"""BENCHMARK.json against the contract's shape, and every part found by
name, including a configuration, traffic mix and per-layer metric added
as new files only."""

import json
import re

from conftest import BENCH, ROOT, run_tiny

from benchmark.registry import Registry

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SOURCES = ("device_trace", "program_span", "program_counter", "host_clock")


def _spec():
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def test_spec_keys_and_names():
    spec = _spec()
    assert set(spec) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    assert spec["paths"] == ["benchmark"]
    assert 1 <= spec["run_seconds"] <= 51
    names = [c["name"] for c in spec["configs"]] + \
        [w["name"] for w in spec["workloads"]] + \
        [m["name"] for m in spec["end_to_end"] + spec["per_layer"]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)
    for c in spec["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"] == f"benchmark/configs/{c['name']}.json"
        assert 1 <= len(c["source"]) <= 200 and 1 <= len(c["why"]) <= 200
    used = {w["config"] for w in spec["workloads"]}
    assert used == {c["name"] for c in spec["configs"]}
    pairs = [(w["config"], w["traffic"]) for w in spec["workloads"]]
    assert len(pairs) == len(set(pairs))
    assert all(w["chips"] == 1 and len(w["why"]) <= 200
               for w in spec["workloads"])
    e2e = {m["name"] for m in spec["end_to_end"]}
    assert "setup_s" in e2e
    for m in spec["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0 < m["bound"] <= 0.25 and UNIT.match(m["unit"])
    cells = {w["name"] for w in spec["workloads"]}
    for m in spec["per_layer"]:
        assert m["source"] in SOURCES and UNIT.match(m["unit"])
        assert m["moves"] in e2e and set(m["workloads"]) <= cells
        assert m["better"] in ("lower", "higher")
        if m["name"].endswith("_roofline"):
            assert m["unit"] == "%"
    for w in cells:
        assert any(w in m["workloads"] for m in spec["per_layer"])


def test_every_part_found_by_name():
    reg = Registry()
    spec = reg.spec()
    for w in spec["workloads"]:
        cfg = reg.config(w["config"])
        assert cfg["name"] == w["config"]
        assert set(cfg["reduced"]) <= set(cfg["assumed"])
        assert cfg["correct"]["recall_min"] == 0.99
        trf = reg.traffic(w["traffic"])
        assert trf["loop"] == "closed" and trf["clients"] == 1
        assert hasattr(reg.engine(cfg["engine"]), "make")
    for m in spec["per_layer"]:
        assert callable(reg.layer_metric(m["name"]).read)
    assert (BENCH / "layer_metrics" / "prune_roofline.py").exists()


def test_part_added_from_new_files_only(tiny):
    reg, base = tiny
    cfg = json.loads((base / "configs" / "tiny-pfam25-resident.json")
                     .read_text())
    cfg.update(name="tiny-wide", pool=40)
    (base / "configs" / "tiny-wide.json").write_text(json.dumps(cfg))
    (base / "traffic" / "b4.json").write_text(json.dumps(
        {"loop": "closed", "clients": 1, "batch": 4, "center_block": 4,
         "warmup_batches": 2}))
    (base / "layer_metrics" / "bench.batches_traced.py").write_text(
        "def read(ctx):\n    return float(ctx.batches) or None\n")
    spec = json.loads((base / "BENCHMARK.json").read_text())
    spec["workloads"].append({"name": "tiny-wide.b4",
                              "config": "tiny-wide", "traffic": "b4",
                              "chips": 1, "why": "added"})
    spec["per_layer"].append({"name": "bench.batches_traced",
                              "unit": "batches", "better": "higher",
                              "source": "program_counter", "layer": "device",
                              "moves": "queries_per_s",
                              "workloads": ["tiny-wide.b4"]})
    (base / "BENCHMARK.json").write_text(json.dumps(spec))
    res = run_tiny(reg, "tiny-wide.b4", seconds=0.5, trace=True)
    assert res["correct"], res["checks"]
    assert res["metrics"]["bench.batches_traced"]["value"] >= 1
    res = run_tiny(reg, "tiny-wide.b4", seconds=0.3)
    assert set(res["metrics"]) == {"queries_per_s", "batch_p95_ms",
                                   "weighted_recall", "setup_s"}
    assert res["correct"] and res["attempted"] >= 2
