"""The LSH cell at a tiny size on the CPU, through ``run.run_cell``: a
sound run is judged correct, and faults planted in what its batches
return are judged not correct."""

import json
import shutil

import numpy as np
import pytest
import torch

from conftest import BENCH, ROOT, run_tiny

from benchmark import reference

CELL = "tiny-pfam25-lsh.b8"
# a tiny database's buckets hold a few hundred rows at most; the cell's
# cand_max is sized for 2^22
TINY = {"n_rows": 4096, "pool": 32, "cand_max": 128}
# a tiny batch of 128 tables takes ~0.1-0.3 s on a loaded CPU: the window
# holds several
SECONDS = 2.0


@pytest.fixture
def tiny_lsh(tmp_path):
    """(Registry over a tiny copy of the LSH cell, its spec path)."""
    from benchmark.registry import Registry
    base = tmp_path / "bench"
    for sub in ("engines", "layer_metrics"):
        shutil.copytree(BENCH / sub, base / sub)
    (base / "configs").mkdir()
    (base / "traffic").mkdir()
    cfg = json.loads((BENCH / "configs" / "pfam25-lsh.json").read_text())
    cfg.update(TINY)
    (base / "configs" / "tiny-pfam25-lsh.json").write_text(json.dumps(cfg))
    (base / "traffic" / "b8.json").write_text(json.dumps(
        {"loop": "closed", "clients": 1, "batch": 8, "center_block": 8,
         "warmup_batches": 1}))
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    spec["workloads"] = [{"name": CELL, "config": "tiny-pfam25-lsh",
                          "traffic": "b8", "chips": 1, "why": "tiny"}]
    spec["per_layer"] = [m for m in spec["per_layer"]
                         if "pfam25-lsh.batch1024" in m["workloads"]]
    for m in spec["per_layer"]:
        m["workloads"] = [CELL]
    (base / "BENCHMARK.json").write_text(json.dumps(spec))
    return Registry(base=base, spec_path=base / "BENCHMARK.json")


class Planted:
    """The engine, with ``fault(self, centers, hits)`` applied to what each
    batch returns."""

    def __init__(self, engine, data, fault):
        self.engine, self.data, self.fault = engine, data, fault
        self.calls = 0

    @property
    def stats(self):
        return self.engine.stats

    def search(self, centers):
        hits = self.engine.search(centers)
        self.calls += 1
        return self.fault(self, centers, hits)

    def call_shapes(self, batch):
        return self.engine.call_shapes(batch)

    def close(self):
        self.engine.close()


def dropped_hits(eng, centers, hits):
    """Each center's nearest true hit left out."""
    ci, ki, d = hits
    order = np.lexsort((d, ci))
    first = np.ones(len(ci), bool)
    first[1:] = ci[order][1:] != ci[order][:-1]
    keep = np.ones(len(ci), bool)
    keep[order[first]] = False
    return ci[keep], ki[keep], d[keep]


def wrong_distance(eng, centers, hits):
    """The farthest hit's distance 0.01 off."""
    ci, ki, d = (x.copy() for x in hits)
    if len(d):
        d[np.argmax(d)] += np.float32(0.01)
    return ci, ki, d


def outside_radius(eng, centers, hits):
    """A k-mer beyond the radius returned, with its exact distance."""
    ci, ki, d = hits
    db = eng.data.db
    c = torch.as_tensor(centers[:1], dtype=torch.int8)
    rows = torch.arange(db.shape[0])
    d2 = reference.pair_d2(db, c, torch.zeros_like(rows), rows)
    far = int(torch.argmax(d2))
    return (np.append(ci, 0), np.append(ki, far),
            np.append(d, np.float32(float(d2[far]) ** 0.5)))


def raising(eng, centers, hits):
    """The second batch never answers."""
    if eng.calls == 2:
        raise RuntimeError("planted: a batch that raised")
    return hits


def test_verify_roofline_is_the_shared_reader(tiny_lsh):
    """The LSH cell's roofline reads through ``verify_roofline.py``'s
    arithmetic, not a copy of it."""
    own = tiny_lsh.layer_metric("lsh.verify_roofline").read
    shared = tiny_lsh.layer_metric("verify_roofline").read
    assert own.__code__.co_filename == shared.__code__.co_filename


def test_sound_run_is_correct(tiny_lsh):
    res = run_tiny(tiny_lsh, CELL, seed=2 ** 31 + 23, seconds=SECONDS)
    assert res["correct"], res["checks"]
    assert res["failed"] == 0 and res["attempted"] >= 2
    assert res["checks"]["hit_error"]["value"] < 1e-6
    assert set(res["metrics"]) >= {"queries_per_s", "batch_p95_ms",
                                   "weighted_recall", "setup_s"}


def test_traced_run_reads_the_host_metrics(tiny_lsh):
    res = run_tiny(tiny_lsh, CELL, seed=2 ** 31 + 23, trace=True,
                   seconds=SECONDS)
    assert res["correct"], res["checks"]
    # the kernel readers find no CUDA kernel on the CPU
    assert set(res["metrics"]) == {"lsh.enqueue_ms",
                                   "lsh.verified_per_batch"}


@pytest.mark.parametrize("fault, check", [
    (dropped_hits, "recall"), (wrong_distance, "hit_error"),
    (outside_radius, "hit_error"), (raising, "failed_batches")])
def test_planted_fault_is_not_correct(tiny_lsh, fault, check):
    res = run_tiny(tiny_lsh, CELL, seed=2 ** 31 + 23, seconds=SECONDS,
                   wrap=lambda engine, data: Planted(engine, data, fault))
    assert not res["correct"]
    assert not res["checks"][check]["ok"], res["checks"]
