"""A tiny benchmark on the CPU: the real engines and layer readers beside
configurations and a traffic mix cut to a few thousand rows, and a
specification that names them."""

import json
import shutil
import sys
from pathlib import Path

import pytest

HERE = Path(__file__).resolve().parent
BENCH = HERE.parent
ROOT = BENCH.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

TINY = {"n_rows": 4096, "pool": 32, "k_blocks": 512}


@pytest.fixture
def tiny(tmp_path):
    """(Registry over a tiny copy of the benchmark, its spec path)."""
    from benchmark.registry import Registry
    base = tmp_path / "bench"
    for sub in ("engines", "layer_metrics"):
        shutil.copytree(BENCH / sub, base / sub)
    (base / "configs").mkdir()
    (base / "traffic").mkdir()
    for name, extra in (("pfam25-resident", {}),
                        ("pfam25-streamed", {"segment_points": 1024})):
        cfg = json.loads((BENCH / "configs" / f"{name}.json").read_text())
        cfg.update(TINY, **extra)
        (base / "configs" / f"tiny-{name}.json").write_text(json.dumps(cfg))
    (base / "traffic" / "b8.json").write_text(json.dumps(
        {"loop": "closed", "clients": 1, "batch": 8, "center_block": 8,
         "warmup_batches": 1}))
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    spec["workloads"] = [
        {"name": f"tiny-{c}.b8", "config": f"tiny-{c}", "traffic": "b8",
         "chips": 1, "why": "tiny"}
        for c in ("pfam25-resident", "pfam25-streamed")]
    for m in spec["per_layer"]:
        m.pop("workloads", None)
    (base / "BENCHMARK.json").write_text(json.dumps(spec))
    return Registry(base=base, spec_path=base / "BENCHMARK.json"), base


def run_tiny(reg, cell, seed=7, seconds=0.3, trace=False, wrap=None):
    import time

    import torch

    from benchmark import run
    return run.run_cell(reg, reg.workload(cell), seed, seconds, trace,
                        torch.device("cpu"), t_start=time.perf_counter(),
                        wrap=wrap)
