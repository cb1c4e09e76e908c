"""hsearch_tpu_torch stands alone: every module (and chip_smoke.py) imports
with jax and hsearch_tpu blocked, and an entry point given no device
raises when CUDA is absent instead of running on the CPU."""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from hsearch_tpu_torch import cli
from hsearch_tpu_torch.search import exact, ivf
from hsearch_tpu_torch.utils import checkpoint

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_BLOCKED_IMPORT = r"""
import importlib, importlib.util, pkgutil, sys
sys.modules["jax"] = None          # any import of jax or hsearch_tpu fails
sys.modules["hsearch_tpu"] = None
import hsearch_tpu_torch
names = ["hsearch_tpu_torch"] + [
    m.name for m in pkgutil.walk_packages(hsearch_tpu_torch.__path__,
                                          "hsearch_tpu_torch.")
    if m.name != "hsearch_tpu_torch.__main__"]
for name in names:
    importlib.import_module(name)
spec = importlib.util.spec_from_file_location("chip_smoke", "chip_smoke.py")
spec.loader.exec_module(importlib.util.module_from_spec(spec))
assert not any(k == "jax" or k.startswith(("jax.", "hsearch_tpu."))
               for k, v in sys.modules.items() if v is not None)
print(len(names))
"""


def test_imports_without_jax_or_reference():
    res = subprocess.run([sys.executable, "-c", _BLOCKED_IMPORT], cwd=REPO,
                         capture_output=True, text=True, timeout=120,
                         env=dict(os.environ, PYTHONPATH=REPO))
    assert res.returncode == 0, res.stderr
    assert int(res.stdout.split()[-1]) >= 15      # every module was found


ENTRY_POINTS = {
    "exact.search_radius": lambda db: exact.search_radius(db, db[:2], 5.0),
    "exact.search_topk": lambda db: exact.search_topk(db, db[:2], 3),
    "ivf.build_index": lambda db: ivf.build_index(db, torch.Generator()),
    "checkpoint.index_from_arrays": lambda db: checkpoint.index_from_arrays(
        db.reshape(4, -1).astype(np.int8), np.arange(16).reshape(4, 4),
        np.zeros((4, 40), np.float32), np.zeros(4, np.float32), 16, 5),
}


@pytest.mark.parametrize("entry", sorted(ENTRY_POINTS))
def test_default_device_raises_without_cuda(monkeypatch, rng, entry):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    db = rng.integers(0, 20, (16, 5)).astype(np.int32)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ENTRY_POINTS[entry](db)


def test_cli_default_device_raises_without_cuda(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    fa = tmp_path / "k.fasta"
    fa.write_text(">a\nARNDCQEGHI\n>b\nARNDCQEGHV\n")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        cli.main(["motif-search-exact", "-d", str(fa), "-c", str(fa),
                  "-l", "10", "-o", str(tmp_path / "o.txt")])
