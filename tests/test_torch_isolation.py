"""hsearch_tpu_torch stands alone: every module (and chip_smoke.py) imports
with jax and hsearch_tpu blocked, and an entry point given no device
raises when CUDA is absent instead of running on the CPU."""

import os
import subprocess
import sys
import tempfile

import numpy as np
import pytest
import torch

from hsearch_tpu_torch import bench, cli, metric
from hsearch_tpu_torch.align import pipeline
from hsearch_tpu_torch.cluster import centroid, greedy, greedy_dist
from hsearch_tpu_torch.cluster import pcluster, pcluster_dist, postprocess
from hsearch_tpu_torch.core import io as tio
from hsearch_tpu_torch.examples import (bench_engines, bench_pcluster_mp,
                                        pipeline_e2e, quickstart)
from hsearch_tpu_torch.lsh import tuning
from hsearch_tpu_torch.parallel import mesh, multihost, stream_sharded, train
from hsearch_tpu_torch.search import exact, ivf, motif, stream
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
assert "hsearch_tpu_torch.native_ext" in names
print(len(names))
"""


def test_imports_without_jax_or_reference():
    res = subprocess.run([sys.executable, "-c", _BLOCKED_IMPORT], cwd=REPO,
                         capture_output=True, text=True, timeout=120,
                         env=dict(os.environ, PYTHONPATH=REPO))
    assert res.returncode == 0, res.stderr
    # every module was found: lsh/, cluster/ (pcluster included),
    # search/stream, utils/{stats,profiling}, core/{dataprep,orf,stockholm,
    # mds}, align/ (reduced, blast_stat, hostops, seed_index, extend,
    # gapped_device, pipeline), metric, parallel/ (mesh, sharded,
    # multihost, _mp_check, train, stream_sharded), the distributed
    # clustering (cluster/{greedy_dist, pcluster_dist, _mp_greedy_check,
    # _mp_pcluster_check}), bench and examples/ with its 11 scripts, and
    # native_ext (the C++ host library's bindings)
    assert int(res.stdout.split()[-1]) >= 71


# the host library built into a fresh directory with jax and hsearch_tpu
# blocked: its source is the port's csrc/hostops.cpp, and no library of
# the JAX package's native/ is mapped into the process
_BLOCKED_BUILD = r"""
import pathlib, sys
sys.modules["jax"] = None
sys.modules["hsearch_tpu"] = None
import numpy as np
from hsearch_tpu_torch import native_ext
default = native_ext.lib_path()
native_ext._BUILD = pathlib.Path(sys.argv[1])
order = native_ext.argsort_u64(np.array([3, 1, 2, 1], np.uint64))
assert order.tolist() == [1, 3, 2, 0]
maps = open("/proc/self/maps").read()
print(default)
print(native_ext.SOURCE)
print(native_ext._load()._name)
print("native/" in maps, "libhsearch_native" in maps)
"""


def test_host_library_builds_from_the_ports_source(tmp_path):
    res = subprocess.run([sys.executable, "-c", _BLOCKED_BUILD,
                          str(tmp_path)], cwd=REPO, capture_output=True,
                         text=True, timeout=300,
                         env=dict(os.environ, PYTHONPATH=REPO))
    assert res.returncode == 0, res.stderr
    default, source, loaded, flags = res.stdout.splitlines()
    pkg = os.path.join(REPO, "hsearch_tpu_torch")
    assert os.path.dirname(default) == os.path.join(pkg, "_build")
    assert source == os.path.join(pkg, "csrc", "hostops.cpp")
    assert os.path.dirname(loaded) == str(tmp_path)
    assert os.path.basename(loaded) == os.path.basename(default)
    assert flags == "False False"


def _proteins(db):
    return tio.ProteinDB(names=[f"p{i}" for i in range(len(db))],
                         seq=db.reshape(-1).astype(np.uint8),
                         starts=np.arange(len(db) + 1) * db.shape[1])


ENTRY_POINTS = {
    "exact.search_radius": lambda db: exact.search_radius(db, db[:2], 5.0),
    "exact.search_topk": lambda db: exact.search_topk(db, db[:2], 3),
    "ivf.build_index": lambda db: ivf.build_index(db, torch.Generator()),
    "checkpoint.index_from_arrays": lambda db: checkpoint.index_from_arrays(
        db.reshape(4, -1).astype(np.int8), np.arange(16).reshape(4, 4),
        np.zeros((4, 40), np.float32), np.zeros(4, np.float32), 16, 5),
    "motif.build_index": lambda db: motif.build_index(db, torch.Generator()),
    "motif.index_from_arrays": lambda db: motif.index_from_arrays(
        np.zeros((1, 40, 4)), np.zeros((1, 4)), 50.0, 7,
        np.zeros((1, 16), np.int32), np.zeros((1, 16), np.int32),
        np.zeros((17, 5), np.int32), 4),
    "tuning.sweep": lambda db: tuning.sweep(db, db[:2], 5.0),
    "greedy.cluster_greedy": lambda db: greedy.cluster_greedy(
        db, torch.Generator()),
    "centroid.cluster_centroid": lambda db: centroid.cluster_centroid(
        db, torch.Generator()),
    "postprocess.merge_by_center_distance":
        lambda db: postprocess.merge_by_center_distance(
            db, np.arange(16), 5.0, torch.Generator()),
    "postprocess.center_distance_samples":
        lambda db: postprocess.center_distance_samples(
            np.zeros((3, 40), np.float32)),
    "pipeline.ProteinSearcher": lambda db: pipeline.ProteinSearcher(
        _proteins(db)),
    "pcluster.cluster_proteins": lambda db: pcluster.cluster_proteins(
        _proteins(db), torch.Generator()),
    "pcluster.klsh_codes_all": lambda db: pcluster.klsh_codes_all(
        _proteins(db), [pcluster.klsh_init(torch.Generator())]),
    "stream.build_segmented": lambda db: stream.build_segmented(
        db, torch.Generator(), segment_points=8),
    "metric.k_best_peptides": lambda db: metric.k_best_peptides(db[0], 5),
    "train.fit_embedding": lambda db: train.fit_embedding(steps=1),
    "mesh.make_mesh": lambda db: mesh.make_mesh(),
    "multihost.host_mesh": lambda db: multihost.host_mesh(),
    "multihost.initialize": lambda db: multihost.initialize(
        "127.0.0.1:1", 1, 0),
    "greedy_dist.cluster_greedy_distributed":
        lambda db: greedy_dist.cluster_greedy_distributed(
            db, torch.Generator()),
    "pcluster_dist.cluster_proteins_distributed":
        lambda db: pcluster_dist.cluster_proteins_distributed(
            _proteins(db), torch.Generator()),
    "stream_sharded.search_segmented_sharded":
        lambda db: stream_sharded.search_segmented_sharded(
            stream.build_segmented(db, torch.Generator(), segment_points=8,
                                   block_size=4, device="cpu"), db[:2], 5.0),
    "bench.main": lambda db: bench.main(["--log2n", "10", "--centers", "8"]),
    # one example of each kind: a single-process bench, a multi-process
    # one, the CLI-driven pipeline and the worked example
    "examples.bench_engines.main": lambda db: bench_engines.main(["10"]),
    "examples.bench_pcluster_mp.main":
        lambda db: bench_pcluster_mp.main(["16"]),
    "examples.pipeline_e2e.main": lambda db: pipeline_e2e.main(
        ["4", os.path.join(tempfile.gettempdir(), "never_made")]),
    "examples.quickstart.run": lambda db: quickstart.run(),
    "stream.upload_segment": lambda db: stream.upload_segment(
        stream.host_segment_from_arrays(
            db.reshape(4, -1).astype(np.int8),
            np.arange(16, dtype=np.int32).reshape(4, 4), 0, 16, 5,
            pin=False)),
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


def test_segivf_load_raises_without_cuda(monkeypatch, tmp_path, rng):
    db = rng.integers(0, 20, (16, 5)).astype(np.int32)
    path = str(tmp_path / "seg.npz")
    checkpoint.save_index(path, stream.build_segmented(
        db, torch.Generator(), segment_points=8, block_size=4,
        device="cpu"))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        checkpoint.load_index(path)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        cli.main(["serve", "-i", path])
    assert checkpoint.load_index(path, device="cpu").num_segments == 2


CLI_TOOLS = {
    "motif-search-lsh": ["motif-search", "-c", "{fa}", "-o", "{out}",
                         "--engine", "lsh", "-k", "4"],
    "motif-search-stream": ["motif-search", "-c", "{fa}", "-o", "{out}",
                            "--engine", "stream"],
    "index-build-ivf": ["index-build", "-o", "{out}.npz"],
    "index-build-stream": ["index-build", "-o", "{out}.npz", "--engine",
                           "stream"],
    "lsh-sweep": ["lsh-sweep", "-c", "{fa}"],
    "hclust2": ["hclust2", "-o", "{out}"],
    "hclust3": ["hclust3", "-o", "{out}", "--merge-radius", "5"],
    "hclust": ["hclust", "-o", "{out}"],
}


@pytest.mark.parametrize("tool", sorted(CLI_TOOLS))
def test_new_cli_tools_raise_without_cuda(monkeypatch, tmp_path, tool):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    fa = tmp_path / "k.fasta"
    fa.write_text(">a\nARNDCQEGHI\n>b\nARNDCQEGHV\n")
    args = [a.format(fa=fa, out=tmp_path / "o.txt")
            for a in CLI_TOOLS[tool]]
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        cli.main([*args, "-d", str(fa), "-l", "10"])


def test_pcluster_cli_raises_without_cuda(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    fa = tmp_path / "p.fasta"
    fa.write_text(">a\nARNDCQEGHILKMFPSTWYV\n>b\nARNDCQEGHILKMFPSTWYA\n")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        cli.main(["pcluster", "-d", str(fa), "-o", str(tmp_path / "o")])


def test_fit_embedding_cli_raises_without_cuda(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        cli.main(["fit-embedding", "-o", str(tmp_path / "c.txt"),
                  "--steps", "1"])
