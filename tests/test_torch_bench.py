"""hsearch_tpu_torch.bench against the JAX package's bench.py on the CPU:
the workload generator bitwise, and the kb ladder on one index that the
JAX package built (hit sets, weighted recall and the chosen kb).

The root bench.py imports only numpy at module level, so it is loaded
from its file here."""

import importlib.util
import json
import os

import jax
import numpy as np
import pytest
import torch

from hsearch_tpu.search import evaluate as jevaluate
from hsearch_tpu.search import exact as jexact
from hsearch_tpu.search import ivf as jivf
from hsearch_tpu.utils import checkpoint as jckpt
from hsearch_tpu_torch import bench
from hsearch_tpu_torch.core import embedding
from hsearch_tpu_torch.ops import cuda_kernels as ck
from hsearch_tpu_torch.utils import checkpoint

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _load(path, name):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


jbench = _load(os.path.join(REPO, "bench.py"), "_jax_root_bench")


@pytest.mark.parametrize("n,l,family_size,query_n,fams", [
    (4096, 25, 64, 64, False),
    (4096, 25, 64, 256, True),       # query_n clamped to the 64 families
    (1000, 10, 16, 8, True),
    (50, 25, 64, 256, False),        # one family, one query
])
def test_protein_like_db_bitwise(n, l, family_size, query_n, fams):
    want = jbench.protein_like_db(np.random.default_rng(3), n, l,
                                  family_size, query_n, fams)
    got = bench.protein_like_db(np.random.default_rng(3), n, l,
                                family_size, query_n, fams)
    assert len(got) == len(want) == (3 if fams else 2)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)


N_LOG2, C, CB = 12, 64, 64


@pytest.fixture(scope="module")
def jax_bench_index(tmp_path_factory):
    """The bench workload at 2^12 rows and 64 centers, its IVF index built
    by the JAX package (block size 32, PRNGKey(0)) and saved to .npz."""
    db, centers = jbench.protein_like_db(np.random.default_rng(0),
                                         1 << N_LOG2, 25, query_n=C)
    idx = jivf.build_index(db, jax.random.PRNGKey(0), block_size=32)
    path = str(tmp_path_factory.mktemp("bench") / "jax_bench.npz")
    jckpt.save_index(path, idx)
    return db, centers, idx, path


def _pairs(ci, ki):
    return set(zip(np.asarray(ci).tolist(), np.asarray(ki).tolist()))


def _jax_ladder(jidx, db, centers, ladder):
    """bench.py's oracle and ladder (its main, lines 130-184) on the JAX
    package: (truth, [(kb, hits, recall)])."""
    truth = jexact.search_radius(db, centers, bench.RADIUS, center_block=256,
                                 max_hits=4 * 512)
    rungs = []
    for kb in ladder:
        hits = jivf.search(jidx, centers, bench.RADIUS, k_blocks=kb,
                           max_hits=512, center_block=CB,
                           retry_overflow=False, stats_out={},
                           pack_cap_frac=4)
        rep = jevaluate.recall_from_indices(*truth, hits[0], hits[1],
                                            bench.RADIUS)
        rungs.append((kb, hits, rep.recall))
        if rep.recall >= 0.99:
            break
    return truth, rungs


# the bench's ladder (its first rung is lossless at this size) and a finer
# one whose recall crosses 0.99 at its third rung
@pytest.mark.parametrize("ladder", [bench.KB_LADDER, (4, 8, 16, 32)])
def test_ladder_equals_jax_on_its_index(jax_bench_index, ladder):
    db, centers, jidx, path = jax_bench_index
    idx = checkpoint.load_index(path, device="cpu")
    assert idx.num_blocks == jidx.num_blocks
    # tie precondition: at every capped rung each center's kb-th and
    # (kb+1)-th prune keys differ, so the selected blocks do not depend on
    # tie order
    key = np.sort(ck.sq_distance_prune(
        torch.as_tensor(embedding.embed_kmers(centers)), idx.block_centroid,
        idx.block_radius, bench.RADIUS)[0][:, :idx.num_blocks].numpy(),
        axis=1)
    for kb in ladder:
        if kb < idx.num_blocks:
            kth, nxt = key[:, kb - 1], key[:, kb]
            assert np.all(~np.isfinite(kth) | (kth < nxt * (1 - 1e-5)))
    truth, jrungs = _jax_ladder(jidx, db, centers, ladder)
    res = bench.run_ladder(idx, db, centers, center_block=CB,
                           ladder=ladder, iters=1)
    # the oracle: the same hit set, d^2 to rtol 1e-5
    assert _pairs(*res.truth[:2]) == _pairs(*truth[:2])
    want_d = {p: d for p, d in zip(zip(*truth[:2]), truth[2])}
    got_d = np.array([want_d[p] for p in zip(*res.truth[:2])])
    np.testing.assert_allclose(res.truth[2] ** 2, got_d ** 2, rtol=1e-5)
    # every rung: the same hits; weighted recall to rtol 1e-9 (its
    # weights come from each package's oracle distances)
    assert [kb for kb, _ in res.rungs] == [kb for kb, _, _ in jrungs]
    for (kb, hits), (_, jhits, jrecall), row in zip(res.rungs, jrungs,
                                                    res.record["ladder"]):
        assert _pairs(*hits[:2]) == _pairs(*jhits[:2])
        np.testing.assert_allclose(row["recall"], jrecall, rtol=1e-9)
    assert res.record["kb"] == jrungs[-1][0]
    assert res.record["recall"] >= bench.RECALL_GATE
    if ladder != bench.KB_LADDER:
        assert len(jrungs) == 3 and jrungs[0][2] < 0.99
    assert res.record["hits"] == len(jrungs[-1][1][0])
    assert len(res.record["call_s"]) == 1
    # the CPU path runs the kernels' plain versions: no launch counted
    assert res.record["launches_per_call"] == {"sq_distance_prune": 0,
                                               "ptable_verify": 0,
                                               "extend_pairs": 0,
                                               "block_bounds": 0,
                                               "banded_scores": 0,
                                               "elect": 0}


def test_main_prints_one_json_line(capsys):
    assert bench.main(["--log2n", str(N_LOG2), "--centers", str(C),
                       "--device", "cpu"]) == 0
    cap = capsys.readouterr()
    lines = cap.out.splitlines()
    assert len(lines) == 1
    row = json.loads(lines[0])
    assert set(row) == {"metric", "value", "unit", "vs_baseline"}
    assert row["metric"] == "motif_search_throughput"
    assert row["unit"] == "center queries/s/chip"
    assert row["value"] > 0 and row["vs_baseline"] > 0
    summary = cap.err.splitlines()[-1]
    assert " kb=128 " in summary and "card_brute=" in summary
    assert "call_ms min/median/max=" in summary and "card=cpu" in summary


def test_main_raises_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        bench.main(["--log2n", str(N_LOG2), "--centers", str(C)])
