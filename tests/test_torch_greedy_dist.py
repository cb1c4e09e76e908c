"""hsearch_tpu_torch/cluster/greedy_dist.py against single-process
cluster_greedy and the JAX package's cluster_greedy_distributed on the
CPU: in one process, and as spawned gloo clusters of 2 and 3 processes
(cluster/_mp_greedy_check.py).

Torch cannot reproduce jax.random, so the parity cases carry the JAX
rounds' (a, b) draws across (``round_params``) on data with no pairwise
distance within 1e-3 of the radius and bucket codes equal to JAX's in
every round (float32 sums in another order could differ at either)."""

import jax
import numpy as np
import torch

from hsearch_tpu.cluster import greedy as jg, greedy_dist as jgd
from hsearch_tpu.lsh import pstable as jp
from hsearch_tpu_torch.cluster import _mp_greedy_check, greedy, greedy_dist
from hsearch_tpu_torch.core import embedding
from hsearch_tpu_torch.lsh import pstable
from hsearch_tpu_torch.parallel import _mp_check

MODULE = "hsearch_tpu_torch.cluster._mp_greedy_check"


def _km(rng, n=512, l=8, fams=12):
    fam = rng.integers(0, 20, (fams, l), dtype=np.int32)
    which = rng.integers(0, fams, n)
    km = fam[which].copy()
    flip = rng.integers(0, l, n)
    km[np.arange(n), flip] = rng.integers(0, 20, n)
    return km


def _round_params(key, cfg, dim):
    """What the JAX package's greedy clustering draws for each round."""
    keys = jax.random.split(key, cfg.hash_l)
    out = []
    for r in range(cfg.hash_l):
        p = jp.init(keys[r], dim, cfg.hash_k, 1, cfg.w)
        out.append((np.asarray(p.a), np.asarray(p.b)))
    return out


def _assert_clear(km, cfg, rp):
    """No distance within 1e-3 of the radius (over every pair: each bucket
    is a subset), and every round's bucket codes equal to the JAX
    package's (a scaled projection within float32 noise of an integer
    could fall on either side)."""
    for lo in range(0, len(km), 512):
        d = np.sqrt(embedding.DISTANCE_SQUARE[km[lo:lo + 512, None, :],
                                              km[None]].sum(-1))
        assert not (np.abs(d - cfg.radius) < 1e-3).any()
    for a, b in rp:
        jparams = jp.PStableParams(a=jax.numpy.asarray(a),
                                   b=jax.numpy.asarray(b), w=cfg.w)
        want = np.asarray(jp.hash_codes(jax.numpy.asarray(km), jparams,
                                        is_kmers=True))
        tparams = pstable.params_from_arrays(a, b, cfg.w, device="cpu")
        got = pstable.hash_codes(torch.as_tensor(km), tparams,
                                 is_kmers=True).numpy()
        np.testing.assert_array_equal(got, want)


def test_single_process_equals_cluster_greedy_and_jax(rng):
    km = _km(rng)
    cfg = greedy.ClusterConfig(hash_l=4)
    got = greedy_dist.cluster_greedy_distributed(
        km, torch.Generator().manual_seed(3), cfg, device="cpu")
    ref = greedy.cluster_greedy(km, torch.Generator().manual_seed(3), cfg,
                                device="cpu")
    np.testing.assert_array_equal(got.parent, ref.parent)
    np.testing.assert_array_equal(got.merged, ref.merged)
    assert (ref.parent >= 0).sum() > 100      # merges happened
    # the JAX package's distributed function in one process, its draws
    # carried
    key = jax.random.PRNGKey(3)
    rp = _round_params(key, cfg, km.shape[1] * embedding.AA_DIM)
    _assert_clear(km, cfg, rp)
    want = jgd.cluster_greedy_distributed(km, key,
                                          jg.ClusterConfig(hash_l=4))
    got = greedy_dist.cluster_greedy_distributed(km, None, cfg, rp,
                                                 device="cpu")
    np.testing.assert_array_equal(got.parent, want.parent)
    np.testing.assert_array_equal(got.merged, want.merged)


def test_two_process_cluster_equals_jax(tmp_path):
    """2 processes, JAX's draws and JAX's result carried in by .npz: the
    distributed result equals in-process cluster_greedy and JAX's."""
    km = _mp_greedy_check._workload()
    assert km.shape == (4096, 8)
    cfg = jg.ClusterConfig(hash_l=6)
    key = jax.random.PRNGKey(5)
    rp = _round_params(key, cfg, km.shape[1] * embedding.AA_DIM)
    _assert_clear(km, cfg, rp)
    want = jg.cluster_greedy(km, key, cfg)
    path = str(tmp_path / "jax.npz")
    np.savez(path, round_a=np.stack([a for a, _ in rp]),
             round_b=np.stack([b for _, b in rp]), parent=want.parent,
             merged=want.merged)
    outs = _mp_check.run_local_cluster(
        nproc=2, ndev_per_proc=1, module=MODULE, timeout=120,
        extra_env={"GREEDY_CHECK_NPZ": path})
    n_heads = int((want.merged != 2).sum())
    assert all(f"greedy clusters={n_heads} " in o for o in outs)


def test_three_process_cluster_bit_identical():
    """nproc 3: strided bucket-row ownership with an odd process count."""
    outs = _mp_check.run_local_cluster(
        nproc=3, ndev_per_proc=1, module=MODULE, timeout=120,
        extra_env={"GREEDY_CHECK_N": 2048, "GREEDY_CHECK_L": 4})
    assert len(outs) == 3
