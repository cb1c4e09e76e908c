"""The BLOSUM metric tools and embedding training of hsearch_tpu_torch
(metric.py, core/mds.py, core/blosum.py, parallel/train.py) against the
JAX package on the same inputs, on the CPU."""

import itertools

import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from hsearch_tpu import metric as jmetric
from hsearch_tpu.core import blosum as jblosum, mds as jmds
from hsearch_tpu.parallel import train as jtrain
from hsearch_tpu_torch import metric
from hsearch_tpu_torch.core import blosum, embedding, mds
from hsearch_tpu_torch.parallel import mesh as mesh_lib, train

MODES = ("similarity", "distance", "metric")


@pytest.mark.parametrize("mode", MODES)
def test_k_best_peptides_equal_jax(rng, mode):
    # random queries, and queries of one repeated residue, whose beams are
    # full of equal scores: ties must fall as lax.top_k breaks them
    queries = [rng.integers(0, 20, 8).astype(np.int32) for _ in range(8)]
    queries += [np.full(6, a, np.int32) for a in (0, 7)]
    n_ties = 0
    for q in queries:
        js, jp = jmetric.k_best_peptides(jnp.asarray(q), 50, mode)
        ts, tp = metric.k_best_peptides(q, 50, mode, device="cpu")
        np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
        np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))
        n_ties += int((np.diff(np.asarray(js)) == 0).sum())
    assert n_ties > 0


def test_k_best_similarity_matches_bruteforce(rng):
    l, k = 3, 25
    q = rng.integers(0, 20, l).astype(np.int32)
    scores, seqs = metric.k_best_peptides(q, k, "similarity", device="cpu")
    scores, seqs = scores.numpy(), seqs.numpy()
    all_pep = np.array(list(itertools.product(range(20), repeat=l)))
    all_s = blosum.BLOSUM62[q, all_pep].sum(axis=1)
    np.testing.assert_allclose(np.sort(scores)[::-1],
                               np.sort(all_s)[::-1][:k])
    np.testing.assert_allclose(blosum.BLOSUM62[q, seqs].sum(axis=1), scores)
    best = metric.k_best_peptides(q, 1, "similarity", device="cpu")[1]
    assert tuple(seqs[0]) == tuple(best[0].numpy())


def test_k_best_distance_matches_bruteforce(rng):
    l, k = 3, 25
    q = rng.integers(0, 20, l).astype(np.int32)
    scores, seqs = metric.k_best_peptides(q, k, "distance", device="cpu")
    all_pep = np.array(list(itertools.product(range(20), repeat=l)))
    all_d = embedding.DISTANCE_SQUARE[q, all_pep].sum(axis=1)
    np.testing.assert_allclose(np.sort(scores.numpy())[:k],
                               np.sort(all_d)[:k], rtol=1e-5)
    assert tuple(seqs.numpy()[np.argmin(scores.numpy())]) == tuple(q)


def test_similarity_distance_agreement(rng):
    frac = metric.topk_agreement(rng, length=5, k=20, n_queries=10,
                                 device="cpu")
    assert frac > 0.5
    want = jmetric.topk_agreement(np.random.default_rng(3), 5, 20, 4)
    got = metric.topk_agreement(np.random.default_rng(3), 5, 20, 4,
                                device="cpu")
    assert got == want


def test_correlation_samples_equal_jax(rng):
    sim, dis = metric.correlation_samples(np.random.default_rng(1), 10,
                                          2000)
    jsim, jdis = jmetric.correlation_samples(np.random.default_rng(1), 10,
                                             2000)
    np.testing.assert_array_equal(sim, jsim)
    np.testing.assert_array_equal(dis, jdis)
    assert np.corrcoef(sim, dis)[0, 1] < -0.7


def test_blosum_helpers_equal_jax(rng):
    np.testing.assert_array_equal(blosum.BLOSUM_DISTANCE,
                                  jblosum.BLOSUM_DISTANCE)
    np.testing.assert_array_equal(blosum.similarity_to_distance(),
                                  jblosum.similarity_to_distance())
    assert blosum.triangle_inequality_violations(blosum.BLOSUM_DISTANCE) \
        == jblosum.triangle_inequality_violations(jblosum.BLOSUM_DISTANCE) \
        == 0
    a = rng.integers(0, 20, (9, 6))
    b = rng.integers(0, 20, (9, 6))
    np.testing.assert_array_equal(blosum.score_kmers(a, b),
                                  jblosum.score_kmers(a, b))


def test_mds_equals_jax():
    d = blosum.BLOSUM_DISTANCE.astype(float)
    for dim in (4, 8):
        np.testing.assert_allclose(mds.classical_mds(d, dim),
                                   jmds.classical_mds(d, dim), atol=1e-9)
        x = mds.smacof(d, dim)
        np.testing.assert_allclose(x, jmds.smacof(d, dim), atol=1e-9)
        assert abs(mds.l1_error(d, x) - jmds.l1_error(d, x)) <= 1e-9
        assert abs(mds.l2_error(d, x) - jmds.l2_error(d, x)) <= 1e-9
    got = mds.mds_sweep(d, range(1, 4))
    want = jmds.mds_sweep(d, range(1, 4))
    for g, w in zip(got, want):
        assert g["dim"] == w["dim"]
        np.testing.assert_allclose([g["l1"], g["l2"]], [w["l1"], w["l2"]],
                                   rtol=1e-9)


def test_mds_regenerates_embedding_quality():
    d = blosum.BLOSUM_DISTANCE.astype(float)
    x = mds.smacof(d, 8)
    our_l2 = mds.l2_error(d, x)
    assert our_l2 <= mds.l2_error(d, embedding.COORDINATES) * 1.05
    assert mds.l2_error(d, mds.smacof(d, 4)) >= our_l2


def test_sample_pair_batch_equals_jax():
    got = train.sample_pair_batch(np.random.default_rng(5), 64, 4)
    want = jtrain.sample_pair_batch(np.random.default_rng(5), 64, 4)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


def test_stress_loss_equals_jax(rng):
    coords = rng.normal(0, 1, (20, 8)).astype(np.float32)
    xa, xb, d2 = train.sample_pair_batch(rng, 512, 4)
    got = float(train.stress_loss(torch.as_tensor(coords),
                                  torch.as_tensor(xa), torch.as_tensor(xb),
                                  torch.as_tensor(d2)))
    want = float(jtrain.stress_loss(jnp.asarray(coords), jnp.asarray(xa),
                                    jnp.asarray(xb), jnp.asarray(d2)))
    assert abs(got - want) <= 1e-5 * abs(want)


def _jax_steps(coords0, batches, lr):
    opt = optax.adam(lr)
    c = jnp.asarray(coords0)
    state = opt.init(c)
    step = jtrain.make_train_step(opt)
    out = []
    for xa, xb, d2 in batches:
        c, state, _ = step(c, state, jnp.asarray(xa), jnp.asarray(xb),
                           jnp.asarray(d2))
        out.append(np.asarray(c))
    return out


def _torch_steps(coords0, batches, lr, mesh=None):
    c = torch.tensor(coords0, requires_grad=True)
    step = train.make_train_step(torch.optim.Adam([c], lr=lr), mesh)
    out = []
    for xa, xb, d2 in batches:
        step(torch.as_tensor(xa), torch.as_tensor(xb), torch.as_tensor(d2))
        out.append(c.detach().numpy().copy())
    return out


def test_train_steps_equal_jax(rng):
    coords0 = rng.normal(0, 1, (20, 8)).astype(np.float32)
    batches = [train.sample_pair_batch(rng, 512, 4) for _ in range(20)]
    got = _torch_steps(coords0, batches, 3e-2)
    want = _jax_steps(coords0, batches, 3e-2)
    assert np.abs(got[0] - want[0]).max() <= 1e-4     # one step
    assert np.abs(got[-1] - want[-1]).max() <= 1e-4   # twenty steps


def test_mesh_train_step_equals_single_device(rng):
    mesh = mesh_lib.make_mesh(8, data=2, devices=["cpu"] * 8)
    coords0 = rng.normal(0, 1, (20, 8)).astype(np.float32)
    batches = [train.sample_pair_batch(rng, 512, 4) for _ in range(5)]
    single = _torch_steps(coords0, batches, 3e-2)
    sharded = _torch_steps(coords0, batches, 3e-2, mesh)
    assert np.abs(sharded[0] - single[0]).max() <= 1e-5
    assert np.abs(sharded[-1] - single[-1]).max() <= 1e-5
    c = torch.tensor(coords0, requires_grad=True)
    step = train.make_train_step(torch.optim.Adam([c], lr=1e-2), mesh)
    with pytest.raises(ValueError, match="does not split evenly"):
        step(*(torch.as_tensor(x) for x in
               train.sample_pair_batch(rng, 100, 4)))


def test_train_loss_decreases_on_mesh(rng):
    mesh = mesh_lib.make_mesh(8, data=2, devices=["cpu"] * 8)
    c = torch.tensor(rng.normal(0, 1, (20, 8)), dtype=torch.float32,
                     requires_grad=True)
    step = train.make_train_step(torch.optim.Adam([c], lr=1e-2), mesh)
    losses = [float(step(*(torch.as_tensor(x) for x in
                           train.sample_pair_batch(rng, 256, 4))))
              for _ in range(21)]
    assert np.isfinite(losses).all() and losses[-1] < losses[0]


def test_fit_embedding_reaches_reference_stress():
    coords = train.fit_embedding(dim=8, steps=1000, batch=2048, kmer_len=1,
                                 lr=1e-1, seed=0, device="cpu")
    d_fit = np.linalg.norm(coords[:, None] - coords[None, :], axis=-1)
    d_ref = np.linalg.norm(embedding.COORDINATES[:, None]
                           - embedding.COORDINATES[None, :], axis=-1)
    target = blosum.BLOSUM_DISTANCE
    assert np.abs(d_fit - target).mean() \
        < np.abs(d_ref - target).mean() * 1.1
