"""hsearch_tpu_torch.ops.distance (and the copied constant tables) against
hsearch_tpu on the same numpy inputs, on the CPU.

Tolerances: the norm-identity forms (||a||^2 + ||b||^2 - 2ab) lose digits
to float32 cancellation, so rtol 1e-5 / atol 1e-3; the one-hot and
table-sum forms add the same exact table entries in another order, so
rtol 1e-6 / atol 1e-4.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hsearch_tpu.core import alphabet as j_alphabet
from hsearch_tpu.core import blosum as j_blosum
from hsearch_tpu.core import embedding as j_embedding
from hsearch_tpu.ops import distance as jd
from hsearch_tpu.search import motif as j_motif
from hsearch_tpu_torch.core import alphabet, blosum, embedding
from hsearch_tpu_torch.ops import distance as td
from hsearch_tpu_torch.search import motif

NORM = dict(rtol=1e-5, atol=1e-3)
TABLE = dict(rtol=1e-6, atol=1e-4)
L = 10


def _inputs(rng):
    q = rng.integers(0, 20, (7, L)).astype(np.int32)
    db = rng.integers(0, 20, (53, L)).astype(np.int32)
    pts = embedding.embed_kmers(rng.integers(0, 20, (7, L))) \
        + rng.normal(0, 0.5, (7, 8 * L)).astype(np.float32)
    a = rng.normal(0, 10, (9, 40)).astype(np.float32)
    b = rng.normal(0, 10, (11, 40)).astype(np.float32)
    ptab = rng.random((5, L, 20)).astype(np.float32)
    cand = rng.integers(0, 20, (5, 700, L)).astype(np.int8)
    return dict(q=q, db=db, pts=pts, a=a, b=b, ptab=ptab, cand=cand)


T = torch.as_tensor
CASES = {
    "sq_distance_matrix": (
        lambda x: td.sq_distance_matrix(T(x["a"]), T(x["b"])),
        lambda x: jd.sq_distance_matrix(x["a"], x["b"]), NORM),
    "kmer_sq_distance_matrix": (
        lambda x: td.kmer_sq_distance_matrix(T(x["q"]), T(x["db"])),
        lambda x: jd.kmer_sq_distance_matrix(jnp.asarray(x["q"]),
                                             jnp.asarray(x["db"])), TABLE),
    "kmer_sq_distance_matrix_fast": (
        lambda x: td.kmer_sq_distance_matrix_fast(T(x["q"]), T(x["db"])),
        lambda x: jd.kmer_sq_distance_matrix_fast(jnp.asarray(x["q"]),
                                                  jnp.asarray(x["db"])),
        NORM),
    "kmer_blosum_score_matrix": (
        lambda x: td.kmer_blosum_score_matrix(T(x["q"]), T(x["db"])),
        lambda x: jd.kmer_blosum_score_matrix(jnp.asarray(x["q"]),
                                              jnp.asarray(x["db"])), TABLE),
    "point_vs_kmer_sq_distance": (
        lambda x: td.point_vs_kmer_sq_distance(T(x["pts"]), T(x["db"])),
        lambda x: jd.point_vs_kmer_sq_distance(jnp.asarray(x["pts"]),
                                               jnp.asarray(x["db"])), NORM),
    "ptable_distances": (
        lambda x: td.ptable_distances(T(x["ptab"]), T(x["cand"])),
        lambda x: jd.ptable_distances(jnp.asarray(x["ptab"]),
                                      jnp.asarray(x["cand"])), TABLE),
    "ptable_distances_mxu": (
        lambda x: td.ptable_distances_mxu(T(x["ptab"]), T(x["cand"]),
                                          chunk=128),
        lambda x: jd.ptable_distances_mxu(jnp.asarray(x["ptab"]),
                                          jnp.asarray(x["cand"]),
                                          chunk=128), TABLE),
    "blocked_kmer_sq_distance": (
        lambda x: td.blocked_kmer_sq_distance(x["q"], x["db"], block=16,
                                              device="cpu"),
        lambda x: jd.blocked_kmer_sq_distance(x["q"], x["db"], block=16),
        TABLE),
    "center_ptables_int": (
        lambda x: motif._center_ptables(T(x["q"]), L),
        lambda x: j_motif._center_ptables(jnp.asarray(x["q"]), L), TABLE),
    "center_ptables_float": (
        lambda x: motif._center_ptables(T(x["pts"]), L),
        lambda x: j_motif._center_ptables(jnp.asarray(x["pts"]), L), NORM),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_distance_matches_jax(rng, name):
    port, ref, tol = CASES[name]
    x = _inputs(rng)
    got = port(x)
    got = got.numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(ref(x))
    assert got.shape == want.shape
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, want, **tol)


def test_constant_tables_are_exact_copies():
    np.testing.assert_array_equal(embedding.COORDINATES,
                                  j_embedding.COORDINATES)
    np.testing.assert_array_equal(embedding.DISTANCE_SQUARE,
                                  j_embedding.DISTANCE_SQUARE)
    np.testing.assert_array_equal(blosum.BLOSUM62, j_blosum.BLOSUM62)
    assert alphabet.AA20 == j_alphabet.AA20
    assert alphabet.INVALID == j_alphabet.INVALID


def test_alphabet_matches_jax(rng):
    s = "ARNDCQEGHILKMFPSTWYVxbzJ*acd"
    np.testing.assert_array_equal(alphabet.encode(s), j_alphabet.encode(s))
    idx = alphabet.encode(s)
    assert alphabet.decode(idx) == j_alphabet.decode(idx)
    for seed, off in ((0, 0), (7, 1234)):
        np.testing.assert_array_equal(
            alphabet.randomize_unknown_at(idx, seed, off),
            j_alphabet.randomize_unknown_at(idx, seed, off))
    km = rng.integers(0, 20, (6, L))
    np.testing.assert_array_equal(embedding.embed_kmers(km),
                                  j_embedding.embed_kmers(km))
    np.testing.assert_array_equal(embedding.kmer_sq_distance(km, km[::-1]),
                                  j_embedding.kmer_sq_distance(km, km[::-1]))
