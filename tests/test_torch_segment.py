"""hsearch_tpu_torch.ops.segment against hsearch_tpu.ops.segment on the same
numpy inputs: packed codes, sorted tables, probe, candidate gather and
dedup are bit-identical (integer ops: no tolerance)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hsearch_tpu.ops import segment as jseg
from hsearch_tpu_torch.ops import segment as tseg

I32 = np.iinfo(np.int32)


def _buckets(rng, k):
    """Random int32 bucket indices over the whole range, small signed
    values (the usual case) and the +-2^31 extremes."""
    b = rng.integers(I32.min, I32.max, (64, k), dtype=np.int64)
    b[:32] = rng.integers(-70, 70, (32, k))
    b[32] = I32.max
    b[33] = I32.min
    b[34, ::2] = I32.min
    b[34, 1::2] = I32.max
    b[35] = -1
    return b.astype(np.int32)


@pytest.mark.parametrize("k", [4, 8, 16])
def test_pack_codes_bit_identical(rng, k):
    b = _buckets(rng, k)
    want = np.asarray(jseg.pack_codes(jnp.asarray(b)))
    got = tseg.pack_codes(torch.as_tensor(b)).numpy()
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, want)
    if k == 4:
        np.testing.assert_array_equal(
            tseg.pack_codes_exact(torch.as_tensor(b)).numpy(), want)
    else:
        np.testing.assert_array_equal(
            tseg.pack_codes_mixed(torch.as_tensor(b)).numpy(),
            np.asarray(jseg.pack_codes_mixed(jnp.asarray(b))))


def test_pack_codes_exact_rejects_wide():
    with pytest.raises(ValueError, match="pack_codes_mixed"):
        tseg.pack_codes_exact(torch.zeros((2, 5), dtype=torch.int32))


def _tables(rng, t=3, n=500):
    # few distinct codes: long runs of ties, where only a stable sort
    # gives the JAX package's perm
    codes = rng.integers(-6, 6, (t, n)).astype(np.int32)
    codes[1] = 7
    jt = jseg.build_tables(jnp.asarray(codes))
    tt = tseg.build_tables(torch.as_tensor(codes))
    return codes, jt, tt


def test_build_tables_identical_with_ties(rng):
    codes, jt, tt = _tables(rng)
    assert tt.perm.dtype == torch.int32
    np.testing.assert_array_equal(tt.perm.numpy(), np.asarray(jt.perm))
    np.testing.assert_array_equal(tt.sorted_codes.numpy(),
                                  np.asarray(jt.sorted_codes))
    assert tseg.max_bucket_size(tt.sorted_codes) == \
        jseg.max_bucket_size(codes) == 500


def test_max_bucket_size_matches(rng):
    codes = rng.integers(0, 40, (4, 300)).astype(np.int32)
    tt = tseg.build_tables(torch.as_tensor(codes))
    assert tseg.max_bucket_size(tt.sorted_codes) == \
        jseg.max_bucket_size(codes)
    assert tseg.max_bucket_size(torch.zeros((2, 0), dtype=torch.int32)) == 1


@pytest.mark.parametrize("probes", [None, 3])
def test_probe_gather_dedup_identical(rng, probes):
    _, jt, tt = _tables(rng)
    shape = (9, 3) if probes is None else (9, 3, probes)
    q = rng.integers(-8, 9, shape).astype(np.int32)   # incl. absent codes
    jlo, jcnt = jseg.probe(jt, jnp.asarray(q))
    tlo, tcnt = tseg.probe(tt, torch.as_tensor(q))
    assert tlo.shape == shape and tlo.dtype == torch.int32
    np.testing.assert_array_equal(tlo.numpy(), np.asarray(jlo))
    np.testing.assert_array_equal(tcnt.numpy(), np.asarray(jcnt))
    cand_max = 40                                   # below the 500-run
    jcnt = jnp.minimum(jcnt, cand_max)
    tcnt = torch.clamp_max(tcnt, cand_max)
    jids = jseg.gather_candidates(jt, jlo, jcnt, cand_max)
    tids = tseg.gather_candidates(tt, tlo, tcnt, cand_max)
    np.testing.assert_array_equal(tids.numpy(), np.asarray(jids))
    np.testing.assert_array_equal(
        tseg.dedup_sorted(tids, 500).numpy(),
        np.asarray(jseg.dedup_sorted(jids, sentinel=500)))
