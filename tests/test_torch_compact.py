"""Packed hit buffers: hsearch_tpu_torch.ops.compact and hsearch_tpu.ops.compact
decode each other's buffers (fused, split, with_d2=False, 32-bit fused
word, overflow), and an overflowed buffer's full slots read back."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hsearch_tpu.ops import compact as jc
from hsearch_tpu_torch.ops import compact as tc

# (C, k, sentinel, pack kwargs)
LAYOUTS = {
    "fused": (8, 16, 1000, {}),
    "split": (8, 16, 1000, {"cid_offset": 5}),
    "no_d2": (8, 16, 1000, {"with_d2": False}),
    # cid_bits (4) + kid_bits (28) == 32: the fused word reaches the sign bit
    "fused_32bit": (16, 8, 1 << 28, {"cap_frac": 2}),
    "overflow": (8, 16, 1000, {"cap_frac": 16}),
    "overflow_padded": (8, 16, 1000, {"cap_frac": 16}),
}
# the real (unpadded) center rows full_hits is given, by overflow layout
OVERFLOW_REAL = {"overflow": None, "overflow_padded": 5}


def _slots(rng, c, k, sentinel):
    ids = rng.integers(0, sentinel, (c, k)).astype(np.int64)
    ids[rng.random((c, k)) < 0.85] = sentinel         # invalid slots
    if sentinel > 1000:
        ids[:, 0] = sentinel - 1                      # the top kid bits set
    d2 = rng.random((c, k)).astype(np.float32) * 100
    meta = rng.integers(0, 50, c).astype(np.int32)
    return ids, d2, meta


def _unpacked_equal(a, b, c):
    (ha, ma), (hb, mb) = a, b
    assert len(ma) == len(mb) == 1
    np.testing.assert_array_equal(ma[0], mb[0])
    if ha is None or hb is None:
        assert ha is None and hb is None
        return
    for xa, xb in zip(ha, hb):
        if xa is None or xb is None:
            assert xa is None and xb is None
        else:
            np.testing.assert_array_equal(xa, xb)


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_cross_decode(rng, layout):
    c, k, sentinel, kw = LAYOUTS[layout]
    ids, d2, meta = _slots(rng, c, k, sentinel)
    j_buf = np.asarray(jc.pack_hits(jnp.asarray(ids.astype(np.int32)),
                                    jnp.asarray(d2), sentinel,
                                    meta_vecs=(jnp.asarray(meta),), **kw))
    t_buf = tc.pack_hits(torch.as_tensor(ids), torch.as_tensor(d2),
                         sentinel, meta_vecs=(torch.as_tensor(meta),),
                         **kw).numpy()
    assert t_buf.dtype == np.int32 and t_buf.shape == j_buf.shape
    # header: layout word, cap, total, meta
    np.testing.assert_array_equal(t_buf[:3 + c], j_buf[:3 + c])
    total = int(j_buf[2])
    assert total == int((ids < sentinel).sum())
    # each side decodes the other's buffer to the same hits
    for unpack in (tc.unpack_hits, jc.unpack_hits):
        _unpacked_equal(unpack(t_buf, (c,)), unpack(j_buf, (c,)), c)
    hits, _ = tc.unpack_hits(j_buf, (c,))
    if layout in OVERFLOW_REAL:
        assert hits is None and total > int(j_buf[1])
        real = OVERFLOW_REAL[layout]
        hc, hk, hd, nbytes = tc.full_hits(torch.as_tensor(ids),
                                          torch.as_tensor(d2), sentinel, real)
        valid = ids < sentinel
        if real is not None:
            assert valid[real:].any()                 # the mask drops hits
            valid[real:] = False
        want_c, want_k = np.nonzero(valid)
        assert hc.dtype == hk.dtype == np.int64 and hd.dtype == np.float32
        np.testing.assert_array_equal(hc, want_c)
        np.testing.assert_array_equal(hk, ids[want_c, want_k])
        np.testing.assert_array_equal(hd, d2[want_c, want_k])
        assert nbytes == ids.nbytes + d2.nbytes
        return
    cid, kid, hd2 = hits
    want_c, want_k = np.nonzero(ids < sentinel)
    np.testing.assert_array_equal(cid, want_c + kw.get("cid_offset", 0))
    np.testing.assert_array_equal(kid, ids[want_c, want_k])
    if kw.get("with_d2", True):
        np.testing.assert_array_equal(hd2, d2[want_c, want_k])
    else:
        assert hd2 is None
