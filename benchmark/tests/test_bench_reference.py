"""The plain reference against a numpy brute force, and the control's
rounding."""

import numpy as np
import pytest
import torch

from benchmark import reference


def _numpy_d2(db, centers):
    c = reference.COORDINATES
    dsq = ((c[:, None, :] - c[None, :, :]) ** 2).sum(-1)
    return dsq[centers[:, None, :], db[None, :, :]].sum(-1)


def _tiny(seed=5, n=300, p=7, l=5):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, 20, (n, l)).astype(np.int8),
            rng.integers(0, 20, (p, l)).astype(np.int8))


@pytest.mark.parametrize("center_block,row_chunk", [(1024, 1 << 18), (3, 64)])
def test_radius_hits_equal_numpy_brute_force(center_block, row_chunk):
    db, centers = _tiny()
    d2 = _numpy_d2(db.astype(np.int64), centers.astype(np.int64))
    radius = float(np.sqrt(np.quantile(d2, 0.3)))
    c, r, got = reference.radius_hits(torch.as_tensor(db),
                                      torch.as_tensor(centers), radius,
                                      center_block=center_block,
                                      row_chunk=row_chunk)
    wc, wr = np.nonzero(d2 <= radius ** 2)
    np.testing.assert_array_equal(c.numpy(), wc)
    np.testing.assert_array_equal(r.numpy(), wr)
    np.testing.assert_allclose(got.numpy(), d2[wc, wr], rtol=1e-12)
    pd2 = reference.pair_d2(torch.as_tensor(db), torch.as_tensor(centers),
                            c, r, block=5)
    np.testing.assert_allclose(pd2.numpy(), d2[wc, wr], rtol=1e-12)


def test_control_is_tf32_rounded():
    x = torch.tensor([1.0, 1.0 + 2 ** -11, 1.0 + 2 ** -10, 3.14159265,
                      1225.0, 0.0])
    y = reference.round_tf32(x)
    # 10 mantissa bits: a half step rounds away from zero
    assert y[0] == 1.0 and y[1] == 1.0 + 2 ** -10 and y[2] == 1.0 + 2 ** -10
    assert y[4] == 1225.0 and y[5] == 0.0
    assert abs(float(y[3]) - 3.14159265) <= 3.14159265 * 2 ** -11
    bits = y.view(torch.int32)
    assert bool(((bits & 0x1FFF) == 0).all())
    db, centers = _tiny(seed=6)
    radius = 40.0
    ref = reference.radius_hits(torch.as_tensor(db),
                                torch.as_tensor(centers), radius)
    ctl = reference.radius_hits(torch.as_tensor(db),
                                torch.as_tensor(centers), radius,
                                precision="tf32")
    both = set(zip(ref[0].tolist(), ref[1].tolist())) & \
        set(zip(ctl[0].tolist(), ctl[1].tolist()))
    assert len(both) >= 0.95 * ref[0].numel()
    a = dict(zip(zip(ref[0].tolist(), ref[1].tolist()), ref[2].tolist()))
    b = dict(zip(zip(ctl[0].tolist(), ctl[1].tolist()), ctl[2].tolist()))
    gap = max(abs(a[k] - b[k]) / max(a[k], 1.0) for k in both)
    assert 1e-6 < gap < 2e-3


@pytest.mark.cuda
def test_radius_hits_on_the_card_equal_the_cpu():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    db, centers = _tiny(seed=8, n=5000, p=40, l=25)
    want = reference.radius_hits(torch.as_tensor(db),
                                 torch.as_tensor(centers), 45.0)
    got = reference.radius_hits(torch.as_tensor(db, device="cuda"),
                                torch.as_tensor(centers, device="cuda"),
                                45.0, row_chunk=1024)
    for w, g in zip(want, got):
        torch.testing.assert_close(g.cpu(), w, rtol=1e-12, atol=0)
