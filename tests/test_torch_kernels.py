"""The CUDA kernels' plain versions against hsearch_tpu's Pallas kernels in
interpret mode, at tests/test_pallas.py's shapes and tolerances; the CPU
dispatch of the wrappers; and, on a machine with a CUDA device, each
kernel against its plain version.

The CUDA case needs neither jax nor tests/conftest.py, so it also runs on
a GPU host without JAX:

    python -m pytest --noconftest -p no:cacheprovider -m cuda \
        tests/test_torch_kernels.py
"""

import numpy as np
import pytest
import torch

from hsearch_tpu_torch.ops import cuda_kernels as ck
from hsearch_tpu_torch.ops import distance as td


def _prune_inputs(rng):
    q = rng.normal(0, 10, (200, 80)).astype(np.float32)
    c = rng.normal(0, 10, (300, 80)).astype(np.float32)
    rad = np.abs(rng.normal(0, 5, 300)).astype(np.float32)
    return q, c, rad


@pytest.mark.parametrize("r", [30.0, 121.5])   # 121.5: ~half the keys live
def test_prune_plain_matches_pallas(rng, r):
    pk = pytest.importorskip("hsearch_tpu.ops.pallas_kernels")
    q, c, rad = _prune_inputs(rng)
    want = np.asarray(pk.sq_distance_prune(q, c, rad, r, interpret=True))
    got = ck.sq_distance_prune_plain(torch.as_tensor(q), torch.as_tensor(c),
                                     torch.as_tensor(rad), r).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-3)
    if r > 100:
        assert 0.2 < np.isfinite(want).mean() < 0.8


def test_ptable_verify_plain_matches_pallas(rng):
    import jax.numpy as jnp
    pk = pytest.importorskip("hsearch_tpu.ops.pallas_kernels")
    c, m, l = 6, 1000, 25
    ptab = rng.random((c, l, 20)).astype(np.float32)
    cand = rng.integers(0, 20, (c, m, l)).astype(np.int8)
    want = np.asarray(pk.ptable_verify(jnp.asarray(ptab), jnp.asarray(cand),
                                       interpret=True))
    got = ck.ptable_verify_plain(torch.as_tensor(ptab),
                                 torch.as_tensor(cand)).numpy()
    np.testing.assert_allclose(got, want, rtol=2e-6, atol=1e-4)


def test_cpu_wrappers_take_plain_versions(rng):
    q, c, rad = _prune_inputs(rng)
    qt, ct, rt = (torch.as_tensor(x) for x in (q, c, rad))
    ptab = torch.rand(3, 7, 20)
    cand = torch.randint(0, 20, (3, 50, 7)).to(torch.int8)
    ck.reset_launches()
    assert torch.equal(ck.sq_distance_prune(qt, ct, rt, 121.5),
                       ck.sq_distance_prune_plain(qt, ct, rt, 121.5))
    assert torch.equal(ck.ptable_verify(ptab, cand),
                       td.ptable_distances(ptab, cand))
    # the counts record kernel launches only
    assert ck.launch_counts() == {"sq_distance_prune": 0,
                                  "ptable_verify": 0}


def test_non_cpu_tensors_never_fall_back():
    # a tensor that is not on the CPU goes to the kernel path, which
    # refuses anything but CUDA tensors instead of computing elsewhere
    q = torch.empty((4, 16), device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        ck.sq_distance_prune(q, torch.empty((5, 16), device="meta"),
                             torch.empty(5, device="meta"), 1.0)
    with pytest.raises(ValueError, match="CUDA"):
        ck.ptable_verify(torch.empty((2, 3, 20), device="meta"),
                         torch.empty((2, 9, 3), dtype=torch.int8,
                                     device="meta"))


@pytest.mark.cuda
def test_kernels_match_plain_on_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")
    rng = np.random.default_rng(0)
    dev = torch.device("cuda")
    q, c, rad = (torch.as_tensor(x, device=dev) for x in _prune_inputs(rng))
    got = ck.sq_distance_prune(q, c, rad, 121.5)
    want = ck.sq_distance_prune_plain(q, c, rad, 121.5)
    both = torch.isfinite(got) & torch.isfinite(want)
    assert both.any()
    torch.testing.assert_close(got[both], want[both], rtol=1e-4, atol=1e-3)
    ptab = torch.as_tensor(rng.random((6, 25, 20)).astype(np.float32),
                           device=dev)
    cand = torch.as_tensor(rng.integers(0, 20, (6, 1000, 25))
                           .astype(np.int8), device=dev)
    assert torch.equal(ck.ptable_verify(ptab, cand),
                       ck.ptable_verify_plain(ptab, cand))
