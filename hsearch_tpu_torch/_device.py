"""Device and precision policy: the one place that picks a device.

The reference runs every exact GEMM at ``Precision.HIGHEST``
(hsearch_tpu/ops/distance.py:27-29).  On Hopper a float32 product may run
in TF32, which keeps ~3 decimal digits and flips the ``d2 <= R^2`` test
near the radius, so every entry point turns TF32 off before it touches a
tensor.
"""

from __future__ import annotations

import torch


def set_precision() -> None:
    """Full float32 for matmuls and convolutions (no TF32)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


def resolve(device: str | torch.device = "cuda") -> torch.device:
    """The device an entry point runs on; never a silent CPU fallback.

    ``"cuda"`` (the default everywhere) raises when no CUDA device is
    present — the caller must ask for ``"cpu"`` explicitly.
    """
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(device)!r} requested but CUDA is not available; "
            "pass device='cpu' to run on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {str(device)!r}")
    set_precision()
    return dev
