"""Published peaks of one NVIDIA H100 and the least time of each kernel's
work, counted from its launch shape alone (copied from ``chip_smoke.py``'s
``PEAK_*``, ``_bound_ms`` and the prune and verify counts).

A share of a roofline is this least time over the kernel's device time in
the trace, so it cannot pass 100% unless the count is too high or the
time leaves out part of the work.  Only work fixed by the shapes is
counted: nothing that depends on the data (distinct blocks selected, rows
alive), which could only raise the count.
"""

from __future__ import annotations

# NVIDIA H100 SXM data sheet, dense rates without sparsity, at 700 W
PEAK_F32_FLOPS = 67e12
PEAK_TF32_FLOPS = 495e12
PEAK_BYTES = 3.35e12

# blocks per select group of the prune kernel's group minima
# (hsearch_tpu_torch/csrc/prune.cu GROUP)
PRUNE_GROUP = 64


def bound_s(flops: float, nbytes: float, peak_flops: float = PEAK_F32_FLOPS):
    """(least seconds, "operations" or "bytes"): the larger of the
    operations over the peak rate and the bytes over the HBM bandwidth."""
    t_ops = flops / peak_flops
    t_bytes = nbytes / PEAK_BYTES
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes
                                 else "bytes")


def prune_least_s(c: int, b: int, d: int) -> float:
    """``sq_distance_prune`` on (C, D) centers and (B, D) block centroids:
    the full-float32 product 2*C*B*D at the 3xTF32 rate (three TF32
    products, the least cost of float32 accuracy on the tensor cores);
    bytes: centers, centroids and radii read once, the (C, Bp) keys, the
    (C, Bp/64) group minima and the (C,) alive counts written once."""
    bp = -(-b // PRUNE_GROUP) * PRUNE_GROUP
    nbytes = 4.0 * (c * d + b * d + b + c * bp + c * bp // PRUNE_GROUP + c)
    return bound_s(3 * 2.0 * c * b * d, nbytes, PEAK_TF32_FLOPS)[0]


def verify_least_s(c: int, kb: int, bs: int, l: int) -> float:
    """``ptable_verify`` of C centers over kb selected blocks of bs rows:
    bytes only, the (C, L, 20) tables and the (C, kb) selected ids (int64)
    and keys (f32) read once, the (C, kb*bs) distances and (C,) counts
    written once.  The selected blocks' rows are left out: how many are
    distinct depends on the data."""
    nbytes = 4.0 * c * l * 20 + 12.0 * c * kb + 4.0 * c * kb * bs + 4.0 * c
    return bound_s(0.0, nbytes)[0]
