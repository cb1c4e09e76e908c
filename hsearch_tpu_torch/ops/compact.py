"""Single-buffer packed hit transfer (counterpart of hsearch_tpu/ops/compact.py).

Every search engine compacts its per-center hit slots on the device and
ships them to the host as ONE flat int32 buffer, in exactly the layout of
the JAX package, so that each side decodes the other's buffers:

    [0]                 kid_bits if (cid, kid) are fused into one word,
                        else 0 (split layout); NEGATED when the d2 row
                        is omitted (``with_d2=False``, fused only)
    [1]                 cap  (hit capacity of this buffer)
    [2]                 total valid hits (may exceed cap -> overflow)
    [3 : 3+n_meta]      caller meta vectors (e.g. per-center hit counts)
    then, fused layout (when cid_bits + kid_bits <= 32):
        [.. : ..+cap]   (cid << kid_bits) | kid   per hit
        [.. : ..+cap]   float32 squared distance, bitcast to int32
                        (absent when [0] < 0)
    or split layout:
        three cap-rows: cid, kid, d2-bits.

Valid slots are gathered in row-major order with a stable sort on the
validity key, which keeps the device stream free of host synchronisation
(``nonzero`` would wait for the device) and gives the JAX package's order
for the first ``total`` entries.
"""

from __future__ import annotations

import numpy as np
import torch

_HDR = 3


def pack_hits(ids: torch.Tensor, d2: torch.Tensor, sentinel,
              meta_vecs: tuple = (), cid_offset=None,
              cap_frac: int = 4, cid_bound: int | None = None,
              id_bound: int | None = None,
              with_d2: bool = True) -> torch.Tensor:
    """Device-side pack of (C, k) hit slots into one flat int32 buffer.

    ids: (C, k) integer, invalid slots >= ``sentinel``; d2: (C, k) float32.
    meta_vecs: int32 vectors stored after the header.  cid_offset: scalar
    added to every center id.  cid_bound / id_bound: upper bounds
    (exclusive) on the center id after offset and on valid point ids;
    they decide whether the fused 1-word (cid, kid) layout fits 32 bits.
    cap = max(C*k // cap_frac, 1).  with_d2=False omits the d2 row (fused
    layout only).
    """
    c, k = ids.shape
    dev = ids.device
    flat = ids.reshape(-1).to(torch.int64)
    valid = flat < sentinel
    pos = torch.arange(c * k, dtype=torch.int64, device=dev)
    skey = torch.where(valid, pos, torch.full_like(pos, c * k))
    perm = torch.sort(skey, stable=True).indices
    cid = pos // k
    if cid_offset is not None:
        cid = cid + int(cid_offset)
    if cid_bound is None:
        cid_bound = c if cid_offset is None else 0   # 0 -> force split
    if id_bound is None:
        id_bound = int(sentinel) if isinstance(sentinel, (int,
                                                          np.integer)) else 0
    kid_bits = max(int(id_bound - 1).bit_length(), 1)
    cid_bits = max(int(cid_bound - 1).bit_length(), 1)
    fused = 0 < cid_bound and 0 < id_bound and cid_bits + kid_bits <= 32
    total = valid.sum().to(torch.int32).reshape(1)
    cap = max((c * k) // cap_frac, 1)
    drop_d2 = fused and not with_d2
    # torch.full fills on the device; a host-built header tensor would be
    # a host->device copy that synchronises the stream
    word0 = (-kid_bits if drop_d2 else kid_bits) if fused else 0
    head = [torch.full((1,), word0, dtype=torch.int32, device=dev),
            torch.full((1,), cap, dtype=torch.int32, device=dev),
            total, *[m.to(torch.int32) for m in meta_vecs]]
    take = perm[:cap]
    if fused:
        # the fused word may reach the sign bit (cid_bits + kid_bits ==
        # 32): build it in int64, keep the low 32 bits and reinterpret
        # them as int32; slots past ``total`` are never decoded
        word = (cid[take] << kid_bits) | (flat[take] & ((1 << kid_bits) - 1))
        word = word & 0xFFFFFFFF
        word = torch.where(word >= (1 << 31), word - (1 << 32), word)
        rows = [word.to(torch.int32)]
        if drop_d2:
            return torch.cat(head + rows)
    else:
        rows = [cid[take].to(torch.int32), flat[take].to(torch.int32)]
    d2f = d2.reshape(-1).to(torch.float32)[take].contiguous()
    rows.append(d2f.view(torch.int32))
    return torch.cat(head + rows)


def unpack_hits(packed: np.ndarray, meta_lens: tuple = ()):
    """Host-side unpack of one pack_hits buffer (either package's).

    Returns (hits, metas): ``metas`` is a list of int32 vectors matching
    ``meta_lens``; ``hits`` is (cid, kid, d2) arrays of length ``total``
    (d2 is None for a ``with_d2=False`` buffer), or None when the packed
    capacity overflowed (the caller reads the full buffers: ``full_hits``).
    """
    out = np.asarray(packed).reshape(-1)
    kid_bits, cap, tot = int(out[0]), int(out[1]), int(out[2])
    metas, off = [], _HDR
    for ln in meta_lens:
        metas.append(out[off:off + ln])
        off += ln
    if tot > cap:
        return None, metas
    if kid_bits:
        w = out[off:off + tot].view(np.uint32)
        cid = (w >> abs(kid_bits)).astype(np.int32)
        kid = (w & np.uint32((1 << abs(kid_bits)) - 1)).astype(np.int32)
        d2 = out[off + cap:off + cap + tot].view(np.float32) \
            if kid_bits > 0 else None
    else:
        cid = out[off:off + tot]
        kid = out[off + cap:off + cap + tot]
        d2 = out[off + 2 * cap:off + 2 * cap + tot].view(np.float32)
    return (cid, kid, d2), metas


def full_hits(ids: torch.Tensor, d2: torch.Tensor, sentinel,
              real: int | None = None):
    """Host-side read of the full (C, k) hit slots behind a packed buffer
    that overflowed.

    Reads ``ids`` and ``d2`` back; slots with ids >= ``sentinel``, and
    every slot of rows ``real:`` (padding centers), are not hits.  Returns
    (cid int64, kid int64, d2, nbytes): the hits in row-major order, d2 in
    its buffer's dtype, and the bytes read back.
    """
    idsh = ids.cpu().numpy()
    d2h = d2.cpu().numpy()
    valid = idsh < sentinel
    if real is not None:
        valid[real:] = False
    hc, hm = np.nonzero(valid)
    return (hc.astype(np.int64), idsh[hc, hm].astype(np.int64), d2h[hc, hm],
            idsh.nbytes + d2h.nbytes)
