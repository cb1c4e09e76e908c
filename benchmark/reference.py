"""The plain reference: exact brute-force radius search in plain PyTorch.

It imports nothing of the port and takes nothing the port made: it reads
the raw k-mer rows and query centers that the benchmark drew, with its own
frozen copy of the 20x8 BLOSUM62 coordinate table.  The squared distance
of two k-mers is ``sum_l DSQ[a_l, b_l]`` with ``DSQ`` the squared
Euclidean distances between residue coordinates (the metric the
reference's ``motif_both_points.cpp`` searches in).  It is computed for
every (center, row) pair as one product of each center's (L*20) table of
``DSQ`` rows with each row's one-hot code, so each entry is exactly the
sum of the table entries.

``precision="float64"`` is the reference.  ``precision="tf32"`` is the
control: the same search with the table rounded to TF32's 10-bit mantissa,
as the tensor cores round a float32 operand, accumulated in float32.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

#: 20x8 MDS embedding of the BLOSUM62 metric, rows ARNDCQEGHILKMFPSTWYV
#: (recorded in the reference at hclust/src/hclust/util.hpp:21-42).
COORDINATES = np.array([
    [-0.876280, 3.598596, 2.554616, -0.729216, 0.698828, 1.221507, -2.765205, -3.163091],
    [-4.111404, -1.936791, -2.682295, 0.942498, 6.924314, -1.195785, -1.639269, 0.615381],
    [-7.471612, -2.468058, 0.932738, -4.488355, 0.553080, -3.081577, 0.368010, 4.223792],
    [-8.317871, -0.848602, 1.752372, -1.407818, -4.874022, -1.493568, 5.256411, -2.561758],
    [5.421664, 11.791877, 2.675596, -5.622478, 4.322457, 3.946839, 2.229597, -1.901479],
    [-3.771796, -2.525005, -1.567736, 2.619391, 2.781873, 0.952486, 3.947072, -0.954304],
    [-6.585010, -2.752755, -1.649014, 1.605597, -1.833933, -0.730211, 2.313328, -3.239486],
    [-3.978253, -1.155062, 9.994796, -0.195264, -1.110059, -2.860194, -4.952672, -1.495210],
    [-2.630176, -8.283034, -4.773107, -6.479084, 0.070359, 4.318067, -1.847373, -0.086451],
    [4.548022, 5.189698, -3.999001, -0.186966, -3.275059, -1.882387, -0.627095, 0.049364],
    [5.341899, 4.436639, -3.552811, 1.250614, 0.266899, -2.609335, -0.694939, 0.812004],
    [-5.742562, -1.207887, -2.587323, 2.866228, 4.169821, -1.991698, -1.941954, -0.747156],
    [4.241223, 2.474317, -2.658336, 2.946054, 2.011534, -3.254331, 1.266004, -0.186966],
    [9.340442, -3.359172, -0.635377, -2.878570, -3.255191, -2.200202, -1.104637, -0.062654],
    [-6.150933, 3.182318, 0.122393, 7.788554, -3.094076, 6.831600, -1.992627, 1.807240],
    [-2.523437, 1.824168, 3.256463, -2.386830, 0.439791, 1.024198, 0.486894, 1.190316],
    [-0.823028, 3.115233, 2.075337, -0.585875, -1.471153, 0.518398, 1.846290, 6.269577],
    [13.592409, -8.961858, 6.548108, 4.623650, 2.128797, 0.808588, 2.631353, 0.521535],
    [7.173223, -6.765800, -2.811202, -1.654989, -1.878135, 3.104673, -1.272146, -0.635970],
    [3.323480, 4.651177, -2.996218, 1.972858, -3.576126, -1.427066, -1.507041, -0.454682],
], dtype=np.float64)

PRECISIONS = ("float64", "tf32")


def dsq_table(device) -> torch.Tensor:
    """(20, 20) float64 squared distances between residue coordinates."""
    c = torch.as_tensor(COORDINATES, dtype=torch.float64, device=device)
    d = c[:, None, :] - c[None, :, :]
    return (d * d).sum(-1)


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 ``x`` rounded to TF32 (10 mantissa bits), to nearest with
    ties away from zero, as ``cvt.rna.tf32.f32`` rounds (finite x)."""
    bits = x.contiguous().view(torch.int32)
    bits = (bits + 0x1000) & ~0x1FFF
    return bits.view(torch.float32)


def _tables(centers: torch.Tensor, precision: str) -> torch.Tensor:
    """(C, L) centers -> (C, L*20) rows of DSQ in the search's dtype."""
    tab = dsq_table(centers.device)[centers.long()]          # (C, L, 20)
    tab = tab.reshape(centers.shape[0], -1)
    if precision == "tf32":
        return round_tf32(tab.to(torch.float32))
    return tab


def _onehot(rows: torch.Tensor, dtype) -> torch.Tensor:
    return F.one_hot(rows.long(), 20).reshape(rows.shape[0], -1).to(dtype)


def radius_hits(db: torch.Tensor, centers: torch.Tensor, radius: float,
                precision: str = "float64", center_block: int = 1024,
                row_chunk: int = 1 << 18):
    """Every (center, row) pair with squared distance <= radius**2.

    db (N, L) and centers (C, L) hold amino-acid indices.  Returns
    (center (M,) int64, row (M,) int64, d2 (M,) float64), sorted by
    (center, row).  Runs where ``db`` lies, in blocks of ``center_block``
    centers by ``row_chunk`` rows, with TF32 off for the product.
    """
    if precision not in PRECISIONS:
        raise ValueError(f"precision {precision!r}")
    dtype = torch.float64 if precision == "float64" else torch.float32
    r2 = float(radius) ** 2
    out_c, out_r, out_d = [], [], []
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        tabs = [_tables(centers[s:s + center_block], precision)
                for s in range(0, centers.shape[0], center_block)]
        for lo in range(0, db.shape[0], row_chunk):
            hot = _onehot(db[lo:lo + row_chunk], dtype)
            for bi, tab in enumerate(tabs):
                d2 = tab @ hot.T
                c, r = torch.nonzero(d2 <= r2, as_tuple=True)
                out_c.append(c + bi * center_block)
                out_r.append(r + lo)
                out_d.append(d2[c, r].to(torch.float64))
                del d2
            del hot
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    if not out_c:
        e = torch.empty(0, dtype=torch.int64, device=db.device)
        return e, e, torch.empty(0, dtype=torch.float64, device=db.device)
    c, r, d = torch.cat(out_c), torch.cat(out_r), torch.cat(out_d)
    order = torch.argsort(c * db.shape[0] + r)
    return c[order], r[order], d[order]


def pair_d2(db: torch.Tensor, centers: torch.Tensor, ci: torch.Tensor,
            ri: torch.Tensor, block: int = 1 << 22) -> torch.Tensor:
    """Squared distances (float64) of the pairs (centers[ci], db[ri]), by
    the table lookups themselves, in blocks of ``block`` pairs."""
    dsq = dsq_table(db.device)
    out = []
    for s in range(0, ci.numel(), block):
        a = centers[ci[s:s + block]].long()
        b = db[ri[s:s + block]].long()
        out.append(dsq[a, b].sum(dim=1))
    if not out:
        return torch.empty(0, dtype=torch.float64, device=db.device)
    return torch.cat(out)
