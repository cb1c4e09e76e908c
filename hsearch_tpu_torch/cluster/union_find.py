"""Union-find for transitive cluster merging (own copy of
hsearch_tpu/cluster/union_find.py).

``connected_components`` labels a graph given as an edge list through
scipy's sparse connected components; ``UnionFind`` keeps the reference
semantics (smallest root wins) for incremental use.
"""

from __future__ import annotations

import numpy as np
from scipy.sparse import coo_matrix
from scipy.sparse.csgraph import connected_components as _cc


class UnionFind:
    def __init__(self, n: int):
        self.parent = np.arange(n, dtype=np.int64)

    def find(self, x: int) -> int:
        p = self.parent
        while p[x] != x:
            p[x] = p[p[x]]   # path halving
            x = p[x]
        return int(x)

    def union(self, a: int, b: int) -> None:
        ra, rb = self.find(a), self.find(b)
        if ra != rb:
            # smaller root wins -> deterministic component labels
            lo, hi = (ra, rb) if ra < rb else (rb, ra)
            self.parent[hi] = lo

    def union_edges(self, src: np.ndarray, dst: np.ndarray) -> None:
        for a, b in zip(np.asarray(src).tolist(), np.asarray(dst).tolist()):
            self.union(a, b)

    def components(self) -> np.ndarray:
        """(N,) root label per element (fully compressed)."""
        p = self.parent
        for i in range(len(p)):
            p[i] = self.find(i)
        return p.copy()

    def groups(self) -> list[np.ndarray]:
        roots = self.components()
        order = np.argsort(roots, kind="stable")
        sr = roots[order]
        cuts = np.nonzero(sr[1:] != sr[:-1])[0] + 1
        return np.split(order, cuts)


def connected_components(n: int, src: np.ndarray,
                         dst: np.ndarray) -> np.ndarray:
    """(N,) component labels 0..n_components-1 of the undirected graph on
    n nodes with the given edges.  The numbering is scipy's: partitions
    equal those of ``UnionFind``, label values need not."""
    src = np.asarray(src, np.int64)
    dst = np.asarray(dst, np.int64)
    # duplicate edges are summed: int32 weights cannot wrap to 0
    graph = coo_matrix((np.ones(len(src), np.int32), (src, dst)),
                       shape=(n, n))
    _, labels = _cc(graph, directed=False)
    return labels.astype(np.int64)
