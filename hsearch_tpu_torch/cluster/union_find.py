"""Union-find for transitive cluster merging (own copy of
hsearch_tpu/cluster/union_find.py).

``connected_components`` labels a graph given as an edge list through the
C++ host library (``native_ext.union_find_labels``); ``UnionFind`` keeps
the reference semantics (smallest root wins) for incremental use and is
that function's plain version.
"""

from __future__ import annotations

import numpy as np

from .. import native_ext


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
    """(N,) component label of each node of the undirected graph on n
    nodes with the given edges: the component's smallest node, as
    ``UnionFind.components`` and the JAX package label it."""
    return native_ext.union_find_labels(n, src, dst)
