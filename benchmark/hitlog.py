"""The window's hits, kept for the judge after the window closes.

Each batch's hits are copied, as they arrive, into chunks that set-up
allocated and touched: (center's position in its batch, k-mer id,
distance) as (int32, int32, float32), with a value outside its batch or
outside the database stored as -1.  The program's own arrays are then
freed as it would free them for any client, so the process's memory
stays steady through the window instead of growing with every batch.
"""

from __future__ import annotations

import numpy as np
import torch

CHUNK = 1 << 22        # hits per chunk: 48 MiB


class HitLog:
    def __init__(self, n_rows: int, reserve: int = 0):
        self.n_rows = int(n_rows)
        self.sent: list = []          # pool indices of each batch
        self.counts: list = []        # hits of each batch
        self.chunks: list = []
        for _ in range(-(-int(reserve) // CHUNK)):
            self._grow()
        self._next = -1               # the chunk being filled
        self.fill = CHUNK             # hits in it

    def _grow(self) -> None:
        chunk = (np.zeros(CHUNK, np.int32), np.zeros(CHUNK, np.int32),
                 np.zeros(CHUNK, np.float32))
        for a in chunk:               # touch every page now, not later
            a.fill(1)
        self.chunks.append(chunk)

    def add(self, pool_ids: np.ndarray, hits) -> None:
        """One batch: its pool indices and the (ci, ki, d) it returned."""
        ci, ki, d = (np.asarray(x) for x in hits)
        b = len(pool_ids)
        ci = np.where((ci >= 0) & (ci < b), ci, -1)
        ki = np.where((ki >= 0) & (ki < self.n_rows), ki, -1)
        self.sent.append(np.asarray(pool_ids))
        self.counts.append(len(ci))
        s = 0
        while s < len(ci):
            if self.fill == CHUNK:
                self._next += 1
                if self._next == len(self.chunks):
                    self._grow()
                self.fill = 0
            c_ci, c_ki, c_d = self.chunks[self._next]
            m = min(CHUNK - self.fill, len(ci) - s)
            sl = slice(self.fill, self.fill + m)
            c_ci[sl], c_ki[sl], c_d[sl] = ci[s:s + m], ki[s:s + m], \
                d[s:s + m]
            self.fill += m
            s += m

    @classmethod
    def of(cls, n_rows: int, batches: list) -> "HitLog":
        """A log of [(pool indices, (ci, ki, d))]."""
        log = cls(n_rows)
        for ids, hits in batches:
            log.add(ids, hits)
        return log

    def tensors(self, device: torch.device):
        """(batch id, pool index of the center or -1, k-mer id or -1,
        distance as float64), each (H,), on ``device``."""
        total = int(sum(self.counts))
        ci = np.empty(total, np.int64)
        ki = np.empty(total, np.int64)
        d = np.empty(total, np.float64)
        s = 0
        for k, (a, b, c) in enumerate(self.chunks[:self._next + 1]):
            m = CHUNK if k < self._next else self.fill
            ci[s:s + m], ki[s:s + m], d[s:s + m] = a[:m], b[:m], c[:m]
            s += m
        bid = np.repeat(np.arange(len(self.counts)), self.counts)
        offsets = np.cumsum([0] + [len(x) for x in self.sent])
        flat = np.concatenate(self.sent) if self.sent else \
            np.empty(0, np.int64)
        pid = np.where(ci >= 0, flat[offsets[bid] + np.maximum(ci, 0)]
                       if total else ci, -1)
        t = (lambda x: torch.as_tensor(x, device=device))
        return t(bid), t(pid), t(ki), t(d)

    def sent_ids(self) -> np.ndarray:
        return np.concatenate(self.sent) if self.sent else \
            np.empty(0, np.int64)
