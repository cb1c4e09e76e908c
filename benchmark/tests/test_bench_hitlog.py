"""The hit log across chunk boundaries, with reserved and grown chunks."""

import numpy as np
import pytest
import torch

from benchmark import hitlog


@pytest.mark.parametrize("reserve", [0, 10, 40])
def test_hits_survive_chunk_boundaries(monkeypatch, reserve):
    monkeypatch.setattr(hitlog, "CHUNK", 7)
    rng = np.random.default_rng(1)
    log = hitlog.HitLog(n_rows=50, reserve=reserve)
    want = []
    for b in range(6):
        ids = rng.permutation(20)[:4]
        m = int(rng.integers(0, 12))
        ci = rng.integers(-1, 5, m)            # -1 and 4: outside the batch
        ki = rng.integers(-3, 60, m)           # <0 and >=50: outside the db
        d = rng.random(m).astype(np.float32)
        log.add(ids, (ci, ki, d))
        for c, k, x in zip(ci, ki, d):
            ok = 0 <= c < 4
            want.append((b, ids[c] if ok else -1,
                         k if 0 <= k < 50 else -1, float(x)))
    bid, pid, ki, d = log.tensors(torch.device("cpu"))
    got = list(zip(bid.tolist(), pid.tolist(), ki.tolist(), d.tolist()))
    assert got == want
    assert len(log.sent_ids()) == 24
