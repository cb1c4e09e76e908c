"""A run on the CPU at a tiny size, past the look for a card: a sound
engine is judged correct, and each fault the cells can have, planted in
the timed path, and the control in the program's place, are judged not
correct."""

import numpy as np
import pytest
import torch

from conftest import run_tiny

from benchmark import reference

CELLS = ("tiny-pfam25-resident.b8", "tiny-pfam25-streamed.b8")


class Planted:
    """The engine, with ``fault(batch_no, centers, hits)`` applied to what
    each batch returns."""

    def __init__(self, engine, fault):
        self.engine, self.fault, self.calls = engine, fault, 0
        self.prev = None

    @property
    def stats(self):
        return self.engine.stats

    def search(self, centers):
        hits = self.engine.search(centers)
        self.calls += 1
        out = self.fault(self, centers, hits)
        self.prev = hits
        return out

    def call_shapes(self, batch):
        return self.engine.call_shapes(batch)

    def close(self):
        self.engine.close()


def stale(eng, centers, hits):
    """A step that returns its state unchanged: the last batch's hits."""
    return hits if eng.prev is None else eng.prev


def half(eng, centers, hits):
    """Half of the batch left out: only the first half's hits return."""
    ci, ki, d = hits
    keep = ci < len(centers) // 2
    return ci[keep], ki[keep], d[keep]


def altered_id(eng, centers, hits):
    """An answer altered where it is produced: one hit's k-mer id."""
    ci, ki, d = (x.copy() for x in hits)
    if len(ki):
        ki[0] = (ki[0] + 1) % 4096
    return ci, ki, d


def altered_distance(eng, centers, hits):
    """An answer altered where it is produced: every distance 1e-4 off."""
    ci, ki, d = hits
    return ci, ki, (d * np.float32(1.0001)).astype(np.float32)


@pytest.mark.parametrize("cell", CELLS)
def test_sound_run_is_correct(cell, tiny):
    reg, _ = tiny
    res = run_tiny(reg, cell, seed=2 ** 31 + 11)
    assert res["correct"], res["checks"]
    assert res["failed"] == 0 and res["attempted"] >= 2
    assert res["checks"]["hit_error"]["value"] < 1e-6
    assert list(res)[-1] == "checks"


def repeated(eng, centers, hits):
    """An answer altered where it is produced: the first hit sent twice."""
    ci, ki, d = hits
    return (np.concatenate([ci[:1], ci]), np.concatenate([ki[:1], ki]),
            np.concatenate([d[:1], d]))


@pytest.mark.parametrize("fault", [stale, half, altered_id,
                                   altered_distance, repeated])
@pytest.mark.parametrize("cell", CELLS)
def test_planted_fault_is_not_correct(cell, fault, tiny):
    reg, _ = tiny
    res = run_tiny(reg, cell, wrap=lambda e, d: Planted(e, fault))
    assert not res["correct"], (fault.__name__, res["checks"])


def test_a_batch_that_raises_is_not_correct(tiny):
    reg, _ = tiny

    def boom(eng, centers, hits):
        if eng.calls == 3:
            raise RuntimeError("lost")
        return hits

    res = run_tiny(reg, CELLS[0], wrap=lambda e, d: Planted(e, boom))
    assert res["failed"] == 1 and not res["correct"]
    assert not res["checks"]["failed_batches"]["ok"]


class Control:
    """The control in the program's place: the reference computed one
    precision lower (TF32) answers every batch."""

    def __init__(self, engine, data_db, radius):
        self.engine, self.db, self.radius = engine, data_db, radius
        self.stats = {}

    def search(self, centers):
        c, r, d2 = reference.radius_hits(self.db, torch.as_tensor(centers),
                                         self.radius, precision="tf32")
        return c.numpy(), r.numpy(), np.sqrt(d2.numpy()).astype(np.float32)

    def call_shapes(self, batch):
        return self.engine.call_shapes(batch)

    def close(self):
        self.engine.close()


@pytest.mark.parametrize("cell", CELLS)
def test_control_is_not_correct(cell, tiny):
    reg, _ = tiny
    res = run_tiny(reg, cell, wrap=lambda e, d: Control(e, d.db, 35.0))
    assert not res["correct"]
    assert res["checks"]["recall"]["ok"]
    assert not res["checks"]["hit_error"]["ok"]
