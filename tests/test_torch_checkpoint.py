"""The ``seed`` checkpoint kind of hsearch_tpu_torch.utils.checkpoint: a
SeedIndex saved by either package loads in the other with equal arrays,
equal ``g10_at`` and equal probe results; a group-partitioned index keeps
its ``group_starts``.  Mirrors tests/test_utils.py's seed cases."""

import numpy as np
import pytest

from hsearch_tpu.align import seed_index as jsi
from hsearch_tpu.utils import checkpoint as jcheckpoint
from hsearch_tpu_torch.align import seed_index
from hsearch_tpu_torch.utils import checkpoint

FIELDS = ("sorted_codes", "positions", "seq", "starts", "group_starts",
          "g10_at")


def _corpus(rng, grouped):
    lens = rng.integers(12, 40, 24)
    # an 8-letter alphabet: many shared seeds, buckets of several positions
    seq = rng.integers(0, 8, int(lens.sum())).astype(np.int32)
    starts = np.concatenate([[0], np.cumsum(lens)]).astype(np.int64)
    groups = np.repeat(np.arange(3), 8) if grouped else None
    return seq, starts, groups


def _probe(view, seq, starts, groups, probe_host):
    code, _, v10, qg10 = seed_index.host_codes(seq, starts)
    q = np.nonzero(v10)[0]
    qgroups = None if groups is None \
        else np.repeat(groups, np.diff(starts))[q]
    return probe_host(view, code[q], qg10[q], 4, qgroups)


@pytest.mark.parametrize("grouped", [False, True])
@pytest.mark.parametrize("writer", ["torch", "jax"])
def test_seed_checkpoint_crosses_packages(tmp_path, rng, writer, grouped):
    seq, starts, groups = _corpus(rng, grouped)
    idx = seed_index.build_index(seq, starts, groups)
    jidx = jsi.build_index(seq, starts, groups)
    path = str(tmp_path / "seed.npz")
    if writer == "torch":
        checkpoint.save_index(path, idx)
    else:
        jcheckpoint.save_index(path, jidx)
    assert checkpoint.peek(path)[0] == "seed"
    got = checkpoint.load_index(path, device="cpu")
    want = jcheckpoint.load_index(path)
    assert isinstance(got, seed_index.SeedIndex)
    assert (got.group_starts is not None) == grouped
    for f in FIELDS:
        g, w, o = getattr(got, f), getattr(want, f), getattr(idx, f)
        if w is None:
            assert g is None and o is None
            continue
        np.testing.assert_array_equal(g, np.asarray(w), err_msg=f)
        np.testing.assert_array_equal(g, o, err_msg=f)
    assert got.sorted_codes.dtype == np.uint32
    assert got.positions.dtype == np.int64
    res = _probe(seed_index.host_view(got), seq, starts, groups,
                 seed_index.probe_host)
    jres = _probe(jsi.host_view(want), seq, starts, groups, jsi.probe_host)
    ores = _probe(seed_index.host_view(idx), seq, starts, groups,
                  seed_index.probe_host)
    for a, b, c in zip(res[:2], jres[:2], ores[:2]):
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(a, c)
    assert res[2] == jres[2] and len(res[0]) > 100


def test_unknown_kind_is_refused(tmp_path):
    path = str(tmp_path / "x.npz")
    np.savez(path, __kind__="nope", meta="{}")
    with pytest.raises(ValueError, match="unknown index kind 'nope'"):
        checkpoint.load_index(path, device="cpu")
    with pytest.raises(TypeError, match="unknown index type"):
        checkpoint.save_index(path, object())
