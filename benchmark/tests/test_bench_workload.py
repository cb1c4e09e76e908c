"""The database drawn from the seed: the published statistics it is
drawn from, its family structure, and the same inputs for the same seed."""

import numpy as np
import pytest
import torch

from benchmark import protein_model, reference, workload

CFG = {"n_rows": 20000, "kmer_len": 25, "family_size": 100, "pool": 64,
       "identity_min": 0.62}


def test_tables_match_the_program_and_sum_to_one():
    from hsearch_tpu_torch.core import blosum
    np.testing.assert_array_equal(protein_model.BLOSUM62,
                                  blosum.BLOSUM62[:20, :20])
    assert protein_model.background().sum() == pytest.approx(1.0)
    sub = protein_model.substitution()
    assert np.allclose(sub.sum(axis=1), 1.0) and not np.diag(sub).any()
    # BLOSUM62 scores L -> I at +2 and L -> D at -4: 2^3 apart, times the
    # ratio of their background frequencies
    p = protein_model.background()
    assert sub[10, 9] / sub[10, 3] == pytest.approx(p[9] / p[3] * 8.0)


def test_same_seed_same_inputs_and_families():
    a = workload.family_db(CFG, 2 ** 33 + 5, torch.device("cpu"))
    b = workload.family_db(CFG, 2 ** 33 + 5, torch.device("cpu"))
    assert torch.equal(a.db, b.db) and torch.equal(a.pool, b.pool)
    assert not torch.equal(
        a.db, workload.family_db(CFG, 6, torch.device("cpu")).db)
    db = a.db.long().numpy()
    freq = np.bincount(db.ravel(), minlength=20) / db.size
    assert np.abs(freq - protein_model.background()).max() < 0.01
    assert len({tuple(r) for r in a.pool_np}) == CFG["pool"]
    # each center's family of 100 members, at identities from 0.62 to 1,
    # lies mostly within R = 35; unrelated rows lie far outside it
    c, _, _ = reference.radius_hits(a.db, a.pool, 35.0)
    assert 0.6 < c.numel() / (CFG["pool"] * CFG["family_size"]) < 0.95


def test_identity_min_one_copies_the_centers():
    cfg = dict(CFG, identity_min=1.0)
    d = workload.family_db(cfg, 3, torch.device("cpu"))
    db = d.db.numpy()
    nfam = cfg["n_rows"] // cfg["family_size"]
    assert (db.reshape(-1, nfam, 25) == db[None, :nfam]).all()
    with pytest.raises(ValueError):
        workload.family_db(dict(CFG, identity_min=1.5), 3,
                           torch.device("cpu"))
