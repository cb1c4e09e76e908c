"""hsearch_tpu_torch.examples against the JAX package's examples/ scripts on
the CPU: each script at a tiny size with ``--device cpu`` (its rows or
files checked), and, where a result does not depend on a random draw or
the draw is carried, the same numbers as the JAX script's functions on
the same inputs.

The JAX scripts import only numpy and the standard library at module
level, so their functions are loaded from their files (examples/ is not a
package).  Multi-process scripts run 2-process gloo clusters."""

import importlib.util
import json
import os
import sys

import jax
import numpy as np
import pytest
import torch

from hsearch_tpu import cli as jcli
from hsearch_tpu.cluster import pcluster as jpc
from hsearch_tpu.core import alphabet as jalphabet, io as jio
from hsearch_tpu.search import evaluate as jevaluate
from hsearch_tpu.search import exact as jexact
from hsearch_tpu.search import motif as jmotif
from hsearch_tpu_torch.bench import protein_like_db
from hsearch_tpu_torch.cluster import pcluster
from hsearch_tpu_torch.examples import (
    bench_align, bench_engines, bench_gapped, bench_merge_scale,
    bench_pcluster_mp, bench_scale24, bench_stream, bench_stream27,
    pipeline_e2e, quickstart, sweep_klsh)
from hsearch_tpu_torch.lsh import pstable
from hsearch_tpu_torch.search import exact

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EXAMPLES = os.path.join(REPO, "examples")
NEAR_TIE = 1e-5


def _jax_example(name, monkeypatch=None):
    """The JAX package's examples/<name>.py as a module (examples/ on the
    path while it loads, for the scripts that import a sibling)."""
    if monkeypatch is not None:
        monkeypatch.syspath_prepend(EXAMPLES)
    spec = importlib.util.spec_from_file_location(
        f"_jax_example_{name}", os.path.join(EXAMPLES, f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _rows(out):
    return [json.loads(ln) for ln in out.splitlines() if ln.startswith("{")]


def _pairs(ci, ki):
    return set(zip(np.asarray(ci).tolist(), np.asarray(ki).tolist()))


# ---- bench_engines -------------------------------------------------------

def test_bench_engines_rows(capsys):
    bench_engines.main(["11", "--merge", "--device", "cpu"])
    rows = _rows(capsys.readouterr().out)
    assert [r["engine"] for r in rows] == [
        "lsh_ref", "lsh_tuned", "ivf", "hclust2_greedy_L8",
        "hclust2_greedy_L8+merge", "hclust_centroid_L8"]
    assert all(r["n"] == 2048 for r in rows)
    assert rows[1]["cand_max"] == 2048
    assert rows[2]["weighted_recall"] == 1.0    # kb 128 covers 2^11 rows
    # the merge joins greedy's fragments of each family
    assert rows[4]["clusters"] < rows[3]["clusters"]
    assert rows[4]["family_pair_recall"] > rows[3]["family_pair_recall"]


@pytest.mark.parametrize("point", [0, 1])
def test_bench_engines_lsh_row_equals_jax_with_its_draw(point):
    """The script's LSH rows with the JAX package's tables carried over:
    the same hits, recall and cand_max as the JAX script's loop."""
    db, centers = protein_like_db(np.random.default_rng(0), 1 << 11, 25,
                                  query_n=32)
    tag, cfg, cand_max = bench_engines.lsh_points()[point]
    jcfg = jmotif.MotifSearchConfig(**vars(cfg))
    truth = jexact.search_radius(db, centers, 35.0, center_block=256,
                                 max_hits=2048)
    jidx = jmotif.build_index(db, jax.random.PRNGKey(0), jcfg,
                              cand_max=cand_max)
    want = jmotif.search(jidx, centers, jcfg)
    jrec = jevaluate.recall_from_indices(*truth, want[0], want[1], 35.0)
    params = pstable.params_from_arrays(np.asarray(jidx.params.a),
                                        np.asarray(jidx.params.b), cfg.w)
    ptruth = exact.search_radius(db, centers, 35.0, center_block=256,
                                 max_hits=2048, device="cpu")
    assert _pairs(*ptruth[:2]) == _pairs(*truth[:2])
    row, got = bench_engines.lsh_row(db, centers, ptruth, tag, cfg,
                                     cand_max, "cpu", params=params,
                                     log=lambda m: None)
    assert _pairs(*got[:2]) == _pairs(*want[:2]) and len(got[0]) > 100
    assert row["weighted_recall"] == round(jrec.recall, 4)
    assert row["cand_max"] == jidx.cand_max


def test_pair_recall_counts_shared_labels():
    fam = np.repeat(np.arange(50), 8)
    assert bench_engines.pair_recall(fam.copy(), fam, 5000) == 1.0
    assert bench_engines.pair_recall(np.arange(400), fam, 5000) == 0.0


# ---- bench_stream --------------------------------------------------------

def test_bench_stream_row(capsys):
    bench_stream.main(["11", "--c=64", "--cb=32", "--kb=16", "--device",
                       "cpu"])
    (row,) = _rows(capsys.readouterr().out)
    assert set(row) == {"bench", "n_log2", "c", "cb", "kb", "qps",
                        "ms_per_query", "gemm_gflops", "f32_peak_share",
                        "sample_recall", "hits", "device"}
    assert (row["c"], row["cb"], row["kb"]) == (32, 32, 16)  # 32 families
    assert row["f32_peak_share"] is None and row["device"] == "cpu"
    assert 0.9 < row["sample_recall"] <= 1.0 and row["hits"] > 0
    # the JAX script's operation count: prune 2*D*B, verify 2*20L*kb*bs
    assert bench_stream.flops_per_query(25, 100, 16) == \
        2.0 * 200 * 100 + 2.0 * 500 * 16 * 32


# ---- quickstart ----------------------------------------------------------

def test_quickstart_oracle_equals_jax(tmp_path, capsys):
    res = quickstart.run("cpu", str(tmp_path))
    out = capsys.readouterr().out
    assert "== exact hit set" in out and "pcluster:" in out
    # the k-mers as the JAX package reads and cuts the same FASTA
    jdb = jio.read_fasta(str(tmp_path / "db.fasta"))
    jk = np.concatenate([
        jalphabet.kmer_view(jdb.protein(i).astype(np.int64), 10)
        for i in range(jdb.num_proteins)]).astype(np.int32)
    np.testing.assert_array_equal(res["kmers"], jk)
    center = jalphabet.encode(quickstart.MOTIF).astype(np.int32)[None, :]
    want = jexact.search_radius(jk, center, 25.0)
    got = res["exact"]
    assert _pairs(*got[:2]) == _pairs(*want[:2]) and len(got[0]) >= 20
    np.testing.assert_allclose(np.sort(got[2]), np.sort(want[2]), rtol=1e-5)
    assert _pairs(*res["lsh"][:2]) <= _pairs(*got[:2])
    assert os.path.getsize(res["meme"]) > 0


# ---- pipeline_e2e --------------------------------------------------------

def test_pipeline_e2e_stages_equal_jax_cli(tmp_path, capsys):
    port = tmp_path / "port"
    summary = pipeline_e2e.main(["40", str(port), "--device", "cpu"])
    assert set(summary["times_s"]) >= {"synth_dna", "orf", "gen_kmers",
                                       "to_fasta", "ivf_search", "hclust2"}
    assert json.load(open(port / "pipeline_times.json")) == summary
    # the same corpus from the JAX script's generator, then the JAX CLI
    jmod = _jax_example("pipeline_e2e")
    jdir = tmp_path / "jax"
    jdir.mkdir()
    jdna = str(jdir / "dna.fasta")
    jmod.synth_dna(jdna, 40, np.random.default_rng(0))
    assert open(jdna).read() == open(port / "dna.fasta").read()
    jcli.main(["orf", "-q", jdna])
    assert open(jdna + "_translatedAA.fasta").read() == \
        open(port / "dna.fasta_translatedAA.fasta").read()
    jtsv = str(jdir / "kmers.tsv")
    jcli.main(["gen-kmers", "-d", jdna + "_translatedAA.fasta", "-o", jtsv,
               "-l", "10", "--stream-aa", str(1 << 22)])
    assert open(jtsv).read() == open(port / "kmers.tsv").read()
    # the IVF stage's hits == the JAX CLI's exact search on its inputs
    jhits = str(jdir / "hits.txt")
    jcli.main(["motif-search-exact", "-d", str(port / "kmers.fasta"), "-c",
               str(port / "centers.fasta"), "-l", "10", "-T", "25.0", "-o",
               jhits])

    def triples(path):
        with open(path) as f:
            return {(a, b): float(d) for a, b, d in (ln.split() for ln in f)}

    got, want = triples(port / "hits.txt"), triples(jhits)
    assert got.keys() == want.keys() and len(got) > 256
    for k, d in got.items():
        np.testing.assert_allclose(d ** 2, want[k] ** 2, rtol=1e-5,
                                   atol=1e-3)
    # hclust2 wrote a partition of the clustered subset
    kmers = [ln.strip() for ln in open(port / "kmers_sub.fasta")
             if not ln.startswith(">")]
    members = jio.read_clusters(str(port / "clusters.txt"))
    assert sorted(m for c in members for m in c) == sorted(kmers)
    assert os.path.getsize(port / "postmeme.format.txt") > 0
    capsys.readouterr()


# ---- bench_align ---------------------------------------------------------

class _Captured(Exception):
    pass


def test_bench_align_corpus_equals_jax_script(monkeypatch):
    """The JAX script's corpus, caught where it reaches cluster_proteins."""
    def capture(db, *a, **k):
        raise _Captured(db)

    jmod = _jax_example("bench_align")
    monkeypatch.setattr(jpc, "cluster_proteins", capture)
    monkeypatch.setattr(sys, "argv", ["bench_align.py", "103",
                                      "--cluster-only"])
    with pytest.raises(_Captured) as exc:
        jmod.main()
    want = exc.value.args[0]
    got, n_fam = bench_align.protein_families(103)
    assert n_fam == 25 and got.names == want.names
    np.testing.assert_array_equal(got.seq, np.asarray(want.seq))
    np.testing.assert_array_equal(got.starts, want.starts)


def test_bench_align_rows(capsys):
    rows = bench_align.main(["64", "--tables=2", "--device", "cpu"])
    assert _rows(capsys.readouterr().out) == rows
    assert [r["bench"] for r in rows] == ["search_all", "cluster_proteins"]
    assert rows[0]["hits"] >= 64 and rows[1]["backend"] == "cpu"
    assert 0.5 < rows[1]["family_pair_recall"] <= 1.0


def test_family_pair_recall_equals_jax_script():
    jmod = _jax_example("bench_pcluster_mp")
    labels = np.random.default_rng(5).integers(0, 30, 206)
    for lab in (labels, np.arange(206) % 51):
        assert bench_align.family_pair_recall(lab, 51) == \
            jmod.family_recall(lab, 51) == \
            bench_pcluster_mp.family_recall(lab, 51)


# ---- bench_pcluster_mp ---------------------------------------------------

@pytest.mark.parametrize("n", [64, 103])
def test_make_corpus_and_db_bitwise(n):
    jmod = _jax_example("bench_pcluster_mp")
    seqs, n_fam = bench_pcluster_mp.make_corpus(n)
    jseqs, jn_fam = jmod.make_corpus(n)
    assert n_fam == jn_fam and seqs.dtype == jseqs.dtype
    np.testing.assert_array_equal(seqs, jseqs)
    db, jdb = bench_pcluster_mp._DB(seqs), jmod._DB(jseqs)
    assert db.names == jdb.names and db.num_proteins == jdb.num_proteins
    assert db.seq.dtype == jdb.seq.dtype
    np.testing.assert_array_equal(db.seq, jdb.seq)
    np.testing.assert_array_equal(db.starts, jdb.starts)
    np.testing.assert_array_equal(db.protein(n - 1), jdb.protein(n - 1))


def test_script_corpus_clusters_as_jax_with_its_draws():
    """cluster_proteins on the script's _DB with the JAX package's KLSH
    draws carried over: labels and hit count equal to the JAX package's
    (no code bit within 1e-5 of its threshold on this corpus)."""
    jmod = _jax_example("bench_pcluster_mp")
    seqs, n_fam = bench_pcluster_mp.make_corpus(96)
    keys = jax.random.split(jax.random.PRNGKey(0), 2)
    jparams = [jpc.klsh_init(k, jpc.FEATURE_SIZE, jpc.DEFAULT_BITS,
                             jpc.DEFAULT_SIGMA) for k in keys]
    feats = jpc.protein_histograms(jmod._DB(seqs)).astype(np.float64)
    for p in jparams:
        m = np.cos(feats @ np.asarray(p.w, np.float64)
                   + np.asarray(p.b, np.float64)) + np.asarray(p.t)
        assert np.abs(m).min() > NEAR_TIE
    want = jpc.cluster_proteins(jmod._DB(seqs), jax.random.PRNGKey(0),
                                tables=2)
    got = pcluster.cluster_proteins(
        bench_pcluster_mp._DB(seqs), None, tables=2, device="cpu",
        klsh_params=[pcluster.klsh_params_from_arrays(
            np.asarray(p.w), np.asarray(p.t), np.asarray(p.b))
            for p in jparams])
    np.testing.assert_array_equal(got.labels, want.labels)
    assert len(got.hits) == len(want.hits) > 96
    assert bench_pcluster_mp.family_recall(got.labels, n_fam) == \
        jmod.family_recall(want.labels, n_fam)


def test_bench_pcluster_mp_two_processes_equal_one(capsys, tmp_path):
    two = bench_pcluster_mp.main(["64", "--nproc=2", "--tables=2",
                                  "--timeout=300", "--device", "cpu",
                                  f"--logdir={tmp_path}"])
    one = bench_pcluster_mp.main(["64", "--single", "--tables=2",
                                  "--timeout=300", "--device", "cpu"])
    assert _rows(capsys.readouterr().out) == [two, one]
    assert (two["nproc"], one["nproc"]) == (2, 1)
    for key in ("total_hits", "clusters", "family_pair_recall"):
        assert two[key] == one[key], key
    assert two["total_hits"] > 64
    logs = [open(tmp_path / f"child{p}.log").read() for p in (0, 1)]
    assert all("CHILD " in log for log in logs)


def test_bench_pcluster_mp_timeout_kills_the_ranks(tmp_path):
    """Ranks still running when the timeout passes are killed and the run
    fails instead of hanging."""
    with pytest.raises(SystemExit, match="failed or timed out"):
        bench_pcluster_mp.run_cluster(16, 2, 1, "cpu", str(tmp_path), 0.5)


# ---- bench_gapped --------------------------------------------------------

def test_add_indels_bitwise(monkeypatch):
    jmod = _jax_example("bench_gapped", monkeypatch)
    seqs, n_fam = bench_pcluster_mp.make_corpus(80)
    np.testing.assert_array_equal(bench_gapped.add_indels(seqs, n_fam),
                                  jmod.add_indels(seqs, n_fam))


def test_bench_gapped_row(capsys):
    row = bench_gapped.main(["48", "--indels", "--device", "cpu"])
    assert _rows(capsys.readouterr().out) == [row]
    assert row["ungapped"]["clusters"] > 0 and row["pairs"] > 0
    # the indels give the gapped pass real gaps to recover
    assert row["pairs_with_gaps"] > 0
    assert row["gapped"]["family_pair_recall"] >= \
        row["ungapped"]["family_pair_recall"]


# ---- sweep_klsh ----------------------------------------------------------

def test_sweep_klsh_rows(capsys):
    rows = sweep_klsh.main(["48", "--tables=1", "--device", "cpu"])
    assert _rows(capsys.readouterr().out) == rows
    assert [(r["bits"], r["sigma"]) for r in rows] == [
        (b, s) for b in sweep_klsh.BITS for s in sweep_klsh.SIGMAS]
    assert all(1 <= r["groups"] <= 48 for r in rows)


# ---- bench_merge_scale ---------------------------------------------------

def test_bench_merge_scale_rows(capsys):
    rows = bench_merge_scale.main(["11", "--kbs=16,64", "--device", "cpu"])
    assert _rows(capsys.readouterr().out) == rows
    assert [r.get("kb") for r in rows] == [None, 16, 64]
    assert rows[0]["true_families"] == 32
    assert all(r["family_pair_recall"] > rows[0]["family_pair_recall"]
               for r in rows[1:])


def test_adjacent_pair_recall():
    fam = np.array([2, 0, 1, 0, 2, 1])
    assert bench_merge_scale.adjacent_pair_recall(fam, fam) == 1.0
    assert bench_merge_scale.adjacent_pair_recall(np.arange(6), fam) == 0.0


# ---- bench_stream27 ------------------------------------------------------

def test_make_kmers_bitwise():
    jmod = _jax_example("bench_stream27")
    got, gq = bench_stream27.make_kmers(1 << 13)
    want, wq = jmod.make_kmers(1 << 13)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(gq, wq)
    np.testing.assert_array_equal(bench_stream27.load_queries(1 << 13), gq)


def test_bench_stream27_budgets_same_hits(tmp_path, capsys):
    path = str(tmp_path / "seg.npz")
    rows = bench_stream27.main(["--log2n=13", "--segment-log2=12",
                                "--budgets=0,1,2", "--queries=64",
                                f"--save={path}", "--device", "cpu"])
    again = bench_stream27.main(["--log2n=13", "--queries=64",
                                 f"--load={path}", "--device", "cpu"])
    assert _rows(capsys.readouterr().out) == rows + again
    assert [r["resident_fraction"] for r in rows] == [0.0, 0.5, 1.0]
    assert all(r["segments"] == 2 for r in rows + again)
    assert len({r["hits"] for r in rows + again}) == 1
    assert all(r["sample_recall"] > 0.98 for r in rows + again)


# ---- bench_scale24 -------------------------------------------------------

def test_scale24_corpus_equals_jax_script(tmp_path, monkeypatch):
    jmod = _jax_example("bench_scale24")
    jpath = str(tmp_path / "jax.fasta")
    monkeypatch.setattr(jmod, "FASTA", jpath)
    monkeypatch.setattr(jmod, "N_PROT", 300)
    jmod.ensure_fasta()
    path = str(tmp_path / "port.fasta")
    bench_scale24.ensure_fasta(path, 300)
    assert open(path).read() == open(jpath).read()
    np.testing.assert_array_equal(bench_scale24.centers(), jmod.centers())
    got = np.concatenate(list(bench_scale24.kmer_chunks(path, 4096)))
    want = np.concatenate(list(jmod.kmer_chunks(4096)))
    assert got.shape == (300 * 40, 25)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("mode", ["stream", "single"])
def test_bench_scale24_rows(tmp_path, monkeypatch, capsys, mode):
    import tempfile
    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))
    monkeypatch.setenv("HSEARCH_SCALE24_NPROT", "2000")
    rows = bench_scale24.main([f"--mode={mode}", "--device", "cpu"])
    assert _rows(capsys.readouterr().out) == rows
    assert os.path.exists(tmp_path / "hsearch_torch_scale24_2000.fasta")
    assert rows[0]["bench"] == f"scale24_{mode}"
    assert all(r["n"] == 80_000 for r in rows)
    assert rows[-1]["sample_recall"] >= 0.99


# ---- no card, no run -----------------------------------------------------

@pytest.mark.parametrize("mod,argv", [
    (bench_stream, ["10"]), (sweep_klsh, ["16"]),
    (bench_stream27, ["--log2n=10"]), (bench_scale24, ["--mode=single"]),
    (bench_align, ["16"]), (bench_gapped, ["16"]),
    (bench_merge_scale, ["10"]), (quickstart, [])])
def test_examples_raise_without_cuda(monkeypatch, mod, argv):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        mod.main(argv)
