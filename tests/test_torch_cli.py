"""python -m hsearch_tpu_torch's tools (with --device cpu where they touch a
tensor): output files equal to hsearch_tpu's on the same inputs, and
indexes that either package saves served by the other."""

import os

import numpy as np
import pytest

from hsearch_tpu import cli as jcli
from hsearch_tpu.core import io as jio
from hsearch_tpu_torch import cli

AA = "ARNDCQEGHILKMFPSTWYV"
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture
def inputs(tmp_path, rng):
    """k-mer FASTA (3 clusters of near-duplicate 10-mers + noise), k-mer
    centers, and the same centers as a free-form datapoints file."""
    rows = []
    for _ in range(3):
        base = rng.integers(0, 20, 10)
        for _ in range(40):
            s = base.copy()
            s[rng.integers(0, 10)] = rng.integers(0, 20)
            rows.append(s)
    rows += [rng.integers(0, 20, 10) for _ in range(30)]
    db = str(tmp_path / "kmers.fasta")
    with open(db, "w") as f:
        for i, r in enumerate(rows):
            f.write(f">k{i}\n{''.join(AA[int(x)] for x in r)}\n")
    centers = str(tmp_path / "centers.fasta")
    pick = (0, 40, 80, 125)
    with open(centers, "w") as f:
        for c in pick:
            f.write(f">c{c}\n{''.join(AA[int(x)] for x in rows[c])}\n")
    points = str(tmp_path / "centers_points.txt")
    from hsearch_tpu_torch.core import embedding
    jio.write_datapoints(points, [f"p{c}" for c in pick],
                         embedding.embed_kmers(np.stack([rows[c]
                                                         for c in pick])))
    return {"db": db, "centers": centers, "points": points}


def _triples(path):
    with open(path) as f:
        return [(a, b, float(d)) for a, b, d in (ln.split() for ln in f)]


def _same_triples(got, want, ordered):
    if not ordered:
        got, want = sorted(got), sorted(want)
    assert [t[:2] for t in got] == [t[:2] for t in want]
    # squared distances, as printed (6 digits); the point-center form
    # loses ~1e-3 in d^2 to float32 cancellation
    np.testing.assert_allclose([t[2] ** 2 for t in got],
                               [t[2] ** 2 for t in want], rtol=1e-5,
                               atol=1e-3)


# tool, extra arguments, centers input, whether the line order is defined
CASES = {
    "exact_tool": ("motif-search-exact", [], "centers", True),
    "exact_tool_points": ("motif-search-exact", [], "points", True),
    "engine_exact": ("motif-search", ["--engine", "exact"], "centers", True),
    # the lossless ivf search: same hit set, order depends on the index
    "engine_ivf": ("motif-search", ["--engine", "ivf", "--block-size", "8"],
                   "centers", False),
    "engine_ivf_points": ("motif-search", ["--engine", "ivf"], "points",
                          False),
    # --approx-select: exact off the accelerator in both packages
    "engine_ivf_approx": ("motif-search", ["--engine", "ivf",
                                           "--block-size", "8",
                                           "--approx-select"],
                          "centers", False),
    # the segmented engine, lossless: 3 segments of 64 k-mers
    "engine_stream": ("motif-search", ["--engine", "stream",
                                       "--segment-points", "64",
                                       "--block-size", "4", "--k-blocks",
                                       "16", "--max-hits", "512"],
                      "centers", False),
    "engine_stream_points": ("motif-search", ["--engine", "stream",
                                              "--segment-points", "64"],
                             "points", False),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_output_equals_jax_cli(tmp_path, inputs, capsys, case):
    tool, extra, cen, ordered = CASES[case]
    outs = {}
    for name, main, dev in (("jax", jcli.main, []),
                            ("torch", cli.main, ["--device", "cpu"])):
        out = str(tmp_path / f"{name}.txt")
        gt = str(tmp_path / "gt.txt")
        args = [tool, "-d", inputs["db"], "-c", inputs[cen], "-l", "10",
                "-T", "30", "-o", out, *extra, *dev]
        if tool == "motif-search":
            jcli.main(["motif-search-exact", "-d", inputs["db"], "-c",
                       inputs[cen], "-l", "10", "-T", "30", "-o", gt])
            args += ["-g", gt]
        capsys.readouterr()
        main(args)
        outs[name] = (out, capsys.readouterr().out)
    got, want = _triples(outs["torch"][0]), _triples(outs["jax"][0])
    assert len(want) > 40
    _same_triples(got, want, ordered)
    if tool == "motif-search":
        acc = [ln for ln in outs["torch"][1].splitlines()
               if ln.startswith("ACCURACY")]
        assert acc == [ln for ln in outs["jax"][1].splitlines()
                       if ln.startswith("ACCURACY")] == ["ACCURACY 1.0"]
        with open(outs["torch"][0] + ".accuracy.txt") as a, \
                open(outs["jax"][0] + ".accuracy.txt") as b:
            assert a.read() == b.read()


def test_no_retry_autotune(tmp_path, inputs, capsys):
    out = str(tmp_path / "auto.txt")
    gt = str(tmp_path / "gt.txt")
    cli.main(["motif-search-exact", "-d", inputs["db"], "-c",
              inputs["centers"], "-l", "10", "-T", "40", "-o", gt,
              "--device", "cpu"])
    cli.main(["motif-search", "-d", inputs["db"], "-c", inputs["centers"],
              "-l", "10", "-T", "40", "-o", out, "--engine", "ivf",
              "--block-size", "4", "--k-blocks", "1", "--max-hits", "512",
              "--no-retry", "--device", "cpu"])
    assert "measured-recall autotune" in capsys.readouterr().err
    truth = {t[:2] for t in _triples(gt)}
    got = {t[:2] for t in _triples(out)}
    assert got <= truth and len(got) >= 0.99 * len(truth)


@pytest.mark.parametrize("dim", [8, 4])
def test_fit_embedding_equals_jax_cli(tmp_path, capsys, dim):
    """Both CLIs draw the same initial table and batches from one seed;
    their Adam steps agree to float32 noise."""
    outs = []
    for tag, main in (("torch", cli.main), ("jax", jcli.main)):
        out = str(tmp_path / f"{tag}.txt")
        args = ["fit-embedding", "-o", out, "--dim", str(dim), "--steps",
                "50", "--batch", "256"]
        main(args + (["--device", "cpu"] if tag == "torch" else []))
        assert f"[{dim}-dim embedding -> {out}]" in capsys.readouterr().err
        outs.append(np.loadtxt(out))
    assert outs[0].shape == (20, dim) and np.isfinite(outs[0]).all()
    np.testing.assert_allclose(outs[0], outs[1], atol=1e-3)
    with open(str(tmp_path / "torch.txt")) as f:
        assert all(len(v.split(".")[1]) == 6 for v in f.readline().split())


# ---- pcluster -----------------------------------------------------------------

_HIST8 = np.array([0, 1, 2, 1, 3, 1, 1, 4, 2, 5, 5, 1, 5, 6, 7, 0, 0, 6, 6, 5])


@pytest.fixture
def protein_families(tmp_path):
    """Four families of 2-4 identical proteins, family f drawn from the
    residues of two 8-group histogram classes of its own (f and f + 3), so
    every family's 3-mer histogram is far from the others'.  With these
    numpy draws both packages' default KLSH draws (--seed 0) form the same
    pre-groups in the same order, which the test asserts first."""
    rng = np.random.default_rng(17)
    path = str(tmp_path / "prot.fasta")
    with open(path, "w") as f:
        k = 0
        for fam in range(4):
            allowed = np.nonzero(np.isin(_HIST8, [fam, (fam + 3) % 8]))[0]
            base = rng.choice(allowed, int(rng.integers(80, 160)))
            for _ in range(int(rng.integers(2, 5))):
                f.write(f">f{fam}_{k} x\n{''.join(AA[i] for i in base)}\n")
                k += 1
    return path


@pytest.mark.parametrize("extra", [[], ["--gapped"]])
def test_pcluster_files_equal_jax(tmp_path, protein_families, extra):
    import jax
    import torch

    from hsearch_tpu.cluster import pcluster as jpc
    from hsearch_tpu_torch.cluster import pcluster as tpc
    db = jio.read_fasta(protein_families, seed=0)
    jcodes = jpc.klsh_codes_all(db, [jpc.klsh_init(
        jax.random.split(jax.random.PRNGKey(0), 1)[0])])[0]
    tcodes = tpc.klsh_codes_all(db, [tpc.klsh_init(
        torch.Generator().manual_seed(0))], device="cpu")[0]
    groups = [g.tolist() for g in jpc.table_groups(jcodes, set())]
    assert groups == [g.tolist() for g in tpc.table_groups(tcodes, set())]
    assert len(groups) == 4
    outs = {}
    for name, main, dev in (("jax", jcli.main, []),
                            ("torch", cli.main, ["--device", "cpu"])):
        out = str(tmp_path / name)
        main(["pcluster", "-d", protein_families, "-o", out, *extra, *dev])
        outs[name] = [open(out + ext).read()
                      for ext in (".m8", ".aln", ".clusters")]
    assert outs["torch"] == outs["jax"]
    m8, aln, clusters = outs["torch"]
    assert len(m8.splitlines()) > 30
    assert aln.count(" vs ") == len(m8.splitlines())
    assert clusters.count("#clusterid") == 4


def _run_distributed(tool_args, nproc=2, timeout=120):
    """``python -m hsearch_tpu_torch <tool_args> --dist-*`` as nproc
    processes of a local gloo group (--device cpu)."""
    import socket
    import subprocess
    import sys

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    procs = [subprocess.Popen(
        [sys.executable, "-m", "hsearch_tpu_torch", *tool_args,
         "--dist-nproc", str(nproc), "--dist-pid", str(p),
         "--dist-coordinator", f"127.0.0.1:{port}", "--device", "cpu"],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for p in range(nproc)]
    try:
        outs = [pr.communicate(timeout=timeout)[0] for pr in procs]
    finally:
        for pr in procs:
            if pr.poll() is None:
                pr.kill()
    assert all(pr.returncode == 0 for pr in procs), outs
    return outs


DIST_ERRORS = {
    "hclust2_no_coordinator": (["hclust2", "-l", "10", "--dist-nproc", "2",
                                "--dist-pid", "0"], "--dist-coordinator"),
    "hclust2_pid_alone": (["hclust2", "-l", "10", "--dist-pid", "2"],
                          "--dist-nproc, --dist-coordinator"),
    "pcluster_no_coordinator": (["pcluster", "--dist-nproc", "2",
                                 "--dist-pid", "1"], "--dist-coordinator"),
    "pcluster_no_pid": (["pcluster", "--dist-nproc", "2",
                         "--dist-coordinator", "127.0.0.1:1"],
                        "--dist-pid"),
}


@pytest.mark.parametrize("case", sorted(DIST_ERRORS))
def test_distributed_flags_exit_clearly(tmp_path, inputs, protein_families,
                                        case):
    args, missing = DIST_ERRORS[case]
    db = protein_families if args[0] == "pcluster" else inputs["db"]
    with pytest.raises(SystemExit, match=f"missing {missing}$"):
        cli.main([*args, "-d", db, "-o", str(tmp_path / "x"), "--device",
                  "cpu"])


def test_hclust2_distributed_equals_single_and_jax(tmp_path, families):
    """hclust2 --merge-radius as 2 gloo processes writes the file of the
    one-process run and of the JAX CLI (process 0 writes it)."""
    path, merge_r = families
    args = ["hclust2", "-k", "8", "-L", "2", "-T", "1.0", "--merge-radius",
            str(merge_r), "-d", path, "-l", "10"]
    outs = {}
    for name in ("jax", "torch", "dist"):
        out = str(tmp_path / f"{name}.clusters")
        if name == "dist":
            _run_distributed([*args, "-o", out])
        elif name == "jax":
            jcli.main([*args, "-o", out])
        else:
            cli.main([*args, "-o", out, "--device", "cpu"])
        with open(out) as f:
            outs[name] = f.read()
    assert outs["dist"] == outs["torch"] == outs["jax"]
    assert outs["dist"].count("#cluster") == 6


def test_pcluster_distributed_equals_single(tmp_path, protein_families):
    """pcluster as 2 gloo processes: the m8 lines of .p0.m8 and .p1.m8
    together are the one-process run's, and .clusters is identical."""
    single, dist = str(tmp_path / "one"), str(tmp_path / "two")
    cli.main(["pcluster", "-d", protein_families, "-o", single, "--device",
              "cpu"])
    _run_distributed(["pcluster", "-d", protein_families, "-o", dist])
    lines = []
    for p in (0, 1):
        with open(f"{dist}.p{p}.m8") as f:
            part = f.read().splitlines()
        assert part            # both processes aligned queries
        lines += part
    with open(single + ".m8") as f:
        want = f.read().splitlines()
    assert sorted(lines) == sorted(want) and len(want) > 30
    with open(single + ".clusters") as f, open(dist + ".clusters") as g:
        assert f.read() == g.read()
    assert not os.path.exists(dist + ".m8")


def test_threads_flag_pins_both_pools(tmp_path, protein_families, capsys):
    """-t 2 pins torch's host threads and the host library's OpenMP pool;
    the stderr line names the effective count."""
    import torch

    from hsearch_tpu_torch import native_ext
    before = torch.get_num_threads(), native_ext.set_threads(0)
    try:
        cli.main(["pcluster", "-d", protein_families, "-o",
                  str(tmp_path / "o"), "-t", "2", "--device", "cpu"])
        assert "[native threads: 2]" in capsys.readouterr().err
        assert torch.get_num_threads() == 2
        assert native_ext.set_threads(0) == 2
    finally:
        torch.set_num_threads(before[0])
        native_ext.set_threads(before[1])


def test_distributed_run_takes_the_even_split(tmp_path, protein_families):
    """A --dist-* run without -t pins each process to cores / nproc."""
    from hsearch_tpu_torch import native_ext
    outs = _run_distributed(["pcluster", "-d", protein_families, "-o",
                             str(tmp_path / "two")])
    want = f"[native threads: {native_ext.default_process_threads(2)}]"
    assert all(want in out for out in outs), outs


# ---- the lsh engine ---------------------------------------------------------

LSH_CASES = {
    "explicit": ["-k", "4", "-L", "8", "-W", "80", "--probes", "4"],
    "no_autotune": ["--no-autotune"],
    "autotune": [],
}


@pytest.mark.parametrize("case", sorted(LSH_CASES))
def test_lsh_engine_hits_within_exact(tmp_path, inputs, capsys, case):
    """motif-search --engine lsh writes a subset of motif-search-exact's
    triples, with the same distances; the explicit and autotuned points
    find nearly all of them on these clusters."""
    gt, out = str(tmp_path / "gt.txt"), str(tmp_path / "lsh.txt")
    base = ["-d", inputs["db"], "-c", inputs["centers"], "-l", "10",
            "-T", "30", "--device", "cpu"]
    cli.main(["motif-search-exact", *base, "-o", gt])
    cli.main(["motif-search", *base, "-o", out, "--engine", "lsh",
              *LSH_CASES[case]])
    err = capsys.readouterr().err
    assert ("lsh autotune" in err) == (case == "autotune")
    truth = {t[:2]: t[2] for t in _triples(gt)}
    got = {t[:2]: t[2] for t in _triples(out)}
    assert got.keys() <= truth.keys() and len(truth) > 40
    np.testing.assert_allclose([got[k] for k in got],
                               [truth[k] for k in got], rtol=1e-5)
    if case != "no_autotune":
        assert len(got) >= 0.9 * len(truth)


def test_lsh_sweep_tool(inputs, capsys):
    cli.main(["lsh-sweep", "-d", inputs["db"], "-c", inputs["centers"],
              "-l", "10", "-T", "30", "--device", "cpu"])
    lines = capsys.readouterr().out.splitlines()
    assert len(lines) == 7 and lines[-1].startswith("# best: K=")
    assert all("recall=" in ln for ln in lines)


# ---- clustering tools ---------------------------------------------------------

@pytest.fixture
def families(tmp_path, rng):
    """A FASTA of families of exact-duplicate 10-mers, shuffled.  Families
    come in pairs one substitution apart; every other pair of rows is far
    apart.  With a greedy radius below every distance between different
    rows, each family's head is its smallest row whatever the LSH draw.
    Returns the path and a merge radius that joins each near pair and
    nothing else."""
    base = rng.integers(0, 20, (6, 10))
    fams = []
    for b in base:
        near = b.copy()
        near[rng.integers(0, 10)] = (near[0] + 1 + rng.integers(0, 18)) % 20
        fams += [b, near]
    rows = np.concatenate([np.tile(f, (int(rng.integers(1, 6)), 1))
                           for f in fams])
    rows = rows[rng.permutation(len(rows))]
    from hsearch_tpu_torch.core import embedding
    f = np.stack(fams)
    d = np.sqrt(embedding.DISTANCE_SQUARE[f[:, None], f[None]].sum(-1))
    near_d = max(d[2 * i, 2 * i + 1] for i in range(6))
    far = d[np.triu_indices(12, 1)]
    far = far[far > near_d]
    assert far.min() - near_d > 1.0
    path = str(tmp_path / "fam.fasta")
    with open(path, "w") as fh:
        for i, r in enumerate(rows):
            fh.write(f">r{i}\n{''.join(AA[int(x)] for x in r)}\n")
    return path, float(near_d + far.min()) / 2


CLUSTER_CASES = {
    "hclust2": ["hclust2", "-k", "8", "-L", "2", "-T", "1.0"],
    "hclust3": ["hclust3", "-k", "8", "-L", "2", "-T", "1.0"],
    "hclust2_merge": ["hclust2", "-k", "8", "-L", "2", "-T", "1.0",
                      "--merge-radius", None],
    "hclust": ["hclust", "-k", "16", "-L", "4", "-T", "1.0"],
}


@pytest.mark.parametrize("case", sorted(CLUSTER_CASES))
def test_clustering_tools_equal_jax(tmp_path, families, case):
    path, merge_r = families
    args = [str(merge_r) if a is None else a for a in CLUSTER_CASES[case]]
    outs = {}
    for name, main, dev in (("jax", jcli.main, []),
                            ("torch", cli.main, ["--device", "cpu"])):
        out = str(tmp_path / f"{name}.clusters")
        main([*args, "-d", path, "-l", "10", "-o", out, *dev])
        with open(out) as f:
            outs[name] = f.read()
    assert outs["torch"] == outs["jax"]
    n_clusters = outs["torch"].count("#cluster")
    assert n_clusters == (6 if case == "hclust2_merge" else 12)


def test_postprocess_equals_jax(tmp_path, families):
    path, _ = families
    clusters = str(tmp_path / "c.txt")
    cli.main(["hclust2", "-d", path, "-l", "10", "-o", clusters, "-k", "8",
              "-L", "2", "-T", "1.0", "--device", "cpu"])
    for name, main, dev in (("jax", jcli.main, []),
                            ("torch", cli.main, ["--device", "cpu"])):
        main(["postprocess", "-c", clusters, "-o",
              str(tmp_path / f"{name}_"), "--min-size", "2", *dev])
    for suffix in ("hclust.format.txt", "meme.format.txt"):
        assert (tmp_path / f"torch_{suffix}").read_text() == \
            (tmp_path / f"jax_{suffix}").read_text()
    got, want = (np.loadtxt(tmp_path / f"{n}_center_distances.txt")
                 for n in ("torch", "jax"))
    assert got.size > 1
    np.testing.assert_allclose(got, want, rtol=1e-5)

STREAM = ["--engine", "stream", "--segment-points", "64", "--block-size",
          "4", "--k-blocks", "16", "--max-hits", "512"]


@pytest.mark.parametrize("saver", ["jax", "torch"])
def test_stream_index_saved_by_either_package(tmp_path, inputs, capsys,
                                              saver):
    """--save-index by one package, --index in both: the same hit set as
    the exact tool."""
    base = ["-d", inputs["db"], "-c", inputs["centers"], "-l", "10",
            "-T", "30"]
    gt = str(tmp_path / "gt.txt")
    cli.main(["motif-search-exact", *base, "-o", gt, "--device", "cpu"])
    truth = {t[:2] for t in _triples(gt)}
    ckpt = str(tmp_path / "seg.npz")
    mains = {"jax": (jcli.main, []), "torch": (cli.main, ["--device", "cpu"])}
    main, dev = mains[saver]
    main(["motif-search", *base, "-o", str(tmp_path / "built.txt"),
          *STREAM, "--save-index", ckpt, *dev])
    for name, (main, dev) in mains.items():
        out = str(tmp_path / f"{name}.txt")
        capsys.readouterr()
        main(["motif-search", *base, "-o", out, *STREAM, "--index", ckpt,
              *dev])
        assert "segmented index reloaded" in capsys.readouterr().err
        assert {t[:2] for t in _triples(out)} == truth
    assert len(truth) > 40


def test_stream_index_is_checked(tmp_path, inputs):
    """--index must hold a segivf index of -l-mers over -d's rows."""
    base = ["-c", inputs["centers"], "-o", str(tmp_path / "x.txt"),
            "--engine", "stream", "--device", "cpu"]
    ivf_idx = str(tmp_path / "ivf.npz")
    cli.main(["index-build", "-d", inputs["db"], "-o", ivf_idx, "-l", "10",
              "--engine", "ivf", "--device", "cpu"])
    with pytest.raises(SystemExit, match="'ivf' index.*segivf"):
        cli.main(["motif-search", "-d", inputs["db"], "-l", "10",
                  "--index", ivf_idx, *base])
    seg = str(tmp_path / "seg.npz")
    cli.main(["index-build", "-d", inputs["db"], "-o", seg, "-l", "10",
              "--engine", "stream", "--segment-points", "64",
              "--device", "cpu"])
    with pytest.raises(SystemExit, match="10-mers, but -l is 8"):
        cli.main(["motif-search", "-d", inputs["db"], "-l", "8",
                  "--index", seg, *base])
    small = tmp_path / "small.fasta"
    small.write_text("".join(open(inputs["db"]).readlines()[:20]))
    with pytest.raises(SystemExit, match="150 points.*has 10 k-mers"):
        cli.main(["motif-search", "-d", str(small), "-l", "10",
                  "--index", seg, *base])


SERVE_BUILD = {"ivf": ["--engine", "ivf", "--block-size", "8"],
               "stream": ["--engine", "stream", "--segment-points", "64",
                          "--block-size", "4"],
               "lsh": ["--engine", "lsh", "-L", "8"]}


def _served(out: str):
    hits = [ln.split() for ln in out.splitlines()
            if ln and not ln.startswith("#")]
    return {(q, k): float(d) for q, k, d in hits}


@pytest.mark.parametrize("built_by", ["jax", "torch"])
@pytest.mark.parametrize("engine", sorted(SERVE_BUILD))
def test_index_build_and_serve_across_packages(tmp_path, inputs, capsys,
                                               engine, built_by):
    """index-build by one package; serve in both answers each query with
    the same hits."""
    idx = str(tmp_path / "idx.npz")
    mains = {"jax": (jcli.main, []), "torch": (cli.main, ["--device", "cpu"])}
    main, dev = mains[built_by]
    main(["index-build", "-d", inputs["db"], "-o", idx, "-l", "10",
          *SERVE_BUILD[engine], *dev])
    rows = [ln.strip() for ln in open(inputs["db"]) if not
            ln.startswith(">")]
    q = tmp_path / "q.txt"
    q.write_text("\n".join([rows[0], rows[45], "ARND", rows[90],
                            rows[140]]) + "\n\n" + rows[1] + "\n")
    served = {}
    for name, (main, dev) in mains.items():
        capsys.readouterr()
        main(["serve", "-i", idx, "--input", str(q), "-T", "25",
              "--k-blocks", "64", "--probes", "4", *dev])
        res = capsys.readouterr()
        assert "# query must be length 10" in res.err
        served[name] = _served(res.out)
    assert served["torch"].keys() == served["jax"].keys()
    assert {s for s, _ in served["torch"]} == {rows[0], rows[45], rows[90],
                                               rows[140]}
    for k, v in served["torch"].items():
        np.testing.assert_allclose(v, served["jax"][k], rtol=1e-5,
                                   atol=1e-4)


# ---- data preparation and evaluation tools -----------------------------------

@pytest.fixture
def prep(tmp_path, rng):
    """Inputs of the host-only tools: proteins with unknown and lowercase
    residues, a cluster file, DNA, a two-entry STOCKHOLM file, and hit
    triples with a truth set."""
    paths = {}
    prot = tmp_path / "prot.fasta"
    with open(prot, "w") as f:
        f.write("text before the first record\n")
        for i in range(40):
            s = "".join(AA[j] for j in rng.integers(0, 20,
                                                   int(rng.integers(20, 90))))
            if i % 4 == 0:
                s = "WWCHHKKRRF" + s
            if i % 5 == 1:
                s = s[:7] + "XB" + s[9:].lower()
            f.write(f">p{i} desc {i}\n{s[:40]}\n{s[40:]}\n")
    paths["prot"] = str(prot)
    clusters = tmp_path / "clusters.txt"
    clusters.write_text("".join(
        f"#clusterid:{c}:size{n}\n" + "".join(
            "".join(AA[j] for j in rng.integers(0, 20, 10)) + "\n"
            for _ in range(n))
        for c, n in enumerate((5, 1, 7, 3))))
    paths["clusters"] = str(clusters)
    dna = tmp_path / "dna.fasta"
    dna.write_text(">d1 x\nATGGCCATTGTAATGGGCCGCTGAAAGGGTGCCCGATAG\n"
                   ">d2\natggcgtttaaacccgggTTTAAACCCGGGATGNNNAAATTT\n"
                   "ACGTACGTTAGCATGCATGCATGCATGCATGCATGC\n")
    paths["dna"] = str(dna)
    stk = tmp_path / "fam.stk"
    stk.write_text(
        "# STOCKHOLM 1.0\n#=GF ID F1\n#=GF AC PF1\n#=GF SQ 3\n"
        "s1/1-20  MKVLAA.GHHKKRRFWWCHHK\n"
        "s2/3-22  MKVLaaAGHHKKRRFWWCHHK\n"
        "s3/1-12  MK-LAA.GHHKK\n"
        "s1/1-20  WWQQ\n//\n"
        "# STOCKHOLM 1.0\n#=GF ID F2\n#=GF AC PF2\n"
        "t1/5-30  PPGGSSTTAAWWYYVVLLIIKK\n"
        "t2/5-30  MKVLAAGHHKKRRFWWCHHKLL\n//\n")
    paths["stk"] = str(stk)
    gt = tmp_path / "gt.txt"
    gt.write_text("c0 k0 5.0\nc0 k1 10.0\nc0 k2 30.0\nc1 k3 60.0\n"
                  "c1 k4 49.38\n")
    res_dir = tmp_path / "results"
    res_dir.mkdir()
    (res_dir / "a.txt").write_text("c0 k0 5.0\nc0 k2 30.0\n")
    (res_dir / "b.txt").write_text("c1 k3 60.0\nc0 k1 10.0\nc9 k9 1.0\n")
    paths["gt"], paths["res_dir"] = str(gt), str(res_dir)
    paths["res"] = str(res_dir / "b.txt")
    meme = tmp_path / "meme.txt"
    meme.write_text("HEADER\nc0 k1\nc0 k5\nc1 k3\nlonely\nc7 k7\n")
    paths["meme"] = str(meme)
    return paths


# tool arguments ({out} is the output file), and whether the tool's result
# is its output file or its standard output
PREP_CASES = {
    "protein2datapoints": (["protein2datapoints", "-d", "{prot}", "-o",
                            "{out}", "-l", "10", "--seed", "3"], "file"),
    "protein2datapoints_stream": (["protein2datapoints", "-d", "{prot}",
                                   "-o", "{out}", "-l", "10", "--seed", "3",
                                   "--stream-aa", "300"], "file"),
    "gen_kmers": (["gen-kmers", "-d", "{prot}", "-o", "{out}", "-l", "4"],
                  "file"),
    "gen_kmers_stream": (["gen-kmers", "-d", "{prot}", "-o", "{out}", "-l",
                          "4", "--stream-aa", "300"], "file"),
    "kmer2coordinates": (["kmer2coordinates", "-i", "{db}", "-o", "{out}",
                          "-l", "10"], "file"),
    "shuffle_kmers": (["shuffle-kmers", "-c", "{clusters}", "-o", "{out}",
                       "--min-size", "3", "--seed", "4", "-n", "4"], "file"),
    "orf": (["orf", "-q", "{dna}", "-o", "{out}", "--min-len", "3"], "file"),
    "stockholm": (["stockholm", "-i", "{stk}", "-o", "{out}", "-l", "10"],
                  "file"),
    "evaluate2": (["evaluate2", "-g", "{gt}", "-r", "{res_dir}"], "stdout"),
    "evaluate2_search": (["evaluate2", "-g", "{gt}", "-r", "{res}", "-T",
                          "35", "--weighting", "search"], "stdout"),
    "evaluate_motifs": (["evaluate-motifs", "-m", "{meme}", "-r", "{res}"],
                        "stdout"),
}


@pytest.mark.parametrize("case", sorted(PREP_CASES))
def test_prep_and_evaluation_tools_equal_jax(tmp_path, inputs, prep,
                                             capsys, case):
    args, what = PREP_CASES[case]
    got, err = {}, {}
    for name, main in (("jax", jcli.main), ("torch", cli.main)):
        out = str(tmp_path / f"{name}.out")
        capsys.readouterr()
        main([a.format(out=out, **prep, **inputs) for a in args])
        res = capsys.readouterr()
        got[name] = open(out).read() if what == "file" else res.out
        err[name] = res.err.replace(out, "OUT")
    assert got["torch"] == got["jax"] and len(got["torch"]) > 10
    assert err["torch"] == err["jax"]
