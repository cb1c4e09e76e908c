"""python -m hsearch_tpu_torch motif-search / motif-search-exact with
--device cpu: output files equal to hsearch_tpu's on the same inputs."""

import numpy as np
import pytest

from hsearch_tpu import cli as jcli
from hsearch_tpu.core import io as jio
from hsearch_tpu_torch import cli

AA = "ARNDCQEGHILKMFPSTWYV"


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


@pytest.mark.parametrize("engine", ["stream"])
def test_unported_engines_exit_clearly(tmp_path, inputs, engine):
    with pytest.raises(SystemExit, match="not yet ported.*ROADMAP A.5"):
        cli.main(["motif-search", "-d", inputs["db"], "-c",
                  inputs["centers"], "-l", "10", "-o",
                  str(tmp_path / "x.txt"), "--engine", engine,
                  "--device", "cpu"])


@pytest.mark.parametrize("flag", ["--dist-nproc", "--dist-pid"])
def test_distributed_clustering_exits_clearly(tmp_path, inputs, flag):
    with pytest.raises(SystemExit, match="not yet ported.*ROADMAP A.10"):
        cli.main(["hclust2", "-d", inputs["db"], "-l", "10", "-o",
                  str(tmp_path / "x.txt"), flag, "2", "--device", "cpu"])


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
