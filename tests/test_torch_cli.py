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


@pytest.mark.parametrize("engine", ["lsh", "stream"])
def test_unported_engines_exit_clearly(tmp_path, inputs, engine):
    with pytest.raises(SystemExit, match="not yet ported.*ROADMAP"):
        cli.main(["motif-search", "-d", inputs["db"], "-c",
                  inputs["centers"], "-l", "10", "-o",
                  str(tmp_path / "x.txt"), "--engine", engine,
                  "--device", "cpu"])
