"""The harness imports no module of the JAX stack, its yardstick nothing of
the port, it writes to no fixed path, and a run without a card fails
without a result."""

import ast
import os
import subprocess
import sys

import pytest
import torch

from conftest import BENCH, ROOT

FORBIDDEN = {"jax", "jaxlib", "flax", "hsearch_tpu"}
# the yardstick: nothing of the program may reach these
YARDSTICK = ("reference.py", "judge.py", "recall.py", "workload.py",
             "protein_model.py", "roofline.py", "devtrace.py", "registry.py")


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_no_module_imports_the_jax_stack():
    files = sorted(BENCH.rglob("*.py"))
    assert len(files) > 15
    for path in files:
        tops = {name.partition(".")[0] for name in _imports(path)}
        assert not tops & FORBIDDEN, (path, tops & FORBIDDEN)


def test_yardstick_imports_nothing_of_the_port():
    for name in YARDSTICK:
        tops = {n.partition(".")[0] for n in _imports(BENCH / name)}
        assert "hsearch_tpu_torch" not in tops, name
        assert tops <= {"__future__", "benchmark", "dataclasses", "json",
                        "math", "numpy", "torch", "importlib", "re",
                        "pathlib"}, (name, tops)


def test_no_fixed_temporary_path():
    for path in BENCH.rglob("*.py"):
        if "tests" in path.parts:
            continue
        text = path.read_text()
        assert "/dev/shm" not in text and "/tmp" not in text, path


def test_modules_import_with_the_jax_stack_blocked():
    code = ("import sys\n"
            "for m in ('jax', 'jaxlib', 'flax', 'hsearch_tpu'):\n"
            "    sys.modules[m] = None\n"
            "from benchmark import run, calibrate, judge, reference\n"
            "from benchmark.registry import Registry\n"
            "reg = Registry()\n"
            "spec = reg.spec()\n"
            "for w in spec['workloads']:\n"
            "    reg.engine(reg.config(w['config'])['engine'])\n"
            "for m in spec['per_layer']:\n"
            "    reg.layer_metric(m['name'])\n"
            "print('ok')\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0 and res.stdout.strip() == "ok", res.stderr


def test_run_without_a_card_fails_without_a_result():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the run would measure")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    res = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload",
         "pfam25-resident.batch1024", "--seed", str(2 ** 31 + 5),
         "--seconds", "1", "--trace", "0"],
        cwd=ROOT, capture_output=True, text=True, timeout=300, env=env)
    assert res.returncode != 0 and res.stdout == ""
    assert "CUDA" in res.stderr
