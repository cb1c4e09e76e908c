"""Find a cell's parts by name.

A configuration is ``configs/<name>.json``, a traffic mix
``traffic/<name>.json``, an engine ``engines/<name>.py`` (a module with
``make(cfg, traffic, data, seeds, device)``) and a per-layer metric's
reader ``layer_metrics/<name>.py`` (a module with ``read(ctx)``).  A later
change adds a part as a new file plus its entry in ``BENCHMARK.json``,
without editing a file that is there.
"""

from __future__ import annotations

import importlib.util
import json
import re
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent

_NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


def _checked(name: str) -> str:
    if not _NAME.match(name):
        raise ValueError(f"not a benchmark name: {name!r}")
    return name


class Registry:
    """The parts under ``base`` (default: this folder) and the benchmark
    specification ``spec_path`` (default: ``BENCHMARK.json`` at the root
    of the checkout)."""

    def __init__(self, base: Path = HERE, spec_path: Path | None = None):
        self.base = Path(base)
        self.spec_path = Path(spec_path) if spec_path else \
            ROOT / "BENCHMARK.json"
        self._modules: dict = {}

    def spec(self) -> dict:
        with open(self.spec_path) as f:
            return json.load(f)

    def workload(self, name: str) -> dict:
        for wl in self.spec()["workloads"]:
            if wl["name"] == name:
                return wl
        raise KeyError(f"no workload {name!r} in {self.spec_path}")

    def _json(self, kind: str, name: str) -> dict:
        with open(self.base / kind / f"{_checked(name)}.json") as f:
            return json.load(f)

    def config(self, name: str) -> dict:
        return self._json("configs", name)

    def traffic(self, name: str) -> dict:
        return self._json("traffic", name)

    def _module(self, kind: str, name: str):
        path = self.base / kind / f"{_checked(name)}.py"
        if path not in self._modules:
            mod_name = "benchmark_" + kind + "_" + re.sub(r"\W", "_", name)
            spec = importlib.util.spec_from_file_location(mod_name, path)
            if spec is None or not path.exists():
                raise FileNotFoundError(f"no {kind} file {path}")
            mod = importlib.util.module_from_spec(spec)
            spec.loader.exec_module(mod)
            self._modules[path] = mod
        return self._modules[path]

    def engine(self, name: str):
        return self._module("engines", name)

    def layer_metric(self, name: str):
        return self._module("layer_metrics", name)
