"""Finds every part of the benchmark by name, so that a new configuration,
mix or metric is a new file and never an edit:

* ``BENCHMARK.json`` at the checkout's root: the cells, metrics and bounds;
* ``portbench/configs/<config>.json``: a configuration's sizes, source,
  cuts, plan, driver and reference;
* ``portbench/workloads/<cell>.json``: a cell's configuration, traffic kind
  and mix, engine settings, traced slice and the limits of ``correct``;
* ``portbench/traffic/<kind>.py``: a traffic kind, ``drive(...)``;
* ``portbench/metrics/<metric>.py``: a metric's reader, with its ``LAYER``,
  ``UNIT``, ``BETTER``, ``SOURCE`` and, for a per-layer metric, ``MOVES``.
"""
from __future__ import annotations

import importlib.util
import json
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]       # .../portbench


class Tree:
    """The benchmark's files under ``root`` (the checkout by default)."""

    def __init__(self, root=None):
        self.root = Path(root) if root is not None else HERE.parent
        self.bench = self.root / "portbench"
        self._mods: dict = {}

    def benchmark(self) -> dict:
        return json.loads((self.root / "BENCHMARK.json").read_text())

    def workload(self, name: str) -> dict:
        return self._json("workloads", name)

    def config(self, name: str) -> dict:
        return self._json("configs", name)

    def path(self, rel: str) -> Path:
        return self.root / rel

    def _json(self, kind: str, name: str) -> dict:
        return json.loads((self.bench / kind / f"{name}.json").read_text())

    def module(self, kind: str, name: str):
        key = (kind, name)
        if key not in self._mods:
            path = self.bench / kind / f"{name}.py"
            spec = importlib.util.spec_from_file_location(
                f"portbench_{kind}_{name.replace('.', '_').replace('-', '_')}",
                path)
            mod = importlib.util.module_from_spec(spec)
            spec.loader.exec_module(mod)
            self._mods[key] = mod
        return self._mods[key]

    def cell(self, name: str) -> dict:
        """The ``workloads`` entry of BENCHMARK.json named ``name``."""
        for w in self.benchmark()["workloads"]:
            if w["name"] == name:
                return w
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")

    def metrics_of(self, cell: str, section: str) -> list[dict]:
        """The ``end_to_end`` or ``per_layer`` metrics a cell reports: those
        that list it, and those that list no cells."""
        return [m for m in self.benchmark()[section]
                if cell in m.get("workloads", [cell])]
