"""Finding a cell's files by name: the data-driven part of the harness.

A configuration is ``configs/<config>.json``, a cell ``workloads/<cell>.json``,
a traffic mix ``traffic/mixes/<traffic>.json`` and a metric
``metrics/<metric>.py``; ``BENCHMARK.json`` at the root of the checkout
names them.  A later change adds a cell, a mix or a metric as new files and
an entry in ``BENCHMARK.json``, and edits no code.
"""
from __future__ import annotations

import importlib.util
import json
import re
from pathlib import Path
from typing import Dict, List, Optional

HERE = Path(__file__).resolve().parent
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


def _check_name(name: str) -> str:
    if not NAME.match(name):
        raise ValueError(f"not a valid name: {name!r}")
    return name


class Bench:
    """The benchmark's files under ``root`` (this folder by default) and
    the ``BENCHMARK.json`` beside it (at the checkout's root)."""

    def __init__(self, root: Optional[Path] = None,
                 benchmark_json: Optional[Path] = None):
        self.root = Path(root) if root is not None else HERE
        self.benchmark_json = (Path(benchmark_json) if benchmark_json
                               else self.root.parent / "BENCHMARK.json")
        self.doc = json.loads(self.benchmark_json.read_text())
        self._metrics: Dict[str, object] = {}

    def _json(self, *parts: str) -> Dict:
        return json.loads(self.root.joinpath(*parts).read_text())

    def workload(self, name: str) -> Dict:
        """The cell's file, checked against its ``BENCHMARK.json`` entry."""
        entry = next((w for w in self.doc["workloads"]
                      if w["name"] == _check_name(name)), None)
        if entry is None:
            raise KeyError(f"no workload {name!r} in BENCHMARK.json")
        wl = self._json("workloads", f"{name}.json")
        for key in ("config", "traffic", "chips"):
            if wl[key] != entry[key]:
                raise ValueError(f"{name}: {key} {wl[key]!r} in its file, "
                                 f"{entry[key]!r} in BENCHMARK.json")
        return {**wl, "name": name}

    def config(self, name: str) -> Dict:
        return self._json("configs", f"{_check_name(name)}.json")

    def mix(self, name: str) -> Dict:
        return self._json("traffic", "mixes", f"{_check_name(name)}.json")

    def metric(self, name: str):
        """The module of ``metrics/<name>.py``, or where there is none of
        ``metrics/<stem>.py``, the stem being the name before its first
        dot: ``device_idle_pct.pool`` and ``device_idle_pct.voice`` are one
        quantity, split by the end-to-end metric each moves, with one
        reader.  A name may hold dots, so it is loaded by path, not
        imported."""
        if name not in self._metrics:
            path = self.root / "metrics" / f"{_check_name(name)}.py"
            if not path.is_file():
                path = path.with_name(name.split(".", 1)[0] + ".py")
            spec = importlib.util.spec_from_file_location(
                "perfbench_metric_" + re.sub(r"\W", "_", name), path)
            mod = importlib.util.module_from_spec(spec)
            spec.loader.exec_module(mod)
            self._metrics[name] = mod
        return self._metrics[name]

    def metrics_for(self, cell: str, kind: str) -> List[Dict]:
        """The ``end_to_end`` or ``per_layer`` entries that ``cell``
        reports: those without ``workloads`` and those that list it."""
        return [m for m in self.doc[kind]
                if "workloads" not in m or cell in m["workloads"]]
