"""``BENCHMARK.json`` and the files it names, found by name.

Everything that belongs to one configuration, traffic mix, cell or
per-layer metric is a file of its own: the configuration at the ``file`` its
``configs`` entry gives, the mix at ``traffic/<traffic>.json``, the cell's
sizes and limits at ``cells/<workload>.json``, each per-layer metric's reader
at ``metrics/<metric>.py`` (a ``read(ctx)`` that returns a number, or None
where the cell has nothing for it to read). A later cell, configuration or
metric is added as files and entries; no file here changes.
"""

from __future__ import annotations

import importlib.util
import json
import re
from pathlib import Path
from typing import Dict, List

BENCH_DIR = Path(__file__).resolve().parent
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")


class Spec:
    """The benchmark rooted at ``repo`` (the checkout's root), its files under ``bench``."""

    def __init__(self, repo: Path, bench: Path = BENCH_DIR):
        self.repo = Path(repo)
        self.bench = Path(bench)
        self.data = json.loads((self.repo / "BENCHMARK.json").read_text())

    def workload(self, name: str) -> Dict:
        for w in self.data["workloads"]:
            if w["name"] == name:
                return w
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")

    def config(self, name: str) -> Dict:
        entry = next(c for c in self.data["configs"] if c["name"] == name)
        return json.loads((self.repo / entry["file"]).read_text())

    def traffic(self, name: str) -> Dict:
        return json.loads((self.bench / "traffic" / f"{name}.json").read_text())

    def cell(self, name: str) -> Dict:
        return json.loads((self.bench / "cells" / f"{name}.json").read_text())

    def metrics(self, workload: str, traced: bool) -> List[Dict]:
        """The metrics a run of ``workload`` reports: end-to-end untraced, per-layer traced."""
        kind = "per_layer" if traced else "end_to_end"
        return [m for m in self.data[kind] if workload in m.get("workloads", [workload])]

    def reader(self, metric: str):
        """The ``read`` function of ``metrics/<metric>.py``."""
        path = self.bench / "metrics" / f"{metric}.py"
        spec = importlib.util.spec_from_file_location(f"bench_metric_{metric}", path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        return mod.read


def name_errors(data: Dict) -> List[str]:
    """Names and units of ``data`` (a BENCHMARK.json) outside the allowed characters."""
    bad = []
    for section in ("configs", "workloads", "end_to_end", "per_layer"):
        for entry in data[section]:
            if not NAME.match(entry["name"]):
                bad.append(f"{section}: name {entry['name']!r}")
            if "unit" in entry and not UNIT.match(entry["unit"]):
                bad.append(f"{section}: unit {entry['unit']!r}")
    for w in data["workloads"]:
        for key in ("config", "traffic"):
            if not NAME.match(w[key]):
                bad.append(f"workloads: {key} {w[key]!r}")
    for c in data["configs"]:
        bad += [f"configs: reduced {k!r}" for k in c["reduced"] if not NAME.match(k)]
    return bad
