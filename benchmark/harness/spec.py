"""What ``BENCHMARK.json`` names, found by name as files of their own.

* a configuration: the file its entry names (``configs/<name>.json``);
* a traffic mix: ``traffic/<traffic>.json``;
* a metric, end-to-end or per-layer: ``metrics/<name>.py``, whose
  ``read(run)`` returns the number or None when it finds nothing to read.

A later change adds a configuration, a mix or a metric as a new file and
an entry in ``BENCHMARK.json``; nothing here changes.
"""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path

BENCH_DIR = Path(__file__).resolve().parent.parent


class Spec:
    def __init__(self, path: Path, bench_dir: Path = BENCH_DIR):
        self.path = Path(path)
        self.root = self.path.parent
        self.bench_dir = Path(bench_dir)
        self.data = json.loads(self.path.read_text())

    def cell(self, name: str) -> dict:
        for w in self.data["workloads"]:
            if w["name"] == name:
                return w
        raise KeyError(f"no workload {name!r} in {self.path}")

    def config(self, name: str) -> dict:
        for c in self.data["configs"]:
            if c["name"] == name:
                return json.loads((self.root / c["file"]).read_text())
        raise KeyError(f"no configuration {name!r} in {self.path}")

    def traffic(self, name: str) -> dict:
        return json.loads((self.bench_dir / "traffic" / f"{name}.json")
                          .read_text())

    def metrics(self, cell: dict, trace: bool) -> list[dict]:
        """The metrics a run of ``cell`` reports: with ``trace`` its
        per-layer metrics, else its end-to-end ones."""
        e2e = self.data["end_to_end"]
        mine = {m["name"] for m in e2e
                if cell["name"] in m.get("workloads", [cell["name"]])}
        if not trace:
            return [m for m in e2e if m["name"] in mine]
        return [m for m in self.data["per_layer"]
                if cell["name"] in m.get("workloads", [cell["name"]])
                and (m["moves"] in mine or "workloads" in m)]

    def reader(self, metric: str):
        path = self.bench_dir / "metrics" / f"{metric}.py"
        spec = importlib.util.spec_from_file_location(
            f"benchmark_metric_{metric.replace('.', '_')}", path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        return mod.read
