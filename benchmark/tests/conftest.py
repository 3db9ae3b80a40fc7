"""Fixtures of the benchmark's own tests: a benchmark at a tiny size in a
temporary directory (the real files, with the database, the pools and
the batches cut down), run on the CPU with the kernels' plain versions.

    python -m pytest benchmark/tests -q
"""

import json
import shutil
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
BENCH = ROOT / "benchmark"
sys.path.insert(0, str(ROOT))


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs a CUDA card; skipped on hosts without one")


def make_tiny(tmp: Path, residues: int = 40000, batch: int = 16) -> Path:
    """A copy of the benchmark under ``tmp`` at a tiny size: its
    BENCHMARK.json, with each configuration's database cut to
    ``residues`` and its query batch to ``batch``, and each traffic mix's
    pool, warm-up, traced calls and sample cut down."""
    b = json.loads((ROOT / "BENCHMARK.json").read_text())
    shutil.copytree(BENCH / "metrics", tmp / "metrics")
    (tmp / "configs").mkdir()
    (tmp / "traffic").mkdir()
    for c in b["configs"]:
        d = json.loads((ROOT / c["file"]).read_text())
        d["database"].update(residues=residues, absent_families=200,
                             spare_families=1.0)
        d["search"] = d["search"] + ["--query-batch", str(batch)]
        p = tmp / "configs" / Path(c["file"]).name
        p.write_text(json.dumps(d))
        c["file"] = str(p.relative_to(tmp))
    for f in (BENCH / "traffic").glob("*.json"):
        d = json.loads(f.read_text())
        closed = d["loop"] == "closed"
        d.update(pool=6 if closed else 2, warmup=2 if closed else 1,
                 trace_calls=1, sample_records=40)
        (tmp / "traffic" / f.name).write_text(json.dumps(d))
    (tmp / "BENCHMARK.json").write_text(json.dumps(b))
    return tmp / "BENCHMARK.json"


@pytest.fixture
def tiny_spec(tmp_path):
    from benchmark.harness.spec import Spec

    path = make_tiny(tmp_path / "bench")
    return Spec(path, bench_dir=path.parent)
