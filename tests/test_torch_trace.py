"""--trace-dir in the port: a torch.profiler trace of the search loop is
exported into the directory as a chrome trace (on the CPU here: host
activity), with the JAX package's "Profiling to DIR" message; the m8
does not change; and the trace is written even when a batch raises."""

import json

import numpy as np
import pytest

from lambda_tpu_torch import cli as tcli
from lambda_tpu_torch import options as topt
from lambda_tpu_torch.io import fasta
from lambda_tpu_torch.search import pipeline as tpipe

AA = "ARNDCQEGHILKMFPSTWYV"


@pytest.fixture(scope="module")
def case(tmp_path_factory):
    d = tmp_path_factory.mktemp("torch_trace")
    rng = np.random.default_rng(8)
    letters = np.frombuffer(AA.encode(), np.uint8)
    db = letters[rng.integers(0, 20, (40, 300))]
    fasta.write_fasta(d / "db.fasta", [fasta.SeqRecord(f"s{i}", r.tobytes())
                                       for i, r in enumerate(db)])
    qs = [fasta.SeqRecord(f"q{i}", db[i * 3, 50:150].tobytes())
          for i in range(8)]
    fasta.write_fasta(d / "q.fasta", qs)
    assert tcli.main(["mkindexp", "-d", str(d / "db.fasta"), "-i",
                      str(d / "db.lit"), "-v", "0"]) == 0
    return d


def _traces(path):
    return sorted(path.glob("*.pt.trace.json"))


def test_trace_dir_writes_a_chrome_trace(case, tmp_path, capsys):
    d = case
    argv = ["searchp", "-q", str(d / "q.fasta"), "-i", str(d / "db.lit"),
            "--device", "cpu"]
    assert tcli.main(argv + ["-o", str(tmp_path / "plain.m8"),
                             "-v", "0"]) == 0
    tdir = tmp_path / "trace"
    assert tcli.main(argv + ["-o", str(tmp_path / "traced.m8"), "-v", "1",
                             "--trace-dir", str(tdir)]) == 0
    assert f"Profiling to {tdir}" in capsys.readouterr().out
    assert (tmp_path / "traced.m8").read_bytes() == \
        (tmp_path / "plain.m8").read_bytes() != b""
    (trace,) = _traces(tdir)
    events = json.loads(trace.read_text())["traceEvents"]
    assert any("aten::" in str(e.get("name", "")) for e in events)


def test_trace_dir_flushed_when_a_batch_raises(case, tmp_path, monkeypatch):
    d = case

    def fail(self, sd, stats):
        raise RuntimeError("batch failed")

    monkeypatch.setattr(tpipe.SearchContext, "collect_batch", fail)
    opt = topt.make_search_options(
        topt.Domain.PROTEIN, query_file=str(d / "q.fasta"),
        index_file=str(d / "db.lit"), output=str(tmp_path / "x.m8"),
        verbosity=0)
    opt.profile_dir = str(tmp_path / "trace")
    with pytest.raises(RuntimeError, match="batch failed"):
        tpipe.run_search(opt, device="cpu")
    (trace,) = _traces(tmp_path / "trace")
    assert trace.stat().st_size > 0


def test_trace_holds_the_program_spans_and_batches(case, tmp_path):
    """The StatsHolder buckets and the search loop's batches are spans of
    the trace, on the profiler's clock."""
    d = case
    tdir = tmp_path / "trace"
    assert tcli.main(["searchp", "-q", str(d / "q.fasta"), "-i",
                      str(d / "db.lit"), "--device", "cpu", "-o",
                      str(tmp_path / "t.m8"), "-v", "0", "--trace-dir",
                      str(tdir)]) == 0
    (trace,) = _traces(tdir)
    names = {e.get("name") for e in
             json.loads(trace.read_text())["traceEvents"]}
    assert {"time_seed", "time_seed_walk", "time_seed_prep", "time_read",
            "batch 0"} <= names


def test_two_calls_of_one_process_write_two_traces(case, tmp_path):
    d = case
    opt = topt.make_search_options(
        topt.Domain.PROTEIN, query_file=str(d / "q.fasta"),
        index_file=str(d / "db.lit"), output=str(tmp_path / "x.m8"),
        verbosity=0)
    opt.profile_dir = str(tmp_path / "trace")
    for _ in range(2):
        tpipe.run_search(opt, device="cpu")
    first, second = _traces(tmp_path / "trace")
    assert first.name != second.name
    assert first.name.split(".")[1] == second.name.split(".")[1]  # the pid
