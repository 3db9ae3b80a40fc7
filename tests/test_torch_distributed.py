"""--distributed in the port: the counterpart of
tests/test_multihost_process.py.  Two concurrent port CLI processes on the
CPU join one torch.distributed group (gloo, rendezvous on a free local
port), each searches its --shard-subset, and merge_m8 (annotated) turns
their outputs into the JAX package's single-process bytes, including the
tie cut by database position at -n 1.  A spec that does not parse, and a
rendezvous that does not complete, exit 1."""

import os
import socket
import subprocess
import sys

import pytest

from lambda_tpu import cli as jcli
from lambda_tpu.io import fasta
from lambda_tpu_torch import cli as tcli
from tests.test_e2e import GYRA, REPO


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


@pytest.fixture(scope="module")
def tie_db(tmp_path_factory):
    """tests/test_multihost_process.py's database: two IDENTICAL subjects
    whose name order opposes their database-position order (zzz at
    position 0, aaa last), indexed as two shards by the port's mkindexp."""
    d = tmp_path_factory.mktemp("torch_dist")
    db = d / "db.fasta"
    fasta.write_fasta(db, [
        fasta.SeqRecord("zzz_sub", GYRA.encode()),
        fasta.SeqRecord("mid1", GYRA[::-1].encode()),
        fasta.SeqRecord("mid2",
                        b"MNKQRSTVWYACDEFGHILMNPQRSTVWYACDEFGHIKLM" * 4),
        fasta.SeqRecord("aaa_sub", GYRA.encode()),
    ])
    lit = d / "db.lit"
    assert tcli.main(["mkindexp", "-d", str(db), "-i", str(lit), "-v", "0",
                      "--shards", "2"]) == 0
    q = d / "q.fasta"
    fasta.write_fasta(q, [
        fasta.SeqRecord("q_tie", GYRA[40:120].encode()),
        fasta.SeqRecord("q_other", GYRA[200:280].encode()),
    ])
    return d, lit, q


def test_two_process_shard_run_merges_to_jax_bytes(tie_db, tmp_path):
    d, lit, q = tie_db
    ref = tmp_path / "ref.m8"
    assert jcli.main(["searchp", "-q", str(q), "-i", str(lit), "-o",
                      str(ref), "-n", "1", "-v", "0"]) == 0
    ref_text = ref.read_text()
    assert "zzz_sub" in ref_text and "aaa_sub" not in ref_text

    port = _free_port()
    env = {"PYTHONPATH": str(REPO), "PATH": os.environ.get("PATH", ""),
           "HOME": str(tmp_path)}
    procs, outs = [], []
    for pid in (0, 1):
        out = tmp_path / f"host{pid}.m8"
        outs.append(out)
        procs.append(subprocess.Popen(
            [sys.executable, "-m", "lambda_tpu_torch.cli", "searchp",
             "-q", str(q), "-i", str(lit), "-o", str(out),
             "--shard-subset", str(pid), "-n", "1000000",
             "--distributed", f"127.0.0.1:{port},{pid},2",
             "--device", "cpu", "-v", "0"],
            cwd=REPO, env=env, stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True))
    try:
        for p in procs:
            _, err = p.communicate(timeout=300)
            assert p.returncode == 0, err
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()

    from lambda_tpu_torch.tools import merge_m8

    merged = tmp_path / "merged.m8"
    merge_m8.merge([str(o) for o in outs], str(merged), max_matches=1,
                   query_order=merge_m8._read_query_ids(str(q)))
    assert merged.read_text() == ref_text


def test_distributed_spec_refusals_as_jax(tie_db, capsys):
    """A spec that does not parse: both CLIs exit 1 with the same
    message."""
    d, lit, q = tie_db
    for spec in ("nonsense", "127.0.0.1:1,x,2"):
        argv = ["searchp", "-q", str(q), "-i", str(lit), "-o",
                str(d / "x.m8"), "-v", "0", "--distributed", spec]
        assert jcli.main(argv) == 1
        want = capsys.readouterr().err
        assert tcli.main(argv + ["--device", "cpu"]) == 1
        assert capsys.readouterr().err == want and want


def test_failed_rendezvous_exits_nonzero(tie_db, monkeypatch, capsys):
    """Rank 1 of 2 with no rank 0 to host the rendezvous: the port's CLI
    gives up after the rendezvous timeout (shortened here) and exits 1,
    leaving no process group behind."""
    import torch.distributed as tdist

    from lambda_tpu_torch.search import pipeline

    d, lit, q = tie_db
    monkeypatch.setattr(pipeline, "DIST_TIMEOUT_S", 2)
    rc = tcli.main(["searchp", "-q", str(q), "-i", str(lit), "-o",
                    str(d / "y.m8"), "-v", "0", "--device", "cpu",
                    "--distributed", f"127.0.0.1:{_free_port()},1,2"])
    assert rc == 1
    assert capsys.readouterr().err.startswith("ERROR:")
    assert not tdist.is_initialized()
