"""The port's CLI (``python -m lambda_tpu_torch.cli``) on the CPU against the
JAX package's BLASTP goldens: mkindexp + searchp on the blastp fixtures of
tests/test_golden.py must give m8/m9 byte-equal to tests/golden/."""

import subprocess
import sys

import pytest

from tests.test_e2e import REPO
from tests.test_golden import GOLDEN, _fixtures, _normalize


def run_port_cli(*args, home, **env_extra) -> subprocess.CompletedProcess:
    env = {"PYTHONPATH": str(REPO), "PATH": "/usr/bin:/bin",
           "HOME": str(home), "OMP_NUM_THREADS": "2", **env_extra}
    return subprocess.run(
        [sys.executable, "-m", "lambda_tpu_torch.cli", *args],
        capture_output=True, text=True, cwd=REPO, env=env, check=False)


GOLDEN_CASES = [("blastp_m8", ".m8"), ("blastp_m9", ".m9")]


def _search_golden(name, suffix, tmp_path, **env):
    db, q = _fixtures(tmp_path)[name]
    lit = tmp_path / "db.lit"
    r = run_port_cli("mkindexp", "-d", str(db), "-i", str(lit), "-v", "0",
                     home=tmp_path)
    assert r.returncode == 0, r.stderr
    out = tmp_path / f"{name}{suffix}"
    r = run_port_cli("searchp", "-q", str(q), "-i", str(lit), "-o", str(out),
                     "--version-to-outputfile", "0", "-v", "0",
                     "--device", "cpu", home=tmp_path, **env)
    return r, out


@pytest.mark.parametrize("name,suffix", GOLDEN_CASES)
def test_port_cli_matches_blastp_golden(name, suffix, tmp_path):
    r, out = _search_golden(name, suffix, tmp_path)
    assert r.returncode == 0, r.stderr
    got = _normalize(out.read_bytes())
    assert got == (GOLDEN / f"{name}{suffix}").read_bytes()


@pytest.mark.parametrize("name,suffix", GOLDEN_CASES)
def test_port_cli_device_trace_matches_blastp_golden(name, suffix, tmp_path):
    """Pass 2 through K2's path (LAMBDA_SW_TRACE=device): the same bytes."""
    r, out = _search_golden(name, suffix, tmp_path,
                            LAMBDA_SW_TRACE="device")
    assert r.returncode == 0, r.stderr
    got = _normalize(out.read_bytes())
    assert got == (GOLDEN / f"{name}{suffix}").read_bytes()


def test_port_cli_refuses_unported(tmp_path):
    r = run_port_cli("searchn", "-q", "x", "-i", "y", home=tmp_path)
    assert r.returncode == 1 and "not yet ported" in r.stderr
