"""The port's CLI (``python -m lambda_tpu_torch.cli``) on the CPU against the
JAX package's goldens: the mkindex + search subcommands of every case of
tests/test_golden.py (BLASTP, BLASTN, BLASTX, TBLASTN, TBLASTX and
bisulfite; m8, m9, m0 and SAM) must give output byte-equal to
tests/golden/."""

import subprocess
import sys

import pytest

from tests.test_e2e import REPO
from tests.test_golden import CASES, GOLDEN, _fixtures, _normalize


def run_port_cli(*args, home, **env_extra) -> subprocess.CompletedProcess:
    env = {"PYTHONPATH": str(REPO), "PATH": "/usr/bin:/bin",
           "HOME": str(home), "OMP_NUM_THREADS": "2", **env_extra}
    return subprocess.run(
        [sys.executable, "-m", "lambda_tpu_torch.cli", *args],
        capture_output=True, text=True, cwd=REPO, env=env, check=False)


GOLDEN_CASES = [(name, suffix) for name, _, _, _, suffix in CASES]
_SUBCOMMANDS = {name: (mk, se) for name, mk, se, _, _ in CASES}
# the cases also run with pass 2 through K2's path: both BLASTP formats,
# the two-matrix bisulfite case, BLASTN's minus strand and the translated
# modes
DEVICE_TRACE_CASES = [c for c in GOLDEN_CASES if c[0] in (
    "blastp_m8", "blastp_m9", "bs_m8", "blastn_m8", "blastx_m8",
    "tblastx_m0")]


@pytest.fixture(scope="module")
def golden_inputs(tmp_path_factory):
    """The fixtures of tests/test_golden.py and a cache of the indexes the
    port's mkindex subcommands build from them, one per (database,
    subcommand)."""
    d = tmp_path_factory.mktemp("torch_golden")
    return d, _fixtures(d), {}


def _search_golden(name, suffix, golden_inputs, tmp_path, **env):
    d, fixtures, lits = golden_inputs
    db, q = fixtures[name]
    mk, se = _SUBCOMMANDS[name]
    lit = lits.get((db, mk))
    if lit is None:
        lit = d / f"{db.stem}_{mk}.lit"
        r = run_port_cli(mk, "-d", str(db), "-i", str(lit), "-v", "0",
                         home=d)
        assert r.returncode == 0, r.stderr
        lits[(db, mk)] = lit
    out = tmp_path / f"{name}{suffix}"
    r = run_port_cli(se, "-q", str(q), "-i", str(lit), "-o", str(out),
                     "--version-to-outputfile", "0", "-v", "0",
                     "--device", "cpu", home=tmp_path, **env)
    return r, out


@pytest.mark.parametrize("name,suffix", GOLDEN_CASES)
def test_port_cli_matches_blastp_golden(name, suffix, golden_inputs,
                                        tmp_path):
    r, out = _search_golden(name, suffix, golden_inputs, tmp_path)
    assert r.returncode == 0, r.stderr
    got = _normalize(out.read_bytes())
    assert got == (GOLDEN / f"{name}{suffix}").read_bytes()


@pytest.mark.parametrize("name,suffix", DEVICE_TRACE_CASES)
def test_port_cli_device_trace_matches_blastp_golden(name, suffix,
                                                     golden_inputs, tmp_path):
    """Pass 2 through K2's path (LAMBDA_SW_TRACE=device): the same bytes."""
    r, out = _search_golden(name, suffix, golden_inputs, tmp_path,
                            LAMBDA_SW_TRACE="device")
    assert r.returncode == 0, r.stderr
    got = _normalize(out.read_bytes())
    assert got == (GOLDEN / f"{name}{suffix}").read_bytes()


def test_port_cli_refuses_unported(tmp_path):
    """The port has every flag of the JAX package now; a device mesh larger
    than the visible cards exits 1 with the JAX package's message and
    falls back to nothing (no CPU cells for the default device 'cuda')."""
    import re

    import torch

    q = tmp_path / "q.fasta"
    q.write_text(">q\nMSDLAREITPVNIEEELKSSYLDYAMSVIVGRALPDVRDGL\n")
    n = torch.cuda.device_count()
    want = max(n + 1, 2)
    r = run_port_cli("searchp", "-q", str(q), "-i", str(tmp_path / "y.lit"),
                     "--db-shards", str(want), home=tmp_path)
    assert r.returncode == 1
    assert re.search(rf"--q-shards 1 x --db-shards {want} needs {want} "
                     rf"devices; only {n} available\.", r.stderr), r.stderr
    assert "not yet ported" not in r.stderr


def test_chip_smoke_golden_fixtures_are_the_tests_own(tmp_path):
    """chip_smoke.py (which imports nothing of the JAX package) writes
    the same golden inputs as tests/test_golden.py, for the same cases."""
    import chip_smoke

    (tmp_path / "a").mkdir()
    (tmp_path / "b").mkdir()
    want = _fixtures(tmp_path / "a")
    got = chip_smoke.golden_fixtures(tmp_path / "b")
    assert [c[:3] + (c[-1],) for c in CASES] == \
        [(n, mk, se, suffix) for n, mk, se, suffix in chip_smoke.GOLDEN_CASES]
    assert set(got) == set(want) == set(_SUBCOMMANDS)
    for name, files in want.items():
        for w, g in zip(files, got[name]):
            assert (w.name, w.read_bytes()) == (g.name, g.read_bytes()), name
