"""The other modes end to end: the JAX package's run_search and the port's
(on the CPU) on the fixtures of tests/test_e2e.py (BLASTN on both
strands, BLASTX, TBLASTN, TBLASTX) and tests/test_e2e_bisulfite.py
(converted and unconverted reads, and its randomized partially converted
reads) give byte-equal m8, with pass 2 in the host helpers and through
K2's path (LAMBDA_SW_TRACE=device)."""

from pathlib import Path

import numpy as np
import pytest

from lambda_tpu import options as jopt
from lambda_tpu.index import artifact as jart
from lambda_tpu.io import fasta
from lambda_tpu.search import pipeline as jpipe
from lambda_tpu_torch import options as topt
from lambda_tpu_torch.search import pipeline as tpipe
from tests.test_e2e import GYRA, rev_translate, revcomp

COLUMNS = "std qframe sframe qlen slen".split()


def _write(path: Path, recs) -> Path:
    fasta.write_fasta(path, [fasta.SeqRecord(i, s.encode()) for i, s in recs])
    return path


def _blastn(d: Path):
    rng = np.random.default_rng(5)
    s1 = "".join(rng.choice(list("ACGT"), 300))
    s2 = "".join(rng.choice(list("ACGT"), 200))
    rc = revcomp(s2[50:100])
    rc = rc[:20] + ("A" if rc[20] != "A" else "C") + rc[21:]
    return ("NUCLEOTIDE",
            _write(d / "db.fasta", [("subj1", s1), ("subj2", s2)]),
            _write(d / "q.fasta", [("q1", s1[100:160]), ("q2", rc)]))


def _protein_db(d: Path) -> Path:
    return _write(d / "db.fasta", [
        ("GYRA_ECOLI gyrase", GYRA),
        ("OTHER_PROT", "MNKQRSTVWYACDEFGHILMNPQRSTVWYACDEFGHIKLM" * 4)])


def _blastx(d: Path):
    dna = "GG" + rev_translate(GYRA[30:90]) + "C"
    return ("PROTEIN", _protein_db(d),
            _write(d / "q.fasta", [("xq1", dna), ("xq2", revcomp(dna))]))


def _dna_db(d: Path) -> Path:
    return _write(d / "db.fasta", [("GYRA_DNA", rev_translate(GYRA[:160]))])


def _tblastn(d: Path):
    return ("PROTEIN", _dna_db(d),
            _write(d / "q.fasta", [("tq1", GYRA[20:100])]))


def _tblastx(d: Path):
    return ("PROTEIN", _dna_db(d),
            _write(d / "q.fasta", [("xxq1", rev_translate(GYRA[40:100]))]))


def _bs_genome(d: Path):
    rng = np.random.default_rng(11)
    genome = "".join(rng.choice(list("ACGT"), 400))
    return genome, _write(d / "genome.fasta", [("chr1", genome)])


def _bs_converted(d: Path):
    genome, db = _bs_genome(d)
    read_fwd = genome[100:180].replace("C", "T")
    read_rev = revcomp(genome[200:280].replace("G", "A"))
    return ("BISULFITE", db, _write(d / "reads.fasta", [
        ("r_fwd", read_fwd), ("r_rev", read_rev)]))


def _bs_unconverted(d: Path):
    genome, db = _bs_genome(d)
    return ("BISULFITE", db,
            _write(d / "reads.fasta", [("plain", genome[50:130])]))


def _bs_random(d: Path):
    """The partially converted noisy reads of
    test_bisulfite_m8_randomized_mismatch_consistency, both strands."""
    genome, db = _bs_genome(d)
    rng = np.random.default_rng(47)
    reads = []
    for i in range(10):
        st = int(rng.integers(0, 310))
        frag = list(genome[st:st + 80])
        minus = rng.random() < 0.5
        conv_from, conv_to = ("G", "A") if minus else ("C", "T")
        for p, c in enumerate(frag):
            if c == conv_from and rng.random() < 0.7:
                frag[p] = conv_to
        for _ in range(int(rng.integers(0, 4))):
            p = int(rng.integers(0, len(frag)))
            frag[p] = rng.choice(list("ACGT"))
        s = "".join(frag)
        reads.append((f"r{i}", revcomp(s) if minus else s))
    return ("BISULFITE", db, _write(d / "reads.fasta", reads))


FIXTURES = {"blastn": _blastn, "blastx": _blastx, "tblastn": _tblastn,
            "tblastx": _tblastx, "bs_converted": _bs_converted,
            "bs_unconverted": _bs_unconverted, "bs_random": _bs_random}
# the least number of m8 lines each fixture gives
MIN_LINES = {"blastn": 2, "blastx": 2, "tblastn": 1, "tblastx": 1,
             "bs_converted": 2, "bs_unconverted": 1, "bs_random": 8}


@pytest.fixture(scope="module")
def mode_cases(tmp_path_factory):
    """Each fixture's database, indexed once by the JAX package's mkindex
    for the search domain, and its query file."""
    cases = {}
    for name, make in FIXTURES.items():
        d = tmp_path_factory.mktemp(f"modes_{name}")
        domain, db, q = make(d)
        lit = d / "db.lit"
        o = jopt.IndexerOptions(domain=jopt.Domain[domain], db_file=str(db),
                                index_file=str(lit))
        jart.save_index(jart.build_index(o), str(lit))
        cases[name] = (domain, lit, q, d)
    return cases


def _opt(mod, domain, lit, q, out):
    opt = mod.make_search_options(
        mod.Domain[domain], query_file=str(q), index_file=str(lit),
        output=str(out), verbosity=0, columns=list(COLUMNS))
    mod.detect_output_format(opt)
    return opt


@pytest.mark.parametrize("trace", ["host", "device"])
@pytest.mark.parametrize("name", list(FIXTURES))
def test_port_mode_matches_jax(mode_cases, monkeypatch, name, trace):
    domain, lit, q, d = mode_cases[name]
    if trace == "device":
        monkeypatch.setenv("LAMBDA_SW_TRACE", "device")
    jpipe.run_search(_opt(jopt, domain, lit, q, d / f"jax_{trace}.m8"))
    tpipe.run_search(_opt(topt, domain, lit, q, d / f"port_{trace}.m8"),
                     device="cpu")
    want, got = ((d / f"{who}_{trace}.m8").read_bytes()
                 for who in ("jax", "port"))
    assert want.count(b"\n") >= MIN_LINES[name], want
    assert got == want


def test_bisulfite_scores_odd_frames_with_the_reverse_matrix(mode_cases):
    """The bisulfite context keeps two matrices: the prescore, pass-1 and
    pass-2 matrices of odd subject frames are the JAX package's reverse
    ones, and differ from the forward ones."""
    domain, lit, q, d = mode_cases["bs_converted"]
    jctx = jpipe.SearchContext(_opt(jopt, domain, lit, q, d / "x.m8"))
    tctx = tpipe.SearchContext(_opt(topt, domain, lit, q, d / "x.m8"),
                               device="cpu")
    assert tctx.bs_mode and tctx.unknown_rank == 4
    for fwd, rev in (("sw_fwd", "sw_rev"), ("e8_fwd", "e8_rev")):
        np.testing.assert_array_equal(np.asarray(getattr(tctx, fwd)),
                                      np.asarray(getattr(jctx, fwd)))
        np.testing.assert_array_equal(np.asarray(getattr(tctx, rev)),
                                      np.asarray(getattr(jctx, rev)))
        assert not np.array_equal(np.asarray(getattr(tctx, fwd)),
                                  np.asarray(getattr(tctx, rev)))
    np.testing.assert_array_equal(tctx.d_sub_rev.numpy(),
                                  np.asarray(jctx.d_sub_rev))
    assert (tctx.qry_num_frames, tctx.sbj_num_frames, tctx.program) == \
        (jctx.qry_num_frames, jctx.sbj_num_frames,
         topt.BlastProgram(jctx.program.value))
