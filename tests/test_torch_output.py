"""The output writers of the port against the JAX package's CLI, on the
fixtures of tests/test_e2e_output.py and on randomized BLASTN,
bisulfite and translated ones: the JAX CLI and the port's CLI (on the
CPU) write byte-equal m0 reports, gzipped SAM and, on the untranslation
fixtures, m8; ``--sam-bam-tags help`` and an unknown tag behave alike.
The fixtures here serve tests/test_torch_sam_bam.py too.  The two runs
of a comparison write to the same output path, so the SAM header's
command line differs only in the program's name and the port's
``--device cpu``."""

import gzip

import numpy as np
import pytest

from lambda_tpu import cli as jcli
from lambda_tpu.io import fasta
from lambda_tpu_torch import cli as tcli
from tests.test_e2e import GYRA, rev_translate, revcomp

AA = "ARNDCQEGHILKMFPSTWYV"
TAGS = "AS NM OC IH ar ae ai ap qf qs sf"
TAX_TAGS = TAGS + " st ls lt"

_STD_CODE = {}
for _i, _b1 in enumerate("TCAG"):
    for _j, _b2 in enumerate("TCAG"):
        for _k, _b3 in enumerate("TCAG"):
            _STD_CODE[_b1 + _b2 + _b3] = \
                "FFLLSSSSYY**CC*WLLLLPPPPHHQQRRRRIIIMTTTTNNKKSSRRVVVVAAAADDEEGGGG"[
                    16 * _i + 4 * _j + _k]
_CODONS = {a: [c for c, x in _STD_CODE.items() if x == a] for a in AA}


def _blastp():
    frag2 = GYRA[200:280]
    return dict(mk="mkindexp", se="searchp",
                db=[("GYRA_ECOLI gyrase A", GYRA)],
                q=[("q1 query one", GYRA[50:130]),
                   ("q2", frag2[:30] + "AG" + frag2[32:])])


def _blastn_soft():
    rng = np.random.default_rng(3)
    s1 = "".join(rng.choice(list("ACGT"), 240))
    return dict(mk="mkindexn", se="searchn", db=[("chr", s1)],
                q=[("r1", "ACGTACGTAA" + s1[60:120])])


def _blastn_minus():
    rng = np.random.default_rng(7)
    s1 = "".join(rng.choice(list("ACGT"), 240))
    return dict(mk="mkindexn", se="searchn", db=[("chr", s1)],
                q=[("r1", "ACGTACGTAA" + revcomp(s1[60:120]))])


def _tblastn_minus():
    return dict(mk="mkindexp", se="searchp",
                db=[("MINUS_DNA", revcomp(rev_translate(GYRA[:160])))],
                q=[("tq", GYRA[20:100])])


def _blastx_tax():
    codon = {"A": "GCT", "R": "CGT", "N": "AAT", "D": "GAT", "C": "TGT",
             "Q": "CAA", "E": "GAA", "G": "GGT", "H": "CAT", "I": "ATT",
             "L": "CTG", "K": "AAA", "M": "ATG", "F": "TTT", "P": "CCG",
             "S": "TCT", "T": "ACT", "W": "TGG", "Y": "TAT", "V": "GTT"}
    dna1 = "".join(codon[c] for c in GYRA[60:120])
    dna2 = revcomp("".join(codon[c] for c in GYRA[210:265]))
    dna3 = "ACGTACG" + "".join(codon[c] for c in GYRA[30:75]) + "TTGCA"
    return dict(mk="mkindexp", se="searchp",
                db=[("sp|P0AES4|GYRA_ECOLI gyrase A", GYRA),
                    ("sp|P99999|CHIMERA part", GYRA[150:300] + GYRA[20:80])],
                q=[("qa", dna1), ("qb", dna2), ("qc junk flanks", dna3)])


def _blastn_random():
    rng = np.random.default_rng(77)
    genome = "".join(rng.choice(list("ACGT"), 600))
    reads = []
    for i in range(12):
        st = int(rng.integers(0, 480))
        frag = list(genome[st:st + 90])
        for _ in range(int(rng.integers(0, 5))):
            p = int(rng.integers(0, len(frag)))
            frag[p] = rng.choice([c for c in "ACGT" if c != frag[p]])
        if rng.random() < 0.5:
            p = int(rng.integers(10, len(frag) - 10))
            if rng.random() < 0.5:
                del frag[p:p + int(rng.integers(1, 4))]
            else:
                frag[p:p] = rng.choice(list("ACGT"),
                                       int(rng.integers(1, 4))).tolist()
        s = "".join(frag)
        if rng.random() < 0.3:
            s = "TTTTACGTT"[: int(rng.integers(0, 9))] + s
        if rng.random() < 0.5:
            s = revcomp(s)
        reads.append((f"r{i}", s))
    return dict(mk="mkindexn", se="searchn", db=[("chr", genome)], q=reads)


def _mutated(rng, src, st, n, k):
    frag = list(src[st:st + n])
    for _ in range(k):
        p = int(rng.integers(0, len(frag)))
        frag[p] = rng.choice(list(AA))
    return frag


def _blastx_random():
    rng = np.random.default_rng(13)
    prots = ["".join(rng.choice(list(AA), 150)) for _ in range(3)]
    queries = []
    for i in range(8):
        frag = _mutated(rng, prots[int(rng.integers(0, 3))],
                        int(rng.integers(0, 80)), 50, 4)
        dna = "".join(str(rng.choice(_CODONS[a])) for a in frag)
        dna = "".join(rng.choice(list("ACGT"),
                                 int(rng.integers(0, 3)))) + dna
        if rng.random() < 0.5:
            dna = revcomp(dna)
        queries.append((f"q{i}", dna))
    return dict(mk="mkindexp", se="searchp",
                db=[(f"p{i}", p) for i, p in enumerate(prots)], q=queries)


def _tblastn_random():
    rng = np.random.default_rng(14)
    prots = ["".join(rng.choice(list(AA), 150)) for _ in range(3)]
    dnas = []
    for i, p in enumerate(prots):
        dna = "".join(str(rng.choice(_CODONS[a])) for a in p)
        dnas.append(revcomp(dna) if i % 2 else dna)
    queries = [(f"t{i}", "".join(_mutated(
        rng, prots[int(rng.integers(0, 3))], int(rng.integers(0, 90)), 45,
        3))) for i in range(6)]
    return dict(mk="mkindexp", se="searchp",
                db=[(f"d{i}", s) for i, s in enumerate(dnas)], q=queries)


def _tblastx_random():
    rng = np.random.default_rng(29)
    prots = ["".join(rng.choice(list(AA), 120)) for _ in range(3)]
    dnas = []
    for i, p in enumerate(prots):
        dna = "".join(str(rng.choice(_CODONS[a])) for a in p)
        dnas.append(revcomp(dna) if i % 2 else dna)
    queries = []
    for i in range(6):
        frag = _mutated(rng, prots[int(rng.integers(0, 3))],
                        int(rng.integers(0, 70)), 40, 3)
        dna = "".join(str(rng.choice(_CODONS[a])) for a in frag)
        queries.append((f"q{i}", revcomp(dna) if rng.random() < 0.5
                        else dna))
    return dict(mk="mkindexp", se="searchp",
                db=[(f"d{i}", s) for i, s in enumerate(dnas)], q=queries)


def _bs_random():
    rng = np.random.default_rng(11)
    genome = "".join(rng.choice(list("ACGT"), 400))
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
        s = "".join(frag)
        reads.append((f"r{i}", revcomp(s) if minus else s))
    return dict(mk="mkindexbs", se="searchbs", db=[("chr1", genome)],
                q=reads)


FIXTURES = {"blastp": _blastp, "blastn_soft": _blastn_soft,
            "blastn_minus": _blastn_minus, "tblastn_minus": _tblastn_minus,
            "blastx_tax": _blastx_tax, "blastn_random": _blastn_random,
            "blastx_random": _blastx_random,
            "tblastn_random": _tblastn_random,
            "tblastx_random": _tblastx_random, "bs_random": _bs_random}
# the fixtures indexed with an accession map and a taxonomy
TAXONOMY = {"blastx_tax"}


def _taxonomy(d):
    acc_map = d / "map.accession2taxid"
    acc_map.write_text(
        "accession\taccession.version\ttaxid\tgi\n"
        "P0AES4\tP0AES4.1\t562\t0\n"
        "P99999\tP99999.1\t9606\t0\n")
    dump = d / "dump"
    dump.mkdir()
    (dump / "nodes.dmp").write_text(
        "1\t|\t1\t|\tno rank\t|\n"
        "131567\t|\t1\t|\tno rank\t|\n"
        "562\t|\t131567\t|\tspecies\t|\n"
        "9606\t|\t131567\t|\tspecies\t|\n")
    (dump / "names.dmp").write_text(
        "1\t|\troot\t|\t\t|\tscientific name\t|\n"
        "131567\t|\tcellular organisms\t|\t\t|\tscientific name\t|\n"
        "562\t|\tEscherichia coli\t|\t\t|\tscientific name\t|\n"
        "9606\t|\tHomo sapiens\t|\t\t|\tscientific name\t|\n")
    return ["-m", str(acc_map), "-x", str(dump)]


@pytest.fixture(scope="module")
def out_cases(tmp_path_factory):
    """Each fixture's files and its index, built by the JAX CLI; built on
    first use."""
    made = {}

    def get(name):
        if name not in made:
            spec = FIXTURES[name]()
            d = tmp_path_factory.mktemp(f"out_{name}")
            for key in ("db", "q"):
                fasta.write_fasta(d / f"{key}.fasta", [
                    fasta.SeqRecord(i, s.encode()) for i, s in spec[key]])
            lit = d / "db.lit"
            extra = _taxonomy(d) if name in TAXONOMY else []
            assert jcli.main([spec["mk"], "-d", str(d / "db.fasta"),
                              "-i", str(lit), *extra, "-v", "0"]) == 0
            made[name] = (spec["se"], d, ["-q", str(d / "q.fasta"),
                                          "-i", str(lit)])
        return made[name]
    return get


def _both(out_cases, name, out_name, *args):
    """The JAX CLI's and the port's output of one search, written to the
    same path one after the other."""
    se, d, base = out_cases(name)
    out = d / out_name
    assert jcli.main([se, *base, "-o", str(out), *args, "-v", "0"]) == 0
    want = out.read_bytes()
    out.unlink()
    assert tcli.main([se, *base, "-o", str(out), *args, "-v", "0",
                      "--device", "cpu"]) == 0
    got = out.read_bytes()
    if out_name.endswith(".gz") or out_name.endswith(".bam"):
        assert gzip.decompress(want), "empty output"
    else:
        assert want.strip(), "empty output"
    return want, got


def _port_names(got: bytes) -> bytes:
    """The port's own name and flag in the version tag and command line."""
    return got.replace(b"LAMBDA-TPU-TORCH-", b"LAMBDA-TPU-") \
        .replace(b"lambda-tpu-torch ", b"lambda-tpu ") \
        .replace(b" --device cpu", b"")


def _tags(name):
    return TAX_TAGS if name in TAXONOMY else TAGS


@pytest.mark.parametrize("name", list(FIXTURES))
def test_m0_report_matches_jax(out_cases, name):
    want, got = _both(out_cases, name, "out.m0")
    assert _port_names(got) == want


def test_gzipped_sam_matches_jax(out_cases):
    want, got = _both(out_cases, "blastx_tax", "out.sam.gz",
                      "--sam-bam-tags", TAX_TAGS,
                      "--version-to-outputfile", "0")
    assert got == want


@pytest.mark.parametrize("name", ["blastx_random", "tblastn_random",
                                  "tblastx_random", "tblastn_minus"])
def test_untranslated_m8_matches_jax(out_cases, name):
    """The translated modes' DNA-space coordinates and frames in m8."""
    want, got = _both(out_cases, name, "out.m8", "--output-columns",
                      "std qframe sframe qlen slen")
    assert got == want


def test_sam_bam_tags_help_matches_jax(capsys):
    texts = []
    for main in (jcli.main, tcli.main):
        with pytest.raises(SystemExit) as e:
            main(["searchp", "-q", "q.fasta", "-i", "db.lit",
                  "--sam-bam-tags", "help"])
        assert e.value.code == 0
        texts.append(capsys.readouterr().out)
    assert texts[0] == texts[1] and "\tlt\t" in texts[0]


def test_unknown_sam_bam_tag_is_refused_as_in_jax(capsys):
    errs = []
    for main in (jcli.main, tcli.main):
        with pytest.raises(SystemExit) as e:
            main(["searchp", "-q", "q.fasta", "-i", "db.lit",
                  "--sam-bam-tags", "AS XX"])
        assert e.value.code == 2
        errs.append(capsys.readouterr().err.splitlines()[-1])
    assert _port_names(errs[1].encode()) == errs[0].encode()
    assert 'Unknown column specifier "XX"' in errs[0]
