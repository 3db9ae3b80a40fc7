"""The plain reference: affine Smith-Waterman, bit scores and e-values
against hand-worked cases, and its tie-breaks against the program's host
traceback (which the reference itself never calls)."""

import math

import numpy as np
import pytest

from benchmark.reference import align, judge, stats, tables


def enc(s):
    return tables.encode(s)


def one(q, s, **kw):
    return align.local_alignments([(enc(q), enc(s))], **kw)[0]


def test_identical_sequences_score_their_diagonal():
    r = one("WCHKMY", "WCHKMY")
    assert r["score"] == 11 + 9 + 8 + 5 + 5 + 7
    assert (r["q0"], r["q1"], r["s0"], r["s1"]) == (0, 6, 0, 6)
    assert (r["length"], r["ident"], r["mism"], r["gapopen"]) == (6, 6, 0, 0)


def test_a_gap_costs_eleven_plus_one_per_residue():
    # WWWWW WWWWW against WWWWW G WWWWW: ten W pairs (110) less one
    # gap of one residue (12)
    r = one("WWWWWWWWWW", "WWWWWGWWWWW")
    assert r["score"] == 110 - 12
    assert (r["length"], r["ident"], r["gapopen"]) == (11, 10, 1)
    r = one("WWWWWWWWWW", "WWWWWGGGWWWWW")       # three residues: 14
    assert r["score"] == 110 - 14
    r = one("WWWW", "WWWWGGGGGGGGGGGGGWWWW")   # a gap dearer than half
    assert r["score"] == 44


def test_local_ends_drop_negative_flanks():
    r = one("PPPPWCHKPPPP", "GGGGWCHKGGGG")
    assert r["score"] == 11 + 9 + 8 + 5
    assert (r["q0"], r["q1"], r["s0"], r["s1"]) == (4, 8, 4, 8)


def test_eight_bit_control_saturates():
    w = "W" * 30
    assert one(w, w)["score"] == 330
    assert one(w, w, sat8=True)["score"] == 127


def test_tie_breaks_match_the_program_host_traceback():
    """On random pairs, planted homologous stretches and ties alike, the
    reference gives the alignment the program's pass 2 gives on the
    whole rectangle (score, ends, length, identities, mismatches, gap
    opens)."""
    from lambda_tpu_torch import native

    rng = np.random.default_rng(11)
    pairs = []
    for k in range(80):
        m, n = int(rng.integers(4, 70)), int(rng.integers(4, 90))
        q = rng.integers(0, 20, m)
        s = rng.integers(0, 24, n)
        if k % 2:
            seg = q.copy()
            seg[rng.random(m) < 0.2] = rng.integers(0, 20)
            st = int(rng.integers(0, max(1, n - m)))
            s[st:st + min(m, n - st)] = seg[:min(m, n - st)]
        pairs.append((q, s))
    ref = align.local_alignments(pairs, max_batch=16)
    sc, tr, st = native.sw_traceback_stats_batch(
        [p[0] for p in pairs], [p[1] for p in pairs], tables.BLOSUM62,
        align.GF, align.GE)
    for k, r in enumerate(ref):
        if tr[k] is None:
            assert r["score"] == 0
            continue
        q0, s0, ops = tr[k]
        cq = sum(n for o, n in ops if o in "MI")
        cs = sum(n for o, n in ops if o in "MD")
        assert (int(sc[k]), q0, q0 + cq, s0, s0 + cs, int(st[k][0]),
                int(st[k][1]), int(st[k][2]), int(st[k][4])) == (
            r["score"], r["q0"], r["q1"], r["s0"], r["s1"], r["length"],
            r["ident"], r["mism"], r["gapopen"])


def test_bit_score_and_e_value_by_hand():
    lam, K = 0.267, 0.041
    assert stats.bit_score(100) == pytest.approx(
        (lam * 100 - math.log(K)) / math.log(2))
    assert stats.format_bitscore(stats.bit_score(100)) == "43.1"
    assert stats.format_bitscore(stats.bit_score(400)) == "159"
    adj = stats.length_adjustment(10 ** 8, 360)
    assert 0 < adj < 360
    ev = stats.e_value(100, 360, 10 ** 8)
    assert ev == pytest.approx(K * (360 - adj) * (10 ** 8 - adj)
                               * math.exp(-lam * 100))
    assert stats.format_evalue(3.14159e-45) == "3e-45"
    assert stats.format_evalue(0.00412) == "0.004"
    assert stats.format_evalue(1e-200) == "0.0"


@pytest.mark.parametrize("m,n", [(50, 10 ** 8), (360, 10 ** 8),
                                 (3000, 10 ** 8), (17, 40000), (120, 1)])
def test_length_adjustment_is_ncbi_s(m, n):
    """NCBI's BLAST_ComputeLengthAdjustment as the program computes it."""
    from lambda_tpu_torch import statistics

    assert stats.length_adjustment(n, m) == statistics.length_adjustment(
        n, m, statistics.get_ka_params("blosum62", -11, -1))


def test_tables_are_the_published_ones():
    from lambda_tpu_torch import alphabets as ab, scoring

    aa27 = ab._AA27_CHARS
    for i, a in enumerate(tables.AA):
        for j, b in enumerate(tables.AA):
            assert tables.BLOSUM62[i, j] == scoring.BLOSUM62[
                aa27.index(a), aa27.index(b)]
    assert tables.CODON_TO_AA["ATG"] == "M"
    assert tables.CODON_TO_AA["TGA"] == "*"
    assert sum(len(v) for v in tables.AA_TO_CODONS.values()) == 64
    assert abs(tables.background().sum() - 1) < 1e-12


def test_read_frames_map_back_to_their_nucleotides():
    rng = np.random.default_rng(3)
    dna = "".join("ACGT"[k] for k in rng.integers(0, 4, 151))
    for qs, qe in [(1, 150), (2, 148), (3, 149), (150, 1), (149, 3),
                   (148, 2)]:
        aa, a0, a1, back = judge._frame(dna, qs, qe)
        assert back(a0, a1) == (qs, qe)
        seg = (dna[qs - 1:qe] if qs < qe
               else tables.revcomp(dna)[len(dna) - qs:len(dna) - qe + 1])
        assert np.array_equal(aa[a0:a1], tables.translate(seg))
