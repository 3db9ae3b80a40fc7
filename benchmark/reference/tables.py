"""Frozen tables of the plain reference and of the generator.

Each table is a copy of its published source, kept here so that no later
change to the program can move the yardstick:

* BLOSUM62 in NCBI's order ``ARNDCQEGHILKMFPSTWYVBZX*`` (Henikoff &
  Henikoff 1992; NCBI's ``sm_blosum62``).
* The Karlin-Altschul constants of BLOSUM62 with gap open 11 and extend
  1 (NCBI ``blast_stat.c``: lambda 0.267, K 0.041, H 0.14, alpha 1.9,
  beta -30).
* The standard genetic code (NCBI translation table 1).
* The Robinson & Robinson (1991) amino-acid background frequencies.
"""

from __future__ import annotations

import numpy as np

AA = "ARNDCQEGHILKMFPSTWYVBZX*"
STANDARD_AA = AA[:20]
STOP = AA.index("*")

_BLOSUM62 = """
 4 -1 -2 -2  0 -1 -1  0 -2 -1 -1 -1 -1 -2 -1  1  0 -3 -2  0 -2 -1  0 -4
-1  5  0 -2 -3  1  0 -2  0 -3 -2  2 -1 -3 -2 -1 -1 -3 -2 -3 -1  0 -1 -4
-2  0  6  1 -3  0  0  0  1 -3 -3  0 -2 -3 -2  1  0 -4 -2 -3  3  0 -1 -4
-2 -2  1  6 -3  0  2 -1 -1 -3 -4 -1 -3 -3 -1  0 -1 -4 -3 -3  4  1 -1 -4
 0 -3 -3 -3  9 -3 -4 -3 -3 -1 -1 -3 -1 -2 -3 -1 -1 -2 -2 -1 -3 -3 -2 -4
-1  1  0  0 -3  5  2 -2  0 -3 -2  1  0 -3 -1  0 -1 -2 -1 -2  0  3 -1 -4
-1  0  0  2 -4  2  5 -2  0 -3 -3  1 -2 -3 -1  0 -1 -3 -2 -2  1  4 -1 -4
 0 -2  0 -1 -3 -2 -2  6 -2 -4 -4 -2 -3 -3 -2  0 -2 -2 -3 -3 -1 -2 -1 -4
-2  0  1 -1 -3  0  0 -2  8 -3 -3 -1 -2 -1 -2 -1 -2 -2  2 -3  0  0 -1 -4
-1 -3 -3 -3 -1 -3 -3 -4 -3  4  2 -3  1  0 -3 -2 -1 -3 -1  3 -3 -3 -1 -4
-1 -2 -3 -4 -1 -2 -3 -4 -3  2  4 -2  2  0 -3 -2 -1 -2 -1  1 -4 -3 -1 -4
-1  2  0 -1 -3  1  1 -2 -1 -3 -2  5 -1 -3 -1  0 -1 -3 -2 -2  0  1 -1 -4
-1 -1 -2 -3 -1  0 -2 -3 -2  1  2 -1  5  0 -2 -1 -1 -1 -1  1 -3 -1 -1 -4
-2 -3 -3 -3 -2 -3 -3 -3 -1  0  0 -3  0  6 -4 -2 -2  1  3 -1 -3 -3 -1 -4
-1 -2 -2 -1 -3 -1 -1 -2 -2 -3 -3 -1 -2 -4  7 -1 -1 -4 -3 -2 -2 -1 -2 -4
 1 -1  1  0 -1  0  0  0 -1 -2 -2  0 -1 -2 -1  4  1 -3 -2 -2  0  0  0 -4
 0 -1  0 -1 -1 -1 -1 -2 -2 -1 -1 -1 -1 -2 -1  1  5 -2 -2  0 -1 -1  0 -4
-3 -3 -4 -4 -2 -2 -3 -2 -2 -3 -2 -3 -1  1 -4 -3 -2 11  2 -3 -4 -3 -2 -4
-2 -2 -2 -3 -2 -1 -2 -3  2 -1 -1 -2 -1  3 -3 -2 -2  2  7 -1 -3 -2 -1 -4
 0 -3 -3 -3 -1 -2 -2 -3 -3  3  1 -2  1 -1 -2 -2  0 -3 -1  4 -3 -2 -1 -4
-2 -1  3  4 -3  0  1 -1  0 -3 -4  0 -3 -3 -2  0 -1 -4 -3 -3  4  1 -1 -4
-1  0  0  1 -3  3  4 -2  0 -3 -3  1 -1 -3 -1  0 -1 -3 -2 -2  1  4 -1 -4
 0 -1 -1 -1 -2 -1 -1 -1 -1 -1 -1 -1 -1 -1 -2  0  0 -2 -1 -1 -1 -1 -1 -4
-4 -4 -4 -4 -4 -4 -4 -4 -4 -4 -4 -4 -4 -4 -4 -4 -4 -4 -4 -4 -4 -4 -4  1
"""

BLOSUM62 = np.array([[int(v) for v in row.split()]
                     for row in _BLOSUM62.strip().splitlines()],
                    dtype=np.int32)

# (lambda, K, H, alpha, beta) of BLOSUM62, gap open 11, extend 1; a gap
# of length L costs 11 + L
KA_BLOSUM62_11_1 = (0.267, 0.041, 0.14, 1.9, -30.0)
GAP_OPEN = 11
GAP_EXTEND = 1

# NCBI translation table 1, codons in TCAG order (first base slowest)
_CODE1 = "FFLLSSSSYY**CC*WLLLLPPPPHHQQRRRRIIIMTTTTNNKKSSRRVVVVAAAADDEEGGGG"
_BASES = "TCAG"
CODON_TO_AA = {a + b + c: _CODE1[16 * i + 4 * j + k]
               for i, a in enumerate(_BASES) for j, b in enumerate(_BASES)
               for k, c in enumerate(_BASES)}
AA_TO_CODONS: dict = {}
for _codon, _aa in sorted(CODON_TO_AA.items()):
    AA_TO_CODONS.setdefault(_aa, []).append(_codon)

ROBINSON = {
    "A": 0.07805, "R": 0.05129, "N": 0.04487, "D": 0.05364, "C": 0.01925,
    "Q": 0.04264, "E": 0.06295, "G": 0.07377, "H": 0.02199, "I": 0.05142,
    "L": 0.09019, "K": 0.05744, "M": 0.02243, "F": 0.03856, "P": 0.05203,
    "S": 0.07120, "T": 0.05841, "W": 0.01330, "Y": 0.03216, "V": 0.06441,
}


def background() -> np.ndarray:
    """The 20 standard residues' frequencies in ``STANDARD_AA`` order,
    summing to 1."""
    f = np.array([ROBINSON[c] for c in STANDARD_AA], dtype=np.float64)
    return f / f.sum()


def codon_table() -> np.ndarray:
    """(64,) residue index (into ``AA``) of each codon, the codon's bases
    as 2-bit digits in ACGT order (first base slowest)."""
    out = np.zeros(64, dtype=np.int8)
    for i, a in enumerate("ACGT"):
        for j, b in enumerate("ACGT"):
            for k, c in enumerate("ACGT"):
                out[16 * i + 4 * j + k] = AA.index(CODON_TO_AA[a + b + c])
    return out


def encode(seq: str) -> np.ndarray:
    """Residue indices into ``AA`` of a protein string (other letters are
    X)."""
    lut = np.full(256, AA.index("X"), dtype=np.int8)
    for i, c in enumerate(AA):
        lut[ord(c)] = i
    return lut[np.frombuffer(seq.encode(), dtype=np.uint8)]


def revcomp(dna: str) -> str:
    return dna.translate(str.maketrans("ACGT", "TGCA"))[::-1]


def translate(dna: str) -> np.ndarray:
    """Residue indices of the codons of ``dna`` from its first base (a
    trailing partial codon is dropped)."""
    d = np.frombuffer(dna.encode(), dtype=np.uint8)
    lut = np.zeros(256, dtype=np.int64)
    for i, c in enumerate(b"ACGT"):
        lut[c] = i
    n = len(d) // 3
    r = lut[d[:3 * n]].reshape(n, 3)
    return codon_table()[r[:, 0] * 16 + r[:, 1] * 4 + r[:, 2]]
