"""Bit score, e-value and their tabular formatting, as BLAST defines them.

The length adjustment is NCBI's ``BLAST_ComputeLengthAdjustment`` for one
sequence; the e-value is K m' n' exp(-lambda S) on the query and database
lengths less that adjustment; the printed forms follow NCBI's tabular
output (bit score: one decimal up to 99.9, then whole numbers; e-value:
the ladder of ``format_evalue``).
"""

from __future__ import annotations

import math

from .tables import KA_BLOSUM62_11_1


def length_adjustment(db_length: int, query_length: int,
                      params=KA_BLOSUM62_11_1) -> int:
    lam, K, _, alpha, beta = params
    log_k = math.log(K)
    a_l = alpha / lam
    m, n = float(query_length), float(db_length)
    mb = m + n
    c = n * m - max(m, n) / K
    if c < 0:
        return 0
    val_max = 2.0 * c / (mb + math.sqrt(mb * mb - 4.0 * c))
    val = val_min = 0.0
    converged = False
    for i in range(1, 21):
        val_new = a_l * (log_k + math.log((m - val) * (n - val))) + beta
        if val_new >= val:
            val_min = val
            if val_new - val_min <= 1.0:
                converged = True
                break
            if val_min == val_max:
                break
        else:
            val_max = val
        if val_min <= val_new <= val_max:
            val = val_new
        else:
            val = val_max if i == 1 else 0.5 * (val_min + val_max)
    if not converged:
        return int(val_min)
    result = int(val_min)
    up = math.ceil(val_min)
    if up <= val_max and a_l * (log_k + math.log((m - up) * (n - up))) \
            + beta >= up:
        result = int(up)
    return result


def bit_score(raw: int, params=KA_BLOSUM62_11_1) -> float:
    lam, K = params[0], params[1]
    return (lam * raw - math.log(K)) / math.log(2.0)


def e_value(raw: int, query_residues: int, db_length: int,
            params=KA_BLOSUM62_11_1) -> float:
    """``query_residues``: the query's length in residues (a read's
    nucleotides // 3)."""
    adj = length_adjustment(db_length, query_residues, params)
    lam, K = params[0], params[1]
    return K * float(query_residues - adj) * float(db_length - adj) \
        * math.exp(-lam * raw)


def format_evalue(ev: float) -> str:
    if ev <= 1.0e-180:
        return "0.0"
    if ev < 0.0009:
        return f"{ev:.0e}"
    if ev < 0.1:
        return f"{ev:.3f}"
    if ev < 1.0:
        return f"{ev:.2f}"
    if ev < 10.0:
        return f"{ev:.1f}"
    return f"{ev:.0f}"


def format_bitscore(bs: float) -> str:
    if bs > 9999:
        return f"{bs:.3e}"
    if bs > 99.9:
        return f"{bs:.0f}"
    return f"{bs:.1f}"
