"""The comparison that decides ``correct``: what the window wrote, held to
the plain reference.

It reads the tabular (m8, BLAST ``std`` columns) outputs of the window's
calls and the inputs the harness made, never the program's index or
state, and gives four numbers, each held to a limit of the cell:

* ``output_faults``: queries whose records break the output's rules:
  more than ``max_matches`` records, bit scores not best first, an
  e-value above the limit, an unknown query or subject, a query's
  records not together or not in the order of the query file.
* ``sentinels_missed_pct``: the share of sentinel queries whose records
  name no subject of their source family -- seeding and both passes.
  Sentinels are the planted homologs that a sound search all but never
  misses: every read cut from a subject, and new members of a family of
  divergence at most ``sentinel_divergence`` and length at least
  ``sentinel_length``.  Seeding is a heuristic: its fixed seed schedule
  can miss a short sentinel that a plain Smith-Waterman scores at an
  e-value of 1e-30, about once in 10^5 sentinels, so the number is a
  share held to a limit between what sound runs and a search that drops
  queries read.  The ids of the missed sentinels stand beside it, and,
  not compared, the share of all planted homologs missed (the program's
  sensitivity).
* ``score_off_pct``: records of a sample drawn from the seed whose bit
  score or e-value is not the one of the best local alignment that a
  plain Smith-Waterman finds around the record's segments (the segments
  widened by ``PAD`` residues on each side) -- pass 1, pass 2 and the
  statistics.
* ``align_off_pct``: sampled records whose coordinates, length,
  identity, mismatches or gap opens differ from that alignment's --
  pass 2's traceback and the writer.

With ``control`` the run is the check's control: the sampled records'
numbers are those of the reference itself in the program's place,
computed in saturating 8-bit arithmetic, and ``checks`` and ``correct``
come from them by the same comparison; the program's own readings of
the sample stay beside them under ``program``.  The two exact numbers
read the program's output in both modes.
"""

from __future__ import annotations

import numpy as np

from . import stats, tables
from .align import local_alignments

PAD = 24          # residues around a record's segments for the reference
MISSED_IDS = 8    # missed sentinels named in a run's detail


def _frame(dna: str, qs: int, qe: int):
    """(the translated frame of a read holding nucleotides qs..qe
    (1-based, qs > qe on the minus strand), the segment's first and
    end residue in it, a function from residue coordinates back to
    nucleotide ones)."""
    L = len(dna)
    if qs <= qe:
        off = (qs - 1) % 3
        aa = tables.translate(dna[off:])

        def back(a0, a1):
            return 3 * a0 + off + 1, 3 * a1 + off
        return aa, (qs - 1 - off) // 3, (qe - off) // 3, back
    rc = tables.revcomp(dna)
    off = (L - qs) % 3
    aa = tables.translate(rc[off:])

    def back(a0, a1):
        return L - (3 * a0 + off), L - (3 * a1 + off) + 1
    return aa, (L - qs - off) // 3, (L - qe + 1 - off) // 3, back


def _window(seq, a0: int, a1: int):
    lo, hi = max(0, a0 - PAD), min(len(seq), a1 + PAD)
    return seq[lo:hi], lo


def _expected(rec: dict, q_lo: int, s_lo: int, back, q_res: int,
              db_length: int) -> dict:
    if rec["score"] <= 0:
        return {}
    qs, qe = back(rec["q0"] + q_lo, rec["q1"] + q_lo)
    return dict(
        pident=f"{100.0 * rec['ident'] / rec['length']:.2f}",
        length=str(rec["length"]), mismatch=str(rec["mism"]),
        gapopen=str(rec["gapopen"]), qstart=str(qs), qend=str(qe),
        sstart=str(rec["s0"] + s_lo + 1), send=str(rec["s1"] + s_lo),
        evalue=stats.format_evalue(stats.e_value(rec["score"], q_res,
                                                 db_length)),
        bitscore=stats.format_bitscore(stats.bit_score(rec["score"])))


COLUMNS = ["qseqid", "sseqid", "pident", "length", "mismatch", "gapopen",
           "qstart", "qend", "sstart", "send", "evalue", "bitscore"]
ALIGN_FIELDS = ["qstart", "qend", "sstart", "send", "length", "pident",
                "mismatch", "gapopen"]


def read_m8(path) -> list[dict]:
    out = []
    with open(path) as fh:
        for line in fh:
            f = line.rstrip("\n").split("\t")
            out.append(dict(zip(COLUMNS, f)) if len(f) == len(COLUMNS)
                        else {"bad": line})
    return out


def output_faults(records: list[dict], order: list[str], n_subjects: int,
                  max_matches: int, max_evalue: float) -> int:
    """Queries of one call whose records break the output's rules
    (``order``: the query ids of the call's file, in order)."""
    rank = {q: k for k, q in enumerate(order)}
    bad: set = set()
    seen: set = set()
    prev_q, prev_rank, count, prev_bits = None, -1, 0, None
    for r in records:
        q = r.get("qseqid")
        if q not in rank:
            bad.add(q or "?")
            continue
        if q != prev_q:
            if q in seen or rank[q] < prev_rank:
                bad.add(q)
            seen.add(q)
            prev_q, prev_rank, count, prev_bits = q, rank[q], 0, None
        count += 1
        try:
            bits, ev = float(r["bitscore"]), float(r["evalue"])
            sid = r["sseqid"]
            ok_s = sid[0] == "s" and 0 <= int(sid[1:]) < n_subjects
        except (ValueError, IndexError):
            bad.add(q)
            continue
        if (count > max_matches or ev > max_evalue or not ok_s
                or (prev_bits is not None and bits > prev_bits)):
            bad.add(q)
        prev_bits = bits
    return len(bad)


def judge(calls, queries: dict, db, program: str, limits: dict,
          max_matches: int, max_evalue: float, sample: int, rng,
          sentinel, device="cpu", control: bool = False) -> dict:
    """``calls``: (m8 path, query ids of the call in file order) of each
    call of the window; ``queries``: id -> generate.Query; ``db``: the
    generate.Database; ``sentinel(query)``: whether a planted query is a
    sentinel.  Returns the readings, each number with its limit, and
    ``correct``."""
    n_subjects = db.n_subjects
    db_length = db.residues
    faults = planted = found = sentinels = 0
    missed: list = []
    pool: list = []
    for path, order in calls:
        recs = read_m8(path)
        faults += output_faults(recs, order, n_subjects, max_matches,
                                max_evalue)
        fams: dict = {}
        for r in recs:
            if "bad" in r or r["qseqid"] not in queries:
                continue
            pool.append(r)
            sid = r["sseqid"]
            if sid[1:].isdigit() and int(sid[1:]) < n_subjects:
                fams.setdefault(r["qseqid"], set()).add(
                    int(db.family[int(sid[1:])]))
        for q in order:
            if queries[q].planted:
                hit = queries[q].family in fams.get(q, ())
                planted += 1
                found += hit
                if sentinel(queries[q]):
                    sentinels += 1
                    if not hit:
                        missed.append(q)
    picked = [pool[k] for k in sorted(rng.choice(
        len(pool), min(sample, len(pool)), replace=False))] if pool else []
    pairs, meta = [], []
    for r in picked:
        q = queries[r["qseqid"]]
        qs, qe = int(r["qstart"]), int(r["qend"])
        ss, se = int(r["sstart"]), int(r["send"])
        if program == "blastx":
            aa, a0, a1, back = _frame(q.text, qs, qe)
            q_res = len(q.text) // 3
        else:
            aa, a0, a1 = tables.encode(q.text), qs - 1, qe
            q_res = len(q.text)

            def back(b0, b1):
                return b0 + 1, b1
        qn, q_lo = _window(aa, a0, a1)
        sn, s_lo = _window(db.subject(int(r["sseqid"][1:])), ss - 1, se)
        pairs.append((qn, sn))
        meta.append((q_lo, s_lo, back, q_res))

    def off(got: list, want: list) -> dict:
        """Shares of records whose statistics, or whose alignment, differ
        from the wanted ones."""
        n = max(len(got), 1)
        return dict(score_off_pct=100.0 * sum(
            any(g.get(k) != w.get(k) for k in ("bitscore", "evalue"))
            for g, w in zip(got, want)) / n,
                    align_off_pct=100.0 * sum(
            any(g.get(k) != w.get(k) for k in ALIGN_FIELDS)
            for g, w in zip(got, want)) / n)

    def expected(sat8: bool) -> list:
        return [_expected(rec, *m, db_length) for rec, m in zip(
            local_alignments(pairs, device=device, sat8=sat8), meta)]

    exact = expected(False)
    judged = picked
    if control:
        # the reference in the program's place, in 8-bit arithmetic
        judged = [dict(r, **c) for r, c in zip(picked, expected(True))]
    out = dict(
        output_faults=faults, **off(judged, exact), sampled=len(picked),
        records=len(pool), planted=planted, found=found,
        sentinels=sentinels, sentinels_missed=len(missed),
        sentinels_missed_pct=(100.0 * len(missed) / sentinels
                              if sentinels else None),
        sentinels_missed_ids=missed[:MISSED_IDS],
        homolog_missed_pct=(100.0 * (planted - found) / planted
                            if planted else None))
    if control:
        out["program"] = off(picked, exact)
    checks = {k: dict(value=out[k], limit=limits[k]) for k in limits
              if out.get(k) is not None}
    out["checks"] = checks
    out["correct"] = bool(checks) and len(picked) > 0 and all(
        c["value"] <= c["limit"] for c in checks.values())
    return out
