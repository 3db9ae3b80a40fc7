"""Merge per-host BLAST-tab outputs of a sharded multi-host search.

Each host of a multi-host deployment searches its own shard subset
(``searchp --shard-subset h``) and writes an m8/m9 file whose e-values
and bit scores are computed against the GLOBAL database length, so the
per-host lines are directly comparable.  This tool merges them back
into one per-query record stream:

* query order: by default, first appearance scanning the input files in
  argument order — which can deviate from the query-stream order when a
  query has hits on only a later host.  Pass ``--query-order q.fasta``
  (the original query file) to reproduce the exact stream order.
* within a query, matches sort by (bitScore desc, eValue asc, subject
  name, strand-normalized coordinates).  NOTE: for tied bit scores this
  orders subjects by NAME, while a single-host run orders them by their
  database position (not recoverable from m8 columns) — the kept SET is
  identical unless ``--max-matches`` cuts exactly at such a tie.
* ``--max-matches N`` re-applies the per-query cutoff the per-host runs
  could not apply globally.

Usage: python -m lambda_tpu.tools.merge_m8 out.m8 host0.m8 host1.m8 ...
"""

from __future__ import annotations

import sys


def _key(fields: list[str]):
    # m8: qid sid pident length mism gapo qstart qend sstart send eval bits
    qs, qe = int(fields[6]), int(fields[7])
    ss, se = int(fields[8]), int(fields[9])
    return (-float(fields[11]), float(fields[10]), fields[1],
            min(qs, qe), max(qs, qe), min(ss, se), max(ss, se))


def _annot(fields: list[str]):
    """Parse the internal annotation column (searchp
    --merge-annotations): X:spos:qs:qe:ss:se:qfs:sfs:raw."""
    parts = fields[-1].split(":")
    if len(parts) != 9 or parts[0] != "X":
        raise SystemExit(
            "merge_m8 --annotated: input lines lack the annotation "
            "column (run searchp with --merge-annotations 1)")
    return fields[:-1], tuple(int(x) for x in parts[1:])


def _merge_rows_annotated(rows):
    """Reproduce the single-host per-query order EXACTLY
    (_writeRecord, search_algo.hpp:832-862 = records.sort_dedup_cutoff):
    sort by (subject db position, frame coords, raw desc), dedup keeping
    the best, stable-sort by raw score desc."""
    parsed = [_annot(f) for f in rows]
    parsed.sort(key=lambda t: (t[1][0], t[1][1], t[1][2], t[1][3],
                               t[1][4], t[1][5], t[1][6], -t[1][7]))
    out = []
    prev = None
    for f, a in parsed:
        key = a[:7]
        if key != prev:
            out.append((f, a))
            prev = key
    out.sort(key=lambda t: -t[1][7])
    return [f for f, _ in out]


def merge(paths: list[str], out_path: str, max_matches: int | None = None,
          query_order: list[str] | None = None,
          annotated: bool = False) -> None:
    per_query: dict[str, list[list[str]]] = {}
    order: list[str] = []
    seen: set[str] = set()
    if query_order:
        for q in query_order:
            if q not in seen:
                seen.add(q)
                order.append(q)
    for path in paths:
        with open(path) as fh:
            for line in fh:
                if not line.strip() or line.startswith("#"):
                    continue
                f = line.rstrip("\n").split("\t")
                if f[0] not in per_query:
                    per_query[f[0]] = []
                    if f[0] not in seen:
                        seen.add(f[0])
                        order.append(f[0])
                per_query[f[0]].append(f)
    if not annotated:
        # auto-detect the internal annotation column so a forgotten
        # --annotated cannot leak 'X:...' columns into the merged m8
        for rows_ in per_query.values():
            parts = rows_[0][-1].split(":")
            if len(parts) == 9 and parts[0] == "X":
                print("merge_m8: inputs carry --merge-annotations "
                      "columns; enabling --annotated", file=sys.stderr)
                annotated = True
            break
    with open(out_path, "w") as out:
        for q in order:
            if q not in per_query:
                continue
            if annotated:
                rows = _merge_rows_annotated(per_query[q])
            else:
                rows = sorted(per_query[q], key=_key)
            if max_matches is not None:
                rows = rows[:max_matches]
            for f in rows:
                out.write("\t".join(f) + "\n")


def _read_query_ids(path: str) -> list[str]:
    from ..io import fasta
    from ..output.blast_tab import first_word

    return [first_word(r.id) for r in fasta.iter_seqs(path)]


def main(argv=None) -> int:
    import argparse

    p = argparse.ArgumentParser(
        description="merge per-host sharded m8/m9 outputs")
    p.add_argument("output")
    p.add_argument("inputs", nargs="+")
    p.add_argument("-n", "--max-matches", type=int, default=None)
    p.add_argument("--query-order", default="",
                   help="original query FASTA; reproduces the exact "
                        "query-stream record order")
    p.add_argument("--annotated", action="store_true",
                   help="inputs carry the searchp --merge-annotations "
                        "column: reproduce the exact single-host total "
                        "order (incl. database-position tie order) and "
                        "strip the column")
    a = p.parse_args(argv)
    merge(a.inputs, a.output, a.max_matches,
          _read_query_ids(a.query_order) if a.query_order else None,
          annotated=a.annotated)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
