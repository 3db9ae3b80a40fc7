"""unspanned_pct: the share of the search calls' own clock outside the
program's ten top-level StatsHolder buckets (load, read, seed prep, seed,
locate, merge, extend, extend trace, records, write), over the untraced
calls of a traced run."""

from benchmark.harness.spans import unspanned_pct


def read(run):
    return unspanned_pct(run)
