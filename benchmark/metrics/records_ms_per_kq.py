"""records_ms_per_kq: search.records, pass-1 scores to records (the
bit-score and e-value filters, the per-match loop with the %-identity
filter; StatsHolder.time_records) in ms per 1,000 queries, over the
untraced calls of a traced run."""

from benchmark.harness.spans import ms_per_kq


def read(run):
    return ms_per_kq(run, ("time_records",))
