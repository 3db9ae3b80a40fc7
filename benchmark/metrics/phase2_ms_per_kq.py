"""phase2_ms_per_kq: search.pipeline's phase 2, the re-search of phase
1's losers with full sensitivity (StatsHolder.time_phase2, which spans the
buckets of its own seeding, extension and records) in ms per 1,000
queries, over the untraced calls of a traced run."""

from benchmark.harness.spans import ms_per_kq


def read(run):
    return ms_per_kq(run, ("time_phase2",))
