"""seed_ms_per_kq: search.seeding (+ ops.searchsorted, ops.kmer):
StatsHolder.time_seed + time_locate, in ms per 1,000 queries, over the
untraced calls of a traced run (the program's host clocks)."""

from benchmark.harness.cell import phase_ms_per_kq


def read(run):
    return phase_ms_per_kq(run, ("time_seed", "time_locate"))
