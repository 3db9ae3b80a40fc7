"""pass1_ms_per_kq: search.extend pass 1 (widen/merge, sw_scores_device ->
K1): StatsHolder.time_merge + time_extend, in ms per 1,000 queries, over
the untraced calls of a traced run (the program's host clocks)."""

from benchmark.harness.cell import phase_ms_per_kq


def read(run):
    return phase_ms_per_kq(run, ("time_merge", "time_extend"))
