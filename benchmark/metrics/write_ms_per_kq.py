"""write_ms_per_kq: output.blast_tab: StatsHolder.time_write, in ms per
1,000 queries, over the untraced calls of a traced run (the program's
host clocks)."""

from benchmark.harness.cell import phase_ms_per_kq


def read(run):
    return phase_ms_per_kq(run, ("time_write",))
