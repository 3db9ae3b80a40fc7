"""mesh_xfer_ms_per_kq: parallel.mesh's host seconds of moving data
between the cards and to the host, in ms per 1,000 queries over the
untraced calls of a traced run: pass A's per-card counts reaching each q
row's first card and summed there (StatsHolder.time_mesh_reduce, in
time_seed) and each cell's stats vector, packed rows and pass-1 scores
moved to the host and rebased to global ids (time_mesh_gather, in
time_locate and time_extend)."""

from benchmark.harness.spans import ms_per_kq


def read(run):
    return ms_per_kq(run, ("time_mesh_reduce", "time_mesh_gather"))
