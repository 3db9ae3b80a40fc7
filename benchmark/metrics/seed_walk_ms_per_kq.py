"""seed_walk_ms_per_kq: search.seeding's count curves and slot walk
(StatsHolder.time_seed_walk, inside time_seed) in ms per 1,000 queries,
over the untraced calls of a traced run."""

from benchmark.harness.spans import ms_per_kq


def read(run):
    return ms_per_kq(run, ("time_seed_walk",))
