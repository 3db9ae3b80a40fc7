"""seed_prep_ms_per_kq: search.seeding's host preparation
(StatsHolder.time_seed_prep: query frames, seed schedule, padding, uploads)
in ms per 1,000 queries, over the untraced calls of a traced run."""

from benchmark.harness.spans import ms_per_kq


def read(run):
    return ms_per_kq(run, ("time_seed_prep",))
