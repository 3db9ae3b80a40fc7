"""seed_syncs_per_kq: search.seeding's device-to-host reads, from the
seeder's call to its hits on the host (StatsHolder.seed_syncs, retries
included) per 1,000 queries, over the untraced calls of a traced run."""

from benchmark.harness.spans import per_kq


def read(run):
    return per_kq(run, ("seed_syncs",))
