"""seed_device_ms_per_kq: search.seeding's device-timeline time (the
program's CUDA events around each seeder call, retries included:
StatsHolder.dev_seed_s) in ms per 1,000 queries, over the untraced calls
of a traced run."""

from benchmark.harness.spans import ms_per_kq


def read(run):
    return ms_per_kq(run, ("dev_seed_s",))
