"""seed_ms_per_request.interactive: search.seeding's host time per request
of a closed loop (StatsHolder.time_seed_prep + time_seed + time_locate),
the mean over the untraced requests of a traced run, in ms."""

from benchmark.harness.spans import ms_per_request


def read(run):
    return ms_per_request(run, ("time_seed_prep", "time_seed", "time_locate"))
