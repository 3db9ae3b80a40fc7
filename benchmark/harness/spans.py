"""The program's spans of a search call, as its StatsHolder returns them
on each call (``Call.stats``): the readers of the per-layer metrics that
split a call's host time.  A program that does not record a span gives
None, not an error."""

from __future__ import annotations

from .cell import phase_ms_per_kq

# the ten top-level buckets of a search call, which do not overlap
TOP_LEVEL = ("time_load", "time_read", "time_seed_prep", "time_seed",
             "time_locate", "time_merge", "time_extend", "time_extend_trace",
             "time_records", "time_write")


def untraced(run) -> list:
    """The window's calls outside the profiler (all its calls where the
    profiler took the whole window), as ``phase_ms_per_kq`` takes them."""
    return [c for c in run.calls if not c.traced] or run.calls


def recorded(run, keys) -> bool:
    """Whether the run has calls and every call returned each of ``keys``."""
    return bool(run.calls) and all(k in c.stats for c in run.calls
                                   for k in keys)


def ms_per_kq(run, keys) -> float | None:
    """Milliseconds per 1,000 queries of the buckets ``keys``, or None
    where the program does not record them."""
    return phase_ms_per_kq(run, keys) if recorded(run, keys) else None


def per_kq(run, keys) -> float | None:
    """A counter's sum per 1,000 queries, or None where the program does
    not count it."""
    v = ms_per_kq(run, keys)
    return None if v is None else v / 1e3


def unspanned_pct(run) -> float | None:
    """The share of the calls' own clock (``t1 - t0``) outside every
    top-level bucket, in %."""
    if not recorded(run, TOP_LEVEL):
        return None
    calls = untraced(run)
    total = sum(c.t1 - c.t0 for c in calls)
    if total <= 0:
        return None
    spanned = sum(c.stats[k] for c in calls for k in TOP_LEVEL)
    return 100.0 * (total - spanned) / total


def ms_per_request(run, keys) -> float | None:
    """The mean over the window's untraced requests of the buckets
    ``keys``, in ms, or None where the program does not record them."""
    if not recorded(run, keys):
        return None
    calls = untraced(run)
    return 1e3 * sum(c.stats[k] for c in calls for k in keys) / len(calls)
