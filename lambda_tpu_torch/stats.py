"""Run statistics: the hit funnel (StatsHolder port,
``lambda/src/search_datastructures.hpp:91-295``) plus per-phase
wall-time buckets (the always-available equivalent of the reference's
compile-time LAMBDA_MICRO_STATS timings, search_datastructures.hpp:118-130,
256-284).

The port's copy of the JAX package's module, with the spans of a search
call after its fields: ten top-level buckets (``time_load``,
``time_read``, ``time_seed_prep``, the six phases ``time_seed`` ...
``time_write`` and ``time_records``) that never overlap, nested spans
inside them, seeding's device clock and its host syncs, and under the
device mesh each card's device clock and memory peak.  While a torch
profiler runs, every bucket is also a ``record_function`` span on the
profiler's clock."""

from __future__ import annotations

import contextlib
import dataclasses
import time

import torch

from .ops import slot_walk


def span(name: str):
    """A ``record_function`` span ``name`` while a torch profiler runs;
    otherwise nothing (one bool test)."""
    if torch.autograd.profiler._is_profiler_enabled:
        return torch.profiler.record_function(name)
    return contextlib.nullcontext()


def timed(stats, bucket: str):
    """``stats.timed(bucket)``, or nothing where ``stats`` is None."""
    return contextlib.nullcontext() if stats is None else stats.timed(bucket)


@contextlib.contextmanager
def card_clock(events: list | None, dev: torch.device):
    """CUDA events on ``dev``'s current stream before and after the
    block's work, appended to ``events`` as (device, start, end) for
    :meth:`StatsHolder.add_card_seconds`; nothing where ``events`` is None
    or ``dev`` is not a card."""
    if events is None or dev.type != "cuda":
        yield
        return
    stream = torch.cuda.current_stream(dev)
    start, end = (torch.cuda.Event(enable_timing=True) for _ in "ab")
    start.record(stream)
    try:
        yield
    finally:
        end.record(stream)
        events.append((dev, start, end))


@dataclasses.dataclass
class StatsHolder:
    hits_after_seeding: int = 0
    hits_merged: int = 0
    hits_too_short: int = 0
    hits_masked: int = 0
    hits_failed_pre_extend: int = 0
    hits_failed_percent_ident: int = 0
    hits_failed_bit_score: int = 0
    hits_failed_e_value: int = 0
    hits_abundant: int = 0
    hits_duplicate: int = 0
    hits_duplicate2: int = 0
    hits_final: int = 0
    qrys_with_hit: int = 0
    pairs: int = 0
    # TPU-specific overflow counters (fixed-budget buffers)
    cursors_overflow: int = 0
    hits_overflow: int = 0
    # extension-kernel operating point: dispatches and the alignments
    # they carried (mean rows/dispatch vs the GCUPS-vs-B curve,
    # docs/PERF.md §1)
    ext_dispatches: int = 0
    ext_dispatch_rows: int = 0
    # micro-stats: per-phase wall time (seconds)
    time_seed: float = 0.0
    time_locate: float = 0.0
    time_merge: float = 0.0
    time_extend: float = 0.0
    time_extend_trace: float = 0.0
    time_write: float = 0.0
    # micro-stats: located-seed length distribution (the reference's
    # LAMBDA_MICRO_STATS seedLengths histogram mean/stddev/max,
    # search_datastructures.hpp:118-130; adaptive elongation makes the
    # lengths vary)
    seed_len_n: int = 0
    seed_len_sum: int = 0
    seed_len_sumsq: int = 0
    seed_len_max: int = 0
    # the port's spans (seconds): the other top-level buckets -- the index
    # load, the query read and encode, seeding's host preparation (frames,
    # seed schedule, uploads), pass-1 scores to records (filters, the
    # per-match loop) --
    time_load: float = 0.0
    time_read: float = 0.0
    time_seed_prep: float = 0.0
    time_records: float = 0.0
    # ... nested: the count curves and slot walk (in time_seed), the
    # db-stream shard uploads (in time_seed), phase 2's re-search of the
    # phase-1 losers (spans the buckets of its own work)
    time_seed_walk: float = 0.0
    time_stream_upload: float = 0.0
    time_phase2: float = 0.0
    # seeding's device-timeline seconds (CUDA events around each seeder
    # call, retries included, on the stream of the device the batch lives
    # on: under the mesh the first cell's card alone; 0 on the CPU) and
    # its device-to-host reads
    dev_seed_s: float = 0.0
    seed_syncs: int = 0
    # seeding's batched range searches (ops/searchsorted.py): the rows
    # searched, and the invalid ones (padded slots, identity
    # substitutions) answered without a key read -- counted on the device
    # (see skipped_counter) and read once the call's work is done
    seed_search_rows: int = 0
    seed_search_skipped: int = 0
    # the rows of seeding's slot walks (ops/slot_walk.py), known on the
    # host from the nonzero each walk's caller reads
    seed_walk_rows: int = 0
    # the device mesh (--db-shards/--q-shards), nested: pass A's per-cell
    # counts reaching each q row's first card and summed there (in
    # time_seed); each cell's stats vector, packed rows and pass-1 scores
    # moved to the host and rebased to global ids (in time_locate and
    # time_extend)
    time_mesh_reduce: float = 0.0
    time_mesh_gather: float = 0.0
    # the mesh's cards' own device clocks: CUDA events on each card's
    # stream around its seeding passes and its pass-1 work (window gather
    # and K1), summed per card over a call; the sum over the cards and the
    # largest card's, added up over calls.  The largest
    # torch.cuda.max_memory_allocated of the mesh's cards at a call's end.
    # All 0 without the mesh and on the CPU.
    dev_card_sum_s: float = 0.0
    dev_card_max_s: float = 0.0
    card_mem_peak_bytes: int = 0

    def __iadd__(self, o: "StatsHolder"):
        for f in dataclasses.fields(self):
            if f.name in ("seed_len_max", "card_mem_peak_bytes"):
                setattr(self, f.name, max(getattr(self, f.name),
                                          getattr(o, f.name)))
            else:
                setattr(self, f.name,
                        getattr(self, f.name) + getattr(o, f.name))
        return self

    def skipped_counter(self, device) -> torch.Tensor:
        """The (1,) int64 tensor on ``device`` that the range searches add
        their skipped rows into, without a host read; made on first use.
        :meth:`read_device_counters` moves the counts into
        ``seed_search_skipped``."""
        counters = self.__dict__.setdefault("_device_counters", {})
        if device not in counters:
            counters[device] = torch.zeros(1, dtype=torch.int64,
                                           device=device)
        return counters[device]

    def read_device_counters(self) -> None:
        """Add the device counters into ``seed_search_skipped``: one read
        per device, made when the call's work is done; fold the call's
        per-card clocks (:meth:`add_card_seconds`) into
        ``dev_card_sum_s`` and ``dev_card_max_s``."""
        for c in self.__dict__.pop("_device_counters", {}).values():
            self.seed_search_skipped += int(c)
        clocks = self.__dict__.pop("_card_s", {})
        if clocks:
            self.dev_card_sum_s += sum(clocks.values())
            self.dev_card_max_s += max(clocks.values())

    def add_card_seconds(self, events: list) -> None:
        """Add the seconds between each (device, start, end) pair of
        :func:`card_clock` to that card's clock of this call, and empty
        ``events``.  Every event must be complete: read them after a pull
        that waited for the card's stream, which adds no sync."""
        clocks = self.__dict__.setdefault("_card_s", {})
        for dev, start, end in events:
            clocks[dev] = clocks.get(dev, 0.0) \
                + start.elapsed_time(end) / 1e3
        events.clear()

    def add_seed_lens(self, sl) -> None:
        """Accumulate located-seed lengths (any integer array-like)."""
        import numpy as np

        sl = np.asarray(sl, dtype=np.int64)
        if sl.size == 0:
            return
        self.seed_len_n += int(sl.size)
        self.seed_len_sum += int(sl.sum())
        self.seed_len_sumsq += int((sl * sl).sum())
        self.seed_len_max = max(self.seed_len_max, int(sl.max()))

    @contextlib.contextmanager
    def timed(self, bucket: str):
        t0 = time.perf_counter()
        try:
            with span(bucket):
                yield
        finally:
            setattr(self, bucket,
                    getattr(self, bucket) + time.perf_counter() - t0)

    def print_report(self, options) -> None:
        if options.verbosity >= 2:
            rem = self.hits_after_seeding
            print("   HITS                            Remaining")
            print(f"   after Seeding               {rem:>12}")
            for label, n in [
                ("failed pre-extend test", self.hits_failed_pre_extend),
                ("failed e-value test", self.hits_failed_e_value),
                ("failed bitScore test", self.hits_failed_bit_score),
                ("failed %-identity test", self.hits_failed_percent_ident),
                ("duplicates", self.hits_duplicate),
                ("late duplicates", self.hits_duplicate2),
                ("abundant", self.hits_abundant),
            ]:
                rem -= n
                print(f" - {label:<27}{n:>12} = {rem}")
            # info lines (not part of the subtraction funnel: masked /
            # too-short count schedule-time suppressions, merged counts
            # window unions — both happen BEFORE/DURING seeding+merge, so
            # their units are not post-seeding hits; the reference
            # declares these counters but never increments them in
            # lambda3, search_datastructures.hpp:95-97)
            if self.hits_masked:
                print(f"   [masked seed starts:        {self.hits_masked}]")
            if self.hits_too_short:
                print(f"   [query frames too short:    {self.hits_too_short}]")
            if self.hits_merged:
                print(f"   [windows merged:            {self.hits_merged}]")
            if self.cursors_overflow or self.hits_overflow:
                print(f"   [buffer overflows: cursors={self.cursors_overflow} "
                      f"hits={self.hits_overflow}]")
            if self.seed_len_n:
                mean = self.seed_len_sum / self.seed_len_n
                var = max(self.seed_len_sumsq / self.seed_len_n
                          - mean * mean, 0.0)
                print(f"   [seed length: mean {mean:.1f} sd {var ** 0.5:.1f}"
                      f" max {self.seed_len_max} n {self.seed_len_n}]")
            if self.ext_dispatches:
                print(f"   [extension dispatches: {self.ext_dispatches}, "
                      f"mean alignments/dispatch "
                      f"{self.ext_dispatch_rows / self.ext_dispatches:.0f}]")
            if rem != self.hits_final:
                print("WARNING: hits don't add up")
            print("   PHASE TIMES (s)   seed={:.2f} locate={:.2f} merge={:.2f}"
                  " extend={:.2f} extendTrace={:.2f} write={:.2f}".format(
                      self.time_seed, self.time_locate, self.time_merge,
                      self.time_extend, self.time_extend_trace,
                      self.time_write))
            print("   SPANS (s)   load={:.2f} read={:.2f} seedPrep={:.2f}"
                  " seedWalk={:.2f} records={:.2f} phase2={:.2f}"
                  " streamUpload={:.2f}".format(
                      self.time_load, self.time_read, self.time_seed_prep,
                      self.time_seed_walk, self.time_records,
                      self.time_phase2, self.time_stream_upload))
            if self.dev_seed_s or self.seed_syncs:
                print(f"   [seeding: device {self.dev_seed_s:.2f} s, "
                      f"host syncs {self.seed_syncs}]")
            if self.seed_search_rows:
                print(f"   [seed search: rows {self.seed_search_rows}, "
                      f"skipped {self.seed_search_skipped}]")
            if self.seed_walk_rows:
                print(f"   [seed walk: rows {self.seed_walk_rows}, "
                      f"S2 launches in this process {slot_walk.launches}]")
            if self.dev_card_sum_s or self.time_mesh_gather:
                print(f"   [mesh: reduce {self.time_mesh_reduce:.2f} s, "
                      f"gather {self.time_mesh_gather:.2f} s, cards "
                      f"{self.dev_card_sum_s:.2f} s (largest "
                      f"{self.dev_card_max_s:.2f} s), memory peak "
                      f"{self.card_mem_peak_bytes / 1e9:.2f} GB]")
        if options.verbosity >= 1:
            print(f"Number of total hits:                           {self.hits_final}")
            print(f"Number of Query-Subject pairs:                  {self.pairs}")
            print(f"Number of Queries with at least one valid hit:  {self.qrys_with_hit}")
