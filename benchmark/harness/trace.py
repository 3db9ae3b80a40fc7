"""The traced part of a ``--trace 1`` run: ``torch.profiler`` around the
window's first calls, the harness's spans, the program's ``StatsHolder``
phases as spans, and the shapes of each K1 launch, reduced to numbers.

The reduction works on plain tuples so that it can be tested without a
card: device intervals ``(name, start_s, end_s)`` and host spans
``(name, start_s, end_s)``.
"""

from __future__ import annotations

import contextlib
import dataclasses

import numpy as np

# the span names the harness opens around its calls into the program
CALL_SPAN = "bench.run_search"
K1_KERNEL = "sw_band_score_kernel"
HOST_PHASES = ("time_seed", "time_locate", "time_merge", "time_extend",
               "time_extend_trace", "time_write")


def union_seconds(intervals, lo: float, hi: float) -> float:
    """Length of the union of ``(start, end)`` intervals, clipped to
    [lo, hi]."""
    total, cur_s, cur_e = 0.0, None, None
    for s, e in sorted((max(s, lo), min(e, hi)) for s, e in intervals):
        if e <= s:
            continue
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total


def idle_gaps(intervals, lo: float, hi: float):
    """The gaps of [lo, hi] in which no interval runs, as (start, end)."""
    gaps, t = [], lo
    for s, e in sorted(intervals):
        if s > t:
            gaps.append((t, min(s, hi)))
        t = max(t, e)
        if t >= hi:
            break
    if t < hi:
        gaps.append((t, hi))
    return [(s, e) for s, e in gaps if e > s]


def label_gaps(gaps, spans, top: int = 10):
    """Idle seconds by the innermost host span open at each gap's middle
    (``spans``: (name, start, end)), the ``top`` largest, as [name,
    seconds]."""
    by: dict = {}
    ordered = sorted(spans, key=lambda x: x[1])
    starts = np.array([s for _, s, _ in ordered])
    for gs, ge in gaps:
        mid = 0.5 * (gs + ge)
        name = "no span"
        for k in range(int(np.searchsorted(starts, mid, "right")) - 1, -1,
                       -1):
            n, s, e = ordered[k]
            if s <= mid < e:
                name = n
                break
        by[name] = by.get(name, 0.0) + (ge - gs)
    return sorted(([n, v] for n, v in by.items()), key=lambda x: -x[1])[:top]


def k1_cells(qlen, first, end, d) -> np.ndarray:
    """Cells the banded recurrence needs per row of a K1 launch: query
    positions i in [0, qlen) and window columns j in [first, end) with
    j - d <= i <= j (K1's band: column j holds query positions j - d to
    j).  Rows with d < 0 (batch padding) need none."""
    qlen, first, end, d = (np.asarray(a, dtype=np.int64)
                           for a in (qlen, first, end, d))

    def upto(n):        # cells of columns [0, n)
        a = np.minimum(qlen, np.maximum(0, n - d))
        b = np.minimum(qlen, n)
        return a * (d + 1) + (b - a) * n - (a + b - 1) * (b - a) // 2
    cells = upto(end) - upto(first)
    return np.where((d >= 0) & (end > first), cells, 0)


@dataclasses.dataclass
class K1Launch:
    B: int
    N: int
    C: int
    qlen: object        # device tensors until the trace is reduced
    first: object
    end: object
    d: object


class Tracer:
    """Profiles from ``start()`` to ``stop()``: device activity, the
    harness's spans, the program's StatsHolder phases and K1's shapes."""

    def __init__(self):
        self.k1: list[K1Launch] = []
        self.prof = None
        self._undo: list = []

    def start(self) -> None:
        import torch
        from lambda_tpu_torch.ops import sw_band
        from lambda_tpu_torch.stats import StatsHolder

        timed = StatsHolder.timed

        @contextlib.contextmanager
        def spanned(holder, bucket):
            with torch.profiler.record_function(bucket), timed(holder,
                                                               bucket):
                yield

        k1 = sw_band._sw_band_score_cuda

        def shaped(q, s, d_rows, subst8, *a, **kw):
            pad = subst8.shape[0] - 1
            sv = s != pad
            n = s.shape[1]
            self.k1.append(K1Launch(
                B=q.shape[0], N=n, C=subst8.shape[0],
                qlen=(q != pad).sum(1), first=sv.to(torch.int32).argmax(1),
                end=n - sv.flip(1).to(torch.int32).argmax(1),
                d=d_rows.clone()))
            return k1(q, s, d_rows, subst8, *a, **kw)

        StatsHolder.timed = spanned
        sw_band._sw_band_score_cuda = shaped
        self._undo = [(StatsHolder, "timed", timed),
                      (sw_band, "_sw_band_score_cuda", k1)]
        acts = [torch.profiler.ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        self.prof = torch.profiler.profile(activities=acts)
        self.prof.__enter__()

    def stop(self) -> None:
        import torch
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        self.prof.__exit__(None, None, None)
        for obj, attr, val in self._undo:
            setattr(obj, attr, val)
        self._undo = []

    def events(self):
        """(device intervals, host spans) in seconds: device kernels and
        copies as (name, start, end, is_kernel); the harness's and the
        StatsHolder spans as (name, start, end)."""
        import torch
        dev, host = [], []
        names = set(HOST_PHASES) | {CALL_SPAN}
        for e in self.prof.profiler.kineto_results.events():
            t0, t1 = e.start_ns() * 1e-9, e.end_ns() * 1e-9
            n = e.name()
            if e.device_type() != torch.autograd.DeviceType.CUDA:
                if n in names:
                    host.append((n, t0, t1))
            elif not (n in names or e.is_user_annotation()):
                # the spans' copies on the device's timeline are not work
                dev.append((n, t0, t1, not n.startswith(("Memcpy",
                                                         "Memset"))))
        return dev, host

    def k1_shapes(self):
        """(B, N, C, cells per row) of each recorded K1 launch."""
        out = []
        for L in self.k1:
            out.append((L.B, L.N, L.C, k1_cells(
                L.qlen.cpu().numpy(), L.first.cpu().numpy(),
                L.end.cpu().numpy(), L.d.cpu().numpy())))
        return out


def reduce(dev, host, k1_shapes, window: tuple, peaks: dict | None) -> dict:
    """Numbers of a traced window [lo, hi] (seconds, the profiler's
    clock): busy and window seconds, kernel launches, the device
    operations that took most time, idle gaps labelled by host span,
    and K1's least and measured device seconds."""
    lo, hi = window
    busy = union_seconds([(s, e) for _, s, e, _ in dev], lo, hi)
    kernels = [(n, s, e) for n, s, e, k in dev if k and lo <= s < hi]
    by: dict = {}
    for n, s, e, _ in dev:
        if lo <= s < hi:
            by[n] = by.get(n, 0.0) + (e - s)
    top = sorted(([n[:96], v] for n, v in by.items()), key=lambda x: -x[1])
    gaps = idle_gaps([(s, e) for _, s, e, _ in dev], lo, hi)
    k1_time = sum(e - s for n, s, e in kernels if K1_KERNEL in n)
    k1_least = None
    if peaks and k1_shapes:
        k1_least = sum(k1_least_seconds(B, N, C, cells, peaks)
                       for B, N, C, cells in k1_shapes)
    return dict(busy_s=busy, window_s=hi - lo, launches=len(kernels),
                device_ops=top[:10], idle_gaps=label_gaps(gaps, host),
                k1_s=k1_time, k1_launches=sum(K1_KERNEL in n
                                              for n, _, _ in kernels),
                k1_least_s=k1_least)


# the banded recurrence's integer operations per cell: E and F take two
# adds and a max each, H an add and three maxes (with 0, E, F), the best
# so far a max
K1_OPS_PER_CELL = 11


def k1_least_seconds(B: int, N: int, C: int, cells, peaks: dict) -> float:
    """The least time of one K1 launch: the larger of its operations over
    the card's integer peak and its bytes (query rows, windows, bands,
    matrix and scores, each once) over the memory bandwidth."""
    ops = K1_OPS_PER_CELL * float(np.sum(cells))
    nbytes = 2 * B * N + 4 * B + C * C + 4 * B
    return max(ops / peaks["int_ops_per_s"],
               nbytes / peaks["hbm_bytes_per_s"])
