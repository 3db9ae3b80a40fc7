"""Seeding's slot walk: the adaptive elongation walk over a batch's slots.

The walk (``lambda/src/search_algo.hpp:679-726``) decides, slot after slot
of each query, how far each walked cursor is elongated, and carries the
query's ``hitsThisSeq`` from one slot to the next.  It runs on the
occurrence-count curves of the walked rows (``ops/searchsorted.py:
count_curves``), so it reads no index.

:func:`slot_walk` launches ``csrc/slot_walk.cu`` (one call: the rows'
segment bounds, then one warp per query walking its slots) for CUDA
tensors and runs the plain version :func:`slot_walk_torch` for CPU
tensors; there is no fallback from one to the other.
"""

from __future__ import annotations

import ctypes

import torch

# calls of csrc/slot_walk.cu's launcher since the last reset
launches = 0


def slot_walk_torch(cfg, curve, t_w, q_w, beg_w, flen_w, rem_w, base, hits0,
                    stats=None):
    """Plain PyTorch version of :func:`slot_walk`: a loop over the slots,
    after one host read of their row bounds (counted in
    ``stats.seed_syncs``)."""
    n, E1 = curve.shape
    E = E1 - 1
    dev = curve.device
    T, Q = base.shape
    k, mm, hf = cfg.seed_length, cfg.max_matches, cfg.heuristic_factor
    L = torch.zeros(n, dtype=torch.int64, device=dev)
    if n == 0:
        return L
    er = torch.arange(E, device=dev)
    c1, c2 = curve[:, :E], curve[:, 1:]
    can = ((beg_w[:, None] + k + er[None, :]) < flen_w[:, None]) & (c1 > 0)
    grow = c2 < c1
    hts_before = hits0.to(torch.int64)[None, :] + torch.cumsum(base, dim=0) \
        - base
    walked_acc = torch.zeros(Q, dtype=torch.int64, device=dev)
    bounds = torch.searchsorted(t_w, torch.arange(T + 1, device=dev)).tolist()
    if stats is not None:
        stats.seed_syncs += 1
    for t in range(T):
        a, b = bounds[t], bounds[t + 1]
        if a == b:
            continue
        qs = q_w[a:b]
        hts = (hts_before[t] + walked_acc)[qs]
        desired = torch.where(
            hts >= mm, 1,
            torch.clamp((mm - hts) * hf // rem_w[a:b].clamp(min=1), min=1))
        revert = (c2[a:b] < desired[:, None]) & grow[a:b]
        accept = can[a:b] & ~revert
        Lt = torch.cumprod(accept.to(torch.int64), dim=1).sum(dim=1)
        L[a:b] = Lt
        gfin = curve[a:b].gather(1, Lt[:, None])[:, 0]
        kept = (gfin > 0) & (gfin <= cfg.occ_cap)
        walked_acc.index_add_(0, qs, torch.where(kept, gfin, 0))
    return L


def slot_walk(cfg, curve, t_w, q_w, beg_w, flen_w, rem_w, base, hits0,
              stats=None):
    """The adaptive elongation walk of rows sorted by (slot, query): the
    resident seeder's walked cursors, the stream decide's cursors with a
    nonzero global count, or pigeonhole's seed slots with verified
    occurrences.

    cfg: the phase's SeedConfig (seed_length, max_matches,
    heuristic_factor, occ_cap); curve (n, E+1): each row's count with
    0..E further query characters; t_w/q_w (n,): its slot and query, the
    rows sorted by (t_w, q_w); beg_w, flen_w, rem_w (n,): its seedBegin,
    frame length and remaining-seed estimate; base (T, Q): the
    hitsThisSeq increments of each slot's rows that are not walked; hits0
    (Q,) the carried hitsThisSeq.  Step e accepts while the next position
    is inside the frame, the count is nonzero, and the extended count is
    not below both desiredOccs and the current count; the first refusal
    freezes the row.  A slot's kept rows (count in (0, occ_cap]) add their
    counts to hitsThisSeq before the next slot.  Returns L (n,) int64, the
    accepted elongations.  ``stats.seed_walk_rows`` counts the rows.

    CUDA tensors launch ``csrc/slot_walk.cu`` (no host read); CPU tensors
    run :func:`slot_walk_torch`."""
    if stats is not None:
        stats.seed_walk_rows += curve.shape[0]
    if curve.is_cuda:
        return _slot_walk_cuda(cfg, curve, t_w, q_w, beg_w, flen_w, rem_w,
                               base, hits0)
    return slot_walk_torch(cfg, curve, t_w, q_w, beg_w, flen_w, rem_w, base,
                           hits0, stats)


def _check(name, t, dev, shape):
    """Refuse a launch unless ``t`` is a contiguous int64 tensor of
    ``shape`` on ``dev``."""
    if t.device != dev or t.dtype != torch.int64 or not t.is_contiguous() \
            or tuple(t.shape) != shape:
        raise ValueError(
            f"slot_walk: {name} must be a contiguous int64 tensor of shape "
            f"{shape} on {dev} (got {t.dtype} {tuple(t.shape)} on "
            f"{t.device})")


def _slot_walk_cuda(cfg, curve, t_w, q_w, beg_w, flen_w, rem_w, base, hits0):
    from . import _build

    global launches
    dev = curve.device
    n, E1 = curve.shape
    T, Q = base.shape
    hits0 = hits0.to(torch.int64)
    _check("curve", curve, dev, (n, E1))
    for name, x in (("t_w", t_w), ("q_w", q_w), ("beg_w", beg_w),
                    ("flen_w", flen_w), ("rem_w", rem_w)):
        _check(name, x, dev, (n,))
    _check("base", base, dev, (T, Q))
    _check("hits0", hits0, dev, (Q,))
    if E1 < 1:
        raise ValueError("slot_walk: the curves need at least one column")
    L = torch.empty(n, dtype=torch.int64, device=dev)
    if n == 0:
        return L
    # the (slot, query) segments' first rows: seg[t * Q + q]
    seg = torch.empty(T * Q + 1, dtype=torch.int64, device=dev)
    fn = _build.load("slot_walk").slot_walk_launch
    fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int, ctypes.c_longlong,
                                           ctypes.c_int, ctypes.c_int] \
        + [ctypes.c_longlong] * 4 + [ctypes.c_void_p] * 4
    fn.restype = ctypes.c_int
    with _build.launch_stream(dev) as stream:
        err = fn(curve.data_ptr(), t_w.data_ptr(), q_w.data_ptr(),
                 beg_w.data_ptr(), flen_w.data_ptr(), rem_w.data_ptr(),
                 base.data_ptr(), E1 - 1, n, T, Q, cfg.seed_length,
                 cfg.max_matches, cfg.heuristic_factor, cfg.occ_cap,
                 hits0.data_ptr(), seg.data_ptr(), L.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"slot_walk launch failed: cudaError {err}")
    launches += 1
    return L
