"""Batched masked binary search over the sorted suffix-prefix key index.

The device-side replacement for FM-index cursor operations
(``lambda/src/search_algo.hpp:486-534`` search_impl, ``:679-726``
adaptive elongation): a "cursor" is a half-open range [lo, hi) of rows in
the sorted key array whose keys start with a given character prefix;
extending the cursor right = re-searching within the range with one more
character.

Keys are held as int64 tensors carrying the index's uint32 word values:
torch has no unsigned 32-bit compare, shift or max, and int64 keeps the
unsigned order of every word exactly.

:func:`search_range` and :func:`count_curves` launch
``csrc/searchsorted.cu`` (one launch a call) for CUDA tensors and run
their plain versions (:func:`search_range_torch`,
:func:`count_curves_torch`) for CPU tensors; there is no fallback from
one to the other.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

UINT32_MAX = 0xFFFFFFFF

# launches of csrc/searchsorted.cu (both entries) since the last reset
launches = 0


def length_masks(lengths: torch.Tensor, bits: int, cpw: int,
                 words: int) -> torch.Tensor:
    """Per-word masks selecting the first ``lengths`` characters of a key.

    lengths: (...,) integer prefix lengths in characters.
    Returns (..., words) int64 masks (chars are packed MSB-first,
    left-aligned: char k of word w occupies bits [32-(k+1)*bits, 32-k*bits)).
    """
    w_idx = torch.arange(words, dtype=torch.int64, device=lengths.device)
    used = (lengths.to(torch.int64)[..., None] - w_idx * cpw).clamp(0, cpw)
    full = (UINT32_MAX << (32 - used * bits)) & UINT32_MAX
    return torch.where(used > 0, full, 0)


def _masked_cmp(key_words, target_words, masks):
    """Lexicographic compare of masked keys against (pre-masked) targets.

    key_words/target_words/masks: (..., words) int64.
    Returns (lt, eq) booleans of shape (...,).
    """
    kw = key_words & masks
    lt_w = kw < target_words
    eq_w = kw == target_words
    lt = torch.zeros(kw.shape[:-1], dtype=torch.bool, device=kw.device)
    eq = torch.ones(kw.shape[:-1], dtype=torch.bool, device=kw.device)
    for w in range(kw.shape[-1]):
        lt = lt | (eq & lt_w[..., w])
        eq = eq & eq_w[..., w]
    return lt, eq


def search_range_torch(keys: torch.Tensor, targets: torch.Tensor,
                       masks: torch.Tensor, lo0: torch.Tensor | None = None,
                       hi0: torch.Tensor | None = None,
                       bucket: torch.Tensor | None = None,
                       bucket_shift: int | None = None,
                       valid: torch.Tensor | None = None,
                       skipped: torch.Tensor | None = None):
    """Plain PyTorch version of :func:`search_range`: the bisection as
    eager tensor ops, lower- and upper-bound steps over all rows at once,
    as many as the largest initial range needs (``steps_for``, a host
    read, free on the CPU; further steps would be no-ops)."""
    n = targets.shape[0]
    dev = targets.device
    lo0 = torch.zeros(n, dtype=torch.int64, device=dev) if lo0 is None \
        else lo0.to(torch.int64)
    hi0 = torch.full((n,), keys.shape[0], dtype=torch.int64, device=dev) \
        if hi0 is None else hi0.to(torch.int64)
    given_lo = lo0
    if bucket is not None and bucket_shift is not None:
        full = ((UINT32_MAX << bucket_shift) & UINT32_MAX
                if bucket_shift < 32 else 0)
        usable = (masks[..., 0] & full) == full
        pfx = targets[..., 0] >> bucket_shift
        blo = bucket[pfx]
        bhi = bucket[pfx + 1]
        lo0 = torch.where(usable, torch.maximum(lo0, blo), lo0)
        hi0 = torch.where(usable, torch.minimum(hi0, bhi), hi0)
        hi0 = torch.maximum(hi0, lo0)
    n_steps = steps_for(int((hi0 - lo0).max().clamp(min=0))) if n else 0

    last = keys.shape[0] - 1
    lo_l, hi_l, lo_u, hi_u = lo0, hi0, lo0, hi0
    for _ in range(n_steps):
        # lower bound: first row >= target (the mid of an empty range is
        # clamped into the key array; its compare result is discarded)
        mid = lo_l + ((hi_l - lo_l) >> 1)
        lt, _ = _masked_cmp(keys[mid.clamp(0, last)], targets, masks)
        open_l = lo_l < hi_l
        lo_l = torch.where(open_l & lt, mid + 1, lo_l)
        hi_l = torch.where(open_l & ~lt, mid, hi_l)
        # upper bound: first row > target
        mid = lo_u + ((hi_u - lo_u) >> 1)
        lt, eq = _masked_cmp(keys[mid.clamp(0, last)], targets, masks)
        leq = lt | eq
        open_u = lo_u < hi_u
        lo_u = torch.where(open_u & leq, mid + 1, lo_u)
        hi_u = torch.where(open_u & ~leq, mid, hi_u)
    if valid is not None:
        lo_l = torch.where(valid, lo_l, given_lo)
        hi_u = torch.where(valid, hi_u, given_lo)
        if skipped is not None:
            skipped += (~valid).sum()
    return lo_l, hi_u


def search_range(keys: torch.Tensor, targets: torch.Tensor,
                 masks: torch.Tensor, lo0: torch.Tensor | None = None,
                 hi0: torch.Tensor | None = None,
                 bucket: torch.Tensor | None = None,
                 bucket_shift: int | None = None,
                 valid: torch.Tensor | None = None,
                 skipped: torch.Tensor | None = None):
    """Find, within initial ranges [lo0, hi0), the subrange of rows whose
    masked keys equal ``targets``.

    keys:    (P, words) int64 sorted rows
    targets: (N, words) int64, zero beyond the prefix
    masks:   (N, words) int64 prefix masks
    lo0/hi0: (N,) initial range; None: 0 / P (a full search).  Every
             range is bisected until it is empty, so no step count is
             given.
    bucket/bucket_shift: optional first-word prefix bucket table (see
             ``prefix_table``, int64); for every target whose mask covers
             the bucketed prefix the initial range is intersected with its
             bucket.
    valid:   optional (N,) bool; an invalid row gives [lo0, lo0) (count 0)
             without a key read, and ``skipped``, a (1,) int64 tensor on
             the keys' device, if given, counts it.

    Returns (lo, hi): (N,) int64 each; hi - lo is the occurrence count.
    CUDA tensors launch ``csrc/searchsorted.cu``'s range search; CPU
    tensors run :func:`search_range_torch`."""
    if keys.is_cuda:
        return _search_range_cuda(keys, targets, masks, lo0, hi0, bucket,
                                  bucket_shift, valid, skipped)
    return search_range_torch(keys, targets, masks, lo0, hi0, bucket,
                              bucket_shift, valid, skipped)


def curve_plan(length: int, E: int, bits: int, cpw: int,
               words: int) -> torch.Tensor:
    """The steps of a count curve from ``length`` characters: (E, words +
    2) int64 rows, step e's prefix masks of length + e + 1 characters,
    then the word and shift at which the character at position length + e
    is packed (``kmer.append_char``'s; word -1 past the key's capacity)."""
    lens = torch.arange(length + 1, length + E + 1)
    pos = lens - 1
    word = torch.where(pos < cpw * words, pos // cpw, -1)
    shift = 32 - ((pos % cpw) + 1) * bits
    return torch.cat([length_masks(lens, bits, cpw, words), word[:, None],
                      shift[:, None]], dim=1)


def count_curves_torch(keys: torch.Tensor, targets: torch.Tensor,
                       lo: torch.Tensor, count: torch.Tensor,
                       chars: torch.Tensor, plan: torch.Tensor):
    """Plain PyTorch version of :func:`count_curves`: one
    :func:`search_range_torch` per step."""
    words = keys.shape[1]
    los, cnts = [lo], [count]
    hi = lo + count
    tgt = targets
    for e in range(chars.shape[1]):
        w, sh = (int(x) for x in plan[e, words:])
        if w >= 0:
            tgt = tgt.clone()
            tgt[:, w] += (chars[:, e].to(torch.int64) + 1) << sh
        lo, hi = search_range_torch(keys, tgt, plan[e, :words], lo, hi)
        los.append(lo)
        cnts.append(hi - lo)
    return torch.stack(los, dim=1), torch.stack(cnts, dim=1)


def count_curves(keys: torch.Tensor, targets: torch.Tensor, lo: torch.Tensor,
                 count: torch.Tensor, chars: torch.Tensor,
                 plan: torch.Tensor):
    """Occurrence-count curves of n cursors (cursor.extendRight repeated).

    targets: (n, words) packed strings; lo/count: (n,) their ranges;
    chars: (n, E) the query ranks appended one per step; plan: the
    steps' masks, words and shifts (:func:`curve_plan`).  Step e appends
    chars[:, e] and re-searches within step e - 1's range.  Returns
    (lo_curve, cnt_curve): (n, E + 1) int64, column 0 the given (lo,
    count).  CUDA tensors launch ``csrc/searchsorted.cu``'s curve search
    (one launch); CPU tensors run :func:`count_curves_torch`."""
    if keys.is_cuda:
        return _count_curves_cuda(keys, targets, lo, count, chars, plan)
    return count_curves_torch(keys, targets, lo, count, chars, plan)


def _check(name, t, dtype, dev, shape=None):
    """Refuse a launch unless ``t`` is a contiguous ``dtype`` tensor on
    ``dev`` (of ``shape`` where given)."""
    if t.device != dev or t.dtype != dtype or not t.is_contiguous() \
            or (shape is not None and tuple(t.shape) != shape):
        want = f" of shape {shape}" if shape is not None else ""
        raise ValueError(
            f"searchsorted: {name} must be a contiguous {dtype} tensor"
            f"{want} on {dev} (got {t.dtype} {tuple(t.shape)} on "
            f"{t.device})")


def _ptr(t):
    return None if t is None else t.data_ptr()


def _search_range_cuda(keys, targets, masks, lo0, hi0, bucket, bucket_shift,
                       valid, skipped):
    from . import _build

    global launches
    dev = keys.device
    P, words = keys.shape
    n = targets.shape[0]
    _check("keys", keys, torch.int64, dev)
    _check("targets", targets, torch.int64, dev, (n, words))
    _check("masks", masks, torch.int64, dev, (n, words))
    if P == 0:
        raise ValueError("searchsorted: the key array is empty")
    if lo0 is not None:
        lo0 = lo0.to(torch.int64).contiguous()
        _check("lo0", lo0, torch.int64, dev, (n,))
    if hi0 is not None:
        hi0 = hi0.to(torch.int64).contiguous()
        _check("hi0", hi0, torch.int64, dev, (n,))
    if bucket is None or bucket_shift is None:
        bucket, bucket_shift = None, 32
    else:
        _check("bucket", bucket, torch.int64, dev)
    if valid is not None:
        _check("valid", valid, torch.bool, dev, (n,))
    if skipped is not None:
        _check("skipped", skipped, torch.int64, dev, (1,))
    lo = torch.empty(n, dtype=torch.int64, device=dev)
    hi = torch.empty(n, dtype=torch.int64, device=dev)
    if n == 0:
        return lo, hi
    fn = _build.load("searchsorted").ss_range_launch
    fn.argtypes = [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int] \
        + [ctypes.c_void_p] * 6 + [ctypes.c_int, ctypes.c_longlong] \
        + [ctypes.c_void_p] * 4
    fn.restype = ctypes.c_int
    with _build.launch_stream(dev) as stream:
        err = fn(keys.data_ptr(), P, words, targets.data_ptr(),
                 masks.data_ptr(), _ptr(lo0), _ptr(hi0), _ptr(valid),
                 _ptr(bucket), int(bucket_shift), n, lo.data_ptr(),
                 hi.data_ptr(), _ptr(skipped), stream)
    if err != 0:
        raise RuntimeError(f"searchsorted range launch failed: cudaError "
                           f"{err}")
    launches += 1
    return lo, hi


def _count_curves_cuda(keys, targets, lo, count, chars, plan):
    from . import _build

    global launches
    dev = keys.device
    P, words = keys.shape
    n, E = chars.shape
    _check("keys", keys, torch.int64, dev)
    _check("targets", targets, torch.int64, dev, (n, words))
    _check("lo", lo, torch.int64, dev, (n,))
    _check("count", count, torch.int64, dev, (n,))
    _check("chars", chars, torch.int64, dev, (n, E))
    _check("plan", plan, torch.int64, dev, (E, words + 2))
    if P == 0:
        raise ValueError("searchsorted: the key array is empty")
    lo_curve = torch.empty((n, E + 1), dtype=torch.int64, device=dev)
    cnt_curve = torch.empty((n, E + 1), dtype=torch.int64, device=dev)
    if n == 0:
        return lo_curve, cnt_curve
    fn = _build.load("searchsorted").ss_curves_launch
    fn.argtypes = [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int] \
        + [ctypes.c_void_p] * 5 + [ctypes.c_int, ctypes.c_longlong] \
        + [ctypes.c_void_p] * 3
    fn.restype = ctypes.c_int
    with _build.launch_stream(dev) as stream:
        err = fn(keys.data_ptr(), P, words, targets.data_ptr(),
                 lo.data_ptr(), count.data_ptr(), chars.data_ptr(),
                 plan.data_ptr(), E, n, lo_curve.data_ptr(),
                 cnt_curve.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"searchsorted curve launch failed: cudaError "
                           f"{err}")
    launches += 1
    return lo_curve, cnt_curve


def pick_bucket_m(bits: int, cpw: int, n_rows: int) -> int:
    """Largest first-word prefix length m (chars) whose bucket table
    (2^(bits*m)+1 entries) stays within ~16x the row count and a 16 Mi
    entry cap."""
    cap = min(1 << 24, max(4096, 16 * max(n_rows, 1)))
    m = 0
    while m < cpw and (1 << (bits * (m + 1))) <= cap:
        m += 1
    return m


def prefix_table(keys_word0: np.ndarray, bits: int, m: int) -> np.ndarray:
    """Host-side bucket table over the top ``m`` packed characters of
    word 0 of the SORTED key rows: entry p = index of the first row
    whose word-0 top bits equal p; entry 2^(bits*m) = n_rows."""
    shift = np.uint32(32 - bits * m)
    pfx = (keys_word0.astype(np.uint32) >> shift).astype(np.int64)
    counts = np.bincount(pfx, minlength=1 << (bits * m))
    table = np.zeros((1 << (bits * m)) + 1, dtype=np.int32)
    table[1:] = np.cumsum(counts).astype(np.int32)
    return table


def steps_for(num_rows: int) -> int:
    n = 1
    while (1 << n) < num_rows + 1:
        n += 1
    return n + 1
