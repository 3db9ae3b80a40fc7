"""Match widening/merging and the two-pass banded extension.

Port of ``lambda_tpu/search/extend.py`` (itself a port of
``lambda/src/search_algo.hpp``):

* ``_widenMatch`` / ``_widenAndPreprocessMatches`` (:919-938,
  :1136-1175): widen every seed match to the full query frame plus a
  sqrt-band margin on the subject, sort, merge overlaps, swallow, dedup
  (host numpy + the native merge passes).
* ``iterateMatchesFullSimd`` (:1178-1332) two-pass extension: pass 1
  scores every candidate with K1, or K3 in the sublane layout
  (``score_parts``: windows gathered on the device from each part's
  query/subject tensors -- one part on one card, one per cell of the
  device grid), the caller filters by bit
  score/e-value (pass 1 honours ``LAMBDA_SW_XDROP`` as the JAX package
  does), pass 2 (``trace_pass``) runs the traceback with
  alignment statistics in the host C++ helpers, or, under
  ``LAMBDA_SW_TRACE=device``, through K2 on the same device windows with
  a host walk.  Candidates are bucketed by padded (qlen, band) shape
  class, one launch per class and part (``_launch_classes``).
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np
import torch

from .. import native
from ..ops import sw_band
from ..stats import card_clock, timed


def band_size(qlen: int | np.ndarray):
    """sqrt-band margin (search_misc.hpp:46-50)."""
    return np.sqrt(qlen).astype(np.int64) + 1 if isinstance(qlen, np.ndarray) \
        else int(np.sqrt(qlen)) + 1


@dataclasses.dataclass
class MatchBatch:
    """Columnar match arrays (frame-level ids, trans-space coordinates).

    ``d_lo``/``d_hi`` (set by :func:`widen_and_merge`) are the extension
    band in absolute diagonals (subjectPos - queryPos): extension is
    restricted to cells on diagonals in [d_lo, d_hi].  Bands are
    per-match state so results are independent of batching/grouping.
    """

    qry_id: np.ndarray    # frame-level query id (within batch: q*F + f)
    subj_id: np.ndarray   # frame-level subject id (global)
    qry_start: np.ndarray
    qry_end: np.ndarray
    subj_start: np.ndarray
    subj_end: np.ndarray
    d_lo: np.ndarray | None = None
    d_hi: np.ndarray | None = None

    def __len__(self):
        return len(self.qry_id)

    def take(self, idx):
        return MatchBatch(*(None if a is None else a[idx]
                            for a in self._arrays()))

    def _arrays(self):
        return (self.qry_id, self.subj_id, self.qry_start, self.qry_end,
                self.subj_start, self.subj_end, self.d_lo, self.d_hi)


def widen_and_merge(m: MatchBatch, q_lens: np.ndarray, s_lens: np.ndarray,
                    stats=None) -> MatchBatch:
    """_widenMatch + _widenAndPreprocessMatches (exact port, vectorized),
    plus the extension-band computation: each seed's band is its seed
    diagonal +- the sqrt-band margin; merged matches union their seeds'
    bands."""
    if len(m) == 0:
        return m
    qlen = q_lens[m.qry_id]
    slen = s_lens[m.subj_id]

    # extension band around the seed diagonal (clamped to real cells)
    c = m.subj_start - m.qry_start
    band = band_size(qlen)
    d_lo = np.maximum(c - band, 1 - qlen)
    d_hi = np.minimum(c + band, slen - 1)
    d_hi = np.maximum(d_hi, d_lo)

    # move sStart left to cover the query prefix
    subj_start = np.where(m.subj_start < m.qry_start, 0,
                          m.subj_start - m.qry_start)
    qry_start = np.zeros_like(m.qry_start)
    qry_end = qlen.astype(m.qry_end.dtype)
    subj_end = np.minimum(subj_start + qlen + band, slen)
    subj_start = np.where(band < subj_start, subj_start - band, 0)

    order = np.lexsort((subj_end, subj_start, qry_end, qry_start,
                        m.subj_id, m.qry_id))
    arrs = [np.ascontiguousarray(a[order], dtype=np.int64)
            for a in (m.qry_id, m.subj_id, qry_start, qry_end, subj_start,
                      subj_end, d_lo, d_hi)]
    qid, sid, qs, qe, ss_, se, dlo, dhi = arrs
    before = len(qid)
    if stats is not None and before > 1:
        # merge-pass events (the hitsMerged funnel counter)
        same = (qid[:-1] == qid[1:]) & (sid[:-1] == sid[1:])
        stats.hits_merged += int((same & (se[:-1] >= ss_[1:])).sum())
    # pairwise merge left->right, swallow right->left, unique
    # (search_algo.hpp:1148-1169), in place in the native helpers
    keep = native.merge_passes(*arrs)
    if stats is not None:
        stats.hits_duplicate += int(before - keep.sum())
    return MatchBatch(qid[keep], sid[keep], qs[keep], qe[keep],
                      ss_[keep], se[keep], dlo[keep], dhi[keep])


_BUCKETS = [16, 32, 48, 64, 96, 128, 192, 256, 384, 512, 768, 1024,
            1536, 2048, 3072, 4096, 6144, 8192]


def _bucket(n: int) -> int:
    for b in _BUCKETS:
        if n <= b:
            return b
    return int(n)


# band sizes bucket so the per-alignment band width Dbk+1 is a multiple
# of 8 (the JAX kernel's lane packing; kept so both packages launch the
# same shape classes)
_D_BUCKETS = [7, 15, 23, 31, 39, 47, 63, 79, 95, 127, 159, 191, 255,
              319, 383, 511, 767, 1023]


def _bucket_d(n: int) -> int:
    for b in _D_BUCKETS:
        if n <= b:
            return b
    return int(-(-(n + 1) // 8) * 8) - 1


_QB_ARR = np.asarray(_BUCKETS, dtype=np.int64)
_DB_ARR = np.asarray(_D_BUCKETS, dtype=np.int64)


def _bucket_codes(qlen, d_row):
    """Vectorized (_bucket, _bucket_d) over match arrays."""
    qlen = np.asarray(qlen, dtype=np.int64)
    d_row = np.asarray(d_row, dtype=np.int64)
    qi = np.searchsorted(_QB_ARR, qlen, side="left")
    qb = np.where(qi < len(_QB_ARR), _QB_ARR[np.minimum(qi, len(_QB_ARR) - 1)],
                  qlen)
    di = np.searchsorted(_DB_ARR, d_row, side="left")
    db_fb = (-(-(d_row + 1) // 8) * 8) - 1
    db = np.where(di < len(_DB_ARR), _DB_ARR[np.minimum(di, len(_DB_ARR) - 1)],
                  db_fb)
    return qb.astype(np.int64), db.astype(np.int64)


def bucket_groups(qlen, d_row, rev) -> dict:
    """Group match indices by padded (qlen bucket, band bucket, rev
    matrix) shape class -- the extension dispatch key.  Keys are python
    ints/bool, values index lists in ascending order."""
    n = len(qlen)
    if n == 0:
        return {}
    qb, db = _bucket_codes(qlen, d_row)
    rev = np.asarray(rev).astype(np.int64)
    key = (qb << 33) | (db << 1) | rev
    order = np.argsort(key, kind="stable")
    uniq, starts = np.unique(key[order], return_index=True)
    groups: dict = {}
    bounds = list(starts) + [n]
    for u, lo, hi in zip(uniq, bounds[:-1], bounds[1:]):
        i0 = order[lo]
        groups[(int(qb[i0]), int(db[i0]), bool(rev[i0]))] = \
            order[lo:hi].tolist()
    return groups


class SubjectWindows:
    """Extracts subject windows from the translated subject concat."""

    def __init__(self, trans_concat: np.ndarray, offsets: np.ndarray):
        self.concat = trans_concat
        self.offsets = offsets

    def window_virtual(self, subj_id: int, start: int, length: int,
                       pad_rank: int) -> np.ndarray:
        """Virtual extension window: subject positions [start, start+length)
        where out-of-subject positions are PAD rank.  ``start`` may be
        negative (band poking left of the subject)."""
        o = int(self.offsets[subj_id])
        slen = int(self.offsets[subj_id + 1]) - o
        out = np.full(length, pad_rank, dtype=np.int32)
        lo = max(start, 0)
        hi = min(start + length, slen)
        if hi > lo:
            out[lo - start : hi - start] = self.concat[o + lo : o + hi]
        return out


def _ext_geometry(m: MatchBatch):
    """Banded extension-window geometry per match: window start = d_lo
    (subject coords, may poke outside the subject -> PAD), window length
    = qlen + D, band [0, D] in window coordinates."""
    qlen = (m.qry_end - m.qry_start).astype(np.int64)
    d_row = (m.d_hi - m.d_lo).astype(np.int64)
    wlen = qlen + d_row
    return qlen, d_row, wlen


def trace_pass(m: MatchBatch, q_frames, s_window, subst_ext_fwd,
               subst_ext_rev, gap_first, gap_extend, bs_split: bool,
               resident=None):
    """Pass 2: banded traceback + alignment statistics of the pass-1
    survivors in the host C++ helpers (the reference's compiled tail,
    search_algo.hpp:1296,1302-1325).  Returns (scores, traces, stats),
    stats the (B, 8) int32 array [align_length, matches, mismatches,
    positives, gap_opens, gaps, insertions, deletions].

    With ``LAMBDA_SW_TRACE=device`` (read at call time, as in the JAX
    package) the traceback runs through K2 on the windows gathered from
    ``resident`` = (trans_q, trans_sbj, sbj_offsets, sbj_lens) device
    tensors, and stats is None: the caller then computes the statistics
    per match (records.compute_alignment_stats)."""
    if os.environ.get("LAMBDA_SW_TRACE") == "device":
        if resident is None:
            raise ValueError("LAMBDA_SW_TRACE=device needs the resident "
                             "query/subject tensors")
        sc, tr = _trace_device(m, resident, subst_ext_fwd, subst_ext_rev,
                               gap_first, gap_extend, bs_split)
        return sc, tr, None
    if len(m) == 0:
        return np.zeros(0, np.int64), [], np.zeros((0, 8), np.int32)
    pad = subst_ext_fwd.shape[0] - 1
    _, d_row, wlen = _ext_geometry(m)
    q_list = [q_frames[m.qry_id[i]][m.qry_start[i]:m.qry_end[i]]
              for i in range(len(m))]
    s_list = [s_window.window_virtual(int(m.subj_id[i]), int(m.d_lo[i]),
                                      int(wlen[i]), pad)
              for i in range(len(m))]
    rev = (np.asarray(m.subj_id) % 2 == 1).astype(np.uint8) \
        if bs_split else None
    return native.sw_traceback_stats_batch(
        q_list, s_list, np.asarray(subst_ext_fwd, dtype=np.int32),
        gap_first, gap_extend,
        subst_rev=(np.asarray(subst_ext_rev, dtype=np.int32)
                   if bs_split else None),
        use_rev=rev, band=d_row.astype(np.int32), bs_mode=bs_split)


def _gather_windows(resident, m: MatchBatch, idxs: np.ndarray, pad: int,
                    N: int, q_base: int = 0, s_base: int = 0):
    """The kernel inputs of one banded shape class, gathered on the
    device from the resident tensors: (q, s, d_rows) with q (B, N) int8
    the query rows, s (B, N) int8 the VIRTUAL subject windows (start
    d_lo, length qlen + d_row; positions outside the subject -> PAD) and
    d_rows (B,) int32.  ``resident`` is (trans_q, trans_sbj, sbj_offsets,
    sbj_lens); K1, K2 and K3 launches share it.  Its first query row is
    the batch's row ``q_base`` and its first subject frame the frame
    ``s_base`` (a cell of the device grid; 0 on one card).  The subject
    tensors may live on the host (--db-stream keeps the subject concat
    there): the subject windows are then gathered on the host and
    uploaded."""
    trans_q, trans_sbj, sbj_offsets, sbj_lens = resident
    dev = trans_q.device
    qlen, d_row, _ = _ext_geometry(m)

    def col(a, d=dev, base=0):
        return torch.as_tensor(np.asarray(a[idxs], dtype=np.int64) - base,
                               device=d)

    qry_id = col(m.qry_id, base=q_base)
    qry_start, qry_len, d_rows = (col(a) for a in (m.qry_start, qlen, d_row))
    iq = torch.arange(N, device=dev)
    qidx = (qry_start[:, None] + iq[None, :]).clamp(0, trans_q.shape[1] - 1)
    qwin = trans_q[qry_id[:, None], qidx]
    qwin = torch.where(iq[None, :] < qry_len[:, None], qwin, pad)

    sdev = trans_sbj.device
    subj_id = col(m.subj_id, sdev, s_base)
    d_lo, s_lim = (col(a, sdev) for a in (m.d_lo, qlen + d_row))
    iqs = torch.arange(N, device=sdev)
    spos = d_lo[:, None] + iqs[None, :]          # subject coords
    sval = (spos >= 0) & (spos < sbj_lens[subj_id][:, None]) \
        & (iqs[None, :] < s_lim[:, None])
    sabs = (sbj_offsets[subj_id][:, None] + spos).clamp(
        0, trans_sbj.shape[0] - 1)
    swin = torch.where(sval, trans_sbj[sabs], pad).to(torch.int8)
    return (qwin.to(torch.int8).contiguous(),
            swin.to(dev).contiguous(), d_rows.to(torch.int32))


def _launch_classes(m: MatchBatch, parts, part_of, e8_fwd, e8_rev,
                    bs_split: bool, launch, stats=None, card_events=None):
    """The one launch loop of pass 1 (K1/K3) and of K2: per (qlen bucket,
    band bucket, matrix) class of ``m``, in sorted order, each part that
    holds rows of the class gathers their windows (:func:`_gather_windows`)
    and calls ``launch(q, s, d_rows, e8, qbk, dbk)`` on them.  A part is
    (resident, q_base, s_base), one device's view of the data: one part
    with bases 0 on one card (resident, --db-stream, --shard-subset), one
    per cell on the device grid.  ``part_of`` holds each match's part
    (None: the one part).  ``stats`` counts one dispatch per class and
    its rows, whatever the number of parts; ``card_events`` takes CUDA
    events around each launch (stats.card_clock).  Nothing is pulled:
    returns (idxs, dbk, launch's output) per launch."""
    qlen, d_row, _ = _ext_geometry(m)
    rev = (m.subj_id % 2 == 1) if bs_split else np.zeros(len(m), dtype=bool)
    e8s: dict = {}
    pending = []
    for (qbk, dbk, r), idxs in sorted(
            bucket_groups(qlen, d_row, rev).items()):
        idxs = np.asarray(idxs)
        if stats is not None:
            stats.ext_dispatches += 1
            stats.ext_dispatch_rows += len(idxs)
        for p, (resident, q_base, s_base) in enumerate(parts):
            sel = idxs if part_of is None else idxs[part_of[idxs] == p]
            if len(sel) == 0:
                continue
            dev = resident[0].device
            if (r, dev) not in e8s:
                e8s[r, dev] = torch.as_tensor(e8_rev if r else e8_fwd,
                                              device=dev)
            e8 = e8s[r, dev]
            with card_clock(card_events, dev):
                q, s, d_rows = _gather_windows(resident, m, sel,
                                               e8.shape[0] - 1, qbk + dbk,
                                               q_base, s_base)
                pending.append((sel, dbk, launch(q, s, d_rows, e8, qbk,
                                                 dbk)))
    return pending


def score_parts(m: MatchBatch, parts, part_of, e8_fwd, e8_rev, gap_first,
                gap_extend, bs_split: bool, stats=None, card_events=None,
                pull_span: str | None = None) -> np.ndarray:
    """Pass-1 banded scores of ``m`` over ``parts``, one K1 (or K3)
    launch per class and part (:func:`_launch_classes`).  (The JAX package
    merges classes by a cost model measured on the TPU, and turns that
    merging off under X-drop; padding cannot change an exact score, so
    launching each class alone gives the same scores.)  With the latched
    ``LAMBDA_SW_XDROP`` each class is scored with X-drop at the JAX plan's
    column chunk for that class (lambda_tpu/search/extend.py: the native
    and XLA wirings take ``_plan(qbk + dbk, dbk)[3]``).  The scores are
    pulled after the last launch, in the span ``pull_span`` if given."""
    scores = np.zeros(len(m), dtype=np.int64)
    if len(m) == 0:
        return scores
    x_drop = sw_band._XDROP

    def k1(q, s, d_rows, e8, qbk, dbk):
        return sw_band.sw_band_score_device(
            q, s, d_rows, e8, dbk, int(gap_first), int(gap_extend), x_drop,
            sw_band.plan_nc(qbk + dbk, dbk) if x_drop else 0)

    pending = _launch_classes(m, parts, part_of, e8_fwd, e8_rev, bs_split,
                              k1, stats, card_events)
    with timed(stats if pull_span else None, pull_span):
        for idxs, _, out in pending:
            scores[idxs] = out.cpu().numpy()
    return scores


def sw_scores_device(m: MatchBatch, d_trans_q, d_trans_sbj, d_sbj_offsets,
                     d_sbj_lens, e8_fwd, e8_rev, gap_first, gap_extend,
                     bs_split: bool, stats=None) -> np.ndarray:
    """Pass-1 banded scores on one card: :func:`score_parts` over the one
    part of the resident tensors."""
    resident = (d_trans_q, d_trans_sbj, d_sbj_offsets, d_sbj_lens)
    return score_parts(m, [(resident, 0, 0)], None, e8_fwd, e8_rev,
                       gap_first, gap_extend, bs_split, stats=stats)


def _trace_device(m: MatchBatch, resident, subst_ext_fwd, subst_ext_rev,
                  gap_first, gap_extend, bs_split: bool):
    """Pass 2 through K2: one launch per shape class on windows gathered
    from the resident tensors, then the host walk of every row.  Returns
    (scores, traces) in the conventions of the host path."""
    n = len(m)
    scores = np.zeros(n, dtype=np.int64)
    traces: list = [None] * n

    def k2(q, s, d_rows, e8, qbk, dbk):
        return sw_band.sw_band_align_device(q, s, d_rows, e8, dbk,
                                            int(gap_first), int(gap_extend))

    for idxs, dbk, out in _launch_classes(
            m, [(resident, 0, 0)], None,
            sw_band.ext8_from_ext32(subst_ext_fwd),
            sw_band.ext8_from_ext32(subst_ext_rev), bs_split, k2):
        sc, tr = sw_band.walk_rows(*out, dbk)
        scores[idxs] = sc
        for i, t in zip(idxs, tr):
            traces[i] = t
    return scores, traces
