"""Device seeding engine (torch): the fused seeder and the db-stream passes.

Port of ``lambda_tpu/search/seeding.py`` (make_seeder's fused program and
make_stream_seeder's passes), itself a port of the reference seeding loop
(``lambda/src/search_algo.hpp`` ``search()`` :607-762,
``search_impl`` :484-535, ``searchHalfExactImpl`` :537-604):

* stage 1: for every query the seeds are visited in the reference's
  order; each slot searches all seed variants (exact / half-exact
  enumeration), applies adaptive elongation (cursor extendRight while
  count >= desiredOccs, :679-726) and the abundance cutoff (:729).  The
  ``hitsThisSeq`` feedback that drives desiredOccs is carried across the
  slots (located hits, not prescore-passing hits: the JAX package's
  documented deviation, kept).
* stage 2: all cursors of the batch are expanded into a dense hit list,
  positions and frames are gathered, and the ungapped diagonal prescore
  (seedLooksPromising, :426-481) runs over every hit.
* pigeonhole seeding (delta >= 2; search_datastructures.hpp:506-510): the
  seed is split into delta+1 chunks (half-exact: the exact first half is
  the one anchor), each searched exactly in stage 1; stage 2 verifies
  <= delta mismatches in reduced space over the verification region,
  reports each occurrence once (from its first exact chunk), and takes
  the adaptive elongation (by verification) and the whole-seed abundance
  cutoff on each slot's verified counts.
* database streaming (:func:`make_stream_seeder`): pass A per shard
  computes the shard's counts, the caller sums them, ``decide`` takes
  every decision once on the sums, and pass B per shard locates with the
  decisions forced -- the same integers as one resident index.

Stage 1 is reorganised for eager execution without changing a single
decision: every slot's initial search is independent of the carry, and
so is each cursor's occurrence-count CURVE (the counts of its variant
extended by 0..ext_max further query characters -- the JAX package's
``curve_impl``).  Both run batched over all slots; the slot walk then
only replays the accept/revert walk on the curves, carrying hitsThisSeq
(``ops/slot_walk.py:slot_walk``, the one copy of that decision for the
resident seeder, the stream decide and pigeonhole's walk on verified
counts).  On the card each batched search and each set of curves is one
launch of ``csrc/searchsorted.cu``, which bisects every range until it is
empty, as the JAX while-loop does, and skips padded slots and identity
substitutions without a key read; on the CPU the plain versions bound
their steps by the largest initial range.  Both give the exact ranges.
The slot walk is one call of ``csrc/slot_walk.cu`` on the card (one warp
per query carries its hitsThisSeq across the slots, no host read) and a
loop over the slots on the CPU.

Every entry point takes an optional ``stats`` (a StatsHolder): the count
curves and the slot walk are then its span ``time_seed_walk``, each
device-to-host read (a ``.tolist()``, ``nonzero`` or ``int`` of a
tensor) counts in ``seed_syncs``, the batched searches count their
rows in ``seed_search_rows`` and the invalid ones in
``seed_search_skipped``, and the slot walks their rows in
``seed_walk_rows``.  Without it nothing is recorded.
"""

from __future__ import annotations

import contextlib
import dataclasses

import numpy as np
import torch

from ..ops import kmer, searchsorted as ss, slot_walk as sw

# rows of (slot, query, variant) searched per batched initial search
_SEARCH_ROWS = 1 << 21


def _walk_span(stats):
    """The span ``time_seed_walk`` of ``stats``, or nothing without it."""
    return contextlib.nullcontext() if stats is None \
        else stats.timed("time_seed_walk")


def _synced(stats) -> None:
    """Count one device-to-host read of the seeding in ``stats``."""
    if stats is not None:
        stats.seed_syncs += 1


@dataclasses.dataclass(frozen=True)
class SeedConfig:
    """Seeding parameters for one phase."""

    seed_length: int
    seed_offset: int
    max_seed_dist: int
    half_exact: bool
    adaptive: bool
    max_matches: int
    pre_scoring: int            # region factor (0 = off)
    pre_scoring_thresh: float
    alphabet_size: int          # reduced alphabet
    bits: int
    cpw: int
    words: int
    max_cursors: int = 4096     # per-batch cursor budget
    max_hits: int = 16384       # per-batch hit budget
    heuristic_factor: int = 10  # search_algo.hpp:627
    # first-word prefix bucket length (chars) of the index's lookup
    # table (ops/searchsorted.py prefix_table); 0 = no table
    bucket_m: int = 0

    @property
    def bucket_shift(self) -> int | None:
        return (32 - self.bits * self.bucket_m) if self.bucket_m else None

    @property
    def capacity(self) -> int:
        return self.cpw * self.words

    @property
    def ext_max(self) -> int:
        return max(0, self.capacity - self.seed_length)

    @property
    def occ_cap(self) -> int:
        # abundance cutoff discards cursors with more occurrences
        return self.heuristic_factor * self.max_matches


def compute_seed_slots(trans_frames: list[np.ndarray], qry_num_frames: int,
                       unknown_rank: int, cfg: SeedConfig):
    """Host-side seed schedule.

    Returns (slot_frame, slot_begin, slot_rem, T, sched_stats): arrays of
    shape (Q, T): per original query, the ordered list of (frame row in
    batch, seedBegin) plus the remaining-seed estimate used by
    desiredOccs (search_algo.hpp:695-699).  Invalid slots have frame -1.
    sched_stats = (masked_starts, frames_too_short): seed starts skipped
    for UNKNOWN/homopolymer characters (search_algo.hpp:652-655) and
    query frames shorter than the seed length (:638).
    """
    k, off = cfg.seed_length, cfg.seed_offset
    Q = len(trans_frames) // qry_num_frames
    per_query: list[list[tuple[int, int, int]]] = [[] for _ in range(Q)]
    masked_starts = 0
    frames_too_short = 0

    needles_sum = np.zeros(Q, dtype=np.int64)
    for g, f in enumerate(trans_frames):
        needles_sum[g // qry_num_frames] += len(f)

    for q in range(Q):
        needles_pos = 0
        for fi in range(qry_num_frames):
            g = q * qry_num_frames + fi
            t = trans_frames[g]
            size = len(t)
            if size < k:
                # the reference's `continue` (search_algo.hpp:638) skips the
                # needlesPos update too
                if size > 0:
                    frames_too_short += 1
                continue
            # bad position: UNKNOWN or equal to the next char
            bad = np.zeros(size, dtype=bool)
            bad[:-1] = (t[:-1] == unknown_rank) | (t[:-1] == t[1:])
            pos = 0
            last = size - k
            while True:
                while pos < last and bad[pos]:
                    pos += 1
                    masked_starts += 1
                if pos > last:
                    break
                rem = max((int(needles_sum[q]) - needles_pos - pos) // off, 1)
                per_query[q].append((g, pos, rem))
                pos += off
            needles_pos += size

    T = max((len(x) for x in per_query), default=0)
    T = max(T, 1)
    slot_frame = np.full((Q, T), -1, dtype=np.int32)
    slot_begin = np.zeros((Q, T), dtype=np.int32)
    slot_rem = np.ones((Q, T), dtype=np.int32)
    for q, slots in enumerate(per_query):
        for t, (g, pos, rem) in enumerate(slots):
            slot_frame[q, t] = g
            slot_begin[q, t] = pos
            slot_rem[q, t] = rem
    return slot_frame, slot_begin, slot_rem, T, (masked_starts,
                                                 frames_too_short)


def _seed_mode(cfg: SeedConfig):
    """Static seed-mode constants shared by the fused seeder and the
    stream passes: (pigeon, chunk_off, chunk_len, verify_from, V,
    positions, replacements)."""
    k = cfg.seed_length
    pigeon = cfg.max_seed_dist >= 2
    if pigeon:
        if cfg.half_exact:
            # searchHalfExactImpl semantics (search_algo.hpp:537-604):
            # errors confined to the second half -> the exact first half
            # is the one anchor, verification covers [k//2, k) only
            chunk_off = np.array([0], dtype=np.int32)
            chunk_len = np.array([k // 2], dtype=np.int32)
            verify_from = k // 2
        else:
            chunk_off, chunk_len = kmer.pigeon_chunks(k, cfg.max_seed_dist)
            verify_from = 0
        return pigeon, chunk_off, chunk_len, verify_from, len(chunk_off), \
            None, None
    positions, replacements = kmer.variant_table(
        cfg.seed_length, cfg.max_seed_dist, cfg.alphabet_size,
        cfg.half_exact)
    return pigeon, None, None, 0, len(positions), positions, replacements


# the compacted cursor arrays stage 2 takes
_CURSOR_KEYS = ("lo", "count", "seed_len", "frame", "begin", "shift", "slot")


class Seeder:
    """The seeding programs of one phase config: the fused seeder
    (:meth:`__call__`: stage 1 -> stable cursor compaction -> stage 2 ->
    hit packing) and the db-stream passes (:func:`make_stream_seeder`)."""

    def __init__(self, cfg: SeedConfig):
        self.cfg = cfg
        (self.pigeon, self.chunk_off, self.chunk_len, self.verify_from,
         self.V, self.positions, self.replacements) = _seed_mode(cfg)
        # elongation steps: stage 1's walk (delta <= 1), the stream curves
        # and pigeonhole's elongation by verification
        self.E = cfg.ext_max if cfg.adaptive else 0
        # the count curves' steps (ops/searchsorted.py:curve_plan) on each
        # device of the keys, made on first use
        self._curve_plans: dict = {}

    # -- stage 1 --------------------------------------------------------

    def _variant_chars(self, red_q, gs, begin):
        """Characters (R, V, Lc), lengths (R, V) and validity (R, V) of the
        seed variants at rows (frame gs, seedBegin begin); pigeonhole: the
        chunk anchors, each at its chunk's offset and length."""
        dev = red_q.device
        last = red_q.shape[1] - 1
        R = gs.shape[0]
        if self.pigeon:
            coff = torch.as_tensor(self.chunk_off, dtype=torch.int64,
                                   device=dev)
            clen = torch.as_tensor(self.chunk_len, dtype=torch.int64,
                                   device=dev)
            ar = torch.arange(int(self.chunk_len.max()), device=dev)
            idx = (begin[:, None, None] + coff[None, :, None]
                   + ar[None, None, :]).clamp(0, last)
            return (red_q[gs[:, None, None], idx], clen.expand(R, self.V),
                    torch.ones((R, self.V), dtype=torch.bool, device=dev))
        k = self.cfg.seed_length
        idx = (begin[:, None] + torch.arange(k, device=dev)[None, :]) \
            .clamp(0, last)
        variants, vvalid = kmer.make_variants(red_q[gs[:, None], idx],
                                              self.positions,
                                              self.replacements)
        return (variants, torch.full((R, self.V), k, device=dev), vvalid)

    def _pack(self, chars, lens):
        """Packed keys and prefix masks (..., words) of ``chars`` at
        ``lens`` characters."""
        cfg = self.cfg
        return (kmer.pack_prefix(chars, lens, cfg.bits, cfg.cpw, cfg.words),
                ss.length_masks(lens, cfg.bits, cfg.cpw, cfg.words))

    def _batched_search(self, keys, n_rows, make, bucket, stats=None):
        """(lo, count) (n_rows * V,) of every row's V strings, searched
        over the whole index in batches of rows; ``make(a, b)`` gives rows
        a..b's packed targets, masks (R, V, words) and validity (R, V): an
        invalid string has count 0 and is answered without a key read."""
        cfg = self.cfg
        dev = keys.device
        V, words = self.V, cfg.words
        bsh = cfg.bucket_shift if (cfg.bucket_m and bucket is not None) \
            else None
        bkt = bucket.to(torch.int64) if bsh is not None else None
        skipped = stats.skipped_counter(dev) if stats is not None else None
        lo = torch.empty(n_rows * V, dtype=torch.int64, device=dev)
        count = torch.empty(n_rows * V, dtype=torch.int64, device=dev)
        rows = max(1, _SEARCH_ROWS // V)
        for a in range(0, n_rows, rows):
            b = min(a + rows, n_rows)
            targets, masks, valid = make(a, b)
            n = (b - a) * V
            lo_c, hi_c = ss.search_range(
                keys, targets.reshape(n, words), masks.reshape(n, words),
                bucket=bkt, bucket_shift=bsh, valid=valid.reshape(n),
                skipped=skipped)
            lo[a * V:b * V] = lo_c
            count[a * V:b * V] = hi_c - lo_c
            if stats is not None:
                stats.seed_search_rows += n
        return lo, count

    @staticmethod
    def _slot_rows(slot_frame, slot_begin, slot_rem):
        """Slot-major rows r = t * Q + q: (g, gs, begin, rem), int64."""
        g = slot_frame.t().reshape(-1).to(torch.int64)
        return (g, g.clamp(min=0),
                slot_begin.t().reshape(-1).to(torch.int64),
                slot_rem.t().reshape(-1).to(torch.int64))

    def _initial_search(self, keys, red_q, g, gs, begin, bucket,
                        stats=None):
        """(lo, count) (T * Q * V,) of every slot row's variants."""
        def make(a, b):
            chars, lens, valid = self._variant_chars(red_q, gs[a:b],
                                                     begin[a:b])
            return (*self._pack(chars, lens), valid & (g[a:b] >= 0)[:, None])

        return self._batched_search(keys, g.shape[0], make, bucket, stats)

    def _cursor_dict(self, lo, count, seed_len, shift, gs, begin, Q, T):
        """(T, Q*V) cursor arrays -> the (Q, T*V) cursor lists, in the JAX
        program's order, with each cursor's frame, seedBegin, chunk shift
        and seed-slot id (q * T + t)."""
        V = self.V
        QV = Q * V

        def qtv(x):
            return x.reshape(T, Q, V).permute(1, 0, 2).reshape(Q, T * V)

        def per_row(x):
            return x.reshape(T, Q, 1).expand(T, Q, V).reshape(T, QV)

        dev = lo.device
        slot = torch.arange(Q, device=dev)[None, :] * T \
            + torch.arange(T, device=dev)[:, None]            # (T, Q)
        return dict(lo=qtv(lo), count=qtv(count), seed_len=qtv(seed_len),
                    frame=qtv(per_row(gs)), begin=qtv(per_row(begin)),
                    shift=qtv(shift), slot=qtv(per_row(slot)))

    def stage1(self, keys, red_q, qlens, slot_frame, slot_begin, slot_rem,
               hits_this_seq0, bucket=None, stats=None):
        """Seed search + adaptive elongation + abundance cutoff over all
        slots (pigeonhole: the chunk anchors' exact counts, no decision).
        Returns dict of (Q, T*V) cursor arrays (lo, count, seed_len,
        frame, begin, shift, slot) plus ``ext_over``, the largest per-slot
        overflow of the elongation budget."""
        cfg = self.cfg
        dev = keys.device
        k, V, E = cfg.seed_length, self.V, self.E
        Q, T = slot_frame.shape
        QV = Q * V
        red_q = red_q.to(torch.int64)
        g, gs, begin, rem = self._slot_rows(slot_frame, slot_begin, slot_rem)
        lo, count = self._initial_search(keys, red_q, g, gs, begin, bucket,
                                         stats)
        lo = lo.reshape(T, QV)
        count = count.reshape(T, QV)
        seed_len = torch.full((T, QV), k, dtype=torch.int64, device=dev)
        ext_over = torch.zeros((), dtype=torch.int64, device=dev)

        if E > 0 and not self.pigeon:
            # the JAX program walks, per slot, the live cursors (nonzero
            # count) within the max_cursors budget, in (q, v) order; the
            # rest keep their initial range
            CE = min(cfg.max_cursors, QV)
            live = count > 0
            rank = torch.cumsum(live.to(torch.int64), dim=1) - 1
            ext_over = (live.sum(dim=1) - CE).clamp(min=0).max()
            walk = live & (rank < CE)
            self._walk(keys, red_q, qlens.to(torch.int64), walk, lo, count,
                       seed_len, gs, begin, rem, hits_this_seq0, Q, T, stats)
        if self.pigeon:
            # chunk-anchor counts are counts of a much shorter string: the
            # abundance cutoff waits for stage 2's verified counts
            shift = torch.as_tensor(self.chunk_off, dtype=torch.int64,
                                    device=dev).repeat(T, Q)
            keep = count > 0
        else:
            shift = torch.zeros_like(lo)
            # abundance cutoff (search_algo.hpp:729)
            keep = (count > 0) & (count <= cfg.occ_cap)
        cur = self._cursor_dict(lo, torch.where(keep, count, 0), seed_len,
                                shift, gs, begin, Q, T)
        cur["ext_over"] = ext_over
        return cur

    def _count_curves(self, keys, red_q, widx, lo, count, gs, begin, Q):
        """Occurrence-count curves of the cursors ``widx`` (flat (t, q, v)
        indices into the (T, Q*V) arrays): step e re-searches the variant
        extended by e+1 query characters inside the step-e range
        (``ss.count_curves``, one launch on the card).
        Returns (t_w, q_w, r_w, lo_curve, cnt_curve), the curves
        (n, E+1)."""
        cfg = self.cfg
        dev = keys.device
        k, V, E = cfg.seed_length, self.V, self.E
        QV = Q * V
        nW = widx.numel()
        t_w = widx // QV
        qv = widx % QV
        q_w = qv // V
        r_w = t_w * Q + q_w
        # each cursor's seed and the E query characters after it
        ar = torch.arange(k + E, device=dev)
        chars = red_q[gs[r_w][:, None],
                      (begin[r_w][:, None] + ar[None, :])
                      .clamp(0, red_q.shape[1] - 1)]
        # its own variant: the seed with the variant's one substitution
        # (position -1: the identity)
        v_w = qv % V
        pos = torch.as_tensor(self.positions, dtype=torch.int64,
                              device=dev)[v_w]
        rep = torch.as_tensor(self.replacements, dtype=torch.int64,
                              device=dev)[v_w]
        seed = torch.where(ar[None, :k] == pos[:, None], rep[:, None],
                           chars[:, :k])
        tgt = self._pack(seed, torch.full((nW,), k, device=dev))[0]
        lo_curve, cnt_curve = ss.count_curves(
            keys, tgt, lo.reshape(-1)[widx], count.reshape(-1)[widx],
            chars[:, k:].contiguous(), self._curve_plan_on(dev))
        return t_w, q_w, r_w, lo_curve, cnt_curve

    def _curve_plan_on(self, dev) -> torch.Tensor:
        """The count curves' ``ss.curve_plan`` on ``dev``, made once."""
        plan = self._curve_plans.get(dev)
        if plan is None:
            cfg = self.cfg
            plan = self._curve_plans[dev] = ss.curve_plan(
                cfg.seed_length, self.E, cfg.bits, cfg.cpw,
                cfg.words).to(dev)
        return plan

    def _walk(self, keys, red_q, qlens, walk, lo, count, seed_len, gs, begin,
              rem, hits0, Q, T, stats=None):
        """Adaptive elongation of the walked cursors, in place on the
        (T, Q*V) lo/count/seed_len arrays: their count curves, then
        ``slot_walk`` with the kept counts of the cursors that are not
        walked (fixed at their initial count) as each slot's base."""
        cfg = self.cfg
        with _walk_span(stats):
            widx = torch.nonzero(walk.reshape(-1)).reshape(-1)
            _synced(stats)
            if widx.numel() == 0:
                return
            t_w, q_w, r_w, lo_curve, cnt_curve = self._count_curves(
                keys, red_q, widx, lo, count, gs, begin, Q)
            cnt_t = count.reshape(T, Q, self.V)
            fixed = (cnt_t > 0) & (cnt_t <= cfg.occ_cap) \
                & ~walk.reshape(T, Q, self.V)
            base = torch.where(fixed, cnt_t, 0).sum(dim=2)      # (T, Q)
            L = sw.slot_walk(cfg, cnt_curve, t_w, q_w, begin[r_w],
                             qlens[gs[r_w]], rem[r_w], base, hits0, stats)
            lo.view(-1)[widx] = lo_curve.gather(1, L[:, None])[:, 0]
            count.view(-1)[widx] = cnt_curve.gather(1, L[:, None])[:, 0]
            seed_len.view(-1)[widx] = cfg.seed_length + L

    # -- compaction, stage 2, packing -----------------------------------

    def _compact(self, cur):
        """Stable device cursor compaction (valid cursors first, original
        order preserved).  Returns (the compacted (C,) cursor arrays,
        n_valid)."""
        C = self.cfg.max_cursors
        count = cur["count"].reshape(-1)
        valid = count > 0
        order = torch.argsort((~valid).to(torch.uint8), stable=True)
        c_eff = min(C, count.shape[0])
        sel = order[:c_eff]
        n_valid = valid.sum()
        keep = torch.arange(C, device=count.device) < n_valid

        def take(name):
            x = cur[name].reshape(-1)[sel]
            x = torch.nn.functional.pad(x, (0, C - c_eff))
            return torch.where(keep, x, 0)

        return {name: take(name) for name in _CURSOR_KEYS}, n_valid

    def stage2(self, kmer_pos, kmer_frame, sbj_offsets, sbj_lens, trans_sbj,
               trans_q, tq_lens, cur, subst_fwd, subst_rev, red_q=None,
               red_sbj=None, slots=None, hits0=None, emit_cnt=False,
               forced=None, stats=None):
        """Flat locate (+ pigeonhole verification) + prescore over the
        compacted (C,) cursor arrays ``cur``.  Returns per-hit arrays of
        length cfg.max_hits + stats.

        Pigeonhole mode also takes red_q/red_sbj (reduced query frames and
        subject concat), slots = (slot_frame, slot_begin, slot_rem) and
        hits0.  Stream hooks (pigeonhole only): ``emit_cnt`` returns the
        shard-LOCAL per-slot verified-count matrix (Q*T, E+1) instead of
        hits (pass A); ``forced`` = (keep_dense, L_dense) replaces the
        decisions taken here with global ones (pass B)."""
        cfg = self.cfg
        dev = cur["lo"].device
        trans_q = trans_q.to(torch.int64)
        tq_lens = tq_lens.to(torch.int64)
        C = cur["lo"].shape[0]
        Hn = cfg.max_hits
        k = cfg.seed_length
        # counts are clamped to Hn before the cumsum: hits past Hn are
        # truncated anyway; the overflow stat sums the real total (int64)
        cur_count = cur["count"]
        total_all = cur_count.sum()
        cum = torch.cumsum(torch.clamp(cur_count, max=Hn), dim=0)
        total = cum[-1]
        j = torch.arange(Hn, device=dev)
        cursor_of = torch.searchsorted(cum, j, right=True).clamp(0, C - 1)
        prev = torch.where(cursor_of > 0, cum[(cursor_of - 1).clamp(min=0)],
                           0)
        occ = j - prev
        hit_valid = j < total

        row = (cur["lo"][cursor_of] + occ).clamp(0, kmer_pos.shape[0] - 1)
        pos = kmer_pos[row].to(torch.int64)
        sframe = kmer_frame[row].to(torch.int64)
        s_off = pos - sbj_offsets[sframe] - cur["shift"][cursor_of]
        qframe = cur["frame"][cursor_of]
        qbegin = cur["begin"][cursor_of]
        slen_seed = cur["seed_len"][cursor_of]

        if self.pigeon:
            red_q = red_q.to(torch.int64)
            last_q = red_q.shape[1] - 1
            last_s = red_sbj.shape[0] - 1
            qf = qframe.clamp(0, red_q.shape[0] - 1)
            s_base = sbj_offsets[sframe]
            s_len = sbj_lens[sframe]
            # verify <= delta mismatches over the seed's verification
            # region in reduced space; accept only from the FIRST exactly
            # matching chunk
            rk = torch.arange(k, device=dev)
            q_r = red_q[qf[:, None], (qbegin[:, None] + rk).clamp(0, last_q)]
            s_r = red_sbj[(s_base[:, None] + s_off[:, None] + rk)
                          .clamp(0, last_s)].to(torch.int64)
            mism = q_r != s_r                                 # (Hn, k)
            in_bounds = (s_off >= 0) & (s_off + k <= s_len)
            n_mism = (mism & (rk >= self.verify_from)).sum(dim=1)
            ok = in_bounds & (n_mism <= cfg.max_seed_dist)
            cidx = torch.searchsorted(
                torch.as_tensor(self.chunk_off, dtype=torch.int64,
                                device=dev), cur["shift"][cursor_of])
            dup = torch.zeros(Hn, dtype=torch.bool, device=dev)
            for c in range(self.V):
                a = int(self.chunk_off[c])
                exact_c = ~mism[:, a:a + int(self.chunk_len[c])].any(dim=1)
                dup = dup | (exact_c & (c < cidx))
            hit_valid = hit_valid & ok & ~dup

            # whole-seed abundance cutoff + adaptive elongation
            # (search_algo.hpp:679-729) on the slot's VERIFIED occurrence
            # counts, the reference's whole-seed approximate-match count
            slot = cur["slot"][cursor_of]
            vi = hit_valid.to(torch.int64)
            Qd, Td = slots[0].shape
            E = self.E
            if E > 0:
                # occurrences surviving an e-char elongation are those
                # whose subject continues to match the query exactly in
                # reduced space
                er = torch.arange(E, device=dev)
                qpos = qbegin[:, None] + k + er[None, :]
                spos = s_off[:, None] + k + er[None, :]
                qch = red_q[qf[:, None], qpos.clamp(0, last_q)]
                sch = red_sbj[(s_base[:, None] + spos).clamp(0, last_s)] \
                    .to(torch.int64)
                okch = (qch == sch) & (spos < s_len[:, None]) \
                    & (qpos < tq_lens[qf][:, None])
                ext_cum = torch.cumprod(okch.to(torch.int64), dim=1)
                ext_len = ext_cum.sum(dim=1)
                upd = vi[:, None] * torch.cat(
                    [torch.ones((Hn, 1), dtype=torch.int64, device=dev),
                     ext_cum], dim=1)
                cnt = torch.zeros((Qd * Td, E + 1), dtype=torch.int64,
                                  device=dev).index_add_(0, slot, upd)
                if emit_cnt:
                    return cnt
                if forced is not None:
                    keep_dense, L_dense = forced
                else:
                    L_dense, keep_dense = self.pigeon_decide(
                        cnt, tq_lens, *slots, hits0, stats=stats)
                L_h = L_dense[slot]
                hit_valid = hit_valid & keep_dense[slot] & (ext_len >= L_h)
                slen_seed = torch.where(hit_valid, k + L_h, slen_seed)
            else:
                occ_dense = torch.zeros(Qd * Td, dtype=torch.int64,
                                        device=dev).index_add_(0, slot, vi)
                if emit_cnt:
                    return occ_dense[:, None]
                keep_dense = forced[0] if forced is not None \
                    else occ_dense <= cfg.occ_cap
                hit_valid = hit_valid & keep_dense[slot]

        if cfg.pre_scoring > 0:
            # seedLooksPromising (search_algo.hpp:426-481)
            actual = slen_seed
            eff_len0 = torch.clamp(actual,
                                   min=cfg.pre_scoring * cfg.seed_length)
            half = (eff_len0 - actual) // 2
            eqb = qbegin - half
            esb = s_off - half
            mn = torch.clamp(torch.minimum(eqb, esb), max=0)
            eqb = eqb - mn
            esb = esb - mn
            eff_len = eff_len0 + mn
            qsize = tq_lens[qframe]
            ssize = sbj_lens[sframe].to(torch.int64)
            eff_len = torch.where(
                eff_len0 > actual,
                torch.minimum(torch.minimum(qsize - eqb, ssize - esb),
                              eff_len),
                eff_len)
            EFF = max(cfg.pre_scoring * cfg.seed_length, cfg.capacity)
            r = torch.arange(EFF, device=dev)
            qc = trans_q[qframe.clamp(0, trans_q.shape[0] - 1)[:, None],
                         (eqb[:, None] + r[None, :])
                         .clamp(0, trans_q.shape[1] - 1)]
            sc = trans_sbj[(sbj_offsets[sframe][:, None] + esb[:, None]
                            + r[None, :]).clamp(0, trans_sbj.shape[0] - 1)
                           ].to(torch.int64)
            use_rev = (sframe % 2) == 1
            sub = torch.where(use_rev[:, None], subst_rev[qc, sc],
                              subst_fwd[qc, sc]).to(torch.int64)
            sub = torch.where(r[None, :] < eff_len[:, None], sub, 0)
            # Kadane with a floor at 0: run_i = S_i - min(0, min_{j<=i} S_j)
            S = torch.cumsum(sub, dim=1)
            run = S - torch.clamp(torch.cummin(S, dim=1).values, max=0)
            max_score = torch.clamp(run.max(dim=1).values, min=0)
            # threshold truncated from DOUBLE like the reference
            # (search_algo.hpp:966), as a table indexed by eff_len
            thresh_tbl = torch.tensor(
                [int(float(cfg.pre_scoring_thresh) * n)
                 for n in range(EFF + 1)], dtype=torch.int64, device=dev)
            thresh = thresh_tbl[eff_len.clamp(0, EFF)]
            passed = hit_valid & (max_score >= thresh)
        else:
            passed = hit_valid

        stats = dict(
            hits_located=hit_valid.sum(),
            hits_overflow=torch.clamp(total_all - Hn, 0, 2 ** 30),
            failed_prescore=(hit_valid & ~passed).sum(),
        )
        return dict(q_frame=qframe, q_begin=qbegin, seed_len=slen_seed,
                    s_frame=sframe, s_off=s_off,
                    valid=hit_valid, passed=passed, stats=stats)

    def pigeon_decide(self, cnt, qlens, slot_frame, slot_begin, slot_rem,
                      hits0, stats=None):
        """(L_dense, keep_dense) (Q*T,) from the GLOBAL per-slot verified
        counts ``cnt`` (Q*T, E+1): the whole-seed abundance cutoff, and
        with adaptive seeding the elongation by verification, walked over
        each query's slots in schedule order (``slot_walk``).  The
        resident stage 2 takes it on its own counts, the stream decide
        (delta >= 2) on the shard-summed ones."""
        cfg = self.cfg
        Q, T = slot_frame.shape
        dev = cnt.device
        E = cnt.shape[1] - 1
        if E == 0:
            return (torch.zeros(Q * T, dtype=torch.int64, device=dev),
                    cnt[:, 0] <= cfg.occ_cap)
        curve = cnt.reshape(Q, T, E + 1).transpose(0, 1).reshape(Q * T, E + 1)
        with _walk_span(stats):
            rows = torch.nonzero(curve[:, 0] > 0).reshape(-1)  # r = t*Q + q
            _synced(stats)
            g, gs, begin, rem = self._slot_rows(slot_frame, slot_begin,
                                                slot_rem)
            L = sw.slot_walk(cfg, curve[rows], rows // Q, rows % Q,
                             begin[rows], qlens.to(torch.int64)[gs[rows]],
                             rem[rows], torch.zeros((T, Q), dtype=torch.int64,
                                                    device=dev), hits0, stats)
        gfin = curve[rows].gather(1, L[:, None])[:, 0]
        keep = torch.zeros(Q * T, dtype=torch.bool, device=dev)
        L_all = torch.zeros(Q * T, dtype=torch.int64, device=dev)
        keep[rows] = (gfin > 0) & (gfin <= cfg.occ_cap)
        L_all[rows] = L

        def qt(x):                                 # (t, q) rows -> q*T + t
            return x.reshape(T, Q).t().reshape(-1)

        return qt(L_all), qt(keep)

    def _pack_hits(self, res):
        """Compact the (valid & passed) hits to the front, 16 bytes/hit,
        and the stats vector the host reads first."""
        sel = res["valid"] & res["passed"]
        h_order = torch.argsort((~sel).to(torch.uint8), stable=True)
        packed = torch.stack(
            [res["s_frame"], res["s_off"], res["q_begin"],
             (res["q_frame"] << 8) | res["seed_len"]],
            dim=1).to(torch.int32)
        res["packed"] = packed[h_order]
        st = res["stats"]
        res["stats_vec"] = torch.stack(
            [st["hits_located"], st["hits_overflow"], st["failed_prescore"],
             st["cursors_overflow"], sel.sum()]).to(torch.int32)
        return res

    def _finish(self, cur, kmer_pos, kmer_frame, sbj_offsets, sbj_lens,
                trans_sbj, trans_q, qlens, red_q, red_sbj, subst_fwd,
                subst_rev, slots, hits0, emit_cnt=False, forced=None,
                stats=None):
        """Compaction -> stage 2 -> packing of a stage-1 cursor dict; the
        elongation budget shares base (max_cursors) and retry semantics
        with the stage-2 cursor budget, so its overflow folds into the
        same stat."""
        cc, n_valid = self._compact(cur)
        res = self.stage2(kmer_pos, kmer_frame, sbj_offsets, sbj_lens,
                          trans_sbj, trans_q, qlens, cc, subst_fwd,
                          subst_rev, red_q, red_sbj, slots, hits0,
                          emit_cnt=emit_cnt, forced=forced, stats=stats)
        if emit_cnt:
            return res
        res["stats"]["cursors_overflow"] = torch.maximum(
            torch.clamp(n_valid - self.cfg.max_cursors, min=0),
            cur["ext_over"])
        return self._pack_hits(res)

    def __call__(self, keys, red_q, qlens, slot_frame, slot_begin, slot_rem,
                 hits_this_seq0, kmer_pos, kmer_frame, sbj_offsets, sbj_lens,
                 trans_sbj, trans_q, subst_fwd, subst_rev, bucket=None,
                 red_sbj=None, stats=None):
        """stage 1 -> device cursor compaction -> stage 2 -> packing.

        ``red_sbj``, the reduced subject concat, is needed by pigeonhole
        seeding only.  Returns a dict whose ``stats_vec`` (int32:
        hits_located, hits_overflow, failed_prescore, cursors_overflow,
        n_sel) decides the budget retry and whose ``packed`` (max_hits, 4)
        int32 rows [s_frame, s_off, q_begin, q_frame << 8 | seed_len] hold
        the selected hits first."""
        cur = self.stage1(keys, red_q, qlens, slot_frame, slot_begin,
                          slot_rem, hits_this_seq0, bucket, stats)
        return self._finish(cur, kmer_pos, kmer_frame, sbj_offsets,
                            sbj_lens, trans_sbj, trans_q, qlens, red_q,
                            red_sbj, subst_fwd, subst_rev,
                            (slot_frame, slot_begin, slot_rem),
                            hits_this_seq0, stats=stats)

    # -- database streaming (make_stream_seeder) ------------------------
    # The decisions a single index takes on its counts become one decide
    # over the counts SUMMED across sequential shard passes: the same
    # integers, so the same output bytes.

    def curve_pass(self, keys, red_q, qlens, slot_frame, slot_begin,
                   slot_rem, bucket=None, stats=None):
        """Stream pass A (delta <= 1): per-cursor occurrence-count CURVES
        (Q, T, V, E+1) of the shard: the count of variant v of slot (q, t)
        extended by its next e query characters -- a pure function of the
        query and the shard, so curves add across shards.  The walk only
        consults consecutive extensions of the accepted string, so the
        curve holds every count the single-index walk observes.  No
        budgets."""
        dev = keys.device
        V, E = self.V, self.E
        Q, T = slot_frame.shape
        red_q = red_q.to(torch.int64)
        g, gs, begin, _ = self._slot_rows(slot_frame, slot_begin, slot_rem)
        lo, count = self._initial_search(keys, red_q, g, gs, begin, bucket,
                                         stats)
        curves = torch.zeros((T * Q * V, E + 1), dtype=torch.int64,
                             device=dev)
        curves[:, 0] = count
        if E > 0:
            # a cursor with no local occurrence has an all-zero curve
            with _walk_span(stats):
                widx = torch.nonzero(count > 0).reshape(-1)
                _synced(stats)
                if widx.numel():
                    curves[widx] = self._count_curves(
                        keys, red_q, widx, lo, count, gs, begin, Q)[4]
        return curves.reshape(T, Q, V, E + 1).permute(1, 0, 2, 3)

    def curve_decide(self, curves, qlens, slot_frame, slot_begin, slot_rem,
                     hits0, max_cursors: int = 0, stats=None):
        """Stream decide (delta <= 1): the stage-1 walk (``slot_walk``)
        and abundance cutoff on the GLOBAL (shard-summed) curves, every
        cursor with a nonzero global count walked.  With ``max_cursors``
        (the device mesh) only the first ``max_cursors`` of them per slot,
        in (q, v) order, are walked, as the JAX mesh compacts its globally
        live cursors before the walk; the others keep their initial count
        (the resident stage 1's rule on global counts).  Returns
        (seed_len, keep) (Q, T, V): each cursor's decided length, and the
        global half of stage 1's keep (pass B applies the local half)."""
        cfg = self.cfg
        Q, T, V, E1 = curves.shape
        dev = curves.device
        c = curves.permute(1, 0, 2, 3).reshape(T * Q * V, E1)  # (t, q, v)
        L = torch.zeros(T * Q * V, dtype=torch.int64, device=dev)
        gfin = c[:, 0].clone()
        if E1 > 1:
            walk = gfin > 0
            base = torch.zeros((T, Q), dtype=torch.int64, device=dev)
            if max_cursors:
                live = walk.reshape(T, Q * V)
                rank = torch.cumsum(live.to(torch.int64), dim=1) - 1
                walk = (live & (rank < min(max_cursors, Q * V))).reshape(-1)
                fixed = ~walk & (gfin > 0) & (gfin <= cfg.occ_cap)
                base = torch.where(fixed, gfin, 0).reshape(T, Q, V).sum(2)
            with _walk_span(stats):
                widx = torch.nonzero(walk).reshape(-1)
                _synced(stats)
                _, gs, begin, rem = self._slot_rows(slot_frame, slot_begin,
                                                    slot_rem)
                r_w = widx // V
                Lw = sw.slot_walk(cfg, c[widx], r_w // Q, r_w % Q,
                                  begin[r_w], qlens.to(torch.int64)[gs[r_w]],
                                  rem[r_w], base, hits0, stats)
                L[widx] = Lw
                gfin[widx] = c[widx].gather(1, Lw[:, None])[:, 0]

        def qtv(x):
            return x.reshape(T, Q, V).permute(1, 0, 2)

        return qtv(cfg.seed_length + L), qtv(gfin <= cfg.occ_cap)

    def _stage1_forced(self, keys, red_q, slot_frame, slot_begin, f_len,
                       f_keep, bucket=None, stats=None):
        """Stream pass B stage 1 (delta <= 1): each cursor's DECIDED string
        (variant + accepted elongation characters) searched at its decided
        length in the shard -- no walk.  Emits stage 1's cursor dict."""
        cfg = self.cfg
        dev = keys.device
        k, V, E = cfg.seed_length, self.V, self.E
        Q, T = slot_frame.shape
        red_q = red_q.to(torch.int64)
        g, gs, begin, _ = self._slot_rows(slot_frame, slot_begin, slot_begin)
        fl = f_len.permute(1, 0, 2).reshape(-1).to(torch.int64) \
            .clamp(k, cfg.capacity)
        fk = f_keep.permute(1, 0, 2).reshape(-1)
        ar = torch.arange(E, device=dev)
        last = red_q.shape[1] - 1

        def make(a, b):
            chars, _, valid = self._variant_chars(red_q, gs[a:b], begin[a:b])
            if E > 0:
                epos = (begin[a:b, None] + k + ar[None, :]).clamp(0, last)
                ech = red_q[gs[a:b, None], epos]
                chars = torch.cat([chars, ech[:, None, :].expand(-1, V, E)],
                                  dim=2)
            lens = fl[a * V:b * V].reshape(b - a, V)
            return (*self._pack(chars, lens),
                    valid & (g[a:b] >= 0)[:, None]
                    & fk[a * V:b * V].reshape(b - a, V))

        lo, count = self._batched_search(keys, g.shape[0], make, bucket,
                                         stats)
        QV = Q * V
        cur = self._cursor_dict(lo.reshape(T, QV), count.reshape(T, QV),
                                fl.reshape(T, QV), torch.zeros_like(lo)
                                .reshape(T, QV), gs, begin, Q, T)
        cur["ext_over"] = torch.zeros((), dtype=torch.int64, device=dev)
        return cur

    def forced_pass(self, keys, red_q, qlens, slot_frame, slot_begin,
                    slot_rem, hits0, kmer_pos, kmer_frame, sbj_offsets,
                    sbj_lens, trans_sbj, trans_q, red_sbj, subst_fwd,
                    subst_rev, f_len, f_keep, bucket=None, stats=None):
        """Stream pass B (delta <= 1): forced stage 1 -> compaction ->
        locate + prescore (stage 2 takes no decision in this mode)."""
        cur = self._stage1_forced(keys, red_q, slot_frame, slot_begin,
                                  f_len, f_keep, bucket, stats)
        return self._finish(cur, kmer_pos, kmer_frame, sbj_offsets,
                            sbj_lens, trans_sbj, trans_q, qlens, red_q,
                            red_sbj, subst_fwd, subst_rev,
                            (slot_frame, slot_begin, slot_rem), hits0,
                            stats=stats)

    def pigeon_count_pass(self, keys, red_q, qlens, slot_frame, slot_begin,
                          slot_rem, hits0, kmer_pos, kmer_frame,
                          sbj_offsets, sbj_lens, trans_sbj, trans_q,
                          red_sbj, subst_fwd, subst_rev, bucket=None,
                          stats=None):
        """Stream pass A (delta >= 2): stage 1 + locate + verification,
        emitting the shard-LOCAL per-slot verified-count matrix
        (Q*T, E+1)."""
        cur = self.stage1(keys, red_q, qlens, slot_frame, slot_begin,
                          slot_rem, hits0, bucket, stats)
        return self._finish(cur, kmer_pos, kmer_frame, sbj_offsets,
                            sbj_lens, trans_sbj, trans_q, qlens, red_q,
                            red_sbj, subst_fwd, subst_rev,
                            (slot_frame, slot_begin, slot_rem), hits0,
                            emit_cnt=True, stats=stats)

    def pigeon_forced_pass(self, keys, red_q, qlens, slot_frame, slot_begin,
                           slot_rem, hits0, kmer_pos, kmer_frame,
                           sbj_offsets, sbj_lens, trans_sbj, trans_q,
                           red_sbj, subst_fwd, subst_rev, keep_dense,
                           L_dense, bucket=None, stats=None):
        """Stream pass B (delta >= 2): the fused program with the global
        decisions in place of the local ones."""
        cur = self.stage1(keys, red_q, qlens, slot_frame, slot_begin,
                          slot_rem, hits0, bucket, stats)
        return self._finish(cur, kmer_pos, kmer_frame, sbj_offsets,
                            sbj_lens, trans_sbj, trans_q, qlens, red_q,
                            red_sbj, subst_fwd, subst_rev,
                            (slot_frame, slot_begin, slot_rem), hits0,
                            forced=(keep_dense, L_dense), stats=stats)


def make_seeder(cfg: SeedConfig) -> Seeder:
    return Seeder(cfg)


def make_stream_seeder(cfg: SeedConfig) -> dict:
    """Database-streaming seeder: the seeding of ONE query batch over N
    host-resident database shards streamed one after another through a
    single device, with outputs byte-identical to one resident index.

    Every decision a single index takes on its counts -- adaptive
    elongation accept/revert, the desiredOccs/hitsThisSeq feedback, the
    abundance cutoff (search_algo.hpp:679-729) -- consumes only per-shard
    count SUMS, so: pass A per shard computes the local counts (curves for
    delta <= 1, verified per-slot counts for pigeonhole), the caller
    accumulates them on the device, ``decide`` replays the decisions once
    on the sums, and pass B per shard locates and prescores with the
    decisions FORCED.

    Returns dict with keys pigeon (bool), pass_a, decide, pass_b, with
    the signatures of the JAX package's passes.  The pipeline runs them
    in SearchContext._stream_seed_call."""
    return stream_passes(Seeder(cfg))


def stream_passes(s: Seeder) -> dict:
    """The pass A / decide / pass B methods of seeder ``s`` (see
    :func:`make_stream_seeder`); the device mesh runs them per cell."""
    if s.pigeon:
        return dict(pigeon=True, pass_a=s.pigeon_count_pass,
                    decide=s.pigeon_decide, pass_b=s.pigeon_forced_pass)
    return dict(pigeon=False, pass_a=s.curve_pass, decide=s.curve_decide,
                pass_b=s.forced_pass)
