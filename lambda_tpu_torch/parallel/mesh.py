"""Database shards and the (q, db) device grid: the port of the JAX
package's ``lambda_tpu/parallel/mesh.py``.

Host half.  Every shard holds the sorted k-mer rows of a contiguous range
of subjects (never splitting a subject, which keeps frame-id parity --
the bisulfite fwd/rev matrix selector -- intact), with LOCAL positions
and frame ids; the caller adds ``base`` back.  The shards are stacked on
a leading axis and padded to equal row counts: padded key rows hold
0xFFFFFFFF in every word, above every real key (the port's int64 keys
hold the same uint32 values), so no search ever lands in them.
``--db-stream N`` (search/pipeline.py) uploads one shard at a time.

Device half.  The JAX mesh is single-controller: one process holds a
``q_shards x db_shards`` Mesh, ``shard_map`` runs each cell's program,
and ``psum`` over 'db' takes every adaptive decision on global counts.
The port keeps that shape.  :class:`Mesh` is a grid of torch devices,
cell (i, j) at index ``i * db_shards + j``; one card may hold several
cells, and a db shard's tensors go onto each distinct device once
(``Mesh.put_db``, the counterpart of ``P('db', ...)``).  The cells run one
after another in the one process:

* :func:`make_sharded_seeder`: the seeder's stream passes per cell
  (search/seeding.py:stream_passes) -- pass A on each cell of a q row,
  the sum of its counts onto the row's first device (``Mesh.reduce_db``,
  the psum), one decide there, pass B per cell with the decisions forced;
* :func:`make_sharded_search_step`: the fused demo step (fixed seeds,
  locate, windowed SW with K4, top-k merged over each q row).

Pass 1 over the grid is search/extend.py's one launch loop with one part
per cell (``SearchContext._sharded_scores``): the cell's q block and its
LOCAL subject shard.

``--distributed`` (search/pipeline.py:run_search) joins processes into a
``torch.distributed`` group; the search itself uses no collective.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .. import frames as fr
from ..index.build import KmerIndex, build_kmer_index
from ..ops import kmer as kmer_ops, searchsorted as ss, sw_band, sw_rect
from ..search import seeding
from ..stats import card_clock, timed


def shard_index(red_frames: list[np.ndarray], alphabet_size: int,
                n_shards: int, words: int = 4):
    """Split frames into ``n_shards`` contiguous groups and build one
    k-mer index per shard.  Returns per-shard (KmerIndex, frame_base,
    local_offsets)."""
    groups = np.array_split(np.arange(len(red_frames)), n_shards)
    shards = []
    for g in groups:
        concat, offsets, _ = fr.concat_frames([red_frames[i] for i in g])
        idx = build_kmer_index(concat, offsets, alphabet_size, words=words)
        shards.append((idx, int(g[0]) if len(g) else 0, offsets))
    return shards


def stack_shards(shards):
    """Pad each shard's arrays to the max row count and stack them into
    (n_shards, ...) arrays; padded key rows are all-0xFF and lie beyond
    each shard's ``rows``.  Frame ids become global."""
    n = len(shards)
    pmax = max(s[0].num_positions for s in shards)
    words = shards[0][0].words
    keys = np.full((n, pmax, words), 0xFFFFFFFF, dtype=np.uint32)
    pos = np.zeros((n, pmax), dtype=np.int32)
    frame = np.zeros((n, pmax), dtype=np.int32)
    rows = np.zeros((n,), dtype=np.int32)
    for i, (idx, fb, _loc_offs) in enumerate(shards):
        p = idx.num_positions
        keys[i, :p] = idx.keys
        pos[i, :p] = idx.pos.astype(np.int32)
        frame[i, :p] = idx.frame.astype(np.int32) + fb
        rows[i] = p
    return dict(keys=keys, pos=pos, frame=frame, rows=rows)


def shard_loaded_index(kmer: KmerIndex, trans_concat: np.ndarray,
                       red_concat: np.ndarray, offsets: np.ndarray,
                       lengths: np.ndarray, n_shards: int,
                       frames_per_subject: int = 1):
    """Derive per-shard index slices from an already-sorted k-mer index.

    Subjects (groups of ``frames_per_subject`` consecutive frames) are
    split contiguously over shards.  Because the global rows are sorted
    and a stable filter preserves order, each shard's rows are simply the
    global rows whose frame falls in its range: no re-sort, no re-pack.

    Returns stacked, padded arrays on a leading shard axis; frame ids and
    concat positions are LOCAL to the shard (host adds ``base`` back).
    """
    fps = max(1, frames_per_subject)
    F = len(offsets) - 1
    n_subj = F // fps
    groups = np.array_split(np.arange(n_subj), n_shards)
    frame_global = kmer.frame.astype(np.int64)
    per = []
    prev_hi = 0
    for g in groups:
        # empty shards inherit the running boundary so the per-shard
        # frame bases stay MONOTONE
        f_lo = int(g[0]) * fps if len(g) else prev_hi
        f_hi = (int(g[-1]) + 1) * fps if len(g) else prev_hi
        prev_hi = f_hi
        mask = (frame_global >= f_lo) & (frame_global < f_hi)
        p_lo = int(offsets[f_lo]) if f_hi > f_lo else 0
        p_hi = int(offsets[f_hi]) if f_hi > f_lo else 0
        per.append(dict(
            keys=kmer.keys[mask],
            pos=(kmer.pos[mask].astype(np.int64) - p_lo).astype(np.int32),
            frame=(frame_global[mask] - f_lo).astype(np.int32),
            offsets=(offsets[f_lo:f_hi] - p_lo).astype(np.int32)
                if f_hi > f_lo else np.zeros(0, np.int32),
            lengths=lengths[f_lo:f_hi].astype(np.int32),
            trans=trans_concat[p_lo:p_hi].astype(np.int8),
            red=red_concat[p_lo:p_hi].astype(np.int8),
            base=f_lo,
        ))

    return _stack_shard_dicts(per, kmer.words)


def shard_prebuilt_index(idx, red_concat: np.ndarray):
    """Stack the per-shard arrays of a SHARDED ARTIFACT (mkindex
    --shards; index/artifact.py): the shards were built per subject
    range, so no global filter/re-sort is needed and the host never
    materializes the merged key array."""
    fb = idx.shard_frame_bounds()
    offsets = idx.trans_offsets
    lengths = idx.trans_lengths
    per = []
    for k, sh in enumerate(idx.kmer_shards):
        f_lo, f_hi = int(fb[k]), int(fb[k + 1])
        p_lo = int(offsets[f_lo]) if f_hi > f_lo else 0
        p_hi = int(offsets[f_hi]) if f_hi > f_lo else 0
        per.append(dict(
            keys=sh.keys,
            pos=sh.pos.astype(np.int32),
            frame=sh.frame.astype(np.int32),
            offsets=(offsets[f_lo:f_hi] - p_lo).astype(np.int32)
                if f_hi > f_lo else np.zeros(0, np.int32),
            lengths=lengths[f_lo:f_hi].astype(np.int32),
            trans=idx.trans_concat[p_lo:p_hi].astype(np.int8),
            red=red_concat[p_lo:p_hi].astype(np.int8),
            base=f_lo,
        ))
    return _stack_shard_dicts(per, idx.kmer_meta.words)


def _stack_shard_dicts(per, words):
    D = len(per)
    pmax = max(max(len(p["pos"]) for p in per), 1)
    fmax = max(max(len(p["offsets"]) for p in per), 1)
    smax = max(max(len(p["trans"]) for p in per), 1)
    out = dict(
        keys=np.full((D, pmax, words), 0xFFFFFFFF, dtype=np.uint32),
        pos=np.zeros((D, pmax), dtype=np.int32),
        frame=np.zeros((D, pmax), dtype=np.int32),      # LOCAL frame ids
        offsets=np.zeros((D, fmax), dtype=np.int32),
        lengths=np.zeros((D, fmax), dtype=np.int32),
        trans=np.zeros((D, smax), dtype=np.int8),
        red=np.zeros((D, smax), dtype=np.int8),
        base=np.zeros((D,), dtype=np.int32),
    )
    for i, p in enumerate(per):
        n = len(p["pos"])
        out["keys"][i, :n] = p["keys"]
        out["pos"][i, :n] = p["pos"]
        out["frame"][i, :n] = p["frame"]
        out["offsets"][i, :len(p["offsets"])] = p["offsets"]
        out["lengths"][i, :len(p["lengths"])] = p["lengths"]
        out["trans"][i, :len(p["trans"])] = p["trans"]
        out["red"][i, :len(p["red"])] = p["red"]
        out["base"][i] = p["base"]
    return out


# ---------------------------------------------------------------------------
# The device half: a (q, db) grid of torch devices and the programs that
# run per cell.
# ---------------------------------------------------------------------------


def _tensor_on(x, dev: torch.device, dtype=None) -> torch.Tensor:
    """``x`` (numpy or torch) as a tensor on ``dev``.  uint32 numpy arrays
    (index keys) travel as their int32 bit pattern and are widened on the
    device to int64 holding the uint32 values."""
    if isinstance(x, (np.ndarray, np.generic)):
        x = np.ascontiguousarray(x)
        if x.dtype == np.uint32:
            t = torch.from_numpy(x.view(np.int32)).to(dev).to(torch.int64)
            return t.bitwise_and_(0xFFFFFFFF)
        x = torch.from_numpy(x)
    return x.to(dev, dtype=dtype) if dtype is not None else x.to(dev)


# the most bytes of one part that Mesh.reduce_db moves between devices at
# once
REDUCE_SLICE_BYTES = 256 << 20


class Mesh:
    """A (q_shards, db_shards) grid of torch devices, row-major: cell
    (i, j) is ``devices[i * db_shards + j]``.  Several cells may name one
    device.  The ``put_*`` methods place an array as one tensor per cell
    (a list in cell order), each on its cell's device and shared by the
    cells that name the same device and the same slice: the port's
    counterpart of ``jax.device_put`` with a ``NamedSharding``."""

    def __init__(self, devices, q_shards: int, db_shards: int):
        devs = []
        for d in devices:
            d = torch.device(d)
            if d.type == "cuda" and d.index is None:
                d = torch.device("cuda", torch.cuda.current_device())
            devs.append(d)
        if len(devs) != q_shards * db_shards:
            raise ValueError(f"a {q_shards} x {db_shards} mesh needs "
                             f"{q_shards * db_shards} devices, got "
                             f"{len(devs)}")
        self.shape = (q_shards, db_shards)
        self.devices = devs

    def row(self, i: int) -> range:
        """The cells of q row ``i``: the db group its psum runs over."""
        D = self.shape[1]
        return range(i * D, (i + 1) * D)

    def reduce_db(self, parts: list) -> torch.Tensor:
        """The psum over 'db': the sum of one q row's cell tensors, on the
        row's first device.  The caller hands the parts over: the sum is
        taken in place in ``parts[0]`` and ``parts`` is emptied as it
        goes.  Each other part crosses to that device in slices of at most
        ``REDUCE_SLICE_BYTES`` along its outermost dimension and is released
        once added, so the first device holds the sum and one slice, not
        every cell's part at once (the seeding curves are the size of the
        batch's slots times variants times elongations)."""
        out = parts.pop(0)
        outer = max(range(out.dim()), key=out.stride, default=None)
        while parts:
            p = parts.pop(0)
            if outer is None:
                out += p.to(out.device)
                continue
            n = out.shape[outer]
            row = max(1, out.numel() // max(n, 1) * out.element_size())
            step = max(1, REDUCE_SLICE_BYTES // row)
            for a in range(0, n, step):
                k = min(step, n - a)
                out.narrow(outer, a, k).add_(
                    p.narrow(outer, a, k).to(out.device))
            del p
        return out

    def _place(self, part_of, value_of) -> list:
        placed: dict = {}
        out = []
        for c, dev in enumerate(self.devices):
            key = (part_of(c), str(dev))
            if key not in placed:
                placed[key] = value_of(c, dev)
            out.append(placed[key])
        return out

    def put_db(self, x, dtype=None) -> list:
        """``x`` (db_shards, ...): cell (i, j) gets ``x[j]`` (P('db'))."""
        D = self.shape[1]
        return self._place(lambda c: c % D,
                           lambda c, dev: _tensor_on(x[c % D], dev, dtype))

    def put_q(self, x, dtype=None) -> list:
        """``x`` (q_shards * b, ...): cell (i, j) gets block i of b rows
        (P('q'))."""
        D = self.shape[1]
        b = x.shape[0] // self.shape[0]
        return self._place(lambda c: c // D, lambda c, dev: _tensor_on(
            x[(c // D) * b:(c // D + 1) * b], dev, dtype))

    def put_all(self, x, dtype=None) -> list:
        """``x`` replicated on every cell (P(None))."""
        return self._place(lambda c: 0,
                           lambda c, dev: _tensor_on(x, dev, dtype))


@dataclasses.dataclass(frozen=True)
class StepConfig:
    """Static configuration of the fused sharded search step."""

    seed_length: int = 11
    seed_offset: int = 3
    alphabet_size: int = 10
    bits: int = 4
    cpw: int = 8
    words: int = 4
    seeds_per_query: int = 16
    occ_cap: int = 8          # located hits kept per seed
    window: int = 64          # subject window of the windowed SW
    top_k: int = 8            # merged hits per query


def _ext8(subst: torch.Tensor) -> torch.Tensor:
    """An extend_matrix (int32, PAD row/column last) as K4's int8 matrix:
    ``sw_band.ext8_from_ext32`` on the device."""
    e8 = subst.clamp(-127, 127).to(torch.int8)
    e8[-1, :] = sw_band.PAD_SCORE8
    e8[:, -1] = sw_band.PAD_SCORE8
    return e8.contiguous()


def make_sharded_search_step(mesh: Mesh, cfg: StepConfig):
    """The fused demo search step over the (q, db) grid.

    Inputs, per cell (``Mesh.put_*``; global shapes as the JAX step's):
      red_q, trans_q: (Q, L) int32 queries       -> put_q
      keys: (D, Pmax, W) uint32; pos: (D, Pmax); rows: (D,)  -> put_db
      sbj: (D, S) subject concat; sbj_len: (D,)  -> put_db
      subst: (A+1, A+1) int32 extend_matrix       -> put_all
    Per cell: seeds every seed_offset positions, located occurrences (at
    most occ_cap per seed), the best local score of each query against a
    subject window around each hit with K4 (``sw_rect.sw_score_device``:
    the function of the JAX step's ``sw_xla.sw_score_batch``; K4 takes the
    matrix as int8 with PAD -128, which like PAD -2^20 raises no local
    maximum), and the query's local top-k.  The local tops of a q row are
    concatenated on its first device and cut to the top-k again (the
    JAX step's all_gather + top_k).  Returns (merged (Q, top_k), db_total
    (Q, 1)), both int32 on the first cell's device; db_total is the sum of
    the shards' subject lengths.  (The JAX step also takes Pmax, which
    bounds its bisection; the port's search bisects each range until it
    is empty.)"""
    k = cfg.seed_length
    Qm, Dm = mesh.shape

    def local(red_q, trans_q, keys, pos, rows, sbj, sbj_len, e8):
        dev = red_q.device
        Qs, L = red_q.shape
        T = cfg.seeds_per_query
        starts = torch.arange(T, device=dev) * cfg.seed_offset
        idx2 = (starts[:, None] + torch.arange(k, device=dev)[None, :]) \
            .clamp(0, L - 1)
        chars = red_q.to(torch.int64)[:, idx2]                # (Qs, T, k)
        lens = torch.full((Qs, T), k, dtype=torch.int64, device=dev)
        tgt = kmer_ops.pack_prefix(chars, lens, cfg.bits, cfg.cpw, cfg.words)
        msk = ss.length_masks(lens, cfg.bits, cfg.cpw, cfg.words)
        S = Qs * T
        lo, hi = ss.search_range(
            keys, tgt.reshape(S, cfg.words), msk.reshape(S, cfg.words),
            torch.zeros(S, dtype=torch.int64, device=dev),
            rows.to(torch.int64).reshape(1).expand(S))
        count = torch.clamp(hi - lo, max=cfg.occ_cap)
        occ = torch.arange(cfg.occ_cap, device=dev)
        rowsel = (lo[:, None] + occ[None, :]).clamp(0, keys.shape[0] - 1)
        hit_valid = occ[None, :] < count[:, None]
        hit_pos = pos[rowsel].to(torch.int64)                 # (S, occ)
        sstart = torch.clamp(hit_pos - starts.repeat(Qs)[:, None] - 8, min=0)
        W = cfg.window
        widx = sstart[:, :, None] + torch.arange(W, device=dev)
        swin = sbj[widx.clamp(0, sbj.shape[0] - 1)].to(torch.int64)
        pad = e8.shape[0] - 1
        swin = torch.where(widx < sbj_len.to(torch.int64), swin, pad)
        qi = torch.arange(S, device=dev) // T
        B = S * cfg.occ_cap
        qwin = trans_q[qi].repeat_interleave(cfg.occ_cap, dim=0)
        scores = sw_rect.sw_score_device(
            qwin.to(torch.int8).contiguous(),
            swin.reshape(B, W).to(torch.int8).contiguous(), e8, -12, -1)
        scores = torch.where(hit_valid.reshape(B), scores, 0)
        return torch.topk(scores.reshape(Qs, T * cfg.occ_cap), cfg.top_k,
                          dim=1).values

    def step(red_q, trans_q, keys, pos, rows, sbj, sbj_len, subst):
        e8 = {}
        merged, totals = [], []
        for i in range(Qm):
            tops = []
            for c in mesh.row(i):
                key = str(subst[c].device)
                if key not in e8:
                    e8[key] = _ext8(subst[c])
                tops.append(local(red_q[c], trans_q[c], keys[c], pos[c],
                                  rows[c], sbj[c], sbj_len[c], e8[key]))
            c0 = mesh.row(i)[0]
            gathered = torch.cat([t.to(tops[0].device) for t in tops], dim=1)
            merged.append(torch.topk(gathered, cfg.top_k, dim=1).values
                          .to(mesh.devices[0]))
            total = mesh.reduce_db([sbj_len[c].to(torch.int64, copy=True)
                                    .reshape(())
                                    for c in mesh.row(i)])
            totals.append(total.to(mesh.devices[0]).expand(
                red_q[c0].shape[0], 1))
        return (torch.cat(merged).to(torch.int32),
                torch.cat(totals).to(torch.int32))

    return step


def make_demo_inputs(cfg: StepConfig, n_q: int, q_len: int, db_seq_len: int,
                     n_db_frames: int, seed: int = 0):
    """Synthetic protein-like inputs of the demo step: (frames, red_q,
    trans_q, subst_ext), the JAX package's arrays for the same seed."""
    rng = np.random.default_rng(seed)
    A = cfg.alphabet_size
    frames = [rng.integers(0, A, size=db_seq_len).astype(np.uint8)
              for _ in range(n_db_frames)]
    red_q = rng.integers(0, A, size=(n_q, q_len)).astype(np.int32)
    # plant exact matches so the step finds real hits
    for i in range(min(n_q, n_db_frames)):
        f = frames[i % n_db_frames]
        off = rng.integers(0, max(1, len(f) - q_len))
        red_q[i, :] = f[off: off + q_len]
    trans_q = red_q.copy()
    subst = np.full((A, A), -2, dtype=np.int32)
    np.fill_diagonal(subst, 4)
    return frames, red_q, trans_q, sw_band.extend_matrix(subst)


def demo_subjects(shards, red_frames):
    """The per-shard subject concats of a demo (``shard_index`` result):
    (sbj (D, S) int32 zero-padded, sbj_len (D,) int32)."""
    smax = max(int(offs[-1]) for (_, _, offs) in shards)
    sbj = np.zeros((len(shards), max(smax, 1)), dtype=np.int32)
    sbj_len = np.zeros((len(shards),), dtype=np.int32)
    for i, (_, fb, offs) in enumerate(shards):
        n = int(offs[-1])
        if len(offs) > 1:
            sbj[i, :n] = np.concatenate(
                [red_frames[j] for j in range(fb, fb + len(offs) - 1)])
        sbj_len[i] = n
    return sbj, sbj_len


def make_sharded_seeder(mesh: Mesh, seeder: seeding.Seeder):
    """The seeding of one query batch over the (q, db) grid with the
    phase's seeder (``search/seeding.py:Seeder``): per q row, pass A of
    the stream passes on each cell (delta <= 1: count curves; pigeonhole:
    verified per-slot counts), their sum on the row's first device
    (``Mesh.reduce_db``: the JAX mesh's psum over 'db'), one decide there,
    and pass B per cell with the decisions forced.  Budgets are per cell,
    with the cell's q block of queries, as in the JAX mesh; the decide
    walks at most ``max_cursors`` globally live cursors per slot, as the
    JAX mesh compacts them before its walk, and the overflow of that
    budget folds into every cell's cursor-overflow stat.

    Returns ``step(keys, pos, frame, offsets, lengths, trans, red, red_q,
    qlens, slot_frame, slot_begin, slot_rem, hits0, trans_q, subst_fwd,
    subst_rev, bucket, stats=None, card_events=None)``: index and subject
    shards per cell from ``Mesh.put_db`` (keys int64, offsets and lengths
    int64; bucket may be None), query inputs from ``Mesh.put_q``, matrices
    from ``Mesh.put_all``.  It returns each cell's pass-B result (the fused
    seeder's dict: hit arrays, ``packed``, ``stats_vec``), a list in cell
    order.  ``stats``, a StatsHolder, records the passes' walk span and
    host syncs (see search/seeding.py) and the span ``time_mesh_reduce``;
    ``card_events``, a list, takes the CUDA events around each cell's
    passes (stats.card_clock).

    Id conventions (as the JAX package's): slot_frame holds BATCH-GLOBAL
    query-frame ids and is rebased to the cell's q block here, so emitted
    q_frame ids are block-local (the caller adds the block's first frame
    row); emitted s_frame ids are shard-LOCAL (the caller adds the
    shard's frame base)."""
    passes = seeding.stream_passes(seeder)
    cfg = seeder.cfg
    pigeon = passes["pigeon"]

    def step(keys, pos, frame, offsets, lengths, trans, red, red_q, qlens,
             slot_frame, slot_begin, slot_rem, hits0, trans_q, subst_fwd,
             subst_rev, bucket, stats=None, card_events=None):
        outs = []
        for i in range(mesh.shape[0]):
            cells = mesh.row(i)
            slots, index, bkt = {}, {}, {}
            for c in cells:
                q_base = i * red_q[c].shape[0]
                sf = torch.where(slot_frame[c] >= 0, slot_frame[c] - q_base,
                                 slot_frame[c])
                slots[c] = (red_q[c], qlens[c], sf, slot_begin[c],
                            slot_rem[c])
                index[c] = (pos[c], frame[c], offsets[c], lengths[c],
                            trans[c], trans_q[c], red[c], subst_fwd[c],
                            subst_rev[c])
                bkt[c] = bucket[c] if bucket is not None else None
            parts = []
            for c in cells:
                extra = (hits0[c], *index[c]) if pigeon else ()
                with card_clock(card_events, keys[c].device):
                    parts.append(passes["pass_a"](
                        keys[c], *slots[c], *extra, bkt[c], stats=stats))
            with timed(stats, "time_mesh_reduce"):
                acc = mesh.reduce_db(parts)
            del parts
            c0 = cells[0]
            ext_over = None
            if pigeon:
                L_d, keep_d = passes["decide"](acc, *slots[c0][1:],
                                               hits0[c0], stats=stats)
                forced = (keep_d, L_d)
            else:
                forced = passes["decide"](acc, *slots[c0][1:], hits0[c0],
                                          max_cursors=cfg.max_cursors,
                                          stats=stats)
                if seeder.E > 0:
                    ext_over = _ext_overflow(acc, cfg.max_cursors)
            del acc
            for c in cells:
                dev = keys[c].device
                with card_clock(card_events, dev):
                    res = passes["pass_b"](
                        keys[c], *slots[c], hits0[c], *index[c],
                        *(f.to(dev) for f in forced), bkt[c], stats=stats)
                if ext_over is not None:
                    eo = ext_over.to(dev)
                    res["stats"]["cursors_overflow"] = torch.maximum(
                        res["stats"]["cursors_overflow"], eo)
                    res["stats_vec"][3] = torch.maximum(
                        res["stats_vec"][3], eo.to(torch.int32))
                outs.append(res)
        return outs

    return step


def _ext_overflow(curves: torch.Tensor, max_cursors: int) -> torch.Tensor:
    """The elongation budget's overflow of the JAX mesh: the most globally
    live cursors of any slot beyond ``min(max_cursors, Q * V)``, from the
    summed curves (Q, T, V, E+1)."""
    Q, T, V, _ = curves.shape
    n_live = (curves[..., 0] > 0).sum(dim=(0, 2))               # (T,)
    return (n_live - min(max_cursors, Q * V)).clamp(min=0).max()
