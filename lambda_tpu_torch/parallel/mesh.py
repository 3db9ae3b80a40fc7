"""Database shards of a loaded index: the host half of the JAX package's
``lambda_tpu/parallel/mesh.py``.

Every shard holds the sorted k-mer rows of a contiguous range of
subjects (never splitting a subject, which keeps frame-id parity -- the
bisulfite fwd/rev matrix selector -- intact), with LOCAL positions and
frame ids; the caller adds ``base`` back.  The shards are stacked on a
leading axis and padded to equal row counts: padded key rows hold
0xFFFFFFFF in every word, above every real key (the port's int64 keys
hold the same uint32 values), so no search ever lands in them.
``--db-stream N`` (search/pipeline.py) uploads one shard at a time.

The device mesh (``make_sharded_seeder``, ``make_sharded_band_scorer``,
``make_sharded_search_step``: ``--db-shards``/``--q-shards`` over several
cards) is not ported yet; it will run on ``torch.distributed``.
"""

from __future__ import annotations

import numpy as np

from ..index.build import KmerIndex


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
