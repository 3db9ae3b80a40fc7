"""ctypes loader for the port's host C++ helpers (csrc/host/lambda_native.cpp).

The helpers are the host side of the search: the pass-2 SW traceback with
inline alignment statistics, the widen/merge passes, the index build's
parallel key packing, sort and gathers, parallel gzip for ``.gz``
outputs, and the BGZF blocks of BAM output.  The library is compiled
with g++ on first use into ``build/lambda_tpu_torch/`` at the repository
root, keyed by a hash of the source and the host ISA.  It is required: a failed build raises, and no
entry point falls back to Python loops.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
from pathlib import Path

import numpy as np

_PKG = Path(__file__).resolve().parent
_SRC = _PKG / "csrc" / "host" / "lambda_native.cpp"
BUILD_DIR = _PKG.parent / "build" / "lambda_tpu_torch"
_lib = None


def _isa_tag() -> str:
    """Cache key component for -march=native builds: a build directory
    shared between hosts must not serve ISA-incompatible binaries."""
    import platform

    key = platform.machine()
    try:
        with open("/proc/cpuinfo") as fh:
            for line in fh:
                if line.startswith(("flags", "Features")):
                    key += line
                    break
    except OSError:
        pass
    return hashlib.sha256(key.encode()).hexdigest()[:8]


def _build() -> Path:
    tag = hashlib.sha256(_SRC.read_bytes()).hexdigest()[:16]
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    so = BUILD_DIR / f"liblambda_native-{tag}-{_isa_tag()}.so"
    if so.exists():
        return so
    # per-PID temp: concurrent cold builds must not interleave
    tmp = so.with_suffix(f".so.tmp.{os.getpid()}")
    cmd = ["g++", "-O3", "-fPIC", "-shared", "-fopenmp", "-march=native",
           str(_SRC), "-o", str(tmp), "-lz"]
    r = subprocess.run(cmd, capture_output=True, text=True, timeout=300)
    if r.returncode != 0:
        raise RuntimeError(f"building {_SRC.name} failed:\n{r.stderr}")
    os.replace(tmp, so)
    return so


def get_lib():
    """The loaded ctypes library; builds it on first use (raises if the
    build or the load fails)."""
    global _lib
    if _lib is not None:
        return _lib
    lib = ctypes.CDLL(str(_build()))
    i32p = ctypes.POINTER(ctypes.c_int32)
    u8p = ctypes.POINTER(ctypes.c_uint8)
    lib.sw_traceback_stats_batch.argtypes = [
        i32p, ctypes.c_int32, i32p,          # q, q_stride, qlen
        i32p, ctypes.c_int32, i32p,          # s, s_stride, slen
        ctypes.c_int32,                      # B
        i32p, ctypes.c_int32,                # subst, alph
        i32p, u8p,                           # subst_rev, use_rev
        i32p,                                # band
        ctypes.c_int32, ctypes.c_int32,      # gap_first, gap_extend
        ctypes.c_int32,                      # bs_mode
        i32p, i32p, i32p, i32p, i32p,        # score, q0, s0, qe, se
        u8p, ctypes.c_int32, i32p,           # ops, ops_stride, ops_len
        i32p,                                # stats (B, 8)
    ]
    lib.sw_traceback_stats_batch.restype = None
    lib.bgzf_compress_block.argtypes = [u8p, ctypes.c_int32, ctypes.c_int32,
                                        u8p, ctypes.c_int32]
    lib.bgzf_compress_block.restype = ctypes.c_int32
    lib.gzip_compress_parallel.argtypes = [
        u8p, ctypes.c_int64, ctypes.c_int32, ctypes.c_int32,
        u8p, ctypes.c_int64]
    lib.gzip_compress_parallel.restype = ctypes.c_int64
    i64p = ctypes.POINTER(ctypes.c_int64)
    lib.merge_passes.argtypes = [i64p] * 8 + [u8p, ctypes.c_int64]
    lib.merge_passes.restype = None
    u32p = ctypes.POINTER(ctypes.c_uint32)
    lib.sort_rows_u32.argtypes = [u32p, ctypes.c_int64, ctypes.c_int32, i64p]
    lib.sort_rows_u32.restype = None
    lib.take_rows_u32.argtypes = [u32p, ctypes.c_int64, ctypes.c_int32,
                                  i64p, u32p]
    lib.take_rows_u32.restype = None
    lib.take_frame_of_pos.argtypes = [i64p, ctypes.c_int64, i64p,
                                      ctypes.c_int64, u32p]
    lib.take_frame_of_pos.restype = None
    lib.pack_position_keys.argtypes = [u8p, ctypes.c_int64, i64p,
                                       ctypes.c_int64, ctypes.c_int32,
                                       ctypes.c_int32, u32p]
    lib.pack_position_keys.restype = None
    _lib = lib
    return _lib


def _ptr(a: np.ndarray, typ):
    return a.ctypes.data_as(typ)


def rle_ops(raw: np.ndarray) -> list[tuple[str, int]]:
    """Run-length encode a 1-D uint8 op-byte array (vectorized)."""
    if len(raw) == 0:
        return []
    cut = np.flatnonzero(np.diff(raw)) + 1
    starts = np.concatenate(([0], cut))
    ends = np.concatenate((cut, [len(raw)]))
    return [(chr(raw[st]), int(en - st)) for st, en in zip(starts, ends)]


def sw_traceback_stats_batch(q_list, s_list, subst: np.ndarray,
                             gap_first: int, gap_extend: int,
                             subst_rev: np.ndarray | None = None,
                             use_rev: np.ndarray | None = None,
                             band: np.ndarray | None = None,
                             bs_mode: bool = False):
    """Batched local SW with traceback AND inline alignment statistics on
    the host (pass 2 of the extension; search_algo.hpp:1302-1325).

    q_list/s_list: 1-D rank arrays; band: per-row diagonal band sizes
    (None = full rectangle).  Returns (scores, traces, stats): traces[i] =
    (q0, s0, [(op, run), ...]) or None for score-0 rows, and
    stats the (B, 8) int32 array [align_length, matches, mismatches,
    positives, gap_opens, gaps, insertions, deletions]."""
    lib = get_lib()
    B = len(q_list)
    i32p = ctypes.POINTER(ctypes.c_int32)
    u8p = ctypes.POINTER(ctypes.c_uint8)
    qs = max((len(x) for x in q_list), default=1) or 1
    ss = max((len(x) for x in s_list), default=1) or 1
    q = np.zeros((B, qs), dtype=np.int32)
    s = np.zeros((B, ss), dtype=np.int32)
    qlen = np.zeros(B, dtype=np.int32)
    slen = np.zeros(B, dtype=np.int32)
    for i, (qq, sq) in enumerate(zip(q_list, s_list)):
        q[i, :len(qq)] = qq
        s[i, :len(sq)] = sq
        qlen[i] = len(qq)
        slen[i] = len(sq)
    sub = np.ascontiguousarray(subst, dtype=np.int32)
    sub_rev = (np.ascontiguousarray(subst_rev, dtype=np.int32)
               if subst_rev is not None else None)
    urev = (np.ascontiguousarray(use_rev, dtype=np.uint8)
            if use_rev is not None else None)
    band = (np.ascontiguousarray(band, dtype=np.int32)
            if band is not None else None)

    score = np.zeros(B, dtype=np.int32)
    q0 = np.zeros(B, dtype=np.int32)
    s0 = np.zeros(B, dtype=np.int32)
    qe = np.zeros(B, dtype=np.int32)
    se = np.zeros(B, dtype=np.int32)
    ops_stride = qs + ss + 2
    ops = np.zeros((B, ops_stride), dtype=np.uint8)
    ops_len = np.zeros(B, dtype=np.int32)
    stats = np.zeros((B, 8), dtype=np.int32)
    lib.sw_traceback_stats_batch(
        _ptr(q, i32p), qs, _ptr(qlen, i32p),
        _ptr(s, i32p), ss, _ptr(slen, i32p),
        B, _ptr(sub, i32p), sub.shape[0],
        _ptr(sub_rev, i32p) if sub_rev is not None else None,
        _ptr(urev, u8p) if urev is not None else None,
        _ptr(band, i32p) if band is not None else None,
        int(gap_first), int(gap_extend), int(bool(bs_mode)),
        _ptr(score, i32p), _ptr(q0, i32p), _ptr(s0, i32p),
        _ptr(qe, i32p), _ptr(se, i32p),
        _ptr(ops, u8p), ops_stride, _ptr(ops_len, i32p),
        _ptr(stats, i32p))

    traces = [None if score[b] <= 0 else
              (int(q0[b]), int(s0[b]), rle_ops(ops[b, :ops_len[b]]))
              for b in range(B)]
    return score.astype(np.int64), traces, stats


def gzip_compress(data: bytes, level: int = 6,
                  chunk: int = 1 << 20) -> bytes:
    """One complete gzip member, chunks deflated in parallel (OpenMP;
    pigz-style independent chunks).  Output is deterministic for a fixed
    chunk size regardless of thread count."""
    lib = get_lib()
    src = (np.frombuffer(data, dtype=np.uint8) if len(data)
           else np.zeros(1, dtype=np.uint8))
    out = np.zeros(len(data) + len(data) // 2 + 4096, dtype=np.uint8)
    u8p = ctypes.POINTER(ctypes.c_uint8)
    n = lib.gzip_compress_parallel(
        _ptr(src, u8p), len(data), chunk, level, _ptr(out, u8p), len(out))
    if n < 0:
        raise RuntimeError("gzip_compress_parallel failed")
    return out[:n].tobytes()


def bgzf_compress_block(data: bytes, level: int = 6) -> bytes:
    """``data`` (at most 65,535 bytes) as one complete BGZF block: the
    gzip member with the BC extra field that BAM files are made of."""
    lib = get_lib()
    src = np.frombuffer(data, dtype=np.uint8)
    out = np.zeros(len(data) + 4096, dtype=np.uint8)
    u8p = ctypes.POINTER(ctypes.c_uint8)
    n = lib.bgzf_compress_block(_ptr(src, u8p), len(data), level,
                                _ptr(out, u8p), len(out))
    if n < 0:
        raise RuntimeError("bgzf_compress_block failed")
    return out[:n].tobytes()


def merge_passes(qid, sid, qs, qe, ss, se, dlo, dhi):
    """In-place widen/merge passes over pre-sorted match rows (exact
    replication of search_algo.hpp:1148-1169), unioning the diagonal
    extension bands (dlo/dhi) of merged rows.  Arrays must be
    contiguous int64; returns the unique-keep mask."""
    lib = get_lib()
    n = len(qid)
    keep = np.zeros(n, dtype=np.uint8)
    i64p = ctypes.POINTER(ctypes.c_int64)
    u8p = ctypes.POINTER(ctypes.c_uint8)
    lib.merge_passes(*(a.ctypes.data_as(i64p)
                       for a in (qid, sid, qs, qe, ss, se, dlo, dhi)),
                     keep.ctypes.data_as(u8p), n)
    return keep.astype(bool)


def sort_rows_u32(keys: np.ndarray) -> np.ndarray:
    """Stable lexicographic argsort of (P, words<=4) uint32 key rows
    (parallel; np.lexsort equivalent)."""
    if keys.shape[1] > 4:
        raise ValueError("sort_rows_u32 takes at most 4 key words")
    lib = get_lib()
    keys = np.ascontiguousarray(keys, dtype=np.uint32)
    P = keys.shape[0]
    order = np.zeros(P, dtype=np.int64)
    u32p = ctypes.POINTER(ctypes.c_uint32)
    i64p = ctypes.POINTER(ctypes.c_int64)
    lib.sort_rows_u32(keys.ctypes.data_as(u32p), P, keys.shape[1],
                      order.ctypes.data_as(i64p))
    return order


def take_rows_u32(src: np.ndarray, order: np.ndarray) -> np.ndarray:
    """Parallel ``src[order]`` for (P, words) uint32 rows.  Raises
    IndexError on out-of-range rows (negative indices are NOT
    supported)."""
    lib = get_lib()
    src = np.ascontiguousarray(src, dtype=np.uint32)
    order = np.ascontiguousarray(order, dtype=np.int64)
    n, words = len(order), src.shape[1]
    if n and (order.min() < 0 or order.max() >= src.shape[0]):
        raise IndexError("take_rows_u32: order out of range")
    dst = np.empty((n, words), dtype=np.uint32)
    u32p = ctypes.POINTER(ctypes.c_uint32)
    i64p = ctypes.POINTER(ctypes.c_int64)
    lib.take_rows_u32(src.ctypes.data_as(u32p), n, words,
                      order.ctypes.data_as(i64p),
                      dst.ctypes.data_as(u32p))
    return dst


def take_frame_of_pos(offsets: np.ndarray, order: np.ndarray) -> np.ndarray:
    """Parallel ``frame_of_pos[order]`` without materializing the O(P)
    ``np.repeat`` expansion: per-row binary search over the frame
    offsets.  Raises IndexError on positions outside
    [offsets[0], offsets[-1])."""
    lib = get_lib()
    offsets = np.ascontiguousarray(offsets, dtype=np.int64)
    order = np.ascontiguousarray(order, dtype=np.int64)
    P = len(order)
    if P and (order.min() < offsets[0] or order.max() >= offsets[-1]):
        raise IndexError("take_frame_of_pos: position out of range")
    out = np.empty(P, dtype=np.uint32)
    u32p = ctypes.POINTER(ctypes.c_uint32)
    i64p = ctypes.POINTER(ctypes.c_int64)
    lib.take_frame_of_pos(offsets.ctypes.data_as(i64p), len(offsets) - 1,
                          order.ctypes.data_as(i64p), P,
                          out.ctypes.data_as(u32p))
    return out


def pack_position_keys(concat: np.ndarray, offsets: np.ndarray,
                       bits: int, words: int) -> np.ndarray:
    """Parallel key packing for the k-mer index: for every position, the
    next characters of its frame as (rank+1) packed MSB-first into
    ``words`` uint32 words, 0 past the frame end."""
    lib = get_lib()
    concat = np.ascontiguousarray(concat, dtype=np.uint8)
    offsets = np.ascontiguousarray(offsets, dtype=np.int64)
    P = len(concat)
    keys = np.zeros((P, words), dtype=np.uint32)
    u8p = ctypes.POINTER(ctypes.c_uint8)
    u32p = ctypes.POINTER(ctypes.c_uint32)
    i64p = ctypes.POINTER(ctypes.c_int64)
    lib.pack_position_keys(concat.ctypes.data_as(u8p), P,
                           offsets.ctypes.data_as(i64p), len(offsets) - 1,
                           bits, words, keys.ctypes.data_as(u32p))
    return keys
