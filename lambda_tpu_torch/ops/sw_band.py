"""The banded Smith-Waterman kernels of the extension: K1, K2 and K3.

Port of ``lambda_tpu/ops/sw_band.py``.  Its three TPU kernels become CUDA
kernels; each source's header gives the design and what bounds it:

* K1 (``_make_band_kernel_lane``, pass 1, the default 'lane' layout) ->
  ``csrc/sw_band.cu``, plain version :func:`sw_band_score_torch`.
* K2 (``_make_band_dirs_kernel``, pass 2 under ``LAMBDA_SW_TRACE=device``)
  -> ``csrc/sw_band_dirs.cu``, plain version :func:`sw_band_align_torch`;
  the host walk :func:`traceback_banded` reads its direction codes.
* K3 (``_make_band_kernel``, pass 1 in the 'sublane' layout, chosen by
  ``LAMBDA_SWB_LAYOUT=sublane``, latched when the module is imported as
  in JAX) -> ``csrc/sw_band_sub.cu``: one thread per alignment, its band
  in registers (:func:`sub_config` picks the register bucket or, for
  wide bands, the global-scratch sweep).  K3 computes K1's function
  without X-drop, so its plain version is :func:`sw_band_score_torch`
  too.

K1 and K2 share one core, ``csrc/band_warp.cuh``: a group of G lanes of
one warp sweeps an alignment's band, each lane a run of R consecutive
band offsets held in registers, with no block barrier; the wrapper picks
(G, R) from (B, D) with :func:`warp_config`.

X-drop (``LAMBDA_SW_XDROP``, latched at import as in JAX): pass 1 scores
with the lane kernel's chunk-granular early exit -- after every ``nc``
window columns a row whose max(H, E, 0) over the band has fallen more
than X below its best (best > 0) is latched dead and its later columns
contribute nothing.  ``nc`` must be the JAX package's column chunk
(:func:`plan_nc`, a copy of ``_plan``'s formula), or the checkpoints fall
on other columns and the scores differ.  Pass 2 (K2) stays exact, and the
sublane layout refuses X-drop, as in the JAX package.

Window convention (unchanged): the caller builds a *virtual* subject
window such that the band is exactly ``d = j - i in [0, d_row]`` (query
position i, window position j); positions outside the real subject carry
the PAD rank (``C - 1`` for a (C, C) matrix, scoring ``PAD_SCORE8``
against everything).  Per-row band widths keep every score independent of
how alignments are grouped into launches, and bands are enforced per CELL
(off-band E -> -inf, H -> 0, F sources -> -inf): masking only the
substitution scores would let pure gap corridors cross the band.

``sw_band_score_device`` and ``sw_band_align_device`` launch a kernel for
CUDA tensors and run the plain PyTorch version for CPU tensors; there is
no fallback from one to the other.  Of the TPU kernels' tile plans only
the column chunk survives (:func:`plan_nc`, for X-drop); the CUDA kernels
take any batch and window size, and PAD columns or padding rows cannot
change a score or a trace.
"""

from __future__ import annotations

import ctypes
import os

import numpy as np
import torch

NEG32 = -(2 ** 27)
PAD_SCORE8 = -128
PAD_SCORE = -(2 ** 20)
# shared memory a block may use on Hopper (232,448 bytes)
_SMEM_MAX = 227 * 1024
# pass-1 layout, latched at import like lambda_tpu/ops/sw_band.py:66:
# 'lane' launches K1, 'sublane' launches K3
_LAYOUT = os.environ.get("LAMBDA_SWB_LAYOUT", "lane")
# the lane plan's batch-tile cap (lambda_tpu/ops/sw_band.py:67): it sets
# the column chunk, and with it the X-drop checkpoints
_BT_CAP = int(os.environ.get("LAMBDA_SWB_BT", "512"))
# pass-1 X-drop, latched at import like lambda_tpu/ops/sw_band.py:72
# (0: exact band semantics)
_XDROP = int(os.environ.get("LAMBDA_SW_XDROP", "0"))

# kernel launches since the last reset, one counter per kernel
# (chip_smoke reads them around the main path): K1, K2 and K3
launches = 0
launches_dirs = 0
launches_sub = 0


def extend_matrix(subst: np.ndarray) -> np.ndarray:
    """Add a PAD row/column scoring PAD_SCORE against everything (the
    int32 matrix of the host passes; lambda_tpu/ops/sw_xla.py)."""
    a = subst.shape[0]
    out = np.full((a + 1, a + 1), PAD_SCORE, dtype=np.int32)
    out[:a, :a] = subst
    return out


def extend_matrix8(subst: np.ndarray) -> np.ndarray:
    """Add PAD row/col scoring -128; clip to int8 range."""
    a = subst.shape[0]
    out = np.full((a + 1, a + 1), PAD_SCORE8, dtype=np.int8)
    out[:a, :a] = np.clip(subst, -127, 127)
    return out


def ext8_from_ext32(ext32: np.ndarray) -> np.ndarray:
    """Convert an extend_matrix (int32, PAD row included) to int8."""
    a = ext32.shape[0] - 1
    return extend_matrix8(np.asarray(ext32)[:a, :a])


def _ceil(x: int, m: int) -> int:
    return -(-x // m) * m


def _lane_geometry(D: int):
    """Copy of lambda_tpu/ops/sw_band.py:_lane_geometry: per-alignment
    band width Ws = D+1 padded to 8, P alignments per 128-lane register,
    LW lanes, BT batch sublanes per tile."""
    Ws = _ceil(D + 1, 8)
    P = max(1, 128 // Ws)
    LW = max(_ceil(Ws, 128), 128)
    BT = max(8, min(_BT_CAP, (1 << 21) // (LW * 4)))  # ~2 MB state x3
    BT = (BT // 8) * 8
    return Ws, P, LW, BT


def plan_nc(Ns: int, D: int) -> int:
    """The column chunk NC of the JAX lane plan for a (window Ns, band D)
    class: ``lambda_tpu/ops/sw_band.py:_plan(Ns, D)[3]`` in the lane
    layout, the X-drop checkpoint interval."""
    Ws, P, LW, BT = _lane_geometry(D)
    bytes_per_col = BT * LW
    NC = max(2 * 1024 * 1024 // bytes_per_col, 8)
    NC = 1 << int(np.log2(NC))
    N = max(_ceil(Ns, 8), Ws)
    if NC >= N:
        NC = _ceil(N, 8)
    return NC


def _band_sweep(q: torch.Tensor, s: torch.Tensor, d_rows: torch.Tensor,
                subst8: torch.Tensor, D: int, gap_first: int,
                gap_extend: int):
    """The plain banded DP shared by K1's and K2's plain versions: a
    column loop over (B, D+1) int32 band tensors, the F recurrence as a
    max-plus doubling scan along the band.  Yields, per window column,
    (valid, ea, eb, E, diag, F, H) with ea = E[w+1] + ge and
    eb = H[w+1] + gf of the previous column, E and H masked to the band
    (E = -inf, H = 0 off band) and F unmasked."""
    B, N = q.shape
    dev = q.device
    W = D + 1
    C = subst8.shape[0]
    sub_tbl = subst8.to(torch.int32)
    neg = torch.tensor(NEG32, dtype=torch.int32, device=dev)
    zero = torch.zeros((), dtype=torch.int32, device=dev)
    gf, ge = int(gap_first), int(gap_extend)
    w = torch.arange(W, device=dev)
    valid = w[None, :] >= (D - d_rows.to(torch.int64))[:, None]   # (B, W)
    # query ranks sheared into band coordinates: column j, lane w reads
    # query position j + w - D (PAD outside [0, N))
    qpad = torch.cat([torch.full((B, D), C - 1, dtype=torch.int64,
                                 device=dev),
                      q.to(torch.int64),
                      torch.full((B, W), C - 1, dtype=torch.int64,
                                 device=dev)], dim=1)
    s64 = s.to(torch.int64)
    H = torch.zeros((B, W), dtype=torch.int32, device=dev)
    E = torch.full((B, W), NEG32, dtype=torch.int32, device=dev)
    # lane D pulls E/H from off band (E = -inf, H = 0)
    h_off = torch.zeros((B, 1), dtype=torch.int32, device=dev)
    e_off = torch.full((B, 1), NEG32, dtype=torch.int32, device=dev)
    neg_col = torch.full((B, 1), NEG32, dtype=torch.int32, device=dev)
    for j in range(N):
        sub = sub_tbl[qpad[:, j:j + W], s64[:, j:j + 1]]
        ea = torch.cat([E[:, 1:], e_off], dim=1) + ge
        eb = torch.cat([H[:, 1:], h_off], dim=1) + gf
        E = torch.where(valid, torch.maximum(ea, eb), neg)
        diag = H + sub
        htmp = torch.maximum(torch.maximum(diag, E), zero)
        fsrc = torch.where(valid, htmp, neg)
        # F[w] = max_{k < w} fsrc[k] + gf + (w - 1 - k) * ge
        F = torch.cat([neg_col, fsrc[:, :-1] + gf], dim=1)
        st = 1
        while st < W:
            F = torch.maximum(F, torch.cat(
                [F[:, :st], F[:, :-st] + st * ge], dim=1))
            st *= 2
        H = torch.where(valid, torch.maximum(htmp, F), zero)
        yield valid, ea, eb, E, diag, F, H


def _score_sweep(q, s, d_rows, subst8, D: int, gap_first: int,
                 gap_extend: int, x_drop: int = 0, nc: int = 0):
    """K1's function column by column: yields, per window column, (best
    so far, the rows that swept this column).  With ``x_drop > 0`` a row
    is latched dead after a column j with (j + 1) % nc == 0 when its best
    is positive and max(H, E, 0) over the band is below best - x_drop
    (lambda_tpu/ops/sw_band.py:sw_band_xdrop_reference)."""
    best = torch.zeros(q.shape[0], dtype=torch.int32, device=q.device)
    live = torch.ones(q.shape[0], dtype=torch.bool, device=q.device)
    for j, (_, _, _, E, _, _, H) in enumerate(_band_sweep(
            q, s, d_rows, subst8, D, gap_first, gap_extend)):
        swept = live.clone()
        best = torch.where(live, torch.maximum(best, H.max(dim=1).values),
                           best)
        if x_drop > 0 and (j + 1) % nc == 0:
            cur = torch.maximum(H.max(dim=1).values,
                                E.max(dim=1).values).clamp(min=0)
            live &= ~((best > 0) & (cur < best - x_drop))
        yield best, swept


def sw_band_score_torch(q: torch.Tensor, s: torch.Tensor,
                        d_rows: torch.Tensor, subst8: torch.Tensor, D: int,
                        gap_first: int, gap_extend: int, x_drop: int = 0,
                        nc: int = 0) -> torch.Tensor:
    """Plain PyTorch version of K1 and of K3 (:func:`_band_sweep`, with
    X-drop as :func:`_score_sweep`).  Same arguments and result as
    :func:`sw_band_score_device`."""
    best = torch.zeros(q.shape[0], dtype=torch.int32, device=q.device)
    for best, _ in _score_sweep(q, s, d_rows, subst8, D, gap_first,
                                gap_extend, x_drop, nc):
        pass
    return best


def check_cuda_inputs(kernel, **tensors):
    """Refuse a launch unless every tensor is contiguous on the card with
    its kernel's dtype: int32 for ``d_rows``, int8 for ranks and matrix
    (K1-K4)."""
    for name, t in tensors.items():
        dt = torch.int32 if name == "d_rows" else torch.int8
        if not t.is_cuda or t.dtype != dt or not t.is_contiguous():
            raise ValueError(f"{kernel}: {name} must be a contiguous CUDA "
                             f"{dt} tensor (got {t.dtype} on {t.device})")


# K1 and K2 (csrc/band_warp.cuh): threads per block, window columns staged
# per refill, offsets per segment when the band exceeds 32 lanes x 32
BW_THREADS = 128
BW_CHUNK = 256
SEG = 1024
# run lengths compiled into the kernels: K1 takes any of R_SCORE, K2 a
# run whose codes pack into whole 32-bit words (or R = 1, 2)
R_SCORE = (1, 2, 3, 4, 5, 6, 8, 10, 12, 16, 20, 24, 32)
R_DIRS = (1, 2, 4, 8, 12, 16, 20, 24, 32)
# warp_config's rule, per kernel: (offsets per lane a small launch aims
# at, lanes in flight above which G halves, longest run G may halve to).
# Set from a (B, D) sweep of every G on the H100 (chip_smoke.py
# --warp-sweep, numbers in PERF.md): a small
# launch is bound by one warp's chain of dependent instructions per
# column, which short runs keep short; a large one by issue, where fewer
# lanes per alignment waste fewer on padding and on the scan.  K2 holds
# a code per offset besides, so it keeps its runs shorter.
_WARP_RULE = {False: (5, 48 * 1024, 32), True: (1, 48 * 1024, 16)}


def warp_config(B: int, D: int, dirs: bool = False):
    """(G, R, S) for a K1 (or, with ``dirs``, K2) launch of B rows of band
    D: G lanes per alignment, R band offsets per lane, S segments of
    32 x 32 offsets (S > 1 only for D + 1 > 1024, G = R = 32, state in
    global scratch).  G starts at the power of two that gives runs of
    about the rule's length (16 or 32 lanes: small launches spread each
    band over half a warp or a whole one) and halves, down to 4, while
    B * G lanes exceed the rule's count: large launches pack 32 / G
    alignments into a warp."""
    W = D + 1
    if W > SEG:
        return 32, 32, -(-W // SEG)
    run, lanes, r_max = _WARP_RULE[dirs]
    G = min(32, max(4, 1 << (-(-W // run) - 1).bit_length()))
    while G > 4 and B * G > lanes and -(-W // (G // 2)) <= r_max:
        G //= 2
    need = -(-W // G)
    R = next(r for r in (R_DIRS if dirs else R_SCORE) if r >= need)
    return G, R, 1


def _warp_smem(G: int, C: int) -> int:
    """Dynamic shared bytes of a K1/K2 block: the transposed int32 matrix
    (rounded to 16 bytes), then per group two staging buffers of
    BW_CHUNK + 16 bytes (query and window ranks)."""
    return _ceil(4 * C * C, 16) + (BW_THREADS // G) * 2 * (BW_CHUNK + 16)


def _sw_band_score_cuda(q, s, d_rows, subst8, D, gap_first, gap_extend,
                        x_drop=0, nc=0):
    from . import _build

    global launches
    B, N = q.shape
    C = subst8.shape[0]
    check_cuda_inputs("K1", q=q, s=s, d_rows=d_rows,
                      subst8=subst8)
    lib = _build.load("sw_band")
    fn = lib.sw_band_score_launch
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 11 + [
        ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p,
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    out = torch.empty(B, dtype=torch.int32, device=q.device)
    G, R, S = warp_config(B, D)
    scratch = (torch.empty(3 * S * SEG * B, dtype=torch.int32,
                           device=q.device) if S > 1 else None)
    with _build.launch_stream(q.device) as stream:
        err = fn(q.data_ptr(), s.data_ptr(), d_rows.data_ptr(),
                 subst8.data_ptr(), B, N, D, C, int(gap_first),
                 int(gap_extend), G, R, S, int(x_drop), int(nc),
                 scratch.data_ptr() if scratch is not None else None,
                 _warp_smem(G, C), out.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"K1 launch failed: cudaError {err}")
    launches += 1
    return out


def sw_band_score_device(q: torch.Tensor, s: torch.Tensor,
                         d_rows: torch.Tensor, subst8: torch.Tensor, D: int,
                         gap_first: int, gap_extend: int, x_drop: int = 0,
                         nc: int = 0) -> torch.Tensor:
    """Best in-band local score per row.

    q: (B, N) query ranks (PAD beyond the query), s: (B, N) the virtual
    windows, d_rows: (B,) int32 per-row band sizes <= D (-1 marks a
    batch-padding row that scores 0), subst8: (C, C) int8 with the PAD
    row/column last.  ``x_drop > 0`` applies X-drop with checkpoints
    every ``nc`` columns (:func:`plan_nc`).  Returns (B,) int32.  CUDA
    tensors (int8 ranks) launch K1, or K3 when the layout is 'sublane';
    CPU tensors run :func:`sw_band_score_torch`."""
    if x_drop > 0 and _LAYOUT != "lane":
        # as lambda_tpu/ops/sw_band.py:868-874: the sublane kernel has no
        # X-drop, and exact scores where X-drop ones are asked for would
        # make the output depend on the layout
        raise NotImplementedError(
            "LAMBDA_SW_XDROP requires the default lane layout "
            "(LAMBDA_SWB_LAYOUT=sublane does not implement X-drop)")
    if x_drop > 0 and nc <= 0:
        raise ValueError("X-drop needs the column chunk nc > 0")
    _check_shapes("K1", q, s, d_rows, subst8)
    if q.is_cuda:
        if _LAYOUT == "sublane":
            return _sw_band_score_sub_cuda(q, s, d_rows, subst8, D,
                                           gap_first, gap_extend)
        return _sw_band_score_cuda(q, s, d_rows, subst8, D, gap_first,
                                   gap_extend, x_drop, nc)
    return sw_band_score_torch(q, s, d_rows, subst8, D, gap_first,
                               gap_extend, x_drop, nc)


def _check_shapes(kernel, q, s, d_rows, subst8):
    B, N = q.shape
    C = subst8.shape[0]
    if s.shape != (B, N) or d_rows.shape != (B,) or subst8.shape != (C, C):
        raise ValueError(f"{kernel}: shapes q {tuple(q.shape)} s "
                         f"{tuple(s.shape)} d_rows {tuple(d_rows.shape)} "
                         f"subst8 {tuple(subst8.shape)} do not agree")


# K3 (csrc/sw_band_sub.cu): alignments (threads) per block, the widest
# band held in registers (also the chunk of a wider band's scratch
# sweep), window columns staged per refill
SUB_THREADS = 128
SUB_REG_MAX = 64
SUB_CHUNK = 64


def sub_config(B: int, D: int):
    """(WP, S, blocks) for a K3 launch of B rows of band D: the band's
    D + 1 offsets in registers, rounded up to a compiled bucket WP (a
    multiple of 8 up to SUB_REG_MAX), S = 1; or, above SUB_REG_MAX, S
    chunks of SUB_REG_MAX offsets in global scratch.  One thread per
    alignment, SUB_THREADS per block."""
    W = D + 1
    blocks = -(-B // SUB_THREADS)
    if W <= SUB_REG_MAX:
        return _ceil(max(W, 1), 8), 1, blocks
    return SUB_REG_MAX, -(-W // SUB_REG_MAX), blocks


def _sub_smem(C: int) -> int:
    """Dynamic shared bytes of a K3 block: the per-lane interleaved int8
    tables (C * ceil(C / 4) * 128 bytes, rounded to 16), then per thread
    two staging buffers of SUB_CHUNK + 16 bytes (query and window ranks)."""
    return (_ceil(C * (-(-C // 4)) * 128, 16)
            + 2 * SUB_THREADS * (SUB_CHUNK + 16))


def _sw_band_score_sub_cuda(q, s, d_rows, subst8, D, gap_first,
                            gap_extend):
    from . import _build

    global launches_sub
    B, N = q.shape
    C = subst8.shape[0]
    check_cuda_inputs("K3", q=q, s=s, d_rows=d_rows,
                      subst8=subst8)
    smem = _sub_smem(C)
    if smem > _SMEM_MAX:
        raise ValueError(f"K3: a {C} x {C} matrix needs {smem} bytes of "
                         "shared memory")
    lib = _build.load("sw_band_sub")
    fn = lib.sw_band_sub_launch
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 8 + [
        ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p,
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    out = torch.empty(B, dtype=torch.int32, device=q.device)
    WP, S, blocks = sub_config(B, D)
    scratch = (torch.empty(3 * WP * S * blocks * SUB_THREADS,
                           dtype=torch.int32, device=q.device)
               if S > 1 else None)
    with _build.launch_stream(q.device) as stream:
        err = fn(q.data_ptr(), s.data_ptr(), d_rows.data_ptr(),
                 subst8.data_ptr(), B, N, D, C, int(gap_first),
                 int(gap_extend), WP, S,
                 scratch.data_ptr() if scratch is not None else None,
                 smem, out.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"K3 launch failed: cudaError {err}")
    launches_sub += 1
    return out


def sw_band_score(q: np.ndarray, s: np.ndarray, d_rows: np.ndarray,
                  subst_ext8, gap_first: int, gap_extend: int,
                  device: str = "cuda") -> np.ndarray:
    """Host API: best banded local score per row, with the latched
    X-drop at the JAX plan's chunk (as ``sw_band_score_pallas``).

    q: (B, Mq) ranks (PAD rank = alphabet size); s: (B, Ns) the VIRTUAL
    windows; d_rows: per-row band sizes.  A query wider than the window
    is clipped to Ns columns: query row i only pairs with window
    positions j >= i, so rows past the last window column are out of
    band for every cell."""
    B, Mq = q.shape
    Ns = s.shape[1]
    D = int(d_rows.max()) if len(d_rows) else 0
    pad_rank = int(np.asarray(subst_ext8).shape[0]) - 1
    qp = np.full((B, Ns), pad_rank, dtype=np.int8)
    qp[:, :min(Mq, Ns)] = q[:, :Ns]
    dev = torch.device(device)
    out = sw_band_score_device(
        torch.as_tensor(qp, device=dev),
        torch.as_tensor(np.ascontiguousarray(s, dtype=np.int8), device=dev),
        torch.as_tensor(np.asarray(d_rows, dtype=np.int32), device=dev),
        torch.as_tensor(np.asarray(subst_ext8, dtype=np.int8), device=dev),
        D, gap_first, gap_extend, _XDROP,
        plan_nc(Ns, D) if _XDROP else 0)
    return out.cpu().numpy()


# ---------------------------------------------------------------------------
# K2: the direction-emitting pass (pass 2 under LAMBDA_SW_TRACE=device)
# ---------------------------------------------------------------------------


def sw_band_align_torch(q: torch.Tensor, s: torch.Tensor,
                        d_rows: torch.Tensor, subst8: torch.Tensor, D: int,
                        gap_first: int, gap_extend: int):
    """Plain PyTorch version of K2 (:func:`_band_sweep` plus the codes).
    Same arguments and results as :func:`sw_band_align_device`."""
    B, N = q.shape
    dev = q.device
    W = D + 1
    gf, ge = int(gap_first), int(gap_extend)
    dirs = torch.zeros((B, N, W), dtype=torch.uint8, device=dev)
    w = torch.arange(W, device=dev)
    wmin = (D - d_rows.to(torch.int64))[:, None]
    best = torch.zeros(B, dtype=torch.int32, device=dev)
    key = torch.full((B,), 2 ** 62, dtype=torch.int64, device=dev)
    end_j = torch.full((B,), -1, dtype=torch.int32, device=dev)
    end_w = torch.full((B,), -1, dtype=torch.int32, device=dev)
    neg_col = torch.full((B, 1), NEG32, dtype=torch.int32, device=dev)
    zero_col = torch.zeros((B, 1), dtype=torch.int32, device=dev)
    for j, (valid, ea, eb, E, diag, F, H) in enumerate(_band_sweep(
            q, s, d_rows, subst8, D, gf, ge)):
        pos = H > 0
        code = torch.where(pos & (H == F), 3, 0)
        code = torch.where(pos & (H == E), 2, code)
        code = torch.where(pos & (H == diag), 1, code)
        code = code | torch.where(ea >= eb, 4, 0)
        # F extends: F[w-1] + ge >= H[w-1] + gf (final masked H below)
        f_ext = (torch.cat([neg_col, F[:, :-1]], dim=1) + ge
                 >= torch.cat([zero_col, H[:, :-1]], dim=1) + gf)
        code = code | torch.where(f_ext & (w[None, :] > wmin), 8, 0)
        dirs[:, j] = torch.where(valid, code, 0).to(torch.uint8)
        # end cell: max H, then smallest i + j (key 2j + w), then
        # smallest i (a later column); within a column the first w at
        # the column's maximum has the smallest key
        col_max = H.max(dim=1).values
        col_w = torch.where(H == col_max[:, None], w[None, :], W) \
            .min(dim=1).values
        col_key = 2 * j + col_w
        upd = (col_max > 0) & ((col_max > best)
                               | ((col_max == best) & (col_key <= key)))
        best = torch.where(upd, col_max, best)
        key = torch.where(upd, col_key, key)
        end_j = torch.where(upd, j, end_j)
        end_w = torch.where(upd, col_w.to(torch.int32), end_w)
    return dirs, best, end_j, end_w


def _sw_band_align_cuda(q, s, d_rows, subst8, D, gap_first, gap_extend):
    from . import _build

    global launches_dirs
    B, N = q.shape
    C = subst8.shape[0]
    check_cuda_inputs("K2", q=q, s=s, d_rows=d_rows,
                      subst8=subst8)
    lib = _build.load("sw_band_dirs")
    fn = lib.sw_band_dirs_launch
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 9 + [
        ctypes.c_void_p, ctypes.c_longlong] + [ctypes.c_void_p] * 5
    fn.restype = ctypes.c_int
    dev = q.device
    G, R, S = warp_config(B, D, dirs=True)
    # the kernel's rows hold the launch's G * R * S offsets, the band's
    # D + 1 last: padding below the band keeps each group's stores whole
    Wp = G * R * S
    dirs = torch.empty((B, N, Wp), dtype=torch.uint8, device=dev)
    best, end_j, end_w = (torch.empty(B, dtype=torch.int32, device=dev)
                          for _ in range(3))
    scratch = (torch.empty(3 * S * SEG * B, dtype=torch.int32, device=dev)
               if S > 1 else None)
    with _build.launch_stream(dev) as stream:
        err = fn(q.data_ptr(), s.data_ptr(), d_rows.data_ptr(),
                 subst8.data_ptr(), B, N, D, C, int(gap_first),
                 int(gap_extend), G, R, S,
                 scratch.data_ptr() if scratch is not None else None,
                 _warp_smem(G, C), dirs.data_ptr(), best.data_ptr(),
                 end_j.data_ptr(), end_w.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"K2 launch failed: cudaError {err}")
    launches_dirs += 1
    return dirs[:, :, Wp - 1 - D:], best, end_j, end_w


def sw_band_align_device(q: torch.Tensor, s: torch.Tensor,
                         d_rows: torch.Tensor, subst8: torch.Tensor, D: int,
                         gap_first: int, gap_extend: int):
    """The banded DP with direction codes, for the host walk.

    Same inputs as :func:`sw_band_score_device` (no X-drop: pass 2 is
    exact).  Returns (dirs, best, end_j, end_w): dirs (B, N, D+1) uint8,
    the code of cell (column j, band offset w) of row b at dirs[b, j, w]
    (bits 0-1 the H source -- 1 diagonal, 2 E, 3 F, 0 none --, 4 E
    extends, 8 F extends, 0 off band; from K2 a view of its padded rows);
    best (B,) int32 the row's best score; (end_j, end_w) (B,) int32 the
    end cell the walk starts from (-1 for a score of 0).  CUDA tensors
    launch K2; CPU tensors run :func:`sw_band_align_torch`."""
    _check_shapes("K2", q, s, d_rows, subst8)
    if q.is_cuda:
        return _sw_band_align_cuda(q, s, d_rows, subst8, D, gap_first,
                                   gap_extend)
    return sw_band_align_torch(q, s, d_rows, subst8, D, gap_first,
                               gap_extend)


def traceback_banded(dirs: np.ndarray, b: int, end_j: int, end_w: int,
                     D: int):
    """Walk the direction codes of row ``b`` back from its end cell.

    Port of lambda_tpu/ops/sw_band.py:traceback_banded on the port's
    dirs layout (B, N, D+1), for a row whose best score is positive.
    Returns (q0, s0, ops): 0-based window-relative starts and the
    run-length op list ('M'/'D'/'I') of the sw_xla conventions."""
    col = dirs[b]
    N, W = col.shape
    j, w = int(end_j), int(end_w)
    ops: list[str] = []
    state = "H"
    while True:
        code = int(col[j, w]) if (j >= 0 and 0 <= w < W) else 0
        if state == "H":
            h = code & 3
            if h == 0 or j < 0 or (j + w - D) < 0:
                break
            if h == 1:
                ops.append("M")
                j -= 1            # w unchanged (diagonal)
            elif h == 2:
                state = "E"
            else:
                state = "F"
        elif state == "E":
            ops.append("D")
            state = "E" if code & 4 else "H"
            j -= 1
            w += 1
        else:
            ops.append("I")
            state = "F" if code & 8 else "H"
            w -= 1
    q0 = j + w - D + 1            # start coords (0-based, inclusive)
    s0 = j + 1
    ops.reverse()
    rle: list[tuple[str, int]] = []
    for op in ops:
        if rle and rle[-1][0] == op:
            rle[-1] = (op, rle[-1][1] + 1)
        else:
            rle.append((op, 1))
    return q0, s0, rle


def walk_rows(dirs, best, end_j, end_w, D: int):
    """Host walk of every row of one K2 launch (device or host tensors):
    (scores (B,) int64, traces) with traces[b] = (q0, s0, ops), or None
    for a score of 0."""
    dirs = dirs.cpu().numpy()
    best, end_j, end_w = (t.cpu().numpy() for t in (best, end_j, end_w))
    traces: list = [None] * len(best)
    for b in np.flatnonzero(best > 0):
        traces[b] = traceback_banded(dirs, b, end_j[b], end_w[b], D)
    return best.astype(np.int64), traces


def sw_band_align(q: np.ndarray, s: np.ndarray, d_rows: np.ndarray,
                  subst_ext8, gap_first: int, gap_extend: int,
                  device: str = "cuda"):
    """Host API of the direction-emitting pass (the port of
    ``sw_band_align_pallas``): runs K2 (or its plain version on the CPU)
    and walks each row on the host.  Returns (scores, traces) with
    traces[i] = (q0, s0, rle-ops), or None for a score of 0.  A query
    wider than the window is clipped as in :func:`sw_band_score`."""
    B, Mq = q.shape
    Ns = s.shape[1]
    D = int(d_rows.max()) if len(d_rows) else 0
    pad_rank = int(np.asarray(subst_ext8).shape[0]) - 1
    qp = np.full((B, Ns), pad_rank, dtype=np.int8)
    qp[:, :min(Mq, Ns)] = q[:, :Ns]
    dev = torch.device(device)
    out = sw_band_align_device(
        torch.as_tensor(qp, device=dev),
        torch.as_tensor(np.ascontiguousarray(s, dtype=np.int8), device=dev),
        torch.as_tensor(np.asarray(d_rows, dtype=np.int32), device=dev),
        torch.as_tensor(np.asarray(subst_ext8, dtype=np.int8), device=dev),
        D, gap_first, gap_extend)
    return walk_rows(*out, D)
