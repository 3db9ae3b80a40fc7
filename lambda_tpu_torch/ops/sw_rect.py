"""K4: the unbanded (rectangle) Smith-Waterman score kernel.

Port of ``lambda_tpu/ops/sw_pallas.py``.  Its TPU kernel (``_make_kernel``,
fed by the one-hot substitution image ``_sub_image``) becomes the CUDA
kernel in ``csrc/sw_rect.cu``; see its header for the design and what
bounds it.  The TPU tile plan (``batch_tile``/``_chunk_cols``: batch
tiles, queries padded to 128 lanes, windows to the column chunk) has no
counterpart: the CUDA kernel takes any batch, query and window size.

Conventions are the JAX package's: ``gap_first`` = open + extend for a
gap's first character, ``gap_extend`` for each further one; the PAD rank
(``C - 1``) is trailing and scores -128 against everything, which cannot
raise a local maximum, so nothing is masked.

``sw_score_device`` launches the kernel for CUDA tensors and runs the
plain PyTorch version :func:`sw_score_torch` for CPU tensors; there is no
fallback from one to the other.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from .sw_band import _SMEM_MAX, NEG32, check_cuda_inputs

# the JAX package's query-length limit (sw_pallas.py:55), kept so both
# packages accept the same inputs
M_MAX = 16384

# kernel launches since the last reset (chip_smoke reads it)
launches = 0

# csrc/sw_rect.cu: the query positions per lane compiled into the kernel,
# the most strips (warps) one alignment may take (a 512-thread block),
# and the hand-off slots between two strips
R_RECT = (1, 2, 4, 8, 16, 32)
MAX_STRIPS = 16
RING = 128


def rect_config(B: int, M: int):
    """(R, W, P) of a K4 launch: R query positions per lane, W strips of
    32 * R positions (one warp each) per alignment, P alignments per
    block (W * P <= 4 unless one alignment takes more).  A query of up to
    128 positions takes one warp with the shortest run that covers it;
    longer ones take runs of 4, doubled until at most 16 strips cover M.
    Runs of 4 were the fastest at every case of ``chip_smoke.py
    --rect-sweep`` they could cover (M 128 to 2,048, on the H100): more
    warps in flight outweigh the per-step work that longer runs share."""
    if M <= 128:
        R = next(r for r in R_RECT if 32 * r >= M)
    else:
        R = 4
        while 32 * R * MAX_STRIPS < M:
            R *= 2
    W = max(1, -(-M // (32 * R)))
    return R, W, max(1, 4 // W)


def _rect_smem(C: int, W: int, P: int) -> int:
    """Dynamic shared bytes of a K4 block: the transposed int32 matrix with
    a dead row and column (rounded to 16 bytes), the rings of int2 slots
    between strips, and per alignment its best and two progress counters
    per ring."""
    return (-(-4 * (C + 1) ** 2 // 16) * 16 + P * (W - 1) * RING * 8
            + P * 2 * W * 4)


def sw_score_torch(q: torch.Tensor, s: torch.Tensor, subst8: torch.Tensor,
                   gap_first: int, gap_extend: int) -> torch.Tensor:
    """Plain PyTorch version of K4: a column loop over the window s with
    (B, M) int32 state along the query, F as a max-plus doubling scan
    along the query (sw_pallas.py:154-167).  Same arguments and result as
    :func:`sw_score_device`."""
    B, M = q.shape
    N = s.shape[1]
    dev = q.device
    gf, ge = int(gap_first), int(gap_extend)
    sub_tbl = subst8.to(torch.int32)
    q64 = q.to(torch.int64)
    s64 = s.to(torch.int64)
    zero = torch.zeros((), dtype=torch.int32, device=dev)
    zero_col = torch.zeros((B, 1), dtype=torch.int32, device=dev)
    neg_col = torch.full((B, 1), NEG32, dtype=torch.int32, device=dev)
    H = torch.zeros((B, M), dtype=torch.int32, device=dev)
    E = torch.full((B, M), NEG32, dtype=torch.int32, device=dev)
    best = torch.zeros(B, dtype=torch.int32, device=dev)
    for j in range(N):
        sub = sub_tbl[q64, s64[:, j:j + 1]]
        E = torch.maximum(E + ge, H + gf)
        h_up = torch.cat([zero_col, H[:, :-1]], dim=1)
        htmp = torch.maximum(torch.maximum(h_up + sub, E), zero)
        # F[i] = max_{k < i} htmp[k] + gf + (i - 1 - k) * ge
        F = torch.cat([neg_col, htmp[:, :-1] + gf], dim=1)
        st = 1
        while st < M:
            F = torch.maximum(F, torch.cat(
                [F[:, :st], F[:, :-st] + st * ge], dim=1))
            st *= 2
        H = torch.maximum(htmp, F)
        best = torch.maximum(best, H.max(dim=1).values)
    return best


def _sw_score_cuda(q, s, subst8, gap_first, gap_extend):
    from . import _build

    global launches
    B, M = q.shape
    N = s.shape[1]
    C = subst8.shape[0]
    check_cuda_inputs("K4", q=q, s=s, subst8=subst8)
    lib = _build.load("sw_rect")
    fn = lib.sw_rect_launch
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 9 + [
        ctypes.c_longlong, ctypes.c_void_p, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    out = torch.empty(B, dtype=torch.int32, device=q.device)
    R, W, P = rect_config(B, M)
    smem = _rect_smem(C, W, P)
    if smem > _SMEM_MAX:
        raise ValueError(f"K4: a {C} x {C} matrix and {W} strips need "
                         f"{smem} bytes of shared memory")
    with _build.launch_stream(q.device) as stream:
        err = fn(q.data_ptr(), s.data_ptr(), subst8.data_ptr(), B, M, N, C,
                 int(gap_first), int(gap_extend), R, W, P, smem,
                 out.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"K4 launch failed: cudaError {err}")
    launches += 1
    return out


def sw_score_device(q: torch.Tensor, s: torch.Tensor, subst8: torch.Tensor,
                    gap_first: int, gap_extend: int) -> torch.Tensor:
    """Best local score per row over the whole rectangle.

    q: (B, M) query ranks, s: (B, N) window ranks (PAD = C - 1 trailing
    in both), subst8: (C, C) int8 with the PAD row/column last.  Returns
    (B,) int32.  CUDA tensors (int8 ranks) launch K4; CPU tensors run
    :func:`sw_score_torch`.  An empty query (M = 0) scores 0 on either
    device without a launch, as the JAX package's all-PAD query does."""
    B, M = q.shape
    C = subst8.shape[0]
    if s.shape[0] != B or subst8.shape != (C, C):
        raise ValueError(f"K4: shapes q {tuple(q.shape)} s {tuple(s.shape)} "
                         f"subst8 {tuple(subst8.shape)} do not agree")
    if M == 0:
        return torch.zeros(B, dtype=torch.int32, device=q.device)
    if q.is_cuda:
        return _sw_score_cuda(q, s, subst8, gap_first, gap_extend)
    return sw_score_torch(q, s, subst8, gap_first, gap_extend)


def sw_score(q: np.ndarray, s: np.ndarray, subst_ext8, gap_first: int,
             gap_extend: int, device: str = "cuda") -> np.ndarray:
    """Host API (the port of ``sw_score_pallas``): best local score per
    row.  q: (B, Mq) ranks (PAD rank = alphabet size), s: (B, Ns).
    Returns (B,) int32 numpy.  Queries longer than ``M_MAX`` raise
    ``ValueError``, as in the JAX package."""
    Mq = q.shape[1]
    if Mq > M_MAX:
        raise ValueError(
            f"sw_score: query length {Mq} > M_MAX={M_MAX}; use the banded "
            "kernels (ops/sw_band.py) or the host helpers")
    dev = torch.device(device)

    def put(a):
        return torch.as_tensor(np.ascontiguousarray(a, dtype=np.int8),
                               device=dev)

    return sw_score_device(put(q), put(s), put(subst_ext8), gap_first,
                           gap_extend).cpu().numpy()
