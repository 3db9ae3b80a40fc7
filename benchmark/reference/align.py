"""Plain Smith-Waterman with affine gaps and traceback, in PyTorch.

The textbook recurrence (Gotoh 1982) over the whole rectangle of each
pair, no band and no window, batched over pairs and swept row by row:

    F(i, j) = max(F(i-1, j) - 1, H(i-1, j) - 12)      a gap in the subject
    E(i, j) = max(E(i, j-1) - 1, H(i, j-1) - 12)      a gap in the query
    H(i, j) = max(0, H(i-1, j-1) + BLOSUM62(q_i, s_j), E(i, j), F(i, j))

A gap of length L costs 11 + L.  E is taken along the row as a running
maximum: E(i, j) = max over k < j of Hx(i, k) - 12 - (j-1-k), where Hx
is H without E (opening a gap right after a gap of the same row never
beats extending it).  The alignment ends at the largest H, ties broken
by the smaller i + j and then the smaller i; the traceback prefers the
diagonal, then E, then F, and an extension over an opening, as BLAST's
tabular output of Lambda describes its alignments.

``sat8`` computes every value in saturating 8-bit arithmetic ([-128,
127]): the control, the precision below the exact integers that the
configuration states.
"""

from __future__ import annotations

import numpy as np
import torch

from .tables import AA, BLOSUM62, GAP_EXTEND, GAP_OPEN

GF = -(GAP_OPEN + GAP_EXTEND)      # a gap's first residue
GE = -GAP_EXTEND                   # each further residue
NEG = -(1 << 24)
PAD = len(AA)                      # padding letter, scoring PAD_SCORE
PAD_SCORE = -1000


def _matrix(device) -> torch.Tensor:
    m = np.full((PAD + 1, PAD + 1), PAD_SCORE, dtype=np.int32)
    m[:PAD, :PAD] = BLOSUM62
    return torch.as_tensor(m, device=device)


def _groups(pairs, cell_budget: int, max_batch: int):
    order = sorted(range(len(pairs)),
                   key=lambda k: (len(pairs[k][0]), len(pairs[k][1])))
    group: list = []
    mm = nn = 0
    for k in order:
        m, n = len(pairs[k][0]), len(pairs[k][1])
        m2, n2 = max(mm, m), max(nn, n)
        if group and ((len(group) + 1) * (m2 + 1) * (n2 + 1) > cell_budget
                      or len(group) == max_batch):
            yield group
            group, m2, n2 = [], m, n
        group.append(k)
        mm, nn = m2, n2
    if group:
        yield group


def _sweep(q: torch.Tensor, s: torch.Tensor, qlen, slen, mat, sat8: bool):
    """DP of one batch: (codes (B, M+1, N+1) uint8, best, bi, bj)."""
    B, M = q.shape
    N = s.shape[1]
    dev = q.device
    lo, hi = (-128, 127) if sat8 else (NEG, 1 << 30)
    codes = torch.zeros((B, M + 1, N + 1), dtype=torch.uint8, device=dev)
    hprev = torch.zeros((B, N + 1), dtype=torch.int32, device=dev)
    fprev = torch.full((B, N + 1), NEG, dtype=torch.int32, device=dev)
    zcol = torch.zeros((B, 1), dtype=torch.int32, device=dev)
    ncol = torch.full((B, 1), NEG, dtype=torch.int32, device=dev)
    j1 = torch.arange(1, N + 1, dtype=torch.int32, device=dev)
    j0 = torch.arange(N + 1, dtype=torch.int32, device=dev)
    col_ok = j1[None, :] <= slen[:, None]
    best = torch.zeros(B, dtype=torch.int32, device=dev)
    bi = torch.zeros(B, dtype=torch.int32, device=dev)
    bj = torch.zeros(B, dtype=torch.int32, device=dev)
    for i in range(1, M + 1):
        sub = torch.gather(mat[q[:, i - 1]], 1, s)
        diag = (hprev[:, :-1] + sub).clamp(lo, hi)
        f_ext = fprev[:, 1:] + GE
        f_opn = hprev[:, 1:] + GF
        f = torch.maximum(f_ext, f_opn).clamp(lo, hi)
        hx = torch.maximum(torch.maximum(diag, f), zcol)
        run = torch.cummax(torch.cat([zcol, hx], 1) - j0 * GE, 1).values
        e = (run[:, :-1] + GF + (j1 - 1) * GE).clamp(lo, hi)
        h = torch.maximum(hx, e)
        hsrc = torch.where(h <= 0, 0, torch.where(
            h == diag, 1, torch.where(h == e, 2, 3)))
        e_ext = torch.cat([ncol, e[:, :-1]], 1) + GE
        e_opn = torch.cat([zcol, h[:, :-1]], 1) + GF
        codes[:, i, 1:] = (hsrc | ((e_ext >= e_opn).to(torch.int64) << 2)
                           | ((f_ext >= f_opn).to(torch.int64) << 3)
                           ).to(torch.uint8)
        hm = torch.where(col_ok & (i <= qlen)[:, None], h, -1)
        rmax = hm.max(1).values
        j = (hm == rmax[:, None]).to(torch.int32).argmax(1).to(torch.int32) + 1
        upd = (rmax > best) | ((rmax == best) & (rmax > 0)
                               & (i + j < bi + bj))
        best = torch.where(upd, rmax, best)
        bi = torch.where(upd, torch.full_like(bi, i), bi)
        bj = torch.where(upd, j, bj)
        hprev = torch.cat([zcol, h], 1)
        fprev = torch.cat([ncol, f], 1)
    return codes, best, bi, bj


def _traceback(codes: np.ndarray, bi: int, bj: int, q: np.ndarray,
               s: np.ndarray) -> dict:
    i, j, state = bi, bj, "H"
    ops: list = []
    while True:
        code = int(codes[i, j]) if i + j >= 2 and i >= 0 and j >= 0 else 0
        if state == "H":
            h = code & 3
            if h == 0 or i <= 0 or j <= 0:
                break
            if h == 1:
                ops.append("M")
                i -= 1
                j -= 1
            else:
                state = "E" if h == 2 else "F"
        elif state == "E":
            ops.append("D")
            j -= 1
            state = "E" if code & 4 else "H"
        else:
            ops.append("I")
            i -= 1
            state = "F" if code & 8 else "H"
    ops.reverse()
    ident = mism = opens = 0
    a, b, prev = i, j, ""
    for op in ops:
        if op == "M":
            if q[a] == s[b]:
                ident += 1
            else:
                mism += 1
            a += 1
            b += 1
        else:
            opens += op != prev
            a += op == "I"
            b += op == "D"
        prev = op
    return dict(q0=i, q1=bi, s0=j, s1=bj, length=len(ops), ident=ident,
                mism=mism, gapopen=opens)


def local_alignments(pairs, device="cpu", sat8: bool = False,
                     cell_budget: int = 1 << 27, max_batch: int = 256):
    """The best local alignment of each (query, subject) pair of residue
    index arrays (into ``tables.AA``): a list of dicts with ``score``,
    0-based half-open ``q0, q1, s0, s1``, ``length``, ``ident``, ``mism``
    and ``gapopen`` (``score`` 0 and no coordinates where no residue pair
    scores above 0)."""
    mat = _matrix(device)
    out: list = [None] * len(pairs)
    for grp in _groups(pairs, cell_budget, max_batch):
        M = max(len(pairs[k][0]) for k in grp)
        N = max(len(pairs[k][1]) for k in grp)
        q = np.full((len(grp), max(M, 1)), PAD, dtype=np.int64)
        s = np.full((len(grp), max(N, 1)), PAD, dtype=np.int64)
        for r, k in enumerate(grp):
            q[r, :len(pairs[k][0])] = pairs[k][0]
            s[r, :len(pairs[k][1])] = pairs[k][1]
        qlen = torch.as_tensor([len(pairs[k][0]) for k in grp], device=device)
        slen = torch.as_tensor([len(pairs[k][1]) for k in grp], device=device)
        codes, best, bi, bj = _sweep(torch.as_tensor(q, device=device),
                                     torch.as_tensor(s, device=device),
                                     qlen, slen, mat, sat8)
        codes = codes.cpu().numpy()
        best, bi, bj = (t.cpu().numpy() for t in (best, bi, bj))
        for r, k in enumerate(grp):
            if best[r] <= 0:
                out[k] = dict(score=0)
                continue
            rec = _traceback(codes[r], int(bi[r]), int(bj[r]), q[r], s[r])
            rec["score"] = int(best[r])
            out[k] = rec
        del codes
    return out
