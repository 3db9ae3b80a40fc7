"""Seed k-mer packing and approximate-seed variant enumeration (device).

Replaces the reference's FM-index seed search modes
(``lambda/src/search_algo.hpp:484-604``):

* exact seeds            -> pack the window, one binary search
* half-exact, delta<=1   -> enumerate the identity + every single-char
  substitution in the second half (the backtracking tree of
  searchHalfExactImpl enumerates exactly these distinct strings)
* full delta<=1          -> substitutions at any position
* delta >= 2             -> pigeonhole chunks (:func:`pigeon_chunks`),
  each searched exactly, verified in search/seeding.py

Variants that would duplicate the identity string (replacement equals the
original character) are masked invalid so no hit is reported twice.
Packed keys are int64 tensors holding uint32 word values (see
ops/searchsorted.py).
"""

from __future__ import annotations

import numpy as np
import torch


def pack_prefix(chars: torch.Tensor, lengths: torch.Tensor,
                bits: int, cpw: int, words: int) -> torch.Tensor:
    """Pack 0-based ranks into sorted-key format (rank+1, MSB-first,
    left-aligned, 0 past ``lengths``).

    chars: (..., Lmax) integer; lengths: (...,)  ->  (..., words) int64
    """
    Lmax = chars.shape[-1]
    out = torch.zeros(chars.shape[:-1] + (words,), dtype=torch.int64,
                      device=chars.device)
    j_valid = torch.arange(Lmax, dtype=torch.int64, device=chars.device)
    vals = torch.where(j_valid < lengths.to(torch.int64)[..., None],
                       chars.to(torch.int64) + 1, 0)
    for j in range(min(Lmax, cpw * words)):
        out[..., j // cpw] += vals[..., j] << (32 - ((j % cpw) + 1) * bits)
    return out


def append_char(targets: torch.Tensor, lengths: torch.Tensor,
                newchar: torch.Tensor, bits: int, cpw: int,
                words: int) -> torch.Tensor:
    """Append one character to packed prefixes (cursor.extendRight).

    targets: (..., words) int64; lengths: (...,) current char counts;
    newchar: (...,) 0-based ranks.  Returns new targets; positions beyond
    capacity are dropped (callers cap extension at the key capacity).
    """
    L = lengths.to(torch.int64)
    contrib = (newchar.to(torch.int64) + 1) << (32 - ((L % cpw) + 1) * bits)
    w_idx = torch.arange(words, dtype=torch.int64, device=targets.device)
    add = torch.where((w_idx == (L // cpw)[..., None])
                      & (L[..., None] < cpw * words), contrib[..., None], 0)
    return targets + add


def variant_table(k: int, delta: int, alphabet_size: int, half_exact: bool):
    """Static variant spec for <=delta substitutions.

    Returns (positions, replacements) int32 arrays of shape (V,), where
    position -1 denotes the identity variant.  Only delta<=1 is supported
    by enumeration; the caller handles delta==0 as exact search.
    """
    if delta == 0:
        return np.array([-1], dtype=np.int32), np.array([0], dtype=np.int32)
    if delta != 1:
        raise ValueError(
            f"variant enumeration only supports delta <= 1 (got {delta}); "
            "delta >= 2 uses pigeonhole seeding (see search/seeding.py)")
    start = k // 2 if half_exact else 0  # errors only in 2nd half (hpp:555)
    pos, rep = [-1], [0]
    for p in range(start, k):
        for r in range(alphabet_size):
            pos.append(p)
            rep.append(r)
    return np.array(pos, dtype=np.int32), np.array(rep, dtype=np.int32)


def make_variants(seed_chars: torch.Tensor, positions: np.ndarray,
                  replacements: np.ndarray):
    """Expand seeds (N, k) into variants (N, V, k) plus a validity mask
    (N, V).  A substitution variant is invalid when it equals the identity
    (replacement == original char)."""
    dev = seed_chars.device
    pos = torch.as_tensor(positions, dtype=torch.int64, device=dev)   # (V,)
    rep = torch.as_tensor(replacements, dtype=seed_chars.dtype, device=dev)
    k = seed_chars.shape[-1]
    j = torch.arange(k, dtype=torch.int64, device=dev)
    sel = j[None, :] == pos[:, None]                                  # (V, k)
    expanded = torch.where(sel[None, :, :], rep[None, :, None],
                           seed_chars[:, None, :])
    orig_at_pos = seed_chars[:, pos.clamp(min=0)]                     # (N, V)
    valid = (pos < 0)[None, :] | (orig_at_pos != rep[None, :])
    return expanded, valid


def pigeon_chunks(k: int, delta: int):
    """Pigeonhole partition of a k-length seed into delta+1 chunks
    (search-scheme ``pigeon_opt`` equivalent: any occurrence with <=delta
    mismatches matches at least one chunk exactly).

    Returns (offsets, lengths) int32 arrays of shape (delta+1,); longer
    chunks come first (remainder distributed to the leading chunks).
    """
    parts = delta + 1
    base = k // parts
    lens = [base + (1 if i < k % parts else 0) for i in range(parts)]
    offs = np.concatenate([[0], np.cumsum(lens)[:-1]]).astype(np.int32)
    return offs, np.array(lens, dtype=np.int32)
