"""The port's index search and k-mer packing (torch, int64 keys) against the
JAX ops on small built indexes; mirrors tests/test_ops.py:32-157."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from lambda_tpu import frames as fr
from lambda_tpu.index import build as ib
from lambda_tpu.ops import kmer as jk, searchsorted as js
from lambda_tpu_torch.ops import kmer as tk, searchsorted as ts


def _make_index(seed=0, alph=4, sizes=(60, 40, 80)):
    rng = np.random.default_rng(seed)
    seqs = [rng.integers(0, alph, size=n).astype(np.uint8) for n in sizes]
    concat, offsets, _ = fr.concat_frames(seqs)
    return seqs, concat, offsets, ib.build_kmer_index(concat, offsets, alph)


def _targets(rng, idx, concat, lens):
    rows = []
    for L in lens:
        chars = np.zeros(idx.capacity, np.int32)
        if rng.random() < 0.6:
            p = int(idx.pos[int(rng.integers(0, idx.num_positions))])
            w = concat[p:p + L]
            chars[:len(w)] = w
        else:
            chars[:] = rng.integers(0, idx.alphabet_size, idx.capacity)
        rows.append(chars)
    return np.stack(rows), np.asarray(lens, np.int32)


def _search_case(bucketed, pad_rows):
    """Keys (padded with 0xFFFFFFFF rows), targets of mixed prefix lengths
    (shorter than the bucket prefix, equal, longer, full capacity) packed
    by both packages, and the prefix table where ``bucketed``."""
    rng = np.random.default_rng(11 + pad_rows)
    _, concat, _, idx = _make_index(seed=20 + pad_rows, sizes=(300, 200, 150))
    keys = idx.keys
    if pad_rows:
        keys = np.concatenate([keys, np.full((pad_rows, idx.words),
                                             0xFFFFFFFF, np.uint32)])
    n = len(keys)
    m = js.pick_bucket_m(idx.bits, idx.chars_per_word, n)
    assert ts.pick_bucket_m(idx.bits, idx.chars_per_word, n) == m
    table = js.prefix_table(keys[:, 0], idx.bits, m)
    np.testing.assert_array_equal(
        ts.prefix_table(keys[:, 0], idx.bits, m), table)
    chars, lens = _targets(rng, idx, concat,
                           [L for L in (max(1, m - 1), m, m + 3,
                                        min(idx.capacity, 12))
                            for _ in range(8)])
    bits, cpw, words = idx.bits, idx.chars_per_word, idx.words
    jt = jk.pack_prefix(jnp.asarray(chars), jnp.asarray(lens), bits, cpw,
                        words)
    jm = js.length_masks(jnp.asarray(lens), bits, cpw, words)
    tt = tk.pack_prefix(torch.as_tensor(chars), torch.as_tensor(lens), bits,
                        cpw, words)
    tm = ts.length_masks(torch.as_tensor(lens), bits, cpw, words)
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt).astype(np.int64))
    np.testing.assert_array_equal(tm.numpy(), np.asarray(jm).astype(np.int64))
    extra = (jnp.asarray(table), 32 - bits * m) if bucketed else ()
    textra = (torch.as_tensor(table).long(), 32 - bits * m) \
        if bucketed else ()
    return keys, lens, jt, jm, tt, tm, extra, textra


@pytest.mark.parametrize("bucketed,pad_rows", [(False, 0), (True, 0),
                                               (True, 13)])
def test_search_range_matches_jax(bucketed, pad_rows):
    """(lo, hi) equal the JAX search for mixed prefix lengths (shorter than
    the bucket prefix, equal, longer, full capacity), with and without
    the prefix table, and on keys padded with 0xFFFFFFFF rows."""
    keys, lens, jt, jm, tt, tm, extra, textra = _search_case(bucketed,
                                                             pad_rows)
    n = len(keys)
    steps = js.steps_for(n)
    jlo, jhi = js.search_range(jnp.asarray(keys), jt, jm,
                               jnp.zeros(len(lens), jnp.int32),
                               jnp.full(len(lens), n, jnp.int32), steps,
                               *extra)
    tlo, thi = ts.search_range(torch.as_tensor(keys.astype(np.int64)), tt, tm,
                               torch.zeros(len(lens), dtype=torch.int64),
                               torch.full((len(lens),), n), *textra)
    np.testing.assert_array_equal(tlo.numpy(), np.asarray(jlo))
    np.testing.assert_array_equal(thi.numpy(), np.asarray(jhi))
    assert (thi - tlo).sum() > 0, "fixture found no occurrences"


@pytest.mark.parametrize("bucketed,pad_rows", [(False, 0), (True, 0),
                                               (True, 13)])
def test_search_range_own_bound_equals_fixed_steps(bucketed, pad_rows):
    """The plain version bounds the bisection by the largest initial
    range (after the prefix table) and gives the JAX search's result at
    the fixed step count ``steps_for(P)``, on full and on narrowed initial
    ranges; None for lo0/hi0 is the full search."""
    keys, lens, jt, jm, tt, tm, extra, textra = _search_case(bucketed,
                                                             pad_rows)
    k = torch.as_tensor(keys.astype(np.int64))
    n, N = len(keys), len(lens)

    def fixed(lo0, hi0):
        jlo, jhi = js.search_range(jnp.asarray(keys), jt, jm,
                                   jnp.asarray(lo0, jnp.int32),
                                   jnp.asarray(hi0, jnp.int32),
                                   js.steps_for(n), *extra)
        return (torch.from_numpy(np.array(jlo, np.int64)),
                torch.from_numpy(np.array(jhi, np.int64)))

    full = fixed(np.zeros(N), np.full(N, n))
    for got in (ts.search_range(k, tt, tm, None, None, *textra),
                ts.search_range_torch(k, tt, tm,
                                      torch.zeros(N, dtype=torch.int64),
                                      torch.full((N,), n), *textra)):
        assert torch.equal(got[0], full[0]) and torch.equal(got[1], full[1])
    lo0 = (full[0] - 2).clamp(min=0)
    hi0 = (full[1] + 3).clamp(max=n)
    want = fixed(lo0.numpy(), hi0.numpy())
    got = ts.search_range(k, tt, tm, lo0, hi0, *textra)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert torch.equal(want[0], full[0]) and torch.equal(want[1], full[1])


@pytest.mark.parametrize("bucketed,pad_rows", [(False, 0), (True, 0),
                                               (True, 13)])
def test_search_range_invalid_rows_are_empty_and_counted(bucketed,
                                                         pad_rows):
    """An invalid row answers [lo0, lo0) (count 0) and adds one to
    ``skipped``; the valid rows keep their ranges."""
    keys, lens, _, _, tt, tm, _, textra = _search_case(bucketed, pad_rows)
    k = torch.as_tensor(keys.astype(np.int64))
    N = len(lens)
    valid = torch.arange(N) % 3 != 1
    lo0 = torch.full((N,), 2, dtype=torch.int64)
    hi0 = torch.full((N,), len(keys), dtype=torch.int64)
    want = ts.search_range(k, tt, tm, lo0, hi0, *textra)
    skipped = torch.zeros(1, dtype=torch.int64)
    lo, hi = ts.search_range(k, tt, tm, lo0, hi0, *textra,
                             valid=valid, skipped=skipped)
    assert int(skipped) == int((~valid).sum()) > 0
    assert torch.equal(lo[valid], want[0][valid])
    assert torch.equal(hi[valid], want[1][valid])
    assert (lo[~valid] == 2).all() and (hi[~valid] == 2).all()
    assert (want[1] - want[0])[~valid].sum() > 0, "no skipped occurrence"


@pytest.mark.parametrize("bits,cpw,words,k", [(4, 8, 4, 10), (4, 8, 4, 11),
                                              (3, 10, 2, 7), (5, 6, 3, 4)])
def test_count_curves_plain_equals_append_char_loop(bits, cpw, words, k):
    """count_curves (on the CPU, its plain version) with ``curve_plan``
    gives the curves of the per-step loop it replaced in the seeder:
    ``kmer.append_char`` of the next character, ``length_masks`` one
    longer, a search within the last range."""
    rng = np.random.default_rng(bits * 100 + k)
    alph = min(10, (1 << bits) - 2)
    L = cpw * words
    E = L - k
    strings = rng.integers(0, alph, (40, L))
    src = strings[rng.integers(0, 40, 4000)]
    # half the rows leave their string after 2k characters
    src[:2000, 2 * k:] = rng.integers(0, alph, (2000, max(L - 2 * k, 0)))
    keys = tk.pack_prefix(torch.as_tensor(src), torch.full((4000,), L), bits,
                          cpw, words).numpy()
    keys = torch.as_tensor(
        keys[np.lexsort(tuple(keys[:, w] for w in reversed(range(words))))])
    q = torch.as_tensor(strings[rng.integers(0, 40, 64)])
    tgt = tk.pack_prefix(q[:, :k], torch.full((64,), k), bits, cpw, words)
    lo, hi = ts.search_range(keys, tgt, ts.length_masks(
        torch.full((64,), k), bits, cpw, words))
    assert (hi > lo).all()
    got = ts.count_curves(keys, tgt, lo, hi - lo, q[:, k:].contiguous(),
                          ts.curve_plan(k, E, bits, cpw, words))
    los, cnts, t, lo_c, hi_c = [lo], [hi - lo], tgt, lo, hi
    for e in range(E):
        t = tk.append_char(t, torch.full((64,), k + e), q[:, k + e], bits,
                           cpw, words)
        msk = ts.length_masks(torch.tensor(k + e + 1), bits, cpw, words)
        lo_c, hi_c = ts.search_range(keys, t, msk, lo_c, hi_c)
        los.append(lo_c)
        cnts.append(hi_c - lo_c)
    assert torch.equal(got[0], torch.stack(los, dim=1))
    assert torch.equal(got[1], torch.stack(cnts, dim=1))
    assert got[1].shape == (64, E + 1) and (got[1][:, -1] > 0).any()
    assert (got[1][:, -1] < got[1][:, 0]).any()


def test_length_masks_match_jax():
    lens = np.arange(0, 35, dtype=np.int32)
    for bits, cpw in ((4, 8), (5, 6)):
        want = np.asarray(js.length_masks(jnp.asarray(lens), bits, cpw, 4))
        got = ts.length_masks(torch.as_tensor(lens), bits, cpw, 4).numpy()
        np.testing.assert_array_equal(got, want.astype(np.int64))


def test_pack_prefix_matches_index_keys():
    _, concat, offsets, idx = _make_index(seed=3)
    cap = idx.capacity
    p = 7
    window = np.zeros(cap, dtype=np.int32)
    ln = min(int(offsets[1]) - p, cap)
    window[:ln] = concat[p:p + ln]
    t = tk.pack_prefix(torch.as_tensor(window[None, :]),
                       torch.tensor([ln]), idx.bits, idx.chars_per_word,
                       idx.words)
    row = np.where(idx.pos == p)[0][0]
    np.testing.assert_array_equal(t.numpy()[0], idx.keys[row].astype(np.int64))


def test_append_char_matches_jax():
    bits, cpw, words = 4, 8, 4
    rng = np.random.default_rng(2)
    chars = rng.integers(0, 10, size=(6, 34)).astype(np.int32)
    lens = np.array([0, 5, 8, 15, 31, 32], np.int32)
    jt = jk.pack_prefix(jnp.asarray(chars), jnp.asarray(lens), bits, cpw,
                        words)
    jt2 = jk.append_char(jt, jnp.asarray(lens),
                         jnp.asarray(chars[np.arange(6), np.minimum(lens, 33)]),
                         bits, cpw, words)
    tt = tk.pack_prefix(torch.as_tensor(chars), torch.as_tensor(lens), bits,
                        cpw, words)
    tt2 = tk.append_char(tt, torch.as_tensor(lens),
                         torch.as_tensor(chars[np.arange(6),
                                               np.minimum(lens, 33)]),
                         bits, cpw, words)
    np.testing.assert_array_equal(tt2.numpy(), np.asarray(jt2).astype(np.int64))


@pytest.mark.parametrize("k,delta,half", [(8, 0, True), (8, 1, True),
                                          (11, 1, True), (10, 1, False)])
def test_make_variants_matches_jax(k, delta, half):
    pos, rep = jk.variant_table(k, delta, 10, half)
    tpos, trep = tk.variant_table(k, delta, 10, half)
    np.testing.assert_array_equal(tpos, pos)
    np.testing.assert_array_equal(trep, rep)
    seeds = np.random.default_rng(k).integers(0, 10, (5, k)).astype(np.int32)
    jv, jok = jk.make_variants(jnp.asarray(seeds), pos, rep)
    tv, tok = tk.make_variants(torch.as_tensor(seeds), tpos, trep)
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    np.testing.assert_array_equal(tok.numpy(), np.asarray(jok))


def test_pigeonhole_delta_refused_by_variant_table_as_jax():
    """delta >= 2 is pigeonhole seeding, not enumeration: both packages
    refuse it with the same ValueError."""
    with pytest.raises(ValueError) as want:
        jk.variant_table(5, 2, 4, True)
    with pytest.raises(ValueError) as got:
        tk.variant_table(5, 2, 4, True)
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("delta", [2, 3])
def test_pigeon_chunks_match_jax(delta):
    for k in range(4, 25):
        off, ln = tk.pigeon_chunks(k, delta)
        joff, jln = jk.pigeon_chunks(k, delta)
        assert off.dtype == joff.dtype and ln.dtype == jln.dtype
        np.testing.assert_array_equal(off, joff)
        np.testing.assert_array_equal(ln, jln)
