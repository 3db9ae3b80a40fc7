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


@pytest.mark.parametrize("bucketed,pad_rows", [(False, 0), (True, 0),
                                               (True, 13)])
def test_search_range_matches_jax(bucketed, pad_rows):
    """(lo, hi) equal the JAX search for mixed prefix lengths (shorter than
    the bucket prefix, equal, longer, full capacity), with and without
    the prefix table, and on keys padded with 0xFFFFFFFF rows."""
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
    steps = js.steps_for(n)
    extra = (jnp.asarray(table), 32 - bits * m) if bucketed else ()
    jlo, jhi = js.search_range(jnp.asarray(keys), jt, jm,
                               jnp.zeros(len(lens), jnp.int32),
                               jnp.full(len(lens), n, jnp.int32), steps,
                               *extra)
    textra = (torch.as_tensor(table).long(), 32 - bits * m) \
        if bucketed else ()
    tlo, thi = ts.search_range(torch.as_tensor(keys.astype(np.int64)), tt, tm,
                               torch.zeros(len(lens), dtype=torch.int64),
                               torch.full((len(lens),), n), steps, *textra)
    np.testing.assert_array_equal(tlo.numpy(), np.asarray(jlo))
    np.testing.assert_array_equal(thi.numpy(), np.asarray(jhi))
    assert (thi - tlo).sum() > 0, "fixture found no occurrences"


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
