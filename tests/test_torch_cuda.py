"""Tests that need the CUDA card (marked ``cuda``; they skip elsewhere).

They import only the port, so they run on a machine without JAX:

    python -m pytest -m cuda tests/test_torch_cuda.py -q
"""

import numpy as np
import pytest
import torch

from lambda_tpu_torch.ops import (searchsorted as ss, slot_walk, sw_band,
                                  sw_rect)
from test_torch_slot_walk import CASES as WALK_CASES, WalkCase, \
    cfg_of, walk_case

GF, GE = -12, -1


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _case(seed, B, N, D, A=27):
    rng = np.random.default_rng(seed)
    subst = rng.integers(-4, 6, size=(A, A)).astype(np.int32)
    np.fill_diagonal(subst, rng.integers(4, 12, size=A))
    e8 = sw_band.extend_matrix8(subst)
    q = rng.integers(0, A, size=(B, N)).astype(np.int8)
    q[:, N - D:] = A                       # PAD past the query
    s = rng.integers(0, A, size=(B, N)).astype(np.int8)
    for b in range(0, B, 2):               # planted in-band homologs
        off = int(rng.integers(0, D + 1))
        s[b, off:] = q[b, :N - off]
    d = rng.integers(0, D + 1, size=B).astype(np.int32)
    d[0] = D
    d[3] = -1                              # a batch-padding row
    return q, s, d, e8


@pytest.mark.cuda
@pytest.mark.parametrize("D", [7, 39, 127, 1023, 2047])
def test_k1_matches_plain_version(card, D):
    """K1 (csrc/sw_band.cu) == the plain PyTorch version, exactly, and
    each call launches the kernel once."""
    args = [torch.as_tensor(x, device=card) for x in _case(D, 64, 48 + D, D)]
    before = sw_band.launches
    got = sw_band.sw_band_score_device(*args, D, GF, GE)
    assert sw_band.launches == before + 1
    want = sw_band.sw_band_score_torch(*args, D, GF, GE)
    assert torch.equal(got.cpu(), want.cpu())
    assert int(got[3]) == 0 and int(got.max()) > 0


@pytest.mark.cuda
@pytest.mark.parametrize("D", [7, 39, 127, 1023, 2047])
def test_k1_xdrop_matches_plain_version(card, D):
    """K1 with X-drop (checkpoints every 16 columns) == the plain version,
    exactly, and X-drop changes some scores."""
    args = [torch.as_tensor(x, device=card) for x in _case(D, 64, 48 + D, D)]
    exact = sw_band.sw_band_score_torch(*args, D, GF, GE)
    got = sw_band.sw_band_score_device(*args, D, GF, GE, 4, 16)
    want = sw_band.sw_band_score_torch(*args, D, GF, GE, 4, 16)
    assert torch.equal(got.cpu(), want.cpu())
    assert bool((want != exact).any())


def _with_config(monkeypatch, G, R):
    """Force the wrapper's (G, R): the band D = G * R - 1 - R // 2 leaves
    padding offsets below it in every run length but R = 1."""
    D = max(G * R - 1 - R // 2, 0)
    monkeypatch.setattr(sw_band, "warp_config",
                        lambda B, D_, dirs=False: (G, R, 1))
    return D


@pytest.mark.cuda
@pytest.mark.parametrize("G", [4, 8, 16, 32])
def test_k1_every_run_length(card, monkeypatch, G):
    """K1 == its plain version at every R the wrapper can choose, with and
    without X-drop, for each group width G."""
    for R in sw_band.R_SCORE:
        D = _with_config(monkeypatch, G, R)
        args = [torch.as_tensor(x, device=card)
                for x in _case(G * 100 + R, 37, 40 + D, D)]
        for xd, nc in ((0, 0), (6, 8)):
            got = sw_band.sw_band_score_device(*args, D, GF, GE, xd, nc)
            want = sw_band.sw_band_score_torch(*args, D, GF, GE, xd, nc)
            assert torch.equal(got.cpu(), want.cpu()), (G, R, xd)


@pytest.mark.cuda
@pytest.mark.parametrize("G", [4, 8, 16, 32])
def test_k2_every_run_length(card, monkeypatch, G):
    """K2 == its plain version (codes, scores, end cells) at every R the
    wrapper can choose for K2, for each group width G."""
    for R in sw_band.R_DIRS:
        D = _with_config(monkeypatch, G, R)
        args = [torch.as_tensor(x, device=card)
                for x in _case(G * 100 + R, 37, 40 + D, D)]
        got = sw_band.sw_band_align_device(*args, D, GF, GE)
        want = sw_band.sw_band_align_torch(*args, D, GF, GE)
        for g, w in zip(got, want):
            assert torch.equal(g.cpu(), w.cpu()), (G, R)


@pytest.mark.cuda
def test_k1_refuses_wrong_dtype(card):
    q, s, d, e8 = (torch.as_tensor(x, device=card)
                   for x in _case(1, 8, 20, 7))
    with pytest.raises(ValueError):
        sw_band.sw_band_score_device(q.to(torch.int32), s, d, e8, 7, GF, GE)


@pytest.mark.cuda
@pytest.mark.parametrize("D", [7, 39, 127, 1023, 2047])
def test_k2_matches_plain_version(card, D):
    """K2 (csrc/sw_band_dirs.cu) == the plain PyTorch version: the codes
    of every cell, the best scores and the end cells, exactly; one launch
    per call."""
    args = [torch.as_tensor(x, device=card) for x in _case(D, 64, 48 + D, D)]
    before = sw_band.launches_dirs
    got = sw_band.sw_band_align_device(*args, D, GF, GE)
    assert sw_band.launches_dirs == before + 1
    want = sw_band.sw_band_align_torch(*args, D, GF, GE)
    for g, w in zip(got, want):
        assert torch.equal(g.cpu(), w.cpu())
    assert int(got[1][3]) == 0 and int(got[1].max()) > 0


@pytest.mark.cuda
@pytest.mark.parametrize("D", [0, 7, 39, 127, 1023, 3000])
def test_k3_matches_plain_version(card, monkeypatch, D):
    """K3 (csrc/sw_band_sub.cu, LAMBDA_SWB_LAYOUT=sublane) == the plain
    version of K1, exactly; one launch per call; D above the widest band
    bucket takes the global-scratch path."""
    monkeypatch.setattr(sw_band, "_LAYOUT", "sublane")
    args = [torch.as_tensor(x, device=card) for x in _case(D, 40, 30 + D, D)]
    before = sw_band.launches_sub, sw_band.launches
    got = sw_band.sw_band_score_device(*args, D, GF, GE)
    assert (sw_band.launches_sub, sw_band.launches) == \
        (before[0] + 1, before[1])
    want = sw_band.sw_band_score_torch(*args, D, GF, GE)
    assert torch.equal(got.cpu(), want.cpu())
    assert int(got[3]) == 0


@pytest.mark.cuda
@pytest.mark.parametrize("WP,S", [(8, 1), (16, 1), (24, 1), (32, 1), (40, 1),
                                  (48, 1), (56, 1), (64, 1), (64, 2),
                                  (64, 3)])
def test_k3_every_bucket(card, monkeypatch, WP, S):
    """K3 == the plain version, exactly, at both edges of every register
    bucket (D + 1 = WP - 7 and WP) and of the first scratch widths (65,
    128; 129, 192), with a ragged B (not a multiple of 32 or of a block)
    and padding rows among the rows."""
    monkeypatch.setattr(sw_band, "_LAYOUT", "sublane")
    lo = (S - 1) * WP + 1 if S > 1 else WP - 7
    for W in (lo, WP * S):
        assert sw_band.sub_config(77, W - 1)[:2] == (WP, S)
        q, s, d, e8 = _case(WP * S + W, 77, 41 + W, W - 1)
        d[[10, 40, 76]] = -1
        args = [torch.as_tensor(x, device=card) for x in (q, s, d, e8)]
        got = sw_band.sw_band_score_device(*args, W - 1, GF, GE)
        want = sw_band.sw_band_score_torch(*args, W - 1, GF, GE)
        assert torch.equal(got.cpu(), want.cpu()), W
        assert int(got[40]) == 0 and int(got.max()) > 0


@pytest.mark.cuda
@pytest.mark.parametrize("D", [39, 100])
def test_k3_long_window(card, monkeypatch, D):
    """A window of 333 columns, more than five staging tiles of 64, on
    rows whose starts are not 16-byte aligned; K3 == the plain version."""
    monkeypatch.setattr(sw_band, "_LAYOUT", "sublane")
    args = [torch.as_tensor(x, device=card) for x in _case(D, 45, 333, D)]
    got = sw_band.sw_band_score_device(*args, D, GF, GE)
    want = sw_band.sw_band_score_torch(*args, D, GF, GE)
    assert torch.equal(got.cpu(), want.cpu())


def _rect_case(seed, B, M, N, A=24):
    rng = np.random.default_rng(seed)
    subst = rng.integers(-4, 6, size=(A, A)).astype(np.int32)
    np.fill_diagonal(subst, rng.integers(4, 12, size=A))
    e8 = sw_band.extend_matrix8(subst)
    q = rng.integers(0, A, size=(B, M)).astype(np.int8)
    s = rng.integers(0, A, size=(B, N)).astype(np.int8)
    n = min(M, N)
    s[::2, :n] = q[::2, :n]
    q[1, M // 2:] = A                      # trailing PAD
    return q, s, e8


@pytest.mark.cuda
@pytest.mark.parametrize("M,N", [(1, 9), (20, 31), (128, 300), (129, 200),
                                 (256, 100), (257, 333), (512, 700),
                                 (700, 900), (1000, 150), (4097, 50),
                                 (8193, 40), (16384, 64)])
def test_k4_matches_plain_version(card, M, N):
    """K4 (csrc/sw_rect.cu) == its plain PyTorch version, exactly; one
    launch per call.  The wrapper's (R, W) take one strip (M up to 128),
    two (129: just above a strip; 256), more with a ragged top strip
    (257, 700, 1000, 4097, 8193) or full ones (512), up to 16 strips at
    M_MAX."""
    args = [torch.as_tensor(x, device=card)
            for x in _rect_case(M, 12, M, N)]
    before = sw_rect.launches
    got = sw_rect.sw_score_device(*args, GF, GE)
    assert sw_rect.launches == before + 1
    want = sw_rect.sw_score_torch(*args, GF, GE)
    assert torch.equal(got.cpu(), want.cpu())


@pytest.mark.cuda
def test_k4_empty_query_launches_nothing(card):
    """M 0: zeros from the host entry and the device entry, no launch."""
    q, s, e8 = _rect_case(5, 3, 4, 10)
    before = sw_rect.launches
    host = sw_rect.sw_score(q[:, :0], s, e8, GF, GE, device="cuda")
    dev = sw_rect.sw_score_device(
        *(torch.as_tensor(np.ascontiguousarray(x), device=card)
          for x in (q[:, :0], s, e8)), GF, GE)
    assert sw_rect.launches == before
    assert list(host) == [0, 0, 0] and dev.is_cuda
    assert torch.equal(dev.cpu(), torch.zeros(3, dtype=torch.int32))


@pytest.mark.cuda
@pytest.mark.parametrize("R", [1, 2, 4, 8, 16, 32])
def test_k4_every_run_length(card, monkeypatch, R):
    """K4 == its plain version at every run length the wrapper can pick,
    forced with one ragged strip (four alignments per block), two strips
    (M just above one strip, two alignments per block) and three strips
    with a ragged top; windows longer than the strips' ring."""
    assert R in sw_rect.R_RECT
    strip = 32 * R
    for M, W, P in ((strip - 3, 1, 4), (strip + 1, 2, 2),
                    (2 * strip + 5, 3, 1)):
        monkeypatch.setattr(sw_rect, "rect_config",
                            lambda B, M_, W=W, P=P: (R, W, P))
        args = [torch.as_tensor(x, device=card)
                for x in _rect_case(R * 100 + W, 13, M, 150)]
        got = sw_rect.sw_score_device(*args, GF, GE)
        want = sw_rect.sw_score_torch(*args, GF, GE)
        assert torch.equal(got.cpu(), want.cpu()), (R, M, W, P)


@pytest.mark.cuda
def test_k2_k3_k4_refuse_wrong_dtype(card, monkeypatch):
    q, s, d, e8 = (torch.as_tensor(x, device=card)
                   for x in _case(1, 8, 20, 7))
    with pytest.raises(ValueError):
        sw_band.sw_band_align_device(q, s, d.to(torch.int64), e8, 7, GF, GE)
    monkeypatch.setattr(sw_band, "_LAYOUT", "sublane")
    with pytest.raises(ValueError):
        sw_band.sw_band_score_device(q.to(torch.int32), s, d, e8, 7, GF, GE)
    with pytest.raises(ValueError):
        sw_rect.sw_score_device(q, s.to(torch.int32), e8, GF, GE)


@pytest.mark.cuda
@pytest.mark.parametrize("D", [7, 23, 39, 127])
def test_k1_k2_k3_at_dna_width(card, monkeypatch, D):
    """K1, K2 and K3 == their plain versions at C 6 (DNA5 + PAD, the
    BLASTN and bisulfite matrices), each launched once per call."""
    args = [torch.as_tensor(x, device=card)
            for x in _case(D + 5, 64, 60 + D, D, A=5)]
    assert args[3].shape == (6, 6)
    want = sw_band.sw_band_score_torch(*args, D, GF, GE)
    before = (sw_band.launches, sw_band.launches_dirs, sw_band.launches_sub)
    assert torch.equal(sw_band.sw_band_score_device(*args, D, GF, GE).cpu(),
                       want.cpu())
    for g, w in zip(sw_band.sw_band_align_device(*args, D, GF, GE),
                    sw_band.sw_band_align_torch(*args, D, GF, GE)):
        assert torch.equal(g.cpu(), w.cpu())
    monkeypatch.setattr(sw_band, "_LAYOUT", "sublane")
    assert torch.equal(sw_band.sw_band_score_device(*args, D, GF, GE).cpu(),
                       want.cpu())
    assert (sw_band.launches, sw_band.launches_dirs, sw_band.launches_sub) \
        == tuple(b + 1 for b in before)
    assert int(want.max()) > 0


def _bisulfite_batch(dev):
    """Bisulfite extension inputs on ``dev``: 12 subject frames (even
    forward, odd reverse), 16 converted query frames with one seed hit
    each, widened and merged; the forward and reverse int8 matrices."""
    from lambda_tpu_torch import scoring
    from lambda_tpu_torch.search import extend

    rng = np.random.default_rng(61)
    frames = [rng.integers(0, 4, int(rng.integers(150, 260))).astype(np.uint8)
              for _ in range(12)]
    offsets = np.zeros(13, np.int64)
    offsets[1:] = np.cumsum([len(f) for f in frames])
    tq = np.zeros((16, 96), np.int8)
    mk = {k: [] for k in ("qry_id", "subj_id", "qry_start", "qry_end",
                          "subj_start", "subj_end")}
    for g in range(16):
        sid = g % 12
        st = int(rng.integers(0, len(frames[sid]) - 90))
        q = frames[sid][st:st + 80].copy()
        conv = (1, 3) if sid % 2 == 0 else (2, 0)
        q[(q == conv[0]) & (rng.random(80) < 0.8)] = conv[1]
        tq[g, :80] = q
        for k, v in zip(mk, (g, sid, 20, 32, st + 20, st + 32)):
            mk[k].append(v)
    m = extend.widen_and_merge(
        extend.MatchBatch(**{k: np.asarray(v, np.int64)
                             for k, v in mk.items()}),
        np.full(16, 80, np.int64), offsets[1:] - offsets[:-1])
    resident = tuple(torch.as_tensor(x, device=dev) for x in (
        tq, np.concatenate(frames).astype(np.int8), offsets[:-1],
        offsets[1:] - offsets[:-1]))
    ext = [sw_band.extend_matrix(scoring.make_bisulfite_scheme(
        2, -3, -5, -2, d).matrix) for d in ("fwd", "rev")]
    return extend, m, resident, ext


@pytest.mark.cuda
def test_bisulfite_classes_on_the_card(card, monkeypatch):
    """Bisulfite pass 1 (K1, then K3) and pass 2 (K2): one launch per
    (qlen, band, matrix) class, the odd subject frames' classes with the
    reverse matrix; the card's scores and traces equal the CPU's."""
    extend, m, res_cpu, ext = _bisulfite_batch("cpu")
    _, _, res_card, _ = _bisulfite_batch(card)
    e8 = [sw_band.ext8_from_ext32(e) for e in ext]
    classes = extend.bucket_groups(*extend._ext_geometry(m)[:2],
                                   m.subj_id % 2 == 1)
    assert {r for _, _, r in classes} == {False, True}
    want = extend.sw_scores_device(m, *res_cpu, *e8, GF, GE, True)
    for layout, counter in (("lane", "launches"), ("sublane", "launches_sub")):
        monkeypatch.setattr(sw_band, "_LAYOUT", layout)
        before = getattr(sw_band, counter)
        got = extend.sw_scores_device(m, *res_card, *e8, GF, GE, True)
        assert getattr(sw_band, counter) == before + len(classes)
        np.testing.assert_array_equal(got, want)
    assert (want > 0).sum() >= 12
    before = sw_band.launches_dirs
    sc, tr = extend._trace_device(m, res_card, *ext, GF, GE, True)
    assert sw_band.launches_dirs == before + len(classes)
    sc_cpu, tr_cpu = extend._trace_device(m, res_cpu, *ext, GF, GE, True)
    np.testing.assert_array_equal(sc, sc_cpu)
    assert tr == tr_cpu


def _packed(chars, lens, bits, cpw, words):
    """Strings of ranks packed as the index packs its keys: rank + 1,
    MSB-first, left-aligned, 0 past ``lens``."""
    out = np.zeros((len(chars), words), np.int64)
    for j in range(min(chars.shape[1], cpw * words)):
        v = np.where(j < lens, chars[:, j] + 1, 0)
        out[:, j // cpw] += v << (32 - ((j % cpw) + 1) * bits)
    return out


def _search_case(seed, words, n=3000, P=20000):
    """Sorted keys of ``words`` words (3 bits a character) drawn from a
    small pool of strings, so that rows repeat heavily, one in five cut
    short; targets: prefixes of key strings, random strings, strings
    below the first key (0) and past the last (all ones), cut at every
    length."""
    rng = np.random.default_rng(seed)
    bits, cpw = 3, 10
    L = cpw * words
    pool = rng.integers(0, 6, (P // 40, L))
    kch = pool[rng.integers(0, len(pool), P)]
    klen = np.where(rng.random(P) < 0.2, rng.integers(0, L + 1, P), L)
    keys = _packed(kch, klen, bits, cpw, words)
    keys = keys[np.lexsort(tuple(keys[:, w] for w in reversed(range(words))))]
    ch = kch[rng.integers(0, P, n)]
    rnd = rng.random(n) < 0.3
    ch[rnd] = rng.integers(0, 6, (int(rnd.sum()), L))
    lens = rng.integers(0, L + 1, n)
    tgt = _packed(ch, lens, bits, cpw, words)
    tgt[:40] = 0
    tgt[40:80] = 0xFFFFFFFF
    masks = ss.length_masks(torch.as_tensor(lens), bits, cpw, words).numpy()
    return rng, keys, tgt & masks, masks, ch, bits, cpw


@pytest.mark.cuda
@pytest.mark.parametrize("words", [1, 2, 4, 5])
@pytest.mark.parametrize("bucketed", [False, True])
def test_search_range_kernel_matches_plain_version(card, words, bucketed):
    """csrc/searchsorted.cu's range search == search_range_torch, exactly,
    at 1, 2 and 4 words and 5 (the loop over words): full searches, random
    initial ranges (empty, inverted, outside the array), with and without
    the prefix table and a validity mask; one launch per call, and the
    skipped counter counts the invalid rows."""
    rng, keys, tgt, masks, _, bits, _ = _search_case(words, words)
    n, P = len(tgt), len(keys)
    a, b = rng.integers(-3, P + 3, (2, n))
    extra = {}
    if bucketed:
        m = 2
        extra = dict(bucket=torch.as_tensor(ss.prefix_table(
            keys[:, 0].astype(np.uint32), bits, m)).to(torch.int64),
            bucket_shift=32 - bits * m)
    valid = rng.random(n) < 0.7
    cases = [(None, None, None),
             (np.minimum(a, b).clip(0, P), np.maximum(a, b).clip(0, P), None),
             (a.clip(0, P), b.clip(0, P), valid),
             (a, b, valid)]
    found = None
    for lo0, hi0, ok in cases:
        def on(dev):
            def t(x):
                return None if x is None else torch.as_tensor(x, device=dev)
            kw = {k: v.to(dev) if torch.is_tensor(v) else v
                  for k, v in extra.items()}
            sk = torch.zeros(1, dtype=torch.int64, device=dev)
            return (*ss.search_range(t(keys), t(tgt), t(masks), t(lo0),
                                     t(hi0), valid=t(ok), skipped=sk, **kw),
                    sk)
        want = on("cpu")
        before = ss.launches
        got = on(card)
        assert ss.launches == before + 1
        for g, w in zip(got, want):
            assert torch.equal(g.cpu(), w), (lo0 is None, ok is None)
        if ok is not None:
            assert int(got[2]) == int((~valid).sum()) > 0
            assert bool((got[1] == got[0]).cpu()[torch.as_tensor(~valid)]
                        .all())
        if found is None:
            found = int((want[1] - want[0]).sum())
    assert found > n


@pytest.mark.cuda
@pytest.mark.parametrize("words", [1, 2, 4, 5])
def test_count_curves_kernel_matches_plain_version(card, words):
    """csrc/searchsorted.cu's curve search == count_curves_torch (the
    per-step loop of search_range_torch), exactly, for cursors found at
    a seed length and extended by their strings' next characters up to
    the key's capacity (words past it appended nowhere); one launch."""
    _, keys, _, _, ch, bits, cpw = _search_case(10 + words, words)
    k = 5
    E = cpw * words - k
    tgt = _packed(ch[:, :k], np.full(len(ch), k), bits, cpw, words)
    masks = ss.length_masks(torch.full((len(ch),), k), bits, cpw, words)
    lo, hi = ss.search_range_torch(torch.as_tensor(keys),
                                   torch.as_tensor(tgt), masks)
    live = hi > lo
    plan = ss.curve_plan(k, E + 2, bits, cpw, words)
    nxt = torch.as_tensor(np.concatenate([ch[:, k:], ch[:, :2]], axis=1))
    args = [torch.as_tensor(keys), torch.as_tensor(tgt)[live], lo[live],
            (hi - lo)[live], nxt[live].contiguous(), plan]
    want = ss.count_curves_torch(*args)
    before = ss.launches
    got = ss.count_curves(*(torch.as_tensor(x, device=card) for x in args))
    assert ss.launches == before + 1
    for g, w in zip(got, want):
        assert torch.equal(g.cpu(), w)
    assert int((want[1][:, E] > 0).sum()) > 0


@pytest.mark.cuda
def test_seeding_on_the_card_counts_and_skips_as_on_the_cpu(card, tmp_path):
    """A BLASTP search of 20 planted and 8 random proteins on the card:
    the m8 is the CPU's to the byte, every seeding search launches the
    kernel, and seed_search_rows / seed_search_skipped equal the CPU's,
    where the plain version counts the invalid rows itself."""
    from lambda_tpu_torch import cli, options
    from lambda_tpu_torch.io import fasta
    from lambda_tpu_torch.search import pipeline

    rng = np.random.default_rng(21)
    letters = np.frombuffer(b"ARNDCQEGHILKMFPSTWYV", np.uint8)
    db = letters[rng.integers(0, 20, (60, 300))]
    fasta.write_fasta(tmp_path / "db.fasta", [
        fasta.SeqRecord(f"s{i}", r.tobytes()) for i, r in enumerate(db)])
    qs = []
    for i in range(20):
        q = db[i * 3, 40:200].copy()
        q[rng.integers(0, len(q), 8)] = letters[rng.integers(0, 20, 8)]
        qs.append(fasta.SeqRecord(f"q{i}", q.tobytes()))
    qs += [fasta.SeqRecord(f"r{i}", letters[rng.integers(0, 20, 150)]
                           .tobytes()) for i in range(8)]
    fasta.write_fasta(tmp_path / "q.fasta", qs)
    assert cli.main(["mkindexp", "-d", str(tmp_path / "db.fasta"), "-i",
                     str(tmp_path / "db.lit"), "-v", "0"]) == 0
    out, st = {}, {}
    for dev in ("cpu", "cuda"):
        opt = options.make_search_options(
            options.Domain.PROTEIN, query_file=str(tmp_path / "q.fasta"),
            index_file=str(tmp_path / "db.lit"),
            output=str(tmp_path / f"{dev}.m8"), verbosity=0,
            query_batch_size=8)
        before = ss.launches
        st[dev] = pipeline.run_search(opt, device=dev)
        launched = ss.launches - before
        out[dev] = (tmp_path / f"{dev}.m8").read_bytes()
    assert launched > 0 and st["cpu"].hits_final > 0
    assert out["cuda"] == out["cpu"]
    assert st["cuda"].seed_search_rows == st["cpu"].seed_search_rows > 0
    assert 0 < st["cuda"].seed_search_skipped \
        == st["cpu"].seed_search_skipped < st["cpu"].seed_search_rows


@pytest.mark.cuda
def test_searchsorted_refuses_wrong_dtype_or_device(card):
    _, keys, tgt, masks, _, _, _ = _search_case(1, 2, n=64, P=256)
    k, t, m = (torch.as_tensor(x, device=card) for x in (keys, tgt, masks))
    for bad in (dict(keys=k.to(torch.int32)), dict(targets=t.cpu()),
                dict(masks=m[:, :1].contiguous()),
                dict(valid=torch.ones(64, dtype=torch.int32, device=card)),
                dict(bucket=torch.zeros(9, dtype=torch.int32, device=card),
                     bucket_shift=29)):
        kw = dict(keys=k, targets=t, masks=m) | bad
        with pytest.raises(ValueError):
            ss.search_range(**kw)
    plan = ss.curve_plan(3, 4, 3, 10, 2).to(card)
    nxt = torch.zeros((64, 4), dtype=torch.int64, device=card)
    lo = torch.zeros(64, dtype=torch.int64, device=card)
    with pytest.raises(ValueError):
        ss.count_curves(k, t, lo, lo, nxt.to(torch.int8), plan)
    with pytest.raises(ValueError):
        ss.count_curves(k, t, lo, lo, nxt, plan.cpu())


@pytest.mark.cuda
def test_db_shards4_on_four_cards_is_byte_equal_to_one_card(card, tmp_path):
    """``searchp --db-shards 4`` with shard k resident on cuda:k, through
    run_search on one resident context, writes the bytes of the one-card
    search of the same index (a database of families from the
    benchmark's generator, built as four shards; 1,024 proteins in two
    batches), every hand-written launch running on its own card; the
    card clocks and the fullest card's memory are recorded."""
    import dataclasses

    from benchmark.harness import generate
    from lambda_tpu_torch import cli
    from lambda_tpu_torch.search import pipeline

    if torch.cuda.device_count() < 4:
        pytest.skip("needs four CUDA cards")
    p = dict(residues=2_000_000, length_mean=360, length_sigma=0.7,
             length_min=30, length_max=4000, size_exponent=2.0, size_max=300,
             divergence_min=0.05, divergence_max=0.3,
             indels_per_residue=0.005, indel_max=3, spare_families=0.25,
             absent_families=2000)
    db = generate.make_database(2 ** 35 + 1, p)
    db.write_fasta(tmp_path / "db.fa")
    assert cli.main(["mkindexp", "--shards", "4", "-d",
                     str(tmp_path / "db.fa"), "-i", str(tmp_path / "db.lit"),
                     "-v", "0"]) == 0
    qs = generate.make_queries(generate.rng_for(2 ** 35 + 1, 2), db,
                               dict(kind="proteins", homolog_share=0.7),
                               1024)
    generate.write_queries(tmp_path / "q.fa", qs, 0)
    out, st = {}, {}
    for shards in (1, 4):
        opt = cli.search_options("searchp", [
            "-q", str(tmp_path / "q.fa"), "-i", str(tmp_path / "db.lit"),
            "-o", str(tmp_path / f"{shards}.m8"), "-v", "0"])[0]
        opt = dataclasses.replace(opt, db_shards=shards)
        ctx = pipeline.SearchContext(opt, "cuda")
        cls = pipeline.SearchContext
        pipeline.SearchContext = lambda *a, **kw: ctx
        try:
            before = (ss.launches, sw_band.launches)
            st[shards] = pipeline.run_search(opt, device="cuda")
            launched = (ss.launches - before[0], sw_band.launches - before[1])
        finally:
            pipeline.SearchContext = cls
        out[shards] = (tmp_path / f"{shards}.m8").read_bytes()
        if shards == 4:
            assert [str(d) for d in ctx.mesh_cards()] == [
                f"cuda:{k}" for k in range(4)]
            assert [str(t.device) for t in ctx.d_sh["keys"]] == [
                f"cuda:{k}" for k in range(4)]
        del ctx
    assert st[1].hits_final > 0 and all(n > 0 for n in launched)
    assert out[4] == out[1]
    four = st[4]
    assert 0 < four.dev_card_max_s < four.dev_card_sum_s
    assert 0 < four.time_mesh_reduce < four.time_seed
    assert 0 < four.time_mesh_gather
    assert four.card_mem_peak_bytes >= torch.cuda.max_memory_allocated(1) > 0
    assert st[1].dev_card_sum_s == st[1].card_mem_peak_bytes == 0


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(WALK_CASES))
def test_slot_walk_kernel_matches_plain_version(card, name):
    """csrc/slot_walk.cu == slot_walk_torch, every row, on each case of
    tests/test_torch_slot_walk.py (empty slots, E 0/1/5/7/40, one row a
    slot, counts at occ_cap and occ_cap + 1, hits0 >= max_matches, rem 0,
    a nonzero base, the frame's end inside the curve, segments of more
    than 32 rows) and two seeds; one launcher call each."""
    case = WALK_CASES[name]
    cfg = cfg_of(case)
    for seed in (3, 2147483659):
        args = walk_case(case, seed)
        want = slot_walk.slot_walk_torch(cfg, *args)
        before = slot_walk.launches
        got = slot_walk.slot_walk(cfg, *(x.to(card) for x in args))
        assert slot_walk.launches == before + 1
        assert torch.equal(got.cpu(), want), seed


@pytest.mark.cuda
@pytest.mark.parametrize("density", [0.01, 0.15])
def test_slot_walk_kernel_at_phase2_size(card, density):
    """S2 == its plain version at phase 2's sizes: 512 queries, 1,024
    slots, the variant table of seed length 11 at one substitution (V
    rows a slot and query at most), curves of 22 counts; up to the
    seeder's 4,096 walked cursors a slot."""
    from lambda_tpu_torch.ops import kmer

    V = len(kmer.variant_table(11, 1, 10, True)[0])
    case = WalkCase(T=1024, Q=512, V=V, E=21, density=density,
                    hits0_max=1)
    cfg = cfg_of(case)
    args = walk_case(case, 2147483659)
    dev_args = [x.to(card) for x in args]
    want = slot_walk.slot_walk_torch(cfg, *dev_args)
    got = slot_walk.slot_walk(cfg, *dev_args)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    assert int((want > 0).sum()) > 0


@pytest.mark.cuda
def test_slot_walk_refuses_wrong_dtype_or_device(card):
    case = WALK_CASES["E5"]
    cfg = cfg_of(case)
    args = [x.to(card) for x in walk_case(case, 1)]
    for i, bad in ((0, args[0].to(torch.int32)), (1, args[1].cpu()),
                   (6, args[6].t()), (5, args[5][:-1])):
        with pytest.raises(ValueError):
            slot_walk.slot_walk(cfg, *args[:i], bad, *args[i + 1:])


SEEDER_PATHS = [(1, 1), (1, 2), (2, 1), (2, 2)]


@pytest.mark.cuda
@pytest.mark.parametrize("delta,stream", SEEDER_PATHS,
                         ids=["resident", "stream_decide", "pigeon",
                              "pigeon_stream"])
def test_seeders_walk_on_the_card_as_on_the_cpu(card, tmp_path, delta,
                                                stream):
    """The resident seeder, the stream decide (--db-stream 2) and
    pigeonhole (--seed-delta 2, resident and streamed): every batch's
    packed rows and stats vector of both phases' seeding on the card equal
    the CPU's, and the card's walks launch S2."""
    from lambda_tpu_torch import alphabets as ab, cli, options
    from lambda_tpu_torch.io import fasta
    from lambda_tpu_torch.search import pipeline
    from lambda_tpu_torch.stats import StatsHolder

    rng = np.random.default_rng(22)
    letters = np.frombuffer(b"ARNDCQEGHILKMFPSTWYV", np.uint8)
    db = letters[rng.integers(0, 20, (60, 300))]
    fasta.write_fasta(tmp_path / "db.fasta", [
        fasta.SeqRecord(f"s{i}", r.tobytes()) for i, r in enumerate(db)])
    qs = []
    for i in range(20):
        q = db[i * 3, 40:220].copy()
        q[rng.integers(0, len(q), 8)] = letters[rng.integers(0, 20, 8)]
        qs.append(fasta.SeqRecord(f"q{i}", q.tobytes()))
    qs += [fasta.SeqRecord(f"r{i}", letters[rng.integers(0, 20, 150)]
                           .tobytes()) for i in range(8)]
    fasta.write_fasta(tmp_path / "q.fasta", qs)
    assert cli.main(["mkindexp", "-d", str(tmp_path / "db.fasta"), "-i",
                     str(tmp_path / "db.lit"), "-v", "0"]) == 0
    outs, walked = {}, {}
    for dev in ("cpu", "cuda"):
        opt = options.make_search_options(
            options.Domain.PROTEIN, query_file=str(tmp_path / "q.fasta"),
            index_file=str(tmp_path / "db.lit"),
            output=str(tmp_path / f"{dev}.m8"), verbosity=0)
        opt.db_stream = stream
        opt.search_opts.max_seed_dist = delta
        ctx = pipeline.SearchContext(opt, dev)
        seqs = [ab.encode(r.seq, ctx.qry_orig_alph)
                for r in fasta.read_fasta(str(tmp_path / "q.fasta"))]
        before = slot_walk.launches
        st = StatsHolder()
        outs[dev] = []
        for so in (opt.search_opts0, opt.search_opts):
            for i in range(0, len(seqs), 8):
                sd = ctx.dispatch_seeding(seqs[i:i + 8], so, st)
                for r in (sd.stream_outs if stream > 1 else [sd.res2]):
                    outs[dev].append([r[k].cpu() for k in
                                      ("packed", "stats_vec")])
        walked[dev] = (slot_walk.launches - before, st.seed_walk_rows)
        del ctx
    assert walked["cpu"][0] == 0 and walked["cuda"][0] > 0
    assert walked["cuda"][1] == walked["cpu"][1] > 0
    assert len(outs["cuda"]) == len(outs["cpu"]) > 0
    assert any(int(sv[4]) > 0 for _, sv in outs["cpu"])
    for (pc, sc), (pg, sg) in zip(outs["cpu"], outs["cuda"]):
        assert torch.equal(sg, sc)
        assert torch.equal(pg, pc)
