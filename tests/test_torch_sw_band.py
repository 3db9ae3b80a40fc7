"""K1 (banded SW score pass): the port's plain PyTorch version against the
JAX Pallas kernel (interpret mode, small tiles, as tests/test_ops.py runs
it) and the scalar banded reference.  Scores must be exactly equal.  The
CUDA kernel itself is held against the plain version by
tests/test_torch_cuda.py (on the card) and by chip_smoke.py."""

import numpy as np
import pytest
import torch

from lambda_tpu.ops import sw_band as jsw, sw_pallas, sw_xla
from lambda_tpu_torch.ops import sw_band as tsw

GF, GE = -12, -1


@pytest.fixture
def small_tiles(monkeypatch):
    # interpret mode emulates the kernel grid in Python: tiny tiles
    monkeypatch.setattr(jsw, "_BT_CAP", 8)
    monkeypatch.setattr(jsw, "_BTL_CAP", 128)


def _case(seed, B, Mq, Ns, D, A=27):
    rng = np.random.default_rng(seed)
    subst = rng.integers(-4, 6, size=(A, A)).astype(np.int32)
    np.fill_diagonal(subst, rng.integers(4, 12, size=A))
    e8 = sw_pallas.extend_matrix8(subst)
    q = rng.integers(0, A, size=(B, Mq)).astype(np.int32)
    s = rng.integers(0, A, size=(B, Ns)).astype(np.int32)
    # half the rows carry a planted homolog on an in-band diagonal
    for b in range(0, B, 2):
        off = int(rng.integers(0, D + 1))
        n = min(Mq, Ns - off)
        s[b, off:off + n] = q[b, :n]
    d = rng.integers(0, D + 1, size=B).astype(np.int32)
    d[0] = D
    return subst, e8, q, s, d


def _reference(q, s, d, subst):
    return [0 if d[b] < 0 else
            jsw.sw_band_reference(q[b], s[b], int(d[b]), subst, GF, GE)
            for b in range(len(d))]


def test_plain_matches_jax_band_case(small_tiles):
    """tests/test_ops.py::_band_case shapes."""
    rng = np.random.default_rng(11)
    A = 27
    subst = rng.integers(-4, 6, size=(A, A)).astype(np.int32)
    np.fill_diagonal(subst, rng.integers(4, 12, size=A))
    e8 = sw_pallas.extend_matrix8(subst)
    q = rng.integers(0, A, size=(5, 40)).astype(np.int32)
    s = rng.integers(0, A, size=(5, 52)).astype(np.int32)
    d = np.array([12, 7, 3, 12, 9], dtype=np.int32)
    want = jsw.sw_band_score_pallas(q, s, d, e8, GF, GE, interpret=True)
    got = tsw.sw_band_score(q, s, d, e8, GF, GE, device="cpu")
    np.testing.assert_array_equal(got, want)
    assert list(got) == _reference(q, s, d, subst)


@pytest.mark.parametrize("D", [7, 39, 127])
@pytest.mark.parametrize("seed", [0, 1])
def test_plain_matches_jax_per_band_bucket(small_tiles, D, seed):
    """Band buckets of the extension, rows with d_row < D mixed in."""
    subst, e8, q, s, d = _case(100 * D + seed, 6, 24, 24 + D, D)
    got = tsw.sw_band_score(q, s, d, e8, GF, GE, device="cpu")
    want = jsw.sw_band_score_pallas(q, s, d, e8, GF, GE, interpret=True)
    np.testing.assert_array_equal(got, want)
    assert list(got) == _reference(q, s, d, subst)


def test_padding_rows_score_zero():
    """d_row = -1 marks batch padding: no lane is in band, score 0, and
    the other rows are unaffected."""
    subst, e8, q, s, d = _case(3, 4, 20, 35, 15)
    d_pad = d.copy()
    d_pad[1] = -1
    qp = np.full(s.shape, e8.shape[0] - 1, np.int8)
    qp[:, :q.shape[1]] = q
    dev_args = [torch.as_tensor(x) for x in (qp, s.astype(np.int8), d_pad,
                                             e8)]
    got = tsw.sw_band_score_device(*dev_args, 15, GF, GE).numpy()
    assert got[1] == 0
    want = _reference(q, s, d, subst)
    assert [got[b] for b in (0, 2, 3)] == [want[b] for b in (0, 2, 3)]


def test_query_wider_than_window(small_tiles):
    """tests/test_ops.py:341: the host entry clips a query wider than the
    window (rows past the last window column are out of band)."""
    rng = np.random.default_rng(5)
    A = 6
    subst = rng.integers(-4, 3, size=(A, A)).astype(np.int32)
    np.fill_diagonal(subst, rng.integers(2, 7, size=A))
    e8 = sw_pallas.extend_matrix8(subst)
    q = rng.integers(0, A, size=(2, 33)).astype(np.int32)
    s = rng.integers(0, A, size=(2, 12)).astype(np.int32)
    s[0, :12] = q[0, :12]
    d = np.array([3, 5], dtype=np.int32)
    got = tsw.sw_band_score(q, s, d, e8, -9, -2, device="cpu")
    want = jsw.sw_band_score_pallas(q, s, d, e8, -9, -2, interpret=True)
    np.testing.assert_array_equal(got, want)
    assert list(got) == [jsw.sw_band_reference(q[b], s[b], int(d[b]), subst,
                                               -9, -2) for b in range(2)]


def test_ext8_roundtrip_matches_jax():
    A = 5
    subst = np.arange(A * A).reshape(A, A).astype(np.int32) - 12
    ext32 = tsw.extend_matrix(subst)
    np.testing.assert_array_equal(ext32, sw_xla.extend_matrix(subst))
    e8 = tsw.ext8_from_ext32(ext32)
    np.testing.assert_array_equal(e8, sw_pallas.ext8_from_ext32(ext32))
    np.testing.assert_array_equal(e8[:A, :A], subst)
    assert (e8[A, :] == tsw.PAD_SCORE8).all()
    assert (e8[:, A] == tsw.PAD_SCORE8).all()


@pytest.mark.parametrize("D", [7, 39, 127])
def test_plain_matches_jax_sublane_kernel(monkeypatch, small_tiles, D):
    """K3: the JAX sublane-layout kernel (LAMBDA_SWB_LAYOUT=sublane) in
    interpret mode computes K1's function, so the port holds it against
    the same plain version."""
    monkeypatch.setattr(jsw, "_LAYOUT", "sublane")
    subst, e8, q, s, d = _case(300 + D, 6, 24, 24 + D, D)
    want = jsw.sw_band_score_pallas(q, s, d, e8, GF, GE, interpret=True)
    got = tsw.sw_band_score(q, s, d, e8, GF, GE, device="cpu")
    np.testing.assert_array_equal(got, want)
    assert list(got) == _reference(q, s, d, subst)


def test_sublane_layout_latch_and_x_drop(monkeypatch):
    """The layout is latched from LAMBDA_SWB_LAYOUT at import, as in the
    JAX package, and the sublane layout refuses X-drop (sw_band.py:868)."""
    import importlib
    import os

    assert tsw._LAYOUT == os.environ.get("LAMBDA_SWB_LAYOUT", "lane")
    monkeypatch.setattr(tsw, "_LAYOUT", "sublane")
    subst, e8, q, s, d = _case(4, 2, 17, 17, 7)
    args = [torch.as_tensor(x) for x in (q.astype(np.int8),
                                         s.astype(np.int8), d, e8)]
    with pytest.raises(NotImplementedError, match="lane layout"):
        tsw.sw_band_score_device(*args, 7, GF, GE, x_drop=20)
    # CPU tensors run the plain version in either layout
    np.testing.assert_array_equal(
        tsw.sw_band_score_device(*args, 7, GF, GE).numpy(),
        tsw.sw_band_score_torch(*args, 7, GF, GE).numpy())
    monkeypatch.setenv("LAMBDA_SWB_LAYOUT", "sublane")
    try:
        assert importlib.reload(tsw)._LAYOUT == "sublane"
    finally:
        monkeypatch.delenv("LAMBDA_SWB_LAYOUT")
        importlib.reload(tsw)


def _xdrop_trough(monkeypatch):
    """tests/test_ops.py:_xdrop_setup: m1 (20 matches), a deep trough (40
    mismatches), m2 (30 matches), with JAX's column chunk forced to 16."""
    monkeypatch.setattr(jsw, "_BT_CAP", 8)
    monkeypatch.setattr(jsw, "_BTL_CAP", 128)
    orig_plan = jsw._plan

    def small_nc(Ns, D, layout=None):
        N, W, BROWS, NC, JB = orig_plan(Ns, D, layout)
        return N, W, BROWS, 16, JB

    monkeypatch.setattr(jsw, "_plan", small_nc)
    monkeypatch.setattr(tsw, "plan_nc", lambda Ns, D: 16)
    A = 4
    subst = np.full((A, A), -10, dtype=np.int32)
    np.fill_diagonal(subst, 5)
    e8 = sw_pallas.extend_matrix8(subst)
    q = np.zeros((1, 90), dtype=np.int32)
    s = np.zeros((1, 90), dtype=np.int32)
    q[0, 20:60] = 1
    s[0, 20:60] = 2
    q[0, 60:90] = s[0, 60:90] = 3
    return subst, e8, q, s, np.zeros(1, dtype=np.int32)


@pytest.mark.parametrize("x_drop,want", [(16, 100), (10000, 150)])
def test_xdrop_trough_matches_jax(monkeypatch, x_drop, want):
    """LAMBDA_SW_XDROP at the op level: X 16 latches the row dead inside
    the trough (100, sw_band_xdrop_reference), a large X is exact (150),
    through the port's host API, its device entry (CPU tensors) and the
    JAX kernel in interpret mode."""
    subst, e8, q, s, d = _xdrop_trough(monkeypatch)
    monkeypatch.setattr(jsw, "_XDROP", x_drop)
    monkeypatch.setattr(tsw, "_XDROP", x_drop)
    jax_got = jsw.sw_band_score_pallas(q, s, d, e8, GF, GE, interpret=True)
    got = tsw.sw_band_score(q, s, d, e8, GF, GE, device="cpu")
    dev = tsw.sw_band_score_device(
        *(torch.as_tensor(x) for x in (q.astype(np.int8), s.astype(np.int8),
                                       d, e8)), 0, GF, GE, x_drop, 16)
    assert int(got[0]) == int(jax_got[0]) == int(dev[0]) == want \
        == jsw.sw_band_xdrop_reference(q[0], s[0], 0, subst, GF, GE,
                                       x_drop=x_drop, nc=16)


@pytest.mark.parametrize("D", [7, 39, 127])
@pytest.mark.parametrize("x_drop", [2, 5])
def test_xdrop_matches_jax_per_band_bucket(monkeypatch, D, x_drop):
    """Random rows, half with a planted homolog: the port's X-drop scores
    equal the JAX lane kernel's (interpret mode, chunk 16), and X-drop
    changes some of them."""
    subst, e8, q, s, d = _case(700 + D + x_drop, 8, 40, 40 + D, D)
    Ns = -(-(40 + D) // 16) * 16               # whole 16-column chunks
    s = np.concatenate([s, np.zeros((8, Ns - s.shape[1]), np.int32)], 1)
    _xdrop_trough(monkeypatch)
    exact = tsw.sw_band_score(q, s, d, e8, GF, GE, device="cpu")
    monkeypatch.setattr(jsw, "_XDROP", x_drop)
    monkeypatch.setattr(tsw, "_XDROP", x_drop)
    want = jsw.sw_band_score_pallas(q, s, d, e8, GF, GE, interpret=True)
    got = tsw.sw_band_score(q, s, d, e8, GF, GE, device="cpu")
    np.testing.assert_array_equal(got, want)
    assert (got != exact).any() and (got <= exact).all()


def test_xdrop_latched_at_import(monkeypatch):
    """LAMBDA_SW_XDROP is read once, when the module is imported, as in
    the JAX package (lambda_tpu/ops/sw_band.py:72); 0 when unset."""
    import importlib
    import os

    assert tsw._XDROP == int(os.environ.get("LAMBDA_SW_XDROP", "0"))
    monkeypatch.setenv("LAMBDA_SW_XDROP", "25")
    try:
        assert importlib.reload(tsw)._XDROP == 25
    finally:
        monkeypatch.delenv("LAMBDA_SW_XDROP")
        importlib.reload(tsw)
    assert tsw._XDROP == 0


def test_xdrop_needs_a_chunk():
    subst, e8, q, s, d = _case(4, 2, 17, 17, 7)
    args = [torch.as_tensor(x) for x in (q.astype(np.int8), s.astype(np.int8),
                                         d, e8)]
    with pytest.raises(ValueError, match="nc"):
        tsw.sw_band_score_device(*args, 7, GF, GE, x_drop=20)


@pytest.mark.parametrize("D", [7, 15, 23, 31, 39, 47, 63, 79, 95, 127, 159,
                               191, 255, 319, 383, 511, 767, 1023])
def test_plan_nc_matches_jax_plan(monkeypatch, D):
    """The port's copy of the lane plan's column chunk equals
    ``_plan(qbk + D, D)[3]`` for every query bucket, at the default
    LAMBDA_SWB_BT cap and a small one."""
    from lambda_tpu.search.extend import _BUCKETS

    for cap in (512, 8):
        monkeypatch.setattr(jsw, "_BT_CAP", cap)
        monkeypatch.setattr(tsw, "_BT_CAP", cap)
        for qbk in _BUCKETS:
            assert tsw.plan_nc(qbk + D, D) == \
                jsw._plan(qbk + D, D, layout="lane")[3], (qbk, D, cap)
        if cap == 512 and D == 23:
            assert tsw.plan_nc(128 + 23, 23) == 32


@pytest.mark.parametrize("B,D,k1,k2", [
    (530, 23, (8, 3, 1), (32, 1, 1)), (24576, 39, (4, 10, 1), (4, 12, 1)),
    (24576, 23, (4, 6, 1), (4, 8, 1)), (120, 1023, (32, 32, 1), (32, 32, 1)),
    (40, 2047, (32, 32, 2), (32, 32, 2)), (2048, 127, (16, 8, 1), (16, 8, 1)),
    (100000, 7, (4, 2, 1), (4, 2, 1)), (64, 7, (4, 2, 1), (8, 1, 1)),
    (8192, 255, (8, 32, 1), (16, 16, 1)), (530, 127, (32, 4, 1), (32, 4, 1))])
def test_warp_config(B, D, k1, k2):
    """K1's and K2's (G, R, S): small launches keep runs short, large ones
    pack more alignments into a warp (the rule measured on the card); every
    run length is compiled; K2's runs pack into whole words and its rows
    cover the band."""
    assert tsw.warp_config(B, D) == k1
    assert tsw.warp_config(B, D, dirs=True) == k2
    for (G, R, S), rs in ((k1, tsw.R_SCORE), (k2, tsw.R_DIRS)):
        assert G * R * S >= D + 1 and R in rs and G in (4, 8, 16, 32)
    assert k2[0] * k2[1] * k2[2] % 4 == 0


@pytest.mark.parametrize("B,D,want", [
    (1, 0, (8, 1, 1)), (128, 7, (8, 1, 1)), (129, 8, (16, 1, 2)),
    (300, 39, (40, 1, 3)), (24576, 39, (40, 1, 192)), (530, 23, (24, 1, 5)),
    (64, 55, (56, 1, 1)), (64, 56, (64, 1, 1)), (64, 63, (64, 1, 1)),
    (64, 64, (64, 2, 1)), (40, 127, (64, 2, 1)), (40, 128, (64, 3, 1)),
    (120, 1023, (64, 16, 1)), (40, 3000, (64, 47, 1))])
def test_sub_config(B, D, want):
    """K3's (WP, S, blocks): the band in a register bucket of 8 offsets up
    to SUB_REG_MAX, above it chunks of SUB_REG_MAX in scratch; one thread
    per row, SUB_THREADS per block; every bucket the rule picks is
    compiled."""
    WP, S, blocks = tsw.sub_config(B, D)
    assert (WP, S, blocks) == want
    assert WP * S >= D + 1 and WP % 8 == 0 and WP <= tsw.SUB_REG_MAX
    assert S == 1 or WP == tsw.SUB_REG_MAX
    assert blocks * tsw.SUB_THREADS >= B > (blocks - 1) * tsw.SUB_THREADS
    assert tsw._sub_smem(25) <= 48 * 1024


def _k3_tables(e8):
    """The per-lane interleaved tables of K3's prologue: word x holds the
    entries (q, 4 * s4 + r), r < 4, of lane x & 31, x >> 5 = q * Cw + s4."""
    C = e8.shape[0]
    Cw = -(-C // 4)
    tbl = np.zeros(C * Cw * 128, np.int64)
    for x in range(C * Cw * 32):
        g = x >> 5
        qv, s0 = g // Cw, 4 * (g % Cw)
        for r in range(4):
            if s0 + r < C:
                tbl[4 * x + r] = e8[qv, s0 + r]
    return tbl, 128 * Cw


def _k3_model(q, s, d, e8, D, gf, ge, WP, S):
    """csrc/sw_band_sub.cu, thread by thread: row b is thread b (lane
    b % 32); the band's WP * S offsets swept upward in place in chunks of
    WP, each chunk taking the old H, E and rank of the offset above it;
    dead cells (k < kmin) with T forced to 0, the best taken over T, and
    every score read from the lane's table at the kernel's address, which
    must lie in the lane's own bank."""
    B, N = q.shape
    C = e8.shape[0]
    tbl, qstride = _k3_tables(e8)
    Wp = WP * S
    neg = tsw.NEG32
    out = np.zeros(B, np.int64)
    for b in range(B):
        if d[b] < 0:
            continue
        lane = b % 32
        kmin = Wp - 1 - min(int(d[b]), D)
        H, E, Q = [0] * Wp, [neg] * Wp, [(C - 1) * qstride] * Wp
        best = 0
        for j in range(N):
            sv = int(s[b, j])
            tcol = 4 * lane + 128 * (sv >> 2) + (sv & 3)
            f = tp = neg
            for k0 in range(0, Wp, WP):
                if k0 + WP <= kmin:
                    continue
                top = k0 + WP
                hu, eu, qu = ((H[top], E[top], Q[top]) if top < Wp
                              else (0, neg, int(q[b, j]) * qstride))
                for k in range(k0, top):
                    hup, eup = (H[k + 1], E[k + 1]) if k + 1 < top else (hu,
                                                                         eu)
                    Q[k] = Q[k + 1] if k + 1 < top else qu
                    addr = tcol + Q[k]
                    assert (addr >> 2) & 31 == lane
                    assert tbl[addr] == e8[Q[k] // qstride, sv]
                    e = max(eup + ge, hup + gf)
                    t = max(H[k] + int(tbl[addr]), e, 0) if k >= kmin else 0
                    f = max(f + ge, tp + gf)
                    H[k], E[k] = max(t, f), e
                    best = max(best, t)
                    tp = t
        out[b] = best
    return out


def test_k3_tables_bank_per_lane():
    """Every lane's copy holds subst8 at the kernel's address, and lane l
    reads only bank l, for BLOSUM62's 25 ranks and for odd sizes."""
    for C in (5, 25, 27):
        e8 = (np.arange(C * C).reshape(C, C) % 255 - 127).astype(np.int8)
        tbl, qstride = _k3_tables(e8)
        assert len(tbl) == C * (-(-C // 4)) * 128
        for lane in (0, 7, 31):
            for qv in range(C):
                for sv in range(C):
                    addr = (4 * lane + 128 * (sv >> 2) + (sv & 3)
                            + qv * qstride)
                    assert tbl[addr] == e8[qv, sv]
                    assert (addr >> 2) % 32 == lane


@pytest.mark.parametrize("D,WP,S", [(0, 8, 1), (7, 8, 1), (39, 40, 1),
                                    (33, 40, 1), (39, 16, 3), (70, 64, 2),
                                    (127, 64, 2)])
def test_k3_sweep_model_matches_plain_and_jax(monkeypatch, small_tiles, D,
                                              WP, S):
    """The model of K3's sweep (register bucket, padding offsets below the
    band, scratch chunks) == the plain version == the JAX sublane kernel in
    interpret mode, exactly, with padding rows and rows narrower than D."""
    monkeypatch.setattr(jsw, "_LAYOUT", "sublane")
    subst, e8, q, s, d = _case(900 + D + WP, 6, 24, 24 + D, D)
    d[4] = -1
    qp = np.full(s.shape, e8.shape[0] - 1, np.int8)
    qp[:, :q.shape[1]] = q
    got = _k3_model(qp, s, d, e8.astype(np.int64), D, GF, GE, WP, S)
    plain = tsw.sw_band_score_torch(
        *(torch.as_tensor(x) for x in (qp, s.astype(np.int8), d, e8)), D,
        GF, GE).numpy()
    np.testing.assert_array_equal(got, plain)
    want = jsw.sw_band_score_pallas(q, s, d, e8, GF, GE, interpret=True)
    np.testing.assert_array_equal(got, want)
    assert got[4] == 0 and got.max() > 0
