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
