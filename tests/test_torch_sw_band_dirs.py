"""K2 (the direction-emitting banded pass of pass 2): the port's plain
PyTorch version and host walk against the JAX Pallas kernel in interpret
mode (small tiles, as tests/test_ops.py runs it) and against the host C++
traceback of the default pass 2.

Scores and traces must be exactly equal.  The codes are compared under
the port's rule: the H-source bits on every in-band cell, and each extend
bit wherever the gap value it describes (E for bit 4, F for bit 8) is
positive -- the only cells the walk reads it in.  The CUDA kernel itself
is held against the plain version by tests/test_torch_cuda.py (on the
card) and by chip_smoke.py."""

import numpy as np
import pytest
import torch

from lambda_tpu.ops import sw_band as jsw, sw_pallas, sw_xla
from lambda_tpu_torch import native as tnative
from lambda_tpu_torch.ops import sw_band as tsw


@pytest.fixture
def small_tiles(monkeypatch):
    # interpret mode emulates the kernel grid in Python: tiny tiles
    monkeypatch.setattr(jsw, "_BT_CAP", 8)
    monkeypatch.setattr(jsw, "_BTL_CAP", 128)


def _indel_case(seed, B, Mq, D, letters):
    """Low-complexity queries (``letters`` symbols of a 5-letter matrix)
    whose windows hold a copy with a planted insertion and deletion on an
    in-band diagonal; random gap costs; a padding row (d = -1)."""
    rng = np.random.default_rng(seed)
    A = 5
    subst = rng.integers(-4, 3, size=(A, A)).astype(np.int32)
    np.fill_diagonal(subst, rng.integers(3, 8, size=A))
    e8 = sw_pallas.extend_matrix8(subst)
    q = rng.integers(0, letters, size=(B, Mq)).astype(np.int32)
    s = rng.integers(0, letters, size=(B, Mq + D)).astype(np.int32)
    for b in range(B):
        src = list(q[b])
        k = int(rng.integers(0, len(src)))
        src = src[:k] + list(rng.integers(0, letters, 3)) + src[k:]
        k = int(rng.integers(0, len(src) - 3))
        src = src[:k] + src[k + int(rng.integers(1, 4)):]
        off = int(rng.integers(0, D // 2 + 1))
        n = min(len(src), s.shape[1] - off)
        s[b, off:off + n] = src[:n]
    d = rng.integers(0, D + 1, size=B).astype(np.int32)
    d[0] = D
    d[2] = -1
    gf = int(rng.integers(-12, -4))
    ge = int(rng.integers(-3, 0))
    return subst, e8, q, s, d, gf, ge


def _jax_dirs(q, s, d, e8, gf, ge):
    """JAX's K2 in interpret mode, as (dirs (N, D+1, B),
    best (B,), bestj (B, D+1)) over the first window-width columns."""
    B, Ns = s.shape
    D = int(d.max())
    N, _, _, _, _ = jsw._plan(Ns, D, layout="lane")
    Ws, P, _, _ = jsw._lane_geometry(D)
    BT = jsw.trace_tile(B, D)
    Bp = -(-B // (BT * P)) * BT * P
    qp, sp, dr, put = jsw._pad_host_inputs(q, s, d, N, Bp, e8.shape[0] - 1,
                                           True)
    jd, jbest, _ = (np.asarray(x) for x in jsw.sw_band_align_device(
        put(qp), put(sp), put(dr), put(e8), D, gf, ge, True, bt=BT))
    out = np.zeros((Ns, D + 1, B), np.uint8)
    best = np.zeros(B, np.int64)
    for b in range(B):
        t, r = divmod(b, BT * P)
        bt, p = divmod(r, P)
        lanes = slice(p * Ws, p * Ws + D + 1)
        out[:, :, b] = jd[t, :Ns, bt, lanes]
        best[b] = jbest[t, bt, lanes].max(initial=0)
    return out, best


def _port_dirs(q, s, d, e8, gf, ge):
    """The plain K2 in the port's layout (B, N, D+1), its codes also
    returned in JAX's (N, D+1, B) for the comparison, and E and F."""
    Ns = s.shape[1]
    D = int(d.max())
    qp = np.full((q.shape[0], Ns), e8.shape[0] - 1, np.int8)
    qp[:, :min(q.shape[1], Ns)] = q[:, :Ns]
    args = [torch.as_tensor(x) for x in (qp, s.astype(np.int8), d, e8)]
    dirs, *rest = (x.numpy() for x in tsw.sw_band_align_torch(*args, D, gf,
                                                              ge))
    assert dirs.shape == (len(d), Ns, D + 1)
    band = np.ascontiguousarray(dirs.transpose(1, 2, 0))
    return [band, *rest, *(x.numpy() for x in _gap_values(*args, D, gf, ge))]


def _gap_values(q, s, d, e8, D, gf, ge):
    """E and F of every cell, (N, D+1, B) int32 each, from the plain sweep
    the codes come from: an extend bit is compared only where the gap
    value it describes is positive."""
    cols = [(E.T, F.T) for _, _, _, E, _, F, _ in tsw._band_sweep(
        q, s, d, e8, D, gf, ge)]
    return tuple(torch.stack(x) for x in zip(*cols))


def _assert_codes_equal(port, want, d):
    dirs, _, _, _, E, F = port
    D = dirs.shape[1] - 1
    w = np.arange(D + 1)
    in_band = (w[None, :, None] >= (D - d)[None, None, :]) & (d >= 0)
    in_band = np.broadcast_to(in_band, dirs.shape)
    assert in_band.any()
    np.testing.assert_array_equal((dirs & 3)[in_band], (want & 3)[in_band])
    e_pos = in_band & (E > 0)
    f_pos = in_band & (F > 0)
    np.testing.assert_array_equal((dirs & 4)[e_pos], (want & 4)[e_pos])
    np.testing.assert_array_equal((dirs & 8)[f_pos], (want & 8)[f_pos])
    assert (dirs[~in_band] == 0).all()
    return int(e_pos.sum()), int(f_pos.sum())


@pytest.mark.parametrize("D", [7, 39, 127])
@pytest.mark.parametrize("letters", [3, 5])
def test_plain_matches_jax_dirs_kernel(small_tiles, D, letters):
    subst, e8, q, s, d, gf, ge = _indel_case(10 * D + letters, 10, 30, D,
                                             letters)
    port = _port_dirs(q, s, d, e8, gf, ge)
    want, want_best = _jax_dirs(q, s, d, e8, gf, ge)
    np.testing.assert_array_equal(port[1], want_best)
    n_e, n_f = _assert_codes_equal(port, want, d)
    assert n_e > 0 and n_f > 0, "the case holds no positive gap values"
    # scores and walked traces through both host APIs
    jsc, jtr = jsw.sw_band_align_pallas(q, s, d, e8, gf, ge, interpret=True)
    sc, tr = tsw.sw_band_align(q, s, d, e8, gf, ge, device="cpu")
    np.testing.assert_array_equal(sc, jsc)
    assert tr == jtr
    assert sc[2] == 0 and tr[2] is None
    assert any(len(t[2]) > 1 for t in tr if t is not None), \
        "no trace holds a gap"
    for b, t in enumerate(tr):
        if t is not None:
            assert sw_xla.score_of_ops(q[b], s[b], *t, subst, gf, ge) == sc[b]


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_walk_matches_host_traceback(seed):
    """The K2 path's traces equal the default pass 2's (the port's host
    C++ banded traceback) byte for byte."""
    rng = np.random.default_rng(seed)
    D = int(rng.choice([7, 23, 39]))
    subst, e8, q, s, d, gf, ge = _indel_case(seed, 24, 40, D,
                                             int(rng.integers(3, 6)))
    d[2] = 0                         # the host walker has no padding rows
    sc, tr = tsw.sw_band_align(q, s, d, e8, gf, ge, device="cpu")
    hsc, htr, _ = tnative.sw_traceback_stats_batch(
        list(q), list(s), tsw.extend_matrix(subst), gf, ge, band=d)
    np.testing.assert_array_equal(sc, hsc)
    assert tr == htr


def test_end_cell_tie_break():
    """Equal maxima: the walk starts at the smallest i + j, then the
    smallest i (lambda_tpu/ops/sw_band.py:521-531)."""
    subst = np.array([[2, -3], [-3, 2]], np.int32)
    e8 = sw_pallas.extend_matrix8(subst)
    q = np.array([[0, 0, 1, 1, 1, 0, 0]], np.int32)
    s = np.array([[0, 0, 1, 1, 1, 0, 0, 1, 1, 1, 0, 0]], np.int32)
    d = np.array([5], np.int32)
    port = _port_dirs(q, s, d, e8, -5, -1)
    _, jbest = _jax_dirs(q, s, d, e8, -5, -1)
    sc, tr = tsw.sw_band_align(q, s, d, e8, -5, -1, device="cpu")
    jsc, jtr = jsw.sw_band_align_pallas(q, s, d, e8, -5, -1, interpret=True)
    assert list(sc) == list(jsc) == [int(port[1][0])] == list(jbest)
    assert tr == jtr


def test_query_wider_than_window(small_tiles):
    """tests/test_ops.py:341: the host entry clips a query wider than the
    window, and the trace scores what the kernel scored."""
    rng = np.random.default_rng(5)
    A = 6
    subst = rng.integers(-4, 3, size=(A, A)).astype(np.int32)
    np.fill_diagonal(subst, rng.integers(2, 7, size=A))
    e8 = sw_pallas.extend_matrix8(subst)
    q = rng.integers(0, A, size=(2, 33)).astype(np.int32)
    s = rng.integers(0, A, size=(2, 12)).astype(np.int32)
    s[0, :12] = q[0, :12]
    d = np.array([3, 5], dtype=np.int32)
    sc, tr = tsw.sw_band_align(q, s, d, e8, -9, -2, device="cpu")
    jsc, jtr = jsw.sw_band_align_pallas(q, s, d, e8, -9, -2, interpret=True)
    np.testing.assert_array_equal(sc, jsc)
    assert tr == jtr
    assert list(sc) == [jsw.sw_band_reference(q[b], s[b], int(d[b]), subst,
                                              -9, -2) for b in range(2)]
    q0, s0, ops = tr[0]
    assert sw_xla.score_of_ops(q[0], s[0], q0, s0, ops, subst, -9, -2) \
        == sc[0]


def test_align_scores_equal_score_pass():
    """K2's best scores are K1's scores (same banded DP)."""
    subst, e8, q, s, d, gf, ge = _indel_case(9, 8, 25, 15, 4)
    sc, _ = tsw.sw_band_align(q, s, d, e8, gf, ge, device="cpu")
    np.testing.assert_array_equal(
        sc, tsw.sw_band_score(q, s, d, e8, gf, ge, device="cpu"))
