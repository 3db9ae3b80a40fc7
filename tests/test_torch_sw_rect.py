"""K4 (the rectangle SW score kernel): the port's plain PyTorch version
against the JAX Pallas kernel in interpret mode (``sw_score_pallas``, as
tests/test_ops.py runs it) and the scalar reference ``sw_reference``.
Scores must be exactly equal.  The CUDA kernel itself is held against the
plain version by tests/test_torch_cuda.py (on the card) and by
chip_smoke.py."""

import numpy as np
import pytest
import torch

from lambda_tpu.ops import sw_pallas, sw_xla
from lambda_tpu_torch.ops import sw_rect


def _case(seed, B, M, N, A=27):
    rng = np.random.default_rng(seed)
    subst = rng.integers(-4, 6, size=(A, A)).astype(np.int32)
    np.fill_diagonal(subst, rng.integers(4, 12, size=A))
    e8 = sw_pallas.extend_matrix8(subst)
    q = rng.integers(0, A, size=(B, M)).astype(np.int32)
    s = rng.integers(0, A, size=(B, N)).astype(np.int32)
    qlen = rng.integers(4, M + 1, size=B)
    slen = rng.integers(4, N + 1, size=B)
    for b in range(B):
        # a homolog with an indel inside half of the rows
        if b % 2 == 0:
            n = min(qlen[b], slen[b]) - 3
            k = n // 2
            s[b, :k] = q[b, :k]
            s[b, k + 2:n + 2] = q[b, k:n]
        q[b, qlen[b]:] = A
        s[b, slen[b]:] = A
    return subst, e8, q, s, qlen, slen


@pytest.mark.parametrize("B,M,N,gf,ge", [(5, 33, 47, -12, -1),
                                         (6, 70, 20, -9, -2),
                                         (4, 12, 130, -11, -1)])
def test_plain_matches_jax_and_reference(B, M, N, gf, ge):
    subst, e8, q, s, qlen, slen = _case(B * M + N, B, M, N)
    got = sw_rect.sw_score(q, s, e8, gf, ge, device="cpu")
    want = sw_pallas.sw_score_pallas(q, s, e8, gf, ge, interpret=True)
    np.testing.assert_array_equal(got, want)
    ref = [sw_xla.sw_reference(q[b, :qlen[b]], s[b, :slen[b]], subst, gf,
                               ge) for b in range(B)]
    assert list(got) == ref


def test_device_entry_on_cpu_tensors():
    """The device entry point runs the plain version for CPU tensors and
    takes int8 ranks of any (B, M) x (B, N) shape."""
    subst, e8, q, s, qlen, slen = _case(3, 3, 9, 15)
    got = sw_rect.sw_score_device(
        *(torch.as_tensor(x.astype(np.int8)) for x in (q, s, e8)), -12, -1)
    assert got.dtype == torch.int32 and got.shape == (3,)
    assert list(got.numpy()) == [
        sw_xla.sw_reference(q[b, :qlen[b]], s[b, :slen[b]], subst, -12, -1)
        for b in range(3)]


def test_query_above_m_max_raises():
    q = np.zeros((1, sw_rect.M_MAX + 1), np.int32)
    s = np.zeros((1, 8), np.int32)
    e8 = sw_pallas.extend_matrix8(np.eye(4, dtype=np.int32))
    with pytest.raises(ValueError):
        sw_rect.sw_score(q, s, e8, -12, -1, device="cpu")
    with pytest.raises(ValueError):
        sw_pallas.sw_score_pallas(q, s, e8, -12, -1, interpret=True)
    assert sw_rect.M_MAX == sw_pallas.M_MAX


def test_empty_query_scores_zero_as_jax():
    """q of shape (3, 0): the JAX kernel pads M with PAD and returns zeros;
    the port returns zeros without dispatching (no launch on the card)."""
    subst, e8, q, s, qlen, slen = _case(8, 3, 12, 10)
    q0 = np.zeros((3, 0), np.int32)
    want = sw_pallas.sw_score_pallas(q0, s, e8, -11, -1, interpret=True)
    got = sw_rect.sw_score(q0, s, e8, -11, -1, device="cpu")
    np.testing.assert_array_equal(got, want)
    assert got.dtype == np.int32 and list(got) == [0, 0, 0]


# ------------------------------------------------ the wavefront's schedule

NEG, DEAD = -(2 ** 27), -(2 ** 20)


class _Strip:
    """One warp of csrc/sw_rect.cu's wavefront: L lanes, lane l holding
    the run of R query positions strip0 + l * R + r in its H, E and query
    ranks; ``t`` is its next step, at which lane l computes window column
    t - l."""

    def __init__(self, q_row, k, L, R, C):
        M = len(q_row)
        i = k * L * R + np.arange(L)[:, None] * R + np.arange(R)[None, :]
        self.qo = np.where(i < M, q_row[np.minimum(i, M - 1)], C)
        self.H = np.zeros((L, R), np.int64)
        self.E = np.full((L, R), NEG, np.int64)
        self.sr = np.full(L, C)           # window rank of each lane
        self.ho = np.zeros(L, np.int64)   # top H, at the lane's last column
        self.fo = np.full(L, NEG, np.int64)   # the F it hands up
        self.hd = np.zeros(L, np.int64)   # lane below's top H, a step ago
        self.t = 0
        self.best = 0

    def step(self, s_t, h0, f0, sub, gf, ge):
        """One step: the hand-offs come up one lane (lane 0 takes the
        window rank s_t and the ring's H and F), then every lane sweeps
        its run with F running upward."""
        hin, fin, srk = (np.roll(x, 1) for x in (self.ho, self.fo, self.sr))
        srk[0], hin[0], fin[0] = s_t, h0, f0
        self.sr = srk
        diag, self.hd = self.hd, hin
        f = fin
        for r in range(self.H.shape[1]):
            e = np.maximum(self.E[:, r] + ge, self.H[:, r] + gf)
            tv = np.maximum(np.maximum(diag + sub[self.sr, self.qo[:, r]], e),
                            0)
            diag = self.H[:, r].copy()
            h = np.maximum(tv, f)
            f = np.maximum(f + ge, tv + gf)
            self.E[:, r], self.H[:, r] = e, h
            self.best = max(self.best, int(h.max()))
        self.ho, self.fo = self.H[:, -1].copy(), f
        self.t += 1


def _wavefront(q, s, e8, gf, ge, L, R, ring=8, chunk=2, seed=0):
    """Best score per row by csrc/sw_rect.cu's order of work: strips of
    L * R positions, each a _Strip, run concurrently; at every tick each
    strip, in an order drawn from ``seed``, takes one step unless the
    kernel's waits hold it: a consumer at a chunk's first column waits for
    the producer's progress to cover the chunk, a producer at a chunk's
    first column for the consumer to have read the slots it will
    overwrite.  The top lane of strip k writes (H, F) of column t - (L-1)
    into slot (t - (L-1)) % ring of ring k; lane 0 of strip k + 1 reads
    column t from slot t % ring; progress is published every ``chunk``
    columns.  Fill and drain steps sweep the dead column C, query
    positions past M the dead row C."""
    B, M = q.shape
    N = s.shape[1]
    C = e8.shape[0]
    sub = np.full((C + 1, C + 1), DEAD, np.int64)     # sub[s rank, q rank]
    sub[:C, :C] = e8.T
    S = max(1, -(-M // (L * R)))
    steps = N + L - 1
    rng = np.random.default_rng(seed)
    out = []
    for b in range(B):
        strips = [_Strip(q[b], k, L, R, C) for k in range(S)]
        slots = np.zeros((S, ring, 2), np.int64)
        prod = [0] * S                  # columns written into ring k
        cons = [0] * S                  # columns read from ring k
        while any(st.t < steps for st in strips):
            moved = False
            for k in rng.permutation(S):
                st, t = strips[k], strips[k].t
                if t >= steps:
                    continue
                col_in = k > 0 and t < N
                if col_in and t % chunk == 0 and prod[k - 1] < min(t + chunk,
                                                                   N):
                    continue
                j = t - (L - 1)
                has_out = k + 1 < S and j >= 0
                if has_out and j % chunk == 0 and cons[k] < j + chunk - ring:
                    continue
                h0, f0 = (slots[k - 1, t % ring] if col_in else (0, NEG))
                if col_in and ((t + 1) % chunk == 0 or t + 1 == N):
                    cons[k - 1] = t + 1
                st.step(s[b, t] if t < N else C, h0, f0, sub, gf, ge)
                if has_out:
                    slots[k, j % ring] = st.ho[L - 1], st.fo[L - 1]
                    if (j + 1) % chunk == 0 or j + 1 == N:
                        prod[k] = j + 1
                moved = True
            assert moved, "the strips' rings deadlocked"
        out.append(max(st.best for st in strips))
    return np.array(out, np.int32)


@pytest.mark.parametrize("L,R,M,N", [
    (4, 1, 4, 9),        # one strip
    (4, 1, 9, 23),       # three strips, ragged top strip
    (4, 2, 16, 5),       # two strips, window shorter than a strip
    (4, 2, 17, 40),      # just above a strip multiple, window > the ring
    (4, 3, 5, 30),       # one ragged strip
    (4, 3, 30, 14),      # three strips, ragged
    (4, 3, 36, 31),      # three full strips
])
def test_wavefront_schedule_matches_plain_and_jax(L, R, M, N):
    """The wavefront's schedule (shuffled hand-offs, delayed diagonal,
    rings between strips, dead fill/drain columns and dead positions past
    M) gives exactly sw_score_torch's and the JAX kernel's scores."""
    B = 4
    subst, e8, q, s, qlen, slen = _case(L * 100 + R * 10 + M + N, B, M, N)
    want = sw_pallas.sw_score_pallas(q, s, e8, -11, -1, interpret=True)
    plain = sw_rect.sw_score(q, s, e8, -11, -1, device="cpu")
    np.testing.assert_array_equal(plain, want)
    got = _wavefront(q, s, e8, -11, -1, L, R, seed=M + N)
    np.testing.assert_array_equal(got, want)
    assert int(want.max()) > 0


@pytest.mark.parametrize("M", [1, 32, 33, 128, 129, 256, 257, 1000, 2048,
                               4097, 8193, 16384])
def test_rect_config_covers_query(M):
    """Every M up to M_MAX gets a compiled run length, strips that cover
    it with a partial top strip of at most one run per lane short, at
    most 16 warps per block and shared memory within Hopper's limit."""
    R, W, P = sw_rect.rect_config(64, M)
    assert R in sw_rect.R_RECT
    assert 32 * R * (W - 1) < M <= 32 * R * W
    assert W <= sw_rect.MAX_STRIPS and W * P <= 16
    assert sw_rect._rect_smem(25, W, P) <= 227 * 1024
