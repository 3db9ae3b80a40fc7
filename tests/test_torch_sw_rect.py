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
