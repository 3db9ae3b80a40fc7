"""Seeding's slot walk (lambda_tpu_torch/ops/slot_walk.py): the plain
version against a per-query running-sum walk written here in numpy -- the
order in which csrc/slot_walk.cu walks (one query at a time, its
hitsThisSeq carried as one sum) -- on seeded inputs that reach every
branch of the walk.  The card tests in test_torch_cuda.py hold the kernel
to the plain version on the same cases."""

import dataclasses

import numpy as np
import pytest
import torch

from lambda_tpu_torch.ops import slot_walk as sw
from lambda_tpu_torch.search.seeding import SeedConfig
from lambda_tpu_torch.stats import StatsHolder


@dataclasses.dataclass(frozen=True)
class WalkCase:
    T: int = 24
    Q: int = 6
    V: int = 5                  # rows a segment holds at most
    E: int = 5
    density: float = 0.5        # share of (t, q, v) rows walked
    max_matches: int = 25
    hits0_max: int = 10         # hits0 in [0, hits0_max)
    base_max: int = 0           # base in [0, base_max)
    rem_min: int = 1
    room_min: int = 0           # flen - beg - k in [room_min, E + 3)
    vals: tuple = ()            # the counts drawn from, else a range
    empty_slots: int = 0        # slots left without a row


CASES = {
    "empty_slots": WalkCase(density=0.3, empty_slots=10),
    "E0": WalkCase(E=0),
    "E1": WalkCase(E=1),
    "E5": WalkCase(E=5),
    "one_row_a_slot": WalkCase(V=1, density=0.7),
    "occ_cap_edges": WalkCase(max_matches=3, vals=(0, 1, 2, 29, 30, 31, 45)),
    "hits0_at_max_matches": WalkCase(hits0_max=60),
    "rem_zero": WalkCase(rem_min=-1),
    "nonzero_base": WalkCase(base_max=12),
    "frame_end_inside_curve": WalkCase(room_min=-2),
    "segments_over_32_rows": WalkCase(T=8, Q=3, V=80, E=7, density=0.8),
    "long_curves": WalkCase(T=12, Q=4, V=6, E=40),
}


def cfg_of(case: WalkCase) -> SeedConfig:
    return SeedConfig(seed_length=11, seed_offset=3, max_seed_dist=1,
                      half_exact=True, adaptive=True,
                      max_matches=case.max_matches, pre_scoring=2,
                      pre_scoring_thresh=2.0, alphabet_size=10, bits=4,
                      cpw=8, words=4)


def walk_case(case: WalkCase, seed: int) -> tuple:
    """Seeded inputs of slot_walk: (curve, t_w, q_w, beg_w, flen_w, rem_w,
    base, hits0) as int64 CPU tensors, the rows sorted by (slot, query,
    variant).  Half the rows' curves fall step by step, as real counts
    do; the other half are arbitrary."""
    rng = np.random.default_rng(seed)
    T, Q, V, E = case.T, case.Q, case.V, case.E
    walked = rng.random((T, Q, V)) < case.density
    walked[rng.permutation(T)[:case.empty_slots]] = False
    t_w, q_w, _ = (x.astype(np.int64) for x in np.nonzero(walked))
    n = len(t_w)
    occ = 10 * case.max_matches
    if case.vals:
        curve = rng.choice(np.array(case.vals), (n, E + 1))
    else:
        curve = rng.integers(0, 2 * occ, (n, E + 1))
    fall = rng.random(n) < 0.5
    drop = rng.integers(0, max(2, occ // 4), (n, E + 1))
    drop[:, 0] = 0
    start = rng.integers(0, 2 * occ, (n, 1))
    curve[fall] = np.maximum(start - np.cumsum(drop, axis=1), 0)[fall]
    k = 11
    beg = rng.integers(0, 50, n)
    flen = beg + k + rng.integers(case.room_min, E + 3, n)
    rem = rng.integers(case.rem_min, 30, n)
    base = rng.integers(0, max(case.base_max, 1), (T, Q))
    hits0 = rng.integers(0, case.hits0_max, Q)
    return tuple(torch.as_tensor(np.ascontiguousarray(x), dtype=torch.int64)
                 for x in (curve, t_w, q_w, beg, flen, rem, base, hits0))


def running_sum_walk(cfg, curve, t_w, q_w, beg, flen, rem, base, hits0):
    """The walk as the kernel orders it: query after query, slot after
    slot, hitsThisSeq one running sum; each row stepped until its first
    refusal."""
    curve, t_w, q_w, beg, flen, rem, base, hits0 = (
        np.asarray(x) for x in (curve, t_w, q_w, beg, flen, rem, base,
                                hits0))
    T, Q = base.shape
    E = curve.shape[1] - 1
    mm, hf, k = cfg.max_matches, cfg.heuristic_factor, cfg.seed_length
    L = np.zeros(len(curve), np.int64)
    for q in range(Q):
        h = int(hits0[q])
        for t in range(T):
            kept = 0
            for i in np.nonzero((t_w == t) & (q_w == q))[0]:
                desired = 1 if h >= mm else \
                    max(1, (mm - h) * hf // max(int(rem[i]), 1))
                c = [int(x) for x in curve[i]]
                e = 0
                while e < E and beg[i] + k + e < flen[i] and c[e] > 0 \
                        and not (c[e + 1] < desired and c[e + 1] < c[e]):
                    e += 1
                L[i] = e
                if 0 < c[e] <= cfg.occ_cap:
                    kept += c[e]
            h += int(base[t, q]) + kept
    return L


@pytest.mark.parametrize("name", sorted(CASES))
@pytest.mark.parametrize("seed", [0, 2147483659])
def test_plain_walk_is_the_running_sum_walk(name, seed):
    """slot_walk_torch == the per-query running-sum walk, every row; the
    case reaches what it is named for."""
    case = CASES[name]
    cfg = cfg_of(case)
    args = walk_case(case, seed % (1 << 32))
    got = sw.slot_walk_torch(cfg, *args)
    want = running_sum_walk(cfg, *args)
    np.testing.assert_array_equal(got.numpy(), want)
    curve, t_w = args[0], args[1]
    assert len(curve) > 0
    if case.E:
        assert 0 < int((got > 0).sum()) < len(got)
    if case.empty_slots:
        assert len(set(t_w.tolist())) < case.T
    if case.vals:
        g = curve.gather(1, got[:, None])[:, 0]
        assert bool((g == cfg.occ_cap).any()) \
            and bool((g == cfg.occ_cap + 1).any())


def test_dispatch_on_the_cpu_runs_the_plain_version_and_counts():
    """slot_walk on CPU tensors: the plain version's integers, no kernel
    launch, its rows in seed_walk_rows and its one host read in
    seed_syncs."""
    case = CASES["nonzero_base"]
    cfg = cfg_of(case)
    args = walk_case(case, 7)
    st = StatsHolder()
    before = sw.launches
    got = sw.slot_walk(cfg, *args, stats=st)
    assert sw.launches == before
    assert torch.equal(got, sw.slot_walk_torch(cfg, *args))
    assert st.seed_walk_rows == len(args[0]) > 0 and st.seed_syncs == 1
    empty = sw.slot_walk(cfg, *(x[:0] for x in args[:6]), *args[6:],
                         stats=st)
    assert empty.shape == (0,) and st.seed_walk_rows == len(args[0])
