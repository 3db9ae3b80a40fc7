"""The metric arithmetic on synthetic runs: whole-call rate, p95, idle
share and labelled gaps over synthetic intervals, K1's cells and bytes
from shapes only."""

import json
import types

import numpy as np
import pytest

from benchmark.harness import trace
from benchmark.harness.cell import Call, Run, _peaks, phase_ms_per_kq
from benchmark.harness.spec import Spec
from conftest import ROOT

SPEC = Spec(ROOT / "BENCHMARK.json")


def read(name, run):
    return SPEC.reader(name)(run)


def reported(cell, trace=False):
    return {m["name"] for m in SPEC.metrics(SPEC.cell(cell), trace)}


def fake_run(loop="throughput", calls=(), **kw):
    base = dict(traffic={"loop": loop}, calls=list(calls),
                window_s=calls[-1].t1 if calls else 0, setup_s=31.5,
                mkindex_s=14.0, index_load_s=7.0, mem_peak_bytes=4.5e9)
    base.update(kw)
    return Run(**base)


def call(t0, t1, n=1024, traced=False, **stats):
    st = dict(time_seed=0.0, time_locate=0.0, time_merge=0.0,
              time_extend=0.0, time_extend_trace=0.0, time_write=0.0)
    st.update(stats)
    return Call(pool=0, path=None, n=n, t0=t0, t1=t1, stats=st,
                traced=traced)


def test_whole_call_rate_counts_whole_calls_over_the_window():
    run = fake_run(calls=[call(0.0, 1.0), call(1.0, 2.5), call(2.5, 4.0)])
    assert read("queries_per_s", run) == pytest.approx(3 * 1024 / 4.0)
    # BENCHMARK.json alone chooses the cells that report a metric
    assert "request_p95_ms" not in reported("blastp_sprot_half.proteome")


def test_p95_of_requests():
    lat = np.arange(1, 201) / 1000.0              # 1 .. 200 ms
    t, calls = 0.0, []
    for x in lat:
        calls.append(call(t, t + x, n=3))
        t += x
    run = fake_run("closed", calls)
    assert read("request_p95_ms", run) == pytest.approx(
        np.percentile(lat, 95) * 1e3)
    assert "queries_per_s" not in reported("blastp_sprot_half.interactive")


def test_recall_memory_setup():
    run = fake_run(calls=[call(0, 1)], judged=dict(planted=70, found=63))
    assert read("homolog_recall_pct", run) == pytest.approx(90.0)
    assert read("device_mem_peak_gb", run) == pytest.approx(4.5)
    assert read("setup_s", run) == 31.5
    assert read("mkindex_s", run) == 14.0
    assert read("index_load_s", run) == 7.0
    run.judged = dict(planted=0, found=0)
    assert read("homolog_recall_pct", run) is None


def test_phase_spans_per_kq_leave_out_traced_calls():
    calls = [call(0, 1, traced=True, time_seed=9.0),
             call(1, 2, time_seed=0.2, time_locate=0.1, time_write=0.05),
             call(2, 3, time_seed=0.3, time_extend_trace=0.02)]
    run = fake_run(calls=calls)
    assert phase_ms_per_kq(run, ("time_seed", "time_locate")) \
        == pytest.approx(0.6 * 1e6 / 2048)
    assert read("seed_ms_per_kq", run) == pytest.approx(0.6 * 1e6 / 2048)
    assert read("pass2_ms_per_kq", run) == pytest.approx(0.02 * 1e6 / 2048)
    assert read("write_ms_per_kq", run) == pytest.approx(0.05 * 1e6 / 2048)


def test_union_and_idle_share_over_synthetic_intervals():
    iv = [(0.0, 1.0), (0.5, 2.0), (3.0, 4.0), (9.0, 12.0)]
    assert trace.union_seconds(iv, 0.0, 10.0) == pytest.approx(4.0)
    assert trace.idle_gaps(iv, 0.0, 10.0) == [(2.0, 3.0), (4.0, 9.0)]
    dev = [("k", s, e, True) for s, e in iv]
    host = [(trace.CALL_SPAN, 0.0, 10.0), ("time_seed", 3.5, 9.5)]
    red = trace.reduce(dev, host, [], (0.0, 10.0), None)
    assert red["busy_s"] == pytest.approx(4.0)
    assert red["launches"] == 4              # each that starts inside
    assert red["idle_gaps"] == [["time_seed", 5.0],
                                [trace.CALL_SPAN, 1.0]]
    run = fake_run(calls=[call(0, 10)], trace=dict(red, queries=1024,
                                                   calls=1))
    assert read("device_idle_pct", run) == pytest.approx(60.0)
    assert read("launches_per_kq", run) == pytest.approx(4 * 1000 / 1024)
    closed = fake_run("closed", [call(0, 10)], trace=dict(red, queries=3,
                                                          calls=4))
    assert read("device_idle_pct.interactive", closed) == pytest.approx(60)
    assert read("launches_per_request.interactive", closed) == 1.0


def brute_cells(qlen, first, end, d):
    return sum(1 for j in range(first, end) for i in range(qlen)
               if j - d <= i <= j)


@pytest.mark.parametrize("seed", range(4))
def test_k1_cells_closed_form(seed):
    rng = np.random.default_rng(seed)
    rows = [(int(rng.integers(0, 40)), int(rng.integers(0, 10)),
             int(rng.integers(0, 60)), int(rng.integers(-1, 20)))
            for _ in range(200)]
    q, f, e, d = (np.array(c) for c in zip(*rows))
    got = trace.k1_cells(q, f, e, d)
    want = [brute_cells(*r) if r[3] >= 0 else 0 for r in rows]
    assert got.tolist() == want


def test_k1_cells_are_the_plain_version_s_band():
    """The cells counted are the band lanes K1's plain version computes
    (ops/sw_band.py:_band_sweep: column j, lane w holds query position
    j + w - D, valid for w >= D - d) on real query positions and real
    window columns."""
    import torch
    from lambda_tpu_torch.ops import sw_band

    rng = np.random.default_rng(1)
    B, N, D, C = 6, 40, 9, 25
    q = torch.full((B, N), C - 1, dtype=torch.int8)
    s = torch.full((B, N), C - 1, dtype=torch.int8)
    qlen = rng.integers(1, 30, B)
    first = rng.integers(0, 5, B)
    end = first + rng.integers(1, 30, B)
    d = rng.integers(0, D + 1, B)
    for b in range(B):
        q[b, :qlen[b]] = torch.as_tensor(rng.integers(0, 20, qlen[b]))
        s[b, first[b]:end[b]] = torch.as_tensor(
            rng.integers(0, 20, end[b] - first[b]))
    counted = np.zeros(B, dtype=np.int64)
    W = D + 1
    w = np.arange(W)
    for j, (valid, *_rest) in enumerate(sw_band._band_sweep(
            q, s, torch.as_tensor(d, dtype=torch.int32),
            torch.zeros((C, C), dtype=torch.int8), D, -12, -1)):
        i = j + w - D
        real = (valid.numpy() & (i[None, :] >= 0)
                & (i[None, :] < qlen[:, None])
                & ((first <= j) & (j < end))[:, None])
        counted += real.sum(1)
    assert trace.k1_cells(qlen, first, end, d).tolist() == counted.tolist()


def test_k1_least_time_from_shapes_only():
    peaks = _peaks("NVIDIA H100 80GB HBM3")
    assert peaks["int_ops_per_s"] == pytest.approx(
        132 * 128 * 1.98e9 * 6)
    cells = np.array([1000, 2000])
    t = trace.k1_least_seconds(2, 300, 25, cells, peaks)
    assert t == pytest.approx(max(11 * 3000 / peaks["int_ops_per_s"],
                                  (2 * 2 * 300 + 16 + 625)
                                  / peaks["hbm_bytes_per_s"]))
    red = trace.reduce([("void sw_band_score_kernel<4, false>", 0.0, 1e-3,
                         True)], [(trace.CALL_SPAN, 0.0, 1.0)],
                       [(2, 300, 25, cells)], (0.0, 1.0), peaks)
    run = fake_run(calls=[call(0, 1)], trace=dict(red, queries=1, calls=1),
                   peaks=peaks)
    assert read("k1_roofline_pct", run) == pytest.approx(100 * t / 1e-3)
    assert _peaks("a card without a row") is None
