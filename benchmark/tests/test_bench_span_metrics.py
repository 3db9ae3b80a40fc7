"""The readers of the program's spans on synthetic runs: each over the
untraced calls, and None where the program's stats lack the field (a
program that does not record it)."""

import pytest

from benchmark.harness.cell import Call, Run
from benchmark.harness.spec import Spec
from conftest import ROOT

SPEC = Spec(ROOT / "BENCHMARK.json")
THROUGHPUT = ("blastx_sprot_half.reads150", "blastp_sprot_half.proteome",
              "blastp_sprot_half.dark")
SPAN_METRICS = ("unspanned_pct", "seed_prep_ms_per_kq", "seed_walk_ms_per_kq",
                "seed_device_ms_per_kq", "seed_syncs_per_kq",
                "records_ms_per_kq", "phase2_ms_per_kq")
OLD_KEYS = ("time_seed", "time_locate", "time_merge", "time_extend",
            "time_extend_trace", "time_write")
NEW_KEYS = ("time_load", "time_read", "time_seed_prep", "time_records",
            "time_seed_walk", "time_stream_upload", "time_phase2",
            "dev_seed_s", "seed_syncs")


def read(name, run):
    return SPEC.reader(name)(run)


def run_of(calls, loop="throughput"):
    return Run(traffic={"loop": loop}, calls=list(calls),
               window_s=calls[-1].t1 if calls else 0, setup_s=30.0,
               mkindex_s=14.0, index_load_s=7.0, mem_peak_bytes=4.5e9)


def call(t0, t1, n=1024, traced=False, new=True, **stats):
    st = dict.fromkeys(OLD_KEYS + (NEW_KEYS if new else ()), 0.0)
    if new:
        st["seed_syncs"] = 0
    st.update(stats)
    return Call(pool=0, path=None, n=n, t0=t0, t1=t1, stats=st,
                traced=traced)


def test_span_metrics_over_untraced_calls():
    calls = [call(0, 1, traced=True, time_seed_prep=9.0, seed_syncs=99),
             call(1, 2, time_seed_prep=0.1, time_seed_walk=0.2,
                  dev_seed_s=0.05, seed_syncs=40, time_records=0.03,
                  time_phase2=0.4),
             call(2, 3, time_seed_prep=0.3, time_seed_walk=0.1,
                  dev_seed_s=0.15, seed_syncs=60, time_records=0.01,
                  time_phase2=0.2)]
    run = run_of(calls)
    per_kq = 1e6 / 2048
    assert read("seed_prep_ms_per_kq", run) == pytest.approx(0.4 * per_kq)
    assert read("seed_walk_ms_per_kq", run) == pytest.approx(0.3 * per_kq)
    assert read("seed_device_ms_per_kq", run) == pytest.approx(0.2 * per_kq)
    assert read("seed_syncs_per_kq", run) == pytest.approx(100 * 1e3 / 2048)
    assert read("records_ms_per_kq", run) == pytest.approx(0.04 * per_kq)
    assert read("phase2_ms_per_kq", run) == pytest.approx(0.6 * per_kq)


def test_unspanned_share_of_the_calls_clock():
    calls = [call(0, 4, traced=True),
             call(4, 6, time_load=0.1, time_read=0.1, time_seed_prep=0.2,
                  time_seed=0.8, time_locate=0.1, time_write=0.2,
                  time_seed_walk=0.5, time_phase2=0.9),
             call(6, 8, time_seed=1.0, time_records=0.2, time_extend=0.5,
                  time_merge=0.1, time_extend_trace=0.2)]
    # nested spans (walk, phase 2) are not added again: 3.5 s of 4 spanned
    assert read("unspanned_pct", run_of(calls)) == pytest.approx(12.5)
    # every call traced: all of them count
    assert read("unspanned_pct", run_of([call(0, 2, traced=True,
                                              time_seed=1.5)])) \
        == pytest.approx(25.0)


def test_seeding_per_request_over_untraced_requests():
    calls = [call(0, 1, n=3, traced=True, time_seed=5.0),
             call(1, 2, n=2, time_seed_prep=0.01, time_seed=0.2,
                  time_locate=0.01, time_extend=0.5),
             call(2, 3, n=8, time_seed_prep=0.02, time_seed=0.3,
                  time_locate=0.02)]
    assert read("seed_ms_per_request.interactive",
                run_of(calls, "closed")) == pytest.approx(280.0)


@pytest.mark.parametrize("name", SPAN_METRICS
                         + ("seed_ms_per_request.interactive",))
def test_span_metrics_are_none_without_the_fields(name):
    """A program that returns the six old buckets alone (the parent of
    the spans) gives no reading, and no error; nor does an empty run."""
    old = run_of([call(0, 1, new=False, time_seed=0.5),
                  call(1, 2, new=False, time_seed=0.4)])
    assert read(name, old) is None
    assert read(name, run_of([])) is None


def test_span_metrics_are_reported_where_listed():
    for cell in THROUGHPUT:
        names = {m["name"] for m in SPEC.metrics(SPEC.cell(cell), True)}
        assert set(SPAN_METRICS) <= names
        assert "seed_ms_per_request.interactive" not in names
    inter = {m["name"] for m in SPEC.metrics(
        SPEC.cell("blastp_sprot_half.interactive"), True)}
    assert "seed_ms_per_request.interactive" in inter
    assert not set(SPAN_METRICS) & inter
