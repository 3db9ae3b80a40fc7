"""The four-card cell ``blastp_shards4.proteome`` on the CPU at the tiny
size (the four shards as four cells of the CPU): a sound run is correct
and its control is not; two faults of the exchange between the cards
are not correct; the readers of the mesh's metrics on synthetic runs."""

import contextlib
import json

import pytest
import torch

from benchmark.harness import cell
from benchmark.harness.cell import Call, Run
from benchmark.harness.spec import Spec
from conftest import ROOT

CELL = "blastp_shards4.proteome"
SPEC = Spec(ROOT / "BENCHMARK.json")


def run(spec, seed=2 ** 40 + 3, control=False):
    return cell.run(spec, CELL, seed, 0.2, False, device="cpu",
                    control=control)


def test_the_sharded_cell_is_correct_and_its_control_is_not(tiny_spec):
    r = run(tiny_spec)
    assert r["correct"], r["checks"]
    assert r["detail"]["sampled"] > 0 and r["detail"]["sentinels"] > 0
    assert r["device"]["count"] == 4
    assert set(r["metrics"]) == {"queries_per_s", "homolog_recall_pct",
                                 "setup_s"}
    c = run(tiny_spec, control=True)
    assert not c["correct"], c["checks"]
    assert c["detail"]["program"] == {
        k: r["checks"][k]["value"] for k in c["detail"]["program"]}


def one_member_families(spec) -> Spec:
    """The tiny benchmark with every family one member in the database,
    so that a query's one homolog lies on one card, the planted proteins
    of divergence up to 0.2 (and 100 residues or more) sentinels, and
    calls of four batches: a card's hits left out then miss about a
    quarter of some 20 sentinels, which a sound run all finds."""
    cfg_path = spec.root / "configs" / "blastp_shards4.json"
    cfg = json.loads(cfg_path.read_text())
    cfg["database"]["size_max"] = 1
    cfg_path.write_text(json.dumps(cfg))
    mix_path = spec.root / "traffic" / "proteome.json"
    mix = json.loads(mix_path.read_text())
    mix.update(sentinel_divergence=0.2, batches_per_call=4)
    mix_path.write_text(json.dumps(mix))
    return Spec(spec.path, bench_dir=spec.root)


@contextlib.contextmanager
def last_card_left_out():
    """The gather of the seeding's hits skips the last card's: its count
    of selected hits reads 0 (an off-by-one over the cells)."""
    from lambda_tpu_torch.search import pipeline

    old = pipeline.SearchContext._mesh_seed_call

    def call(self, sd, stats):
        old(self, sd, stats)
        last = dict(sd.mesh_outs[-1])
        last["stats_vec"] = last["stats_vec"].clone()
        last["stats_vec"][4] = 0
        sd.mesh_outs[-1] = last

    pipeline.SearchContext._mesh_seed_call = call
    try:
        yield
    finally:
        pipeline.SearchContext._mesh_seed_call = old


@contextlib.contextmanager
def e_values_over_one_shard():
    """E-values from the length of the first card's shard alone, in
    place of the whole database's."""
    from lambda_tpu_torch import statistics
    from lambda_tpu_torch.search import pipeline

    old = pipeline.SearchContext._mesh_setup

    def setup(self):
        old(self)
        shard0 = int(self.d_sh["lengths"][0].sum())
        self.evaluer = statistics.EValuer(self.ka_params, shard0,
                                          self.program.q_translated)

    pipeline.SearchContext._mesh_setup = setup
    try:
        yield
    finally:
        pipeline.SearchContext._mesh_setup = old


def test_a_card_left_out_of_the_gather_is_not_correct(tiny_spec):
    spec = one_member_families(tiny_spec)
    sound = run(spec)
    assert sound["correct"], sound["checks"]
    with last_card_left_out():
        r = run(spec)
    assert not r["correct"], r["checks"]
    miss = r["checks"]["sentinels_missed_pct"]
    assert miss["value"] > 2 * miss["limit"], r["checks"]
    assert r["detail"]["sentinels_missed"] \
        > sound["detail"]["sentinels_missed"]


def test_e_values_over_one_shard_are_not_correct(tiny_spec):
    with e_values_over_one_shard():
        r = run(tiny_spec)
    assert not r["correct"], r["checks"]
    score = r["checks"]["score_off_pct"]
    assert score["value"] > 10 * score["limit"], r["checks"]
    # the scores and alignments themselves are sound
    assert r["checks"]["align_off_pct"]["value"] == 0


# ---------------------------------------------------------------------------
# the readers of the mesh's metrics
# ---------------------------------------------------------------------------

MESH_KEYS = ("time_mesh_reduce", "time_mesh_gather", "dev_card_sum_s",
             "dev_card_max_s", "card_mem_peak_bytes")
NEW_METRICS = ("mesh_xfer_ms_per_kq", "card_overlap_x", "card_imbalance_pct",
               "fullest_card_mem_gb")


def read(name, run):
    return SPEC.reader(name)(run)


def call(t0, t1, n=1024, traced=False, mesh=True, **stats):
    st = dict(time_seed=0.0, time_locate=0.0, time_merge=0.0,
              time_extend=0.0, time_extend_trace=0.0, time_write=0.0)
    if mesh:
        st.update(dict.fromkeys(MESH_KEYS, 0.0), card_mem_peak_bytes=0)
    st.update(stats)
    return Call(pool=0, path=None, n=n, t0=t0, t1=t1, stats=st,
                traced=traced)


def run_of(calls):
    return Run(traffic={"loop": "throughput"}, calls=list(calls),
               window_s=calls[-1].t1 if calls else 0, setup_s=200.0,
               mkindex_s=80.0, index_load_s=40.0, mem_peak_bytes=9e9)


def test_mesh_metrics_over_a_synthetic_run():
    calls = [
        # the traced call: left out of the span metrics, not of the peak
        call(0, 1, traced=True, time_mesh_reduce=5.0, dev_card_sum_s=9.0,
             dev_card_max_s=9.0, time_seed=1.0, card_mem_peak_bytes=8e9),
        call(1, 2, time_mesh_reduce=0.01, time_mesh_gather=0.03,
             dev_card_sum_s=0.4, dev_card_max_s=0.15, time_seed=0.6,
             time_extend=0.2, card_mem_peak_bytes=6e9),
        call(2, 3, time_mesh_reduce=0.02, time_mesh_gather=0.04,
             dev_card_sum_s=0.2, dev_card_max_s=0.05, time_seed=0.5,
             time_extend=0.1, card_mem_peak_bytes=7e9),
    ]
    r = run_of(calls)
    assert read("mesh_xfer_ms_per_kq", r) == pytest.approx(
        0.1 * 1e6 / 2048)
    assert read("card_overlap_x", r) == pytest.approx(0.6 / 1.4)
    assert read("card_imbalance_pct", r) == pytest.approx(
        100 * (4 * 0.2 / 0.6 - 1))
    assert read("fullest_card_mem_gb", r) == pytest.approx(8.0)
    # cards that share the work evenly, all at once
    even = run_of([call(0, 1, dev_card_sum_s=0.8, dev_card_max_s=0.2,
                        time_seed=0.15, time_extend=0.05)])
    assert read("card_imbalance_pct", even) == pytest.approx(0.0)
    assert read("card_overlap_x", even) == pytest.approx(4.0)


@pytest.mark.parametrize("name", NEW_METRICS)
def test_mesh_metrics_are_none_without_a_mesh_or_the_fields(name):
    """The parent (no such fields), a run of one card or of the CPU (the
    card clocks and memory 0), an empty run: no reading, no error."""
    parent = run_of([call(0, 1, mesh=False, time_seed=0.5)])
    assert read(name, parent) is None
    assert read(name, run_of([])) is None
    if name != "mesh_xfer_ms_per_kq":
        assert read(name, run_of([call(0, 1, time_seed=0.5)])) is None


def test_mesh_metrics_are_reported_in_the_sharded_cell_alone():
    for w in SPEC.data["workloads"]:
        names = {m["name"] for m in SPEC.metrics(w, True)}
        assert (set(NEW_METRICS) <= names) == (w["name"] == CELL)
    names = {m["name"] for m in SPEC.metrics(SPEC.cell(CELL), True)}
    assert "seed_device_ms_per_kq" not in names
    assert {"k1_roofline_pct", "device_idle_pct", "launches_per_kq",
            "unspanned_pct", "phase2_ms_per_kq", "index_load_s"} <= names
    assert SPEC.cell(CELL)["chips"] == 4


@pytest.mark.cuda
def test_a_tiny_run_on_four_cards(tiny_spec):
    if torch.cuda.device_count() < 4:
        pytest.skip("needs four CUDA cards")
    r = cell.run(tiny_spec, CELL, 5, 0.5, True, device="cuda")
    assert r["correct"], r["checks"]
    for name in NEW_METRICS:
        assert r["metrics"][name]["value"] > 0, name
