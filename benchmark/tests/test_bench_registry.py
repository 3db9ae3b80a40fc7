"""The harness finds configurations, traffic mixes and metrics by name,
and takes up new ones added as files plus an entry alone."""

import json

from benchmark.harness.spec import Spec


def test_every_entry_of_the_benchmark_resolves(tiny_spec):
    for w in tiny_spec.data["workloads"]:
        cfg = tiny_spec.config(w["config"])
        assert cfg["name"] == w["config"]
        assert tiny_spec.traffic(w["traffic"])["name"] == w["traffic"]
        for trace in (False, True):
            for m in tiny_spec.metrics(w, trace):
                assert callable(tiny_spec.reader(m["name"]))


def test_each_cell_reports_setup_another_end_to_end_and_a_layer(tiny_spec):
    for w in tiny_spec.data["workloads"]:
        e2e = {m["name"] for m in tiny_spec.metrics(w, False)}
        assert "setup_s" in e2e and len(e2e) >= 2
        assert tiny_spec.metrics(w, True)


def test_a_new_cell_is_taken_up_from_files_and_an_entry(tiny_spec):
    """A configuration, a mix and a per-layer metric added as new files
    and entries, nothing else edited."""
    root = tiny_spec.root
    cfg = json.loads((root / "configs/blastp_sprot_half.json").read_text())
    cfg["name"] = "blastp_tiny"
    (root / "configs/blastp_tiny.json").write_text(json.dumps(cfg))
    mix = json.loads((root / "traffic/proteome.json").read_text())
    mix.update(name="burst", batches_per_call=1)
    (root / "traffic/burst.json").write_text(json.dumps(mix))
    (root / "metrics/calls_in_window.py").write_text(
        "def read(run):\n    return len(run.calls)\n")
    b = json.loads(tiny_spec.path.read_text())
    b["configs"].append(dict(b["configs"][1], name="blastp_tiny",
                             file="configs/blastp_tiny.json"))
    b["workloads"].append({"name": "blastp_tiny.burst",
                           "config": "blastp_tiny", "traffic": "burst",
                           "chips": 1, "why": "a throwaway cell"})
    b["per_layer"].append({"name": "calls_in_window", "unit": "calls",
                           "better": "higher", "source": "host_clock",
                           "layer": "device", "moves": "queries_per_s",
                           "workloads": ["blastp_tiny.burst"]})
    for m in b["end_to_end"]:
        if m["name"] == "queries_per_s":
            m["workloads"].append("blastp_tiny.burst")
    tiny_spec.path.write_text(json.dumps(b))
    spec = Spec(tiny_spec.path, bench_dir=root)
    cell = spec.cell("blastp_tiny.burst")
    assert spec.config(cell["config"])["name"] == "blastp_tiny"
    assert spec.traffic(cell["traffic"])["batches_per_call"] == 1
    layers = {m["name"] for m in spec.metrics(cell, True)}
    # with the metrics without a workloads key, which every cell reports
    assert layers == {"calls_in_window", "index_load_s", "mkindex_s"}
    assert "calls_in_window" not in {
        m["name"] for m in spec.metrics(spec.cell(
            "blastp_sprot_half.proteome"), True)}
    assert spec.reader("calls_in_window")(type("R", (), {"calls": [1, 2]}))\
        == 2
