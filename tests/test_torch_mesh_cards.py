"""The device mesh across cards, rehearsed on the CPU: every hand-written
launch runs under its tensors' device, ``--db-shards 4`` on a resident
context writes the one-device bytes (and records the plain reference
holds), the mesh's spans nest inside their buckets, its counters are
filled under the mesh alone, and the memory estimate is each card's own.

The run across four real cards is ``test_torch_cuda.py::
test_db_shards4_on_four_cards_is_byte_equal_to_one_card``."""

import contextlib
import dataclasses
import time
import types

import numpy as np
import pytest
import torch

from benchmark.harness import generate
from benchmark.reference import judge as judge_mod
from lambda_tpu_torch import cli as tcli, stats as stats_mod
from lambda_tpu_torch.ops import _build, searchsorted as ss, sw_band, sw_rect
from lambda_tpu_torch.parallel import mesh as pmesh
from lambda_tpu_torch.search import pipeline as tpipe
from lambda_tpu_torch.stats import StatsHolder

# ---------------------------------------------------------------------------
# the launch guard, with a stub library in place of the built kernels
# ---------------------------------------------------------------------------


def _launches(wrapper):
    """The one launch of ``wrapper`` on CPU tensors, as its CUDA path
    makes it, and the module counter it adds to."""
    i64 = torch.int64
    keys = torch.zeros((8, 2), dtype=i64)
    if wrapper == "S1 range":
        return (lambda: ss._search_range_cuda(
            keys, torch.zeros((3, 2), dtype=i64), torch.zeros((3, 2),
                                                              dtype=i64),
            None, None, None, None, None, None)), (ss, "launches")
    if wrapper == "S1 curves":
        return (lambda: ss._count_curves_cuda(
            keys, torch.zeros((3, 2), dtype=i64), torch.zeros(3, dtype=i64),
            torch.zeros(3, dtype=i64), torch.zeros((3, 2), dtype=i64),
            torch.zeros((2, 4), dtype=i64))), (ss, "launches")
    q = torch.zeros((4, 16), dtype=torch.int8)
    d_rows = torch.zeros(4, dtype=torch.int32)
    e8 = torch.zeros((28, 28), dtype=torch.int8)
    call = {
        "K1": lambda: sw_band._sw_band_score_cuda(q, q, d_rows, e8, 7, -12,
                                                  -1),
        "K2": lambda: sw_band._sw_band_align_cuda(q, q, d_rows, e8, 7, -12,
                                                  -1),
        "K3": lambda: sw_band._sw_band_score_sub_cuda(q, q, d_rows, e8, 7,
                                                      -12, -1),
        "K4": lambda: sw_rect._sw_score_cuda(q, q, e8, -12, -1),
    }[wrapper]
    counter = {"K1": (sw_band, "launches"), "K2": (sw_band, "launches_dirs"),
               "K3": (sw_band, "launches_sub"), "K4": (sw_rect, "launches")}
    return call, counter[wrapper]


@pytest.mark.parametrize("wrapper", ["S1 range", "S1 curves", "K1", "K2",
                                     "K3", "K4"])
def test_every_launch_wrapper_enters_its_tensors_device(monkeypatch,
                                                        wrapper):
    entered, launched_inside = [], []

    @contextlib.contextmanager
    def guard(dev):
        entered.append(dev)
        yield 1234                     # the stream handle it passes on
        launched_inside.append(dev)

    streams = []

    def entry(*args):
        """A kernel library's entry point: takes its arguments, writes
        nothing, returns 0 (cudaSuccess)."""
        streams.append(args[-1])
        assert len(entered) == len(launched_inside) + 1, \
            "the launch ran outside the device guard"
        return 0

    def load(name):
        # a fresh function per entry, as ctypes gives, for its argtypes
        return types.SimpleNamespace(**{n: (lambda *a: entry(*a)) for n in (
            "ss_range_launch", "ss_curves_launch", "sw_band_score_launch",
            "sw_band_dirs_launch", "sw_band_sub_launch", "sw_rect_launch")})

    monkeypatch.setattr(_build, "load", load)
    monkeypatch.setattr(_build, "launch_stream", guard)
    for mod in (sw_band, sw_rect):       # the CPU tensors pass as cards'
        monkeypatch.setattr(mod, "check_cuda_inputs", lambda *a, **k: None)
    call, (mod, counter) = _launches(wrapper)
    before = getattr(mod, counter)
    call()
    assert entered == [torch.device("cpu")] == launched_inside
    assert streams == [1234]
    assert getattr(mod, counter) == before + 1


# ---------------------------------------------------------------------------
# --db-shards 4 on a resident context
# ---------------------------------------------------------------------------

DB = dict(residues=30000, length_mean=360, length_sigma=0.7, length_min=30,
          length_max=4000, size_exponent=2.0, size_max=300,
          divergence_min=0.05, divergence_max=0.3, indels_per_residue=0.005,
          indel_max=3, spare_families=1.0, absent_families=100)
MIX = dict(kind="proteins", homolog_share=0.7)
SEED = 2 ** 33 + 17


@pytest.fixture(scope="module")
def family_db(tmp_path_factory):
    """A database of protein families from the benchmark's generator
    (subjects in a seeded order, so a family's members lie on several
    shards), indexed whole and as four prebuilt shards, and 32 proteins
    of its families and of absent ones."""
    d = tmp_path_factory.mktemp("mesh_cards")
    db = generate.make_database(SEED, DB)
    db.write_fasta(d / "db.fa")
    for name, extra in (("whole", []), ("shards", ["--shards", "4"])):
        assert tcli.main(["mkindexp", *extra, "-d", str(d / "db.fa"),
                          "-i", str(d / f"{name}.lit"), "-v", "0"]) == 0
    qs = generate.make_queries(generate.rng_for(SEED, 2), db, MIX, 32)
    generate.write_queries(d / "q.fa", qs, 0)
    queries = {f"q{k}": q for k, q in enumerate(qs)}
    return types.SimpleNamespace(dir=d, db=db, queries=queries)


def _opts(fx, index: str, out, **kw):
    opt = tcli.search_options("searchp", [
        "-q", str(fx.dir / "q.fa"), "-i", str(fx.dir / f"{index}.lit"),
        "-o", str(out), "-v", "0", "--query-batch", "16",
        "--device", "cpu"])[0]
    return dataclasses.replace(opt, **kw)


def _resident_search(opt, monkeypatch):
    """run_search of ``opt`` on one resident SearchContext, as the
    benchmark drives it: the context is made first and stood in for
    ``pipeline.SearchContext`` during the call."""
    ctx = tpipe.SearchContext(opt, "cpu")
    with monkeypatch.context() as m:
        m.setattr(tpipe, "SearchContext", lambda *a, **kw: ctx)
        return ctx, tpipe.run_search(opt, device="cpu")


@pytest.mark.parametrize("index", ["shards", "whole"],
                         ids=["prebuilt_shards", "split_at_load"])
def test_db_shards4_on_a_resident_context_writes_one_device_bytes(
        family_db, tmp_path, monkeypatch, index):
    one = _opts(family_db, "whole", tmp_path / "one.m8")
    _resident_search(one, monkeypatch)
    four = _opts(family_db, index, tmp_path / "four.m8", db_shards=4)
    ctx, st = _resident_search(four, monkeypatch)
    assert ctx.mesh is not None and ctx.mesh.shape == (1, 4)
    got = (tmp_path / "four.m8").read_bytes()
    assert got == (tmp_path / "one.m8").read_bytes() != b""
    # the records of the four shards hold against the plain reference:
    # Smith-Waterman around each record, BLAST's statistics over the
    # whole database, the family of each planted query found
    order = [f"q{k}" for k in range(len(family_db.queries))]
    limits = dict(output_faults=0, score_off_pct=0, align_off_pct=0)
    res = judge_mod.judge(
        [(tmp_path / "four.m8", order)], family_db.queries, family_db.db,
        "blastp", limits, four.max_matches, four.max_e_value, 10 ** 6,
        generate.rng_for(SEED, 9), lambda q: True)
    assert res["correct"], res["checks"]
    assert res["sampled"] == res["records"] > 25
    # a query's records come from several shards
    base = ctx.shard_base
    sids = [int(line.split(b"\t")[1][1:]) for line in got.splitlines()]
    assert len(set(np.searchsorted(base, sids, side="right"))) == 4


class _HostEvent:
    """A CUDA event's stand-in on the CPU: the host clock when made."""

    def __init__(self):
        self.t = time.perf_counter()

    def elapsed_time(self, end) -> float:
        return (end.t - self.t) * 1e3


@contextlib.contextmanager
def _host_clock(events, dev):
    """stats.card_clock with host-clock events, so that the CPU fills the
    card clocks as a card would."""
    if events is None:
        yield
        return
    start = _HostEvent()
    yield
    events.append((dev, start, _HostEvent()))


TOP_LEVEL = ("time_load", "time_read", "time_seed_prep", "time_seed",
             "time_locate", "time_merge", "time_extend", "time_extend_trace",
             "time_records", "time_write")


@pytest.mark.parametrize("db_shards", [4, 1], ids=["mesh", "one_device"])
def test_mesh_spans_nest_and_card_counters_fill_under_the_mesh_alone(
        family_db, tmp_path, monkeypatch, db_shards):
    opt = _opts(family_db, "shards", tmp_path / "o.m8", db_shards=db_shards)
    ctx = tpipe.SearchContext(opt, "cpu")
    peaks = {"cuda:0": 3 * 10 ** 9, "cuda:1": 7 * 10 ** 9}
    if ctx.mesh is not None:
        # the card clocks and memory peaks of two cards, on the CPU
        monkeypatch.setattr(pmesh, "card_clock", _host_clock)
        monkeypatch.setattr(ctx, "mesh_cards", lambda: list(peaks))
        monkeypatch.setattr(torch.cuda, "max_memory_allocated",
                            lambda d: peaks[d])
    monkeypatch.setattr(tpipe, "SearchContext", lambda *a, **kw: ctx)
    t0 = time.perf_counter()
    st = tpipe.run_search(opt, device="cpu")
    call_s = time.perf_counter() - t0
    assert st.hits_final > 0
    # the ten top-level buckets still partition no more than the call
    assert sum(getattr(st, k) for k in TOP_LEVEL) <= call_s
    if db_shards == 1:
        for k in ("time_mesh_reduce", "time_mesh_gather", "dev_card_sum_s",
                  "dev_card_max_s", "card_mem_peak_bytes"):
            assert getattr(st, k) == 0, k
        return
    assert 0 < st.time_mesh_reduce < st.time_seed
    assert 0 < st.time_mesh_gather < st.time_locate + st.time_extend
    # every cell on the one CPU device: one card clock, the sum its max
    assert 0 < st.dev_card_max_s == st.dev_card_sum_s
    assert st.dev_card_sum_s < st.time_seed + st.time_extend
    assert st.card_mem_peak_bytes == 7 * 10 ** 9


@pytest.mark.parametrize("slice_bytes", [1, 1000, 256 << 20])
def test_reduce_sums_each_part_in_slices_into_the_first(monkeypatch,
                                                        slice_bytes):
    """The psum of pass A's curves (a permuted view, as curve_pass returns
    them) and of 0-d totals: the plain sum, in place in the first part,
    the parts list emptied, whatever the slice."""
    monkeypatch.setattr(pmesh, "REDUCE_SLICE_BYTES", slice_bytes)
    m = pmesh.Mesh(["cpu"] * 4, 1, 4)
    g = torch.Generator().manual_seed(3)
    parts = [torch.randint(0, 99, (7 * 5 * 3, 4), generator=g)
             .reshape(5, 7, 3, 4).permute(1, 0, 2, 3) for _ in range(4)]
    want = sum(p.clone() for p in parts)
    first = parts[0]
    got = m.reduce_db(parts)
    assert got is first and parts == [] and torch.equal(got, want)
    totals = [torch.tensor(k, dtype=torch.int64) for k in (3, 4, 5, 6)]
    assert int(m.reduce_db(totals)) == 18


def test_card_clocks_sum_and_max_over_cards_per_call():
    st = StatsHolder()

    def ev(t):
        return types.SimpleNamespace(t=t, elapsed_time=lambda e: (e.t - t)
                                     * 1e3)
    cards = [torch.device("cuda", k) for k in range(4)]
    events = [(cards[k % 4], ev(0.0), ev(0.1 * (k + 1))) for k in range(6)]
    st.add_card_seconds(events)
    assert events == []
    st.read_device_counters()
    # card 0: 0.1 + 0.5, card 1: 0.2 + 0.6, cards 2, 3: 0.3, 0.4
    assert st.dev_card_sum_s == pytest.approx(2.1)
    assert st.dev_card_max_s == pytest.approx(0.8)
    st.read_device_counters()              # nothing left of that call
    assert st.dev_card_sum_s == pytest.approx(2.1)
    other = StatsHolder(card_mem_peak_bytes=5, dev_card_max_s=0.2)
    st.card_mem_peak_bytes = 9
    st += other
    assert st.card_mem_peak_bytes == 9
    assert st.dev_card_max_s == pytest.approx(1.0)


def test_card_clock_records_on_the_card_s_stream(monkeypatch):
    made, recorded = [], []

    class Event:
        def __init__(self, enable_timing=False):
            assert enable_timing
            made.append(self)

        def record(self, stream):
            recorded.append((self, stream))

    monkeypatch.setattr(torch.cuda, "Event", Event)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda dev: f"stream of {dev}")
    events = []
    dev = torch.device("cuda", 2)
    with stats_mod.card_clock(events, dev):
        assert len(recorded) == 1
    assert events == [(dev, made[0], made[1])]
    assert [s for _, s in recorded] == ["stream of cuda:2"] * 2
    with stats_mod.card_clock(None, dev), \
            stats_mod.card_clock(events, torch.device("cpu")):
        pass
    assert len(events) == 1 and len(made) == 2


@pytest.mark.parametrize("index", ["shards", "whole"],
                         ids=["prebuilt_shards", "split_at_load"])
def test_memory_estimate_is_each_devices_own_shards(family_db, tmp_path,
                                                    index):
    one = tpipe.SearchContext(_opts(family_db, index, tmp_path / "o.m8"),
                              "cpu")
    whole = one.device_memory_needs()
    assert list(whole) == [torch.device("cpu")]
    cells = ["cpu:0", "cpu:1", "cpu:0", "cpu:1"]   # two cells a device
    opt = _opts(family_db, index, tmp_path / "o.m8", db_shards=4)
    ctx = tpipe.SearchContext(opt, "cpu", devices=[torch.device("cpu")] * 4)
    needs = ctx.device_memory_needs()
    assert list(needs) == [torch.device("cpu")]
    placed = sum(t.numel() * t.element_size() for k, ts in ctx.d_sh.items()
                 if ts is not None for t in {id(t): t for t in ts}.values())
    if index == "shards":
        # exact for an artifact of four shards: what Mesh.put_db placed
        assert needs[torch.device("cpu")] == placed
    else:
        assert 0.9 * placed < needs[torch.device("cpu")] < 1.1 * placed
    # a device holding two of the four shards needs half of them
    ctx.mesh = pmesh.Mesh(cells, 1, 4)
    half = ctx.device_memory_needs()
    assert set(half) == {torch.device("cpu", 0), torch.device("cpu", 1)}
    assert all(2 * v == needs[torch.device("cpu")] for v in half.values())
    assert whole[torch.device("cpu")] > 0
