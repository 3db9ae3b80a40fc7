"""The spans of a search call in the port's StatsHolder: each new bucket
and counter is filled where its work runs, the ten top-level buckets
partition no more than the call's own clock, and recording them changes
neither the seeder's results nor the output bytes."""

import contextlib
import dataclasses
import time

import numpy as np
import pytest
import torch

from lambda_tpu_torch import alphabets as ab, cli as tcli
from lambda_tpu_torch import options as topt
from lambda_tpu_torch.io import fasta
from lambda_tpu_torch.search import pipeline as tpipe
from lambda_tpu_torch.stats import StatsHolder

AA = "ARNDCQEGHILKMFPSTWYV"
TOP_LEVEL = ("time_load", "time_read", "time_seed_prep", "time_seed",
             "time_locate", "time_merge", "time_extend", "time_extend_trace",
             "time_records", "time_write")


@pytest.fixture(scope="module")
def case(tmp_path_factory):
    """40 random proteins; queries: 12 fragments of them with a few
    substitutions (phase 1 finds them) and 6 random proteins (phase 2
    re-searches them)."""
    d = tmp_path_factory.mktemp("torch_spans")
    rng = np.random.default_rng(21)
    letters = np.frombuffer(AA.encode(), np.uint8)
    db = letters[rng.integers(0, 20, (40, 300))]
    fasta.write_fasta(d / "db.fasta", [fasta.SeqRecord(f"s{i}", r.tobytes())
                                       for i, r in enumerate(db)])
    qs = []
    for i in range(12):
        q = db[i * 3, 40:160].copy()
        q[rng.integers(0, len(q), 6)] = letters[rng.integers(0, 20, 6)]
        qs.append(fasta.SeqRecord(f"q{i}", q.tobytes()))
    for i in range(6):
        qs.append(fasta.SeqRecord(
            f"r{i}", letters[rng.integers(0, 20, 150)].tobytes()))
    fasta.write_fasta(d / "q.fasta", qs)
    assert tcli.main(["mkindexp", "-d", str(d / "db.fasta"), "-i",
                      str(d / "db.lit"), "-v", "0"]) == 0
    return d


def _opt(d, out, **kw):
    return topt.make_search_options(
        topt.Domain.PROTEIN, query_file=str(d / "q.fasta"),
        index_file=str(d / "db.lit"), output=str(out), verbosity=0,
        query_batch_size=8, **kw)


def _search(opt):
    t0 = time.perf_counter()
    st = tpipe.run_search(opt, device="cpu")
    return st, time.perf_counter() - t0


@pytest.mark.parametrize("kw", [{}, {"db_stream": 2},
                                {"lazy_qry_file": True}],
                         ids=["resident", "stream", "lazy"])
def test_every_span_and_counter_is_filled_where_its_work_runs(case, tmp_path,
                                                              kw):
    opt = _opt(case, tmp_path / "o.m8", **kw)
    assert opt.iterative_search and opt.adaptive_seeding
    st, call_s = _search(opt)
    assert st.hits_final > 0
    for name in ("time_load", "time_read", "time_seed_prep", "time_seed",
                 "time_records", "time_write", "time_seed_walk",
                 "time_phase2", "seed_syncs"):
        assert getattr(st, name) > 0, name
    assert (st.time_stream_upload > 0) == ("db_stream" in kw)
    assert st.dev_seed_s == 0                 # no device clock on the CPU
    assert st.time_seed_walk <= st.time_seed
    assert st.time_stream_upload <= st.time_seed
    assert st.time_phase2 < call_s
    # the ten top-level buckets do not overlap: their sum fits the call
    assert sum(getattr(st, k) for k in TOP_LEVEL) <= call_s


def test_seeder_gives_the_same_results_with_and_without_stats(case,
                                                              tmp_path):
    opt = _opt(case, tmp_path / "o.m8")
    ctx = tpipe.SearchContext(opt, "cpu")
    seqs = [ab.encode(r.seq, ctx.qry_orig_alph)
            for r in fasta.read_fasta(str(case / "q.fasta"))]
    for so in (opt.search_opts0, opt.search_opts):
        sd = ctx._prepare_seeding(seqs, so, StatsHolder())
        seeder = ctx.seeder_for(so)
        dev = ctx.device

        def call(**kw):
            return seeder(
                ctx.d_keys, sd.d_red_q, sd.d_qlens,
                torch.as_tensor(sd.slot_frame, device=dev),
                torch.as_tensor(sd.slot_begin, device=dev),
                torch.as_tensor(sd.slot_rem, device=dev),
                torch.zeros(sd.Q, dtype=torch.int64, device=dev),
                ctx.d_pos, ctx.d_frame, ctx.d_sbj_offsets, ctx.d_sbj_lens,
                ctx.d_trans_sbj, sd.d_trans_q, ctx.d_sub_fwd, ctx.d_sub_rev,
                ctx.d_bucket, **kw)

        st = StatsHolder()
        plain, recorded = call(), call(stats=st)
        assert st.seed_syncs > 0 and st.time_seed_walk > 0
        for k in ("packed", "stats_vec", "valid", "passed"):
            assert torch.equal(plain[k], recorded[k]), k


def test_m8_is_that_of_a_run_without_spans(case, tmp_path, monkeypatch):
    st, _ = _search(_opt(case, tmp_path / "spans.m8"))

    def no_span(self, bucket):
        return contextlib.nullcontext()

    monkeypatch.setattr(StatsHolder, "timed", no_span)
    monkeypatch.setattr(tpipe, "span", lambda name: contextlib.nullcontext())
    bare, _ = _search(_opt(case, tmp_path / "bare.m8"))
    assert (tmp_path / "spans.m8").read_bytes() == \
        (tmp_path / "bare.m8").read_bytes() != b""
    assert bare.time_seed == bare.time_seed_walk == 0
    # the funnel and the counters do not depend on the spans
    times = {f.name for f in dataclasses.fields(StatsHolder)
             if f.name.startswith("time_")}
    assert {k: v for k, v in dataclasses.asdict(st).items()
            if k not in times} == \
        {k: v for k, v in dataclasses.asdict(bare).items()
         if k not in times}
