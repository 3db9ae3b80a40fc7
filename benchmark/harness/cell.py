"""One run of one cell: set-up, the measured window, the check.

Set-up: the database and the queries from the seed, the program's
``mkindexp`` into a fresh directory under ``TMPDIR``, one resident
``SearchContext``, and a warm-up on queries the window does not use.
The window drives ``lambda_tpu_torch.search.pipeline.run_search`` on the
resident index, which the harness hands to each call by standing it in
for ``pipeline.SearchContext`` during the call (the program has no other
way to search a resident index).  A throughput mix issues whole query
files back to back; a closed loop sends one request when the last one's
output is written.  The window ends with the first call that completes
at or after ``seconds``.  Then the device peak is read, the program's
state freed, and the window's outputs judged against the reference.
"""

from __future__ import annotations

import dataclasses
import gc
import json
import shutil
import tempfile
import time
from pathlib import Path

import numpy as np

from ..reference import judge as judge_mod
from . import generate, trace as trace_mod
from .spec import BENCH_DIR, Spec

WARM_ID = 10_000_000          # first query id of the warm-up's queries


@dataclasses.dataclass
class QueryFile:
    path: Path
    ids: list


@dataclasses.dataclass
class Call:
    pool: int                 # which query file
    path: Path                # its output
    n: int                    # queries in it
    t0: float                 # seconds since the window opened
    t1: float
    stats: dict               # the StatsHolder the call returned
    traced: bool


@dataclasses.dataclass
class Run:
    """What a metric's ``read(run)`` sees."""
    traffic: dict
    calls: list
    window_s: float
    setup_s: float
    mkindex_s: float
    index_load_s: float
    mem_peak_bytes: int
    judged: dict | None = None
    trace: dict | None = None
    peaks: dict | None = None


def _peaks(kind: str) -> dict | None:
    table = json.loads((BENCH_DIR / "harness" / "peaks.json").read_text())
    p = table.get(kind)
    if p is None:
        return None
    return dict(p, int_ops_per_s=p["sms"] * p["lanes_issued_per_sm_clock"]
                * p["boost_clock_hz"] * p["int_ops_per_lane_instruction"])


def _query_files(rng, db, traffic: dict, batch: int, n_files: int,
                 first_id: int, folder: Path, queries: dict):
    """Query files of one stream: ``n_files`` calls of whole batches, or
    requests of a uniform number of proteins."""
    if traffic["loop"] == "closed":
        sizes = rng.integers(traffic["request_min"],
                             traffic["request_max"] + 1, n_files)
    else:
        sizes = np.full(n_files, traffic["batches_per_call"] * batch)
    qs = generate.make_queries(rng, db, traffic, int(sizes.sum()))
    files, at = [], 0
    folder.mkdir(parents=True, exist_ok=True)
    for k, n in enumerate(sizes):
        path = folder / f"f{first_id + at}.fa"
        generate.write_queries(path, qs[at:at + n], first_id + at)
        ids = [f"q{first_id + at + j}" for j in range(n)]
        queries.update(zip(ids, qs[at:at + n]))
        files.append(QueryFile(path, ids))
        at += n
    return files


def _sentinel(traffic: dict, db):
    """Which planted queries are sentinels: every read; proteins of a
    family of low divergence and of some length."""
    if traffic["kind"] == "reads":
        return lambda q: True
    div, length = traffic["sentinel_divergence"], traffic["sentinel_length"]
    return lambda q: (db.fams.div[q.family] <= div
                      and len(q.text) >= length)


def run(spec: Spec, name: str, seed: int, seconds: float, trace: bool,
        device: str = "cuda", control: bool = False,
        t_proc: float | None = None) -> dict:
    """One run of cell ``name``: the result's dict (see ``run.py``)."""
    t_proc = time.perf_counter() if t_proc is None else t_proc
    work = Path(tempfile.mkdtemp(prefix="lambda-bench-"))
    try:
        return _run(spec, name, seed, seconds, trace, device, control,
                    t_proc, work)
    finally:
        shutil.rmtree(work, ignore_errors=True)


def _run(spec, name, seed, seconds, trace, device, control, t_proc, work):
    import torch
    from lambda_tpu_torch import cli
    from lambda_tpu_torch.search import pipeline

    cuda = device == "cuda"
    cell = spec.cell(name)
    cfg = spec.config(cell["config"])
    traffic = spec.traffic(cell["traffic"])
    db = generate.make_database(seed, cfg["database"])
    fasta, lit = work / "db.fa", work / "db.lit"
    db.write_fasta(fasta)
    t = time.perf_counter()
    if cli.main([*cfg["mkindex"], "-d", str(fasta), "-i", str(lit),
                 "-v", "0"]):
        raise RuntimeError("mkindex failed")
    mkindex_s = time.perf_counter() - t
    index_bytes = sum(f.stat().st_size for f in work.glob("db.lit*"))

    def options(query: Path):
        return cli.search_options(cfg["search"][0], [
            *cfg["search"][1:], "-q", str(query), "-i", str(lit),
            "-o", str(work / "warm.m8"), "-v", "0", "--device", device])[0]

    queries: dict = {}
    loop = traffic["loop"]
    batch = options(fasta).query_batch_size
    pool = _query_files(generate.rng_for(seed, 2), db, traffic, batch,
                        traffic["pool"], 0, work / "pool", queries)
    warm = _query_files(generate.rng_for(seed, 3), db, traffic, batch,
                        traffic["warmup"], WARM_ID, work / "warm", {})
    # the options as the CLI sets them for this kind of query
    opt = options(warm[0].path)

    t = time.perf_counter()
    ctx = pipeline.SearchContext(opt, device)
    if cuda:
        torch.cuda.synchronize()
    index_load_s = time.perf_counter() - t
    out_dir = work / "out"
    out_dir.mkdir()

    def search(qf: QueryFile, out: Path):
        return pipeline.run_search(dataclasses.replace(
            opt, query_file=str(qf.path), output=str(out)), device=device)

    tracer = trace_mod.Tracer() if trace else None
    calls: list[Call] = []
    cls = pipeline.SearchContext
    pipeline.SearchContext = lambda *a, **kw: ctx     # the resident index
    try:
        for k, qf in enumerate(warm):
            search(qf, work / f"warm{k}.m8")
        if cuda:
            torch.cuda.synchronize()
        t_open = time.perf_counter()
        setup_s = t_open - t_proc
        tracing = tracer is not None
        if tracing:
            tracer.start()
        n_trace = traffic["trace_calls"]
        while True:
            qf = pool[len(calls) % len(pool)]
            out = out_dir / f"c{len(calls)}.m8"
            t0 = time.perf_counter()
            if tracing:
                with torch.profiler.record_function(trace_mod.CALL_SPAN):
                    st = search(qf, out)
            else:
                st = search(qf, out)
            t1 = time.perf_counter()
            calls.append(Call(pool=len(calls) % len(pool), path=out,
                              n=len(qf.ids), t0=t0 - t_open,
                              t1=t1 - t_open, traced=tracing,
                              stats=dataclasses.asdict(st)))
            if tracing and len(calls) == n_trace:
                tracer.stop()
                tracing = False
            if t1 - t_open >= seconds:
                break
        if tracing:
            tracer.stop()
        window_s = calls[-1].t1
    finally:
        pipeline.SearchContext = cls
    mem_peak = torch.cuda.max_memory_allocated() if cuda else 0
    del ctx
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    kind = torch.cuda.get_device_name(0) if cuda else "cpu"
    rec = Run(traffic=traffic, calls=calls, window_s=window_s,
              setup_s=setup_s, mkindex_s=mkindex_s,
              index_load_s=index_load_s, mem_peak_bytes=mem_peak,
              peaks=_peaks(kind))
    if tracer is not None:
        dev, host = tracer.events()
        spans = [s for s in host if s[0] == trace_mod.CALL_SPAN]
        window = (spans[0][1], spans[-1][2])
        rec.trace = trace_mod.reduce(dev, host, tracer.k1_shapes(), window,
                                     rec.peaks)
        rec.trace["queries"] = sum(c.n for c in calls if c.traced)
        rec.trace["calls"] = sum(c.traced for c in calls)

    # the check, once the program's state is freed
    t_judge = time.perf_counter()
    rec.judged = judge_mod.judge(
        [(c.path, pool[c.pool].ids) for c in calls], queries, db,
        cfg["program"], traffic["limits"], opt.max_matches,
        opt.max_e_value, traffic["sample_records"],
        generate.rng_for(seed, 9), _sentinel(traffic, db), device=device,
        control=control)
    metrics = {}
    for m in spec.metrics(cell, trace):
        v = spec.reader(m["name"])(rec)
        if v is not None:
            metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
    dev_info = {"platform": "gpu" if cuda else "cpu", "kind": kind,
                "count": int(cell["chips"]), "memory_peak_bytes": mem_peak}
    result = {"correct": rec.judged["correct"],
              "attempted": sum(c.n for c in calls) if loop != "closed"
              else len(calls),
              "failed": 0, "metrics": metrics, "device": dev_info}
    if rec.trace is not None:
        dev_info.update(busy_s=rec.trace["busy_s"],
                        window_s=rec.trace["window_s"])
        result["breakdown"] = {"device_ops": rec.trace["device_ops"],
                               "idle_gaps": rec.trace["idle_gaps"]}
    result["detail"] = {k: rec.judged[k] for k in (
        "records", "sampled", "planted", "found", "sentinels",
        "sentinels_missed", "sentinels_missed_ids", "homolog_missed_pct",
        "program") if k in rec.judged} | {
        "control": control,
        "calls": len(calls), "index_bytes": index_bytes,
        "judge_s": time.perf_counter() - t_judge,
        "subjects": db.n_subjects}
    result["checks"] = rec.judged["checks"]
    return result


def phase_ms_per_kq(run: Run, keys) -> float | None:
    """Milliseconds per 1,000 queries of the program's StatsHolder
    buckets ``keys``, over the window's calls outside the profiler (all
    its calls where the profiler took the whole window)."""
    calls = [c for c in run.calls if not c.traced] or run.calls
    n = sum(c.n for c in calls)
    if not n:
        return None
    return 1e6 * sum(c.stats[k] for c in calls for k in keys) / n
