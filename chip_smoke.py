#!/usr/bin/env python3
"""Run the PyTorch/CUDA port (lambda_tpu_torch) end to end on one CUDA card.

    python3 chip_smoke.py

Phases, each printing one JSON line (any failure exits non-zero):

1. device   -- the card's name and power limit (nvidia-smi); no CUDA: exit 1
2. build    -- build K1-K4, S1, S2 and the rate probe (nvcc, sm_90a, one
               nvcc per source) and the host C++ helpers (g++) in parallel
               from the sources in the checkout, with each kernel's ptxas
               report and K3's per instantiation (registers, stack and
               spill bytes; local memory on K3's register path fails the
               run)
   rates    -- the card's int32 instruction rates (csrc/int_rate.cu):
               add, max, the two DPX forms and the band cell as 7
               DPX-folded instructions; the per-cell time of the bounds;
               the latency of one warp sum of an int64 and an add (S2's
               bound)
3. k1       -- K1 against its plain PyTorch version on the card, exact
               equality, at D in {7, 39, 127, 1023} x query buckets
               {64, 256, 1024} with BLOSUM62 ranks and padding rows, at
               D 2047 (two segments of band state), with X-drop (X 5,
               checkpoints every 16 columns) per band bucket, and at the
               bench shape (B 24576, qlen 256, window 290, band 34);
               kernel and plain ms (CUDA events, median), GCUPS, bound
               (X-drop: the cells of the columns each row swept)
4. k2       -- K2 (direction codes) against its plain version at the k1
               cases and D 2047: scores, end cells, H-source bits of every
               in-band cell, extend bits wherever their gap value is
               positive, and the walked traces
5. k3       -- K3 (the sublane layout) against K1's plain version at the
               k1 cases, the bench shape, and both edges of every register
               bucket and of the first scratch widths (band widths 8k and
               8k + 1 up to 129) at B 333 with padding rows
6. grid     -- K1 and K3 timed side by side at B in {256, 512, 2048,
               24576} x D in {23, 39, 127} and at D 1023 (B 256, 2048;
               query bucket 128), both held against the plain version; a
               record, it selects nothing
7. k4       -- K4 (rectangle) against its plain version at M in {128, 512,
               2048} with windows up to 2 M, at M 1000 (eight strips, the
               top one ragged) and at M_MAX 16384 with a 64-column
               window (16 strips), all through the op's host entry point
               (its launches counted); per case the kernel's (R, W, P),
               ms, device_ms, plain ms, bound, GCUPS and share of the
               bound
7b. mesh_step -- parallel/mesh.py:make_sharded_search_step, the fused
               demo step (K4's search path), on make_demo_inputs (256
               queries of 64, 256 subjects of 4,096) over grids 1x1, 1x4
               and 2x2 laid on the one card: the same merged top-k and
               db_total on every grid, seeds of every cell found in its
               shard, K4's first launch per grid held exactly against its
               plain version, K4 launches and the step's call ms
8. golden   -- the port's CLI, mkindex + search of all 13 cases of
               tests/test_golden.py (BLASTP, BLASTN, BLASTX, TBLASTN,
               TBLASTX, bisulfite; m8, m9, m0, SAM) on the card, each
               byte-equal to tests/golden/, in three child processes at
               once (``--golden-child``): default, LAMBDA_SW_TRACE=device
               (K2) and LAMBDA_SWB_LAYOUT=sublane (K3, latched at import)
9. card_cpu -- a 2e5-residue database and 256 queries searched with
               --device cuda and --device cpu: byte-equal m8; then the
               same in a child process under LAMBDA_SW_XDROP (latched at
               import), K1 launched with X-drop, card m8 == CPU m8;
               then BLASTN, BLASTX, TBLASTN, TBLASTX and bisulfite, each
               on its own 2e5-character database with 128 queries, card
               m8 == CPU m8, K1 held against its plain version on each
               mode's first launch (BLASTN: C 6), and for bisulfite K1
               and K2 on the first launch of each rev class
10. scale   -- the main path: a 1e8-residue synthetic protein database
               (250,000 x 400 aa), index resident on the card, 1,024
               queries (70 % homolog fragments, 30 % random) through
               mkindexp / searchp with default options; K1 launch count,
               q/s, per-phase seconds, homolog hit share; K1 held against
               the plain version on the first pass-1 launches' inputs;
               then three rounds of the same queries on the same
               resident index, each round once with default options,
               once with LAMBDA_SW_TRACE=device (K2) and once with the
               sublane layout (K3): every m8 byte-equal to the default
               run's, K2 and K3 held against their plain version on their
               first three launches' inputs in the first round, and the
               spread of search seconds per mode; one more pass of the
               default batches under torch.profiler for the device's
               busy time
   scale_searchsorted -- S1 (csrc/searchsorted.cu) on the main path:
               its launches counted from 0 over the scale search, and
               both entries (range search, count curves) held exactly
               against their plain versions on the inputs of the first
               call of each seeding phase of that search (phase 1 and
               phase 2, whose rows are the random queries' re-seeding)
               and of the BLASTX search below, on the resident keys;
               per call the rows, the skipped rows, kernel ms and
               device ms, plain ms and the bound: the longest chain of
               dependent key loads at the card's random-load latency
               (one-row searches of the whole index, each on a new key)
               against the bytes it must move at 3.35 TB/s
   scale_slot_walk -- S2 (csrc/slot_walk.cu) on the main path: its
               launches counted from 0 over the scale search, held
               exactly against its plain version on the inputs of the
               first walk of each seeding phase of that search and of
               the BLASTX search below; per call the slots, queries,
               rows and steps, kernel ms and device ms, plain ms and the
               bound: the larger of the bytes read once at 3.35 TB/s and
               the slots times one warp sum and add (the rates phase)
11. scale_blastx -- BLASTX at full width on the same resident index
               (reloaded once the BLASTP context is freed): 1,024 DNA
               reads of 300 nt (70 % coding for 100-aa fragments of
               database subjects with 12 substitutions, half on the
               minus strand; 30 % random), six query frames; q/s, split,
               K1 launches and K1 against its plain version, the share of
               homolog reads hitting their source subject on a frame of
               the right sign (>= 50 %), then one rerun each under the
               device trace (K2) and the sublane layout (K3), byte-equal
12. card_cpu_paths -- on the card_cpu databases, card m8 == CPU m8 for
               BLASTP --seed-delta 2 (half-exact on and off) and 3, BLASTN
               and bisulfite --seed-delta 2 --search0 0, BLASTP
               --db-stream 3 (default and --seed-delta 2), bisulfite
               --db-stream 2, K1 held against its plain version on each;
               mkindexp --shards 4 searched with --shard-subset 0,1 and
               2,3, merged by tools/merge_m8.py into the full run's lines
12b. card_cpu_mesh -- the device mesh on the card_cpu databases, its
               cells all on the one card (SearchContext(devices=...)) and
               on CPU cells: BLASTP --db-shards 2, --q-shards 2
               --db-shards 2, --q-shards 4, mkindexp --shards 4 searched
               with --db-shards 4, bisulfite --db-shards 2, BLASTP
               --seed-delta 2 --db-shards 2, and BLASTP --db-shards 2
               under the device trace (K2) and the sublane layout (K3):
               card m8 == CPU m8 == the unsharded card run's, the switch's
               kernel held against its plain version on its first launch;
               the CLI's refusal of a grid larger than the visible cards
               (the JAX package's message); two CLI processes on the card
               with --shard-subset 0 and 1 joined by --distributed,
               merged by merge_m8 into the full run's bytes
    trace_dir -- (in the scale phase) the BLASTP search again on the
               resident index with --trace-dir under build/: a non-empty
               chrome trace naming K1's kernel, the m8 unchanged
13. scale_stream -- the scale search with --db-stream 4 (the index on the
               host as four shards uploaded per pass): m8 == the resident
               run's, device-memory peak below the resident search's;
               q/s, split, upload seconds per pass, K1 held
14. scale_pigeon -- the scale search with --seed-delta 2, resident and
               with --db-stream 4: byte-equal m8 unless a budget
               truncation was accepted (printed); q/s, split, hits
               located, overflow stats, retries, homolog share, K1 held
15. scale_mesh -- the scale search over grids laid on the one card,
               --db-shards 4 (1 x 4) and --q-shards 2 --db-shards 2
               (2 x 2): m8 == the resident run's; q/s, split, K1 launches
               per cell, K1 held, shard set-up seconds, device-memory
               peak

then the kernels line (K1-K4, S1, S2) and, last, {"ok": true, "device": {...}}.
Kernel ``ms`` is the call as issued (CUDA events around the wrapper's
call, the measure of every record of this script); ``device_ms`` beside
it is the device's work alone (the stream held busy by a spin while the
call is enqueued), which leaves out the wrapper's host time.

    python3 chip_smoke.py --warp-sweep

times K1 and K2 (device ms) at every group width on a (B, D) grid: the
measurements behind ops/sw_band.py:warp_config.

    python3 chip_smoke.py --rect-sweep

times K4 (device ms) at the k4 phase's cases for every run length R
whose strips cover M in at most 16 warps: the measurements behind
ops/sw_rect.py:rect_config.
"""

from __future__ import annotations

import concurrent.futures
import contextlib
import ctypes
import json
import os
import re
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

REPO = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12          # H100 SXM data sheet
INT32_LANES_PER_SM = 64            # Hopper white paper: 64 INT32 units/SM
# int32 operations per needed cell of the function each kernel computes
# (not of how it computes it): the affine SW recurrence of K1, K3 and K4
# needs 5 adds + 6 maxes (E, diag, H before F, F, H, best); K2 must also
# produce the code and the end-cell key (7 adds, 5 maxes, 10 compares)
OPS_PER_CELL = 11
K2_OPS_PER_CELL = 22
# ... or, with DPX, 7 instructions (csrc/int_rate.cu's header); the
# bounds take whichever of the two the card runs faster
DPX_CELL_INSTR = 7
KERNELS = ("sw_band", "sw_band_dirs", "sw_band_sub", "sw_rect",
           "searchsorted", "slot_walk")
# the rate probe's modes (csrc/int_rate.cu): name, instructions per thread
# and iteration
RATE_MODES = (("add", 8), ("max", 8), ("viaddmax", 8), ("viaddmax_relu", 8),
              ("dpx_cell", 4 * DPX_CELL_INSTR))
AA = "ARNDCQEGHILKMFPSTWYV"
GYRA = (
    "MSDLAREITPVNIEEELKSSYLDYAMSVIVGRALPDVRDGLKPVHRRVLYAMNVLGNDWNKAYKKSARVVG"
    "DVIGKYHPHGDSAVYDTIVRMAQPFSLRYMLVDGQGNFGSIDGDSAAAMRYTEIRLAKIAHELMADLEKET"
    "VDFVDNYDGTEKIPDVMPTKIPNLLVNGSSGIAVGMATNIPPHNLTEVINGCLAYIDDEDISIEGLMEHIP"
    "GPDFPTAAIINGRRGIEEAYRTGRGKVYIRARAEVEVDAKTGRETIIVHEIPYQVNKARLIEKIAELVKEK"
    "RVEGISALRDESDKDGMRIVIEVKRDAVGEVVLNNLYSQTQLQVSFGINMVALHHGQPKIMNLKDIIAAF"
    "VRHRREVVTRRTIFELRKARDRAHILEALAVALANIDPIIELIRHAPTPAEAKTALVANPWQLGNVAAML"
    "ERAGDDAARPEWLEPEFGVRDGLYYLTEQQAQAILDLRLQKLTGLEHEKLLDEYKELLDQIAELLRILGSA"
    "DRLMEVIREELELVREQFGDKRRTEITAN")


def emit(**kw) -> None:
    print(json.dumps(kw), flush=True)


def smi(query: str) -> str:
    return subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.splitlines()[0]


# ---------------------------------------------------------------- phases


def phase_device() -> dict:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false")
    line = smi("name,power.limit")
    print(line, flush=True)
    mhz = float(smi("clocks.max.sm").split()[0])
    props = torch.cuda.get_device_properties(0)
    int32_rate = props.multi_processor_count * INT32_LANES_PER_SM * mhz * 1e6
    emit(phase="device", nvidia_smi=line, kind=torch.cuda.get_device_name(0),
         count=torch.cuda.device_count(), sms=props.multi_processor_count,
         max_sm_mhz=mhz, int32_ops_per_s=int32_rate,
         torch=torch.__version__, cuda=torch.version.cuda)
    return dict(smi=line, int32_rate=int32_rate,
                sms=props.multi_processor_count, mhz=mhz)


def phase_build() -> None:
    from lambda_tpu_torch import native
    from lambda_tpu_torch.ops import _build

    def timed(fn):
        t0 = time.perf_counter()
        fn()
        return time.perf_counter() - t0

    with concurrent.futures.ThreadPoolExecutor(len(KERNELS) + 1) as ex:
        jobs = {name: ex.submit(timed, lambda n=name: _build.load(n))
                for name in KERNELS + ("int_rate",)}
        host = ex.submit(timed, native.get_lib)
        nvcc_s = {name: round(job.result(), 2) for name, job in jobs.items()}
        host_s = host.result()
    ptxas = {name: [ln.strip() for ln in _build.build_logs.get(name, "")
                    .splitlines() if "registers" in ln or "spill" in ln]
             for name in KERNELS}
    k3 = k3_ptxas(_build.build_logs.get("sw_band_sub", ""))
    emit(phase="build", k1_nvcc_s=nvcc_s["sw_band"], nvcc_s=nvcc_s,
         host_gxx_s=round(host_s, 2), ptxas=ptxas["sw_band"],
         ptxas_by_kernel=ptxas, k3_ptxas=k3)
    if "sw_band_sub" in _build.build_logs and len(k3) != 9:
        raise SystemExit(f"K3's ptxas report names {len(k3)} kernels, not 9")
    spilled = [r for r in k3 if not r["scratch"]
               and (r["stack"] or r["spill_stores"] or r["spill_loads"])]
    if spilled:
        raise SystemExit(f"K3's register path uses local memory: {spilled}")


def k3_ptxas(log: str) -> list:
    """K3's ptxas report per instantiation (band offsets WP per register
    chunk, scratch path or not): registers, stack frame and spill bytes.
    Empty when the library was already built (no compiler output)."""
    rows, cur = [], None
    for ln in log.splitlines():
        m = re.search(r"Function properties for \S*sw_band_sub_kernel"
                      r"ILi(\d+)ELb([01])E", ln)
        if m:
            cur = dict(WP=int(m.group(1)), scratch=m.group(2) == "1")
            rows.append(cur)
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", ln)
        if m and cur is not None:
            cur.update(stack=int(m.group(1)), spill_stores=int(m.group(2)),
                       spill_loads=int(m.group(3)))
            continue
        m = re.search(r"Used (\d+) registers", ln)
        if m and cur is not None and "registers" not in cur:
            cur["registers"] = int(m.group(1))
    return rows


# cycles of the spin that holds the stream busy before a device-time
# measurement: about 1 ms at the H100's 1.98 GHz, more than the host
# needs to enqueue one call of a kernel's wrapper
SPIN_CYCLES = 2_000_000


def time_ms(fn, reps: int, device: bool = False) -> float:
    """Median CUDA-event time of ``fn`` (after one warm-up call).  By
    default the events bracket the call as the host issues it, so a
    kernel shorter than its wrapper's host time is timed at the host's
    pace (the records' earlier kernel times).  ``device``: the stream is first
    held busy by a spin, so the whole call is enqueued before the first
    event fires and the events bracket the device's work alone."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        if device:
            torch.cuda._sleep(SPIN_CYCLES)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return float(np.median(times))


def kernel_times(fn, reps: int) -> dict:
    """``ms``: the time of the call as issued (every record's measure);
    ``device_ms``: the device's work alone."""
    return dict(ms=time_ms(fn, reps),
                device_ms=time_ms(fn, reps, device=True))


def phase_rates(dev_info) -> None:
    """The card's int32 instruction rates from csrc/int_rate.cu (lane
    instructions per second over all SMs, and per SM and clock at the
    maximum SM clock), and the per-cell times the bounds use: a cell of
    K1-K4's function takes the least of 11 operations at the data sheet's
    int32 rate and 7 DPX-folded instructions at the measured cell rate;
    K2's code and end-cell key add 11 operations at the int32 rate
    (compares and selects have no DPX form).  Sets dev_info's
    ``cell_s`` and ``k2_cell_s``, and ``warp_sum_ns``: one warp's chain
    of int64 warp sums and adds (mode 5), per link, S2's time a slot."""
    from lambda_tpu_torch.ops import _build

    fn = _build.load("int_rate").int_rate_launch
    fn.argtypes = [ctypes.c_int] * 4 + [ctypes.c_void_p] * 3
    fn.restype = ctypes.c_int
    blocks, threads, iters = dev_info["sms"] * 4, 256, 1 << 16
    seeds = torch.tensor([-12, -1, 5, 3, 7, 1, 0, 2, -20, -30, -25, -40, 4,
                          -2, 6, -1], dtype=torch.int32, device="cuda")
    out = torch.empty(blocks * threads, dtype=torch.int32, device="cuda")
    per_clock = dev_info["sms"] * dev_info["mhz"] * 1e6
    rates, ms = {}, {}
    for mode, (name, per_iter) in enumerate(RATE_MODES):
        def launch(mode=mode):
            err = fn(mode, blocks, threads, iters, seeds.data_ptr(),
                     out.data_ptr(), torch.cuda.current_stream().cuda_stream)
            if err != 0:
                raise RuntimeError(f"int_rate mode {mode}: cudaError {err}")
        ms[name] = time_ms(launch, 5)
        rates[name] = blocks * threads * iters * per_iter / (ms[name] * 1e-3)

    def chain():
        err = fn(5, 1, 32, iters, seeds.data_ptr(), out.data_ptr(),
                 torch.cuda.current_stream().cuda_stream)
        if err != 0:
            raise RuntimeError(f"int_rate mode 5: cudaError {err}")
    ms["warp_sum_chain"] = time_ms(chain, 5, device=True)
    dev_info["warp_sum_ns"] = ms["warp_sum_chain"] * 1e6 / iters
    plain_cell_s = OPS_PER_CELL / dev_info["int32_rate"]
    dpx_cell_s = DPX_CELL_INSTR / rates["dpx_cell"]
    dev_info["cell_s"] = min(plain_cell_s, dpx_cell_s)
    dev_info["k2_cell_s"] = dev_info["cell_s"] + (
        K2_OPS_PER_CELL - OPS_PER_CELL) / dev_info["int32_rate"]
    emit(phase="rates", blocks=blocks, threads=threads, iters=iters, ms=ms,
         lane_instr_per_s=rates,
         per_sm_per_clock={k: v / per_clock for k, v in rates.items()},
         dpx_cells_per_s=rates["dpx_cell"] / DPX_CELL_INSTR,
         plain_cell_ns=plain_cell_s * 1e9, dpx_cell_ns=dpx_cell_s * 1e9,
         cell_ns=dev_info["cell_s"] * 1e9,
         k2_cell_ns=dev_info["k2_cell_s"] * 1e9,
         cell_by="dpx" if dpx_cell_s < plain_cell_s else "plain int32",
         warp_sum_ns=dev_info["warp_sum_ns"])


def timed(fn):
    """(result, CUDA-event ms) of one call of ``fn``: the plain versions
    are timed on their comparison call, not run again."""
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    a.record()
    out = fn()
    b.record()
    b.synchronize()
    return out, a.elapsed_time(b)


def k1_work(q, d_rows, pad: int, C: int, cols=None):
    """(needed in-band cells, rectangle cells, bytes moved) of one K1
    call: a row of query length L and band d needs L * (d + 1) cells;
    with ``cols`` (B,), the columns each row swept before X-drop latched
    it dead, only the cells (i, j) with j < cols."""
    qlen = (q != pad).sum(dim=1).to(torch.int64)
    d = d_rows.to(torch.int64)
    live = d >= 0
    if cols is None:
        per_row = qlen * (d + 1)
    else:
        # query position i meets columns j in [i, i + d], cut at cols
        i = torch.arange(q.shape[1], device=q.device)[None, :]
        hi = torch.minimum(i + d[:, None], cols.to(torch.int64)[:, None] - 1)
        per_row = ((hi - i + 1).clamp(min=0) * (i < qlen[:, None])).sum(1)
    cells = int(per_row[live].sum())
    rect = int((qlen * (qlen + d))[live].sum())
    B, N = q.shape
    nbytes = 2 * B * N + 4 * B + 4 * B + C * C
    return cells, rect, nbytes


def bound(cells: int, nbytes: int, dev_info, codes: bool = False) -> dict:
    """The least time the card could take: the larger of the needed cells
    at the card's per-cell time (phase_rates; ``codes``: K2's) and the
    bytes over the memory rate."""
    t_ops = cells * dev_info["k2_cell_s" if codes else "cell_s"] * 1e3
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    return dict(bound_ms=max(t_ops, t_bytes),
                bound_by="operations" if t_ops >= t_bytes else "bytes")


def k1_compare(q, s, d_rows, e8, D, gf, ge, dev_info, reps=5,
               plain_reps=1, kernel="K1", x_drop=0, nc=0) -> dict:
    """Kernel vs plain version on the same card tensors: exact equality,
    times, GCUPS and the bound.  ``kernel`` K1, or K3 (the sublane
    layout's kernel, which computes the same function without X-drop).
    ``plain_reps`` 0 times the plain version on its comparison call
    alone.  With ``x_drop`` the bound counts the cells of the columns each
    row swept, as the plain version records them."""
    from lambda_tpu_torch.ops import sw_band

    if kernel == "K1":
        def launch():
            return sw_band.sw_band_score_device(q, s, d_rows, e8, D, gf, ge,
                                                x_drop, nc)
        counter = "launches"
    else:
        def launch():
            return sw_band._sw_band_score_sub_cuda(q, s, d_rows, e8, D, gf,
                                                   ge)
        counter = "launches_sub"

    def plain():
        return sw_band.sw_band_score_torch(q, s, d_rows, e8, D, gf, ge,
                                           x_drop, nc)

    saved = getattr(sw_band, counter)
    out_k = launch()
    out_p, p_ms = timed(plain)
    err = int((out_k.to(torch.int64) - out_p.to(torch.int64)).abs().max())
    kt = kernel_times(launch, reps)
    k_ms = kt["ms"]
    if plain_reps:                     # K1's phase: median of more runs
        p_ms = time_ms(plain, plain_reps)
    setattr(sw_band, counter, saved)   # comparison launches do not count
    cols = None
    if x_drop:
        cols = sum(swept.to(torch.int64) for _, swept in sw_band._score_sweep(
            q, s, d_rows, e8, D, gf, ge, x_drop, nc))
    cells, rect, nbytes = k1_work(q, d_rows, e8.shape[0] - 1, e8.shape[0],
                                  cols)
    return dict(B=int(q.shape[0]), N=int(q.shape[1]), D=D,
                max_abs_err=err, exact_equal=err == 0,
                max_score=int(out_k.max()) if len(out_k) else 0,
                **kt, plain_ms=p_ms,
                **bound(cells, nbytes, dev_info),
                inband_cells=cells,
                rect_gcups=rect / (k_ms * 1e-3) / 1e9,
                inband_gcups=cells / (k_ms * 1e-3) / 1e9)


def k2_compare(q, s, d_rows, e8, D, gf, ge, dev_info, reps=3,
               walk_rows=256) -> dict:
    """K2 vs its plain version on the same card tensors.  Equal means:
    the same per-row scores and end cells, the same H-source bits on
    every in-band cell, the same extend bits wherever the gap value they
    describe is positive (E for bit 4, F for bit 8), and the same walked
    traces (the first ``walk_rows`` rows: the walk is host Python)."""
    from lambda_tpu_torch.ops import sw_band

    saved = sw_band.launches_dirs
    dk, bk, jk, wk = sw_band.sw_band_align_device(q, s, d_rows, e8, D, gf,
                                                  ge)
    (dp, bp, jp, wp), p_ms = timed(lambda: sw_band.sw_band_align_torch(
        q, s, d_rows, e8, D, gf, ge))
    # both write 0 off band, so equal tensors mean every in-band bit is
    # equal; only otherwise is the weaker rule evaluated
    all_bits = torch.equal(dk, dp)
    h_eq = e_eq = f_eq = all_bits
    if not all_bits:
        E, F = gap_values(q, s, d_rows, e8, D, gf, ge)
        w = torch.arange(D + 1, device=q.device)
        d64 = d_rows.to(torch.int64)
        in_band = ((w[None, None, :] >= (D - d64)[:, None, None])
                   & (d64 >= 0)[:, None, None])
        h_eq = bool((((dk ^ dp) & 3) == 0)[in_band.expand_as(dk)].all())
        e_eq = bool((((dk ^ dp) & 4) == 0)[in_band & (E > 0)].all())
        f_eq = bool((((dk ^ dp) & 8) == 0)[in_band & (F > 0)].all())
        del E, F
    err = int((bk.to(torch.int64) - bp.to(torch.int64)).abs().max())
    ends_eq = torch.equal(jk, jp) and torch.equal(wk, wp)
    n = min(walk_rows, int(q.shape[0]))
    wk_sc, wk_tr = sw_band.walk_rows(dk[:n], bk[:n], jk[:n], wk[:n], D)
    wp_sc, wp_tr = sw_band.walk_rows(dp[:n], bp[:n], jp[:n], wp[:n], D)
    traces_eq = bool((wk_sc == wp_sc).all()) and wk_tr == wp_tr
    del dp
    kt = kernel_times(lambda: sw_band.sw_band_align_device(
        q, s, d_rows, e8, D, gf, ge), reps)
    k_ms = kt["ms"]
    sw_band.launches_dirs = saved      # comparison launches do not count
    cells, _, in_bytes = k1_work(q, d_rows, e8.shape[0] - 1, e8.shape[0])
    B, N = q.shape
    nbytes = in_bytes + B * N * (D + 1) + 8 * B   # band codes, end cells
    exact = err == 0 and ends_eq and h_eq and e_eq and f_eq and traces_eq
    return dict(B=int(B), N=int(N), D=D, max_abs_err=err,
                exact_equal=exact, end_cells_equal=ends_eq,
                h_source_equal=h_eq, e_ext_equal=e_eq, f_ext_equal=f_eq,
                all_inband_bits_equal=all_bits, rows_walked=n,
                traces_equal=traces_eq,
                traces_with_gaps=sum(1 for t in wk_tr
                                     if t is not None and len(t[2]) > 1),
                max_score=int(bk.max()) if len(bk) else 0,
                **kt, plain_ms=p_ms,
                **bound(cells, nbytes, dev_info, codes=True),
                inband_cells=cells,
                inband_gcups=cells / (k_ms * 1e-3) / 1e9)


def gap_values(q, s, d_rows, e8, D, gf, ge):
    """E and F of every cell in K2's dirs layout (B, N, D+1), int32 each,
    from the plain sweep K2's plain codes come from."""
    from lambda_tpu_torch.ops import sw_band

    B, N = q.shape
    out = [torch.empty((B, N, D + 1), dtype=torch.int32, device=q.device)
           for _ in range(2)]
    for j, (_, _, _, E, _, F, _) in enumerate(sw_band._band_sweep(
            q, s, d_rows, e8, D, gf, ge)):
        out[0][:, j] = E
        out[1][:, j] = F
    return out


def k4_compare(q, s, e8, gf, ge, dev_info, reps=3, host_out=None) -> dict:
    """K4 vs its plain version on the same card tensors: exact equality
    (and of ``host_out``, the host entry point's result, when given),
    times and the bound (needed cells: real query x real window)."""
    from lambda_tpu_torch.ops import sw_rect

    saved = sw_rect.launches
    out_k = sw_rect.sw_score_device(q, s, e8, gf, ge)
    out_p, p_ms = timed(lambda: sw_rect.sw_score_torch(q, s, e8, gf, ge))
    err = int((out_k.to(torch.int64) - out_p.to(torch.int64)).abs().max())
    if host_out is not None:
        err = max(err, int(np.abs(out_p.cpu().numpy().astype(np.int64)
                                  - host_out).max()))
    kt = kernel_times(lambda: sw_rect.sw_score_device(q, s, e8, gf, ge),
                      reps)
    k_ms = kt["ms"]
    sw_rect.launches = saved           # comparison launches do not count
    pad = e8.shape[0] - 1
    qlen = (q != pad).sum(dim=1).to(torch.int64)
    slen = (s != pad).sum(dim=1).to(torch.int64)
    cells = int((qlen * slen).sum())
    B, M = q.shape
    N = s.shape[1]
    nbytes = B * M + B * N + 4 * B + e8.numel()
    bd = bound(cells, nbytes, dev_info)
    return dict(B=int(B), M=int(M), N=int(N),
                R_W_P=list(sw_rect.rect_config(int(B), int(M))),
                max_abs_err=err, exact_equal=err == 0,
                max_score=int(out_k.max()), **kt, plain_ms=p_ms, **bd,
                cells=cells, gcups=cells / (k_ms * 1e-3) / 1e9,
                device_gcups=cells / (kt["device_ms"] * 1e-3) / 1e9,
                bound_share=bd["bound_ms"] / k_ms,
                device_bound_share=bd["bound_ms"] / kt["device_ms"])


def blosum_e8():
    from lambda_tpu_torch import scoring
    from lambda_tpu_torch.ops import sw_band

    sch = scoring.make_protein_scheme(62, -11, -1)
    e8 = sw_band.ext8_from_ext32(sw_band.extend_matrix(sch.matrix))
    return e8, sch.dp_gap_first, sch.dp_gap_extend


def k1_inputs(rng, B, qbk, D, C, homolog=0.5, pad_rows=0.05):
    """Main-path-shaped K1 inputs: per-row query lengths in (qbk/2, qbk],
    band sizes in [0, D] (some exactly D, some -1 padding rows), windows
    of qlen + d_row real ranks (PAD beyond), half of them homologous."""
    N = qbk + D
    pad = C - 1
    qlen = rng.integers(qbk // 2 + 1, qbk + 1, B)
    d = rng.integers(0, D + 1, B)
    d[rng.random(B) < 0.3] = D
    d[rng.random(B) < pad_rows] = -1
    q = np.full((B, N), pad, np.int8)
    s = np.full((B, N), pad, np.int8)
    for b in range(B):
        L = int(qlen[b])
        q[b, :L] = rng.integers(0, 20, L)
        W = L + max(int(d[b]), 0)
        s[b, :W] = rng.integers(0, 20, W)
        if rng.random() < homolog:
            off = int(rng.integers(0, max(int(d[b]), 0) + 1))
            s[b, off:off + L] = q[b, :L]
            mut = rng.integers(0, L, L // 8)
            s[b, off + mut] = rng.integers(0, 20, len(mut))
    return q, s, d.astype(np.int32)


def phase_k1(dev_info) -> dict:
    from lambda_tpu_torch.ops import sw_band

    rng = np.random.default_rng(7)
    e8_np, gf, ge = blosum_e8()
    dev = torch.device("cuda")
    e8 = torch.as_tensor(e8_np, device=dev)
    C = e8_np.shape[0]
    worst = 0
    for D in (7, 39, 127, 1023):
        for qbk in (64, 256, 1024):
            N = qbk + D
            B = int(min(4096, max(64, (1 << 27) // (N * (D + 1)))))
            q, s, d = k1_inputs(rng, B, qbk, D, C)
            r = k1_compare(*(torch.as_tensor(x, device=dev)
                             for x in (q, s, d)), e8, D, gf, ge, dev_info)
            worst = max(worst, r["max_abs_err"])
            emit(phase="k1", case=f"D{D}_q{qbk}", **r)
            if not r["exact_equal"]:
                raise SystemExit(f"K1 disagrees with its plain version at "
                                 f"D {D}, qlen bucket {qbk}")
    # the bench shape: B 24576, qlen 256, window 290, band 34 (bucket 39)
    B, M, D_true, D, N = 24576, 256, 34, 39, 296
    q = rng.integers(0, 20, (B, N)).astype(np.int8)
    q[:, M:] = C - 1
    s = rng.integers(0, 20, (B, N)).astype(np.int8)
    d = np.full(B, D_true, np.int32)
    bench = k1_compare(*(torch.as_tensor(x, device=dev) for x in (q, s, d)),
                       e8, D, gf, ge, dev_info, reps=10, plain_reps=3)
    # bench.py's accounting: rectangle = B * qlen * window
    bench["rect_gcups"] = B * M * (M + D_true) / (bench["ms"] * 1e-3) / 1e9
    emit(phase="k1", case="bench_shape", **bench)
    if not bench["exact_equal"]:
        raise SystemExit("K1 disagrees with its plain version at the bench "
                         "shape")
    worst = max(worst, bench["max_abs_err"])
    # D 2047: the band state in two segments of global scratch
    rng = np.random.default_rng(31)
    wide = k1_compare(*(torch.as_tensor(x, device=dev)
                        for x in k1_inputs(rng, 64, 256, 2047, C)),
                      e8, 2047, gf, ge, dev_info, reps=3)
    emit(phase="k1", case="D2047_q256", **wide)
    if not wide["exact_equal"]:
        raise SystemExit("K1 disagrees with its plain version at D 2047")
    worst = max(worst, wide["max_abs_err"])
    # X-drop per band bucket: X 5, checkpoints every 16 columns
    for D in (7, 39, 127, 1023):
        qbk = 256
        B = int(min(4096, max(64, (1 << 27) // ((qbk + D) * (D + 1)))))
        args = [torch.as_tensor(x, device=dev)
                for x in k1_inputs(rng, B, qbk, D, C)]
        r = k1_compare(*args, e8, D, gf, ge, dev_info, reps=3, x_drop=5,
                       nc=16)
        # the kernel's X-drop scores (equal to the plain version's, above)
        # against the exact ones
        changed = int((sw_band.sw_band_score_device(*args, e8, D, gf, ge, 5,
                                                    16)
                       != sw_band.sw_band_score_device(*args, e8, D, gf, ge))
                      .sum())
        worst = max(worst, r["max_abs_err"])
        emit(phase="k1", case=f"D{D}_q{qbk}_xdrop5_nc16",
             rows_changed_by_xdrop=changed, **r)
        if not r["exact_equal"] or changed == 0:
            raise SystemExit(f"K1 with X-drop disagrees with its plain "
                             f"version (or X-drop changed nothing) at D {D}")
    return dict(bench=bench, worst=worst)


def band_cases(seed: int, C: int):
    """The k1 phase's band buckets x query buckets, as card tensors."""
    rng = np.random.default_rng(seed)
    dev = torch.device("cuda")
    for D in (7, 39, 127, 1023):
        for qbk in (64, 256, 1024):
            N = qbk + D
            B = int(min(4096, max(64, (1 << 27) // (N * (D + 1)))))
            yield D, qbk, [torch.as_tensor(x, device=dev)
                           for x in k1_inputs(rng, B, qbk, D, C)]


def phase_k2(dev_info) -> dict:
    e8_np, gf, ge = blosum_e8()
    e8 = torch.as_tensor(e8_np, device="cuda")
    worst, rows = 0, []
    for D, qbk, (q, s, d) in band_cases(17, e8_np.shape[0]):
        r = k2_compare(q, s, d, e8, D, gf, ge, dev_info)
        worst = max(worst, r["max_abs_err"])
        rows.append(r)
        emit(phase="k2", case=f"D{D}_q{qbk}", **r)
        if not r["exact_equal"]:
            raise SystemExit(f"K2 disagrees with its plain version at D {D}, "
                             f"qlen bucket {qbk}")
    rng = np.random.default_rng(37)
    q, s, d = (torch.as_tensor(x, device="cuda")
               for x in k1_inputs(rng, 64, 256, 2047, e8_np.shape[0]))
    r = k2_compare(q, s, d, e8, 2047, gf, ge, dev_info, walk_rows=64)
    worst = max(worst, r["max_abs_err"])
    emit(phase="k2", case="D2047_q256", **r)
    if not r["exact_equal"]:
        raise SystemExit("K2 disagrees with its plain version at D 2047")
    return dict(worst=worst)


def phase_grid(dev_info) -> list:
    """K1 and K3 side by side on a (B, D) grid at query bucket 128, each
    held against the plain version; recorded for choosing between them
    by shape, used for nothing here."""
    rng = np.random.default_rng(41)
    e8_np, gf, ge = blosum_e8()
    e8 = torch.as_tensor(e8_np, device="cuda")
    rows = []
    grid = [(B, D) for D in (23, 39, 127) for B in (256, 512, 2048, 24576)]
    for B, D in grid + [(256, 1023), (2048, 1023)]:
        args = [torch.as_tensor(x, device="cuda")
                for x in k1_inputs(rng, B, 128, D, e8_np.shape[0])]
        r1 = k1_compare(*args, e8, D, gf, ge, dev_info, reps=5, plain_reps=0)
        r3 = k1_compare(*args, e8, D, gf, ge, dev_info, reps=5, plain_reps=0,
                        kernel="K3")
        row = dict(B=B, D=D, N=128 + D, k1_ms=r1["ms"], k3_ms=r3["ms"],
                   k1_device_ms=r1["device_ms"], k3_device_ms=r3["device_ms"],
                   bound_ms=r1["bound_ms"], k3_over_k1=r3["ms"] / r1["ms"],
                   k3_over_k1_device=r3["device_ms"] / r1["device_ms"],
                   exact_equal=r1["exact_equal"] and r3["exact_equal"])
        rows.append(row)
        emit(phase="grid", **row)
        if not row["exact_equal"]:
            raise SystemExit(f"K1 or K3 disagrees with the plain version at "
                             f"B {B}, D {D}")
    return rows


def phase_k3(dev_info) -> dict:
    from lambda_tpu_torch.ops import sw_band

    e8_np, gf, ge = blosum_e8()
    dev = torch.device("cuda")
    e8 = torch.as_tensor(e8_np, device=dev)
    worst = 0
    for D, qbk, (q, s, d) in band_cases(19, e8_np.shape[0]):
        r = k1_compare(q, s, d, e8, D, gf, ge, dev_info, plain_reps=0,
                       kernel="K3")
        worst = max(worst, r["max_abs_err"])
        emit(phase="k3", case=f"D{D}_q{qbk}", **r)
        if not r["exact_equal"]:
            raise SystemExit(f"K3 disagrees with K1's plain version at D {D}, "
                             f"qlen bucket {qbk}")
    rng = np.random.default_rng(23)
    B, M, D_true, D, N = 24576, 256, 34, 39, 296
    C = e8_np.shape[0]
    q = rng.integers(0, 20, (B, N)).astype(np.int8)
    q[:, M:] = C - 1
    s = rng.integers(0, 20, (B, N)).astype(np.int8)
    d = np.full(B, D_true, np.int32)
    bench = k1_compare(*(torch.as_tensor(x, device=dev) for x in (q, s, d)),
                       e8, D, gf, ge, dev_info, reps=10, plain_reps=0,
                       kernel="K3")
    bench["rect_gcups"] = B * M * (M + D_true) / (bench["ms"] * 1e-3) / 1e9
    emit(phase="k3", case="bench_shape",
         WP_S_blocks=list(sw_band.sub_config(B, D)), **bench)
    if not bench["exact_equal"]:
        raise SystemExit("K3 disagrees with K1's plain version at the bench "
                         "shape")
    worst = max(worst, bench["max_abs_err"])
    # both edges of every register bucket (W = D + 1 = 8k, 8k + 1), the
    # first scratch widths (65; 128, 129), at a B that is no multiple of
    # 32 with padding rows
    for W in (8, 9, 16, 17, 24, 25, 32, 33, 40, 41, 48, 49, 56, 57, 64, 65,
              128, 129):
        q, s, d = k1_inputs(rng, 333, 64, W - 1, C)
        d[[0, 100, 332]] = -1
        r = k1_compare(*(torch.as_tensor(x, device=dev) for x in (q, s, d)),
                       e8, W - 1, gf, ge, dev_info, reps=3, plain_reps=0,
                       kernel="K3")
        worst = max(worst, r["max_abs_err"])
        emit(phase="k3", case=f"edge_W{W}",
             WP_S_blocks=list(sw_band.sub_config(333, W - 1)), **r)
        if not r["exact_equal"]:
            raise SystemExit(f"K3 disagrees with K1's plain version at band "
                             f"width {W}")
    return dict(bench=bench, worst=worst)


def k4_inputs(rng, B: int, M: int, C: int, N: int = 0):
    """Rectangle inputs: query lengths in (M/2, M], windows of 2 M columns
    holding (M, 2M] real ranks, half of them with a mutated copy of the
    query; PAD (C - 1) trailing.  With ``N`` (< M / 2): windows of N
    columns holding (N/2, N] real ranks, half of them a mutated piece of
    the query."""
    pad = C - 1
    q = np.full((B, M), pad, np.int8)
    s = np.full((B, N or 2 * M), pad, np.int8)
    for b in range(B):
        L = int(rng.integers(M // 2 + 1, M + 1))
        S = int(rng.integers(N // 2 + 1, N + 1) if N
                else rng.integers(M + 1, 2 * M + 1))
        q[b, :L] = rng.integers(0, 20, L)
        s[b, :S] = rng.integers(0, 20, S)
        if b % 2 == 0:
            n = min(L, S)
            off = int(rng.integers(0, S - n + 1))
            src = int(rng.integers(0, L - n + 1)) if N else 0
            s[b, off:off + n] = q[b, src:src + n]
            mut = rng.integers(0, n, n // 8)
            s[b, off + mut] = rng.integers(0, 20, len(mut))
    return q, s


def warp_sweep() -> None:
    """``--warp-sweep``: K1 and K2 device times at every group width G on
    a (B, D) grid (query bucket 128; at B 530, D 23 also 256, for the
    cost of a column), the measurements ops/sw_band.py:warp_config's rule
    was fitted to; each line marks the rule's own choice."""
    from lambda_tpu_torch.ops import sw_band

    rng = np.random.default_rng(5)
    e8_np, gf, ge = blosum_e8()
    e8 = torch.as_tensor(e8_np, device="cuda")
    C = e8_np.shape[0]
    rule = sw_band.warp_config
    grid = [(B, D, 128) for D in (7, 23, 39, 127, 255, 1023)
            for B in (64, 256, 530, 2048, 8192, 24576)
            if D < 255 or B <= 8192] + [(530, 23, 256)]
    try:
        for B, D, qbk in grid:
            N = qbk + D
            q = rng.integers(0, 20, (B, N)).astype(np.int8)
            q[:, qbk:] = C - 1
            s = rng.integers(0, 20, (B, N)).astype(np.int8)
            args = [torch.as_tensor(x, device="cuda")
                    for x in (q, s, np.full(B, D, np.int32))]
            row = dict(B=B, D=D, N=N, k1_rule=rule(B, D)[:2],
                       k2_rule=rule(B, D, dirs=True)[:2])
            for G in (4, 8, 16, 32):
                need = -(-(D + 1) // G)
                if need > 32:
                    continue
                for name, dirs, rs in (("k1", False, sw_band.R_SCORE),
                                       ("k2", True, sw_band.R_DIRS)):
                    R = next(r for r in rs if r >= need)
                    if dirs and B * N * G * R > 3e9:   # dirs bytes
                        continue
                    sw_band.warp_config = (lambda B_, D_, dirs=False, G=G,
                                           R=R: (G, R, 1))
                    fn = (sw_band.sw_band_align_device if dirs
                          else sw_band.sw_band_score_device)
                    row[f"{name}_G{G}_R{R}_device_ms"] = time_ms(
                        lambda: fn(*args, e8, D, gf, ge), 5, device=True)
                    sw_band.warp_config = rule
            emit(phase="warp_sweep", **row)
    finally:
        sw_band.warp_config = rule


def k4_cases(C: int) -> list:
    """The k4 phase's (q, s) inputs: M 128, 512 and 2048 with windows up
    to 2 M, B from 2,048 down to 64 (about 2^28 rectangle cells at most);
    M 1000 (eight strips of 128, the top one ragged); M_MAX with B 16
    and 64-column windows (16 strips of 1,024)."""
    from lambda_tpu_torch.ops import sw_rect

    rng = np.random.default_rng(29)
    cases = []
    for M in (128, 512, 2048, 1000):
        B = int(max(64, min(2048, (1 << 28) // (M * 2 * M))))
        cases.append(k4_inputs(rng, B, M, C))
    cases.append(k4_inputs(rng, 16, sw_rect.M_MAX, C, N=64))
    return cases


def rect_sweep() -> None:
    """``--rect-sweep``: K4 device times at the k4 phase's cases for each
    run length R whose strips cover M in at most 16 warps, leaving no
    half of a strip empty (the measurements ops/sw_rect.py:rect_config's
    rule was set from); each line marks the rule's own choice."""
    from lambda_tpu_torch.ops import sw_rect

    e8_np, gf, ge = blosum_e8()
    e8 = torch.as_tensor(e8_np, device="cuda")
    rule = sw_rect.rect_config
    try:
        for q, s in k4_cases(e8_np.shape[0]):
            qt, st = (torch.as_tensor(x, device="cuda") for x in (q, s))
            B, M = q.shape
            row = dict(B=B, M=M, N=s.shape[1], rule=list(rule(B, M)))
            for R in sw_rect.R_RECT:
                W = -(-M // (32 * R))
                if W > sw_rect.MAX_STRIPS or (R > 1 and M <= 32 * R // 2):
                    continue
                sw_rect.rect_config = (lambda B_, M_, R=R, W=W:
                                       (R, W, max(1, 4 // W)))
                row[f"R{R}_W{W}_device_ms"] = time_ms(
                    lambda: sw_rect.sw_score_device(qt, st, e8, gf, ge), 5,
                    device=True)
                sw_rect.rect_config = rule
            emit(phase="rect_sweep", **row)
    finally:
        sw_rect.rect_config = rule


def phase_k4(dev_info) -> dict:
    """K4 through its op entry point (the host API ``sw_score``, launches
    counted from 0), then each case's kernel against the plain version."""
    from lambda_tpu_torch.ops import sw_rect

    e8_np, gf, ge = blosum_e8()
    cases = k4_cases(e8_np.shape[0])
    sw_rect.launches = 0                       # the op's path starts
    host = [sw_rect.sw_score(q, s, e8_np, gf, ge, device="cuda")
            for q, s in cases]
    launches = sw_rect.launches                # ... and ends
    e8 = torch.as_tensor(e8_np, device="cuda")
    rows = []
    for (q, s), h in zip(cases, host):
        qt, st = (torch.as_tensor(x, device="cuda") for x in (q, s))
        r = k4_compare(qt, st, e8, gf, ge, dev_info, host_out=h)
        rows.append(r)
        emit(phase="k4", case=f"M{r['M']}", **r)
        if not r["exact_equal"]:
            raise SystemExit(f"K4 disagrees with its plain version at M "
                             f"{r['M']}")
    if launches != len(cases):
        raise SystemExit(f"the op's host entry launched K4 {launches} times "
                         f"for {len(cases)} calls")
    return dict(launches=launches, rows=rows)


def run_cli(*args) -> None:
    from lambda_tpu_torch import cli

    rc = cli.main([str(a) for a in args])
    if rc != 0:
        raise SystemExit(f"lambda_tpu_torch.cli {args[0]} exited {rc}")


def write_fasta(path, recs) -> None:
    from lambda_tpu_torch.io import fasta

    fasta.write_fasta(path, [fasta.SeqRecord(i, s.encode()) for i, s in recs])


# pass-2 / pass-1 switches of searchp and the launch counter of the
# kernel each one routes to
MODES = {"default": "launches", "device_trace": "launches_dirs",
         "sublane": "launches_sub"}
# rounds of reruns of all three modes after the scale phase's main run
RERUN_ROUNDS = 3


@contextlib.contextmanager
def switched(mode: str):
    """``device_trace``: LAMBDA_SW_TRACE=device (read at call time, pass 2
    through K2); ``sublane``: the pass-1 layout that ops/sw_band.py latches
    from LAMBDA_SWB_LAYOUT at import, set on the module (K3)."""
    from lambda_tpu_torch.ops import sw_band

    env, layout = os.environ.get("LAMBDA_SW_TRACE"), sw_band._LAYOUT
    if mode == "device_trace":
        os.environ["LAMBDA_SW_TRACE"] = "device"
    elif mode == "sublane":
        sw_band._LAYOUT = "sublane"
    try:
        yield
    finally:
        sw_band._LAYOUT = layout
        if env is None:
            os.environ.pop("LAMBDA_SW_TRACE", None)
        else:
            os.environ["LAMBDA_SW_TRACE"] = env


def band_launches() -> dict:
    from lambda_tpu_torch.ops import sw_band

    return {c: getattr(sw_band, c) for c in MODES.values()}


def reset_band_launches() -> None:
    from lambda_tpu_torch.ops import sw_band

    for c in MODES.values():
        setattr(sw_band, c, 0)


def revcomp(dna: str) -> str:
    return dna.translate(str.maketrans("ACGTN", "TGCAN"))[::-1]


def _codons() -> dict:
    """Amino-acid letter -> its codons under the standard genetic code,
    in the code table's order (DNA4 ranks ACGT, first base slowest)."""
    from lambda_tpu_torch import alphabets as ab

    aas = ab.decode(ab.CODON_TABLE_STD, ab.AMINO_ACID)
    out: dict = {}
    for i, aa in enumerate(aas):
        out.setdefault(aa, []).append(
            "ACGT"[i // 16] + "ACGT"[(i // 4) % 4] + "ACGT"[i % 4])
    return out


def rev_translate(prot: str) -> str:
    """The first codon of each residue (the recipe of tests/test_e2e.py)."""
    codons = _codons()
    return "".join(codons[c][0] for c in prot)


# the cases of tests/test_golden.py: name, mkindex and search subcommand,
# output suffix
GOLDEN_CASES = [
    ("blastp_m8", "mkindexp", "searchp", ".m8"),
    ("blastp_m9", "mkindexp", "searchp", ".m9"),
    ("blastp_m0", "mkindexp", "searchp", ".m0"),
    ("blastp_sam", "mkindexp", "searchp", ".sam"),
    ("blastn_m8", "mkindexn", "searchn", ".m8"),
    ("blastn_m0", "mkindexn", "searchn", ".m0"),
    ("blastn_sam", "mkindexn", "searchn", ".sam"),
    ("blastx_m8", "mkindexp", "searchp", ".m8"),
    ("blastx_m0", "mkindexp", "searchp", ".m0"),
    ("tblastn_m8", "mkindexp", "searchp", ".m8"),
    ("tblastn_m0", "mkindexp", "searchp", ".m0"),
    ("tblastx_m0", "mkindexp", "searchp", ".m0"),
    ("bs_m8", "mkindexbs", "searchbs", ".m8"),
]


def golden_fixtures(d: Path) -> dict:
    """The inputs of tests/test_golden.py (its ``_fixtures`` recipe, the
    same bytes): {case: (database, queries)}."""
    rng = np.random.default_rng(1234)
    pdb, pq = d / "pdb.fasta", d / "pq.fasta"
    write_fasta(pdb, [("GYRA_ECOLI gyrase subunit A", GYRA),
                      ("SECOND_PROT some other protein",
                       GYRA[200:420] + GYRA[10:90])])
    frag2 = GYRA[200:280]
    write_fasta(pq, [("pq1", GYRA[50:130]),
                     ("pq2", frag2[:30] + "AG" + frag2[32:])])
    ndbseq = "".join(rng.choice(list("ACGT"), 600))
    ndb, nq = d / "ndb.fasta", d / "nq.fasta"
    write_fasta(ndb, [("nsubj1", ndbseq)])
    write_fasta(nq, [("nq_plus", ndbseq[100:170]),
                     ("nq_minus", revcomp(ndbseq[300:370]))])
    xq = d / "xq.fasta"
    write_fasta(xq, [("xq1", "GG" + rev_translate(GYRA[30:90]))])
    tdb, tq = d / "tdb.fasta", d / "tq.fasta"
    write_fasta(tdb, [("GYRA_DNA", rev_translate(GYRA[:160]))])
    write_fasta(tq, [("tq1", GYRA[20:100])])
    xxq = d / "xxq.fasta"
    write_fasta(xxq, [("xxq1", rev_translate(GYRA[40:100]))])
    bs_g = "".join(rng.choice(list("ACGT"), 400))
    bdb, bq = d / "bdb.fasta", d / "bq.fasta"
    write_fasta(bdb, [("chrB", bs_g)])
    write_fasta(bq, [("bs_read", bs_g[100:180].replace("C", "T"))])
    out = {c: (pdb, pq) for c in ("blastp_m8", "blastp_m9", "blastp_m0",
                                  "blastp_sam")}
    out.update({c: (ndb, nq) for c in ("blastn_m8", "blastn_m0",
                                       "blastn_sam")})
    out.update(blastx_m8=(pdb, xq), blastx_m0=(pdb, xq),
               tblastn_m8=(tdb, tq), tblastn_m0=(tdb, tq),
               tblastx_m0=(tdb, xxq), bs_m8=(bdb, bq))
    return out


# the environment of each golden child process: the sublane layout is
# latched when ops/sw_band.py is imported
GOLDEN_ENV = {"default": {}, "device_trace": {"LAMBDA_SW_TRACE": "device"},
              "sublane": {"LAMBDA_SWB_LAYOUT": "sublane"}}


def phase_golden(tmp: Path) -> dict:
    """All 13 golden cases on the card, once per switch: one child
    process per switch (``--golden-child``), the three at once.  Returns
    each switch's launches of its kernel."""
    procs = {}
    for mode, env in GOLDEN_ENV.items():
        d = tmp / f"golden_{mode}"
        d.mkdir()
        procs[mode] = subprocess.Popen(
            [sys.executable, str(Path(__file__).resolve()), "--golden-child",
             mode, str(d)], env=dict(os.environ, **env),
            stdout=subprocess.PIPE, text=True)
    counts, failed = {}, []
    for mode, proc in procs.items():
        out, _ = proc.communicate()
        for line in out.splitlines():
            print(line, flush=True)
            if line.startswith("{"):
                rec = json.loads(line)
                counts[mode] = rec.get(MODES[mode], 0)
        if proc.returncode != 0:
            failed.append((mode, proc.returncode))
    if failed:
        raise SystemExit(f"golden child processes failed: {failed}")
    return counts


def golden_child(mode: str, d: Path) -> None:
    """One switch's golden run: mkindex and search of every case through
    the port's CLI on the card, each output byte-equal to tests/golden/,
    and the switch's kernel launched."""
    from lambda_tpu_torch.ops import sw_band

    fixtures = golden_fixtures(d)
    lits: dict = {}
    for name, mk, _, _ in GOLDEN_CASES:
        db = fixtures[name][0]
        if (db, mk) not in lits:
            lits[(db, mk)] = d / f"{db.stem}_{mk}.lit"
            run_cli(mk, "-d", db, "-i", lits[(db, mk)], "-v", "0")
    reset_band_launches()                  # this path starts
    equal = {}
    for name, mk, se, suffix in GOLDEN_CASES:
        db, q = fixtures[name]
        out = d / f"{name}{suffix}"
        run_cli(se, "-q", q, "-i", lits[(db, mk)], "-o", out,
                "--version-to-outputfile", "0", "-v", "0",
                "--device", "cuda")
        got = re.sub(rb"(Database: ).*", rb"\1<path>", out.read_bytes())
        equal[name] = got == (REPO / "tests" / "golden"
                              / f"{name}{suffix}").read_bytes()
    n = band_launches()                    # ... and ends
    emit(phase="golden", mode=mode, cases=len(equal),
         all_equal=all(equal.values()), equal=equal,
         layout=sw_band._LAYOUT, **n)
    if not all(equal.values()):
        raise SystemExit(f"golden outputs differ ({mode}): "
                         f"{[k for k, v in equal.items() if not v]}")
    if n[MODES[mode]] <= 0:
        raise SystemExit(f"the golden searches ({mode}) launched their "
                         "kernel no time")


def synthetic_db(rng, n_subj: int, length: int):
    letters = np.frombuffer(AA.encode(), np.uint8)
    return letters[rng.integers(0, 20, (n_subj, length))]


def query_mix(rng, db, n_q: int):
    """bench_e2e.py's BLAST-shaped mix: 70 % homolog fragments (120 aa,
    12 substitutions) named after their source subject, 30 % random."""
    letters = np.frombuffer(AA.encode(), np.uint8)
    recs = []
    for i in range(n_q):
        if i % 10 < 7:
            src = int(rng.integers(0, len(db)))
            st = int(rng.integers(0, db.shape[1] - 120))
            frag = db[src, st:st + 120].copy()
            frag[rng.integers(0, 120, 12)] = letters[rng.integers(0, 20, 12)]
            recs.append((f"hom{i}_s{src}", frag.tobytes().decode()))
        else:
            recs.append((f"rnd{i}",
                         letters[rng.integers(0, 20, 120)].tobytes().decode()))
    return recs


# X of the card_cpu phase's X-drop run
CARD_CPU_XDROP = 10


def phase_card_cpu(tmp: Path, tag: str = "") -> None:
    """The same queries with --device cuda and --device cpu: byte-equal
    m8.  ``tag`` "xdrop": the run of the child process under
    LAMBDA_SW_XDROP (the database and queries of the first run), which
    also reports K1's launches and whether X-drop changed the m8."""
    from lambda_tpu_torch.ops import sw_band

    lit = tmp / "small.lit"
    if not tag:
        rng = np.random.default_rng(11)
        db = synthetic_db(rng, 500, 400)
        write_fasta(tmp / "small.fasta",
                    [(f"s{i}", r.tobytes().decode())
                     for i, r in enumerate(db)])
        write_fasta(tmp / "small_q.fasta", query_mix(rng, db, 256))
        run_cli("mkindexp", "-d", tmp / "small.fasta", "-i", lit, "-v", "0")
    outs, secs, k1_launches = {}, {}, None
    for dev in ("cuda", "cpu"):
        out = tmp / f"small_{dev}{tag}.m8"
        reset_band_launches()
        t0 = time.perf_counter()
        run_cli("searchp", "-q", tmp / "small_q.fasta", "-i", lit, "-o", out,
                "-v", "0", "--device", dev)
        secs[dev] = round(time.perf_counter() - t0, 3)
        outs[dev] = out.read_bytes()
        if dev == "cuda":
            k1_launches = sw_band.launches
    same = outs["cuda"] == outs["cpu"]
    extra = {}
    if tag:
        extra = dict(x_drop=sw_band._XDROP, k1_launches=k1_launches,
                     m8_differs_from_exact=outs["cuda"]
                     != (tmp / "small_cuda.m8").read_bytes())
    emit(phase="card_cpu" + (f"_{tag}" if tag else ""), db_residues=200000,
         queries=256, m8_equal=same, m8_lines=outs["cuda"].count(b"\n"),
         seconds=secs, **extra)
    if not same or not outs["cuda"]:
        raise SystemExit(f"card and CPU m8 differ (or are empty) {tag}")
    if tag and (sw_band._XDROP <= 0 or not k1_launches):
        raise SystemExit("the X-drop run did not launch K1 with X-drop")


def coding_dna(rng, prot: str) -> str:
    """A DNA sequence coding for ``prot`` under the standard genetic code,
    a random synonymous codon per residue."""
    codons = _codons()
    return "".join(codons[c][k % len(codons[c])]
                   for c, k in zip(prot, rng.integers(0, 6, len(prot))))


def blastx_reads(rng, db, n_q: int, aa: int = 100):
    """DNA reads of 3 * ``aa`` nt: 70 % reverse translations (a random
    synonymous codon per residue, standard code) of ``aa``-residue
    fragments of database subjects carrying aa // 8 substitutions, every
    other one reverse-complemented, named after their source subject and
    strand; 30 % random DNA."""
    letters = np.frombuffer(AA.encode(), np.uint8)
    nt = np.frombuffer(b"ACGT", np.uint8)
    recs = []
    for i in range(n_q):
        if i % 10 < 7:
            src = int(rng.integers(0, len(db)))
            st = int(rng.integers(0, db.shape[1] - aa))
            frag = db[src, st:st + aa].copy()
            frag[rng.integers(0, aa, aa // 8)] = \
                letters[rng.integers(0, 20, aa // 8)]
            dna = coding_dna(rng, frag.tobytes().decode())
            strand = "-" if i % 2 else "+"
            recs.append((f"hom{i}_s{src}_{strand}",
                         revcomp(dna) if i % 2 else dna))
        else:
            recs.append((f"rnd{i}",
                         nt[rng.integers(0, 4, 3 * aa)].tobytes().decode()))
    return recs


# the card_cpu phase's other modes: mkindex and search subcommands
CARD_CPU_MODES = {"blastn": ("mkindexn", "searchn"),
                  "blastx": ("mkindexp", "searchp"),
                  "tblastn": ("mkindexp", "searchp"),
                  "tblastx": ("mkindexp", "searchp"),
                  "bisulfite": ("mkindexbs", "searchbs")}


def mode_inputs(mode: str, n_q: int = 128):
    """(database records, query records) of one mode's card_cpu run: a
    database of 2 x 10^5 characters (residues for BLASTX, nucleotides
    for the DNA databases) and ``n_q`` queries, 70 % made from seeded
    fragments of the database and 30 % random, both strands."""
    rng = np.random.default_rng(
        {"blastn": 21, "blastx": 22, "tblastn": 23, "tblastx": 23,
         "bisulfite": 24}[mode])
    nt = np.frombuffer(b"ACGT", np.uint8)
    if mode == "blastx":
        db = synthetic_db(rng, 500, 400)
        return ([(f"s{i}", r.tobytes().decode()) for i, r in enumerate(db)],
                blastx_reads(rng, db, n_q))
    if mode in ("tblastn", "tblastx"):
        # 500 coding sequences of 133 codons, every other one on the
        # minus strand; one database for both modes
        prot = synthetic_db(rng, 500, 133)
        dna = [coding_dna(rng, r.tobytes().decode()) for r in prot]
        db = [(f"d{i}", revcomp(x) if i % 2 else x)
              for i, x in enumerate(dna)]
        rng = np.random.default_rng(25 if mode == "tblastn" else 26)
        if mode == "tblastx":
            return db, blastx_reads(rng, prot, n_q, aa=60)
        recs = query_mix(rng, prot, n_q)
        return db, [(i, q[:60]) for i, q in recs]
    genome = nt[rng.integers(0, 4, (500, 400))]
    db = [(f"chr{i}", r.tobytes().decode()) for i, r in enumerate(genome)]
    recs = []
    for i in range(n_q):
        if i % 10 >= 7:
            recs.append((f"rnd{i}", nt[rng.integers(0, 4, 150)].tobytes()
                         .decode()))
            continue
        src = int(rng.integers(0, 500))
        st = int(rng.integers(0, 250))
        frag = genome[src, st:st + 150].copy()
        minus = i % 2 == 1
        if mode == "bisulfite":      # C->T (plus) or G->A (minus) at 70 %
            a, b = (b"G", b"A") if minus else (b"C", b"T")
            frag[(frag == a[0]) & (rng.random(150) < 0.7)] = b[0]
        frag[rng.integers(0, 150, 6)] = nt[rng.integers(0, 4, 6)]
        seq = frag.tobytes().decode()
        recs.append((f"hom{i}_chr{src}", revcomp(seq) if minus else seq))
    return db, recs


@contextlib.contextmanager
def capture(wrapper: str, keep, module=None):
    """Clones of the inputs of the calls of ``sw_band.<wrapper>`` (or of
    ``module.<wrapper>``) that ``keep(args, captured)`` selects; the
    calls themselves run."""
    if module is None:
        from lambda_tpu_torch.ops import sw_band as module

    launch = getattr(module, wrapper)
    captured: list = []

    def hook(*a):
        if keep(a, captured):
            captured.append(tuple(x.clone() if torch.is_tensor(x) else x
                                  for x in a))
        return launch(*a)

    setattr(module, wrapper, hook)
    try:
        yield captured
    finally:
        setattr(module, wrapper, launch)


def first(n: int):
    return lambda a, captured: len(captured) < n


def one_per_matrix(a, captured) -> bool:
    """The first launch of each matrix (bisulfite: each rev class)."""
    return not any(torch.equal(a[3], c[3]) for c in captured)


def phase_card_cpu_modes(tmp: Path, dev_info) -> dict:
    """BLASTN, BLASTX, TBLASTN, TBLASTX and bisulfite, each on its own
    2 x 10^5-character database with 128 queries, searched with --device
    cuda and --device cpu: byte-equal m8.  K1 is held against its plain
    version on BLASTN's first launch (C 6: DNA5 and PAD) and on the
    first launch of the other modes; for bisulfite K1 and K2 on the first
    launch of each rev class (forward and reverse matrix), K2 from a
    device-trace run whose m8 must equal the default run's.  Returns each
    mode's K1 launches."""
    launches = {}
    for mode, (mk, se) in CARD_CPU_MODES.items():
        db, qs = mode_inputs(mode)
        write_fasta(tmp / f"{mode}.fasta", db)
        write_fasta(tmp / f"{mode}_q.fasta", qs)
        lit = tmp / f"{mode}.lit"
        run_cli(mk, "-d", tmp / f"{mode}.fasta", "-i", lit, "-v", "0")
        keep = one_per_matrix if mode == "bisulfite" else first(1)
        outs, secs = {}, {}
        for dev in ("cuda", "cpu"):
            out = tmp / f"{mode}_{dev}.m8"
            with capture("_sw_band_score_cuda", keep) as k1_in:
                reset_band_launches()          # this path starts
                t0 = time.perf_counter()
                run_cli(se, "-q", tmp / f"{mode}_q.fasta", "-i", lit,
                        "-o", out, "-v", "0", "--device", dev)
                secs[dev] = round(time.perf_counter() - t0, 3)
                n = band_launches()            # ... and ends
            outs[dev] = out.read_bytes()
            if dev == "cuda":
                launches[mode] = n["launches"]
                k1_cuda = k1_in
        same = outs["cuda"] == outs["cpu"]
        cmp = [k1_compare(*x[:7], dev_info, reps=3, plain_reps=0)
               for x in k1_cuda]
        k2 = []
        trace_same = None
        if mode == "bisulfite":
            out = tmp / f"{mode}_cuda_trace.m8"
            with capture("_sw_band_align_cuda", one_per_matrix) as k2_in, \
                    switched("device_trace"):
                run_cli(se, "-q", tmp / f"{mode}_q.fasta", "-i", lit,
                        "-o", out, "-v", "0", "--device", "cuda")
            trace_same = out.read_bytes() == outs["cuda"]
            k2 = [k2_compare(*x, dev_info) for x in k2_in]
        emit(phase="card_cpu_modes", mode=mode, subcommands=[mk, se],
             db_chars=sum(len(x) for _, x in db), queries=len(qs),
             m8_equal=same, m8_lines=outs["cuda"].count(b"\n"),
             seconds=secs, k1_launches=launches[mode],
             alphabet_size=[int(x[3].shape[0]) for x in k1_cuda],
             device_trace_m8_equal=trace_same,
             k1_compare=[{k: c[k] for k in ("B", "N", "D", "exact_equal",
                                            "ms", "plain_ms", "bound_ms")}
                         for c in cmp],
             k2_compare=[{k: c[k] for k in ("B", "N", "D", "exact_equal",
                                            "ms", "plain_ms", "bound_ms")}
                         for c in k2])
        if not same or not outs["cuda"].strip():
            raise SystemExit(f"{mode}: card and CPU m8 differ (or are "
                             "empty)")
        if launches[mode] <= 0:
            raise SystemExit(f"{mode}: the card search launched K1 no time")
        if not all(c["exact_equal"] for c in cmp + k2):
            raise SystemExit(f"{mode}: a kernel disagrees with its plain "
                             "version")
        if mode == "blastn" and (not cmp
                                 or int(k1_cuda[0][3].shape[0]) != 6):
            raise SystemExit("blastn: K1 was not held at C 6")
        if mode == "bisulfite" and (len(cmp) != 2 or len(k2) != 2
                                    or not trace_same):
            raise SystemExit("bisulfite: K1 and K2 were not held on both "
                             "rev classes, or the device-trace m8 differs")
    return launches


def phase_card_cpu_xdrop(tmp: Path) -> None:
    """phase_card_cpu again in a child process with LAMBDA_SW_XDROP set:
    ops/sw_band.py latches the variable when it is imported."""
    env = dict(os.environ, LAMBDA_SW_XDROP=str(CARD_CPU_XDROP))
    r = subprocess.run([sys.executable, str(Path(__file__).resolve()),
                        "--card-cpu-xdrop", str(tmp)], env=env)
    if r.returncode != 0:
        raise SystemExit(f"the card_cpu X-drop run exited {r.returncode}")


# the card_cpu_paths phase's searches: name -> (database of an earlier
# card_cpu phase, search subcommand, flags); pigeonhole seeding, the
# db-stream passes and both combined
CARD_CPU_PATHS = {
    "blastp_delta2": ("small", "searchp", ["--seed-delta", "2"]),
    "blastp_delta2_full": ("small", "searchp",
                           ["--seed-delta", "2", "--seed-half-exact", "0"]),
    "blastp_delta3": ("small", "searchp", ["--seed-delta", "3"]),
    "blastn_delta2": ("blastn", "searchn",
                      ["--seed-delta", "2", "--search0", "0"]),
    "bisulfite_delta2": ("bisulfite", "searchbs",
                         ["--seed-delta", "2", "--search0", "0"]),
    "blastp_stream3": ("small", "searchp", ["--db-stream", "3"]),
    "blastp_stream3_delta2": ("small", "searchp",
                              ["--db-stream", "3", "--seed-delta", "2"]),
    "bisulfite_stream2": ("bisulfite", "searchbs", ["--db-stream", "2"]),
}


def card_cpu_search(tmp: Path, name: str, se: str, lit: Path, q: Path,
                    flags, dev_info) -> dict:
    """One search with --device cuda and --device cpu: the m8 bytes, K1's
    launches on the card (counted from 0) and K1 held against its plain
    version on the card run's first launch."""
    outs = {}
    for dev in ("cuda", "cpu"):
        out = tmp / f"{name}_{dev}.m8"
        with capture("_sw_band_score_cuda", first(1)) as k1_in:
            reset_band_launches()              # this path starts
            run_cli(se, "-q", q, "-i", lit, "-o", out, "-v", "0",
                    "--device", dev, *flags)
            n = band_launches()                # ... and ends
        outs[dev] = out.read_bytes()
        if dev == "cuda":
            launches, k1_cuda = n["launches"], k1_in
    cmp = [k1_compare(*x[:7], dev_info, reps=3, plain_reps=0, x_drop=x[7],
                      nc=x[8]) for x in k1_cuda]
    return dict(m8_equal=outs["cuda"] == outs["cpu"],
                m8_lines=outs["cuda"].count(b"\n"), k1_launches=launches,
                cmp=cmp, m8=outs["cuda"])


def phase_card_cpu_paths(tmp: Path, dev_info) -> dict:
    """Pigeonhole seeding (seed delta 2 and 3), --db-stream and
    --shard-subset on the 2 x 10^5-character databases of the card_cpu
    phases: card m8 == CPU m8 for each search of CARD_CPU_PATHS, K1 held
    against its plain version on each card run's first launch; then
    mkindexp --shards 4 of the BLASTP database, searched on the card with
    --shard-subset 0,1 and 2,3 (card == CPU for each), the two outputs
    merged by the port's merge_m8 into the full run's line set.  Returns
    each search's K1 launches."""
    from lambda_tpu_torch.tools import merge_m8

    dbs = {"small": (tmp / "small.lit", tmp / "small_q.fasta"),
           "blastn": (tmp / "blastn.lit", tmp / "blastn_q.fasta"),
           "bisulfite": (tmp / "bisulfite.lit", tmp / "bisulfite_q.fasta")}
    runs = {}
    for name, (db, se, flags) in CARD_CPU_PATHS.items():
        runs[name] = card_cpu_search(tmp, name, se, *dbs[db], flags,
                                     dev_info)
    lit4 = tmp / "small4.lit"
    run_cli("mkindexp", "-d", tmp / "small.fasta", "-i", lit4, "-v", "0",
            "--shards", "4")
    q = tmp / "small_q.fasta"
    runs["blastp_shards4_full"] = card_cpu_search(
        tmp, "blastp_shards4_full", "searchp", lit4, q, ["-n", "500"],
        dev_info)
    for sub in ("0,1", "2,3"):
        runs[f"blastp_subset{sub}"] = card_cpu_search(
            tmp, f"blastp_subset{sub.replace(',', '')}", "searchp", lit4, q,
            ["-n", "500", "--shard-subset", sub], dev_info)
    merged = tmp / "blastp_subset_merged.m8"
    merge_m8.main([str(merged), str(tmp / "blastp_subset01_cuda.m8"),
                   str(tmp / "blastp_subset23_cuda.m8")])
    full = set(runs["blastp_shards4_full"]["m8"].decode().splitlines())
    merged_equal = set(merged.read_text().splitlines()) == full
    for name, r in runs.items():
        emit(phase="card_cpu_paths", search=name,
             **{k: r[k] for k in ("m8_equal", "m8_lines", "k1_launches")},
             k1_compare=[{k: c[k] for k in ("B", "N", "D", "exact_equal",
                                            "ms", "plain_ms", "bound_ms")}
                         for c in r["cmp"]])
    emit(phase="card_cpu_paths", search="merge_m8",
         merged_equal_full=merged_equal, full_lines=len(full))
    bad = [n for n, r in runs.items() if not r["m8_equal"]
           or not r["m8"].strip() or r["k1_launches"] <= 0 or not r["cmp"]
           or not all(c["exact_equal"] for c in r["cmp"])]
    if bad:
        raise SystemExit(f"card_cpu_paths: card m8 != CPU m8, empty m8, K1 "
                         f"not launched or not exact: {bad}")
    if not merged_equal:
        raise SystemExit("card_cpu_paths: the merged --shard-subset outputs "
                         "differ from the full run's lines")
    return {n: r["k1_launches"] for n, r in runs.items()}


# the mesh_step phase's grids (q_shards, db_shards), all on the one card,
# and its demo step: seeds of 7 over a 10-letter alphabet, so that random
# seeds hit every db shard besides the planted queries
MESH_GRIDS = ((1, 1), (1, 4), (2, 2))
MESH_STEP_CFG = dict(seed_length=7, seeds_per_query=16, occ_cap=8,
                     window=64, top_k=8)
MESH_STEP_SIZE = dict(n_q=256, q_len=64, db_seq_len=4096, n_db_frames=256)


def cell_seed_hits(cfg, red_q, shards, frames, q_shards: int) -> list:
    """Per (q block, db shard) cell of a demo, the seeds of the block's
    queries that occur in the shard's frames (numpy, independent of the
    step): every seed of ``seed_length`` characters at multiples of
    ``seed_offset``."""
    k, A = cfg.seed_length, cfg.alphabet_size
    w = A ** np.arange(k, dtype=np.int64)
    starts = np.arange(cfg.seeds_per_query) * cfg.seed_offset
    seeds = np.stack([red_q[:, s:s + k].astype(np.int64) @ w
                      for s in starts], axis=1)                 # (Q, T)
    blocks = np.array_split(seeds, q_shards)
    out = []
    for blk in blocks:
        for _, fb, offs in shards:
            kmers = set()
            for f in frames[fb:fb + len(offs) - 1]:
                if len(f) >= k:
                    win = np.lib.stride_tricks.sliding_window_view(
                        f.astype(np.int64), k)
                    kmers.update((win @ w).tolist())
            out.append(int(np.isin(blk, list(kmers)).sum()))
    return out


def phase_mesh_step(dev_info) -> dict:
    """parallel/mesh.py:make_sharded_search_step, the fused demo step (K4's
    path), on make_demo_inputs (256 queries of 64, 256 subjects of 4,096)
    over grids 1x1, 1x4 and 2x2 laid on the one card: every grid's merged
    top-k and db_total equal the 1x1 grid's, every cell has seeds that
    occur in its shard, and K4's first launch of each grid is held
    exactly against its plain version.  K4 launches (counted from 0
    before each grid's step) and the step's call ms (its first call, and
    the median of three more)."""
    from lambda_tpu_torch.ops import sw_rect
    from lambda_tpu_torch.parallel import mesh as pmesh

    cfg = pmesh.StepConfig(**MESH_STEP_CFG)
    frames, red_q, trans_q, subst = pmesh.make_demo_inputs(
        cfg, **MESH_STEP_SIZE)
    ref, cmp, launches = None, [], {}
    for q, db in MESH_GRIDS:
        m = pmesh.Mesh(["cuda:0"] * (q * db), q, db)
        shards = pmesh.shard_index(frames, cfg.alphabet_size, db,
                                   words=cfg.words)
        st = pmesh.stack_shards(shards)
        sbj, sbj_len = pmesh.demo_subjects(shards, frames)
        args = (m.put_q(red_q), m.put_q(trans_q), m.put_db(st["keys"]),
                m.put_db(st["pos"]), m.put_db(st["rows"]), m.put_db(sbj),
                m.put_db(sbj_len), m.put_all(subst))
        step = pmesh.make_sharded_search_step(m, cfg)
        with capture("_sw_score_cuda", first(1), sw_rect) as k4_in:
            sw_rect.launches = 0                   # this path starts
            (merged, total), step_ms = timed(lambda: step(*args))
            n = sw_rect.launches                   # ... and ends
        launches[f"{q}x{db}"] = n
        got = (merged.cpu().numpy(), total.cpu().numpy())
        step_median_ms = time_ms(lambda: step(*args), 3)
        if ref is None:
            ref = got
        c = k4_compare(*k4_in[0][:5], dev_info)
        cmp.append(c)
        hits = cell_seed_hits(cfg, red_q, shards, frames, q)
        same = all(np.array_equal(a, b) for a, b in zip(got, ref))
        emit(phase="mesh_step", grid=[q, db], cells=q * db, k4_launches=n,
             step_ms=step_ms, step_median_ms=step_median_ms,
             merged_equal_1x1=same,
             db_total=int(got[1][0, 0]), top1_max=int(got[0][:, 0].max()),
             queries_with_hit=int((got[0][:, 0] > 0).sum()),
             cell_seed_hits=hits,
             k4_compare={k: c[k] for k in ("B", "M", "N", "exact_equal",
                                           "ms", "device_ms", "plain_ms",
                                           "bound_ms", "bound_by")})
        if not same:
            raise SystemExit(f"mesh_step: the {q}x{db} grid's top-k or "
                             "db_total differs from the 1x1 grid's")
        if n != q * db or not c["exact_equal"] or min(hits) <= 0:
            raise SystemExit(f"mesh_step {q}x{db}: K4 launched {n} times "
                             f"for {q * db} cells, disagrees with its plain "
                             f"version, or a cell has no hit ({hits})")
    return dict(launches=sum(launches.values()), per_grid=launches, cmp=cmp)


# the card_cpu_mesh phase's searches: name -> (database of an earlier
# card_cpu phase, search subcommand, flags, switch, the unsharded card m8
# of an earlier phase with the same flags but the grid's)
CARD_CPU_MESH = {
    "blastp_db2": ("small", "searchp", ["--db-shards", "2"], "default",
                   "small_cuda.m8"),
    "blastp_q2_db2": ("small", "searchp",
                      ["--q-shards", "2", "--db-shards", "2"], "default",
                      "small_cuda.m8"),
    "blastp_q4": ("small", "searchp", ["--q-shards", "4"], "default",
                  "small_cuda.m8"),
    "blastp_prebuilt4_db4": ("small4", "searchp",
                             ["-n", "500", "--db-shards", "4"], "default",
                             "blastp_shards4_full_cuda.m8"),
    "bisulfite_db2": ("bisulfite", "searchbs", ["--db-shards", "2"],
                      "default", "bisulfite_cuda.m8"),
    "blastp_delta2_db2": ("small", "searchp",
                          ["--seed-delta", "2", "--db-shards", "2"],
                          "default", "blastp_delta2_cuda.m8"),
    "blastp_db2_device_trace": ("small", "searchp", ["--db-shards", "2"],
                                "device_trace", "small_cuda.m8"),
    "blastp_db2_sublane": ("small", "searchp", ["--db-shards", "2"],
                           "sublane", "small_cuda.m8"),
}
# the wrapper of each switch's kernel, whose first launch is held
SWITCH_WRAPPER = {"default": "_sw_band_score_cuda",
                  "device_trace": "_sw_band_align_cuda",
                  "sublane": "_sw_band_score_sub_cuda"}


def mesh_search(se: str, argv: list, device: str, cells: int):
    """One search through run_search with the CLI's options: on the card
    the grid's cells all on cuda:0 (SearchContext(devices=...)), on the
    CPU every cell on the CPU."""
    from lambda_tpu_torch import cli
    from lambda_tpu_torch.search import pipeline

    opt, _ = cli.search_options(se, [str(a) for a in argv])
    devices = ["cuda:0"] * cells if device == "cuda" and cells > 1 else None
    return pipeline.run_search(opt, device=device, devices=devices)


def phase_card_cpu_mesh(tmp: Path, dev_info) -> dict:
    """The device mesh on the card_cpu databases: for each search of
    CARD_CPU_MESH the grid laid on the one card and on CPU cells, both
    m8 equal to each other and to the unsharded card run of an earlier
    phase; the switch's kernel launched and held against its plain
    version on its first launch.  Then the CLI's refusal of a mesh larger
    than the visible cards (the JAX package's message), and two CLI
    processes on the card, --shard-subset 0 and 1 of a two-shard index,
    joined by --distributed: merged by merge_m8, the full run's bytes.
    Returns each search's launches of its switch's kernel."""
    import io

    from lambda_tpu_torch import cli

    dbs = {"small": (tmp / "small.lit", tmp / "small_q.fasta"),
           "small4": (tmp / "small4.lit", tmp / "small_q.fasta"),
           "bisulfite": (tmp / "bisulfite.lit", tmp / "bisulfite_q.fasta")}
    launches, bad = {}, []
    for name, (db, se, flags, mode, want) in CARD_CPU_MESH.items():
        lit, q = dbs[db]
        cells = 1
        for f, v in zip(flags, flags[1:]):
            if f in ("--q-shards", "--db-shards"):
                cells *= int(v)
        outs, secs = {}, {}
        for dev in ("cuda", "cpu"):
            out = tmp / f"mesh_{name}_{dev}.m8"
            argv = ["-q", q, "-i", lit, "-o", out, "-v", "0", *flags]
            with switched(mode), capture(SWITCH_WRAPPER[mode], first(1)) \
                    as k_in:
                reset_band_launches()              # this path starts
                t0 = time.perf_counter()
                mesh_search(se, argv, dev, cells)
                secs[dev] = round(time.perf_counter() - t0, 3)
                n = band_launches()[MODES[mode]]   # ... and ends
            outs[dev] = out.read_bytes()
            if dev == "cuda":
                launches[name], kin = n, k_in
        if mode == "device_trace":
            cmp = [k2_compare(*x, dev_info) for x in kin]
        else:
            cmp = [k1_compare(*x[:7], dev_info, reps=3, plain_reps=0,
                              kernel="K3" if mode == "sublane" else "K1",
                              **({} if mode == "sublane" else
                                 dict(x_drop=x[7], nc=x[8])))
                   for x in kin]
        unsharded = (tmp / want).read_bytes()
        ok = (outs["cuda"] == outs["cpu"] == unsharded
              and outs["cuda"].strip() and launches[name] > 0 and cmp
              and all(c["exact_equal"] for c in cmp))
        emit(phase="card_cpu_mesh", search=name, flags=flags, cells=cells,
             switch=mode, m8_equal_cpu=outs["cuda"] == outs["cpu"],
             m8_equal_unsharded=outs["cuda"] == unsharded,
             m8_lines=outs["cuda"].count(b"\n"), seconds=secs,
             kernel_launches=launches[name],
             kernel_compare=[{k: c[k] for k in ("B", "N", "D",
                                                "exact_equal", "ms",
                                                "plain_ms", "bound_ms")}
                             for c in cmp])
        if not ok:
            bad.append(name)
    if bad:
        raise SystemExit(f"card_cpu_mesh: mesh m8 differs (card, CPU, "
                         f"unsharded), is empty, or its kernel was not "
                         f"launched or not exact: {bad}")

    # a grid larger than the visible cards: refused as the JAX package
    # refuses it, with no fallback
    n_cards = torch.cuda.device_count()
    err = io.StringIO()
    with contextlib.redirect_stderr(err):
        rc = cli.main(["searchp", "-q", str(tmp / "small_q.fasta"), "-i",
                       str(tmp / "small.lit"), "-o",
                       str(tmp / "refused.m8"), "-v", "0", "--db-shards",
                       str(n_cards + 1)])
    want_err = (f"ERROR: --q-shards 1 x --db-shards {n_cards + 1} needs "
                f"{n_cards + 1} devices; only {n_cards} available.\n")
    emit(phase="card_cpu_mesh", search="refusal", rc=rc,
         stderr=err.getvalue(), expected=want_err)
    if rc != 1 or err.getvalue() != want_err:
        raise SystemExit("card_cpu_mesh: the CLI did not refuse a mesh "
                         "larger than the visible cards as expected")
    dist = distributed_runs(tmp)
    launches["distributed"] = dist
    return launches


def distributed_runs(tmp: Path) -> dict:
    """mkindexp --shards 2 of the card_cpu BLASTP database; the full run
    on the card (default -n 25), then two concurrent CLI processes on the
    card, one --shard-subset each, joined into one torch.distributed
    group (gloo, a free local port), merged by merge_m8 (annotated, the
    query file's order, -n 25) into the full run's bytes."""
    import socket

    from lambda_tpu_torch.tools import merge_m8

    lit2, q = tmp / "small2.lit", tmp / "small_q.fasta"
    run_cli("mkindexp", "-d", tmp / "small.fasta", "-i", lit2, "-v", "0",
            "--shards", "2")
    full = tmp / "dist_full.m8"
    run_cli("searchp", "-q", q, "-i", lit2, "-o", full, "-v", "0")
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    procs, outs = [], []
    t0 = time.perf_counter()
    for pid in (0, 1):
        out = tmp / f"dist_host{pid}.m8"
        outs.append(out)
        procs.append(subprocess.Popen(
            [sys.executable, "-m", "lambda_tpu_torch.cli", "searchp",
             "-q", str(q), "-i", str(lit2), "-o", str(out),
             "--shard-subset", str(pid), "-n", "1000000",
             "--distributed", f"127.0.0.1:{port},{pid},2", "-v", "0"],
            cwd=REPO, env=dict(os.environ, PYTHONPATH=str(REPO)),
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    rcs, errs = [], []
    try:
        for p in procs:
            _, e = p.communicate(timeout=300)
            rcs.append(p.returncode)
            errs.append(e[-2000:])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    secs = round(time.perf_counter() - t0, 3)
    if any(rcs):
        raise SystemExit(f"the --distributed processes exited {rcs}: {errs}")
    merged = tmp / "dist_merged.m8"
    merge_m8.merge([str(o) for o in outs], str(merged), max_matches=25,
                   query_order=merge_m8._read_query_ids(str(q)))
    same = merged.read_bytes() == full.read_bytes()
    lines = [o.read_bytes().count(b"\n") for o in outs]
    emit(phase="card_cpu_mesh", search="distributed", processes=2,
         host_lines=lines, seconds=secs, merged_equal_full=same,
         full_lines=full.read_bytes().count(b"\n"))
    if not same or not all(lines):
        raise SystemExit("the merged --distributed outputs differ from the "
                         "full run's bytes (or a host wrote nothing)")
    return dict(host_lines=lines, seconds=secs)


PHASE_KEYS = ("seed", "locate", "merge", "extend", "extend_trace", "write")


def main_search(opt, devices=None, ss_inputs: bool = False) -> dict:
    """run_search on the card (``devices``: the mesh's cells), with the
    hooks of this script only: the resident bytes and the time at which
    SearchContext is ready (index read and uploaded), the context itself
    (for the reruns), and the inputs of the first three K1 launches.
    Its K1, S1 and S2 launches are counted from 0.  ``ss_inputs``: also
    the inputs of S1's and S2's first calls of each seeding phase
    (:func:`seeding_inputs`)."""
    from lambda_tpu_torch.ops import searchsorted as ss, slot_walk, sw_band
    from lambda_tpu_torch.search import pipeline

    rec: dict = {}
    init = pipeline.SearchContext.__init__

    def init_hook(self, *a, **kw):
        init(self, *a, **kw)
        torch.cuda.synchronize()
        rec["resident_bytes"] = torch.cuda.memory_allocated()
        rec["ready"] = time.perf_counter()
        rec["ctx"] = self

    pipeline.SearchContext.__init__ = init_hook
    try:
        with capture("_sw_band_score_cuda", first(3)) as k1_in, \
                seeding_inputs(opt, ss_inputs) as ss_in:
            torch.cuda.reset_peak_memory_stats()
            reset_band_launches()                  # the main path starts
            ss.launches = slot_walk.launches = 0
            t0 = time.perf_counter()
            rec["stats"] = pipeline.run_search(opt, device="cuda",
                                               devices=devices)
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            rec["launches"] = sw_band.launches     # ... and ends
            rec["ss_launches"] = ss.launches
            rec["sw_launches"] = slot_walk.launches
    finally:
        pipeline.SearchContext.__init__ = init
    rec.update(k1_inputs=k1_in, ss_inputs=ss_in, load_s=rec["ready"] - t0,
               search_s=t1 - rec["ready"], total_s=t1 - t0)
    return rec


@contextlib.contextmanager
def seeding_inputs(opt, keep: bool):
    """With ``keep``, the inputs of S1's first range search and first
    count curves, and of S2's first walk, in each seeding phase of a
    search with ``opt`` (phase 2: a dispatch with ``opt.search_opts`` in
    an iterative search), as {(entry, phase): args}: every tensor cloned
    but the resident keys, which are held by reference.  The calls
    themselves run."""
    from lambda_tpu_torch.ops import searchsorted as ss, slot_walk
    from lambda_tpu_torch.search import pipeline

    captured: dict = {}
    if not keep:
        yield captured
        return
    cls = pipeline.SearchContext
    dispatch = cls.dispatch_seeding
    wrappers = {"range": (ss, "_search_range_cuda"),
                "curves": (ss, "_count_curves_cuda"),
                "walk": (slot_walk, "_slot_walk_cuda")}
    launch = {e: getattr(m, w) for e, (m, w) in wrappers.items()}
    phase = [1]

    def dispatch_hook(self, qry_seqs, so, stats):
        phase[0] = 2 if opt.iterative_search and so is opt.search_opts \
            else 1
        return dispatch(self, qry_seqs, so, stats)

    def hook(entry):
        def call(keys, *a):
            if (entry, phase[0]) not in captured:
                captured[(entry, phase[0])] = (keys,) + tuple(
                    x.clone() if torch.is_tensor(x) else x for x in a)
            return launch[entry](keys, *a)
        return call

    cls.dispatch_seeding = dispatch_hook
    for e, (m, w) in wrappers.items():
        setattr(m, w, hook(e))
    try:
        yield captured
    finally:
        cls.dispatch_seeding = dispatch
        for e, (m, w) in wrappers.items():
            setattr(m, w, launch[e])


def device_call_ms(fn) -> float:
    """One call of ``fn`` timed on the device alone (the stream held busy
    by a spin while it is enqueued, as ``time_ms(device=True)``)."""
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(SPIN_CYCLES)
    a.record()
    fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b)


def ss_load_latency(keys, reps: int = 41) -> dict:
    """The card's latency of one dependent key load of S1's bisection:
    one-row range searches of the whole key array, each for a new key row
    drawn at random (the bisection's last levels miss the L2), less an
    empty call's time (a row answered without a load), over the rounds
    of loads such a search takes at most; the same for a row searched
    again and again (its rows stay in the L2)."""
    from lambda_tpu_torch.ops import searchsorted as ss

    P, words = keys.shape
    saved = ss.launches
    mask = torch.full((1, words), 0xFFFFFFFF, dtype=torch.int64,
                      device=keys.device)
    rows = torch.randint(0, P, (reps,), generator=torch.Generator()
                         .manual_seed(2026)).tolist()
    no = torch.zeros(1, dtype=torch.bool, device=keys.device)
    tgt = [keys[r:r + 1].clone() for r in rows]

    def search(t, valid=None):
        return lambda: ss._search_range_cuda(keys, t, mask, None, None, None,
                                             None, valid, None)

    search(tgt[0])()                           # the first call: warm
    fresh = float(np.median([device_call_ms(search(t)) for t in tgt[1:]]))
    again = float(np.median([device_call_ms(search(tgt[0]))
                             for _ in range(reps)]))
    empty = float(np.median([device_call_ms(search(tgt[0], no))
                             for _ in range(reps)]))
    ss.launches = saved                # measurement launches do not count
    rounds = P.bit_length()            # ceil(log2(P + 1)) at most
    return dict(rows=P, rounds=rounds, fresh_ms=fresh, again_ms=again,
                empty_ms=empty,
                load_ns=max(fresh - empty, 0.0) / rounds * 1e6,
                l2_load_ns=max(again - empty, 0.0) / rounds * 1e6)


def ss_initial_ranges(keys, targets, masks, lo0, hi0, bucket, bucket_shift):
    """The ranges S1 starts from: [lo0, hi0) (0 / P if None) cut to each
    row's prefix bucket where its mask covers the bucketed prefix (as
    ``search_range_torch`` does)."""
    from lambda_tpu_torch.ops import searchsorted as ss

    n, P = targets.shape[0], keys.shape[0]
    dev = targets.device
    lo = torch.zeros(n, dtype=torch.int64, device=dev) if lo0 is None \
        else lo0.clone()
    hi = torch.full((n,), P, dtype=torch.int64, device=dev) if hi0 is None \
        else hi0.clone()
    if bucket is not None and bucket_shift is not None:
        full = (ss.UINT32_MAX << bucket_shift) & ss.UINT32_MAX \
            if bucket_shift < 32 else 0
        usable = (masks[:, 0] & full) == full
        pfx = targets[:, 0] >> bucket_shift
        lo = torch.where(usable, torch.maximum(lo, bucket[pfx]), lo)
        hi = torch.where(usable, torch.minimum(hi, bucket[pfx + 1]), hi)
        hi = torch.maximum(hi, lo)
    return lo, hi


def floor_log2_1p(x) -> torch.Tensor:
    """floor(log2(x + 1)) of a non-negative int64 tensor: the fewest
    bisection rounds that empty a range of x rows."""
    x = x.clamp(min=0) + 1
    r = torch.zeros_like(x)
    for b in (32, 16, 8, 4, 2, 1):
        big = x >= (1 << b)
        r += big * b
        x = torch.where(big, x >> b, x)
    return r


def ss_compare(entry: str, args, dev_info, reps: int = 5) -> dict:
    """S1's ``entry`` ("range" or "curves") against its plain version on
    the same card tensors (a main-path call's inputs): exact equality of
    every output (and of the skipped count), kernel ms and device ms,
    the plain version's ms on its comparison call, and the bound: the
    larger of the longest chain of dependent key loads (at least
    floor(log2(range + 1)) rounds a bisection) at the card's random-load
    latency (``dev_info["ss_load_ns"]``) and the bytes that must move
    (inputs read, outputs written; key rows not counted, as the top of
    the bisection is shared through the L2) at 3.35 TB/s."""
    from lambda_tpu_torch.ops import searchsorted as ss

    saved = ss.launches
    dev = args[0].device
    if entry == "range":
        keys, tgt, masks, lo0, hi0, bucket, bsh, valid, _ = args
        n, words = tgt.shape

        def run(fn, sk=None):
            sk = torch.zeros(1, dtype=torch.int64, device=dev) \
                if sk is None else sk
            return (*fn(keys, tgt, masks, lo0, hi0, bucket, bsh, valid, sk),
                    sk)

        sk_timed = torch.zeros(1, dtype=torch.int64, device=dev)

        def launch(sk=None):
            return run(ss._search_range_cuda, sk)

        def timed_launch():
            return launch(sk_timed)

        def plain():
            return run(ss.search_range_torch)

        lo, hi = ss_initial_ranges(keys, tgt, masks, lo0, hi0, bucket, bsh)
        ok = torch.ones(n, dtype=torch.bool, device=dev) if valid is None \
            else valid
        n_valid = int(ok.sum())
        chain = int(floor_log2_1p(torch.where(ok, hi - lo, 0)).max())
        nbytes = (n_valid * words * 16 + 16 * n
                  + (n if valid is not None else 0)
                  + 8 * n * ((lo0 is not None) + (hi0 is not None)))
        extra = dict(rows=n, valid_rows=n_valid)
    else:
        keys, tgt, lo0, cnt0, chars, plan = args
        n, words = tgt.shape
        E = chars.shape[1]

        def launch():
            return ss._count_curves_cuda(*args)

        timed_launch = launch

        def plain():
            return ss.count_curves_torch(*args)

        nbytes = n * (words + 2 + E) * 8 + 2 * n * (E + 1) * 8
        extra = dict(rows=n, steps=E)
    out_k = launch()
    out_p, p_ms = timed(plain)
    err = max(int((a - b).abs().max()) if a.numel() else 0
              for a, b in zip(out_k, out_p))
    kt = kernel_times(timed_launch, reps)
    ss.launches = saved                # comparison launches do not count
    if entry == "curves":
        cnt = out_p[1][:, :E]          # step e bisects step e - 1's range
        chain = int(floor_log2_1p(cnt).sum(dim=1).max()) if n else 0
    else:
        extra["skipped_rows"] = int(out_p[2])
    t_chain = chain * dev_info["ss_load_ns"] * 1e-6
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    return dict(entry=entry, **extra, max_abs_err=err, exact_equal=err == 0,
                **kt, plain_ms=p_ms, chain_loads=chain, chain_ms=t_chain,
                bytes=nbytes, bytes_ms=t_bytes,
                bound_ms=max(t_chain, t_bytes),
                bound_by="latency" if t_chain >= t_bytes else "bytes")


def phase_scale_searchsorted(search: str, rec, dev_info) -> list:
    """S1 against its plain versions on the inputs ``rec`` (main_search
    with ``ss_inputs``) captured: one line per call; fails the run on any
    difference, or if the search launched S1 no time or no call of a
    phase-1 entry was captured."""
    if rec["ss_launches"] <= 0:
        raise SystemExit(f"the {search} search launched S1 no time")
    for entry in ("range", "curves"):
        if (entry, 1) not in rec["ss_inputs"]:
            raise SystemExit(f"the {search} search made no S1 {entry} call "
                             "in phase 1")
    cmp = []
    for (entry, ph), args in sorted(rec["ss_inputs"].items()):
        if entry == "walk":
            continue
        c = dict(ss_compare(entry, args, dev_info), seeding_phase=ph)
        emit(phase="scale_searchsorted", search=search,
             launches=rec["ss_launches"], **c)
        cmp.append(c)
    if not all(c["exact_equal"] for c in cmp):
        raise SystemExit(f"S1 disagrees with its plain version on the "
                         f"{search} search's inputs")
    return cmp


def phase_scale_slot_walk(search: str, rec, dev_info) -> list:
    """S2 against its plain version on the walks ``rec`` (main_search
    with ``ss_inputs``) captured, the first of each seeding phase: one
    line per call; fails the run on any difference, or if the search
    launched S2 no time or walked nothing in phase 1."""
    if rec["sw_launches"] <= 0:
        raise SystemExit(f"the {search} search launched S2 no time")
    if ("walk", 1) not in rec["ss_inputs"]:
        raise SystemExit(f"the {search} search made no S2 call in phase 1")
    cmp = []
    for (entry, ph), args in sorted(rec["ss_inputs"].items()):
        if entry != "walk":
            continue
        c = dict(slot_walk_cost(args, dev_info), seeding_phase=ph)
        emit(phase="scale_slot_walk", search=search,
             launches=rec["sw_launches"], **c)
        cmp.append(c)
    return cmp


def phase_scale(tmp: Path, dev_info, n_subj=250_000, length=400,
                n_q=1024) -> dict:
    rng = np.random.default_rng(2024)
    t0 = time.perf_counter()
    db = synthetic_db(rng, n_subj, length)
    write_fasta(tmp / "big.fasta",
                [(f"s{i}", r.tobytes().decode()) for i, r in enumerate(db)])
    write_fasta(tmp / "big_q.fasta", query_mix(rng, db, n_q))
    # the scale_blastx phase's reads, from the same subjects
    write_fasta(tmp / "big_x.fasta",
                blastx_reads(np.random.default_rng(2025), db, n_q))
    gen_s = time.perf_counter() - t0
    del db
    lit = tmp / "big.lit"
    t0 = time.perf_counter()
    run_cli("mkindexp", "-d", tmp / "big.fasta", "-i", lit, "-v", "0")
    build_s = time.perf_counter() - t0

    def make_opt(out: Path):
        return scale_opt(tmp, out)

    opt = make_opt(tmp / "big.m8")
    rec = main_search(opt, ss_inputs=True)
    search_peak = torch.cuda.max_memory_allocated()
    stats, launches, search_s = rec["stats"], rec["launches"], \
        rec["search_s"]
    keys = rec["ctx"].d_keys
    dev_info["ss_latency"] = ss_load_latency(keys)
    dev_info["ss_load_ns"] = dev_info["ss_latency"]["load_ns"]
    emit(phase="scale_searchsorted_latency", **dev_info["ss_latency"])
    ss_cmp = phase_scale_searchsorted("blastp", rec, dev_info)
    sw_cmp = phase_scale_slot_walk("blastp", rec, dev_info)
    del keys
    rec.pop("ss_inputs")

    n_hom, found, share = homolog_share(tmp / "big.m8", n_q)
    cmp = [k1_compare(*x[:7], dev_info, reps=3, x_drop=x[7], nc=x[8])
           for x in rec["k1_inputs"]]
    want_m8 = (tmp / "big.m8").read_bytes()
    # RERUN_ROUNDS rounds of all three modes on the same resident index:
    # each switch's run, and the spread of the host-bound search; the
    # kernels are held against their plain versions in the first round
    reruns: dict = {}
    spread = {m: {"search_s": [], "time_extend_trace_s": []} for m in MODES}
    spread["default"]["search_s"].append(round(search_s, 3))
    spread["default"]["time_extend_trace_s"].append(
        round(stats.time_extend_trace, 3))
    for rnd in range(RERUN_ROUNDS):
        for mode in MODES:
            check = rnd == 0 and mode != "default"
            r = rerun_search(rec["ctx"], make_opt, tmp / f"big_{mode}.m8",
                             mode, want_m8, dev_info, n_q, rnd, check)
            if check:
                reruns[mode] = r
            for k in ("search_s", "time_extend_trace_s"):
                spread[mode][k].append(r[k])
    emit(phase="scale_spread", rounds=RERUN_ROUNDS, runs=spread,
         median_search_s={m: float(np.median(v["search_s"]))
                          for m, v in spread.items()})
    ctx = rec.pop("ctx")
    prof = profile_search(ctx, opt)
    peak = torch.cuda.max_memory_allocated()
    # last on this index: the profiler's trace would weigh on the reruns
    trace_launches = trace_dir_check(ctx, make_opt, tmp, want_m8)
    del ctx
    emit(phase="scale", db_residues=n_subj * length, subjects=n_subj,
         queries=n_q, gen_s=round(gen_s, 2), index_build_s=round(build_s, 2),
         resident_bytes=rec.get("resident_bytes"),
         peak_device_bytes=peak, search_peak_device_bytes=search_peak,
         # load = index read + upload (SearchContext); search = the
         # batches after it, on the resident index
         load_s=round(rec["load_s"], 3),
         search_s=round(search_s, 3),
         queries_per_s=round(n_q / search_s, 2),
         queries_per_s_with_load=round(n_q / rec["total_s"], 2),
         phase_s={k: round(getattr(stats, f"time_{k}"), 3)
                  for k in PHASE_KEYS},
         k1_launches=launches, ext_rows=stats.ext_dispatch_rows,
         homolog_queries=n_hom, homolog_hit_source=found,
         homolog_share=round(share, 4),
         device_busy_share_of_search=round(
             prof["device_busy_ms"] / (search_s * 1e3), 4),
         profiled_pass=prof,
         k1_main_path_compare=[{k: c[k] for k in
                                ("B", "N", "D", "exact_equal", "ms",
                                 "device_ms", "plain_ms", "bound_ms")}
                               for c in cmp])
    if launches <= 0:
        raise SystemExit("the main path launched K1 no time")
    if share < 0.5:
        raise SystemExit(f"only {share:.2%} of homolog queries hit their "
                         "source subject")
    if not all(c["exact_equal"] for c in cmp):
        raise SystemExit("K1 disagrees with its plain version on main-path "
                         "inputs")
    return dict(launches=launches, cmp=cmp, reruns=reruns, peak=search_peak,
                trace_launches=trace_launches, ss_launches=rec["ss_launches"],
                ss_cmp=ss_cmp, sw_launches=rec["sw_launches"], sw_cmp=sw_cmp)


def homolog_share(m8: Path, n_q: int):
    """(homolog queries, those that hit their source subject, share) of a
    scale search's m8 (query_mix names a homolog after its source)."""
    hits: dict = {}
    for line in m8.read_text().splitlines():
        f = line.split("\t")
        hits.setdefault(f[0], set()).add(f[1])
    n_hom = sum(1 for i in range(n_q) if i % 10 < 7)
    found = sum(1 for qid, subs in hits.items()
                if qid.startswith("hom") and qid.split("_s")[1] in
                {s[1:] for s in subs})
    return n_hom, found, found / n_hom


def trace_dir_check(ctx, make_opt, tmp: Path, want_m8: bytes) -> int:
    """The scale search once more on the resident index (``ctx``) with
    --trace-dir under build/: the m8 unchanged, and a non-empty chrome
    trace in the directory that names K1's kernel.  Returns K1's
    launches in that run."""
    from lambda_tpu_torch.search import pipeline

    tdir = tmp / "trace"
    opt = make_opt(tmp / "big_trace.m8")
    opt.profile_dir = str(tdir)
    cls = pipeline.SearchContext
    pipeline.SearchContext = lambda *a, **kw: ctx      # the resident index
    try:
        reset_band_launches()                  # this path starts
        t0 = time.perf_counter()
        pipeline.run_search(opt, device="cuda")
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        launches = band_launches()["launches"]  # ... and ends
    finally:
        pipeline.SearchContext = cls
    files = sorted(tdir.glob("*.json"))
    text = files[0].read_text() if files else ""
    names_k1 = "sw_band_score_kernel" in text
    same = (tmp / "big_trace.m8").read_bytes() == want_m8
    emit(phase="trace_dir", directory=str(tdir.relative_to(REPO)),
         files=[f.name for f in files], trace_bytes=len(text),
         names_k1_kernel=names_k1, m8_equal_default=same,
         k1_launches=launches, seconds=round(secs, 3))
    if not files or not text or not names_k1:
        raise SystemExit("--trace-dir wrote no trace, or one that does not "
                         "name K1's kernel")
    if not same or launches <= 0:
        raise SystemExit("the --trace-dir run's m8 differs, or it launched "
                         "K1 no time")
    return launches


@contextlib.contextmanager
def counting(cls, name: str):
    """Counts the calls of method ``name`` of ``cls`` (the budget retries
    of SearchContext._next_scale)."""
    meth = getattr(cls, name)
    calls = [0]

    def hook(*a, **kw):
        calls[0] += 1
        return meth(*a, **kw)

    setattr(cls, name, hook)
    try:
        yield calls
    finally:
        setattr(cls, name, meth)


def scale_opt(tmp: Path, out: Path, stream: int = 1,
              delta: int | None = None, grid=(1, 1)):
    """The scale phase's searchp options (default), with --db-stream,
    --seed-delta and (--q-shards, --db-shards) as given."""
    from lambda_tpu_torch import options as opt_mod

    opt = opt_mod.make_search_options(
        opt_mod.Domain.PROTEIN, query_file=str(tmp / "big_q.fasta"),
        index_file=str(tmp / "big.lit"), output=str(out), verbosity=0)
    opt.db_stream = stream
    opt.q_shards, opt.db_shards = grid
    if delta is not None:
        opt.search_opts.max_seed_dist = delta
    return opt


def scale_run(tmp: Path, dev_info, out: Path, n_q: int, **kw) -> dict:
    """One scale search through main_search (index loaded anew, device
    memory peak from 0): its numbers, budget retries and K1 held against
    its plain version on the first three launches' inputs."""
    import gc

    from lambda_tpu_torch.ops import slot_walk
    from lambda_tpu_torch.search import pipeline

    delta = kw.get("delta") or 1

    def phase2_walk(a, captured):      # the first walk of phase 2's seeds
        return not captured and a[0].max_seed_dist == delta

    q, db = kw.get("grid", (1, 1))
    devices = ["cuda:0"] * (q * db) if q * db > 1 else None
    gc.collect()                       # the previous context is gone
    torch.cuda.empty_cache()
    with counting(pipeline.SearchContext, "_next_scale") as retries, \
            capture("_slot_walk_cuda", phase2_walk, slot_walk) as walk_in, \
            cell_calls() as per_cell, \
            timing(pipeline.SearchContext, "_mesh_setup") as setup_s:
        rec = main_search(scale_opt(tmp, out, **kw), devices)
    ctx, stats = rec.pop("ctx"), rec["stats"]
    peak = torch.cuda.max_memory_allocated()
    cmp = [k1_compare(*x[:7], dev_info, reps=3, x_drop=x[7], nc=x[8])
           for x in rec["k1_inputs"]]
    n_hom, found, share = homolog_share(out, n_q)
    r = dict(search_s=round(rec["search_s"], 3),
             load_s=round(rec["load_s"], 3),
             queries_per_s=round(n_q / rec["search_s"], 2),
             phase_s={k: round(getattr(stats, f"time_{k}"), 3)
                      for k in PHASE_KEYS},
             k1_launches=rec["launches"], ss_launches=rec["ss_launches"],
             sw_launches=rec["sw_launches"], peak_device_bytes=peak,
             hits_located=stats.hits_after_seeding,
             hits_overflow=stats.hits_overflow,
             cursors_overflow=stats.cursors_overflow,
             budget_retries=retries[0],
             budget_scale=dict((str(k), v) for k, v in
                               ctx._budget_scale.items()),
             homolog_queries=n_hom, homolog_hit_source=found,
             homolog_share=round(share, 4),
             m8_lines=out.read_bytes().count(b"\n"),
             k1_compare=[{k: c[k] for k in
                          ("B", "N", "D", "exact_equal", "ms", "device_ms",
                           "plain_ms", "bound_ms")} for c in cmp])
    if walk_in:
        r["slot_walk"] = slot_walk_cost(walk_in[0], dev_info)
    if ctx.db_stream > 1:
        # the shard uploads of every pass A and pass B, from the stats
        r["upload_s"] = round(stats.time_stream_upload, 4)
        r["shard_host_bytes"] = sum(t.numel() * t.element_size()
                                    for t in ctx.stream_sh.values())
    if ctx.mesh is not None:
        r["grid"] = [q, db]
        r["mesh_setup_s"] = round(setup_s[0], 3)
        r["k1_launches_per_cell"] = [
            per_cell.get((c // db, int(ctx.shard_base[c % db])), 0)
            for c in range(q * db)]
        r["mesh_device_bytes"] = sum(
            t.numel() * t.element_size() for name, cells in ctx.d_sh.items()
            if cells is not None for t in {id(x): x for x in cells}.values())
    del ctx
    if rec["launches"] <= 0:
        raise SystemExit(f"the scale search {kw} launched K1 no time")
    if not cmp or not all(c["exact_equal"] for c in cmp):
        raise SystemExit(f"K1 disagrees with its plain version on the "
                         f"scale search {kw}")
    if rec["sw_launches"] <= 0 or not walk_in:
        raise SystemExit(f"the scale search {kw} launched S2 no time")
    return dict(r, cmp=cmp)


@contextlib.contextmanager
def timing(cls, name: str):
    """The seconds of the calls of method ``name`` of ``cls``, the card
    synchronised after each (the mesh's shard set-up)."""
    meth = getattr(cls, name)
    secs = [0.0]

    def hook(*a, **kw):
        t0 = time.perf_counter()
        out = meth(*a, **kw)
        torch.cuda.synchronize()
        secs[0] += time.perf_counter() - t0
        return out

    setattr(cls, name, hook)
    try:
        yield secs
    finally:
        setattr(cls, name, meth)


@contextlib.contextmanager
def cell_calls():
    """Counts the pass-1 launches (``sw_band.sw_band_score_device``) per
    part of search/extend.py's launch loop: each call goes to the part
    whose windows ``extend._gather_windows`` gathered just before it,
    keyed (q block, subject frame base).  On the mesh a part is a cell."""
    from lambda_tpu_torch.ops import sw_band
    from lambda_tpu_torch.search import extend

    gather, score = extend._gather_windows, sw_band.sw_band_score_device
    calls: dict = {}
    part = [None]

    def gather_hook(resident, m, idxs, pad, N, q_base=0, s_base=0):
        part[0] = (q_base // resident[0].shape[0], s_base)
        return gather(resident, m, idxs, pad, N, q_base, s_base)

    def score_hook(*a):
        calls[part[0]] = calls.get(part[0], 0) + 1
        return score(*a)

    extend._gather_windows = gather_hook
    sw_band.sw_band_score_device = score_hook
    try:
        yield calls
    finally:
        extend._gather_windows = gather
        sw_band.sw_band_score_device = score


def slot_walk_cost(args, dev_info) -> dict:
    """S2 (ops/slot_walk.py:_slot_walk_cuda) against its plain version
    on one main-path call's inputs ``args``: exact equality of every
    row's elongation (a difference fails the run), kernel ms and device
    ms, the plain version's ms on its comparison call and its launches
    (torch.profiler), and the bound: the larger of the bytes read once
    (curves, the rows' slot, query, begin, frame length and remaining
    estimate, base and hits0, the segment bounds written and read, L
    written) at 3.35 TB/s and the slots times one warp sum and add
    (``dev_info["warp_sum_ns"]``)."""
    from lambda_tpu_torch.ops import slot_walk

    saved = slot_walk.launches
    curve, base = args[1], args[7]
    n, E1 = curve.shape
    T, Q = base.shape

    def launch():
        return slot_walk._slot_walk_cuda(*args)

    def plain():
        return slot_walk.slot_walk_torch(*args)

    out_k = launch()
    out_p, p_ms = timed(plain)
    acts = [torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        plain()
        torch.cuda.synchronize()
    plain_launches = sum(e.count for e in prof.key_averages()
                         if e.device_type == torch.autograd.DeviceType.CUDA)
    err = int((out_k - out_p).abs().max()) if n else 0
    kt = kernel_times(launch, 5)
    slot_walk.launches = saved         # comparison launches do not count
    nbytes = 8 * (n * E1 + 6 * n + 3 * T * Q + Q + 2)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_chain = T * dev_info["warp_sum_ns"] * 1e-6
    c = dict(slots=T, queries=Q, rows=n, steps=E1 - 1, max_abs_err=err,
             exact_equal=err == 0, **kt, plain_ms=p_ms,
             plain_launches=plain_launches, bytes=nbytes, bytes_ms=t_bytes,
             chain_ms=t_chain, bound_ms=max(t_bytes, t_chain),
             bound_by="chain" if t_chain >= t_bytes else "bytes")
    if err:
        raise SystemExit(f"S2 disagrees with its plain version on a "
                         f"main-path walk: {c}")
    return c


def phase_scale_stream(tmp: Path, dev_info, resident_peak: int,
                       n_q=1024) -> dict:
    """The scale phase's BLASTP search with --db-stream 4: the 10^8-residue
    index stays on the host as four shards, each uploaded per pass.  The
    m8 must equal the resident run's and the device-memory peak must stay
    below the resident run's; q/s, the split, the upload seconds of each
    pass, K1's launches and K1 against its plain version."""
    r = scale_run(tmp, dev_info, tmp / "big_stream.m8", n_q, stream=4)
    same = (tmp / "big_stream.m8").read_bytes() == \
        (tmp / "big.m8").read_bytes()
    emit(phase="scale_stream", shards=4, queries=n_q,
         m8_equal_resident=same, resident_peak_device_bytes=resident_peak,
         **{k: v for k, v in r.items() if k != "cmp"})
    if not same:
        raise SystemExit("the --db-stream 4 m8 differs from the resident "
                         "run's")
    if r["peak_device_bytes"] >= resident_peak:
        raise SystemExit("the --db-stream 4 search's device-memory peak is "
                         "not below the resident run's")
    return r


def phase_scale_pigeon(tmp: Path, dev_info, n_q=1024) -> dict:
    """The scale phase's index and queries with --seed-delta 2 (pigeonhole
    seeding in phase 2; half-exact, adaptive, two phases), resident and
    then with --db-stream 4.  The two m8 must be byte-equal unless a
    budget truncation was accepted (hits_overflow or cursors_overflow at
    the accepted scale in either run): the JAX package's budgets are per
    shard under streaming, so truncated hit lists may differ.  q/s, the
    split, hits located, the overflow stats, retries, K1's launches and
    K1 against its plain version, the homolog share."""
    runs = {}
    for stream in (1, 4):
        runs[stream] = scale_run(tmp, dev_info, tmp / f"big_d2_s{stream}.m8",
                                 n_q, stream=stream, delta=2)
    same = (tmp / "big_d2_s1.m8").read_bytes() == \
        (tmp / "big_d2_s4.m8").read_bytes()
    truncated = any(r["hits_overflow"] or r["cursors_overflow"]
                    for r in runs.values())
    for stream, r in runs.items():
        emit(phase="scale_pigeon", seed_delta=2, db_stream=stream,
             queries=n_q, m8_equal_resident=same,
             truncation_accepted=truncated,
             **{k: v for k, v in r.items() if k != "cmp"})
    if not same and not truncated:
        raise SystemExit("--seed-delta 2: the streamed m8 differs from the "
                         "resident one with no budget truncation")
    return runs


def phase_scale_mesh(tmp: Path, dev_info, resident_peak: int,
                     n_q=1024) -> dict:
    """The scale phase's BLASTP search, nothing cut, over two grids laid on
    the one card: --db-shards 4 as 1 x 4 cells and --q-shards 2
    --db-shards 2 as 2 x 2.  Each m8 must equal the resident run's; q/s,
    the split, K1's launches per cell and K1 against its plain version on
    the first launches, the shard set-up seconds and the device-memory
    peak (each shard is placed on the card once, not once per cell)."""
    runs = {}
    for grid in ((1, 4), (2, 2)):
        out = tmp / f"big_mesh_{grid[0]}x{grid[1]}.m8"
        r = scale_run(tmp, dev_info, out, n_q, grid=grid)
        same = out.read_bytes() == (tmp / "big.m8").read_bytes()
        emit(phase="scale_mesh", queries=n_q, m8_equal_resident=same,
             resident_peak_device_bytes=resident_peak,
             **{k: v for k, v in r.items() if k != "cmp"})
        if not same:
            raise SystemExit(f"the {grid} mesh m8 differs from the resident "
                             "run's")
        if min(r["k1_launches_per_cell"]) <= 0:
            raise SystemExit(f"a cell of the {grid} mesh launched K1 no "
                             "time")
        runs[grid] = r
    return runs


def phase_scale_blastx(tmp: Path, dev_info, n_q=1024) -> dict:
    """BLASTX at full width on the scale phase's resident 10^8-residue
    index: 1,024 DNA reads of 300 nt (blastx_reads, numpy seed 2025) with
    default searchp options; the program is BLASTX with six query frames
    because the reads are DNA.  q/s, the per-phase split, K1's launches
    and K1 against its plain version on the first three launches' inputs,
    the share of homolog reads that hit their source subject on a query
    frame of the right sign (>= 50 %), then one rerun each under
    LAMBDA_SW_TRACE=device and the sublane layout, each m8 byte-equal to
    the default run's and K2 / K3 held against their plain version."""
    import gc

    from lambda_tpu_torch import options as opt_mod

    gc.collect()                       # the BLASTP context is gone
    torch.cuda.empty_cache()

    def make_opt(out: Path):
        return opt_mod.make_search_options(
            opt_mod.Domain.PROTEIN, query_file=str(tmp / "big_x.fasta"),
            index_file=str(tmp / "big.lit"), output=str(out), verbosity=0,
            columns=["std", "qframe"])

    rec = main_search(make_opt(tmp / "big_x.m8"), ss_inputs=True)
    ss_cmp = phase_scale_searchsorted("blastx", rec, dev_info)
    sw_cmp = phase_scale_slot_walk("blastx", rec, dev_info)
    rec.pop("ss_inputs")
    ctx, stats = rec.pop("ctx"), rec["stats"]
    hits: dict = {}
    for line in (tmp / "big_x.m8").read_text().splitlines():
        f = line.split("\t")
        hits.setdefault(f[0], set()).add(
            (f[1], "-" if f[12].startswith("-") else "+"))
    n_hom = sum(1 for i in range(n_q) if i % 10 < 7)
    found = 0
    for qid, subs in hits.items():
        if qid.startswith("hom"):
            _, src, strand = qid.split("_")
            found += (src, strand) in subs
    share = found / n_hom
    cmp = [k1_compare(*x[:7], dev_info, reps=3, x_drop=x[7], nc=x[8])
           for x in rec["k1_inputs"]]
    want_m8 = (tmp / "big_x.m8").read_bytes()
    reruns = {mode: rerun_search(ctx, make_opt, tmp / f"big_x_{mode}.m8",
                                 mode, want_m8, dev_info, n_q, 0, True,
                                 phase="scale_blastx_rerun")
              for mode in ("device_trace", "sublane")}
    program = (ctx.program.value, ctx.qry_num_frames)
    emit(phase="scale_blastx", program=program[0],
         query_frames=program[1], db_residues=int(
             ctx.idx.db_total_length), queries=n_q,
         resident_bytes=rec["resident_bytes"],
         peak_device_bytes=torch.cuda.max_memory_allocated(),
         load_s=round(rec["load_s"], 3), search_s=round(rec["search_s"], 3),
         queries_per_s=round(n_q / rec["search_s"], 2),
         queries_per_s_with_load=round(n_q / rec["total_s"], 2),
         phase_s={k: round(getattr(stats, f"time_{k}"), 3)
                  for k in PHASE_KEYS},
         k1_launches=rec["launches"], ext_rows=stats.ext_dispatch_rows,
         m8_lines=want_m8.count(b"\n"), homolog_queries=n_hom,
         homolog_hit_source_strand=found, homolog_share=round(share, 4),
         k1_main_path_compare=[{k: c[k] for k in
                                ("B", "N", "D", "exact_equal", "ms",
                                 "device_ms", "plain_ms", "bound_ms")}
                               for c in cmp])
    del ctx
    if program != ("blastx", 6):
        raise SystemExit("the DNA reads did not run as BLASTX with six "
                         "query frames")
    if rec["launches"] <= 0:
        raise SystemExit("the BLASTX search launched K1 no time")
    if share < 0.5:
        raise SystemExit(f"only {share:.2%} of homolog reads hit their "
                         "source subject on a frame of the right sign")
    if not all(c["exact_equal"] for c in cmp):
        raise SystemExit("K1 disagrees with its plain version on the BLASTX "
                         "search's inputs")
    return dict(launches=rec["launches"], cmp=cmp, reruns=reruns,
                ss_launches=rec["ss_launches"], ss_cmp=ss_cmp,
                sw_launches=rec["sw_launches"], sw_cmp=sw_cmp)


def rerun_search(ctx, make_opt, out: Path, mode: str, want_m8: bytes,
                 dev_info, n_q: int, rnd: int, check: bool,
                 phase: str = "scale_rerun") -> dict:
    """A scale search's queries again through run_search on the SAME
    resident index (SearchContext is handed the loaded context), with the
    ``mode``'s switch on: its kernel's launches counted from 0 and the m8
    (written to ``out``; ``make_opt(out)`` gives the options) held
    byte-equal to the default run's.  With ``check`` the kernel is also
    held against its plain version on its first three launches'
    inputs."""
    from lambda_tpu_torch.search import pipeline

    counter = MODES[mode]
    wrapper = {"default": "_sw_band_score_cuda",
               "device_trace": "_sw_band_align_cuda",
               "sublane": "_sw_band_score_sub_cuda"}[mode]
    cls = pipeline.SearchContext
    pipeline.SearchContext = lambda *a, **kw: ctx      # the resident index
    try:
        with switched(mode), capture(wrapper, first(3 if check else 0)) \
                as captured:
            reset_band_launches()                  # this path starts
            t0 = time.perf_counter()
            stats = pipeline.run_search(make_opt(out), device="cuda")
            torch.cuda.synchronize()
            search_s = time.perf_counter() - t0
            n = band_launches()                    # ... and ends
    finally:
        pipeline.SearchContext = cls
    same = out.read_bytes() == want_m8
    if mode == "device_trace":
        cmp = [k2_compare(*x, dev_info) for x in captured]
    else:
        cmp = [k1_compare(*x, dev_info, reps=3, plain_reps=0, kernel="K3")
               for x in captured]
    emit(phase=phase, mode=mode, round=rnd, m8_equal_default=same,
         search_s=round(search_s, 3),
         queries_per_s=round(n_q / search_s, 2),
         time_extend_s=round(stats.time_extend, 3),
         time_extend_trace_s=round(stats.time_extend_trace, 3),
         phase_s={k: round(getattr(stats, f"time_{k}"), 3)
                  for k in PHASE_KEYS},
         k1_launches=n["launches"], k2_launches=n["launches_dirs"],
         k3_launches=n["launches_sub"],
         main_path_compare=[{k: c[k] for k in
                             ("B", "N", "D", "exact_equal", "ms",
                              "device_ms", "plain_ms", "bound_ms",
                              "bound_by")}
                            for c in cmp])
    if not same:
        raise SystemExit(f"the {mode} run's m8 differs from the default "
                         "run's")
    if n[counter] <= 0 or (check and not cmp):
        raise SystemExit(f"the {mode} run launched its kernel no time")
    if not all(c["exact_equal"] for c in cmp):
        raise SystemExit(f"the {mode} run's kernel disagrees with its plain "
                         "version on main-path inputs")
    return dict(launches=n[counter], cmp=cmp, search_s=round(search_s, 3),
                time_extend_trace_s=round(stats.time_extend_trace, 3))


def profile_search(ctx, opt) -> dict:
    """The main path's query batches once more on the resident index
    (same two-phase flow as run_search), under torch.profiler: the
    device time of all kernels, their launches, and the top three."""
    from lambda_tpu_torch import alphabets as ab
    from lambda_tpu_torch.io import fasta
    from lambda_tpu_torch.stats import StatsHolder

    seqs = [ab.encode(r.seq, ctx.qry_orig_alph)
            for r in fasta.read_fasta(opt.query_file)]
    B = opt.query_batch_size
    st = StatsHolder()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for i in range(0, len(seqs), B):
            batch = seqs[i:i + B]
            res = ctx.process_batch(batch, opt.search_opts0, st)
            rest = [q for q in range(len(batch)) if not res.get(q)]
            if rest:
                ctx.process_batch([batch[q] for q in rest], opt.search_opts,
                                  st)
        torch.cuda.synchronize()
    kern = [e for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA]
    top = sorted(kern, key=lambda e: -e.self_device_time_total)[:3]
    return dict(device_busy_ms=sum(e.self_device_time_total
                                   for e in kern) / 1e3,
                kernel_launches=sum(e.count for e in kern),
                top_kernels=[[e.key[:48], e.self_device_time_total / 1e3,
                              e.count] for e in top])


def cmp_sums(cmp, launches) -> dict:
    """A path's launches and the sums over its timed launches."""
    return dict(launches=launches, launches_timed=len(cmp),
                exact_equal=all(c["exact_equal"] for c in cmp),
                max_abs_err=max([c["max_abs_err"] for c in cmp] or [0]),
                **{k: sum(c[k] for c in cmp) for k in
                   ("ms", "device_ms", "plain_ms", "bound_ms")})


def bound_by(cmp) -> str:
    """What bounds a set of timed launches: their common ``bound_by``
    ("operations" where there is none), else "mixed"."""
    by = {c["bound_by"] for c in cmp} or {"operations"}
    return by.pop() if len(by) == 1 else "mixed"


def kernel_entry(name, source, replaces, launches, worst, cmp,
                 **extra) -> dict:
    """One entry of the kernels line: main-path launches, and the sums
    over the timed main-path launches (or op calls) of kernel (the call
    as issued, and the device's work alone), plain and bound times."""
    return dict(
        name=name, route="cuda", source=source, replaces=replaces,
        launches=launches,
        max_abs_err=max([worst] + [c["max_abs_err"] for c in cmp]),
        exact_equal=all(c["exact_equal"] for c in cmp),
        ms=sum(c["ms"] for c in cmp),
        device_ms=sum(c["device_ms"] for c in cmp),
        plain_ms=sum(c["plain_ms"] for c in cmp),
        bound_ms=sum(c["bound_ms"] for c in cmp),
        bound_by=bound_by(cmp),
        library_ms=None, main_path_launches_timed=len(cmp), **extra)


def main() -> int:
    if sys.argv[1:2] == ["--warp-sweep"]:
        phase_device()
        warp_sweep()
        return 0
    if sys.argv[1:2] == ["--rect-sweep"]:
        phase_device()
        rect_sweep()
        return 0
    if sys.argv[1:2] == ["--card-cpu-xdrop"]:       # phase_card_cpu_xdrop
        if not torch.cuda.is_available():
            raise SystemExit("chip_smoke: torch.cuda.is_available() is false")
        phase_card_cpu(Path(sys.argv[2]), tag="xdrop")
        return 0
    if sys.argv[1:2] == ["--golden-child"]:         # phase_golden
        if not torch.cuda.is_available():
            raise SystemExit("chip_smoke: torch.cuda.is_available() is false")
        golden_child(sys.argv[2], Path(sys.argv[3]))
        return 0
    dev_info = phase_device()
    phase_build()
    phase_rates(dev_info)
    k1 = phase_k1(dev_info)
    k2 = phase_k2(dev_info)
    k3 = phase_k3(dev_info)
    phase_grid(dev_info)
    k4 = phase_k4(dev_info)
    mstep = phase_mesh_step(dev_info)
    (REPO / "build").mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=REPO / "build") as d:
        tmp = Path(d)
        golden = phase_golden(tmp)
        phase_card_cpu(tmp)
        phase_card_cpu_xdrop(tmp)
        modes = phase_card_cpu_modes(tmp, dev_info)
        paths = phase_card_cpu_paths(tmp, dev_info)
        cmesh = phase_card_cpu_mesh(tmp, dev_info)
        scale = phase_scale(tmp, dev_info)
        blastx = phase_scale_blastx(tmp, dev_info)
        stream = phase_scale_stream(tmp, dev_info, scale["peak"])
        pigeon = phase_scale_pigeon(tmp, dev_info)
        smesh = phase_scale_mesh(tmp, dev_info, scale["peak"])
    reruns = scale["reruns"]
    bx_reruns = {m: dict(cmp=r["cmp"], launches=r["launches"])
                 for m, r in blastx["reruns"].items()}

    def bench(r):
        return {k: r[k] for k in ("B", "N", "D", "ms", "device_ms", "plain_ms",
                                  "bound_ms", "rect_gcups", "inband_gcups")}

    print(smi("name,power.limit"), flush=True)
    emit(kernels=[
        kernel_entry(
            "K1 sw_band_score", "lambda_tpu_torch/csrc/sw_band.cu",
            "lambda_tpu/ops/sw_band.py:572 _make_band_kernel_lane",
            scale["launches"], k1["worst"], scale["cmp"],
            bench_shape=bench(k1["bench"]),
            blastx=cmp_sums(blastx["cmp"], blastx["launches"]),
            stream=cmp_sums(stream["cmp"], stream["k1_launches"]),
            pigeon=cmp_sums(pigeon[1]["cmp"], pigeon[1]["k1_launches"]),
            pigeon_stream=cmp_sums(pigeon[4]["cmp"],
                                   pigeon[4]["k1_launches"]),
            path_launches=dict(golden=golden["default"], **modes,
                               **{f"card_cpu_{n}": v
                                  for n, v in paths.items()},
                               scale_stream=stream["k1_launches"],
                               scale_pigeon=pigeon[1]["k1_launches"],
                               scale_pigeon_stream=pigeon[4]["k1_launches"],
                               trace_dir=scale["trace_launches"],
                               **{f"card_cpu_mesh_{n}": v
                                  for n, v in cmesh.items()
                                  if n in CARD_CPU_MESH
                                  and CARD_CPU_MESH[n][3] == "default"},
                               **{f"scale_mesh_{q}x{d}":
                                  r["k1_launches_per_cell"]
                                  for (q, d), r in smesh.items()}),
            mesh=cmp_sums(smesh[(1, 4)]["cmp"],
                          smesh[(1, 4)]["k1_launches"])),
        kernel_entry(
            "K2 sw_band_dirs", "lambda_tpu_torch/csrc/sw_band_dirs.cu",
            "lambda_tpu/ops/sw_band.py:277 _make_band_dirs_kernel",
            reruns["device_trace"]["launches"], k2["worst"],
            reruns["device_trace"]["cmp"],
            blastx=cmp_sums(**bx_reruns["device_trace"]),
            path_launches=dict(
                golden=golden["device_trace"],
                card_cpu_mesh=cmesh["blastp_db2_device_trace"])),
        kernel_entry(
            "K3 sw_band_sub", "lambda_tpu_torch/csrc/sw_band_sub.cu",
            "lambda_tpu/ops/sw_band.py:728 _make_band_kernel",
            reruns["sublane"]["launches"], k3["worst"],
            reruns["sublane"]["cmp"], bench_shape=bench(k3["bench"]),
            blastx=cmp_sums(**bx_reruns["sublane"]),
            path_launches=dict(
                golden=golden["sublane"],
                card_cpu_mesh=cmesh["blastp_db2_sublane"])),
        kernel_entry(
            "K4 sw_rect", "lambda_tpu_torch/csrc/sw_rect.cu",
            "lambda_tpu/ops/sw_pallas.py:118 _make_kernel",
            mstep["launches"], 0, mstep["cmp"],
            path="mesh_step (parallel/mesh.py:make_sharded_search_step)",
            path_launches=mstep["per_grid"],
            op_cases=cmp_sums(k4["rows"], k4["launches"])),
        kernel_entry(
            "S1 searchsorted", "lambda_tpu_torch/csrc/searchsorted.cu",
            "none (lambda_tpu/ops/searchsorted.py:search_range, jnp ops "
            "in a lax.while_loop)",
            scale["ss_launches"], 0, scale["ss_cmp"],
            blastx=cmp_sums(blastx["ss_cmp"], blastx["ss_launches"]),
            load_latency=dev_info["ss_latency"],
            path_launches=dict(
                scale_blastx=blastx["ss_launches"],
                scale_stream=stream["ss_launches"],
                scale_pigeon=pigeon[1]["ss_launches"],
                scale_pigeon_stream=pigeon[4]["ss_launches"],
                **{f"scale_mesh_{q}x{d}": r["ss_launches"]
                   for (q, d), r in smesh.items()})),
        kernel_entry(
            "S2 slot_walk", "lambda_tpu_torch/csrc/slot_walk.cu",
            "none (lambda_tpu/search/seeding.py:503, the slot walk in a "
            "lax.scan)",
            scale["sw_launches"], 0, scale["sw_cmp"],
            blastx=cmp_sums(blastx["sw_cmp"], blastx["sw_launches"]),
            warp_sum_ns=dev_info["warp_sum_ns"],
            path_launches=dict(
                scale_blastx=blastx["sw_launches"],
                scale_stream=stream["sw_launches"],
                scale_pigeon=pigeon[1]["sw_launches"],
                scale_pigeon_stream=pigeon[4]["sw_launches"],
                **{f"scale_mesh_{q}x{d}": r["sw_launches"]
                   for (q, d), r in smesh.items()})),
    ])
    emit(ok=True, device=dict(platform="gpu",
                              kind=torch.cuda.get_device_name(0),
                              count=torch.cuda.device_count()))
    return 0


if __name__ == "__main__":
    sys.exit(main())
