// Seeding's slot walk for Hopper (sm_90a): the adaptive elongation walk
// (lambda/src/search_algo.hpp:679-726) of a batch's walked cursors, one warp
// per query carrying the query's hitsThisSeq across its slots.
//
// Replaces no TPU kernel.  The JAX package walks the slots in a lax.scan
// inside one XLA program (lambda_tpu/search/seeding.py:503).  The port's
// eager version (ops/slot_walk.py: slot_walk_torch, kept as this kernel's
// plain version) reads the slots' row bounds to the host and loops over
// the slots in Python, some 25 small kernels a slot and up to about 1,024
// slots a call: the host's launches, not the card, set its time.  This
// file does each call in one launcher call.
//
// What it computes (slot_walk_launch): the rows are sorted by (slot t,
// query q); row i has the count curve curve[i, 0..E] (its count with
// 0..E further query characters), room_i = flen_i - beg_i - k (the
// elongations that stay inside the query frame) and rem_i (the
// remaining-seed estimate).  Per query q, h = hits0[q]; for t = 0..T-1:
//   every row i of segment (t, q): desired = h >= max_matches ? 1 :
//     max(1, (max_matches - h) * heuristic_factor / max(rem_i, 1));
//     step e = 0..E-1 is accepted while e < room_i, curve[i, e] > 0 and
//     not (curve[i, e+1] < desired and curve[i, e+1] < curve[i, e]); the
//     first refusal stops the row; L[i] = the steps accepted;
//   h += base[t, q] + the sum of curve[i, L[i]] over the segment's rows
//     with 0 < curve[i, L[i]] <= occ_cap.
// This is the plain version's hits-before-the-slot plus walked-so-far
// written as a running sum, in the same integer arithmetic: the quotient
// of desired is truncated, which equals the plain version's floor
// wherever max(1, .) can tell them apart.
//
// Two kernels, enqueued by the one launcher call:
//   slot_seg_kernel: seg[t * Q + q] = the first row of segment (t, q),
//     for every t * Q + q in [0, T * Q] (a bisection over the rows' keys
//     t * Q + q), and L zeroed (a row outside every segment walks no step).
//   slot_walk_kernel: warp q walks query q's slots in order, its lanes
//     over the segment's rows (strided by 32; a segment holds 1 to V rows),
//     a warp sum of the kept counts per slot.
//
// Bound: only the carry h is serial.  Each slot's bounds and base (loaded
// 32 slots at a time, one slot a lane, a block of slots ahead) and each
// lane's first row of the next slot (its curve, room and rem in registers
// for E <= 32) do not depend on h, so they are loaded while the current
// slot walks: the chain per slot is a row walk in registers and a warp
// reduction, not a device-memory latency.  The least time of a call is the
// larger of (bytes read once: curves, rows' beg/flen/rem, the slot keys,
// base, seg) / 3.35 TB/s and T x (one warp reduction and add); one warp
// per query keeps every query's chain in flight at once, since the queries
// are independent.  Rows past a lane's first in a slot (segments of more
// than 32 rows) and E > 32 read their curve from device memory in the walk.

#include <cuda_runtime.h>
#include <stdint.h>

typedef long long i64;

#define SEG_THREADS 256
// warps (queries) per block of the walk
#define SW_WARPS 4
#define FULL 0xffffffffu

// seg[kk] = the first row i with t_w[i] * Q + q_w[i] >= kk, kk = 0..nk-1;
// L zeroed
__global__ void __launch_bounds__(SEG_THREADS) slot_seg_kernel(
    const i64* __restrict__ t_w, const i64* __restrict__ q_w, i64 n, i64 Q,
    i64 nk, i64* __restrict__ seg, i64* __restrict__ L)
{
    const i64 i = (i64)blockIdx.x * blockDim.x + threadIdx.x;
    if (i < n) L[i] = 0;
    if (i >= nk) return;
    i64 lo = 0, hi = n;
    while (lo < hi) {
        const i64 mid = lo + ((hi - lo) >> 1);
        if (__ldg(t_w + mid) * Q + __ldg(q_w + mid) < i) lo = mid + 1;
        else hi = mid;
    }
    seg[i] = lo;
}

// a row's walk inputs held in registers: its curve up to E <= EM
template <int EM>
struct Row {
    i64 c[EM + 1];
    i64 room, rem;
};

struct Walk {
    const i64* curve;
    const i64* beg;
    const i64* flen;
    const i64* rem;
    int E;
    i64 k, mm, hf, occ_cap;
};

template <int EM>
__device__ __forceinline__ void load_row(Row<EM>& r, const Walk& w, i64 row)
{
    const i64* c = w.curve + row * (w.E + 1);
#pragma unroll
    for (int e = 0; e <= EM; ++e)
        if (e <= w.E) r.c[e] = __ldg(c + e);
    r.room = __ldg(w.flen + row) - __ldg(w.beg + row) - w.k;
    r.rem = __ldg(w.rem + row);
}

__device__ __forceinline__ i64 desired_occs(i64 h, i64 rem, const Walk& w)
{
    if (h >= w.mm) return 1;
    const i64 d = (w.mm - h) * w.hf / (rem > 1 ? rem : 1);
    return d > 1 ? d : 1;
}

// the walk of a row from its curve in registers: the steps accepted, and
// g = its count after them
template <int EM>
__device__ __forceinline__ i64 walk_regs(const Row<EM>& r, int E, i64 d,
                                         i64& g)
{
    i64 L = 0;
    g = r.c[0];
    bool go = true;
#pragma unroll
    for (int e = 0; e < EM; ++e) {
        if (go && e < E) {
            const i64 c1 = r.c[e], c2 = r.c[e + 1];
            if (e < r.room && c1 > 0 && !(c2 < d && c2 < c1)) {
                L = e + 1;
                g = c2;
            } else {
                go = false;
            }
        }
    }
    return L;
}

// the same walk, its curve read from device memory step by step
__device__ __forceinline__ i64 walk_global(const Walk& w, i64 row, i64 room,
                                           i64 d, i64& g)
{
    const i64* c = w.curve + row * (w.E + 1);
    i64 c1 = __ldg(c);
    i64 L = 0;
    for (int e = 0; e < w.E; ++e) {
        if (!(e < room && c1 > 0)) break;
        const i64 c2 = __ldg(c + e + 1);
        if (c2 < d && c2 < c1) break;
        L = e + 1;
        c1 = c2;
    }
    g = c1;
    return L;
}

__device__ __forceinline__ i64 warp_sum(i64 v)
{
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(FULL, v, o);
    return v;
}

// slot t's [a, b) and base of query q (empty past the last slot)
__device__ __forceinline__ void slot_bounds(
    const i64* __restrict__ seg, const i64* __restrict__ base, int t, int T,
    int Q, int q, i64& a, i64& b, i64& bs)
{
    a = b = bs = 0;
    if (t < T) {
        const i64 r = (i64)t * Q + q;
        a = __ldg(seg + r);
        b = __ldg(seg + r + 1);
        bs = __ldg(base + r);
    }
}

template <int EM>
__global__ void __launch_bounds__(SW_WARPS * 32) slot_walk_kernel(
    Walk w, const i64* __restrict__ base, const i64* __restrict__ hits0,
    const i64* __restrict__ seg, int T, int Q, i64* __restrict__ L_out)
{
    const int lane = threadIdx.x & 31;
    const int q = blockIdx.x * SW_WARPS + (threadIdx.x >> 5);
    if (q >= Q) return;                       // a whole warp
    i64 h = __ldg(hits0 + q);
    // lane j: slot tb + j's rows [sa, sb) and base
    i64 sa, sb, sbase;
    slot_bounds(seg, base, lane, T, Q, q, sa, sb, sbase);
    // EM > 0: each lane's first row of the slot, loaded a slot ahead
    Row<(EM > 0 ? EM : 1)> cur, nxt;
    {
        const i64 a = __shfl_sync(FULL, sa, 0), b = __shfl_sync(FULL, sb, 0);
        if (EM > 0 && a + lane < b) load_row(cur, w, a + lane);
    }
    for (int tb = 0; tb < T; tb += 32) {
        i64 na, nb, nbase;                    // the next block of slots
        slot_bounds(seg, base, tb + 32 + lane, T, Q, q, na, nb, nbase);
        const int ns = T - tb < 32 ? T - tb : 32;
        for (int j = 0; j < ns; ++j) {
            const i64 a = __shfl_sync(FULL, sa, j);
            const i64 b = __shfl_sync(FULL, sb, j);
            const i64 bs = __shfl_sync(FULL, sbase, j);
            // the next slot's first rows, loaded while this slot walks
            const int jn = (j + 1) & 31;
            const i64 an_in = __shfl_sync(FULL, sa, jn);
            const i64 bn_in = __shfl_sync(FULL, sb, jn);
            const i64 an_out = __shfl_sync(FULL, na, 0);
            const i64 bn_out = __shfl_sync(FULL, nb, 0);
            const i64 an = j < 31 ? an_in : an_out;
            const i64 bn = j < 31 ? bn_in : bn_out;
            if (EM > 0 && an + lane < bn) load_row(nxt, w, an + lane);
            i64 kept = 0;
            if (a < b) {                      // the same in every lane
                for (i64 row = a + lane; row < b; row += 32) {
                    i64 g, L;
                    if (EM > 0 && row == a + lane) {
                        L = walk_regs(cur, w.E, desired_occs(h, cur.rem, w),
                                      g);
                    } else {
                        const i64 room = __ldg(w.flen + row)
                            - __ldg(w.beg + row) - w.k;
                        L = walk_global(w, row, room,
                                        desired_occs(h, __ldg(w.rem + row),
                                                     w), g);
                    }
                    L_out[row] = L;
                    if (g > 0 && g <= w.occ_cap) kept += g;
                }
                kept = warp_sum(kept);
            }
            h += bs + kept;
            if (EM > 0) cur = nxt;
        }
        sa = na;
        sb = nb;
        sbase = nbase;
    }
}

// The walk of n rows sorted by (t_w, q_w) (see the header): curve (n, E+1),
// t_w, q_w, beg, flen, rem (n,), base (T, Q), hits0 (Q,), all int64; seg
// (T * Q + 1,) scratch; writes L (n,).  Returns the first nonzero
// cudaGetLastError() of its two launches.
extern "C" int slot_walk_launch(
    const i64* curve, const i64* t_w, const i64* q_w, const i64* beg,
    const i64* flen, const i64* rem, const i64* base, int E, long long n,
    int T, int Q, long long k, long long mm, long long hf, long long occ_cap,
    const i64* hits0, i64* seg, i64* L, void* stream)
{
    if (n <= 0) return 0;
    if (E < 0 || T < 0 || Q < 0) return (int)cudaErrorInvalidValue;
    cudaStream_t st = (cudaStream_t)stream;
    const i64 nk = (i64)T * Q + 1;
    const i64 m = n > nk ? n : nk;
    slot_seg_kernel<<<(int)((m + SEG_THREADS - 1) / SEG_THREADS),
                      SEG_THREADS, 0, st>>>(t_w, q_w, n, Q, nk, seg, L);
    int err = (int)cudaGetLastError();
    if (err != 0 || T == 0 || Q == 0) return err;
    const Walk w{curve, beg, flen, rem, E, k, mm, hf, occ_cap};
    const int blocks = (Q + SW_WARPS - 1) / SW_WARPS;
#define SW_WALK(EM)                                                         \
    slot_walk_kernel<EM><<<blocks, SW_WARPS * 32, 0, st>>>(                 \
        w, base, hits0, seg, T, Q, L)
    if (E <= 8) SW_WALK(8);
    else if (E <= 16) SW_WALK(16);
    else if (E <= 32) SW_WALK(32);
    else SW_WALK(0);
#undef SW_WALK
    return (int)cudaGetLastError();
}
