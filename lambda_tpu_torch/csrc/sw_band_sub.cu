// K3: banded affine-gap Smith-Waterman score pass for Hopper (sm_90a), one
// thread per alignment with the band in that thread's registers.  Chosen
// by LAMBDA_SWB_LAYOUT=sublane.
//
// Replaces the Pallas TPU kernel lambda_tpu/ops/sw_band.py:
// _make_band_kernel (launched by _score_band_padded), together with its
// feeder _band_image_sub.  The TPU kernel keeps its state as (W, BTL):
// alignments on the lane axis, one per lane, the band offset on the
// sublane axis.  On the card the lane axis is the warp's 32 threads and
// the sublane axis is one thread's registers.  K1 (csrc/band_warp.cuh)
// spreads a band over G >= 4 lanes and pays for a scan; this is the G = 1
// limit, written on its own.
//
// What it computes: exactly K1's function without X-drop -- for every
// alignment b the best local score over the cells whose band offset
// w = i - j + D lies in [D - d_rows[b], D]; off-band cells are dead
// (H = 0, E = -inf, F sources -inf); rows with d_rows[b] < 0 and rows
// past B score 0.  D has no upper limit.
//
// Layout.  The band is held as WP * S offsets k, the band's offset D at
// k = WP * S - 1 and the padding (never in band) at the bottom; offset w
// sits at k = w + WP * S - 1 - D.  Up to D + 1 = SUB_REG_MAX offsets
// (S = 1) H, E and the query rank of every offset live in registers; a
// wider band lives in a global scratch laid out [k][b] -- a warp's 32
// alignments read 32 consecutive words, the TPU's (W, BTL) state -- and
// is swept in S chunks of WP offsets, upward.
//
// Per window column j, thread b sweeps k upward, in place:
//   E[k] = max(E[k+1] + ge, H[k+1] + gf)          (previous column)
//   T    = max(H[k] + sub(q[i], s[j]), E[k], 0)   (H[k]: the diagonal)
//   F    = max(F + ge, T_prev + gf)               (running up the band)
//   H[k] = max(T, F)
// Ascending order reads H[k+1] and E[k+1] before this column overwrites
// them, so the sweep needs no temporary column, no scan, no shuffle and no
// barrier.  The query rank of (j, k) is that of (j - 1, k + 1), so only
// the top offset reads a new rank, q[j]; the ranks (as table offsets)
// shift down one register per column.  The register path sweeps two
// columns per loop turn in straight-line code, so that column j + 1's low
// offsets overlap column j's F chain.  A chunk of the scratch path takes
// the chunk above's old bottom H, E and rank as its k + 1 (read before
// that chunk is rewritten in this column) and carries F and T_prev up;
// chunks wholly below the row's band are skipped.
//
// Dead cells.  The offsets below the row's band, k < kmin, form a prefix;
// their T is forced to 0.  Then their F stays negative and their H is 0,
// and their E is never read by a live cell (E comes from above), so one
// select per cell replaces the three masks of the band's definition.  The
// best is taken over T: F in a column is always below the T it came from.
//
// Scores.  32 threads of a warp look up 32 random entries; a shared
// matrix would be about 3.5-way bank conflicted.  Each lane gets its own
// interleaved int8 copy instead, built in the block's prologue from
// subst8: entry (q, s) of lane l sits at byte
//   128 * (q * Cw + (s >> 2)) + 4 * l + (s & 3),   Cw = ceil(C / 4),
// so lane l always reads bank l, the per-column part 128 * (s >> 2) +
// 4 * l + (s & 3) is added once per column, and a cell's score is one add
// and one signed byte load from its query rank's row offset 128 * Cw * q.
// The window and query rows are staged per thread, SUB_CHUNK columns at
// a time, into shared memory with aligned 16-byte loads.
//
// Bound: int32 operations, like K1: 11 per needed cell of the function
// (5 adds, 6 maxes), or 7 DPX-folded instructions (csrc/int_rate.cu),
// against inputs of two int8 rows per alignment read once.  The design
// spends about 12 instructions per cell (the 7, the score's add and load,
// the rank shift and the dead-cell select) with no barrier, no shuffle and
// no shared state traffic, and the table has no bank conflicts.  What it
// cannot do: fill the card at a few hundred alignments, where the time is
// one thread's instruction stream, or keep a band wider than 64 offsets
// near the SM: the scratch path moves 24 bytes of state per cell.

#include <cuda_runtime.h>
#include <stdint.h>

#ifndef NEG32
#define NEG32 (-(1 << 27))
#endif

#define SUB_THREADS 128                // threads (alignments) per block
#define SUB_REG_MAX 64                 // widest register band; scratch chunk
#define SUB_CHUNK 64                   // window columns per staging refill
#define SUB_STAGE (SUB_CHUNK + 16)     // staging bytes per row and stream

struct SubProblem {
    const int8_t* q;          // (B, N) query ranks, PAD beyond the query
    const int8_t* s;          // (B, N) virtual windows
    const int32_t* d_rows;    // (B,) band per row, -1: padding row
    const int8_t* subst8;     // (C, C), PAD row/column last
    int B, N, D, C, gf, ge;
    int S;                    // chunks of WP offsets (S > 1: scratch)
    int32_t* scratch;         // S > 1: 3 * WP * S int32 per grid thread
    int32_t* out;             // (B,) best
};

// Bytes of the per-lane tables, rounded to 16.
__device__ __forceinline__ int sub_table_bytes(int C)
{
    return (C * ((C + 3) >> 2) * 128 + 15) & ~15;
}

// Copy the 16-byte-aligned blocks that cover bytes [start, start +
// SUB_CHUNK) of `base` into `buf` (16-byte aligned, SUB_STAGE bytes).
// Blocks wholly inside the tensor's [0, total) bytes are one 16-byte
// load; the few at its ends are read byte by byte.  Returns the position
// of base[start] in buf.
__device__ __forceinline__ int sub_stage(const int8_t* __restrict__ base,
                                         size_t total, size_t start,
                                         int8_t* buf)
{
    const uintptr_t a = (uintptr_t)(base + start);
    const uintptr_t a0 = a & ~(uintptr_t)15;
    const uintptr_t lo = (uintptr_t)base, hi = (uintptr_t)(base + total);
    const int nblk = (int)((a - a0 + SUB_CHUNK + 15) >> 4);
    for (int k = 0; k < nblk; ++k) {
        const uintptr_t p = a0 + 16 * (uintptr_t)k;
        union { int4 v; int8_t c[16]; } u;
        if (p >= lo && p + 16 <= hi) {
            u.v = __ldg((const int4*)p);
        } else {
            for (int i = 0; i < 16; ++i)
                u.c[i] = (p + i >= lo && p + i < hi)
                             ? *(const int8_t*)(p + i) : (int8_t)0;
        }
        ((int4*)buf)[k] = u.v;
    }
    return (int)(a - a0);
}

// One window column over WP offsets held in registers, k = 0 .. WP - 1
// of a chunk.  H, E, Q (the query ranks' table offsets) hold the previous
// column on entry and this column on exit.  hu, eu, qu: H, E and table
// offset of the offset above the chunk (previous column).  tcol: the
// lane's table plus this column's window part.  Cells k < kmin are dead.
// f and tp carry F and the last T up from the chunk below.
template <int WP>
__device__ __forceinline__ void sub_column(
    int (&H)[WP], int (&E)[WP], int (&Q)[WP], int hu, int eu, int qu,
    const int8_t* tcol, int kmin, int gf, int ge, int& f, int& tp,
    int& best)
{
#pragma unroll
    for (int k = 0; k < WP; ++k) {
        const int hup = k + 1 < WP ? H[k + 1] : hu;
        const int eup = k + 1 < WP ? E[k + 1] : eu;
        Q[k] = k + 1 < WP ? Q[k + 1] : qu;
        const int e = __viaddmax_s32(eup, ge, hup + gf);
        const int t0 = __viaddmax_s32_relu(H[k], (int)tcol[Q[k]], e);
        const int t = k >= kmin ? t0 : 0;
        f = __viaddmax_s32(f, ge, tp + gf);
        H[k] = max(t, f);
        E[k] = e;
        if (k & 1) best = __vimax3_s32(best, tp, t);
        tp = t;
    }
}

template <int WP, bool SCRATCH>
__global__ void __launch_bounds__(SUB_THREADS)
sw_band_sub_kernel(SubProblem P)
{
    extern __shared__ int4 smem[];
    const int C = P.C, Cw = (C + 3) >> 2;
    // the per-lane tables: word x holds entries (q, 4 * s4 .. 4 * s4 + 3)
    // of lane x & 31, with x >> 5 = q * Cw + s4
    uint32_t* t32 = (uint32_t*)smem;
    for (int x = threadIdx.x; x < C * Cw * 32; x += SUB_THREADS) {
        const int g = x >> 5, qv = g / Cw, s0 = 4 * (g - qv * Cw);
        uint32_t w = 0;
        for (int r = 0; r < 4; ++r)
            if (s0 + r < C)
                w |= (uint32_t)(uint8_t)P.subst8[qv * C + s0 + r] << (8 * r);
        t32[x] = w;
    }
    __syncthreads();
    // threads only read their own rows from here on: no more barriers
    const int b = blockIdx.x * SUB_THREADS + threadIdx.x;
    const int d = b < P.B ? P.d_rows[b] : -1;
    if (d < 0) {
        if (b < P.B) P.out[b] = 0;
        return;
    }
    const int lane = threadIdx.x & 31;
    const int S = SCRATCH ? P.S : 1;
    const int Wp = WP * S;
    const int N = P.N, D = P.D, gf = P.gf, ge = P.ge;
    const int kmin = Wp - 1 - min(d, D);
    const int qstride = 128 * Cw;
    const int qpad = (C - 1) * qstride;
    const int8_t* tbl = (const int8_t*)smem + 4 * lane;
    int8_t* qbuf = (int8_t*)smem + sub_table_bytes(C)
                   + threadIdx.x * SUB_STAGE;
    int8_t* sbuf = qbuf + SUB_THREADS * SUB_STAGE;
    int H[WP], E[WP], Q[WP];
#pragma unroll
    for (int k = 0; k < WP; ++k) {
        H[k] = 0;
        E[k] = NEG32;
        Q[k] = qpad;
    }
    int32_t* Hs = nullptr;
    int32_t* Es = nullptr;
    int32_t* Qs = nullptr;
    size_t rows = 0;
    if constexpr (SCRATCH) {
        rows = (size_t)gridDim.x * SUB_THREADS;
        Hs = P.scratch + b;
        Es = Hs + (size_t)Wp * rows;
        Qs = Es + (size_t)Wp * rows;
        for (int k = 0; k < Wp; ++k) {
            Hs[k * rows] = 0;
            Es[k * rows] = NEG32;
            Qs[k * rows] = qpad;
        }
    }
    const size_t row = (size_t)b * N, total = (size_t)P.B * N;
    int best = 0, qo = 0, so = 0, c0 = 0;
    if constexpr (!SCRATCH) {
        // the window part of column j's score address and its new query
        // rank, after staging the next SUB_CHUNK columns when j starts them
        auto column_inputs = [&](int j, const int8_t*& tcol, int& qtop) {
            if (j % SUB_CHUNK == 0) {
                qo = sub_stage(P.q, total, row + j, qbuf);
                so = sub_stage(P.s, total, row + j, sbuf);
                c0 = j;
            }
            const int sv = sbuf[so + j - c0];
            qtop = qbuf[qo + j - c0] * qstride;
            tcol = tbl + 128 * (sv >> 2) + (sv & 3);
        };
        // two columns per turn in straight-line code, so that column
        // j + 1's low offsets overlap column j's F chain (a pair never
        // straddles a staging refill: SUB_CHUNK is even)
        int j = 0;
        for (; j + 1 < N; j += 2) {
            const int8_t *t0, *t1;
            int q0, q1;
            column_inputs(j, t0, q0);
            column_inputs(j + 1, t1, q1);
            int f = NEG32, tp = NEG32;
            sub_column<WP>(H, E, Q, 0, NEG32, q0, t0, kmin, gf, ge, f, tp,
                           best);
            int f1 = NEG32, tp1 = NEG32;
            sub_column<WP>(H, E, Q, 0, NEG32, q1, t1, kmin, gf, ge, f1, tp1,
                           best);
        }
        if (j < N) {
            const int8_t* t0;
            int q0;
            column_inputs(j, t0, q0);
            int f = NEG32, tp = NEG32;
            sub_column<WP>(H, E, Q, 0, NEG32, q0, t0, kmin, gf, ge, f, tp,
                           best);
        }
    } else {
        for (int j = 0; j < N; ++j) {
            if (j % SUB_CHUNK == 0) {
                qo = sub_stage(P.q, total, row + j, qbuf);
                so = sub_stage(P.s, total, row + j, sbuf);
                c0 = j;
            }
            const int sv = sbuf[so + j - c0];
            const int qtop = qbuf[qo + j - c0] * qstride;
            const int8_t* tcol = tbl + 128 * (sv >> 2) + (sv & 3);
            int f = NEG32, tp = NEG32;
            for (int c = 0; c < S; ++c) {
                const int k0 = c * WP;
                if (k0 + WP <= kmin) continue;      // wholly below the band
#pragma unroll
                for (int k = 0; k < WP; ++k) {
                    H[k] = Hs[(k0 + k) * rows];
                    E[k] = Es[(k0 + k) * rows];
                    Q[k] = Qs[(k0 + k) * rows];
                }
                int hu = 0, eu = NEG32, qu = qtop;
                if (c + 1 < S) {                    // old values, above
                    hu = Hs[(k0 + WP) * rows];
                    eu = Es[(k0 + WP) * rows];
                    qu = Qs[(k0 + WP) * rows];
                }
                sub_column<WP>(H, E, Q, hu, eu, qu, tcol, kmin - k0, gf, ge,
                               f, tp, best);
#pragma unroll
                for (int k = 0; k < WP; ++k) {
                    Hs[(k0 + k) * rows] = H[k];
                    Es[(k0 + k) * rows] = E[k];
                    Qs[(k0 + k) * rows] = Q[k];
                }
            }
        }
    }
    P.out[b] = best;
}

template <int WP, bool SCRATCH>
static int launch(const SubProblem& P, long long smem_bytes,
                  cudaStream_t stream)
{
    if (smem_bytes > 48 * 1024) {
        cudaError_t err = cudaFuncSetAttribute(
            sw_band_sub_kernel<WP, SCRATCH>,
            cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem_bytes);
        if (err != cudaSuccess) return (int)err;
    }
    const int blocks = (P.B + SUB_THREADS - 1) / SUB_THREADS;
    sw_band_sub_kernel<WP, SCRATCH><<<blocks, SUB_THREADS,
                                      (size_t)smem_bytes, stream>>>(P);
    return (int)cudaGetLastError();
}

// Plain C entry point (loaded with ctypes).  WP offsets per chunk (a
// multiple of 8 up to SUB_REG_MAX), S chunks (S > 1: WP = SUB_REG_MAX and
// `scratch` holds 3 * WP * S int32 per thread of the grid,
// ceil(B / 128) * 128 threads).  Launches on `stream` and returns
// cudaGetLastError() of the launch (-1 for a WP that was not compiled).
extern "C" int sw_band_sub_launch(
    const int8_t* q, const int8_t* s, const int32_t* d_rows,
    const int8_t* subst8, int B, int N, int D, int C, int gap_first,
    int gap_extend, int WP, int S, int32_t* scratch, long long smem_bytes,
    int32_t* out, void* stream)
{
    if (B <= 0) return 0;
    SubProblem P{q, s, d_rows, subst8, B, N, D, C, gap_first, gap_extend,
                 S, scratch, out};
    cudaStream_t st = (cudaStream_t)stream;
    if (S > 1) {
        if (WP != SUB_REG_MAX) return -1;
        return launch<SUB_REG_MAX, true>(P, smem_bytes, st);
    }
    switch (WP) {
    case 8: return launch<8, false>(P, smem_bytes, st);
    case 16: return launch<16, false>(P, smem_bytes, st);
    case 24: return launch<24, false>(P, smem_bytes, st);
    case 32: return launch<32, false>(P, smem_bytes, st);
    case 40: return launch<40, false>(P, smem_bytes, st);
    case 48: return launch<48, false>(P, smem_bytes, st);
    case 56: return launch<56, false>(P, smem_bytes, st);
    case 64: return launch<64, false>(P, smem_bytes, st);
    default: return -1;
    }
}
