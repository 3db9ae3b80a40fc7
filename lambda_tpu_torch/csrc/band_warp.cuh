// The band sweep of K1 (csrc/sw_band.cu) and K2 (csrc/sw_band_dirs.cu):
// banded affine-gap Smith-Waterman as a warp-resident sweep for Hopper
// (sm_90a), with the DPX instructions for the max-plus steps.
//
// It replaces the column body of the Pallas TPU kernels
// lambda_tpu/ops/sw_band.py:_make_band_kernel_lane (K1) and
// _make_band_dirs_kernel (K2), which hold one band per vector register
// with the band offset on the lane axis and compute F as a lane-roll
// doubling scan.  On the card a band lives in one warp instead.
//
// Cells: band offset w = i - j + D (i query position, j window column),
// the in-band offsets of a row w in [wmin, D], wmin = D - d_row; off-band
// cells are dead (H = 0, E = -inf, F sources -inf), so pure gap corridors
// cannot cross the band.  Per cell
//   E = max(E[w+1] + ge, H[w+1] + gf)      (previous column; w = D: -inf, 0)
//   T = max(H[w] + sub(q[i], s[j]), E, 0)  (H[w]: previous column, diagonal)
//   F = max(F[w-1] + ge, T[w-1] + gf)      (this column, running upward)
//   H = max(T, F).
// H is exact for every cell; negative E and F values are sentinels that
// may differ from other sweeps (the plain version's, the TPU kernel's)
// and never reach a positive H, since H is floored at 0.
//
// Layout.  A group of G lanes of one warp (G = 4, 8, 16 or 32) sweeps one
// alignment; lane gl holds the run of R consecutive offsets
// w = D + 1 - G*R + gl*R + r, r < R, so offset D is the last offset of the
// top lane and the G*R - (D+1) padding offsets sit below the band (they
// are never in band).  H, E and the query rank of each offset live in
// registers (R is a template parameter, so the arrays stay in registers);
// a band wider than 32 x 32 offsets runs as S segments of 1024 offsets
// (G = R = 32), each segment's state reloaded from and stored to a
// per-alignment global scratch, segments swept upward.  32 / G
// alignments share a warp, 128 / G a block.  The sweep uses no block
// barrier: a warp's groups run converged, their shuffles take the full
// warp mask with the group as the shuffle width, so each compiles to one
// SHFL (a mask that differed per group made the compiler wrap every
// shuffle in a convergence loop, 2-3x the column's latency).
//
// Per window column:
//   1. Every BW_CHUNK columns the group stages the next BW_CHUNK bytes of
//      its query and window rows into shared memory with aligned 16-byte
//      loads; s[j] and q[j] are then one broadcast read each.
//   2. E and H pull from w + 1 inside the run and, for the run's top
//      offset, from the lane above through __shfl_down_sync.  The query
//      rank moves the same way: cell (j, w) reads the rank of
//      (j - 1, w + 1), so only offset D reads a new rank, q[j].
//   3. The scores come from the substitution matrix held transposed in
//      shared memory: the lanes of a column read one row of it, s[j]'s.
//   4. F inside a run is a running value; the F entering each run is an
//      exclusive max-plus scan over the G lanes (log2 G shuffle steps,
//      step R * ge), plus the carry from the segments below.
//   5. DPX: __viaddmax_s32 for E, F and the scan (max(a + b, c) in one
//      instruction), __viaddmax_s32_relu for T (max(H + sub, E, 0)),
//      __vimax3_s32 for X-drop's max(cur, H, E).
//
// Bound: int32 operations.  The function needs 11 per cell (5 adds,
// 6 maxes), or 7 instructions with DPX (csrc/int_rate.cu, which measures
// their rate); the inputs are two int8 rows per alignment, read once.
// The warp design spreads a band's cells over lanes, so a launch of a few
// hundred alignments reaches every SM, keeps the state out of memory up
// to D = 1023, and DPX folds each add-max pair into one instruction.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#ifndef NEG32
#define NEG32 (-(1 << 27))
#endif

#define BW_THREADS 128                 // threads per block
#define BW_CHUNK 256                   // window columns per staging refill
#define BW_STAGE (BW_CHUNK + 16)       // staging bytes per row and stream
#define BW_SEG 1024                    // offsets per segment (32 x 32)

struct BandProblem {
    const int8_t* q;          // (B, N) query ranks, PAD beyond the query
    const int8_t* s;          // (B, N) virtual windows
    const int32_t* d_rows;    // (B,) band per row, -1: padding row
    const int8_t* subst8;     // (C, C), PAD row/column last
    int B, N, D, C, gf, ge;
    int G, S;                 // lanes per alignment, segments
    int x_drop, nc;           // K1: X-drop, checkpoint every nc columns
    int32_t* scratch;         // S > 1: 3 * S * BW_SEG int32 per row
    int32_t* out;             // K1: (B,) best
    uint8_t* dirs;            // K2: (B, N, G*R*S) codes
    int32_t* best;            // K2: (B,) best, end cell
    int32_t* end_j;
    int32_t* end_w;
};

// Bytes of the block's shared memory before the staging buffers: the
// transposed int32 matrix, rounded up to 16.
__device__ __forceinline__ int bw_matrix_bytes(int C)
{
    return (4 * C * C + 15) & ~15;
}

// The block's prologue (the only block barrier): the matrix transposed,
// subT[s * C + q] = subst8[q * C + s].
__device__ __forceinline__ int32_t* bw_load_matrix(const BandProblem& P,
                                                   int4* smem)
{
    int32_t* subT = (int32_t*)smem;
    const int C = P.C;
    for (int i = threadIdx.x; i < C * C; i += blockDim.x)
        subT[(i % C) * C + i / C] = P.subst8[i];
    __syncthreads();
    return subT;
}

// Copy the 16-byte-aligned blocks that cover bytes [start, start +
// BW_CHUNK) of `base` into `buf` (16-byte aligned, BW_STAGE bytes), lane
// gl of G taking every G-th block.  Blocks wholly inside the tensor's
// [0, total) bytes are one 16-byte load; the few at its ends are read
// byte by byte.  Returns the position of base[start] in buf.
__device__ __forceinline__ int bw_stage(const int8_t* __restrict__ base,
                                        size_t total, size_t start,
                                        int8_t* buf, int gl, int G)
{
    const uintptr_t a = (uintptr_t)(base + start);
    const uintptr_t a0 = a & ~(uintptr_t)15;
    const uintptr_t lo = (uintptr_t)base, hi = (uintptr_t)(base + total);
    const int nblk = (int)((a - a0 + BW_CHUNK + 15) >> 4);
    for (int k = gl; k < nblk; k += G) {
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

// Group reductions over each G-lane group of the warp (`mask`: the warp).
__device__ __forceinline__ int bw_group_max(int v, unsigned mask, int G)
{
    for (int o = G >> 1; o > 0; o >>= 1)
        v = max(v, __shfl_xor_sync(mask, v, o, G));
    return v;
}

// The end cell of K2 over the group: maximum H, then the smallest key
// 2j + w (smallest i + j), then the later column (smallest i).
__device__ __forceinline__ void bw_group_end(int& best, int& key, int& j,
                                             int& w, unsigned mask, int G)
{
    for (int o = G >> 1; o > 0; o >>= 1) {
        const int ob = __shfl_xor_sync(mask, best, o, G);
        const int ok = __shfl_xor_sync(mask, key, o, G);
        const int oj = __shfl_xor_sync(mask, j, o, G);
        const int ow = __shfl_xor_sync(mask, w, o, G);
        if (ob > best || (ob == best && (ok < key || (ok == key && oj > j)))) {
            best = ob;
            key = ok;
            j = oj;
            w = ow;
        }
    }
}

// K2's codes of one run, cw[k] holding r = 4k..4k+3 in its bytes, stored
// at p (aligned to the run's size): one 16-, 8- or 4-byte store per 16,
// 8 or 4 codes, a 2- or 1-byte store for R = 2 or 1.
template <int R>
__device__ __forceinline__ void bw_store_codes(
    uint8_t* p, const uint32_t (&cw)[(R + 3) / 4])
{
    if constexpr (R % 16 == 0) {
#pragma unroll
        for (int k = 0; k < R / 4; k += 4)
            ((uint4*)p)[k / 4] = make_uint4(cw[k], cw[k + 1], cw[k + 2],
                                            cw[k + 3]);
    } else if constexpr (R % 8 == 0) {
#pragma unroll
        for (int k = 0; k < R / 4; k += 2)
            ((uint2*)p)[k / 2] = make_uint2(cw[k], cw[k + 1]);
    } else if constexpr (R % 4 == 0) {
#pragma unroll
        for (int k = 0; k < R / 4; ++k) ((uint32_t*)p)[k] = cw[k];
    } else if constexpr (R == 2) {
        *(uint16_t*)p = (uint16_t)cw[0];
    } else {
        static_assert(R == 1, "K2 runs are 1, 2 or a multiple of 4 codes");
        *p = (uint8_t)cw[0];
    }
}

// Running end-cell state of one lane (K2).
struct BwEnd {
    int best, key, j, w;
};

// One window column of one run (one lane's R offsets, first offset w0).
// H, E and qr hold the previous column on entry and this column on exit.
// hu, eu, qu: H, E and query rank of the offset above the run (previous
// column).  carry: in, the F entering the group's lowest offset from
// below; out, the F entering the offset above the group's top.  fb, hb
// (K2): in, F and final H of the offset below the group's lowest; out,
// those of the group's top offset.  Returns the lane's largest H.
template <int R, bool DIRS>
__device__ __forceinline__ int bw_column(
    int (&H)[R], int (&E)[R], int (&qr)[R], uint32_t (&cw)[(R + 3) / 4],
    int hu, int eu, int qu, const int32_t* __restrict__ subrow, int w0,
    int wmin, int gf, int ge, int G, int gl, unsigned mask, int& carry,
    int& fb, int& hb, int j, BwEnd& end)
{
    const int rlo = wmin - w0;            // r >= rlo: in band
    int part[DIRS ? R : 1];
    // pass 1: E, T = max(H + sub, E, 0), and c, the F this run hands to
    // the offset above it
    int c = NEG32;
#pragma unroll
    for (int r = 0; r < R; ++r) {
        const int hup = r + 1 < R ? H[r + 1] : hu;
        const int eup = r + 1 < R ? E[r + 1] : eu;
        qr[r] = r + 1 < R ? qr[r + 1] : qu;
        const int sub = subrow[qr[r]];
        const bool v = r >= rlo;
        const int eb = hup + gf;
        const int e = __viaddmax_s32(eup, ge, eb);
        const int t = __viaddmax_s32_relu(H[r], sub, e);
        if constexpr (DIRS)
            part[r] = (eup + ge >= eb ? 4 : 0)
                      | (t > 0 ? (t == H[r] + sub ? 1 : 2) : 0);
        const int fs = v ? t : NEG32;
        c = __viaddmax_s32(c, ge, fs + gf);
        H[r] = fs;
        E[r] = v ? e : NEG32;
    }
    // F entering the run: exclusive max-plus scan of c over the group
    const int step = R * ge;
    int y = c;
    for (int sh = 1; sh < G; sh <<= 1) {
        const int o = __shfl_up_sync(mask, y, sh, G);
        if (gl >= sh) y = __viaddmax_s32(o, sh * step, y);
    }
    int f = __shfl_up_sync(mask, y, 1, G);
    f = gl == 0 ? carry : __viaddmax_s32(carry, gl * step, f);
    const int top = __shfl_sync(mask, y, G - 1, G);
    carry = max(__viaddmax_s32(carry, G * step, top), NEG32);
    // pass 2: H = max(T, F); K2's codes and end cell
    int hmax = 0;
    int fprev = 0, hprev = 0, fsp = 0;
#pragma unroll
    for (int r = 0; r < R; ++r) {
        if (r > 0) f = __viaddmax_s32(f, ge, fsp + gf);
        const int fs = H[r];
        const bool v = r >= rlo;
        const int h = v ? max(fs, f) : 0;
        if constexpr (DIRS) {
            int code = 0;
            if (v) {
                code = f > fs ? (part[r] & 4) | 3 : part[r];
                if (r > 0 && r > rlo && fprev + ge >= hprev + gf) code |= 8;
            }
            if ((r & 3) == 0) cw[r >> 2] = 0;
            cw[r >> 2] |= (uint32_t)code << (8 * (r & 3));
            fprev = f;
            hprev = h;
            const int key = 2 * j + w0 + r;
            if (h > 0 && (h > end.best || (h == end.best && key <= end.key))) {
                end.best = h;
                end.key = key;
                end.j = j;
                end.w = w0 + r;
            }
        }
        hmax = max(hmax, h);
        H[r] = h;
        fsp = fs;
    }
    if constexpr (DIRS) {
        // bit 3 of the run's first offset: F and final H of the offset
        // below, from the lane below (or the carry for the group's first)
        int fl = __shfl_up_sync(mask, fprev, 1, G);
        int hl = __shfl_up_sync(mask, hprev, 1, G);
        if (gl == 0) {
            fl = fb;
            hl = hb;
        }
        if (0 > rlo && fl + ge >= hl + gf) cw[0] |= 8u;
        fb = __shfl_sync(mask, fprev, G - 1, G);
        hb = __shfl_sync(mask, hprev, G - 1, G);
    }
    return hmax;
}

// The whole sweep of alignment b by its group (lane gl of G = P.G, or of
// 32 when MULTI).  Every warp runs it converged, all 32 lanes, so each
// shuffle takes the full mask and the group width (a mask that differed
// per group would make the compiler wrap every shuffle in a convergence
// loop).  A group that is not `active` (a row past B or a padding row)
// sweeps along with nothing in band and writes nothing.  K1 (DIRS
// false): returns the group's best, with X-drop: a group whose row is
// dead freezes its best at once, and the warp stops sweeping when all
// its groups are dead (per alignment when G = 32).  K2: writes the codes
// of row b and returns the end cell in `end` (reduced over the group).
template <int R, bool DIRS, bool MULTI>
__device__ __forceinline__ int bw_sweep(const BandProblem& P, int b,
                                        bool active, int gid, int gl,
                                        BwEnd& end)
{
    extern __shared__ int4 bw_smem[];
    const unsigned mask = 0xffffffffu;
    const int G = MULTI ? 32 : P.G;
    const int S = MULTI ? P.S : 1;
    const int N = P.N, D = P.D, C = P.C, gf = P.gf, ge = P.ge;
    const int Wp = G * R * S;
    const int d = active ? P.d_rows[b] : -1;
    const int wmin = d < 0 ? D + 1 : (d > D ? 0 : D - d);
    const int pad = C - 1;
    const int32_t* subT = (const int32_t*)bw_smem;
    int8_t* qbuf = (int8_t*)bw_smem + bw_matrix_bytes(C)
                   + gid * 2 * BW_STAGE;
    int8_t* sbuf = qbuf + BW_STAGE;
    int H[R], E[R], qr[R];
    uint32_t cw[(R + 3) / 4];
#pragma unroll
    for (int r = 0; r < R; ++r) {
        H[r] = 0;
        E[r] = NEG32;
        qr[r] = pad;
    }
    int32_t* Hs = nullptr;
    int32_t* Es = nullptr;
    int32_t* Qs = nullptr;
    if constexpr (MULTI) {
        Hs = P.scratch + (size_t)b * 3 * S * BW_SEG;
        Es = Hs + (size_t)S * BW_SEG;
        Qs = Es + (size_t)S * BW_SEG;
        for (int k = 0; k < S; ++k)
#pragma unroll
            for (int r = 0; r < R; ++r) {
                const int x = (k * 32 + r) * 32 + gl;
                Hs[x] = 0;
                Es[x] = NEG32;
                Qs[x] = pad;
            }
        __syncwarp(mask);
    }
    const size_t row = (size_t)b * N, total = (size_t)P.B * N;
    uint8_t* drow = DIRS ? P.dirs + (size_t)b * N * Wp : nullptr;
    const bool top = gl == G - 1;
    bool alive = active;
    int best = 0, qo = 0, so = 0, c0 = 0;
    for (int j = 0; j < N; ++j) {
        if (j % BW_CHUNK == 0) {
            __syncwarp(mask);
            qo = bw_stage(P.q, total, row + j, qbuf, gl, G);
            so = bw_stage(P.s, total, row + j, sbuf, gl, G);
            c0 = j;
            __syncwarp(mask);
        }
        const int32_t* subrow = subT + (int)sbuf[so + j - c0] * C;
        const int qj = qbuf[qo + j - c0];
        const bool check = !DIRS && P.x_drop > 0 && (j + 1) % P.nc == 0;
        int carry = NEG32, fb = NEG32, hb = 0, cur = 0;
        for (int k = 0; k < S; ++k) {
            if constexpr (MULTI) {
#pragma unroll
                for (int r = 0; r < R; ++r) {
                    const int x = (k * 32 + r) * 32 + gl;
                    H[r] = Hs[x];
                    E[r] = Es[x];
                    qr[r] = Qs[x];
                }
            }
            int hu = __shfl_down_sync(mask, H[0], 1, G);
            int eu = __shfl_down_sync(mask, E[0], 1, G);
            int qu = __shfl_down_sync(mask, qr[0], 1, G);
            if (MULTI && top && k + 1 < S) {       // old values, above
                const int x = (k + 1) * 32 * 32;
                hu = Hs[x];
                eu = Es[x];
                qu = Qs[x];
            } else {                                // offset D: off band
                hu = top ? 0 : hu;
                eu = top ? NEG32 : eu;
                qu = top ? qj : qu;
            }
            const int w0 = D + 1 - Wp + (k * G + gl) * R;
            const int hm = bw_column<R, DIRS>(H, E, qr, cw, hu, eu, qu,
                                              subrow, w0, wmin, gf, ge, G,
                                              gl, mask, carry, fb, hb, j,
                                              end);
            if (alive) best = max(best, hm);
            if constexpr (DIRS) {
                if (active)
                    bw_store_codes<R>(drow + (size_t)j * Wp
                                      + (k * G + gl) * R, cw);
            }
            if (check) {
#pragma unroll
                for (int r = 0; r < R; ++r) cur = __vimax3_s32(cur, H[r], E[r]);
            }
            if constexpr (MULTI) {
#pragma unroll
                for (int r = 0; r < R; ++r) {
                    const int x = (k * 32 + r) * 32 + gl;
                    Hs[x] = H[r];
                    Es[x] = E[r];
                    Qs[x] = qr[r];
                }
                __syncwarp(mask);
            }
        }
        if (check) {
            // X-drop (lambda_tpu/ops/sw_band.py:663-681), per alignment:
            // a row whose max(H, E, 0) fell more than X below its best is
            // dead and its best frozen; the warp stops when all are
            const int gb = bw_group_max(best, mask, G);
            const int gc = bw_group_max(cur, mask, G);
            if (gb > 0 && gc < gb - P.x_drop) alive = false;
            if (!__any_sync(mask, alive)) break;
        }
    }
    if constexpr (DIRS) {
        bw_group_end(end.best, end.key, end.j, end.w, mask, G);
        return end.best;
    }
    return bw_group_max(best, mask, G);
}
