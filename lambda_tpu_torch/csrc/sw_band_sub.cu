// K3: banded affine-gap Smith-Waterman score pass with the band spread over
// the threads, for Hopper (sm_90a).  Chosen by LAMBDA_SWB_LAYOUT=sublane.
//
// Replaces the Pallas TPU kernel lambda_tpu/ops/sw_band.py:
// _make_band_kernel (launched by _score_band_padded), together with its
// feeder _band_image_sub.  That kernel is K1's twin with the band offset on
// the TPU's sublane (parallel) axis; this is the card's form of the same
// idea, not a copy of K1 (csrc/sw_band.cu).
//
// What it computes: exactly K1's function without X-drop -- for every
// alignment b the best local score over the cells whose band offset
// w = i - j + D lies in [D - d_rows[b], D]; off-band cells are dead
// (H = 0, E = -inf, F sources -inf); rows with d_rows[b] < 0 score 0.
//
// Layout: a team of T threads (a power of two, at most 256) per
// alignment; thread tt holds the run of R = ceil((D + 1) / T) consecutive
// offsets w = tt * R + r, so D has no upper limit.  Teams of narrow bands
// share a block (256 / T alignments per block).  The H and E columns live
// in dynamic shared memory as [r][tt] (a warp touches consecutive words),
// or in a global scratch buffer when they do not fit.  Per window column:
//   1. each thread reads H, E at the first offset of the next run (the
//      w + 1 source of its last offset), then the block synchronises;
//   2. each thread sweeps its run: E and H pull from w + 1, the diagonal
//      predecessor sits at the same w, Htmp = max(diag, E, 0) is stored,
//      and c, the F value its run hands on, is accumulated;
//   3. F entering each run is a max-plus scan of c over the team
//      (team_scan.cuh: warp shuffles, then shared memory);
//   4. each thread sweeps its run again with that F: H = max(Htmp, F).
//
// Bound: integer operations, like K1 (about 14 int32 adds and maxes per
// cell here, against int8 ranks read once).  What the design does about
// it: the band's cells of one column run in parallel over T threads, so a
// launch of a few hundred alignments fills the card's SMs where K1 runs
// one sequential thread per alignment; the price is three block barriers
// per column and the scan's log2(T) shuffle steps.

#include <cuda_runtime.h>
#include <stdint.h>

#include "team_scan.cuh"

__global__ void sw_band_sub_kernel(
    const int8_t* __restrict__ q, const int8_t* __restrict__ s,
    const int32_t* __restrict__ d_rows, const int8_t* __restrict__ subst8,
    int B, int N, int D, int C, int gap_first, int gap_extend, int T, int R,
    int32_t* __restrict__ scratch, int32_t* __restrict__ out)
{
    extern __shared__ int32_t smem[];
    int32_t* sub = smem;                              // C * C
    int32_t* ys = sub + C * C;                        // blockDim.x
    int32_t* warp_tot = ys + blockDim.x;              // blockDim.x / 32 + 1
    int32_t* state = warp_tot + (blockDim.x >> 5) + 1;
    for (int i = threadIdx.x; i < C * C; i += blockDim.x) sub[i] = subst8[i];

    const int tt = threadIdx.x & (T - 1);
    const int a = threadIdx.x / T;
    const int b = blockIdx.x * (blockDim.x / T) + a;
    const int Wp = T * R;
    int32_t* H = scratch != nullptr ? scratch + (size_t)b * 2 * Wp
                                    : state + (size_t)a * 2 * Wp;
    int32_t* E = H + Wp;
    const int d = b < B ? d_rows[b] : -1;
    const bool live = d >= 0;
    const int wmin = !live ? D + 1 : (d > D ? 0 : D - d);
    for (int r = 0; r < R; ++r) {
        H[r * T + tt] = 0;
        E[r * T + tt] = NEG32;
    }
    __syncthreads();

    const int8_t* qrow = q + (size_t)(live ? b : 0) * N;
    const int8_t* srow = s + (size_t)(live ? b : 0) * N;
    const int pad = C - 1;
    const int gf = gap_first, ge = gap_extend;
    const int w0 = tt * R;
    int best = 0;
    for (int j = 0; j < N; ++j) {
        // 1. the w + 1 source of this run's last offset
        int up_h = 0, up_e = NEG32;
        if (tt + 1 < T) {
            up_h = H[tt + 1];
            up_e = E[tt + 1];
        }
        __syncthreads();
        // 2. E, Htmp and the run's F hand-on
        const int32_t* scol = sub + (live ? (int)srow[j] : pad);
        int h_diag = H[tt];
        int c = NEG32;
        for (int r = 0; r < R; ++r) {
            const int w = w0 + r;
            int h_up = up_h, e_up = up_e;
            if (r + 1 < R) {
                h_up = H[(r + 1) * T + tt];
                e_up = E[(r + 1) * T + tt];
            }
            int e = NEG32, htmp = 0, fsrc = NEG32;
            if (w >= wmin && w <= D) {
                e = max(e_up + ge, h_up + gf);
                const int i = j + w - D;
                const int qr = (i >= 0 && i < N) ? (int)qrow[i] : pad;
                htmp = max(max(h_diag + scol[qr * C], e), 0);
                fsrc = htmp;
            }
            E[r * T + tt] = e;
            H[r * T + tt] = htmp;
            c = max(c + ge, fsrc + gf);
            h_diag = h_up;
        }
        // 3. F entering the run
        int f = team_scan_exclusive(c, R * ge, T, tt, ys, warp_tot);
        // 4. H = max(Htmp, F)
        for (int r = 0; r < R; ++r) {
            const int w = w0 + r;
            const int htmp = H[r * T + tt];
            int fsrc = NEG32;
            if (w >= wmin && w <= D) {
                const int h = max(htmp, f);
                H[r * T + tt] = h;
                best = max(best, h);
                fsrc = htmp;
            }
            f = max(f + ge, fsrc + gf);
        }
        __syncthreads();
    }
    ys[threadIdx.x] = best;
    __syncthreads();
    if (tt == 0 && b < B) {
        int m = 0;
        for (int k = 0; k < T; ++k) m = max(m, ys[a * T + k]);
        out[b] = m;
    }
}

// Plain C entry point (loaded with ctypes).  A block of `threads` threads
// holds threads / T alignments; `scratch` (or nullptr) holds 2 * T * R
// int32 per alignment of every block.  Launches on `stream` and returns
// cudaGetLastError() of the launch.
extern "C" int sw_band_sub_launch(
    const int8_t* q, const int8_t* s, const int32_t* d_rows,
    const int8_t* subst8, int B, int N, int D, int C, int gap_first,
    int gap_extend, int T, int R, int threads, int32_t* scratch,
    long long smem_bytes, int32_t* out, void* stream)
{
    if (B <= 0) return 0;
    if (smem_bytes > 48 * 1024) {
        cudaError_t err = cudaFuncSetAttribute(
            sw_band_sub_kernel,
            cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem_bytes);
        if (err != cudaSuccess) return (int)err;
    }
    const int per_block = threads / T;
    const int blocks = (B + per_block - 1) / per_block;
    sw_band_sub_kernel<<<blocks, threads, (size_t)smem_bytes,
                         (cudaStream_t)stream>>>(
        q, s, d_rows, subst8, B, N, D, C, gap_first, gap_extend, T, R,
        scratch, out);
    return (int)cudaGetLastError();
}
