// K4: unbanded (rectangle) affine-gap Smith-Waterman score for Hopper
// (sm_90a).
//
// Replaces the Pallas TPU kernel lambda_tpu/ops/sw_pallas.py: _make_kernel
// (launched by _score_padded), together with its feeder _sub_image, the
// one-hot MXU contraction that materialises S(q_i, s_j) as an int8 image
// in HBM because the TPU cannot gather per cell.  On the card the gather
// is a shared-memory load, so this kernel reads the ranks directly.
//
// What it computes: for every row b the best local score over the whole
// (M x N) rectangle of q[b] (query, M positions) against s[b] (N window
// positions).  PAD ranks are trailing and score -128 against everything,
// which cannot raise the maximum, so nothing is masked.
//
// Layout: K3's design (csrc/sw_band_sub.cu) with query positions in place
// of band offsets.  A team of T threads (a power of two, at most 256) per
// row; thread tt holds the run of R = ceil(M / T) consecutive query
// positions i = tt * R + r; teams of short queries share a block.  H and E
// columns live in dynamic shared memory as [r][tt] (global scratch when
// they do not fit).  Per window column j:
//   1. each thread reads H at the last position of the run below (the
//      diagonal source of its first position), then the block syncs;
//   2. each thread sweeps its run: E = max(E + ge, H + gf) stays on its
//      own position, Htmp = max(H[i-1] + S(q_i, s_j), E, 0), and c, the F
//      value its run hands on, is accumulated;
//   3. F entering each run is a max-plus scan of c over the team
//      (team_scan.cuh);
//   4. each thread sweeps its run again: H = max(Htmp, F).
// Positions past M (the last run's tail) are dead.
//
// Bound: integer operations (about 14 int32 adds and maxes per cell
// against int8 ranks read once).  The design's answer is the same as
// K3's: a row's column is computed by T threads at once, so a few hundred
// rows fill the SMs; the price is three barriers per column.

#include <cuda_runtime.h>
#include <stdint.h>

#include "team_scan.cuh"

__global__ void sw_rect_kernel(
    const int8_t* __restrict__ q, const int8_t* __restrict__ s,
    const int8_t* __restrict__ subst8, int B, int M, int N, int C,
    int gap_first, int gap_extend, int T, int R,
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
    const int Mp = T * R;
    int32_t* H = scratch != nullptr ? scratch + (size_t)b * 2 * Mp
                                    : state + (size_t)a * 2 * Mp;
    int32_t* E = H + Mp;
    const bool live = b < B;
    for (int r = 0; r < R; ++r) {
        H[r * T + tt] = 0;
        E[r * T + tt] = NEG32;
    }
    __syncthreads();

    const int8_t* qrow = q + (size_t)(live ? b : 0) * M;
    const int8_t* srow = s + (size_t)(live ? b : 0) * N;
    const int pad = C - 1;
    const int gf = gap_first, ge = gap_extend;
    const int i0 = tt * R;
    int best = 0;
    for (int j = 0; j < N; ++j) {
        // 1. the diagonal source of this run's first position
        const int down_h = tt > 0 ? H[(R - 1) * T + tt - 1] : 0;
        __syncthreads();
        // 2. E, Htmp and the run's F hand-on
        const int32_t* scol = sub + (live ? (int)srow[j] : pad);
        int h_diag = down_h;
        int c = NEG32;
        for (int r = 0; r < R; ++r) {
            const int i = i0 + r;
            const int h_old = H[r * T + tt];
            int e = NEG32, htmp = 0, fsrc = NEG32;
            if (live && i < M) {
                e = max(E[r * T + tt] + ge, h_old + gf);
                htmp = max(max(h_diag + scol[(int)qrow[i] * C], e), 0);
                fsrc = htmp;
            }
            E[r * T + tt] = e;
            H[r * T + tt] = htmp;
            c = max(c + ge, fsrc + gf);
            h_diag = h_old;
        }
        // 3. F entering the run
        int f = team_scan_exclusive(c, R * ge, T, tt, ys, warp_tot);
        // 4. H = max(Htmp, F)
        for (int r = 0; r < R; ++r) {
            const int htmp = H[r * T + tt];
            int fsrc = NEG32;
            if (live && i0 + r < M) {
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
    if (tt == 0 && live) {
        int m = 0;
        for (int k = 0; k < T; ++k) m = max(m, ys[a * T + k]);
        out[b] = m;
    }
}

// Plain C entry point (loaded with ctypes).  A block of `threads` threads
// holds threads / T rows; `scratch` (or nullptr) holds 2 * T * R int32 per
// row of every block.  Launches on `stream` and returns cudaGetLastError()
// of the launch.
extern "C" int sw_rect_launch(
    const int8_t* q, const int8_t* s, const int8_t* subst8, int B, int M,
    int N, int C, int gap_first, int gap_extend, int T, int R, int threads,
    int32_t* scratch, long long smem_bytes, int32_t* out, void* stream)
{
    if (B <= 0) return 0;
    if (smem_bytes > 48 * 1024) {
        cudaError_t err = cudaFuncSetAttribute(
            sw_rect_kernel,
            cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem_bytes);
        if (err != cudaSuccess) return (int)err;
    }
    const int per_block = threads / T;
    const int blocks = (B + per_block - 1) / per_block;
    sw_rect_kernel<<<blocks, threads, (size_t)smem_bytes,
                     (cudaStream_t)stream>>>(
        q, s, subst8, B, M, N, C, gap_first, gap_extend, T, R, scratch, out);
    return (int)cudaGetLastError();
}
