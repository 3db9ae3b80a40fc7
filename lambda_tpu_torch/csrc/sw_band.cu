// K1: banded affine-gap Smith-Waterman score pass for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel lambda_tpu/ops/sw_band.py:
// _make_band_kernel_lane (launched by _score_band_lane), together with
// its feeders _band_image_lane and _lane_wmin: the TPU kernel needs a
// sheared int8 substitution image because it cannot gather cheaply; this
// kernel reads the query/window ranks directly and looks the scores up in
// a substitution matrix held in shared memory.
//
// What it computes: for every alignment b, the best local score over the
// cells (i, j) whose diagonal offset d = j - i lies in [0, d_rows[b]]
// (i: query position, j: window position).  Query positions outside
// [0, N) and PAD ranks score PAD (-128) against everything.  Rows with
// d_rows[b] < 0 are batch padding and score 0.  Off-band cells are dead
// (H = 0, E = -inf, F sources -inf), so pure gap corridors cannot cross
// the band.  d_rows must be <= D.  With x_drop > 0, the TPU kernel's
// X-drop (sw_band.py:663-681): after every nc window columns a row whose
// max(H, E, 0) over the band has fallen more than x_drop below its best
// (best > 0) is dead, and its later columns contribute nothing.
//
// Design (csrc/band_warp.cuh): a group of G lanes of one warp per
// alignment, each lane a run of R band offsets in registers; E/H and the
// query rank move between runs by shuffles, F enters each run through a
// max-plus scan over the group, the add-max steps are DPX instructions,
// and there is no block barrier in the sweep.  The wrapper
// (ops/sw_band.py:warp_config) spreads a band over 16 or 32 lanes for
// small launches and packs 32 / G alignments per warp for large ones, by
// a rule measured on the card.  X-drop: a dead alignment's best is frozen
// at once, and its warp stops sweeping when all of its alignments are
// dead (at G = 32, the alignment's own exit).
//
// Bound: int32 operations, per needed cell of the function 11 (5 adds, 6
// maxes) or 7 with DPX (csrc/int_rate.cu), whichever the card runs
// faster, against inputs of two int8 rows per alignment read once.  The
// design keeps the band in registers up to D = 1023 and spreads its cells
// over lanes, so even a launch of a few hundred rows reaches every SM;
// what remains at such launches is one warp's chain of dependent
// instructions per column.

#include "band_warp.cuh"

template <int R, bool MULTI>
__global__ void __launch_bounds__(BW_THREADS)
sw_band_score_kernel(BandProblem P)
{
    extern __shared__ int4 smem[];
    bw_load_matrix(P, smem);
    const int G = MULTI ? 32 : P.G;
    const int gid = threadIdx.x / G, gl = threadIdx.x & (G - 1);
    const int b = blockIdx.x * (BW_THREADS / G) + gid;
    // rows past B and padding rows sweep along, converged with the warp
    const bool active = b < P.B && P.d_rows[b] >= 0;
    if (!__any_sync(0xffffffffu, active)) {
        if (gl == 0 && b < P.B) P.out[b] = 0;
        return;
    }
    BwEnd end{0, 0, 0, 0};
    const int best = bw_sweep<R, false, MULTI>(P, active ? b : 0, active,
                                               gid, gl, end);
    if (gl == 0 && b < P.B) P.out[b] = active ? best : 0;
}

template <int R, bool MULTI>
static int launch(const BandProblem& P, long long smem_bytes,
                  cudaStream_t stream)
{
    if (smem_bytes > 48 * 1024) {
        cudaError_t err = cudaFuncSetAttribute(
            sw_band_score_kernel<R, MULTI>,
            cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem_bytes);
        if (err != cudaSuccess) return (int)err;
    }
    const int per_block = BW_THREADS / (MULTI ? 32 : P.G);
    const int blocks = (P.B + per_block - 1) / per_block;
    sw_band_score_kernel<R, MULTI><<<blocks, BW_THREADS, (size_t)smem_bytes,
                                     stream>>>(P);
    return (int)cudaGetLastError();
}

// Plain C entry point (loaded with ctypes).  G lanes per alignment, R
// offsets per lane (one of ops/sw_band.py:R_SCORE), S segments (S > 1:
// G = R = 32 and `scratch` holds 3 * S * 1024 int32 per row).  Launches
// on `stream` and returns cudaGetLastError() of the launch (-1 for an R
// that was not compiled).
extern "C" int sw_band_score_launch(
    const int8_t* q, const int8_t* s, const int32_t* d_rows,
    const int8_t* subst8, int B, int N, int D, int C, int gap_first,
    int gap_extend, int G, int R, int S, int x_drop, int nc,
    int32_t* scratch, long long smem_bytes, int32_t* out, void* stream)
{
    if (B <= 0) return 0;
    BandProblem P{q, s, d_rows, subst8, B, N, D, C, gap_first, gap_extend,
                  G, S, x_drop, nc, scratch, out, nullptr, nullptr, nullptr,
                  nullptr};
    cudaStream_t st = (cudaStream_t)stream;
    if (S > 1) return launch<32, true>(P, smem_bytes, st);
    switch (R) {
    case 1: return launch<1, false>(P, smem_bytes, st);
    case 2: return launch<2, false>(P, smem_bytes, st);
    case 3: return launch<3, false>(P, smem_bytes, st);
    case 4: return launch<4, false>(P, smem_bytes, st);
    case 5: return launch<5, false>(P, smem_bytes, st);
    case 6: return launch<6, false>(P, smem_bytes, st);
    case 8: return launch<8, false>(P, smem_bytes, st);
    case 10: return launch<10, false>(P, smem_bytes, st);
    case 12: return launch<12, false>(P, smem_bytes, st);
    case 16: return launch<16, false>(P, smem_bytes, st);
    case 20: return launch<20, false>(P, smem_bytes, st);
    case 24: return launch<24, false>(P, smem_bytes, st);
    case 32: return launch<32, false>(P, smem_bytes, st);
    default: return -1;
    }
}
