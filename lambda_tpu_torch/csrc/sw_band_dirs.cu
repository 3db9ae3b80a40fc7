// K2: banded affine-gap Smith-Waterman with direction codes for Hopper
// (sm_90a), the device half of pass 2 (the traceback of the pass-1
// survivors).
//
// Replaces the Pallas TPU kernel lambda_tpu/ops/sw_band.py:
// _make_band_dirs_kernel (launched by _dirs_band_lane), together with its
// feeders _band_image_lane and _lane_wmin.  As in K1 (csrc/sw_band.cu) the
// kernel builds no substitution image: it reads the query/window ranks and
// looks the scores up in a shared-memory matrix.
//
// What it computes: K1's banded DP without X-drop (band offsets
// w = i - j + D, in-band offsets w in [D - d_row, D], off-band cells dead,
// rows with d_row < 0 are batch padding), plus, per cell, the uint8 code
// of the sw_xla encoding that the host walk (ops/sw_band.traceback_banded)
// reads:
//   bits 0-1  H source when H > 0: 1 diagonal, 2 E, 3 F (priority in that
//             order), 0 when H == 0;
//   bit 2 (4) E extends: E[w+1] + ge >= H[w+1] + gf of the previous column
//             (never at w = D, whose up values are E = -inf, H = 0);
//   bit 3 (8) F extends: F[w-1] + ge >= H[w-1] + gf with the final H of the
//             offset below (never at the lowest in-band offset).
// Off-band cells and the padding below the band get code 0.  Per row it
// also returns the best score and the end cell (j, w) the walk starts
// from: maximum H, then smallest i+j, then smallest i -- the JAX rule of
// traceback_banded, which a running key 2j + w per lane, ties to the later
// column, and a reduction over the group under the same order reproduce.
//
// Design: K1's warp sweep (csrc/band_warp.cuh), G lanes per alignment,
// R offsets per lane in registers, DPX add-max steps, no block barrier.
// Each lane derives its R codes in the sweep's second pass; the F-extend
// bit of a run's first offset reads F and final H of the offset below
// through __shfl_up_sync.  dirs has the layout (B, N, Wp), Wp = G*R*S,
// offset w of column j at dirs[b][j][w + Wp - 1 - D], so a group writes
// each column as one contiguous run of Wp bytes and each lane its R codes
// packed into 32-bit words (R a multiple of 4; 16- and 8-byte stores where
// R allows, 2- and 1-byte stores for R = 2, 1).  The wrapper hands on the
// view of the band's D + 1 offsets, the plain version's (B, N, D+1).
//
// Bound: integer operations at most shapes, bytes at some.  Each needed
// cell costs K1's cell (7 instructions with DPX, csrc/int_rate.cu) and
// about 11 int32 operations more for the code and the end-cell key, which
// have no DPX form; the codes are written once, B * N * (D+1) bytes, and
// at 3.35 TB/s a byte costs as much as 5 operations at the int32 rate, so
// the store stream sets the bound where the band's cells outnumber the
// needed ones about fourfold (wide bands over short queries); packing
// each lane's codes into whole words keeps that stream coalesced.

#include "band_warp.cuh"

template <int R, bool MULTI>
__global__ void __launch_bounds__(BW_THREADS)
sw_band_dirs_kernel(BandProblem P)
{
    extern __shared__ int4 smem[];
    bw_load_matrix(P, smem);
    const int G = MULTI ? 32 : P.G;
    const int gid = threadIdx.x / G, gl = threadIdx.x & (G - 1);
    const int b = blockIdx.x * (BW_THREADS / G) + gid;
    // rows past B and padding rows sweep along, converged with the warp
    const bool active = b < P.B && P.d_rows[b] >= 0;
    if (b < P.B && !active) {                  // batch padding: all zero
        const size_t words = (size_t)P.N * G * R * P.S / 4;
        uint32_t* drow = (uint32_t*)(P.dirs + (size_t)b * P.N * G * R * P.S);
        for (size_t k = gl; k < words; k += G) drow[k] = 0;
    }
    BwEnd end{0, 0x7fffffff, -1, -1};
    if (__any_sync(0xffffffffu, active))
        bw_sweep<R, true, MULTI>(P, active ? b : 0, active, gid, gl, end);
    if (gl == 0 && b < P.B) {
        P.best[b] = active ? end.best : 0;
        P.end_j[b] = active ? end.j : -1;
        P.end_w[b] = active ? end.w : -1;
    }
}


template <int R, bool MULTI>
static int launch(const BandProblem& P, long long smem_bytes,
                  cudaStream_t stream)
{
    if (smem_bytes > 48 * 1024) {
        cudaError_t err = cudaFuncSetAttribute(
            sw_band_dirs_kernel<R, MULTI>,
            cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem_bytes);
        if (err != cudaSuccess) return (int)err;
    }
    const int per_block = BW_THREADS / (MULTI ? 32 : P.G);
    const int blocks = (P.B + per_block - 1) / per_block;
    sw_band_dirs_kernel<R, MULTI><<<blocks, BW_THREADS, (size_t)smem_bytes,
                                    stream>>>(P);
    return (int)cudaGetLastError();
}

// Plain C entry point (loaded with ctypes).  G, R (one of
// ops/sw_band.py:R_DIRS) and S as for K1; dirs is (B, N, G*R*S).
// Launches on `stream` and returns cudaGetLastError() of the launch (-1
// for an R that was not compiled).
extern "C" int sw_band_dirs_launch(
    const int8_t* q, const int8_t* s, const int32_t* d_rows,
    const int8_t* subst8, int B, int N, int D, int C, int gap_first,
    int gap_extend, int G, int R, int S, int32_t* scratch,
    long long smem_bytes, uint8_t* dirs, int32_t* best, int32_t* end_j,
    int32_t* end_w, void* stream)
{
    if (B <= 0) return 0;
    BandProblem P{q, s, d_rows, subst8, B, N, D, C, gap_first, gap_extend,
                  G, S, 0, 0, scratch, nullptr, dirs, best, end_j, end_w};
    cudaStream_t st = (cudaStream_t)stream;
    if (S > 1) return launch<32, true>(P, smem_bytes, st);
    switch (R) {
    case 1: return launch<1, false>(P, smem_bytes, st);
    case 2: return launch<2, false>(P, smem_bytes, st);
    case 4: return launch<4, false>(P, smem_bytes, st);
    case 8: return launch<8, false>(P, smem_bytes, st);
    case 12: return launch<12, false>(P, smem_bytes, st);
    case 16: return launch<16, false>(P, smem_bytes, st);
    case 20: return launch<20, false>(P, smem_bytes, st);
    case 24: return launch<24, false>(P, smem_bytes, st);
    case 32: return launch<32, false>(P, smem_bytes, st);
    default: return -1;
    }
}
