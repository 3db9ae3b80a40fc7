// K4: unbanded (rectangle) affine-gap Smith-Waterman score for Hopper
// (sm_90a), as a skewed warp wavefront with the DPX instructions.
//
// Replaces the Pallas TPU kernel lambda_tpu/ops/sw_pallas.py: _make_kernel
// (launched by _score_padded), together with its feeder _sub_image, the
// one-hot MXU contraction that materialises S(q_i, s_j) as an int8 image
// in HBM because the TPU cannot gather per cell.  On the card the gather
// is a shared-memory load, so this kernel reads the ranks directly.
//
// What it computes: for every row b the best local score over the whole
// (M x N) rectangle of q[b] (query, M positions) against s[b] (N window
// positions), column by column along the window:
//   E = max(E + ge, H + gf)                   (same position, last column)
//   T = max(H[i-1] + S(q_i, s_j), E, 0)       (H[i-1]: last column)
//   F = max(F[i-1] + ge, T[i-1] + gf)         (this column, running up)
//   H = max(T, F),  best = max over every H.
// PAD ranks are trailing and score -128 against everything, which cannot
// raise the maximum, so nothing is masked.
//
// Layout: one warp per strip of 32 * R query positions; lane l holds the
// run i = strip0 + l * R + r, r < R, and keeps its H, E and query ranks
// in registers for the whole sweep (R is a template parameter).  H is
// kept as Hg = H + gf, so that E = max(E + ge, Hg) and the next Hg =
// max(F + gf, T + gf) are one DPX instruction each.
//
// The wavefront.  At step t lane l computes window column j = t - l for
// its whole run, so the lane below finished column j one step earlier:
//   - one __shfl_up_sync each brings the lane below's top Hg and the F it
//     hands up (max(F + ge, T + gf) of its top position) at column j, and
//     its window rank s[j];
//   - the diagonal source of the run's first position is the lane
//     below's top Hg at column j - 1: the value brought up one step
//     earlier, kept in a register;
//   - inside the run F is a running value, so no scan is needed;
//   - lane 0 takes its next rank from lanes 0-15 of a register that holds
//     the next 16 window ranks, loaded one block of 16 steps ahead.
// The steps run in blocks of RECT_CHUNK = 16, unrolled with no branch
// inside (R <= 8).  The scores are loads from the substitution matrix,
// held transposed in shared memory so that a step's R loads read the
// row of the lane's window rank.
// Fill and drain (t - l outside [0, N)) need no mask: a lane there
// sweeps a dead window column whose scores are RECT_DEAD, which leaves
// H at 0 before column 0 and cannot raise the best after column N - 1
// (every H of a dead column is below an H of an earlier column).  Query
// positions past M (the top strip's ragged end) are dead the same way.
//
// Strips.  M > 32 * R runs as W <= 16 strips, warp k of an alignment the
// strip k, all in one block.  Lane 31 of warp k writes the Hg and F it
// hands up at each column into a ring of RECT_RING slots in shared
// memory, where lane 0 of warp k + 1 reads them; the two synchronise once
// per block of steps through progress counters in shared memory
// (release / acquire at block scope, the waiting side spinning with
// __nanosleep), never through a block barrier.  Short queries (W = 1)
// share a block, one warp each.
//
// Bound: int32 operations.  The function needs 11 per cell (5 adds,
// 6 maxes), or 7 instructions with DPX; chip_smoke.py's rates phase
// measures the card's rate of that 7-instruction cell, and its k4 phase
// bounds K4 by it.  The inputs, two int8 rows per alignment, are read
// once.  Here a cell takes 4.5 DPX instructions (__viaddmax_s32 for E,
// F and Hg, __viaddmax_s32_relu for T, __vimax3_s32 folding two cells
// into the best), an add and the load of its score.
// Against the team design this replaces (PR 2's: a team of up to 256
// threads per row, H and E in shared memory, F as a max-plus scan), the
// wavefront removes
//   - the block barriers: three per column there, none in the column
//     loop here (the strips' rings synchronise every 16 columns);
//   - the shared-memory state: H, E and the query ranks live in
//     registers, and nothing goes to global scratch at any M;
//   - the global load per cell: the query ranks are loaded once;
//   - the scan: F runs through the run and up the lanes by shuffles, and
//     DPX folds each add-max pair into one instruction.
// What stays is the wavefront's price: per step and lane four shuffles,
// lane 0's and lane 31's ring traffic and the rank hand-off, which runs
// of 4 (the launch's usual R) share over only 4 cells.  The score loads'
// bank conflicts (the lanes of a step read 32 different rows) cost
// little: a conflict-free per-warp query profile measured no faster.

#include <cuda/atomic>
#include <cuda_runtime.h>
#include <stdint.h>

#define NEG32 (-(1 << 27))
#define RECT_DEAD (-(1 << 20))      // score of a dead query position or column
#define RECT_RING 128               // hand-off slots between two strips
#define RECT_CHUNK 16               // steps per block, between publications
#define RECT_MAX_THREADS 512        // 16 strips (warps) per block

struct RectProblem {
    const int8_t* q;          // (B, M) query ranks
    const int8_t* s;          // (B, N) window ranks
    const int8_t* subst8;     // (C, C), PAD row/column last
    int B, M, N, C, gf, ge;
    int W, P;                 // strips (warps) per alignment,
                              // alignments per block
    int32_t* out;             // (B,) best
};

using rect_flag = cuda::atomic_ref<int, cuda::thread_scope_block>;

// Bytes of the block's shared memory before the rings: the transposed
// matrix with a dead row and column, (C+1) x (C+1) int32, rounded to 16.
__host__ __device__ inline int rect_matrix_bytes(int C)
{
    return (4 * (C + 1) * (C + 1) + 15) & ~15;
}

// Spin (every lane, so the warp stays converged) until *flag >= need.
__device__ __forceinline__ void rect_wait(int32_t* flag, int need)
{
    rect_flag f(*flag);
    while (f.load(cuda::std::memory_order_acquire) < need) __nanosleep(64);
}

template <int R>
__global__ void __launch_bounds__(RECT_MAX_THREADS)
sw_rect_kernel(const RectProblem P)
{
    extern __shared__ int4 rect_smem[];
    const unsigned FULL = 0xffffffffu;
    const int C = P.C, C1 = C + 1, W = P.W, M = P.M, N = P.N;
    const int gf = P.gf, ge = P.ge;
    // subT[s * C1 + q] = S(q, s) - gf (H is kept as H + gf, below); row
    // and column C are dead
    int32_t* subT = (int32_t*)rect_smem;
    int2* rings = (int2*)((char*)rect_smem + rect_matrix_bytes(C));
    int32_t* ctl = (int32_t*)(rings + (size_t)P.P * (W - 1) * RECT_RING);
    for (int x = threadIdx.x; x < C1 * C1; x += blockDim.x) {
        const int sr = x / C1, qr = x - sr * C1;
        subT[x] = (sr < C && qr < C) ? (int)P.subst8[qr * C + sr] - gf
                                     : RECT_DEAD;
    }
    // per alignment of the block: the best, then per ring its producer's
    // and its consumer's progress (columns written, columns read)
    for (int x = threadIdx.x; x < P.P * 2 * W; x += blockDim.x) ctl[x] = 0;
    __syncthreads();

    const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
    const int a = wid / W, k = wid - a * W;
    const int b = blockIdx.x * P.P + a;
    const bool live = b < P.B;
    int32_t* actl = ctl + a * 2 * W;
    const bool has_in = k > 0, has_out = k + 1 < W;
    int32_t* prod_in = actl + 2 * k - 1;      // ring k - 1 (has_in)
    int32_t* cons_in = actl + 2 * k;
    int32_t* prod_out = actl + 2 * k + 1;     // ring k (has_out)
    int32_t* cons_out = actl + 2 * k + 2;
    const int2* ring_in =
        has_in ? rings + (size_t)(a * (W - 1) + k - 1) * RECT_RING : nullptr;
    int2* ring_out =
        has_out ? rings + (size_t)(a * (W - 1) + k) * RECT_RING : nullptr;

    const int8_t* qrow = P.q + (size_t)(live ? b : 0) * M;
    const int8_t* srow = P.s + (size_t)(live ? b : 0) * N;
    const int i0 = (k * 32 + lane) * R;
    // Hg = H + gf, so that E = max(E + ge, Hg) and the next Hg =
    // max(F + gf, T + gf) are one DPX instruction each; qb: the query
    // rank's byte offset in a row of subT
    int Hg[R], E[R], qb[R];
#pragma unroll
    for (int r = 0; r < R; ++r) {
        Hg[r] = gf;
        E[r] = NEG32;
        qb[r] = 4 * ((live && i0 + r < M) ? (int)qrow[i0 + r] : C);
    }
    // sr: this lane's window rank at the step; ho, fo: the Hg of its top
    // position and the F it hands up, at its last column; hd: the lane
    // below's top Hg at the last column (the diagonal source of the run's
    // first cell)
    int sr = lane == 0 && N > 0 ? (int)srow[0] : C;
    int ho = gf, fo = NEG32, hd = gf, best = gf;
    const char* subB = (const char*)subT;
    // One block of RECT_CHUNK steps t0.. (unrolled, no branch inside):
    // wcur holds in lanes l < RECT_CHUNK the window rank s[t0 + 1 + l]
    // (lane 0's rank at the next step), wnext is loaded for the next
    // block.  The strips synchronise once per block: the consumer waits
    // until its producer has written the block's columns, the producer
    // until the slots it overwrites were read; each then publishes.
    auto block = [&](const int t0, const int wcur, int& wnext) {
        const int xn = t0 + 1 + RECT_CHUNK + (lane & (RECT_CHUNK - 1));
        wnext = xn < N ? (int)srow[xn] : C;
        // the block writes columns up to t0 + RECT_CHUNK - 32, each over
        // the slot of the column RECT_RING before it
        if (has_in && t0 < N) rect_wait(prod_in, min(t0 + RECT_CHUNK, N));
        if (has_out)
            rect_wait(cons_out, min(t0 + RECT_CHUNK - 31 - RECT_RING, N));
        // the block's ring slots: t0 is a multiple of RECT_CHUNK, which
        // divides RECT_RING, so they do not wrap
        const int2* rb = ring_in + (t0 & (RECT_RING - 1));
        auto step = [&](const int u) {
            const int t = t0 + u;
            // this step's scores and lane 0's hand-off, loaded before
            // the shuffles so that their latencies overlap
            const char* rowp = subB + sr * (4 * C1);
            int sub[R];
#pragma unroll
            for (int r = 0; r < R; ++r) sub[r] = *(const int*)(rowp + qb[r]);
            const int2 rv = has_in && t < N ? rb[u] : make_int2(gf, NEG32);
            int hin = __shfl_up_sync(FULL, ho, 1);
            int fin = __shfl_up_sync(FULL, fo, 1);
            const int s1 = __shfl_sync(FULL, wcur, u);
            const int srn = __shfl_up_sync(FULL, sr, 1);
            hin = lane == 0 ? rv.x : hin;
            fin = lane == 0 ? rv.y : fin;
            sr = lane == 0 ? s1 : srn;
            int diag = hd;
            hd = hin;
            int f = fin;
#pragma unroll
            for (int r = 0; r < R; ++r) {
                const int e = __viaddmax_s32(E[r], ge, Hg[r]);
                const int tg = __viaddmax_s32_relu(diag, sub[r], e) + gf;
                diag = Hg[r];
                Hg[r] = __viaddmax_s32(f, gf, tg);
                f = __viaddmax_s32(f, ge, tg);
                E[r] = e;
                if (r & 1)
                    best = __vimax3_s32(best, Hg[r > 0 ? r - 1 : 0], Hg[r]);
                else if (r == R - 1)
                    best = max(best, Hg[r]);
            }
            ho = Hg[R - 1];
            fo = f;
            // lane 31 finished column t - 31
            if (has_out && lane == 31 && t >= 31 && t - 31 < N)
                ring_out[(t - 31) & (RECT_RING - 1)] = make_int2(ho, fo);
        };
        // long runs are not unrolled over the block: their registers
        // would spill
        if constexpr (R >= 16) {
#pragma unroll 1
            for (int u = 0; u < RECT_CHUNK; ++u) step(u);
        } else {
#pragma unroll
            for (int u = 0; u < RECT_CHUNK; ++u) step(u);
        }
        const int t1 = t0 + RECT_CHUNK;
        if (has_in && t0 < N && lane == 0)
            rect_flag(*cons_in).store(min(t1, N),
                                      cuda::std::memory_order_release);
        if (has_out && t1 > 31 && lane == 31)
            rect_flag(*prod_out).store(min(t1 - 31, N),
                                       cuda::std::memory_order_release);
    };
    // blocks in pairs, so that the two window registers alternate; the
    // last block's steps past N + 31 sweep dead columns
    const int steps = (live && N > 0) ? N + 31 : 0;
    int winA = 1 + (lane & (RECT_CHUNK - 1)) < N
                   ? (int)srow[1 + (lane & (RECT_CHUNK - 1))] : C;
    int winB = C;
    for (int t0 = 0; t0 < steps; t0 += 2 * RECT_CHUNK) {
        block(t0, winA, winB);
        if (t0 + RECT_CHUNK < steps) block(t0 + RECT_CHUNK, winB, winA);
    }
    best -= gf;
    for (int o = 16; o > 0; o >>= 1)
        best = max(best, __shfl_xor_sync(FULL, best, o));
    if (lane == 0 && live) atomicMax(actl, best);
    __syncthreads();
    if ((int)threadIdx.x < P.P) {
        const int bb = blockIdx.x * P.P + threadIdx.x;
        if (bb < P.B) P.out[bb] = ctl[threadIdx.x * 2 * W];
    }
}

template <int R>
static int rect_launch(const RectProblem& P, int blocks, int threads,
                       long long smem_bytes, cudaStream_t stream)
{
    if (smem_bytes > 48 * 1024) {
        cudaError_t err = cudaFuncSetAttribute(
            sw_rect_kernel<R>, cudaFuncAttributeMaxDynamicSharedMemorySize,
            (int)smem_bytes);
        if (err != cudaSuccess) return (int)err;
    }
    sw_rect_kernel<R><<<blocks, threads, (size_t)smem_bytes, stream>>>(P);
    return (int)cudaGetLastError();
}

// Plain C entry point (loaded with ctypes).  R: query positions per lane
// (1, 2, 4, 8, 16 or 32); W: strips per alignment, W * 32 * R >= M; P:
// alignments per block, W * P <= 16; smem_bytes: rect_matrix_bytes(C) +
// P * (W - 1) * RECT_RING * 8 + P * 2 * W * 4.  Launches on `stream` and
// returns cudaGetLastError() of the launch.
extern "C" int sw_rect_launch(
    const int8_t* q, const int8_t* s, const int8_t* subst8, int B, int M,
    int N, int C, int gap_first, int gap_extend, int R, int W, int P,
    long long smem_bytes, int32_t* out, void* stream)
{
    if (B <= 0) return 0;
    if (W < 1 || P < 1 || W * P * 32 > RECT_MAX_THREADS
        || (long long)W * 32 * R < M)
        return (int)cudaErrorInvalidValue;
    const RectProblem prob{q, s, subst8, B, M, N, C, gap_first, gap_extend,
                           W, P, out};
    const int blocks = (B + P - 1) / P, threads = 32 * W * P;
    cudaStream_t st = (cudaStream_t)stream;
    switch (R) {
    case 1: return rect_launch<1>(prob, blocks, threads, smem_bytes, st);
    case 2: return rect_launch<2>(prob, blocks, threads, smem_bytes, st);
    case 4: return rect_launch<4>(prob, blocks, threads, smem_bytes, st);
    case 8: return rect_launch<8>(prob, blocks, threads, smem_bytes, st);
    case 16: return rect_launch<16>(prob, blocks, threads, smem_bytes, st);
    case 32: return rect_launch<32>(prob, blocks, threads, smem_bytes, st);
    default: return (int)cudaErrorInvalidValue;
    }
}
