// A probe of the card's int32 instruction rates, behind the operation
// bounds that chip_smoke.py states for K1-K4.  No search path runs it.
//
// The bounds count the needed cells of banded Smith-Waterman.  Written
// with plain int32 operations a cell takes 11 (5 adds, 6 maxes); with
// Hopper's DPX instructions, which fold an add and a max (and a max with
// 0) into one, it takes 7:
//   E = __viaddmax_s32(E, ge, H[w+1] + gf)          1 add, 1 DPX
//   T = __viaddmax_s32_relu(H[w], sub, E)           1 DPX
//   F = __viaddmax_s32(F, ge, T[w-1] + gf)          1 add, 1 DPX
//   H = max(T, F); best = max(best, H)              2 maxes
// Whether 7 DPX-folded instructions beat 11 plain ones depends on the rate
// at which DPX issues, which no data sheet gives; this kernel measures it.
//
// Modes (each thread runs `iters` iterations of CH chains that feed one
// another across iterations, so no chain folds into a closed form, and
// stores what it computed, so nothing is dead):
//   0  add                    x[c] = x[c] + x[c+1]
//   1  max                    x[c] = max(x[c], x[c+1])
//   2  __viaddmax_s32         x[c] = max(x[c] + y[c], x[c+1])
//   3  __viaddmax_s32_relu    x[c] = max(x[c] + y[c], x[c+1], 0)
//   4  the cell above, CELLS independent cells per iteration
// Modes 1-4 issue CH instructions per iteration (mode 4: 7 * CELLS), one
// per operation; nvcc spreads mode 0's adds over IADD3 and IMAD, which
// issue on two pipes, so its rate is that of adds as compiled.
//   5  the carry of the slot walk (csrc/slot_walk.cu): per iteration a
//      warp sum of an int64 (five shuffles and adds) and one add, each
//      iteration waiting for the last; launched as one warp, its time
//      over `iters` is the latency of one slot's chain.

#include <cuda_runtime.h>
#include <stdint.h>

#define CH 8
#define CELLS 4

template <int MODE>
__global__ void int_rate_kernel(const int32_t* __restrict__ in, int iters,
                                int32_t* __restrict__ out)
{
    const int t = blockIdx.x * blockDim.x + threadIdx.x;
    int32_t acc = 0;
    if (MODE < 4) {
        int32_t x[CH], y[CH];
#pragma unroll
        for (int c = 0; c < CH; ++c) {
            x[c] = in[c] + t;
            y[c] = in[CH + c];
        }
        for (int it = 0; it < iters; ++it) {
            int32_t n[CH];
#pragma unroll
            for (int c = 0; c < CH; ++c) {
                const int32_t a = x[c], b = x[(c + 1) % CH];
                if (MODE == 0) n[c] = a + b;
                if (MODE == 1) n[c] = max(a, b);
                if (MODE == 2) n[c] = __viaddmax_s32(a, y[c], b);
                if (MODE == 3) n[c] = __viaddmax_s32_relu(a, y[c], b);
            }
#pragma unroll
            for (int c = 0; c < CH; ++c) x[c] = n[c];
        }
#pragma unroll
        for (int c = 0; c < CH; ++c) acc ^= x[c];
    } else {
        const int32_t gf = in[0], ge = in[1];
        int32_t h[CELLS], e[CELLS], f[CELLS], tp[CELLS], best[CELLS],
            sub[CELLS];
#pragma unroll
        for (int c = 0; c < CELLS; ++c) {
            h[c] = in[2 + c] + t;
            e[c] = f[c] = tp[c] = in[8 + c];
            best[c] = 0;
            sub[c] = in[12 + c];
        }
        for (int it = 0; it < iters; ++it) {
            int32_t t_new[CELLS], h_new[CELLS];
#pragma unroll
            for (int c = 0; c < CELLS; ++c) {
                e[c] = __viaddmax_s32(e[c], ge, h[(c + 1) % CELLS] + gf);
                t_new[c] = __viaddmax_s32_relu(h[c], sub[c], e[c]);
                f[c] = __viaddmax_s32(f[c], ge,
                                      tp[(c + CELLS - 1) % CELLS] + gf);
                h_new[c] = max(t_new[c], f[c]);
                best[c] = max(best[c], h_new[c]);
            }
#pragma unroll
            for (int c = 0; c < CELLS; ++c) {
                h[c] = h_new[c];
                tp[c] = t_new[c];
            }
        }
#pragma unroll
        for (int c = 0; c < CELLS; ++c) acc ^= best[c] ^ e[c] ^ f[c];
    }
    out[t] = acc;
}

__global__ void warp_chain_kernel(const int32_t* __restrict__ in, int iters,
                                  int32_t* __restrict__ out)
{
    const int t = blockIdx.x * blockDim.x + threadIdx.x;
    long long h = in[0] + t;
    const long long y = in[1];
    for (int it = 0; it < iters; ++it) {
        long long v = h;
#pragma unroll
        for (int o = 16; o > 0; o >>= 1)
            v += __shfl_xor_sync(0xffffffffu, v, o);
        h += v + y;
    }
    out[t] = (int32_t)(h ^ (h >> 32));
}

// Plain C entry point (loaded with ctypes): one launch of `mode` on
// `blocks` x `threads`; `in` holds 16 int32 seeds, `out` one int32 per
// thread.  Returns cudaGetLastError() of the launch (-1 for an unknown
// mode).
extern "C" int int_rate_launch(int mode, int blocks, int threads, int iters,
                               const int32_t* in, int32_t* out, void* stream)
{
    cudaStream_t st = (cudaStream_t)stream;
    switch (mode) {
    case 0: int_rate_kernel<0><<<blocks, threads, 0, st>>>(in, iters, out);
        break;
    case 1: int_rate_kernel<1><<<blocks, threads, 0, st>>>(in, iters, out);
        break;
    case 2: int_rate_kernel<2><<<blocks, threads, 0, st>>>(in, iters, out);
        break;
    case 3: int_rate_kernel<3><<<blocks, threads, 0, st>>>(in, iters, out);
        break;
    case 4: int_rate_kernel<4><<<blocks, threads, 0, st>>>(in, iters, out);
        break;
    case 5: warp_chain_kernel<<<blocks, threads, 0, st>>>(in, iters, out);
        break;
    default: return -1;
    }
    return (int)cudaGetLastError();
}
