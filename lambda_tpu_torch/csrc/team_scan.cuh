// The F recurrence of K3 and K4 across the threads of a team.
//
// A team is T consecutive threads of a block (T a power of two, at most
// 1024, teams aligned to T) that share one alignment; thread tt of the
// team holds a run of R consecutive cells of the column.  Within its run a
// thread computes c, the F value its own cells hand to the first cell of
// the next run.  F entering run tt is then an exclusive max-plus scan over
// the runs below it:
//   F_in[tt] = max over t' < tt of c[t'] + (tt - 1 - t') * step,
//   step = R * gap_extend, F_in[0] = -inf,
// computed with warp shuffles and, for teams wider than a warp, one
// carry per warp through shared memory.
//
// Every thread of the block must call it (it holds __syncthreads).  `ys`
// holds blockDim.x ints and `warp_tot` blockDim.x / 32 ints of shared
// memory.  Results below -inf are clamped to -inf (NEG32): they only ever
// meet H values that are >= 0.

#pragma once

#include <cuda_runtime.h>

#ifndef NEG32
#define NEG32 (-(1 << 27))
#endif

__device__ __forceinline__ int team_scan_exclusive(
    int c, int step, int T, int tt, int* ys, int* warp_tot)
{
    const int lane = threadIdx.x & 31;
    const int width = T < 32 ? T : 32;
    // inclusive scan inside each warp (or each team narrower than one)
    int y = c;
    for (int s = 1; s < width; s <<= 1) {
        const int v = __shfl_up_sync(0xffffffffu, y, s, width);
        if ((lane & (width - 1)) >= s) y = max(y, v + s * step);
    }
    if (T > 32) {
        const int warp = threadIdx.x >> 5;
        if (lane == 31) warp_tot[warp] = y;
        __syncthreads();
        // carry from the team's earlier warps:
        // max over k < wt of tot[k] + 32 * (wt - 1 - k) * step
        const int wt = tt >> 5;
        const int w0 = warp - wt;
        int carry = NEG32;
        for (int k = 0; k < wt; ++k)
            carry = max(max(carry + 32 * step, NEG32), warp_tot[w0 + k]);
        y = max(y, carry + (lane + 1) * step);
    }
    ys[threadIdx.x] = y;
    __syncthreads();
    const int f = tt > 0 ? ys[threadIdx.x - 1] : NEG32;
    return max(f, NEG32);
}
