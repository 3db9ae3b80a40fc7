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
// w = i - j + D, in-band lanes w in [D - d_row, D], off-band cells dead,
// rows with d_row < 0 are batch padding), plus, per cell, the uint8 code
// of the sw_xla encoding that the host walk (ops/sw_band.traceback_banded)
// reads:
//   bits 0-1  H source when H > 0: 1 diagonal, 2 E, 3 F (priority in that
//             order), 0 when H == 0;
//   bit 2 (4) E extends: E[w+1] + ge >= H[w+1] + gf of the previous column
//             (never at w = D, whose up values are E = -inf, H = 0);
//   bit 3 (8) F extends: F[w-1] + ge >= H[w-1] + gf with the final H of the
//             offset below (never at the lowest offset).
// Off-band cells get code 0.  Per row it also returns the best score and
// the end cell (j, w) the walk starts from: maximum H, then smallest i+j,
// then smallest i -- the JAX rule of traceback_banded (per-lane first
// column at the maximum, then the smallest (i+j, i)), which a running key
// reproduces because a lane's first column at its maximum has its
// smallest i+j.
//
// Layout: one thread per alignment, the in-place column sweep of K1 (H and
// E columns in dynamic shared memory, [w][thread], or in a global scratch
// buffer [w][b] when they do not fit).  The codes are written as
// dirs[j][w][b] (shape (N, D+1, B)), so the 32 threads of a warp store 32
// consecutive bytes for each cell.
//
// Bound: integer operations at most shapes, bytes at some.  Each needed
// cell costs about 22 int32 operations (K1's 11, the code and the
// end-cell key), and the codes are written once, B * N * (D+1) bytes; at
// 3.35 TB/s a byte costs as much as 5 operations at the int32 rate, so the
// store stream sets the bound only where the band's cells outnumber the
// needed ones about fourfold (wide bands over short queries).  This first
// version does nothing about either beyond coalescing the byte stores
// across the warp; packing four codes into one 32-bit store and spreading
// the band over threads (K3's design) are later work.

#include <cuda_runtime.h>
#include <stdint.h>

#define NEG32 (-(1 << 27))

__global__ void sw_band_dirs_kernel(
    const int8_t* __restrict__ q, const int8_t* __restrict__ s,
    const int32_t* __restrict__ d_rows, const int8_t* __restrict__ subst8,
    int B, int N, int D, int C, int gap_first, int gap_extend,
    int32_t* __restrict__ scratch, uint8_t* __restrict__ dirs,
    int32_t* __restrict__ best_out, int32_t* __restrict__ end_j,
    int32_t* __restrict__ end_w)
{
    extern __shared__ int32_t smem[];
    int32_t* sub = smem;
    const int tid = threadIdx.x;
    for (int i = tid; i < C * C; i += blockDim.x) sub[i] = subst8[i];
    __syncthreads();

    const int b = blockIdx.x * blockDim.x + tid;
    if (b >= B) return;
    const int d = d_rows[b];
    const int Ws = D + 1;
    const size_t col_stride = (size_t)Ws * B;     // dirs: one column j
    uint8_t* drow = dirs + b;
    if (d < 0) {
        for (int j = 0; j < N; ++j)
            for (int w = 0; w <= D; ++w)
                drow[j * col_stride + (size_t)w * B] = 0;
        best_out[b] = 0;
        end_j[b] = -1;
        end_w[b] = -1;
        return;
    }
    int32_t* H;
    int32_t* E;
    size_t stride;
    if (scratch == nullptr) {
        H = smem + C * C + tid;
        E = H + (size_t)Ws * blockDim.x;
        stride = blockDim.x;
    } else {
        H = scratch + b;
        E = H + (size_t)Ws * B;
        stride = B;
    }
    const int wmin = d > D ? 0 : D - d;
    for (int w = wmin; w <= D; ++w) {
        H[w * stride] = 0;
        E[w * stride] = NEG32;
    }

    const int8_t* qrow = q + (size_t)b * N;
    const int8_t* srow = s + (size_t)b * N;
    const int pad = C - 1;
    const int gf = gap_first, ge = gap_extend;
    int best = 0, bj = -1, bw = -1;
    int bkey = 0x7fffffff;                          // 2j + w of the best cell
    for (int j = 0; j < N; ++j) {
        uint8_t* dcol = drow + j * col_stride;
        for (int w = 0; w < wmin; ++w) dcol[(size_t)w * B] = 0;
        const int32_t* scol = sub + srow[j];
        int f = NEG32;             // F[w - 1]
        int fsrc = NEG32;          // Htmp[w - 1] (off band below wmin)
        int hn_prev = 0;           // final H[w - 1]
        int h_diag = H[wmin * stride];
        for (int w = wmin; w <= D; ++w) {
            int h_up = 0, e_up = NEG32;      // w = D pulls from off band
            if (w < D) {
                h_up = H[(w + 1) * stride];
                e_up = E[(w + 1) * stride];
            }
            const int ea = e_up + ge, eb = h_up + gf;
            const int e = max(ea, eb);
            const int i = j + w - D;
            const int qr = (i >= 0 && i < N) ? (int)qrow[i] : pad;
            const int diag = h_diag + scol[qr * C];
            const int htmp = max(max(diag, e), 0);
            const bool f_ext = f + ge >= hn_prev + gf;   // F[w-1], H[w-1]
            f = max(f + ge, fsrc + gf);
            const int h = max(htmp, f);
            int code = 0;
            if (h > 0) code = h == diag ? 1 : (h == e ? 2 : 3);
            if (ea >= eb) code |= 4;
            if (f_ext && w > wmin) code |= 8;
            dcol[(size_t)w * B] = (uint8_t)code;
            fsrc = htmp;
            hn_prev = h;
            H[w * stride] = h;
            E[w * stride] = e;
            const int key = 2 * j + w;
            if (h > 0 && (h > best || (h == best && key <= bkey))) {
                best = h;
                bkey = key;
                bj = j;
                bw = w;
            }
            h_diag = h_up;
        }
    }
    best_out[b] = best;
    end_j[b] = bj;
    end_w[b] = bw;
}

// Plain C entry point (loaded with ctypes).  Launches on `stream` and
// returns cudaGetLastError() of the launch.
extern "C" int sw_band_dirs_launch(
    const int8_t* q, const int8_t* s, const int32_t* d_rows,
    const int8_t* subst8, int B, int N, int D, int C, int gap_first,
    int gap_extend, int32_t* scratch, int threads, long long smem_bytes,
    uint8_t* dirs, int32_t* best, int32_t* end_j, int32_t* end_w,
    void* stream)
{
    if (B <= 0) return 0;
    if (smem_bytes > 48 * 1024) {
        cudaError_t err = cudaFuncSetAttribute(
            sw_band_dirs_kernel,
            cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem_bytes);
        if (err != cudaSuccess) return (int)err;
    }
    const int blocks = (B + threads - 1) / threads;
    sw_band_dirs_kernel<<<blocks, threads, (size_t)smem_bytes,
                          (cudaStream_t)stream>>>(
        q, s, d_rows, subst8, B, N, D, C, gap_first, gap_extend, scratch,
        dirs, best, end_j, end_w);
    return (int)cudaGetLastError();
}
