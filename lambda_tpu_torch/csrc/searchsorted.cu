// Seeding's bisection over the sorted key index for Hopper (sm_90a): one
// thread per searched row, the whole bisection in registers.
//
// Replaces no TPU kernel.  The JAX package bisects with jnp ops in a
// lax.while_loop (lambda_tpu/ops/searchsorted.py: search_range), which XLA
// runs as one program on the TPU.  The port's eager version
// (ops/searchsorted.py: search_range_torch, kept as this kernel's plain
// version) issues some 59 small kernels per bisection step, and seeding
// calls it for every step of every count curve: the host's launches, not
// the card, set seeding's time.  This file does each call in one launch.
//
// What it computes (ss_range_launch): for every row i, within the initial
// range [lo0, hi0) -- intersected with the row's first-word prefix bucket
// where the row's mask covers the bucketed prefix -- the subrange of key
// rows whose masked key equals the row's target:
//   lo = first row r in the range with (keys[r] & mask) >= target
//   hi = first row r in the range with (keys[r] & mask) >  target
// compared lexicographically over the row's words.  Both bounds follow
// the plain version's bisection step by step (mid = lo + (hi - lo) / 2,
// the key read at mid clamped into the array) until their ranges are
// empty, so the results are the plain version's on every input, inverted
// or empty ranges included.  While the two bounds' ranges coincide they
// read the same key, so one load serves both; after the first equal key
// they split, and each step then issues both bounds' loads before either
// compare.  A row whose valid byte is 0 answers [lo0, lo0) without a
// load and is counted (one atomic per warp) into *skipped.
//
// ss_curves_launch: the count curve of each walked cursor.  Column 0 is
// the cursor's (lo, count); step e appends the cursor's next query
// character to its packed target, at the word and shift the step's plan
// row gives, takes the plan row's masks (one character longer), and
// bisects within step e - 1's range.  The E steps run in one thread.
//
// Keys are the index's rows as stored: (P, words) int64 holding uint32
// values.  words = 1-4 are compiled with the row in registers; wider
// rows take a loop over the words.  The alphabet's bits and characters
// per word enter only through the masks, the packed targets and the
// plan, so the DNA indexes take the kernel unchanged.
//
// Bound: dependent random loads.  A row's bisection is a chain of about
// log2(range) loads, each of one key row (8 * words bytes in one or two
// 32-byte sectors) at a random place in a table of gigabytes, far beyond
// the 50 MB L2, so each step waits one device-memory latency.  The
// least time of a launch is the larger of (the longest chain) x (the
// card's random-load latency) and (sectors read x 32 bytes) / 3.35 TB/s.
// One thread per row keeps thousands of chains in flight, so the second
// term rules at the main path's row counts; issuing the split bounds'
// loads together halves each chain after the split.

#include <cuda_runtime.h>
#include <stdint.h>

typedef long long i64;

#define SS_THREADS 256
// the widest key row the loop over words holds (words above 4)
#define SS_MAXW 64

// a row's packed target and mask words
template <int W>
struct Needle {
    i64 t[W > 0 ? W : SS_MAXW];
    i64 m[W > 0 ? W : SS_MAXW];
};

__device__ __forceinline__ i64 clamp_row(i64 r, i64 last)
{
    return r < 0 ? 0 : (r > last ? last : r);
}

// sign of (keys[row] & mask) - target, lexicographic over the words; with
// the row in registers (W > 0) every word's load is issued first
template <int W>
__device__ __forceinline__ int cmp_row(const i64* __restrict__ keys, i64 row,
                                       const Needle<W>& x, int words)
{
    if constexpr (W > 0) {
        const i64* k = keys + row * W;
        i64 kw[W];
#pragma unroll
        for (int w = 0; w < W; ++w) kw[w] = __ldg(k + w);
#pragma unroll
        for (int w = 0; w < W; ++w) {
            const i64 v = kw[w] & x.m[w];
            if (v != x.t[w]) return v < x.t[w] ? -1 : 1;
        }
        return 0;
    } else {
        const i64* k = keys + row * words;
        for (int w = 0; w < words; ++w) {
            const i64 v = __ldg(k + w) & x.m[w];
            if (v != x.t[w]) return v < x.t[w] ? -1 : 1;
        }
        return 0;
    }
}

// [lo, hi) <- the subrange of [lo, hi) whose masked keys equal x's target
template <int W>
__device__ __forceinline__ void equal_range(const i64* __restrict__ keys,
                                            i64 last, const Needle<W>& x,
                                            int words, i64& lo, i64& hi)
{
    i64 ll = lo, lh = hi;            // the lower bound's range
    i64 ul = lo, uh = hi;            // the upper bound's
    bool split = false;
    while (ll < lh) {                // the two ranges coincide: one load
        const i64 mid = ll + ((lh - ll) >> 1);
        const int c = cmp_row<W>(keys, clamp_row(mid, last), x, words);
        if (c < 0) {
            ll = mid + 1;
        } else if (c > 0) {
            lh = mid;
        } else {                     // lower goes left, upper right
            ul = mid + 1;
            uh = lh;
            lh = mid;
            split = true;
            break;
        }
    }
    if (!split) {
        lo = ll;
        hi = lh;
        return;
    }
    while (ll < lh || ul < uh) {
        const bool ol = ll < lh, ou = ul < uh;
        const i64 ml = ll + ((lh - ll) >> 1);
        const i64 mu = ul + ((uh - ul) >> 1);
        const int cl = ol ? cmp_row<W>(keys, clamp_row(ml, last), x, words)
                          : 0;
        const int cu = ou ? cmp_row<W>(keys, clamp_row(mu, last), x, words)
                          : 0;
        if (ol) {
            if (cl < 0) ll = ml + 1; else lh = ml;
        }
        if (ou) {
            if (cu <= 0) ul = mu + 1; else uh = mu;
        }
    }
    lo = ll;
    hi = uh;
}

template <int W>
__device__ __forceinline__ void load_words(i64* dst, const i64* src,
                                           int words)
{
    const int nw = W > 0 ? W : words;
#pragma unroll
    for (int w = 0; w < (W > 0 ? W : SS_MAXW); ++w)
        if (W > 0 || w < nw) dst[w] = src[w];
}

template <int W>
__global__ void __launch_bounds__(SS_THREADS) ss_range_kernel(
    const i64* __restrict__ keys, i64 P, int words,
    const i64* __restrict__ targets, const i64* __restrict__ masks,
    const i64* __restrict__ lo0, const i64* __restrict__ hi0,
    const uint8_t* __restrict__ valid, const i64* __restrict__ bucket,
    int bucket_shift, i64 n, i64* __restrict__ lo_out,
    i64* __restrict__ hi_out, unsigned long long* __restrict__ skipped)
{
    const i64 i = (i64)blockIdx.x * blockDim.x + threadIdx.x;
    const bool in = i < n;
    const bool skip = in && valid != nullptr && valid[i] == 0;
    if (skipped != nullptr) {        // every lane of the warp gets here
        const unsigned b = __ballot_sync(0xffffffffu, skip);
        if (b != 0u && (int)(threadIdx.x & 31) == __ffs(b) - 1)
            atomicAdd(skipped, (unsigned long long)__popc(b));
    }
    if (!in) return;
    i64 lo = lo0 != nullptr ? lo0[i] : 0;
    i64 hi = hi0 != nullptr ? hi0[i] : P;
    if (skip) {
        lo_out[i] = lo;
        hi_out[i] = lo;
        return;
    }
    const int nw = W > 0 ? W : words;
    Needle<W> x;
    load_words<W>(x.t, targets + i * nw, words);
    load_words<W>(x.m, masks + i * nw, words);
    if (bucket != nullptr) {
        const i64 full = bucket_shift < 32
            ? ((i64)0xFFFFFFFF << bucket_shift) & 0xFFFFFFFF : 0;
        if ((x.m[0] & full) == full) {
            const i64 p = x.t[0] >> bucket_shift;
            const i64 blo = bucket[p], bhi = bucket[p + 1];
            lo = lo > blo ? lo : blo;
            hi = hi < bhi ? hi : bhi;
        }
        hi = hi > lo ? hi : lo;
    }
    equal_range<W>(keys, P - 1, x, words, lo, hi);
    lo_out[i] = lo;
    hi_out[i] = hi;
}

template <int W>
__global__ void __launch_bounds__(SS_THREADS) ss_curves_kernel(
    const i64* __restrict__ keys, i64 P, int words,
    const i64* __restrict__ targets, const i64* __restrict__ lo0,
    const i64* __restrict__ cnt0, const i64* __restrict__ chars,
    const i64* __restrict__ plan, int E, i64 n,
    i64* __restrict__ lo_curve, i64* __restrict__ cnt_curve)
{
    const i64 i = (i64)blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= n) return;
    const int nw = W > 0 ? W : words;
    Needle<W> x;
    load_words<W>(x.t, targets + i * nw, words);
    i64 lo = lo0[i], hi = lo + cnt0[i];
    i64* lc = lo_curve + i * (E + 1);
    i64* cc = cnt_curve + i * (E + 1);
    lc[0] = lo;
    cc[0] = hi - lo;
    for (int e = 0; e < E; ++e) {
        const i64* pe = plan + (i64)e * (nw + 2);
        load_words<W>(x.m, pe, words);
        const i64 cw = pe[nw];
        const i64 add = (chars[i * E + e] + 1) << pe[nw + 1];
#pragma unroll
        for (int w = 0; w < (W > 0 ? W : SS_MAXW); ++w)
            if ((W > 0 || w < nw) && w == cw) x.t[w] += add;
        equal_range<W>(keys, P - 1, x, words, lo, hi);
        lc[e + 1] = lo;
        cc[e + 1] = hi - lo;
    }
}

static int blocks_for(i64 n)
{
    return (int)((n + SS_THREADS - 1) / SS_THREADS);
}

// The range search of n rows (see the header); lo0/hi0 may be null (0
// and P), valid null (every row valid), bucket null (no prefix table),
// skipped null (not counted).  Returns cudaGetLastError() of the launch.
extern "C" int ss_range_launch(
    const i64* keys, long long P, int words, const i64* targets,
    const i64* masks, const i64* lo0, const i64* hi0, const uint8_t* valid,
    const i64* bucket, int bucket_shift, long long n, i64* lo_out,
    i64* hi_out, unsigned long long* skipped, void* stream)
{
    if (n <= 0) return 0;
    if (P <= 0 || words < 1 || words > SS_MAXW || bucket_shift < 0
        || bucket_shift > 32)
        return (int)cudaErrorInvalidValue;
    cudaStream_t st = (cudaStream_t)stream;
    const int blocks = blocks_for(n);
#define SS_RANGE(W)                                                         \
    ss_range_kernel<W><<<blocks, SS_THREADS, 0, st>>>(                      \
        keys, P, words, targets, masks, lo0, hi0, valid, bucket,            \
        bucket_shift, n, lo_out, hi_out, skipped)
    switch (words) {
    case 1: SS_RANGE(1); break;
    case 2: SS_RANGE(2); break;
    case 3: SS_RANGE(3); break;
    case 4: SS_RANGE(4); break;
    default: SS_RANGE(0); break;
    }
#undef SS_RANGE
    return (int)cudaGetLastError();
}

// The count curves of n cursors over E steps: targets (n, words), lo0 and
// cnt0 (n,), chars (n, E) query ranks, plan (E, words + 2): each step's
// masks, then the word its character goes to (-1: none) and its shift.
// Writes lo_curve and cnt_curve (n, E + 1).  Returns cudaGetLastError().
extern "C" int ss_curves_launch(
    const i64* keys, long long P, int words, const i64* targets,
    const i64* lo0, const i64* cnt0, const i64* chars, const i64* plan,
    int E, long long n, i64* lo_curve, i64* cnt_curve, void* stream)
{
    if (n <= 0) return 0;
    if (P <= 0 || words < 1 || words > SS_MAXW || E < 0)
        return (int)cudaErrorInvalidValue;
    cudaStream_t st = (cudaStream_t)stream;
    const int blocks = blocks_for(n);
#define SS_CURVES(W)                                                        \
    ss_curves_kernel<W><<<blocks, SS_THREADS, 0, st>>>(                     \
        keys, P, words, targets, lo0, cnt0, chars, plan, E, n, lo_curve,    \
        cnt_curve)
    switch (words) {
    case 1: SS_CURVES(1); break;
    case 2: SS_CURVES(2); break;
    case 3: SS_CURVES(3); break;
    case 4: SS_CURVES(4); break;
    default: SS_CURVES(0); break;
    }
#undef SS_CURVES
    return (int)cudaGetLastError();
}
