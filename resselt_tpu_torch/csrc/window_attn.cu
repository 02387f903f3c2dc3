// Window multi-head attention with relative-position bias and shift mask,
// for Hopper: the attention core of SwinIR and the other window
// transformers.
//
// Replaces resselt_tpu/ops/window_attention.py::_kernel, which the JAX
// package reaches through window_mha_pallas.  For every window w and head h
// it computes what that kernel computes:
//   O[w, :, h] = softmax(scale * Q_h K_h^T + bias[h] + mask[w mod nW]) V_h
// with the scaled scores, bias, mask and softmax in f32 and the output in
// the input's dtype.  q, k and v are (B, N, C), C = heads * head_dim, whose
// tokens lie `ld` elements apart and windows `wstride` apart, so the three
// channel slices of one (B, N, 3C) qkv projection are read in place (no
// copy); bias is f32 (heads, N, N); mask is f32 (nW, N, N) or null; the
// output is contiguous (B, N, C).  Takes 1 <= N <= 256 and head_dim <= 64:
// tokens are padded to a multiple of 16 and head_dim to 16, 32 or 64 inside
// the kernel (zero in shared memory, -inf in the padded score columns).
//
// Two kernels:
//  * f32: exact f32 FMA on the CUDA cores (no TF32), one block per (window,
//    head).  K_h and V_h are staged in shared memory; each thread owns one
//    query row, keeps q (scaled in f32) and its output row in registers, and
//    walks the keys in steps of 16 with a running max and sum.
//  * bf16 / fp16 (one template over the 16-bit type): mma.sync m16n8k16
//    with f32 accumulation, persistent blocks; see below.
//
// What bounds it on an H100: bytes from device memory by the book (at
// SwinIR-M's bench shape, 16,384 windows of 64 tokens, C 180, 6 heads, one
// launch moves 4 x 377 MB against 48 GFLOP), but what a (window, head) block
// of the first design really waited for was L2: it read its own f32 bias
// tile and mask tile per window, 256 KB + 256 KB at n = 256 against 36 KB of
// q, k and v.  What the 16-bit kernel does about that:
//  * The bias is read once per block.  A block owns one head and one tile
//    of query rows (128 rows where a window has more than 64 and head_dim
//    pads to 32, else 64), keeps that slice of bias[h], divided by scale, in
//    shared memory (128 x n f32: 135 KB at n = 256; 18 KB at n = 64) and
//    never reads bias again.  The grid is as many blocks as the card holds
//    at once.
//  * A block is up to 16 warps in window groups: a group is the 4 or 8
//    warps of one row tile (16 rows a warp) and walks windows of its own,
//    w = chunk, chunk + nchunks, ...; the block's 2 or 4 groups share the
//    bias rows and nothing else, and meet at a named barrier of their own.
//    So 16 warps an SM hide each other's mma.sync, shuffle and exp latencies
//    although the bias slice leaves room for one block.  The blocks of one
//    window's heads and row tiles are neighbours and walk the windows in
//    step, so K and V (24 KB a head at HAT-S, staged once per row tile)
//    come from L2.
//  * Windows whose mask tile is all zero skip the mask: `flags` (one byte
//    per mask window, computed once per mask tensor by the caller) says
//    which tiles hold a non-zero value; adding 0.0f is exact.  Of a Swin
//    shift mask only the last row and column of windows are non-zero.
//  * K and V arrive ahead of the math: the keys of all of a group's windows
//    form one sequence of 64-key chunks that goes through a ring of 3
//    shared-memory slots (K and V rows of the chunk; the window's Q rows
//    ride with its first chunk into a ring of their own), each chunk a
//    cp.async group started two chunks ahead.  One group barrier per chunk:
//    it publishes the chunk that has landed and frees the slot of the
//    chunk before.  Rows are staged with the widest cp.async copies (16, 8
//    or 4 bytes) that the pointers, the pitches and head_dim allow; rows
//    that are only 2-byte aligned (an odd head_dim) are refused, and the
//    caller (ops/window_attention.py) hands such heads over zero-padded to
//    a multiple of 8 elements.
//  * Per chunk a warp starts its score accumulators from (bias + mask) /
//    scale (the mask's 8-byte loads go straight into the accumulator
//    registers, unconditional and all in flight at once; the bias comes from
//    shared memory, conflict-free at a row pitch of n + 8 floats), adds
//    Q K^T on the tensor cores, multiplies once by scale * log2(e), runs an
//    online softmax in base 2 (ex2 on the special-function unit) in f32,
//    and multiplies P, rounded to the 16-bit type, by V.  The scores never
//    leave registers.  scale must be positive.
// ptxas (CUDA 12.8, sm_90a): head_dim <= 32 is held to 128 registers by
// its 512 threads and spills 8 bytes; head_dim 64 (256 threads) takes 186
// and spills 4.  What this leaves on the table, and why HAT-S's bench shape
// is still 7-17% behind cuDNN's fused attention: mma.sync instead of
// wgmma, with every step of the chain (products, quad shuffles, ex2, the
// second products) waiting on the one before inside a warp; head_dim 24 /
// 30 padded to 32 in both products; as many ex2 as tensor-core cycles at
// head_dim 24; the same warps start the cp.async copies and do the math,
// so the copies' cycles are not hidden; O is stored from registers in
// 4-byte pieces (staging it through shared memory measured 4% better at
// head_dim 24 and worse at 30 and 12 on an H100, so it is not done).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "half16.cuh"

namespace {

constexpr int MAX_N = 256;
constexpr int MAX_HD = 64;
constexpr int H16_THREADS = 512;  // at most, per block (16-bit kernel): 16 warps in window groups of 4 or 8
constexpr int KT = 64;   // keys per softmax step and per ring slot (16-bit kernel)
constexpr int RS = 3;    // ring slots per window group (16-bit kernel)
constexpr int JT = 16;   // keys per softmax step (f32)

__host__ __device__ __forceinline__ int round16(int x) { return (x + 15) & ~15; }

// Stage rows [0, NP) of one head (hd elements at src + row * ld) into
// shared memory at dst + row * S, by the `nthreads` threads whose index is
// `tid`, zero past n rows and hd columns.  With
// VB = 4, 8 or 16 (hd, ld, src and S aligned to VB bytes) every copy is a
// cp.async, all in flight at once, that zero-fills outside the head.  The
// caller waits (cp_async_wait_all(), or cp_async_commit() and
// cp_async_wait<N>()) and passes a barrier.
template <int VB>
__device__ __forceinline__ void cp_async(void* dst, const void* src, bool valid) {
    const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(d), "l"(src), "n"(VB), "r"(valid ? VB : 0));
}

__device__ __forceinline__ void cp_async_wait_all() {
    asm volatile("cp.async.commit_group;\n" ::);
    asm volatile("cp.async.wait_group 0;\n" ::);
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }

template <int PENDING>
__device__ __forceinline__ void cp_async_wait() {
    asm volatile("cp.async.wait_group %0;\n" ::"n"(PENDING) : "memory");
}

template <typename T, int VB>
__device__ __forceinline__ void stage_vec(T* dst, const T* __restrict__ src, int n, int NP, int hd, int DP, int S,
                                          long long ld, int tid, int nthreads) {
    constexpr int E = VB / (int)sizeof(T);
    const int per_row = DP / E;
    for (int i = tid; i < NP * per_row; i += nthreads) {
        const int row = i / per_row, col = (i % per_row) * E;
        const bool valid = row < n && col < hd;
        cp_async<VB>(dst + row * S + col, valid ? src + row * ld + col : src, valid);
    }
}

template <typename T>
__device__ __forceinline__ void stage(T* dst, const T* __restrict__ src, int n, int NP, int hd, int DP, int S,
                                      long long ld, int vb, int tid, int nthreads) {
    switch (vb) {
        case 16: stage_vec<T, 16>(dst, src, n, NP, hd, DP, S, ld, tid, nthreads); break;
        case 8: stage_vec<T, 8>(dst, src, n, NP, hd, DP, S, ld, tid, nthreads); break;
        default: stage_vec<T, 4>(dst, src, n, NP, hd, DP, S, ld, tid, nthreads); break;
    }
}

// ---------------------------------------------------------------------------
// f32: CUDA-core FMA, one thread per query row.
// ---------------------------------------------------------------------------

template <int DP>
__global__ void __launch_bounds__(MAX_N)
wattn_f32_kernel(const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
                 const float* __restrict__ bias, const float* __restrict__ mask, float* __restrict__ out, int n,
                 int heads, int hd, long long ld, long long wstride, int nw, float scale, int vb) {
    extern __shared__ __align__(16) float smem32[];
    const int NP = round16(n);
    float* ks = smem32;
    float* vs = ks + NP * DP;
    const long long blk = blockIdx.x;
    const int h = (int)(blk % heads);
    const long long w = blk / heads;
    const size_t base = (size_t)w * wstride + (size_t)h * hd;
    stage<float>(ks, k + base, n, NP, hd, DP, DP, ld, vb, threadIdx.x, blockDim.x);
    stage<float>(vs, v + base, n, NP, hd, DP, DP, ld, vb, threadIdx.x, blockDim.x);
    cp_async_wait_all();
    __syncthreads();

    const int i = threadIdx.x;
    if (i >= n) return;
    const float* qp = q + base + (size_t)i * ld;
    float qr[DP], o[DP];
#pragma unroll
    for (int d = 0; d < DP; ++d) {
        qr[d] = d < hd ? qp[d] * scale : 0.f;
        o[d] = 0.f;
    }
    const float* br = bias + ((size_t)h * n + i) * n;
    const float* mr = mask != nullptr ? mask + ((size_t)(w % nw) * n + i) * n : nullptr;
    float m = -INFINITY, l = 0.f;

    for (int j0 = 0; j0 < n; j0 += JT) {
        float s[JT];
        float mx = -INFINITY;
#pragma unroll
        for (int jj = 0; jj < JT; ++jj) {
            const int j = j0 + jj;
            float val = -INFINITY;
            if (j < n) {
                const float* kr = ks + j * DP;
                float acc = 0.f;
#pragma unroll
                for (int d = 0; d < DP; d += 4) {
                    const float4 kv = *reinterpret_cast<const float4*>(kr + d);
                    acc = fmaf(qr[d], kv.x, acc);
                    acc = fmaf(qr[d + 1], kv.y, acc);
                    acc = fmaf(qr[d + 2], kv.z, acc);
                    acc = fmaf(qr[d + 3], kv.w, acc);
                }
                val = acc + br[j];
                if (mr != nullptr) val += mr[j];
            }
            s[jj] = val;
            mx = fmaxf(mx, val);
        }
        const float mn = fmaxf(m, mx);
        const float corr = expf(m - mn);
        m = mn;
        l *= corr;
#pragma unroll
        for (int d = 0; d < DP; ++d) o[d] *= corr;
#pragma unroll
        for (int jj = 0; jj < JT; ++jj) {
            const int j = j0 + jj;
            if (j < n) {
                const float p = expf(s[jj] - mn);
                l += p;
                const float* vr = vs + j * DP;
#pragma unroll
                for (int d = 0; d < DP; d += 4) {
                    const float4 vv = *reinterpret_cast<const float4*>(vr + d);
                    o[d] = fmaf(p, vv.x, o[d]);
                    o[d + 1] = fmaf(p, vv.y, o[d + 1]);
                    o[d + 2] = fmaf(p, vv.z, o[d + 2]);
                    o[d + 3] = fmaf(p, vv.w, o[d + 3]);
                }
            }
        }
    }
    const float inv = 1.f / l;
    float* op = out + ((size_t)w * n + i) * ((size_t)heads * hd) + (size_t)h * hd;
#pragma unroll
    for (int d = 0; d < DP; ++d)
        if (d < hd) op[d] = o[d] * inv;
}

// ---------------------------------------------------------------------------
// bf16 / fp16: mma.sync m16n8k16, 4 warps, persistent over windows.
// ---------------------------------------------------------------------------

// 2^x on the special-function unit (2^-inf = 0).
__device__ __forceinline__ float ex2(float x) {
    float y;
    asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
    return y;
}

// Shared memory of the 16-bit kernel: the block's bias rows, [rtile][NP + 8]
// f32 (rtile = 64 or 128 query rows: 16 per warp of a window group); then
// per window group the K/V ring, RS slots of [KT][S] K then [KT][S] V, and
// QS slots of [rtile][S] Q.  S = DP + 8 elements (conflict-free ldmatrix).
__host__ __device__ inline int h16_chunks(int n) { return (round16(n) + KT - 1) / KT; }
__host__ __device__ inline int h16_q_slots(int n) { return (RS + h16_chunks(n) - 1) / h16_chunks(n); }
__host__ __device__ inline size_t h16_group_elems(int n, int dp, int rtile) {
    return (size_t)(RS * 2 * KT + h16_q_slots(n) * rtile) * (dp + 8);
}
__host__ __device__ inline size_t h16_smem_bytes(int n, int dp, int rtile, int groups) {
    return (size_t)rtile * (round16(n) + 8) * 4 + groups * h16_group_elems(n, dp, rtile) * 2;
}

// A barrier of one window group's `threads` threads.
__device__ __forceinline__ void group_barrier(int group, int threads) {
    asm volatile("bar.sync %0, %1;\n" ::"r"(group + 1), "r"(threads) : "memory");
}

template <typename T, int DP>
__global__ void __launch_bounds__(DP <= 32 ? H16_THREADS : H16_THREADS / 2)
wattn_h16_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                 const float* __restrict__ bias, const float* __restrict__ mask,
                 const unsigned char* __restrict__ flags, T* __restrict__ out, int windows, int n, int heads, int hd,
                 long long ld, long long wstride, int nw, float scale, int vb, int rtile, int nchunks) {
    using HT = Half16<T>;
    constexpr int S = DP + 8;  // row stride in elements
    extern __shared__ __align__(16) unsigned char smem[];
    const int NP = round16(n);
    const int BP = NP + 8;
    const int NC = h16_chunks(n);
    const int QS = h16_q_slots(n);
    // the block: one head, one tile of rtile query rows; its groups of rtile
    // / 16 warps each walk windows of their own: chunk, chunk + nchunks, ...
    const int gthreads = rtile * 2;  // 16 rows a warp
    const int tid = threadIdx.x % gthreads, group = threadIdx.x / gthreads;
    const int groups = blockDim.x / gthreads;
    float* bsm = reinterpret_cast<float*>(smem);
    T* ring = reinterpret_cast<T*>(smem + (size_t)rtile * BP * 4) + group * h16_group_elems(n, DP, rtile);
    T* qsm = ring + RS * 2 * KT * S;

    const int ncombo = heads * ((NP + rtile - 1) / rtile);
    const int combo = blockIdx.x % ncombo, chunk = (blockIdx.x / ncombo) * groups + group;
    const int h = combo % heads, rt = combo / heads;
    const int row0 = rt * rtile;                      // the block's first query row
    const int my_windows = chunk < windows ? (windows - chunk + nchunks - 1) / nchunks : 0;
    const int F = my_windows * NC;                    // 64-key chunks this group walks

    // chunk f of the block's sequence into its ring slot; a window's Q rows
    // with its first chunk
    auto load_chunk = [&](int f) {
        if (f >= F) return;
        const int wi = f / NC, c = f % NC;
        const size_t base = (size_t)(chunk + wi * nchunks) * wstride + (size_t)h * hd;
        const int key0 = c * KT;
        const int rows = min(KT, NP - key0), live = max(0, min(rows, n - key0));
        T* ks = ring + (f % RS) * 2 * KT * S;
        stage<T>(ks, k + base + (size_t)key0 * ld, live, rows, hd, DP, S, ld, vb, tid, gthreads);
        stage<T>(ks + KT * S, v + base + (size_t)key0 * ld, live, rows, hd, DP, S, ld, vb, tid, gthreads);
        if (c == 0) {
            const int qrows = min(rtile, NP - row0), qlive = max(0, min(qrows, n - row0));
            stage<T>(qsm + (wi % QS) * rtile * S, q + base + (size_t)row0 * ld, qlive, qrows, hd, DP, S, ld, vb, tid,
                     gthreads);
        }
    };

#pragma unroll 1
    for (int f = 0; f < RS - 1; ++f) {
        load_chunk(f);
        cp_async_commit();
    }

    // The accumulators of Q K^T start from (bias + mask) / scale, so that
    // they hold the scores over scale; the softmax multiplies by scale *
    // log2(e) inside the fma that subtracts the max, ready for ex2.  This
    // needs scale > 0 (the wrapper arranges it).
    const float inv_scale = 1.f / scale;
    const float scale_log2e = scale * 1.4426950408889634f;

    // the block's bias rows over scale, zero past n
    {
        const float* bh = bias + ((size_t)h * n + row0) * n;
        for (int i = threadIdx.x; i < rtile * NP; i += blockDim.x) {
            const int r = i / NP, col = i % NP;
            bsm[r * BP + col] = (row0 + r < n && col < n) ? bh[(size_t)r * n + col] * inv_scale : 0.f;
        }
    }

    __syncthreads();  // the bias rows are in place

    const int warp = tid >> 5;
    const int lane = tid & 31;
    const int g = lane >> 2, t4 = lane & 3;
    const int C = heads * hd;
    const bool pairs = (C % 2 == 0) && (hd % 2 == 0);
    const bool vec2 = (n % 2) == 0;
    const bool active = row0 + warp * 16 < NP;  // else: nothing but the barriers
    // accumulator (m16 x n8): lane holds rows g and g + 8, columns t4 * 2 and + 1
    const int rl0 = warp * 16 + g, rl1 = rl0 + 8;  // within the block's tile
    const int r0 = row0 + rl0, r1 = row0 + rl1;    // within the window

    uint32_t qa[DP / 16][4];
    float o[DP / 8][4];
    float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;
    const float* mw = nullptr;
    int w = 0;

    int wi = 0, c = 0;
#pragma unroll 1
    for (int f = 0; f < F; ++f) {
        cp_async_wait<RS - 2>();  // this thread's pieces of chunk f have landed
        group_barrier(group, gthreads);  // every thread's; and every warp of the group is done with chunk f - 1
        load_chunk(f + RS - 1);   // into the slot of chunk f - 1
        cp_async_commit();

        if (active) {
            const T* ks = ring + (f % RS) * 2 * KT * S;
            const T* vs = ks + KT * S;
            if (c == 0) {
                w = chunk + wi * nchunks;
                mw = nullptr;
                if (mask != nullptr) {
                    const int mi = w % nw;
                    if (flags == nullptr || flags[mi]) mw = mask + (size_t)mi * n * n;
                }
                // A (16 query rows x 16 dims, row-major): lane gives the address of
                // row lane % 16, dims (lane / 16) * 8 ..
                const T* qs = qsm + (wi % QS) * rtile * S;
#pragma unroll
                for (int kk = 0; kk < DP / 16; ++kk)
                    ldmatrix_x4(qa[kk], qs + (warp * 16 + (lane & 15)) * S + kk * 16 + (lane >> 4) * 8);
#pragma unroll
                for (int i = 0; i < DP / 8; ++i)
#pragma unroll
                    for (int e = 0; e < 4; ++e) o[i][e] = 0.f;
                m0 = m1 = -INFINITY;
                l0 = l1 = 0.f;
            }
            const int kc = c * KT;
            const int nk = min(KT, NP - kc);  // a multiple of 16
            // The accumulators start from (bias + mask) / scale.  Every load is
            // unconditional (rows and columns past the end are clamped; what
            // they give is never used), and the mask goes straight into the
            // accumulator registers, so that all of a chunk's mask loads are
            // in flight at once before the first product needs them.
            float s[KT / 8][4];
            if (mw != nullptr) {
                const float* m0p = mw + (size_t)min(r0, n - 1) * n;
                const float* m1p = mw + (size_t)min(r1, n - 1) * n;
                if (vec2) {  // n even: 8-byte loads
#pragma unroll
                    for (int t = 0; t < KT / 8; ++t) {
                        const int col = min(kc + t * 8 + t4 * 2, n - 2);
                        const float2 k0 = *reinterpret_cast<const float2*>(m0p + col);
                        const float2 k1 = *reinterpret_cast<const float2*>(m1p + col);
                        s[t][0] = k0.x;
                        s[t][1] = k0.y;
                        s[t][2] = k1.x;
                        s[t][3] = k1.y;
                    }
                } else {
#pragma unroll
                    for (int t = 0; t < KT / 8; ++t) {
                        const int col = kc + t * 8 + t4 * 2;
                        const int ca = min(col, n - 1), cb = min(col + 1, n - 1);
                        s[t][0] = m0p[ca];
                        s[t][1] = m0p[cb];
                        s[t][2] = m1p[ca];
                        s[t][3] = m1p[cb];
                    }
                }
#pragma unroll
                for (int t = 0; t < KT / 8; ++t) {
                    const int col = min(kc + t * 8 + t4 * 2, NP - 2);
                    const float2 b0 = *reinterpret_cast<const float2*>(bsm + rl0 * BP + col);
                    const float2 b1 = *reinterpret_cast<const float2*>(bsm + rl1 * BP + col);
                    s[t][0] = fmaf(s[t][0], inv_scale, b0.x);
                    s[t][1] = fmaf(s[t][1], inv_scale, b0.y);
                    s[t][2] = fmaf(s[t][2], inv_scale, b1.x);
                    s[t][3] = fmaf(s[t][3], inv_scale, b1.y);
                }
            } else {
#pragma unroll
                for (int t = 0; t < KT / 8; ++t) {
                    const int col = min(kc + t * 8 + t4 * 2, NP - 2);
                    const float2 b0 = *reinterpret_cast<const float2*>(bsm + rl0 * BP + col);
                    const float2 b1 = *reinterpret_cast<const float2*>(bsm + rl1 * BP + col);
                    s[t][0] = b0.x;
                    s[t][1] = b0.y;
                    s[t][2] = b1.x;
                    s[t][3] = b1.y;
                }
            }
            // S = Q K^T.  B (16 dims x 8 keys, "col"): K rows are keys, so a
            // non-transposed ldmatrix gives it; lane gives the address of key
            // (lane & 7) + (lane / 16) * 8, dims ((lane / 8) & 1) * 8 ..
#pragma unroll
            for (int j = 0; j < KT / 16; ++j) {
                if (j * 16 < nk) {
#pragma unroll
                    for (int kk = 0; kk < DP / 16; ++kk) {
                        uint32_t b[4];
                        ldmatrix_x4(b, ks + (j * 16 + (lane & 7) + ((lane >> 4) << 3)) * S + kk * 16 +
                                           ((lane >> 3) & 1) * 8);
                        HT::mma(s[2 * j], qa[kk], b[0], b[1]);
                        HT::mma(s[2 * j + 1], qa[kk], b[2], b[3]);
                    }
                }
            }
            // -inf past the last key: only a window's last chunk can have such
            // columns, and only where n is no multiple of 64
            if (kc + KT > n) {
#pragma unroll
                for (int t = 0; t < KT / 8; ++t) {
                    const int col = kc + t * 8 + t4 * 2;
                    if (col >= n) s[t][0] = s[t][2] = -INFINITY;
                    if (col + 1 >= n) s[t][1] = s[t][3] = -INFINITY;
                }
            }
            // the running max stays in the accumulators' domain (scale > 0);
            // 2^((s - max) * scale * log2(e)) is one fma and one ex2
            float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
            for (int t = 0; t < KT / 8; ++t) {
                mx0 = fmaxf(mx0, fmaxf(s[t][0], s[t][1]));
                mx1 = fmaxf(mx1, fmaxf(s[t][2], s[t][3]));
            }
            // the four lanes of a quad hold one row
#pragma unroll
            for (int off = 1; off < 4; off <<= 1) {
                mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
                mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
            }
            // column 0 lies in the first chunk, so the running max is finite
            const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
            const float e0 = ex2((m0 - mn0) * scale_log2e), e1 = ex2((m1 - mn1) * scale_log2e);
            const float neg0 = -mn0 * scale_log2e, neg1 = -mn1 * scale_log2e;
            m0 = mn0;
            m1 = mn1;
            l0 *= e0;
            l1 *= e1;
            if (c > 0) {  // a window's first chunk finds O zero
#pragma unroll
                for (int i = 0; i < DP / 8; ++i) {
                    o[i][0] *= e0;
                    o[i][1] *= e0;
                    o[i][2] *= e1;
                    o[i][3] *= e1;
                }
            }
#pragma unroll
            for (int t = 0; t < KT / 8; ++t) {
                s[t][0] = ex2(fmaf(s[t][0], scale_log2e, neg0));
                s[t][1] = ex2(fmaf(s[t][1], scale_log2e, neg0));
                s[t][2] = ex2(fmaf(s[t][2], scale_log2e, neg1));
                s[t][3] = ex2(fmaf(s[t][3], scale_log2e, neg1));
                l0 += s[t][0] + s[t][1];
                l1 += s[t][2] + s[t][3];
            }
            // O += P V.  The accumulator layout of two n8 score tiles is the
            // A fragment of one k16 step; B (16 keys x 8 dims) is V stored
            // key-major, read with ldmatrix.trans: lane gives the address of
            // key lane % 16, dims (lane / 16) * 8 .. of a pair of n8 tiles
#pragma unroll
            for (int j = 0; j < KT / 16; ++j) {
                if (j * 16 < nk) {
                    const uint32_t pa[4] = {HT::pack(s[2 * j][0], s[2 * j][1]), HT::pack(s[2 * j][2], s[2 * j][3]),
                                            HT::pack(s[2 * j + 1][0], s[2 * j + 1][1]),
                                            HT::pack(s[2 * j + 1][2], s[2 * j + 1][3])};
#pragma unroll
                    for (int np = 0; np < DP / 16; ++np) {
                        uint32_t b[4];
                        ldmatrix_x4_trans(b, vs + (j * 16 + (lane & 15)) * S + np * 16 + (lane >> 4) * 8);
                        HT::mma(o[2 * np], pa, b[0], b[1]);
                        HT::mma(o[2 * np + 1], pa, b[2], b[3]);
                    }
                }
            }

            if (c == NC - 1) {
#pragma unroll
                for (int off = 1; off < 4; off <<= 1) {
                    l0 += __shfl_xor_sync(0xffffffffu, l0, off);
                    l1 += __shfl_xor_sync(0xffffffffu, l1, off);
                }
                const float i0 = 1.f / l0, i1 = 1.f / l1;
                T* ow = out + (size_t)w * n * C + (size_t)h * hd;
#pragma unroll
                for (int nt = 0; nt < DP / 8; ++nt) {
                    const int d = nt * 8 + t4 * 2;
                    if (d >= hd) continue;
#pragma unroll
                    for (int half = 0; half < 2; ++half) {
                        const int row = half ? r1 : r0;
                        if (row >= n) continue;
                        const float inv = half ? i1 : i0;
                        const float a0 = o[nt][2 * half] * inv, a1 = o[nt][2 * half + 1] * inv;
                        T* p = ow + (size_t)row * C + d;
                        if (pairs) {
                            *reinterpret_cast<uint32_t*>(p) = HT::pack(a0, a1);
                        } else {
                            p[0] = HT::from_float(a0);
                            if (d + 1 < hd) p[1] = HT::from_float(a1);
                        }
                    }
                }
            }
        }
        if (++c == NC) {
            c = 0;
            ++wi;
        }
    }
    cp_async_wait<0>();
}

// Widest load (bytes) that every staged row start allows: the pointers, the
// window and token pitches and the head offsets must all be multiples of it.
int pick_vb(const void* q, const void* k, const void* v, long long ld, long long wstride, int hd, int es) {
    const uintptr_t a = reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
                        reinterpret_cast<uintptr_t>(v) | static_cast<uintptr_t>(ld * es) |
                        static_cast<uintptr_t>(wstride * es) | static_cast<uintptr_t>(hd * es);
    for (int vb = 16; vb > es; vb >>= 1)
        if (a % vb == 0) return vb;
    return es;
}

int head_pad(int hd) { return hd <= 16 ? 16 : (hd <= 32 ? 32 : 64); }

bool bad_shape(const void* bias, int windows, int n, int heads, int hd, long long ld, long long wstride, int nw) {
    return bias == nullptr || windows <= 0 || n < 1 || n > MAX_N || heads < 1 || hd < 1 || hd > MAX_HD ||
           ld < (long long)heads * hd || wstride < (long long)n * ld || nw < 1 || windows % nw != 0 ||
           (long long)windows * heads > 0x7fffffffLL;
}

int num_sms() {
    static int sms = 0;
    if (sms == 0) {
        int dev = 0;
        cudaGetDevice(&dev);
        cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    }
    return sms;
}

template <int DP>
cudaError_t launch_f32(const void* q, const void* k, const void* v, const void* bias, const void* mask, void* out,
                       int windows, int n, int heads, int hd, long long ld, long long wstride, int nw, float scale,
                       cudaStream_t stream) {
    const size_t smem = (size_t)2 * round16(n) * DP * sizeof(float);
    cudaError_t err = cudaFuncSetAttribute(wattn_f32_kernel<DP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           (int)smem);
    if (err != cudaSuccess) return err;
    const int threads = (n + 31) / 32 * 32;
    const int vb = pick_vb(q, k, v, ld, wstride, hd, 4);
    wattn_f32_kernel<DP><<<windows * heads, threads, smem, stream>>>(
        static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
        static_cast<const float*>(bias), static_cast<const float*>(mask), static_cast<float*>(out), n, heads, hd,
        ld, wstride, nw, scale, vb);
    return cudaGetLastError();
}

// The 16-bit kernel's grid: (head, row tile) combinations x as many window
// chunks as keep every block resident at once.
template <typename T, int DP>
cudaError_t launch_h16(const void* q, const void* k, const void* v, const void* bias, const void* mask,
                       const void* flags, void* out, int windows, int n, int heads, int hd, long long ld,
                       long long wstride, int nw, float scale, cudaStream_t stream) {
    // 128-row tiles where a window has more than 64 rows (its K and V are then
    // staged by half as many blocks) and head_dim pads to 32 (measured on an
    // H100 at n 256: faster at head_dim 24, slower at head_dim 12); as many
    // window groups a block as its threads and shared memory hold
    const int max_threads = DP <= 32 ? H16_THREADS : H16_THREADS / 2;
    const int rtile = (round16(n) > 64 && DP == 32) ? 128 : 64;
    int groups = max_threads / (rtile * 2);
    while (groups > 1 && h16_smem_bytes(n, DP, rtile, groups) > (size_t)232448) groups /= 2;
    const size_t smem = h16_smem_bytes(n, DP, rtile, groups);
    auto kernel = wattn_h16_kernel<T, DP>;
    // the attribute and the occupancy of this kernel at this size, asked once
    static size_t known_smem = 0;
    static int known_per_sm = 0;
    if (smem != known_smem) {
        cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
        if (err != cudaSuccess) return err;
        err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&known_per_sm, kernel, groups * rtile * 2, smem);
        if (err != cudaSuccess) return err;
        known_smem = smem;
    }
    const int per_sm = known_per_sm;
    if (per_sm < 1) return cudaErrorInvalidConfiguration;
    const long long ncombo = (long long)heads * ((round16(n) + rtile - 1) / rtile);
    long long per_combo = (long long)num_sms() * per_sm / ncombo;  // blocks of one (head, row tile)
    if (per_combo > (windows + groups - 1) / groups) per_combo = (windows + groups - 1) / groups;
    if (per_combo < 1) per_combo = 1;
    if (ncombo * per_combo > 0x7fffffffLL) return cudaErrorInvalidValue;
    const int vb = pick_vb(q, k, v, ld, wstride, hd, 2);
    kernel<<<(unsigned)(ncombo * per_combo), groups * rtile * 2, smem, stream>>>(
        static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
        static_cast<const float*>(bias), static_cast<const float*>(mask), static_cast<const unsigned char*>(flags),
        static_cast<T*>(out), windows, n, heads, hd, ld, wstride, nw, scale, vb, rtile, (int)(per_combo * groups));
    return cudaGetLastError();
}

template <typename T>
int launch_h16_any(const void* q, const void* k, const void* v, const void* bias, const void* mask,
                   const void* flags, void* out, int windows, int n, int heads, int hd, long long ld,
                   long long wstride, int nw, float scale, void* stream) {
    // the kernel divides bias and mask by scale and takes maxima of scores over scale, and stages rows
    // with cp.async copies of at least 4 bytes
    if (bad_shape(bias, windows, n, heads, hd, ld, wstride, nw) || !(scale > 0.f) || !isfinite(scale) ||
        pick_vb(q, k, v, ld, wstride, hd, 2) < 4)
        return (int)cudaErrorInvalidValue;
    const cudaStream_t s = static_cast<cudaStream_t>(stream);
    switch (head_pad(hd)) {
        case 16:
            return (int)launch_h16<T, 16>(q, k, v, bias, mask, flags, out, windows, n, heads, hd, ld, wstride, nw,
                                          scale, s);
        case 32:
            return (int)launch_h16<T, 32>(q, k, v, bias, mask, flags, out, windows, n, heads, hd, ld, wstride, nw,
                                          scale, s);
        default:
            return (int)launch_h16<T, 64>(q, k, v, bias, mask, flags, out, windows, n, heads, hd, ld, wstride, nw,
                                          scale, s);
    }
}

}  // namespace

// Plain C entry points (loaded with ctypes).  `ld` and `wstride` are the
// token and window pitches of q, k and v in elements; `mask` may be null;
// `flags` (16-bit kernels) is null or one byte per mask window, zero where
// the window's mask tile is all zero.  Each launches on `stream` and returns
// cudaGetLastError() right after the launch (0 = launched).
extern "C" int resselt_window_attn_f32(const void* q, const void* k, const void* v, const void* bias,
                                       const void* mask, void* out, int windows, int n, int heads, int hd,
                                       long long ld, long long wstride, int nw, float scale, void* stream) {
    if (bad_shape(bias, windows, n, heads, hd, ld, wstride, nw)) return (int)cudaErrorInvalidValue;
    const cudaStream_t s = static_cast<cudaStream_t>(stream);
    switch (head_pad(hd)) {
        case 16: return (int)launch_f32<16>(q, k, v, bias, mask, out, windows, n, heads, hd, ld, wstride, nw, scale, s);
        case 32: return (int)launch_f32<32>(q, k, v, bias, mask, out, windows, n, heads, hd, ld, wstride, nw, scale, s);
        default: return (int)launch_f32<64>(q, k, v, bias, mask, out, windows, n, heads, hd, ld, wstride, nw, scale, s);
    }
}

extern "C" int resselt_window_attn_bf16(const void* q, const void* k, const void* v, const void* bias,
                                        const void* mask, const void* flags, void* out, int windows, int n,
                                        int heads, int hd, long long ld, long long wstride, int nw, float scale,
                                        void* stream) {
    return launch_h16_any<__nv_bfloat16>(q, k, v, bias, mask, flags, out, windows, n, heads, hd, ld, wstride, nw,
                                         scale, stream);
}

extern "C" int resselt_window_attn_f16(const void* q, const void* k, const void* v, const void* bias,
                                       const void* mask, const void* flags, void* out, int windows, int n,
                                       int heads, int hd, long long ld, long long wstride, int nw, float scale,
                                       void* stream) {
    return launch_h16_any<__half>(q, k, v, bias, mask, flags, out, windows, n, heads, hd, ld, wstride, nw, scale,
                                  stream);
}
