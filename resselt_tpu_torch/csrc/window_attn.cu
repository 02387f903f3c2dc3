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
// output is contiguous (B, N, C).  Takes every N >= 1 and head_dim >= 1, as
// the TPU kernel does, on five kernels (resselt_window_attn_route names the
// one a shape takes):
//
//  * N <= 256 and head_dim <= 64, the window transformers' shapes: tokens
//    padded to a multiple of 16 and head_dim to 16, 32 or 64 inside the
//    kernel (zero in shared memory, -inf in the padded score columns).
//    - f32: exact f32 FMA on the CUDA cores (no TF32), one block per
//      (window, head).  K_h and V_h are staged in shared memory; each
//      thread owns one query row, keeps q (scaled in f32) and its output
//      row in registers, and walks the keys in steps of 16 with a running
//      max and sum.  With the next kernel, the first pair.
//    - bf16 / fp16 at N <= 64 (SwinIR, FDAT, OmniSR, FlexNet): mma.sync
//      m16n8k16 with f32 accumulation, persistent blocks; "the first 16-bit
//      kernel" below.  One template over the 16-bit type, as every 16-bit
//      kernel here.
//    - bf16 / fp16 at 64 < N <= 256 (HAT, ATD, DAT, RGT, DRCT): wgmma, a
//      producer warpgroup and two consumer warpgroups; "the wgmma kernel"
//      below.
//  * Any other N or head_dim (DRCT's heads of 77 and 122, FlexNet's one
//    wide head, windows of more than 256 tokens): the "any" kernels, at the
//    end of the file.  Their limits came from holding a whole head in
//    registers (head_dim 64 already takes 186 registers at 256 threads) and
//    a whole block of bias rows in shared memory (135 KB of f32 at N 256),
//    so they hold neither: the keys go in chunks with an online softmax,
//    the bias and mask are read per key chunk from L2 into the score
//    registers, and the head runs in slices.  Q K^T accumulates over
//    head-dim steps of 64 (Q and K staged a step at a time); the P V
//    accumulator is kept per output slice, one block for each (window,
//    head, 64 query rows, output slice) that recomputes the scores and its
//    own softmax statistics.  A slice is 64 columns, or 128 where head_dim
//    is above 64, so every head of the models (up to 128) is one slice:
//    keeping the accumulator in shared memory instead would cost a round
//    trip of O per key chunk, and a statistics pass would cost a second
//    Q K^T per head where the slices cost none below 128.
//
// What bounds it on an H100: bytes from device memory by the book (at
// SwinIR-M's bench shape, 16,384 windows of 64 tokens, C 180, 6 heads, one
// launch moves 4 x 377 MB against 48 GFLOP), but what a (window, head) block
// of the first design really waited for was L2: it read its own f32 bias
// tile and mask tile per window, 256 KB + 256 KB at n = 256 against 36 KB of
// q, k and v.  What the first 16-bit kernel does about that:
//  * The bias is read once per block.  A block owns one head and one tile
//    of query rows (64 rows), keeps that slice of bias[h], divided by scale,
//    in shared memory (18 KB at n = 64) and never reads bias again.  The
//    grid is as many blocks as the card holds at once.
//  * A block is up to 16 warps in window groups: a group is the 4 warps of
//    one row tile (16 rows a warp) and walks windows of its own, w = chunk,
//    chunk + nchunks, ...; the block's groups share the bias rows and
//    nothing else, and meet at a named barrier of their own.  So 16 warps
//    an SM hide each other's mma.sync, shuffle and exp latencies.  The
//    blocks of one window's heads are neighbours and walk the windows in
//    step, so K and V come from L2.
//  * Windows whose mask tile is all zero skip the mask: `flags` (one byte
//    per mask window, computed once per mask tensor by the caller) says
//    which tiles hold a non-zero value; adding 0.0f is exact.  Of a Swin
//    shift mask only the last row and column of windows are non-zero.  The
//    wgmma kernel does the same.
//  * K, V and Q arrive ahead of the math: a group's windows go through a
//    ring of 3 shared-memory slots, each window a cp.async group started
//    two windows ahead.  One group barrier per window: it publishes the
//    window that has landed and frees the slot of the window before.  Rows
//    are staged with the widest cp.async copies (16, 8
//    or 4 bytes) that the pointers, the pitches and head_dim allow; rows
//    that are only 2-byte aligned (an odd head_dim) are refused, and the
//    caller (ops/window_attention.py) hands such heads over zero-padded to
//    a multiple of 8 elements.  The wgmma kernel stages the same way.
//  * Per window a warp starts its score accumulators from (bias + mask) /
//    scale (the mask's 8-byte loads go straight into the accumulator
//    registers, unconditional and all in flight at once; the bias comes from
//    shared memory, conflict-free at a row pitch of n + 8 floats), adds
//    Q K^T on the tensor cores, multiplies once by scale * log2(e), runs a
//    softmax in base 2 (ex2 on the special-function unit) in f32, and
//    multiplies P, rounded to the 16-bit type, by V.  The scores never
//    leave registers.  scale must be positive.
// ptxas (sm_90a): head_dim <= 32 is held to 128 registers by its 512
// threads and spills 8 bytes; head_dim 64 (256 threads) takes 186 and
// spills 4.  What this leaves on the table, and why HAT-S's bench shape was
// 7-17% behind cuDNN's fused attention: mma.sync instead of wgmma, with
// every step of the chain (products, quad shuffles, ex2, the second
// products) waiting on the one before inside a warp; the same warps start
// the cp.async copies and do the math, so the copies' cycles are not
// hidden; O is stored from registers in 4-byte pieces (staging it through
// shared memory measured 4% better at head_dim 24 and worse at 30 and 12 on
// an H100, so it is not done).
//
// The wgmma kernel.  At N 256 the first 16-bit kernel's bias slice (then
// 128 rows, 135 KB) left room for one block of 8-16 warps an SM, every
// warp chaining its own mma.sync, shuffles and ex2; and a served DRCT-L
// launch has 81 windows, so a window group walked only 4-8 of them and the
// bias reuse bought little.  DRCT-L's pair launches ran at 5-9% of their
// bound.  The wgmma kernel instead:
//  * A block owns one (head, 64-row tile of queries) and walks windows w =
//    bc, bc + nblk, ...; the grid is one block an SM.  Its bias rows over
//    scale (64 x (KEYS + 8) f32, 66 KB at N 256; KEYS = N padded to 128 or
//    256) are loaded by the consumers in 16-byte pieces while the producer
//    stages the first windows.
//  * Warp-specialised, three warpgroups.  The producer (setmaxnreg 40):
//    warps 8-9 stage each window's 64 Q rows and its K, warps 10-11 its V,
//    by cp.async into two stages, one per consumer warpgroup, with a full
//    and an empty mbarrier per stage for Q + K and for V, so that Q and K
//    are refilled as soon as the consumer's Q K^T is done and V after its
//    P V.  q, k and v stay read in place from the projection: DRCT's token
//    pitches (1,080 and 1,656 bytes) rule out the tensor copies, and its
//    heads of 60 and 92 bytes allow 4-byte copies at most.  A few lanes take
//    a row (4 for 4-byte copies, else 8), side by side, and each walks the
//    row's groups of 8 columns at fixed offsets, a copy an instruction: a
//    lane a piece and a loop iteration a row took three times the
//    instructions, and the producer set the pace (DRCT-L's swin4 83 us a
//    launch against 57 on an H100).
//  * The two consumer warpgroups (setmaxnreg 232) take alternate windows
//    and take turns at the tensor cores, kept by two named barriers:
//    consumer 0 issues its window's Q K^T, consumer 1 its own, consumer 0
//    its P V, consumer 1 its own, ...; one's softmax and epilogue run under
//    the other's products.  Each window is straight-line code from its
//    products to their wait: a branch between them made ptxas serialise the
//    wgmmas (C7515).
//  * S = Q K^T by wgmma m64nKEYSk16, A and B K-major from shared memory
//    without swizzle: Q, K and V are stored [group of 8 columns][row][8],
//    a group one row pitch and 16 bytes past the one before, so that the
//    pieces of a row land in different banks.  The accumulators start from
//    (bias + mask) / scale; the mask's loads (only where `flags` marks the
//    tile) go out before the waits for the stage and the turn and are
//    taken up after them.
//  * One exact softmax pass a window: -inf past N, each row's max over all
//    its keys (a quad of lanes holds a row), 2^((s - max) scale log2(e)) by
//    one fma and one ex2 a score, the row sums in f32.  All of a row's
//    scores are in registers, so no running max or rescale is needed.
//  * O = P V by wgmma m64nDPk16: P, rounded to the 16-bit type, is the
//    register A operand (the accumulators of two neighbouring n8 column
//    groups are the A fragment of one k16 step), and V is B, MN-major
//    (transposed) from the same shared-memory layout.  O is normalised and
//    stored from registers in 4-byte pieces.
// ptxas (sm_90a): 168 registers a thread at launch (384 threads, one block
// an SM), the consumers' branch up to 232 and the producer's 40 after
// setmaxnreg; 0 bytes of spills in all 16 instantiations (bf16 / fp16, DP
// 16 / 32 / 48 / 64, KEYS 128 / 256).  What it leaves (an H100 at 700 W,
// DRCT-L's served launches at 24-27% of their bound, 11% at swin2's
// heads padded to 56): the copies (a copy of the kernel that staged
// nothing ran swin4 unmasked in 35 us against 57), then the consumers'
// instruction stream, two warps an SM sub-partition (leaving out the ex2
// and the fma before it as well: 28 us against 40); the tensor cores are
// idle most of the time (leaving out the products changed nothing).
// Taking turns measured the same as running free (within 2%).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "async_copy.cuh"
#include "half16.cuh"
#include "wgmma.cuh"

namespace {

constexpr int MAX_N = 256;
constexpr int MAX_HD = 64;
constexpr int H16_THREADS = 512;  // at most, per block (first 16-bit kernel): 16 warps in window groups of 4
constexpr int KT = 64;   // tokens a window at most, and rows of a ring slot (first 16-bit kernel)
constexpr int RS = 3;    // ring slots per window group (first 16-bit kernel)
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

// Shared memory of the first 16-bit kernel: the block's bias rows, [KT][NP +
// 8] f32; then per window group a ring of RS slots, each one window's
// [KT][S] K, [KT][S] V, and after the ring's K and V, RS slots of [KT][S] Q.
// S = DP + 8 elements (conflict-free ldmatrix).
__host__ __device__ inline size_t h16_group_elems(int dp) { return (size_t)RS * 3 * KT * (dp + 8); }
__host__ __device__ inline size_t h16_smem_bytes(int n, int dp, int groups) {
    return (size_t)KT * (round16(n) + 8) * 4 + groups * h16_group_elems(dp) * 2;
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
                 long long ld, long long wstride, int nw, float scale, int vb, int nchunks) {
    using HT = Half16<T>;
    constexpr int S = DP + 8;        // row stride in elements
    constexpr int GTHREADS = KT * 2;  // a window group: 4 warps of 16 rows
    extern __shared__ __align__(16) unsigned char smem[];
    const int NP = round16(n);
    const int BP = NP + 8;
    // the block: one head; its groups each walk windows of their own:
    // chunk, chunk + nchunks, ...
    const int tid = threadIdx.x % GTHREADS, group = threadIdx.x / GTHREADS;
    const int groups = blockDim.x / GTHREADS;
    float* bsm = reinterpret_cast<float*>(smem);
    T* ring = reinterpret_cast<T*>(smem + (size_t)KT * BP * 4) + group * h16_group_elems(DP);
    T* qsm = ring + RS * 2 * KT * S;

    const int h = blockIdx.x % heads, chunk = (blockIdx.x / heads) * groups + group;
    const int F = chunk < windows ? (windows - chunk + nchunks - 1) / nchunks : 0;  // windows this group walks

    // the group's f-th window (K, V and Q) into its ring slot
    auto load_window = [&](int f) {
        if (f >= F) return;
        const size_t base = (size_t)(chunk + f * nchunks) * wstride + (size_t)h * hd;
        T* ks = ring + (f % RS) * 2 * KT * S;
        stage<T>(ks, k + base, n, NP, hd, DP, S, ld, vb, tid, GTHREADS);
        stage<T>(ks + KT * S, v + base, n, NP, hd, DP, S, ld, vb, tid, GTHREADS);
        stage<T>(qsm + (f % RS) * KT * S, q + base, n, NP, hd, DP, S, ld, vb, tid, GTHREADS);
    };

#pragma unroll 1
    for (int f = 0; f < RS - 1; ++f) {
        load_window(f);
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
        const float* bh = bias + (size_t)h * n * n;
        for (int i = threadIdx.x; i < KT * NP; i += blockDim.x) {
            const int r = i / NP, col = i % NP;
            bsm[r * BP + col] = (r < n && col < n) ? bh[(size_t)r * n + col] * inv_scale : 0.f;
        }
    }

    __syncthreads();  // the bias rows are in place

    const int warp = tid >> 5;
    const int lane = tid & 31;
    const int g = lane >> 2, t4 = lane & 3;
    const int C = heads * hd;
    const bool pairs = (C % 2 == 0) && (hd % 2 == 0);
    const bool vec2 = (n % 2) == 0;
    const bool active = warp * 16 < NP;  // else: nothing but the barriers
    // accumulator (m16 x n8): lane holds rows g and g + 8, columns t4 * 2 and + 1
    const int r0 = warp * 16 + g, r1 = r0 + 8;

#pragma unroll 1
    for (int f = 0; f < F; ++f) {
        cp_async_wait<RS - 2>();  // this thread's pieces of window f have landed
        group_barrier(group, GTHREADS);  // every thread's; and every warp of the group is done with window f - 1
        load_window(f + RS - 1);   // into the slot of window f - 1
        cp_async_commit();
        if (!active) continue;

        const T* ks = ring + (f % RS) * 2 * KT * S;
        const T* vs = ks + KT * S;
        const int w = chunk + f * nchunks;
        const float* mw = nullptr;
        if (mask != nullptr) {
            const int mi = w % nw;
            if (flags == nullptr || flags[mi]) mw = mask + (size_t)mi * n * n;
        }
        // A (16 query rows x 16 dims, row-major): lane gives the address of
        // row lane % 16, dims (lane / 16) * 8 ..
        uint32_t qa[DP / 16][4];
        const T* qs = qsm + (f % RS) * KT * S;
#pragma unroll
        for (int kk = 0; kk < DP / 16; ++kk)
            ldmatrix_x4(qa[kk], qs + (warp * 16 + (lane & 15)) * S + kk * 16 + (lane >> 4) * 8);
        // The accumulators start from (bias + mask) / scale.  Every load is
        // unconditional (rows and columns past the end are clamped; what
        // they give is never used), and the mask goes straight into the
        // accumulator registers, so that all of a window's mask loads are
        // in flight at once before the first product needs them.
        float s[KT / 8][4];
        if (mw != nullptr) {
            const float* m0p = mw + (size_t)min(r0, n - 1) * n;
            const float* m1p = mw + (size_t)min(r1, n - 1) * n;
            if (vec2) {  // n even: 8-byte loads
#pragma unroll
                for (int t = 0; t < KT / 8; ++t) {
                    const int col = min(t * 8 + t4 * 2, n - 2);
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
                    const int col = t * 8 + t4 * 2;
                    const int ca = min(col, n - 1), cb = min(col + 1, n - 1);
                    s[t][0] = m0p[ca];
                    s[t][1] = m0p[cb];
                    s[t][2] = m1p[ca];
                    s[t][3] = m1p[cb];
                }
            }
#pragma unroll
            for (int t = 0; t < KT / 8; ++t) {
                const int col = min(t * 8 + t4 * 2, NP - 2);
                const float2 b0 = *reinterpret_cast<const float2*>(bsm + r0 * BP + col);
                const float2 b1 = *reinterpret_cast<const float2*>(bsm + r1 * BP + col);
                s[t][0] = fmaf(s[t][0], inv_scale, b0.x);
                s[t][1] = fmaf(s[t][1], inv_scale, b0.y);
                s[t][2] = fmaf(s[t][2], inv_scale, b1.x);
                s[t][3] = fmaf(s[t][3], inv_scale, b1.y);
            }
        } else {
#pragma unroll
            for (int t = 0; t < KT / 8; ++t) {
                const int col = min(t * 8 + t4 * 2, NP - 2);
                const float2 b0 = *reinterpret_cast<const float2*>(bsm + r0 * BP + col);
                const float2 b1 = *reinterpret_cast<const float2*>(bsm + r1 * BP + col);
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
            if (j * 16 < NP) {
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
        // -inf past the last key (only where n is no multiple of 64)
        if (KT > n) {
#pragma unroll
            for (int t = 0; t < KT / 8; ++t) {
                const int col = t * 8 + t4 * 2;
                if (col >= n) s[t][0] = s[t][2] = -INFINITY;
                if (col + 1 >= n) s[t][1] = s[t][3] = -INFINITY;
            }
        }
        // the max stays in the accumulators' domain (scale > 0);
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
        const float neg0 = -mx0 * scale_log2e, neg1 = -mx1 * scale_log2e;
        float l0 = 0.f, l1 = 0.f;
#pragma unroll
        for (int t = 0; t < KT / 8; ++t) {
            s[t][0] = ex2(fmaf(s[t][0], scale_log2e, neg0));
            s[t][1] = ex2(fmaf(s[t][1], scale_log2e, neg0));
            s[t][2] = ex2(fmaf(s[t][2], scale_log2e, neg1));
            s[t][3] = ex2(fmaf(s[t][3], scale_log2e, neg1));
            l0 += s[t][0] + s[t][1];
            l1 += s[t][2] + s[t][3];
        }
        // O = P V.  The accumulator layout of two n8 score tiles is the A
        // fragment of one k16 step; B (16 keys x 8 dims) is V stored
        // key-major, read with ldmatrix.trans: lane gives the address of key
        // lane % 16, dims (lane / 16) * 8 .. of a pair of n8 tiles
        float o[DP / 8][4];
#pragma unroll
        for (int i = 0; i < DP / 8; ++i)
#pragma unroll
            for (int e = 0; e < 4; ++e) o[i][e] = 0.f;
#pragma unroll
        for (int j = 0; j < KT / 16; ++j) {
            if (j * 16 < NP) {
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
    cp_async_wait<0>();
}

// ---------------------------------------------------------------------------
// bf16 / fp16 at 64 < n <= 256 and head_dim <= 64: wgmma, a producer
// warpgroup and two consumer warpgroups (see the note at the top).  A block
// owns one (head, 64-row tile of queries) and walks windows w = bc, bc +
// nblk, ...; its i-th window goes to consumer warpgroup i % 2 through stage
// i % 2 of shared memory.
// ---------------------------------------------------------------------------

constexpr int WG_ROWS = 64;        // query rows a block: one m64 tile
constexpr int WG_THREADS = 384;    // consumer warpgroups 0 and 1, then the producer warpgroup
constexpr int WG_LOADER = 64;      // threads of each of the producer's two loaders (Q and K; V)
constexpr int WG_CONSUMERS = 256;  // threads of the two consumer warpgroups
constexpr int BAR_TURN = 1;        // named barrier BAR_TURN + c: consumer warpgroup c's turn at the tensor cores
constexpr int BAR_BIAS = 3;        // named barrier: the consumers' bias rows are in place

// Shared memory of a block at head_dim padded to DP and KC chunks of 64
// keys: the bias rows, [64][KEYS + 8] f32 (over scale, zero past n), then
// two stages of Q [64 rows], K [KEYS rows] and V [KEYS rows], then eight
// mbarriers.  Q, K and V are stored [group of 8 columns][row][8 elements]:
// a row's 16 bytes of one group are one row of a core matrix, and a group
// lies 16 bytes past a whole multiple of rows from the next, so that the
// pieces of one row land in different banks.  Rows and columns past the
// head are zero from the start and never written.
template <int DP, int KC>
struct WgLayout {
    static constexpr int KEYS = KC * 64;
    static constexpr int QGP = WG_ROWS * 16 + 16;  // bytes from one group of 8 columns to the next
    static constexpr int KGP = KEYS * 16 + 16;
    static constexpr int Q_BYTES = DP / 8 * QGP;
    static constexpr int K_BYTES = DP / 8 * KGP;
    static constexpr int STAGE = Q_BYTES + 2 * K_BYTES;
    static constexpr int BP = KEYS + 8;            // floats a bias row: conflict-free float2 reads
    static constexpr int BIAS = WG_ROWS * BP * 4;
    static constexpr int BARS = BIAS + 2 * STAGE;  // qk_full[2], v_full[2], qk_empty[2], v_empty[2]
    static constexpr int SMEM = BARS + 8 * 8;
};

// an arrival on the mbarrier once every cp.async this thread has issued so far has landed
__device__ __forceinline__ void cp_async_arrive(uint32_t bar) {
    asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(bar) : "memory");
}

template <int R>
__device__ __forceinline__ void setmaxnreg_inc() { asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(R)); }
template <int R>
__device__ __forceinline__ void setmaxnreg_dec() { asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(R)); }

// Copies steps K .. NK - 1 of a lane's pieces of one row, those below nk,
// by cp.async of VB bytes at fixed offsets from the row's two addresses (DS
// bytes a step in shared memory, SS in global memory).
template <int VB, int DS, int SS, int K, int NK>
__device__ __forceinline__ void copy_steps(uint32_t dr, const char* sr, int nk) {
    if constexpr (K < NK) {
        if (K < nk)
            asm volatile("cp.async.ca.shared.global [%0+%2], [%1+%3], %4;\n" ::"r"(dr), "l"(sr), "n"(K * DS),
                         "n"(K * SS), "n"(VB));
        copy_steps<VB, DS, SS, K + 1, NK>(dr, sr, nk);
    }
}

// Rows [0, rows) of one head (hd elements at src + row * ld) into a buffer
// of the layout above (GP bytes between groups of 8 columns) at dst, by the
// `nthreads` threads of one loader (index tid), in cp.async copies of VB
// bytes.  LPR lanes take a row, side by side along LPR x VB of its bytes
// (LPR / (16 / VB) groups of 8 columns); a lane then walks the row in steps
// of that many groups at fixed offsets, a copy an instruction, and the warp
// takes 32 / LPR rows at a time.
template <typename T, int VB, int DP, int GP, int LPR>
__device__ __forceinline__ void stage_rows_vec(uint32_t dst, const T* __restrict__ src, long long ld, int rows,
                                               int hd, int tid, int nthreads) {
    constexpr int PG = 16 / VB;     // lanes a group
    constexpr int GPS = LPR / PG;   // groups a step
    const int p = tid % PG, gl = (tid % LPR) / PG;
    const int lead = gl * 16 + p * VB;  // this lane's first byte of a row
    const int nk = (hd * (int)sizeof(T) - lead + GPS * 16 - 1) / (GPS * 16);
    const long long pitch = ld * (long long)sizeof(T);
    const char* sr = reinterpret_cast<const char*>(src) + lead + (tid / LPR) * pitch;
    uint32_t dr = dst + gl * GP + p * VB + (tid / LPR) * 16;
#pragma unroll 1
    for (int r = tid / LPR; r < rows; r += nthreads / LPR) {
        copy_steps<VB, GPS * GP, GPS * 16, 0, (DP / 8 + GPS - 1) / GPS>(dr, sr, nk);
        sr += (nthreads / LPR) * pitch;
        dr += (nthreads / LPR) * 16;
    }
}

template <typename T, int DP, int GP>
__device__ __forceinline__ void stage_rows(uint32_t dst, const T* __restrict__ src, long long ld, int rows, int hd,
                                           int vb, int tid, int nthreads) {
    switch (vb) {
        case 16: stage_rows_vec<T, 16, DP, GP, 8>(dst, src, ld, rows, hd, tid, nthreads); break;
        case 8: stage_rows_vec<T, 8, DP, GP, 8>(dst, src, ld, rows, hd, tid, nthreads); break;
        default: stage_rows_vec<T, 4, DP, GP, 4>(dst, src, ld, rows, hd, tid, nthreads); break;
    }
}

template <typename T, int DP, int KC>
__global__ void __launch_bounds__(WG_THREADS, 1)
wattn_wgmma_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                   const float* __restrict__ bias, const float* __restrict__ mask,
                   const unsigned char* __restrict__ flags, T* __restrict__ out, int windows, int n, int heads, int hd,
                   long long ld, long long wstride, int nw, float scale, int vb, int nblk) {
    using L = WgLayout<DP, KC>;
    using HT = Half16<T>;
    constexpr int KEYS = L::KEYS;
    extern __shared__ __align__(128) unsigned char smem[];
    float* bsm = reinterpret_cast<float*>(smem);
    const uint32_t smem_addr = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
    const auto q_at = [&](int s) { return smem_addr + L::BIAS + s * L::STAGE; };
    const auto k_at = [&](int s) { return q_at(s) + L::Q_BYTES; };
    const auto v_at = [&](int s) { return k_at(s) + L::K_BYTES; };
    const auto qk_full = [&](int s) { return smem_addr + L::BARS + 8 * s; };
    const auto v_full = [&](int s) { return smem_addr + L::BARS + 16 + 8 * s; };
    const auto qk_empty = [&](int s) { return smem_addr + L::BARS + 32 + 8 * s; };
    const auto v_empty = [&](int s) { return smem_addr + L::BARS + 48 + 8 * s; };

    // the block: head h, query rows row0 .. row0 + 63, windows bc, bc + nblk, ...
    const int rtiles = (n + WG_ROWS - 1) / WG_ROWS;
    const int ncombo = heads * rtiles;
    const int combo = blockIdx.x % ncombo, bc = blockIdx.x / ncombo;
    const int h = combo % heads, row0 = (combo / heads) * WG_ROWS;
    const int m = bc < windows ? (windows - bc + nblk - 1) / nblk : 0;
    const int tid = threadIdx.x;
    const float inv_scale = 1.f / scale;

    // full: each loader thread's copies landed; empty: each consumer thread done with the stage's operands
    if (tid == 0) {
        for (int s = 0; s < 2; ++s) {
            mbar_init(qk_full(s), WG_LOADER);
            mbar_init(v_full(s), WG_LOADER);
            mbar_init(qk_empty(s), 128);
            mbar_init(v_empty(s), 128);
        }
        mbar_fence_init();
    }
    // both stages zero
    uint4* z = reinterpret_cast<uint4*>(smem + L::BIAS);
    for (int i = tid; i < 2 * L::STAGE / 16; i += WG_THREADS) z[i] = make_uint4(0u, 0u, 0u, 0u);
    fence_async_shared();
    __syncthreads();

    // the warp from lane 0: uniform in the compiler's eyes, so that no branch
    // around the products reads as divergent
    const int warp = __shfl_sync(0xffffffffu, tid >> 5, 0);
    if (warp >= 8) {
        // the producer: warps 8-9 stage each window's Q rows and K, warps
        // 10-11 its V, a window ahead of the consumer that takes it
        setmaxnreg_dec<40>();
        const int lt = tid - WG_CONSUMERS;
        const bool v_loader = lt >= WG_LOADER;
        const int t = lt % WG_LOADER;
        for (int i = 0; i < m; ++i) {
            const int s = i & 1;
            const uint32_t parity = ((i >> 1) & 1) ^ 1;  // the stage's last use, by window i - 2
            const size_t base = (size_t)(bc + (long long)i * nblk) * wstride + (size_t)h * hd;
            if (!v_loader) {
                mbar_wait(qk_empty(s), parity);
                stage_rows<T, DP, L::QGP>(q_at(s), q + base + (size_t)row0 * ld, ld, min(WG_ROWS, n - row0), hd, vb,
                                          t, WG_LOADER);
                stage_rows<T, DP, L::KGP>(k_at(s), k + base, ld, n, hd, vb, t, WG_LOADER);
                cp_async_arrive(qk_full(s));
            } else {
                mbar_wait(v_empty(s), parity);
                stage_rows<T, DP, L::KGP>(v_at(s), v + base, ld, n, hd, vb, t, WG_LOADER);
                cp_async_arrive(v_full(s));
            }
        }
        asm volatile("cp.async.wait_all;\n" ::: "memory");
    } else {
        setmaxnreg_inc<232>();
        // the block's bias rows over scale, zero past n, while the producer
        // stages the first windows: four columns a thread at a time, 16-byte
        // loads where n is a multiple of 4, all of a thread's in flight
        {
            const float* bh = bias + ((size_t)h * n + row0) * n;
            const bool vec4 = n % 4 == 0;
#pragma unroll
            for (int x = 0; x < WG_ROWS * KEYS / 4 / WG_CONSUMERS; ++x) {
                const int i = tid + x * WG_CONSUMERS;
                const int r = i / (KEYS / 4), col = (i % (KEYS / 4)) * 4;
                const float* br = bh + (size_t)r * n + col;
                float4 b = make_float4(0.f, 0.f, 0.f, 0.f);
                if (row0 + r < n) {
                    if (vec4) {
                        if (col < n) b = *reinterpret_cast<const float4*>(br);
                    } else {
                        b.x = col < n ? br[0] : 0.f;
                        b.y = col + 1 < n ? br[1] : 0.f;
                        b.z = col + 2 < n ? br[2] : 0.f;
                        b.w = col + 3 < n ? br[3] : 0.f;
                    }
                }
                *reinterpret_cast<float4*>(bsm + r * L::BP + col) =
                    make_float4(b.x * inv_scale, b.y * inv_scale, b.z * inv_scale, b.w * inv_scale);
            }
        }
        named_sync(BAR_BIAS, WG_CONSUMERS);
        const int cw = warp >> 2;  // this consumer warpgroup, and its stage
        const int lane = tid & 31, g = lane >> 2, t4 = lane & 3;
        // accumulator (m64 x N): lane holds rows rl0 and rl1 of the tile, of
        // every 8 columns 8 j + 2 t4 and + 1 (wgmma.cuh)
        const int rl0 = (warp & 3) * 16 + g, rl1 = rl0 + 8;
        const int r0 = row0 + rl0, r1 = row0 + rl1;  // within the window
        const float scale_log2e = scale * 1.4426950408889634f;
        const int C = heads * hd;
        const bool vec2 = (n % 2) == 0;
        // Consumer 0 issues window 0's Q K^T, then consumer 1 window 1's,
        // then consumer 0 window 0's P V, consumer 1 window 1's, consumer 0
        // window 2's Q K^T, ...: each one's softmax and epilogue run under
        // the other's products.  Each window is straight-line code from its
        // products to their wait (a branch between them makes ptxas
        // serialize the wgmmas); consumer 1, a window short where the block
        // has an odd count, passes its last two turns on.
        if (cw == 1) named_arrive(BAR_TURN, WG_CONSUMERS);  // consumer 0's first turn
        const int mine = (m - cw + 1) / 2;                  // this consumer's windows: 2 it + cw
#pragma unroll 1
        for (int it = 0; it < mine; ++it) {
            const uint32_t parity = it & 1;
            const long long w = bc + (long long)(2 * it + cw) * nblk;
            // The accumulators start from (bias + mask) / scale, so that they
            // end as the scores over scale (scale > 0).  The mask's loads
            // (only where flags marks the tile) go out first, unconditional
            // (clamped past the end) and all in flight at once, and are
            // taken up with the bias only after the waits for the stage and
            // the turn, which they overlap; without a mask the bias rows are
            // in place before the waits.
            float s[KEYS / 2];
            const float* mw = nullptr;
            if (mask != nullptr) {
                const int mi = (int)(w % nw);
                if (flags == nullptr || flags[mi]) mw = mask + (size_t)mi * n * n;
            }
            if (mw != nullptr) {
                const float* m0p = mw + (size_t)min(r0, n - 1) * n;
                const float* m1p = mw + (size_t)min(r1, n - 1) * n;
                if (vec2) {
#pragma unroll
                    for (int j = 0; j < KEYS / 8; ++j) {
                        const int col = min(j * 8 + t4 * 2, n - 2);
                        const float2 k0 = *reinterpret_cast<const float2*>(m0p + col);
                        const float2 k1 = *reinterpret_cast<const float2*>(m1p + col);
                        s[4 * j] = k0.x;
                        s[4 * j + 1] = k0.y;
                        s[4 * j + 2] = k1.x;
                        s[4 * j + 3] = k1.y;
                    }
                } else {
#pragma unroll
                    for (int j = 0; j < KEYS / 8; ++j) {
                        const int col = j * 8 + t4 * 2;
                        const int ca = min(col, n - 1), cb = min(col + 1, n - 1);
                        s[4 * j] = m0p[ca];
                        s[4 * j + 1] = m0p[cb];
                        s[4 * j + 2] = m1p[ca];
                        s[4 * j + 3] = m1p[cb];
                    }
                }
            } else {
#pragma unroll
                for (int j = 0; j < KEYS / 8; ++j) {
                    const float2 b0 = *reinterpret_cast<const float2*>(bsm + rl0 * L::BP + j * 8 + t4 * 2);
                    const float2 b1 = *reinterpret_cast<const float2*>(bsm + rl1 * L::BP + j * 8 + t4 * 2);
                    s[4 * j] = b0.x;
                    s[4 * j + 1] = b0.y;
                    s[4 * j + 2] = b1.x;
                    s[4 * j + 3] = b1.y;
                }
            }
            mbar_wait(qk_full(cw), parity);
            fence_async_shared();  // the loaders' copies, visible to wgmma
            named_sync(BAR_TURN + cw, WG_CONSUMERS);
            if (mw != nullptr) {
#pragma unroll
                for (int j = 0; j < KEYS / 8; ++j) {
                    const float2 b0 = *reinterpret_cast<const float2*>(bsm + rl0 * L::BP + j * 8 + t4 * 2);
                    const float2 b1 = *reinterpret_cast<const float2*>(bsm + rl1 * L::BP + j * 8 + t4 * 2);
                    s[4 * j] = fmaf(s[4 * j], inv_scale, b0.x);
                    s[4 * j + 1] = fmaf(s[4 * j + 1], inv_scale, b0.y);
                    s[4 * j + 2] = fmaf(s[4 * j + 2], inv_scale, b1.x);
                    s[4 * j + 3] = fmaf(s[4 * j + 3], inv_scale, b1.y);
                }
            }

            // S += Q K^T: A (64 rows x 16 dims) and B (16 dims x KEYS keys)
            // K-major, a k16 step the next two groups of 8 columns
            fence_registers(s);
            wgmma_fence();
#pragma unroll
            for (int kk = 0; kk < DP / 16; ++kk)
                Wgmma<KEYS>::template ss<T>(s, wgmma_desc(q_at(cw) + 2 * kk * L::QGP, L::QGP, 128),
                                            wgmma_desc(k_at(cw) + 2 * kk * L::KGP, L::KGP, 128), 1);
            wgmma_commit();
            named_arrive(BAR_TURN + 1 - cw, WG_CONSUMERS);
            wgmma_wait<0>();
            fence_registers(s);
            mbar_arrive(qk_empty(cw));

            // One exact pass: -inf past the last key, each row's max over all
            // its keys (a quad of lanes holds a row), then 2^((s - max) scale
            // log2(e)) on the special-function unit: one fma and one ex2 a
            // score
            if (KEYS > n) {
#pragma unroll
                for (int j = 0; j < KEYS / 8; ++j) {
                    const int col = j * 8 + t4 * 2;
                    if (col >= n) s[4 * j] = s[4 * j + 2] = -INFINITY;
                    if (col + 1 >= n) s[4 * j + 1] = s[4 * j + 3] = -INFINITY;
                }
            }
            float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
            for (int j = 0; j < KEYS / 8; ++j) {
                mx0 = fmaxf(mx0, fmaxf(s[4 * j], s[4 * j + 1]));
                mx1 = fmaxf(mx1, fmaxf(s[4 * j + 2], s[4 * j + 3]));
            }
#pragma unroll
            for (int off = 1; off < 4; off <<= 1) {
                mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
                mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
            }
            const float neg0 = -mx0 * scale_log2e, neg1 = -mx1 * scale_log2e;
            // P, rounded to T: the A fragment of k16 step ks is the
            // accumulators of column groups 2 ks and 2 ks + 1
            uint32_t pa[KEYS / 16][4];
            float l0 = 0.f, l1 = 0.f;
#pragma unroll
            for (int ks = 0; ks < KEYS / 16; ++ks) {
                float e[8];
#pragma unroll
                for (int x = 0; x < 8; ++x) e[x] = ex2(fmaf(s[8 * ks + x], scale_log2e, (x & 2) ? neg1 : neg0));
                l0 += (e[0] + e[1]) + (e[4] + e[5]);
                l1 += (e[2] + e[3]) + (e[6] + e[7]);
                pa[ks][0] = HT::pack(e[0], e[1]);
                pa[ks][1] = HT::pack(e[2], e[3]);
                pa[ks][2] = HT::pack(e[4], e[5]);
                pa[ks][3] = HT::pack(e[6], e[7]);
            }
            mbar_wait(v_full(cw), parity);
            fence_async_shared();

            // O = P V: B (16 keys x DP dims) is V stored key-major, MN-major
            // for wgmma (8 keys 128 bytes apart, groups of 8 dims a group
            // pitch apart)
            float o[DP / 2];
#pragma unroll
            for (int x = 0; x < DP / 2; ++x) o[x] = 0.f;
            named_sync(BAR_TURN + cw, WG_CONSUMERS);
            fence_registers(o);
            wgmma_fence();
#pragma unroll
            for (int ks = 0; ks < KEYS / 16; ++ks)
                Wgmma<DP>::template rs<T>(o, pa[ks], wgmma_desc(v_at(cw) + ks * 256, 128, L::KGP), 1);
            wgmma_commit();
            named_arrive(BAR_TURN + 1 - cw, WG_CONSUMERS);
            wgmma_wait<0>();
            fence_registers(o);
#pragma unroll
            for (int ks = 0; ks < KEYS / 16; ++ks)  // P's registers stay P's until the products are done
                asm volatile("" ::"r"(pa[ks][0]), "r"(pa[ks][1]), "r"(pa[ks][2]), "r"(pa[ks][3]) : "memory");
            mbar_arrive(v_empty(cw));

#pragma unroll
            for (int off = 1; off < 4; off <<= 1) {
                l0 += __shfl_xor_sync(0xffffffffu, l0, off);
                l1 += __shfl_xor_sync(0xffffffffu, l1, off);
            }
            const float i0 = 1.f / l0, i1 = 1.f / l1;
            T* ow = out + (size_t)w * n * C + (size_t)h * hd;
#pragma unroll
            for (int j = 0; j < DP / 8; ++j) {
                const int d = j * 8 + t4 * 2;  // hd is even: the pair lies in the head or past it
                if (d >= hd) continue;
                if (r0 < n)
                    *reinterpret_cast<uint32_t*>(ow + (size_t)r0 * C + d) = HT::pack(o[4 * j] * i0, o[4 * j + 1] * i0);
                if (r1 < n)
                    *reinterpret_cast<uint32_t*>(ow + (size_t)r1 * C + d) =
                        HT::pack(o[4 * j + 2] * i1, o[4 * j + 3] * i1);
            }
        }
        if (mine < (m + 1) / 2) {  // consumer 1 a window short: its Q K^T and P V turns
            named_sync(BAR_TURN + cw, WG_CONSUMERS);
            named_arrive(BAR_TURN + 1 - cw, WG_CONSUMERS);
            named_sync(BAR_TURN + cw, WG_CONSUMERS);
            named_arrive(BAR_TURN + 1 - cw, WG_CONSUMERS);
        }
        if (cw == 0) named_sync(BAR_TURN, WG_CONSUMERS);  // consumer 1's last hand-over
    }
}

// ---------------------------------------------------------------------------
// Any N and head_dim: the "any" kernels (see the note at the top).  A block
// owns one (window, head, tile of query rows, slice of output columns); the
// grid is every such block, blockIdx.x = ((w * heads + h) * rtiles + rt) *
// slices + slice.
// ---------------------------------------------------------------------------

constexpr int AR = 64;       // query rows a block (16-bit: 4 warps x 16)
constexpr int AK = 64;       // keys a chunk (16-bit)
constexpr int AD = 64;       // head dims a Q K^T step (16-bit)
constexpr int AS = AD + 8;   // row stride of the staged Q and K steps, elements (conflict-free ldmatrix)
constexpr int FR = 128;      // query rows (threads) a block at most (f32)
constexpr int FK = 32;       // keys a chunk (f32)
constexpr int FD = 32;       // head dims a Q K^T step (f32)
constexpr int FV = 64;       // output columns a block (f32)

// Output columns of a 16-bit block: one slice holds every head up to 128.
__host__ __device__ inline int any_dv(int hd) { return hd > 64 ? 128 : 64; }
// Shared memory of the 16-bit kernel: two steps of [AR][AS] Q and [AK][AS]
// K (the next step lands while this one is multiplied), two chunks of V
// [AK][dv + 8] (the next chunk's V lands with its first step).
__host__ __device__ inline size_t any_h16_smem_bytes(int dv) {
    return (size_t)2 * (AR + AK) * AS * 2 + (size_t)2 * AK * (dv + 8) * 2;
}

// f32: one thread per query row, exact FMA.  Per key chunk of FK keys the
// scores accumulate over head-dim steps of FD (each step's K rows staged in
// shared memory, q's step read from the thread's own row, scaled in f32 as
// the TPU kernel scales it); then bias and mask, the online softmax, and
// the chunk's V columns of the block's slice staged and multiplied in.
__global__ void __launch_bounds__(FR)
wattn_f32_any_kernel(const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
                     const float* __restrict__ bias, const float* __restrict__ mask, float* __restrict__ out, int n,
                     int heads, int hd, long long ld, long long wstride, int nw, float scale, int rtiles,
                     int slices) {
    __shared__ __align__(16) float ksm[FK][FD];
    __shared__ __align__(16) float vsm[FK][FV];
    long long blk = blockIdx.x;
    const int sl = (int)(blk % slices);
    blk /= slices;
    const int rt = (int)(blk % rtiles);
    blk /= rtiles;
    const int h = (int)(blk % heads);
    const long long w = blk / heads;
    const int tid = threadIdx.x, rows = blockDim.x;
    const int i = rt * rows + tid, ic = min(i, n - 1);  // this thread's query row (clamped: the others' loads)
    const int d0 = sl * FV, dv = min(FV, hd - d0);
    const size_t base = (size_t)w * wstride + (size_t)h * hd;
    const float* qp = q + base + (size_t)ic * ld;
    const float* br = bias + ((size_t)h * n + ic) * n;
    const float* mr = mask != nullptr ? mask + ((size_t)(w % nw) * n + ic) * n : nullptr;

    float o[FV];
#pragma unroll
    for (int d = 0; d < FV; ++d) o[d] = 0.f;
    float m = -INFINITY, l = 0.f;
#pragma unroll 1
    for (int j0 = 0; j0 < n; j0 += FK) {
        float s[FK];
#pragma unroll
        for (int jj = 0; jj < FK; ++jj) s[jj] = 0.f;
#pragma unroll 1
        for (int e0 = 0; e0 < hd; e0 += FD) {
            __syncthreads();  // every thread is done with the last step's K (and the last chunk's V)
            for (int x = tid; x < FK * FD; x += rows) {
                const int r = x / FD, cc = x % FD;
                ksm[r][cc] = (j0 + r < n && e0 + cc < hd) ? k[base + (size_t)(j0 + r) * ld + e0 + cc] : 0.f;
            }
            __syncthreads();
            float qr[FD];
#pragma unroll
            for (int d = 0; d < FD; ++d) qr[d] = e0 + d < hd ? qp[e0 + d] * scale : 0.f;
#pragma unroll
            for (int jj = 0; jj < FK; ++jj) {
                const float4* kr = reinterpret_cast<const float4*>(ksm[jj]);
                float acc = s[jj];
#pragma unroll
                for (int d = 0; d < FD / 4; ++d) {
                    const float4 kv = kr[d];
                    acc = fmaf(qr[4 * d], kv.x, acc);
                    acc = fmaf(qr[4 * d + 1], kv.y, acc);
                    acc = fmaf(qr[4 * d + 2], kv.z, acc);
                    acc = fmaf(qr[4 * d + 3], kv.w, acc);
                }
                s[jj] = acc;
            }
        }
        float mx = -INFINITY;
#pragma unroll
        for (int jj = 0; jj < FK; ++jj) {
            const int j = j0 + jj;
            float val = -INFINITY;
            if (j < n) {
                val = s[jj] + br[j];
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
        for (int d = 0; d < FV; ++d) o[d] *= corr;
        // the chunk's V columns of this slice (the barrier at the top of the
        // last step freed vsm)
        for (int x = tid; x < FK * FV; x += rows) {
            const int r = x / FV, cc = x % FV;
            vsm[r][cc] = (j0 + r < n && cc < dv) ? v[base + (size_t)(j0 + r) * ld + d0 + cc] : 0.f;
        }
        __syncthreads();
#pragma unroll
        for (int jj = 0; jj < FK; ++jj) {
            if (j0 + jj < n) {
                const float p = expf(s[jj] - mn);
                l += p;
                const float4* vr = reinterpret_cast<const float4*>(vsm[jj]);
#pragma unroll
                for (int d = 0; d < FV / 4; ++d) {
                    const float4 vv = vr[d];
                    o[4 * d] = fmaf(p, vv.x, o[4 * d]);
                    o[4 * d + 1] = fmaf(p, vv.y, o[4 * d + 1]);
                    o[4 * d + 2] = fmaf(p, vv.z, o[4 * d + 2]);
                    o[4 * d + 3] = fmaf(p, vv.w, o[4 * d + 3]);
                }
            }
        }
    }
    if (i >= n) return;
    const float inv = 1.f / l;
    float* op = out + ((size_t)w * n + i) * ((size_t)heads * hd) + (size_t)h * hd + d0;
#pragma unroll
    for (int d = 0; d < FV; ++d)
        if (d < dv) op[d] = o[d] * inv;
}

// bf16 / fp16: 4 warps, 16 query rows each, mma.sync m16n8k16 with f32
// accumulation.  The block's steps, (key chunk, head-dim step) in order, go
// through two shared-memory slots by cp.async, the next in flight while the
// tensor cores work on this one; a chunk's V columns arrive with its first
// step.  A warp's score accumulators for its 16 rows x 64 keys start from
// (bias + mask) / scale, read straight from L2 at the chunk's first step
// (as the first kernel pair's 16-bit kernel starts them, so that they need
// no registers of their own: 168 registers, three blocks an SM, where
// holding bias + mask apart took 254 and two, and ran slower at DRCT's
// shapes on an H100); after the chunk's last step they hold (bias + mask)
// / scale + Q K^T, which times scale is the scores; then the online
// softmax in base 2 (ex2 on the special-function unit), and P, rounded to
// the 16-bit type, times V.  The scores never leave registers.  scale must be
// positive.
template <typename T, int DV>
__global__ void __launch_bounds__(128)
wattn_h16_any_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                     const float* __restrict__ bias, const float* __restrict__ mask,
                     const unsigned char* __restrict__ flags, T* __restrict__ out, int n, int heads, int hd,
                     long long ld, long long wstride, int nw, float scale, int vb, int rtiles, int slices) {
    using HT = Half16<T>;
    constexpr int VS = DV + 8;  // row stride of the staged V, elements
    extern __shared__ __align__(16) unsigned char smem[];
    T* ring = reinterpret_cast<T*>(smem);  // 2 slots of [AR][AS] Q then [AK][AS] K
    T* vbuf = ring + 2 * (AR + AK) * AS;   // 2 slots of [AK][VS] V
    long long blk = blockIdx.x;
    const int sl = (int)(blk % slices);
    blk /= slices;
    const int rt = (int)(blk % rtiles);
    blk /= rtiles;
    const int h = (int)(blk % heads);
    const long long w = blk / heads;
    const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
    const int g = lane >> 2, t4 = lane & 3;
    const int row0 = rt * AR, d0 = sl * DV;
    const int dv = min(DV, hd - d0), dvp = round16(dv);  // the slice's columns, and padded to 16
    const int dq = round16(hd);                          // Q K^T depth, zero past head_dim
    const int nds = (dq + AD - 1) / AD;                  // Q K^T steps a chunk
    const int F = ((n + AK - 1) / AK) * nds;              // steps of the block
    const size_t base = (size_t)w * wstride + (size_t)h * hd;
    const int qlive = min(AR, n - row0);

    auto load_step = [&](int f) {
        if (f >= F) return;
        const int c = f / nds, ds = f % nds;
        const int key0 = c * AK, klive = min(AK, n - key0);
        const int e0 = ds * AD, dsz = min(AD, dq - e0), elive = min(AD, hd - e0);
        T* qd = ring + (f & 1) * (AR + AK) * AS;
        stage<T>(qd, q + base + (size_t)row0 * ld + e0, qlive, AR, elive, dsz, AS, ld, vb, tid, 128);
        stage<T>(qd + AR * AS, k + base + (size_t)key0 * ld + e0, klive, AK, elive, dsz, AS, ld, vb, tid, 128);
        if (ds == 0)
            stage<T>(vbuf + (c & 1) * AK * VS, v + base + (size_t)key0 * ld + d0, klive, AK, dv, dvp, VS, ld, vb,
                     tid, 128);
    };
    load_step(0);
    cp_async_commit();

    const float* mw = nullptr;
    if (mask != nullptr) {
        const int mi = (int)(w % nw);
        if (flags == nullptr || flags[mi]) mw = mask + (size_t)mi * n * n;
    }
    // accumulator (m16 x n8): lane holds rows g and g + 8, columns t4 * 2 and + 1
    const int r0 = min(row0 + warp * 16 + g, n - 1), r1 = min(row0 + warp * 16 + g + 8, n - 1);
    const float* b0p = bias + ((size_t)h * n + r0) * n;
    const float* b1p = bias + ((size_t)h * n + r1) * n;
    const float* m0p = mw != nullptr ? mw + (size_t)r0 * n : nullptr;
    const float* m1p = mw != nullptr ? mw + (size_t)r1 * n : nullptr;
    const bool active = row0 + warp * 16 < n;  // else: nothing but the barriers
    const bool vec2 = (n % 2) == 0;
    const float log2e = 1.4426950408889634f;

    float o[DV / 8][4];
#pragma unroll
    for (int i = 0; i < DV / 8; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e) o[i][e] = 0.f;
    float s[AK / 8][4];
    const float inv_scale = 1.f / scale;
    float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;

#pragma unroll 1
    for (int f = 0; f < F; ++f) {
        const int c = f / nds, ds = f % nds;
        cp_async_wait<0>();  // this thread's pieces of step f have landed
        __syncthreads();     // every thread's; and every warp is done with step f - 1's slot
        load_step(f + 1);
        cp_async_commit();
        if (!active) continue;
        const int kc = c * AK, nkeys = n - kc;  // keys of this chunk: min(AK, nkeys)
        if (ds == 0) {  // the accumulators start from (bias + mask) / scale (scale > 0)
#pragma unroll
            for (int t = 0; t < AK / 8; ++t) {
                const int col = kc + t * 8 + t4 * 2;
                if (vec2) {  // n even: 8-byte loads (col is even), clamped at the last pair
                    const int cc = min(col, n - 2);
                    const float2 b0 = *reinterpret_cast<const float2*>(b0p + cc);
                    const float2 b1 = *reinterpret_cast<const float2*>(b1p + cc);
                    s[t][0] = b0.x;
                    s[t][1] = b0.y;
                    s[t][2] = b1.x;
                    s[t][3] = b1.y;
                    if (m0p != nullptr) {
                        const float2 k0 = *reinterpret_cast<const float2*>(m0p + cc);
                        const float2 k1 = *reinterpret_cast<const float2*>(m1p + cc);
                        s[t][0] += k0.x;
                        s[t][1] += k0.y;
                        s[t][2] += k1.x;
                        s[t][3] += k1.y;
                    }
                } else {
                    const int ca = min(col, n - 1), cb = min(col + 1, n - 1);
                    s[t][0] = b0p[ca];
                    s[t][1] = b0p[cb];
                    s[t][2] = b1p[ca];
                    s[t][3] = b1p[cb];
                    if (m0p != nullptr) {
                        s[t][0] += m0p[ca];
                        s[t][1] += m0p[cb];
                        s[t][2] += m1p[ca];
                        s[t][3] += m1p[cb];
                    }
                }
            }
#pragma unroll
            for (int t = 0; t < AK / 8; ++t)
#pragma unroll
                for (int e = 0; e < 4; ++e) s[t][e] *= inv_scale;
        }
        // S += Q K^T over this step's dims.  A (16 query rows x 16 dims,
        // row-major): lane gives the address of row lane % 16, dims (lane /
        // 16) * 8 ..; B (16 dims x 8 keys, "col"): K rows are keys, so a
        // non-transposed ldmatrix gives it; lane gives the address of key
        // (lane & 7) + (lane / 16) * 8, dims ((lane / 8) & 1) * 8 ..
        const T* qs = ring + (f & 1) * (AR + AK) * AS;
        const T* ks = qs + AR * AS;
        const int dsz = min(AD, dq - ds * AD);
#pragma unroll
        for (int kk = 0; kk < AD / 16; ++kk) {
            if (kk * 16 < dsz) {
                uint32_t a[4];
                ldmatrix_x4(a, qs + (warp * 16 + (lane & 15)) * AS + kk * 16 + (lane >> 4) * 8);
#pragma unroll
                for (int j = 0; j < AK / 16; ++j) {
                    if (j * 16 < nkeys) {
                        uint32_t b[4];
                        ldmatrix_x4(b, ks + (j * 16 + (lane & 7) + ((lane >> 4) << 3)) * AS + kk * 16 +
                                           ((lane >> 3) & 1) * 8);
                        HT::mma(s[2 * j], a, b[0], b[1]);
                        HT::mma(s[2 * j + 1], a, b[2], b[3]);
                    }
                }
            }
        }
        if (ds != nds - 1) continue;

        // scale * (S + (bias + mask) / scale), -inf past the last key
        float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
        for (int t = 0; t < AK / 8; ++t) {
            const int col = t * 8 + t4 * 2;
#pragma unroll
            for (int e = 0; e < 2; ++e) {
                const bool live = col + e < nkeys;
                s[t][e] = live ? s[t][e] * scale : -INFINITY;
                s[t][2 + e] = live ? s[t][2 + e] * scale : -INFINITY;
            }
            mx0 = fmaxf(mx0, fmaxf(s[t][0], s[t][1]));
            mx1 = fmaxf(mx1, fmaxf(s[t][2], s[t][3]));
        }
        // the four lanes of a quad hold one row
#pragma unroll
        for (int off = 1; off < 4; off <<= 1) {
            mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
            mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
        }
        // key 0 lies in the first chunk, so the running max is finite from there on
        const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
        const float e0 = ex2((m0 - mn0) * log2e), e1 = ex2((m1 - mn1) * log2e);
        const float neg0 = -mn0 * log2e, neg1 = -mn1 * log2e;
        m0 = mn0;
        m1 = mn1;
        l0 *= e0;
        l1 *= e1;
#pragma unroll
        for (int i = 0; i < DV / 8; ++i) {
            o[i][0] *= e0;
            o[i][1] *= e0;
            o[i][2] *= e1;
            o[i][3] *= e1;
        }
#pragma unroll
        for (int t = 0; t < AK / 8; ++t) {
            s[t][0] = ex2(fmaf(s[t][0], log2e, neg0));
            s[t][1] = ex2(fmaf(s[t][1], log2e, neg0));
            s[t][2] = ex2(fmaf(s[t][2], log2e, neg1));
            s[t][3] = ex2(fmaf(s[t][3], log2e, neg1));
            l0 += s[t][0] + s[t][1];
            l1 += s[t][2] + s[t][3];
        }
        // O += P V.  The accumulator layout of two n8 score tiles is the A
        // fragment of one k16 step; B (16 keys x 8 dims) is V stored
        // key-major, read with ldmatrix.trans: lane gives the address of key
        // lane % 16, dims (lane / 16) * 8 .. of a pair of n8 tiles
        const T* vs = vbuf + (c & 1) * AK * VS;
#pragma unroll
        for (int j = 0; j < AK / 16; ++j) {
            if (j * 16 < nkeys) {
                const uint32_t pa[4] = {HT::pack(s[2 * j][0], s[2 * j][1]), HT::pack(s[2 * j][2], s[2 * j][3]),
                                        HT::pack(s[2 * j + 1][0], s[2 * j + 1][1]),
                                        HT::pack(s[2 * j + 1][2], s[2 * j + 1][3])};
#pragma unroll
                for (int np = 0; np < DV / 16; ++np) {
                    if (np * 16 < dvp) {
                        uint32_t b[4];
                        ldmatrix_x4_trans(b, vs + (j * 16 + (lane & 15)) * VS + np * 16 + (lane >> 4) * 8);
                        HT::mma(o[2 * np], pa, b[0], b[1]);
                        HT::mma(o[2 * np + 1], pa, b[2], b[3]);
                    }
                }
            }
        }
    }
    cp_async_wait<0>();
    if (!active) return;
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
        l0 += __shfl_xor_sync(0xffffffffu, l0, off);
        l1 += __shfl_xor_sync(0xffffffffu, l1, off);
    }
    const float i0 = 1.f / l0, i1 = 1.f / l1;
    const int C = heads * hd;
    const bool pairs = (C % 2 == 0) && (hd % 2 == 0);
    T* ow = out + (size_t)w * n * C + (size_t)h * hd + d0;
#pragma unroll
    for (int nt = 0; nt < DV / 8; ++nt) {
        const int d = nt * 8 + t4 * 2;
        if (d >= dv) continue;
#pragma unroll
        for (int half = 0; half < 2; ++half) {
            const int row = row0 + warp * 16 + g + 8 * half;
            if (row >= n) continue;
            const float inv = half ? i1 : i0;
            const float a0 = o[nt][2 * half] * inv, a1 = o[nt][2 * half + 1] * inv;
            T* p = ow + (size_t)row * C + d;
            if (pairs) {
                *reinterpret_cast<uint32_t*>(p) = HT::pack(a0, a1);
            } else {
                p[0] = HT::from_float(a0);
                if (d + 1 < dv) p[1] = HT::from_float(a1);
            }
        }
    }
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

}  // namespace

// The kernel a shape (n tokens, head_dim hd as launched, elements of
// element_bytes) runs on: 0 the first pair (wattn_f32_kernel,
// wattn_h16_kernel), which hold a whole head and (16-bit) a block of bias
// rows; 1 the "any" kernels (wattn_f32_any_kernel, wattn_h16_any_kernel),
// which take every n and head_dim; 2 wattn_wgmma_kernel, the 16-bit windows
// of more than 64 tokens, where the first 16-bit kernel's bias rows cost it
// its occupancy.  Exported, so that the wrapper names the kernel a launch
// takes by the rule the dispatch below follows.
enum Route { ROUTE_FIRST_PAIR = 0, ROUTE_ANY = 1, ROUTE_WGMMA = 2 };

extern "C" int resselt_window_attn_route(int n, int hd, int element_bytes) {
    if (n > MAX_N || hd > MAX_HD) return ROUTE_ANY;
    return element_bytes == 2 && n > 64 ? ROUTE_WGMMA : ROUTE_FIRST_PAIR;
}

namespace {

// The blocks one window takes on the "any" kernels (row tiles x slices),
// and the grid's limit on the blocks of a launch.
long long any_blocks_per_window(int n, int hd, int es) {
    const int rows = es == 4 ? FR : AR;
    const int cols = es == 4 ? FV : any_dv(hd);
    return (long long)((n + rows - 1) / rows) * ((hd + cols - 1) / cols);
}
constexpr long long MAX_GRID = 0x7fffffffLL;

// The most windows one launch takes at this shape (elements of es bytes):
// the grid's x dimension bounds the blocks, and `windows` is an int.
long long max_windows(int n, int heads, int hd, int es) {
    if (n < 1 || heads < 1 || hd < 1) return 0;
    // f32: a block per (window, head); 16-bit: persistent blocks
    if (resselt_window_attn_route(n, hd, es) != ROUTE_ANY) return es == 4 ? MAX_GRID / heads : MAX_GRID;
    return MAX_GRID / ((long long)heads * any_blocks_per_window(n, hd, es));
}

bool bad_shape(const void* bias, int windows, int n, int heads, int hd, long long ld, long long wstride, int nw,
               int es) {
    return bias == nullptr || windows <= 0 || n < 1 || heads < 1 || hd < 1 || ld < (long long)heads * hd ||
           wstride < (long long)n * ld || nw < 1 || windows % nw != 0 || windows > max_windows(n, heads, hd, es);
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

cudaError_t launch_f32_any(const void* q, const void* k, const void* v, const void* bias, const void* mask,
                           void* out, int windows, int n, int heads, int hd, long long ld, long long wstride, int nw,
                           float scale, cudaStream_t stream) {
    const int threads = n < FR ? (n + 31) / 32 * 32 : FR;
    const int rtiles = (n + threads - 1) / threads, slices = (hd + FV - 1) / FV;
    const long long blocks = (long long)windows * heads * rtiles * slices;
    wattn_f32_any_kernel<<<(unsigned)blocks, threads, 0, stream>>>(
        static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
        static_cast<const float*>(bias), static_cast<const float*>(mask), static_cast<float*>(out), n, heads, hd,
        ld, wstride, nw, scale, rtiles, slices);
    return cudaGetLastError();
}

// The first 16-bit kernel's grid: each head x as many window chunks as
// keep every block resident at once; as many window groups a block as its
// threads and shared memory hold.
template <typename T, int DP>
cudaError_t launch_h16(const void* q, const void* k, const void* v, const void* bias, const void* mask,
                       const void* flags, void* out, int windows, int n, int heads, int hd, long long ld,
                       long long wstride, int nw, float scale, cudaStream_t stream) {
    const int max_threads = DP <= 32 ? H16_THREADS : H16_THREADS / 2;
    int groups = max_threads / (KT * 2);
    while (groups > 1 && h16_smem_bytes(n, DP, groups) > (size_t)232448) groups /= 2;
    const size_t smem = h16_smem_bytes(n, DP, groups);
    auto kernel = wattn_h16_kernel<T, DP>;
    // the attribute and the occupancy of this kernel at this size, asked once
    static size_t known_smem = 0;
    static int known_per_sm = 0;
    if (smem != known_smem) {
        cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
        if (err != cudaSuccess) return err;
        err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&known_per_sm, kernel, groups * KT * 2, smem);
        if (err != cudaSuccess) return err;
        known_smem = smem;
    }
    const int per_sm = known_per_sm;
    if (per_sm < 1) return cudaErrorInvalidConfiguration;
    long long per_head = (long long)num_sms() * per_sm / heads;  // blocks of one head
    if (per_head > (windows + groups - 1) / groups) per_head = (windows + groups - 1) / groups;
    if (per_head < 1) per_head = 1;
    if (heads * per_head > 0x7fffffffLL) return cudaErrorInvalidValue;
    const int vb = pick_vb(q, k, v, ld, wstride, hd, 2);
    kernel<<<(unsigned)(heads * per_head), groups * KT * 2, smem, stream>>>(
        static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
        static_cast<const float*>(bias), static_cast<const float*>(mask), static_cast<const unsigned char*>(flags),
        static_cast<T*>(out), windows, n, heads, hd, ld, wstride, nw, scale, vb, (int)(per_head * groups));
    return cudaGetLastError();
}

// The wgmma kernel's grid: (head, row tile) combinations x as many window
// chunks as keep one block on each SM, and no more than the windows give
// each consumer warpgroup one.
template <typename T, int DP, int KC>
cudaError_t launch_wgmma(const void* q, const void* k, const void* v, const void* bias, const void* mask,
                         const void* flags, void* out, int windows, int n, int heads, int hd, long long ld,
                         long long wstride, int nw, float scale, cudaStream_t stream) {
    auto kernel = wattn_wgmma_kernel<T, DP, KC>;
    static int attribute_set = -1;  // the device the attribute was set on
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return err;
    if (attribute_set != dev) {
        err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, WgLayout<DP, KC>::SMEM);
        if (err != cudaSuccess) return err;
        attribute_set = dev;
    }
    const long long ncombo = (long long)heads * ((n + WG_ROWS - 1) / WG_ROWS);
    long long per_combo = num_sms() / ncombo;
    if (per_combo > (windows + 1) / 2) per_combo = (windows + 1) / 2;
    if (per_combo < 1) per_combo = 1;
    if (ncombo * per_combo > 0x7fffffffLL) return cudaErrorInvalidValue;
    const int vb = pick_vb(q, k, v, ld, wstride, hd, 2);
    kernel<<<(unsigned)(ncombo * per_combo), WG_THREADS, WgLayout<DP, KC>::SMEM, stream>>>(
        static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
        static_cast<const float*>(bias), static_cast<const float*>(mask), static_cast<const unsigned char*>(flags),
        static_cast<T*>(out), windows, n, heads, hd, ld, wstride, nw, scale, vb, (int)per_combo);
    return cudaGetLastError();
}

// head_dim padded to a multiple of 16 (the Q K^T depth); n up to 128 in two
// chunks of 64 keys, more in four
template <typename T>
cudaError_t launch_wgmma_shape(const void* q, const void* k, const void* v, const void* bias, const void* mask,
                               const void* flags, void* out, int windows, int n, int heads, int hd, long long ld,
                               long long wstride, int nw, float scale, cudaStream_t s) {
#define RESSELT_WGMMA_LAUNCH(DP, KC) \
    launch_wgmma<T, DP, KC>(q, k, v, bias, mask, flags, out, windows, n, heads, hd, ld, wstride, nw, scale, s)
    const bool two = n <= 128;
    switch (round16(hd)) {
        case 16: return two ? RESSELT_WGMMA_LAUNCH(16, 2) : RESSELT_WGMMA_LAUNCH(16, 4);
        case 32: return two ? RESSELT_WGMMA_LAUNCH(32, 2) : RESSELT_WGMMA_LAUNCH(32, 4);
        case 48: return two ? RESSELT_WGMMA_LAUNCH(48, 2) : RESSELT_WGMMA_LAUNCH(48, 4);
        default: return two ? RESSELT_WGMMA_LAUNCH(64, 2) : RESSELT_WGMMA_LAUNCH(64, 4);
    }
#undef RESSELT_WGMMA_LAUNCH
}

template <typename T, int DV>
cudaError_t launch_h16_any(const void* q, const void* k, const void* v, const void* bias, const void* mask,
                           const void* flags, void* out, int windows, int n, int heads, int hd, long long ld,
                           long long wstride, int nw, float scale, cudaStream_t stream) {
    const size_t smem = any_h16_smem_bytes(DV);
    auto kernel = wattn_h16_any_kernel<T, DV>;
    cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    const int rtiles = (n + AR - 1) / AR, slices = (hd + DV - 1) / DV;
    const long long blocks = (long long)windows * heads * rtiles * slices;
    const int vb = pick_vb(q, k, v, ld, wstride, hd, 2);
    kernel<<<(unsigned)blocks, 128, smem, stream>>>(
        static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
        static_cast<const float*>(bias), static_cast<const float*>(mask), static_cast<const unsigned char*>(flags),
        static_cast<T*>(out), n, heads, hd, ld, wstride, nw, scale, vb, rtiles, slices);
    return cudaGetLastError();
}

template <typename T>
int launch_h16_entry(const void* q, const void* k, const void* v, const void* bias, const void* mask,
                     const void* flags, void* out, int windows, int n, int heads, int hd, long long ld,
                     long long wstride, int nw, float scale, void* stream) {
    // the first kernel divides bias and mask by scale and takes maxima of scores over scale; both stage
    // rows with cp.async copies of at least 4 bytes
    if (bad_shape(bias, windows, n, heads, hd, ld, wstride, nw, 2) || !(scale > 0.f) || !isfinite(scale) ||
        pick_vb(q, k, v, ld, wstride, hd, 2) < 4)
        return (int)cudaErrorInvalidValue;
    const cudaStream_t s = static_cast<cudaStream_t>(stream);
    const int route = resselt_window_attn_route(n, hd, 2);
    if (route == ROUTE_WGMMA)
        return (int)launch_wgmma_shape<T>(q, k, v, bias, mask, flags, out, windows, n, heads, hd, ld, wstride, nw,
                                          scale, s);
    if (route == ROUTE_ANY) {
        if (any_dv(hd) == 64)
            return (int)launch_h16_any<T, 64>(q, k, v, bias, mask, flags, out, windows, n, heads, hd, ld, wstride,
                                              nw, scale, s);
        return (int)launch_h16_any<T, 128>(q, k, v, bias, mask, flags, out, windows, n, heads, hd, ld, wstride, nw,
                                           scale, s);
    }
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
// cudaGetLastError() right after the launch (0 = launched).  A launch takes
// at most resselt_window_attn_max_windows windows; the caller splits more.
extern "C" long long resselt_window_attn_max_windows(int n, int heads, int hd, int element_bytes) {
    return max_windows(n, heads, hd, element_bytes);
}

extern "C" int resselt_window_attn_f32(const void* q, const void* k, const void* v, const void* bias,
                                       const void* mask, void* out, int windows, int n, int heads, int hd,
                                       long long ld, long long wstride, int nw, float scale, void* stream) {
    if (bad_shape(bias, windows, n, heads, hd, ld, wstride, nw, 4)) return (int)cudaErrorInvalidValue;
    const cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (resselt_window_attn_route(n, hd, 4) == ROUTE_ANY)
        return (int)launch_f32_any(q, k, v, bias, mask, out, windows, n, heads, hd, ld, wstride, nw, scale, s);
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
    return launch_h16_entry<__nv_bfloat16>(q, k, v, bias, mask, flags, out, windows, n, heads, hd, ld, wstride, nw,
                                           scale, stream);
}

extern "C" int resselt_window_attn_f16(const void* q, const void* k, const void* v, const void* bias,
                                       const void* mask, const void* flags, void* out, int windows, int n,
                                       int heads, int hd, long long ld, long long wstride, int nw, float scale,
                                       void* stream) {
    return launch_h16_entry<__half>(q, k, v, bias, mask, flags, out, windows, n, heads, hd, ld, wstride, nw, scale,
                                    stream);
}
