// Overlapping cross-window attention with a relative-position bias, for
// Hopper: the attention of HAT's OCAB (overlapping cross-attention block).
//
// Replaces no TPU kernel: the JAX package runs OCAB in XLA
// (resselt_tpu/archs/hat.py::_ocab through nn/window.py's plain attention),
// and so did the port (nn/window.py::_mha_plain), which writes every
// window's (heads, N, M) scores to device memory, adds the bias into a
// second tensor and takes the softmax into a third: at HAT-L's served batch
// (392 windows of 256 queries and 576 keys, 6 heads) each is a 694 MB bf16
// tensor, about 58 GB of traffic an OCAB of a 720p frame.  For every window
// w and head h this kernel computes
//   O[w, :, h] = softmax(scale * Q_h K_h^T + bias[h]) V_h
// with N queries and M keys a window, the scaled scores, bias and softmax in
// f32 (never written to memory) and the output in the input's dtype (bf16 or
// fp16).  q is (B, N, C), C = heads * head_dim, its tokens `ldq` elements
// apart and windows `wsq` apart (the window-partitioned projection, read in
// place); k and v are (B, M, C) at their own pitches `ldkv` and `wskv` (the
// two channel halves of the overlapping-windows tensor, read in place);
// bias is f32 (heads, N, M); the output is contiguous (B, N, C).  There is
// no mask.  resselt_window_cross_attn_supported is the rule of the shapes it
// takes: 16 bits, an even head_dim up to 32, at most MAX_KEYS keys, any N.
//
// What bounds it on an H100: by the book the bytes (q, k, v and the output
// once, the f32 bias once: 238 MB, 71 us a HAT-L launch at 3.35 TB/s,
// against 42 us of tensor-core work); next the exponentials, one a score:
// 347 M a HAT-L launch, about 94 us on the special-function units (16 a
// clock an SM).  What a first design (each window's whole K and V in a
// stage, the bias read per key chunk straight from L2) really waited for
// was L2: a block re-read its 64 bias rows (147 KB) for every window, twice
// the bytes of the window's K and V, 2 GB a launch in all; it ran at 0.551
// ms a HAT-L launch, 13% of the bound (an H100 at 700 W).  The design here
// (window_attn.cu's wgmma kernel's, with the keys in chunks):
//  * A block owns one (head, 64-row tile of queries) and walks windows w =
//    bc, bc + nblk, ...; the grid is one block an SM.  Its bias rows over
//    scale (64 x (MAX_KEYS + 8) f32, 150 KB) are loaded once, by the
//    consumers, while the producer stages the first windows, and stay in
//    shared memory: L2 then serves K and V alone.
//  * Warp-specialised: a producer warpgroup (setmaxnreg 40) and two
//    consumer warpgroups (setmaxnreg 232) that take alternate windows and
//    run free of each other.  Warps 8-9 of the producer feed consumer 0,
//    warps 10-11 consumer 1: each window's 64 Q rows into one of two Q
//    buffers of the consumer, then its keys in chunks of CK = 64, the
//    chunk's K and V rows into a ring of RING slots of the consumer, by
//    cp.async in place at the operands' pitches, each buffer and slot with
//    a full and an empty mbarrier.  K and V rows past M in a last short
//    chunk are written zero.
//  * Per chunk, S = bias / scale + Q K^T by wgmma m64n64k16 (A and B K-major
//    from shared memory, stored [group of 8 columns][row][8] with a group
//    16 bytes past a whole number of rows from the next), then an online
//    softmax across the chunks (64 rows x 576 f32 scores do not fit a
//    warpgroup's registers): -inf past M, each row's new max (a quad of
//    lanes holds a row), the running sum and O rescaled by 2^((old - new)
//    scale log2(e)), P = 2^((s - max) scale log2(e)) by one fma and one ex2
//    a score, rounded to the 16-bit type as the register A operand of O +=
//    P V by wgmma m64nDPk16 (V MN-major from the same layout).  O is
//    normalised and stored from registers in 4-byte pieces.  scale must be
//    positive.
//  * Rows are staged with the widest cp.async copies (16, 8 or 4 bytes) that
//    the pointers, pitches and head_dim allow; HAT-L's heads of 30 (60
//    bytes, at a token pitch of 360 elements) take 4-byte copies, HAT-S's
//    heads of 24 16-byte ones.  Each chunk's products are straight-line code
//    from the issue to the wait (a branch between them makes ptxas
//    serialise the wgmmas).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "async_copy.cuh"
#include "half16.cuh"
#include "wgmma.cuh"

namespace {

constexpr int ROWS = 64;          // query rows a block: one m64 tile
constexpr int THREADS = 384;      // consumer warpgroups 0 and 1, then the producer warpgroup
constexpr int LOADER = 64;        // threads of each of the producer's two loaders, one a consumer
constexpr int CONSUMERS = 256;    // threads of the two consumer warpgroups
constexpr int CK = 64;            // keys a chunk: one m64n64 Q K^T
constexpr int MAX_KEYS = 9 * CK;  // keys the bias rows hold: 576, HAT's 24 x 24 overlapping window
constexpr int RING = 3;           // chunk slots of a consumer
constexpr int MAX_HD = 32;
constexpr int MAX_SMEM = 232448;
constexpr int BAR_BIAS = 1;       // named barrier: the consumers' bias rows are in place

__host__ __device__ __forceinline__ int round16(int x) { return (x + 15) & ~15; }

// Shared memory of a block at head_dim padded to DP: the bias rows, [64][BP]
// f32 (over scale, zero past n and m), then per consumer two Q buffers [64
// rows] and RING chunk slots of K [CK rows] and V [CK rows], then per
// consumer the mbarriers q_full[2], q_empty[2], kv_full[RING],
// kv_empty[RING].  Rows and columns past the window's and the head's are
// zero from the start and never written, but for K and V rows past M in a
// last short chunk, which are written zero.
template <int DP>
struct CrossLayout {
    static constexpr int BP = MAX_KEYS + 8;     // floats a bias row: conflict-free float2 reads
    static constexpr int BIAS = ROWS * BP * 4;
    static constexpr int QGP = ROWS * 16 + 16;  // bytes from one group of 8 columns to the next
    static constexpr int KGP = CK * 16 + 16;
    static constexpr int Q_BYTES = DP / 8 * QGP;
    static constexpr int K_BYTES = DP / 8 * KGP;
    static constexpr int SLOT = 2 * K_BYTES;    // a chunk's K, then its V
    static constexpr int CONSUMER = 2 * Q_BYTES + RING * SLOT;
    static constexpr int BARS = BIAS + 2 * CONSUMER;
    static constexpr int BARS_PER = 4 + 2 * RING;
    static constexpr int SMEM = BARS + 2 * BARS_PER * 8;
    static_assert(SMEM <= MAX_SMEM, "the bias rows, Q buffers and chunk rings must fit in shared memory");
};

// 2^x on the special-function unit (2^-inf = 0).
__device__ __forceinline__ float ex2(float x) {
    float y;
    asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
    return y;
}

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
// bytes a step in shared memory, SS in global memory), of which sz bytes
// are read (VB) or none (0: the piece is written zero).
template <int VB, int DS, int SS, int K, int NK>
__device__ __forceinline__ void copy_steps(uint32_t dr, const char* sr, int nk, int sz) {
    if constexpr (K < NK) {
        if (K < nk)
            asm volatile("cp.async.ca.shared.global [%0+%2], [%1+%3], %4, %5;\n" ::"r"(dr), "l"(sr), "n"(K * DS),
                         "n"(K * SS), "n"(VB), "r"(sz));
        copy_steps<VB, DS, SS, K + 1, NK>(dr, sr, nk, sz);
    }
}

// Rows [0, fill) of a buffer of the layout above (GP bytes between groups of
// 8 columns) at dst: rows [0, rows) from one head (hd elements at src + row
// * ld), the rest written zero, by the `nthreads` threads of one loader
// (index tid), in cp.async copies of VB bytes: LPR lanes take a row side by
// side, each walking the row's groups of 8 columns at fixed offsets, a copy
// an instruction (window_attn.cu's stage_rows_vec).
template <typename T, int VB, int DP, int GP, int LPR>
__device__ __forceinline__ void stage_rows_vec(uint32_t dst, const T* __restrict__ src, long long ld, int rows,
                                               int fill, int hd, int tid, int nthreads) {
    constexpr int PG = 16 / VB;    // lanes a group
    constexpr int GPS = LPR / PG;  // groups a step
    const int p = tid % PG, gl = (tid % LPR) / PG;
    const int lead = gl * 16 + p * VB;  // this lane's first byte of a row
    const int nk = (hd * (int)sizeof(T) - lead + GPS * 16 - 1) / (GPS * 16);
    const long long pitch = ld * (long long)sizeof(T);
    const char* s0 = reinterpret_cast<const char*>(src) + lead;  // row 0: the address of a zero-filled piece
    const char* sr = s0 + (tid / LPR) * pitch;
    uint32_t dr = dst + gl * GP + p * VB + (tid / LPR) * 16;
#pragma unroll 1
    for (int r = tid / LPR; r < fill; r += nthreads / LPR) {
        const bool live = r < rows;
        copy_steps<VB, GPS * GP, GPS * 16, 0, (DP / 8 + GPS - 1) / GPS>(dr, live ? sr : s0, nk, live ? VB : 0);
        sr += (nthreads / LPR) * pitch;
        dr += (nthreads / LPR) * 16;
    }
}

template <typename T, int DP, int GP>
__device__ __forceinline__ void stage_rows(uint32_t dst, const T* __restrict__ src, long long ld, int rows, int fill,
                                           int hd, int vb, int tid, int nthreads) {
    switch (vb) {
        case 16: stage_rows_vec<T, 16, DP, GP, 8>(dst, src, ld, rows, fill, hd, tid, nthreads); break;
        case 8: stage_rows_vec<T, 8, DP, GP, 8>(dst, src, ld, rows, fill, hd, tid, nthreads); break;
        default: stage_rows_vec<T, 4, DP, GP, 4>(dst, src, ld, rows, fill, hd, tid, nthreads); break;
    }
}

template <typename T, int DP>
__global__ void __launch_bounds__(THREADS, 1)
wcross_wgmma_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                    const float* __restrict__ bias, T* __restrict__ out, int windows, int n, int m, int heads,
                    int hd, long long ldq, long long wsq, long long ldkv, long long wskv, float scale, int vb,
                    int nblk) {
    using L = CrossLayout<DP>;
    using HT = Half16<T>;
    extern __shared__ __align__(128) unsigned char smem[];
    float* bsm = reinterpret_cast<float*>(smem);
    const uint32_t smem_addr = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
    // consumer c's Q buffer b, its chunk slot r (K, then V), and its mbarriers
    const auto q_at = [&](int c, int b) { return smem_addr + L::BIAS + c * L::CONSUMER + b * L::Q_BYTES; };
    const auto k_at = [&](int c, int r) { return q_at(c, 2) + r * L::SLOT; };
    const auto v_at = [&](int c, int r) { return k_at(c, r) + L::K_BYTES; };
    const auto bar = [&](int c, int i) { return smem_addr + L::BARS + (c * L::BARS_PER + i) * 8; };
    const auto q_full = [&](int c, int b) { return bar(c, b); };
    const auto q_empty = [&](int c, int b) { return bar(c, 2 + b); };
    const auto kv_full = [&](int c, int r) { return bar(c, 4 + r); };
    const auto kv_empty = [&](int c, int r) { return bar(c, 4 + RING + r); };

    // the block: head h, query rows row0 .. row0 + 63, windows bc, bc + nblk, ...; its i-th window goes to
    // consumer i % 2
    const int rtiles = (n + ROWS - 1) / ROWS;
    const int ncombo = heads * rtiles;
    const int combo = blockIdx.x % ncombo, bc = blockIdx.x / ncombo;
    const int h = combo % heads, row0 = (combo / heads) * ROWS;
    const int mwin = bc < windows ? (windows - bc + nblk - 1) / nblk : 0;
    const int nch = (m + CK - 1) / CK;  // key chunks a window
    const int tid = threadIdx.x;

    // full: each loader thread's copies landed; empty: each consumer thread done with the operands
    if (tid == 0) {
        for (int c = 0; c < 2; ++c)
            for (int i = 0; i < L::BARS_PER; ++i) mbar_init(bar(c, i), (i < 2 || (i >= 4 && i < 4 + RING)) ? LOADER : 128);
        mbar_fence_init();
    }
    // the Q buffers and chunk slots zero
    uint4* z = reinterpret_cast<uint4*>(smem + L::BIAS);
    for (int i = tid; i < 2 * L::CONSUMER / 16; i += THREADS) z[i] = make_uint4(0u, 0u, 0u, 0u);
    fence_async_shared();
    __syncthreads();

    // the warp from lane 0: uniform in the compiler's eyes
    const int warp = __shfl_sync(0xffffffffu, tid >> 5, 0);
    if (warp >= 8) {
        // the producer: warps 8-9 feed consumer 0, warps 10-11 consumer 1, each window's Q rows and then its
        // chunks of K and V rows, as far ahead as the consumer's buffers and slots allow
        setmaxnreg_dec<40>();
        const int cl = (warp - 8) >> 1;
        const int t = (tid - CONSUMERS) % LOADER;
        const int mine = (mwin - cl + 1) / 2;
        for (int it = 0; it < mine; ++it) {
            const long long w = bc + (long long)(2 * it + cl) * nblk;
            const int b = it & 1;
            mbar_wait(q_empty(cl, b), ((it >> 1) & 1) ^ 1);  // the buffer's last use, by window it - 2
            stage_rows<T, DP, L::QGP>(q_at(cl, b), q + (size_t)w * wsq + (size_t)h * hd + (size_t)row0 * ldq, ldq,
                                      min(ROWS, n - row0), min(ROWS, n - row0), hd, vb, t, LOADER);
            cp_async_arrive(q_full(cl, b));
            const T* kw = k + (size_t)w * wskv + (size_t)h * hd;
            const T* vw = v + (size_t)w * wskv + (size_t)h * hd;
            for (int c = 0; c < nch; ++c) {
                const int g = it * nch + c, r = g % RING;
                const int live = min(CK, m - c * CK);
                mbar_wait(kv_empty(cl, r), ((g / RING) & 1) ^ 1);  // the slot's last use, by chunk g - RING
                stage_rows<T, DP, L::KGP>(k_at(cl, r), kw + (size_t)c * CK * ldkv, ldkv, live, CK, hd, vb, t, LOADER);
                stage_rows<T, DP, L::KGP>(v_at(cl, r), vw + (size_t)c * CK * ldkv, ldkv, live, CK, hd, vb, t, LOADER);
                cp_async_arrive(kv_full(cl, r));
            }
        }
        asm volatile("cp.async.wait_all;\n" ::: "memory");
    } else {
        setmaxnreg_inc<232>();
        // the block's bias rows over scale, zero past n and m, while the
        // producer stages the first windows: four columns a thread at a
        // time, 16-byte loads where m is a multiple of 4
        {
            const float inv_scale = 1.f / scale;
            const float* bh = bias + ((size_t)h * n + row0) * m;
            const bool vec4 = m % 4 == 0;
            const int cols = nch * CK;
            for (int i = tid; i < ROWS * cols / 4; i += CONSUMERS) {
                const int r = i / (cols / 4), col = (i % (cols / 4)) * 4;
                const float* br = bh + (size_t)r * m + col;
                float4 b = make_float4(0.f, 0.f, 0.f, 0.f);
                if (row0 + r < n) {
                    if (vec4) {
                        if (col < m) b = *reinterpret_cast<const float4*>(br);
                    } else {
                        b.x = col < m ? br[0] : 0.f;
                        b.y = col + 1 < m ? br[1] : 0.f;
                        b.z = col + 2 < m ? br[2] : 0.f;
                        b.w = col + 3 < m ? br[3] : 0.f;
                    }
                }
                *reinterpret_cast<float4*>(bsm + r * L::BP + col) =
                    make_float4(b.x * inv_scale, b.y * inv_scale, b.z * inv_scale, b.w * inv_scale);
            }
        }
        named_sync(BAR_BIAS, CONSUMERS);
        const int cw = warp >> 2;  // this consumer warpgroup
        const int lane = tid & 31, g4 = lane >> 2, t4 = lane & 3;
        // accumulator (m64 x N): lane holds rows rl0 and rl1 of the tile, of
        // every 8 columns 8 j + 2 t4 and + 1 (wgmma.cuh)
        const int rl0 = (warp & 3) * 16 + g4, rl1 = rl0 + 8;
        const int r0 = row0 + rl0, r1 = row0 + rl1;  // within the window
        const float scale_log2e = scale * 1.4426950408889634f;
        const int C = heads * hd;
        const int mine = (mwin - cw + 1) / 2;  // this consumer's windows: 2 it + cw
#pragma unroll 1
        for (int it = 0; it < mine; ++it) {
            const long long w = bc + (long long)(2 * it + cw) * nblk;
            const int b = it & 1;
            float o[DP / 2];
#pragma unroll
            for (int x = 0; x < DP / 2; ++x) o[x] = 0.f;
            float mr0 = -INFINITY, mr1 = -INFINITY, l0 = 0.f, l1 = 0.f;  // the rows' running max and sum
            mbar_wait(q_full(cw, b), (it >> 1) & 1);

#pragma unroll 1
            for (int c = 0; c < nch; ++c) {
                const int g = it * nch + c, r = g % RING;
                // S = bias / scale + Q K^T over the chunk's keys: A (64 rows x
                // 16 dims) and B (16 dims x CK keys) K-major, a k16 step the
                // next two groups of 8 columns; the accumulators end as the
                // scores over scale (scale > 0)
                float s[CK / 2];
#pragma unroll
                for (int j = 0; j < CK / 8; ++j) {
                    const float2 b0 = *reinterpret_cast<const float2*>(bsm + rl0 * L::BP + c * CK + j * 8 + t4 * 2);
                    const float2 b1 = *reinterpret_cast<const float2*>(bsm + rl1 * L::BP + c * CK + j * 8 + t4 * 2);
                    s[4 * j] = b0.x;
                    s[4 * j + 1] = b0.y;
                    s[4 * j + 2] = b1.x;
                    s[4 * j + 3] = b1.y;
                }
                mbar_wait(kv_full(cw, r), (g / RING) & 1);
                fence_async_shared();  // the loaders' copies, visible to wgmma
                fence_registers(s);
                wgmma_fence();
#pragma unroll
                for (int kk = 0; kk < DP / 16; ++kk)
                    Wgmma<CK>::template ss<T>(s, wgmma_desc(q_at(cw, b) + 2 * kk * L::QGP, L::QGP, 128),
                                              wgmma_desc(k_at(cw, r) + 2 * kk * L::KGP, L::KGP, 128), 1);
                wgmma_commit();
                wgmma_wait<0>();
                fence_registers(s);
                if (c == nch - 1) mbar_arrive(q_empty(cw, b));

                // -inf past the last key, then the rows' new max over this
                // chunk and the chunks before (a quad of lanes holds a row)
                const int k0 = c * CK + t4 * 2;
                if (c * CK + CK > m) {
#pragma unroll
                    for (int j = 0; j < CK / 8; ++j) {
                        if (k0 + j * 8 >= m) s[4 * j] = s[4 * j + 2] = -INFINITY;
                        if (k0 + j * 8 + 1 >= m) s[4 * j + 1] = s[4 * j + 3] = -INFINITY;
                    }
                }
                float mx0 = mr0, mx1 = mr1;
#pragma unroll
                for (int j = 0; j < CK / 8; ++j) {
                    mx0 = fmaxf(mx0, fmaxf(s[4 * j], s[4 * j + 1]));
                    mx1 = fmaxf(mx1, fmaxf(s[4 * j + 2], s[4 * j + 3]));
                }
#pragma unroll
                for (int off = 1; off < 4; off <<= 1) {
                    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
                    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
                }
                // every chunk holds a key, so the max is finite from the first
                // chunk on, and the first chunk's rescale is 2^-inf = 0
                const float c0 = ex2((mr0 - mx0) * scale_log2e), c1 = ex2((mr1 - mx1) * scale_log2e);
                mr0 = mx0;
                mr1 = mx1;
                l0 *= c0;
                l1 *= c1;
#pragma unroll
                for (int j = 0; j < DP / 8; ++j) {
                    o[4 * j] *= c0;
                    o[4 * j + 1] *= c0;
                    o[4 * j + 2] *= c1;
                    o[4 * j + 3] *= c1;
                }
                // P = 2^((s - max) scale log2(e)), rounded to T: the A fragment
                // of k16 step ks is the accumulators of column groups 2 ks and
                // 2 ks + 1
                const float neg0 = -mx0 * scale_log2e, neg1 = -mx1 * scale_log2e;
                uint32_t pa[CK / 16][4];
#pragma unroll
                for (int ks = 0; ks < CK / 16; ++ks) {
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

                // O += P V: B (16 keys x DP dims) is V stored key-major,
                // MN-major for wgmma (8 keys 128 bytes apart, groups of 8 dims
                // a group pitch apart)
                fence_registers(o);
                wgmma_fence();
#pragma unroll
                for (int ks = 0; ks < CK / 16; ++ks)
                    Wgmma<DP>::template rs<T>(o, pa[ks], wgmma_desc(v_at(cw, r) + ks * 256, 128, L::KGP), 1);
                wgmma_commit();
                wgmma_wait<0>();
                fence_registers(o);
#pragma unroll
                for (int ks = 0; ks < CK / 16; ++ks)  // P's registers stay P's until the products are done
                    asm volatile("" ::"r"(pa[ks][0]), "r"(pa[ks][1]), "r"(pa[ks][2]), "r"(pa[ks][3]) : "memory");
                mbar_arrive(kv_empty(cw, r));
            }

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
    }
}

// Widest load (bytes) that every staged row start allows: the pointers, the
// window and token pitches and the head offsets must all be multiples of it.
int pick_vb(const void* q, const void* k, const void* v, long long ldq, long long wsq, long long ldkv,
            long long wskv, int hd, int es) {
    const uintptr_t a = reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
                        reinterpret_cast<uintptr_t>(v) | static_cast<uintptr_t>(ldq * es) |
                        static_cast<uintptr_t>(wsq * es) | static_cast<uintptr_t>(ldkv * es) |
                        static_cast<uintptr_t>(wskv * es) | static_cast<uintptr_t>(hd * es);
    for (int vb = 16; vb > es; vb >>= 1)
        if (a % vb == 0) return vb;
    return es;
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

}  // namespace

// The rule of the shapes the kernel takes (n queries, m keys, head_dim hd,
// elements of element_bytes): 1 where it takes them, else 0.  16 bits; an
// even head_dim up to 32 (staged in 4-byte pieces at least, stored in pairs);
// at most MAX_KEYS keys, which the bias rows hold.  Exported, so that the
// wrapper asks the rule the launch follows.
extern "C" int resselt_window_cross_attn_supported(int n, int m, int hd, int element_bytes) {
    return element_bytes == 2 && n >= 1 && m >= 1 && m <= MAX_KEYS && hd >= 2 && hd <= MAX_HD && hd % 2 == 0;
}

namespace {

// The grid: (head, row tile) combinations x as many window chunks as keep
// one block on each SM, and no more than the windows give each consumer
// warpgroup one.
template <typename T, int DP>
cudaError_t launch(const void* q, const void* k, const void* v, const void* bias, void* out, int windows, int n, int m,
                   int heads, int hd, long long ldq, long long wsq, long long ldkv, long long wskv, float scale,
                   int vb, cudaStream_t stream) {
    auto kernel = wcross_wgmma_kernel<T, DP>;
    static int attribute_set = -1;  // the device the attribute was set on
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return err;
    if (attribute_set != dev) {
        err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, CrossLayout<DP>::SMEM);
        if (err != cudaSuccess) return err;
        attribute_set = dev;
    }
    const long long ncombo = (long long)heads * ((n + ROWS - 1) / ROWS);
    long long per_combo = num_sms() / ncombo;
    if (per_combo > (windows + 1) / 2) per_combo = (windows + 1) / 2;
    if (per_combo < 1) per_combo = 1;
    if (ncombo * per_combo > 0x7fffffffLL) return cudaErrorInvalidValue;
    kernel<<<(unsigned)(ncombo * per_combo), THREADS, CrossLayout<DP>::SMEM, stream>>>(
        static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
        static_cast<const float*>(bias), static_cast<T*>(out), windows, n, m, heads, hd, ldq, wsq, ldkv, wskv, scale,
        vb, (int)per_combo);
    return cudaGetLastError();
}

template <typename T>
int launch_entry(const void* q, const void* k, const void* v, const void* bias, void* out, int windows, int n, int m,
                 int heads, int hd, long long ldq, long long wsq, long long ldkv, long long wskv, float scale,
                 void* stream) {
    const int vb = pick_vb(q, k, v, ldq, wsq, ldkv, wskv, hd, 2);
    if (!resselt_window_cross_attn_supported(n, m, hd, 2) || bias == nullptr || windows < 1 || heads < 1 ||
        ldq < (long long)heads * hd || wsq < (long long)n * ldq || ldkv < (long long)heads * hd ||
        wskv < (long long)m * ldkv || !(scale > 0.f) || !isfinite(scale) || vb < 4)
        return (int)cudaErrorInvalidValue;
    const cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (round16(hd) == 16)
        return (int)launch<T, 16>(q, k, v, bias, out, windows, n, m, heads, hd, ldq, wsq, ldkv, wskv, scale, vb, s);
    return (int)launch<T, 32>(q, k, v, bias, out, windows, n, m, heads, hd, ldq, wsq, ldkv, wskv, scale, vb, s);
}

}  // namespace

// Plain C entry points (loaded with ctypes).  `ldq` / `wsq` are q's token
// and window pitches, `ldkv` / `wskv` those of k and v, in elements.  Each
// launches on `stream` and returns cudaGetLastError() right after the launch
// (0 = launched), or cudaErrorInvalidValue for a shape outside the rule or
// operands it cannot stage.
extern "C" int resselt_window_cross_attn_bf16(const void* q, const void* k, const void* v, const void* bias,
                                              void* out, int windows, int n, int m, int heads, int hd,
                                              long long ldq, long long wsq, long long ldkv, long long wskv,
                                              float scale, void* stream) {
    return launch_entry<__nv_bfloat16>(q, k, v, bias, out, windows, n, m, heads, hd, ldq, wsq, ldkv, wskv, scale,
                                       stream);
}

extern "C" int resselt_window_cross_attn_f16(const void* q, const void* k, const void* v, const void* bias,
                                             void* out, int windows, int n, int m, int heads, int hd, long long ldq,
                                             long long wsq, long long ldkv, long long wskv, float scale,
                                             void* stream) {
    return launch_entry<__half>(q, k, v, bias, out, windows, n, m, heads, hd, ldq, wsq, ldkv, wskv, scale, stream);
}
