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
// Two kernels, one block per (window, head):
//  * f32: exact f32 FMA on the CUDA cores (no TF32).  K_h and V_h are staged
//    in shared memory; each thread owns one query row, keeps q (scaled in
//    f32) and its output row in registers, and walks the keys in steps of
//    16 with a running max and sum.
//  * bf16: mma.sync m16n8k16 with f32 accumulation.  Q_h, K_h and V_h are
//    staged in shared memory; each of 4 warps owns 16-row query tiles and
//    walks the keys in steps of 64: S = Q K^T on the tensor cores, scale,
//    bias and mask added in f32 in registers, an online (running max / sum)
//    softmax, then P, rounded to bf16, times V on the tensor cores.  The
//    scores never leave registers.
//
// What bounds it on an H100: bytes.  At SwinIR-M's bench shape (16,384
// windows of 64 tokens, C 180, 6 heads, bf16) one launch reads q, k, v and
// writes O, 4 x 377 MB, against 48 GFLOP: 0.45 ms at 3.35 TB/s, 0.05 ms at
// 989 TFLOP/s.  The TPU kernel's 128-lane channel padding, its n == 128
// gate and its static per-head lane slices exist for the TPU's vector
// layout and do not carry over.  What this design does about the bytes: it
// reads each q/k/v element once (the neighbouring heads of a window are
// neighbouring blocks, so a token row's sectors are shared in L2), keeps
// the 64 x 64 f32 scores of a head in registers, and writes O once.  Head
// slices start at multiples of head_dim * 2 bytes (60 B at head_dim 30), so
// rows are staged with the widest cp.async copies (16, 8 or 4 bytes) that
// the pointers, the pitches and head_dim allow, all in flight at once: a
// block's staging is one memory latency, not one per row.  The bias and
// mask are read from L2 in 8-byte pairs (96 KB of bias and 16.8 MB of mask
// at the bench shape).  What this simple design leaves on the table:
// mma.sync instead of wgmma; a block stages, waits, then computes (only
// other blocks on the SM overlap its loads); about 116 registers a thread
// allow 4 blocks of 4 warps per SM; head_dim 30 is padded to 32 in the
// products; every (window, head) block re-reads its bias and mask from L2.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int MAX_N = 256;
constexpr int MAX_HD = 64;
constexpr int BF16_WARPS = 4;
constexpr int KT = 64;   // keys per softmax step (bf16)
constexpr int JT = 16;   // keys per softmax step (f32)

__host__ __device__ __forceinline__ int round16(int x) { return (x + 15) & ~15; }

// Stage rows [0, NP) of one head (hd elements at src + row * ld) into
// shared memory at dst + row * S, zero past n rows and hd columns.  With
// VB = 4, 8 or 16 (hd, ld, src and S aligned to VB bytes) every copy is a
// cp.async, all in flight at once, that zero-fills outside the head; a
// 2-byte head (odd bf16 head_dim) is staged with plain loads.  The caller
// waits with cp_async_wait_all() and a barrier.
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
                                          long long ld) {
    constexpr int E = VB / (int)sizeof(T);
    const int per_row = DP / E;
    for (int i = threadIdx.x; i < NP * per_row; i += blockDim.x) {
        const int row = i / per_row, col = (i % per_row) * E;
        const bool valid = row < n && col < hd;
        if constexpr (VB >= 4) {
            cp_async<VB>(dst + row * S + col, valid ? src + row * ld + col : src, valid);
        } else {
            dst[row * S + col] = valid ? src[row * ld + col] : T();
        }
    }
}

template <typename T>
__device__ __forceinline__ void stage(T* dst, const T* __restrict__ src, int n, int NP, int hd, int DP, int S,
                                      long long ld, int vb) {
    switch (vb) {
        case 16: stage_vec<T, 16>(dst, src, n, NP, hd, DP, S, ld); break;
        case 8: stage_vec<T, 8>(dst, src, n, NP, hd, DP, S, ld); break;
        case 4: stage_vec<T, 4>(dst, src, n, NP, hd, DP, S, ld); break;
        default:
            if constexpr (sizeof(T) == 2) stage_vec<T, 2>(dst, src, n, NP, hd, DP, S, ld);
            break;
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
    stage<float>(ks, k + base, n, NP, hd, DP, DP, ld, vb);
    stage<float>(vs, v + base, n, NP, hd, DP, DP, ld, vb);
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
// bf16: mma.sync m16n8k16, 4 warps, 16 query rows per warp tile.
// ---------------------------------------------------------------------------

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
    const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(p));
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
                 : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
                 : "r"(a));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const void* p) {
    const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(p));
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
                 : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
                 : "r"(a));
}

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Two neighbouring f32 values p[col], p[col + 1] (0 past n); one 8-byte
// load where the row length n is even (col is even).
__device__ __forceinline__ float2 load2(const float* __restrict__ p, int col, int n, bool vec2) {
    if (vec2 && col < n) return *reinterpret_cast<const float2*>(p + col);
    return make_float2(col < n ? p[col] : 0.f, col + 1 < n ? p[col + 1] : 0.f);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
    const __nv_bfloat162 p = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<const uint32_t*>(&p);
}

template <int DP>
__global__ void __launch_bounds__(BF16_WARPS * 32)
wattn_bf16_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                  const __nv_bfloat16* __restrict__ v, const float* __restrict__ bias,
                  const float* __restrict__ mask, __nv_bfloat16* __restrict__ out, int n, int heads, int hd,
                  long long ld, long long wstride, int nw, float scale, int vb) {
    constexpr int S = DP + 8;  // row stride in bf16 (conflict-free ldmatrix)
    extern __shared__ __align__(16) unsigned char smem[];
    const int NP = round16(n);
    __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(smem);
    __nv_bfloat16* ks = qs + NP * S;
    __nv_bfloat16* vs = ks + NP * S;
    const long long blk = blockIdx.x;
    const int h = (int)(blk % heads);
    const long long w = blk / heads;
    const size_t base = (size_t)w * wstride + (size_t)h * hd;
    stage<__nv_bfloat16>(qs, q + base, n, NP, hd, DP, S, ld, vb);
    stage<__nv_bfloat16>(ks, k + base, n, NP, hd, DP, S, ld, vb);
    stage<__nv_bfloat16>(vs, v + base, n, NP, hd, DP, S, ld, vb);
    cp_async_wait_all();
    __syncthreads();

    const int warp = threadIdx.x >> 5;
    const int lane = threadIdx.x & 31;
    const int g = lane >> 2, t4 = lane & 3;
    const float* bh = bias + (size_t)h * n * n;
    const float* mw = mask != nullptr ? mask + (size_t)(w % nw) * n * n : nullptr;
    const int C = heads * hd;
    __nv_bfloat16* ow = out + (size_t)w * n * C + (size_t)h * hd;
    const bool pairs = (C % 2 == 0) && (hd % 2 == 0);
    const bool vec2 = (n % 2) == 0;

    for (int mt = warp; mt < NP / 16; mt += BF16_WARPS) {
        // A (16 query rows x 16 dims, row-major): lane gives the address of
        // row lane % 16, dims (lane / 16) * 8 ..
        uint32_t qa[DP / 16][4];
#pragma unroll
        for (int kk = 0; kk < DP / 16; ++kk)
            ldmatrix_x4(qa[kk], qs + (mt * 16 + (lane & 15)) * S + kk * 16 + (lane >> 4) * 8);

        float o[DP / 8][4];
#pragma unroll
        for (int i = 0; i < DP / 8; ++i)
#pragma unroll
            for (int e = 0; e < 4; ++e) o[i][e] = 0.f;
        float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;
        // accumulator (m16 x n8): lane holds rows g and g + 8, columns t4 * 2 and + 1
        const int r0 = mt * 16 + g, r1 = r0 + 8;

        for (int kc = 0; kc < NP; kc += KT) {
            const int nk = min(KT, NP - kc);  // a multiple of 16
            float s[KT / 8][4];
#pragma unroll
            for (int t = 0; t < KT / 8; ++t)
#pragma unroll
                for (int e = 0; e < 4; ++e) s[t][e] = 0.f;
            // S = Q K^T.  B (16 dims x 8 keys, "col"): K rows are keys, so a
            // non-transposed ldmatrix gives it; lane gives the address of key
            // (lane & 7) + (lane / 16) * 8, dims ((lane / 8) & 1) * 8 ..
#pragma unroll
            for (int j = 0; j < KT / 16; ++j) {
                if (j * 16 < nk) {
#pragma unroll
                    for (int kk = 0; kk < DP / 16; ++kk) {
                        uint32_t b[4];
                        ldmatrix_x4(b, ks + (kc + j * 16 + (lane & 7) + ((lane >> 4) << 3)) * S + kk * 16 +
                                           ((lane >> 3) & 1) * 8);
                        mma_bf16(s[2 * j], qa[kk], b[0], b[1]);
                        mma_bf16(s[2 * j + 1], qa[kk], b[2], b[3]);
                    }
                }
            }
            // scale, bias and mask in f32; -inf past the last key
            float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
            for (int t = 0; t < KT / 8; ++t) {
                const int col = kc + t * 8 + t4 * 2;
                const bool live = t * 8 < nk;
                float2 b0 = make_float2(0.f, 0.f), b1 = b0, k0 = b0, k1 = b0;
                if (live && r0 < n) {
                    b0 = load2(bh + r0 * n, col, n, vec2);
                    if (mw != nullptr) k0 = load2(mw + r0 * n, col, n, vec2);
                }
                if (live && r1 < n) {
                    b1 = load2(bh + r1 * n, col, n, vec2);
                    if (mw != nullptr) k1 = load2(mw + r1 * n, col, n, vec2);
                }
                const bool c0 = live && col < n, c1 = live && col + 1 < n;
                s[t][0] = c0 ? s[t][0] * scale + b0.x + k0.x : -INFINITY;
                s[t][1] = c1 ? s[t][1] * scale + b0.y + k0.y : -INFINITY;
                s[t][2] = c0 ? s[t][2] * scale + b1.x + k1.x : -INFINITY;
                s[t][3] = c1 ? s[t][3] * scale + b1.y + k1.y : -INFINITY;
                mx0 = fmaxf(mx0, fmaxf(s[t][0], s[t][1]));
                mx1 = fmaxf(mx1, fmaxf(s[t][2], s[t][3]));
            }
            // the four lanes of a quad hold one row
#pragma unroll
            for (int off = 1; off < 4; off <<= 1) {
                mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
                mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
            }
            // column 0 lies in the first step, so the running max is finite
            const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
            const float c0 = __expf(m0 - mn0), c1 = __expf(m1 - mn1);
            m0 = mn0;
            m1 = mn1;
            l0 *= c0;
            l1 *= c1;
#pragma unroll
            for (int i = 0; i < DP / 8; ++i) {
                o[i][0] *= c0;
                o[i][1] *= c0;
                o[i][2] *= c1;
                o[i][3] *= c1;
            }
#pragma unroll
            for (int t = 0; t < KT / 8; ++t) {
                s[t][0] = __expf(s[t][0] - mn0);
                s[t][1] = __expf(s[t][1] - mn0);
                s[t][2] = __expf(s[t][2] - mn1);
                s[t][3] = __expf(s[t][3] - mn1);
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
                    const uint32_t pa[4] = {pack_bf16(s[2 * j][0], s[2 * j][1]), pack_bf16(s[2 * j][2], s[2 * j][3]),
                                            pack_bf16(s[2 * j + 1][0], s[2 * j + 1][1]),
                                            pack_bf16(s[2 * j + 1][2], s[2 * j + 1][3])};
#pragma unroll
                    for (int np = 0; np < DP / 16; ++np) {
                        uint32_t b[4];
                        ldmatrix_x4_trans(b, vs + (kc + j * 16 + (lane & 15)) * S + np * 16 + (lane >> 4) * 8);
                        mma_bf16(o[2 * np], pa, b[0], b[1]);
                        mma_bf16(o[2 * np + 1], pa, b[2], b[3]);
                    }
                }
            }
        }

#pragma unroll
        for (int off = 1; off < 4; off <<= 1) {
            l0 += __shfl_xor_sync(0xffffffffu, l0, off);
            l1 += __shfl_xor_sync(0xffffffffu, l1, off);
        }
        const float i0 = 1.f / l0, i1 = 1.f / l1;
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
                __nv_bfloat16* p = ow + (size_t)row * C + d;
                if (pairs) {
                    *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a0, a1);
                } else {
                    p[0] = __float2bfloat16(a0);
                    if (d + 1 < hd) p[1] = __float2bfloat16(a1);
                }
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

bool bad_shape(const void* bias, int windows, int n, int heads, int hd, long long ld, long long wstride, int nw) {
    return bias == nullptr || windows <= 0 || n < 1 || n > MAX_N || heads < 1 || hd < 1 || hd > MAX_HD ||
           ld < (long long)heads * hd || wstride < (long long)n * ld || nw < 1 || windows % nw != 0 ||
           (long long)windows * heads > 0x7fffffffLL;
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

template <int DP>
cudaError_t launch_bf16(const void* q, const void* k, const void* v, const void* bias, const void* mask, void* out,
                        int windows, int n, int heads, int hd, long long ld, long long wstride, int nw, float scale,
                        cudaStream_t stream) {
    const size_t smem = (size_t)3 * round16(n) * (DP + 8) * sizeof(__nv_bfloat16);
    cudaError_t err = cudaFuncSetAttribute(wattn_bf16_kernel<DP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           (int)smem);
    if (err != cudaSuccess) return err;
    const int vb = pick_vb(q, k, v, ld, wstride, hd, 2);
    wattn_bf16_kernel<DP><<<windows * heads, BF16_WARPS * 32, smem, stream>>>(
        static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
        static_cast<const __nv_bfloat16*>(v), static_cast<const float*>(bias), static_cast<const float*>(mask),
        static_cast<__nv_bfloat16*>(out), n, heads, hd, ld, wstride, nw, scale, vb);
    return cudaGetLastError();
}

}  // namespace

// Plain C entry points (loaded with ctypes).  `ld` and `wstride` are the
// token and window pitches of q, k and v in elements; `mask` may be null.
// Each launches on `stream` and returns cudaGetLastError() right after the
// launch (0 = launched).
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
                                        const void* mask, void* out, int windows, int n, int heads, int hd,
                                        long long ld, long long wstride, int nw, float scale, void* stream) {
    if (bad_shape(bias, windows, n, heads, hd, ld, wstride, nw)) return (int)cudaErrorInvalidValue;
    const cudaStream_t s = static_cast<cudaStream_t>(stream);
    switch (head_pad(hd)) {
        case 16: return (int)launch_bf16<16>(q, k, v, bias, mask, out, windows, n, heads, hd, ld, wstride, nw, scale, s);
        case 32: return (int)launch_bf16<32>(q, k, v, bias, mask, out, windows, n, heads, hd, ld, wstride, nw, scale, s);
        default: return (int)launch_bf16<64>(q, k, v, bias, mask, out, windows, n, heads, hd, ld, wstride, nw, scale, s);
    }
}
