// Same-padded k x k convolution + bias + activation on NHWC tensors, for
// Hopper: PLKSR's partial large-kernel conv (k = 17, 16 -> 16 channels).
//
// Replaces resselt_tpu/ops/fused_conv.py::_lk_kernel, which the JAX package
// reaches through fused_conv_lk.  It computes what that kernel computes:
//   y[n, h, w, co] = act(b[co] + sum_{dy, dx < k, ci} x[n, h + dy - k/2, w + dx - k/2, ci] * W[co, ci, dy, dx])
// with zero padding and act linear or leaky relu 0.2.  Layouts are the
// port's own: y is contiguous NHWC; x is NHWC whose pixels lie `pitch`
// elements apart with the Cin channels next to each other, so a channel
// slice x[..., :pdim] of a wider tensor is read in place (no copy); w is repacked
// once by the caller into taps [dy * k + dx][Cin][Cout] in x's dtype; b is
// f32 (or null).  Takes k odd <= 31, Cout <= 64 and any Cin, H, W >= 1.
//
// Two kernels:
//  * f32: exact f32 FMA on the CUDA cores (no TF32), held at 1e-4 against
//    an f32 reference.
//  * bf16 / fp16 (one template over the 16-bit type): implicit GEMM on the
//    tensor cores through mma.sync m16n8k16 with f32 accumulation (M =
//    output pixels, N = Cout, K = k * k * Cin; at Cin = 16 each tap is one
//    k16 step); bias, activation and one rounding to the 16-bit type at the
//    store.  bf16 is the path PLKSR serves in.
//
// What bounds it on an H100: operations.  At PLKSR's bench shape (16 x
// 256 x 256, 16 -> 16, k = 17) the conv does 155 GFLOP on 67 MB of bf16
// traffic, about 2300 FLOP per byte, far above the card's ridge.  The TPU
// kernel's column packing into 128 lanes, its host-built group-shifted
// input copies and its per-plane DMA ring exist for the TPU's vector
// layout and do not carry over.  Here a block owns an output tile (bf16:
// 32 x 16 pixels, f32: 16 x 16) and every output channel; per 16 (f32: 8)
// input channels it stages the tile's (TH + k - 1) x (TW + k - 1) halo in
// shared memory, and per kernel row dy the k taps' weights (the f32 weights
// of a 17 x 17 16 -> 16 conv are 296 KB and do not fit whole), then
// accumulates the row's k taps in registers.  Shared-memory strides are
// padded (48 B per halo pixel, 16 * n + 8 elements per weight row) so that
// ldmatrix is free of bank conflicts.  What this simple design leaves on
// the table: mma.sync instead of wgmma; synchronous staging (no cp.async /
// TMA ring), with a barrier per kernel row; each A fragment is reloaded
// from shared memory for every tap, although neighbouring taps see the
// same pixels shifted by one column; Cin = 8 fills half of each k16 step.

#include <cuda_runtime.h>
#include <stdint.h>

#include "half16.cuh"

namespace {

constexpr int MAX_K = 31;
constexpr int MAX_COUT = 64;
constexpr int THREADS = 256;

enum Act { ACT_LINEAR = 0, ACT_LRELU = 1 };

__device__ __forceinline__ float activate(float v, int act) {
    return (act == ACT_LRELU && v < 0.f) ? 0.2f * v : v;
}

// ---------------------------------------------------------------------------
// f32: CUDA-core FMA.  A block of 32 * ng threads (ng = ceil(Cout / 8))
// owns a 16 x 16-pixel tile; thread (pg, cg) owns 8 consecutive pixels of
// tile row pg / 2 (columns (pg % 2) * 8 ..) and channels cg * 8 ...
// ---------------------------------------------------------------------------

constexpr int TH32 = 16;
constexpr int TW32 = 16;
constexpr int KC32 = 8;          // input channels per stage
constexpr int XPS32 = KC32 + 1;  // halo pixel stride in floats (odd: fewer bank conflicts)

__host__ __device__ inline int f32_halo_floats(int k) {
    return ((TH32 + k - 1) * (TW32 + k - 1) * XPS32 + 3) / 4 * 4;  // 16-byte aligned end
}

__global__ void __launch_bounds__(THREADS)
conv_lk_f32_kernel(const float* __restrict__ x, const float* __restrict__ w, const float* __restrict__ bias,
                   float* __restrict__ y, int H, int W, int Cin, int Cout, int pitch, int k, int act, int ng) {
    extern __shared__ __align__(16) float smem32[];
    const int HWD = TW32 + k - 1;
    const int HH = TH32 + k - 1;
    const int CO = ng * 8;  // weight row stride in floats
    float* xs = smem32;
    float* ws = smem32 + f32_halo_floats(k);

    const int tid = threadIdx.x;
    const int nthreads = blockDim.x;
    const int n = blockIdx.z;
    const int oy0 = blockIdx.y * TH32;
    const int ox0 = blockIdx.x * TW32;
    const int pad = k / 2;
    const int cg = tid % ng;
    const int pg = tid / ng;
    const int ty = pg >> 1;
    const int tx = (pg & 1) * 8;
    const float* xn = x + (size_t)n * H * W * pitch;

    float acc[8][8];
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

    for (int c0 = 0; c0 < Cin; c0 += KC32) {
        for (int i = tid; i < HH * HWD * KC32; i += nthreads) {
            const int kk = i % KC32, p = i / KC32;
            const int iy = oy0 - pad + p / HWD, ix = ox0 - pad + p % HWD;
            float v = 0.f;
            if (c0 + kk < Cin && iy >= 0 && iy < H && ix >= 0 && ix < W)
                v = xn[((size_t)iy * W + ix) * pitch + c0 + kk];
            xs[p * XPS32 + kk] = v;
        }
        for (int dy = 0; dy < k; ++dy) {
            // weights of kernel row dy: k taps x KC32 input channels x CO outputs
            for (int i = tid; i < k * KC32 * CO; i += nthreads) {
                const int co = i % CO, r = i / CO;  // r = dx * KC32 + kk
                const int kk = r % KC32, dx = r / KC32;
                float v = 0.f;
                if (c0 + kk < Cin && co < Cout) v = w[((size_t)(dy * k + dx) * Cin + c0 + kk) * Cout + co];
                ws[r * CO + co] = v;
            }
            __syncthreads();

#pragma unroll 1
            for (int kk = 0; kk < KC32; ++kk) {
                const float* xr = xs + ((ty + dy) * HWD + tx) * XPS32 + kk;
                float in[8];
#pragma unroll
                for (int i = 0; i < 8; ++i) in[i] = xr[i * XPS32];
#pragma unroll 1
                for (int dx = 0; dx < k; ++dx) {
                    const float* wr = ws + (dx * KC32 + kk) * CO + cg * 8;
                    const float4 w0 = *reinterpret_cast<const float4*>(wr);
                    const float4 w1 = *reinterpret_cast<const float4*>(wr + 4);
                    const float wv[8] = {w0.x, w0.y, w0.z, w0.w, w1.x, w1.y, w1.z, w1.w};
#pragma unroll
                    for (int i = 0; i < 8; ++i)
#pragma unroll
                        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(in[i], wv[j], acc[i][j]);
                    // slide the 8-pixel window one column right
#pragma unroll
                    for (int i = 0; i < 7; ++i) in[i] = in[i + 1];
                    if (dx + 1 < k) in[7] = xr[(8 + dx) * XPS32];
                }
            }
            __syncthreads();
        }
    }

    const int oy = oy0 + ty;
    if (oy >= H) return;
    float bj[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
        const int co = cg * 8 + j;
        bj[j] = (bias != nullptr && co < Cout) ? bias[co] : 0.f;
    }
#pragma unroll
    for (int i = 0; i < 8; ++i) {
        const int ox = ox0 + tx + i;
        if (ox >= W) break;
        float* yp = y + (((size_t)n * H + oy) * W + ox) * Cout;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
            const int co = cg * 8 + j;
            if (co < Cout) yp[co] = activate(acc[i][j] + bj[j], act);
        }
    }
}

// ---------------------------------------------------------------------------
// bf16 / fp16 (template parameter T): mma.sync m16n8k16 implicit GEMM.  A
// block of 8 warps owns a 32 x 16-pixel tile; warp w owns tile rows 4w ..
// 4w + 3 (four m16 tiles of 16 pixels) and all Cout channels (2 * NP n8
// tiles).
// ---------------------------------------------------------------------------

constexpr int TH = 32;
constexpr int TW = 16;
constexpr int MT = TH / 8;   // m16 tiles per warp
constexpr int KC = 16;       // input channels per stage: one k16 step per tap
constexpr int XPS = KC + 8;  // halo pixel stride in bf16 (48 B: conflict-free ldmatrix)

__host__ __device__ inline int bf16_halo_elems(int k) { return (TH + k - 1) * (TW + k - 1) * XPS; }

template <typename T, int NP>  // T: the 16-bit type; NP pairs of n8 tiles: Cout <= 16 * NP
__global__ void __launch_bounds__(THREADS)
conv_lk_h16_kernel(const T* __restrict__ x, const T* __restrict__ w,
                   const float* __restrict__ bias, T* __restrict__ y, int H, int W, int Cin,
                   int Cout, int pitch, int k, int act, int vec_x, int vec_w) {
    using HT = Half16<T>;
    constexpr int BN = NP * 16;
    constexpr int WPS = BN + 8;  // weight row stride in bf16 (conflict-free ldmatrix.trans)
    extern __shared__ __align__(16) unsigned char smem[];
    const int HWD = TW + k - 1;
    const int HH = TH + k - 1;
    T* xs = reinterpret_cast<T*>(smem);
    T* ws = xs + bf16_halo_elems(k);  // 48 B per halo pixel keeps it 16-byte aligned

    const int tid = threadIdx.x;
    const int warp = tid >> 5;
    const int lane = tid & 31;
    const int n = blockIdx.z;
    const int oy0 = blockIdx.y * TH;
    const int ox0 = blockIdx.x * TW;
    const int pad = k / 2;
    const T* xn = x + (size_t)n * H * W * pitch;
    const T zero = HT::from_float(0.f);

    float acc[MT][2 * NP][4];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int nt = 0; nt < 2 * NP; ++nt)
#pragma unroll
            for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0.f;

    for (int c0 = 0; c0 < Cin; c0 += KC) {
        // input halo: HH x HWD pixels x KC channels, zero outside the image
        if (vec_x) {
            for (int i = tid; i < HH * HWD * (KC / 8); i += THREADS) {
                const int v = i & 1, p = i >> 1;
                const int iy = oy0 - pad + p / HWD, ix = ox0 - pad + p % HWD;
                const int ch = c0 + v * 8;
                uint4 val = make_uint4(0, 0, 0, 0);
                if (ch < Cin && iy >= 0 && iy < H && ix >= 0 && ix < W)
                    val = *reinterpret_cast<const uint4*>(xn + ((size_t)iy * W + ix) * pitch + ch);
                *reinterpret_cast<uint4*>(xs + p * XPS + v * 8) = val;
            }
        } else {
            for (int i = tid; i < HH * HWD * KC; i += THREADS) {
                const int kk = i % KC, p = i / KC;
                const int iy = oy0 - pad + p / HWD, ix = ox0 - pad + p % HWD;
                T val = zero;
                if (c0 + kk < Cin && iy >= 0 && iy < H && ix >= 0 && ix < W)
                    val = xn[((size_t)iy * W + ix) * pitch + c0 + kk];
                xs[p * XPS + kk] = val;
            }
        }

        for (int dy = 0; dy < k; ++dy) {
            // weights of kernel row dy: k taps x KC input channels x BN outputs, zero past the ends
            if (vec_w) {
                for (int i = tid; i < k * KC * (BN / 8); i += THREADS) {
                    const int v = i % (BN / 8), r = i / (BN / 8);  // r = dx * KC + kk
                    const int kk = r % KC, dx = r / KC;
                    const int co = v * 8;
                    uint4 val = make_uint4(0, 0, 0, 0);
                    if (c0 + kk < Cin && co < Cout)
                        val = *reinterpret_cast<const uint4*>(w + ((size_t)(dy * k + dx) * Cin + c0 + kk) * Cout + co);
                    *reinterpret_cast<uint4*>(ws + r * WPS + v * 8) = val;
                }
            } else {
                for (int i = tid; i < k * KC * BN; i += THREADS) {
                    const int co = i % BN, r = i / BN;
                    const int kk = r % KC, dx = r / KC;
                    T val = zero;
                    if (c0 + kk < Cin && co < Cout) val = w[((size_t)(dy * k + dx) * Cin + c0 + kk) * Cout + co];
                    ws[r * WPS + co] = val;
                }
            }
            __syncthreads();

#pragma unroll 1
            for (int dx = 0; dx < k; ++dx) {
                // A (16 pixels x 16 channels, row-major): lane gives the address
                // of pixel lane % 16, channels (lane / 16) * 8 ..
                uint32_t a[MT][4];
#pragma unroll
                for (int mt = 0; mt < MT; ++mt) {
                    const int row = warp * MT + mt + dy;
                    ldmatrix_x4(a[mt], xs + (row * HWD + (lane & 15) + dx) * XPS + (lane >> 4) * 8);
                }
                // B (16 channels in x 8 out, stored k-major): lane gives the
                // address of input channel lane % 16, outputs (lane / 16) * 8 ..
                // of a pair of n8 tiles
#pragma unroll
                for (int np = 0; np < NP; ++np) {
                    uint32_t b[4];
                    ldmatrix_x4_trans(b, ws + (dx * KC + (lane & 15)) * WPS + np * 16 + (lane >> 4) * 8);
#pragma unroll
                    for (int mt = 0; mt < MT; ++mt) {
                        HT::mma(acc[mt][2 * np], a[mt], b[0], b[1]);
                        HT::mma(acc[mt][2 * np + 1], a[mt], b[2], b[3]);
                    }
                }
            }
            __syncthreads();
        }
    }

    // accumulator (m16 x n8): lane holds pixel lane / 4 (and + 8), channels
    // (lane % 4) * 2 and + 1
    const bool pairs = (Cout & 1) == 0;
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
        const int oy = oy0 + warp * MT + mt;
        if (oy >= H) continue;
#pragma unroll
        for (int nt = 0; nt < 2 * NP; ++nt) {
            const int co = nt * 8 + (lane & 3) * 2;
            if (co >= Cout) continue;
            const float b0 = bias != nullptr ? bias[co] : 0.f;
            const float b1 = (bias != nullptr && co + 1 < Cout) ? bias[co + 1] : 0.f;
#pragma unroll
            for (int half = 0; half < 2; ++half) {
                const int ox = ox0 + (lane >> 2) + half * 8;
                if (ox >= W) continue;
                const float v0 = activate(acc[mt][nt][2 * half] + b0, act);
                const float v1 = activate(acc[mt][nt][2 * half + 1] + b1, act);
                T* yp = y + (((size_t)n * H + oy) * W + ox) * Cout + co;
                if (pairs) {
                    *reinterpret_cast<uint32_t*>(yp) = HT::pack(v0, v1);
                } else {
                    yp[0] = HT::from_float(v0);
                    if (co + 1 < Cout) yp[1] = HT::from_float(v1);
                }
            }
        }
    }
}

template <typename T, int NP>
cudaError_t launch_h16(const void* x, const void* w, const void* b, void* y, int n, int h, int wd, int cin,
                        int cout, int pitch, int k, int act, cudaStream_t stream) {
    const size_t smem = (size_t)bf16_halo_elems(k) * 2 + (size_t)k * KC * (NP * 16 + 8) * 2;
    cudaError_t err = cudaFuncSetAttribute(conv_lk_h16_kernel<T, NP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           (int)smem);
    if (err != cudaSuccess) return err;
    const int vec_x = (cin % 8 == 0) && (pitch % 8 == 0) && (reinterpret_cast<uintptr_t>(x) % 16 == 0);
    const int vec_w = (cout % 8 == 0) && (reinterpret_cast<uintptr_t>(w) % 16 == 0);
    const dim3 grid((wd + TW - 1) / TW, (h + TH - 1) / TH, n);
    conv_lk_h16_kernel<T, NP><<<grid, THREADS, smem, stream>>>(
        static_cast<const T*>(x), static_cast<const T*>(w), static_cast<const float*>(b),
        static_cast<T*>(y), h, wd, cin, cout, pitch, k, act, vec_x, vec_w);
    return cudaGetLastError();
}

bool bad_shape(int n, int h, int w, int cin, int cout, int pitch, int k, int act) {
    return n <= 0 || h <= 0 || w <= 0 || cin <= 0 || cout <= 0 || cout > MAX_COUT || pitch < cin || k <= 0 ||
           k % 2 == 0 || k > MAX_K || (act != ACT_LINEAR && act != ACT_LRELU) || n > 65535 ||
           (h + TH32 - 1) / TH32 > 65535;
}

}  // namespace

// Plain C entry points (loaded with ctypes).  Each launches on `stream` and
// returns cudaGetLastError() right after the launch (0 = launched).
extern "C" int resselt_conv_lk_f32(const void* x, const void* w, const void* b, void* y, int n, int h, int wd,
                                   int cin, int cout, int pitch, int k, int act, void* stream) {
    if (bad_shape(n, h, wd, cin, cout, pitch, k, act)) return (int)cudaErrorInvalidValue;
    const int ng = (cout + 7) / 8;
    const size_t smem = ((size_t)f32_halo_floats(k) + (size_t)k * KC32 * ng * 8) * 4;
    cudaError_t err = cudaFuncSetAttribute(conv_lk_f32_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           (int)smem);
    if (err != cudaSuccess) return (int)err;
    const dim3 grid((wd + TW32 - 1) / TW32, (h + TH32 - 1) / TH32, n);
    conv_lk_f32_kernel<<<grid, 32 * ng, smem, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(x), static_cast<const float*>(w), static_cast<const float*>(b),
        static_cast<float*>(y), h, wd, cin, cout, pitch, k, act, ng);
    return (int)cudaGetLastError();
}

namespace {

template <typename T>
int launch_h16_any(const void* x, const void* w, const void* b, void* y, int n, int h, int wd, int cin, int cout,
                   int pitch, int k, int act, void* stream) {
    if (bad_shape(n, h, wd, cin, cout, pitch, k, act)) return (int)cudaErrorInvalidValue;
    const cudaStream_t s = static_cast<cudaStream_t>(stream);
    switch ((cout + 15) / 16) {
        case 1: return (int)launch_h16<T, 1>(x, w, b, y, n, h, wd, cin, cout, pitch, k, act, s);
        case 2: return (int)launch_h16<T, 2>(x, w, b, y, n, h, wd, cin, cout, pitch, k, act, s);
        case 3: return (int)launch_h16<T, 3>(x, w, b, y, n, h, wd, cin, cout, pitch, k, act, s);
        default: return (int)launch_h16<T, 4>(x, w, b, y, n, h, wd, cin, cout, pitch, k, act, s);
    }
}

}  // namespace

extern "C" int resselt_conv_lk_bf16(const void* x, const void* w, const void* b, void* y, int n, int h, int wd,
                                    int cin, int cout, int pitch, int k, int act, void* stream) {
    return launch_h16_any<__nv_bfloat16>(x, w, b, y, n, h, wd, cin, cout, pitch, k, act, stream);
}

extern "C" int resselt_conv_lk_f16(const void* x, const void* w, const void* b, void* y, int n, int h, int wd,
                                   int cin, int cout, int pitch, int k, int act, void* stream) {
    return launch_h16_any<__half>(x, w, b, y, n, h, wd, cin, cout, pitch, k, act, stream);
}
