// Same-padded 3x3 convolution + bias + activation on NHWC tensors, for Hopper.
//
// Replaces resselt_tpu/ops/fused_conv.py::_kernel, which the JAX package
// reaches through fused_conv3x3_act and fused_conv3x3_pack2.  It computes
// what that kernel computes: y = act(conv3x3(x, w, zero padding) + b), with
// act one of linear / leaky relu 0.2 / silu / mish.  The layout is the
// port's own: x and y are contiguous NHWC, w is repacked once by the caller
// into [tap = dy*3+dx][Cin][Cout] (Cout contiguous) in x's dtype, and b is
// f32 (or null).  Zero padding comes from masking the halo loads; no padded
// copy of x is made.
//
// Two kernels:
//  * f32: exact f32 FMA on the CUDA cores (no TF32), so that it holds to
//    1e-4 against an f32 reference.
//  * bf16: implicit GEMM on the tensor cores through mma.sync m16n8k16 with
//    f32 accumulation (M = pixels, N = Cout, K = 9 * Cin); the output is
//    rounded to bf16 once, after bias and activation.  This is the path
//    ESRGAN serves in.
//
// Both use one design.  A block owns a 16x16-pixel output tile and 64
// output channels.  For each chunk of input channels it stages the 18x18
// input halo and the matching slice of the 9 taps' weights in shared
// memory, then accumulates over the 9 taps in registers.  Blocks are
// independent; each loads its own halo.
//
// What bounds it on an H100: at ESRGAN's RDB shapes, tensor-core FLOPs or
// close to it.  The stage-0 producer conv (K = 576, N = 192) does about 430
// FLOP per byte it must move in bf16 (read x once, write y once), above the
// card's bf16 ridge of about 295 FLOP/B, so its floor is the 989 TFLOP/s
// dense rate; stages 1-4 (K = 288, N = 160..64) sit at 190-240 FLOP/B, just
// under the ridge.  What this simple design leaves on the table: mma.sync reaches a
// fraction of what wgmma does; staging is synchronous (no cp.async/TMA
// ring, so loads do not overlap the math of the same block); every block
// re-reads the weight slice from L2 per chunk; the 64-wide channel block
// wastes most of its work on the 64->3 last conv; outputs are stored from
// registers in 4-byte pieces rather than through shared memory.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TH = 16;          // output tile rows
constexpr int TW = 16;          // output tile columns
constexpr int HH = TH + 2;      // halo rows
constexpr int HW = TW + 2;      // halo columns
constexpr int BN = 64;          // output channels per block
constexpr int THREADS = 256;

enum Act { ACT_LINEAR = 0, ACT_LRELU = 1, ACT_SILU = 2, ACT_MISH = 3 };

__device__ __forceinline__ float activate(float v, int act) {
    switch (act) {
        case ACT_LRELU:
            return v >= 0.f ? v : 0.2f * v;
        case ACT_SILU:
            return v / (1.f + expf(-v));
        case ACT_MISH: {
            const float sp = fmaxf(v, 0.f) + log1pf(expf(-fabsf(v)));  // softplus
            return v * tanhf(sp);
        }
        default:
            return v;
    }
}

// ---------------------------------------------------------------------------
// f32: CUDA-core FMA.  Thread (pg, cg) owns 8 consecutive pixels of one tile
// row (pg / 2, columns (pg % 2) * 8 ..) and 8 consecutive channels (cg * 8 ..).
// ---------------------------------------------------------------------------

constexpr int KC32 = 8;          // input channels per stage
constexpr int XPS32 = KC32 + 1;  // halo pixel stride in floats (odd: fewer bank conflicts)

__global__ void __launch_bounds__(THREADS)
conv3x3_f32_kernel(const float* __restrict__ x, const float* __restrict__ w,
                   const float* __restrict__ bias, float* __restrict__ y,
                   int H, int W, int Cin, int Cout, int n_cb, int act) {
    __shared__ float xs[HH * HW * XPS32];
    __shared__ __align__(16) float ws[9 * KC32 * BN];

    const int tid = threadIdx.x;
    const int n = blockIdx.z / n_cb;
    const int co0 = (blockIdx.z % n_cb) * BN;
    const int oy0 = blockIdx.y * TH;
    const int ox0 = blockIdx.x * TW;
    const int cg = tid & 7;
    const int pg = tid >> 3;
    const int ty = pg >> 1;
    const int tx = (pg & 1) * 8;
    const float* xn = x + (size_t)n * H * W * Cin;

    float acc[8][8];
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

    for (int c0 = 0; c0 < Cin; c0 += KC32) {
        for (int i = tid; i < HH * HW * KC32; i += THREADS) {
            const int k = i % KC32, p = i / KC32;
            const int iy = oy0 - 1 + p / HW, ix = ox0 - 1 + p % HW;
            float v = 0.f;
            if (c0 + k < Cin && iy >= 0 && iy < H && ix >= 0 && ix < W)
                v = xn[((size_t)iy * W + ix) * Cin + c0 + k];
            xs[p * XPS32 + k] = v;
        }
        for (int i = tid; i < 9 * KC32 * BN; i += THREADS) {
            const int co = i % BN, r = i / BN;  // r = tap * KC32 + k
            const int k = r % KC32, tap = r / KC32;
            float v = 0.f;
            if (c0 + k < Cin && co0 + co < Cout)
                v = w[((size_t)tap * Cin + c0 + k) * Cout + co0 + co];
            ws[r * BN + co] = v;
        }
        __syncthreads();

#pragma unroll 1
        for (int k = 0; k < KC32; ++k) {
#pragma unroll
            for (int dy = 0; dy < 3; ++dy) {
                float in[10];
#pragma unroll
                for (int j = 0; j < 10; ++j) in[j] = xs[((ty + dy) * HW + tx + j) * XPS32 + k];
#pragma unroll
                for (int dx = 0; dx < 3; ++dx) {
                    const float* wr = ws + ((dy * 3 + dx) * KC32 + k) * BN + cg * 8;
                    const float4 w0 = *reinterpret_cast<const float4*>(wr);
                    const float4 w1 = *reinterpret_cast<const float4*>(wr + 4);
                    const float wv[8] = {w0.x, w0.y, w0.z, w0.w, w1.x, w1.y, w1.z, w1.w};
#pragma unroll
                    for (int i = 0; i < 8; ++i)
#pragma unroll
                        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(in[i + dx], wv[j], acc[i][j]);
                }
            }
        }
        __syncthreads();
    }

    const int oy = oy0 + ty;
    if (oy >= H) return;
    float bj[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
        const int co = co0 + cg * 8 + j;
        bj[j] = (bias != nullptr && co < Cout) ? bias[co] : 0.f;
    }
#pragma unroll
    for (int i = 0; i < 8; ++i) {
        const int ox = ox0 + tx + i;
        if (ox >= W) break;
        float* yp = y + (((size_t)n * H + oy) * W + ox) * Cout;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
            const int co = co0 + cg * 8 + j;
            if (co < Cout) yp[co] = activate(acc[i][j] + bj[j], act);
        }
    }
}

// ---------------------------------------------------------------------------
// bf16: mma.sync m16n8k16 implicit GEMM.  Warp w owns tile rows 2w and 2w+1
// (two m16 tiles of 16 pixels each) and all 64 channels (eight n8 tiles).
// ---------------------------------------------------------------------------

constexpr int KC = 16;       // input channels per stage: one k16 step per tap
constexpr int XPS = KC + 8;  // halo pixel stride in bf16 (48 B: conflict-free ldmatrix)
constexpr int WPS = BN + 8;  // weight row stride in bf16 (144 B: conflict-free ldmatrix.trans)

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

__global__ void __launch_bounds__(THREADS)
conv3x3_bf16_kernel(const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ w,
                    const float* __restrict__ bias, __nv_bfloat16* __restrict__ y,
                    int H, int W, int Cin, int Cout, int n_cb, int act, int vec_x, int vec_w) {
    __shared__ __align__(16) __nv_bfloat16 xs[HH * HW * XPS];
    __shared__ __align__(16) __nv_bfloat16 ws[9 * KC * WPS];

    const int tid = threadIdx.x;
    const int warp = tid >> 5;
    const int lane = tid & 31;
    const int n = blockIdx.z / n_cb;
    const int co0 = (blockIdx.z % n_cb) * BN;
    const int oy0 = blockIdx.y * TH;
    const int ox0 = blockIdx.x * TW;
    const __nv_bfloat16* xn = x + (size_t)n * H * W * Cin;
    const __nv_bfloat16 zero = __float2bfloat16(0.f);

    float acc[2][8][4];
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int nt = 0; nt < 8; ++nt)
#pragma unroll
            for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0.f;

    for (int c0 = 0; c0 < Cin; c0 += KC) {
        // input halo: HH x HW pixels x KC channels, zero outside the image
        if (vec_x) {
            for (int i = tid; i < HH * HW * (KC / 8); i += THREADS) {
                const int v = i & 1, p = i >> 1;
                const int iy = oy0 - 1 + p / HW, ix = ox0 - 1 + p % HW;
                const int ch = c0 + v * 8;
                uint4 val = make_uint4(0, 0, 0, 0);
                if (ch < Cin && iy >= 0 && iy < H && ix >= 0 && ix < W)
                    val = *reinterpret_cast<const uint4*>(xn + ((size_t)iy * W + ix) * Cin + ch);
                *reinterpret_cast<uint4*>(xs + p * XPS + v * 8) = val;
            }
        } else {
            for (int i = tid; i < HH * HW * KC; i += THREADS) {
                const int k = i % KC, p = i / KC;
                const int iy = oy0 - 1 + p / HW, ix = ox0 - 1 + p % HW;
                __nv_bfloat16 val = zero;
                if (c0 + k < Cin && iy >= 0 && iy < H && ix >= 0 && ix < W)
                    val = xn[((size_t)iy * W + ix) * Cin + c0 + k];
                xs[p * XPS + k] = val;
            }
        }
        // weights: 9 taps x KC input channels x BN output channels, zero past the ends
        if (vec_w) {
            for (int i = tid; i < 9 * KC * (BN / 8); i += THREADS) {
                const int v = i & 7, r = i >> 3;  // r = tap * KC + k
                const int k = r % KC, tap = r / KC;
                const int co = co0 + v * 8;
                uint4 val = make_uint4(0, 0, 0, 0);
                if (c0 + k < Cin && co < Cout)
                    val = *reinterpret_cast<const uint4*>(w + ((size_t)tap * Cin + c0 + k) * Cout + co);
                *reinterpret_cast<uint4*>(ws + r * WPS + v * 8) = val;
            }
        } else {
            for (int i = tid; i < 9 * KC * BN; i += THREADS) {
                const int co = i % BN, r = i / BN;
                const int k = r % KC, tap = r / KC;
                __nv_bfloat16 val = zero;
                if (c0 + k < Cin && co0 + co < Cout)
                    val = w[((size_t)tap * Cin + c0 + k) * Cout + co0 + co];
                ws[r * WPS + co] = val;
            }
        }
        __syncthreads();

#pragma unroll
        for (int tap = 0; tap < 9; ++tap) {
            const int dy = tap / 3, dx = tap % 3;
            // A (16 pixels x 16 channels, row-major): lane gives the address of
            // pixel lane % 16, channels (lane / 16) * 8 ..
            uint32_t a[2][4];
#pragma unroll
            for (int mt = 0; mt < 2; ++mt) {
                const int row = 2 * warp + mt + dy;
                ldmatrix_x4(a[mt], xs + (row * HW + (lane & 15) + dx) * XPS + (lane >> 4) * 8);
            }
            // B (16 channels in x 8 channels out, stored k-major): lane gives the
            // address of input channel lane % 16, output channels (lane / 16) * 8 ..
            // of a pair of n8 tiles
#pragma unroll
            for (int np = 0; np < 4; ++np) {
                uint32_t b[4];
                ldmatrix_x4_trans(b, ws + (tap * KC + (lane & 15)) * WPS + np * 16 + (lane >> 4) * 8);
#pragma unroll
                for (int mt = 0; mt < 2; ++mt) {
                    mma_bf16(acc[mt][2 * np], a[mt], b[0], b[1]);
                    mma_bf16(acc[mt][2 * np + 1], a[mt], b[2], b[3]);
                }
            }
        }
        __syncthreads();
    }

    // accumulator (m16 x n8): lane holds pixel lane / 4 (and + 8), channels
    // (lane % 4) * 2 and + 1
    const bool pairs = (Cout & 1) == 0;
#pragma unroll
    for (int mt = 0; mt < 2; ++mt) {
        const int oy = oy0 + 2 * warp + mt;
        if (oy >= H) continue;
#pragma unroll
        for (int nt = 0; nt < 8; ++nt) {
            const int co = co0 + nt * 8 + (lane & 3) * 2;
            if (co >= Cout) continue;
            const float b0 = bias != nullptr ? bias[co] : 0.f;
            const float b1 = (bias != nullptr && co + 1 < Cout) ? bias[co + 1] : 0.f;
#pragma unroll
            for (int half = 0; half < 2; ++half) {
                const int ox = ox0 + (lane >> 2) + half * 8;
                if (ox >= W) continue;
                const float v0 = activate(acc[mt][nt][2 * half] + b0, act);
                const float v1 = activate(acc[mt][nt][2 * half + 1] + b1, act);
                __nv_bfloat16* yp = y + (((size_t)n * H + oy) * W + ox) * Cout + co;
                if (pairs) {
                    *reinterpret_cast<__nv_bfloat162*>(yp) = __floats2bfloat162_rn(v0, v1);
                } else {
                    yp[0] = __float2bfloat16(v0);
                    if (co + 1 < Cout) yp[1] = __float2bfloat16(v1);
                }
            }
        }
    }
}

dim3 grid_for(int n, int h, int w, int cout, int* n_cb) {
    *n_cb = (cout + BN - 1) / BN;
    return dim3((w + TW - 1) / TW, (h + TH - 1) / TH, n * *n_cb);
}

bool bad_shape(int n, int h, int w, int cin, int cout, int act) {
    return n <= 0 || h <= 0 || w <= 0 || cin <= 0 || cout <= 0 || act < 0 || act > ACT_MISH ||
           (long long)n * ((cout + BN - 1) / BN) > 65535 || (h + TH - 1) / TH > 65535;
}

}  // namespace

// Plain C entry points (loaded with ctypes).  Each launches on `stream` and
// returns cudaGetLastError() right after the launch (0 = launched).
extern "C" int resselt_conv3x3_f32(const void* x, const void* w, const void* b, void* y, int n, int h,
                                   int wd, int cin, int cout, int act, void* stream) {
    if (bad_shape(n, h, wd, cin, cout, act)) return (int)cudaErrorInvalidValue;
    int n_cb;
    const dim3 grid = grid_for(n, h, wd, cout, &n_cb);
    conv3x3_f32_kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(x), static_cast<const float*>(w), static_cast<const float*>(b),
        static_cast<float*>(y), h, wd, cin, cout, n_cb, act);
    return (int)cudaGetLastError();
}

extern "C" int resselt_conv3x3_bf16(const void* x, const void* w, const void* b, void* y, int n, int h,
                                    int wd, int cin, int cout, int act, void* stream) {
    if (bad_shape(n, h, wd, cin, cout, act)) return (int)cudaErrorInvalidValue;
    int n_cb;
    const dim3 grid = grid_for(n, h, wd, cout, &n_cb);
    const int vec_x = (cin % 8 == 0) && (reinterpret_cast<uintptr_t>(x) % 16 == 0);
    const int vec_w = (cout % 8 == 0) && (reinterpret_cast<uintptr_t>(w) % 16 == 0);
    conv3x3_bf16_kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const __nv_bfloat16*>(x), static_cast<const __nv_bfloat16*>(w),
        static_cast<const float*>(b), static_cast<__nv_bfloat16*>(y), h, wd, cin, cout, n_cb, act, vec_x,
        vec_w);
    return (int)cudaGetLastError();
}
