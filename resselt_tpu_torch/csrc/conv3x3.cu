// Same-padded 3x3 convolution + bias + activation on NHWC tensors, for Hopper.
//
// Replaces resselt_tpu/ops/fused_conv.py::_kernel, which the JAX package
// reaches through fused_conv3x3_act and fused_conv3x3_pack2.  It computes
// what that kernel computes: y = act(conv3x3(x, w, zero padding) + b), with
// act one of linear / leaky relu 0.2 / silu / mish.  The layout is the
// port's own: x and y are contiguous NHWC, w is repacked once by the caller
// into [tap = dy*3+dx][Cin][Cout] (Cout contiguous) in x's dtype, and b is
// f32 (or null).  Zero padding comes from zero-filling the halo loads; no
// padded copy of x is made.  Accumulation is f32 and the output is rounded
// once, after bias and activation.
//
// Three kernels:
//  * f32: exact f32 FMA on the CUDA cores (no TF32), so that it holds to
//    1e-4 against an f32 reference.  A block owns a 16x16-pixel tile and 64
//    output channels and stages halo and weights per 8 input channels.
//  * bf16 / fp16, wgmma (the path ESRGAN serves in; Cin a multiple of 16,
//    16-byte aligned x, weights and halos that fit shared memory): an
//    implicit GEMM, M = pixels, N = Cout, K = 9 * Cin, on
//    wgmma.mma_async m64nNk16 with both operands read from shared memory
//    through descriptors.
//  * bf16 / fp16, mma.sync (every other shape: Cin 3, 12, ..., or a Cin so
//    large that its halo does not fit): the 16x16-pixel x 64-channel block
//    of the f32 kernel with mma.sync m16n8k16 and synchronous staging.
//
// What bounds it on an H100: tensor-core operations, or close to it.  The
// RDB stage-0 conv (K = 576, N = 192) does about 430 FLOP per byte it must
// move in bf16, above the card's ridge of about 295 FLOP/B; stages 1-4
// (K = 288, N = 160..64) sit at 190-240 FLOP/B; only the last conv (64 ->
// 3) is bound by reading x.  What the wgmma kernel does about it:
//  * Weights stay in shared memory.  Blocks are persistent: a block stages
//    its slice of the weights once (all 9 taps, all Cin, NT <= 96 output
//    channels; Cout above 96 is split over blockIdx.y into equal slices of
//    at most 96, e.g. 192 = 2 x 96, 160 = 2 x 80) and then walks 16x16-pixel
//    tiles, so the L2 -> SM traffic per tile is the halo alone (41 KB at
//    Cin 64) and not the 221 KB of weights a stage-0 tile needs.  NT is the
//    smallest of 8, 16, 32, 48, 64, 80, 96 that covers the slice: the 64 -> 3
//    conv runs n = 8 tiles, not 64-wide ones.
//  * wgmma with A and B from shared memory, no swizzle.  The halo of a tile
//    is stored as [channel group of 8][halo row][halo column][8 channels],
//    so the 8 pixels of one tile row and one channel group are 128
//    contiguous bytes: a core matrix.  An m64 tile is 8 rows x 8 columns of
//    pixels; a tap's shift (dy, dx) is a byte offset on the descriptor's
//    start address, the row pitch is the descriptor's stride offset, the
//    channel-group pitch its leading offset.  No thread loads A or B
//    fragments; a thread's registers hold accumulators (2 m64 tiles x NT / 2)
//    and little else.  The weights are stored [tap][channel group][Cout][8
//    input channels] (K-major, the 8 x 8 transposition done in registers
//    while staging).
//  * An asynchronous two-stage ring for the halo: all 256 threads (two
//    warpgroups, each owning an 8-column half of the tile) start 16-byte
//    cp.async copies with zero-fill outside the image for the next tile
//    before they start the current tile's 18 x Cin / 16 wgmmas, so the
//    loads of tile i + 1 overlap the math and the stores of tile i.
//  * Output through shared memory: each warp stages its 16 pixels x NT
//    channels (bias and activation applied, rounded) and writes them in
//    16-byte pieces (2-byte pieces where Cout is not a multiple of 8, the
//    48-byte runs of the 64 -> 3 conv), whole sectors either way.
//  * The activation is chosen once per tile, outside the per-element loops
//    (with_act): left as a switch per element, the compiler evaluated the
//    transcendental branches for every output and the epilogue took four
//    times as long as the products.
// ptxas (CUDA 12.8, sm_90a) for the wgmma kernel: 152 registers at NT = 96
// (96 of them accumulators), 142 at 80, 118 at 64, 76 at 8; 0 bytes of
// spills in every instantiation; 1 block of 256 threads per SM at Cin 64
// (175-221 KB of shared memory), 2 at Cin 32 and NT <= 64.  On an H100 the
// products of a tile run close to the tensor cores' rate; what this leaves
// on the table is that the three phases of a tile (starting the next halo's
// copies, the products, the epilogue) take turns inside a block instead of
// overlapping: no producer warp, no second accumulator set, no TMA; stage 0
// reads each halo twice (once per Cout slice).

#include <cuda_runtime.h>
#include <stdint.h>

#include "async_copy.cuh"
#include "half16.cuh"
#include "wgmma.cuh"

namespace {

constexpr int TH = 16;          // output tile rows
constexpr int TW = 16;          // output tile columns
constexpr int HH = TH + 2;      // halo rows
constexpr int HW = TW + 2;      // halo columns
constexpr int BN = 64;          // output channels per block (f32 and mma.sync kernels)
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

// The 16-bit kernels' epilogues run `body` with the activation as a
// compile-time constant: one uniform branch per tile, not a switch (which
// the compiler may turn into predicated transcendental code) per element.
template <int ACT>
struct ActConst {
    static constexpr int value = ACT;
};

template <class Body>
__device__ __forceinline__ void with_act(int act, Body body) {
    switch (act) {
        case ACT_LRELU: body(ActConst<ACT_LRELU>{}); break;
        case ACT_SILU: body(ActConst<ACT_SILU>{}); break;
        case ACT_MISH: body(ActConst<ACT_MISH>{}); break;
        default: body(ActConst<ACT_LINEAR>{}); break;
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
// bf16 / fp16, mma.sync m16n8k16 implicit GEMM (the narrow path).  Warp w
// owns tile rows 2w and 2w+1 (two m16 tiles of 16 pixels each) and all 64
// channels (eight n8 tiles).
// ---------------------------------------------------------------------------

constexpr int KC = 16;       // input channels per stage: one k16 step per tap
constexpr int XPS = KC + 8;  // halo pixel stride in elements (48 B: conflict-free ldmatrix)
constexpr int WPS = BN + 8;  // weight row stride in elements (144 B: conflict-free ldmatrix.trans)

template <typename T>
__global__ void __launch_bounds__(THREADS)
conv3x3_mma_kernel(const T* __restrict__ x, const T* __restrict__ w, const float* __restrict__ bias,
                   T* __restrict__ y, int H, int W, int Cin, int Cout, int n_cb, int act, int vec_x, int vec_w) {
    using HT = Half16<T>;
    __shared__ __align__(16) T xs[HH * HW * XPS];
    __shared__ __align__(16) T ws[9 * KC * WPS];

    const int tid = threadIdx.x;
    const int warp = tid >> 5;
    const int lane = tid & 31;
    const int n = blockIdx.z / n_cb;
    const int co0 = (blockIdx.z % n_cb) * BN;
    const int oy0 = blockIdx.y * TH;
    const int ox0 = blockIdx.x * TW;
    const T* xn = x + (size_t)n * H * W * Cin;
    const T zero = HT::from_float(0.f);

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
                T val = zero;
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
                T val = zero;
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
                    HT::mma(acc[mt][2 * np], a[mt], b[0], b[1]);
                    HT::mma(acc[mt][2 * np + 1], a[mt], b[2], b[3]);
                }
            }
        }
        __syncthreads();
    }

    // accumulator (m16 x n8): lane holds pixel lane / 4 (and + 8), channels
    // (lane % 4) * 2 and + 1
    const bool pairs = (Cout & 1) == 0;
    with_act(act, [&](auto act_c) {
    constexpr int ACT = decltype(act_c)::value;
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
                const float v0 = activate(acc[mt][nt][2 * half] + b0, ACT);
                const float v1 = activate(acc[mt][nt][2 * half + 1] + b1, ACT);
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
    });
}


// ---------------------------------------------------------------------------
// bf16 / fp16, wgmma.  See the note at the top.  A block of two warpgroups
// owns 16x16-pixel tiles; warpgroup g owns tile columns 8g .. 8g + 7, as two
// m64 tiles of 8 rows x 8 columns (tile rows 0-7 and 8-15).
// ---------------------------------------------------------------------------

constexpr int PLANE = HH * HW * 16 + 16;  // bytes of one channel group of a halo stage (+ 16: planes 4 banks apart)
constexpr int STAGES = 2;
constexpr int SMEM_MAX = 232448;     // what a block may ask for on sm_90

__host__ __device__ inline int wg_out_stride(int nt) { return nt + 8; }  // elements: rows 4 banks apart
__host__ __device__ inline size_t wg_weight_bytes(int cin, int nt) { return (size_t)9 * cin * nt * 2; }
__host__ __device__ inline size_t wg_halo_bytes(int cin) { return (size_t)(cin / 8) * PLANE; }
__host__ __device__ inline size_t wg_smem_bytes(int cin, int nt) {
    return wg_weight_bytes(cin, nt) + STAGES * wg_halo_bytes(cin) + (size_t)(THREADS / 32) * 16 * wg_out_stride(nt) * 2 +
           (size_t)nt * 4;
}

template <typename T, int NT>
__global__ void __launch_bounds__(THREADS, NT <= 64 ? 2 : 1)
conv3x3_wgmma_kernel(const T* __restrict__ x, const T* __restrict__ w, const float* __restrict__ bias,
                     T* __restrict__ y, int H, int W, int Cin, int Cout, int tiles_x, int tiles_y, int num_tiles,
                     int act, int vec_w, int vec_y) {
    using HT = Half16<T>;
    extern __shared__ __align__(128) unsigned char smem[];
    const int ncg = Cin / 8;
    const int OS = wg_out_stride(NT);
    unsigned char* wsm = smem;                                   // [tap][cg][NT][8]
    unsigned char* hsm = wsm + wg_weight_bytes(Cin, NT);         // STAGES x [cg][HH][HW][8]
    T* osm = reinterpret_cast<T*>(hsm + STAGES * wg_halo_bytes(Cin));  // per warp [16][OS]
    float* bsm = reinterpret_cast<float*>(osm + (THREADS / 32) * 16 * OS);

    const int tid = threadIdx.x;
    const int warp = tid >> 5, lane = tid & 31;
    const int wgi = warp >> 2, wq = warp & 3;
    const int g = lane >> 2, t4 = lane & 3;
    const int co0 = blockIdx.y * NT;
    const int ncols = min(NT, Cout - co0);

    const uint32_t hsm_addr = static_cast<uint32_t>(__cvta_generic_to_shared(hsm));
    const uint32_t wsm_addr = static_cast<uint32_t>(__cvta_generic_to_shared(wsm));
    const uint32_t halo_bytes = (uint32_t)wg_halo_bytes(Cin);

    // the halo of tile t into stage s: 16-byte pieces, zero outside the image.
    // A thread owns (pixel, odd or even channel groups): two lanes cover a
    // pixel's 32-byte sector per copy, and the pixel's index math is done once
    auto load_halo = [&](int s, int t) {
        const int tx = t % tiles_x, ty = (t / tiles_x) % tiles_y, n = t / (tiles_x * tiles_y);
        const int oy0 = ty * TH - 1, ox0 = tx * TW - 1;
        const T* xn = x + (size_t)n * H * W * Cin;
        const uint32_t base = hsm_addr + s * halo_bytes;
        for (int i = tid; i < HH * HW * 2; i += THREADS) {
            const int half = i & 1, p = i >> 1;
            const int iy = oy0 + p / HW, ix = ox0 + p % HW;
            const bool valid = iy >= 0 && iy < H && ix >= 0 && ix < W;
            const T* src = valid ? xn + ((size_t)iy * W + ix) * Cin + half * 8 : x;
            const uint32_t dst = base + half * PLANE + p * 16;
            for (int cg = 0; cg < ncg; cg += 2) cp_async16(dst + cg * PLANE, valid ? src + cg * 8 : x, valid);
        }
    };

    int t = blockIdx.x;
    if (t < num_tiles) load_halo(0, t);
    cp_async_commit();

    // this block's weights, once: w[tap][k][co0 + n] -> wsm[tap][k / 8][n][k % 8], zero past Cout
    if (vec_w) {
        const int ngr = NT / 8;
        for (int i = tid; i < 9 * ncg * ngr; i += THREADS) {
            const int ng = i % ngr, r = i / ngr;  // r = tap * ncg + cg
            const int cg = r % ncg, tap = r / ncg;
            const int co = co0 + ng * 8;
            uint32_t in[8][4];
#pragma unroll
            for (int k = 0; k < 8; ++k) {
                uint4 v = make_uint4(0u, 0u, 0u, 0u);
                if (co < Cout) v = *reinterpret_cast<const uint4*>(w + ((size_t)tap * Cin + cg * 8 + k) * Cout + co);
                in[k][0] = v.x; in[k][1] = v.y; in[k][2] = v.z; in[k][3] = v.w;
            }
            uint4* dst = reinterpret_cast<uint4*>(wsm + ((size_t)r * NT + ng * 8) * 16);
#pragma unroll
            for (int nn = 0; nn < 8; ++nn) {
                const uint32_t sel = (nn & 1) ? 0x7632u : 0x5410u;
                uint4 o;
                o.x = __byte_perm(in[0][nn >> 1], in[1][nn >> 1], sel);
                o.y = __byte_perm(in[2][nn >> 1], in[3][nn >> 1], sel);
                o.z = __byte_perm(in[4][nn >> 1], in[5][nn >> 1], sel);
                o.w = __byte_perm(in[6][nn >> 1], in[7][nn >> 1], sel);
                dst[nn] = o;
            }
        }
    } else {
        T* wd = reinterpret_cast<T*>(wsm);
        for (int i = tid; i < 9 * Cin * NT; i += THREADS) {
            const int nn = i % NT, r = i / NT;  // r = tap * Cin + k
            const int k = r % Cin, tap = r / Cin;
            T v = HT::from_float(0.f);
            if (co0 + nn < Cout) v = w[(size_t)r * Cout + co0 + nn];
            wd[((size_t)(tap * ncg + k / 8) * NT + nn) * 8 + k % 8] = v;
        }
    }
    for (int i = tid; i < NT; i += THREADS) bsm[i] = (bias != nullptr && co0 + i < Cout) ? bias[co0 + i] : 0.f;

    float acc[2][NT / 2];
    T* ow = osm + warp * 16 * OS;
    int stage = 0;
    for (; t < num_tiles; t += gridDim.x, stage ^= 1) {
        const int tn = t + gridDim.x;
        if (tn < num_tiles) load_halo(stage ^ 1, tn);
        cp_async_commit();
        cp_async_wait<1>();    // this thread's pieces of tile t have landed
        fence_async_shared();  // ... and are visible to wgmma (so are the weights, the first time)
        __syncthreads();       // every thread's pieces

        // 9 taps x Cin / 16 k-steps x 2 m64 tiles
        const uint32_t a0 = hsm_addr + stage * halo_bytes + (wgi * 8) * 16;
        fence_registers(acc[0]);
        fence_registers(acc[1]);
        wgmma_fence();
#pragma unroll
        for (int tap = 0; tap < 9; ++tap) {
            const int dy = tap / 3, dx = tap % 3;
#pragma unroll 1
            for (int ks = 0; ks < ncg / 2; ++ks) {
                const uint64_t db = wgmma_desc(wsm_addr + ((tap * ncg + 2 * ks) * NT) * 16, NT * 16, 128);
                const uint32_t aa = a0 + 2 * ks * PLANE + (dy * HW + dx) * 16;
                const int accumulate = (tap | ks) != 0;
                Wgmma<NT>::template ss<T>(acc[0], wgmma_desc(aa, PLANE, HW * 16), db, accumulate);
                Wgmma<NT>::template ss<T>(acc[1], wgmma_desc(aa + 8 * HW * 16, PLANE, HW * 16), db, accumulate);
            }
        }
        wgmma_commit();
        wgmma_wait<0>();
        fence_registers(acc[0]);
        fence_registers(acc[1]);

        // bias, activation, rounding; through the warp's staging rows to global
        const int tx = t % tiles_x, ty = (t / tiles_x) % tiles_y, n = t / (tiles_x * tiles_y);
        const int ox0 = tx * TW + wgi * 8;
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) {
            // m64 row r = 16 wq + g (+ 8) is pixel (r / 8, r % 8) of the 8x8 patch
            with_act(act, [&](auto act_c) {
                constexpr int ACT = decltype(act_c)::value;
#pragma unroll
                for (int j = 0; j < NT / 8; ++j) {
                    const int c = 8 * j + 2 * t4;
                    const float b0 = bsm[c], b1 = bsm[c + 1];
                    *reinterpret_cast<uint32_t*>(ow + g * OS + c) =
                        HT::pack(activate(acc[mt][4 * j] + b0, ACT), activate(acc[mt][4 * j + 1] + b1, ACT));
                    *reinterpret_cast<uint32_t*>(ow + (8 + g) * OS + c) =
                        HT::pack(activate(acc[mt][4 * j + 2] + b0, ACT), activate(acc[mt][4 * j + 3] + b1, ACT));
                }
            });
            __syncwarp();
            const int oyb = ty * TH + mt * 8 + 2 * wq;
            T* yn = y + (size_t)n * H * W * Cout + co0;
            if (vec_y) {
                const int nv = ncols / 8;
                for (int i = lane; i < 16 * nv; i += 32) {
                    const int v = i % nv, pl = i / nv;
                    const int oy = oyb + (pl >> 3), ox = ox0 + (pl & 7);
                    if (oy < H && ox < W)
                        *reinterpret_cast<uint4*>(yn + ((size_t)oy * W + ox) * Cout + v * 8) =
                            *reinterpret_cast<const uint4*>(ow + pl * OS + v * 8);
                }
            } else {
                for (int i = lane; i < 16 * ncols; i += 32) {
                    const int c = i % ncols, pl = i / ncols;
                    const int oy = oyb + (pl >> 3), ox = ox0 + (pl & 7);
                    if (oy < H && ox < W) yn[((size_t)oy * W + ox) * Cout + c] = ow[pl * OS + c];
                }
            }
            __syncwarp();
        }
        __syncthreads();  // both warpgroups are done with this stage before it is refilled
    }
    cp_async_wait<0>();
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

template <typename T, int NT>
cudaError_t launch_wgmma(const T* x, const T* w, const float* b, T* y, int n, int h, int wd, int cin, int cout,
                         int n_split, int act, cudaStream_t stream) {
    const size_t smem = wg_smem_bytes(cin, NT);
    auto kernel = conv3x3_wgmma_kernel<T, NT>;
    // the attribute and the occupancy of this kernel at this size, asked once
    static size_t known_smem = 0;
    static int known_per_sm = 0;
    if (smem != known_smem) {
        cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
        if (err != cudaSuccess) return err;
        err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&known_per_sm, kernel, THREADS, smem);
        if (err != cudaSuccess) return err;
        known_smem = smem;
    }
    const int per_sm = known_per_sm;
    if (per_sm < 1) return cudaErrorInvalidConfiguration;
    const int tiles_x = (wd + TW - 1) / TW, tiles_y = (h + TH - 1) / TH;
    const long long tiles = (long long)n * tiles_x * tiles_y;
    if (tiles > 0x7fffffffLL) return cudaErrorInvalidValue;
    const long long resident = (long long)num_sms() * per_sm / n_split;
    const int gx = (int)(tiles < resident ? tiles : (resident < 1 ? 1 : resident));
    const int vec_w = (cout % 8 == 0) && (reinterpret_cast<uintptr_t>(w) % 16 == 0);
    const int vec_y = (cout % 8 == 0) && (reinterpret_cast<uintptr_t>(y) % 16 == 0);
    kernel<<<dim3(gx, n_split), THREADS, smem, stream>>>(x, w, b, y, h, wd, cin, cout, tiles_x, tiles_y, (int)tiles,
                                                          act, vec_w, vec_y);
    return cudaGetLastError();
}

dim3 grid_for(int n, int h, int w, int cout, int* n_cb) {
    *n_cb = (cout + BN - 1) / BN;
    return dim3((w + TW - 1) / TW, (h + TH - 1) / TH, n * *n_cb);
}

bool bad_shape(int n, int h, int w, int cin, int cout, int act) {
    return n <= 0 || h <= 0 || w <= 0 || cin <= 0 || cout <= 0 || act < 0 || act > ACT_MISH;
}

// the f32 and mma.sync kernels put n x channel blocks in gridDim.z
bool grid_too_large(int n, int h, int cout) {
    return (long long)n * ((cout + BN - 1) / BN) > 65535 || (h + TH - 1) / TH > 65535;
}

// The 16-bit conv: the wgmma kernel where the shape allows it (Cout split
// into the fewest equal slices of at most 96 channels whose weights fit
// shared memory beside the halo ring), else the mma.sync kernel.
template <typename T>
int launch_h16(const void* xv, const void* wv, const void* bv, void* yv, int n, int h, int wd, int cin, int cout,
               int act, void* stream) {
    if (bad_shape(n, h, wd, cin, cout, act)) return (int)cudaErrorInvalidValue;
    const T* x = static_cast<const T*>(xv);
    const T* w = static_cast<const T*>(wv);
    const float* b = static_cast<const float*>(bv);
    T* y = static_cast<T*>(yv);
    const cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (cin % 16 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0) {
        static const int kNT[] = {8, 16, 32, 48, 64, 80, 96};
        for (int n_split = (cout + 95) / 96; n_split <= (cout + 7) / 8 && n_split <= 65535; ++n_split) {
            const int slice = (cout + n_split - 1) / n_split;
            int nt = 96;
            for (int i = 6; i >= 0; --i)
                if (kNT[i] >= slice) nt = kNT[i];
            if ((long long)nt * (n_split - 1) >= cout) continue;  // a slice would be empty
            if (wg_smem_bytes(cin, nt) > (size_t)SMEM_MAX) continue;
            switch (nt) {
                case 8: return (int)launch_wgmma<T, 8>(x, w, b, y, n, h, wd, cin, cout, n_split, act, s);
                case 16: return (int)launch_wgmma<T, 16>(x, w, b, y, n, h, wd, cin, cout, n_split, act, s);
                case 32: return (int)launch_wgmma<T, 32>(x, w, b, y, n, h, wd, cin, cout, n_split, act, s);
                case 48: return (int)launch_wgmma<T, 48>(x, w, b, y, n, h, wd, cin, cout, n_split, act, s);
                case 64: return (int)launch_wgmma<T, 64>(x, w, b, y, n, h, wd, cin, cout, n_split, act, s);
                case 80: return (int)launch_wgmma<T, 80>(x, w, b, y, n, h, wd, cin, cout, n_split, act, s);
                default: return (int)launch_wgmma<T, 96>(x, w, b, y, n, h, wd, cin, cout, n_split, act, s);
            }
        }
    }
    if (grid_too_large(n, h, cout)) return (int)cudaErrorInvalidValue;
    int n_cb;
    const dim3 grid = grid_for(n, h, wd, cout, &n_cb);
    const int vec_x = (cin % 8 == 0) && (reinterpret_cast<uintptr_t>(x) % 16 == 0);
    const int vec_w = (cout % 8 == 0) && (reinterpret_cast<uintptr_t>(w) % 16 == 0);
    conv3x3_mma_kernel<T><<<grid, THREADS, 0, s>>>(x, w, b, y, h, wd, cin, cout, n_cb, act, vec_x, vec_w);
    return (int)cudaGetLastError();
}

}  // namespace

// Plain C entry points (loaded with ctypes).  Each launches on `stream` and
// returns cudaGetLastError() right after the launch (0 = launched).
extern "C" int resselt_conv3x3_f32(const void* x, const void* w, const void* b, void* y, int n, int h,
                                   int wd, int cin, int cout, int act, void* stream) {
    if (bad_shape(n, h, wd, cin, cout, act) || grid_too_large(n, h, cout)) return (int)cudaErrorInvalidValue;
    int n_cb;
    const dim3 grid = grid_for(n, h, wd, cout, &n_cb);
    conv3x3_f32_kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(x), static_cast<const float*>(w), static_cast<const float*>(b),
        static_cast<float*>(y), h, wd, cin, cout, n_cb, act);
    return (int)cudaGetLastError();
}

extern "C" int resselt_conv3x3_bf16(const void* x, const void* w, const void* b, void* y, int n, int h,
                                    int wd, int cin, int cout, int act, void* stream) {
    return launch_h16<__nv_bfloat16>(x, w, b, y, n, h, wd, cin, cout, act, stream);
}

extern "C" int resselt_conv3x3_f16(const void* x, const void* w, const void* b, void* y, int n, int h,
                                   int wd, int cin, int cout, int act, void* stream) {
    return launch_h16<__half>(x, w, b, y, n, h, wd, cin, cout, act, stream);
}
