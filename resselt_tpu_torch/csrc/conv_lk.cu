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
// f32 (or null).  Takes every odd k, as the TPU kernel does, Cout <= 64 and
// any Cin, H, W >= 1.
//
// Four kernels:
//  * f32: exact f32 FMA on the CUDA cores (no TF32), held at 1e-4 against
//    an f32 reference.  It stages a tile's halo and one kernel row's
//    weights at a time; up to k 31 both fit in shared memory, and where
//    they do not the taps go in square blocks of tb x tb (tap_block picks
//    tb), each block's halo and weights staged in turn, all accumulating
//    into the same output tile.
//  * bf16 / fp16 (each a template over the 16-bit type), on the path that
//    plan_path picks from the shape and x's alignment alone (exported as
//    resselt_conv_lk_path, so that the wrapper counts the path it took):
//    - stacked (Cin 16, Cout <= 16, 16-byte aligned pixels, all weights
//      resident): PLKSR's path, below.
//    - tiles (Cin 16 and 64, Cout up to 64, where the halos and a kernel
//      row's weights fit): wgmma m64nNk16 on 8 x 8-pixel m64 tiles
//      with both operands in shared memory, as conv3x3.cu's; a block owns
//      32 x 16 pixels, stages 16 input channels' halo at a time and the
//      weights one kernel row at a time, the next while the tensor cores
//      work on the current.
//    - mma (every other shape: Cin 8 and 32, pixels not 16-byte aligned,
//      k 31 at Cin 64, every k past 33): implicit GEMM through mma.sync
//      m16n8k16, a 32 x 16-pixel block that restages each kernel row's
//      weights between barriers; in blocks of taps as the f32 kernel
//      where a kernel row's halo and weights do not fit.  The stacked path's weights fit up to k 31, the tiles
//      path's two halos and two kernel rows up to k 33 at Cout <= 16.
//
// What bounds it on an H100: operations.  At PLKSR's bench shape (16 x
// 256 x 256, 16 -> 16, k 17) the conv does 155 GFLOP on 67 MB of bf16
// traffic, about 2300 FLOP per byte, far above the card's ridge: 0.157 ms
// at 989 TFLOP/s.  The TPU kernel's column packing into 128 lanes, its
// host-built group-shifted input copies and its per-plane DMA ring exist
// for the TPU's vector layout and do not carry over.  On Hopper the rate
// comes from wgmma, and wgmma's rate needs a wide N: an m64n16k16 (N =
// Cout = 16) runs at a fraction of the tensor cores' rate, whether A comes
// from registers or shared memory.  The stacked path therefore makes N the
// pixels and stacks the taps of G = 64 / Cout neighbouring output rows in
// M: for input row s of a tile and tap column dx, one m64n128k16 takes A =
// the weights of kernel rows s, s - 1, .., s - G + 1 (16 output channels
// each) and B = 128 pixels of input row s shifted by dx, and adds each
// 16-row slice of D to its own output row.  The weights are stored
// [dx][k - 1 - dy] in K-major 16-channel blocks with G - 1 zero blocks
// between the tap columns, so that A for every (s, dx) is one descriptor
// and the rows of dy outside [0, k) read zeros; the shift by dx is 16
// bytes on B's descriptor.  A block of two warpgroups owns G rows x 256
// columns, walks its k + G - 1 input rows through a 4-row cp.async ring
// (one barrier a row; the next rows load while the current row's wgmmas
// run), and is persistent over the tiles.  It leaves on the table: the
// G - 1 rows of the ramp at each end of a tile (k + G - 1 input rows for G
// output rows: 85% of the issued products are useful at k 17, G 4);
// output stored in 2-byte pieces from the accumulators' layout; the copies
// and products of one block take turns with its epilogue.

#include <cuda_runtime.h>
#include <stdint.h>

#include "async_copy.cuh"
#include "half16.cuh"
#include "wgmma.cuh"

namespace {

constexpr int MAX_COUT = 64;
constexpr int THREADS = 256;

enum Act { ACT_LINEAR = 0, ACT_LRELU = 1 };
// The 16-bit paths, numbered as ops/fused_conv.py::LK_PATHS names them.
enum Path { LK_PATH_MMA = 0, LK_PATH_STACKED = 1, LK_PATH_TILES = 2 };

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

__host__ __device__ inline int f32_halo_floats(int tb) {
    return ((TH32 + tb - 1) * (TW32 + tb - 1) * XPS32 + 3) / 4 * 4;  // 16-byte aligned end
}

// The taps go in square blocks of tb x tb where the halo and a kernel
// row's weights do not fit in shared memory at tb = k (past k 31): per block
// of taps the halo it reads, (16 + tb - 1)^2 pixels, then its kernel rows
// one at a time.  BLOCKED is false where tb = k: the one block is then the
// whole kernel, as the loop that took every k up to 31 was written.
template <bool BLOCKED>
__global__ void __launch_bounds__(THREADS)
conv_lk_f32_kernel(const float* __restrict__ x, const float* __restrict__ w, const float* __restrict__ bias,
                   float* __restrict__ y, int H, int W, int Cin, int Cout, int pitch, int k, int act, int ng, int tb) {
    extern __shared__ __align__(16) float smem32[];
    if (!BLOCKED) tb = k;
    const int HWD = TW32 + tb - 1;
    const int CO = ng * 8;  // weight row stride in floats
    float* xs = smem32;
    float* ws = smem32 + f32_halo_floats(tb);

    const int tid = threadIdx.x;
    const int nthreads = blockDim.x;
    const int n = blockIdx.z;
    const int tiles_x = (W + TW32 - 1) / TW32;  // blockIdx.x: the tile, row-major
    const int oy0 = (int)(blockIdx.x / tiles_x) * TH32;
    const int ox0 = (int)(blockIdx.x % tiles_x) * TW32;
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

    // input channels c0 .. c0 + KC32 - 1 of taps (dy0 .. dy0 + nr - 1, dx0 .. dx0 + nc - 1)
    auto taps = [&](int c0, int dy0, int nr, int dx0, int nc) {
        for (int i = tid; i < (TH32 + nr - 1) * HWD * KC32; i += nthreads) {
            const int kk = i % KC32, p = i / KC32;
            const int iy = oy0 - pad + dy0 + p / HWD, ix = ox0 - pad + dx0 + p % HWD;
            float v = 0.f;
            if (c0 + kk < Cin && iy >= 0 && iy < H && ix >= 0 && ix < W)
                v = xn[((size_t)iy * W + ix) * pitch + c0 + kk];
            xs[p * XPS32 + kk] = v;
        }
        for (int dy = dy0; dy < dy0 + nr; ++dy) {
            // weights of taps (dy, dx0 ..): nc taps x KC32 input channels x CO outputs
            for (int i = tid; i < nc * KC32 * CO; i += nthreads) {
                const int co = i % CO, r = i / CO;  // r = (dx - dx0) * KC32 + kk
                const int kk = r % KC32, dx = dx0 + r / KC32;
                float v = 0.f;
                if (c0 + kk < Cin && co < Cout) v = w[((size_t)(dy * k + dx) * Cin + c0 + kk) * Cout + co];
                ws[r * CO + co] = v;
            }
            __syncthreads();

#pragma unroll 1
            for (int kk = 0; kk < KC32; ++kk) {
                const float* xr = xs + ((ty + dy - dy0) * HWD + tx) * XPS32 + kk;
                float in[8];
#pragma unroll
                for (int i = 0; i < 8; ++i) in[i] = xr[i * XPS32];
#pragma unroll 1
                for (int dx = 0; dx < nc; ++dx) {
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
                    if (dx + 1 < nc) in[7] = xr[(8 + dx) * XPS32];
                }
            }
            __syncthreads();
        }
    };
    for (int c0 = 0; c0 < Cin; c0 += KC32) {
        if (BLOCKED) {
            for (int dy0 = 0; dy0 < k; dy0 += tb)
                for (int dx0 = 0; dx0 < k; dx0 += tb) taps(c0, dy0, min(tb, k - dy0), dx0, min(tb, k - dx0));
        } else {
            taps(c0, 0, k, 0, k);
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

__host__ __device__ inline int bf16_halo_elems(int tb) { return (TH + tb - 1) * (TW + tb - 1) * XPS; }

// The taps go in square blocks of tb x tb, as in the f32 kernel (BLOCKED
// false where tb = k).
template <typename T, int NP, bool BLOCKED>  // T: the 16-bit type; NP pairs of n8 tiles: Cout <= 16 * NP
__global__ void __launch_bounds__(THREADS)
conv_lk_h16_kernel(const T* __restrict__ x, const T* __restrict__ w,
                   const float* __restrict__ bias, T* __restrict__ y, int H, int W, int Cin,
                   int Cout, int pitch, int k, int act, int vec_x, int vec_w, int tb) {
    using HT = Half16<T>;
    constexpr int BN = NP * 16;
    constexpr int WPS = BN + 8;  // weight row stride in bf16 (conflict-free ldmatrix.trans)
    extern __shared__ __align__(16) unsigned char smem[];
    if (!BLOCKED) tb = k;
    const int HWD = TW + tb - 1;
    T* xs = reinterpret_cast<T*>(smem);
    T* ws = xs + bf16_halo_elems(tb);  // 48 B per halo pixel keeps it 16-byte aligned

    const int tid = threadIdx.x;
    const int warp = tid >> 5;
    const int lane = tid & 31;
    const int n = blockIdx.z;
    const int tiles_x = (W + TW - 1) / TW;  // blockIdx.x: the tile, row-major
    const int oy0 = (int)(blockIdx.x / tiles_x) * TH;
    const int ox0 = (int)(blockIdx.x % tiles_x) * TW;
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

    // input channels c0 .. c0 + KC - 1 of taps (dy0 .. dy0 + nr - 1, dx0 .. dx0 + nc - 1)
    auto taps = [&](int c0, int dy0, int nr, int dx0, int nc) {
        // input halo of the taps: TH + nr - 1 rows x HWD pixels x KC channels, zero outside the image
        const int oy = oy0 - pad + dy0, ox = ox0 - pad + dx0;
        if (vec_x) {
            for (int i = tid; i < (TH + nr - 1) * HWD * (KC / 8); i += THREADS) {
                const int v = i & 1, p = i >> 1;
                const int iy = oy + p / HWD, ix = ox + p % HWD;
                const int ch = c0 + v * 8;
                uint4 val = make_uint4(0, 0, 0, 0);
                if (ch < Cin && iy >= 0 && iy < H && ix >= 0 && ix < W)
                    val = *reinterpret_cast<const uint4*>(xn + ((size_t)iy * W + ix) * pitch + ch);
                *reinterpret_cast<uint4*>(xs + p * XPS + v * 8) = val;
            }
        } else {
            for (int i = tid; i < (TH + nr - 1) * HWD * KC; i += THREADS) {
                const int kk = i % KC, p = i / KC;
                const int iy = oy + p / HWD, ix = ox + p % HWD;
                T val = zero;
                if (c0 + kk < Cin && iy >= 0 && iy < H && ix >= 0 && ix < W)
                    val = xn[((size_t)iy * W + ix) * pitch + c0 + kk];
                xs[p * XPS + kk] = val;
            }
        }

        for (int dy = dy0; dy < dy0 + nr; ++dy) {
            // weights of taps (dy, dx0 ..): nc taps x KC input channels x BN outputs, zero past the ends
            if (vec_w) {
                for (int i = tid; i < nc * KC * (BN / 8); i += THREADS) {
                    const int v = i % (BN / 8), r = i / (BN / 8);  // r = (dx - dx0) * KC + kk
                    const int kk = r % KC, dx = dx0 + r / KC;
                    const int co = v * 8;
                    uint4 val = make_uint4(0, 0, 0, 0);
                    if (c0 + kk < Cin && co < Cout)
                        val = *reinterpret_cast<const uint4*>(w + ((size_t)(dy * k + dx) * Cin + c0 + kk) * Cout + co);
                    *reinterpret_cast<uint4*>(ws + r * WPS + v * 8) = val;
                }
            } else {
                for (int i = tid; i < nc * KC * BN; i += THREADS) {
                    const int co = i % BN, r = i / BN;
                    const int kk = r % KC, dx = dx0 + r / KC;
                    T val = zero;
                    if (c0 + kk < Cin && co < Cout) val = w[((size_t)(dy * k + dx) * Cin + c0 + kk) * Cout + co];
                    ws[r * WPS + co] = val;
                }
            }
            __syncthreads();

#pragma unroll 1
            for (int dx = 0; dx < nc; ++dx) {
                // A (16 pixels x 16 channels, row-major): lane gives the address
                // of pixel lane % 16, channels (lane / 16) * 8 ..
                uint32_t a[MT][4];
#pragma unroll
                for (int mt = 0; mt < MT; ++mt) {
                    const int row = warp * MT + mt + dy - dy0;
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
    };
    for (int c0 = 0; c0 < Cin; c0 += KC) {
        if (BLOCKED) {
            for (int dy0 = 0; dy0 < k; dy0 += tb)
                for (int dx0 = 0; dx0 < k; dx0 += tb) taps(c0, dy0, min(tb, k - dy0), dx0, min(tb, k - dx0));
        } else {
            taps(c0, 0, k, 0, k);
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

// ---------------------------------------------------------------------------
// bf16 / fp16 "stacked": the taps of G = 64 / CO neighbouring output rows
// stacked in wgmma's M (Cin 16, Cout <= 16, all weights resident).  See the
// note at the top.  D (m64 x 128) row 16 w + .. is (output row g, channel co)
// with m = g CO + co; its columns are 128 pixels of those rows.  For input
// row s of a tile (image row o0 - pad + s) and tap column dx, A is the
// weights of kernel rows dy = s - g for g = 0 .. G - 1, one 2-channel-group
// block per g, stored [dx][dy' = k - 1 - dy] with G - 1 zero blocks between
// the tap columns so that the dy outside [0, k) read zeros; B is the input
// row shifted by dx.  A block of two warpgroups owns G output rows x 256
// columns (128 a warpgroup) and walks its k + G - 1 input rows through a
// ring of ST_SLOTS row buffers ([channel group][column][8]).
// ---------------------------------------------------------------------------

constexpr int ST_W = 128;      // output columns of a warpgroup
constexpr int ST_SLOTS = 4;    // input-row ring
constexpr int SMEM_MAX = 232448;

__host__ __device__ inline int st_plane_bytes(int k) { return (2 * ST_W + k - 1) * 16 + 16; }
__host__ __device__ inline int st_blocks(int co, int k) { return k * k + (k + 1) * (64 / co - 1); }
__host__ __device__ inline size_t st_smem_bytes(int co, int k) {
    return (size_t)st_blocks(co, k) * co * 32 + (size_t)ST_SLOTS * 2 * st_plane_bytes(k) + (size_t)co * 4;
}

// The 16-bit conv's epilogue runs `body` with the activation as a
// compile-time constant (one uniform branch, not a branch per element).
template <int ACT>
struct ActConst {
    static constexpr int value = ACT;
};
template <class Body>
__device__ __forceinline__ void with_act(int act, Body body) {
    if (act == ACT_LRELU) body(ActConst<ACT_LRELU>{});
    else body(ActConst<ACT_LINEAR>{});
}

// w[tap][ci][co] for taps [tap0, tap0 + ntaps) and all Cin, co < Cout (zero up
// to NT) -> dst[tap - tap0][ci / 8][NT][ci % 8]: K-major B tiles, the 8 x 8
// transposition done in registers.  Synchronous; all `nthreads` threads.
template <typename T, int NT>
__device__ void stage_weights(unsigned char* dst, const T* __restrict__ w, int tap0, int ntaps, int Cin, int Cout,
                              int ci0, int ncin, int vec_w, int tid, int nthreads) {
    const int ncg = ncin / 8;
    if (vec_w) {
        const int ngr = NT / 8;
        for (int i = tid; i < ntaps * ncg * ngr; i += nthreads) {
            const int ng = i % ngr, r = i / ngr;  // r = tap * ncg + cg
            const int cg = r % ncg, tap = r / ncg;
            const int co = ng * 8;
            uint32_t in[8][4];
#pragma unroll
            for (int kk = 0; kk < 8; ++kk) {
                uint4 v = make_uint4(0u, 0u, 0u, 0u);
                if (co < Cout)
                    v = *reinterpret_cast<const uint4*>(w + ((size_t)(tap0 + tap) * Cin + ci0 + cg * 8 + kk) * Cout + co);
                in[kk][0] = v.x; in[kk][1] = v.y; in[kk][2] = v.z; in[kk][3] = v.w;
            }
            uint4* d = reinterpret_cast<uint4*>(dst + ((size_t)r * NT + ng * 8) * 16);
#pragma unroll
            for (int nn = 0; nn < 8; ++nn) {
                const uint32_t sel = (nn & 1) ? 0x7632u : 0x5410u;
                uint4 o;
                o.x = __byte_perm(in[0][nn >> 1], in[1][nn >> 1], sel);
                o.y = __byte_perm(in[2][nn >> 1], in[3][nn >> 1], sel);
                o.z = __byte_perm(in[4][nn >> 1], in[5][nn >> 1], sel);
                o.w = __byte_perm(in[6][nn >> 1], in[7][nn >> 1], sel);
                d[nn] = o;
            }
        }
    } else {
        T* d = reinterpret_cast<T*>(dst);
        for (int i = tid; i < ntaps * ncin * NT; i += nthreads) {
            const int nn = i % NT, r = i / NT;  // r = tap * ncin + kk
            const int kk = r % ncin, tap = r / ncin;
            T v = Half16<T>::from_float(0.f);
            if (nn < Cout) v = w[((size_t)(tap0 + tap) * Cin + ci0 + kk) * Cout + nn];
            d[((size_t)(tap * ncg + kk / 8) * NT + nn) * 8 + kk % 8] = v;
        }
    }
}

template <typename T, int CO>
__global__ void __launch_bounds__(256, 1)
conv_lk_stacked_kernel(const T* __restrict__ x, const T* __restrict__ w, const float* __restrict__ bias,
                       T* __restrict__ y, int H, int W, int Cout, int pitch, int k, int act, int tiles_x,
                       int tiles_y, int tiles) {
    constexpr int G = 64 / CO;  // output rows of a tile
    constexpr int BLK = CO * 32;  // bytes of one (dx, dy) block: [CO / 8][2][8][8]
    extern __shared__ __align__(16) unsigned char smem[];
    const int pad = k / 2, nrows = k + G - 1, plane = st_plane_bytes(k);
    unsigned char* wsm = smem;
    unsigned char* rsm = wsm + (size_t)st_blocks(CO, k) * BLK;
    float* bsm = reinterpret_cast<float*>(rsm + ST_SLOTS * 2 * plane);
    const int tid = threadIdx.x, wg = tid >> 7, wq = (tid >> 5) & 3, lane = tid & 31;

    // weights: w[dy * k + dx][ci][co] -> block (G - 1) + dx (k + G - 1) + k - 1 - dy,
    // within it [co / 8][ci / 8][co % 8][ci % 8]; the G - 1 blocks before each
    // tap column and after the last are zero
    {
        uint32_t* w32 = reinterpret_cast<uint32_t*>(wsm);
        for (int i = tid; i < st_blocks(CO, k) * BLK / 4; i += 256) w32[i] = 0u;
        __syncthreads();
        T* wd = reinterpret_cast<T*>(wsm);
        for (int i = tid; i < k * k * 16 * CO; i += 256) {
            const int co = i % CO, r = i / CO, ci = r % 16, tap = r / 16;
            const int dy = tap / k, dx = tap % k;
            const int blk = (G - 1) + dx * (k + G - 1) + k - 1 - dy;
            wd[(size_t)blk * (BLK / 2) + ((co >> 3) * 2 + (ci >> 3)) * 64 + (co & 7) * 8 + (ci & 7)] =
                co < Cout ? w[(size_t)r * Cout + co] : Half16<T>::from_float(0.f);
        }
        if (tid < CO) bsm[tid] = (bias != nullptr && tid < Cout) ? bias[tid] : 0.f;
    }
    const uint32_t w_addr = static_cast<uint32_t>(__cvta_generic_to_shared(wsm));
    const uint32_t r_addr = static_cast<uint32_t>(__cvta_generic_to_shared(rsm));
    const int HWD = 2 * ST_W + k - 1;
    float acc[64];

    // Every branch that surrounds a wgmma depends on the tile alone (a
    // branch on the warpgroup would make ptxas serialize the wgmmas).
    for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
        const int tx = t % tiles_x, ty = (t / tiles_x) % tiles_y, n = t / (tiles_x * tiles_y);
        const int o0 = ty * G, x0 = tx * 2 * ST_W;
        const T* xn = x + (size_t)n * H * W * pitch;
        auto load_row = [&](int r) {
            const int iy = o0 - pad + r;
            const bool row_ok = iy >= 0 && iy < H;
            const uint32_t base = r_addr + (r % ST_SLOTS) * 2 * plane;
            for (int i = tid; i < HWD * 2; i += 256) {
                const int px = i >> 1, cg = i & 1, ix = x0 - pad + px;
                const bool valid = row_ok && ix >= 0 && ix < W;
                cp_async16(base + cg * plane + px * 16, valid ? xn + ((size_t)iy * W + ix) * pitch + cg * 8 : x, valid);
            }
        };
        __syncthreads();  // the previous tile's readers of the ring are done
        load_row(0);
        cp_async_commit();
        load_row(1);
        cp_async_commit();
        for (int r = 0; r < nrows; ++r) {
            cp_async_wait<1>();   // this thread's pieces of row r
            wgmma_wait<1>();      // the products of row r - 2 are done
            fence_async_shared();
            __syncthreads();      // every thread's pieces; every warpgroup's row r - 2 products
            if (r + 2 < nrows) load_row(r + 2);
            cp_async_commit();
            const uint32_t b0 = r_addr + (r % ST_SLOTS) * 2 * plane + (wg * ST_W) * 16;
            const uint32_t a0 = w_addr + (k - 1 - r + G - 1) * BLK;
            fence_registers(acc);
            wgmma_fence();
#pragma unroll 1
            for (int dx = 0; dx < k; ++dx)
                Wgmma<128>::template ss<T>(acc, wgmma_desc(a0 + dx * (k + G - 1) * BLK, 128, 256),
                                           wgmma_desc(b0 + dx * 16, plane, 128), (r | dx) != 0);
            wgmma_commit();
        }
        wgmma_wait<0>();
        fence_registers(acc);

        // D row m = 16 wq + lane / 4 (+ 8) is output row o0 + m / CO, channel m % CO;
        // columns 8 j + 2 (lane % 4) and + 1 are pixels
        with_act(act, [&](auto act_c) {
            constexpr int ACT = decltype(act_c)::value;
#pragma unroll
            for (int hr = 0; hr < 2; ++hr) {
                const int m = 16 * wq + (lane >> 2) + 8 * hr, oy = o0 + m / CO, co = m % CO;
                if (oy >= H || co >= Cout) continue;
                const float b = bsm[co];
                T* yrow = y + ((size_t)n * H + oy) * W * Cout + co;
#pragma unroll
                for (int j = 0; j < 16; ++j) {
                    const int ox = x0 + wg * ST_W + 8 * j + 2 * (lane & 3);
                    if (ox < W) yrow[(size_t)ox * Cout] = Half16<T>::from_float(activate(acc[4 * j + 2 * hr] + b, ACT));
                    if (ox + 1 < W)
                        yrow[(size_t)(ox + 1) * Cout] = Half16<T>::from_float(activate(acc[4 * j + 2 * hr + 1] + b, ACT));
                }
            }
        });
    }
    cp_async_wait<0>();
}

// ---------------------------------------------------------------------------
// bf16 / fp16 "tiles": wgmma with both operands in shared memory (Cin a
// multiple of 16, Cout up to 64).  A block of two warpgroups owns a 32 x
// 16-pixel output tile; warpgroup g owns columns 8 g .. 8 g + 7 as four m64
// tiles of 8 x 8 pixels.  The input channels go 16 at a time (a stage: the
// tile's halo, [2 channel groups][row][column][8]); the weights come one
// chunk at a time, a chunk being one kernel row dy of one stage
// ([dx][2][NT][8], K-major).  Two halo buffers and two weight buffers: the
// next chunk is staged while the current chunk's wgmmas run.
// ---------------------------------------------------------------------------

constexpr int TT_H = 32;  // tile rows
constexpr int TT_W = 16;  // tile columns

__host__ __device__ inline int tiles_plane_bytes(int k) { return (TT_H + k - 1) * (TT_W + k - 1) * 16 + 16; }
__host__ __device__ inline int tiles_chunk_bytes(int nt, int k) { return k * 2 * nt * 16; }
__host__ __device__ inline size_t tiles_smem_bytes(int nt, int k) {
    return (size_t)2 * 2 * tiles_plane_bytes(k) + (size_t)2 * tiles_chunk_bytes(nt, k) + (size_t)nt * 4;
}

template <typename T, int NT>
__global__ void __launch_bounds__(256, 1)
conv_lk_tiles_kernel(const T* __restrict__ x, const T* __restrict__ w, const float* __restrict__ bias,
                     T* __restrict__ y, int H, int W, int Cin, int Cout, int pitch, int k, int act, int vec_w) {
    extern __shared__ __align__(16) unsigned char smem[];
    const int pad = k / 2;
    const int HH2 = TT_H + k - 1, HW2 = TT_W + k - 1;
    const int plane = tiles_plane_bytes(k), chunk = tiles_chunk_bytes(NT, k);
    unsigned char* hsm = smem;                    // 2 stages x 2 planes
    unsigned char* wsm = hsm + 4 * plane;         // 2 chunks
    float* bsm = reinterpret_cast<float*>(wsm + 2 * chunk);
    const int tid = threadIdx.x, wgi = tid >> 7, wq = (tid >> 5) & 3, lane = tid & 31;
    const int tiles_x = (W + TT_W - 1) / TT_W;  // blockIdx.x: the tile, row-major
    const int n = blockIdx.z, oy0 = (int)(blockIdx.x / tiles_x) * TT_H, ox0 = (int)(blockIdx.x % tiles_x) * TT_W;
    const T* xn = x + (size_t)n * H * W * pitch;
    const uint32_t h_addr = static_cast<uint32_t>(__cvta_generic_to_shared(hsm));
    const uint32_t w_addr = static_cast<uint32_t>(__cvta_generic_to_shared(wsm));

    auto load_halo = [&](int stage) {
        const uint32_t base = h_addr + (stage & 1) * 2 * plane;
        for (int i = tid; i < HH2 * HW2 * 2; i += 256) {
            const int half = i & 1, p = i >> 1;
            const int iy = oy0 - pad + p / HW2, ix = ox0 - pad + p % HW2;
            const bool valid = iy >= 0 && iy < H && ix >= 0 && ix < W;
            const T* src = valid ? xn + ((size_t)iy * W + ix) * pitch + stage * 16 + half * 8 : x;
            cp_async16(base + half * plane + p * 16, src, valid);
        }
    };
    const int nchunks = (Cin / 16) * k;
    load_halo(0);
    cp_async_commit();
    stage_weights<T, NT>(wsm, w, 0, k, Cin, Cout, 0, 16, vec_w, tid, 256);
    for (int i = tid; i < NT; i += 256) bsm[i] = (bias != nullptr && i < Cout) ? bias[i] : 0.f;

    float acc[4][NT / 2];
    for (int c = 0; c < nchunks; ++c) {
        const int stage = c / k, dy = c - stage * k;
        cp_async_wait<0>();
        fence_async_shared();
        __syncthreads();  // chunk c's halo and weights are in; chunk c - 1's products are done

        const uint32_t a0 = h_addr + (stage & 1) * 2 * plane + (wgi * 8) * 16;
        const uint32_t b0 = w_addr + (c & 1) * chunk;
#pragma unroll
        for (int mt = 0; mt < 4; ++mt) fence_registers(acc[mt]);
        wgmma_fence();
#pragma unroll 1
        for (int dx = 0; dx < k; ++dx) {
            const uint64_t db = wgmma_desc(b0 + dx * 2 * NT * 16, NT * 16, 128);
            const int accumulate = (c | dx) != 0;
#pragma unroll
            for (int mt = 0; mt < 4; ++mt)
                Wgmma<NT>::template ss<T>(acc[mt], wgmma_desc(a0 + ((mt * 8 + dy) * HW2 + dx) * 16, plane, HW2 * 16),
                                          db, accumulate);
        }
        wgmma_commit();
        // stage chunk c + 1 while the tensor cores work on chunk c
        if (c + 1 < nchunks) {
            const int s1 = (c + 1) / k, dy1 = c + 1 - s1 * k;
            if (s1 != stage) load_halo(s1);
            stage_weights<T, NT>(wsm + ((c + 1) & 1) * chunk, w, dy1 * k, k, Cin, Cout, s1 * 16, 16, vec_w, tid,
                                 256);
        }
        cp_async_commit();
        wgmma_wait<0>();
#pragma unroll
        for (int mt = 0; mt < 4; ++mt) fence_registers(acc[mt]);
    }

    // m64 row 16 wq + g + 8 hr is pixel (2 wq + hr, g) of the 8 x 8 patch
    const int g = lane >> 2, t4 = lane & 3;
    const int ox = ox0 + wgi * 8 + g;
    with_act(act, [&](auto act_c) {
        constexpr int ACT = decltype(act_c)::value;
#pragma unroll
        for (int mt = 0; mt < 4; ++mt) {
#pragma unroll
            for (int hr = 0; hr < 2; ++hr) {
                const int oy = oy0 + mt * 8 + 2 * wq + hr;
                if (oy >= H || ox >= W) continue;
                T* yp = y + (((size_t)n * H + oy) * W + ox) * Cout;
#pragma unroll
                for (int j = 0; j < NT / 8; ++j) {
                    const int co = 8 * j + 2 * t4;
                    if (co >= Cout) continue;
                    const float v0 = activate(acc[mt][4 * j + 2 * hr] + bsm[co], ACT);
                    const float v1 = activate(acc[mt][4 * j + 2 * hr + 1] + bsm[co + 1], ACT);
                    if ((Cout & 1) == 0) {
                        *reinterpret_cast<uint32_t*>(yp + co) = Half16<T>::pack(v0, v1);
                    } else {
                        yp[co] = Half16<T>::from_float(v0);
                        if (co + 1 < Cout) yp[co + 1] = Half16<T>::from_float(v1);
                    }
                }
            }
        }
    });
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

// The side tb of the square blocks that the f32 and mma kernels take the
// taps in: k where a block's halo and one kernel row's weights (`bytes(tb)`)
// fit in shared memory, as they do for every k up to 31; past that the
// widest even split of k that fits.
template <class Bytes>
int tap_block(int k, Bytes bytes) {
    for (int parts = 1;; ++parts) {
        const int tb = (k + parts - 1) / parts;
        if (bytes(tb) <= (size_t)SMEM_MAX || tb == 1) return tb;
    }
}

template <typename T, int NP>
cudaError_t launch_mma(const void* x, const void* w, const void* b, void* y, int n, int h, int wd, int cin,
                       int cout, int pitch, int k, int act, cudaStream_t stream) {
    auto bytes = [](int tb) { return (size_t)bf16_halo_elems(tb) * 2 + (size_t)tb * KC * (NP * 16 + 8) * 2; };
    const int tb = tap_block(k, bytes);
    const size_t smem = bytes(tb);
    auto kernel = tb < k ? conv_lk_h16_kernel<T, NP, true> : conv_lk_h16_kernel<T, NP, false>;
    cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    const int vec_x = (cin % 8 == 0) && (pitch % 8 == 0) && (reinterpret_cast<uintptr_t>(x) % 16 == 0);
    const int vec_w = (cout % 8 == 0) && (reinterpret_cast<uintptr_t>(w) % 16 == 0);
    const dim3 grid(((wd + TW - 1) / TW) * ((h + TH - 1) / TH), 1, n);
    kernel<<<grid, THREADS, smem, stream>>>(
        static_cast<const T*>(x), static_cast<const T*>(w), static_cast<const float*>(b),
        static_cast<T*>(y), h, wd, cin, cout, pitch, k, act, vec_x, vec_w, tb);
    return cudaGetLastError();
}

template <typename T, int CO>
cudaError_t launch_stacked(const void* x, const void* w, const void* b, void* y, int n, int h, int wd, int cout,
                           int pitch, int k, int act, cudaStream_t stream) {
    const size_t smem = st_smem_bytes(CO, k);
    auto kernel = conv_lk_stacked_kernel<T, CO>;
    cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    const int tiles_x = (wd + 2 * ST_W - 1) / (2 * ST_W), tiles_y = (h + 64 / CO - 1) / (64 / CO);
    const long long tiles = (long long)n * tiles_x * tiles_y;
    if (tiles > 0x7fffffffLL) return cudaErrorInvalidValue;
    const int grid = (int)(tiles < num_sms() ? tiles : num_sms());
    kernel<<<grid, 256, smem, stream>>>(static_cast<const T*>(x), static_cast<const T*>(w),
                                        static_cast<const float*>(b), static_cast<T*>(y), h, wd, cout, pitch, k, act,
                                        tiles_x, tiles_y, (int)tiles);
    return cudaGetLastError();
}

template <typename T, int NT>
cudaError_t launch_tiles(const void* x, const void* w, const void* b, void* y, int n, int h, int wd, int cin,
                         int cout, int pitch, int k, int act, cudaStream_t stream) {
    const size_t smem = tiles_smem_bytes(NT, k);
    auto kernel = conv_lk_tiles_kernel<T, NT>;
    cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    const int vec_w = (cout % 8 == 0) && (reinterpret_cast<uintptr_t>(w) % 16 == 0);
    const dim3 grid(((wd + TT_W - 1) / TT_W) * ((h + TT_H - 1) / TT_H), 1, n);
    kernel<<<grid, 256, smem, stream>>>(static_cast<const T*>(x), static_cast<const T*>(w),
                                        static_cast<const float*>(b), static_cast<T*>(y), h, wd, cin, cout, pitch, k,
                                        act, vec_w);
    return cudaGetLastError();
}

bool bad_shape(int n, int h, int w, int cin, int cout, int pitch, int k, int act) {
    return n <= 0 || h <= 0 || w <= 0 || cin <= 0 || cout <= 0 || cout > MAX_COUT || pitch < cin || k <= 0 ||
           k % 2 == 0 || (act != ACT_LINEAR && act != ACT_LRELU) || n > 65535 ||
           (long long)((h + TH32 - 1) / TH32) * ((w + TW32 - 1) / TW32) > 0x7fffffffLL;  // the f32 grid's tiles
}

// The 16-bit path of a shape, from the shape and x's alignment alone:
// stacked for Cin 16, Cout <= 16 where all the weights fit beside the ring;
// tiles for Cin 16 and 64 where two halos and two kernel rows' weights fit;
// mma for the rest (Cin 8 and 32, pixels not 16-byte aligned, k 31 at Cin
// 64).  The wgmma paths read 16-byte pieces of x.  Cin 32 stays on mma
// because there tiles was the slower (NVIDIA H100 80GB HBM3, 700.00 W,
// tools/time_kernel_variants.py, 16 x 256 x 256, both in one call: k 17
// 32 -> 32 1.90 ms against 1.56, k 13 32 -> 24 1.18 against 0.94; and the
// faster at k 17 64 -> 64, 5.25 against 7.77, and k 31 16 -> 16, 2.21
// against 2.47).
int plan_path(int cin, int cout, int k, int pitch, const void* x) {
    if (cin % 16 != 0 || cin == 32 || pitch % 8 != 0 || reinterpret_cast<uintptr_t>(x) % 16 != 0)
        return LK_PATH_MMA;
    if (cin == 16 && cout <= 16 && st_smem_bytes(cout <= 8 ? 8 : 16, k) <= (size_t)SMEM_MAX) return LK_PATH_STACKED;
    if (tiles_smem_bytes((cout + 15) / 16 * 16, k) <= (size_t)SMEM_MAX) return LK_PATH_TILES;
    return LK_PATH_MMA;
}

template <typename T>
int launch_h16_any(const void* x, const void* w, const void* b, void* y, int n, int h, int wd, int cin, int cout,
                   int pitch, int k, int act, void* stream) {
    if (bad_shape(n, h, wd, cin, cout, pitch, k, act)) return (int)cudaErrorInvalidValue;
    const cudaStream_t s = static_cast<cudaStream_t>(stream);
    switch (plan_path(cin, cout, k, pitch, x)) {
        case LK_PATH_STACKED:
            return cout <= 8 ? (int)launch_stacked<T, 8>(x, w, b, y, n, h, wd, cout, pitch, k, act, s)
                             : (int)launch_stacked<T, 16>(x, w, b, y, n, h, wd, cout, pitch, k, act, s);
        case LK_PATH_TILES:
            switch ((cout + 15) / 16) {
                case 1: return (int)launch_tiles<T, 16>(x, w, b, y, n, h, wd, cin, cout, pitch, k, act, s);
                case 2: return (int)launch_tiles<T, 32>(x, w, b, y, n, h, wd, cin, cout, pitch, k, act, s);
                case 3: return (int)launch_tiles<T, 48>(x, w, b, y, n, h, wd, cin, cout, pitch, k, act, s);
                default: return (int)launch_tiles<T, 64>(x, w, b, y, n, h, wd, cin, cout, pitch, k, act, s);
            }
        default:
            switch ((cout + 15) / 16) {
                case 1: return (int)launch_mma<T, 1>(x, w, b, y, n, h, wd, cin, cout, pitch, k, act, s);
                case 2: return (int)launch_mma<T, 2>(x, w, b, y, n, h, wd, cin, cout, pitch, k, act, s);
                case 3: return (int)launch_mma<T, 3>(x, w, b, y, n, h, wd, cin, cout, pitch, k, act, s);
                default: return (int)launch_mma<T, 4>(x, w, b, y, n, h, wd, cin, cout, pitch, k, act, s);
            }
    }
}

}  // namespace

// Plain C entry points (loaded with ctypes).  Each launches on `stream` and
// returns cudaGetLastError() right after the launch (0 = launched).  A
// launch takes at most 65535 images (the grid's z); the caller splits more.
extern "C" int resselt_conv_lk_f32(const void* x, const void* w, const void* b, void* y, int n, int h, int wd,
                                   int cin, int cout, int pitch, int k, int act, void* stream) {
    if (bad_shape(n, h, wd, cin, cout, pitch, k, act)) return (int)cudaErrorInvalidValue;
    const int ng = (cout + 7) / 8;
    auto bytes = [ng](int tb) { return ((size_t)f32_halo_floats(tb) + (size_t)tb * KC32 * ng * 8) * 4; };
    const int tb = tap_block(k, bytes);
    const size_t smem = bytes(tb);
    auto kernel = tb < k ? conv_lk_f32_kernel<true> : conv_lk_f32_kernel<false>;
    cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    const dim3 grid(((wd + TW32 - 1) / TW32) * ((h + TH32 - 1) / TH32), 1, n);
    kernel<<<grid, 32 * ng, smem, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(x), static_cast<const float*>(w), static_cast<const float*>(b),
        static_cast<float*>(y), h, wd, cin, cout, pitch, k, act, ng, tb);
    return (int)cudaGetLastError();
}

// The 16-bit path (enum Path) that resselt_conv_lk_bf16 / _f16 take for
// these arguments.
extern "C" int resselt_conv_lk_path(int cin, int cout, int k, int pitch, const void* x) {
    return plan_path(cin, cout, k, pitch, x);
}

extern "C" int resselt_conv_lk_bf16(const void* x, const void* w, const void* b, void* y, int n, int h, int wd,
                                    int cin, int cout, int pitch, int k, int act, void* stream) {
    return launch_h16_any<__nv_bfloat16>(x, w, b, y, n, h, wd, cin, cout, pitch, k, act, stream);
}

extern "C" int resselt_conv_lk_f16(const void* x, const void* w, const void* b, void* y, int n, int h, int wd,
                                   int cin, int cout, int pitch, int k, int act, void* stream) {
    return launch_h16_any<__half>(x, w, b, y, n, h, wd, cin, cout, pitch, k, act, stream);
}
