// EIMN's MOLRCM attention (multi-order large-kernel recursive context),
// the whole chain in one kernel, for Hopper.
//
// Replaces resselt_tpu/ops/molrcm.py::_kernel, which the JAX package reaches
// through fused_molrcm.  For NHWC x with dim = 64 channels, split c1 = 24,
// c2 = 8, c3 = 32, it computes what that kernel computes:
//   value = Wv x + bv
//   q     = gelu(Wq x + bq)                          (exact erf form)
//   r     = dw5x5(q) + br                             (pad 2)
//   f     = [dw5x5_dil2(r[:c1]) + b1, r[c1:c1+c2], dw7x7_dil3(r[c1+c2:]) + b2]
//   out   = Wo (silu(Wf f + bf) * value) + bo
// Every depthwise conv zero-pads its own input, as torch's convs do: q is
// zero outside the image before the region conv, and r is zero outside the
// image before the dilated pair.  x and out are contiguous (n, h, w, 64) in
// f32, bf16 or fp16; w is the f32 buffer ops/molrcm.py::pack_molrcm_weights builds
// (1x1 weights as torch's [c_out][k], depthwise taps as [dy * K + dx][c];
// for a 16-bit model every value is already rounded to its type).  Takes any n, h,
// w >= 1.
//
// What bounds it on an H100: bytes, by the book.  The chain does 20,152 MAC
// per pixel (16,384 of them in the four 64 x 64 products) on 256 B (bf16)
// of x and out: 42 GFLOP and 268 MB at the bench shape (16 x 256 x 256),
// 0.043 ms at 989 TFLOP/s and 0.080 ms at 3.35 TB/s.  In practice the
// depthwise convs (3,768 f32 MAC a pixel on the CUDA cores, with their
// shared-memory traffic) and gelu's erff on every q value bound it.  The
// TPU kernel's layout (W on 128 lanes, host-assembled overlapping W-tiles,
// lane rolls) does not carry over.
//  * f32: a block of 512 threads owns a 16 x 16-pixel output tile and works
//    through the channels in groups of 8: q on the group's halo (38 x 38
//    pixels for the dil-3 channels), r on that halo less 2, then the
//    group's f on the tile; every product in exact f32 FMA (no TF32), Wf f
//    accumulated group by group in registers.  It recomputes q on 4.35x and
//    r on 3.2x the tile's pixels.
//  * bf16 / fp16 (one template over the 16-bit type E): one persistent
//    block of 512 threads per SM walks down 16-column strips of the image
//    (an item: one strip of one image, over a run of rows that strip_rows
//    plans so that the items fill the card; the whole height at the bench
//    shape).  Rings in shared memory hold q rows
//    of each channel class on the columns the class needs (38 for the
//    dil-3 channels, 28 dil-2, 20 pass-through) and r rows (34 / 24 / 16
//    columns): every row of q and r is computed once per strip, and only
//    the horizontal halo is recomputed (q on 2.4x the strip's pixels, r on
//    1.75x).  Step i of an item has one block-wide barrier: it computes q
//    row i, r row i - 3, f row i - 13, the gated product of row i - 14 and
//    the output of row i - 15, each from rows that earlier steps wrote (x
//    row i comes in by cp.async during step i - 1), so that every warp runs
//    a mix of stages and none waits for another inside a step.  q on the
//    tensor cores (mma.sync m16n8k16 tiles placed on each class's columns,
//    Wq's fragments in registers), gelu in the exact erf form; the region
//    and dilated convs on the CUDA cores, a thread one channel and a run of
//    columns with its taps in registers and its class's geometry known at
//    compile time; the three other products on the tensor cores from
//    weights in shared memory.  f and the gated product are f32 values,
//    each split into two 16-bit parts (hi + lo) multiplied in turn, so
//    those products lose nothing beyond f32 rounding in bf16 and keep 22
//    bits in fp16 (x and the weights are 16-bit already); q, r and f stay
//    f32 in shared memory.
// What it reaches and leaves (NVIDIA H100 80GB HBM3, 700.00 W,
// tools/time_kernel_variants.py, every design in one call): 1.67 ms at the
// bench shape (16 x 256 x 256), 21x the byte bound; the same strips with
// three barriers a step took 2.53, and the 16 x 16-tile design before them
// about 2.5.  It is bound by instruction issue: a step issues about 12,000
// warp-instructions for 16 output pixels, and the 16 warps' dependency
// chains (ldmatrix, mma, erff, shared-memory loads) leave some 40% of the
// issue slots idle.
// A copy with one stage compiled out saves 0.40 (r), 0.45 (f), 0.44 (q) or
// 0.58 ms (the products of the output rows).  What would move it: fewer
// instructions per output pixel, which needs wider strips and so the r
// rings out of shared memory (f accumulated as r rows arrive), and more
// warps to hide the chains, which needs fewer registers than the dil-3 f
// threads' 49 taps.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "async_copy.cuh"
#include "half16.cuh"

namespace {

constexpr int DIM = 64;
constexpr int C1 = 24;   // dw5x5 dilation 2
constexpr int C2 = 8;    // passed through
constexpr int C3 = 32;   // dw7x7 dilation 3
constexpr int T = 16;    // output tile side
constexpr int TP = T * T;
constexpr int THREADS = 512;
constexpr int G = 8;     // channels per group
constexpr int QMAX = T + 22;  // q halo side of the dil-3 groups
constexpr int RMAX = T + 18;  // r halo side of the dil-3 groups
constexpr int LDB = DIM + 8;  // 16-bit row stride of the [pixel][channel] tiles (conflict-free ldmatrix)

// Packed weights (floats), as ops/molrcm.py::_layout(64) lays them out.
constexpr int W_Q = 0;
constexpr int B_Q = W_Q + DIM * DIM;
constexpr int W_V = B_Q + DIM;
constexpr int B_V = W_V + DIM * DIM;
constexpr int W_R = B_V + DIM;
constexpr int B_R = W_R + 25 * DIM;
constexpr int W_1 = B_R + DIM;
constexpr int B_1 = W_1 + 25 * C1;
constexpr int W_2 = B_1 + C1;
constexpr int B_2 = W_2 + 49 * C3;
constexpr int W_F = B_2 + C3;
constexpr int B_F = W_F + DIM * DIM;
constexpr int W_O = B_F + DIM;
constexpr int B_O = W_O + DIM * DIM;
constexpr int W_TOTAL = B_O + DIM;

// ---------------------------------------------------------------------------
// Shared by both kernels: the group geometry and the depthwise stages.
// ---------------------------------------------------------------------------

struct Group {
    int c0;    // first channel
    int kind;  // 0: pass-through, 1: dw5x5 dil 2, 2: dw7x7 dil 3
    int rr;    // reach of the dilated conv: r is needed on T + 2 rr
    int rq;    // plus the region conv's: q is needed on T + 2 rq
    int er, eq;
};

__device__ __forceinline__ Group group(int g) {
    Group s;
    s.c0 = g * G;
    s.kind = g < C1 / G ? 1 : (g < (C1 + C2) / G ? 0 : 2);
    s.rr = s.kind == 1 ? 4 : (s.kind == 2 ? 9 : 0);
    s.rq = s.rr + 2;
    s.er = T + 2 * s.rr;
    s.eq = T + 2 * s.rq;
    return s;
}

// Depthwise taps and biases of the group: WR [25][8], BR [8], WD [49][8], BD [8].
struct DwSmem {
    float* WR;
    float* BR;
    float* WD;
    float* BD;
};
constexpr int DW_FLOATS = 25 * G + G + 49 * G + G;

__device__ __forceinline__ DwSmem dw_smem(float* base) {
    return {base, base + 25 * G, base + 26 * G, base + 75 * G};
}

__device__ void load_dw(const float* __restrict__ w, const Group& s, DwSmem d) {
    for (int i = threadIdx.x; i < 49 * G; i += THREADS) {
        const int t = i / G, c = i % G;
        if (t < 25) d.WR[i] = w[W_R + t * DIM + s.c0 + c];
        float tap = 0.f;
        if (s.kind == 1 && t < 25) tap = w[W_1 + t * C1 + s.c0 + c];
        if (s.kind == 2) tap = w[W_2 + t * C3 + s.c0 - C1 - C2 + c];
        d.WD[i] = tap;
    }
    if (threadIdx.x < G) {
        const int c = threadIdx.x;
        d.BR[c] = w[B_R + s.c0 + c];
        d.BD[c] = s.kind == 1 ? w[B_1 + s.c0 + c] : (s.kind == 2 ? w[B_2 + s.c0 - C1 - C2 + c] : 0.f);
    }
}

__device__ __forceinline__ float4 ld4(const float* p) { return *reinterpret_cast<const float4*>(p); }
__device__ __forceinline__ void st4(float* p, float4 v) { *reinterpret_cast<float4*>(p) = v; }

__device__ __forceinline__ void fma4(float4& acc, float4 a, float4 b) {
    acc.x = fmaf(a.x, b.x, acc.x);
    acc.y = fmaf(a.y, b.y, acc.y);
    acc.z = fmaf(a.z, b.z, acc.z);
    acc.w = fmaf(a.w, b.w, acc.w);
}

__device__ __forceinline__ float gelu(float v) { return 0.5f * v * (1.f + erff(v * 0.70710678118654752f)); }
__device__ __forceinline__ float silu(float v) { return v / (1.f + expf(-v)); }

// The depthwise stages work on one channel per thread with that channel's
// taps in registers.  Lane l takes channel l % 8 of the group, so a warp
// covers 4 neighbouring columns x 8 channels and each of its shared-memory
// reads is 32 consecutive floats.  A thread walks a run of output rows that
// share input rows, loading each input row once per tap column.

// r = dw5x5(q) + br on the group's er x er halo (zero outside the image).
// Q holds the group's 8 channels of q on a qeq x qeq halo, [qeq * qeq][8],
// whose row and column qoff is the group's own halo's first; RG is
// [er * er][8].  Runs of RUN consecutive rows.
constexpr int RUN = 4;

__device__ void region_conv(const float* Q, int qeq, int qoff, float* RG, DwSmem d, const Group& s, int oy, int ox,
                            int h, int wd) {
    const int c = threadIdx.x % G;
    float tap[25];
#pragma unroll
    for (int t = 0; t < 25; ++t) tap[t] = d.WR[t * G + c];
    const float bias = d.BR[c];
    const int runs = (s.er + RUN - 1) / RUN;
    for (int it = threadIdx.x / G; it < s.er * runs; it += THREADS / G) {
        const int rx = it % s.er, ry0 = (it / s.er) * RUN;
        float acc[RUN];
#pragma unroll
        for (int m = 0; m < RUN; ++m) acc[m] = 0.f;
#pragma unroll
        for (int dx = 0; dx < 5; ++dx) {
#pragma unroll
            for (int j = 0; j < RUN + 4; ++j) {
                // input row ry0 + j feeds output rows ry0 + m at tap dy = j - m;
                // rows past the halo feed only rows past er, which are not stored
                const float q = Q[((min(ry0 + j, s.eq - 1) + qoff) * qeq + rx + dx + qoff) * G + c];
#pragma unroll
                for (int m = 0; m < RUN; ++m)
                    if (j - m >= 0 && j - m < 5) acc[m] = fmaf(q, tap[(j - m) * 5 + dx], acc[m]);
            }
        }
#pragma unroll
        for (int m = 0; m < RUN; ++m) {
            const int ry = ry0 + m;
            const int y = oy - s.rr + ry, xx = ox - s.rr + rx;
            if (ry < s.er) RG[(ry * s.er + rx) * G + c] = y >= 0 && y < h && xx >= 0 && xx < wd ? acc[m] + bias : 0.f;
        }
    }
}

// f = dwKxK_dilD(r) + bd for the group's channels on the tile: store(px, c,
// value) for every tile pixel and channel c < 8.  Under dilation D the
// output rows ty0, ty0 + D, ... share input rows, so a run is one such
// residue class of one column: M rows.
template <int K, int D, class Store>
__device__ void dilated_conv(const float* RG, DwSmem d, int er, Store store) {
    constexpr int M = (T + D - 1) / D;
    const int c = threadIdx.x % G;
    float tap[K * K];
#pragma unroll
    for (int t = 0; t < K * K; ++t) tap[t] = d.WD[t * G + c];
    const float bias = d.BD[c];
    for (int it = threadIdx.x / G; it < T * D; it += THREADS / G) {
        const int tx = it % T, ty0 = it / T;
        float acc[M];
#pragma unroll
        for (int m = 0; m < M; ++m) acc[m] = 0.f;
#pragma unroll
        for (int dx = 0; dx < K; ++dx) {
#pragma unroll
            for (int j = 0; j < M + K - 1; ++j) {
                // output row ty0 + D m at tap dy reads r row ty0 + D (m + dy)
                const float v = RG[(min(ty0 + D * j, er - 1) * er + tx + D * dx) * G + c];
#pragma unroll
                for (int m = 0; m < M; ++m)
                    if (j - m >= 0 && j - m < K) acc[m] = fmaf(v, tap[(j - m) * K + dx], acc[m]);
            }
        }
#pragma unroll
        for (int m = 0; m < M; ++m)
            if (ty0 + D * m < T) store((ty0 + D * m) * T + tx, c, acc[m] + bias);
    }
}

// The group's f: the dilated conv of its branch, or r itself on the tile.
template <class Store>
__device__ void group_f(const float* RG, DwSmem d, const Group& s, Store store) {
    if (s.kind == 1) {
        dilated_conv<5, 2>(RG, d, s.er, store);
    } else if (s.kind == 2) {
        dilated_conv<7, 3>(RG, d, s.er, store);
    } else {
        for (int i = threadIdx.x; i < TP * G; i += THREADS) store(i / G, i % G, RG[i]);
    }
}

// ---------------------------------------------------------------------------
// f32: CUDA-core FMA throughout.
// ---------------------------------------------------------------------------

// Shared memory (floats).  XT holds the tile's x as [k][pixel], then the
// gated product as [c][pixel].  The work area holds one group's buffers
// during the group loop, then Wv, Wo and the biases.
constexpr int F_XT = 0;
constexpr int F_WORK = F_XT + DIM * TP;
constexpr int F_QG = F_WORK;                 // [QMAX * QMAX][8]
constexpr int F_RG = F_QG + QMAX * QMAX * G;  // [RMAX * RMAX][8]
constexpr int F_FG = F_RG + RMAX * RMAX * G;  // [8][pixel]
constexpr int F_WQG = F_FG + G * TP;          // [64][8]
constexpr int F_BQG = F_WQG + DIM * G;
constexpr int F_WFG = F_BQG + G;              // [8][64]
constexpr int F_DW = F_WFG + G * DIM;
constexpr int F_END = F_DW + DW_FLOATS;
constexpr int F_WV = F_WORK;                  // after the group loop
constexpr int F_WO = F_WV + DIM * DIM;
constexpr int F_BV = F_WO + DIM * DIM;
constexpr int F_BF = F_BV + DIM;
constexpr int F_BO = F_BF + DIM;
static_assert(F_BO + DIM <= F_END, "phase-2 weights must fit the work area");
constexpr size_t F32_SMEM = (size_t)F_END * sizeof(float);

// acc[i][j] += sum_k A[k][px0 + i] * B[k][co0 + j] over k < K: A is [k][pixel]
// with TP pixels a row, B is [k][c] with DIM channels a row.
template <int K>
__device__ __forceinline__ void tile_product(float (&acc)[4][8], const float* A, const float* B, int px0, int co0) {
#pragma unroll 8
    for (int k = 0; k < K; ++k) {
        const float4 a = ld4(A + k * TP + px0);
        const float4 b0 = ld4(B + k * DIM + co0), b1 = ld4(B + k * DIM + co0 + 4);
        const float av[4] = {a.x, a.y, a.z, a.w};
        const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
}

__global__ void __launch_bounds__(THREADS, 1)
molrcm_f32_kernel(const float* __restrict__ x, const float* __restrict__ w, float* __restrict__ out, int h, int wd,
                  int tiles_w, int tiles_per_image) {
    extern __shared__ __align__(16) float smem[];
    const int tid = threadIdx.x;
    const int img = blockIdx.x / tiles_per_image;
    const int tile = blockIdx.x % tiles_per_image;
    const int oy = (tile / tiles_w) * T, ox = (tile % tiles_w) * T;
    const float* xi = x + (size_t)img * h * wd * DIM;

    // the tile's x, transposed to [k][pixel] (zero outside the image)
    float* XT = smem + F_XT;
    for (int i = tid; i < TP * (DIM / 4); i += THREADS) {
        const int px = i % TP, kq = i / TP;
        const int y = oy + px / T, xx = ox + px % T;
        float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
        if (y < h && xx < wd) v = ld4(xi + ((size_t)y * wd + xx) * DIM + kq * 4);
        XT[(kq * 4 + 0) * TP + px] = v.x;
        XT[(kq * 4 + 1) * TP + px] = v.y;
        XT[(kq * 4 + 2) * TP + px] = v.z;
        XT[(kq * 4 + 3) * TP + px] = v.w;
    }

    // this thread's share of the tile products: 4 pixels x 8 channels
    const int px0 = (tid % (TP / 4)) * 4;
    const int co0 = (tid / (TP / 4)) * 8;
    float hacc[4][8];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) hacc[i][j] = 0.f;

    float* QG = smem + F_QG;
    float* RG = smem + F_RG;
    float* FG = smem + F_FG;
    float* WQG = smem + F_WQG;
    float* BQG = smem + F_BQG;
    float* WFG = smem + F_WFG;
    const DwSmem dw = dw_smem(smem + F_DW);

    for (int g = 0; g < DIM / G; ++g) {
        const Group s = group(g);
        __syncthreads();  // the previous group's readers are done
        for (int i = tid; i < DIM * G; i += THREADS) {
            WQG[i] = w[W_Q + (s.c0 + i % G) * DIM + i / G];
            WFG[i] = w[W_F + (i % DIM) * DIM + s.c0 + i / DIM];
        }
        if (tid < G) BQG[tid] = w[B_Q + s.c0 + tid];
        load_dw(w, s, dw);
        __syncthreads();

        // q = gelu(Wq x + bq) for this group's channels on its eq x eq halo
        for (int p = tid; p < s.eq * s.eq; p += THREADS) {
            const int y = oy - s.rq + p / s.eq, xx = ox - s.rq + p % s.eq;
            float4 a0 = make_float4(0.f, 0.f, 0.f, 0.f), a1 = a0;
            if (y >= 0 && y < h && xx >= 0 && xx < wd) {
                a0 = ld4(BQG);
                a1 = ld4(BQG + 4);
                const float* xp = xi + ((size_t)y * wd + xx) * DIM;
#pragma unroll
                for (int kq = 0; kq < DIM / 4; ++kq) {
                    const float4 v = ld4(xp + kq * 4);
                    const float xv[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
                    for (int kk = 0; kk < 4; ++kk) {
                        const int k = kq * 4 + kk;
                        const float4 xk = make_float4(xv[kk], xv[kk], xv[kk], xv[kk]);
                        fma4(a0, xk, ld4(WQG + k * G));
                        fma4(a1, xk, ld4(WQG + k * G + 4));
                    }
                }
                a0 = make_float4(gelu(a0.x), gelu(a0.y), gelu(a0.z), gelu(a0.w));
                a1 = make_float4(gelu(a1.x), gelu(a1.y), gelu(a1.z), gelu(a1.w));
            }
            st4(QG + p * G, a0);
            st4(QG + p * G + 4, a1);
        }
        __syncthreads();
        region_conv(QG, s.eq, 0, RG, dw, s, oy, ox, h, wd);
        __syncthreads();
        group_f(RG, dw, s, [&](int px, int c, float v) { FG[c * TP + px] = v; });
        __syncthreads();
        tile_product<G>(hacc, FG, WFG, px0, co0);  // this group's share of Wf f
    }

    __syncthreads();  // the last group's readers are done with the work area
    for (int i = tid; i < DIM * DIM; i += THREADS) {
        smem[F_WV + i] = w[W_V + (i % DIM) * DIM + i / DIM];  // to [k][c]
        smem[F_WO + i] = w[W_O + (i % DIM) * DIM + i / DIM];
    }
    if (tid < DIM) {
        smem[F_BV + tid] = w[B_V + tid];
        smem[F_BF + tid] = w[B_F + tid];
        smem[F_BO + tid] = w[B_O + tid];
    }
    __syncthreads();

    // value = Wv x + bv, then gated = silu(Wf f + bf) * value
    float vacc[4][8];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) vacc[i][j] = smem[F_BV + co0 + j];
    tile_product<DIM>(vacc, XT, smem + F_WV, px0, co0);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) vacc[i][j] *= silu(hacc[i][j] + smem[F_BF + co0 + j]);
    __syncthreads();  // every thread is done reading XT
#pragma unroll
    for (int j = 0; j < 8; ++j)
        st4(XT + (co0 + j) * TP + px0, make_float4(vacc[0][j], vacc[1][j], vacc[2][j], vacc[3][j]));
    __syncthreads();

    // out = Wo gated + bo
    float oacc[4][8];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) oacc[i][j] = smem[F_BO + co0 + j];
    tile_product<DIM>(oacc, XT, smem + F_WO, px0, co0);
    float* oi = out + (size_t)img * h * wd * DIM;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
        const int px = px0 + i;
        const int y = oy + px / T, xx = ox + px % T;
        if (y < h && xx < wd) {
            float* op = oi + ((size_t)y * wd + xx) * DIM + co0;
            st4(op, make_float4(oacc[i][0], oacc[i][1], oacc[i][2], oacc[i][3]));
            st4(op + 4, make_float4(oacc[i][4], oacc[i][5], oacc[i][6], oacc[i][7]));
        }
    }
}

// ---------------------------------------------------------------------------
// bf16 / fp16 (template parameter E): a block walks down a 16-column strip
// of the image and keeps rings of q and r rows in shared memory, so that
// every row of q and r is computed once per strip.  See the note at the top.
// ---------------------------------------------------------------------------

constexpr int SW = 16;              // output columns of a strip
constexpr int QW = SW + 22;         // q columns: the strip's - 11 .. + 26 (the dil-3 channels' reach)
constexpr int R3W = SW + 18;        // dil-3 channels' r columns: - 9 .. + 24
constexpr int R2W = SW + 8;         // dil-2 channels' r columns: - 4 .. + 19
constexpr int Q2LO = 5, Q2W = SW + 12;  // dil-2 channels' q columns: q column 5 (- 6) .. + 21
constexpr int QPLO = 9, QPW = SW + 4;   // pass-through channels' q columns: q column 9 (- 2) .. + 17
// Step i of an item computes q row i, r row i - LAG_R, f row i - LAG_F,
// the gated product of row i - LAG_O and the output of row i - LAG_G; each
// reads only rows that earlier steps wrote.
constexpr int LAG_R = 3, LAG_F = 13, LAG_O = 14, LAG_G = 15;
// Ring slots (rows): q rows i - 5 .. i, r rows i - 22 .. i - 3 (dil 3),
// i - 17 .. i - 3 (dil 2), i - 13 .. i - 3 (pass-through).
constexpr int QS = 6, R3S = 20, R2S = 15, RPS = 11;
constexpr int ST_THREADS = 512;
// Steps an item takes beyond its rows: the 11 q rows above it and the lag
// of its last output row.
constexpr int ST_EXTRA = 11 + LAG_G;
// packed biases in shared memory (floats)
constexpr int SB_Q = 0, SB_R = 64, SB_1 = 128, SB_2 = 152, SB_V = 184, SB_F = 248, SB_O = 312, SB_N = 376;

// Shared memory (bytes), all offsets 16-byte aligned.
constexpr int S_Q3 = 0;                                  // q ring [QS][QW][32] f32, channels 32..63
constexpr int S_Q2 = S_Q3 + QS * QW * C3 * 4;            // q ring [QS][Q2W][24] f32, channels 0..23
constexpr int S_QP = S_Q2 + QS * Q2W * C1 * 4;           // q ring [QS][QPW][8] f32, channels 24..31
constexpr int S_R3 = S_QP + QS * QPW * C2 * 4;           // r ring [R3S][R3W][32] f32, channels 32..63
constexpr int S_R2 = S_R3 + R3S * R3W * C3 * 4;          // r ring [R2S][R2W][24] f32, channels 0..23
constexpr int S_RP = S_R2 + R2S * R2W * C1 * 4;          // r ring [RPS][SW][8] f32, channels 24..31
constexpr int S_W = S_RP + RPS * SW * C2 * 4;            // Wv (qperm), Wf, Wo: [3][64][64] 16-bit, swizzled (w_col)
constexpr int S_BIAS = S_W + 3 * DIM * DIM * 2;
constexpr int S_X = S_BIAS + SB_N * 4;                   // x rows, 2 x [QW][64] 16-bit, 16-byte pieces swizzled
constexpr int S_FT = S_X + 2 * QW * DIM * 2;             // f rows, 2 slots x (hi, lo) x [SW][LDB] 16-bit
constexpr int S_GT = S_FT + 4 * SW * LDB * 2;            // gated rows, 2 slots x (hi, lo) x [SW][LDB] 16-bit
constexpr int S_END = S_GT + 4 * SW * LDB * 2;
static_assert(S_END <= 232448, "a block has at most 227 KB of shared memory");

// (a, b) as hi + lo pairs of the 16-bit type: hi = E(v), lo = E(v - hi).
template <typename E>
__device__ __forceinline__ void split_h16(float a, float b, uint32_t& hi, uint32_t& lo) {
    hi = Half16<E>::pack(a, b);
    const float2 back = Half16<E>::unpack(hi);
    lo = Half16<E>::pack(a - back.x, b - back.y);
}

// The value product takes its A fragments straight from global x: within
// each k16 step ks, lane t4 holds logical channels (2 t4, 2 t4 + 1) and
// (2 t4 + 8, 2 t4 + 9); they are taken from physical channels
// 16 t4 + 4 ks + (0, 1) and + (2, 3), so that a lane reads one 32-byte run
// of a pixel.  qperm(k) is the column of a [n][64] weight row that holds
// physical input channel k in that order.
__device__ __forceinline__ int qperm(int k) {
    const int t = k / 16, ks = (k % 16) / 4, hi = (k % 4) / 2, e = k % 2;
    return ks * 16 + hi * 8 + 2 * t + e;
}

// Rows of the [64][64] 16-bit weight tiles are 128 bytes: the 16-byte
// piece p of row n lies at piece p ^ (n % 8), so that ldmatrix's 8 rows
// fall in 8 different banks.  w_col is where column k of row n lies.
__device__ __forceinline__ int w_col(int n, int k) { return (((k >> 3) ^ (n & 7)) << 3) | (k & 7); }
// ldmatrix_x4 of a weight tile's B fragments for k16 steps ks, ks + 1 and
// output channels n0 .. n0 + 7 (n0 a multiple of 8): lane l's row address.
__device__ __forceinline__ int w_frag(int n0, int ks, int lane) {
    return (n0 + (lane & 7)) * DIM + w_col(lane & 7, 16 * (ks + (lane >> 4)) + ((lane >> 3) & 1) * 8);
}

// The 32 bytes of a pixel's x that lane t4 owns: channels 16 t4 .. 16 t4 + 15.
template <typename E>
__device__ __forceinline__ void load_x32(const E* p, bool valid, uint32_t (&v)[8]) {
    uint4 a = make_uint4(0u, 0u, 0u, 0u), b = a;
    if (valid) {
        a = *reinterpret_cast<const uint4*>(p);
        b = *reinterpret_cast<const uint4*>(p + 8);
    }
    v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
    v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}

// The ring slot of a row; rows are never below -64 slots.
__device__ __forceinline__ int ring(int row, int slots) { return (row + 64 * slots) % slots; }

// silu with a fast division (2 ulp; 0 where 1 + e^-v overflows, which is the limit)
__device__ __forceinline__ float silu_fast(float v) { return __fdividef(v, 1.f + expf(-v)); }

// One m16 x n8 tile of q: channels 8 nt .. 8 nt + 7 on the 16 q columns
// from `start`, of which it stores columns [lo, hi).  The channels of an
// n-tile are of one class, and each class's tiles cover just the columns
// it needs: 0 .. 37 (dil 3), 5 .. 32 (dil 2), 9 .. 28 (pass-through).
struct QTile {
    int nt, start, lo, hi;
};
__device__ __forceinline__ QTile q_tile(int nt, int t) {
    if (nt < C1 / 8) return t == 0 ? QTile{nt, 5, 5, 21} : QTile{nt, 17, 21, 33};
    if (nt < (C1 + C2) / 8) return t == 0 ? QTile{nt, 9, 9, 25} : QTile{nt, 13, 25, 29};
    return t == 0 ? QTile{nt, 0, 0, 16} : (t == 1 ? QTile{nt, 16, 16, 32} : QTile{nt, 22, 32, 38});
}
// The q tiles of warp w: tile 0 of n-tile w for warps 0..6, tiles 1 and 2
// of the dil-3 n-tiles for warps 8..11, tile 1 of n-tile w - 12 for warps
// 12..15, and tile 0 of n-tile 7 for warp 12 (warp 7, whose r runs are of
// two classes, has none).
__device__ __forceinline__ int q_tiles_of(int w) { return w == 7 ? 0 : (w >= 8 && w < 13 ? 2 : 1); }
__device__ __forceinline__ QTile q_tile_of(int w, int p) {
    if (w < 8) return q_tile(w, 0);
    if (w < 12) return q_tile(w - 4, 1 + p);
    if (w == 12 && p == 1) return q_tile(7, 0);
    return q_tile(w - 12, 1);
}

// The geometry of a channel class of r (K 3: the dil-3 channels, 2: the
// dil-2 ones, 0: the pass-through ones), known at compile time.
template <int K>
struct RGeo {
    static constexpr int LEFT = K == 3 ? 9 : (K == 2 ? 4 : 0);   // r column 0 is strip column -LEFT
    static constexpr int WIDTH = SW + 2 * LEFT;                  // r columns
    static constexpr int QN = WIDTH + 4;                         // q columns of the class's ring
    static constexpr int CH = K == 3 ? C3 : (K == 2 ? C1 : C2);  // channels of the class
};

// r row j = dw5x5(q) + br of one channel on the 8 r columns from br0 (of
// which columns past the class's width are not stored: only the last dil-3
// run has any).  q and r point at the channel in the class's rings, qs is
// the slot of q row j - 2, rs the slot of r row j; bit m of vmask says
// that r column br0 + m lies in the image (none does for a row outside it).
// The reads run past the class's q columns only for columns that are not
// stored.
template <int K>
__device__ __forceinline__ void r_run(const float* q, float* r, const float (&tap)[49], float bias, int br0, int qs,
                                      int rs, unsigned vmask) {
    using G = RGeo<K>;
    float acc[8] = {};
    if (vmask) {
#pragma unroll
        for (int dy = 0; dy < 5; ++dy) {
            const int s = qs + dy < QS ? qs + dy : qs + dy - QS;
            const float* qr = q + (s * G::QN + br0) * G::CH;
            float qv[12];
#pragma unroll
            for (int m = 0; m < 12; ++m) qv[m] = qr[m * G::CH];
#pragma unroll
            for (int dx = 0; dx < 5; ++dx)
#pragma unroll
                for (int m = 0; m < 8; ++m) acc[m] = fmaf(qv[m + dx], tap[dy * 5 + dx], acc[m]);
        }
    }
    float* rr = r + (rs * G::WIDTH + br0) * G::CH;
#pragma unroll
    for (int m = 0; m < 8; ++m)
        if (br0 + m < G::WIDTH) rr[m * G::CH] = (vmask >> m) & 1 ? acc[m] + bias : 0.f;
}

// Work of a step, by warp (one barrier a step, every stage reading rows
// that earlier steps wrote):
//   warps 0..7:   the gated product of row i - 14 (warp w: channels 8 w ..
//                 + 7), one q tile of row i (none on warp 7), one run of r
//                 row i - 3
//   warps 8..13:  f row i - 13 of the dil-3 channels (a residue run of
//                 columns each), two q tiles of row i (warps 8..12) or one
//                 (13)
//   warps 14, 15: f row i - 13 of the dil-2 and pass-through channels,
//                 one q tile of row i
//   warps 8..15:  output row i - 15 (warp w: channels 8 (w - 8) .. + 7)
template <typename E>
__global__ void __launch_bounds__(ST_THREADS, 1)
molrcm_h16_kernel(const E* __restrict__ x, const float* __restrict__ w, E* __restrict__ out, int h, int wd,
                  int strips, int seg_rows, int segs, int items) {
    using HT = Half16<E>;
    extern __shared__ __align__(16) unsigned char sm[];
    float* Q3 = reinterpret_cast<float*>(sm + S_Q3);
    float* Q2 = reinterpret_cast<float*>(sm + S_Q2);
    float* QP = reinterpret_cast<float*>(sm + S_QP);
    float* R3 = reinterpret_cast<float*>(sm + S_R3);
    float* R2 = reinterpret_cast<float*>(sm + S_R2);
    float* RP = reinterpret_cast<float*>(sm + S_RP);
    E* W3 = reinterpret_cast<E*>(sm + S_W);
    const float* BS = reinterpret_cast<const float*>(sm + S_BIAS);
    E* XB = reinterpret_cast<E*>(sm + S_X);
    E* FT = reinterpret_cast<E*>(sm + S_FT);
    E* GT = reinterpret_cast<E*>(sm + S_GT);
    const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
    const int g8 = lane >> 2, t4 = lane & 3;

    // the weights, once per block: Wv (columns in qperm order), Wf, Wo as
    // 16-bit [n][64] (swizzled) and every bias in shared memory; each thread's
    // depthwise taps and Wq fragments in registers
    for (int i = tid; i < 3 * DIM * DIM / 2; i += ST_THREADS) {
        const int m = i / (DIM * DIM / 2), e = 2 * (i % (DIM * DIM / 2)), n = e / DIM, k = e % DIM;
        const float2 v = *reinterpret_cast<const float2*>(w + (m == 0 ? W_V : (m == 1 ? W_F : W_O)) + e);
        *reinterpret_cast<uint32_t*>(W3 + (m * DIM + n) * DIM + w_col(n, m == 0 ? qperm(k) : k)) = HT::pack(v.x, v.y);
    }
    {
        float* bs = reinterpret_cast<float*>(sm + S_BIAS);
        for (int i = tid; i < SB_N; i += ST_THREADS)
            bs[i] = i < SB_R ? w[B_Q + i] : i < SB_1 ? w[B_R + i - SB_R] : i < SB_2 ? w[B_1 + i - SB_1]
                  : i < SB_V ? w[B_2 + i - SB_2] : i < SB_F ? w[B_V + i - SB_V] : i < SB_O ? w[B_F + i - SB_F]
                  : w[B_O + i - SB_O];
    }
    // q: the warp's tiles, their Wq fragments, and which of a lane's two
    // fragment rows (hr) each tile stores (bit 2 p + hr); a half that no
    // lane of the warp stores is skipped
    const int nq = q_tiles_of(warp);
    uint32_t wq[2][4][2];
    unsigned qstore = 0, qlive = 0;
#pragma unroll
    for (int p = 0; p < 2; ++p) {
        const QTile qt = q_tile_of(warp, p < nq ? p : 0);
        const int n = 8 * qt.nt + g8;
#pragma unroll
        for (int ks = 0; ks < 4; ++ks) {
            const float* wr = w + W_Q + n * DIM + 16 * ks + 2 * t4;
            wq[p][ks][0] = HT::pack(wr[0], wr[1]);
            wq[p][ks][1] = HT::pack(wr[8], wr[9]);
        }
#pragma unroll
        for (int hr = 0; hr < 2; ++hr) {
            const int px = qt.start + g8 + 8 * hr, first = qt.start + 8 * hr;
            if (p < nq && px >= qt.lo && px < qt.hi) qstore |= 1u << (2 * p + hr);
            if (p < nq && first + 7 >= qt.lo && first < qt.hi) qlive |= 1u << (2 * p + hr);
        }
    }
    // r (threads 0..247): thread t owns channel bc and r columns br0 ..
    // br0 + 7 of its class: 5 runs of the dil-3 channels' 34 columns (160
    // threads, warps 0..4), 3 of the dil-2 ones' 24 (72), 2 of the
    // pass-through ones' 16 (16).  f (threads 256..511): a dil-3 channel on
    // a residue run of columns 3 apart (192 threads), a dil-2 channel on the
    // 8 columns of one parity (48), or the 8 pass-through channels of a
    // column (16).  tap holds the thread's depthwise taps.
    int bc = -1, br0 = 0, rleft = 0;
    if (tid < 160) bc = C1 + C2 + (tid & 31), br0 = (tid >> 5) * 8, rleft = RGeo<3>::LEFT;
    else if (tid < 232) bc = (tid - 160) % C1, br0 = (tid - 160) / C1 * 8, rleft = RGeo<2>::LEFT;
    else if (tid < 248) bc = C1 + ((tid - 232) & 7), br0 = ((tid - 232) >> 3) * 8;
    float tap[49];
#pragma unroll
    for (int t = 0; t < 49; ++t) {
        float v = 0.f;
        if (tid < 256) {
            if (t < 25 && bc >= 0) v = w[W_R + t * DIM + bc];
        } else if (tid < 448) {
            v = w[W_2 + t * C3 + lane];
        } else if (tid < 496) {
            if (t < 25) v = w[W_1 + t * C1 + (tid - 448) % C1];
        }
        tap[t] = v;
    }
    // x rows: thread t < QW * 8 copies 16-byte piece t % 8 of q column t / 8,
    // stored at piece (t % 8) ^ (column % 8), so that ldmatrix's 8 rows fall
    // in 8 different banks
    const int xpx = tid >> 3, xpiece = tid & 7;
    const uint32_t xdst = static_cast<uint32_t>(__cvta_generic_to_shared(XB)) +
                          (xpx * DIM + 8 * (xpiece ^ (xpx & 7))) * 2;

    for (int item = blockIdx.x; item < items; item += gridDim.x) {
        const int seg = item % segs, strip = (item / segs) % strips, img = item / (segs * strips);
        const int ya = seg * seg_rows, yb = min(ya + seg_rows, h), x0 = strip * SW;
        const E* xi = x + (size_t)img * h * wd * DIM;
        E* oi = out + (size_t)img * h * wd * DIM;
        const size_t row_elems = (size_t)wd * DIM;

        // the item's column masks: of the x piece this thread copies, of the
        // q columns it stores, of the r columns it computes
        const int xcol = x0 - 11 + xpx;
        const bool xcol_ok = tid < QW * 8 && xcol >= 0 && xcol < wd;
        unsigned qcol = 0, rcol = 0;
#pragma unroll
        for (int p = 0; p < 2; ++p)
#pragma unroll
            for (int hr = 0; hr < 2; ++hr) {
                const int col = x0 - 11 + q_tile_of(warp, p < nq ? p : 0).start + g8 + 8 * hr;
                if (col >= 0 && col < wd) qcol |= 1u << (2 * p + hr);
            }
#pragma unroll
        for (int m = 0; m < 8; ++m) {
            const int col = x0 - rleft + br0 + m;
            if (col >= 0 && col < wd) rcol |= 1u << m;
        }

        // x row i into buffer i & 1, zero outside the image
        auto load_xrow = [&](int i) {
            if (tid < QW * 8) {
                const bool valid = xcol_ok && i >= 0 && i < h;
                cp_async16(xdst + (i & 1) * QW * DIM * 2,
                           valid ? xi + (size_t)i * row_elems + (size_t)xcol * DIM + 8 * xpiece : x, valid);
            }
        };
        // the value product's A fragments (16 pixels of output row y), as load_x32 reads them
        uint32_t xv[2][8];
        auto load_value = [&](int y) {
#pragma unroll
            for (int hr = 0; hr < 2; ++hr) {
                const int col = x0 + g8 + 8 * hr;
                const bool valid = y < yb && col < wd;
                load_x32(xi + (valid ? (size_t)y * row_elems + (size_t)col * DIM : 0) + 16 * t4, valid, xv[hr]);
            }
        };
        load_xrow(ya - 11);
        cp_async_commit();
        if (warp < 8) load_value(ya);

        for (int i = ya - 11; i <= yb + LAG_G - 1; ++i) {
            cp_async_wait<0>();
            __syncthreads();  // x row i is in; every stage of step i - 1 is done
            if (i + 1 <= yb + 10) load_xrow(i + 1);
            cp_async_commit();
            const int yo = i - LAG_O, yf = i - LAG_F, yg = i - LAG_G;
            const bool gate_row = yo >= ya && yo < yb;
            const bool out_row = yg >= ya && yg < yb;

            // -- gated row yo = silu(Wf f + bf) * (Wv x + bv), into slot yo & 1 --
            if (warp < 8 && gate_row) {
                const E* FB = FT + (yo & 1) * 2 * SW * LDB;
                const E* FL = FB + SW * LDB;
                const int n0 = 8 * warp;
                // independent accumulators (f hi, f lo, value), so that the
                // mma chains are 4 long
                E* GB = GT + (yo & 1) * 2 * SW * LDB;
                E* GL = GB + SW * LDB;
                float hacc[2][4] = {}, vacc[4] = {};
#pragma unroll
                for (int ks = 0; ks < 4; ks += 2) {
                    const int boff = w_frag(n0, ks, lane);
                    uint32_t bf[4], bv[4];
                    ldmatrix_x4(bf, W3 + DIM * DIM + boff);
                    ldmatrix_x4(bv, W3 + boff);
#pragma unroll
                    for (int kk = 0; kk < 2; ++kk) {
                        uint32_t ah[4], al[4];
                        const int aoff = (lane & 15) * LDB + (ks + kk) * 16 + (lane >> 4) * 8;
                        ldmatrix_x4(ah, FB + aoff);
                        ldmatrix_x4(al, FL + aoff);
                        const int kx = ks + kk;
                        const uint32_t ax[4] = {xv[0][2 * kx], xv[1][2 * kx], xv[0][2 * kx + 1], xv[1][2 * kx + 1]};
                        HT::mma(hacc[0], ah, bf[2 * kk], bf[2 * kk + 1]);
                        HT::mma(hacc[1], al, bf[2 * kk], bf[2 * kk + 1]);
                        HT::mma(vacc, ax, bv[2 * kk], bv[2 * kk + 1]);
                    }
                }
                const int c = n0 + 2 * t4;
#pragma unroll
                for (int hr = 0; hr < 2; ++hr) {
                    const float g0 =
                        silu_fast(hacc[0][2 * hr] + hacc[1][2 * hr] + BS[SB_F + c]) * (vacc[2 * hr] + BS[SB_V + c]);
                    const float g1 = silu_fast(hacc[0][2 * hr + 1] + hacc[1][2 * hr + 1] + BS[SB_F + c + 1]) *
                                     (vacc[2 * hr + 1] + BS[SB_V + c + 1]);
                    uint32_t hi, lo;
                    split_h16<E>(g0, g1, hi, lo);
                    *reinterpret_cast<uint32_t*>(GB + (g8 + 8 * hr) * LDB + c) = hi;
                    *reinterpret_cast<uint32_t*>(GL + (g8 + 8 * hr) * LDB + c) = lo;
                }
                load_value(yo + 1);
            }

            // -- q row i: gelu(Wq x + bq) on the tensor cores -----------------------
            if (i <= yb + 10) {
                const bool row_ok = i >= 0 && i < h;
                const E* X = XB + (i & 1) * QW * DIM;
                const int slot = ring(i, QS);
#pragma unroll
                for (int p = 0; p < 2; ++p) {
                    if (p >= nq) break;
                    const QTile qt = q_tile_of(warp, p);
                    float acc[4] = {};
                    if (row_ok) {
                        const int px = qt.start + (lane & 15);
#pragma unroll
                        for (int ks = 0; ks < 4; ++ks) {
                            uint32_t a[4];
                            ldmatrix_x4(a, X + px * DIM + 8 * ((2 * ks + (lane >> 4)) ^ (px & 7)));
                            HT::mma(acc, a, wq[p][ks][0], wq[p][ks][1]);
                        }
                    }
                    const int c = 8 * qt.nt + 2 * t4;
                    const bool k3 = qt.nt >= (C1 + C2) / 8, k2 = qt.nt < C1 / 8;
                    float* qrow = k3 ? Q3 + slot * QW * C3 + c - C1 - C2
                                : k2 ? Q2 + (slot * Q2W - Q2LO) * C1 + c
                                     : QP + (slot * QPW - QPLO) * C2 + c - C1;
                    const int cstride = k3 ? C3 : (k2 ? C1 : C2);
                    const float b0 = BS[SB_Q + c], b1 = BS[SB_Q + c + 1];
#pragma unroll
                    for (int hr = 0; hr < 2; ++hr) {
                        const unsigned bit = 1u << (2 * p + hr);
                        if (!(qlive & bit)) continue;
                        float2 q = make_float2(gelu(acc[2 * hr] + b0), gelu(acc[2 * hr + 1] + b1));
                        if (!row_ok || !(qcol & bit)) q = make_float2(0.f, 0.f);
                        if (qstore & bit)
                            *reinterpret_cast<float2*>(qrow + (qt.start + g8 + 8 * hr) * cstride) = q;
                    }
                }
            }

            auto put_f = [&](E* FB, int px, int ch, float v) {  // f as hi + lo into the f row
                const E hi = HT::from_float(v);
                FB[px * LDB + ch] = hi;
                FB[SW * LDB + px * LDB + ch] = HT::from_float(v - HT::to_float(hi));
            };
            if (warp < 8) {
                // -- r row j = dw5x5(q) + br, zero outside the image -------------------
                const int j = i - LAG_R;
                const int qs = ring(j - 2, QS);
                const unsigned vmask = j >= 0 && j < h ? rcol : 0u;
                if (warp < 5) {
                    if (j >= ya - 9 && j <= yb + 8)
                        r_run<3>(Q3 + bc - C1 - C2, R3 + bc - C1 - C2, tap, BS[SB_R + bc], br0, qs, ring(j, R3S),
                                 vmask);
                } else if (tid < 232) {
                    if (j >= ya - 4 && j <= yb + 3)
                        r_run<2>(Q2 + bc, R2 + bc, tap, BS[SB_R + bc], br0, qs, ring(j, R2S), vmask);
                } else if (tid < 248) {
                    if (j >= ya && j < yb)
                        r_run<0>(QP + bc - C1, RP + bc - C1, tap, BS[SB_R + bc], br0, qs, ring(j, RPS), vmask);
                }
            } else if (yf >= ya && yf < yb) {
                // -- f row yf into the f row slot yf & 1 ---------------------------
                E* FB = FT + (yf & 1) * 2 * SW * LDB;
                if (warp < 14) {
                    // dil-3 channel C1 + C2 + lane on the columns s0, s0 + 3(, s0 + 6):
                    // runs {0, 3, 6}, {9, 12, 15}, {1, 4, 7}, {10, 13}, {2, 5, 8}, {11, 14};
                    // the reads past the r row's 34 columns feed only the
                    // third column of the runs of two, which is not stored
                    const int run = warp - 8, s0 = (run >> 1) + 9 * (run & 1), cnt = s0 + 6 < SW ? 3 : 2;
                    const int s9 = ring(yf - 9, R3S);
                    float acc[3] = {0.f, 0.f, 0.f};
#pragma unroll
                    for (int dy = 0; dy < 7; ++dy) {
                        const int s = s9 + 3 * dy < R3S ? s9 + 3 * dy : s9 + 3 * dy - R3S;
                        const float* rr = R3 + (s * R3W + s0) * C3 + lane;
                        float rv[9];
#pragma unroll
                        for (int m = 0; m < 9; ++m) rv[m] = rr[3 * m * C3];
#pragma unroll
                        for (int dx = 0; dx < 7; ++dx)
#pragma unroll
                            for (int m = 0; m < 3; ++m) acc[m] = fmaf(rv[m + dx], tap[dy * 7 + dx], acc[m]);
                    }
                    const float bias = BS[SB_2 + lane];
#pragma unroll
                    for (int m = 0; m < 3; ++m)
                        if (m < cnt) put_f(FB, s0 + 3 * m, C1 + C2 + lane, acc[m] + bias);
                } else if (tid < 496) {
                    // dil-2 channel c on the columns of one parity
                    const int u = tid - 448, c = u % C1, s0 = u / C1;
                    const int s4 = ring(yf - 4, R2S);
                    float acc[8] = {};
#pragma unroll
                    for (int dy = 0; dy < 5; ++dy) {
                        const int s = s4 + 2 * dy < R2S ? s4 + 2 * dy : s4 + 2 * dy - R2S;
                        const float* rr = R2 + (s * R2W + s0) * C1 + c;
                        float rv[12];
#pragma unroll
                        for (int m = 0; m < 12; ++m) rv[m] = rr[2 * m * C1];
#pragma unroll
                        for (int dx = 0; dx < 5; ++dx)
#pragma unroll
                            for (int m = 0; m < 8; ++m) acc[m] = fmaf(rv[m + dx], tap[dy * 5 + dx], acc[m]);
                    }
                    const float bias = BS[SB_1 + c];
#pragma unroll
                    for (int m = 0; m < 8; ++m) put_f(FB, s0 + 2 * m, c, acc[m] + bias);
                } else {
                    // the pass-through channels of column tid - 496: r itself
                    const int col = tid - 496;
                    const float* rp = RP + (ring(yf, RPS) * SW + col) * C2;
#pragma unroll
                    for (int k = 0; k < C2; ++k) put_f(FB, col, C1 + k, rp[k]);
                }
            }
            // -- output row yg = Wo gated + bo, from slot yg & 1 -----------------
            if (warp >= 8 && out_row) {
                const E* GB = GT + (yg & 1) * 2 * SW * LDB;
                const E* GL = GB + SW * LDB;
                const int n0 = 8 * (warp - 8), c = n0 + 2 * t4;
                float oacc[2][4] = {};
#pragma unroll
                for (int ks = 0; ks < 4; ks += 2) {
                    uint32_t bo[4];
                    ldmatrix_x4(bo, W3 + 2 * DIM * DIM + w_frag(n0, ks, lane));
#pragma unroll
                    for (int kk = 0; kk < 2; ++kk) {
                        uint32_t ah[4], al[4];
                        const int aoff = (lane & 15) * LDB + (ks + kk) * 16 + (lane >> 4) * 8;
                        ldmatrix_x4(ah, GB + aoff);
                        ldmatrix_x4(al, GL + aoff);
                        HT::mma(oacc[0], ah, bo[2 * kk], bo[2 * kk + 1]);
                        HT::mma(oacc[1], al, bo[2 * kk], bo[2 * kk + 1]);
                    }
                }
#pragma unroll
                for (int hr = 0; hr < 2; ++hr) {
                    const int col = x0 + g8 + 8 * hr;
                    if (col < wd)
                        *reinterpret_cast<uint32_t*>(oi + (size_t)yg * row_elems + (size_t)col * DIM + c) =
                            HT::pack(oacc[0][2 * hr] + oacc[1][2 * hr] + BS[SB_O + c],
                                     oacc[0][2 * hr + 1] + oacc[1][2 * hr + 1] + BS[SB_O + c + 1]);
                }
            }
        }
    }
    cp_async_wait<0>();
}

// The grid: one block per 16 x 16 output tile of every image.
bool grid_of(int n, int h, int wd, int& tiles_w, int& tiles_per_image, unsigned& blocks) {
    if (n < 1 || h < 1 || wd < 1) return false;
    const long long tw = (wd + T - 1) / T, th = (h + T - 1) / T;
    const long long b = (long long)n * tw * th;
    if (b > 0x7fffffffLL) return false;
    tiles_w = (int)tw;
    tiles_per_image = (int)(tw * th);
    blocks = (unsigned)b;
    return true;
}

}  // namespace

// Plain C entry points (loaded with ctypes).  x and out are contiguous
// (n, h, w, 64) and 16-byte aligned; w holds the packed f32 weights
// (resselt_molrcm_weights() floats).  Each launches on `stream` and returns
// cudaGetLastError() right after the launch (0 = launched).
extern "C" int resselt_molrcm_weights() { return W_TOTAL; }

extern "C" int resselt_molrcm_f32(const void* x, const void* w, void* out, int n, int h, int wd, void* stream) {
    int tiles_w, tiles_per_image;
    unsigned blocks;
    if (x == nullptr || w == nullptr || out == nullptr || !grid_of(n, h, wd, tiles_w, tiles_per_image, blocks))
        return (int)cudaErrorInvalidValue;
    cudaError_t err = cudaFuncSetAttribute(molrcm_f32_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)F32_SMEM);
    if (err != cudaSuccess) return (int)err;
    molrcm_f32_kernel<<<blocks, THREADS, F32_SMEM, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(x), static_cast<const float*>(w), static_cast<float*>(out), h, wd, tiles_w,
        tiles_per_image);
    return (int)cudaGetLastError();
}

namespace {

int num_sms() {
    static int sms = 0;
    if (sms == 0) {
        int dev = 0;
        cudaGetDevice(&dev);
        cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    }
    return sms;
}

// Output rows of an item: the whole image height where its strips fill the
// card, else runs of at least 8 rows; of those, the height that makes the
// fewest steps per SM, (items / SMs rounded up) x (rows + ST_EXTRA).
int strip_rows(int n, int h, int wd) {
    const long long strips = (long long)n * ((wd + SW - 1) / SW), sms = num_sms();
    long long best_cost = -1;
    int best = h;
    for (int segs = 1; segs <= h; ++segs) {
        const int rows = (h + segs - 1) / segs;
        if (segs > 1 && rows < 8) break;
        const long long cost = (strips * ((h + rows - 1) / rows) + sms - 1) / sms * (rows + ST_EXTRA);
        if (best_cost < 0 || cost < best_cost) best_cost = cost, best = rows;
    }
    return best;
}

// One item per (image, 16-column strip, run of strip_rows output rows); one
// persistent block of 512 threads per SM walks the items.
template <typename E>
int launch_h16(const void* x, const void* w, void* out, int n, int h, int wd, void* stream) {
    if (x == nullptr || w == nullptr || out == nullptr || n < 1 || h < 1 || wd < 1) return (int)cudaErrorInvalidValue;
    const int seg_rows = strip_rows(n, h, wd);
    const long long strips = (wd + SW - 1) / SW, segs = (h + seg_rows - 1) / seg_rows;
    const long long items = (long long)n * strips * segs;
    if (items > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
    cudaError_t err = cudaFuncSetAttribute(molrcm_h16_kernel<E>, cudaFuncAttributeMaxDynamicSharedMemorySize, S_END);
    if (err != cudaSuccess) return (int)err;
    const int blocks = (int)(items < num_sms() ? items : num_sms());
    molrcm_h16_kernel<E><<<blocks, ST_THREADS, S_END, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const E*>(x), static_cast<const float*>(w), static_cast<E*>(out), h, wd, (int)strips, seg_rows,
        (int)segs, (int)items);
    return (int)cudaGetLastError();
}

}  // namespace

extern "C" int resselt_molrcm_bf16(const void* x, const void* w, void* out, int n, int h, int wd, void* stream) {
    return launch_h16<__nv_bfloat16>(x, w, out, n, h, wd, stream);
}

extern "C" int resselt_molrcm_f16(const void* x, const void* w, void* out, int n, int h, int wd, void* stream) {
    return launch_h16<__half>(x, w, out, n, h, wd, stream);
}
