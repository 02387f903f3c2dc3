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
// 0.043 ms at 989 TFLOP/s and 0.080 ms at 3.35 TB/s.  The TPU kernel's
// layout (W on 128 lanes, host-assembled overlapping W-tiles, lane rolls)
// does not carry over.  Here a block of 512 threads owns a 16 x 16-pixel
// output tile and works through the channels in groups of 8: q on the
// group's own halo (38 x 38 pixels for the dil-3 channels, 28 x 28 for the
// dil-2 ones, 20 x 20 for the pass-through ones), r on that halo less 2,
// then the group's 8 channels of f on the tile.  q and r live in shared
// memory for a group or two at a time (46 KB + 37 KB a group in f32); 64
// channels of q on a 38 x 38 halo (370 KB in f32) would not fit.  So the
// halo's x is read from L2 once per pass, and the q product costs (halo
// area / 256) times its useful work: about 4.2x.  The depthwise convs run
// in f32 on the CUDA cores from shared memory, one channel per thread with
// its taps in registers, over runs of output rows that share input rows.
//  * f32: one group at a time; every product in exact f32 FMA (no TF32).
//    Wf f is accumulated group by group in registers (each thread owns 4
//    pixels x 8 output channels); the tile's x is staged once, transposed,
//    for the value product.
//  * bf16 / fp16 (one template over the 16-bit type E): the four products
//    on the tensor cores, mma.sync m16n8k16 with f32 accumulation.  q is computed for two groups per pass (two n8
//    tiles per A fragment, on the larger of their halos), so the halo's x
//    is read four times, not eight.  The q and value products take their A
//    fragments straight from global memory, in a channel order permuted
//    within each k16 step (qperm), so that a lane reads 32 contiguous bytes
//    a pixel.  f is staged as a [pixel][channel] tile; each warp owns one
//    16-pixel tile row and computes Wf f and Wv x, the gated product and Wo
//    of it, and writes its row back through shared memory in 16-byte
//    stores.  f and the gated product are f32 values: each is split into
//    two 16-bit parts (hi + lo) multiplied in turn, so those products lose
//    nothing beyond f32 rounding in bf16 and keep 22 bits in fp16 (x and
//    the weights are 16-bit already).
// What this design leaves on the table: wgmma instead of mma.sync; a larger
// tile (32 x 32 halves the halo recompute) needs q and r in less shared
// memory; gelu (erff) runs on every halo pixel; every stage ends in a
// block-wide barrier, and with one 512-thread block per SM nothing fills
// the SM while the slowest warp of a stage finishes.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "half16.cuh"

namespace {

constexpr int DIM = 64;
constexpr int C1 = 24;   // dw5x5 dilation 2
constexpr int C2 = 8;    // passed through
constexpr int C3 = 32;   // dw7x7 dilation 3
constexpr int T = 16;    // output tile side
constexpr int TP = T * T;
constexpr int THREADS = 512;
constexpr int WARPS = THREADS / 32;
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
// bf16 / fp16 (template parameter E): the four products on the tensor cores
// (mma.sync m16n8k16, f32 accumulation); the depthwise convs as in the f32
// kernel.
// ---------------------------------------------------------------------------

// The q and value products take their A fragments straight from global x.
// Within each k16 step ks, lane t4 holds logical channels (2 t4, 2 t4 + 1)
// and (2 t4 + 8, 2 t4 + 9); they are taken from physical channels
// 16 t4 + 4 ks + (0, 1) and + (2, 3), so a lane reads one 32-byte run of a
// pixel.  The weights' B fragments follow the same order (qperm below).

// Shared memory (bytes).  FB and FL hold the hi and lo 16-bit parts of the
// tile's f, then of the gated product; FB then the output, row by row;
// both are [pixel][LDB] 16-bit.  The work area holds one pair of groups' q
// (two planes of [QMAX * QMAX][8] f32), one group's r and both groups' taps
// during the loop, then Wf, Wv (in the permuted channel order), Wo as
// [n][LDB] 16-bit and their biases.
constexpr int B_FB = 0;
constexpr int B_FL = B_FB + TP * LDB * 2;
constexpr int B_WORK = B_FL + TP * LDB * 2;
constexpr int B_QG = B_WORK;
constexpr int B_RG = B_QG + 2 * QMAX * QMAX * G * 4;
constexpr int B_DW = B_RG + RMAX * RMAX * G * 4;
constexpr int B_END = B_DW + 2 * DW_FLOATS * 4;
constexpr int B_W3 = B_WORK;
constexpr int B_BIAS = B_W3 + 3 * DIM * LDB * 2;  // f32 bf, bv, bo
static_assert(B_BIAS + 3 * DIM * 4 <= B_END, "phase-2 weights must fit the work area");
constexpr size_t BF16_SMEM = (size_t)B_END;
static_assert(BF16_SMEM <= 232448, "a block has at most 227 KB of shared memory");

// (a, b) as hi + lo pairs of the 16-bit type: hi = E(v), lo = E(v - hi).
template <typename E>
__device__ __forceinline__ void split_h16(float a, float b, uint32_t& hi, uint32_t& lo) {
    hi = Half16<E>::pack(a, b);
    const float2 back = Half16<E>::unpack(hi);
    lo = Half16<E>::pack(a - back.x, b - back.y);
}

// The column of a permuted [n][LDB] weight row that holds physical input
// channel k: the B fragment of step ks reads columns ks * 16 + 2 t4 (+1)
// and ks * 16 + 8 + 2 t4 (+1).
__device__ __forceinline__ int qperm(int k) {
    const int t = k / 16, ks = (k % 16) / 4, hi = (k % 4) / 2, e = k % 2;
    return ks * 16 + hi * 8 + 2 * t + e;
}

// acc (16 pixels x 64 channels, as 8 n8 tiles) += A B^T for the k16 step
// ks, B a [n][LDB] 16-bit weight in shared memory.
template <typename E>
__device__ __forceinline__ void step_product(float (&acc)[8][4], const uint32_t (&a)[4], const E* B,
                                             int ks, int lane) {
#pragma unroll
    for (int np = 0; np < DIM / 16; ++np) {
        uint32_t b[4];
        ldmatrix_x4(b, B + (np * 16 + (lane & 7) + ((lane >> 4) << 3)) * LDB + ks * 16 + ((lane >> 3) & 1) * 8);
        Half16<E>::mma(acc[2 * np], a, b[0], b[1]);
        Half16<E>::mma(acc[2 * np + 1], a, b[2], b[3]);
    }
}

// acc += A B^T, A the rows m0 .. m0 + 15 of a [pixel][LDB] tile.
template <typename E>
__device__ __forceinline__ void row_product(float (&acc)[8][4], const E* A, const E* B,
                                            int m0, int lane) {
#pragma unroll
    for (int ks = 0; ks < DIM / 16; ++ks) {
        uint32_t a[4];
        ldmatrix_x4(a, A + (m0 + (lane & 15)) * LDB + ks * 16 + (lane >> 4) * 8);
        step_product(acc, a, B, ks, lane);
    }
}

// acc += X B^T, X the A fragments of 16 pixels' x as load_x32 reads them
// (rows g8 and g8 + 8), B permuted by qperm.
template <typename E>
__device__ __forceinline__ void x_product(float (&acc)[8][4], const uint32_t (&xv)[2][8], const E* B,
                                          int lane) {
#pragma unroll
    for (int ks = 0; ks < DIM / 16; ++ks) {
        const uint32_t a[4] = {xv[0][2 * ks], xv[1][2 * ks], xv[0][2 * ks + 1], xv[1][2 * ks + 1]};
        step_product(acc, a, B, ks, lane);
    }
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

template <typename E>
__global__ void __launch_bounds__(THREADS, 1)
molrcm_h16_kernel(const E* __restrict__ x, const float* __restrict__ w, E* __restrict__ out, int h, int wd,
                  int tiles_w, int tiles_per_image) {
    using HT = Half16<E>;
    extern __shared__ __align__(16) unsigned char smem8[];
    const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
    const int g8 = lane >> 2, t4 = lane & 3;
    const int img = blockIdx.x / tiles_per_image;
    const int tile = blockIdx.x % tiles_per_image;
    const int oy = (tile / tiles_w) * T, ox = (tile % tiles_w) * T;
    const E* xi = x + (size_t)img * h * wd * DIM;
    E* FB = reinterpret_cast<E*>(smem8 + B_FB);
    E* FL = reinterpret_cast<E*>(smem8 + B_FL);
    float* QG = reinterpret_cast<float*>(smem8 + B_QG);
    float* RG = reinterpret_cast<float*>(smem8 + B_RG);
    const DwSmem dws[2] = {dw_smem(reinterpret_cast<float*>(smem8 + B_DW)),
                           dw_smem(reinterpret_cast<float*>(smem8 + B_DW) + DW_FLOATS)};

    // The groups go in pairs (channels 16 p .. 16 p + 15): q is computed for
    // both on the larger halo, so each pass over the halo's x feeds two n8
    // tiles; r and f follow group by group.
    for (int pr = 0; pr < DIM / (2 * G); ++pr) {
        const Group sg[2] = {group(2 * pr), group(2 * pr + 1)};
        const int rq = max(sg[0].rq, sg[1].rq), eq = T + 2 * rq, np = eq * eq;
        __syncthreads();  // the previous pair's readers are done
        load_dw(w, sg[0], dws[0]);
        load_dw(w, sg[1], dws[1]);
        // Wq's B fragments: output channel 16 pr + 8 nt + g8, the lane's
        // input channels 16 t4 .. 16 t4 + 15 in k order
        uint32_t wq[2][8];
        float bq[2][2];
#pragma unroll
        for (int nt = 0; nt < 2; ++nt) {
            const int c = 16 * pr + 8 * nt;
#pragma unroll
            for (int j = 0; j < 8; ++j) {
                const float2 v = *reinterpret_cast<const float2*>(w + W_Q + (c + g8) * DIM + 16 * t4 + 2 * j);
                wq[nt][j] = HT::pack(v.x, v.y);
            }
            bq[nt][0] = w[B_Q + c + 2 * t4];
            bq[nt][1] = w[B_Q + c + 2 * t4 + 1];
        }

        // q = gelu(Wq x + bq) on the eq x eq halo, 16 halo pixels per row
        // tile, into plane nt of QG
        for (int mt = warp; mt * 16 < np; mt += WARPS) {
            uint32_t xv[2][8];
            bool valid[2];
#pragma unroll
            for (int hr = 0; hr < 2; ++hr) {
                const int r = mt * 16 + g8 + 8 * hr;
                const int y = oy - rq + r / eq, xx = ox - rq + r % eq;
                valid[hr] = r < np && y >= 0 && y < h && xx >= 0 && xx < wd;
                load_x32(xi + ((size_t)(valid[hr] ? y : 0) * wd + (valid[hr] ? xx : 0)) * DIM + 16 * t4, valid[hr],
                         xv[hr]);
            }
#pragma unroll
            for (int nt = 0; nt < 2; ++nt) {
                float d[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
                for (int ks = 0; ks < 4; ++ks) {
                    const uint32_t a[4] = {xv[0][2 * ks], xv[1][2 * ks], xv[0][2 * ks + 1], xv[1][2 * ks + 1]};
                    HT::mma(d, a, wq[nt][2 * ks], wq[nt][2 * ks + 1]);
                }
#pragma unroll
                for (int hr = 0; hr < 2; ++hr) {
                    const int r = mt * 16 + g8 + 8 * hr;
                    if (r >= np) continue;
                    float2 q = make_float2(0.f, 0.f);
                    if (valid[hr]) q = make_float2(gelu(d[2 * hr] + bq[nt][0]), gelu(d[2 * hr + 1] + bq[nt][1]));
                    *reinterpret_cast<float2*>(QG + (nt * np + r) * G + 2 * t4) = q;
                }
            }
        }
#pragma unroll
        for (int half = 0; half < 2; ++half) {
            const Group& s = sg[half];
            __syncthreads();  // q (and, for the second group, the first's f) is done
            region_conv(QG + half * np * G, eq, rq - s.rq, RG, dws[half], s, oy, ox, h, wd);
            __syncthreads();
            group_f(RG, dws[half], s, [&](int px, int c, float v) {
                const E hi = HT::from_float(v);
                FB[px * LDB + s.c0 + c] = hi;
                FL[px * LDB + s.c0 + c] = HT::from_float(v - HT::to_float(hi));
            });
        }
    }

    __syncthreads();  // the last group's readers are done with the work area
    E* W3 = reinterpret_cast<E*>(smem8 + B_W3);
    float* bias = reinterpret_cast<float*>(smem8 + B_BIAS);
    for (int i = tid; i < 3 * DIM * DIM / 2; i += THREADS) {
        const int m = i / (DIM * DIM / 2), e = 2 * (i % (DIM * DIM / 2)), n = e / DIM, k = e % DIM;
        const float2 v = *reinterpret_cast<const float2*>(w + (m == 0 ? W_F : (m == 1 ? W_V : W_O)) + e);
        *reinterpret_cast<uint32_t*>(W3 + (m * DIM + n) * LDB + (m == 1 ? qperm(k) : k)) = HT::pack(v.x, v.y);
    }
    if (tid < 3 * DIM) {
        const int m = tid / DIM, n = tid % DIM;
        bias[tid] = w[(m == 0 ? B_F : (m == 1 ? B_V : B_O)) + n];
    }
    // this warp's tile row (16 pixels) of x, as A fragments
    const int y = oy + warp;
    uint32_t xa[2][8];
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
        const int xx = ox + g8 + 8 * hr;
        const bool valid = y < h && xx < wd;
        load_x32(xi + ((size_t)(valid ? y : 0) * wd + (valid ? xx : 0)) * DIM + 16 * t4, valid, xa[hr]);
    }
    __syncthreads();

    // each warp owns tile row `warp` (16 pixels) from here on
    const int m0 = warp * 16;
    float hacc[8][4], vacc[8][4];
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e) hacc[i][e] = vacc[i][e] = 0.f;
    row_product(hacc, FB, W3, m0, lane);
    row_product(hacc, FL, W3, m0, lane);
    x_product(vacc, xa, W3 + DIM * LDB, lane);
    __syncwarp();  // the warp's ldmatrix reads of its FB and FL rows are done
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
        const int n = nt * 8 + 2 * t4;
#pragma unroll
        for (int hr = 0; hr < 2; ++hr) {
            const float g0 = silu(hacc[nt][2 * hr] + bias[n]) * (vacc[nt][2 * hr] + bias[DIM + n]);
            const float g1 = silu(hacc[nt][2 * hr + 1] + bias[n + 1]) * (vacc[nt][2 * hr + 1] + bias[DIM + n + 1]);
            uint32_t hi, lo;
            split_h16<E>(g0, g1, hi, lo);
            *reinterpret_cast<uint32_t*>(FB + (m0 + g8 + 8 * hr) * LDB + n) = hi;
            *reinterpret_cast<uint32_t*>(FL + (m0 + g8 + 8 * hr) * LDB + n) = lo;
        }
    }
    __syncwarp();
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e) hacc[i][e] = 0.f;
    row_product(hacc, FB, W3 + 2 * DIM * LDB, m0, lane);
    row_product(hacc, FL, W3 + 2 * DIM * LDB, m0, lane);
    __syncwarp();
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
        const int n = nt * 8 + 2 * t4;
#pragma unroll
        for (int hr = 0; hr < 2; ++hr)
            *reinterpret_cast<uint32_t*>(FB + (m0 + g8 + 8 * hr) * LDB + n) =
                HT::pack(hacc[nt][2 * hr] + bias[2 * DIM + n], hacc[nt][2 * hr + 1] + bias[2 * DIM + n + 1]);
    }
    __syncwarp();
    E* oi = out + (size_t)img * h * wd * DIM;
    for (int i = lane; i < 16 * (DIM / 8); i += 32) {
        const int px = i / (DIM / 8), j = i % (DIM / 8);
        const int xx = ox + px;
        if (y < h && xx < wd)
            *reinterpret_cast<uint4*>(oi + ((size_t)y * wd + xx) * DIM + j * 8) =
                *reinterpret_cast<const uint4*>(FB + (m0 + px) * LDB + j * 8);
    }
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

template <typename E>
int launch_h16(const void* x, const void* w, void* out, int n, int h, int wd, void* stream) {
    int tiles_w, tiles_per_image;
    unsigned blocks;
    if (x == nullptr || w == nullptr || out == nullptr || !grid_of(n, h, wd, tiles_w, tiles_per_image, blocks))
        return (int)cudaErrorInvalidValue;
    cudaError_t err =
        cudaFuncSetAttribute(molrcm_h16_kernel<E>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)BF16_SMEM);
    if (err != cudaSuccess) return (int)err;
    molrcm_h16_kernel<E><<<blocks, THREADS, BF16_SMEM, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const E*>(x), static_cast<const float*>(w), static_cast<E*>(out), h, wd, tiles_w,
        tiles_per_image);
    return (int)cudaGetLastError();
}

}  // namespace

extern "C" int resselt_molrcm_bf16(const void* x, const void* w, void* out, int n, int h, int wd, void* stream) {
    return launch_h16<__nv_bfloat16>(x, w, out, n, h, wd, stream);
}

extern "C" int resselt_molrcm_f16(const void* x, const void* w, void* out, int n, int h, int wd, void* stream) {
    return launch_h16<__half>(x, w, out, n, h, wd, stream);
}
