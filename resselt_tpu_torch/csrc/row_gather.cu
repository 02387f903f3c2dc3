// Indexed row gather on Hopper: out[j, :] = src[idx[j], :], bit-exact.
//
// Replaces tools/probe_acmsa_gather.py::_gather_kernel, which the JAX
// package reaches through tile_gather: the row shuffle of ATD's AC_MSA (the
// qkv rows into category-sorted order, and the attention output back
// through the inverted permutation).  It computes what that kernel
// computes.  The TPU kernel moves one aligned (8, 128) f32 tile per row,
// its least DMA, `blk` rows per sequential grid step, with the indices
// prefetched as scalars; none of that carries over.  Here a row is any
// number of bytes: src holds rows_src rows of row_bytes bytes, pitch_bytes
// apart (so a row slice of a wider matrix is read in place), idx holds
// rows_out int32 or int64 values in [0, rows_src), and out is contiguous.
//
// What bounds it on an H100: bytes.  The gather does no arithmetic; the
// least time is (rows read + rows written + indices) over the memory rate.
// Writes are contiguous.  Reads are whole rows at random offsets, so a row
// of 96-420 bytes (ATD: C = 48 or 210 in bf16, and three times that for the
// qkv rows) touches its 32-byte sectors once, up to a ragged first and
// last one.  Design: the output is cut into vectors of V bytes, V the
// largest of 16, 8, 4, 2 that divides the row, the pitch and both base
// addresses; consecutive threads own consecutive output vectors, so every
// lane works whatever the row width, stores coalesce, and the lanes of a
// row read its index from one cached word.  A thread moves four vectors,
// all four loads in flight before the first store.  Addresses are 64-bit:
// a batch of qkv rows passes 2^31 bytes.  An index outside [0, rows_src)
// stops the kernel with a trap, which the next synchronisation reports,
// instead of reading memory that is not src's.  What this simple design
// leaves on the table: no shared-memory staging, no TMA gather, and a
// 64-bit division per thread to find its first row.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int PER_THREAD = 4;
constexpr int PER_BLOCK = THREADS * PER_THREAD;

template <typename Vec, typename Index>
__global__ void __launch_bounds__(THREADS)
row_gather_kernel(const Vec* __restrict__ src, const Index* __restrict__ idx, Vec* __restrict__ out,
                  long long total, unsigned vpr, long long pitch, long long rows_src) {
    // the block's first output vector, as (row, column); the thread's own
    // vectors lie less than PER_BLOCK further on, so 32 bits do from here
    const long long g0 = (long long)blockIdx.x * PER_BLOCK;
    const long long row0 = g0 / vpr;
    const unsigned col0 = (unsigned)(g0 - row0 * vpr);

    Vec v[PER_THREAD];
    bool live[PER_THREAD];
#pragma unroll
    for (int k = 0; k < PER_THREAD; ++k) {
        const unsigned t = threadIdx.x + k * THREADS;
        live[k] = g0 + t < total;
        if (live[k]) {
            const unsigned c = col0 + t;
            const unsigned dr = c / vpr;
            const long long r = (long long)__ldg(idx + row0 + dr);
            if (r < 0 || r >= rows_src) __trap();
            v[k] = __ldg(src + r * pitch + (c - dr * vpr));
        }
    }
#pragma unroll
    for (int k = 0; k < PER_THREAD; ++k) {
        if (live[k]) out[g0 + threadIdx.x + k * THREADS] = v[k];
    }
}

template <typename Vec>
cudaError_t launch(const void* src, const void* idx, void* out, long long rows_out, long long rows_src,
                   long long row_bytes, long long pitch_bytes, int idx64, cudaStream_t stream) {
    const long long vpr = row_bytes / (long long)sizeof(Vec);
    const long long total = rows_out * vpr;
    const long long blocks = (total + PER_BLOCK - 1) / PER_BLOCK;
    if (vpr > 0x7fffffffLL - PER_BLOCK || blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
    const long long pitch = pitch_bytes / (long long)sizeof(Vec);
    if (idx64) {
        row_gather_kernel<Vec, long long><<<(unsigned)blocks, THREADS, 0, stream>>>(
            static_cast<const Vec*>(src), static_cast<const long long*>(idx), static_cast<Vec*>(out),
            total, (unsigned)vpr, pitch, rows_src);
    } else {
        row_gather_kernel<Vec, int><<<(unsigned)blocks, THREADS, 0, stream>>>(
            static_cast<const Vec*>(src), static_cast<const int*>(idx), static_cast<Vec*>(out),
            total, (unsigned)vpr, pitch, rows_src);
    }
    return cudaGetLastError();
}

bool aligned(const void* src, const void* out, long long row_bytes, long long pitch_bytes, long long v) {
    return row_bytes % v == 0 && pitch_bytes % v == 0 && reinterpret_cast<uintptr_t>(src) % v == 0 &&
           reinterpret_cast<uintptr_t>(out) % v == 0;
}

}  // namespace

// Gathers rows_out rows of row_bytes bytes.  Returns the CUDA error of the
// launch (0: launched); the caller checks the operands' shapes and devices.
extern "C" int resselt_row_gather(const void* src, const void* idx, void* out, long long rows_out,
                                  long long rows_src, long long row_bytes, long long pitch_bytes, int idx64,
                                  void* stream) {
    if (rows_out <= 0 || rows_src <= 0 || row_bytes <= 0 || pitch_bytes < row_bytes) return (int)cudaErrorInvalidValue;
    const cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (aligned(src, out, row_bytes, pitch_bytes, 16))
        return (int)launch<uint4>(src, idx, out, rows_out, rows_src, row_bytes, pitch_bytes, idx64, s);
    if (aligned(src, out, row_bytes, pitch_bytes, 8))
        return (int)launch<uint2>(src, idx, out, rows_out, rows_src, row_bytes, pitch_bytes, idx64, s);
    if (aligned(src, out, row_bytes, pitch_bytes, 4))
        return (int)launch<uint32_t>(src, idx, out, rows_out, rows_src, row_bytes, pitch_bytes, idx64, s);
    if (aligned(src, out, row_bytes, pitch_bytes, 2))
        return (int)launch<uint16_t>(src, idx, out, rows_out, rows_src, row_bytes, pitch_bytes, idx64, s);
    return (int)cudaErrorInvalidValue;
}
