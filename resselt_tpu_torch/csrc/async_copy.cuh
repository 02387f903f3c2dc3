// Asynchronous copies into shared memory, shared by the kernels that ring
// their inputs through it: cp.async (16-byte global -> shared copies,
// zero-filled where the source is not valid), and Hopper's tensor copies
// (TMA: one thread asks for a whole box of a tensor, the hardware fills
// what lies outside the tensor with zeros) with the mbarriers that count
// their bytes and the named barriers that order warpgroups.

#pragma once

#include <stdint.h>

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, bool valid) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src), "r"(valid ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }
template <int PENDING>
__device__ __forceinline__ void cp_async_wait() {
    asm volatile("cp.async.wait_group %0;\n" ::"n"(PENDING) : "memory");
}

// An mbarrier (8 bytes of shared memory at `bar`) that completes a phase
// when `count` threads have arrived and the bytes announced with
// mbar_expect_tx have landed.  Phases alternate in parity from 0.
__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}
// after the inits, before any other thread or a tensor copy uses them
__device__ __forceinline__ void mbar_fence_init() { asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory"); }
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
    asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}
// one arrival that also announces `bytes` of tensor copies to come
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes) : "memory");
}
// until the phase of this parity has completed
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
    asm volatile(
        "{\n.reg .pred p;\nWAIT:\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
        "@!p bra WAIT;\n}\n" ::"r"(bar),
        "r"(parity)
        : "memory");
}

// A 4-d box of the tensor that `map` describes (a CUtensorMap in the
// kernel's parameters), at coordinates c0 (innermost) .. c3, into shared
// memory at `dst` (128-byte aligned); its bytes count on `bar`.
__device__ __forceinline__ void tma_load_4d(uint32_t dst, const void* map, uint32_t bar, int c0, int c1, int c2,
                                            int c3) {
    asm volatile(
        "cp.async.bulk.tensor.4d.shared::cluster.global.tile.mbarrier::complete_tx::bytes"
        " [%0], [%1, {%2, %3, %4, %5}], [%6];\n" ::"r"(dst),
        "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2), "r"(c3), "r"(bar)
        : "memory");
}

// Named barrier `id` (not 0, __syncthreads' own) of `threads` threads:
// wait there, or arrive without waiting.
__device__ __forceinline__ void named_sync(int id, int threads) {
    asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}
__device__ __forceinline__ void named_arrive(int id, int threads) {
    asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}
