// wgmma.mma_async for Hopper (sm_90a): D (m64 x N, f32, in registers) += A B
// with A (m64 x k16) and B (k16 x N) of one 16-bit type, both read from
// shared memory through matrix descriptors, both K-major (no transpose).
// Wgmma<N>::ss<T>(d, desc_a, desc_b, scale_d): one wgmma; with
// scale_d == 0 it overwrites d instead of adding to it.  N is one of 8, 16,
// 32, 48, 64, 80, 96, 128, 256.  Wgmma<N>::rs<T>(d, a, desc_b, scale_d)
// (N 16, 32, 48, 64) takes A from registers instead, four 32-bit registers
// a thread holding the m16n8k16 A fragment of its warp's 16 rows (the
// accumulator layout of two neighbouring n8 column groups, rounded to T and
// packed in pairs), and B MN-major: the N elements of one K row are
// contiguous (core matrices of 8 K rows x 8 N elements; `lbo` between
// neighbouring groups of 8 K rows, `sbo` between groups of 8 N columns).
// A thread holds N / 2 accumulators: thread t of
// warp w (of the warpgroup's four) holds rows 16 w + t / 4 and + 8, and of
// every 8 columns j the two columns 8 j + 2 (t % 4) and + 1:
//   d[4 j + 0], d[4 j + 1]: row 16 w + t / 4,     columns 8 j + 2 (t % 4), + 1
//   d[4 j + 2], d[4 j + 3]: row 16 w + t / 4 + 8, the same columns
// The operand lists below are mechanical: N / 2 registers each.

#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <stdint.h>

#include <type_traits>

// A shared-memory matrix descriptor without swizzle: core matrices are 8
// rows of 16 bytes stored as 128 contiguous bytes; `lbo` is the byte
// distance between the two core matrices of a k16 step (along K), `sbo`
// between neighbouring groups of 8 rows (along M or N).
__device__ __forceinline__ uint64_t wgmma_desc(uint32_t smem_addr, uint32_t lbo, uint32_t sbo) {
    return (uint64_t)((smem_addr & 0x3FFFFu) >> 4) | ((uint64_t)(lbo >> 4) << 16) | ((uint64_t)(sbo >> 4) << 32);
}

__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_commit() { asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory"); }
template <int PENDING>
__device__ __forceinline__ void wgmma_wait() {
    asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(PENDING) : "memory");
}
// Shared-memory writes made by ordinary stores or cp.async become visible
// to wgmma's (asynchronous-proxy) reads.
__device__ __forceinline__ void fence_async_shared() { asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory"); }
// Keeps the compiler from moving reads or writes of accumulators across
// the point where it stands (before wgmma_fence, after wgmma_wait).
template <int NR>
__device__ __forceinline__ void fence_registers(float (&d)[NR]) {
#pragma unroll
    for (int i = 0; i < NR; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

template <int N>
struct Wgmma;

template <>
struct Wgmma<8> {
    template <typename T>
    static __device__ __forceinline__ void ss(float (&d)[4], uint64_t desc_a, uint64_t desc_b, int scale_d) {
#define RESSELT_WGMMA_8(TYPES) \
        asm volatile( \
            "{\n.reg .pred p;\nsetp.ne.b32 p, %6, 0;\n" \
            "wgmma.mma_async.sync.aligned.m64n8k16.f32." TYPES " " \
            "{%0, %1, %2, %3}, " \
            "%4, %5, p, 1, 1, 0, 0;\n}\n" \
            : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]) \
            : "l"(desc_a), "l"(desc_b), "r"(scale_d))
        if constexpr (std::is_same<T, __half>::value) {
            RESSELT_WGMMA_8("f16.f16");
        } else {
            RESSELT_WGMMA_8("bf16.bf16");
        }
#undef RESSELT_WGMMA_8
    }
};

template <>
struct Wgmma<16> {
    template <typename T>
    static __device__ __forceinline__ void ss(float (&d)[8], uint64_t desc_a, uint64_t desc_b, int scale_d) {
#define RESSELT_WGMMA_16(TYPES) \
        asm volatile( \
            "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n" \
            "wgmma.mma_async.sync.aligned.m64n16k16.f32." TYPES " " \
            "{%0, %1, %2, %3, %4, %5, %6, %7}, " \
            "%8, %9, p, 1, 1, 0, 0;\n}\n" \
            : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), \
            "+f"(d[6]), "+f"(d[7]) \
            : "l"(desc_a), "l"(desc_b), "r"(scale_d))
        if constexpr (std::is_same<T, __half>::value) {
            RESSELT_WGMMA_16("f16.f16");
        } else {
            RESSELT_WGMMA_16("bf16.bf16");
        }
#undef RESSELT_WGMMA_16
    }
    template <typename T>
    static __device__ __forceinline__ void rs(float (&d)[8], const uint32_t (&a)[4], uint64_t desc_b, int scale_d) {
#define RESSELT_WGMMA_RS_16(TYPES) \
        asm volatile( \
            "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n" \
            "wgmma.mma_async.sync.aligned.m64n16k16.f32." TYPES " " \
            "{%0, %1, %2, %3, %4, %5, %6, %7}, " \
            "{%8, %9, %10, %11}, %12, p, 1, 1, 1;\n}\n" \
            : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]) \
            : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(scale_d))
        if constexpr (std::is_same<T, __half>::value) {
            RESSELT_WGMMA_RS_16("f16.f16");
        } else {
            RESSELT_WGMMA_RS_16("bf16.bf16");
        }
#undef RESSELT_WGMMA_RS_16
    }
};

template <>
struct Wgmma<32> {
    template <typename T>
    static __device__ __forceinline__ void ss(float (&d)[16], uint64_t desc_a, uint64_t desc_b, int scale_d) {
#define RESSELT_WGMMA_32(TYPES) \
        asm volatile( \
            "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n" \
            "wgmma.mma_async.sync.aligned.m64n32k16.f32." TYPES " " \
            "{%0, %1, %2, %3, %4, %5, %6, %7, " \
            "%8, %9, %10, %11, %12, %13, %14, %15}, " \
            "%16, %17, p, 1, 1, 0, 0;\n}\n" \
            : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), \
            "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), \
            "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]) \
            : "l"(desc_a), "l"(desc_b), "r"(scale_d))
        if constexpr (std::is_same<T, __half>::value) {
            RESSELT_WGMMA_32("f16.f16");
        } else {
            RESSELT_WGMMA_32("bf16.bf16");
        }
#undef RESSELT_WGMMA_32
    }
    template <typename T>
    static __device__ __forceinline__ void rs(float (&d)[16], const uint32_t (&a)[4], uint64_t desc_b, int scale_d) {
#define RESSELT_WGMMA_RS_32(TYPES) \
        asm volatile( \
            "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n" \
            "wgmma.mma_async.sync.aligned.m64n32k16.f32." TYPES " " \
            "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, " \
            "{%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n" \
            : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]) \
            : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(scale_d))
        if constexpr (std::is_same<T, __half>::value) {
            RESSELT_WGMMA_RS_32("f16.f16");
        } else {
            RESSELT_WGMMA_RS_32("bf16.bf16");
        }
#undef RESSELT_WGMMA_RS_32
    }
};

template <>
struct Wgmma<48> {
    template <typename T>
    static __device__ __forceinline__ void ss(float (&d)[24], uint64_t desc_a, uint64_t desc_b, int scale_d) {
#define RESSELT_WGMMA_48(TYPES) \
        asm volatile( \
            "{\n.reg .pred p;\nsetp.ne.b32 p, %26, 0;\n" \
            "wgmma.mma_async.sync.aligned.m64n48k16.f32." TYPES " " \
            "{%0, %1, %2, %3, %4, %5, %6, %7, " \
            "%8, %9, %10, %11, %12, %13, %14, %15, " \
            "%16, %17, %18, %19, %20, %21, %22, %23}, " \
            "%24, %25, p, 1, 1, 0, 0;\n}\n" \
            : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), \
            "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), \
            "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), \
            "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]) \
            : "l"(desc_a), "l"(desc_b), "r"(scale_d))
        if constexpr (std::is_same<T, __half>::value) {
            RESSELT_WGMMA_48("f16.f16");
        } else {
            RESSELT_WGMMA_48("bf16.bf16");
        }
#undef RESSELT_WGMMA_48
    }
    template <typename T>
    static __device__ __forceinline__ void rs(float (&d)[24], const uint32_t (&a)[4], uint64_t desc_b, int scale_d) {
#define RESSELT_WGMMA_RS_48(TYPES) \
        asm volatile( \
            "{\n.reg .pred p;\nsetp.ne.b32 p, %29, 0;\n" \
            "wgmma.mma_async.sync.aligned.m64n48k16.f32." TYPES " " \
            "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23}, " \
            "{%24, %25, %26, %27}, %28, p, 1, 1, 1;\n}\n" \
            : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]) \
            : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(scale_d))
        if constexpr (std::is_same<T, __half>::value) {
            RESSELT_WGMMA_RS_48("f16.f16");
        } else {
            RESSELT_WGMMA_RS_48("bf16.bf16");
        }
#undef RESSELT_WGMMA_RS_48
    }
};

template <>
struct Wgmma<64> {
    template <typename T>
    static __device__ __forceinline__ void ss(float (&d)[32], uint64_t desc_a, uint64_t desc_b, int scale_d) {
#define RESSELT_WGMMA_64(TYPES) \
        asm volatile( \
            "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n" \
            "wgmma.mma_async.sync.aligned.m64n64k16.f32." TYPES " " \
            "{%0, %1, %2, %3, %4, %5, %6, %7, " \
            "%8, %9, %10, %11, %12, %13, %14, %15, " \
            "%16, %17, %18, %19, %20, %21, %22, %23, " \
            "%24, %25, %26, %27, %28, %29, %30, %31}, " \
            "%32, %33, p, 1, 1, 0, 0;\n}\n" \
            : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), \
            "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), \
            "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), \
            "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), \
            "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), \
            "+f"(d[30]), "+f"(d[31]) \
            : "l"(desc_a), "l"(desc_b), "r"(scale_d))
        if constexpr (std::is_same<T, __half>::value) {
            RESSELT_WGMMA_64("f16.f16");
        } else {
            RESSELT_WGMMA_64("bf16.bf16");
        }
#undef RESSELT_WGMMA_64
    }
    template <typename T>
    static __device__ __forceinline__ void rs(float (&d)[32], const uint32_t (&a)[4], uint64_t desc_b, int scale_d) {
#define RESSELT_WGMMA_RS_64(TYPES) \
        asm volatile( \
            "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n" \
            "wgmma.mma_async.sync.aligned.m64n64k16.f32." TYPES " " \
            "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, " \
            "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n" \
            : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]) \
            : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(scale_d))
        if constexpr (std::is_same<T, __half>::value) {
            RESSELT_WGMMA_RS_64("f16.f16");
        } else {
            RESSELT_WGMMA_RS_64("bf16.bf16");
        }
#undef RESSELT_WGMMA_RS_64
    }
};

template <>
struct Wgmma<80> {
    template <typename T>
    static __device__ __forceinline__ void ss(float (&d)[40], uint64_t desc_a, uint64_t desc_b, int scale_d) {
#define RESSELT_WGMMA_80(TYPES) \
        asm volatile( \
            "{\n.reg .pred p;\nsetp.ne.b32 p, %42, 0;\n" \
            "wgmma.mma_async.sync.aligned.m64n80k16.f32." TYPES " " \
            "{%0, %1, %2, %3, %4, %5, %6, %7, " \
            "%8, %9, %10, %11, %12, %13, %14, %15, " \
            "%16, %17, %18, %19, %20, %21, %22, %23, " \
            "%24, %25, %26, %27, %28, %29, %30, %31, " \
            "%32, %33, %34, %35, %36, %37, %38, %39}, " \
            "%40, %41, p, 1, 1, 0, 0;\n}\n" \
            : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), \
            "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), \
            "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), \
            "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), \
            "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), \
            "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), \
            "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]) \
            : "l"(desc_a), "l"(desc_b), "r"(scale_d))
        if constexpr (std::is_same<T, __half>::value) {
            RESSELT_WGMMA_80("f16.f16");
        } else {
            RESSELT_WGMMA_80("bf16.bf16");
        }
#undef RESSELT_WGMMA_80
    }
};

template <>
struct Wgmma<96> {
    template <typename T>
    static __device__ __forceinline__ void ss(float (&d)[48], uint64_t desc_a, uint64_t desc_b, int scale_d) {
#define RESSELT_WGMMA_96(TYPES) \
        asm volatile( \
            "{\n.reg .pred p;\nsetp.ne.b32 p, %50, 0;\n" \
            "wgmma.mma_async.sync.aligned.m64n96k16.f32." TYPES " " \
            "{%0, %1, %2, %3, %4, %5, %6, %7, " \
            "%8, %9, %10, %11, %12, %13, %14, %15, " \
            "%16, %17, %18, %19, %20, %21, %22, %23, " \
            "%24, %25, %26, %27, %28, %29, %30, %31, " \
            "%32, %33, %34, %35, %36, %37, %38, %39, " \
            "%40, %41, %42, %43, %44, %45, %46, %47}, " \
            "%48, %49, p, 1, 1, 0, 0;\n}\n" \
            : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), \
            "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), \
            "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), \
            "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), \
            "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), \
            "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), \
            "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), \
            "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]) \
            : "l"(desc_a), "l"(desc_b), "r"(scale_d))
        if constexpr (std::is_same<T, __half>::value) {
            RESSELT_WGMMA_96("f16.f16");
        } else {
            RESSELT_WGMMA_96("bf16.bf16");
        }
#undef RESSELT_WGMMA_96
    }
};

template <>
struct Wgmma<128> {
    template <typename T>
    static __device__ __forceinline__ void ss(float (&d)[64], uint64_t desc_a, uint64_t desc_b, int scale_d) {
#define RESSELT_WGMMA_128(TYPES) \
        asm volatile( \
            "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n" \
            "wgmma.mma_async.sync.aligned.m64n128k16.f32." TYPES " " \
            "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, " \
            "%64, %65, p, 1, 1, 0, 0;\n}\n" \
            : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]) \
            : "l"(desc_a), "l"(desc_b), "r"(scale_d))
        if constexpr (std::is_same<T, __half>::value) {
            RESSELT_WGMMA_128("f16.f16");
        } else {
            RESSELT_WGMMA_128("bf16.bf16");
        }
#undef RESSELT_WGMMA_128
    }
};

template <>
struct Wgmma<256> {
    template <typename T>
    static __device__ __forceinline__ void ss(float (&d)[128], uint64_t desc_a, uint64_t desc_b, int scale_d) {
#define RESSELT_WGMMA_256(TYPES) \
        asm volatile( \
            "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n" \
            "wgmma.mma_async.sync.aligned.m64n256k16.f32." TYPES " " \
            "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, %96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, %112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127}, " \
            "%128, %129, p, 1, 1, 0, 0;\n}\n" \
            : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]), "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]), "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]), "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]), "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]), "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]), "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127]) \
            : "l"(desc_a), "l"(desc_b), "r"(scale_d))
        if constexpr (std::is_same<T, __half>::value) {
            RESSELT_WGMMA_256("f16.f16");
        } else {
            RESSELT_WGMMA_256("bf16.bf16");
        }
#undef RESSELT_WGMMA_256
    }
};
