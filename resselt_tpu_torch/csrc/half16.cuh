// The two 16-bit floating types the tensor-core paths take, behind one
// interface: Half16<__nv_bfloat16> and Half16<__half>.  A kernel is written
// once as a template over T and reaches the conversions, the packed pair and
// the mma.sync operation of its type through Half16<T>.  Also the
// ldmatrix loads those paths share.

#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <stdint.h>

template <typename T>
struct Half16;

template <>
struct Half16<__nv_bfloat16> {
    static __device__ __forceinline__ __nv_bfloat16 from_float(float v) { return __float2bfloat16_rn(v); }
    static __device__ __forceinline__ float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }
    // (lo, hi) rounded and packed, lo in the low half
    static __device__ __forceinline__ uint32_t pack(float lo, float hi) {
        const __nv_bfloat162 p = __floats2bfloat162_rn(lo, hi);
        return *reinterpret_cast<const uint32_t*>(&p);
    }
    static __device__ __forceinline__ float2 unpack(uint32_t v) {
        return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&v));
    }
    // d (m16 x n8, f32) += a (m16 x k16, row) b (k16 x n8, col)
    static __device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
        asm volatile(
            "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
            "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
            : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
            : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
    }
};

template <>
struct Half16<__half> {
    static __device__ __forceinline__ __half from_float(float v) { return __float2half_rn(v); }
    static __device__ __forceinline__ float to_float(__half v) { return __half2float(v); }
    static __device__ __forceinline__ uint32_t pack(float lo, float hi) {
        const __half2 p = __floats2half2_rn(lo, hi);
        return *reinterpret_cast<const uint32_t*>(&p);
    }
    static __device__ __forceinline__ float2 unpack(uint32_t v) {
        return __half22float2(*reinterpret_cast<const __half2*>(&v));
    }
    static __device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
        asm volatile(
            "mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 "
            "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
            : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
            : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
    }
};

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
