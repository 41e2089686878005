// The tensor-core pieces shared by every 3xTF32 kernel: the narrow f32
// kernels (rod_kernel.cu) and the wide core (tc_picard.cuh).  An f32 operand
// is split as x_hi = tf32(x) (cvt.rna), x_lo = tf32(x - x_hi), and a product
// sums lo hi + hi lo + hi hi on mma.sync.m16n8k8 tiles (TF32 in, FP32
// accumulate), as accurate as FP32 FMAs at these depths.
//
// A quaternion (w, x, y, z) lives in a float4 as (.x, .y, .z, .w).
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace tc {

__device__ __forceinline__ uint32_t tf32(float x) {
    uint32_t r;
    asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));
    return r;
}

__device__ __forceinline__ void split_tf32(float x, uint32_t& hi, uint32_t& lo) {
    hi = tf32(x);
    lo = tf32(x - __uint_as_float(hi));
}

// The same split in three instructions where ptxas expands split_tf32 into
// seven (cvt.rna becomes a finiteness test, an add, a select and a mask): hi
// rounded to nearest by the integer add itself, which is what cvt.rna does
// for finite x, and lo = x - hi left in f32, of which the tensor cores read
// only the TF32 bits (they ignore the low 13, as ptxas's own cvt.rna of an
// operand that feeds only mma.sync assumes).  So lo is truncated rather than
// rounded: |x - hi - tf32(lo)| < 2^-21 |x| against 2^-22, with the sign of lo
// as often negative as positive; a NaN x reaches the product through lo.
__device__ __forceinline__ void split_tf32_raw_lo(float x, uint32_t& hi, uint32_t& lo) {
    hi = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
    lo = __float_as_uint(x - __uint_as_float(hi));
}

// c += a b on one m16n8k8 tile (TF32 in, FP32 accumulate).  In the tile a
// thread (g = lane / 4, t = lane % 4) holds a = (g, t), (g + 8, t),
// (g, t + 4), (g + 8, t + 4); b = (t, g), (t + 4, g); c = (g, 2t),
// (g, 2t + 1), (g + 8, 2t), (g + 8, 2t + 1).
__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
    asm volatile(
        "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// t = A(K) s, the quaternion-skew action of main.cpp:72-75 (12 FMAs).
__device__ __forceinline__ float4 a_apply(const float (&k)[3], float4 s) {
    float4 t;
    t.x = -k[0] * s.y - k[1] * s.z - k[2] * s.w;
    t.y = fmaf(k[0], s.x, fmaf(k[2], s.z, -k[1] * s.w));
    t.z = fmaf(k[1], s.x, fmaf(-k[2], s.y, k[0] * s.w));
    t.w = fmaf(k[2], s.x, fmaf(k[1], s.y, -k[0] * s.z));
    return t;
}

}  // namespace tc
