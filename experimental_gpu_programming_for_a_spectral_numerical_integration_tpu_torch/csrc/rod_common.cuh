// Device pieces of the refined narrow kernels, K3 and K5 (refined_kernel.cu),
// on the CUDA cores.  (K1, K2 and K4 narrow run on the tensor cores:
// rod_kernel.cu.)
//
// Layout shared by every kernel: a block of kThreads threads holds
// kThreads / P rods; rod `group` owns lanes [group*P, group*P + P) of the
// block, and lane i of a group owns collocation point i (points >= n-1 are
// padding: their operator rows, columns and strain are zero, so they stay
// exactly zero).  P is 8, 16 or 32, so a group never straddles a warp and
// __syncwarp() orders the exchanges between a group's lanes.
//
// A quaternion (w, x, y, z) lives in a float4 as (.x, .y, .z, .w).
#pragma once

#include <cuda_runtime.h>

namespace rod {

constexpr int kThreads = 256;

// Exchange slots of one group; the stride P + 1 puts the groups of a warp
// on different shared-memory banks.
template <int P>
struct Slots {
    static constexpr int kGroups = kThreads / P;
    static constexpr int kStride = P + 1;
    static constexpr int kSize = kGroups * kStride;
};

// Row `lane` of a P x P row-major f32 operator into registers.
template <int P>
__device__ __forceinline__ void load_row(const float* __restrict__ mat, int lane,
                                         float (&row)[P]) {
#pragma unroll
    for (int j = 0; j < P; ++j) row[j] = mat[lane * P + j];
}

// t = A(K) s, the quaternion-skew action of main.cpp:72-75 (12 FMAs).
__device__ __forceinline__ float4 a_apply(float k0, float k1, float k2, float4 s) {
    float4 t;
    t.x = -k0 * s.y - k1 * s.z - k2 * s.w;
    t.y = fmaf(k0, s.x, fmaf(k2, s.z, -k1 * s.w));
    t.z = fmaf(k1, s.x, fmaf(-k2, s.y, k0 * s.w));
    t.w = fmaf(k2, s.x, fmaf(k1, s.y, -k0 * s.z));
    return t;
}

// acc + sum_j g[j] * slot[j]: one row of (I ⊗ G) applied to the group's
// exchanged 4-vectors.  `slot` points at the group's first slot.
template <int P>
__device__ __forceinline__ float4 g_apply(const float (&g)[P], const float4* slot,
                                          float4 acc) {
#pragma unroll
    for (int j = 0; j < P; ++j) {
        const float4 t = slot[j];
        acc.x = fmaf(g[j], t.x, acc.x);
        acc.y = fmaf(g[j], t.y, acc.y);
        acc.z = fmaf(g[j], t.z, acc.z);
        acc.w = fmaf(g[j], t.w, acc.w);
    }
    return acc;
}

// Picard fixed point s = g_rhs + G (A(K/2) s), `iters` steps from s = g_rhs.
// Every lane of the warp must call it with the same `iters`.
template <int P>
__device__ __forceinline__ float4 picard(const float (&g)[P], float4* slot, int lane,
                                         float kh0, float kh1, float kh2,
                                         float4 g_rhs, int iters) {
    float4 s = g_rhs;
    for (int it = 0; it < iters; ++it) {
        slot[lane] = a_apply(kh0, kh1, kh2, s);
        __syncwarp();
        s = g_apply<P>(g, slot, g_rhs);
        __syncwarp();
    }
    return s;
}

// G v for a vector v given per lane: exchange it, then one row product.
template <int P>
__device__ __forceinline__ float4 g_times(const float (&g)[P], float4* slot, int lane,
                                          float4 v) {
    slot[lane] = v;
    __syncwarp();
    const float4 out = g_apply<P>(g, slot, make_float4(0.f, 0.f, 0.f, 0.f));
    __syncwarp();
    return out;
}

// Largest value of v over the P lanes of the calling lane's group.
template <int P>
__device__ __forceinline__ float group_max(float v) {
#pragma unroll
    for (int off = P / 2; off > 0; off /= 2) {
        v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off, P));
    }
    return v;
}

// Which P the launcher was given: 8, 16 or 32 lanes per rod.
inline bool valid_lanes(int p, int npts) {
    return (p == 8 || p == 16 || p == 32) && npts >= 1 && npts <= p;
}

inline int blocks_for(int batch, int p) {
    const int rods_per_block = kThreads / p;
    return (batch + rods_per_block - 1) / rods_per_block;
}

}  // namespace rod
