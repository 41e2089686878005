// Device pieces shared by the wide-grid rod kernels (rod_wide_kernel.cu,
// refined_wide_kernel.cu): 32 < n-1 <= 512 collocation points.
//
// Layout: a block of kThreads threads holds R rods.  The points are padded to
// P (64, 128, 256 or 512; padded points have zero operator rows, columns and
// strain, so they stay exactly zero).  Thread t serves rod t % R of the block
// and the TM consecutive points i0 = (t / R) * TM .. i0 + TM - 1 of that rod,
// so P = TM * RG with RG = kThreads / R row groups.  The rod's state for
// those points lives in the thread's registers.
//
// Every product with a P x P operator goes through a shared-memory panel
// panel[k * R + rod] (one float4 per point and rod): each thread writes its
// points, the block synchronises, and each thread then forms its rows of
// G * panel, reading column k of G from G^T (row k of the transposed operator,
// TM consecutive floats, vector loads through L1/L2: every block reads the
// same G, so it stays in L2) and the 4-vector of its rod from the panel.
// Columns k >= n-1 are zero, so the product stops at n-1.  A rod spans many
// warps, so the exchanges are ordered by __syncthreads().
//
// A quaternion (w, x, y, z) lives in a float4 as (.x, .y, .z, .w).
#pragma once

#include <cuda_runtime.h>

namespace wide {

constexpr int kThreads = 256;

// Launch shape per padded width P: TM points per thread, RG row groups,
// R = kThreads / RG rods per block.
template <int P> struct Shape;
template <> struct Shape<64> { static constexpr int TM = 4, RG = 16; };
template <> struct Shape<128> { static constexpr int TM = 4, RG = 32; };
template <> struct Shape<256> { static constexpr int TM = 8, RG = 32; };
template <> struct Shape<512> { static constexpr int TM = 8, RG = 64; };

template <int P>
struct Layout {
    static constexpr int TM = Shape<P>::TM;
    static constexpr int RG = Shape<P>::RG;
    static constexpr int R = kThreads / RG;
    static_assert(TM * RG == P && R * RG == kThreads && TM % 4 == 0, "bad wide shape");
};

// Which padded widths the launchers take.
inline bool valid_width(int p, int npts) {
    return (p == 64 || p == 128 || p == 256 || p == 512) && npts > 32 && npts <= p;
}

inline int blocks_for(int batch, int rods_per_block) {
    return (batch + rods_per_block - 1) / rods_per_block;
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

// TM consecutive floats of a 16-byte aligned row, as float4 loads.
template <int TM>
__device__ __forceinline__ void load_row(const float* __restrict__ src, float (&g)[TM]) {
#pragma unroll
    for (int m = 0; m < TM; m += 4) {
        const float4 v = __ldg(reinterpret_cast<const float4*>(src + m));
        g[m] = v.x;
        g[m + 1] = v.y;
        g[m + 2] = v.z;
        g[m + 3] = v.w;
    }
}

// acc[m] += sum_{k < npts} G[i0 + m][k] * panel[k][rod].  `gt` is G^T
// (P x P, row-major); the panel must be complete (callers synchronise).
template <int P>
__device__ __forceinline__ void panel_product(const float* __restrict__ gt,
                                              const float4* panel, int npts, int i0,
                                              int rod, float4 (&acc)[Layout<P>::TM]) {
    constexpr int TM = Layout<P>::TM, R = Layout<P>::R;
#pragma unroll 2
    for (int k = 0; k < npts; ++k) {
        const float4 t = panel[k * R + rod];
        float g[TM];
        load_row<TM>(gt + (size_t)k * P + i0, g);
#pragma unroll
        for (int m = 0; m < TM; ++m) {
            acc[m].x = fmaf(g[m], t.x, acc[m].x);
            acc[m].y = fmaf(g[m], t.y, acc[m].y);
            acc[m].z = fmaf(g[m], t.z, acc[m].z);
            acc[m].w = fmaf(g[m], t.w, acc[m].w);
        }
    }
}

// out = base + G v for this thread's points: v goes through the panel.
// Every thread of the block must call it.
template <int P>
__device__ __forceinline__ void g_times(const float* __restrict__ gt, float4* panel,
                                        int npts, int i0, int rod,
                                        const float4 (&v)[Layout<P>::TM],
                                        const float4 (&base)[Layout<P>::TM],
                                        float4 (&out)[Layout<P>::TM]) {
    constexpr int TM = Layout<P>::TM, R = Layout<P>::R;
#pragma unroll
    for (int m = 0; m < TM; ++m) panel[(i0 + m) * R + rod] = v[m];
    __syncthreads();
    float4 acc[TM];
#pragma unroll
    for (int m = 0; m < TM; ++m) acc[m] = base[m];
    panel_product<P>(gt, panel, npts, i0, rod, acc);
    __syncthreads();
#pragma unroll
    for (int m = 0; m < TM; ++m) out[m] = acc[m];
}

// Picard fixed point s = g_rhs + G (A(K/2) s), `iters` steps from s = g_rhs;
// kh[m] holds K/2 at point i0 + m.  Every thread of the block must call it
// with the same `iters`.
template <int P>
__device__ __forceinline__ void picard(const float* __restrict__ gt, float4* panel,
                                       int npts, int i0, int rod,
                                       const float (&kh)[Layout<P>::TM][3],
                                       const float4 (&g_rhs)[Layout<P>::TM], int iters,
                                       float4 (&s)[Layout<P>::TM]) {
    constexpr int TM = Layout<P>::TM;
#pragma unroll
    for (int m = 0; m < TM; ++m) s[m] = g_rhs[m];
    for (int it = 0; it < iters; ++it) {
        float4 t[TM];
#pragma unroll
        for (int m = 0; m < TM; ++m) t[m] = a_apply(kh[m], s[m]);
        g_times<P>(gt, panel, npts, i0, rod, t, g_rhs, s);
    }
}

}  // namespace wide
