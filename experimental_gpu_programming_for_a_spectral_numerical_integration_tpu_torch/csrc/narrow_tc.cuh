// Tensor-core Picard core of every narrow kernel (n-1 <= 32 points): K1, K2
// and K4 (rod_kernel.cu) and K3 and K5 (refined_kernel.cu).
//
// Every Picard step of a warp's R rods is one GEMM on the tensor cores,
// transposed so that the state never leaves the mma.sync registers:
//     S^T = base^T + T^T G^T,   T = A(K/2) S,
// with M = 4R rows in component-major order (m = c R + rod) and K = N = P
// points.  In the m16n8 accumulator a thread (g = lane / 4, t = lane % 4)
// holds all four components of rod g (and of rod g + 8 when R = 16) at points
// 2t and 2t + 1 of each 8-point n-tile, so A(K/2), the tangent and the stores
// are thread-local.  With k rows t and t + 4 of each 8-deep k-block standing
// for points 2t and 2t + 1, the accumulator tile (c0, c1, c2, c3) is the next
// product's A fragment (c0, c2, c1, c3): G^T is a constant, so the caller
// permutes its rows to that k order (rod_kernel.mma_k_order) and splits it
// into TF32 hi and lo planes, and each thread holds its B fragments in
// registers for the whole kernel.  No shared memory and no barrier.
// Precision as in tc_picard.cuh: 3xTF32 (lo hi + hi lo + hi hi), G's split
// made once by the caller, and each product of depth <= 16 summed in a fresh
// tile and added to the base with a rounded FP32 add (the tensor cores do
// not round their FP32 tile sum to nearest).  T is split in registers at each
// step by split_tf32_raw_lo (tf32_mma.cuh): hi rounded to nearest as cvt.rna
// would, lo truncated by the tensor cores, in three instructions where
// cvt.rna takes seven; the loop was issue-bound on them.
//
// Points are padded to P (8, 16 or 32); padded points have zero operator
// rows, columns and strain, so they stay exactly zero.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "tf32_mma.cuh"

namespace narrow {

// A launch shape at padded width P_: R_ rods a warp (8 or 16), WARPS_ warps a
// block, and the blocks per SM its registers are fitted to.
template <int P_, int R_, int WARPS_, int BLOCKS_>
struct Cfg {
    static constexpr int P = P_, R = R_, kWarps = WARPS_, kMinBlocks = BLOCKS_;
    static constexpr int kThreads = 32 * WARPS_;
    static constexpr int NB = P / 8;   // n-tiles of a tile = k-blocks of a product
    static constexpr int MT = R / 4;   // m-tiles: the 4R rows, 16 a tile
    static constexpr int H = R / 8;    // rods a thread holds: g and g + 8
    static constexpr int NS = (NB + 1) / 2;   // 16-deep slabs of a product
    static_assert(R == 8 || R == 16, "8 or 16 rods a warp");
};

// The launch shapes of K1, K2 and K4.
template <int P> struct Shape;
template <> struct Shape<8> : Cfg<8, 16, 4, 4> {};
template <> struct Shape<16> : Cfg<16, 8, 4, 4> {};
template <> struct Shape<32> : Cfg<32, 8, 4, 2> {};

// A thread's part of the warp's 4R x P state, in the m16n8 accumulator layout.
template <class C>
using Tile = float[C::MT][C::NB][4];

// Component c of the thread's rod g + 8h at its point 8nb + 2t + e: row
// m = c R + 8h of the GEMM.
template <class C>
__device__ __forceinline__ float& at(Tile<C>& x, int h, int nb, int e, int c) {
    const int m = c * C::R + 8 * h;
    return x[m / 16][nb][2 * (m / 8 % 2) + e];
}

template <class C>
__device__ __forceinline__ float4 at4(Tile<C>& x, int h, int nb, int e) {
    return make_float4(at<C>(x, h, nb, e, 0), at<C>(x, h, nb, e, 1), at<C>(x, h, nb, e, 2),
                       at<C>(x, h, nb, e, 3));
}

template <class C>
__device__ __forceinline__ void put4(Tile<C>& x, int h, int nb, int e, float4 v) {
    at<C>(x, h, nb, e, 0) = v.x;
    at<C>(x, h, nb, e, 1) = v.y;
    at<C>(x, h, nb, e, 2) = v.z;
    at<C>(x, h, nb, e, 3) = v.w;
}

// The thread's (rod, point) pairs in a loop nest: f(h, nb, e).
template <class C, class F>
__device__ __forceinline__ void for_pairs(F f) {
#pragma unroll
    for (int h = 0; h < C::H; ++h)
#pragma unroll
        for (int nb = 0; nb < C::NB; ++nb)
#pragma unroll
            for (int e = 0; e < 2; ++e) f(h, nb, e);
}

// Thread coordinates: g, t, and the warp's first rod.
struct Lane {
    int g, t;
    long long rod0;
    __device__ long long rod(int h) const { return rod0 + g + 8 * h; }
    __device__ int point(int nb, int e) const { return 8 * nb + 2 * t + e; }
};

template <class C>
__device__ __forceinline__ Lane lane_of() {
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
    return Lane{lane >> 2, lane & 3, ((long long)blockIdx.x * C::kWarps + warp) * C::R};
}

// The thread's B fragments of G^T for each (k-block, n-tile): k rows t and
// t + 4, column g; TF32 hi and lo.
template <class C>
struct Operator {
    uint32_t hi[C::NB][C::NB][2], lo[C::NB][C::NB][2];
};

template <class C>
__device__ __forceinline__ void load_operator(Operator<C>& op, const float* __restrict__ gtp,
                                              const Lane& l) {
    const float* hi = gtp + C::P * C::P;
    const float* lo = hi + C::P * C::P;
#pragma unroll
    for (int kb = 0; kb < C::NB; ++kb)
#pragma unroll
        for (int nb = 0; nb < C::NB; ++nb)
#pragma unroll
            for (int j = 0; j < 2; ++j) {
                const int off = (8 * kb + l.t + 4 * j) * C::P + 8 * nb + l.g;
                op.hi[kb][nb][j] = __float_as_uint(__ldg(hi + off));
                op.lo[kb][nb][j] = __float_as_uint(__ldg(lo + off));
            }
}

// out = G T for the warp's rods, T given per pair as tv(h, nb, e) (a float4
// of components); tv may read out.  T's n-tile kb is the A fragment of
// k-block kb, split into TF32 hi and lo in registers; the products of each
// 16-deep slab are summed in a fresh tile (small ones first, as in
// tc_picard.cuh) and the slabs added in FP32.
template <class C, class TV>
__device__ __forceinline__ void product(const Operator<C>& op, TV tv, Tile<C>& out) {
    uint32_t ah[C::NB][C::MT][4], al[C::NB][C::MT][4];
    for_pairs<C>([&](int h, int nb, int e) {
        const float4 v = tv(h, nb, e);
        const float vc[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
        for (int c = 0; c < 4; ++c) {
            // the accumulator entry q of row m is A fragment entry a
            const int m = c * C::R + 8 * h, q = 2 * (m / 8 % 2) + e;
            const int a = 2 * (q & 1) + (q >> 1);
            tc::split_tf32_raw_lo(vc[c], ah[nb][m / 16][a], al[nb][m / 16][a]);
        }
    });
    float d[C::NS][C::MT][C::NB][4] = {};
#pragma unroll
    for (int kb = 0; kb < C::NB; ++kb)
#pragma unroll
        for (int pass = 0; pass < 3; ++pass)
#pragma unroll
            for (int mt = 0; mt < C::MT; ++mt)
#pragma unroll
                for (int nb = 0; nb < C::NB; ++nb) {
                    const uint32_t(&b)[2] = pass == 1 ? op.lo[kb][nb] : op.hi[kb][nb];
                    tc::mma_tf32(d[kb / 2][mt][nb], pass == 0 ? al[kb][mt] : ah[kb][mt], b[0],
                                 b[1]);
                }
    float* o = &out[0][0][0];
#pragma unroll
    for (int j = 0; j < C::MT * C::NB * 4; ++j) {
        o[j] = (&d[0][0][0][0])[j];
#pragma unroll
        for (int sl = 1; sl < C::NS; ++sl) o[j] += (&d[sl][0][0][0])[j];
    }
}

// K_a = sum_j P_j(x_i) qe[a*ne + j] for components a0 .. a0 + 2 at the
// thread's pairs (zero for a rod past the batch), in the plain version's
// order of j.
template <class C>
__device__ __forceinline__ void strain3(const float* __restrict__ qes,
                                        const float* __restrict__ ptab, int batch, int nq,
                                        int ne, int a0, const Lane& l,
                                        float (&k)[C::H][C::NB][2][3]) {
    for_pairs<C>([&](int h, int nb, int e) {
#pragma unroll
        for (int a = 0; a < 3; ++a) k[h][nb][e][a] = 0.f;
    });
    for (int j = 0; j < ne; ++j) {
        float pt[C::NB][2];
#pragma unroll
        for (int nb = 0; nb < C::NB; ++nb)
#pragma unroll
            for (int e = 0; e < 2; ++e) pt[nb][e] = __ldg(ptab + l.point(nb, e) * ne + j);
#pragma unroll
        for (int h = 0; h < C::H; ++h) {
            const long long rod = l.rod(h);
            if (rod >= batch) continue;
#pragma unroll
            for (int a = 0; a < 3; ++a) {
                const float q = __ldg(qes + rod * nq + (a0 + a) * ne + j);
#pragma unroll
                for (int nb = 0; nb < C::NB; ++nb)
#pragma unroll
                    for (int e = 0; e < 2; ++e) k[h][nb][e][a] = fmaf(pt[nb][e], q, k[h][nb][e][a]);
            }
        }
    }
}

// Which P the launcher was given: 8, 16 or 32 points.
inline bool valid_width(int p, int npts) {
    return (p == 8 || p == 16 || p == 32) && npts >= 1 && npts <= p;
}

template <class C, class Kernel, class... Args>
int launch(Kernel kernel, int batch, cudaStream_t stream, Args... args) {
    constexpr int rods = C::R * C::kWarps;
    kernel<<<(batch + rods - 1) / rods, C::kThreads, 0, stream>>>(args...);
    return (int)cudaGetLastError();
}

}  // namespace narrow
