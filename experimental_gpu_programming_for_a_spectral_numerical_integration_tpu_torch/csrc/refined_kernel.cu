// K3 and K5: the whole refined rod solve in one kernel, with the demo boundary
// values (K3) or per-rod ones (K5).
//
// Replaces the JAX package's Pallas TPU kernels ops/pallas/refined_kernel.py
// rod_shape_refined_kernel (body _kernel, pallas_call :890), the headline path,
// and rod_shape_refined_kernel_bc (the same body with bc=True, pallas_call
// :792), the multi-segment accuracy chain:
//   1. K = Phi (qe_hi + qe_lo) in FP64;
//   2. f32 Picard base solve s (K/2 rounded to f32), as K1;
//   3. residual rhs - Dn_NN s + 1/2 A(K) s in FP64, rhs = -dn_in ⊗ (1,0,0,0);
//   4. f32 Picard correction delta of that residual;
//   5. x = s + delta in FP64 (exact), the FP64 unnormalized tangent
//      b = R(x) e1 (R(x)(e1 + gamma) for na = 6) and FP64 position r = G b;
//   6. x and r split into f32 (hi, lo) pairs; a rod with
//      max_i |K_i / 2|^2 > (check_rho / L)^2 is NaN in all four outputs.
// K5 takes q0 = q0_hi + q0_lo (B,4) and r0 = r0_hi + r0_lo (B,3), f32 pairs:
// the base solve starts from gvec32 ⊗ q0_hi (as the TPU body does), the FP64
// residual uses rhs = -dn_in ⊗ (q0_hi + q0_lo), and the FP64 position is
// G b + gvec64 ⊗ (r0_hi + r0_lo) with gvec64 = -G dn_in, so a junction state
// never drops to f32.  The rho limit is per segment: (check_rho / L_segment)^2.
// The TPU kernel needed int8 Ozaki planes and double-word EFTs for steps 3
// and 5 (and dd outer products for the boundary terms), and NaN-poisoned
// states outside the int8 windows (|s| >= 3.96, |b| >= 7.92); native FP64
// removes all of them.
//
// Bound on an H100: two f32 Picard loops and G res (41 products of 4 (n-1)^2
// multiply-adds at N=16 and 20/20 iterations, ~37,000 per rod, plus 12 (n-1)
// per step in A(K/2)) and ~1,600 FP64 multiply-adds (Dn_NN s and G b)
// against ~72 bytes in and 840 bytes out per rod: operations bound.
// Design: the narrow tensor-core core (narrow_tc.cuh) runs both f32 loops:
// the base solve is K1's loop, the correction K2's, each step of a warp's 8
// or 16 rods one 3xTF32 mma.sync product held in registers.  The FP64
// products Dn_NN s and G b run on the FP64 tensor cores (DMMA,
// mma.sync.m8n8k4.f64) in the same layout: one component of the rods
// g + 8h is an 8-row M-block, and k-step (kb, e) takes k index t for point
// 8 kb + 2t + e, so a thread's A fragment (row g, column t) is its own value
// at that point and its C fragment (row g, columns 2t, 2t + 1 of n-tile nb)
// its own pairs: neither product moves data between threads.  The B fragments
// (one double per k-step and n-tile) come from the operator permuted on the
// host (refined_kernel.dmma_order) so that a thread reads a k-block's two as
// one 16-byte load, the warp's loads consecutive (L1-resident).  To fit
// K1's launch shape (128 registers a thread at P = 8 and 16, no spills), the
// FP64 strain is recomputed from qe where it is used (the loops' f32 K/2,
// the residual's K/2, gamma for the tangent) rather than held through the
// loops, Q leaves as the exact f32 pair of s + delta (TwoSum, no FP64
// round trip), and the tangent and position go one component at a time.
// The rho sentinel's max over a rod's points is two shuffles across the 4
// threads (t) that hold the rod.
//
// C interface as rod_kernel.cu; qes_lo, q0_lo and r0_lo may be NULL (zero low
// words) and rho2_limit < 0 disables the sentinel.  Operators are zero-padded
// to P points: gtp as rod_kernel.cu's, g64 and dn64 G and Dn_NN in
// dmma_order, ptab64 P x ne, gvec32, din64 and gvec64 P.
#include <type_traits>

#include "narrow_tc.cuh"
#include "refined_bc.cuh"

namespace {

using namespace narrow;
using namespace refined_bc;

// Launch shape of K3 and K5: K1's (narrow_tc.cuh), but 3 blocks per SM at
// P = 16 for na = 6, whose tangent does not fit 4 blocks' registers.
template <int P, int NA>
using RShape = std::conditional_t<P == 16 && NA == 6, Cfg<16, 8, 4, 3>, Shape<P>>;

// d += a b on one m8n8k4 FP64 tile (DMMA).  A thread (g = lane / 4,
// t = lane % 4) holds a = (g, t), b = (t, g) and d = (g, 2t), (g, 2t + 1).
__device__ __forceinline__ void mma_f64(double (&d)[2], double a, double b) {
    asm volatile("mma.sync.aligned.m8n8k4.row.col.f64.f64.f64.f64 {%0, %1}, {%2}, {%3}, {%0, %1};"
                 : "+d"(d[0]), "+d"(d[1])
                 : "d"(a), "d"(b));
}

// d += Op v for one component of the warp's rods g + 8h, v given per pair as
// xv(kb, e) and d[nb][e] at point 8 nb + 2t + e; Op (P x P, FP64) in
// dmma_order: Op[8 nb + g][8 kb + 2t + e] at ((nb NB + kb) 32 + lane) 2 + e.
template <class C, class XV>
__device__ __forceinline__ void product64(const double* __restrict__ op, XV xv,
                                          double (&d)[C::NB][2]) {
    const double2* b2 = reinterpret_cast<const double2*>(op) + threadIdx.x % 32;
#pragma unroll
    for (int kb = 0; kb < C::NB; ++kb) {
        double2 b[C::NB];
#pragma unroll
        for (int nb = 0; nb < C::NB; ++nb) b[nb] = __ldg(b2 + (nb * C::NB + kb) * 32);
#pragma unroll
        for (int e = 0; e < 2; ++e) {
            const double a = xv(kb, e);
#pragma unroll
            for (int nb = 0; nb < C::NB; ++nb) mma_f64(d[nb], a, e ? b[nb].y : b[nb].x);
        }
    }
}

// K_a in FP64 for components a0 .. a0 + NC - 1 at the thread's pairs, from
// both words of qe (zero for a rod past the batch), summed over j in order.
template <class C, int NC>
__device__ __forceinline__ void strain64(const float* __restrict__ qes_hi,
                                         const float* __restrict__ qes_lo,
                                         const double* __restrict__ ptab64, int batch, int nq,
                                         int ne, int a0, const Lane& l,
                                         double (&k)[C::H][C::NB][2][NC]) {
    for_pairs<C>([&](int h, int nb, int e) {
#pragma unroll
        for (int a = 0; a < NC; ++a) k[h][nb][e][a] = 0.0;
    });
    for (int j = 0; j < ne; ++j) {
        double pt[C::NB][2];
#pragma unroll
        for (int nb = 0; nb < C::NB; ++nb)
#pragma unroll
            for (int e = 0; e < 2; ++e) pt[nb][e] = __ldg(ptab64 + l.point(nb, e) * ne + j);
#pragma unroll
        for (int h = 0; h < C::H; ++h) {
            const long long rod = l.rod(h);
            if (rod >= batch) continue;
#pragma unroll
            for (int a = 0; a < NC; ++a) {
                const long long at = rod * nq + (a0 + a) * ne + j;
                double q = (double)__ldg(qes_hi + at);
                if (qes_lo != nullptr) q += (double)__ldg(qes_lo + at);
#pragma unroll
                for (int nb = 0; nb < C::NB; ++nb)
#pragma unroll
                    for (int e = 0; e < 2; ++e) k[h][nb][e][a] = fma(pt[nb][e], q, k[h][nb][e][a]);
            }
        }
    }
}

__device__ __forceinline__ void split(double v, float& hi, float& lo) {
    hi = __double2float_rn(v);
    lo = __double2float_rn(v - (double)hi);
}

// The f32 pair (hi, lo) of the exact sum a + b (TwoSum): the same pair as
// split((double)a + (double)b) wherever that double sum is exact, and the
// pair whose double sum is the rounded one otherwise.
__device__ __forceinline__ void two_sum(float a, float b, float& hi, float& lo) {
    hi = __fadd_rn(a, b);
    const float bb = __fsub_rn(hi, a);
    lo = __fadd_rn(__fsub_rn(a, __fsub_rn(hi, bb)), __fsub_rn(b, bb));
}

template <int P, int NA, bool BC>
__global__ void __launch_bounds__(RShape<P, NA>::kThreads, RShape<P, NA>::kMinBlocks)
rod_shape_refined_kernel(const float* __restrict__ qes_hi, const float* __restrict__ qes_lo,
                         int batch, int npts, int ne, const float* __restrict__ gtp,
                         const float* __restrict__ gvec32, const double* __restrict__ g64,
                         const double* __restrict__ dn64, const double* __restrict__ ptab64,
                         const double* __restrict__ din64, Boundary bc, int iters,
                         int corr_iters, float rho2_limit, float* __restrict__ q_hi,
                         float* __restrict__ q_lo, float* __restrict__ r_hi,
                         float* __restrict__ r_lo) {
    using C = RShape<P, NA>;
    const int nq = NA * ne;
    const Lane l = lane_of<C>();
    if (l.rod0 >= batch) return;   // the whole warp is past the batch
    Operator<C> op;
    load_operator<C>(op, gtp, l);

    // 1. K/2 in f32, rounded from the FP64 strain (as the plain version).
    float kh[C::H][C::NB][2][3];
    {
        double k64[C::H][C::NB][2][3];
        strain64<C, 3>(qes_hi, qes_lo, ptab64, batch, nq, ne, 0, l, k64);
        for_pairs<C>([&](int h, int nb, int e) {
#pragma unroll
            for (int a = 0; a < 3; ++a) kh[h][nb][e][a] = (float)(0.5 * k64[h][nb][e][a]);
        });
    }

    // rho sentinel: max over the rod's points of |K/2|^2, the thread's own
    // pairs and then the 4 threads (t) that hold the rod.  Padded points
    // have zero strain.
    bool bad[C::H];
#pragma unroll
    for (int h = 0; h < C::H; ++h) {
        float m = 0.f;
#pragma unroll
        for (int nb = 0; nb < C::NB; ++nb)
#pragma unroll
            for (int e = 0; e < 2; ++e) {
                const float* f = kh[h][nb][e];
                m = fmaxf(m, f[0] * f[0] + f[1] * f[1] + f[2] * f[2]);
            }
        m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 1));
        m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 2));
        bad[h] = rho2_limit >= 0.f && m > rho2_limit;
    }

    // 2. f32 base solve s = gvec32 ⊗ q0 + G (A(K/2) s): K1's loop.  K5 reads
    // q0_hi here, its FP64 boundary pairs where they are used.
    Tile<C> s;
    {
        float gv[C::NB][2], q0[C::H][4];
#pragma unroll
        for (int nb = 0; nb < C::NB; ++nb)
#pragma unroll
            for (int e = 0; e < 2; ++e) gv[nb][e] = __ldg(gvec32 + l.point(nb, e));
#pragma unroll
        for (int h = 0; h < C::H; ++h) {
            const long long rod = l.rod(h);
            const float4 q = BC && rod < batch
                                 ? __ldg(reinterpret_cast<const float4*>(bc.q0_hi) + rod)
                                 : make_float4(1.f, 0.f, 0.f, 0.f);
            q0[h][0] = q.x;
            q0[h][1] = q.y;
            q0[h][2] = q.z;
            q0[h][3] = q.w;
        }
        Tile<C> base;
        for_pairs<C>([&](int h, int nb, int e) {
#pragma unroll
            for (int c = 0; c < 4; ++c) {
                at<C>(base, h, nb, e, c) = gv[nb][e] * q0[h][c];
                at<C>(s, h, nb, e, c) = at<C>(base, h, nb, e, c);
            }
        });
        for (int it = 0; it < iters; ++it) {
            product<C>(op, [&](int h, int nb, int e) {
                return tc::a_apply(kh[h][nb][e], at4<C>(s, h, nb, e));
            }, s);
            for_pairs<C>([&](int h, int nb, int e) {
#pragma unroll
                for (int c = 0; c < (BC ? 4 : 1); ++c)
                    at<C>(s, h, nb, e, c) += at<C>(base, h, nb, e, c);
            });
        }
    }

    // 3. FP64 residual rhs - Dn_NN s + A(K/2) s, on DMMA per component with
    // C = rhs + A(K/2) s and A = -s; rounded to f32 for the correction.
    Tile<C> res;
#pragma unroll
    for (int h = 0; h < C::H; ++h) {
        double d[4][C::NB][2];
        {
            double k64[C::H][C::NB][2][3];   // only rod h's are used
            strain64<C, 3>(qes_hi, qes_lo, ptab64, batch, nq, ne, 0, l, k64);
            const long long rod = l.rod(h);
            double q0[4];   // rhs = -dn_in ⊗ q0
#pragma unroll
            for (int c = 0; c < 4; ++c) {
                q0[c] = BC && rod < batch ? pair_at(bc.q0_hi, bc.q0_lo, rod * 4 + c)
                                          : (c == 0 ? 1.0 : 0.0);
            }
#pragma unroll
            for (int nb = 0; nb < C::NB; ++nb)
#pragma unroll
                for (int e = 0; e < 2; ++e) {
                    const double din = __ldg(din64 + l.point(nb, e));
                    const double k0 = 0.5 * k64[h][nb][e][0], k1 = 0.5 * k64[h][nb][e][1];
                    const double k2 = 0.5 * k64[h][nb][e][2];
                    const double sw = at<C>(s, h, nb, e, 0), sx = at<C>(s, h, nb, e, 1);
                    const double sy = at<C>(s, h, nb, e, 2), sz = at<C>(s, h, nb, e, 3);
                    d[0][nb][e] = -din * q0[0] + (-k0 * sx - k1 * sy - k2 * sz);
                    d[1][nb][e] = -din * q0[1] + (k0 * sw + k2 * sy - k1 * sz);
                    d[2][nb][e] = -din * q0[2] + (k1 * sw - k2 * sx + k0 * sz);
                    d[3][nb][e] = -din * q0[3] + (k2 * sw + k1 * sx - k0 * sy);
                }
        }
#pragma unroll
        for (int c = 0; c < 4; ++c) {
            product64<C>(dn64, [&](int kb, int e) { return -(double)at<C>(s, h, kb, e, c); },
                         d[c]);
#pragma unroll
            for (int nb = 0; nb < C::NB; ++nb)
#pragma unroll
                for (int e = 0; e < 2; ++e) at<C>(res, h, nb, e, c) = (float)d[c][nb][e];
        }
    }

    // 4. f32 correction x = G (res + A(K/2) x): K2's loop, corr_iters + 1
    // products from x = 0, the first G res.
    Tile<C> x;
    for_pairs<C>([&](int h, int nb, int e) {
        put4<C>(x, h, nb, e, make_float4(0.f, 0.f, 0.f, 0.f));
    });
    for (int it = 0; it <= corr_iters; ++it) {
        product<C>(op, [&](int h, int nb, int e) {
            const float4 v = at4<C>(res, h, nb, e);
            const float4 t = tc::a_apply(kh[h][nb][e], at4<C>(x, h, nb, e));
            return make_float4(v.x + t.x, v.y + t.y, v.z + t.z, v.w + t.w);
        }, x);
    }

    // 5-6. x = s + delta as an exact f32 pair (Q, split and stored) and in
    // FP64, the FP64 unnormalized tangent b = R(x) e1 (main.cpp:130-136;
    // R(x) (e1 + gamma) for na = 6) and the FP64 position r = G b
    // (+ gvec64 ⊗ r0 for K5) on DMMA, a component at a time: b_c is formed
    // from x again for each c, to keep one component of b in registers.
    const float nan = __int_as_float(0x7fc00000);
    double gam[C::H][C::NB][2][NA == 6 ? 3 : 1];   // (epsilon, gamma_1, gamma_2) - (1, 0, 0)
    if constexpr (NA == 6) strain64<C, 3>(qes_hi, qes_lo, ptab64, batch, nq, ne, 3, l, gam);
#pragma unroll
    for (int c = 0; c < 3; ++c) {
        double bt[C::H][C::NB][2];   // b_c
        for_pairs<C>([&](int h, int nb, int e) {
            float4 hi, lo;
            two_sum(at<C>(s, h, nb, e, 0), at<C>(x, h, nb, e, 0), hi.x, lo.x);
            two_sum(at<C>(s, h, nb, e, 1), at<C>(x, h, nb, e, 1), hi.y, lo.y);
            two_sum(at<C>(s, h, nb, e, 2), at<C>(x, h, nb, e, 2), hi.z, lo.z);
            two_sum(at<C>(s, h, nb, e, 3), at<C>(x, h, nb, e, 3), hi.w, lo.w);
            if (c == 0) {
                const long long rod = l.rod(h);
                const int i = l.point(nb, e);
                if (rod < batch && i < npts) {
                    const float4 nan4 = make_float4(nan, nan, nan, nan);
                    reinterpret_cast<float4*>(q_hi)[rod * npts + i] = bad[h] ? nan4 : hi;
                    reinterpret_cast<float4*>(q_lo)[rod * npts + i] = bad[h] ? nan4 : lo;
                }
            }
            const double w = (double)hi.x + (double)lo.x, xx = (double)hi.y + (double)lo.y;
            const double y = (double)hi.z + (double)lo.z, z = (double)hi.w + (double)lo.w;
            // row c of R(x)
            const double r[3] = {
                c == 0 ? 1.0 - 2.0 * (y * y + z * z) : c == 1 ? 2.0 * (xx * y + w * z)
                                                            : 2.0 * (xx * z - w * y),
                c == 0 ? 2.0 * (xx * y - w * z) : c == 1 ? 1.0 - 2.0 * (xx * xx + z * z)
                                                         : 2.0 * (y * z + w * xx),
                c == 0 ? 2.0 * (xx * z + w * y) : c == 1 ? 2.0 * (y * z - w * xx)
                                                         : 1.0 - 2.0 * (xx * xx + y * y)};
            if constexpr (NA == 6) {
                const double* g = gam[h][nb][e];
                bt[h][nb][e] = r[0] * (1.0 + g[0]) + r[1] * g[1] + r[2] * g[2];
            } else {
                bt[h][nb][e] = r[0];
            }
        });
#pragma unroll
        for (int h = 0; h < C::H; ++h) {
            const long long rod = l.rod(h);
            const bool live = rod < batch;
            double d[C::NB][2];
            const double r0 = BC && live ? pair_at(bc.r0_hi, bc.r0_lo, rod * 3 + c) : 0.0;
#pragma unroll
            for (int nb = 0; nb < C::NB; ++nb)
#pragma unroll
                for (int e = 0; e < 2; ++e)
                    d[nb][e] = BC ? __ldg(bc.gvec64 + l.point(nb, e)) * r0 : 0.0;
            product64<C>(g64, [&](int kb, int e) { return bt[h][kb][e]; }, d);
#pragma unroll
            for (int nb = 0; nb < C::NB; ++nb)
#pragma unroll
                for (int e = 0; e < 2; ++e) {
                    const int i = l.point(nb, e);
                    if (live && i < npts) {
                        float rh, rl;
                        split(d[nb][e], rh, rl);
                        if (bad[h]) rh = rl = nan;
                        r_hi[(rod * npts + i) * 3 + c] = rh;
                        r_lo[(rod * npts + i) * 3 + c] = rl;
                    }
                }
        }
    }
}

template <int P, bool BC>
int launch_refined(const float* qes_hi, const float* qes_lo, int batch, int npts, int na,
                   int ne, const float* gtp, const float* gvec32, const double* g64,
                   const double* dn64, const double* ptab64, const double* din64, Boundary bc,
                   int iters, int corr_iters, float rho2_limit, float* q_hi, float* q_lo,
                   float* r_hi, float* r_lo, cudaStream_t stream) {
    if (na == 6) {
        return launch<RShape<P, 6>>(rod_shape_refined_kernel<P, 6, BC>, batch, stream, qes_hi,
                                 qes_lo, batch, npts, ne, gtp, gvec32, g64, dn64, ptab64, din64,
                                 bc, iters, corr_iters, rho2_limit, q_hi, q_lo, r_hi, r_lo);
    }
    return launch<RShape<P, 3>>(rod_shape_refined_kernel<P, 3, BC>, batch, stream, qes_hi, qes_lo,
                             batch, npts, ne, gtp, gvec32, g64, dn64, ptab64, din64, bc, iters,
                             corr_iters, rho2_limit, q_hi, q_lo, r_hi, r_lo);
}

template <bool BC>
int refined_entry(const float* qes_hi, const float* qes_lo, int batch, int npts, int p,
                  int na, int ne, const float* gtp, const float* gvec32, const double* g64,
                  const double* dn64, const double* ptab64, const double* din64,
                  Boundary bc, int iters, int corr_iters, double rho2_limit, float* q_hi,
                  float* q_lo, float* r_hi, float* r_lo, void* stream) {
    if (!valid_width(p, npts) || batch <= 0 || (na != 3 && na != 6) || ne < 1 ||
        iters < 0 || corr_iters < 0 ||
        (BC && (bc.q0_hi == nullptr || bc.r0_hi == nullptr || bc.gvec64 == nullptr))) {
        return (int)cudaErrorInvalidValue;
    }
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    const float limit = rho2_limit < 0.0 ? -1.f : (float)rho2_limit;
    switch (p) {
        case 8:
            return launch_refined<8, BC>(qes_hi, qes_lo, batch, npts, na, ne, gtp, gvec32, g64,
                                         dn64, ptab64, din64, bc, iters, corr_iters, limit, q_hi,
                                         q_lo, r_hi, r_lo, s);
        case 16:
            return launch_refined<16, BC>(qes_hi, qes_lo, batch, npts, na, ne, gtp, gvec32, g64,
                                          dn64, ptab64, din64, bc, iters, corr_iters, limit,
                                          q_hi, q_lo, r_hi, r_lo, s);
        default:
            return launch_refined<32, BC>(qes_hi, qes_lo, batch, npts, na, ne, gtp, gvec32, g64,
                                          dn64, ptab64, din64, bc, iters, corr_iters, limit,
                                          q_hi, q_lo, r_hi, r_lo, s);
    }
}

}  // namespace

extern "C" int rod_shape_refined(const float* qes_hi, const float* qes_lo, int batch,
                                 int npts, int p, int na, int ne, const float* gtp,
                                 const float* gvec32, const double* g64, const double* dn64,
                                 const double* ptab64, const double* din64, int iters,
                                 int corr_iters, double rho2_limit, float* q_hi,
                                 float* q_lo, float* r_hi, float* r_lo, void* stream) {
    return refined_entry<false>(qes_hi, qes_lo, batch, npts, p, na, ne, gtp, gvec32, g64,
                                dn64, ptab64, din64, Boundary{}, iters, corr_iters,
                                rho2_limit, q_hi, q_lo, r_hi, r_lo, stream);
}

// K5: q0_hi (B, 4, 16-byte aligned) and r0_hi (B, 3) f32, with optional low
// words of the same shapes; gvec64 = -G dn_in zero-padded to P.
extern "C" int rod_shape_refined_bc(const float* qes_hi, const float* qes_lo,
                                    const float* q0_hi, const float* q0_lo,
                                    const float* r0_hi, const float* r0_lo, int batch,
                                    int npts, int p, int na, int ne, const float* gtp,
                                    const float* gvec32, const double* g64,
                                    const double* dn64, const double* ptab64,
                                    const double* din64, const double* gvec64, int iters,
                                    int corr_iters, double rho2_limit, float* q_hi,
                                    float* q_lo, float* r_hi, float* r_lo, void* stream) {
    return refined_entry<true>(qes_hi, qes_lo, batch, npts, p, na, ne, gtp, gvec32, g64,
                               dn64, ptab64, din64, Boundary{q0_hi, q0_lo, r0_hi, r0_lo, gvec64},
                               iters, corr_iters, rho2_limit, q_hi, q_lo, r_hi, r_lo, stream);
}
