// K1, K2 and K4 narrow (n-1 <= 32 points): the fused f32 rod solve, the
// general right-hand-side Picard solve, and the fused solve with per-rod
// boundary values.
//
// Replaces the JAX package's Pallas TPU kernels in ops/pallas/rod_kernel.py:
//   K1 rod_shape_fused (body _kernel): qe -> K = Phi qe -> Picard
//      s = G(-dn_in ⊗ q0) + G (1/2 A(K)) s with q0 = (1,0,0,0) -> tangent
//      b = R(s) e1, or R(s)(e1 + gamma) for na = 6 (unnormalized R) ->
//      position r = G b (r0 = 0);
//   K2 picard_correction_fused (body _corr_kernel): x = G rhs + G (1/2 A(K)) x
//      for a per-rod rhs; reads only the 3 curvature components of qe;
//   K4 rod_shape_fused_bc (body _kernel_bc, pallas_call :508): K1 with per-rod
//      boundary values q0 (B,4) and r0 (B,3).  G(-dn_in ⊗ q0) = gvec ⊗ q0 with
//      K1's constant gvec = G(-dn_in), so point i starts from gvec_i q0 and the
//      position is r = G b + gvec ⊗ r0.  The TPU body built -dn_in ⊗ q0 from
//      outer-product row blocks; here it is one product per component.
//
// Bound on an H100: ~21,600 f32 multiply-adds per rod at N=16 (20 Picard
// steps of 4 (n-1)^2 in the product with G and 12 (n-1) in A(K/2)) against
// ~456 bytes of device traffic, so operations bound.  Design: the narrow
// tensor-core core (narrow_tc.cuh): every Picard step of a warp's 8 or 16
// rods is one 3xTF32 mma.sync product whose state never leaves the
// registers; only qe, q0, r0, rhs and the outputs touch device memory.
// K1/K4: S = gvec ⊗ q0 + G T; the tangent b on the accumulators; the position
// r = gvec ⊗ r0 + G b is one more product (b's fourth component zero).  K2:
// x = G (rhs + A(K/2) x), iters + 1 products from x = 0 (the plain version's
// fixed point x = G rhs + G A(K/2) x), rhs read once into the thread's
// registers.  K = Phi qe is f32 from ptab, as in the plain version.
//
// C interface (ctypes): device pointers, ints, the stream as void*; each entry
// returns cudaGetLastError() after its launch, cudaErrorInvalidValue for
// arguments it does not take.  Operators are zero-padded to P points by the
// caller: gtp (3, P, P) is G^T with its rows in narrow_tc.cuh's k order, then its
// TF32 hi and lo planes; ptab is P x ne, gvec P.
#include "narrow_tc.cuh"

namespace {

using namespace narrow;

// K1 (BC = false: q0 = (1,0,0,0), r0 = 0) and K4 (BC = true: q0 and r0 per
// rod, q0 not normalised) share this body.
template <int P, int NA, bool BC>
__global__ void __launch_bounds__(Shape<P>::kThreads, Shape<P>::kMinBlocks)
rod_shape_fused_kernel(const float* __restrict__ qes, const float* __restrict__ q0s,
                       const float* __restrict__ r0s, int batch, int npts, int ne,
                       const float* __restrict__ gtp, const float* __restrict__ ptab,
                       const float* __restrict__ gvec, int iters,
                       float* __restrict__ q_out, float* __restrict__ r_out) {
    using C = Shape<P>;
    const Lane l = lane_of<C>();
    if (l.rod0 >= batch) return;   // the whole warp is past the batch
    Operator<C> op;
    load_operator<C>(op, gtp, l);
    float kh[C::H][C::NB][2][3];
    strain3<C>(qes, ptab, batch, NA * ne, ne, 0, l, kh);
    for_pairs<C>([&](int h, int nb, int e) {
#pragma unroll
        for (int a = 0; a < 3; ++a) kh[h][nb][e][a] *= 0.5f;
    });

    // The boundary terms gvec ⊗ q0 and gvec ⊗ r0, formed per pair.
    float gv[C::NB][2];
#pragma unroll
    for (int nb = 0; nb < C::NB; ++nb)
#pragma unroll
        for (int e = 0; e < 2; ++e) gv[nb][e] = __ldg(gvec + l.point(nb, e));
    float q0[C::H][4], r0[C::H][3];
#pragma unroll
    for (int h = 0; h < C::H; ++h) {
        const long long rod = l.rod(h);
        const bool live = BC && rod < batch;
        const float4 q = live ? __ldg(reinterpret_cast<const float4*>(q0s) + rod)
                              : make_float4(1.f, 0.f, 0.f, 0.f);
        q0[h][0] = q.x;
        q0[h][1] = q.y;
        q0[h][2] = q.z;
        q0[h][3] = q.w;
#pragma unroll
        for (int c = 0; c < 3; ++c) r0[h][c] = live ? __ldg(r0s + rod * 3 + c) : 0.f;
    }
    // s = gvec ⊗ q0 + G T: the base is zero but in component 0 for K1.
    Tile<C> base, acc;
    for_pairs<C>([&](int h, int nb, int e) {
#pragma unroll
        for (int c = 0; c < 4; ++c) at<C>(base, h, nb, e, c) = gv[nb][e] * q0[h][c];
    });
    const auto add_base = [&]() {
        for_pairs<C>([&](int h, int nb, int e) {
#pragma unroll
            for (int c = 0; c < (BC ? 4 : 1); ++c)
                at<C>(acc, h, nb, e, c) += at<C>(base, h, nb, e, c);
        });
    };
    for_pairs<C>([&](int h, int nb, int e) {
#pragma unroll
        for (int c = 0; c < 4; ++c) at<C>(acc, h, nb, e, c) = at<C>(base, h, nb, e, c);
    });
    for (int it = 0; it < iters; ++it) {
        product<C>(op, [&](int h, int nb, int e) {
            return tc::a_apply(kh[h][nb][e], at4<C>(acc, h, nb, e));
        }, acc);
        add_base();
    }

    for_pairs<C>([&](int h, int nb, int e) {
        const long long rod = l.rod(h);
        const int i = l.point(nb, e);
        if (rod < batch && i < npts)
            reinterpret_cast<float4*>(q_out)[rod * npts + i] = at4<C>(acc, h, nb, e);
    });

    // The unnormalized tangent b (main.cpp:130-136), Reissner form for
    // na = 6, and the position r = gvec ⊗ r0 + G b.
    float gam[C::H][C::NB][2][3];   // (epsilon, gamma_1, gamma_2) - (1, 0, 0)
    if constexpr (NA == 6) strain3<C>(qes, ptab, batch, NA * ne, ne, 3, l, gam);
    const auto tangent = [&](int h, int nb, int e) {
        const float4 s = at4<C>(acc, h, nb, e);
        const float w = s.x, x = s.y, y = s.z, z = s.w;
        const float r00 = 1.f - 2.f * (y * y + z * z);
        const float r10 = 2.f * (x * y + w * z);
        const float r20 = 2.f * (x * z - w * y);
        if constexpr (NA == 6) {
            const float e0 = 1.f + gam[h][nb][e][0], g1 = gam[h][nb][e][1];
            const float g2 = gam[h][nb][e][2];
            const float r01 = 2.f * (x * y - w * z), r02 = 2.f * (x * z + w * y);
            const float r11 = 1.f - 2.f * (x * x + z * z), r12 = 2.f * (y * z - w * x);
            const float r21 = 2.f * (y * z + w * x), r22 = 1.f - 2.f * (x * x + y * y);
            return make_float4(r00 * e0 + r01 * g1 + r02 * g2, r10 * e0 + r11 * g1 + r12 * g2,
                               r20 * e0 + r21 * g1 + r22 * g2, 0.f);
        }
        return make_float4(r00, r10, r20, 0.f);
    };
    product<C>(op, tangent, acc);
    if constexpr (BC) {
        for_pairs<C>([&](int h, int nb, int e) {
#pragma unroll
            for (int c = 0; c < 3; ++c) at<C>(acc, h, nb, e, c) += gv[nb][e] * r0[h][c];
        });
    }
    for_pairs<C>([&](int h, int nb, int e) {
        const long long rod = l.rod(h);
        const int i = l.point(nb, e);
        if (rod < batch && i < npts) {
            const long long out = (rod * npts + i) * 3;
#pragma unroll
            for (int c = 0; c < 3; ++c) r_out[out + c] = at<C>(acc, h, nb, e, c);
        }
    });
}

template <int P>
__global__ void __launch_bounds__(Shape<P>::kThreads, Shape<P>::kMinBlocks)
picard_correction_kernel(const float* __restrict__ qes, int batch, int npts, int nq,
                         int ne, const float* __restrict__ gtp,
                         const float* __restrict__ ptab, const float* __restrict__ rhs,
                         int iters, float* __restrict__ x_out) {
    using C = Shape<P>;
    const Lane l = lane_of<C>();
    if (l.rod0 >= batch) return;   // the whole warp is past the batch
    Operator<C> op;
    load_operator<C>(op, gtp, l);
    // Only the 3 curvature components drive the quaternion ODE.
    float kh[C::H][C::NB][2][3];
    strain3<C>(qes, ptab, batch, nq, ne, 0, l, kh);
    for_pairs<C>([&](int h, int nb, int e) {
#pragma unroll
        for (int a = 0; a < 3; ++a) kh[h][nb][e][a] *= 0.5f;
    });

    Tile<C> b, x;
    for_pairs<C>([&](int h, int nb, int e) {
        const long long rod = l.rod(h);
        const int i = l.point(nb, e);
        put4<C>(b, h, nb, e, rod < batch && i < npts
                                     ? __ldg(reinterpret_cast<const float4*>(rhs) + rod * npts + i)
                                     : make_float4(0.f, 0.f, 0.f, 0.f));
        put4<C>(x, h, nb, e, make_float4(0.f, 0.f, 0.f, 0.f));
    });
    // x = G (rhs + A(K/2) x): iters + 1 products from x = 0, the first G rhs.
    for (int it = 0; it <= iters; ++it) {
        product<C>(op, [&](int h, int nb, int e) {
            const float4 v = at4<C>(b, h, nb, e);
            const float4 t = tc::a_apply(kh[h][nb][e], at4<C>(x, h, nb, e));
            return make_float4(v.x + t.x, v.y + t.y, v.z + t.z, v.w + t.w);
        }, x);
    }

    for_pairs<C>([&](int h, int nb, int e) {
        const long long rod = l.rod(h);
        const int i = l.point(nb, e);
        if (rod < batch && i < npts)
            reinterpret_cast<float4*>(x_out)[rod * npts + i] = at4<C>(x, h, nb, e);
    });
}

template <int P, bool BC>
int launch_fused(const float* qes, const float* q0, const float* r0, int batch, int npts,
                 int na, int ne, const float* gtp, const float* ptab, const float* gvec,
                 int iters, float* q, float* r, cudaStream_t stream) {
    if (na == 6) {
        return launch<Shape<P>>(rod_shape_fused_kernel<P, 6, BC>, batch, stream, qes, q0, r0,
                                batch, npts, ne, gtp, ptab, gvec, iters, q, r);
    }
    return launch<Shape<P>>(rod_shape_fused_kernel<P, 3, BC>, batch, stream, qes, q0, r0, batch,
                            npts, ne, gtp, ptab, gvec, iters, q, r);
}

template <bool BC>
int fused_entry(const float* qes, const float* q0, const float* r0, int batch, int npts,
                int p, int na, int ne, const float* gtp, const float* ptab, const float* gvec,
                int iters, float* q_out, float* r_out, void* stream) {
    if (!valid_width(p, npts) || batch <= 0 || (na != 3 && na != 6) || ne < 1 ||
        iters < 0 || (BC && (q0 == nullptr || r0 == nullptr))) {
        return (int)cudaErrorInvalidValue;
    }
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    switch (p) {
        case 8: return launch_fused<8, BC>(qes, q0, r0, batch, npts, na, ne, gtp, ptab, gvec, iters, q_out, r_out, s);
        case 16: return launch_fused<16, BC>(qes, q0, r0, batch, npts, na, ne, gtp, ptab, gvec, iters, q_out, r_out, s);
        default: return launch_fused<32, BC>(qes, q0, r0, batch, npts, na, ne, gtp, ptab, gvec, iters, q_out, r_out, s);
    }
}

template <int P>
int launch_correction(const float* qes, int batch, int npts, int nq, int ne,
                      const float* gtp, const float* ptab, const float* rhs, int iters,
                      float* x, cudaStream_t stream) {
    return launch<Shape<P>>(picard_correction_kernel<P>, batch, stream, qes, batch, npts, nq, ne,
                            gtp, ptab, rhs, iters, x);
}

}  // namespace

extern "C" int rod_shape_fused_f32(const float* qes, int batch, int npts, int p, int na,
                                   int ne, const float* gtp, const float* ptab,
                                   const float* gvec, int iters, float* q_out,
                                   float* r_out, void* stream) {
    return fused_entry<false>(qes, nullptr, nullptr, batch, npts, p, na, ne, gtp, ptab, gvec,
                              iters, q_out, r_out, stream);
}

// q0 (B, 4) and r0 (B, 3) contiguous f32; q0 16-byte aligned.
extern "C" int rod_shape_fused_bc_f32(const float* qes, const float* q0, const float* r0,
                                      int batch, int npts, int p, int na, int ne,
                                      const float* gtp, const float* ptab, const float* gvec,
                                      int iters, float* q_out, float* r_out, void* stream) {
    return fused_entry<true>(qes, q0, r0, batch, npts, p, na, ne, gtp, ptab, gvec, iters,
                             q_out, r_out, stream);
}

extern "C" int picard_correction_f32(const float* qes, int batch, int npts, int p, int nq,
                                     int ne, const float* gtp, const float* ptab,
                                     const float* rhs, int iters, float* x_out,
                                     void* stream) {
    if (!valid_width(p, npts) || batch <= 0 || ne < 1 || nq < 3 * ne || iters < 0) {
        return (int)cudaErrorInvalidValue;
    }
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    switch (p) {
        case 8: return launch_correction<8>(qes, batch, npts, nq, ne, gtp, ptab, rhs, iters, x_out, s);
        case 16: return launch_correction<16>(qes, batch, npts, nq, ne, gtp, ptab, rhs, iters, x_out, s);
        default: return launch_correction<32>(qes, batch, npts, nq, ne, gtp, ptab, rhs, iters, x_out, s);
    }
}
