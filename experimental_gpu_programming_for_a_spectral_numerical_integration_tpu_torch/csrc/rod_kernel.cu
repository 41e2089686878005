// K1, K2 and K4: fused f32 rod solve, general right-hand-side Picard solve, and
// the fused solve with per-rod boundary values.
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
//      K1's constant gvec = G(-dn_in), so lane i starts from gvec_i q0 and the
//      position is r = G b + gvec ⊗ r0.  The TPU body built -dn_in ⊗ q0 from
//      outer-product row blocks; here it is one product per component.
//
// Bound on an H100: ~21,600 FP32 FMAs per rod at N=16 against ~456 bytes of
// device traffic, so FP32-FMA bound.  Design: one group of P lanes per rod
// (rod_common.cuh), lane i holds point i's state, strain and row i of G in
// registers; a Picard step exchanges A(K/2)s through shared memory and costs
// each lane 12 + 4P FMAs and P broadcast loads.  Only qe, rhs and the outputs
// touch device memory.  Plain FP32 FMA arithmetic for every precision value.
//
// C interface (ctypes): device pointers, ints, the stream as void*; each entry
// returns cudaGetLastError() after its launch, cudaErrorInvalidValue for
// arguments it does not take.  Operators are zero-padded to P x P (g), P x ne
// (ptab) and P (gvec) by the caller.
#include "rod_common.cuh"

namespace {

using namespace rod;

// K1 (BC = false: q0 = (1,0,0,0), r0 = 0) and K4 (BC = true: q0 and r0 per
// rod, q0 not normalised) share this body.
template <int P, int NA, bool BC>
__global__ void __launch_bounds__(kThreads)
rod_shape_fused_kernel(const float* __restrict__ qes, const float* __restrict__ q0s,
                       const float* __restrict__ r0s, int batch, int npts, int ne,
                       const float* __restrict__ gmat, const float* __restrict__ ptab,
                       const float* __restrict__ gvec, int iters,
                       float* __restrict__ q_out, float* __restrict__ r_out) {
    __shared__ float4 slots[Slots<P>::kSize];
    const int lane = threadIdx.x % P;
    const int group = threadIdx.x / P;
    const long long rod = (long long)blockIdx.x * Slots<P>::kGroups + group;
    const bool live = rod < batch;
    float4* slot = slots + group * Slots<P>::kStride;

    float g[P];
    load_row<P>(gmat, lane, g);

    // Strain at this lane's point: K_a = sum_e P_e(x_i) qe[a*ne + e].
    float k[NA];
#pragma unroll
    for (int a = 0; a < NA; ++a) {
        k[a] = 0.f;
        if (live) {
            for (int e = 0; e < ne; ++e) {
                k[a] = fmaf(ptab[lane * ne + e], qes[rod * (NA * ne) + a * ne + e], k[a]);
            }
        }
    }

    float4 g_rhs = make_float4(gvec[lane], 0.f, 0.f, 0.f);
    float r0[3] = {0.f, 0.f, 0.f};
    if constexpr (BC) {
        if (live) {
            const float4 q0 = reinterpret_cast<const float4*>(q0s)[rod];
            const float gv = gvec[lane];
            g_rhs = make_float4(gv * q0.x, gv * q0.y, gv * q0.z, gv * q0.w);
#pragma unroll
            for (int c = 0; c < 3; ++c) r0[c] = gvec[lane] * r0s[rod * 3 + c];
        }
    }
    const float4 s = picard<P>(g, slot, lane, 0.5f * k[0], 0.5f * k[1], 0.5f * k[2],
                               g_rhs, iters);

    // Unnormalized tangent (main.cpp:130-136), Reissner form for na = 6.
    const float w = s.x, x = s.y, y = s.z, z = s.w;
    const float r00 = 1.f - 2.f * (y * y + z * z);
    const float r10 = 2.f * (x * y + w * z);
    const float r20 = 2.f * (x * z - w * y);
    float4 b;
    if constexpr (NA == 6) {
        const float e0 = 1.f + k[3], g1 = k[4], g2 = k[5];
        const float r01 = 2.f * (x * y - w * z), r02 = 2.f * (x * z + w * y);
        const float r11 = 1.f - 2.f * (x * x + z * z), r12 = 2.f * (y * z - w * x);
        const float r21 = 2.f * (y * z + w * x), r22 = 1.f - 2.f * (x * x + y * y);
        b = make_float4(r00 * e0 + r01 * g1 + r02 * g2,
                        r10 * e0 + r11 * g1 + r12 * g2,
                        r20 * e0 + r21 * g1 + r22 * g2, 0.f);
    } else {
        b = make_float4(r00, r10, r20, 0.f);
    }
    float4 r = g_times<P>(g, slot, lane, b);
    if constexpr (BC) {
        r.x += r0[0];
        r.y += r0[1];
        r.z += r0[2];
    }

    if (live && lane < npts) {
        const long long at = rod * npts + lane;
        reinterpret_cast<float4*>(q_out)[at] = s;
        r_out[at * 3 + 0] = r.x;
        r_out[at * 3 + 1] = r.y;
        r_out[at * 3 + 2] = r.z;
    }
}

template <int P>
__global__ void __launch_bounds__(kThreads)
picard_correction_kernel(const float* __restrict__ qes, int batch, int npts, int nq,
                         int ne, const float* __restrict__ gmat,
                         const float* __restrict__ ptab, const float* __restrict__ rhs,
                         int iters, float* __restrict__ x_out) {
    __shared__ float4 slots[Slots<P>::kSize];
    const int lane = threadIdx.x % P;
    const int group = threadIdx.x / P;
    const long long rod = (long long)blockIdx.x * Slots<P>::kGroups + group;
    const bool live = rod < batch;
    const bool point = live && lane < npts;
    float4* slot = slots + group * Slots<P>::kStride;

    float g[P];
    load_row<P>(gmat, lane, g);

    // Only the 3 curvature components drive the quaternion ODE.
    float k[3];
#pragma unroll
    for (int a = 0; a < 3; ++a) {
        k[a] = 0.f;
        if (live) {
            for (int e = 0; e < ne; ++e) {
                k[a] = fmaf(ptab[lane * ne + e], qes[rod * nq + a * ne + e], k[a]);
            }
        }
    }

    const float4 v = point ? reinterpret_cast<const float4*>(rhs)[rod * npts + lane]
                           : make_float4(0.f, 0.f, 0.f, 0.f);
    const float4 g_rhs = g_times<P>(g, slot, lane, v);
    const float4 x = picard<P>(g, slot, lane, 0.5f * k[0], 0.5f * k[1], 0.5f * k[2],
                               g_rhs, iters);
    if (point) reinterpret_cast<float4*>(x_out)[rod * npts + lane] = x;
}

template <int P, bool BC>
void launch_fused(const float* qes, const float* q0, const float* r0, int batch, int npts,
                  int na, int ne, const float* g, const float* ptab, const float* gvec,
                  int iters, float* q, float* r, cudaStream_t stream) {
    const int blocks = blocks_for(batch, P);
    if (na == 6) {
        rod_shape_fused_kernel<P, 6, BC><<<blocks, kThreads, 0, stream>>>(
            qes, q0, r0, batch, npts, ne, g, ptab, gvec, iters, q, r);
    } else {
        rod_shape_fused_kernel<P, 3, BC><<<blocks, kThreads, 0, stream>>>(
            qes, q0, r0, batch, npts, ne, g, ptab, gvec, iters, q, r);
    }
}

template <bool BC>
int fused_entry(const float* qes, const float* q0, const float* r0, int batch, int npts,
                int p, int na, int ne, const float* g, const float* ptab, const float* gvec,
                int iters, float* q_out, float* r_out, void* stream) {
    if (!valid_lanes(p, npts) || batch <= 0 || (na != 3 && na != 6) || ne < 1 ||
        iters < 0 || (BC && (q0 == nullptr || r0 == nullptr))) {
        return (int)cudaErrorInvalidValue;
    }
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    switch (p) {
        case 8: launch_fused<8, BC>(qes, q0, r0, batch, npts, na, ne, g, ptab, gvec, iters, q_out, r_out, s); break;
        case 16: launch_fused<16, BC>(qes, q0, r0, batch, npts, na, ne, g, ptab, gvec, iters, q_out, r_out, s); break;
        default: launch_fused<32, BC>(qes, q0, r0, batch, npts, na, ne, g, ptab, gvec, iters, q_out, r_out, s); break;
    }
    return (int)cudaGetLastError();
}

template <int P>
void launch_correction(const float* qes, int batch, int npts, int nq, int ne,
                       const float* g, const float* ptab, const float* rhs, int iters,
                       float* x, cudaStream_t stream) {
    const int blocks = blocks_for(batch, P);
    picard_correction_kernel<P><<<blocks, kThreads, 0, stream>>>(
        qes, batch, npts, nq, ne, g, ptab, rhs, iters, x);
}

}  // namespace

extern "C" int rod_shape_fused_f32(const float* qes, int batch, int npts, int p, int na,
                                   int ne, const float* g, const float* ptab,
                                   const float* gvec, int iters, float* q_out,
                                   float* r_out, void* stream) {
    return fused_entry<false>(qes, nullptr, nullptr, batch, npts, p, na, ne, g, ptab, gvec,
                              iters, q_out, r_out, stream);
}

// q0 (B, 4) and r0 (B, 3) contiguous f32; q0 16-byte aligned.
extern "C" int rod_shape_fused_bc_f32(const float* qes, const float* q0, const float* r0,
                                      int batch, int npts, int p, int na, int ne,
                                      const float* g, const float* ptab, const float* gvec,
                                      int iters, float* q_out, float* r_out, void* stream) {
    return fused_entry<true>(qes, q0, r0, batch, npts, p, na, ne, g, ptab, gvec, iters,
                             q_out, r_out, stream);
}

extern "C" int picard_correction_f32(const float* qes, int batch, int npts, int p, int nq,
                                     int ne, const float* g, const float* ptab,
                                     const float* rhs, int iters, float* x_out,
                                     void* stream) {
    if (!valid_lanes(p, npts) || batch <= 0 || ne < 1 || nq < 3 * ne || iters < 0) {
        return (int)cudaErrorInvalidValue;
    }
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    switch (p) {
        case 8: launch_correction<8>(qes, batch, npts, nq, ne, g, ptab, rhs, iters, x_out, s); break;
        case 16: launch_correction<16>(qes, batch, npts, nq, ne, g, ptab, rhs, iters, x_out, s); break;
        default: launch_correction<32>(qes, batch, npts, nq, ne, g, ptab, rhs, iters, x_out, s); break;
    }
    return (int)cudaGetLastError();
}
