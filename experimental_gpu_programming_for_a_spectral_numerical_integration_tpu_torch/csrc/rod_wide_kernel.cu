// K1 wide, K2 wide and K4 wide: the fused f32 rod solve, the general
// right-hand-side Picard solve and the fused solve with per-rod boundary values
// on grids with 32 < n-1 <= 512 points.
//
// Replaces the wide and paired bodies of the JAX package's Pallas TPU kernels
// in ops/pallas/rod_kernel.py, which differ only in how they pack rods onto
// 128-lane tiles:
//   K1 wide: _rod_shape_fused_wide (pallas_call in _wide_call, :738) and
//      _rod_shape_fused_pair (pallas_call in _pair_call, :997): qe -> K = Phi qe
//      -> Picard s = G(-dn_in ⊗ q0) + G (1/2 A(K)) s with q0 = (1,0,0,0) ->
//      tangent b = R(s) e1, or R(s)(e1 + gamma) for na = 6 (unnormalized R) ->
//      position r = G b (r0 = 0);
//   K2 wide: _picard_correction_fused_wide (:738) and
//      _picard_correction_fused_pair (:997): x = G rhs + G (1/2 A(K)) x for a
//      per-rod rhs; reads only the 3 curvature components of qe;
//   K4 wide: _rod_shape_fused_bc_wide (:769, pallas_call in _wide_call :738) and
//      _rod_shape_fused_bc_pair (:1028, in _pair_call :997): K1 wide with per-rod
//      q0 (B,4) and r0 (B,3); G(-dn_in ⊗ q0) = gvec ⊗ q0, so point i starts
//      from gvec_i q0, and the position is r = G b + gvec ⊗ r0 (q0 is not
//      normalised, as in the JAX package).
// The ½ is folded into K and the full G is used (the TPU bodies use W = G/2
// and a x2 tangent); the result is the same.
//
// Bound on an H100: a Picard step costs 4 (n-1)^2 FP32 FMAs per rod; K1 at
// n=64 with 20 steps is ~318k FMAs per rod against 9 floats in and 7 (n-1)
// floats out, so it is FP32-FMA bound (B=32768: >= 0.31 ms at 67 TFLOP/s).
// Design (wide_common.cuh): a block of 256 threads holds R rods, each thread
// TM points of one rod in registers; a Picard step writes A(K/2)s into a
// shared-memory panel, synchronises, and forms G * panel with G^T streamed
// through L1/L2 (TM-wide vector loads, one broadcast panel load per 4 TM
// FMAs).  G does not fit in shared memory beyond n-1 = 128.  Plain FP32 FMA
// arithmetic for every precision value.
//
// C interface (ctypes): device pointers, ints, the stream as void*; each entry
// returns cudaGetLastError() after its launch, cudaErrorInvalidValue for
// arguments it does not take.  Operators are zero-padded to P x P (gt = G^T),
// P x ne (ptab) and P (gvec) by the caller.
#include "wide_common.cuh"

namespace {

using namespace wide;

// Strain component a at point i: K_a = sum_e P_e(x_i) qe[a*ne + e].
__device__ __forceinline__ float strain(const float* __restrict__ qe_rod,
                                        const float* __restrict__ ptab, int ne, int i,
                                        int a) {
    float k = 0.f;
    for (int e = 0; e < ne; ++e) k = fmaf(ptab[i * ne + e], qe_rod[a * ne + e], k);
    return k;
}

// K1 wide (BC = false: q0 = (1,0,0,0), r0 = 0) and K4 wide (BC = true) share
// this body.
template <int P, int NA, bool BC>
__global__ void __launch_bounds__(kThreads)
rod_shape_fused_wide_kernel(const float* __restrict__ qes, const float* __restrict__ q0s,
                            const float* __restrict__ r0s, int batch, int npts, int ne,
                            const float* __restrict__ gt, const float* __restrict__ ptab,
                            const float* __restrict__ gvec, int iters,
                            float* __restrict__ q_out, float* __restrict__ r_out) {
    using L = Layout<P>;
    constexpr int TM = L::TM, R = L::R;
    __shared__ float4 panel[P * R];
    const int rod = threadIdx.x % R;
    const int i0 = (threadIdx.x / R) * TM;
    const long long gid = (long long)blockIdx.x * R + rod;
    const bool live = gid < batch;
    const float* qe_rod = qes + gid * (NA * ne);

    float4 q0 = make_float4(1.f, 0.f, 0.f, 0.f);
    float r0[3] = {0.f, 0.f, 0.f};
    if constexpr (BC) {
        if (live) {
            q0 = reinterpret_cast<const float4*>(q0s)[gid];
#pragma unroll
            for (int c = 0; c < 3; ++c) r0[c] = r0s[gid * 3 + c];
        }
    }
    float kh[TM][3];
    float4 g_rhs[TM];
#pragma unroll
    for (int m = 0; m < TM; ++m) {
#pragma unroll
        for (int a = 0; a < 3; ++a) {
            kh[m][a] = live ? 0.5f * strain(qe_rod, ptab, ne, i0 + m, a) : 0.f;
        }
        const float gv = gvec[i0 + m];
        if constexpr (BC) {
            g_rhs[m] = make_float4(gv * q0.x, gv * q0.y, gv * q0.z, gv * q0.w);
        } else {
            g_rhs[m] = make_float4(gv, 0.f, 0.f, 0.f);
        }
    }

    float4 s[TM];
    picard<P>(gt, panel, npts, i0, rod, kh, g_rhs, iters, s);

    // Unnormalized tangent (main.cpp:130-136), Reissner form for na = 6.
    float4 b[TM], base[TM];
#pragma unroll
    for (int m = 0; m < TM; ++m) {
        const float w = s[m].x, x = s[m].y, y = s[m].z, z = s[m].w;
        const float r00 = 1.f - 2.f * (y * y + z * z);
        const float r10 = 2.f * (x * y + w * z);
        const float r20 = 2.f * (x * z - w * y);
        if constexpr (NA == 6) {
            const int i = i0 + m;
            const float e0 = live ? 1.f + strain(qe_rod, ptab, ne, i, 3) : 1.f;
            const float g1 = live ? strain(qe_rod, ptab, ne, i, 4) : 0.f;
            const float g2 = live ? strain(qe_rod, ptab, ne, i, 5) : 0.f;
            const float r01 = 2.f * (x * y - w * z), r02 = 2.f * (x * z + w * y);
            const float r11 = 1.f - 2.f * (x * x + z * z), r12 = 2.f * (y * z - w * x);
            const float r21 = 2.f * (y * z + w * x), r22 = 1.f - 2.f * (x * x + y * y);
            b[m] = make_float4(r00 * e0 + r01 * g1 + r02 * g2,
                               r10 * e0 + r11 * g1 + r12 * g2,
                               r20 * e0 + r21 * g1 + r22 * g2, 0.f);
        } else {
            b[m] = make_float4(r00, r10, r20, 0.f);
        }
        // The position r = G b + gvec ⊗ r0 starts from the boundary term.
        const float gv = BC ? gvec[i0 + m] : 0.f;
        base[m] = make_float4(gv * r0[0], gv * r0[1], gv * r0[2], 0.f);
    }
    float4 r[TM];
    g_times<P>(gt, panel, npts, i0, rod, b, base, r);

    if (live) {
#pragma unroll
        for (int m = 0; m < TM; ++m) {
            const int i = i0 + m;
            if (i < npts) {
                const long long at = gid * npts + i;
                reinterpret_cast<float4*>(q_out)[at] = s[m];
                r_out[at * 3 + 0] = r[m].x;
                r_out[at * 3 + 1] = r[m].y;
                r_out[at * 3 + 2] = r[m].z;
            }
        }
    }
}

template <int P>
__global__ void __launch_bounds__(kThreads)
picard_correction_wide_kernel(const float* __restrict__ qes, int batch, int npts, int nq,
                              int ne, const float* __restrict__ gt,
                              const float* __restrict__ ptab, const float* __restrict__ rhs,
                              int iters, float* __restrict__ x_out) {
    using L = Layout<P>;
    constexpr int TM = L::TM, R = L::R;
    __shared__ float4 panel[P * R];
    const int rod = threadIdx.x % R;
    const int i0 = (threadIdx.x / R) * TM;
    const long long gid = (long long)blockIdx.x * R + rod;
    const bool live = gid < batch;
    const float* qe_rod = qes + gid * nq;

    // Only the 3 curvature components drive the quaternion ODE.
    float kh[TM][3];
    float4 v[TM], zero[TM];
#pragma unroll
    for (int m = 0; m < TM; ++m) {
        const int i = i0 + m;
#pragma unroll
        for (int a = 0; a < 3; ++a) {
            kh[m][a] = live ? 0.5f * strain(qe_rod, ptab, ne, i, a) : 0.f;
        }
        v[m] = (live && i < npts) ? reinterpret_cast<const float4*>(rhs)[gid * npts + i]
                                  : make_float4(0.f, 0.f, 0.f, 0.f);
        zero[m] = make_float4(0.f, 0.f, 0.f, 0.f);
    }
    float4 g_rhs[TM], x[TM];
    g_times<P>(gt, panel, npts, i0, rod, v, zero, g_rhs);
    picard<P>(gt, panel, npts, i0, rod, kh, g_rhs, iters, x);

    if (live) {
#pragma unroll
        for (int m = 0; m < TM; ++m) {
            const int i = i0 + m;
            if (i < npts) reinterpret_cast<float4*>(x_out)[gid * npts + i] = x[m];
        }
    }
}

template <int P, bool BC>
void launch_fused(const float* qes, const float* q0, const float* r0, int batch, int npts,
                  int na, int ne, const float* gt, const float* ptab, const float* gvec,
                  int iters, float* q, float* r, cudaStream_t stream) {
    const int blocks = blocks_for(batch, Layout<P>::R);
    if (na == 6) {
        rod_shape_fused_wide_kernel<P, 6, BC><<<blocks, kThreads, 0, stream>>>(
            qes, q0, r0, batch, npts, ne, gt, ptab, gvec, iters, q, r);
    } else {
        rod_shape_fused_wide_kernel<P, 3, BC><<<blocks, kThreads, 0, stream>>>(
            qes, q0, r0, batch, npts, ne, gt, ptab, gvec, iters, q, r);
    }
}

template <bool BC>
int fused_entry(const float* qes, const float* q0, const float* r0, int batch, int npts,
                int p, int na, int ne, const float* gt, const float* ptab, const float* gvec,
                int iters, float* q_out, float* r_out, void* stream) {
    if (!valid_width(p, npts) || batch <= 0 || (na != 3 && na != 6) || ne < 1 ||
        iters < 0 || (BC && (q0 == nullptr || r0 == nullptr))) {
        return (int)cudaErrorInvalidValue;
    }
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    switch (p) {
        case 64: launch_fused<64, BC>(qes, q0, r0, batch, npts, na, ne, gt, ptab, gvec, iters, q_out, r_out, s); break;
        case 128: launch_fused<128, BC>(qes, q0, r0, batch, npts, na, ne, gt, ptab, gvec, iters, q_out, r_out, s); break;
        case 256: launch_fused<256, BC>(qes, q0, r0, batch, npts, na, ne, gt, ptab, gvec, iters, q_out, r_out, s); break;
        default: launch_fused<512, BC>(qes, q0, r0, batch, npts, na, ne, gt, ptab, gvec, iters, q_out, r_out, s); break;
    }
    return (int)cudaGetLastError();
}

template <int P>
void launch_correction(const float* qes, int batch, int npts, int nq, int ne,
                       const float* gt, const float* ptab, const float* rhs, int iters,
                       float* x, cudaStream_t stream) {
    const int blocks = blocks_for(batch, Layout<P>::R);
    picard_correction_wide_kernel<P><<<blocks, kThreads, 0, stream>>>(
        qes, batch, npts, nq, ne, gt, ptab, rhs, iters, x);
}

}  // namespace

extern "C" int rod_shape_fused_wide_f32(const float* qes, int batch, int npts, int p,
                                        int na, int ne, const float* gt, const float* ptab,
                                        const float* gvec, int iters, float* q_out,
                                        float* r_out, void* stream) {
    return fused_entry<false>(qes, nullptr, nullptr, batch, npts, p, na, ne, gt, ptab, gvec,
                              iters, q_out, r_out, stream);
}

// q0 (B, 4) and r0 (B, 3) contiguous f32; q0 16-byte aligned.
extern "C" int rod_shape_fused_bc_wide_f32(const float* qes, const float* q0,
                                           const float* r0, int batch, int npts, int p,
                                           int na, int ne, const float* gt,
                                           const float* ptab, const float* gvec, int iters,
                                           float* q_out, float* r_out, void* stream) {
    return fused_entry<true>(qes, q0, r0, batch, npts, p, na, ne, gt, ptab, gvec, iters,
                             q_out, r_out, stream);
}

extern "C" int picard_correction_wide_f32(const float* qes, int batch, int npts, int p,
                                          int nq, int ne, const float* gt, const float* ptab,
                                          const float* rhs, int iters, float* x_out,
                                          void* stream) {
    if (!valid_width(p, npts) || batch <= 0 || ne < 1 || nq < 3 * ne || iters < 0) {
        return (int)cudaErrorInvalidValue;
    }
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    switch (p) {
        case 64: launch_correction<64>(qes, batch, npts, nq, ne, gt, ptab, rhs, iters, x_out, s); break;
        case 128: launch_correction<128>(qes, batch, npts, nq, ne, gt, ptab, rhs, iters, x_out, s); break;
        case 256: launch_correction<256>(qes, batch, npts, nq, ne, gt, ptab, rhs, iters, x_out, s); break;
        default: launch_correction<512>(qes, batch, npts, nq, ne, gt, ptab, rhs, iters, x_out, s); break;
    }
    return (int)cudaGetLastError();
}
