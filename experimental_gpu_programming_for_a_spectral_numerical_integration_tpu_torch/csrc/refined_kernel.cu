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
// Bound on an H100: two f32 Picard loops (~43,000 FP32 FMAs per rod at
// N=16) plus ~1,600 FP64 FMAs against ~72 bytes in and 840 bytes out: FMA
// bound.  Design: K1's (rod_common.cuh) with Dn_NN and G in FP64 in shared
// memory, transposed so that lane i reading column j touches consecutive
// doubles.
//
// C interface as rod_kernel.cu; qes_lo, q0_lo and r0_lo may be NULL (zero low
// words) and rho2_limit < 0 disables the sentinel.
#include "refined_bc.cuh"
#include "rod_common.cuh"

namespace {

using namespace rod;
using namespace refined_bc;

__device__ __forceinline__ void split(double v, float& hi, float& lo) {
    hi = __double2float_rn(v);
    lo = __double2float_rn(v - (double)hi);
}

template <int P, int NA, bool BC>
__global__ void __launch_bounds__(kThreads)
rod_shape_refined_kernel(const float* __restrict__ qes_hi, const float* __restrict__ qes_lo,
                         int batch, int npts, int ne, const float* __restrict__ g32,
                         const float* __restrict__ gvec32, const double* __restrict__ g64,
                         const double* __restrict__ dn64, const double* __restrict__ ptab64,
                         const double* __restrict__ din64, Boundary bc, int iters,
                         int corr_iters, float rho2_limit, float* __restrict__ q_hi,
                         float* __restrict__ q_lo, float* __restrict__ r_hi,
                         float* __restrict__ r_lo) {
    __shared__ double gt64[P * P];   // gt64[j*P + i] = G[i][j]
    __shared__ double dt64[P * P];   // dt64[j*P + i] = Dn_NN[i][j]
    __shared__ float4 slots[Slots<P>::kSize];
    __shared__ double slots64[Slots<P>::kSize * 4];

    for (int idx = threadIdx.x; idx < P * P; idx += kThreads) {
        const int i = idx / P, j = idx % P;
        gt64[j * P + i] = g64[idx];
        dt64[j * P + i] = dn64[idx];
    }
    __syncthreads();

    const int lane = threadIdx.x % P;
    const int group = threadIdx.x / P;
    const long long rod = (long long)blockIdx.x * Slots<P>::kGroups + group;
    const bool live = rod < batch;
    float4* slot = slots + group * Slots<P>::kStride;
    double* slot64 = slots64 + 4 * group * Slots<P>::kStride;

    float g[P];
    load_row<P>(g32, lane, g);

    // 1. strain in FP64 from both words of qe.
    double k[NA];
#pragma unroll
    for (int a = 0; a < NA; ++a) {
        k[a] = 0.0;
        if (live) {
            for (int e = 0; e < ne; ++e) {
                const long long at = rod * (NA * ne) + a * ne + e;
                double qe = (double)qes_hi[at];
                if (qes_lo != nullptr) qe += (double)qes_lo[at];
                k[a] = fma(ptab64[lane * ne + e], qe, k[a]);
            }
        }
    }
    const double kh0 = 0.5 * k[0], kh1 = 0.5 * k[1], kh2 = 0.5 * k[2];
    const float f0 = (float)kh0, f1 = (float)kh1, f2 = (float)kh2;

    // K5's boundary values are read where they are used, to keep them out of
    // the register peak of the Picard loops: q0_hi here (the f32 base solve
    // starts from gvec32 ⊗ q0_hi), q0 for the residual, r0 for the position.
    float4 g_rhs = make_float4(gvec32[lane], 0.f, 0.f, 0.f);
    if constexpr (BC) {
        if (live) {
            const float4 qh = reinterpret_cast<const float4*>(bc.q0_hi)[rod];
            const float gv = gvec32[lane];
            g_rhs = make_float4(gv * qh.x, gv * qh.y, gv * qh.z, gv * qh.w);
        }
    }

    // 2. f32 base solve.
    const float4 s = picard<P>(g, slot, lane, f0, f1, f2, g_rhs, iters);

    // rho sentinel: max over the rod's points of |K/2|^2 (all lanes shuffle).
    const float rho2 = group_max<P>(f0 * f0 + f1 * f1 + f2 * f2);
    const bool bad = rho2_limit >= 0.f && rho2 > rho2_limit;

    // 3. FP64 residual rhs - Dn_NN s + A(K/2) s.
    slot[lane] = s;
    __syncwarp();
    double d0 = 0.0, d1 = 0.0, d2 = 0.0, d3 = 0.0;
#pragma unroll
    for (int j = 0; j < P; ++j) {
        const double dij = dt64[j * P + lane];
        const float4 t = slot[j];
        d0 = fma(dij, (double)t.x, d0);
        d1 = fma(dij, (double)t.y, d1);
        d2 = fma(dij, (double)t.z, d2);
        d3 = fma(dij, (double)t.w, d3);
    }
    __syncwarp();
    const double sw = s.x, sx = s.y, sy = s.z, sz = s.w;
    double res0, res1, res2, res3;
    if constexpr (BC) {   // rhs = -dn_in ⊗ q0, every component
        double q0[4] = {1.0, 0.0, 0.0, 0.0};
        if (live) {
#pragma unroll
            for (int c = 0; c < 4; ++c) q0[c] = pair_at(bc.q0_hi, bc.q0_lo, rod * 4 + c);
        }
        const double din = din64[lane];
        res0 = -din * q0[0] - d0 + (-kh0 * sx - kh1 * sy - kh2 * sz);
        res1 = -din * q0[1] - d1 + (kh0 * sw + kh2 * sy - kh1 * sz);
        res2 = -din * q0[2] - d2 + (kh1 * sw - kh2 * sx + kh0 * sz);
        res3 = -din * q0[3] - d3 + (kh2 * sw + kh1 * sx - kh0 * sy);
    } else {
        res0 = -din64[lane] - d0 + (-kh0 * sx - kh1 * sy - kh2 * sz);
        res1 = -d1 + (kh0 * sw + kh2 * sy - kh1 * sz);
        res2 = -d2 + (kh1 * sw - kh2 * sx + kh0 * sz);
        res3 = -d3 + (kh2 * sw + kh1 * sx - kh0 * sy);
    }

    // 4. f32 correction.
    const float4 g_res = g_times<P>(
        g, slot, lane, make_float4((float)res0, (float)res1, (float)res2, (float)res3));
    const float4 delta = picard<P>(g, slot, lane, f0, f1, f2, g_res, corr_iters);

    // 5. FP64 combine, tangent and position.
    const double w = sw + (double)delta.x, x = sx + (double)delta.y;
    const double y = sy + (double)delta.z, z = sz + (double)delta.w;
    const double r00 = 1.0 - 2.0 * (y * y + z * z);
    const double r10 = 2.0 * (x * y + w * z);
    const double r20 = 2.0 * (x * z - w * y);
    double b0 = r00, b1 = r10, b2 = r20;
    if constexpr (NA == 6) {
        const double e0 = 1.0 + k[3], g1 = k[4], g2 = k[5];
        const double r01 = 2.0 * (x * y - w * z), r02 = 2.0 * (x * z + w * y);
        const double r11 = 1.0 - 2.0 * (x * x + z * z), r12 = 2.0 * (y * z - w * x);
        const double r21 = 2.0 * (y * z + w * x), r22 = 1.0 - 2.0 * (x * x + y * y);
        b0 = r00 * e0 + r01 * g1 + r02 * g2;
        b1 = r10 * e0 + r11 * g1 + r12 * g2;
        b2 = r20 * e0 + r21 * g1 + r22 * g2;
    }
    slot64[4 * lane + 0] = b0;
    slot64[4 * lane + 1] = b1;
    slot64[4 * lane + 2] = b2;
    __syncwarp();
    double p0 = 0.0, p1 = 0.0, p2 = 0.0;
#pragma unroll
    for (int j = 0; j < P; ++j) {
        const double gij = gt64[j * P + lane];
        p0 = fma(gij, slot64[4 * j + 0], p0);
        p1 = fma(gij, slot64[4 * j + 1], p1);
        p2 = fma(gij, slot64[4 * j + 2], p2);
    }
    if constexpr (BC) {   // + gvec64 ⊗ r0, in FP64
        double r0[3] = {0.0, 0.0, 0.0};
        if (live) {
#pragma unroll
            for (int c = 0; c < 3; ++c) r0[c] = pair_at(bc.r0_hi, bc.r0_lo, rod * 3 + c);
        }
        const double gv = bc.gvec64[lane];
        p0 = fma(gv, r0[0], p0);
        p1 = fma(gv, r0[1], p1);
        p2 = fma(gv, r0[2], p2);
    }

    // 6. split, or poison the rod.
    if (live && lane < npts) {
        const long long at = rod * npts + lane;
        float4 qh, ql;
        float rh[3], rl[3];
        split(w, qh.x, ql.x);
        split(x, qh.y, ql.y);
        split(y, qh.z, ql.z);
        split(z, qh.w, ql.w);
        split(p0, rh[0], rl[0]);
        split(p1, rh[1], rl[1]);
        split(p2, rh[2], rl[2]);
        if (bad) {
            const float nan = __int_as_float(0x7fc00000);
            qh = ql = make_float4(nan, nan, nan, nan);
            rh[0] = rh[1] = rh[2] = rl[0] = rl[1] = rl[2] = nan;
        }
        reinterpret_cast<float4*>(q_hi)[at] = qh;
        reinterpret_cast<float4*>(q_lo)[at] = ql;
#pragma unroll
        for (int c = 0; c < 3; ++c) {
            r_hi[at * 3 + c] = rh[c];
            r_lo[at * 3 + c] = rl[c];
        }
    }
}

template <int P, bool BC>
void launch(const float* qes_hi, const float* qes_lo, int batch, int npts, int na, int ne,
            const float* g32, const float* gvec32, const double* g64, const double* dn64,
            const double* ptab64, const double* din64, Boundary bc, int iters,
            int corr_iters, float rho2_limit, float* q_hi, float* q_lo, float* r_hi,
            float* r_lo, cudaStream_t stream) {
    const int blocks = blocks_for(batch, P);
    if (na == 6) {
        rod_shape_refined_kernel<P, 6, BC><<<blocks, kThreads, 0, stream>>>(
            qes_hi, qes_lo, batch, npts, ne, g32, gvec32, g64, dn64, ptab64, din64, bc, iters,
            corr_iters, rho2_limit, q_hi, q_lo, r_hi, r_lo);
    } else {
        rod_shape_refined_kernel<P, 3, BC><<<blocks, kThreads, 0, stream>>>(
            qes_hi, qes_lo, batch, npts, ne, g32, gvec32, g64, dn64, ptab64, din64, bc, iters,
            corr_iters, rho2_limit, q_hi, q_lo, r_hi, r_lo);
    }
}

template <bool BC>
int refined_entry(const float* qes_hi, const float* qes_lo, int batch, int npts, int p,
                  int na, int ne, const float* g32, const float* gvec32, const double* g64,
                  const double* dn64, const double* ptab64, const double* din64,
                  Boundary bc, int iters, int corr_iters, double rho2_limit, float* q_hi,
                  float* q_lo, float* r_hi, float* r_lo, void* stream) {
    if (!valid_lanes(p, npts) || batch <= 0 || (na != 3 && na != 6) || ne < 1 ||
        iters < 0 || corr_iters < 0 ||
        (BC && (bc.q0_hi == nullptr || bc.r0_hi == nullptr || bc.gvec64 == nullptr))) {
        return (int)cudaErrorInvalidValue;
    }
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    const float limit = rho2_limit < 0.0 ? -1.f : (float)rho2_limit;
    switch (p) {
        case 8:
            launch<8, BC>(qes_hi, qes_lo, batch, npts, na, ne, g32, gvec32, g64, dn64, ptab64,
                          din64, bc, iters, corr_iters, limit, q_hi, q_lo, r_hi, r_lo, s);
            break;
        case 16:
            launch<16, BC>(qes_hi, qes_lo, batch, npts, na, ne, g32, gvec32, g64, dn64,
                           ptab64, din64, bc, iters, corr_iters, limit, q_hi, q_lo, r_hi,
                           r_lo, s);
            break;
        default:
            launch<32, BC>(qes_hi, qes_lo, batch, npts, na, ne, g32, gvec32, g64, dn64,
                           ptab64, din64, bc, iters, corr_iters, limit, q_hi, q_lo, r_hi,
                           r_lo, s);
            break;
    }
    return (int)cudaGetLastError();
}

}  // namespace

extern "C" int rod_shape_refined(const float* qes_hi, const float* qes_lo, int batch,
                                 int npts, int p, int na, int ne, const float* g32,
                                 const float* gvec32, const double* g64, const double* dn64,
                                 const double* ptab64, const double* din64, int iters,
                                 int corr_iters, double rho2_limit, float* q_hi,
                                 float* q_lo, float* r_hi, float* r_lo, void* stream) {
    return refined_entry<false>(qes_hi, qes_lo, batch, npts, p, na, ne, g32, gvec32, g64,
                                dn64, ptab64, din64, Boundary{}, iters, corr_iters,
                                rho2_limit, q_hi, q_lo, r_hi, r_lo, stream);
}

// K5: q0_hi (B, 4, 16-byte aligned) and r0_hi (B, 3) f32, with optional low
// words of the same shapes; gvec64 = -G dn_in zero-padded to P.
extern "C" int rod_shape_refined_bc(const float* qes_hi, const float* qes_lo,
                                    const float* q0_hi, const float* q0_lo,
                                    const float* r0_hi, const float* r0_lo, int batch,
                                    int npts, int p, int na, int ne, const float* g32,
                                    const float* gvec32, const double* g64,
                                    const double* dn64, const double* ptab64,
                                    const double* din64, const double* gvec64, int iters,
                                    int corr_iters, double rho2_limit, float* q_hi,
                                    float* q_lo, float* r_hi, float* r_lo, void* stream) {
    return refined_entry<true>(qes_hi, qes_lo, batch, npts, p, na, ne, g32, gvec32, g64,
                               dn64, ptab64, din64, Boundary{q0_hi, q0_lo, r0_hi, r0_lo, gvec64},
                               iters, corr_iters, rho2_limit, q_hi, q_lo, r_hi, r_lo, stream);
}
