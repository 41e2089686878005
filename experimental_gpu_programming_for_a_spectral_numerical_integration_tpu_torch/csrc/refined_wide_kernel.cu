// K3 wide and K5 wide: the whole refined rod solve in one kernel, with the demo
// boundary values (K3) or per-rod ones (K5), on grids with 32 < n-1 <= 512
// points.
//
// Replaces the wide and paired bodies of the JAX package's Pallas TPU kernel
// ops/pallas/refined_kernel.py rod_shape_refined_kernel, which differ only in
// how they pack rods onto 128-lane tiles: _rod_shape_refined_kernel_wide
// (pallas_call :540) and _rod_shape_refined_kernel_pair (pallas_call in
// _refined_pair_call, :1195), and of rod_shape_refined_kernel_bc:
// _rod_shape_refined_kernel_bc_wide (pallas_call :635) and
// _rod_shape_refined_kernel_bc_pair (:1253, in _refined_pair_call :1195).
// Same steps as K3 and K5 narrow (refined_kernel.cu):
//   1. K = Phi (qe_hi + qe_lo) in FP64;
//   2. f32 Picard base solve s (K/2 rounded to f32);
//   3. residual rhs - Dn_NN s + 1/2 A(K) s in FP64, rhs = -dn_in ⊗ (1,0,0,0);
//   4. f32 Picard correction delta of that residual;
//   5. x = s + delta in FP64, the FP64 unnormalized tangent b = R(x) e1
//      (R(x)(e1 + gamma) for na = 6) and FP64 position r = G b;
//   6. x and r split into f32 (hi, lo) pairs; a rod with
//      max_i |K_i / 2|^2 > (check_rho / L)^2 is NaN in all four outputs.
// K5 takes q0 = q0_hi + q0_lo and r0 = r0_hi + r0_lo per rod: the base solve
// starts from gvec32 ⊗ q0_hi, the residual's rhs is -dn_in ⊗ q0 and the
// position G b + gvec64 ⊗ r0, both in FP64 (gvec64 = -G dn_in).
// The TPU bodies fold 1/2 into the strain table and run steps 3 and 5 on int8
// Ozaki planes with int8-window NaN tests; here 1/2 is folded into K, the
// full G is used, and steps 3 and 5 are native FP64 (no planes, no window
// tests; the rho sentinel stays).
//
// Bound on an H100: the two f32 Picard loops are K1's FP32-FMA work,
// 4 (n-1)^2 (iters + corr_iters + 2) FMAs per rod (n=256 with 28 + 28 steps:
// ~15M per rod, B=8192 >= 3.6 ms at 67 TFLOP/s); the FP64 residual and
// position add 7 (n-1)^2 FMAs per rod at half the FP32 rate; the traffic is
// ~72 bytes in and 56 (n-1) bytes out per rod.  FMA bound.  Design: K1 wide's
// (wide_common.cuh) for the f32 loops; the FP64 products read Dn_NN^T and
// G^T in FP64 from device memory (through L1/L2) against the same panel,
// which is reused as an FP64 panel for the position.  A rod spans several
// warps, so the rho sentinel's max is a shared-memory atomicMax.
//
// C interface as rod_wide_kernel.cu; qes_lo, q0_lo and r0_lo may be NULL (zero
// low words) and rho2_limit < 0 disables the sentinel.  g32t, dn64t and g64t are the
// transposed operators, zero-padded to P x P.
#include "refined_bc.cuh"
#include "wide_common.cuh"

namespace {

using namespace wide;
using namespace refined_bc;

__device__ __forceinline__ void split(double v, float& hi, float& lo) {
    hi = __double2float_rn(v);
    lo = __double2float_rn(v - (double)hi);
}

// FP64 strain component a at point i from both words of qe.
__device__ __forceinline__ double strain64(const float* __restrict__ hi,
                                           const float* __restrict__ lo,
                                           const double* __restrict__ ptab, int ne, int i,
                                           int a) {
    double k = 0.0;
    for (int e = 0; e < ne; ++e) {
        double qe = (double)hi[a * ne + e];
        if (lo != nullptr) qe += (double)lo[a * ne + e];
        k = fma(ptab[i * ne + e], qe, k);
    }
    return k;
}

// TM consecutive doubles of a 16-byte aligned row.
template <int TM>
__device__ __forceinline__ void load_row64(const double* __restrict__ src, double (&d)[TM]) {
#pragma unroll
    for (int m = 0; m < TM; m += 2) {
        const double2 v = __ldg(reinterpret_cast<const double2*>(src + m));
        d[m] = v.x;
        d[m + 1] = v.y;
    }
}

template <int P>
constexpr size_t panel_bytes() {
    return (size_t)P * Layout<P>::R * 2 * sizeof(double2);   // 4 doubles per point and rod
}

template <int P, int NA, bool BC>
__global__ void __launch_bounds__(kThreads)
rod_shape_refined_wide_kernel(const float* __restrict__ qes_hi,
                              const float* __restrict__ qes_lo, int batch, int npts, int ne,
                              const float* __restrict__ g32t, const float* __restrict__ gvec32,
                              const double* __restrict__ g64t,
                              const double* __restrict__ dn64t,
                              const double* __restrict__ ptab64,
                              const double* __restrict__ din64, Boundary bc, int iters,
                              int corr_iters,
                              float rho2_limit, float* __restrict__ q_hi,
                              float* __restrict__ q_lo, float* __restrict__ r_hi,
                              float* __restrict__ r_lo) {
    using L = Layout<P>;
    constexpr int TM = L::TM, R = L::R;
    extern __shared__ double2 smem[];
    float4* panel = reinterpret_cast<float4*>(smem);   // f32 phases
    double2* panel64 = smem;                            // position phase
    __shared__ int rho_bits[R];

    const int rod = threadIdx.x % R;
    const int i0 = (threadIdx.x / R) * TM;
    const long long gid = (long long)blockIdx.x * R + rod;
    const bool live = gid < batch;
    const int nq = NA * ne;
    const float* hi_rod = qes_hi + gid * nq;
    const float* lo_rod = qes_lo == nullptr ? nullptr : qes_lo + gid * nq;
    if (threadIdx.x < R) rho_bits[threadIdx.x] = 0;
    __syncthreads();

    // K5's boundary values are read where they are used, to keep them out of
    // the register peak of the Picard loops: q0_hi here (the f32 base solve
    // starts from gvec32 ⊗ q0_hi), q0 for the residual, r0 for the position.
    float4 q0h = make_float4(1.f, 0.f, 0.f, 0.f);
    if constexpr (BC) {
        if (live) q0h = reinterpret_cast<const float4*>(bc.q0_hi)[gid];
    }

    // 1. K/2 in FP64, rounded to f32 for the Picard loops.
    float kh[TM][3];
    float4 g_rhs[TM];
    float rho2 = 0.f;
#pragma unroll
    for (int m = 0; m < TM; ++m) {
#pragma unroll
        for (int a = 0; a < 3; ++a) {
            kh[m][a] = live ? (float)(0.5 * strain64(hi_rod, lo_rod, ptab64, ne, i0 + m, a))
                            : 0.f;
        }
        rho2 = fmaxf(rho2, kh[m][0] * kh[m][0] + kh[m][1] * kh[m][1] + kh[m][2] * kh[m][2]);
        const float gv = gvec32[i0 + m];
        if constexpr (BC) {
            g_rhs[m] = make_float4(gv * q0h.x, gv * q0h.y, gv * q0h.z, gv * q0h.w);
        } else {
            g_rhs[m] = make_float4(gv, 0.f, 0.f, 0.f);
        }
    }

    // 2. f32 base solve.
    float4 s[TM];
    picard<P>(g32t, panel, npts, i0, rod, kh, g_rhs, iters, s);

    // rho sentinel: max over the rod's points of |K/2|^2 (non-negative
    // floats order as their bit patterns).
    atomicMax(&rho_bits[rod], __float_as_int(rho2));

    // 3. FP64 residual rhs - Dn_NN s + A(K/2) s.
#pragma unroll
    for (int m = 0; m < TM; ++m) panel[(i0 + m) * R + rod] = s[m];
    __syncthreads();
    const bool bad = rho2_limit >= 0.f && __int_as_float(rho_bits[rod]) > rho2_limit;
    double d[TM][4];
#pragma unroll
    for (int m = 0; m < TM; ++m) d[m][0] = d[m][1] = d[m][2] = d[m][3] = 0.0;
    for (int k = 0; k < npts; ++k) {
        const float4 t = panel[k * R + rod];
        double dk[TM];
        load_row64<TM>(dn64t + (size_t)k * P + i0, dk);
#pragma unroll
        for (int m = 0; m < TM; ++m) {
            d[m][0] = fma(dk[m], (double)t.x, d[m][0]);
            d[m][1] = fma(dk[m], (double)t.y, d[m][1]);
            d[m][2] = fma(dk[m], (double)t.z, d[m][2]);
            d[m][3] = fma(dk[m], (double)t.w, d[m][3]);
        }
    }
    __syncthreads();
    float4 res[TM];
#pragma unroll
    for (int m = 0; m < TM; ++m) {
        const int i = i0 + m;
        double kh0 = 0.0, kh1 = 0.0, kh2 = 0.0;
        if (live) {
            kh0 = 0.5 * strain64(hi_rod, lo_rod, ptab64, ne, i, 0);
            kh1 = 0.5 * strain64(hi_rod, lo_rod, ptab64, ne, i, 1);
            kh2 = 0.5 * strain64(hi_rod, lo_rod, ptab64, ne, i, 2);
        }
        const double sw = s[m].x, sx = s[m].y, sy = s[m].z, sz = s[m].w;
        double e0, e1, e2, e3;
        if constexpr (BC) {   // rhs = -dn_in ⊗ q0, every component
            double q0[4] = {1.0, 0.0, 0.0, 0.0};
            if (live) {
#pragma unroll
                for (int c = 0; c < 4; ++c) q0[c] = pair_at(bc.q0_hi, bc.q0_lo, gid * 4 + c);
            }
            const double din = din64[i];
            e0 = -din * q0[0] - d[m][0] + (-kh0 * sx - kh1 * sy - kh2 * sz);
            e1 = -din * q0[1] - d[m][1] + (kh0 * sw + kh2 * sy - kh1 * sz);
            e2 = -din * q0[2] - d[m][2] + (kh1 * sw - kh2 * sx + kh0 * sz);
            e3 = -din * q0[3] - d[m][3] + (kh2 * sw + kh1 * sx - kh0 * sy);
        } else {
            e0 = -din64[i] - d[m][0] + (-kh0 * sx - kh1 * sy - kh2 * sz);
            e1 = -d[m][1] + (kh0 * sw + kh2 * sy - kh1 * sz);
            e2 = -d[m][2] + (kh1 * sw - kh2 * sx + kh0 * sz);
            e3 = -d[m][3] + (kh2 * sw + kh1 * sx - kh0 * sy);
        }
        res[m] = make_float4((float)e0, (float)e1, (float)e2, (float)e3);
    }

    // 4. f32 correction.
    float4 zero[TM], g_res[TM], delta[TM];
#pragma unroll
    for (int m = 0; m < TM; ++m) zero[m] = make_float4(0.f, 0.f, 0.f, 0.f);
    g_times<P>(g32t, panel, npts, i0, rod, res, zero, g_res);
    picard<P>(g32t, panel, npts, i0, rod, kh, g_res, corr_iters, delta);

    // 5. FP64 combine (written out at once, split or poisoned) and tangent
    // into the FP64 panel (the f32 panel is free: the correction's last
    // product ended with a barrier), then the position.
    const float nan = __int_as_float(0x7fc00000);
#pragma unroll
    for (int m = 0; m < TM; ++m) {
        const int i = i0 + m;
        const double w = (double)s[m].x + (double)delta[m].x;
        const double xx = (double)s[m].y + (double)delta[m].y;
        const double y = (double)s[m].z + (double)delta[m].z;
        const double z = (double)s[m].w + (double)delta[m].w;
        if (live && i < npts) {
            float4 qh, ql;
            split(w, qh.x, ql.x);
            split(xx, qh.y, ql.y);
            split(y, qh.z, ql.z);
            split(z, qh.w, ql.w);
            if (bad) qh = ql = make_float4(nan, nan, nan, nan);
            reinterpret_cast<float4*>(q_hi)[gid * npts + i] = qh;
            reinterpret_cast<float4*>(q_lo)[gid * npts + i] = ql;
        }
        const double r00 = 1.0 - 2.0 * (y * y + z * z);
        const double r10 = 2.0 * (xx * y + w * z);
        const double r20 = 2.0 * (xx * z - w * y);
        double b0 = r00, b1 = r10, b2 = r20;
        if constexpr (NA == 6) {
            double e0 = 1.0, g1 = 0.0, g2 = 0.0;
            if (live) {
                e0 += strain64(hi_rod, lo_rod, ptab64, ne, i, 3);
                g1 = strain64(hi_rod, lo_rod, ptab64, ne, i, 4);
                g2 = strain64(hi_rod, lo_rod, ptab64, ne, i, 5);
            }
            const double r01 = 2.0 * (xx * y - w * z), r02 = 2.0 * (xx * z + w * y);
            const double r11 = 1.0 - 2.0 * (xx * xx + z * z), r12 = 2.0 * (y * z - w * xx);
            const double r21 = 2.0 * (y * z + w * xx), r22 = 1.0 - 2.0 * (xx * xx + y * y);
            b0 = r00 * e0 + r01 * g1 + r02 * g2;
            b1 = r10 * e0 + r11 * g1 + r12 * g2;
            b2 = r20 * e0 + r21 * g1 + r22 * g2;
        }
        panel64[((i0 + m) * R + rod) * 2 + 0] = make_double2(b0, b1);
        panel64[((i0 + m) * R + rod) * 2 + 1] = make_double2(b2, 0.0);
    }
    __syncthreads();
    double p[TM][3];
#pragma unroll
    for (int m = 0; m < TM; ++m) p[m][0] = p[m][1] = p[m][2] = 0.0;
    for (int k = 0; k < npts; ++k) {
        const double2 b01 = panel64[(k * R + rod) * 2 + 0];
        const double2 b2 = panel64[(k * R + rod) * 2 + 1];
        double gk[TM];
        load_row64<TM>(g64t + (size_t)k * P + i0, gk);
#pragma unroll
        for (int m = 0; m < TM; ++m) {
            p[m][0] = fma(gk[m], b01.x, p[m][0]);
            p[m][1] = fma(gk[m], b01.y, p[m][1]);
            p[m][2] = fma(gk[m], b2.x, p[m][2]);
        }
    }
    if constexpr (BC) {   // + gvec64 ⊗ r0, in FP64
        double r0[3] = {0.0, 0.0, 0.0};
        if (live) {
#pragma unroll
            for (int c = 0; c < 3; ++c) r0[c] = pair_at(bc.r0_hi, bc.r0_lo, gid * 3 + c);
        }
#pragma unroll
        for (int m = 0; m < TM; ++m) {
            const double gv = bc.gvec64[i0 + m];
#pragma unroll
            for (int c = 0; c < 3; ++c) p[m][c] = fma(gv, r0[c], p[m][c]);
        }
    }

    // 6. split the position, or poison the rod.
    if (live) {
#pragma unroll
        for (int m = 0; m < TM; ++m) {
            const int i = i0 + m;
            if (i >= npts) continue;
            const long long at = gid * npts + i;
#pragma unroll
            for (int c = 0; c < 3; ++c) {
                float rh, rl;
                split(p[m][c], rh, rl);
                r_hi[at * 3 + c] = bad ? nan : rh;
                r_lo[at * 3 + c] = bad ? nan : rl;
            }
        }
    }
}

template <int P, int NA, bool BC>
int launch_na(const float* qes_hi, const float* qes_lo, int batch, int npts, int ne,
              const float* g32t, const float* gvec32, const double* g64t,
              const double* dn64t, const double* ptab64, const double* din64, Boundary bc,
              int iters, int corr_iters, float rho2_limit, float* q_hi, float* q_lo,
              float* r_hi, float* r_lo, cudaStream_t stream) {
    constexpr size_t bytes = panel_bytes<P>();
    const cudaError_t err = cudaFuncSetAttribute(
        rod_shape_refined_wide_kernel<P, NA, BC>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)bytes);
    if (err != cudaSuccess) return (int)err;
    const int blocks = blocks_for(batch, Layout<P>::R);
    rod_shape_refined_wide_kernel<P, NA, BC><<<blocks, kThreads, bytes, stream>>>(
            qes_hi, qes_lo, batch, npts, ne, g32t, gvec32, g64t, dn64t, ptab64, din64, bc,
            iters, corr_iters, rho2_limit, q_hi, q_lo, r_hi, r_lo);
    return (int)cudaGetLastError();
}

template <int P, bool BC>
int launch(const float* qes_hi, const float* qes_lo, int batch, int npts, int na, int ne,
           const float* g32t, const float* gvec32, const double* g64t, const double* dn64t,
           const double* ptab64, const double* din64, Boundary bc, int iters, int corr_iters,
           float rho2_limit, float* q_hi, float* q_lo, float* r_hi, float* r_lo,
           cudaStream_t stream) {
    if (na == 6) {
        return launch_na<P, 6, BC>(qes_hi, qes_lo, batch, npts, ne, g32t, gvec32, g64t, dn64t,
                                   ptab64, din64, bc, iters, corr_iters, rho2_limit, q_hi,
                                   q_lo, r_hi, r_lo, stream);
    }
    return launch_na<P, 3, BC>(qes_hi, qes_lo, batch, npts, ne, g32t, gvec32, g64t, dn64t,
                               ptab64, din64, bc, iters, corr_iters, rho2_limit, q_hi, q_lo,
                               r_hi, r_lo, stream);
}

template <bool BC>
int refined_entry(const float* qes_hi, const float* qes_lo, int batch, int npts, int p,
                  int na, int ne, const float* g32t, const float* gvec32, const double* g64t,
                  const double* dn64t, const double* ptab64, const double* din64,
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
        case 64:
            return launch<64, BC>(qes_hi, qes_lo, batch, npts, na, ne, g32t, gvec32, g64t,
                                  dn64t, ptab64, din64, bc, iters, corr_iters, limit, q_hi,
                                  q_lo, r_hi, r_lo, s);
        case 128:
            return launch<128, BC>(qes_hi, qes_lo, batch, npts, na, ne, g32t, gvec32, g64t,
                                   dn64t, ptab64, din64, bc, iters, corr_iters, limit, q_hi,
                                   q_lo, r_hi, r_lo, s);
        case 256:
            return launch<256, BC>(qes_hi, qes_lo, batch, npts, na, ne, g32t, gvec32, g64t,
                                   dn64t, ptab64, din64, bc, iters, corr_iters, limit, q_hi,
                                   q_lo, r_hi, r_lo, s);
        default:
            return launch<512, BC>(qes_hi, qes_lo, batch, npts, na, ne, g32t, gvec32, g64t,
                                   dn64t, ptab64, din64, bc, iters, corr_iters, limit, q_hi,
                                   q_lo, r_hi, r_lo, s);
    }
}

}  // namespace

extern "C" int rod_shape_refined_wide(const float* qes_hi, const float* qes_lo, int batch,
                                      int npts, int p, int na, int ne, const float* g32t,
                                      const float* gvec32, const double* g64t,
                                      const double* dn64t, const double* ptab64,
                                      const double* din64, int iters, int corr_iters,
                                      double rho2_limit, float* q_hi, float* q_lo,
                                      float* r_hi, float* r_lo, void* stream) {
    return refined_entry<false>(qes_hi, qes_lo, batch, npts, p, na, ne, g32t, gvec32, g64t,
                                dn64t, ptab64, din64, Boundary{}, iters, corr_iters,
                                rho2_limit, q_hi, q_lo, r_hi, r_lo, stream);
}

// K5 wide: arguments as rod_shape_refined_bc (refined_kernel.cu), with the
// transposed operators of rod_shape_refined_wide.
extern "C" int rod_shape_refined_bc_wide(const float* qes_hi, const float* qes_lo,
                                         const float* q0_hi, const float* q0_lo,
                                         const float* r0_hi, const float* r0_lo, int batch,
                                         int npts, int p, int na, int ne, const float* g32t,
                                         const float* gvec32, const double* g64t,
                                         const double* dn64t, const double* ptab64,
                                         const double* din64, const double* gvec64,
                                         int iters, int corr_iters, double rho2_limit,
                                         float* q_hi, float* q_lo, float* r_hi, float* r_lo,
                                         void* stream) {
    return refined_entry<true>(qes_hi, qes_lo, batch, npts, p, na, ne, g32t, gvec32, g64t,
                               dn64t, ptab64, din64, Boundary{q0_hi, q0_lo, r0_hi, r0_lo, gvec64},
                               iters, corr_iters, rho2_limit, q_hi, q_lo, r_hi, r_lo, stream);
}
