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
// Bound on an H100: the two f32 Picard loops and G res are 4 (n-1)^2
// (iters + corr_iters + 1) multiply-adds per rod (n=256, 16 + 16 steps:
// ~8.6M per rod); in FP32 FMAs that is >= 2.1 ms at B=8192 (67 TFLOP/s), as
// 3xTF32 tensor-core products three times the work at 495 TFLOP/s, >= 0.85
// ms.  The FP64 residual and position add 7 (n-1)^2 FMAs per rod; the
// traffic is ~72 bytes in and 56 (n-1) bytes out per rod.  Operations bound.
// Design (tc_picard.cuh): R rods per block, the f32 products as 3xTF32
// mma.sync tiles with the points as M and the rods' four components as N, G^T
// and the panel T = A(K/2) s in shared memory (G^T resident at P <= 128,
// streamed in double-buffered cp.async slabs above), the state in the MMA
// accumulators with A(K/2) applied in registers, g_rhs in per-thread
// shared-memory slots.  The base solve s is kept in q_hi (this thread's own
// points) between steps 3 and 5, and K/2 is recomputed after the residual,
// to keep both out of the registers of the FP64 phase.  The FP64 products
// read Dn_NN^T and G^T in FP64 from device memory (through L1/L2) against
// FP64 panels of s and of the tangent b laid over G^T and T (converted once,
// not at every product term).  A rod spans several warps, so the rho
// sentinel's max is a shared-memory atomicMax.
//
// C interface as rod_wide_kernel.cu; qes_lo, q0_lo and r0_lo may be NULL (zero
// low words) and rho2_limit < 0 disables the sentinel.  g32t, dn64t and g64t are the
// transposed operators, zero-padded to P x P (g32t: the first plane of
// rod_wide_kernel.cu's gt).
#include "refined_bc.cuh"
#include "tc_picard.cuh"

namespace {

using namespace refined_bc;

// Launch shape per padded width P (tc_picard.cuh): 8 (point, rod) pairs a
// thread at P = 64/128, 16 above; two blocks per SM at P = 64.
template <int P> struct Shape;
template <> struct Shape<64> : tc::Cfg<64, 32, 2, 4, 64, 2> {};
template <> struct Shape<128> : tc::Cfg<128, 16, 8, 1, 128, 1> {};
template <> struct Shape<256> : tc::Cfg<256, 16, 8, 1, 32, 1> {};
template <> struct Shape<512> : tc::Cfg<512, 8, 8, 1, 16, 1> {};

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

// Dynamic shared memory: G^T and T, or over both the FP64 panel of s (the
// residual) or of the tangent b (the position); then each thread's private
// slots for g_rhs.
template <int P>
__host__ __device__ constexpr size_t region_bytes() {
    using C = Shape<P>;
    const size_t ops = (size_t)(C::kGFloats + C::kTFloats) * sizeof(float);
    const size_t s64 = (size_t)P * 4 * C::R * sizeof(double);
    return ops > s64 ? ops : s64;
}

template <int P>
__host__ __device__ constexpr size_t smem_bytes() {
    using C = Shape<P>;
    return region_bytes<P>() + (size_t)C::kAcc * C::kThreads * sizeof(float);
}

// K/2 at the thread's pairs, f32-rounded from FP64 (zero for a rod past the
// batch), and each rod's max |K/2|^2 over the thread's points.
template <int P>
__device__ __forceinline__ void half_strain(const float* __restrict__ qes_hi,
                                            const float* __restrict__ qes_lo,
                                            const double* __restrict__ ptab64, int batch,
                                            int nq, int ne, long long rod_base,
                                            const tc::Lane& l,
                                            float (&kh)[Shape<P>::MT][Shape<P>::JR][2][2][3],
                                            float (&rho2)[Shape<P>::JR][2]) {
    using C = Shape<P>;
#pragma unroll
    for (int jr = 0; jr < C::JR; ++jr)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
            const long long gid = rod_base + tc::pair_rod(l, jr, e);
            const bool live = gid < batch;
            const float* hi = qes_hi + gid * nq;
            const float* lo = qes_lo == nullptr ? nullptr : qes_lo + gid * nq;
            rho2[jr][e] = 0.f;
#pragma unroll
            for (int mt = 0; mt < C::MT; ++mt)
#pragma unroll
                for (int h = 0; h < 2; ++h) {
                    float* k = kh[mt][jr][h][e];
                    const int i = tc::pair_row(l, mt, h);
#pragma unroll
                    for (int a = 0; a < 3; ++a)
                        k[a] = live ? (float)(0.5 * strain64(hi, lo, ptab64, ne, i, a)) : 0.f;
                    rho2[jr][e] = fmaxf(rho2[jr][e], k[0] * k[0] + k[1] * k[1] + k[2] * k[2]);
                }
        }
}

template <int P, int NA, bool BC>
__global__ void __launch_bounds__(Shape<P>::kThreads, Shape<P>::kMinBlocks)
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
    using C = Shape<P>;
    constexpr int MT = C::MT, JR = C::JR, NT = C::NT, R = C::R;
    extern __shared__ double2 smem[];
    float* gs = reinterpret_cast<float*>(smem);          // G^T (resident or slabs)
    float* ts = gs + C::kGFloats;                        // the panel T
    double* panel64 = reinterpret_cast<double*>(smem);   // FP64 panels, over gs and ts
    float* slots = reinterpret_cast<float*>(smem) + region_bytes<P>() / sizeof(float);
    __shared__ int rho_bits[R];

    const int tid = threadIdx.x;
    const tc::Lane l = tc::lane_of<C>(tid);
    const long long rod_base = (long long)blockIdx.x * R;
    const int nq = NA * ne;
    if (tid < R) rho_bits[tid] = 0;
    __syncthreads();
    tc::request_g<C>(gs, g32t, tid);

    // 1. K/2 in FP64, rounded to f32, and the rho sentinel: max over the
    // rod's points of |K/2|^2 (non-negative floats order as their bits).
    float kh[MT][JR][2][2][3];
    float rho2[JR][2];
    half_strain<P>(qes_hi, qes_lo, ptab64, batch, nq, ne, rod_base, l, kh, rho2);
#pragma unroll
    for (int jr = 0; jr < JR; ++jr)
#pragma unroll
        for (int e = 0; e < 2; ++e)
            atomicMax(&rho_bits[tc::pair_rod(l, jr, e)], __float_as_int(rho2[jr][e]));

    // 2. f32 base solve s (in acc) from g_rhs = gvec32 ⊗ q0_hi (K5) or
    // gvec32 ⊗ (1,0,0,0) (K3) in the slots.
    float acc[MT][NT][4];
    tc::for_pairs<C>(l, [&](int mt, int jr, int h, int e, int i, int rl) {
        const float gv = gvec32[i];
        if constexpr (BC) {
            float4 q0h = make_float4(1.f, 0.f, 0.f, 0.f);
            if (rod_base + rl < batch) q0h = reinterpret_cast<const float4*>(bc.q0_hi)[rod_base + rl];
            ACC(mt, jr, h, e, 0) = gv * q0h.x;
            ACC(mt, jr, h, e, 1) = gv * q0h.y;
            ACC(mt, jr, h, e, 2) = gv * q0h.z;
            ACC(mt, jr, h, e, 3) = gv * q0h.w;
        } else {
            ACC(mt, jr, h, e, 0) = gv;
            ACC(mt, jr, h, e, 1) = ACC(mt, jr, h, e, 2) = ACC(mt, jr, h, e, 3) = 0.f;
        }
    });
    tc::store_acc<C>(slots, tid, acc);
    const auto g_rhs = [&](float (&a)[MT][NT][4]) { tc::load_acc<C>(slots, tid, a); };
    tc::picard<C>(gs, g32t, ts, npts, tid, l, kh, iters, acc, g_rhs);

    // 3. s into the FP64 panel s64[k][c R + rod] over gs and ts (and into
    // q_hi, this thread's own points, until step 5), then the FP64 residual
    // rhs - Dn_NN s + A(K/2) s into acc.
    double* s64 = panel64;
    tc::cp_async_wait<0>();
    __syncthreads();
    tc::for_pairs<C>(l, [&](int mt, int jr, int h, int e, int i, int rl) {
        double* at = s64 + (size_t)i * 4 * R + rl;
#pragma unroll
        for (int c = 0; c < 4; ++c) at[c * R] = ACC(mt, jr, h, e, c);
        if (rod_base + rl < batch && i < npts)
            reinterpret_cast<float4*>(q_hi)[(rod_base + rl) * npts + i] = make_float4(
                    ACC(mt, jr, h, e, 0), ACC(mt, jr, h, e, 1), ACC(mt, jr, h, e, 2),
                    ACC(mt, jr, h, e, 3));
    });
    __syncthreads();
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
        double d[JR][2][2][4];
#pragma unroll
        for (int jr = 0; jr < JR; ++jr)
#pragma unroll
            for (int h = 0; h < 2; ++h)
#pragma unroll
                for (int e = 0; e < 2; ++e)
#pragma unroll
                    for (int c = 0; c < 4; ++c) d[jr][h][e][c] = 0.0;
        const int i0 = tc::pair_row(l, mt, 0), i1 = tc::pair_row(l, mt, 1);
        for (int k = 0; k < npts; ++k) {
            const double dk0 = dn64t[(size_t)k * P + i0], dk1 = dn64t[(size_t)k * P + i1];
            const double* sk = s64 + (size_t)k * 4 * R + tc::pair_rod(l, 0, 0);
#pragma unroll
            for (int jr = 0; jr < JR; ++jr)
#pragma unroll
                for (int e = 0; e < 2; ++e)
#pragma unroll
                    for (int c = 0; c < 4; ++c) {
                        const double sv = sk[c * R + jr * 8 + e];
                        d[jr][0][e][c] = fma(dk0, sv, d[jr][0][e][c]);
                        d[jr][1][e][c] = fma(dk1, sv, d[jr][1][e][c]);
                    }
        }
#pragma unroll
        for (int jr = 0; jr < JR; ++jr)
#pragma unroll
            for (int h = 0; h < 2; ++h)
#pragma unroll
                for (int e = 0; e < 2; ++e) {
                    const int i = tc::pair_row(l, mt, h), rl = tc::pair_rod(l, jr, e);
                    const long long gid = rod_base + rl;
                    const bool live = gid < batch;
                    const float* hi_rod = qes_hi + gid * nq;
                    const float* lo_rod = qes_lo == nullptr ? nullptr : qes_lo + gid * nq;
                    double kh0 = 0.0, kh1 = 0.0, kh2 = 0.0;
                    if (live) {
                        kh0 = 0.5 * strain64(hi_rod, lo_rod, ptab64, ne, i, 0);
                        kh1 = 0.5 * strain64(hi_rod, lo_rod, ptab64, ne, i, 1);
                        kh2 = 0.5 * strain64(hi_rod, lo_rod, ptab64, ne, i, 2);
                    }
                    const double* s = s64 + (size_t)i * 4 * R + rl;
                    const double sw = s[0], sx = s[R], sy = s[2 * R], sz = s[3 * R];
                    const double* dm = d[jr][h][e];
                    double e0, e1, e2, e3;
                    if constexpr (BC) {   // rhs = -dn_in ⊗ q0, every component
                        double q0[4] = {1.0, 0.0, 0.0, 0.0};
                        if (live) {
#pragma unroll
                            for (int c = 0; c < 4; ++c)
                                q0[c] = pair_at(bc.q0_hi, bc.q0_lo, gid * 4 + c);
                        }
                        const double din = din64[i];
                        e0 = -din * q0[0] - dm[0] + (-kh0 * sx - kh1 * sy - kh2 * sz);
                        e1 = -din * q0[1] - dm[1] + (kh0 * sw + kh2 * sy - kh1 * sz);
                        e2 = -din * q0[2] - dm[2] + (kh1 * sw - kh2 * sx + kh0 * sz);
                        e3 = -din * q0[3] - dm[3] + (kh2 * sw + kh1 * sx - kh0 * sy);
                    } else {
                        e0 = -din64[i] - dm[0] + (-kh0 * sx - kh1 * sy - kh2 * sz);
                        e1 = -dm[1] + (kh0 * sw + kh2 * sy - kh1 * sz);
                        e2 = -dm[2] + (kh1 * sw - kh2 * sx + kh0 * sz);
                        e3 = -dm[3] + (kh2 * sw + kh1 * sx - kh0 * sy);
                    }
                    ACC(mt, jr, h, e, 0) = (float)e0;
                    ACC(mt, jr, h, e, 1) = (float)e1;
                    ACC(mt, jr, h, e, 2) = (float)e2;
                    ACC(mt, jr, h, e, 3) = (float)e3;
                }
    }

    // 4. f32 correction: g_res = G res, then Picard from g_res.
    __syncthreads();   // every thread is done with s64: G^T and T take it back
    tc::request_g<C>(gs, g32t, tid);
    tc::write_panel<C>(ts, l, [&](int mt, int jr, int h, int e) {
        return make_float4(ACC(mt, jr, h, e, 0), ACC(mt, jr, h, e, 1), ACC(mt, jr, h, e, 2),
                           ACC(mt, jr, h, e, 3));
    });
    tc::zero_acc<C>(acc);
    tc::gemm<C>(gs, g32t, ts, npts, tid, l, acc);
    tc::store_acc<C>(slots, tid, acc);
    half_strain<P>(qes_hi, qes_lo, ptab64, batch, nq, ne, rod_base, l, kh, rho2);
    tc::picard<C>(gs, g32t, ts, npts, tid, l, kh, corr_iters, acc, g_rhs);

    // 5. FP64 combine x = s + delta (written out at once, split or poisoned)
    // and tangent into the FP64 panel, then the position.  The panel lies
    // over G^T and T: the last slab request must land first.
    tc::cp_async_wait<0>();
    __syncthreads();
    const float nan = __int_as_float(0x7fc00000);
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int jr = 0; jr < JR; ++jr)
#pragma unroll
            for (int h = 0; h < 2; ++h)
#pragma unroll
                for (int e = 0; e < 2; ++e) {
                    const int i = tc::pair_row(l, mt, h), rl = tc::pair_rod(l, jr, e);
                    const long long gid = rod_base + rl;
                    const bool live = gid < batch;
                    const bool out = live && i < npts;
                    const int q = 2 * h + e;
                    float4 s = make_float4(0.f, 0.f, 0.f, 0.f);
                    if (out) s = reinterpret_cast<const float4*>(q_hi)[gid * npts + i];
                    const double w = (double)s.x + (double)acc[mt][jr][q];
                    const double xx = (double)s.y + (double)acc[mt][JR + jr][q];
                    const double y = (double)s.z + (double)acc[mt][2 * JR + jr][q];
                    const double z = (double)s.w + (double)acc[mt][3 * JR + jr][q];
                    if (out) {
                        float4 qh, ql;
                        split(w, qh.x, ql.x);
                        split(xx, qh.y, ql.y);
                        split(y, qh.z, ql.z);
                        split(z, qh.w, ql.w);
                        if (rho2_limit >= 0.f && __int_as_float(rho_bits[rl]) > rho2_limit)
                            qh = ql = make_float4(nan, nan, nan, nan);
                        reinterpret_cast<float4*>(q_hi)[gid * npts + i] = qh;
                        reinterpret_cast<float4*>(q_lo)[gid * npts + i] = ql;
                    }
                    const double r00 = 1.0 - 2.0 * (y * y + z * z);
                    const double r10 = 2.0 * (xx * y + w * z);
                    const double r20 = 2.0 * (xx * z - w * y);
                    double b0 = r00, b1 = r10, b2 = r20;
                    if constexpr (NA == 6) {
                        const float* hi_rod = qes_hi + gid * nq;
                        const float* lo_rod = qes_lo == nullptr ? nullptr : qes_lo + gid * nq;
                        double e0 = 1.0, g1 = 0.0, g2 = 0.0;
                        if (live) {
                            e0 += strain64(hi_rod, lo_rod, ptab64, ne, i, 3);
                            g1 = strain64(hi_rod, lo_rod, ptab64, ne, i, 4);
                            g2 = strain64(hi_rod, lo_rod, ptab64, ne, i, 5);
                        }
                        const double r01 = 2.0 * (xx * y - w * z), r02 = 2.0 * (xx * z + w * y);
                        const double r11 = 1.0 - 2.0 * (xx * xx + z * z);
                        const double r12 = 2.0 * (y * z - w * xx);
                        const double r21 = 2.0 * (y * z + w * xx);
                        const double r22 = 1.0 - 2.0 * (xx * xx + y * y);
                        b0 = r00 * e0 + r01 * g1 + r02 * g2;
                        b1 = r10 * e0 + r11 * g1 + r12 * g2;
                        b2 = r20 * e0 + r21 * g1 + r22 * g2;
                    }
                    double* b = panel64 + ((size_t)i * R + rl) * 3;
                    b[0] = b0;
                    b[1] = b1;
                    b[2] = b2;
                }
    __syncthreads();
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
        double p[JR][2][2][3];
#pragma unroll
        for (int jr = 0; jr < JR; ++jr)
#pragma unroll
            for (int h = 0; h < 2; ++h)
#pragma unroll
                for (int e = 0; e < 2; ++e) p[jr][h][e][0] = p[jr][h][e][1] = p[jr][h][e][2] = 0.0;
        const int i0 = tc::pair_row(l, mt, 0), i1 = tc::pair_row(l, mt, 1);
        for (int k = 0; k < npts; ++k) {
            const double gk[2] = {g64t[(size_t)k * P + i0], g64t[(size_t)k * P + i1]};
            const double* bk = panel64 + ((size_t)k * R + tc::pair_rod(l, 0, 0)) * 3;
#pragma unroll
            for (int jr = 0; jr < JR; ++jr)
#pragma unroll
                for (int e = 0; e < 2; ++e)
#pragma unroll
                    for (int c = 0; c < 3; ++c) {
                        const double bv = bk[(jr * 8 + e) * 3 + c];
                        p[jr][0][e][c] = fma(gk[0], bv, p[jr][0][e][c]);
                        p[jr][1][e][c] = fma(gk[1], bv, p[jr][1][e][c]);
                    }
        }
        // 6. + gvec64 ⊗ r0 (K5, FP64), then split the position or poison the rod.
#pragma unroll
        for (int jr = 0; jr < JR; ++jr)
#pragma unroll
            for (int e = 0; e < 2; ++e) {
                const int rl = tc::pair_rod(l, jr, e);
                const long long gid = rod_base + rl;
                if (gid >= batch) continue;
                const bool bad = rho2_limit >= 0.f && __int_as_float(rho_bits[rl]) > rho2_limit;
                double r0[3] = {0.0, 0.0, 0.0};
                if constexpr (BC) {
#pragma unroll
                    for (int c = 0; c < 3; ++c) r0[c] = pair_at(bc.r0_hi, bc.r0_lo, gid * 3 + c);
                }
#pragma unroll
                for (int h = 0; h < 2; ++h) {
                    const int i = tc::pair_row(l, mt, h);
                    if (i >= npts) continue;
                    const long long at = gid * npts + i;
#pragma unroll
                    for (int c = 0; c < 3; ++c) {
                        double v = p[jr][h][e][c];
                        if constexpr (BC) v = fma(bc.gvec64[i], r0[c], v);
                        float rh, rl32;
                        split(v, rh, rl32);
                        r_hi[at * 3 + c] = bad ? nan : rh;
                        r_lo[at * 3 + c] = bad ? nan : rl32;
                    }
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
    return tc::launch<Shape<P>>(rod_shape_refined_wide_kernel<P, NA, BC>, smem_bytes<P>(), batch,
                                stream, qes_hi, qes_lo, batch, npts, ne, g32t, gvec32, g64t,
                                dn64t, ptab64, din64, bc, iters, corr_iters, rho2_limit, q_hi,
                                q_lo, r_hi, r_lo);
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
    if (!tc::valid_width(p, npts) || batch <= 0 || (na != 3 && na != 6) || ne < 1 ||
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
