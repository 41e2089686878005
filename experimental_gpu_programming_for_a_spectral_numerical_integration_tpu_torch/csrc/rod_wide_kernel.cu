// K1 wide, K2 wide and K4 wide: the fused f32 rod solve, the general
// right-hand-side Picard solve and the fused solve with per-rod boundary values
// on grids with 32 < n-1 <= 512 points.
//
// Replaces the wide and paired bodies of the JAX package's Pallas TPU kernels
// in ops/pallas/rod_kernel.py, which differ only in how they pack rods onto
// 128-lane tiles (wide: pallas_call in _wide_call, :738; paired: pallas_call in
// _pair_call, :997):
//   K1 wide: _rod_shape_fused_wide (:748) and _rod_shape_fused_pair (:1007):
//      qe -> K = Phi qe -> Picard s = G(-dn_in ⊗ q0) + G (1/2 A(K)) s with
//      q0 = (1,0,0,0) -> tangent b = R(s) e1, or R(s)(e1 + gamma) for na = 6
//      (unnormalized R) -> position r = G b (r0 = 0);
//   K2 wide: _picard_correction_fused_wide (:802) and
//      _picard_correction_fused_pair (:1063): x = G rhs + G (1/2 A(K)) x for a
//      per-rod rhs; reads only the 3 curvature components of qe;
//   K4 wide: _rod_shape_fused_bc_wide (:769) and _rod_shape_fused_bc_pair
//      (:1028): K1 wide with per-rod q0 (B,4) and r0 (B,3); G(-dn_in ⊗ q0) =
//      gvec ⊗ q0, so point i starts from gvec_i q0, and the position is
//      r = G b + gvec ⊗ r0 (q0 is not normalised, as in the JAX package).
// The ½ is folded into K and the full G is used (the TPU bodies use W = G/2
// and a x2 tangent); the result is the same.
//
// Bound on an H100: a Picard step is 4 (n-1)^2 multiply-adds per rod in the
// product with G, against 12 (n-1) for A(K/2); K1 at n=64 with 24 steps is
// ~393k per rod against 9 floats in and 7 (n-1) floats out, so every body is
// operations bound: K1 at n=64, B=32768, takes at least 0.40 ms in FP32 FMAs
// (67 TFLOP/s) and 0.17 ms with the products as 3xTF32 on the tensor cores
// (495 TFLOP/s dense TF32, three passes for an f32-accurate product).
// Design (tc_picard.cuh, the core of every wide kernel): R rods per block; a
// Picard step is one GEMM with the points as M and the rods' four components
// as N, 3xTF32 mma.sync with each 16-deep k-step summed in a fresh tile, G^T
// and T in shared memory (G^T resident at P <= 128, streamed in
// double-buffered cp.async slabs above); the state stays in the MMA
// accumulators, where A(K/2), the right-hand side and the tangent are applied
// in registers, so a step costs two block barriers.  Where shared memory
// allows, G^T (split by the caller) and T (split as it is written) are kept
// as TF32 hi and lo planes, which takes the conversions out of the k loop.
// K1/K4: S = g_rhs + G T with g_rhs = gvec ⊗ q0 recomputed at each step;
// K = Phi qe is f32 from ptab, as in the plain version; the position
// r = G b + gvec ⊗ r0 is one more GEMM with T = b (component 3 zero).  K2:
// x = G (rhs + A(K/2) x), iters + 1 GEMMs from x = 0 (the plain version's
// fixed point x = G rhs + G A(K/2) x, one product per step), rhs kept in
// per-thread shared-memory slots at P = 64 and read from L1/L2 at each step
// above, where that room goes to a split T.
//
// C interface (ctypes): device pointers, ints, the stream as void*; each entry
// returns cudaGetLastError() after its launch, cudaErrorInvalidValue for
// arguments it does not take.  Operators are zero-padded to P points by the
// caller: gt (3, P, P) is G^T and its TF32 hi and lo planes (16-byte
// aligned), ptab P x ne, gvec P.
#include "tc_picard.cuh"

namespace {

// Launch shapes per padded width P (tc_picard.cuh), fitted on an H100 by their
// ptxas reports and times (PERF.md): 8 (point, rod) pairs a thread at
// P = 64/128, 16 above; two blocks per SM at P = 64.  G^T and T are kept split
// at P <= 128; at P = 256 only T (a split G^T doubles the slabs streamed from
// L2, which was slower); at P = 512 a split plane does not fit.
template <int P> struct Shape;
template <> struct Shape<64> : tc::Cfg<64, 32, 2, 4, 64, 2, true, true> {};
template <> struct Shape<128> : tc::Cfg<128, 16, 8, 1, 128, 1, true, true> {};
template <> struct Shape<256> : tc::Cfg<256, 16, 8, 1, 32, 1, false, true> {};
template <> struct Shape<512> : tc::Cfg<512, 8, 8, 1, 16, 1> {};
// K2's: rhs in per-thread shared-memory slots, in place of a split T, where
// both would not fit with two blocks per SM (P = 64); above, K1's.
template <int P> struct CorrShape : Shape<P> { static constexpr bool kRhsSlots = false; };
template <> struct CorrShape<64> : tc::Cfg<64, 32, 2, 4, 64, 2, true> {
    static constexpr bool kRhsSlots = true;
};

// Dynamic shared memory: G^T and T, then (K2) each thread's slots for rhs.
template <class C, bool SLOTS>
constexpr size_t smem_bytes() {
    constexpr size_t bytes =
            (size_t)(C::kGFloats + C::kTFloats + (SLOTS ? C::kAcc * C::kThreads : 0)) * sizeof(float);
    // an H100 SM has 228 KB of shared memory, 1 KB of it reserved per block
    static_assert((bytes + 1024) * C::kMinBlocks <= 228 * 1024, "shared memory of an SM");
    return bytes;
}

// Strain component a at point i: K_a = sum_e P_e(x_i) qe[a*ne + e].
__device__ __forceinline__ float strain(const float* __restrict__ qe_rod,
                                        const float* __restrict__ ptab, int ne, int i,
                                        int a) {
    float k = 0.f;
    for (int e = 0; e < ne; ++e) k = fmaf(ptab[i * ne + e], qe_rod[a * ne + e], k);
    return k;
}

// K/2 at the thread's pairs (zero for a rod past the batch).
template <class C>
__device__ __forceinline__ void half_strain(const float* __restrict__ qes,
                                            const float* __restrict__ ptab, int batch, int nq,
                                            int ne, long long rod_base, const tc::Lane& l,
                                            float (&kh)[C::MT][C::JR][2][2][3]) {
    tc::for_pairs<C>(l, [&](int mt, int jr, int h, int e, int i, int rl) {
        const long long gid = rod_base + rl;
#pragma unroll
        for (int a = 0; a < 3; ++a)
            kh[mt][jr][h][e][a] = gid < batch ? 0.5f * strain(qes + gid * nq, ptab, ne, i, a) : 0.f;
    });
}

// K1 wide (BC = false: q0 = (1,0,0,0), r0 = 0) and K4 wide (BC = true) share
// this body.
template <int P, int NA, bool BC>
__global__ void __launch_bounds__(Shape<P>::kThreads, Shape<P>::kMinBlocks)
rod_shape_fused_wide_kernel(const float* __restrict__ qes, const float* __restrict__ q0s,
                            const float* __restrict__ r0s, int batch, int npts, int ne,
                            const float* __restrict__ gt, const float* __restrict__ ptab,
                            const float* __restrict__ gvec, int iters,
                            float* __restrict__ q_out, float* __restrict__ r_out) {
    using C = Shape<P>;
    constexpr int MT = C::MT, JR = C::JR, NT = C::NT;
    extern __shared__ float4 smem[];
    float* gs = reinterpret_cast<float*>(smem);   // G^T (resident or slabs)
    float* ts = gs + C::kGFloats;                 // the panel T
    const int tid = threadIdx.x;
    const tc::Lane l = tc::lane_of<C>(tid);
    const long long rod_base = (long long)blockIdx.x * C::R;
    tc::request_g<C>(gs, gt, tid);

    float kh[MT][JR][2][2][3];
    half_strain<C>(qes, ptab, batch, NA * ne, ne, rod_base, l, kh);

    // s from g_rhs = gvec ⊗ q0, recomputed at each step.
    float acc[MT][NT][4];
    const auto g_rhs = [&](float (&acc)[MT][NT][4]) {
        tc::for_pairs<C>(l, [&](int mt, int jr, int h, int e, int i, int rl) {
            const float gv = __ldg(gvec + i);
            if constexpr (BC) {
                float4 q0 = make_float4(1.f, 0.f, 0.f, 0.f);
                if (rod_base + rl < batch) q0 = __ldg(reinterpret_cast<const float4*>(q0s) + rod_base + rl);
                ACC(mt, jr, h, e, 0) = gv * q0.x;
                ACC(mt, jr, h, e, 1) = gv * q0.y;
                ACC(mt, jr, h, e, 2) = gv * q0.z;
                ACC(mt, jr, h, e, 3) = gv * q0.w;
            } else {
                ACC(mt, jr, h, e, 0) = gv;
                ACC(mt, jr, h, e, 1) = ACC(mt, jr, h, e, 2) = ACC(mt, jr, h, e, 3) = 0.f;
            }
        });
    };
    tc::picard<C>(gs, gt, ts, npts, tid, l, kh, iters, acc, g_rhs);

    // q out; the unnormalized tangent b (main.cpp:130-136), Reissner form for
    // na = 6, into T.
    tc::for_pairs<C>(l, [&](int mt, int jr, int h, int e, int i, int rl) {
        const long long gid = rod_base + rl;
        if (gid < batch && i < npts)
            reinterpret_cast<float4*>(q_out)[gid * npts + i] =
                    make_float4(ACC(mt, jr, h, e, 0), ACC(mt, jr, h, e, 1), ACC(mt, jr, h, e, 2),
                                ACC(mt, jr, h, e, 3));
    });
    tc::write_panel<C>(ts, l, [&](int mt, int jr, int h, int e) {
        const float w = ACC(mt, jr, h, e, 0), x = ACC(mt, jr, h, e, 1);
        const float y = ACC(mt, jr, h, e, 2), z = ACC(mt, jr, h, e, 3);
        const float r00 = 1.f - 2.f * (y * y + z * z);
        const float r10 = 2.f * (x * y + w * z);
        const float r20 = 2.f * (x * z - w * y);
        if constexpr (NA == 6) {
            const int i = tc::pair_row(l, mt, h);
            const long long gid = rod_base + tc::pair_rod(l, jr, e);
            const bool live = gid < batch;
            const float* qe = qes + gid * (NA * ne);
            const float e0 = live ? 1.f + strain(qe, ptab, ne, i, 3) : 1.f;
            const float g1 = live ? strain(qe, ptab, ne, i, 4) : 0.f;
            const float g2 = live ? strain(qe, ptab, ne, i, 5) : 0.f;
            const float r01 = 2.f * (x * y - w * z), r02 = 2.f * (x * z + w * y);
            const float r11 = 1.f - 2.f * (x * x + z * z), r12 = 2.f * (y * z - w * x);
            const float r21 = 2.f * (y * z + w * x), r22 = 1.f - 2.f * (x * x + y * y);
            return make_float4(r00 * e0 + r01 * g1 + r02 * g2, r10 * e0 + r11 * g1 + r12 * g2,
                               r20 * e0 + r21 * g1 + r22 * g2, 0.f);
        }
        return make_float4(r00, r10, r20, 0.f);
    });

    // The position r = G b + gvec ⊗ r0 starts from the boundary term.
    tc::for_pairs<C>(l, [&](int mt, int jr, int h, int e, int i, int rl) {
        float r0[3] = {0.f, 0.f, 0.f};
        if constexpr (BC) {
            if (rod_base + rl < batch) {
#pragma unroll
                for (int c = 0; c < 3; ++c) r0[c] = __ldg(r0s + (rod_base + rl) * 3 + c);
            }
        }
        const float gv = BC ? __ldg(gvec + i) : 0.f;
#pragma unroll
        for (int c = 0; c < 3; ++c) ACC(mt, jr, h, e, c) = gv * r0[c];
        ACC(mt, jr, h, e, 3) = 0.f;
    });
    tc::gemm<C>(gs, gt, ts, npts, tid, l, acc);
    tc::for_pairs<C>(l, [&](int mt, int jr, int h, int e, int i, int rl) {
        const long long gid = rod_base + rl;
        if (gid < batch && i < npts) {
            const long long at = gid * npts + i;
#pragma unroll
            for (int c = 0; c < 3; ++c) r_out[at * 3 + c] = ACC(mt, jr, h, e, c);
        }
    });
    tc::cp_async_wait<0>();   // a streamed G^T has requested its next first slab
}

template <int P>
__global__ void __launch_bounds__(CorrShape<P>::kThreads, CorrShape<P>::kMinBlocks)
picard_correction_wide_kernel(const float* __restrict__ qes, int batch, int npts, int nq,
                              int ne, const float* __restrict__ gt,
                              const float* __restrict__ ptab, const float* __restrict__ rhs,
                              int iters, float* __restrict__ x_out) {
    using C = CorrShape<P>;
    constexpr int MT = C::MT, JR = C::JR, NT = C::NT;
    extern __shared__ float4 smem[];
    float* gs = reinterpret_cast<float*>(smem);   // G^T (resident or slabs)
    float* ts = gs + C::kGFloats;                 // the panel T
    float* slots = ts + C::kTFloats;              // the thread's rhs (kRhsSlots)
    const int tid = threadIdx.x;
    const tc::Lane l = tc::lane_of<C>(tid);
    const long long rod_base = (long long)blockIdx.x * C::R;
    tc::request_g<C>(gs, gt, tid);

    // Only the 3 curvature components drive the quaternion ODE.
    float kh[MT][JR][2][2][3];
    half_strain<C>(qes, ptab, batch, nq, ne, rod_base, l, kh);

    // x = G (rhs + A(K/2) x): iters + 1 products from x = 0, the first one
    // G rhs.
    const auto rhs_at = [&](int mt, int jr, int h, int e) {
        const int i = tc::pair_row(l, mt, h);
        const long long gid = rod_base + tc::pair_rod(l, jr, e);
        return gid < batch && i < npts ? __ldg(reinterpret_cast<const float4*>(rhs) + gid * npts + i)
                                       : make_float4(0.f, 0.f, 0.f, 0.f);
    };
    float acc[MT][NT][4];
    if constexpr (C::kRhsSlots) {
        tc::for_pairs<C>(l, [&](int mt, int jr, int h, int e, int, int) {
            const float4 b = rhs_at(mt, jr, h, e);
            ACC(mt, jr, h, e, 0) = b.x;
            ACC(mt, jr, h, e, 1) = b.y;
            ACC(mt, jr, h, e, 2) = b.z;
            ACC(mt, jr, h, e, 3) = b.w;
        });
        tc::store_acc<C>(slots, tid, acc);
    }
    tc::zero_acc<C>(acc);
    for (int it = 0; it <= iters; ++it) {
        tc::write_panel<C>(ts, l, [&](int mt, int jr, int h, int e) {
            float4 b;
            if constexpr (C::kRhsSlots) {
                b = tc::load_pair<C>(slots, tid, mt, jr, h, e);
            } else {
                b = rhs_at(mt, jr, h, e);
            }
            const float4 t = tc::a_apply(kh[mt][jr][h][e],
                                         make_float4(ACC(mt, jr, h, e, 0), ACC(mt, jr, h, e, 1),
                                                     ACC(mt, jr, h, e, 2), ACC(mt, jr, h, e, 3)));
            return make_float4(b.x + t.x, b.y + t.y, b.z + t.z, b.w + t.w);
        });
        tc::zero_acc<C>(acc);
        tc::gemm<C>(gs, gt, ts, npts, tid, l, acc);
    }

    tc::for_pairs<C>(l, [&](int mt, int jr, int h, int e, int i, int rl) {
        const long long gid = rod_base + rl;
        if (gid < batch && i < npts)
            reinterpret_cast<float4*>(x_out)[gid * npts + i] =
                    make_float4(ACC(mt, jr, h, e, 0), ACC(mt, jr, h, e, 1), ACC(mt, jr, h, e, 2),
                                ACC(mt, jr, h, e, 3));
    });
    tc::cp_async_wait<0>();   // a streamed G^T has requested its next first slab
}

template <int P, bool BC>
int launch_fused(const float* qes, const float* q0, const float* r0, int batch, int npts,
                 int na, int ne, const float* gt, const float* ptab, const float* gvec,
                 int iters, float* q, float* r, cudaStream_t stream) {
    using C = Shape<P>;
    constexpr size_t bytes = smem_bytes<C, false>();
    if (na == 6) {
        return tc::launch<C>(rod_shape_fused_wide_kernel<P, 6, BC>, bytes, batch, stream, qes, q0,
                             r0, batch, npts, ne, gt, ptab, gvec, iters, q, r);
    }
    return tc::launch<C>(rod_shape_fused_wide_kernel<P, 3, BC>, bytes, batch, stream, qes, q0, r0,
                         batch, npts, ne, gt, ptab, gvec, iters, q, r);
}

template <bool BC>
int fused_entry(const float* qes, const float* q0, const float* r0, int batch, int npts,
                int p, int na, int ne, const float* gt, const float* ptab, const float* gvec,
                int iters, float* q_out, float* r_out, void* stream) {
    if (!tc::valid_width(p, npts) || batch <= 0 || (na != 3 && na != 6) || ne < 1 ||
        iters < 0 || (BC && (q0 == nullptr || r0 == nullptr))) {
        return (int)cudaErrorInvalidValue;
    }
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    switch (p) {
        case 64: return launch_fused<64, BC>(qes, q0, r0, batch, npts, na, ne, gt, ptab, gvec, iters, q_out, r_out, s);
        case 128: return launch_fused<128, BC>(qes, q0, r0, batch, npts, na, ne, gt, ptab, gvec, iters, q_out, r_out, s);
        case 256: return launch_fused<256, BC>(qes, q0, r0, batch, npts, na, ne, gt, ptab, gvec, iters, q_out, r_out, s);
        default: return launch_fused<512, BC>(qes, q0, r0, batch, npts, na, ne, gt, ptab, gvec, iters, q_out, r_out, s);
    }
}

template <int P>
int launch_correction(const float* qes, int batch, int npts, int nq, int ne,
                      const float* gt, const float* ptab, const float* rhs, int iters,
                      float* x, cudaStream_t stream) {
    using C = CorrShape<P>;
    return tc::launch<C>(picard_correction_wide_kernel<P>, smem_bytes<C, C::kRhsSlots>(), batch,
                         stream,
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
    if (!tc::valid_width(p, npts) || batch <= 0 || ne < 1 || nq < 3 * ne || iters < 0) {
        return (int)cudaErrorInvalidValue;
    }
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    switch (p) {
        case 64: return launch_correction<64>(qes, batch, npts, nq, ne, gt, ptab, rhs, iters, x_out, s);
        case 128: return launch_correction<128>(qes, batch, npts, nq, ne, gt, ptab, rhs, iters, x_out, s);
        case 256: return launch_correction<256>(qes, batch, npts, nq, ne, gt, ptab, rhs, iters, x_out, s);
        default: return launch_correction<512>(qes, batch, npts, nq, ne, gt, ptab, rhs, iters, x_out, s);
    }
}
