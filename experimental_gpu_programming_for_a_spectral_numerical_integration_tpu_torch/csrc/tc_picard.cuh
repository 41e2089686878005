// Tensor-core Picard core of the refined wide kernels (refined_wide_kernel.cu):
// the f32 products S = base + G T of a block of R rods run as 3xTF32
// mma.sync.m16n8k8 on Hopper's tensor cores, with G and T in shared memory.
//
// Each Picard step is a GEMM with M = P (points), K = P and N = 4R columns,
// ordered component-major, col = c * R + rod.  Warp w owns the MW x 4RW tile
// of rows wm * MW .. and rods wn * RW .. (wm = w % WM, wn = w / WM).  In the
// m16n8 accumulator a thread (g = lane / 4, t = lane % 4) holds rows g and
// g + 8 of each 16-row m-tile and columns 2t, 2t + 1 of each n-tile, so with
// the component-major order it holds all four quaternion components of its
// (point, rod) pairs: the A(K/2) action of every step is thread-local.
//
// Precision: each operand is split as x_hi = tf32(x) (cvt.rna), x_lo =
// tf32(x - x_hi), and the product sums G_lo T_hi + G_hi T_lo + G_hi T_hi in
// FP32, as accurate as FP32 FMAs here (one pass of TF32 is not: ~1e-7).  The
// tensor cores do not round their FP32 sum to nearest (it mostly truncates
// toward zero), so each 16-deep step is summed in a fresh tile and added to
// the state with a rounded FP32 add.
// The split is made in registers when a fragment is read from shared memory
// (storing T split instead costs the shared memory that holds g_rhs).
//
// Shared memory: G^T as gs[k][row] (row stride P + 8) and T as ts[k][col]
// (row stride 4R + 8): both strides are 8 mod 32 banks, so the A and B
// fragment reads and the float2 writes of T are free of bank conflicts.
// At P <= 128 all of G^T stays resident for the whole kernel; above, G^T is
// streamed in k-slabs of KS rows, double-buffered with cp.async so that the
// next slab loads while the current one multiplies.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace tc {

// Launch shape per padded width P: R rods per block, WM x WN warps, k-slabs of
// KS rows of G^T (KS = P: G^T resident).
template <int P> struct Shape;
template <> struct Shape<64> { static constexpr int R = 32, WM = 2, WN = 4, KS = 64; };
template <> struct Shape<128> { static constexpr int R = 16, WM = 8, WN = 1, KS = 128; };
template <> struct Shape<256> { static constexpr int R = 16, WM = 8, WN = 1, KS = 32; };
template <> struct Shape<512> { static constexpr int R = 8, WM = 8, WN = 1, KS = 16; };

template <int P>
struct Cfg {
    static constexpr int R = Shape<P>::R, WM = Shape<P>::WM, WN = Shape<P>::WN;
    static constexpr int KS = Shape<P>::KS;
    static constexpr bool kResident = KS == P;
    static constexpr int kThreads = 32 * WM * WN;
    static constexpr int MW = P / WM, RW = R / WN;   // rows and rods of a warp
    static constexpr int MT = MW / 16, JR = RW / 8;  // m-tiles, rod groups of 8
    static constexpr int NT = 4 * JR;                // n-tiles: component-major
    static constexpr int kAcc = MT * NT * 4;         // accumulator floats a thread holds
    static constexpr int GS = P + 8;                 // row stride of G^T in shared memory
    static constexpr int TS = 4 * R + 8;             // row stride of T in shared memory
    static constexpr int kGFloats = (kResident ? P : 2 * KS) * GS;
    static constexpr int kTFloats = P * TS;
    static_assert(MW % 16 == 0 && RW % 8 == 0 && P % KS == 0 && KS % 16 == 0, "bad shape");
    static constexpr int kMinBlocks = P == 64 ? 2 : 1;   // blocks per SM the registers allow
    static_assert(kAcc * kThreads == 4 * P * R, "every (point, rod) pair once");
};

// Thread coordinates within the block's GEMM.
struct Lane {
    int g, t, row0, rod0;   // row0: the warp's first row; rod0: its first rod
};

template <int P>
__device__ __forceinline__ Lane lane_of(int tid) {
    using C = Cfg<P>;
    const int warp = tid / 32, lane = tid % 32;
    return Lane{lane >> 2, lane & 3, (warp % C::WM) * C::MW, (warp / C::WM) * C::RW};
}

// The pair (mt, jr, h, e) of a thread: point row and block-local rod.
__device__ __forceinline__ int pair_row(const Lane& l, int mt, int h) {
    return l.row0 + mt * 16 + l.g + 8 * h;
}
__device__ __forceinline__ int pair_rod(const Lane& l, int jr, int e) {
    return l.rod0 + jr * 8 + 2 * l.t + e;
}

// ---- PTX: TF32 rounding, the tensor-core product, asynchronous copies ----

__device__ __forceinline__ uint32_t tf32(float x) {
    uint32_t r;
    asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));
    return r;
}

__device__ __forceinline__ void split_tf32(float x, uint32_t& hi, uint32_t& lo) {
    hi = tf32(x);
    lo = tf32(x - __uint_as_float(hi));
}

// c += a b on one m16n8k8 tile (TF32 in, FP32 accumulate).
__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
    asm volatile(
        "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
    const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(s), "l"(src));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;"); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
    asm volatile("cp.async.wait_group %0;" ::"n"(N));
}

// ---- operator tiles ----

// Rows k0 .. k0 + rows - 1 of G^T (P x P, row-major in device memory) into
// gs[k - k0][.] with row stride GS; every thread of the block takes part.
template <int P>
__device__ __forceinline__ void load_gt(float* gs, const float* __restrict__ gt, int k0,
                                        int rows, int tid) {
    using C = Cfg<P>;
    constexpr int kChunks = P / 4;   // 16-byte chunks per row
    for (int q = tid; q < rows * kChunks; q += C::kThreads) {
        const int k = q / kChunks, c = q % kChunks;
        cp_async16(gs + k * C::GS + 4 * c, gt + (size_t)(k0 + k) * P + 4 * c);
    }
    cp_async_commit();
}

// Request what the next product reads first: all of G^T (resident) or its
// first slab into buffer 0 (streamed).
template <int P>
__device__ __forceinline__ void request_g(float* gs, const float* __restrict__ gt, int tid) {
    load_gt<P>(gs, gt, 0, Cfg<P>::kResident ? P : Cfg<P>::KS, tid);
}


// acc += G[rows of the warp][k0 + kk] T[k0 + kk][cols of the warp] for
// kk < kcount (a multiple of 16); gs holds G^T rows from k0 on.  The six
// products of each 16-deep step are summed in a fresh tile d and added to acc
// in FP32: the tensor cores' FP32 sum mostly truncates toward zero, so summing
// into acc itself would lose up to an ulp of the state at every step, nearly
// always in the same direction.
template <int P>
__device__ __forceinline__ void mma_slab(const float* gs, const float* ts, int k0, int kcount,
                                         const Lane& l, float (&acc)[Cfg<P>::MT][Cfg<P>::NT][4]) {
    using C = Cfg<P>;
    for (int kk = 0; kk < kcount; kk += 16) {
        uint32_t ah[2][C::MT][4], al[2][C::MT][4];
#pragma unroll
        for (int s = 0; s < 2; ++s) {
            const float* ga = gs + (kk + 8 * s + l.t) * C::GS + l.row0 + l.g;
#pragma unroll
            for (int mt = 0; mt < C::MT; ++mt) {
                split_tf32(ga[mt * 16], ah[s][mt][0], al[s][mt][0]);
                split_tf32(ga[mt * 16 + 8], ah[s][mt][1], al[s][mt][1]);
                split_tf32(ga[4 * C::GS + mt * 16], ah[s][mt][2], al[s][mt][2]);
                split_tf32(ga[4 * C::GS + mt * 16 + 8], ah[s][mt][3], al[s][mt][3]);
            }
        }
        const float* tb = ts + (k0 + kk + l.t) * C::TS + l.rod0 + l.g;
#pragma unroll
        for (int nt = 0; nt < C::NT; ++nt) {
            const int col = (nt / C::JR) * C::R + (nt % C::JR) * 8;
            uint32_t bh[2][2], bl[2][2];
#pragma unroll
            for (int s = 0; s < 2; ++s) {
                split_tf32(tb[8 * s * C::TS + col], bh[s][0], bl[s][0]);
                split_tf32(tb[(8 * s + 4) * C::TS + col], bh[s][1], bl[s][1]);
            }
#pragma unroll
            for (int mt = 0; mt < C::MT; ++mt) {
                float d[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
                for (int s = 0; s < 2; ++s) {   // the two small products first
                    mma_tf32(d, al[s][mt], bh[s][0], bh[s][1]);
                    mma_tf32(d, ah[s][mt], bl[s][0], bl[s][1]);
                    mma_tf32(d, ah[s][mt], bh[s][0], bh[s][1]);
                }
#pragma unroll
                for (int q = 0; q < 4; ++q) acc[mt][nt][q] += d[q];
            }
        }
    }
}

// acc += G T over k < npts, T complete in ts once every thread arrives.
// Every thread of the block must call it; it begins and ends with a block
// barrier; it expects request_g's copies issued, and a streamed G requests
// the next product's first slab before it returns.
template <int P>
__device__ __forceinline__ void gemm(float* gs, const float* __restrict__ gt, const float* ts,
                                     int npts, int tid, const Lane& l,
                                     float (&acc)[Cfg<P>::MT][Cfg<P>::NT][4]) {
    using C = Cfg<P>;
    const int kend = (npts + 15) & ~15;   // G^T's rows past npts are zero
    if constexpr (C::kResident) {
        cp_async_wait<0>();
        __syncthreads();
        mma_slab<P>(gs, ts, 0, kend, l, acc);
        __syncthreads();
    } else {
        const int nslab = (kend + C::KS - 1) / C::KS;
        for (int s = 0; s < nslab; ++s) {
            if (s + 1 < nslab) {
                load_gt<P>(gs + ((s + 1) & 1) * C::KS * C::GS, gt, (s + 1) * C::KS, C::KS, tid);
                cp_async_wait<1>();
            } else {
                cp_async_wait<0>();
            }
            __syncthreads();
            const int k0 = s * C::KS;
            mma_slab<P>(gs + (s & 1) * C::KS * C::GS, ts, k0, min(C::KS, kend - k0), l, acc);
            __syncthreads();
        }
        request_g<P>(gs, gt, tid);
    }
}

}  // namespace tc
