// Tensor-core Picard core of every wide kernel (32 < n-1 <= 512 points): K1,
// K2 and K4 wide (rod_wide_kernel.cu) and K3 and K5 wide
// (refined_wide_kernel.cu).  The f32 products S = base + G T of a block of R
// rods run as 3xTF32 mma.sync.m16n8k8 on Hopper's tensor cores, with G and T
// in shared memory.
//
// Points are padded to P (64, 128, 256 or 512); padded points have zero
// operator rows, columns and strain, so they stay exactly zero.  Each Picard
// step is a GEMM with M = P (points), K = P and N = 4R columns, ordered
// component-major, col = c * R + rod.  Warp w owns the MW x 4RW tile of rows
// wm * MW .. and rods wn * RW .. (wm = w % WM, wn = w / WM).  In the m16n8
// accumulator a thread (g = lane / 4, t = lane % 4) holds rows g and g + 8
// of each 16-row m-tile and columns 2t, 2t + 1 of each n-tile, so with the
// component-major order it holds all four quaternion components of its
// (point, rod) pairs: the A(K/2) action of every step is thread-local, and
// the state never leaves the accumulators.
//
// Precision: each operand is split as x_hi = tf32(x) (cvt.rna), x_lo =
// tf32(x - x_hi), and the product sums G_lo T_hi + G_hi T_lo + G_hi T_hi in
// FP32, as accurate as FP32 FMAs here (one pass of TF32 is not: ~1e-7).  The
// tensor cores do not round their FP32 sum to nearest (it mostly truncates
// toward zero), so each 16-deep step is summed in a fresh tile and added to
// the state with a rounded FP32 add.
// The split is made in registers when a fragment is read from shared memory,
// unless the kernel's shape keeps that operand split there (Cfg: twice its
// shared memory; the refined kernels need that room for their FP64 panels).
//
// Shared memory: G^T as gs[k][row] (row stride P + 8) and T as ts[k][col]
// (row stride 4R + 8): both strides are 8 mod 32 banks, so the A and B
// fragment reads and the float2 writes of T are free of bank conflicts.
// When KS = P all of G^T stays resident for the whole kernel; otherwise G^T
// is streamed in k-slabs of KS rows, double-buffered with cp.async so that
// the next slab loads while the current one multiplies.
//
// A quaternion (w, x, y, z) lives in a float4 as (.x, .y, .z, .w).
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "tf32_mma.cuh"

namespace tc {

// Which padded widths the wide launchers take.
inline bool valid_width(int p, int npts) {
    return (p == 64 || p == 128 || p == 256 || p == 512) && npts > 32 && npts <= p;
}

inline int blocks_for(int batch, int rods_per_block) {
    return (batch + rods_per_block - 1) / rods_per_block;
}

// A kernel's launch shape at padded width P_: R_ rods per block, WM_ x WN_
// warps, k-slabs of KS_ rows of G^T (KS_ = P_: G^T resident), the blocks per
// SM its registers are fitted to, and which operands shared memory holds
// already split into TF32 hi and lo planes: G^T (SPLIT_G_, copied from the
// caller's hi and lo planes) and T (SPLIT_T_, split once as it is written).
// A split operand's fragments need no conversion in the k loop, for twice
// its shared memory; the products are the same.
template <int P_, int R_, int WM_, int WN_, int KS_, int BLOCKS_, bool SPLIT_G_ = false,
          bool SPLIT_T_ = false>
struct Cfg {
    static constexpr int P = P_, R = R_, WM = WM_, WN = WN_, KS = KS_;
    static constexpr bool kSplitG = SPLIT_G_, kSplitT = SPLIT_T_;
    static constexpr bool kResident = KS == P;
    static constexpr int kThreads = 32 * WM * WN;
    static constexpr int kMinBlocks = BLOCKS_;
    static constexpr int MW = P / WM, RW = R / WN;   // rows and rods of a warp
    static constexpr int MT = MW / 16, JR = RW / 8;  // m-tiles, rod groups of 8
    static constexpr int NT = 4 * JR;                // n-tiles: component-major
    static constexpr int kAcc = MT * NT * 4;         // accumulator floats a thread holds
    static constexpr int GS = P + 8;                 // row stride of G^T in shared memory
    static constexpr int TS = 4 * R + 8;             // row stride of T in shared memory
    static constexpr int kGPlane = (kResident ? P : KS) * GS;   // a buffer's hi (or only) plane
    static constexpr int kGBuf = (kSplitG ? 2 : 1) * kGPlane;    // floats of a buffer of G^T
    static constexpr int kGFloats = (kResident ? 1 : 2) * kGBuf;
    static constexpr int kTPlane = P * TS;
    static constexpr int kTFloats = (kSplitT ? 2 : 1) * kTPlane;
    static_assert(MW % 16 == 0 && RW % 8 == 0 && P % KS == 0 && KS % 16 == 0, "bad shape");
    static_assert(kAcc * kThreads == 4 * P * R, "every (point, rod) pair once");
};

// Thread coordinates within the block's GEMM.
struct Lane {
    int g, t, row0, rod0;   // row0: the warp's first row; rod0: its first rod
};

template <class C>
__device__ __forceinline__ Lane lane_of(int tid) {
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

// ---- PTX: asynchronous copies (TF32 rounding and the product: tf32_mma.cuh) ----

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

// Rows k0 .. k0 + rows - 1 of G^T into the buffer gs, as gs[k - k0][.] with
// row stride GS; every thread of the block takes part.  gt is (3, P, P),
// row-major in device memory: G^T, then its TF32 hi and lo planes, which a
// split G^T copies (hi at gs, lo at gs + kGPlane).
template <class C>
__device__ __forceinline__ void load_gt(float* gs, const float* __restrict__ gt, int k0,
                                        int rows, int tid) {
    constexpr int kChunks = C::P / 4;   // 16-byte chunks per row
    if constexpr (C::kSplitG) {
        const float* hi = gt + (size_t)C::P * C::P;
        for (int q = tid; q < 2 * rows * kChunks; q += C::kThreads) {
            const int plane = q / (rows * kChunks), k = q / kChunks % rows, c = q % kChunks;
            cp_async16(gs + plane * C::kGPlane + k * C::GS + 4 * c,
                       hi + (size_t)plane * C::P * C::P + (size_t)(k0 + k) * C::P + 4 * c);
        }
    } else {
        for (int q = tid; q < rows * kChunks; q += C::kThreads) {
            const int k = q / kChunks, c = q % kChunks;
            cp_async16(gs + k * C::GS + 4 * c, gt + (size_t)(k0 + k) * C::P + 4 * c);
        }
    }
    cp_async_commit();
}

// Request what the next product reads first: all of G^T (resident) or its
// first slab into buffer 0 (streamed).
template <class C>
__device__ __forceinline__ void request_g(float* gs, const float* __restrict__ gt, int tid) {
    load_gt<C>(gs, gt, 0, C::kResident ? C::P : C::KS, tid);
}

// The TF32 hi and lo parts of an operand element at p[off], split in
// registers, or read from the lo plane `plane` floats on when SPLIT.
template <bool SPLIT, int plane>
__device__ __forceinline__ void operand(const float* p, int off, uint32_t& hi, uint32_t& lo) {
    if constexpr (SPLIT) {
        hi = __float_as_uint(p[off]);
        lo = __float_as_uint(p[plane + off]);
    } else {
        split_tf32(p[off], hi, lo);
    }
}

// acc += G[rows of the warp][k0 + kk] T[k0 + kk][cols of the warp] for
// kk < kcount (a multiple of 16); gs holds G^T rows from k0 on.  The six
// products of each 16-deep step are summed in a fresh tile d and added to acc
// in FP32: the tensor cores' FP32 sum mostly truncates toward zero, so summing
// into acc itself would lose up to an ulp of the state at every step, nearly
// always in the same direction.
template <class C>
__device__ __forceinline__ void mma_slab(const float* gs, const float* ts, int k0, int kcount,
                                         const Lane& l, float (&acc)[C::MT][C::NT][4]) {
    for (int kk = 0; kk < kcount; kk += 16) {
        uint32_t ah[2][C::MT][4], al[2][C::MT][4];
#pragma unroll
        for (int s = 0; s < 2; ++s) {
            const float* ga = gs + (kk + 8 * s + l.t) * C::GS + l.row0 + l.g;
#pragma unroll
            for (int mt = 0; mt < C::MT; ++mt) {
                operand<C::kSplitG, C::kGPlane>(ga, mt * 16, ah[s][mt][0], al[s][mt][0]);
                operand<C::kSplitG, C::kGPlane>(ga, mt * 16 + 8, ah[s][mt][1], al[s][mt][1]);
                operand<C::kSplitG, C::kGPlane>(ga, 4 * C::GS + mt * 16, ah[s][mt][2], al[s][mt][2]);
                operand<C::kSplitG, C::kGPlane>(ga, 4 * C::GS + mt * 16 + 8, ah[s][mt][3],
                                                al[s][mt][3]);
            }
        }
        const float* tb = ts + (k0 + kk + l.t) * C::TS + l.rod0 + l.g;
#pragma unroll
        for (int nt = 0; nt < C::NT; ++nt) {
            const int col = (nt / C::JR) * C::R + (nt % C::JR) * 8;
            uint32_t bh[2][2], bl[2][2];
#pragma unroll
            for (int s = 0; s < 2; ++s) {
                operand<C::kSplitT, C::kTPlane>(tb, 8 * s * C::TS + col, bh[s][0], bl[s][0]);
                operand<C::kSplitT, C::kTPlane>(tb, (8 * s + 4) * C::TS + col, bh[s][1], bl[s][1]);
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
template <class C>
__device__ __forceinline__ void gemm(float* gs, const float* __restrict__ gt, const float* ts,
                                     int npts, int tid, const Lane& l,
                                     float (&acc)[C::MT][C::NT][4]) {
    const int kend = (npts + 15) & ~15;   // G^T's rows past npts are zero
    if constexpr (C::kResident) {
        cp_async_wait<0>();
        __syncthreads();
        mma_slab<C>(gs, ts, 0, kend, l, acc);
        __syncthreads();
    } else {
        const int nslab = (kend + C::KS - 1) / C::KS;
        for (int s = 0; s < nslab; ++s) {
            if (s + 1 < nslab) {
                load_gt<C>(gs + ((s + 1) & 1) * C::kGBuf, gt, (s + 1) * C::KS, C::KS, tid);
                cp_async_wait<1>();
            } else {
                cp_async_wait<0>();
            }
            __syncthreads();
            const int k0 = s * C::KS;
            mma_slab<C>(gs + (s & 1) * C::kGBuf, ts, k0, min(C::KS, kend - k0), l, acc);
            __syncthreads();
        }
        request_g<C>(gs, gt, tid);
    }
}

// ---- the state of a thread's (point, rod) pairs ----

// The thread's accumulator entries of pair (mt, jr, h, e), component c; a
// kernel using it names its configuration C.
#define ACC(mt, jr, h, e, c) acc[mt][(c) * C::JR + (jr)][2 * (h) + (e)]

// The thread's pairs in a loop nest: f(mt, jr, h, e, point, block-local rod).
template <class C, class F>
__device__ __forceinline__ void for_pairs(const Lane& l, F f) {
#pragma unroll
    for (int mt = 0; mt < C::MT; ++mt)
#pragma unroll
        for (int jr = 0; jr < C::JR; ++jr)
#pragma unroll
            for (int h = 0; h < 2; ++h)
#pragma unroll
                for (int e = 0; e < 2; ++e)
                    f(mt, jr, h, e, pair_row(l, mt, h), pair_rod(l, jr, e));
}

// Two rods' component values (a, b) at row[0], row[1], split into the hi and
// lo planes of a split T.
template <class C>
__device__ __forceinline__ void put2(float* row, float a, float b) {
    if constexpr (C::kSplitT) {
        uint32_t ah, al, bh, bl;
        split_tf32(a, ah, al);
        split_tf32(b, bh, bl);
        *reinterpret_cast<float2*>(row) = make_float2(__uint_as_float(ah), __uint_as_float(bh));
        *reinterpret_cast<float2*>(row + C::kTPlane) =
                make_float2(__uint_as_float(al), __uint_as_float(bl));
    } else {
        *reinterpret_cast<float2*>(row) = make_float2(a, b);
    }
}

// Each pair's 4-vector v(mt, jr, h, e) into T.
template <class C, class V>
__device__ __forceinline__ void write_panel(float* ts, const Lane& l, V v) {
#pragma unroll
    for (int mt = 0; mt < C::MT; ++mt)
#pragma unroll
        for (int jr = 0; jr < C::JR; ++jr)
#pragma unroll
            for (int h = 0; h < 2; ++h) {
                const float4 t0 = v(mt, jr, h, 0), t1 = v(mt, jr, h, 1);
                float* row = ts + pair_row(l, mt, h) * C::TS + pair_rod(l, jr, 0);
                put2<C>(row, t0.x, t1.x);
                put2<C>(row + C::R, t0.y, t1.y);
                put2<C>(row + 2 * C::R, t0.z, t1.z);
                put2<C>(row + 3 * C::R, t0.w, t1.w);
            }
}

// The thread's accumulator tile <-> its private slots (layout [j][thread]:
// conflict-free, not shared with other threads).
template <class C>
__device__ __forceinline__ void store_acc(float* slots, int tid,
                                          const float (&acc)[C::MT][C::NT][4]) {
#pragma unroll
    for (int j = 0; j < C::kAcc; ++j) slots[j * C::kThreads + tid] = (&acc[0][0][0])[j];
}

template <class C>
__device__ __forceinline__ void load_acc(const float* slots, int tid,
                                         float (&acc)[C::MT][C::NT][4]) {
#pragma unroll
    for (int j = 0; j < C::kAcc; ++j) (&acc[0][0][0])[j] = slots[j * C::kThreads + tid];
}

template <class C>
__device__ __forceinline__ void zero_acc(float (&acc)[C::MT][C::NT][4]) {
#pragma unroll
    for (int j = 0; j < C::kAcc; ++j) (&acc[0][0][0])[j] = 0.f;
}

// Pair (mt, jr, h, e)'s 4-vector from the thread's slots.
template <class C>
__device__ __forceinline__ float4 load_pair(const float* slots, int tid, int mt, int jr, int h,
                                            int e) {
    const float* at = slots + ((mt * C::NT + jr) * 4 + 2 * h + e) * C::kThreads + tid;
    constexpr int kComponent = 4 * C::JR * C::kThreads;   // ACC's stride between components
    return make_float4(at[0], at[kComponent], at[2 * kComponent], at[3 * kComponent]);
}

// Picard fixed point s = g_rhs + G (A(K/2) s), `iters` steps from s = g_rhs,
// into acc; g_rhs(acc) sets acc to the right-hand side (from the thread's
// slots, or recomputed).  Every thread of the block must call it with the
// same `iters`; it expects request_g's copies issued.
template <class C, class Rhs>
__device__ __forceinline__ void picard(float* gs, const float* __restrict__ gt, float* ts,
                                       int npts, int tid, const Lane& l,
                                       const float (&kh)[C::MT][C::JR][2][2][3], int iters,
                                       float (&acc)[C::MT][C::NT][4], Rhs g_rhs) {
    g_rhs(acc);
    for (int it = 0; it < iters; ++it) {
        write_panel<C>(ts, l, [&](int mt, int jr, int h, int e) {
            return a_apply(kh[mt][jr][h][e], make_float4(ACC(mt, jr, h, e, 0), ACC(mt, jr, h, e, 1),
                                                         ACC(mt, jr, h, e, 2), ACC(mt, jr, h, e, 3)));
        });
        g_rhs(acc);
        gemm<C>(gs, gt, ts, npts, tid, l, acc);
    }
}

// Launch `kernel` over the batch with `bytes` of dynamic shared memory;
// returns the launch's error.
template <class C, class... Params, class... Args>
int launch(void (*kernel)(Params...), size_t bytes, int batch, cudaStream_t stream,
           Args... args) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (err != cudaSuccess) return (int)err;
    kernel<<<blocks_for(batch, C::R), C::kThreads, bytes, stream>>>(args...);
    return (int)cudaGetLastError();
}

}  // namespace tc
