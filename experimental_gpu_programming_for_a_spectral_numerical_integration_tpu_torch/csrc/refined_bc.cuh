// Per-rod boundary pairs of K5, shared by the narrow and wide refined
// kernels (refined_kernel.cu, refined_wide_kernel.cu).
#pragma once

#include <cuda_runtime.h>

namespace refined_bc {

// Per-rod boundary values of K5 (all NULL for K3).
struct Boundary {
    const float* q0_hi;     // (B, 4)
    const float* q0_lo;     // (B, 4) or NULL
    const float* r0_hi;     // (B, 3)
    const float* r0_lo;     // (B, 3) or NULL
    const double* gvec64;   // (P,) -G dn_in
};

// Component c of a rod's f32 pair as one double.
__device__ __forceinline__ double pair_at(const float* hi, const float* lo, long long at) {
    double v = (double)hi[at];
    if (lo != nullptr) v += (double)lo[at];
    return v;
}

}  // namespace refined_bc
