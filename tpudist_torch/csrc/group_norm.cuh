// The GroupNorm pre-activation, shared by K9 and K10 (group_norm.cu).
//
//   x̂   = (x − mean)·rstd
//   pre = x̂·γ + β            (+ residual in add_relu mode)
//
// Each operation is rounded to f32 on its own, in this order: the __f*_rn
// intrinsics are never contracted into an FMA.  The plain PyTorch versions
// (tpudist_torch/ops/group_norm.py::_pre_activation) evaluate the same
// expression one rounded tensor op at a time, so the kernels and the plain
// versions agree bit for bit on the sign of the pre-activation, and with it
// on the ReLU mask that K10 recomputes: an element whose mask flipped would
// take a whole dy into its gradient.
#pragma once

#include <cuda_runtime.h>

namespace tpudist {

__device__ __forceinline__ float gn_xhat(float x, float mean, float rstd) {
  return __fmul_rn(__fsub_rn(x, mean), rstd);
}

__device__ __forceinline__ float gn_pre(float xhat, float gamma, float beta) {
  return __fadd_rn(__fmul_rn(xhat, gamma), beta);
}

}  // namespace tpudist
