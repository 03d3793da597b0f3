// Helpers of fused_ffn.cu's CUDA-core kernels: 4-element stores in the storage
// dtype (the counterpart of layer_common.cuh's load4) and the opt-in to more
// than 48 KB of dynamic shared memory.

#pragma once

#include "layer_common.cuh"

namespace {

__device__ __forceinline__ void store4(float* p, const float* v) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}
// round to nearest even, as st<__nv_bfloat16>
__device__ __forceinline__ void store4(__nv_bfloat16* p, const float* v) {
  const __nv_bfloat162 lo = __floats2bfloat162_rn(v[0], v[1]);
  const __nv_bfloat162 hi = __floats2bfloat162_rn(v[2], v[3]);
  uint2 u;
  u.x = *reinterpret_cast<const uint32_t*>(&lo);
  u.y = *reinterpret_cast<const uint32_t*>(&hi);
  *reinterpret_cast<uint2*>(p) = u;
}

// let `kernel` take `smem` bytes of dynamic shared memory; 0 or a cudaError
template <typename Kernel>
int opt_in(Kernel kernel, size_t smem) {
  if (smem <= 48 * 1024) return 0;
  return static_cast<int>(cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem)));
}

}  // namespace
