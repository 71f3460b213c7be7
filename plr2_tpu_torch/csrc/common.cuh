// Shared helpers for the hand-written Hopper kernels of plr2_tpu_torch.
//
// The kernels are built by one nvcc call into one shared library with a
// plain C interface (no PyTorch headers) and loaded with ctypes; see
// plr2_tpu_torch/ops/_build.py. Every launcher takes raw device pointers,
// sizes and the CUDA stream, and returns cudaGetLastError() as an int.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace plr2 {

// dtype codes shared with ops/_build.py
enum DType : int { kF32 = 0, kBF16 = 1 };

template <typename T> __device__ __forceinline__ float to_f(T v);
template <> __device__ __forceinline__ float to_f<float>(float v) { return v; }
template <> __device__ __forceinline__ float to_f<__nv_bfloat16>(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// round-to-nearest-even, as torch's float -> bfloat16 conversion
template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// value rounded to T and widened back: the working-type rounding of an
// intermediate that the reference stores in the input dtype
template <typename T> __device__ __forceinline__ float round_to(float v) {
  return to_f<T>(from_f<T>(v));
}

// Raise the dynamic shared-memory limit of `kernel` to `bytes` (needed
// above 48 KB); `granted` remembers the largest limit set so far for this
// kernel instantiation, so the attribute call is made only when it grows.
template <typename K>
inline cudaError_t allow_smem(K kernel, int bytes, int& granted) {
  if (bytes <= granted) return cudaSuccess;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err == cudaSuccess) granted = bytes;
  return err;
}

}  // namespace plr2
