// Backward of the choose gather: a deterministic segment sum.
//
// The forward gathers rows of the decoder's output, y (B, HW, C), at the
// `choose` indices idx (B, N) into (B, N, C). Its gradient is
//   dy[b, h, :] = sum over n with idx[b, n] == h of ct[b, n, :],
// which torch.gather's own backward (scatter_add_) computes with atomic
// adds on the card: where a mask has fewer pixels than N, `choose` repeats
// indices (the wrap path of `sample_choose`), the adds of one row land in
// an order that changes from run to run, and so do the f32 sums. This
// kernel adds each row's contributions in ascending n, whatever the run.
//
// This is a repair, not the port of a TPU kernel: the JAX package's
// `plr2_tpu/ops/gather.py` `gather_rows` writes the same backward as a
// one-hot contraction, which XLA runs as a product. At the port's full
// 160 x 160 decoder resolution that one-hot (B, N, HW) would be 3.3 GB at
// batch 32, so the port sums segments instead.
//
// Design: the wrapper (ops/gather.py) stable-sorts each sample's indices,
// which keeps equal indices in ascending n, and passes the sorted indices
// and the permutation. The launcher zeroes dy (cudaMemsetAsync: rows that
// no index points at get no thread). Then a row of 64 threads takes one
// sorted position k of one sample; if k starts a segment (k == 0 or its
// index differs from k - 1's), it walks the segment, adding ct[b, perm[k],
// c] into an f32 register for its channels c, and writes the row once. No
// atomics, and the result is, bit for bit, the sequential index_add_ of the
// plain twin: 0 + a0 + a1 + ... in ascending n, in f32, rounded once to the
// output dtype.
//
// Bound on the H100: bytes. ct is read once (B N C), the indices once and
// dy written once (B HW C); at the stage-1 shape (batch 32, 1000 points, a
// 160 x 160 map, 64 channels, f32) that is 0.22 GB, 0.065 ms at 3.35 TB/s,
// and dy's write is 96% of it: the memset writes all of dy, the segment
// rows (at most N of HW per sample) write their rows a second time. (A
// first design gave every output row a thread that binary-searched the
// sorted indices: 819,200 searches at that shape, for rows that are mostly
// empty, and it ran several times slower.)

#include "common.cuh"

namespace plr2 {
namespace {

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

constexpr int kRowsPerBlock = 4;  // blockDim.y: sorted positions of a block
constexpr int kLanes = 64;        // blockDim.x: channels a pass

template <typename T>
__global__ void __launch_bounds__(kLanes * kRowsPerBlock)
gather_bwd_kernel(const T* __restrict__ ct, const int64_t* __restrict__ sidx,
                  const int64_t* __restrict__ perm, T* __restrict__ dy, int B,
                  int N, int HW, int C) {
  const int64_t pos = static_cast<int64_t>(blockIdx.x) * kRowsPerBlock + threadIdx.y;
  if (pos >= static_cast<int64_t>(B) * N) return;
  const int b = static_cast<int>(pos / N);
  const int k0 = static_cast<int>(pos % N);
  const int64_t* s = sidx + static_cast<int64_t>(b) * N;
  const int64_t h = s[k0];
  if (k0 > 0 && s[k0 - 1] == h) return;  // not the start of a segment
  const int64_t* p = perm + static_cast<int64_t>(b) * N;
  const T* src = ct + static_cast<int64_t>(b) * N * C;
  T* out = dy + (static_cast<int64_t>(b) * HW + h) * C;
  for (int c = threadIdx.x; c < C; c += kLanes) {
    float acc = 0.0f;
    for (int k = k0; k < N && s[k] == h; ++k)
      acc = __fadd_rn(acc, to_f32(src[p[k] * C + c]));
    out[c] = from_f32<T>(acc);
  }
}

template <typename T>
int launch_gather_bwd(const void* ct, const void* sidx, const void* perm,
                      void* dy, int B, int N, int HW, int C, cudaStream_t stream) {
  cudaError_t err = cudaMemsetAsync(
      dy, 0, static_cast<size_t>(B) * HW * C * sizeof(T), stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int64_t rows = static_cast<int64_t>(B) * N;
  if (rows == 0 || C == 0) return cudaSuccess;
  const dim3 block(kLanes, kRowsPerBlock);
  const unsigned grid = static_cast<unsigned>((rows + kRowsPerBlock - 1) / kRowsPerBlock);
  gather_bwd_kernel<T><<<grid, block, 0, stream>>>(
      static_cast<const T*>(ct), static_cast<const int64_t*>(sidx),
      static_cast<const int64_t*>(perm), static_cast<T*>(dy), B, N, HW, C);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
}  // namespace plr2

// ct (B, N, C) and dy (B, HW, C) of dtype `dtype` (csrc/common.cuh codes);
// sidx, perm (B, N) int64: each sample's indices stable-sorted ascending and
// their original positions, each index in [0, HW). dy is written whole.
extern "C" int plr2_gather_rows_backward(int dtype, const void* ct,
                                         const void* sidx, const void* perm,
                                         void* dy, int B, int N, int HW, int C,
                                         void* stream) {
  auto st = static_cast<cudaStream_t>(stream);
  if (dtype == plr2::kF32)
    return plr2::launch_gather_bwd<float>(ct, sidx, perm, dy, B, N, HW, C, st);
  if (dtype == plr2::kBF16)
    return plr2::launch_gather_bwd<__nv_bfloat16>(ct, sidx, perm, dy, B, N, HW, C, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
