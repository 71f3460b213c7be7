// Pose-head ladder: out = L4(relu(L3(relu(L2(relu(L1(x))))))), Li(h) = h Wi^T + bi.
//
// Replaces the TPU kernel plr2_tpu/ops/pallas_fusion.py `fused_mlp_head`
// (`_mlp_kernel`). This is the forward; the backward is plain PyTorch
// (ops/mlp_head.py), as the JAX custom VJP's is plain XLA, so no backward
// kernel exists on either side. Semantics as there: products accumulate in
// f32, the bias is added in f32, and after each ReLU the activation is
// rounded to the input dtype before it feeds the next layer.
//
// Bound on the H100: operations. One head at 1000 points moves ~3 MB of
// weights and x (bf16) per 2*1000*1.1e6 = 2.2 GFLOP: ~700 FLOP/byte, far
// above the card's ~300 FLOP/byte balance point.
//
// Design (simple first): one block owns BM rows and runs the whole ladder
// for them. The block's activations (BM x 640 and BM x 256) stay in shared
// memory between layers and never touch device memory; only x is read and
// only the K-wide result is written. The weights (1408x640 alone is 1.8 MB
// in bf16, far beyond the 227 KB a block can hold) stream through shared
// memory in 32 x 128 tiles, and every layer is computed in 128-column
// passes with a 16x16 thread grid, each thread holding a (BM/16) x 8 tile
// of f32 accumulators fed by scalar FP32 FMAs. Tensor cores (mma.sync /
// wgmma) and a TMA ring are later work.
//
// Weights use the torch Linear / Conv1d layout (out, in), row-major.
#include "common.cuh"

namespace plr2 {
namespace {

constexpr int kThreads = 256;
constexpr int kBK = 32;   // depth of one staged tile
constexpr int kBN = 128;  // output columns per pass
constexpr int kTN = 8;    // columns per thread: tx + 16 * j

template <typename T>
__host__ __device__ constexpr int row_pad() {
  return sizeof(T) == 2 ? 2 : 1;  // one 32-bit word
}

// One layer for the block's BM rows: for each 128-column pass, stage W (and
// x, for the first layer) tile by tile, accumulate, then run the epilogue.
template <typename T, int BM, bool kFirst, bool kLast>
__device__ __forceinline__ void layer(
    const T* __restrict__ xg, int m0, int P,      // first layer: x rows
    const T* hin, int lda,                        // later layers: smem input
    int K, const T* __restrict__ w, const T* __restrict__ b, int N,
    T* hout, int ldo,                             // smem output (not last)
    T* __restrict__ og,                           // device output (last)
    float* xs, float* ws) {
  constexpr int TM = BM / 16;
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  for (int n0 = 0; n0 < N; n0 += kBN) {
    float acc[TM][kTN];
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < kTN; ++j) acc[i][j] = 0.f;

    for (int k0 = 0; k0 < K; k0 += kBK) {
      // ws[kk][nn] = W[n0 + nn][k0 + kk]; consecutive threads walk k, so
      // device reads coalesce and the padded smem stores do not conflict
      for (int e = tid; e < kBK * kBN; e += kThreads) {
        const int kk = e % kBK, nn = e / kBK;
        const int n = n0 + nn, k = k0 + kk;
        ws[kk * (kBN + 1) + nn] =
            (n < N && k < K) ? to_f<T>(w[(size_t)n * K + k]) : 0.f;
      }
      if (kFirst) {
        for (int e = tid; e < BM * kBK; e += kThreads) {
          const int kk = e % kBK, r = e / kBK;
          const int m = m0 + r, k = k0 + kk;
          xs[r * (kBK + 1) + kk] =
              (m < P && k < K) ? to_f<T>(xg[(size_t)m * K + k]) : 0.f;
        }
      }
      __syncthreads();
      const int kmax = min(kBK, K - k0);
      for (int kk = 0; kk < kmax; ++kk) {
        float a[TM], bw[kTN];
#pragma unroll
        for (int i = 0; i < TM; ++i)
          a[i] = kFirst ? xs[(ty * TM + i) * (kBK + 1) + kk]
                        : to_f<T>(hin[(ty * TM + i) * lda + k0 + kk]);
#pragma unroll
        for (int j = 0; j < kTN; ++j) bw[j] = ws[kk * (kBN + 1) + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < TM; ++i)
#pragma unroll
          for (int j = 0; j < kTN; ++j) acc[i][j] = fmaf(a[i], bw[j], acc[i][j]);
      }
      __syncthreads();
    }

#pragma unroll
    for (int j = 0; j < kTN; ++j) {
      const int n = n0 + tx + 16 * j;
      if (n >= N) continue;
      const float bias = to_f<T>(b[n]);
#pragma unroll
      for (int i = 0; i < TM; ++i) {
        const int r = ty * TM + i;
        const float v = acc[i][j] + bias;
        if (kLast) {
          if (m0 + r < P) og[(size_t)(m0 + r) * N + n] = from_f<T>(v);
        } else {
          hout[r * ldo + n] = from_f<T>(fmaxf(v, 0.f));
        }
      }
    }
  }
  __syncthreads();  // the layer's output is complete before the next reads it
}

template <typename T, int BM>
__global__ void __launch_bounds__(kThreads) mlp_head_kernel(
    const T* __restrict__ x,
    const T* __restrict__ w1, const T* __restrict__ b1,
    const T* __restrict__ w2, const T* __restrict__ b2,
    const T* __restrict__ w3, const T* __restrict__ b3,
    const T* __restrict__ w4, const T* __restrict__ b4,
    T* __restrict__ out, int P, int C0, int N1, int N2, int N3, int N4) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* xs = reinterpret_cast<float*>(smem);        // [BM][kBK + 1]
  float* ws = xs + BM * (kBK + 1);                   // [kBK][kBN + 1]
  T* ha = reinterpret_cast<T*>(ws + kBK * (kBN + 1));  // h1, later h3
  const int lda = max(N1, N3) + row_pad<T>();
  T* hb = ha + BM * lda;                             // h2
  const int ldb = N2 + row_pad<T>();
  const int m0 = blockIdx.x * BM;

  layer<T, BM, true, false>(x, m0, P, nullptr, 0, C0, w1, b1, N1, ha, lda,
                            nullptr, xs, ws);
  layer<T, BM, false, false>(nullptr, m0, P, ha, lda, N1, w2, b2, N2, hb, ldb,
                             nullptr, xs, ws);
  layer<T, BM, false, false>(nullptr, m0, P, hb, ldb, N2, w3, b3, N3, ha, lda,
                             nullptr, xs, ws);
  layer<T, BM, false, true>(nullptr, m0, P, ha, lda, N3, w4, b4, N4, nullptr,
                            0, out, xs, ws);
}

template <typename T, int BM>
int smem_bytes(int N1, int N2, int N3) {
  const int lda = (N1 > N3 ? N1 : N3) + row_pad<T>();
  const int ldb = N2 + row_pad<T>();
  return (int)(sizeof(float) * (BM * (kBK + 1) + kBK * (kBN + 1)) +
               sizeof(T) * BM * (lda + ldb));
}

template <typename T, int BM>
int launch(const void* x, const void* w1, const void* b1, const void* w2,
           const void* b2, const void* w3, const void* b3, const void* w4,
           const void* b4, void* out, int P, int C0, int N1, int N2, int N3,
           int N4, cudaStream_t stream) {
  static int granted = 0;
  const int bytes = smem_bytes<T, BM>(N1, N2, N3);
  auto kernel = mlp_head_kernel<T, BM>;
  cudaError_t err = allow_smem(kernel, bytes, granted);
  if (err != cudaSuccess) return (int)err;
  if (P > 0) {
    auto c = [](const void* p) { return static_cast<const T*>(p); };
    kernel<<<(P + BM - 1) / BM, kThreads, bytes, stream>>>(
        c(x), c(w1), c(b1), c(w2), c(b2), c(w3), c(b3), c(w4), c(b4),
        static_cast<T*>(out), P, C0, N1, N2, N3, N4);
  }
  return (int)cudaGetLastError();
}

}  // namespace
}  // namespace plr2

// Rows per block: 64 in bf16 (64 x 640 bf16 = 80 KB of activations), 32 in
// f32 so that the f32 activations fit the same room. Widths whose shared
// memory exceeds what a block may use make the launch fail with
// cudaErrorInvalidValue from cudaFuncSetAttribute.
// x (P, C0); wi (Ni, N(i-1)); bi (Ni,); out (P, N4); all contiguous, one dtype.
extern "C" int plr2_mlp_head(int dtype, const void* x, const void* w1,
                             const void* b1, const void* w2, const void* b2,
                             const void* w3, const void* b3, const void* w4,
                             const void* b4, void* out, int P, int C0, int N1,
                             int N2, int N3, int N4, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == plr2::kBF16)
    return plr2::launch<__nv_bfloat16, 64>(x, w1, b1, w2, b2, w3, b3, w4, b4,
                                           out, P, C0, N1, N2, N3, N4, s);
  if (dtype == plr2::kF32)
    return plr2::launch<float, 32>(x, w1, b1, w2, b2, w3, b3, w4, b4, out, P,
                                   C0, N1, N2, N3, N4, s);
  return (int)cudaErrorInvalidValue;
}
