// PSP decoder stage: out = prelu(conv3x3(upsample2x(x), w) + bias, alpha).
//
// Replaces the TPU kernel plr2_tpu/ops/pallas_upsample.py
// `fused_upconv3x3_prelu` (`_kernel`). This is the forward; the backward is
// plain PyTorch (ops/upconv.py), as the JAX custom VJP's is plain XLA, so no
// backward kernel exists on either side. x is NHWC (B, H, W,
// Cin), w is HWIO (3, 3, Cin, Cout), out is NHWC (B, 2H, 2W, Cout). The
// upsample is the half-pixel (align_corners=False) bilinear 2x with clamped
// edges: output row 2t = 0.25 x[t-1] + 0.75 x[t], row 2t+1 = 0.75 x[t] +
// 0.25 x[t+1], columns alike; the conv reads zeros outside the 2x map.
//
// Bound on the H100: operations. up_1 at 160 px crops is 2*40*40*9*1024*256
// = 7.5 GFLOP per frame over ~0.6 MB of input and ~0.8 MB of output (bf16).
//
// Design (simple first): a block owns an 8 x 16 tile of output pixels and
// 64 output channels. For each chunk of 16 input channels it forms the
// upsampled 10 x 18 patch (the tile plus the conv's 1-pixel halo) on the
// fly from the low-res input, rounded to the input dtype as a stored
// upsampled map would be, together with the chunk's 3x3x16x64 weights, in
// shared memory; the 2x map is never written to device memory. Each thread
// accumulates 8 pixels x 4 channels in f32 with scalar FP32 FMAs; the
// epilogue adds the bias, applies the scalar PReLU and casts once. Tensor
// cores (an implicit GEMM with M = pixels, N = Cout, K = 9 Cin) are later
// work.
#include "common.cuh"

namespace plr2 {
namespace {

constexpr int kThreads = 256;
constexpr int kTH = 8, kTW = 16;            // output tile (2x resolution)
constexpr int kPH = kTH + 2, kPW = kTW + 2; // with the conv halo
constexpr int kCO = 64;                     // output channels per block
constexpr int kCK = 16;                     // input channels per chunk
constexpr int kUS = kCK + 1;                // padded pixel stride in smem
constexpr int kSmemBytes = (int)sizeof(float) * (kPH * kPW * kUS + 9 * kCK * kCO);

// source taps of 2x-map coordinate Y (0 <= Y < 2n): rows (a, b), weights (wa, wb)
__device__ __forceinline__ void taps(int Y, int n, int& a, int& b, float& wa,
                                     float& wb) {
  const int t = Y >> 1;
  if (Y & 1) {
    a = t; b = min(t + 1, n - 1); wa = 0.75f; wb = 0.25f;
  } else {
    a = max(t - 1, 0); b = t; wa = 0.25f; wb = 0.75f;
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads) upconv_kernel(
    const T* __restrict__ x, const T* __restrict__ w,
    const T* __restrict__ bias, const T* __restrict__ alpha,
    T* __restrict__ out, int H, int W, int Cin, int Cout) {
  extern __shared__ __align__(16) float smem[];
  float* us = smem;                       // [kPH][kPW][kUS] upsampled patch
  float* wsm = smem + kPH * kPW * kUS;    // [9][kCK][kCO] weights
  const int H2 = 2 * H, W2 = 2 * W;
  const int tiles_w = (W2 + kTW - 1) / kTW;
  const int oy0 = (blockIdx.x / tiles_w) * kTH;
  const int ox0 = (blockIdx.x % tiles_w) * kTW;
  const int co0 = blockIdx.y * kCO;
  const int b = blockIdx.z;
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int py = ty >> 1, px0 = (ty & 1) * 8;  // this thread: 8 pixels of one row
  const T* xb = x + (size_t)b * H * W * Cin;

  float acc[8][4];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int c0 = 0; c0 < Cin; c0 += kCK) {
    for (int e = tid; e < kPH * kPW * kCK; e += kThreads) {
      const int c = e % kCK, q = e / kCK;
      const int Y = oy0 - 1 + q / kPW, X = ox0 - 1 + q % kPW, ci = c0 + c;
      float v = 0.f;  // the conv's zero padding, and channels past Cin
      if (Y >= 0 && Y < H2 && X >= 0 && X < W2 && ci < Cin) {
        int ya, yb, xa, xc;
        float wya, wyb, wxa, wxc;
        taps(Y, H, ya, yb, wya, wyb);
        taps(X, W, xa, xc, wxa, wxc);
        const float r0 = wxa * to_f<T>(xb[((size_t)ya * W + xa) * Cin + ci]) +
                         wxc * to_f<T>(xb[((size_t)ya * W + xc) * Cin + ci]);
        const float r1 = wxa * to_f<T>(xb[((size_t)yb * W + xa) * Cin + ci]) +
                         wxc * to_f<T>(xb[((size_t)yb * W + xc) * Cin + ci]);
        v = round_to<T>(wya * r0 + wyb * r1);
      }
      us[q * kUS + c] = v;
    }
    for (int e = tid; e < 9 * kCK * kCO; e += kThreads) {
      const int co = e % kCO, q = e / kCO;
      const int c = q % kCK, tap = q / kCK;
      const int ci = c0 + c, o = co0 + co;
      wsm[e] = (ci < Cin && o < Cout)
                   ? to_f<T>(w[((size_t)tap * Cin + ci) * Cout + o])
                   : 0.f;
    }
    __syncthreads();
#pragma unroll 1
    for (int tap = 0; tap < 9; ++tap) {
      const int dy = tap / 3, dx = tap % 3;
      const float* urow = us + ((py + dy) * kPW + px0 + dx) * kUS;
      const float* wt = wsm + tap * kCK * kCO + tx;
#pragma unroll 4
      for (int c = 0; c < kCK; ++c) {
        float wv[4], uv[8];
#pragma unroll
        for (int j = 0; j < 4; ++j) wv[j] = wt[c * kCO + 16 * j];
#pragma unroll
        for (int i = 0; i < 8; ++i) uv[i] = urow[i * kUS + c];
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(uv[i], wv[j], acc[i][j]);
      }
    }
    __syncthreads();
  }

  const float a = to_f<T>(alpha[0]);
  const int oy = oy0 + py;
  if (oy >= H2) return;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int o = co0 + tx + 16 * j;
    if (o >= Cout) continue;
    const float bv = to_f<T>(bias[o]);
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int ox = ox0 + px0 + i;
      if (ox >= W2) continue;
      float v = acc[i][j] + bv;
      v = v >= 0.f ? v : a * v;
      out[(((size_t)b * H2 + oy) * W2 + ox) * Cout + o] = from_f<T>(v);
    }
  }
}

template <typename T>
int launch(const void* x, const void* w, const void* bias, const void* alpha,
           void* out, int B, int H, int W, int Cin, int Cout,
           cudaStream_t stream) {
  static int granted = 0;
  auto kernel = upconv_kernel<T>;
  cudaError_t err = allow_smem(kernel, kSmemBytes, granted);
  if (err != cudaSuccess) return (int)err;
  if (B > 0 && H > 0 && W > 0 && Cout > 0) {
    const int tiles = ((2 * H + kTH - 1) / kTH) * ((2 * W + kTW - 1) / kTW);
    dim3 grid(tiles, (Cout + kCO - 1) / kCO, B);
    kernel<<<grid, kThreads, kSmemBytes, stream>>>(
        static_cast<const T*>(x), static_cast<const T*>(w),
        static_cast<const T*>(bias), static_cast<const T*>(alpha),
        static_cast<T*>(out), H, W, Cin, Cout);
  }
  return (int)cudaGetLastError();
}

}  // namespace
}  // namespace plr2

// x (B, H, W, Cin), w (3, 3, Cin, Cout), bias (Cout,), alpha (1,) on the
// device; out (B, 2H, 2W, Cout); all contiguous, one dtype.
extern "C" int plr2_upconv3x3_prelu(int dtype, const void* x, const void* w,
                                    const void* bias, const void* alpha,
                                    void* out, int B, int H, int W, int Cin,
                                    int Cout, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == plr2::kBF16)
    return plr2::launch<__nv_bfloat16>(x, w, bias, alpha, out, B, H, W, Cin,
                                       Cout, s);
  if (dtype == plr2::kF32)
    return plr2::launch<float>(x, w, bias, alpha, out, B, H, W, Cin, Cout, s);
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* plr2_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
