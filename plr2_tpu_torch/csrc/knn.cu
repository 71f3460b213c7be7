// ADD-S nearest-neighbour search: for every query point, the FIRST target
// index of least squared distance (the upstream lib/knn extension's `inds`,
// 0-based), and optionally that target's coordinates.
//
// Replaces the TPU kernels of plr2_tpu/ops/pallas_knn.py:
//   plr2_nn_argmin    <- `nn_argmin_pallas`    (`_argmin_kernel`)
//   plr2_nn_match     <- `nn_match_pallas`     (`_match_coords_kernel`)
//   plr2_nn_match_mxu <- `nn_match_pallas_mxu` (`_match_coords_kernel_mxu`)
// The TPU kernels take one target cloud for all queries; these take a batch:
// queries (S, P, 3) against per-sample targets (S, M2, 3), f32, so all the
// symmetric samples of a training step go in one launch.
//
// d2, two forms:
//  - exact difference (argmin, match): ((dx*dx + dy*dy) + dz*dz) with
//    __fsub_rn/__fmul_rn/__fadd_rn, so nvcc cannot contract it into FMAs.
//    This is, bit for bit, the d2 of the plain PyTorch twin (elementwise ops
//    in the same order) and of the JAX kernel in interpret mode, so the
//    indices agree exactly.
//  - augmented product (match_mxu): [a, |a|^2, 1, 0, 0, 0] . [-2b, 1, |b|^2,
//    0, 0, 0] accumulated term by term in FP32 FMAs (no tensor cores, so no
//    TF32 rounding of coordinates). |a|^2 and |b|^2 are rounded products and
//    sums. The plain twin rounds each product, so the two may pick different
//    targets where two targets are within an ulp of a tie.
//
// Bound on the H100: FP32 operations. Counting 8 FLOP per query-target pair
// (3 subtractions, 3 products, 2 sums), the stage-1 ADD-S match (5 samples x
// 500k queries x 500 targets) is 1.0e10 FLOP, 0.15 ms at 67 TFLOP/s, while
// its bytes (queries in, coordinates out: 60 MB) take 0.018 ms.
//
// Design (simple first): one thread per query, holding it in registers. A
// block of 256 queries of one sample stages that sample's targets through
// shared memory in chunks of 1024, as SoA arrays padded to a multiple of 4,
// so every thread of a warp reads the same address (a broadcast) and one
// float4 load brings four targets' x. Any M2 works: the chunk loop covers
// it (500: one chunk; YCB's 2600 large mesh: three). Padded slots hold +inf
// coordinates (exact form) or an +inf |b|^2 (augmented form), so their d2 is
// +inf and never wins. A running (dmin, index) updated on a strict `<`,
// scanning targets in increasing index, yields the first argmin without the
// JAX kernels' +1e9 sentinels. The matched coordinates are read back from
// device memory at the found index, so they are the targets' exact values.
#include <math.h>

#include "common.cuh"

namespace plr2 {
namespace {

constexpr int kThreads = 256;
constexpr int kChunk = 1024;  // targets per shared-memory stage

enum Mode : int { kArgmin = 0, kMatch = 1, kMatchMxu = 2 };

template <int kMode>
__global__ void __launch_bounds__(kThreads)
    nn_kernel(const float* __restrict__ q, const float* __restrict__ t,
              void* __restrict__ out, int P, int M2) {
  __shared__ __align__(16) float sx[kChunk];
  __shared__ __align__(16) float sy[kChunk];
  __shared__ __align__(16) float sz[kChunk];
  __shared__ __align__(16) float sw[kMode == kMatchMxu ? kChunk : 4];

  const int s = blockIdx.y;
  const int p = blockIdx.x * kThreads + threadIdx.x;
  const bool live = p < P;
  const float* ts = t + (size_t)s * M2 * 3;
  float ax = 0.f, ay = 0.f, az = 0.f;
  if (live) {
    const float* qp = q + ((size_t)s * P + p) * 3;
    ax = qp[0];
    ay = qp[1];
    az = qp[2];
  }
  const float a2 = __fadd_rn(__fadd_rn(__fmul_rn(ax, ax), __fmul_rn(ay, ay)),
                             __fmul_rn(az, az));

  float dmin = INFINITY;
  int best = 0;
  for (int c0 = 0; c0 < M2; c0 += kChunk) {
    const int n = min(kChunk, M2 - c0);
    const int n4 = (n + 3) & ~3;
    __syncthreads();  // the previous chunk is consumed
    for (int e = threadIdx.x; e < n4; e += kThreads) {
      float bx = INFINITY, by = INFINITY, bz = INFINITY;
      if (e < n) {
        const float* tp = ts + (size_t)(c0 + e) * 3;
        bx = tp[0];
        by = tp[1];
        bz = tp[2];
      }
      if (kMode == kMatchMxu) {
        const bool real = e < n;
        sx[e] = real ? -2.f * bx : 0.f;
        sy[e] = real ? -2.f * by : 0.f;
        sz[e] = real ? -2.f * bz : 0.f;
        sw[e] = real ? __fadd_rn(__fadd_rn(__fmul_rn(bx, bx), __fmul_rn(by, by)),
                                 __fmul_rn(bz, bz))
                     : INFINITY;
      } else {
        sx[e] = bx;
        sy[e] = by;
        sz[e] = bz;
      }
    }
    __syncthreads();
    if (!live) continue;
    for (int j = 0; j < n4; j += 4) {
      const float4 X = *reinterpret_cast<const float4*>(sx + j);
      const float4 Y = *reinterpret_cast<const float4*>(sy + j);
      const float4 Z = *reinterpret_cast<const float4*>(sz + j);
      const float xs[4] = {X.x, X.y, X.z, X.w};
      const float ys[4] = {Y.x, Y.y, Y.z, Y.w};
      const float zs[4] = {Z.x, Z.y, Z.z, Z.w};
      float ws[4] = {0.f, 0.f, 0.f, 0.f};
      if (kMode == kMatchMxu) {
        const float4 W = *reinterpret_cast<const float4*>(sw + j);
        ws[0] = W.x;
        ws[1] = W.y;
        ws[2] = W.z;
        ws[3] = W.w;
      }
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        float d2;
        if (kMode == kMatchMxu) {
          // a . (-2b), then + |a|^2 * 1, then + 1 * |b|^2
          d2 = fmaf(az, zs[k], fmaf(ay, ys[k], __fmul_rn(ax, xs[k])));
          d2 = __fadd_rn(__fadd_rn(d2, a2), ws[k]);
        } else {
          const float dx = __fsub_rn(ax, xs[k]);
          const float dy = __fsub_rn(ay, ys[k]);
          const float dz = __fsub_rn(az, zs[k]);
          d2 = __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)),
                         __fmul_rn(dz, dz));
        }
        if (d2 < dmin) {
          dmin = d2;
          best = c0 + j + k;
        }
      }
    }
  }
  if (!live) return;
  const size_t row = (size_t)s * P + p;
  if (kMode == kArgmin) {
    static_cast<long long*>(out)[row] = best;
  } else {
    const float* tb = ts + (size_t)best * 3;
    float* o = static_cast<float*>(out) + row * 3;
    o[0] = tb[0];
    o[1] = tb[1];
    o[2] = tb[2];
  }
}

template <int kMode>
int launch(const void* q, const void* t, void* out, int S, int P, int M2,
           cudaStream_t stream) {
  if (S < 0 || P < 0 || M2 < 1) return (int)cudaErrorInvalidValue;
  if (S > 0 && P > 0) {
    const dim3 grid((P + kThreads - 1) / kThreads, S);
    nn_kernel<kMode><<<grid, kThreads, 0, stream>>>(
        static_cast<const float*>(q), static_cast<const float*>(t), out, P, M2);
  }
  return (int)cudaGetLastError();
}

}  // namespace
}  // namespace plr2

// q (S, P, 3) f32; t (S, M2, 3) f32; all contiguous. M2 >= 1.
// out: (S, P) int64 indices.
extern "C" int plr2_nn_argmin(const void* q, const void* t, void* out, int S,
                              int P, int M2, void* stream) {
  return plr2::launch<plr2::kArgmin>(q, t, out, S, P, M2,
                                     static_cast<cudaStream_t>(stream));
}

// out: (S, P, 3) f32 coordinates of the exact-difference first argmin.
extern "C" int plr2_nn_match(const void* q, const void* t, void* out, int S,
                             int P, int M2, void* stream) {
  return plr2::launch<plr2::kMatch>(q, t, out, S, P, M2,
                                    static_cast<cudaStream_t>(stream));
}

// out: (S, P, 3) f32 coordinates of the augmented-product first argmin.
extern "C" int plr2_nn_match_mxu(const void* q, const void* t, void* out,
                                 int S, int P, int M2, void* stream) {
  return plr2::launch<plr2::kMatchMxu>(q, t, out, S, P, M2,
                                       static_cast<cudaStream_t>(stream));
}
