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
// Bound on the H100: FP32 issue slots. An SM sub-partition issues one warp
// instruction a clock, so the FP32 pipes give 132 SMs x 128 lanes x 1.98
// GHz = 33.5 T instruction slots/s (the 67 TFLOP/s of the data sheet counts
// an FFMA as two FLOP). The exact-difference d2 cannot use an FFMA, since
// it must equal its twin bit for bit: it costs 8 slots a query-target pair
// (3 __fsub_rn, 3 __fmul_rn, 2 __fadd_rn). The augmented form costs 5
// (FMUL, 2 FFMA, 2 FADD). The stage-1 ADD-S match (5 samples x 500k
// queries x 500 targets, 1.25e9 pairs) therefore needs at least 0.299 ms
// exact and 0.187 ms augmented, while its bytes (queries in, coordinates
// out: 60 MB) take 0.018 ms. (ops/knn.py `issue_slots` counts them.)
//
// Exact forms (nn_kernel, simple first): one thread per query, holding it
// in registers. A block of 256 queries of one sample stages that sample's
// targets through shared memory in chunks of 1024, as SoA arrays padded to
// a multiple of 4, so every thread of a warp reads the same address (a
// broadcast) and one float4 load brings four targets' x. Any M2 works: the
// chunk loop covers it (500: one chunk; YCB's 2600 large mesh: three).
// Padded slots hold +inf coordinates, so their d2 is +inf and never wins.
// A running (dmin, index) updated on a strict `<`, scanning targets in
// increasing index, yields the first argmin without the JAX kernels' +1e9
// sentinels. The matched coordinates are read back from device memory at
// the found index, so they are the targets' exact values. They reach
// 53-55% of their bound and are not redesigned.
//
// Augmented form (nn_mxu_kernel): the one-query loop above paid about 9
// issue slots a pair for 5 FP32 operations (a shared load per pair, and a
// compare and two selects per pair). Here a thread holds kMxuQ = 4 queries,
// so one set of shared loads (8 float4: 8 targets' -2x, -2y, -2z, |b|^2)
// serves 32 pairs, and the running minimum is updated once per group of
// kMxuG = 8 targets: the group's least d2 by a tree of 7 FMNMX, then one
// compare and two selects that keep the least d2 and the group's first
// index, on a strict `<`, so an earlier group wins a tie. About 6.4 slots
// a pair. After each chunk the index inside the group is recovered for
// each query whose minimum fell in that chunk: the group's d2 are computed
// again from the staged targets, by the same rounded steps, and the first
// equal to the minimum wins (in shared memory: read back from device
// memory after the scan, each query would wait on its loads in turn).
// FMNMX, not an integer minimum on the float bits: the product-form d2 can
// be negative after cancellation. Padded slots hold an +inf |b|^2.
#include <math.h>

#include "common.cuh"

namespace plr2 {
namespace {

constexpr int kThreads = 256;
constexpr int kChunk = 1024;  // targets per shared-memory stage

enum Mode : int { kArgmin = 0, kMatch = 1 };

template <int kMode>
__global__ void __launch_bounds__(kThreads)
    nn_kernel(const float* __restrict__ q, const float* __restrict__ t,
              void* __restrict__ out, int P, int M2) {
  __shared__ __align__(16) float sx[kChunk];
  __shared__ __align__(16) float sy[kChunk];
  __shared__ __align__(16) float sz[kChunk];

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
      sx[e] = bx;
      sy[e] = by;
      sz[e] = bz;
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
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const float dx = __fsub_rn(ax, xs[k]);
        const float dy = __fsub_rn(ay, ys[k]);
        const float dz = __fsub_rn(az, zs[k]);
        const float d2 = __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)),
                                   __fmul_rn(dz, dz));
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


// ---------------------------------------------------------------------------
// Augmented form: kMxuQ queries a thread, a running minimum per group of
// kMxuG targets (see the header note).

constexpr int kMxuThreads = 128;
constexpr int kMxuQ = 4;  // queries a thread
constexpr int kMxuG = 8;  // targets a group

// The augmented d2 of query (ax, ay, az, a2) against a staged target
// (-2b, |b|^2): a . (-2b) term by term in FMAs, then + |a|^2, then + |b|^2.
__device__ __forceinline__ float d2_augmented(float ax, float ay, float az, float a2,
                                              float nx, float ny, float nz, float b2) {
  const float d = fmaf(az, nz, fmaf(ay, ny, __fmul_rn(ax, nx)));
  return __fadd_rn(__fadd_rn(d, a2), b2);
}

__device__ __forceinline__ float sq_norm(float x, float y, float z) {
  return __fadd_rn(__fadd_rn(__fmul_rn(x, x), __fmul_rn(y, y)), __fmul_rn(z, z));
}

__global__ void __launch_bounds__(kMxuThreads, 8)
    nn_mxu_kernel(const float* __restrict__ q, const float* __restrict__ t,
                  float* __restrict__ out, int P, int M2) {
  __shared__ __align__(16) float sx[kChunk];
  __shared__ __align__(16) float sy[kChunk];
  __shared__ __align__(16) float sz[kChunk];
  __shared__ __align__(16) float sw[kChunk];

  const int s = blockIdx.y;
  const int p0 = blockIdx.x * kMxuThreads * kMxuQ + threadIdx.x;
  const float* ts = t + (size_t)s * M2 * 3;
  float ax[kMxuQ], ay[kMxuQ], az[kMxuQ], a2[kMxuQ], dmin[kMxuQ];
  int best[kMxuQ];
#pragma unroll
  for (int i = 0; i < kMxuQ; ++i) {
    const int p = p0 + i * kMxuThreads;
    ax[i] = ay[i] = az[i] = 0.f;
    if (p < P) {
      const float* qp = q + ((size_t)s * P + p) * 3;
      ax[i] = qp[0];
      ay[i] = qp[1];
      az[i] = qp[2];
    }
    a2[i] = sq_norm(ax[i], ay[i], az[i]);
    dmin[i] = INFINITY;
    best[i] = 0;  // the group's first target, then the target itself
  }

  for (int c0 = 0; c0 < M2; c0 += kChunk) {
    const int n = min(kChunk, M2 - c0);
    const int ng = (n + kMxuG - 1) / kMxuG * kMxuG;
    __syncthreads();  // the previous chunk is consumed
    for (int e = threadIdx.x; e < ng; e += kMxuThreads) {
      const bool real = e < n;
      const float* tp = ts + (size_t)(c0 + (real ? e : 0)) * 3;
      const float bx = tp[0], by = tp[1], bz = tp[2];
      sx[e] = real ? -2.f * bx : 0.f;
      sy[e] = real ? -2.f * by : 0.f;
      sz[e] = real ? -2.f * bz : 0.f;
      sw[e] = real ? sq_norm(bx, by, bz) : INFINITY;
    }
    __syncthreads();
    for (int j = 0; j < ng; j += kMxuG) {
      float nx[kMxuG], ny[kMxuG], nz[kMxuG], b2[kMxuG];
#pragma unroll
      for (int h = 0; h < kMxuG; h += 4) {
        const float4 X = *reinterpret_cast<const float4*>(sx + j + h);
        const float4 Y = *reinterpret_cast<const float4*>(sy + j + h);
        const float4 Z = *reinterpret_cast<const float4*>(sz + j + h);
        const float4 W = *reinterpret_cast<const float4*>(sw + j + h);
        nx[h] = X.x, nx[h + 1] = X.y, nx[h + 2] = X.z, nx[h + 3] = X.w;
        ny[h] = Y.x, ny[h + 1] = Y.y, ny[h + 2] = Y.z, ny[h + 3] = Y.w;
        nz[h] = Z.x, nz[h + 1] = Z.y, nz[h + 2] = Z.z, nz[h + 3] = Z.w;
        b2[h] = W.x, b2[h + 1] = W.y, b2[h + 2] = W.z, b2[h + 3] = W.w;
      }
#pragma unroll
      for (int i = 0; i < kMxuQ; ++i) {
        float d[kMxuG];
#pragma unroll
        for (int k = 0; k < kMxuG; ++k)
          d[k] = d2_augmented(ax[i], ay[i], az[i], a2[i], nx[k], ny[k], nz[k], b2[k]);
#pragma unroll
        for (int w = 1; w < kMxuG; w *= 2)
#pragma unroll
          for (int k = 0; k < kMxuG; k += 2 * w) d[k] = fminf(d[k], d[k + w]);
        const bool lower = d[0] < dmin[i];
        dmin[i] = lower ? d[0] : dmin[i];
        best[i] = lower ? c0 + j : best[i];
      }
    }
    // a minimum found in this chunk: the first target of its group whose d2
    // equals it, from the staged values (padded slots give +inf)
#pragma unroll
    for (int i = 0; i < kMxuQ; ++i) {
      if (best[i] < c0 || !(dmin[i] < INFINITY)) continue;
      const int g = best[i] - c0;
      int first = 0;
#pragma unroll
      for (int k = kMxuG - 1; k >= 0; --k) {
        const float dk = d2_augmented(ax[i], ay[i], az[i], a2[i], sx[g + k],
                                      sy[g + k], sz[g + k], sw[g + k]);
        first = dk == dmin[i] ? k : first;
      }
      best[i] += first;  // found: a minimum of the group is one of its d2
    }
  }

#pragma unroll
  for (int i = 0; i < kMxuQ; ++i) {
    const int p = p0 + i * kMxuThreads;
    if (p >= P) continue;
    const float* tb = ts + (size_t)best[i] * 3;
    float* o = out + ((size_t)s * P + p) * 3;
    o[0] = tb[0];
    o[1] = tb[1];
    o[2] = tb[2];
  }
}

int launch_mxu(const void* q, const void* t, void* out, int S, int P, int M2,
               cudaStream_t stream) {
  if (S < 0 || P < 0 || M2 < 1) return (int)cudaErrorInvalidValue;
  if (S > 0 && P > 0) {
    const dim3 grid((P + kMxuThreads * kMxuQ - 1) / (kMxuThreads * kMxuQ), S);
    nn_mxu_kernel<<<grid, kMxuThreads, 0, stream>>>(
        static_cast<const float*>(q), static_cast<const float*>(t),
        static_cast<float*>(out), P, M2);
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
  return plr2::launch_mxu(q, t, out, S, P, M2, static_cast<cudaStream_t>(stream));
}
