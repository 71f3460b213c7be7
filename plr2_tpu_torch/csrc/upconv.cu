// PSP decoder stage: out = prelu(conv3x3(upsample2x(x), w) + bias, alpha).
//
// Replaces the TPU kernel plr2_tpu/ops/pallas_upsample.py
// `fused_upconv3x3_prelu` (`_kernel`). This is the forward; the backward is
// plain PyTorch (ops/upconv.py), as the JAX custom VJP's is plain XLA, so no
// backward kernel exists on either side. x is NHWC (B, H, W, Cin), out is
// NHWC (B, 2H, 2W, Cout). The upsample is the half-pixel
// (align_corners=False) bilinear 2x with clamped edges: output row 2t =
// 0.25 x[t-1] + 0.75 x[t], row 2t+1 = 0.75 x[t] + 0.25 x[t+1], columns
// alike (columns first, then rows); the upsampled map is rounded to the
// input dtype; the conv reads zeros outside the 2x map; bias and the scalar
// PReLU in f32; one rounding at the end.
//
// Main path at 160 px crops (low-res h x w x Cin -> 2h x 2w x Cout):
// up_1 20x20x1024 -> 40x40x256 (7.5 GFLOP a frame), up_2 40x40x256 ->
// 80x80x64 (1.9), up_3 80x80x64 -> 160x160x64 (1.9).
//
// bf16: tensor cores (wgmma + TMA), upconv_wgmma_kernel below.
//
// Bound on the H100: operations for up_1 and up_2 (up_1 at batch 8: 60
// GFLOP, 61 us of bf16 tensor-core time, against ~16 MB); up_3 is close to
// balanced (at batch 128 it reads 105 MB and writes 419 MB: 0.156 ms of
// HBM time against 0.244 ms of tensor-core time).
//
// Design: an implicit GEMM over the 2x map, which never touches device
// memory. A block owns an 8 x 16 tile of output pixels and NB output
// channels (NB = 256 when Cout >= 256, else 64); each of its two consumer
// warpgroups owns one 8 x 8 half (M = 64 pixels), and K = 9 taps x Cin in
// chunks of 64 channels. For each chunk:
//  1. the producer warp's lane 0 brings the low-res footprint of the tile
//     (6 x 10 pixels: the tile's sources plus the conv halo's) into shared
//     memory with one 4D TMA load, and each tap's NB x 64 weight tile
//     (128-byte swizzled, from the (9, Cout, Cin) packing of
//     ops/upconv.py) into a ring of weight stages;
//  2. the 256 consumer threads blend the footprint into the bf16
//     upsampled patch, the tile plus the conv halo (10 x 18 pixels x 64
//     channels), with the same f32 products and sums as the plain version;
//  3. each consumer warpgroup runs 4 wgmmas (k16) per tap over the tap's
//     shifted 8 x 8 window of the patch against the tap's weight tile.
// The patch is double-buffered, so a chunk's blend overlaps the previous
// chunk's last wgmma group, and every ring stage is released once the
// wgmma group that read it has completed (wait_group 1).
//
// Trouble spots, and what the design does about them:
//  - Two edge rules. The upsample clamps its sources at the low-res border;
//    the conv reads zeros outside [0, 2H) x [0, 2W). TMA's zero fill gives
//    the second rule but not the first: the footprint load may run past the
//    border (those bytes are zeros), and the blend clamps its source indices
//    itself, so it never reads them; only patch pixels outside the 2x map
//    are set to 0. Channels past Cin are zeros of the TMA load (x) and of
//    the weight load alike.
//  - A shifted window must be a legal wgmma A operand. The patch is stored
//    in the no-swizzle canonical K-major layout: one 16-byte core-matrix row
//    is one pixel's 8 channels, pixels contiguous along x in rows of 18,
//    and the 8 channel groups of the chunk in planes of 10 x 18 x 16 B. An
//    8 x 8 window at any (dy, dx) is then one descriptor: 8 consecutive
//    pixels of a row are a core matrix, SBO = 18 x 16 B between window rows,
//    LBO = 2880 B between channel groups, start 16-byte aligned.
//  - Shared memory. The weights of one chunk of up_1 (9 x 256 x 64 bf16,
//    295 KB) do not fit a block, so weights stream per tap: 32 KB a stage
//    at NB = 256 (4 stages), 8 KB at NB = 64 (6 stages). With the two
//    footprint stages (2 x 7.5 KB) and the two patches (2 x 22.5 KB):
//    193,632 B at NB = 256 (one block per SM), 111,744 B at NB = 64 (two).
//  - up_3 is close to balanced: its single chunk gives a block no overlap
//    of its own; two blocks per SM overlap each other's loads and stores.
//    The output is stored from the accumulator fragments, 4 bytes a
//    thread, masked to the map and to Cout; staging it for 16-byte stores
//    is not done here.
// Widths: Cin must be a multiple of 8 (16-byte TMA strides; the wrapper
// checks); any B, H, W and Cout.
//
// f32: scalar FP32 FMAs (upconv_kernel below), simple first: a block
// owns an 8 x 16 tile and 64 output channels, forms the upsampled 10 x 18
// patch for each chunk of 16 input channels in shared memory, and each
// thread accumulates 8 pixels x 4 channels in f32.
#include "common.cuh"

// ---------------------------------------------------------------------------
// f32: the scalar kernel (see the header note).

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


// ---------------------------------------------------------------------------
// bf16: wgmma + TMA (see the header note).
namespace plr2 {
namespace {

constexpr int kTCThreads = 2 * 128 + 32;  // two consumer warpgroups + producer
constexpr int kPatchW = 18, kPatchH = 10;  // 8 x 16 tile + conv halo
constexpr int kPlane = kPatchH * kPatchW * 16;  // one channel group: 2880 B
constexpr int kPatch = 8 * kPlane;              // 64 channels: 23,040 B
constexpr int kLowH = 6, kLowW = 10;            // low-res footprint
constexpr int kLow = kLowH * kLowW * 128;       // x 64 channels: 7,680 B
constexpr int kWTile = 64 * 128;                // 64 weight rows x 64: 8 KB

template <int NB>
struct UpCfg {
  static constexpr int kStages = NB == 256 ? 4 : 6;
  static constexpr int kMinBlocks = NB == 256 ? 1 : 2;
  static constexpr int kWStage = NB * 128;
  // weight ring (1 KB aligned), 2 footprints, 2 patches, barriers, slack
  static constexpr int kBars = 8 * (2 * kStages + 4);
  static constexpr int kBytes = 1024 + kStages * kWStage + 2 * kLow + 2 * kPatch + kBars;
};

// source taps of 2x-map coordinate Y (0 <= Y < 2n): rows (a, b), weights (wa, wb)
__device__ __forceinline__ void src_taps(int Y, int n, int& a, int& b, float& wa,
                                         float& wb) {
  const int t = Y >> 1;
  if (Y & 1) {
    a = t; b = min(t + 1, n - 1); wa = 0.75f; wb = 0.25f;
  } else {
    a = max(t - 1, 0); b = t; wa = 0.25f; wb = 0.75f;
  }
}

// wa * a + wb * b with each product and the sum rounded, as the plain
// version's separate torch multiplies and add
__device__ __forceinline__ float blend(float wa, float a, float wb, float b) {
  return __fadd_rn(__fmul_rn(wa, a), __fmul_rn(wb, b));
}

__device__ __forceinline__ void unpack8(const uint4& v, float (&f)[8]) {
  const __nv_bfloat162* p = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 t = __bfloat1622float2(p[i]);
    f[2 * i] = t.x;
    f[2 * i + 1] = t.y;
  }
}

template <int NB>
__global__ void __launch_bounds__(kTCThreads, UpCfg<NB>::kMinBlocks)
    upconv_wgmma_kernel(const __grid_constant__ CUtensorMap xmap,
                        const __grid_constant__ CUtensorMap wmap,
                        const __nv_bfloat16* __restrict__ bias,
                        const __nv_bfloat16* __restrict__ alpha,
                        __nv_bfloat16* __restrict__ out, int H, int W, int Cin,
                        int Cout) {
  using Cfg = UpCfg<NB>;
  constexpr int S = Cfg::kStages;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  unsigned char* gbase = smem_raw + (base - raw);
  const uint32_t wring = base;
  const uint32_t low = wring + S * Cfg::kWStage;  // 2 footprints
  const uint32_t patch = low + 2 * kLow;          // 2 patches
  const uint32_t bars = patch + 2 * kPatch;
  auto wfull = [&](int s) { return bars + 8 * s; };
  auto wempty = [&](int s) { return bars + 8 * (S + s); };
  auto lfull = [&](int s) { return bars + 8 * (2 * S + s); };
  auto lempty = [&](int s) { return bars + 8 * (2 * S + 2 + s); };

  const int H2 = 2 * H, W2 = 2 * W;
  const int tiles_w = (W2 + 15) / 16;
  const int oy0 = (blockIdx.x / tiles_w) * 8, ox0 = (blockIdx.x % tiles_w) * 16;
  const int ly0 = oy0 / 2 - 1, lx0 = ox0 / 2 - 1;  // footprint origin
  const int co0 = blockIdx.y * NB, b = blockIdx.z;
  const int nk = (Cin + 63) / 64;
  const int tid = threadIdx.x;
  constexpr int kConsumers = 256;

  if (tid == 0) {
    for (int s = 0; s < S; ++s) {
      mbar_init(wfull(s), 1);
      mbar_init(wempty(s), kConsumers);
    }
    for (int s = 0; s < 2; ++s) {
      mbar_init(lfull(s), 1);
      mbar_init(lempty(s), kConsumers);
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (tid >= kConsumers) {  // producer warp: lane 0 issues every load
    if (tid != kConsumers) return;
    int it = 0;
    for (int c = 0; c < nk; ++c) {
      const int ls = c & 1;
      mbar_wait(lempty(ls), ((c >> 1) & 1) ^ 1);
      mbar_expect_tx(lfull(ls), kLow);
      tma_load_4d(low + ls * kLow, &xmap, lfull(ls), c * 64, lx0, ly0, b);
      for (int tap = 0; tap < 9; ++tap, ++it) {
        const int s = it % S;
        mbar_wait(wempty(s), ((it / S) & 1) ^ 1);
        mbar_expect_tx(wfull(s), Cfg::kWStage);
#pragma unroll
        for (int q = 0; q < NB / 64; ++q)
          tma_load_3d(wring + s * Cfg::kWStage + q * kWTile, &wmap, wfull(s),
                      c * 64, co0 + 64 * q, tap);
      }
    }
    return;
  }

  const int wg = tid >> 7;  // this warpgroup's pixels: x in [8 wg, 8 wg + 8)
  float acc[NB / 2];  // the first wgmma overwrites it
  int it = 0;
  for (int c = 0; c < nk; ++c) {
    const int ls = c & 1;
    const uint32_t pt = patch + ls * kPatch;
    // both warpgroups are done with the wgmmas that read this patch buffer
    // (chunk c - 2's: each thread has waited down to one pending group)
    named_bar_sync(1, kConsumers);
    mbar_wait(lfull(ls), (c >> 1) & 1);
    const unsigned char* lo = gbase + (low + ls * kLow - base);
    unsigned char* pp = gbase + (pt - base);
    for (int e = tid; e < kPatchH * kPatchW * 8; e += kConsumers) {
      const int g = e & 7, q = e >> 3;  // channel group, patch pixel
      const int py = q / kPatchW, px = q - py * kPatchW;
      const int Y = oy0 - 1 + py, X = ox0 - 1 + px;
      uint4 v = make_uint4(0, 0, 0, 0);  // the conv's zero padding
      if (Y >= 0 && Y < H2 && X >= 0 && X < W2) {
        int ya, yb, xa, xb;
        float wya, wyb, wxa, wxb;
        src_taps(Y, H, ya, yb, wya, wyb);
        src_taps(X, W, xa, xb, wxa, wxb);
        ya -= ly0; yb -= ly0; xa -= lx0; xb -= lx0;
        auto at = [&](int yy, int xx) {
          return *reinterpret_cast<const uint4*>(lo + (yy * kLowW + xx) * 128 + g * 16);
        };
        float p00[8], p01[8], p10[8], p11[8];
        unpack8(at(ya, xa), p00);
        unpack8(at(ya, xb), p01);
        unpack8(at(yb, xa), p10);
        unpack8(at(yb, xb), p11);
        __nv_bfloat162* o = reinterpret_cast<__nv_bfloat162*>(&v);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          float r[2];
#pragma unroll
          for (int e2 = 0; e2 < 2; ++e2) {
            const int ch = 2 * i + e2;
            const float r0 = blend(wxa, p00[ch], wxb, p01[ch]);
            const float r1 = blend(wxa, p10[ch], wxb, p11[ch]);
            r[e2] = blend(wya, r0, wyb, r1);
          }
          o[i] = __floats2bfloat162_rn(r[0], r[1]);
        }
      }
      *reinterpret_cast<uint4*>(pp + g * kPlane + q * 16) = v;
    }
    fence_proxy_async();
    mbar_arrive(lempty(ls));
    named_bar_sync(1, kConsumers);  // the patch is complete

    for (int tap = 0; tap < 9; ++tap, ++it) {
      const int dy = tap / 3, dx = tap - 3 * dy;
      const int s = it % S;
      mbar_wait(wfull(s), (it / S) & 1);
      const uint32_t a = pt + (dy * kPatchW + 8 * wg + dx) * 16;
      const uint32_t bw = wring + s * Cfg::kWStage;
      fence_operands(acc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_bf16<NB>(acc, desc_plain(a + 2 * kk * kPlane, kPlane, kPatchW * 16),
                       desc_sw128(bw + 32 * kk), it > 0 || kk > 0);
      wgmma_commit();
      wgmma_wait<1>();  // the previous step's group is done: release its stage
      fence_operands(acc);
      if (it > 0) mbar_arrive(wempty((it - 1) % S));
    }
  }
  wgmma_wait<0>();
  fence_operands(acc);

  // accumulator fragment: register 4j + 2h + e holds row m = 16 warp +
  // lane/4 + 8h (pixel (m / 8, m % 8) of the warpgroup's 8 x 8 half),
  // column 8j + 2 (lane % 4) + e
  const float a = __bfloat162float(alpha[0]);
  const int warp = (tid >> 5) & 3, lane = tid & 31;
#pragma unroll
  for (int j = 0; j < NB / 8; ++j) {
    const int co = co0 + 8 * j + 2 * (lane & 3);
    if (co >= Cout) continue;
    const float b0 = __bfloat162float(bias[co]);
    const float b1 = co + 1 < Cout ? __bfloat162float(bias[co + 1]) : 0.f;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int m = warp * 16 + (lane >> 2) + 8 * h;
      const int oy = oy0 + (m >> 3), ox = ox0 + 8 * wg + (m & 7);
      if (oy >= H2 || ox >= W2) continue;
      float v0 = acc[4 * j + 2 * h] + b0, v1 = acc[4 * j + 2 * h + 1] + b1;
      v0 = v0 >= 0.f ? v0 : a * v0;
      v1 = v1 >= 0.f ? v1 : a * v1;
      __nv_bfloat16* o = out + (((size_t)b * H2 + oy) * W2 + ox) * Cout + co;
      if (co + 1 < Cout && (Cout & 1) == 0) {
        *reinterpret_cast<__nv_bfloat162*>(o) = __floats2bfloat162_rn(v0, v1);
      } else {
        o[0] = __float2bfloat16_rn(v0);
        if (co + 1 < Cout) o[1] = __float2bfloat16_rn(v1);
      }
    }
  }
}

template <int NB>
int launch_wgmma(const void* x, const void* wp, const void* bias,
                 const void* alpha, void* out, int B, int H, int W, int Cin,
                 int Cout, cudaStream_t stream) {
  static int granted = 0;
  auto kernel = upconv_wgmma_kernel<NB>;
  cudaError_t err = allow_smem(kernel, UpCfg<NB>::kBytes, granted);
  if (err != cudaSuccess) return (int)err;
  if (B > 0 && H > 0 && W > 0 && Cout > 0) {
    CUtensorMap xmap, wmap;
    const cuuint64_t xdims[4] = {(cuuint64_t)Cin, (cuuint64_t)W, (cuuint64_t)H,
                                 (cuuint64_t)B};
    const cuuint64_t xstr[3] = {(cuuint64_t)Cin * 2, (cuuint64_t)W * Cin * 2,
                                (cuuint64_t)H * W * Cin * 2};
    const cuuint32_t xbox[4] = {64, kLowW, kLowH, 1};
    const cuuint64_t wdims[3] = {(cuuint64_t)Cin, (cuuint64_t)Cout, 9};
    const cuuint64_t wstr[2] = {(cuuint64_t)Cin * 2, (cuuint64_t)Cout * Cin * 2};
    const cuuint32_t wbox[3] = {64, 64, 1};
    if (!encode_bf16_map(&xmap, 4, x, xdims, xstr, xbox, false) ||
        !encode_bf16_map(&wmap, 3, wp, wdims, wstr, wbox, true))
      return (int)cudaErrorInvalidValue;
    const int tiles = ((2 * H + 7) / 8) * ((2 * W + 15) / 16);
    dim3 grid(tiles, (Cout + NB - 1) / NB, B);
    kernel<<<grid, kTCThreads, UpCfg<NB>::kBytes, stream>>>(
        xmap, wmap, static_cast<const __nv_bfloat16*>(bias),
        static_cast<const __nv_bfloat16*>(alpha), static_cast<__nv_bfloat16*>(out),
        H, W, Cin, Cout);
  }
  return (int)cudaGetLastError();
}

}  // namespace
}  // namespace plr2

// x (B, H, W, Cin), bias (Cout,), alpha (1,) on the device; out (B, 2H, 2W,
// Cout); all contiguous, one dtype. w: f32, HWIO (3, 3, Cin, Cout); bf16,
// the (9, Cout, Cin) packing of ops/upconv.py `pack_weights` (tap-major,
// K-major rows), with Cin a multiple of 8 and every pointer 16-byte aligned.
extern "C" int plr2_upconv3x3_prelu(int dtype, const void* x, const void* w,
                                    const void* bias, const void* alpha,
                                    void* out, int B, int H, int W, int Cin,
                                    int Cout, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == plr2::kBF16)
    return Cout >= 256
               ? plr2::launch_wgmma<256>(x, w, bias, alpha, out, B, H, W, Cin, Cout, s)
               : plr2::launch_wgmma<64>(x, w, bias, alpha, out, B, H, W, Cin, Cout, s);
  if (dtype == plr2::kF32)
    return plr2::launch<float>(x, w, bias, alpha, out, B, H, W, Cin, Cout, s);
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* plr2_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
