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
// f32: an implicit GEMM on the FP32 cores (upconv_sgemm_kernel below).
// f32 stays full f32 (no TF32), so the bound is the FFMA rate: 67 TFLOP/s,
// 1.35 ms for the three stages at batch 8. An SM issues 128 FFMAs but
// loads 32 words of shared memory a clock, so the design is about reuse.
// A block owns 8 x 8 output pixels x 256 channels, 8 x 16 x 128 (Cout >=
// 128; ops/upconv.py `f32_plan` takes the shape with fewer waves:
// 40-pixel rows fill 8-wide tiles) or 16 x 16 x 64 (Cout < 128: up_2,
// up_3); each thread 8 consecutive pixels of a row x 8 channels (64
// accumulators). For each input channel and kernel row dy a thread loads
// its 10 patch values once
// (two float4s and a float2: the patch is channel-planar, [c][y][x] in
// padded rows) and the three dx taps' 8 weights (two float4s each; the
// packed weights keep Cout contiguous): 192 FFMAs for 9 loads, none
// bank-conflicted. Input channels come in chunks of 8 (4 for the 256-wide
// tile): the chunk's low-res footprint and its 9 x CK x NB weights arrive
// by cp.async into a two-stage ring while the previous chunk's FFMAs run;
// then the block blends the footprint from shared memory into the patch
// (the same rounded products and sums as the plain version, so the patch
// is bit-equal to its upsampled map) and runs the chunk. Two barriers a
// chunk; 54-84 KB of shared memory (64-84 KB split) and at most 128
// registers a thread: two blocks an SM. The weights are read as the (9, Cin, round4(Cout))
// packing of ops/upconv.py `pack_weights_f32`, a view of HWIO when Cout is
// a multiple of 4. Any B, H, W, Cin and Cout: the footprint comes in
// 4-byte copies where Cin is not a multiple of 4.
//
// f32 at one crop: split-K over a thread-block cluster. A batch-1 stage
// gives the tiles above few blocks (up_1 at a 240 px crop: 64 blocks for
// 264 slots), so most SMs idle and each busy one holds a single block. The
// wrapper's plan (ops/upconv.py `f32_plan`, which also picks the tile)
// then sets S, the largest of 1, 2, 4 and 8 for which blocks x S still
// fits one wave of the card's clusters of S (plr2_upconv_f32_clusters:
// a cluster's blocks share a GPC, so an H100 holds 264 blocks in clusters
// of 2 but 248 in clusters of 4) and S <= the chunk count. S = 1
// launches the kernel above unchanged, with no cluster attribute. S > 1
// launches the kSplit instance as clusters of S blocks along x that own
// the same output tile: rank r runs chunks [r nk / S, (r + 1) nk / S) of
// the same loop, stages its 64 partial sums a thread in its own shared
// memory (over the weight ring, which is free by then), and after a
// cluster barrier finalises pixels [8r / S, 8(r + 1) / S) of every
// thread's row of 8: it reads the S partials through distributed shared
// memory, sums them in rank order 0 .. S-1, adds the bias, applies the
// PReLU and stores. A second cluster barrier keeps every block resident
// until the others have read its partials. The order is fixed, so a
// launch repeats bit for bit; no workspace in device memory, no atomics
// and no second kernel: the reduction is the epilogue of the same
// upconv_sgemm_kernel, whose device time is the whole stage's.
#include "common.cuh"

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

// ---------------------------------------------------------------------------
// f32: an implicit GEMM on the FP32 cores (see the header note).

namespace plr2 {
namespace {

constexpr int kUpThreads = 256;

// A block owns a TH x TW tile of output pixels and NB output channels and
// takes the input channels in chunks of CK.
template <int TH, int TW, int NB, int CK>
struct UpF32 {
  static constexpr int kPH = TH + 2, kPW = TW + 2;  // patch: tile + conv halo
  static constexpr int kPWs = (kPW + 3) & ~3;       // its row stride (floats)
  static constexpr int kLH = TH / 2 + 2, kLW = TW / 2 + 2;  // low-res footprint
  static constexpr int kGroups = NB / 8;                    // channel groups
  static_assert(TH * TW / 8 * kGroups == kUpThreads, "8 px x 8 ch a thread");
  static constexpr int kW = 9 * CK * NB;        // weight stage [9][CK][NB]
  static constexpr int kLow = kLH * kLW * CK;   // footprint [pixel][CK]
  static constexpr int kPatch = CK * kPH * kPWs;  // patch [CK][PH][PWs]
  static constexpr int kBytes = (int)sizeof(float) * (2 * (kW + kLow) + kPatch);
  // the split's staged partial sums, 64 a thread, over the buffers above
  static constexpr int kPartials = (int)sizeof(float) * 64 * kUpThreads;
  static constexpr int kSplitBytes = kBytes > kPartials ? kBytes : kPartials;
};

// out[co .. co + 3] of one pixel: one 16-byte store where Cout is a
// multiple of 4, else the channels below Cout one by one
__device__ __forceinline__ void store4(float* o, const float (&v)[4], int co,
                                       int Cout) {
  if ((Cout & 3) == 0) {
    *reinterpret_cast<float4*>(o) = make_float4(v[0], v[1], v[2], v[3]);
  } else {
#pragma unroll
    for (int j = 0; j < 4; ++j)
      if (co + j < Cout) o[j] = v[j];
  }
}

// x NHWC (B, H, W, Cin); w the (9, Cin, ldw) packing of ops/upconv.py
// `pack_weights_f32` (ldw = round4(Cout), zeros past Cout); out NHWC
// (B, 2H, 2W, Cout); x and w 16-byte aligned. vec16: Cin % 4 == 0, so the
// footprint arrives in 16-byte copies (else 4-byte ones). kSplit: launched
// as clusters of S blocks along x, S consecutive blocks a tile (header note).
template <int TH, int TW, int NB, int CK, bool kSplit>
__global__ void __launch_bounds__(kUpThreads, 2) upconv_sgemm_kernel(
    const float* __restrict__ x, const float* __restrict__ w,
    const float* __restrict__ bias, const float* __restrict__ alpha,
    float* __restrict__ out, int H, int W, int Cin, int Cout, int ldw,
    int vec16) {
  using Cfg = UpF32<TH, TW, NB, CK>;
  constexpr int PH = Cfg::kPH, PW = Cfg::kPW, PWs = Cfg::kPWs;
  constexpr int LH = Cfg::kLH, LW = Cfg::kLW;
  extern __shared__ __align__(16) float smem[];
  float* wsm = smem;                    // 2 weight stages
  float* low = wsm + 2 * Cfg::kW;       // 2 footprints
  float* patch = low + 2 * Cfg::kLow;   // the upsampled patch

  // the cluster's size and this block's rank in it (1 and 0 unsplit)
  const int S = kSplit ? cluster_size() : 1, rank = kSplit ? cluster_rank() : 0;
  const int tile = kSplit ? (int)blockIdx.x / S : (int)blockIdx.x;
  const int H2 = 2 * H, W2 = 2 * W;
  const int tiles_w = (W2 + TW - 1) / TW;
  const int oy0 = (tile / tiles_w) * TH, ox0 = (tile % tiles_w) * TW;
  const int ly0 = oy0 / 2 - 1, lx0 = ox0 / 2 - 1;  // footprint origin
  const int co0 = blockIdx.y * NB, b = blockIdx.z;
  const int tid = threadIdx.x;
  // a warp is 8 channel groups x 4 pixel groups: its weight loads read 8
  // distinct float4s and its patch loads 4, one shared-memory wavefront each
  const int lane = tid & 31, warp = tid >> 5;
  const int cg = (lane & 7) + 8 * (warp % (Cfg::kGroups / 8));
  const int pg = (lane >> 3) + 4 * (warp / (Cfg::kGroups / 8));
  const int py = pg / (TW / 8), px0 = (pg % (TW / 8)) * 8;  // 8 pixels of a row
  const float* xb = x + (size_t)b * H * W * Cin;
  const int nk = (Cin + CK - 1) / CK;
  const int cb = rank * nk / S, ce = (rank + 1) * nk / S;  // this block's chunks

  auto load = [&](int c, int s) {
    const int c0 = c * CK;
    float* ws = wsm + s * Cfg::kW;
    for (int e = tid; e < 9 * CK * NB / 4; e += kUpThreads) {
      const int q = e % (NB / 4), r = e / (NB / 4);  // r = tap * CK + ci
      const int tap = r / CK, ci = c0 + r % CK, co = co0 + 4 * q;
      const bool ok = ci < Cin && co < ldw;
      cp_async16(ws + r * NB + 4 * q,
                 ok ? w + ((size_t)tap * Cin + ci) * ldw + co : w, ok ? 16 : 0);
    }
    float* lo = low + s * Cfg::kLow;
    if (vec16) {
      for (int e = tid; e < LH * LW * CK / 4; e += kUpThreads) {
        const int h = e % (CK / 4), p = e / (CK / 4);
        const int yy = ly0 + p / LW, xx = lx0 + p % LW, ci = c0 + 4 * h;
        const int n = yy >= 0 && yy < H && xx >= 0 && xx < W
                          ? max(0, min(4, Cin - ci)) : 0;
        cp_async16(lo + p * CK + 4 * h,
                   n ? xb + ((size_t)yy * W + xx) * Cin + ci : xb, 4 * n);
      }
    } else {
      for (int e = tid; e < LH * LW * CK; e += kUpThreads) {
        const int j = e % CK, p = e / CK;
        const int yy = ly0 + p / LW, xx = lx0 + p % LW, ci = c0 + j;
        const bool ok = yy >= 0 && yy < H && xx >= 0 && xx < W && ci < Cin;
        cp_async4(lo + p * CK + j, ok ? xb + ((size_t)yy * W + xx) * Cin + ci : xb,
                  ok ? 4 : 0);
      }
    }
  };

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  load(cb, 0);
  cp_async_commit();
#pragma unroll 1
  for (int c = cb; c < ce; ++c) {
    const int s = (c - cb) & 1;
    cp_async_wait<0>();  // chunk c has landed (this thread's copies)
    __syncthreads();     // everyone's; everyone is done with chunk c - 1
    if (c + 1 < ce) load(c + 1, s ^ 1);
    cp_async_commit();

    // the upsampled patch of chunk c from its footprint: clamped sources,
    // zeros outside the 2x map (the conv's padding) and past Cin
    const float* lo = low + s * Cfg::kLow;
    for (int e = tid; e < CK * PH * PW; e += kUpThreads) {
      const int ci = e / (PH * PW), q = e % (PH * PW);
      const int qy = q / PW, qx = q % PW;
      const int Y = oy0 - 1 + qy, X = ox0 - 1 + qx;
      float v = 0.f;
      if (Y >= 0 && Y < H2 && X >= 0 && X < W2) {
        int ya, yb, xa, xc;
        float wya, wyb, wxa, wxc;
        src_taps(Y, H, ya, yb, wya, wyb);
        src_taps(X, W, xa, xc, wxa, wxc);
        ya -= ly0; yb -= ly0; xa -= lx0; xc -= lx0;
        const float r0 = blend(wxa, lo[(ya * LW + xa) * CK + ci], wxc,
                                   lo[(ya * LW + xc) * CK + ci]);
        const float r1 = blend(wxa, lo[(yb * LW + xa) * CK + ci], wxc,
                                   lo[(yb * LW + xc) * CK + ci]);
        v = blend(wya, r0, wyb, r1);
      }
      patch[(ci * PH + qy) * PWs + qx] = v;
    }
    __syncthreads();  // the patch is complete

    const float* ws = wsm + s * Cfg::kW + 4 * cg;
#pragma unroll 1
    for (int ci = 0; ci < CK; ++ci) {
#pragma unroll
      for (int dy = 0; dy < 3; ++dy) {
        // this thread's 10 patch values of row py + dy: x = px0 .. px0 + 9
        const float* pr = patch + (ci * PH + py + dy) * PWs + px0;
        const float4 p0 = *reinterpret_cast<const float4*>(pr);
        const float4 p1 = *reinterpret_cast<const float4*>(pr + 4);
        const float2 p2 = *reinterpret_cast<const float2*>(pr + 8);
        const float p[10] = {p0.x, p0.y, p0.z, p0.w, p1.x, p1.y, p1.z, p1.w,
                             p2.x, p2.y};
#pragma unroll
        for (int dx = 0; dx < 3; ++dx) {
          const float* wr = ws + ((dy * 3 + dx) * CK + ci) * NB;
          const float4 w0 = *reinterpret_cast<const float4*>(wr);
          const float4 w1 = *reinterpret_cast<const float4*>(wr + NB / 2);
          const float wv[8] = {w0.x, w0.y, w0.z, w0.w, w1.x, w1.y, w1.z, w1.w};
#pragma unroll
          for (int i = 0; i < 8; ++i)
#pragma unroll
            for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(p[i + dx], wv[j], acc[i][j]);
        }
      }
    }
  }
  cp_async_wait<0>();

  const float a = alpha[0];
  const int oy = oy0 + py;
  if constexpr (!kSplit) {
    if (oy >= H2) return;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int co = co0 + h * (NB / 2) + 4 * cg;
      if (co >= Cout) continue;
      float bv[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) bv[j] = co + j < Cout ? bias[co + j] : 0.f;
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int ox = ox0 + px0 + i;
        if (ox >= W2) continue;
        float v[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          v[j] = acc[i][4 * h + j] + bv[j];
          v[j] = v[j] >= 0.f ? v[j] : a * v[j];
        }
        store4(out + (((size_t)b * H2 + oy) * W2 + ox) * Cout + co, v, co, Cout);
      }
    }
  } else {
    // float4 k = 2 i + h of every thread (pixel i, channel half h) at
    // part[k][tid]; no thread of this block reads the last chunk's weights
    // or patch any more once all have passed the barrier
    float4* part = reinterpret_cast<float4*>(smem);
    __syncthreads();
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int h = 0; h < 2; ++h)
        part[(2 * i + h) * kUpThreads + tid] =
            make_float4(acc[i][4 * h], acc[i][4 * h + 1], acc[i][4 * h + 2],
                        acc[i][4 * h + 3]);
    cluster_sync();  // every rank's partials are staged
#pragma unroll 1
    for (int i = 8 * rank / S; i < 8 * (rank + 1) / S; ++i) {
      const int ox = ox0 + px0 + i;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int co = co0 + h * (NB / 2) + 4 * cg;
        const int k = (2 * i + h) * kUpThreads + tid;
        float4 t = ld_cluster4(part + k, 0);
#pragma unroll 1
        for (int q = 1; q < S; ++q) {  // rank order: the same sum every launch
          const float4 u = ld_cluster4(part + k, q);
          t.x += u.x; t.y += u.y; t.z += u.z; t.w += u.w;
        }
        if (oy >= H2 || ox >= W2 || co >= Cout) continue;
        float v[4] = {t.x, t.y, t.z, t.w};
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          v[j] += co + j < Cout ? bias[co + j] : 0.f;
          v[j] = v[j] >= 0.f ? v[j] : a * v[j];
        }
        store4(out + (((size_t)b * H2 + oy) * W2 + ox) * Cout + co, v, co, Cout);
      }
    }
    cluster_sync();  // no block leaves while another reads its partials
  }
}

// Raise the dynamic shared-memory limit of one instance once; `bytes` is
// what it takes
template <int TH, int TW, int NB, int CK, bool kSplit>
cudaError_t ready_f32(int& bytes) {
  static int granted = 0;
  using Cfg = UpF32<TH, TW, NB, CK>;
  bytes = kSplit ? Cfg::kSplitBytes : Cfg::kBytes;
  return allow_smem(upconv_sgemm_kernel<TH, TW, NB, CK, kSplit>, bytes, granted);
}

// split = S, the blocks a tile: 1 (a plain launch), 2, 4 or 8 (clusters)
template <int TH, int TW, int NB, int CK>
int launch_f32(const void* x, const void* w, const void* bias, const void* alpha,
               void* out, int B, int H, int W, int Cin, int Cout, int split,
               cudaStream_t stream) {
  if (split > 1 && split > (Cin + CK - 1) / CK) return (int)cudaErrorInvalidValue;
  int bytes = 0;
  cudaError_t err = split == 1 ? ready_f32<TH, TW, NB, CK, false>(bytes)
                               : ready_f32<TH, TW, NB, CK, true>(bytes);
  if (err != cudaSuccess) return (int)err;
  if (B > 0 && H > 0 && W > 0 && Cout > 0) {
    const int tiles = ((2 * H + TH - 1) / TH) * ((2 * W + TW - 1) / TW);
    const float* xf = static_cast<const float*>(x);
    const float* wf = static_cast<const float*>(w);
    const float* bf = static_cast<const float*>(bias);
    const float* af = static_cast<const float*>(alpha);
    float* of = static_cast<float*>(out);
    const int ldw = (Cout + 3) & ~3, vec16 = Cin % 4 == 0;
    if (split == 1) {
      dim3 grid(tiles, (Cout + NB - 1) / NB, B);
      upconv_sgemm_kernel<TH, TW, NB, CK, false><<<grid, kUpThreads, bytes, stream>>>(
          xf, wf, bf, af, of, H, W, Cin, Cout, ldw, vec16);
    } else {
      cudaLaunchAttribute attr;
      attr.id = cudaLaunchAttributeClusterDimension;
      attr.val.clusterDim.x = split;
      attr.val.clusterDim.y = 1;
      attr.val.clusterDim.z = 1;
      cudaLaunchConfig_t cfg = {};
      cfg.gridDim = dim3(tiles * split, (Cout + NB - 1) / NB, B);
      cfg.blockDim = dim3(kUpThreads);
      cfg.dynamicSmemBytes = bytes;
      cfg.stream = stream;
      cfg.attrs = &attr;
      cfg.numAttrs = 1;
      err = cudaLaunchKernelEx(&cfg, upconv_sgemm_kernel<TH, TW, NB, CK, true>, xf, wf,
                               bf, af, of, H, W, Cin, Cout, ldw, vec16);
      if (err != cudaSuccess) return (int)err;
    }
  }
  return (int)cudaGetLastError();
}

// Clusters of `split` blocks of the split instance that the card holds at
// once (cudaOccupancyMaxActiveClusters), or -1 on an error
template <int TH, int TW, int NB, int CK>
int clusters_f32(int split) {
  int bytes = 0, n = 0;
  if (ready_f32<TH, TW, NB, CK, true>(bytes) != cudaSuccess) return -1;
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = split;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(split);
  cfg.blockDim = dim3(kUpThreads);
  cfg.dynamicSmemBytes = bytes;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  return cudaOccupancyMaxActiveClusters(
             &n, (const void*)upconv_sgemm_kernel<TH, TW, NB, CK, true>, &cfg) ==
                 cudaSuccess
             ? n
             : -1;
}

}  // namespace
}  // namespace plr2

// x (B, H, W, Cin), bias (Cout,), alpha (1,) on the device; out (B, 2H, 2W,
// Cout); all contiguous, one dtype, x and w 16-byte aligned. w: f32, the
// (9, Cin, round4(Cout)) packing of ops/upconv.py `pack_weights_f32`, any
// widths; bf16, the (9, Cout, Cin) packing of ops/upconv.py `pack_weights`
// (tap-major, K-major rows), with Cin a multiple of 8 and every pointer
// 16-byte aligned. tile and split: the f32 plan of ops/upconv.py
// `f32_plan` (tile 0 = 8 x 8 px x 256 channels, 1 = 8 x 16 x 128, 2 = 16 x
// 16 x 64; split 1, 2, 4 or 8 blocks a tile, at most the chunk count);
// bf16 reads neither.
extern "C" int plr2_upconv3x3_prelu(int dtype, const void* x, const void* w,
                                    const void* bias, const void* alpha,
                                    void* out, int B, int H, int W, int Cin,
                                    int Cout, void* stream, int tile, int split) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == plr2::kBF16)
    return Cout >= 256
               ? plr2::launch_wgmma<256>(x, w, bias, alpha, out, B, H, W, Cin, Cout, s)
               : plr2::launch_wgmma<64>(x, w, bias, alpha, out, B, H, W, Cin, Cout, s);
  if (dtype != plr2::kF32 || (split != 1 && split != 2 && split != 4 && split != 8))
    return (int)cudaErrorInvalidValue;
  switch (tile) {
    case 0:
      return plr2::launch_f32<8, 8, 256, 4>(x, w, bias, alpha, out, B, H, W, Cin, Cout,
                                            split, s);
    case 1:
      return plr2::launch_f32<8, 16, 128, 8>(x, w, bias, alpha, out, B, H, W, Cin, Cout,
                                             split, s);
    case 2:
      return plr2::launch_f32<16, 16, 64, 8>(x, w, bias, alpha, out, B, H, W, Cin, Cout,
                                             split, s);
  }
  return (int)cudaErrorInvalidValue;
}

// For the f32 plan (ops/upconv.py `card_slots`): the clusters of `split`
// (2, 4 or 8) blocks of tile `tile` that the card holds at once, or -1
extern "C" int plr2_upconv_f32_clusters(int tile, int split) {
  if (split != 2 && split != 4 && split != 8) return -1;
  switch (tile) {
    case 0: return plr2::clusters_f32<8, 8, 256, 4>(split);
    case 1: return plr2::clusters_f32<8, 16, 128, 8>(split);
    case 2: return plr2::clusters_f32<16, 16, 64, 8>(split);
  }
  return -1;
}

extern "C" const char* plr2_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
