// Pose-head ladder: out = L4(relu(L3(relu(L2(relu(L1(x))))))), Li(h) = h Wi^T + bi.
//
// Replaces the TPU kernel plr2_tpu/ops/pallas_fusion.py `fused_mlp_head`
// (`_mlp_kernel`). This is the forward; the backward is plain PyTorch
// (ops/mlp_head.py), as the JAX custom VJP's is plain XLA, so no backward
// kernel exists on either side. Semantics as there: products accumulate in
// f32, the bias is added in f32, and after each ReLU the activation is
// rounded to the input dtype before it feeds the next layer. Weights use
// the torch Linear / Conv1d layout (out, in), row-major: K-major, which is
// wgmma's "TN" form.
//
// Widths of the main path: 1408 -> 640 -> 256 -> 128 -> K, K = 84, 63 or 21;
// P = 1000 rows per frame. One head at 8000 rows is 17.7 GFLOP.
//
// bf16: tensor cores (wgmma + TMA), mlp_head_wgmma_kernel below.
//
// Bound on the H100: operations (a head at 8000 rows moves ~25 MB of x,
// weights and output against 17.7 GFLOP: 18 us of bf16 tensor-core time
// against 7 us of HBM time). Every row block also reads all 2.2 MB of a
// head's bf16 weights from L2, ceil(P / 64) x 2.2 MB per head (277 MB at
// 8000 rows, 4.4 GB at 128,000), but that stream is not what holds the
// kernel back: a block takes about as long alone as in a full wave of
// them, and as long when its ring stages are marked full without loads. Its time goes
// to the wgmma mainloop (about half the tensor cores' rate: a step of 64
// rows x 256 columns x 64 is little work per mbarrier round) and to the
// epilogues between passes. A 2-block cluster that multicast each weight
// tile (half the L2 reads) ran slower than single blocks.
//
// Design. One block owns BM = 64 rows (wgmma's M) and runs the whole
// ladder for them; h1-h3 stay in shared memory and never touch device
// memory. Warps 0-7 are two consumer warpgroups that issue the wgmmas and
// run the epilogues; warp 8 is the producer, whose lane 0 issues TMA
// loads into a ring of stages, each a 64 x 64 slice of x (layer 1 only)
// and up to 256 x 64 weights, guarded by a full and an empty mbarrier.
// Every layer runs in N-passes of 256, 128 or 64 columns (the accumulator
// of a 64 x 640 layer would need 320 registers a thread), and each
// warpgroup takes half of a pass's columns against the same A (64
// accumulator registers at a pass of 256). Layer 1 streams its x slices
// from L2 again on each of its three passes. The consumers keep one wgmma
// group in flight (wait_group 1) and release a stage once the group that
// read it has completed. A pass's epilogue adds the bias, applies the
// ReLU, rounds to bf16 and writes h into shared memory in the 128-byte
// swizzled K-major layout that TMA gives x, so the next layer's A operand
// is read by the same descriptor form; the last layer stores to device
// memory with masked plain stores (a row of K = 63 bf16 is 126 B, not a
// 16-byte multiple, so no TMA store).
//
// On-chip budget (232,448 B a block; main-path widths). The activation
// region is h1's 64 x 640 x 2 = 80 KB. Layer 2 is one pass, so once both
// warpgroups' wgmmas that read h1 have completed (a named barrier) its
// epilogue writes h2 (32 KB) over h1's first columns; h3 (16 KB) goes
// beside it. That leaves three 40 KB ring stages: 230,528 B with the
// barriers and 1 KB of alignment, one block per SM. (Widths where h2 cannot share h1's room
// give it its own, with fewer stages; fewer than two fail the launch.) At
// 8000 rows the 125 blocks fill 125 of the 132 SMs; BM = 128 would halve
// the L2 weight traffic per row but needs 160 KB for h1 alone.
//
// Ragged edges. Rows past P and weight rows past N or columns past K are
// read as zeros by TMA, so every width is padded to 64 on chip: padded h
// columns are exactly 0 (zero weights, bias masked) and meet zero weights
// in the next layer. Stores are masked to P rows and N4 columns. TMA needs
// 16-byte row strides: C0, N1, N2 and N3 must be multiples of 8 (the
// wrapper checks) and every pointer 16-byte aligned.
//
// f32: scalar FP32 FMAs (mlp_head_kernel below), simple first: one
// block of 32 rows keeps its activations in shared memory and streams the
// weights in 32 x 128 tiles; a 16 x 16 thread grid, each thread a
// (BM/16) x 8 tile of f32 accumulators.
#include "common.cuh"

// ---------------------------------------------------------------------------
// f32: the scalar kernel (see the header note).

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


// ---------------------------------------------------------------------------
// bf16: wgmma + TMA (see the header note).
namespace plr2 {
namespace {

constexpr int kBM = 64;                 // rows per block: wgmma's M
constexpr int kConsumers = 256;         // two warpgroups
constexpr int kTCThreads = kConsumers + 32;  // and one producer warp
constexpr int kTile = 64 * 128;         // 64 rows x 64 bf16 (128 B): 8 KB
constexpr int kSlotA = kTile;           // a 64 x 64 slice of x
constexpr int kStage = kSlotA + 4 * kTile;  // and up to 256 x 64 weights
constexpr int kMaxStages = 4;
constexpr int kSmemLimit = 232448;      // per block on the H100

__host__ __device__ __forceinline__ int pad64(int n) { return (n + 63) & ~63; }

struct HeadMaps {
  CUtensorMap x, w[4];
};

// width of the N-pass that starts with `rem` padded columns left
__host__ __device__ __forceinline__ int pass_width(int rem) {
  return rem >= 256 ? 256 : rem >= 128 ? 128 : 64;
}

// What the host decides: widths, ring depth, where h1-h3 live
struct HeadPlan {
  const __nv_bfloat16* b[4];
  int k[4], n[4];
  int stages;
  int h_off[3];  // byte offsets of h1, h2, h3 in the activation region
  int h_bytes;   // size of the activation region
};

// A ring of `n` stages. full(s): the stage's loads have landed (one
// arrival, the producer's, plus the bytes). empty(s): the 8 consumer warps
// are done with it.
struct Ring {
  uint32_t stages_addr, bars;
  int n;
  __device__ uint32_t stage(int s) const { return stages_addr + s * kStage; }
  __device__ uint32_t full(int s) const { return bars + 8 * s; }
  __device__ uint32_t empty(int s) const { return bars + 8 * (n + s); }
  // called by every consumer thread once its wgmmas reading stage s are done
  __device__ void release(int s) const {
    if ((threadIdx.x & 31) == 0) mbar_arrive(empty(s));
  }
};

// One N-pass of layer l over the block's 64 rows: nk k-steps of 64, then
// the epilogue. `it` counts ring steps across the whole ladder. Each
// consumer warpgroup computes half of the pass's NP columns (WN of them)
// against the same A: half the accumulator each, and two independent
// chains of wgmmas.
template <int NP>
__device__ __forceinline__ void head_pass(
    const Ring& ring, int& it, int l, int nk, uint32_t hin, int n0,
    const HeadPlan& L, unsigned char* hout, __nv_bfloat16* __restrict__ out,
    int m0, int P, bool hout_is_hin) {
  constexpr int WN = NP / 2;
  const int wg = threadIdx.x >> 7;
  float acc[WN / 2];  // the pass's first wgmma overwrites it
  for (int kc = 0; kc < nk; ++kc, ++it) {
    const int s = it % ring.n;
    mbar_wait(ring.full(s), (it / ring.n) & 1);
    const uint32_t st = ring.stage(s);
    const uint32_t a = l == 0 ? st : hin + kc * kTile;
    const uint32_t b = st + kSlotA + wg * WN * 128;  // this half's weight rows
    fence_operands(acc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_bf16<WN>(acc, desc_sw128(a + 32 * kk), desc_sw128(b + 32 * kk),
                     kc > 0 || kk > 0);
    wgmma_commit();
    wgmma_wait<1>();  // the previous step's group is done: release its stage
    fence_operands(acc);
    if (kc > 0) ring.release((it - 1) % ring.n);
  }
  wgmma_wait<0>();
  fence_operands(acc);
  ring.release((it - 1) % ring.n);
  // h2 overwriting h1: the other warpgroup's wgmmas must be done with it
  if (hout_is_hin) named_bar_sync(1, kConsumers);

  // accumulator fragment: register 4j + 2h + e holds row
  // 16 warp + lane/4 + 8h, column 8j + 2 (lane % 4) + e of this half
  const int warp = (threadIdx.x >> 5) & 3, lane = threadIdx.x & 31;
  const int N = L.n[l];
  const __nv_bfloat16* bias = L.b[l];
#pragma unroll
  for (int j = 0; j < WN / 8; ++j) {
    const int c = n0 + wg * WN + 8 * j + 2 * (lane & 3);
    const float b0 = c < N ? __bfloat162float(bias[c]) : 0.f;
    const float b1 = c + 1 < N ? __bfloat162float(bias[c + 1]) : 0.f;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = warp * 16 + (lane >> 2) + 8 * h;
      const float v0 = acc[4 * j + 2 * h] + b0, v1 = acc[4 * j + 2 * h + 1] + b1;
      if (l < 3) {
        *reinterpret_cast<__nv_bfloat162*>(hout + (c >> 6) * kTile +
                                           sw128_offset(r, c & 63)) =
            __floats2bfloat162_rn(fmaxf(v0, 0.f), fmaxf(v1, 0.f));
      } else if (m0 + r < P && c < N) {
        __nv_bfloat16* o = out + (size_t)(m0 + r) * N + c;
        if (c + 1 < N && (N & 1) == 0) {
          *reinterpret_cast<__nv_bfloat162*>(o) = __floats2bfloat162_rn(v0, v1);
        } else {
          o[0] = __float2bfloat16_rn(v0);
          if (c + 1 < N) o[1] = __float2bfloat16_rn(v1);
        }
      }
    }
  }
}

// Consumer warpgroup: the four layers, h1-h3 in the activation region.
__device__ __forceinline__ void consume(const Ring& ring, const HeadPlan& L,
                                        unsigned char* hregion, uint32_t hbase,
                                        __nv_bfloat16* __restrict__ out, int m0,
                                        int P) {
  int it = 0;
  uint32_t hin = 0;
  for (int l = 0; l < 4; ++l) {
    const int nk = (L.k[l] + 63) / 64, np = pad64(L.n[l]);
    const int off = l < 3 ? L.h_off[l] : 0;
    const bool alias = l == 1 && off == L.h_off[0];
    for (int n0 = 0; n0 < np; n0 += pass_width(np - n0)) {
      const int w = pass_width(np - n0);
      if (w == 256)
        head_pass<256>(ring, it, l, nk, hin, n0, L, hregion + off, out, m0, P, alias);
      else if (w == 128)
        head_pass<128>(ring, it, l, nk, hin, n0, L, hregion + off, out, m0, P, alias);
      else
        head_pass<64>(ring, it, l, nk, hin, n0, L, hregion + off, out, m0, P, alias);
    }
    if (l < 3) {  // h complete and visible to wgmma before the next layer
      fence_proxy_async();
      named_bar_sync(1, kConsumers);
    }
    hin = hbase + off;
  }
}

__global__ void __launch_bounds__(kTCThreads, 1) mlp_head_wgmma_kernel(
    const __grid_constant__ HeadMaps maps, const HeadPlan L,
    __nv_bfloat16* __restrict__ out, int P) {
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;  // 128B swizzle: 1 KB aligned
  const uint32_t hbase = base + L.stages * kStage;
  const Ring ring{base, hbase + L.h_bytes, L.stages};
  const int tid = threadIdx.x, m0 = blockIdx.x * kBM;
  if (tid == 0) {
    for (int s = 0; s < ring.n; ++s) {
      mbar_init(ring.full(s), 1);
      mbar_init(ring.empty(s), kConsumers / 32);
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (tid >= kConsumers) {  // producer warp: lane 0 issues every load
    if (tid != kConsumers) return;
    int it = 0;
    for (int l = 0; l < 4; ++l) {
      const int nk = (L.k[l] + 63) / 64, np = pad64(L.n[l]);
      for (int n0 = 0; n0 < np; n0 += pass_width(np - n0)) {
        const int w = pass_width(np - n0);
        for (int kc = 0; kc < nk; ++kc, ++it) {
          const int s = it % ring.n;
          mbar_wait(ring.empty(s), ((it / ring.n) & 1) ^ 1);
          const uint32_t st = ring.stage(s);
          mbar_expect_tx(ring.full(s), w * 128 + (l == 0 ? kSlotA : 0));
          if (l == 0) tma_load_2d(st, &maps.x, ring.full(s), kc * 64, m0);
          for (int q = 0; q < w / 64; ++q)
            tma_load_2d(st + kSlotA + q * kTile, &maps.w[l], ring.full(s),
                        kc * 64, n0 + 64 * q);
        }
      }
    }
    return;
  }
  consume(ring, L, smem_raw + (hbase - raw), hbase, out, m0, P);
}

// Ring and activation layout for the widths k, n. h2 shares h1's room when
// layer 2 is one pass (its epilogue runs once every wgmma reading h1 is
// done) and h2 and h3 fit there side by side; else h2 gets its own room and
// h3 takes h1's.
HeadPlan plan_head(const int* k, const int* n) {
  HeadPlan L{};
  for (int l = 0; l < 4; ++l) L.k[l] = k[l], L.n[l] = n[l];
  const int p1 = pad64(n[0]) * 128, p2 = pad64(n[1]) * 128, p3 = pad64(n[2]) * 128;
  if (pad64(n[1]) <= pass_width(pad64(n[1])) && p2 + p3 <= p1) {
    L.h_off[0] = 0, L.h_off[1] = 0, L.h_off[2] = p2;
    L.h_bytes = p1;
  } else {
    const int a = p1 > p3 ? p1 : p3;
    L.h_off[0] = 0, L.h_off[1] = a, L.h_off[2] = 0;
    L.h_bytes = a + p2;
  }
  L.stages = (kSmemLimit - 1024 - 16 * kMaxStages - L.h_bytes) / kStage;
  if (L.stages > kMaxStages) L.stages = kMaxStages;
  return L;
}

int launch_wgmma(const void* x, const void* const* w, const void* const* b,
                 void* out, int P, const int* k, const int* n,
                 cudaStream_t stream) {
  static int granted = 0;
  HeadPlan L = plan_head(k, n);
  if (L.stages < 2) return (int)cudaErrorInvalidValue;  // widths too large
  const int bytes = 1024 + L.stages * kStage + L.h_bytes + 16 * kMaxStages;
  cudaError_t err = allow_smem(mlp_head_wgmma_kernel, bytes, granted);
  if (err != cudaSuccess || P == 0) return (int)err;
  HeadMaps maps;
  const cuuint32_t box[2] = {64, 64};
  const cuuint64_t xdims[2] = {(cuuint64_t)k[0], (cuuint64_t)P};
  const cuuint64_t xstride[1] = {(cuuint64_t)k[0] * 2};
  if (!encode_bf16_map(&maps.x, 2, x, xdims, xstride, box, true))
    return (int)cudaErrorInvalidValue;
  for (int l = 0; l < 4; ++l) {
    const cuuint64_t dims[2] = {(cuuint64_t)k[l], (cuuint64_t)n[l]};
    const cuuint64_t stride[1] = {(cuuint64_t)k[l] * 2};
    if (!encode_bf16_map(&maps.w[l], 2, w[l], dims, stride, box, true))
      return (int)cudaErrorInvalidValue;
    L.b[l] = static_cast<const __nv_bfloat16*>(b[l]);
  }
  mlp_head_wgmma_kernel<<<(P + kBM - 1) / kBM, kTCThreads, bytes, stream>>>(
      maps, L, static_cast<__nv_bfloat16*>(out), P);
  return (int)cudaGetLastError();
}

}  // namespace
}  // namespace plr2

// x (P, C0); wi (Ni, N(i-1)); bi (Ni,); out (P, N4); all contiguous, one
// dtype. bf16: the wgmma kernel; C0, N1, N2, N3 multiples of 8 and every
// pointer 16-byte aligned (ops/mlp_head.py checks), any P and N4. f32: the
// scalar kernel, 32 rows per block; any widths whose activations fit in
// shared memory. Widths whose shared memory exceeds what a block may use
// make the launch fail with cudaErrorInvalidValue.
extern "C" int plr2_mlp_head(int dtype, const void* x, const void* w1,
                             const void* b1, const void* w2, const void* b2,
                             const void* w3, const void* b3, const void* w4,
                             const void* b4, void* out, int P, int C0, int N1,
                             int N2, int N3, int N4, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == plr2::kBF16) {
    const void* w[4] = {w1, w2, w3, w4};
    const void* b[4] = {b1, b2, b3, b4};
    const int k[4] = {C0, N1, N2, N3}, n[4] = {N1, N2, N3, N4};
    return plr2::launch_wgmma(x, w, b, out, P, k, n, s);
  }
  if (dtype == plr2::kF32)
    return plr2::launch<float, 32>(x, w1, b1, w2, b2, w3, b3, w4, b4, out, P,
                                   C0, N1, N2, N3, N4, s);
  return (int)cudaErrorInvalidValue;
}
