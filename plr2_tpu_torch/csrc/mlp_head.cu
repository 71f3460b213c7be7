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
// f32: the FP32 cores (head_sgemm_kernel below), one launch per layer.
// f32 stays full f32 (no TF32 on the tensor cores), so the bound is the
// FFMA rate: 67 TFLOP/s, 0.26 ms for one head at 8000 rows. What holds an
// FFMA kernel below it is shared memory: an SM issues 128 FFMAs but loads
// 32 words a clock, so each loaded word must feed at least 4 FFMAs. The
// whole ladder cannot stay on chip at the tile that needs: h1 alone is 160
// KB of f32 at 64 rows, and a register-tiled SGEMM wants 128 rows a block.
// So each layer is one register-tiled SGEMM with a fused epilogue (bias,
// ReLU except on layer 4), and h1-h3 go through a device scratch that the
// wrapper allocates (at 8000 rows h1 is 20 MB and stays in the 50 MB L2;
// at 128,000 rows it is 328 MB of HBM traffic a head, ~0.2 ms against ~6
// ms of FFMA time). A block of 256 threads owns a 128-row tile, 64, 128 or
// 160 columns wide; each thread 8 rows x 4, 8 or 10 columns. Both
// operands sit k-major in shared memory, A transposed on its way in, so a
// k step is two float4 loads of A and at most three of B (none bank-
// conflicted) for up to 80 FFMAs. Loads overlap the FFMAs: B by 16-byte
// cp.async a stage ahead, A through registers (16-byte loads a stage
// ahead, stored down the next stage's columns after the FFMAs) or, for
// the 160-wide tile whose 80 accumulators leave no registers for that, by
// 4-byte cp.async into a three-stage ring. At most 128 registers a thread
// (__launch_bounds__(256, 2)): two blocks an SM. The tile width is chosen
// per layer by waves (pick_shape): at 8000 rows layer 1 has 315 tiles of
// 128 x 128 for 264 block slots, 252 of 128 x 160. B is W^T, packed per
// call by the wrapper (ops/mlp_head.py `pack_weights_f32`, padded with
// zeros to multiples of 4); x's columns are zero-padded to a multiple of 4
// where they are not one. Ragged edges: rows past P, columns past N and
// depth past K are zero-filled by the loads.
#include "common.cuh"

// ---------------------------------------------------------------------------
// f32: one register-tiled SGEMM launch per layer (see the header note).

namespace plr2 {
namespace {

constexpr int kSgThreads = 256;  // a 16 x 16 grid: tx walks columns, ty rows
constexpr int kSgBM = 128;       // rows per block tile
// row stride of A's k-major stages: 16-byte rows; the stores (or copies)
// of one row's k by a warp fall in 2-way conflicting banks at worst
constexpr int kSgLdA = kSgBM + 4;

__host__ __device__ constexpr int round4(int n) { return (n + 3) & ~3; }

// A 128 x 160 tile (BN = 160) needs 80 accumulators a thread and leaves
// no registers to stage A through: its A comes by 4-byte cp.async into a
// ring of three 32-deep stages. The 64- and 128-wide tiles stage A through
// registers (16-byte loads, fewer load instructions) into two stages, 16
// k at a time: 32 deep for the 64-wide tile, 16 for the 128-wide one
// (whose 64 accumulators leave no room for the mid-stage loads).
template <int BN>
__host__ __device__ constexpr bool async_a() { return BN == 160; }

template <int BN>
__host__ __device__ constexpr int sgemm_bk() { return BN == 128 ? 16 : 32; }

template <int BN>
__host__ __device__ constexpr int sgemm_stages() { return async_a<BN>() ? 3 : 2; }

template <int BN>
constexpr int sgemm_smem_bytes() {
  return (int)sizeof(float) * sgemm_stages<BN>() * sgemm_bk<BN>() * (kSgLdA + BN);
}

// a thread's columns: float4 groups at 64 q + 4 tx, q < kQ, and for BN =
// 160 a float2 group at 128 + 2 tx
template <int BN> constexpr int kQ = BN >= 128 ? 2 : 1;
template <int BN> constexpr bool kPair = BN == 160;
template <int BN> constexpr int kTN = 4 * kQ<BN> + (kPair<BN> ? 2 : 0);  // 4, 8, 10

// `steps` k steps: as (k-major A, offset to this thread's 4 ty) and bs
// (k-major B, offset to 4 tx) into the thread's 8 x kTN accumulators
template <int BN, int steps>
__device__ __forceinline__ void sgemm_steps(const float* as, const float* bs, int tx,
                                            float (&acc)[8][kTN<BN>]) {
  constexpr int TN = kTN<BN>;
#pragma unroll
  for (int kk = 0; kk < steps; ++kk) {
    const float4 a0 = *reinterpret_cast<const float4*>(as + kk * kSgLdA);
    const float4 a1 = *reinterpret_cast<const float4*>(as + kk * kSgLdA + 64);
    const float a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
    float b[TN];
#pragma unroll
    for (int q = 0; q < kQ<BN>; ++q) {
      const float4 v = *reinterpret_cast<const float4*>(bs + kk * BN + q * 64);
      b[4 * q] = v.x, b[4 * q + 1] = v.y, b[4 * q + 2] = v.z, b[4 * q + 3] = v.w;
    }
    if (kPair<BN>) {  // bs + 128 - 2 tx = this thread's float2 at 128 + 2 tx
      const float2 v = *reinterpret_cast<const float2*>(bs + kk * BN + 128 - 2 * tx);
      b[TN - 2] = v.x, b[TN - 1] = v.y;
    }
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
  }
}

// One layer: C[M, N] = act(A[M, K] B[K, N] + bias), A row-major with row
// stride lda (a multiple of 4, 16-byte aligned), B the (K, ldb) packing
// of ops/mlp_head.py (W^T, ldb = round4(N), zero columns past N, 16-byte
// aligned). A block owns a 128 x BN tile; thread (tx, ty) of its 16 x 16
// grid owns rows {4 ty, 64 + 4 ty} + 0..3 and columns {4 tx, 64 + 4 tx}
// + 0..3 (BN = 128), 4 tx + 0..3 (BN = 64), or those of 128 and 128 +
// 2 tx + 0..1 (BN = 160). Both operands sit k-major in shared memory, so
// each k step is two float4 loads of A and two (one; two and a float2) of
// B. A is transposed on its way in: by 4-byte copies (BN = 160), or by
// 16-byte loads of 4 k of two rows a thread into registers, issued a
// stage ahead and stored down two columns of the next stage after the
// current stage's FFMAs. B arrives by 16-byte cp.async a stage ahead.
// Hidden layers (kLast = false) apply the ReLU and store rows of C up to
// ldc = round4(N) columns (the columns past N are exact zeros); the last
// layer stores N columns with scalar stores.
template <int BN, bool kLast>
__global__ void __launch_bounds__(kSgThreads, 2) head_sgemm_kernel(
    const float* __restrict__ A, int lda, const float* __restrict__ B, int ldb,
    const float* __restrict__ bias, float* __restrict__ C, int ldc, int M,
    int N, int K) {
  constexpr int TN = kTN<BN>, kBK = sgemm_bk<BN>(), S = sgemm_stages<BN>();
  constexpr int kQuads = kQ<BN>, kGroups = kQ<BN> + (kPair<BN> ? 1 : 0);
  extern __shared__ __align__(16) float smem[];
  float* As = smem;                      // [S][kBK][kSgLdA]
  float* Bs = smem + S * kBK * kSgLdA;   // [S][kBK][BN]
  // a warp is 8 tx x 4 ty: its A loads read 4 distinct float4s and its B
  // loads 8, one shared-memory wavefront each
  const int tid = threadIdx.x;
  const int tx = (tid & 7) | ((tid >> 5) & 1) << 3, ty = ((tid >> 3) & 3) | (tid >> 6) << 2;
  const int m0 = blockIdx.x * kSgBM, n0 = blockIdx.y * BN;
  const int nk = (K + kBK - 1) / kBK;

  auto load_b = [&](int kt, int s) {
    float* bs = Bs + s * kBK * BN;
#pragma unroll
    for (int r = 0; r < (kBK * BN / 4 + kSgThreads - 1) / kSgThreads; ++r) {
      const int e = tid + r * kSgThreads, kr = e / (BN / 4), nq = (e % (BN / 4)) * 4;
      if (kBK * BN / 4 % kSgThreads && e >= kBK * BN / 4) break;
      const int k = kt * kBK + kr, n = n0 + nq;
      const bool ok = k < K && n < ldb;
      cp_async16(bs + kr * BN + nq, ok ? B + (size_t)k * ldb + n : B, ok ? 16 : 0);
    }
  };

  float acc[8][TN];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

  if constexpr (async_a<BN>()) {
    // a warp copies 16 k of two rows a step (two cache lines)
    auto copy_a = [&](int kt, int s) {
      float* as = As + s * kBK * kSgLdA;
#pragma unroll
      for (int r = 0; r < kSgBM * kBK / kSgThreads; ++r) {  // 16 copies
        const int kr = (tid & 15) + 16 * (r >> 3), row = (tid >> 4) + 16 * (r & 7);
        const int m = m0 + row, k = kt * kBK + kr;
        const bool ok = m < M && k < K;
        cp_async4(as + kr * kSgLdA + row, ok ? A + (size_t)m * lda + k : A, ok ? 4 : 0);
      }
    };
#pragma unroll
    for (int s = 0; s < S - 1; ++s) {
      if (s < nk) copy_a(s, s), load_b(s, s);
      cp_async_commit();
    }
#pragma unroll 1
    for (int kt = 0; kt < nk; ++kt) {
      cp_async_wait<S - 2>();  // stage kt has landed (this thread's copies)
      __syncthreads();         // everyone's; everyone is done with kt - 1
      const int next = kt + S - 1;
      if (next < nk) copy_a(next, next % S), load_b(next, next % S);
      cp_async_commit();
      const int s = kt % S;
      sgemm_steps<BN, kBK>(As + s * kBK * kSgLdA + 4 * ty, Bs + s * kBK * BN + 4 * tx, tx, acc);
    }
  } else {
    // 4 k of rows ar and ar + 64 a half stage h (16 k; 4 threads share a
    // row's 64 bytes: a warp's load touches 8 cache lines)
    constexpr int kHalves = kBK / 16;
    const int ar = tid >> 2, ak = (tid & 3) * 4;
    float4 st[2];
    auto fetch_a = [&](int kt, int h) {
      const int k = kt * kBK + 16 * h + ak;
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int m = m0 + ar + 64 * r;
        const float* src = A + (size_t)(m < M ? m : 0) * lda + k;
        if (m < M && k + 4 <= K) {
          st[r] = *reinterpret_cast<const float4*>(src);
        } else {  // the ragged edge: rows past M, depth past K
          float v[4];
#pragma unroll
          for (int j = 0; j < 4; ++j) v[j] = m < M && k + j < K ? src[j] : 0.f;
          st[r] = make_float4(v[0], v[1], v[2], v[3]);
        }
      }
    };
    auto store_a = [&](int s, int h) {
      float* as = As + (s * kBK + 16 * h + ak) * kSgLdA + ar;
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        as[64 * r] = st[r].x;
        as[kSgLdA + 64 * r] = st[r].y;
        as[2 * kSgLdA + 64 * r] = st[r].z;
        as[3 * kSgLdA + 64 * r] = st[r].w;
      }
    };
#pragma unroll
    for (int h = 0; h < kHalves; ++h) fetch_a(0, h), store_a(0, h);
    load_b(0, 0);
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();
#pragma unroll 1
    for (int kt = 0; kt < nk; ++kt) {
      const int s = kt & 1;
      const bool more = kt + 1 < nk;
      if (more) {  // the next stage's loads, in flight during the FFMAs
        fetch_a(kt + 1, 0);
        load_b(kt + 1, s ^ 1);
      }
      cp_async_commit();
#pragma unroll
      for (int h = 0; h < kHalves; ++h) {
        sgemm_steps<BN, 16>(As + (s * kBK + 16 * h) * kSgLdA + 4 * ty,
                            Bs + (s * kBK + 16 * h) * BN + 4 * tx, tx, acc);
        if (more) {  // stage s ^ 1 was last read before the previous barrier
          store_a(s ^ 1, h);
          if (h + 1 < kHalves) fetch_a(kt + 1, h + 1);
        }
      }
      cp_async_wait<0>();
      __syncthreads();
    }
  }
  cp_async_wait<0>();

  // column group g: 4 columns at n0 + 64 g + 4 tx (g < kQ), or 2 at n0 +
  // 128 + 2 tx (g = kQ, BN = 160); accumulator columns 4 g ..
#pragma unroll
  for (int g = 0; g < kGroups; ++g) {
    const int wdt = g < kQuads ? 4 : 2;
    const int n = n0 + (g < kQuads ? 64 * g + 4 * tx : 128 + 2 * tx);
    float bv[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) bv[j] = j < wdt && n + j < N ? bias[n + j] : 0.f;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int m = m0 + (i >> 2) * 64 + 4 * ty + (i & 3);
      if (m >= M) continue;
      float v[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) v[j] = j < wdt ? acc[i][4 * g + j] + bv[j] : 0.f;
      float* o = C + (size_t)m * ldc + n;
      if (kLast) {
#pragma unroll
        for (int j = 0; j < wdt; ++j)
          if (n + j < N) o[j] = v[j];
      } else if (n < ldc && wdt == 4) {
        *reinterpret_cast<float4*>(o) = make_float4(
            fmaxf(v[0], 0.f), fmaxf(v[1], 0.f), fmaxf(v[2], 0.f), fmaxf(v[3], 0.f));
      } else if (n < ldc) {
        *reinterpret_cast<float2*>(o) = make_float2(fmaxf(v[0], 0.f), fmaxf(v[1], 0.f));
      }
    }
  }
}

struct SgemmShape {
  int bn;  // 64, 128 or 160 columns a tile
  int tiles_m, tiles_n;
};

// The column tile of a layer, by estimated time: waves of two blocks an SM
// times the work of a tile, a 128 x 64 tile counted at 75 for its fewer
// FMAs per shared load. 128 x 128 tiles do the most FMAs per load; 128 x
// 160 tiles (hidden layers only) cut N = 640 into 4, so layer 1 at 8000
// rows is one wave of 252 tiles on 264 slots (315 tiles at 128, 630 at 64).
SgemmShape pick_shape(int M, int N, int slots, bool last) {
  const int tm = (M + kSgBM - 1) / kSgBM;
  const int widths[3] = {128, 160, 64}, cost[3] = {128, 160, 75};
  SgemmShape best{0, tm, 0};
  long best_t = 0;
  for (int i = 0; i < 3; ++i) {
    if (last && widths[i] == 160) continue;
    const int tn = (N + widths[i] - 1) / widths[i];
    const long t = ((long)tm * tn + slots - 1) / slots * cost[i];
    if (best.bn == 0 || t < best_t) best = {widths[i], tm, tn}, best_t = t;
  }
  return best;
}

template <int BN, bool kLast>
cudaError_t launch_layer(const SgemmShape& g, const float* A, int lda,
                         const float* B, int ldb, const float* bias, float* C,
                         int ldc, int M, int N, int K, cudaStream_t stream) {
  static int granted = 0;
  auto kernel = head_sgemm_kernel<BN, kLast>;
  const int bytes = sgemm_smem_bytes<BN>();
  cudaError_t err = allow_smem(kernel, bytes, granted);
  if (err != cudaSuccess) return err;
  kernel<<<dim3(g.tiles_m, g.tiles_n), kSgThreads, bytes, stream>>>(
      A, lda, B, ldb, bias, C, ldc, M, N, K);
  return cudaGetLastError();
}

// The ladder as four launches; h1 and h3 in scratch[0 : P x lda], h2 in
// scratch[P x lda :], lda = round4(max(N1, N3)), ldb = round4(N2).
int launch_f32(const float* x, const float* const* wt, const float* const* b,
               float* out, float* scratch, int P, const int* k, const int* n,
               cudaStream_t stream) {
  if (P == 0) return (int)cudaGetLastError();
  const int lda = round4(n[0] > n[2] ? n[0] : n[2]), ldb = round4(n[1]);
  float* ha = scratch;
  float* hb = scratch + (size_t)P * lda;
  const float* in[4] = {x, ha, hb, ha};
  const int ld_in[4] = {k[0], lda, ldb, lda};
  float* outs[3] = {ha, hb, ha};
  const int ld_out[3] = {lda, ldb, lda};
  const int slots = block_slots(2);  // __launch_bounds__(256, 2)
  for (int l = 0; l < 4; ++l) {
    const SgemmShape g = pick_shape(P, n[l], slots, l == 3);
    const int ldw = round4(n[l]);
    cudaError_t err;
    if (l == 3)
      err = g.bn == 128
                ? launch_layer<128, true>(g, in[l], ld_in[l], wt[l], ldw, b[l],
                                          out, n[l], P, n[l], k[l], stream)
                : launch_layer<64, true>(g, in[l], ld_in[l], wt[l], ldw, b[l],
                                         out, n[l], P, n[l], k[l], stream);
    else if (g.bn == 160)
      err = launch_layer<160, false>(g, in[l], ld_in[l], wt[l], ldw, b[l], outs[l],
                                     ld_out[l], P, n[l], k[l], stream);
    else
      err = g.bn == 128
                ? launch_layer<128, false>(g, in[l], ld_in[l], wt[l], ldw, b[l],
                                           outs[l], ld_out[l], P, n[l], k[l], stream)
                : launch_layer<64, false>(g, in[l], ld_in[l], wt[l], ldw, b[l],
                                          outs[l], ld_out[l], P, n[l], k[l], stream);
    if (err != cudaSuccess) return (int)err;
  }
  return (int)cudaSuccess;
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

// x (P, C0); bi (Ni,); out (P, N4); all contiguous, one dtype. bf16: wi
// (Ni, N(i-1)), the wgmma kernel; C0, N1, N2, N3 multiples of 8 and every
// pointer 16-byte aligned (ops/mlp_head.py checks), any P and N4; scratch
// unused. f32: wi packed as W^T (round4(N(i-1)), round4(Ni)) with zeros
// past N(i-1) and Ni (ops/mlp_head.py `pack_weights_f32`), four
// register-tiled SGEMM launches; C0 a multiple of 4 (the wrapper pads x),
// x and the packed weights 16-byte aligned, scratch P x (round4(max(N1,
// N3)) + round4(N2)) floats for h1-h3, any P and N1..N4.
extern "C" int plr2_mlp_head(int dtype, const void* x, const void* w1,
                             const void* b1, const void* w2, const void* b2,
                             const void* w3, const void* b3, const void* w4,
                             const void* b4, void* out, void* scratch, int P,
                             int C0, int N1, int N2, int N3, int N4,
                             void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int k[4] = {C0, N1, N2, N3}, n[4] = {N1, N2, N3, N4};
  if (dtype == plr2::kBF16) {
    const void* w[4] = {w1, w2, w3, w4};
    const void* b[4] = {b1, b2, b3, b4};
    return plr2::launch_wgmma(x, w, b, out, P, k, n, s);
  }
  if (dtype == plr2::kF32) {
    auto f = [](const void* p) { return static_cast<const float*>(p); };
    const float* w[4] = {f(w1), f(w2), f(w3), f(w4)};
    const float* b[4] = {f(b1), f(b2), f(b3), f(b4)};
    return plr2::launch_f32(f(x), w, b, static_cast<float*>(out),
                            static_cast<float*>(scratch), P, k, n, s);
  }
  return (int)cudaErrorInvalidValue;
}
