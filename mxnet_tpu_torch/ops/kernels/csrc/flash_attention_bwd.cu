// Flash-attention backward for Hopper (sm_90a), plain C interface for ctypes.
//
// Replaces: mxnet_tpu/ops/pallas/flash_attention.py `_fa_backward` (:618)
// and its Pallas kernels `_fa_bwd_dq_kernel_res` (:351) /
// `_fa_bwd_dq_kernel_stream` (:391) (here: the dQ kernels) and
// `_fa_bwd_dkv_kernel_res` (:461) / `_fa_bwd_dkv_kernel_stream` (:531)
// (here: the dK/dV kernels). FlashAttention-2 math from the forward's saved
// per-row logsumexp (f32, natural log) and D = rowsum(dO * O), which the
// caller computes (as the reference does, :631; a cotangent of the lse folds
// into D there, so D stays an input): p = exp(scale * q.k - lse),
// dS = p * (dO.v - D), dQ = scale * dS K, dK = scale * dS^T Q, dV = p^T dO,
// dK/dV summed over the G query heads that share a kv head (GQA). Sums in
// f32 whatever the input type, each result cast once on its single store.
//
// Two kernels and no atomics, the reference's own split: a dQ kernel owns
// query rows and loops over keys; a dK/dV kernel owns key rows and loops
// over the query tiles of every head of its group. The gradients are
// bitwise repeatable; the price is recomputing S and dP in the dQ kernel.
//
// What bounds it on the card: 10 * D flops per visible (query, key) pair and
// head (q.k recomputed, dO.v, and the products into dQ, dK, dV). At the
// training shape (B 4, H 16, Hkv 4, T 2048, D 128, causal) that is
// ~172 GFLOP against ~168 MB of q/k/v/o/dO/dQ/dK/dV in bf16: bound by
// operations, ~0.17 ms on the bf16 tensor cores, ~2.6 ms at the 67 TFLOP/s
// f32 rate. The two-kernel split does 14 * D (S and dP twice); the bf16
// kernels' split operands (below) make that 20 * D of tensor work.
//
// Two designs, one per type, as in the forward (flash_attention_fwd.cu).
//
// bf16 (flash_bwd_dq_wgmma_kernel, flash_bwd_dkv_wgmma_kernel): a block owns
// 128 rows (keys for dK/dV, queries for dQ) of one (batch, head) as two
// warpgroups of 64 (256 threads), loads its own rows of two operands once
// (K and V; Q and dO) by TMA, and streams 64-row tiles of the other two
// (Q and dO for each head of the group; K and V) through a 3-stage ring:
// 4-D tensor maps over (D, T, H, B) with the tensors' byte strides, built
// per call on the host, 128-byte swizzle. Each stage has a full barrier and
// an empty one that the 8 warps arrive on once wgmma.wait_group shows their
// products reading it are done; thread 0 refills a stage two tiles ahead.
// Per tile a warpgroup issues its two score products, S^T = K Q^T and
// dP^T = V dO^T (dK/dV) or S = Q K^T and dP = dO V^T (dQ), as wgmma
// m64n64k16 with both operands K-major in shared memory, waits for S only
// and turns it into P = exp2(scale * log2(e) * S - lse * log2(e)) in
// registers while dP is still on the tensor cores, then dS = P (dP - D).
// The accumulator of m64n64 is already the A fragment's order
// (hopper.cuh), so P and dS enter the next products from registers (the RS
// form of wgmma) and never touch shared memory: dV += P^T dO and
// dK += dS^T Q, or dQ += dS K, with the B operand read MN-major through the
// transpose bit. P and dS go in as two bf16 parts each, hi = bf16(x) and
// lo = bf16(x - hi): the TPU kernel and the plain version keep them in f32,
// and a single bf16 P misses chip_smoke.py's unchanged bf16 gate for dV by
// up to 1.76x, a single bf16 dS for dQ by up to 2.23x (dK 1.38x), while
// the split keeps every gradient within 0.13-0.35x of it
// (mxnet_tpu_torch/tools/flash_bwd_spread.py repeats this arithmetic on the
// CPU); the split costs a second product for each, 20 * D against 14 * D. The dK/dV kernel's 64 lse and D values of a tile are staged in
// shared memory by each warpgroup (a named barrier per tile), the dQ
// kernel's two rows a thread sit in registers. No wgmma group outlives its
// tile, so every wgmma_wait is unconditional without peeling a tile. No
// producer warp: the accumulators (dK 64 + dV 64, or dQ 64) and the two
// score tiles (32 + 32) take ~200 f32 registers a thread, and a third
// warpgroup would cap a thread at 168. Tiles on the masked side of the causal
// diagonal are never loaded; the mask runs only on tiles that cross it (or,
// for dQ, a ragged Tk); rows past Tq read lse = +inf, so their P is 0. The
// longest causal blocks start first: the lowest key blocks (dK/dV) and the
// highest query blocks (dQ), with the (batch, head) on grid x. 160 KB of
// shared memory at D = 128, 80 KB at D = 64.
//
// f32 (flash_bwd_dq_f32_kernel, flash_bwd_dkv_f32_kernel): full f32, no
// TF32 (the train phase holds parameters to 1e-5 against the CPU). A block
// owns 64 rows, 256 threads as 16 x 16; each thread holds a 4 x 4 register
// tile of S and of dP (rows 4tr.., columns tc + 16c) and a 4 x D/16 tile of
// each accumulator, and reads every operand from shared memory as float4.
// Score loops: per 4 dims 16 loads feed 128 FMAs, half of them broadcasts
// within a half-warp; product loops: per row of the reduction 3 loads feed
// 32 FMAs (D = 128). The streamed tiles (K/V for dQ, Q/dO for dK/dV) are
// double-buffered with 16-byte cp.async, so tile j + 1 loads while tile j
// computes; rows are padded to D + 4 floats so the 8 rows a float4 phase
// reads fall in distinct banks. dS^T (dQ) or P^T then dS^T (dK/dV) pass
// between threads through shared memory: dQ's over the V stage it was
// computed from, dK/dV's through one 64 x 68 buffer in turn. The dK/dV
// kernel stages each tile's lse and D in shared memory beside its
// cp.async group. 198 KB (dQ) / 216 KB (dK/dV) of shared memory at
// D = 128.
//
// Ragged Tq/Tk tails are masked in every kernel, so every length runs.

#include "hopper.cuh"

#include <math.h>

namespace {

constexpr float LOG2E = 1.44269504088896340736f;

// --- bf16: wgmma + TMA ----------------------------------------------------------
namespace wg {

constexpr int OWN = 128;       // rows a block owns (two warpgroups of 64)
constexpr int TILE = 64;       // rows of a streamed tile
constexpr int STAGES = 3;
constexpr int THREADS = 256;
constexpr int BOX = 64;        // bf16 columns of one 128-byte swizzled box
constexpr int ROW_BYTES = 128;

template <int D>
struct Layout {
  static constexpr int BOXES = D / BOX;
  static constexpr int OWN_BYTES = OWN * D * 2;    // one owned operand
  static constexpr int TILE_BYTES = TILE * D * 2;  // one streamed operand
  static constexpr int B_OFF = OWN_BYTES;          // the second owned one
  static constexpr int RING_OFF = 2 * OWN_BYTES;   // stage s at + s * 2 tiles
  static constexpr int STAT_OFF = RING_OFF + STAGES * 2 * TILE_BYTES;
  // dK/dV: [warpgroup][parity][lse | D][64] f32
  static constexpr int STAT_BYTES = 2 * 2 * 2 * TILE * 4;
  static constexpr int BAR_OFF = STAT_OFF + STAT_BYTES;
  // owned-rows barrier, full and empty per stage; slack to round the
  // dynamic base up to 1024 bytes
  static constexpr int BYTES = BAR_OFF + (1 + 2 * STAGES) * 8 + 1024;
};

// acc (64 x 64) = A B^T over the depth D: A the warpgroup's 64 rows at
// `a`, B 64 rows at `b`, both K-major with their 64-wide boxes `a_box` /
// `b_box` bytes apart; issued, not waited for
template <int D>
__device__ __forceinline__ void issue_scores(float (&acc)[32], uint32_t a,
                                             uint32_t a_box, uint32_t b,
                                             uint32_t b_box) {
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const uint32_t at = (kk % 4) * 32;
    hopper::wgmma_ss_m64n64k16(
        acc, hopper::make_desc_sw128(a + (kk / 4) * a_box + at, 16, 1024),
        hopper::make_desc_sw128(b + (kk / 4) * b_box + at, 16, 1024),
        kk > 0);
  }
}

// acc (64 x D) += X B with X (64 x 64) as hi + lo A fragments and B the
// streamed 64-row tile at `b`, read MN-major (its D boxes TILE * 128 bytes
// apart, the LBO); issued, not waited for
template <int D>
__device__ __forceinline__ void issue_product(float (&acc)[D / 2],
                                              const uint32_t (&hi)[4][4],
                                              const uint32_t (&lo)[4][4],
                                              uint32_t b) {
#pragma unroll
  for (int kc = 0; kc < TILE / 16; ++kc) {
    const uint64_t db = hopper::make_desc_sw128(b + kc * 16 * ROW_BYTES,
                                                TILE * ROW_BYTES, 1024);
    if constexpr (D == 128) {
      hopper::wgmma_rs_m64n128k16_tb(acc, hi[kc], db);
      hopper::wgmma_rs_m64n128k16_tb(acc, lo[kc], db);
    } else {
      hopper::wgmma_rs_m64n64k16_tb(acc, hi[kc], db);
      hopper::wgmma_rs_m64n64k16_tb(acc, lo[kc], db);
    }
  }
}

// Rows r0 and r0 + 8 of a (64 x D) accumulator, times `mul`, as bf16 into
// the contiguous rows of `out` (row r at out + r * D), rows >= `limit` not
// written; r0 = the thread's first row, cq its first column.
template <int D>
__device__ __forceinline__ void store_rows(const float (&acc)[D / 2],
                                           __nv_bfloat16* out, int r0,
                                           int limit, int cq, float mul) {
  __nv_bfloat16* o0 = out + (int64_t)r0 * D + cq;
  __nv_bfloat16* o1 = o0 + 8 * D;
#pragma unroll
  for (int g = 0; g < D / 8; ++g) {
    if (r0 < limit)
      *reinterpret_cast<__nv_bfloat162*>(o0 + 8 * g) = __floats2bfloat162_rn(
          acc[4 * g] * mul, acc[4 * g + 1] * mul);
    if (r0 + 8 < limit)
      *reinterpret_cast<__nv_bfloat162*>(o1 + 8 * g) = __floats2bfloat162_rn(
          acc[4 * g + 2] * mul, acc[4 * g + 3] * mul);
  }
}

// Barriers, 8 bytes each from `at`: the owned rows; full[s]; empty[s].
struct Bars {
  uint32_t own, full, empty;
  __device__ explicit Bars(uint32_t at)
      : own(at), full(at + 8), empty(at + 8 + 8 * STAGES) {}
  __device__ void init() const {
    hopper::mbar_init(own, 1);
    for (int s = 0; s < STAGES; ++s) {
      hopper::mbar_init(full + 8 * s, 1);
      hopper::mbar_init(empty + 8 * s, 8);  // one arrival per warp
    }
    hopper::mbar_fence_init();
  }
};

// dK/dV: the block owns keys k0 .. k0 + 127 of kv head hk; warpgroup c owns
// keys k0 + 64c ..; iteration i streams query tile qt_lo + i % per of the
// group's head i / per.
template <int D>
__global__ void __launch_bounds__(THREADS, 1)
flash_bwd_dkv_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                           const __grid_constant__ CUtensorMap tk,
                           const __grid_constant__ CUtensorMap tv,
                           const __grid_constant__ CUtensorMap tdo,
                           const float* __restrict__ lse,
                           const float* __restrict__ dvec,
                           __nv_bfloat16* __restrict__ dk,
                           __nv_bfloat16* __restrict__ dv, int H, int Hkv,
                           int Tq, int Tk, float scale, int causal) {
  using namespace hopper;
  using L = Layout<D>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  const uint32_t sK = base, sV = base + L::B_OFF, ring = base + L::RING_OFF;
  float* stat = reinterpret_cast<float*>(smem_raw + (base - raw) + L::STAT_OFF);
  const Bars bar(base + L::BAR_OFF);

  const int bkv = blockIdx.x;
  const int b = bkv / Hkv;
  const int hk = bkv % Hkv;
  const int G = H / Hkv;
  const int k0 = blockIdx.y * OWN;  // y = 0 first: the longest causal blocks
  const int offset = Tk - Tq;
  // causal: query tiles wholly before the block's first key see none of it
  const int qt_lo = causal ? max(k0 - offset, 0) / TILE : 0;
  const int per = (Tq + TILE - 1) / TILE - qt_lo;
  const int n = G * per;

  if (threadIdx.x == 0) bar.init();
  __syncthreads();

  // thread 0: Q and dO of iteration i into stage i % STAGES, once the 8
  // warps have released that stage's previous tile
  auto load = [&](int i) {
    const int s = i % STAGES;
    if (i >= STAGES) mbar_wait(bar.empty + 8 * s, (i / STAGES - 1) & 1);
    const int h = hk * G + i / per;
    const int q0 = (qt_lo + i % per) * TILE;
    const uint32_t dst = ring + s * 2 * L::TILE_BYTES;
    mbar_expect_tx(bar.full + 8 * s, 2 * L::TILE_BYTES);
    for (int x = 0; x < L::BOXES; ++x) {
      tma_load_4d(dst + x * TILE * ROW_BYTES, &tq, bar.full + 8 * s, x * BOX,
                  q0, h, b);
      tma_load_4d(dst + L::TILE_BYTES + x * TILE * ROW_BYTES, &tdo,
                  bar.full + 8 * s, x * BOX, q0, h, b);
    }
  };
  if (threadIdx.x == 0) {
    mbar_expect_tx(bar.own, 2 * L::OWN_BYTES);
    for (int x = 0; x < L::BOXES; ++x) {
      tma_load_4d(sK + x * OWN * ROW_BYTES, &tk, bar.own, x * BOX, k0, hk, b);
      tma_load_4d(sV + x * OWN * ROW_BYTES, &tv, bar.own, x * BOX, k0, hk, b);
    }
    for (int i = 0; i < min(n, STAGES - 1); ++i) load(i);
  }

  const int c = threadIdx.x / 128;
  const int t = threadIdx.x % 128;
  const int lane = t % 32;
  const int key0 = 16 * (t / 32) + lane / 4;   // and key0 + 8, in the group
  const int cq = 2 * (lane % 4);
  const int first_key = k0 + 64 * c;
  const uint32_t k_rows = sK + 64 * c * ROW_BYTES;
  const uint32_t v_rows = sV + 64 * c * ROW_BYTES;
  const float scale_log2 = scale * LOG2E;
  // this warpgroup's stats: [parity][lse * log2(e) | D][64]
  float* my_stat = stat + c * 2 * 2 * TILE;

  // thread t's stat of iteration i: lse (t < 64) or D of query t % 64;
  // rows past Tq get lse = +inf, so their P is 0
  auto stat_of = [&](int i) {
    const int q = (qt_lo + i % per) * TILE + t % TILE;
    const int64_t at = ((int64_t)b * H + hk * G + i / per) * Tq + q;
    if (t < TILE) return q < Tq ? lse[at] * LOG2E : INFINITY;
    return q < Tq ? dvec[at] : 0.f;
  };

  float dk_acc[D / 2], dv_acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dk_acc[i] = dv_acc[i] = 0.f;
  float s_acc[32], dp_acc[32];
  uint32_t p_hi[4][4], p_lo[4][4], d_hi[4][4], d_lo[4][4];

  float stat_next = stat_of(0);
  mbar_wait(bar.own, 0);
  for (int i = 0; i < n; ++i) {
    const int s = i % STAGES;
    const uint32_t sq = ring + s * 2 * L::TILE_BYTES;
    const uint32_t sdo = sq + L::TILE_BYTES;
    const int q0 = (qt_lo + i % per) * TILE;
    float* st = my_stat + (i & 1) * 2 * TILE;
    st[t] = stat_next;
    if (i + 1 < n) stat_next = stat_of(i + 1);
    named_bar_sync(1 + c, 128);
    mbar_wait(bar.full + 8 * s, (i / STAGES) & 1);

    fence_all(s_acc);
    fence_all(dp_acc);
    wgmma_fence();
    issue_scores<D>(s_acc, k_rows, OWN * ROW_BYTES, sq, TILE * ROW_BYTES);
    wgmma_commit();
    issue_scores<D>(dp_acc, v_rows, OWN * ROW_BYTES, sdo, TILE * ROW_BYTES);
    wgmma_commit();
    fence_all(s_acc);
    fence_all(dp_acc);

    // P^T while dP^T is on the tensor cores; row = key, column = query
    wgmma_wait<1>();
    fence_all(s_acc);
    const bool mask = causal && q0 + offset < first_key + 63;
#pragma unroll
    for (int e = 0; e < 32; ++e) {
      const int col = 8 * (e / 4) + cq + (e % 2);
      float p = ex2(s_acc[e] * scale_log2 - st[col]);
      if (mask && first_key + key0 + ((e & 2) ? 8 : 0) > q0 + col + offset)
        p = 0.f;
      s_acc[e] = p;
    }
    wgmma_wait<0>();
    fence_all(dp_acc);
#pragma unroll
    for (int e = 0; e < 32; ++e) {
      const int col = 8 * (e / 4) + cq + (e % 2);
      dp_acc[e] = s_acc[e] * (dp_acc[e] - st[TILE + col]);
    }

    // dV += P^T dO, then dK += dS^T Q (dS split while dV runs)
    split_fragments(s_acc, p_hi, p_lo);
    fence_all(dv_acc);
    fence_all(p_hi);
    fence_all(p_lo);
    wgmma_fence();
    issue_product<D>(dv_acc, p_hi, p_lo, sdo);
    wgmma_commit();
    fence_all(dv_acc);
    fence_all(p_hi);
    fence_all(p_lo);
    split_fragments(dp_acc, d_hi, d_lo);
    fence_all(dk_acc);
    fence_all(d_hi);
    fence_all(d_lo);
    wgmma_fence();
    issue_product<D>(dk_acc, d_hi, d_lo, sq);
    wgmma_commit();
    fence_all(dk_acc);
    fence_all(d_hi);
    fence_all(d_lo);
    wgmma_wait<0>();
    fence_all(dv_acc);
    fence_all(dk_acc);
    fence_all(p_hi);
    fence_all(p_lo);
    fence_all(d_hi);
    fence_all(d_lo);
    if (lane == 0) mbar_arrive(bar.empty + 8 * s);  // this warp read stage s
    if (threadIdx.x == 0 && i + STAGES - 1 < n) load(i + STAGES - 1);
  }

  const int64_t row0 = (int64_t)bkv * Tk;
  store_rows<D>(dk_acc, dk + row0 * D, first_key + key0, Tk, cq, scale);
  store_rows<D>(dv_acc, dv + row0 * D, first_key + key0, Tk, cq, 1.f);
}

// dQ: the block owns queries q0 .. q0 + 127 of head h; warpgroup c owns
// q0 + 64c ..; tile j streams keys 64j .. 64j + 63 of kv head h / G.
template <int D>
__global__ void __launch_bounds__(THREADS, 1)
flash_bwd_dq_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                          const __grid_constant__ CUtensorMap tk,
                          const __grid_constant__ CUtensorMap tv,
                          const __grid_constant__ CUtensorMap tdo,
                          const float* __restrict__ lse,
                          const float* __restrict__ dvec,
                          __nv_bfloat16* __restrict__ dq, int H, int G,
                          int Tq, int Tk, float scale, int causal) {
  using namespace hopper;
  using L = Layout<D>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t sQ = base, sdO = base + L::B_OFF, ring = base + L::RING_OFF;
  const Bars bar(base + L::BAR_OFF);

  const int bh = blockIdx.x;
  const int b = bh / H;
  const int h = bh % H;
  const int hk = h / G;
  // blocks launch x-fastest: every head's longest causal block goes first
  const int q0 = (gridDim.y - 1 - blockIdx.y) * OWN;
  const int offset = Tk - Tq;
  int n = (Tk + TILE - 1) / TILE;
  if (causal)  // tiles right of the block's last diagonal are never loaded
    n = min(n, (min(q0 + OWN, Tq) - 1 + offset) / TILE + 1);

  if (threadIdx.x == 0) bar.init();
  __syncthreads();

  auto load = [&](int j) {
    const int s = j % STAGES;
    if (j >= STAGES) mbar_wait(bar.empty + 8 * s, (j / STAGES - 1) & 1);
    const uint32_t dst = ring + s * 2 * L::TILE_BYTES;
    mbar_expect_tx(bar.full + 8 * s, 2 * L::TILE_BYTES);
    for (int x = 0; x < L::BOXES; ++x) {
      tma_load_4d(dst + x * TILE * ROW_BYTES, &tk, bar.full + 8 * s, x * BOX,
                  j * TILE, hk, b);
      tma_load_4d(dst + L::TILE_BYTES + x * TILE * ROW_BYTES, &tv,
                  bar.full + 8 * s, x * BOX, j * TILE, hk, b);
    }
  };
  if (threadIdx.x == 0) {
    mbar_expect_tx(bar.own, 2 * L::OWN_BYTES);
    for (int x = 0; x < L::BOXES; ++x) {
      tma_load_4d(sQ + x * OWN * ROW_BYTES, &tq, bar.own, x * BOX, q0, h, b);
      tma_load_4d(sdO + x * OWN * ROW_BYTES, &tdo, bar.own, x * BOX, q0, h,
                  b);
    }
    for (int j = 0; j < min(n, STAGES - 1); ++j) load(j);
  }

  const int c = threadIdx.x / 128;
  const int t = threadIdx.x % 128;
  const int lane = t % 32;
  const int row0 = q0 + 64 * c + 16 * (t / 32) + lane / 4;  // and row0 + 8
  const int cq = 2 * (lane % 4);
  const int first_qpos = q0 + 64 * c + offset;  // the warpgroup's least
  const uint32_t q_rows = sQ + 64 * c * ROW_BYTES;
  const uint32_t do_rows = sdO + 64 * c * ROW_BYTES;
  const float scale_log2 = scale * LOG2E;
  const int64_t at0 = (int64_t)bh * Tq + row0;
  const float lse0 = row0 < Tq ? lse[at0] * LOG2E : INFINITY;
  const float lse1 = row0 + 8 < Tq ? lse[at0 + 8] * LOG2E : INFINITY;
  const float d0 = row0 < Tq ? dvec[at0] : 0.f;
  const float d1 = row0 + 8 < Tq ? dvec[at0 + 8] : 0.f;

  float dq_acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dq_acc[i] = 0.f;
  float s_acc[32], dp_acc[32];
  uint32_t d_hi[4][4], d_lo[4][4];

  mbar_wait(bar.own, 0);
  for (int j = 0; j < n; ++j) {
    const int s = j % STAGES;
    const uint32_t sk = ring + s * 2 * L::TILE_BYTES;
    const uint32_t sv = sk + L::TILE_BYTES;
    const int k0 = j * TILE;
    mbar_wait(bar.full + 8 * s, (j / STAGES) & 1);

    fence_all(s_acc);
    fence_all(dp_acc);
    wgmma_fence();
    issue_scores<D>(s_acc, q_rows, OWN * ROW_BYTES, sk, TILE * ROW_BYTES);
    wgmma_commit();
    issue_scores<D>(dp_acc, do_rows, OWN * ROW_BYTES, sv, TILE * ROW_BYTES);
    wgmma_commit();
    fence_all(s_acc);
    fence_all(dp_acc);

    // P while dP is on the tensor cores; row = query, column = key
    wgmma_wait<1>();
    fence_all(s_acc);
    const bool mask = k0 + TILE > Tk || (causal && k0 + TILE - 1 > first_qpos);
#pragma unroll
    for (int e = 0; e < 32; ++e) {
      const bool second = e & 2;
      float p = ex2(s_acc[e] * scale_log2 - (second ? lse1 : lse0));
      if (mask) {
        const int key = k0 + 8 * (e / 4) + cq + (e % 2);
        const int qpos = row0 + (second ? 8 : 0) + offset;
        if (key >= Tk || (causal && key > qpos)) p = 0.f;
      }
      s_acc[e] = p;
    }
    wgmma_wait<0>();
    fence_all(dp_acc);
#pragma unroll
    for (int e = 0; e < 32; ++e)
      dp_acc[e] = s_acc[e] * (dp_acc[e] - ((e & 2) ? d1 : d0));

    // dQ += dS K
    split_fragments(dp_acc, d_hi, d_lo);
    fence_all(dq_acc);
    fence_all(d_hi);
    fence_all(d_lo);
    wgmma_fence();
    issue_product<D>(dq_acc, d_hi, d_lo, sk);
    wgmma_commit();
    fence_all(dq_acc);
    fence_all(d_hi);
    fence_all(d_lo);
    wgmma_wait<0>();
    fence_all(dq_acc);
    fence_all(d_hi);
    fence_all(d_lo);
    if (lane == 0) mbar_arrive(bar.empty + 8 * s);
    if (threadIdx.x == 0 && j + STAGES - 1 < n) load(j + STAGES - 1);
  }

  store_rows<D>(dq_acc, dq + (int64_t)bh * Tq * D, row0, Tq, cq, scale);
}

// maps over (D, T, H, B) with the byte strides of T, H, B; box rows `rq`
// for q/dO and `rk` for k/v
int encode_maps(CUtensorMap* m, const void* q, const void* k, const void* v,
                const void* dout, int D, int B, int H, int Hkv, int Tq,
                int Tk, const int64_t qs[3], const int64_t ks[3],
                const int64_t vs[3], const int64_t os[3], int rq, int rk) {
  const uint64_t dq[4] = {(uint64_t)D, (uint64_t)Tq, (uint64_t)H,
                          (uint64_t)B};
  const uint64_t dk[4] = {(uint64_t)D, (uint64_t)Tk, (uint64_t)Hkv,
                          (uint64_t)B};
  const int64_t* all[4] = {qs, ks, vs, os};
  uint64_t st[4][3];
  for (int i = 0; i < 4; ++i)
    for (int j = 0; j < 3; ++j) st[i][j] = (uint64_t)all[i][2 - j];
  int err = hopper::encode_bf16_4d(&m[0], q, dq, st[0], rq);
  if (err == 0) err = hopper::encode_bf16_4d(&m[1], k, dk, st[1], rk);
  if (err == 0) err = hopper::encode_bf16_4d(&m[2], v, dk, st[2], rk);
  if (err == 0) err = hopper::encode_bf16_4d(&m[3], dout, dq, st[3], rq);
  return err;
}

template <int D>
int launch(int which, const void* q, const void* k, const void* v,
           const void* dout, const float* lse, const float* dvec, void* dq,
           void* dk, void* dv, int B, int H, int Hkv, int Tq, int Tk,
           const int64_t qs[3], const int64_t ks[3], const int64_t vs[3],
           const int64_t os[3], float scale, int causal,
           cudaStream_t stream) {
  CUtensorMap m[4];
  const int smem = Layout<D>::BYTES;
  cudaError_t e;
  if (which == 0) {
    int err = encode_maps(m, q, k, v, dout, D, B, H, Hkv, Tq, Tk, qs, ks, vs,
                          os, OWN, TILE);
    if (err != 0) return err;
    e = cudaFuncSetAttribute(flash_bwd_dq_wgmma_kernel<D>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem);
    if (e != cudaSuccess) return (int)e;
    flash_bwd_dq_wgmma_kernel<D>
        <<<dim3(B * H, (Tq + OWN - 1) / OWN), THREADS, smem, stream>>>(
            m[0], m[1], m[2], m[3], lse, dvec,
            static_cast<__nv_bfloat16*>(dq), H, H / Hkv, Tq, Tk, scale,
            causal);
    return (int)cudaGetLastError();
  }
  int err = encode_maps(m, q, k, v, dout, D, B, H, Hkv, Tq, Tk, qs, ks, vs,
                        os, TILE, OWN);
  if (err != 0) return err;
  e = cudaFuncSetAttribute(flash_bwd_dkv_wgmma_kernel<D>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  flash_bwd_dkv_wgmma_kernel<D>
      <<<dim3(B * Hkv, (Tk + OWN - 1) / OWN), THREADS, smem, stream>>>(
          m[0], m[1], m[2], m[3], lse, dvec, static_cast<__nv_bfloat16*>(dk),
          static_cast<__nv_bfloat16*>(dv), H, Hkv, Tq, Tk, scale, causal);
  return (int)cudaGetLastError();
}

}  // namespace wg

// --- f32: register tiles + cp.async ----------------------------------------------
namespace rt {

constexpr int ROWS = 64;       // rows a block owns, and of a streamed tile
constexpr int THREADS = 256;   // 16 x 16: thread (tr, tc) = (t / 16, t % 16)
constexpr int TLD = ROWS + 4;  // row stride of a transposed 64 x 64 tile

template <int D>
struct Layout {
  static constexpr int LD = D + 4;        // row stride of a D-wide tile
  static constexpr int TILE = ROWS * LD;  // floats of one D-wide tile
  // dQ: Q, dO, then two stages of (K, V); dS^T over the V it came from
  static constexpr int DQ_FLOATS = 6 * TILE;
  // dK/dV: K, V, two stages of (Q, dO), the P^T / dS^T buffer, and two
  // stages of the tile's (lse * log2(e), D)
  static constexpr int PT_OFF = 6 * TILE;
  static constexpr int STAT_OFF = PT_OFF + ROWS * TLD;
  static constexpr int DKV_FLOATS = STAT_OFF + 2 * 2 * ROWS;
};

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

// rows [r0, r0 + 64) of a (T, D) slice at row stride `st` into a 64 x LD
// tile with 16-byte cp.async; rows past T are zeros
template <int D>
__device__ __forceinline__ void load_rows(float* dst, const float* src,
                                          int64_t st, int r0, int T) {
  constexpr int C4 = D / 4;
  for (int i = threadIdx.x; i < ROWS * C4; i += THREADS) {
    const int r = i / C4, cc = (i % C4) * 4;
    const bool ok = r0 + r < T;
    hopper::cp_async16(dst + r * Layout<D>::LD + cc,
                       src + (ok ? (int64_t)(r0 + r) * st : 0) + cc, ok);
  }
}

// acc[r][c] += sum over D of a[4tr + r] . b[tc + 16c], both 64 x LD tiles
template <int D>
__device__ __forceinline__ void scores(float (&acc)[4][4], const float* a,
                                       const float* b, int tr, int tc) {
  constexpr int LD = Layout<D>::LD;
#pragma unroll 4
  for (int d = 0; d < D; d += 4) {
    float4 bf[4];
#pragma unroll
    for (int c = 0; c < 4; ++c) bf[c] = ld4(b + (tc + 16 * c) * LD + d);
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const float4 af = ld4(a + (4 * tr + r) * LD + d);
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        acc[r][c] = fmaf(af.x, bf[c].x, acc[r][c]);
        acc[r][c] = fmaf(af.y, bf[c].y, acc[r][c]);
        acc[r][c] = fmaf(af.z, bf[c].z, acc[r][c]);
        acc[r][c] = fmaf(af.w, bf[c].w, acc[r][c]);
      }
    }
  }
}

// acc[r][4g + e] += sum over the 64 rows k of xt[k][4tr + r] *
// y[k][64g + 4tc + e]: xt a transposed 64 x TLD tile, y a 64 x LD tile
template <int D>
__device__ __forceinline__ void product(float (&acc)[4][D / 16],
                                        const float* xt, const float* y,
                                        int tr, int tc) {
  constexpr int LD = Layout<D>::LD;
#pragma unroll 4
  for (int k = 0; k < ROWS; ++k) {
    const float4 x = ld4(xt + k * TLD + 4 * tr);
    const float xr[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
    for (int g = 0; g < D / 64; ++g) {
      const float4 yf = ld4(y + k * LD + 64 * g + 4 * tc);
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        acc[r][4 * g + 0] = fmaf(xr[r], yf.x, acc[r][4 * g + 0]);
        acc[r][4 * g + 1] = fmaf(xr[r], yf.y, acc[r][4 * g + 1]);
        acc[r][4 * g + 2] = fmaf(xr[r], yf.z, acc[r][4 * g + 2]);
        acc[r][4 * g + 3] = fmaf(xr[r], yf.w, acc[r][4 * g + 3]);
      }
    }
  }
}

// x (4 rows x columns tc + 16c) into xt transposed: xt[col][4tr + r]
__device__ __forceinline__ void store_transposed(float* xt,
                                                 const float (&x)[4][4],
                                                 int tr, int tc) {
#pragma unroll
  for (int c = 0; c < 4; ++c)
    *reinterpret_cast<float4*>(xt + (tc + 16 * c) * TLD + 4 * tr) =
        make_float4(x[0][c], x[1][c], x[2][c], x[3][c]);
}

template <int D>
__device__ __forceinline__ void store_acc(const float (&acc)[4][D / 16],
                                          float* out, int r0, int limit,
                                          int tc, float mul) {
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    if (r0 + r >= limit) continue;
    float* row = out + (int64_t)(r0 + r) * D + 4 * tc;
#pragma unroll
    for (int g = 0; g < D / 64; ++g)
      *reinterpret_cast<float4*>(row + 64 * g) = make_float4(
          acc[r][4 * g] * mul, acc[r][4 * g + 1] * mul,
          acc[r][4 * g + 2] * mul, acc[r][4 * g + 3] * mul);
  }
}

template <int D>
__global__ void __launch_bounds__(THREADS, 1)
flash_bwd_dq_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                        const float* __restrict__ v,
                        const float* __restrict__ dout,
                        const float* __restrict__ lse,
                        const float* __restrict__ dvec, float* __restrict__ dq,
                        int H, int G, int Tq, int Tk,
                        int64_t q_sb, int64_t q_sh, int64_t q_st,
                        int64_t k_sb, int64_t k_sh, int64_t k_st,
                        int64_t v_sb, int64_t v_sh, int64_t v_st,
                        int64_t o_sb, int64_t o_sh, int64_t o_st,
                        float scale, int causal) {
  using L = Layout<D>;
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  float* Qs = smem;                // pre-scaled by scale * log2(e)
  float* Os = smem + L::TILE;      // dO
  float* KV = smem + 2 * L::TILE;  // stage st: K at + 2st tiles, V after

  const int tid = threadIdx.x;
  const int tr = tid / 16, tc = tid % 16;
  const int bh = blockIdx.x;
  const int b = bh / H;
  const int h = bh % H;
  const int hk = h / G;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * ROWS;  // longest tiles first
  const int offset = Tk - Tq;
  int n = (Tk + ROWS - 1) / ROWS;
  if (causal) n = min(n, (min(q0 + ROWS, Tq) - 1 + offset) / ROWS + 1);

  const float* kp = k + b * k_sb + hk * k_sh;
  const float* vp = v + b * v_sb + hk * v_sh;
  auto load_tile = [&](int j, int st) {
    load_rows<D>(KV + 2 * st * L::TILE, kp, k_st, j * ROWS, Tk);
    load_rows<D>(KV + (2 * st + 1) * L::TILE, vp, v_st, j * ROWS, Tk);
    hopper::cp_async_commit();
  };
  load_tile(0, 0);
  const float c2 = scale * LOG2E;
  {
    const float* qp = q + b * q_sb + h * q_sh;
    const float* op = dout + b * o_sb + h * o_sh;
    constexpr int C4 = D / 4;
    for (int i = tid; i < ROWS * C4; i += THREADS) {
      const int r = i / C4, cc = (i % C4) * 4;
      float4 x = make_float4(0.f, 0.f, 0.f, 0.f), y = x;
      if (q0 + r < Tq) {
        x = ld4(qp + (int64_t)(q0 + r) * q_st + cc);
        y = ld4(op + (int64_t)(q0 + r) * o_st + cc);
      }
      *reinterpret_cast<float4*>(Qs + r * L::LD + cc) =
          make_float4(x.x * c2, x.y * c2, x.z * c2, x.w * c2);
      *reinterpret_cast<float4*>(Os + r * L::LD + cc) = y;
    }
  }
  float lse2[4], dd[4];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int t = q0 + 4 * tr + r;
    lse2[r] = t < Tq ? lse[(int64_t)bh * Tq + t] * LOG2E : INFINITY;
    dd[r] = t < Tq ? dvec[(int64_t)bh * Tq + t] : 0.f;
  }

  float acc[4][D / 16];
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int e = 0; e < D / 16; ++e) acc[r][e] = 0.f;

  for (int j = 0; j < n; ++j) {
    const int cur = j & 1;
    const int k0 = j * ROWS;
    if (j + 1 < n) {
      load_tile(j + 1, cur ^ 1);  // overlaps this tile's compute
      hopper::cp_async_wait<1>();
    } else {
      hopper::cp_async_wait<0>();
    }
    __syncthreads();
    const float* Kc = KV + 2 * cur * L::TILE;
    float* Vc = KV + (2 * cur + 1) * L::TILE;

    float s[4][4], dp[4][4];
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) s[r][c] = dp[r][c] = 0.f;
    scores<D>(s, Qs, Kc, tr, tc);
    scores<D>(dp, Os, Vc, tr, tc);

    const bool mask = k0 + ROWS > Tk || (causal && k0 + ROWS - 1 > q0 + offset);
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        float p = exp2f(s[r][c] - lse2[r]);
        if (mask) {
          const int key = k0 + tc + 16 * c;
          if (key >= Tk || (causal && key > q0 + 4 * tr + r + offset))
            p = 0.f;
        }
        dp[r][c] = p * (dp[r][c] - dd[r]);  // dS
      }
    __syncthreads();               // every read of this V stage is done
    store_transposed(Vc, dp, tr, tc);
    __syncthreads();
    product<D>(acc, Vc, Kc, tr, tc);
    __syncthreads();               // the stage is read before it refills
  }
  store_acc<D>(acc, dq + (int64_t)bh * Tq * D, q0 + 4 * tr, Tq, tc, scale);
}

template <int D>
__global__ void __launch_bounds__(THREADS, 1)
flash_bwd_dkv_f32_kernel(const float* __restrict__ q,
                         const float* __restrict__ k,
                         const float* __restrict__ v,
                         const float* __restrict__ dout,
                         const float* __restrict__ lse,
                         const float* __restrict__ dvec,
                         float* __restrict__ dk, float* __restrict__ dv,
                         int H, int Hkv, int Tq, int Tk,
                         int64_t q_sb, int64_t q_sh, int64_t q_st,
                         int64_t k_sb, int64_t k_sh, int64_t k_st,
                         int64_t v_sb, int64_t v_sh, int64_t v_st,
                         int64_t o_sb, int64_t o_sh, int64_t o_st,
                         float scale, int causal) {
  using L = Layout<D>;
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  float* Ks = smem;
  float* Vs = smem + L::TILE;
  float* QO = smem + 2 * L::TILE;  // stage st: Q at + 2st tiles, dO after
  float* Pt = smem + L::PT_OFF;    // P^T, then dS^T: [query][key]
  float* Stat = smem + L::STAT_OFF;  // stage st: lse * log2(e), then D

  const int tid = threadIdx.x;
  const int tr = tid / 16, tc = tid % 16;
  const int bkv = blockIdx.x;
  const int b = bkv / Hkv;
  const int hk = bkv % Hkv;
  const int G = H / Hkv;
  const int k0 = blockIdx.y * ROWS;  // y = 0 first: the longest causal blocks
  const int offset = Tk - Tq;
  const int qt_lo = causal ? max(k0 - offset, 0) / ROWS : 0;
  const int per = (Tq + ROWS - 1) / ROWS - qt_lo;
  const int n = G * per;

  // tile i: query rows of head hk * G + i / per; its lse and D are staged
  // beside the cp.async group by plain loads (visible after the same
  // __syncthreads); rows past Tq get lse = +inf, so their P is 0
  auto load_tile = [&](int i, int st) {
    const int h = hk * G + i / per;
    const int q0 = (qt_lo + i % per) * ROWS;
    load_rows<D>(QO + 2 * st * L::TILE, q + b * q_sb + h * q_sh, q_st, q0,
                 Tq);
    load_rows<D>(QO + (2 * st + 1) * L::TILE, dout + b * o_sb + h * o_sh,
                 o_st, q0, Tq);
    hopper::cp_async_commit();
    if (tid < 2 * ROWS) {
      const int t = q0 + tid % ROWS;
      const int64_t at = ((int64_t)b * H + h) * Tq + t;
      Stat[st * 2 * ROWS + tid] =
          tid < ROWS ? (t < Tq ? lse[at] * LOG2E : INFINITY)
                     : (t < Tq ? dvec[at] : 0.f);
    }
  };
  load_rows<D>(Ks, k + b * k_sb + hk * k_sh, k_st, k0, Tk);
  load_rows<D>(Vs, v + b * v_sb + hk * v_sh, v_st, k0, Tk);
  load_tile(0, 0);  // one group with K and V

  float dk_acc[4][D / 16], dv_acc[4][D / 16];
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int e = 0; e < D / 16; ++e) dk_acc[r][e] = dv_acc[r][e] = 0.f;
  const float c2 = scale * LOG2E;

  for (int i = 0; i < n; ++i) {
    const int cur = i & 1;
    const int q0 = (qt_lo + i % per) * ROWS;
    if (i + 1 < n) {
      load_tile(i + 1, cur ^ 1);
      hopper::cp_async_wait<1>();
    } else {
      hopper::cp_async_wait<0>();
    }
    __syncthreads();
    const float* Qc = QO + 2 * cur * L::TILE;
    const float* Oc = QO + (2 * cur + 1) * L::TILE;
    const float* st = Stat + cur * 2 * ROWS;

    // S^T and dP^T: rows = keys 4tr + r, columns = queries tc + 16c
    float s[4][4], dp[4][4];
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) s[r][c] = dp[r][c] = 0.f;
    scores<D>(s, Ks, Qc, tr, tc);
    scores<D>(dp, Vs, Oc, tr, tc);

    const bool mask = causal && q0 + offset < k0 + ROWS - 1;
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int col = tc + 16 * c;
      const float l2 = st[col], dcol = st[ROWS + col];
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        float p = exp2f(s[r][c] * c2 - l2);
        if (mask && k0 + 4 * tr + r > q0 + col + offset) p = 0.f;
        s[r][c] = p;
        dp[r][c] = p * (dp[r][c] - dcol);  // dS
      }
    }
    // dV += P^T dO, then dK += dS^T Q, through one transposed buffer
    store_transposed(Pt, s, tr, tc);
    __syncthreads();
    product<D>(dv_acc, Pt, Oc, tr, tc);
    __syncthreads();
    store_transposed(Pt, dp, tr, tc);
    __syncthreads();
    product<D>(dk_acc, Pt, Qc, tr, tc);
    __syncthreads();  // the buffer and the stage are read before refills
  }
  const int64_t row0 = (int64_t)bkv * Tk;
  store_acc<D>(dk_acc, dk + row0 * D, k0 + 4 * tr, Tk, tc, scale);
  store_acc<D>(dv_acc, dv + row0 * D, k0 + 4 * tr, Tk, tc, 1.f);
}

template <int D>
int launch(int which, const void* q, const void* k, const void* v,
           const void* dout, const float* lse, const float* dvec, void* dq,
           void* dk, void* dv, int B, int H, int Hkv, int Tq, int Tk,
           const int64_t qs[3], const int64_t ks[3], const int64_t vs[3],
           const int64_t os[3], float scale, int causal,
           cudaStream_t stream) {
  const float* qf = static_cast<const float*>(q);
  const float* kf = static_cast<const float*>(k);
  const float* vf = static_cast<const float*>(v);
  const float* of = static_cast<const float*>(dout);
  cudaError_t e;
  // byte strides -> element strides
  if (which == 0) {
    const int smem = Layout<D>::DQ_FLOATS * 4;
    e = cudaFuncSetAttribute(flash_bwd_dq_f32_kernel<D>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem);
    if (e != cudaSuccess) return (int)e;
    flash_bwd_dq_f32_kernel<D>
        <<<dim3(B * H, (Tq + ROWS - 1) / ROWS), THREADS, smem, stream>>>(
            qf, kf, vf, of, lse, dvec, static_cast<float*>(dq), H, H / Hkv,
            Tq, Tk, qs[0] / 4, qs[1] / 4, qs[2] / 4, ks[0] / 4, ks[1] / 4,
            ks[2] / 4, vs[0] / 4, vs[1] / 4, vs[2] / 4, os[0] / 4, os[1] / 4,
            os[2] / 4, scale, causal);
    return (int)cudaGetLastError();
  }
  const int smem = Layout<D>::DKV_FLOATS * 4;
  e = cudaFuncSetAttribute(flash_bwd_dkv_f32_kernel<D>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  flash_bwd_dkv_f32_kernel<D>
      <<<dim3(B * Hkv, (Tk + ROWS - 1) / ROWS), THREADS, smem, stream>>>(
          qf, kf, vf, of, lse, dvec, static_cast<float*>(dk),
          static_cast<float*>(dv), H, Hkv, Tq, Tk, qs[0] / 4, qs[1] / 4,
          qs[2] / 4, ks[0] / 4, ks[1] / 4, ks[2] / 4, vs[0] / 4, vs[1] / 4,
          vs[2] / 4, os[0] / 4, os[1] / 4, os[2] / 4, scale, causal);
  return (int)cudaGetLastError();
}

}  // namespace rt

bool aligned16(const void* p, const int64_t s[3]) {
  if (reinterpret_cast<uintptr_t>(p) % 16) return false;
  for (int i = 0; i < 3; ++i)
    if (s[i] <= 0 || s[i] % 16) return false;
  return true;
}

}  // namespace

extern "C" {

// which: 0 launches the dQ kernel (writes dq), 1 the dK/dV kernel (writes
// dk, dv), each on `stream`; the caller launches both and counts each.
// q/dout: (B, H, Tq, D), k/v: (B, Hkv, Tk, D), each with unit stride on D
// and the given BYTE strides for batch, head and sequence: positive
// multiples of 16, with 16-byte aligned bases (TMA and 16-byte cp.async
// read them in place; the wrapper copies a tensor that fails). lse/dvec:
// contiguous (B, H, Tq) f32. dq: contiguous (B, H, Tq, D), dk/dv:
// contiguous (B, Hkv, Tk, D), all of the input type. dtype: 0 float32,
// 1 bfloat16. D: 64 or 128. Returns a cudaError_t.
int mxtt_flash_attention_bwd(int which, const void* q, const void* k,
                             const void* v, const void* dout,
                             const float* lse, const float* dvec, void* dq,
                             void* dk, void* dv, int dtype, int B, int H,
                             int Hkv, int Tq, int Tk, int D, int64_t q_sb,
                             int64_t q_sh, int64_t q_st, int64_t k_sb,
                             int64_t k_sh, int64_t k_st, int64_t v_sb,
                             int64_t v_sh, int64_t v_st, int64_t o_sb,
                             int64_t o_sh, int64_t o_st, float scale,
                             int causal, void* stream) {
  const int64_t qs[3] = {q_sb, q_sh, q_st};
  const int64_t ks[3] = {k_sb, k_sh, k_st};
  const int64_t vs[3] = {v_sb, v_sh, v_st};
  const int64_t os[3] = {o_sb, o_sh, o_st};
  if ((which != 0 && which != 1) || B < 1 || H < 1 || Hkv < 1 || H % Hkv ||
      Tq < 1 || Tk < 1 || (Tq + 63) / 64 > 65535 || (Tk + 63) / 64 > 65535 ||
      !aligned16(q, qs) || !aligned16(k, ks) || !aligned16(v, vs) ||
      !aligned16(dout, os))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define MXTT_FA_BWD_LAUNCH(NS, DD)                                          \
  return NS::launch<DD>(which, q, k, v, dout, lse, dvec, dq, dk, dv, B, H, \
                        Hkv, Tq, Tk, qs, ks, vs, os, scale, causal, s)
  if (dtype == 0 && D == 64) MXTT_FA_BWD_LAUNCH(rt, 64);
  if (dtype == 0 && D == 128) MXTT_FA_BWD_LAUNCH(rt, 128);
  if (dtype == 1 && D == 64) MXTT_FA_BWD_LAUNCH(wg, 64);
  if (dtype == 1 && D == 128) MXTT_FA_BWD_LAUNCH(wg, 128);
#undef MXTT_FA_BWD_LAUNCH
  return (int)cudaErrorInvalidValue;
}

// Dynamic shared memory (bytes) one block of kernel `which` (0 dQ, 1 dK/dV)
// of the (dtype, D) instantiation asks for, or -1.
int mxtt_flash_attention_bwd_smem(int which, int dtype, int D) {
  if (which != 0 && which != 1) return -1;
  if (dtype == 0 && D == 64)
    return 4 * (which ? rt::Layout<64>::DKV_FLOATS : rt::Layout<64>::DQ_FLOATS);
  if (dtype == 0 && D == 128)
    return 4 * (which ? rt::Layout<128>::DKV_FLOATS
                      : rt::Layout<128>::DQ_FLOATS);
  if (dtype == 1 && D == 64) return wg::Layout<64>::BYTES;
  if (dtype == 1 && D == 128) return wg::Layout<128>::BYTES;
  return -1;
}

}  // extern "C"
