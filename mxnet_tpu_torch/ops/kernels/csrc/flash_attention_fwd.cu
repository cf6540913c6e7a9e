// Flash-attention forward for Hopper (sm_90a), plain C interface for ctypes.
//
// Replaces: mxnet_tpu/ops/pallas/flash_attention.py `_fa_forward` (:259) and
// its Pallas kernels `_fa_kernel_res` (:90) and `_fa_kernel_stream` (:152).
// Semantics follow `flash_attention()` (:881): O = softmax(scale * Q K^T) V
// with an optional causal mask aligned at tk - tq, grouped-query heads read
// by index (q head h uses kv head h / (H / Hkv)), online softmax with an f32
// running max and sum, f32 accumulation, optional per-row logsumexp (f32,
// natural log: the backward kernels read it as exp(scale * q.k - lse)).
//
// What bounds it on the card: at the serving path's largest prefill
// (B 1, H 16, Hkv 4, T = 2048, D = 128, causal) one call does 17.2 GFLOP
// against 42 MB (f32) of q/k/v/o. In bf16 that is 17.4 us on the tensor
// cores (989 TFLOP/s) against 6 us of bytes; in f32 it is 257 us on the FMA
// units (67 TFLOP/s): both are bound by operations. The port's f32 is full
// f32 (the train phase holds parameters to 1e-5 against the CPU), so f32
// takes no tensor cores: TF32 keeps about three digits.
//
// Two designs, one per type, because the card gives the types different
// units.
//
// bf16 (flash_fwd_wgmma_kernel): a block owns 128 query rows of one
// (batch, head), as two warpgroups of 64 rows (256 threads). Thread 0 loads
// Q once and streams 128-key K and V tiles through a 2-stage ring with TMA:
// 4-D tensor maps over (D, T, H, B) with the tensors' byte strides, built
// per call on the host, 128-byte swizzle, so a D = 128 row is two 64-wide
// boxes. Each stage has a full barrier for K and one for V, and an empty
// barrier for each that the 8 warps arrive on once wgmma.wait_group shows
// their products reading it are done; thread 0 refills K_{j+2} and V_{j+1}
// behind them, a tile ahead of use. Per tile j a warpgroup issues
// S_j = Q K_j^T (wgmma m64n128k16, both operands K-major in shared memory)
// and O += P_{j-1} V_{j-1}, waits for S_j only, and runs the online softmax
// on the S accumulator in registers (scale * log2(e) folded into one
// multiply, ex2, row max and sum over the 4 threads of a row by shuffles;
// the mask only on tiles that cross Tk or a diagonal) while the P V product
// is still on the tensor cores. P enters P V from registers (the RS form of
// wgmma) and V is read MN-major through the transpose bit, so V is never
// transposed in memory. P goes in as two bf16 parts, hi = bf16(p) and
// lo = bf16(p - hi): the TPU kernel and the plain version keep P in f32,
// and a single bf16 P is off by up to 2^-8 of each weight, which on short
// causal rows exceeds the 2e-3 + 2e-2 gate against the plain version
// (mxnet_tpu_torch/tools/flash_p_spread.py repeats this arithmetic on the
// CPU: 1.07x the gate at T = 2048, 0.21-0.31x with the split); the split
// costs a second P V product, 1.5x the tensor work of one bf16 P.
// No producer warp: a third warpgroup (or a ninth warp) puts 3 warps on an
// SM sub-partition, which caps a thread at 168 registers; this kernel needs
// ~220 (S 64, P 64, O 64 f32 registers), and ptxas kept the 168 cap for the
// consumers after setmaxnreg, spilling and serializing every wgmma. With
// 8 warps the cap is 255. Tile 0 is peeled off the loop so that every wait
// in it is unconditional: ptxas serializes all wgmmas of a kernel when a
// conditional wait leaves it unsure whether a group is in flight.
// Tiles right of the diagonal are never loaded. Blocks launch with the
// (batch, head) on grid x and the q-tile on y, reversed, so every head's
// longest causal tiles start first and the short ones fill the tail of the
// 132 SMs. The G query heads of a GQA group are separate blocks: K and V of
// one kv head are 1 MB (bf16) at T = 2048 and stay in the 50 MB L2 between
// them. 160 KB of shared memory at D = 128 (Q 32 KB, two stages of K and V
// at 32 KB each), 80 KB at D = 64.
//
// f32 (flash_fwd_f32_kernel): a block owns 128 query rows, 256 threads, and
// streams 64-key tiles. Each thread holds an 8 x 4 register tile of S and
// an 8 x 8 (D = 128) or 8 x 4 tile of O, and reads its operands from shared
// memory as float4: per 4 dims 8 Q and 4 K loads feed 128 FMAs (10.7 per
// load), per key 2 P and 2 V loads feed 64 (16 per load). K and V tiles are
// double-buffered with 16-byte cp.async, so tile j + 1 loads while tile j
// computes. 16-byte cp.async moves 4 consecutive dims of one key, so the K
// tile keeps K's row order (not transposed): its rows are padded to D + 4
// floats, and a thread's 4 keys are 16 apart, so the 8 lanes of one float4
// load phase read 8 keys in distinct banks. Q is pre-scaled by
// scale * log2(e) in f32 and read as broadcasts; P is written key-major over
// the K stage it was computed from. 194 KB of shared memory at D = 128.
// The grid runs the longest causal tiles first, as in the bf16 kernel.
//
// Ragged Tq/Tk tails are masked in both kernels, so every length runs. The
// TPU kernel's resident/streaming split is a VMEM artifact and has no
// counterpart here: nothing in shared memory scales with the sequence.

#include "hopper.cuh"

#include <math.h>

namespace {

constexpr float LN2 = 0.69314718055994530942f;
constexpr float LOG2E = 1.44269504088896340736f;

// --- bf16: wgmma + TMA ----------------------------------------------------------
namespace wg {

constexpr int BQ = 128;        // query rows per block (two warpgroups)
constexpr int BK = 128;        // keys per ring stage
constexpr int STAGES = 2;
constexpr int THREADS = 256;   // two warpgroups of 64 query rows each
constexpr int BOX = 64;        // bf16 columns of one 128-byte swizzled box
constexpr int ROW_BYTES = 128;

template <int D>
struct Layout {
  static constexpr int BOXES = D / BOX;
  static constexpr int Q_BYTES = BQ * D * 2;
  static constexpr int KV_BYTES = BK * D * 2;      // one K or V tile
  static constexpr int K_OFF = Q_BYTES;            // K stage s at + s * KV_BYTES
  static constexpr int V_OFF = K_OFF + STAGES * KV_BYTES;
  static constexpr int BAR_OFF = V_OFF + STAGES * KV_BYTES;
  // 9 barriers, and slack to round the dynamic base up to 1024 bytes
  static constexpr int BYTES = BAR_OFF + 9 * 8 + 1024;
};

// The online-softmax step of one tile on the S accumulator of m64n128k16:
// scales S into the exp2 domain, masks keys >= Tk and (causal) keys right
// of each row's diagonal when `mask`, updates the running max m and sum l
// of the thread's two rows, returns their rescale factors in a0 / a1, and
// leaves P = exp2(S - m) in s.
__device__ __forceinline__ void softmax_tile(float (&s)[BK / 2], int k0,
                                             bool mask, int Tk, int causal,
                                             int qpos0, int cq,
                                             float scale_log2, float& m0,
                                             float& m1, float& l0, float& l1,
                                             float& a0, float& a1) {
#pragma unroll
  for (int i = 0; i < BK / 2; ++i) {
    s[i] *= scale_log2;
    if (mask) {
      const int key = k0 + 8 * (i / 4) + cq + (i % 2);
      const int qpos = qpos0 + ((i & 2) ? 8 : 0);
      if (key >= Tk || (causal && key > qpos)) s[i] = -INFINITY;
    }
  }
  float mx0 = m0, mx1 = m1;
#pragma unroll
  for (int i = 0; i < BK / 2; ++i) {
    if (i & 2) mx1 = fmaxf(mx1, s[i]);
    else mx0 = fmaxf(mx0, s[i]);
  }
#pragma unroll
  for (int w = 1; w < 4; w <<= 1) {  // the 4 threads of a row
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, w));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, w));
  }
  // a row with no visible key yet keeps 0 weights, not NaN
  const float mu0 = mx0 == -INFINITY ? 0.f : mx0;
  const float mu1 = mx1 == -INFINITY ? 0.f : mx1;
  a0 = hopper::ex2(m0 - mu0);
  a1 = hopper::ex2(m1 - mu1);
  m0 = mx0;
  m1 = mx1;
  float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
  for (int i = 0; i < BK / 2; ++i) {
    if (i & 2) {
      s[i] = hopper::ex2(s[i] - mu1);
      sum1 += s[i];
    } else {
      s[i] = hopper::ex2(s[i] - mu0);
      sum0 += s[i];
    }
  }
#pragma unroll
  for (int w = 1; w < 4; w <<= 1) {
    sum0 += __shfl_xor_sync(0xffffffffu, sum0, w);
    sum1 += __shfl_xor_sync(0xffffffffu, sum1, w);
  }
  l0 = l0 * a0 + sum0;
  l1 = l1 * a1 + sum1;
}

// S = Q K^T for one consumer warpgroup: the depth D in steps of 16
// (32 bytes inside a 128-byte box); issued, not waited for
template <int D>
__device__ __forceinline__ void issue_qk(float (&s)[BK / 2], uint32_t q_rows,
                                         uint32_t k_tile) {
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const uint32_t q_at = (kk / 4) * BQ * ROW_BYTES + (kk % 4) * 32;
    const uint32_t k_at = (kk / 4) * BK * ROW_BYTES + (kk % 4) * 32;
    hopper::wgmma_ss_m64n128k16(
        s, hopper::make_desc_sw128(q_rows + q_at, 16, 1024),
        hopper::make_desc_sw128(k_tile + k_at, 16, 1024), kk > 0);
  }
}

// O += P V: 16 keys per product, hi then lo; V MN-major, its D boxes
// BK * 128 bytes (LBO) apart; issued, not waited for
template <int D>
__device__ __forceinline__ void issue_pv(float (&o)[D / 2],
                                         const uint32_t (&hi)[BK / 16][4],
                                         const uint32_t (&lo)[BK / 16][4],
                                         uint32_t v_tile) {
#pragma unroll
  for (int kc = 0; kc < BK / 16; ++kc) {
    const uint64_t dv = hopper::make_desc_sw128(v_tile + kc * 16 * ROW_BYTES,
                                                BK * ROW_BYTES, 1024);
    if constexpr (D == 128) {
      hopper::wgmma_rs_m64n128k16_tb(o, hi[kc], dv);
      hopper::wgmma_rs_m64n128k16_tb(o, lo[kc], dv);
    } else {
      hopper::wgmma_rs_m64n64k16_tb(o, hi[kc], dv);
      hopper::wgmma_rs_m64n64k16_tb(o, lo[kc], dv);
    }
  }
}

template <int D>
__global__ void __launch_bounds__(THREADS, 1)
flash_fwd_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                       const __grid_constant__ CUtensorMap tk,
                       const __grid_constant__ CUtensorMap tv,
                       __nv_bfloat16* __restrict__ o, float* __restrict__ lse,
                       int H, int G, int Tq, int Tk, float scale_log2,
                       int causal) {
  using namespace hopper;
  using L = Layout<D>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t sQ = base, sK = base + L::K_OFF, sV = base + L::V_OFF;
  // barriers, 8 bytes each: Q full; per stage K full, V full, K empty and
  // V empty (K is released once S is done, V once P.V is)
  const uint32_t bar_q = base + L::BAR_OFF;
  const uint32_t bar_k = bar_q + 8;        // + 8 * stage
  const uint32_t bar_v = bar_q + 24;
  const uint32_t bar_ek = bar_q + 40;
  const uint32_t bar_ev = bar_q + 56;

  const int bh = blockIdx.x;
  const int b = bh / H;
  const int h = bh % H;
  const int hk = h / G;
  // blocks launch x-fastest: every head's longest causal tile goes first
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ;
  const int offset = Tk - Tq;
  int n_tiles = (Tk + BK - 1) / BK;
  if (causal)  // tiles right of the block's last diagonal are never loaded
    n_tiles = min(n_tiles, (min(q0 + BQ, Tq) - 1 + offset) / BK + 1);

  if (threadIdx.x == 0) {
    mbar_init(bar_q, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(bar_k + 8 * s, 1);
      mbar_init(bar_v + 8 * s, 1);
      mbar_init(bar_ek + 8 * s, 8);  // one arrival per warp
      mbar_init(bar_ev + 8 * s, 8);
    }
    mbar_fence_init();
  }
  __syncthreads();

  // Thread 0 issues every load: Q and the first two tiles here, and in the
  // loop K_{j+2} once both groups have read K_j, and V_{j+1} once both have
  // finished P_{j-1} V_{j-1} (one tile of lead for each)
  auto load_k = [&](int j) {
    const int s = j % STAGES;
    mbar_expect_tx(bar_k + 8 * s, L::KV_BYTES);
    for (int x = 0; x < L::BOXES; ++x)
      tma_load_4d(sK + s * L::KV_BYTES + x * BK * ROW_BYTES, &tk,
                  bar_k + 8 * s, x * BOX, j * BK, hk, b);
  };
  auto load_v = [&](int j) {
    const int s = j % STAGES;
    mbar_expect_tx(bar_v + 8 * s, L::KV_BYTES);
    for (int x = 0; x < L::BOXES; ++x)
      tma_load_4d(sV + s * L::KV_BYTES + x * BK * ROW_BYTES, &tv,
                  bar_v + 8 * s, x * BOX, j * BK, hk, b);
  };
  if (threadIdx.x == 0) {
    mbar_expect_tx(bar_q, L::Q_BYTES);
    for (int x = 0; x < L::BOXES; ++x)
      tma_load_4d(sQ + x * BQ * ROW_BYTES, &tq, bar_q, x * BOX, q0, h, b);
    for (int j = 0; j < min(n_tiles, STAGES); ++j) {
      load_k(j);
      load_v(j);
    }
  }

  // warpgroup c owns block rows 64c .. 64c + 63. Per tile j it issues
  // S_j = Q K_j^T and then O += P_{j-1} V_{j-1}, runs the softmax of S_j
  // while P_{j-1} V_{j-1} is still on the tensor cores, and only then
  // rescales O and turns P_j into A fragments.
  const int c = threadIdx.x / 128;
  const int t = threadIdx.x % 128;
  const int lane = t % 32;
  const int row0 = 64 * c + 16 * (t / 32) + lane / 4;  // and row0 + 8
  const int qpos0 = q0 + row0 + offset;                // on the key axis
  const int cq = 2 * (lane % 4);
  const int first_qpos = q0 + 64 * c + offset;        // the group's least
  const uint32_t q_rows = sQ + 64 * c * ROW_BYTES;

  float oacc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) oacc[i] = 0.f;
  float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f, a0, a1;
  float sacc[BK / 2];
  uint32_t phi[BK / 16][4], plo[BK / 16][4];

  // thread 0's loads after tile j: K_{j+2} once both groups read K_j, and
  // V_{j+1} once both finished P_{j-1} V_{j-1} (V_0 and V_1 came first)
  auto refill = [&](int j) {
    if (threadIdx.x != 0) return;
    if (j + 2 < n_tiles) {
      mbar_wait(bar_ek + 8 * (j % STAGES), (j / STAGES) & 1);
      load_k(j + 2);
    }
    if (j > 0 && j + 1 < n_tiles) {
      mbar_wait(bar_ev + 8 * ((j - 1) % STAGES), ((j - 1) / STAGES) & 1);
      load_v(j + 1);
    }
  };
  // the mask only where a tile crosses Tk or a row's diagonal in this group
  auto needs_mask = [&](int k0) {
    return k0 + BK > Tk || (causal && k0 + BK - 1 > first_qpos);
  };

  // Tile 0 is peeled off so that the loop body waits for its wgmma groups
  // unconditionally: ptxas serializes every wgmma of a kernel once a
  // conditional wait leaves it unsure whether a group is still in flight.
  mbar_wait(bar_q, 0);
  mbar_wait(bar_k, 0);
  fence_all(sacc);
  wgmma_fence();
  issue_qk<D>(sacc, q_rows, sK);
  wgmma_commit();
  wgmma_wait<0>();
  fence_all(sacc);
  if (lane == 0) mbar_arrive(bar_ek);
  softmax_tile(sacc, 0, needs_mask(0), Tk, causal, qpos0, cq, scale_log2, m0,
               m1, l0, l1, a0, a1);
  split_fragments(sacc, phi, plo);
  refill(0);

  for (int j = 1; j < n_tiles; ++j) {
    const int s = j % STAGES, sp = (j - 1) % STAGES;  // tile j - 1's stage
    mbar_wait(bar_k + 8 * s, (j / STAGES) & 1);
    mbar_wait(bar_v + 8 * sp, ((j - 1) / STAGES) & 1);
    // every register a wgmma owns is fenced before its batch is issued and
    // after it is committed, so no other instruction touches it in flight
    fence_all(sacc);
    wgmma_fence();
    issue_qk<D>(sacc, q_rows, sK + s * L::KV_BYTES);
    wgmma_commit();
    fence_all(sacc);
    fence_all(oacc);
    fence_all(phi);
    fence_all(plo);
    wgmma_fence();
    issue_pv<D>(oacc, phi, plo, sV + sp * L::KV_BYTES);
    wgmma_commit();
    fence_all(oacc);
    fence_all(phi);
    fence_all(plo);
    wgmma_wait<1>();  // S_j is done; P_{j-1} V_{j-1} runs on under softmax
    fence_all(sacc);
    if (lane == 0) mbar_arrive(bar_ek + 8 * s);  // this warp read K_j
    softmax_tile(sacc, j * BK, needs_mask(j * BK), Tk, causal, qpos0, cq,
                 scale_log2, m0, m1, l0, l1, a0, a1);
    wgmma_wait<0>();
    fence_all(oacc);
    fence_all(phi);
    fence_all(plo);
    if (lane == 0) mbar_arrive(bar_ev + 8 * sp);  // and V_{j-1}
#pragma unroll
    for (int i = 0; i < D / 2; ++i) oacc[i] *= (i & 2) ? a1 : a0;
    split_fragments(sacc, phi, plo);
    refill(j);
  }
  {
    const int s = (n_tiles - 1) % STAGES;
    mbar_wait(bar_v + 8 * s, ((n_tiles - 1) / STAGES) & 1);
    fence_all(oacc);
    fence_all(phi);
    fence_all(plo);
    wgmma_fence();
    issue_pv<D>(oacc, phi, plo, sV + s * L::KV_BYTES);
    wgmma_commit();
    wgmma_wait<0>();
    fence_all(oacc);
    fence_all(phi);
    fence_all(plo);
  }

  // epilogue: O / l in bf16 through o's rows, lse = ln2 * (m + log2 l)
  const int t0 = q0 + row0, t1 = t0 + 8;
  const float inv0 = 1.f / l0, inv1 = 1.f / l1;
  __nv_bfloat16* o0 = o + ((int64_t)bh * Tq + t0) * D + cq;
  __nv_bfloat16* o1 = o0 + 8 * D;
#pragma unroll
  for (int g = 0; g < D / 8; ++g) {
    if (t0 < Tq)
      *reinterpret_cast<__nv_bfloat162*>(o0 + 8 * g) =
          __floats2bfloat162_rn(oacc[4 * g] * inv0, oacc[4 * g + 1] * inv0);
    if (t1 < Tq)
      *reinterpret_cast<__nv_bfloat162*>(o1 + 8 * g) = __floats2bfloat162_rn(
          oacc[4 * g + 2] * inv1, oacc[4 * g + 3] * inv1);
  }
  if (lse != nullptr && lane % 4 == 0) {
    if (t0 < Tq) lse[(int64_t)bh * Tq + t0] = (m0 + log2f(l0)) * LN2;
    if (t1 < Tq) lse[(int64_t)bh * Tq + t1] = (m1 + log2f(l1)) * LN2;
  }
}

template <int D>
int launch(const void* q, const void* k, const void* v, void* o, float* lse,
           int B, int H, int Hkv, int Tq, int Tk, const int64_t qs[3],
           const int64_t ks[3], const int64_t vs[3], float scale, int causal,
           cudaStream_t stream) {
  // maps over (D, T, H, B); strides are those of T, H, B in bytes
  CUtensorMap mq, mk, mv;
  const uint64_t dq[4] = {(uint64_t)D, (uint64_t)Tq, (uint64_t)H,
                          (uint64_t)B};
  const uint64_t dk[4] = {(uint64_t)D, (uint64_t)Tk, (uint64_t)Hkv,
                          (uint64_t)B};
  const uint64_t sq[3] = {(uint64_t)qs[2], (uint64_t)qs[1], (uint64_t)qs[0]};
  const uint64_t sk[3] = {(uint64_t)ks[2], (uint64_t)ks[1], (uint64_t)ks[0]};
  const uint64_t sv[3] = {(uint64_t)vs[2], (uint64_t)vs[1], (uint64_t)vs[0]};
  int err = hopper::encode_bf16_4d(&mq, q, dq, sq, BQ);
  if (err == 0) err = hopper::encode_bf16_4d(&mk, k, dk, sk, BK);
  if (err == 0) err = hopper::encode_bf16_4d(&mv, v, dk, sv, BK);
  if (err != 0) return err;
  const int smem = Layout<D>::BYTES;
  cudaError_t e = cudaFuncSetAttribute(
      flash_fwd_wgmma_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid(B * H, (Tq + BQ - 1) / BQ);
  flash_fwd_wgmma_kernel<D><<<grid, THREADS, smem, stream>>>(
      mq, mk, mv, static_cast<__nv_bfloat16*>(o), lse, H, H / Hkv, Tq, Tk,
      scale * LOG2E, causal);
  return (int)cudaGetLastError();
}

}  // namespace wg

// --- f32: register tiles + cp.async ----------------------------------------------
namespace rt {

constexpr int BQ = 128;        // query rows per block
constexpr int BK = 64;         // keys per tile
constexpr int THREADS = 256;   // 16 x 16: thread (tr, tc) = (t / 16, t % 16)

template <int D>
struct Layout {
  static constexpr int KLD = D + 4;   // K row stride: 8 keys in 8 bank groups
  static constexpr int PLD = BQ + 4;  // P^T row stride (one row per key)
  static constexpr int STAGE =        // a K stage, later that tile's P^T
      BK * KLD > BK * PLD ? BK * KLD : BK * PLD;
  static constexpr int Q_FLOATS = BQ * D;
  static constexpr int K_OFF = Q_FLOATS;
  static constexpr int V_OFF = K_OFF + 2 * STAGE;
  static constexpr int FLOATS = V_OFF + 2 * BK * D;
  static constexpr int BYTES = FLOATS * 4;
};

// row r (0..7) of thread row-group tr: 4tr + r, then 64 + 4tr + r - 4
__device__ __forceinline__ int row_of(int tr, int r) {
  return (r < 4 ? 0 : 64 - 4) + 4 * tr + r;
}

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

template <int D>
__global__ void __launch_bounds__(THREADS, 1)
flash_fwd_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, float* __restrict__ o,
                     float* __restrict__ lse, int H, int G, int Tq, int Tk,
                     int64_t q_sb, int64_t q_sh, int64_t q_st,
                     int64_t k_sb, int64_t k_sh, int64_t k_st,
                     int64_t v_sb, int64_t v_sh, int64_t v_st,
                     float scale_log2, int causal) {
  using L = Layout<D>;
  constexpr int C4 = D / 4;         // 16-byte chunks in a row
  constexpr int OG = D / 64;        // float4 column groups of O per thread
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  float* Qs = smem;                 // BQ x D, pre-scaled
  float* Ks = smem + L::K_OFF;      // 2 stages of BK x KLD
  float* Vs = smem + L::V_OFF;      // 2 stages of BK x D

  const int tid = threadIdx.x;
  const int tr = tid / 16, tc = tid % 16;
  const int bh = blockIdx.x;
  const int b = bh / H;
  const int h = bh % H;
  const int hk = h / G;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ;  // longest tiles first
  const int offset = Tk - Tq;
  int n_tiles = (Tk + BK - 1) / BK;
  if (causal)
    n_tiles = min(n_tiles, (min(q0 + BQ, Tq) - 1 + offset) / BK + 1);

  const float* qp = q + b * q_sb + h * q_sh;
  const float* kp = k + b * k_sb + hk * k_sh;
  const float* vp = v + b * v_sb + hk * v_sh;

  auto load_tile = [&](int j, int st) {
    const int k0 = j * BK;
    float* kd = Ks + st * L::STAGE;
    float* vd = Vs + st * BK * D;
    for (int i = tid; i < BK * C4; i += THREADS) {
      const int r = i / C4, cc = (i % C4) * 4;
      const bool ok = k0 + r < Tk;  // rows past Tk are zeros
      const int64_t t = ok ? k0 + r : 0;
      hopper::cp_async16(kd + r * L::KLD + cc, kp + t * k_st + cc, ok);
      hopper::cp_async16(vd + r * D + cc, vp + t * v_st + cc, ok);
    }
    hopper::cp_async_commit();
  };

  load_tile(0, 0);
  for (int i = tid; i < BQ * C4; i += THREADS) {
    const int r = i / C4, cc = (i % C4) * 4;
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (q0 + r < Tq) x = ld4(qp + (int64_t)(q0 + r) * q_st + cc);
    x.x *= scale_log2;
    x.y *= scale_log2;
    x.z *= scale_log2;
    x.w *= scale_log2;
    *reinterpret_cast<float4*>(Qs + r * D + cc) = x;
  }

  float oacc[8][4 * OG];
#pragma unroll
  for (int r = 0; r < 8; ++r)
#pragma unroll
    for (int e = 0; e < 4 * OG; ++e) oacc[r][e] = 0.f;
  float m[8], l[8];
#pragma unroll
  for (int r = 0; r < 8; ++r) {
    m[r] = -INFINITY;
    l[r] = 0.f;
  }

  for (int j = 0; j < n_tiles; ++j) {
    const int cur = j & 1;
    const int k0 = j * BK;
    if (j + 1 < n_tiles) {
      load_tile(j + 1, cur ^ 1);     // overlaps this tile's compute
      hopper::cp_async_wait<1>();
    } else {
      hopper::cp_async_wait<0>();
    }
    __syncthreads();
    float* Kc = Ks + cur * L::STAGE;

    // S (8 rows x keys tc, tc + 16, tc + 32, tc + 48) over D, 4 dims a step
    float s[8][4];
#pragma unroll
    for (int r = 0; r < 8; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) s[r][c] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; d += 4) {
      float4 kf[4];
#pragma unroll
      for (int c = 0; c < 4; ++c) kf[c] = ld4(Kc + (tc + 16 * c) * L::KLD + d);
#pragma unroll
      for (int r = 0; r < 8; ++r) {
        const float4 qf = ld4(Qs + row_of(tr, r) * D + d);
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          s[r][c] = fmaf(qf.x, kf[c].x, s[r][c]);
          s[r][c] = fmaf(qf.y, kf[c].y, s[r][c]);
          s[r][c] = fmaf(qf.z, kf[c].z, s[r][c]);
          s[r][c] = fmaf(qf.w, kf[c].w, s[r][c]);
        }
      }
    }

    // online softmax in the exp2 domain; rows are shared by the 16 lanes
    // of a half-warp
    const bool mask = k0 + BK > Tk || (causal && k0 + BK - 1 > q0 + offset);
    float alpha[8];
#pragma unroll
    for (int r = 0; r < 8; ++r) {
      const int qpos = q0 + row_of(tr, r) + offset;
      float mx = -INFINITY;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        if (mask) {
          const int key = k0 + tc + 16 * c;
          if (key >= Tk || (causal && key > qpos)) s[r][c] = -INFINITY;
        }
        mx = fmaxf(mx, s[r][c]);
      }
#pragma unroll
      for (int w = 1; w < 16; w <<= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, w));
      const float mn = fmaxf(m[r], mx);
      const float mu = mn == -INFINITY ? 0.f : mn;
      alpha[r] = exp2f(m[r] - mu);
      m[r] = mn;
      float sum = 0.f;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        s[r][c] = exp2f(s[r][c] - mu);
        sum += s[r][c];
      }
#pragma unroll
      for (int w = 1; w < 16; w <<= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, w);
      l[r] = l[r] * alpha[r] + sum;
    }

    __syncthreads();                   // every read of this K stage is done
    float* Pt = Kc;                    // P^T: row = key, column = query row
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      float* prow = Pt + (tc + 16 * c) * L::PLD + 4 * tr;
      *reinterpret_cast<float4*>(prow) =
          make_float4(s[0][c], s[1][c], s[2][c], s[3][c]);
      *reinterpret_cast<float4*>(prow + 64) =
          make_float4(s[4][c], s[5][c], s[6][c], s[7][c]);
    }
#pragma unroll
    for (int r = 0; r < 8; ++r)
#pragma unroll
      for (int e = 0; e < 4 * OG; ++e) oacc[r][e] *= alpha[r];
    __syncthreads();

    // O (8 rows x columns 4tc + 64g .. + 3) += P V over the tile's keys
    const float* Vc = Vs + cur * BK * D;
#pragma unroll 4
    for (int kk = 0; kk < BK; ++kk) {
      const float4 p0 = ld4(Pt + kk * L::PLD + 4 * tr);
      const float4 p1 = ld4(Pt + kk * L::PLD + 64 + 4 * tr);
      const float pr[8] = {p0.x, p0.y, p0.z, p0.w, p1.x, p1.y, p1.z, p1.w};
#pragma unroll
      for (int g = 0; g < OG; ++g) {
        const float4 vf = ld4(Vc + kk * D + 64 * g + 4 * tc);
#pragma unroll
        for (int r = 0; r < 8; ++r) {
          oacc[r][4 * g + 0] = fmaf(pr[r], vf.x, oacc[r][4 * g + 0]);
          oacc[r][4 * g + 1] = fmaf(pr[r], vf.y, oacc[r][4 * g + 1]);
          oacc[r][4 * g + 2] = fmaf(pr[r], vf.z, oacc[r][4 * g + 2]);
          oacc[r][4 * g + 3] = fmaf(pr[r], vf.w, oacc[r][4 * g + 3]);
        }
      }
    }
    __syncthreads();   // P and V of this stage are read before it refills
  }

#pragma unroll
  for (int r = 0; r < 8; ++r) {
    const int t = q0 + row_of(tr, r);
    if (t < Tq) {
      const float inv = 1.f / l[r];
      float* orow = o + ((int64_t)bh * Tq + t) * D + 4 * tc;
#pragma unroll
      for (int g = 0; g < OG; ++g)
        *reinterpret_cast<float4*>(orow + 64 * g) = make_float4(
            oacc[r][4 * g] * inv, oacc[r][4 * g + 1] * inv,
            oacc[r][4 * g + 2] * inv, oacc[r][4 * g + 3] * inv);
      if (lse != nullptr && tc == 0)
        lse[(int64_t)bh * Tq + t] = (m[r] + log2f(l[r])) * LN2;
    }
  }
}

template <int D>
int launch(const void* q, const void* k, const void* v, void* o, float* lse,
           int B, int H, int Hkv, int Tq, int Tk, const int64_t qs[3],
           const int64_t ks[3], const int64_t vs[3], float scale, int causal,
           cudaStream_t stream) {
  const int smem = Layout<D>::BYTES;
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_f32_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(B * H, (Tq + BQ - 1) / BQ);
  // byte strides -> element strides
  flash_fwd_f32_kernel<D><<<grid, THREADS, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), lse, H, H / Hkv,
      Tq, Tk, qs[0] / 4, qs[1] / 4, qs[2] / 4, ks[0] / 4, ks[1] / 4,
      ks[2] / 4, vs[0] / 4, vs[1] / 4, vs[2] / 4, scale * LOG2E, causal);
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

// q: (B, H, Tq, D), k/v: (B, Hkv, Tk, D), each with unit stride on D and the
// given BYTE strides for batch, head and sequence: positive multiples of 16,
// with 16-byte aligned bases (TMA and 16-byte cp.async read them in place;
// the wrapper copies a tensor that fails). o: contiguous (B, H, Tq, D) of
// the input type; lse: contiguous (B, H, Tq) f32 or null. dtype: 0 float32,
// 1 bfloat16. D: 64 or 128. Returns a cudaError_t.
int mxtt_flash_attention_fwd(const void* q, const void* k, const void* v,
                             void* o, float* lse, int dtype, int B, int H,
                             int Hkv, int Tq, int Tk, int D,
                             int64_t q_sb, int64_t q_sh, int64_t q_st,
                             int64_t k_sb, int64_t k_sh, int64_t k_st,
                             int64_t v_sb, int64_t v_sh, int64_t v_st,
                             float scale, int causal, void* stream) {
  const int64_t qs[3] = {q_sb, q_sh, q_st};
  const int64_t ks[3] = {k_sb, k_sh, k_st};
  const int64_t vs[3] = {v_sb, v_sh, v_st};
  if (B < 1 || H < 1 || Hkv < 1 || H % Hkv || Tq < 1 || Tk < 1 ||
      (Tq + 127) / 128 > 65535 || !aligned16(q, qs) || !aligned16(k, ks) ||
      !aligned16(v, vs))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define MXTT_FA_LAUNCH(NS, DD)                                              \
  return NS::launch<DD>(q, k, v, o, lse, B, H, Hkv, Tq, Tk, qs, ks, vs,     \
                        scale, causal, s)
  if (dtype == 0 && D == 64) MXTT_FA_LAUNCH(rt, 64);
  if (dtype == 0 && D == 128) MXTT_FA_LAUNCH(rt, 128);
  if (dtype == 1 && D == 64) MXTT_FA_LAUNCH(wg, 64);
  if (dtype == 1 && D == 128) MXTT_FA_LAUNCH(wg, 128);
#undef MXTT_FA_LAUNCH
  return (int)cudaErrorInvalidValue;
}

// Dynamic shared memory (bytes) one block of the (dtype, D) instantiation
// asks for, or -1.
int mxtt_flash_attention_fwd_smem(int dtype, int D) {
  if (dtype == 0 && D == 64) return rt::Layout<64>::BYTES;
  if (dtype == 0 && D == 128) return rt::Layout<128>::BYTES;
  if (dtype == 1 && D == 64) return wg::Layout<64>::BYTES;
  if (dtype == 1 && D == 128) return wg::Layout<128>::BYTES;
  return -1;
}

}  // extern "C"
