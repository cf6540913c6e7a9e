// One LSTM time step for Hopper (sm_90a), plain C interface for ctypes.
//
// Replaces: mxnet_tpu/ops/pallas/lstm.py `lstm_step` (:35) and its Pallas
// kernel `_step_kernel` (:21). With ib (N, 4H) the hoisted input projection
// plus both biases, h and c (N, H) the state and Wh (4H, H) the recurrent
// weight, gate order i, f, g, o:
//
//   gates = ib + h . Wh^T                       (f32 products and sums)
//   c'    = sigmoid(f) * c + sigmoid(i) * tanh(g)
//   h'    = sigmoid(o) * tanh(c')
//
// h' and c' are written in the inputs' type (f32 or bf16); the gate maths
// runs in f32 and tanh(c') reads the f32 c', as in the Pallas kernel. ib
// and c are read through their (row, column) element strides; h' and c' go
// to rows of their own stride (h' straight into ys[t] of the scan's
// output). Wh arrives as a view into the packed parameter blob, h / c as
// rows of the scan's output or as broadcast views with stride 0.
//
// What bounds it on the card: at the LSTM LM's shape, N = 128, H = 512, one
// step is 2*N*4H*H = 268 MFLOP, 4.0 us on the f32 FMA units (67 TFLOP/s),
// against 6.3 MB read and written, 1.9 us at 3.35 TB/s: operations. At
// N = 8 the 4 MB of Wh dominate: bytes, 1.3 us. In bf16 both are bytes.
// Inside the scan Wh (4 MB f32) stays in the 50 MB L2 from step to step,
// so what a step really pays is the L2 -> SM traffic and its latency.
//
// Every body owns whole hidden units: a block takes all four gate rows j,
// H+j, 2H+j, 3H+j of Wh for its units and the whole H-long sum, so the
// block finishes c' and h' of its units itself: no second kernel, no
// atomics, no split of the sum across blocks (the gates need all of it).
// The Pallas kernel does the whole (N, 4H) product in one VMEM pass; on
// Hopper that becomes a grid of such blocks. Three bodies, picked by the
// wrapper's plan (lstm.py `plan`):
//
// f32 (lstm_f32_kernel<BM>): register tiles fed by a cp.async ring.
//  - Tiles: <64> = 64 rows x 8 units a block, for N > 32: at (128, 512)
//    64 x 2 = 128 blocks on 132 SMs, 1M FMAs each (~4.3 us at the FMA
//    rate). A block's L2 traffic is (BM + 4 BJ) * H floats, least for BM
//    = 4 BJ at this block count: 24.6 MB a step. <16> = 16 rows x 4 units,
//    64 threads, one row a thread, for N <= 32: at (8, 512) 128 blocks
//    that share out the 4 MB of Wh, 32 KB each.
//  - A 128-bit shared load costs a warp four cycles, one a quarter-warp,
//    however many lanes read the same address. With 16 sums a thread (4
//    rows x one unit's 4 gates, the first form) a thread reads 8 LDS.128
//    per 64 FMAs: two shared cycles for every FMA cycle. So the <64> body
//    splits k inside the block instead: its 4 warps are k slices, each
//    owning the whole 64 x 8-unit tile over a quarter of every stage, 8
//    rows x 2 units x 4 gates = 64 sums a thread (rows rg + 8 i, units ug
//    + 4 v), 16 LDS.128 per 256 FMAs: one shared cycle per FMA cycle. The
//    slices' sums meet in shared memory after the k loop (40 KB, in the
//    ring's space), and each thread finishes 4 rows of one unit. Within a
//    quarter-warp the h reads are 2 adjacent rows and the Wh reads 4
//    adjacent units, 4 banks apart (row stride BK + 4): no conflicts.
//  - k moves in chunks (BK = 32 / 64) through a 3 / 4-stage cp.async ring.
//    Rows that are 16-byte aligned and contiguous in k (the LM's Wh blob
//    views at offsets 4H*I and 3*4H*H, ys[t-1], with H % 4 == 0) copy 16
//    bytes a time; any other layout (an odd blob offset, stride-0 h0) 4
//    bytes a time through its strides. Nothing is copied on the host.
//  - ib and c are loaded into registers before the products, so their
//    latency hides behind them. Ragged N, H and k are zero-filled by the
//    copies (src size 0) and masked at the store.
//  - Where the time goes at (128, 512) (tools/lstm_variants.py's
//    ablations): the copies, bound by L2's rate for the 24.6 MB, and the
//    products add up instead of overlapping; a deeper ring, a longer
//    chunk or a faster exp do not move it (PERF.md).
//
// bf16 (lstm_wgmma_kernel<BJ>): wgmma fed by TMA, for h and Wh 16-byte
// aligned with unit stride in k and H a multiple of 16.
//  - One warpgroup computes a 64-row h tile (m64) times BJ units x 4 gates.
//    The B tile is ONE TMA box (64 k, BJ units, 4 gates) of Wh viewed as
//    (4, H, H): its rows land gate-major, n = g BJ + u. Both operands are
//    K-major with the 128-byte swizzle; k moves 64 a stage through a
//    4-stage TMA/mbarrier ring (thread 0 issues, each warp releases).
//  - With BJ a multiple of 8, the m64nNk16 accumulator gives the thread
//    that holds column u also u + BJ, u + 2 BJ and u + 3 BJ: each unit's
//    four gates sit in one thread's registers, and the epilogue needs no
//    shared-memory pass. BJ = 8: m64n32k16, 16 f32 a thread, 64 x 2 = 128
//    blocks at (128, 512).
//  - TMA's out-of-bounds zero fill masks rows past N (N = 8 still runs one
//    m64 tile) and k past H. Tensor maps are encoded per call on the host.
//    No conditional wgmma_wait; accumulators are fenced (see hopper.cuh).
//
// bf16 off the TMA route (lstm_simt_kernel<UPW, WARPS>): the first, simple
// form, for misaligned or strided bf16 and H not a multiple of 16. Lane =
// batch row, each warp UPW units, every input read by scalar loads through
// its strides; the wrapper's tiles_for picks (UPW, WARPS).
//
// Keeping Wh resident across steps (one persistent launch per layer with
// a grid-wide step barrier) is later work: it changes the launch count.

#include "hopper.cuh"

namespace {

__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}
__device__ __forceinline__ float sigmoid(float x) {
  return 1.f / (1.f + expf(-x));
}

struct Args {
  const void* ib;
  const void* h;
  const void* c;
  const void* wh;
  void* h_out;
  void* c_out;
  int n, hidden;
  // element strides: (row, column) of each input, row of each output
  int64_t ib_r, ib_c, h_r, h_c, c_r, c_c, wh_r, wh_c, ho_r, co_r;
  int vec_h, vec_w;  // f32: copy h / Wh rows 16 bytes a time
};

// c' and h' of one (row, unit) from its gate sums (ib added), i, f, g, o
template <typename T>
__device__ __forceinline__ void finish(const float (&g)[4], float c_prev,
                                       T* h_out, T* c_out) {
  const float c_new = sigmoid(g[1]) * c_prev + sigmoid(g[0]) * tanhf(g[2]);
  store(c_out, c_new);
  store(h_out, sigmoid(g[3]) * tanhf(c_new));
}

// --- f32: register tiles + cp.async ---------------------------------------------
namespace rt {

template <int BM>
struct Tile {
  static constexpr bool WIDE = BM == 64;
  static constexpr int BJ = WIDE ? 8 : 4;       // units a block
  static constexpr int TM = WIDE ? 8 : 1;       // rows a thread
  static constexpr int TU = WIDE ? 2 : 1;       // units a thread
  static constexpr int KW = WIDE ? 4 : 1;       // k slices of a block
  static constexpr int BK = WIDE ? 32 : 64;     // k a stage
  static constexpr int STAGES = WIDE ? 3 : 4;
  static constexpr int RG = BM / TM;            // row groups of a slice
  static constexpr int UG = BJ / TU;            // unit groups of a slice
  static constexpr int SLICE = RG * UG;         // threads of a slice
  static constexpr int THREADS = SLICE * KW;
  static constexpr int KS = BK / KW;            // k of a stage a slice sums
  static constexpr int LDS = BK + 4;            // row stride (floats): rows
                                                // 4 banks apart
  static constexpr int WROWS = 4 * BJ;          // Wh rows: gate-major
  static constexpr int STAGE_FLOATS = (BM + WROWS) * LDS;
  static constexpr int RING_FLOATS = STAGES * STAGE_FLOATS;
  static constexpr int LDR = 4 * BJ + 8;        // row stride of the sums
  static constexpr int RED_FLOATS = KW > 1 ? KW * BM * LDR : 0;
  static constexpr int BYTES =                  // the sums reuse the ring
      (RING_FLOATS > RED_FLOATS ? RING_FLOATS : RED_FLOATS) * 4;
  // (row, unit) outputs a thread finishes: its own with one slice, else
  // an equal share of the block's
  static constexpr int FT = KW > 1 ? BM * BJ / THREADS : TM * TU;
  static_assert((BM * BK) % (4 * THREADS) == 0 &&
                    (WROWS * BK) % (4 * THREADS) == 0 && KS % 4 == 0,
                "whole 16-byte copies a thread, float4 steps a slice");
};

// Stage k0 .. k0 + BK of the block's h rows and Wh rows into `s`:
// 16-byte copies where the operand allows it, else 4-byte ones through
// the strides; out of range (row >= N, unit >= H, k >= H) copies zeros.
// The 4-byte loops stay rolled: unrolled, ptxas keeps each copy's
// 64-bit row address live across the k loop (16 + 16 of them in the
// 16-row body), and the bodies spill.
template <int BM>
__device__ __forceinline__ void stage(float* s, const Args& a, int r0,
                                      int j0, int k0, int tid) {
  using L = Tile<BM>;
  const float* h = static_cast<const float*>(a.h);
  const float* wh = static_cast<const float*>(a.wh);
  const int H = a.hidden;
  float* sh = s;
  float* sw = s + BM * L::LDS;
  constexpr int Q = L::BK / 4;  // 16-byte pieces a row
  if (a.vec_h) {
#pragma unroll
    for (int p = 0; p < BM * Q / L::THREADS; ++p) {
      const int q = tid + p * L::THREADS;
      const int r = q / Q, kk = (q % Q) * 4;
      const int row = r0 + r, k = k0 + kk;
      const bool ok = row < a.n && k < H;
      hopper::cp_async16(sh + r * L::LDS + kk,
                         ok ? h + (int64_t)row * a.h_r + k : h, ok);
    }
  } else {
#pragma unroll 1
    for (int p = 0; p < BM * L::BK / L::THREADS; ++p) {
      const int q = tid + p * L::THREADS;
      const int r = q / L::BK, kk = q % L::BK;
      const int row = r0 + r, k = k0 + kk;
      const bool ok = row < a.n && k < H;
      hopper::cp_async4(sh + r * L::LDS + kk,
                        ok ? h + (int64_t)row * a.h_r + (int64_t)k * a.h_c
                           : h,
                        ok);
    }
  }
  if (a.vec_w) {
#pragma unroll
    for (int p = 0; p < L::WROWS * Q / L::THREADS; ++p) {
      const int q = tid + p * L::THREADS;
      const int wr = q / Q, kk = (q % Q) * 4;
      const int g = wr / L::BJ, j = j0 + wr % L::BJ, k = k0 + kk;
      const bool ok = j < H && k < H;
      hopper::cp_async16(sw + wr * L::LDS + kk,
                         ok ? wh + ((int64_t)g * H + j) * a.wh_r + k : wh,
                         ok);
    }
  } else {
#pragma unroll 1
    for (int p = 0; p < L::WROWS * L::BK / L::THREADS; ++p) {
      const int q = tid + p * L::THREADS;
      const int wr = q / L::BK, kk = q % L::BK;
      const int g = wr / L::BJ, j = j0 + wr % L::BJ, k = k0 + kk;
      const bool ok = j < H && k < H;
      hopper::cp_async4(sw + wr * L::LDS + kk,
                        ok ? wh + ((int64_t)g * H + j) * a.wh_r +
                                 (int64_t)k * a.wh_c
                           : wh,
                        ok);
    }
  }
}

// (row, unit) in the block of the f-th output thread t = tid, (rg, ug),
// finishes: its own with one slice, else rows t / BJ + (THREADS / BJ) f of
// unit t % BJ
template <int BM>
__device__ __forceinline__ int2 out_at(int f, int tid, int rg, int ug) {
  using L = Tile<BM>;
  if constexpr (L::KW > 1)
    return make_int2(tid / L::BJ + (L::THREADS / L::BJ) * f, tid % L::BJ);
  else
    return make_int2(rg + L::RG * (f / L::TU), ug + L::UG * (f % L::TU));
}

// Block (unit tile x, row tile y). Thread t is in k slice kw = t / SLICE
// and, inside it, owns rows r0 + rg + RG i (i < TM) of units j0 + ug + UG
// v (v < TU), (rg, ug) = ((t % SLICE) / UG, (t % SLICE) % UG): each stage
// of BK k is summed by the KW slices, KS k each. With KW > 1 the slices'
// sums meet in shared memory, and thread t finishes rows t / BJ + (THREADS
// / BJ) i of unit t % BJ. One block an SM is all a launch needs: with that
// bound ptxas may use every register (left to its own occupancy target it
// held the 16-row body to 72 registers, and it spilled).
template <int BM>
__global__ void __launch_bounds__(Tile<BM>::THREADS, 1)
lstm_f32_kernel(Args a) {
  using L = Tile<BM>;
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int tid = threadIdx.x;
  const int kw = tid / L::SLICE, st = tid % L::SLICE;
  const int rg = st / L::UG, ug = st % L::UG;
  const int j0 = blockIdx.x * L::BJ, r0 = blockIdx.y * BM;
  const int H = a.hidden;

  // the epilogue's operands, loaded first: their latency hides behind the
  // products
  const float* ib = static_cast<const float*>(a.ib);
  const float* c = static_cast<const float*>(a.c);
  float ibv[L::FT][4], cv[L::FT];
#pragma unroll
  for (int f = 0; f < L::FT; ++f) {
    const int2 o = out_at<BM>(f, tid, rg, ug);
    const int row = r0 + o.x, j = j0 + o.y;
    const bool ok = row < a.n && j < H;
#pragma unroll
    for (int g = 0; g < 4; ++g)
      ibv[f][g] = ok ? ib[(int64_t)row * a.ib_r + (int64_t)(g * H + j) *
                                                      a.ib_c]
                     : 0.f;
    cv[f] = ok ? c[(int64_t)row * a.c_r + (int64_t)j * a.c_c] : 0.f;
  }

  float acc[L::TM][L::TU][4];
#pragma unroll
  for (int i = 0; i < L::TM; ++i)
#pragma unroll
    for (int v = 0; v < L::TU; ++v)
#pragma unroll
      for (int g = 0; g < 4; ++g) acc[i][v][g] = 0.f;

  const int nk = (H + L::BK - 1) / L::BK;
#pragma unroll
  for (int s = 0; s < L::STAGES - 1; ++s) {
    if (s < nk) stage<BM>(smem + s * L::STAGE_FLOATS, a, r0, j0, s * L::BK,
                          tid);
    hopper::cp_async_commit();
  }
  for (int kc = 0; kc < nk; ++kc) {
    hopper::cp_async_wait<L::STAGES - 2>();  // chunk kc has landed
    __syncthreads();  // ... for every thread; chunk kc - 1 is consumed
    const int next = kc + L::STAGES - 1;
    if (next < nk)
      stage<BM>(smem + (next % L::STAGES) * L::STAGE_FLOATS, a, r0, j0,
                next * L::BK, tid);
    hopper::cp_async_commit();
    const float* sh = smem + (kc % L::STAGES) * L::STAGE_FLOATS + kw * L::KS;
    const float* sw = sh + BM * L::LDS;
#pragma unroll
    for (int kk = 0; kk < L::KS; kk += 4) {
      float4 wv[L::TU][4];
#pragma unroll
      for (int v = 0; v < L::TU; ++v)
#pragma unroll
        for (int g = 0; g < 4; ++g)
          wv[v][g] = *reinterpret_cast<const float4*>(
              sw + (g * L::BJ + ug + L::UG * v) * L::LDS + kk);
#pragma unroll
      for (int i = 0; i < L::TM; ++i) {
        const float4 hv = *reinterpret_cast<const float4*>(
            sh + (rg + L::RG * i) * L::LDS + kk);
#pragma unroll
        for (int v = 0; v < L::TU; ++v)
#pragma unroll
          for (int g = 0; g < 4; ++g) {
            float s = acc[i][v][g];
            s = fmaf(hv.x, wv[v][g].x, s);
            s = fmaf(hv.y, wv[v][g].y, s);
            s = fmaf(hv.z, wv[v][g].z, s);
            s = fmaf(hv.w, wv[v][g].w, s);
            acc[i][v][g] = s;
          }
      }
    }
  }

  if constexpr (L::KW > 1) {
    // the slices' sums meet in the ring's space: [slice][row][g BJ + u]
    hopper::cp_async_wait<0>();
    __syncthreads();
    float* red = smem;
#pragma unroll
    for (int i = 0; i < L::TM; ++i)
#pragma unroll
      for (int v = 0; v < L::TU; ++v)
#pragma unroll
        for (int g = 0; g < 4; ++g)
          red[(kw * BM + rg + L::RG * i) * L::LDR + g * L::BJ + ug +
              L::UG * v] = acc[i][v][g];
    __syncthreads();
  }
  float* h_out = static_cast<float*>(a.h_out);
  float* c_out = static_cast<float*>(a.c_out);
#pragma unroll
  for (int f = 0; f < L::FT; ++f) {
    const int2 o = out_at<BM>(f, tid, rg, ug);
    const int r = o.x, u = o.y;
    if (r0 + r >= a.n || j0 + u >= H) continue;
    float g[4];
#pragma unroll
    for (int gi = 0; gi < 4; ++gi) {
      float sum = ibv[f][gi];
      if constexpr (L::KW > 1) {
#pragma unroll
        for (int w = 0; w < L::KW; ++w)
          sum += smem[(w * BM + r) * L::LDR + gi * L::BJ + u];
      } else {
        sum += acc[f / L::TU][f % L::TU][gi];
      }
      g[gi] = sum;
    }
    finish(g, cv[f], h_out + (int64_t)(r0 + r) * a.ho_r + j0 + u,
           c_out + (int64_t)(r0 + r) * a.co_r + j0 + u);
  }
}

template <int BM>
int launch(const Args& a, cudaStream_t s) {
  using L = Tile<BM>;
  cudaError_t e = cudaFuncSetAttribute(
      lstm_f32_kernel<BM>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      L::BYTES);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((unsigned)((a.hidden + L::BJ - 1) / L::BJ),
                  (unsigned)((a.n + BM - 1) / BM));
  lstm_f32_kernel<BM><<<grid, L::THREADS, L::BYTES, s>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace rt

// --- bf16: wgmma + TMA ----------------------------------------------------------
namespace wg {

constexpr int BM = 64;             // batch rows a block: one m64 tile
constexpr int BK = 64;             // k a stage: one 128-byte box row
constexpr int STAGES = 4;
constexpr int THREADS = 128;       // one warpgroup
constexpr int A_BYTES = BM * 128;  // the h box

template <int BJ>
struct Layout {
  static_assert(BJ % 8 == 0, "each unit's four gates in one thread");
  static constexpr int N = 4 * BJ;            // columns: gate-major
  static constexpr int B_BYTES = N * 128;     // the Wh box (64, BJ, 4)
  static constexpr int STAGE_BYTES = A_BYTES + B_BYTES;
  static constexpr int BAR_OFF = STAGES * STAGE_BYTES;
  static constexpr int BYTES = BAR_OFF + 2 * STAGES * 8 + 1024;
  static_assert(B_BYTES % 1024 == 0 && STAGE_BYTES % 1024 == 0,
                "swizzled tiles on 1024-byte boundaries");
};

struct Maps {
  CUtensorMap h;   // (H, N): boxes (64 k, 64 rows)
  CUtensorMap wh;  // (H, H, 4): boxes (64 k, BJ units, 4 gates)
};

template <int BJ>
__device__ __forceinline__ void mma_stage(float (&acc)[2 * BJ], uint32_t a,
                                          uint32_t b) {
#pragma unroll
  for (int kk = 0; kk < BK / 16; ++kk) {
    const uint64_t da = hopper::make_desc_sw128(a + kk * 32, 16, 1024);
    const uint64_t db = hopper::make_desc_sw128(b + kk * 32, 16, 1024);
    if constexpr (BJ == 8)
      hopper::wgmma_ss_m64n32k16(acc, da, db, 1);
    else
      hopper::wgmma_ss_m64n64k16(acc, da, db, 1);
  }
}

// Block (unit tile x, row tile y): rows r0 .. r0 + 64 of units j0 .. j0 +
// BJ. Thread t holds rows 16 (t / 32) + (t % 32) / 4 (+ 8) and, in each
// 8-column group q of gate g, units 8 q + 2 (t % 4) (+ 1): the column
// of gate g, unit u is g BJ + u, so d[4 (g BJ / 8 + q) + 2 hh + e].
template <int BJ>
__global__ void __launch_bounds__(THREADS, 1)
lstm_wgmma_kernel(const __grid_constant__ Maps maps, Args a) {
  using namespace hopper;
  using L = Layout<BJ>;
  constexpr int NQ = BJ / 8;  // 8-column groups a gate
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t full = base + L::BAR_OFF, empty = full + 8 * STAGES;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int j0 = blockIdx.x * BJ, r0 = blockIdx.y * BM;
  const int H = a.hidden, nk = (H + BK - 1) / BK;

  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, 4);  // one arrival per warp
    }
    mbar_fence_init();
  }
  __syncthreads();

  // thread 0: stage i of k into slot i % STAGES, once the 4 warps have
  // released that slot's previous stage
  auto load = [&](int i) {
    const int s = i % STAGES;
    if (i >= STAGES) mbar_wait(empty + 8 * s, (i / STAGES - 1) & 1);
    const uint32_t dst = base + s * L::STAGE_BYTES, bar = full + 8 * s;
    mbar_expect_tx(bar, L::STAGE_BYTES);
    tma_load_4d(dst, &maps.h, bar, i * BK, r0, 0, 0);
    tma_load_4d(dst + A_BYTES, &maps.wh, bar, i * BK, j0, 0, 0);
  };
  if (tid == 0)
    for (int i = 0; i < min(nk, STAGES - 1); ++i) load(i);

  // the epilogue's operands, loaded while the products run
  const __nv_bfloat16* ib = static_cast<const __nv_bfloat16*>(a.ib);
  const __nv_bfloat16* c = static_cast<const __nv_bfloat16*>(a.c);
  const int row0 = r0 + 16 * warp + lane / 4, u0 = 2 * (lane % 4);
  float ibv[2][NQ][2][4], cv[2][NQ][2];
#pragma unroll
  for (int hh = 0; hh < 2; ++hh)
#pragma unroll
    for (int q = 0; q < NQ; ++q)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int row = row0 + 8 * hh, j = j0 + 8 * q + u0 + e;
        const bool ok = row < a.n && j < H;
#pragma unroll
        for (int g = 0; g < 4; ++g)
          ibv[hh][q][e][g] =
              ok ? to_f32(ib[(int64_t)row * a.ib_r +
                             (int64_t)(g * H + j) * a.ib_c])
                 : 0.f;
        cv[hh][q][e] =
            ok ? to_f32(c[(int64_t)row * a.c_r + (int64_t)j * a.c_c]) : 0.f;
      }

  float acc[2 * BJ];
#pragma unroll
  for (int i = 0; i < 2 * BJ; ++i) acc[i] = 0.f;
  for (int i = 0; i < nk; ++i) {
    const int s = i % STAGES;
    const uint32_t st = base + s * L::STAGE_BYTES;
    mbar_wait(full + 8 * s, (i / STAGES) & 1);
    fence_all(acc);
    wgmma_fence();
    mma_stage<BJ>(acc, st, st + A_BYTES);
    wgmma_commit();
    fence_all(acc);
    wgmma_wait<1>();  // stage i - 1's products are done
    fence_all(acc);
    if (i > 0 && lane == 0) mbar_arrive(empty + 8 * ((i - 1) % STAGES));
    if (tid == 0 && i + STAGES - 1 < nk) load(i + STAGES - 1);
  }
  wgmma_wait<0>();
  fence_all(acc);

  __nv_bfloat16* h_out = static_cast<__nv_bfloat16*>(a.h_out);
  __nv_bfloat16* c_out = static_cast<__nv_bfloat16*>(a.c_out);
#pragma unroll
  for (int hh = 0; hh < 2; ++hh)
#pragma unroll
    for (int q = 0; q < NQ; ++q)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int row = row0 + 8 * hh, j = j0 + 8 * q + u0 + e;
        if (row >= a.n || j >= H) continue;
        float g[4];
#pragma unroll
        for (int gi = 0; gi < 4; ++gi)
          g[gi] = acc[4 * (gi * NQ + q) + 2 * hh + e] + ibv[hh][q][e][gi];
        finish(g, cv[hh][q][e], h_out + (int64_t)row * a.ho_r + j,
               c_out + (int64_t)row * a.co_r + j);
      }
}

// h as (H, N) and Wh as (H, H, 4), bf16, rows 16-byte aligned
template <int BJ>
int launch(const Args& a, cudaStream_t s) {
  Maps m;
  const uint64_t n = (uint64_t)a.n, hid = (uint64_t)a.hidden;
  const uint64_t hr = (uint64_t)a.h_r * 2, wr = (uint64_t)a.wh_r * 2;
  const uint64_t hd[4] = {hid, n, 1, 1};
  const uint64_t hs[3] = {hr, hr * n, hr * n};
  const uint32_t hbox[4] = {BK, BM, 1, 1};
  const uint64_t wd[4] = {hid, hid, 4, 1};
  const uint64_t ws[3] = {wr, wr * hid, wr * hid * 4};
  const uint32_t wbox[4] = {BK, BJ, 4, 1};
  int err = hopper::encode_bf16_4d_box(&m.h, a.h, hd, hs, hbox);
  if (err == 0) err = hopper::encode_bf16_4d_box(&m.wh, a.wh, wd, ws, wbox);
  if (err != 0) return err;
  const int smem = Layout<BJ>::BYTES;
  cudaError_t e = cudaFuncSetAttribute(
      lstm_wgmma_kernel<BJ>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((unsigned)(a.hidden / BJ), (unsigned)((a.n + BM - 1) / BM));
  lstm_wgmma_kernel<BJ><<<grid, THREADS, smem, s>>>(m, a);
  return (int)cudaGetLastError();
}

}  // namespace wg

// --- bf16 off the TMA route: the simple SIMT form ----------------------------------
namespace simt {

constexpr int ROWS = 32;     // batch rows per block: one per lane
constexpr int BK = 32;       // k per staged chunk
constexpr int LDS = BK + 4;  // shared row stride (floats), 16-byte aligned

// Lane = batch row; each warp takes UPW units, so a thread keeps 4 UPW f32
// sums. Each 32-wide chunk of the H-long dot product is staged in shared
// memory through scalar loads: the h tile (32 rows) and the Wh rows (read
// by all lanes of a warp at once: a broadcast).
template <int UPW, int WARPS>
__global__ void __launch_bounds__(WARPS * 32)
lstm_simt_kernel(Args a) {
  using T = __nv_bfloat16;
  constexpr int THREADS = WARPS * 32;
  constexpr int BJ = WARPS * UPW;  // hidden units per block
  constexpr int WROWS = 4 * BJ;    // Wh rows per block: gate-major
  __shared__ __align__(16) float sh[ROWS][LDS];
  __shared__ __align__(16) float sw[WROWS][LDS];

  const T* ib = static_cast<const T*>(a.ib);
  const T* h = static_cast<const T*>(a.h);
  const T* c = static_cast<const T*>(a.c);
  const T* wh = static_cast<const T*>(a.wh);
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int j0 = blockIdx.x * BJ;    // first unit of the block
  const int r0 = blockIdx.y * ROWS;  // first row of the block
  const int H = a.hidden;

  float acc[UPW][4];
#pragma unroll
  for (int u = 0; u < UPW; ++u)
#pragma unroll
    for (int g = 0; g < 4; ++g) acc[u][g] = 0.f;

  // staging role: column kk of each chunk (consecutive threads read
  // consecutive k), rows tid / BK + p * (THREADS / BK)
  constexpr int RSTEP = THREADS / BK;
  const int kk_s = tid % BK, r_s = tid / BK;
  for (int k0 = 0; k0 < H; k0 += BK) {
    const int k = k0 + kk_s;
    const bool kok = k < H;
#pragma unroll 4
    for (int r = r_s; r < ROWS; r += RSTEP) {
      const int row = r0 + r;
      sh[r][kk_s] = (kok && row < a.n)
                        ? to_f32(h[row * a.h_r + k * a.h_c])
                        : 0.f;
    }
#pragma unroll 4
    for (int wr = r_s; wr < WROWS; wr += RSTEP) {
      const int g = wr / BJ, j = j0 + (wr - g * BJ);
      sw[wr][kk_s] = (kok && j < H)
                         ? to_f32(wh[((int64_t)g * H + j) * a.wh_r +
                                     k * a.wh_c])
                         : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; kk += 4) {
      const float4 hv = *reinterpret_cast<const float4*>(&sh[lane][kk]);
#pragma unroll
      for (int u = 0; u < UPW; ++u) {
        const int ul = warp * UPW + u;
#pragma unroll
        for (int g = 0; g < 4; ++g) {
          const float4 wv =
              *reinterpret_cast<const float4*>(&sw[g * BJ + ul][kk]);
          float s = acc[u][g];
          s = fmaf(hv.x, wv.x, s);
          s = fmaf(hv.y, wv.y, s);
          s = fmaf(hv.z, wv.z, s);
          s = fmaf(hv.w, wv.w, s);
          acc[u][g] = s;
        }
      }
    }
    __syncthreads();
  }

  const int row = r0 + lane;
  if (row >= a.n) return;
  T* h_out = static_cast<T*>(a.h_out) + row * a.ho_r;
  T* c_out = static_cast<T*>(a.c_out) + row * a.co_r;
  const T* ib_row = ib + row * a.ib_r;
#pragma unroll
  for (int u = 0; u < UPW; ++u) {
    const int j = j0 + warp * UPW + u;
    if (j >= H) continue;
    float g[4];
#pragma unroll
    for (int gi = 0; gi < 4; ++gi)
      g[gi] = acc[u][gi] + to_f32(ib_row[(int64_t)(gi * H + j) * a.ib_c]);
    finish(g, to_f32(c[row * a.c_r + j * a.c_c]), h_out + j, c_out + j);
  }
}

template <int UPW, int WARPS>
int launch(const Args& a, cudaStream_t s) {
  constexpr int BJ = WARPS * UPW;
  dim3 grid((unsigned)((a.hidden + BJ - 1) / BJ),
            (unsigned)((a.n + ROWS - 1) / ROWS));
  lstm_simt_kernel<UPW, WARPS><<<grid, WARPS * 32, 0, s>>>(a);
  return (int)cudaGetLastError();
}

int dispatch(const Args& a, int upw, int warps, cudaStream_t s) {
  if (upw == 4 && warps == 4) return launch<4, 4>(a, s);
  if (upw == 2 && warps == 4) return launch<2, 4>(a, s);
  if (upw == 1 && warps == 4) return launch<1, 4>(a, s);
  if (upw == 1 && warps == 2) return launch<1, 2>(a, s);
  if (upw == 1 && warps == 1) return launch<1, 1>(a, s);
  return (int)cudaErrorInvalidValue;
}

}  // namespace simt

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

// rows of `elems`-element pieces of 16 bytes: unit stride in k, every
// row start on 16 bytes
bool rows16(const void* p, int64_t row, int64_t col, int64_t elems) {
  return aligned16(p) && col == 1 && row % elems == 0;
}

}  // namespace

extern "C" {

// One step on `stream`. dtype: 0 float32, 1 bfloat16 (all six tensors
// alike). n, hidden >= 1. Strides are in elements: ib (N, 4H), h, c (N,
// H) and wh (4H, H) by (row, column); h_out, c_out (N, H) by row, column
// stride 1. The outputs must not overlap the inputs. route (the wrapper's
// plan): 0 f32 (float32; tile = BM, 64 or 16; vec_h / vec_w copy h / Wh
// 16 bytes a time, which wants rows of unit column stride starting on 16
// bytes and H % 4 == 0), 1 wgmma (bfloat16; tile = BJ, 8; h and wh rows
// of unit column stride, 16-byte aligned, at least H apart; H % 16 == 0),
// 2 simt (bfloat16; (tile, warps) one of (4, 4), (2, 4), (1, 4), (1, 2),
// (1, 1)). Returns a cudaError_t.
int mxtt_lstm_step(const void* ib, const void* h, const void* c,
                   const void* wh, void* h_out, void* c_out, int dtype,
                   int n, int hidden, int64_t ib_r, int64_t ib_c,
                   int64_t h_r, int64_t h_c, int64_t c_r, int64_t c_c,
                   int64_t wh_r, int64_t wh_c, int64_t ho_r, int64_t co_r,
                   int route, int tile, int warps, int vec_h, int vec_w,
                   void* stream) {
  if ((dtype != 0 && dtype != 1) || n < 1 || hidden < 1 ||
      (n + 15) / 16 > 65535 || (int64_t)4 * hidden > INT32_MAX)
    return (int)cudaErrorInvalidValue;
  Args a{ib,   h,    c,    wh,   h_out, c_out, n,    hidden, ib_r, ib_c,
         h_r,  h_c,  c_r,  c_c,  wh_r,  wh_c,  ho_r, co_r,   vec_h, vec_w};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (route == 0) {
    if (dtype != 0 || (vec_h && !rows16(h, h_r, h_c, 4)) ||
        (vec_w && !rows16(wh, wh_r, wh_c, 4)) ||
        ((vec_h || vec_w) && hidden % 4 != 0))
      return (int)cudaErrorInvalidValue;
    if (tile == 64) return rt::launch<64>(a, s);
    if (tile == 16) return rt::launch<16>(a, s);
    return (int)cudaErrorInvalidValue;
  }
  if (route == 1) {
    if (dtype != 1 || tile != 8 || hidden % 16 != 0 ||
        !rows16(h, h_r, h_c, 8) || !rows16(wh, wh_r, wh_c, 8) ||
        h_r < hidden || wh_r < hidden)
      return (int)cudaErrorInvalidValue;
    return wg::launch<8>(a, s);
  }
  if (route == 2 && dtype == 1) return simt::dispatch(a, tile, warps, s);
  return (int)cudaErrorInvalidValue;
}

// Dynamic shared memory (bytes) a block of `route` at `tile` takes (the
// simt body uses static shared memory only: 0).
int mxtt_lstm_step_smem(int route, int tile) {
  if (route == 0 && tile == 64) return rt::Tile<64>::BYTES;
  if (route == 0 && tile == 16) return rt::Tile<16>::BYTES;
  if (route == 1 && tile == 8) return wg::Layout<8>::BYTES;
  return 0;
}

}  // extern "C"
