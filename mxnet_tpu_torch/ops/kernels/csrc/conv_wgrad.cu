// Convolution weight gradient for Hopper (sm_90a), plain C interface for
// ctypes.
//
// Replaces: mxnet_tpu/ops/pallas/conv_bwd.py `conv_wgrad` (:89) and its
// Pallas kernel `_wgrad_kernel` (:38). For a (ksz, ksz) window with one
// stride s and one zero padding p on both spatial axes:
//
//   dW[kh, kw, c, k] = sum over (n, oh, ow) of
//                      x[n, oh*s - p + kh, ow*s - p + kw, c] * dy[n, oh, ow, k]
//
// x is (N, H, W, C) and dy (N, OH, OW, K). The result is f32 HWIO (ksz, ksz,
// C, K), contiguous: an (M = ksz*ksz*C) x K row-major matrix whose row
// m = (kh*ksz + kw)*C + c. Products and sums run in f32. It is a GEMM of
// M x K over the depth L = N*OH*OW, whose A operand (x) is read through the
// window, never copied out as columns.
//
// What bounds it on the card: operations. Every 3x3 convolution of
// ResNet-50 at batch 32 is 2*N*OH*OW*C*K*9 = 7.40 GFLOP (the stages trade
// spatial size for channels): 0.110 ms on the f32 FMA units (67 TFLOP/s),
// 7.5 us on the bf16 tensor cores (989 TFLOP/s), against 4-8 us for x and
// dy in bf16.
//
// The depth L (1,568 to 100,352 at batch 32) is long and the output small
// (576 x 64 at stage 1), so one block per output tile would leave most SMs
// idle. The Pallas kernel sums image blocks along a sequential grid axis;
// Hopper blocks run in no order, so the reduction is split: block
// (m, k, z) of a partial kernel sums its split z of L for one output tile
// into slice z of an f32 workspace (splits, M, K), and
// conv_wgrad_reduce_kernel adds the slices in the order z = 0..splits-1.
// No atomics: the gradient repeats bitwise. The wrapper's plan
// (conv_wgrad.py `plan`) picks the splits so that the blocks fill whole
// waves of the card.
//
// Three bodies, one per route of the plan:
//
// bf16 (conv_wgrad_wgmma_kernel): implicit GEMM on the tensor cores.
// x and dy arrive as contiguous NHWC bf16 (conv_wgrad_repack_kernel
// transposes the NCHW views once per call through shared-memory tiles,
// the cast fused in), so every TMA stride is a multiple of 16 bytes. An
// L tile is one TMA box of (64 channels, bw, bh, bi) = 64 rows of
// (ow, oh, n); the box's W and H extents are powers of two that cover
// OW and OH (8 / 16 / 32 / 64 at OW = 7 / 14 / 28 / 56), and
// the rows past OW, OH or N read as zeros in dy, so they add nothing. The
// x box of tap (kh, kw) is the same box shifted by (kh - p, kw - p): boxes
// that leave the image fill with zeros, and those zeros are the padding.
// Stride 2 reads x through four parity planes (x[:, hp::2, wp::2, :], a
// map each: base offset and doubled strides), so a tap is a plain shift in
// one plane. A block is two warpgroups, each owning 64 rows of M (one tap,
// 64 channels) against the same BN = 64 or 128 columns of K: thread 0
// streams the two x boxes and the BN / 64 dy boxes of each L tile through
// a 3-stage ring (full and empty mbarriers, as the flash kernels), and each
// warpgroup runs wgmma m64nBNk16 with both operands MN-major (c and k
// contiguous; the transpose bits), four per tile, keeping one group in
// flight. The accumulator (BN / 2 f32 registers a thread) is the sum.
// 3 x 24 or 32 KB of shared memory, two or more blocks an SM; bf16
// products are exact in f32.
//
// f32 (conv_wgrad_f32_kernel): full f32 on the FMA units, no TF32 (the
// resnet phase holds updates against the CPU). A block owns a 128 x BN
// tile (BN = 64 or 128), 2 * BN threads, each an 8 x 8 register tile (rows
// 4t.. and 64 + 4t.., columns likewise): per row of L it reads two float4
// of x and two of dy from shared memory for 64 FMAs. Tiles of 16 rows of L
// stream through a 3-stage ring by 4-byte cp.async straight from the NCHW
// views (f32 is 4-byte aligned at every window shift, so no repack); the
// zero-fill form (src-size 0) writes the padding and the ragged edges.
// Eight lanes take eight consecutive rows of L of one column (32
// contiguous bytes of NCHW) and rows sit 4 floats apart modulo 32 banks,
// so the stores are free of bank conflicts. Each thread's (c, kh, kw)
// offsets are computed once; its (n, oh, ow) advances by 16 rows a tile
// without a division.
//
// bf16 off the TMA route (conv_wgrad_simt_kernel): C or K not a multiple
// of 8, a stride above 2, or H or W not a multiple of the stride. The
// first, simple form: 64 x 64 tiles,
// 32 rows of L a step staged through registers (bf16 widened to f32),
// 4 x 4 micro-tiles on the FMA units.

#include "hopper.cuh"

namespace {

// --- bf16: wgmma + TMA ----------------------------------------------------------
namespace wg {

constexpr int BL = 64;                // rows of L per tile: one box
constexpr int STAGES = 3;             // two blocks an SM at BN = 128
constexpr int THREADS = 256;          // two warpgroups
constexpr int BOX_BYTES = BL * 128;   // 64 bf16 of c (or k) a row

template <int BN>
struct Layout {
  // stage: x box of warpgroup 0, of warpgroup 1, then BN / 64 dy boxes
  static constexpr int STAGE_BYTES = (2 + BN / 64) * BOX_BYTES;
  static constexpr int BAR_OFF = STAGES * STAGE_BYTES;
  static constexpr int BYTES = BAR_OFF + 2 * STAGES * 8 + 1024;
};

// x through s * s parity planes (s <= 2), then dy
struct Maps {
  CUtensorMap x[4];
  CUtensorMap dy;
};

struct Geom {
  int c, k, m, ksz, stride, pad;
  int cb;          // 64-channel blocks of C
  int mt;          // 64-row tiles of M: ksz * ksz * cb
  int wb, hb;      // L tiles along OW and OH
  int bw, bh, bi;  // a tile's box extents along OW, OH, N
  int lt;          // L tiles
  int chunk;       // L tiles per split
};

struct Tap {
  int plane, dw, dh, c0;
};

// Where M tile `mt` reads x: its parity plane, the shift of its box in the
// plane, and its first channel.
__device__ __forceinline__ Tap tap_of(const Geom& g, int mt) {
  const int tap = mt / g.cb;
  const int cbi = mt - tap * g.cb;
  const int kh = tap / g.ksz, kw = tap - (tap / g.ksz) * g.ksz;
  const int qh = kh - g.pad, qw = kw - g.pad;
  // floor division and a remainder in [0, s)
  const int dh = (qh >= 0 ? qh : qh - g.stride + 1) / g.stride;
  const int dw = (qw >= 0 ? qw : qw - g.stride + 1) / g.stride;
  return {(qh - dh * g.stride) * g.stride + (qw - dw * g.stride), dw, dh,
          cbi * 64};
}

template <int BN>
__device__ __forceinline__ void mma_tile(float (&acc)[BN / 2], uint32_t a,
                                         uint32_t b) {
#pragma unroll
  for (int kk = 0; kk < BL / 16; ++kk) {
    const uint64_t da = hopper::make_desc_sw128(a + kk * 2048, BOX_BYTES, 1024);
    const uint64_t db = hopper::make_desc_sw128(b + kk * 2048, BOX_BYTES, 1024);
    if constexpr (BN == 128)
      hopper::wgmma_ss_m64n128k16_tt(acc, da, db);
    else
      hopper::wgmma_ss_m64n64k16_tt(acc, da, db);
  }
}

// Block (mb, kb, z): warpgroup w owns M tile 2 mb + w (the last tile again,
// unstored, when that is past the end), columns kb * BN .., and sums L
// tiles z * chunk .. of them into ws slice z.
template <int BN>
__global__ void __launch_bounds__(THREADS, 1)
conv_wgrad_wgmma_kernel(const __grid_constant__ Maps maps,
                        float* __restrict__ ws, Geom g) {
  using namespace hopper;
  using L = Layout<BN>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t full = base + L::BAR_OFF, empty = full + 8 * STAGES;

  const int w = threadIdx.x / 128;
  const int mt_own = 2 * blockIdx.x + w;
  const int k0 = blockIdx.y * BN;
  const int t_begin = blockIdx.z * g.chunk;
  const int n = min(g.chunk, g.lt - t_begin);

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, 8);  // one arrival per warp
    }
    mbar_fence_init();
  }
  __syncthreads();

  // thread 0: L tile i of the split into stage i % STAGES, once the 8 warps
  // have released that stage's previous tile
  const Tap tap0 = tap_of(g, min(2 * blockIdx.x, g.mt - 1));
  const Tap tap1 = tap_of(g, min(2 * blockIdx.x + 1, g.mt - 1));
  auto load = [&](int i) {
    const int s = i % STAGES;
    if (i >= STAGES) mbar_wait(empty + 8 * s, (i / STAGES - 1) & 1);
    const int t = t_begin + i;
    const int wi = t % g.wb, r = t / g.wb;
    const int ow0 = wi * g.bw, oh0 = (r % g.hb) * g.bh, n0 = (r / g.hb) * g.bi;
    const uint32_t dst = base + s * L::STAGE_BYTES, bar = full + 8 * s;
    mbar_expect_tx(bar, L::STAGE_BYTES);
    tma_load_4d(dst, &maps.x[tap0.plane], bar, tap0.c0, ow0 + tap0.dw,
                oh0 + tap0.dh, n0);
    tma_load_4d(dst + BOX_BYTES, &maps.x[tap1.plane], bar, tap1.c0,
                ow0 + tap1.dw, oh0 + tap1.dh, n0);
#pragma unroll
    for (int j = 0; j < BN / 64; ++j)
      tma_load_4d(dst + (2 + j) * BOX_BYTES, &maps.dy, bar, k0 + 64 * j, ow0,
                  oh0, n0);
  };
  if (threadIdx.x == 0)
    for (int i = 0; i < min(n, STAGES - 1); ++i) load(i);

  float acc[BN / 2];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;
  const int lane = threadIdx.x % 32;
  for (int i = 0; i < n; ++i) {
    const int s = i % STAGES;
    const uint32_t st = base + s * L::STAGE_BYTES;
    mbar_wait(full + 8 * s, (i / STAGES) & 1);
    fence_all(acc);
    wgmma_fence();
    mma_tile<BN>(acc, st + w * BOX_BYTES, st + 2 * BOX_BYTES);
    wgmma_commit();
    fence_all(acc);
    wgmma_wait<1>();  // tile i - 1's products are done
    fence_all(acc);
    if (i > 0 && lane == 0) mbar_arrive(empty + 8 * ((i - 1) % STAGES));
    if (threadIdx.x == 0 && i + STAGES - 1 < n) load(i + STAGES - 1);
  }
  wgmma_wait<0>();
  fence_all(acc);
  if (mt_own >= g.mt) return;

  // rows r0, r0 + 8 of the warpgroup's tile; columns 8j + cq, + 1
  const Tap tap = w == 0 ? tap0 : tap1;
  const int tw = threadIdx.x % 128;
  const int r0 = 16 * (tw / 32) + lane / 4, cq = 2 * (lane % 4);
  const int row_m0 = (mt_own / g.cb) * g.c;  // row of channel 0 of the tap
  float* out = ws + (int64_t)blockIdx.z * g.m * g.k;
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
    const int kc = k0 + 8 * j + cq;
    if (kc >= g.k) continue;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int c = tap.c0 + r0 + 8 * h;
      if (c < g.c)
        *reinterpret_cast<float2*>(out + (int64_t)(row_m0 + c) * g.k + kc) =
            make_float2(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
    }
  }
}

// x (contiguous NHWC bf16) as s * s parity-plane maps and dy (contiguous
// NHWC bf16) as one, all in boxes of (64, bw, bh, bi)
int encode_maps(Maps* m, const void* x, const void* dy, int n, int h, int w,
                int c, int oh, int ow, int k, int s, int bw, int bh, int bi) {
  const uint32_t box[4] = {64, (uint32_t)bw, (uint32_t)bh, (uint32_t)bi};
  for (int hp = 0; hp < s; ++hp)
    for (int wp = 0; wp < s; ++wp) {
      const uint64_t dims[4] = {(uint64_t)c, (uint64_t)((w - wp + s - 1) / s),
                                (uint64_t)((h - hp + s - 1) / s),
                                (uint64_t)n};
      const uint64_t st[3] = {(uint64_t)s * c * 2, (uint64_t)s * w * c * 2,
                              (uint64_t)h * w * c * 2};
      const void* at = static_cast<const __nv_bfloat16*>(x) +
                       ((int64_t)hp * w + wp) * c;
      const int err = hopper::encode_bf16_4d_box(&m->x[hp * s + wp], at, dims,
                                                 st, box);
      if (err != 0) return err;
    }
  const uint64_t dims[4] = {(uint64_t)k, (uint64_t)ow, (uint64_t)oh,
                            (uint64_t)n};
  const uint64_t st[3] = {(uint64_t)k * 2, (uint64_t)ow * k * 2,
                          (uint64_t)oh * ow * k * 2};
  return hopper::encode_bf16_4d_box(&m->dy, dy, dims, st, box);
}

template <int BN>
int launch(const Maps& maps, float* ws, const Geom& g, int splits,
           cudaStream_t stream) {
  const int smem = Layout<BN>::BYTES;
  cudaError_t e = cudaFuncSetAttribute(
      conv_wgrad_wgmma_kernel<BN>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((g.mt + 1) / 2, (g.k + BN - 1) / BN, splits);
  conv_wgrad_wgmma_kernel<BN><<<grid, THREADS, smem, stream>>>(maps, ws, g);
  return (int)cudaGetLastError();
}

}  // namespace wg

// --- f32: register tiles + cp.async ----------------------------------------------
namespace rt {

constexpr int BM = 128;     // rows of M a block owns
constexpr int BL = 16;      // rows of L per stage
constexpr int STAGES = 3;

template <int BN, bool TAP>
struct Cfg {
  static constexpr int THREADS = 2 * BN;      // (BM / 8) x (BN / 8)
  static constexpr int TN = BN / 8;           // threads along K
  static constexpr int LDA = BM + 4, LDB = BN + 4;
  static constexpr int COLS = THREADS / 16;   // columns one staging pass
  static constexpr int A_PER = BM / COLS;     // x elements a thread stages
  static constexpr int B_PER = BN / COLS;     // dy elements a thread stages
  static constexpr int STAGE_FLOATS = BL * (LDA + LDB);
  static constexpr int BYTES = STAGES * STAGE_FLOATS * 4;
  // the one-tap body keeps 3 index registers, the other 2 for each staged
  // x element: only the first fits two 256-thread blocks an SM
  static constexpr int MIN_BLOCKS = BN == 64 ? (TAP ? 3 : 2) : (TAP ? 2 : 1);
};

struct Geom {
  int h, w, c, oh, ow, k, ksz, stride, pad;
  int l;      // N * OH * OW
  int m;      // ksz * ksz * C
  int chunk;  // rows of L per split, a multiple of BL
  int64_t sxn, sdn;
  int sxh, sxw, sxc, sdh, sdw, sdk;
};

// The f32 partial sum of block (m, k, z). TAP: C is a multiple of BM, so
// the block's 128 rows of M are channels of one tap and share its window
// shift: one bounds check a staged row, channel offsets by a stride.
template <int BN, bool TAP>
__device__ __forceinline__ void f32_body(const float* __restrict__ x,
                                         const float* __restrict__ dy,
                                         float* __restrict__ ws,
                                         const Geom& g) {
  using C = Cfg<BN, TAP>;
  extern __shared__ __align__(16) float smem[];
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int m0 = blockIdx.x * BM, k0 = blockIdx.y * BN;
  const int l_begin = blockIdx.z * g.chunk;
  const int l_end = min(l_begin + g.chunk, g.l);
  const int steps = (l_end - l_begin + BL - 1) / BL;

  // staging role: row r of each stage, columns col + COLS * j; eight
  // consecutive lanes take eight consecutive rows of one column
  const int r = (lane & 7) + 8 * (warp & 1);
  const int col = (lane >> 3) + 4 * (warp >> 1);
  // x: TAP keeps the tap's (kh, kw) and channel col's offset; else each
  // element's offset and (kh << 16 | kw), rows past M out of bounds
  constexpr int XN = TAP ? 1 : C::A_PER;
  int xo[XN], khw[XN];
#pragma unroll
  for (int j = 0; j < XN; ++j) {
    const int m = m0 + col + C::COLS * j;
    if (m < g.m) {
      const int tap = m / g.c, c = m - (m / g.c) * g.c;
      const int kh = tap / g.ksz, kw = tap - (tap / g.ksz) * g.ksz;
      xo[j] = kh * g.sxh + kw * g.sxw + c * g.sxc;
      khw[j] = (kh << 16) | kw;
    } else {
      xo[j] = 0;
      khw[j] = 0x7FFF << 16;
    }
  }
  const int xstep = C::COLS * g.sxc;
  // dy: column col's offset, the columns inside K as bits
  const int do0 = (k0 + col) * g.sdk, dstep = C::COLS * g.sdk;
  unsigned kok = 0;
#pragma unroll
  for (int j = 0; j < C::B_PER; ++j)
    kok |= (k0 + col + C::COLS * j < g.k ? 1u : 0u) << j;
  // (n, oh, ow) of the row this thread stages next
  int ln = l_begin + r;
  int nn = ln / (g.oh * g.ow);
  int oh = (ln - nn * g.oh * g.ow) / g.ow;
  int ow = ln - nn * g.oh * g.ow - oh * g.ow;

  auto stage = [&](int slot) {
    float* as = smem + slot * C::STAGE_FLOATS + r * C::LDA + col;
    float* bs = smem + slot * C::STAGE_FLOATS + BL * C::LDA + r * C::LDB + col;
    const bool lok = ln < l_end;
    const int ih0 = oh * g.stride - g.pad, iw0 = ow * g.stride - g.pad;
    const float* xb = x + nn * g.sxn + (int64_t)ih0 * g.sxh +
                      (int64_t)iw0 * g.sxw;
    const float* db = dy + nn * g.sdn + (int64_t)oh * g.sdh +
                      (int64_t)ow * g.sdw + do0;
#pragma unroll
    for (int j = 0; j < C::A_PER; ++j) {
      const int q = TAP ? 0 : j;
      const int ih = ih0 + (khw[q] >> 16), iw = iw0 + (khw[q] & 0xFFFF);
      const bool ok = lok && (unsigned)ih < (unsigned)g.h &&
                      (unsigned)iw < (unsigned)g.w;
      const float* src = TAP ? xb + xo[0] + j * xstep : xb + xo[j];
      hopper::cp_async4(as + C::COLS * j, ok ? src : x, ok);
    }
#pragma unroll
    for (int j = 0; j < C::B_PER; ++j) {
      const bool ok = lok && ((kok >> j) & 1u);
      hopper::cp_async4(bs + C::COLS * j, ok ? db + j * dstep : dy, ok);
    }
    ln += BL;
    ow += BL;
    while (ow >= g.ow) {
      ow -= g.ow;
      if (++oh == g.oh) {
        oh = 0;
        ++nn;
      }
    }
  };

  // compute role: rows 4 tm .. and 64 + 4 tm .., columns 4 tn .. and
  // BN / 2 + 4 tn ..
  const int tm = tid / C::TN, tn = tid % C::TN;
  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < steps) stage(s);
    hopper::cp_async_commit();
  }
  for (int it = 0; it < steps; ++it) {
    hopper::cp_async_wait<STAGES - 2>();
    __syncthreads();  // tile it landed; everyone is done with tile it - 1
    if (it + STAGES - 1 < steps) stage((it + STAGES - 1) % STAGES);
    hopper::cp_async_commit();
    const float* as = smem + (it % STAGES) * C::STAGE_FLOATS;
    const float* bs = as + BL * C::LDA;
#pragma unroll
    for (int i = 0; i < BL; ++i) {
      const float4 a0 = *reinterpret_cast<const float4*>(as + i * C::LDA +
                                                         4 * tm);
      const float4 a1 = *reinterpret_cast<const float4*>(as + i * C::LDA +
                                                         64 + 4 * tm);
      const float4 b0 = *reinterpret_cast<const float4*>(bs + i * C::LDB +
                                                         4 * tn);
      const float4 b1 = *reinterpret_cast<const float4*>(bs + i * C::LDB +
                                                         BN / 2 + 4 * tn);
      const float av[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int ii = 0; ii < 8; ++ii)
#pragma unroll
        for (int jj = 0; jj < 8; ++jj)
          acc[ii][jj] = fmaf(av[ii], bv[jj], acc[ii][jj]);
    }
  }
  hopper::cp_async_wait<0>();

  float* out = ws + (int64_t)blockIdx.z * g.m * g.k;
#pragma unroll
  for (int ii = 0; ii < 8; ++ii) {
    const int m = m0 + 4 * tm + (ii & 3) + (ii >> 2) * 64;
    if (m >= g.m) continue;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int k = k0 + 4 * tn + half * (BN / 2);
      float* o = out + (int64_t)m * g.k + k;
      const float* v = &acc[ii][4 * half];
      if ((g.k & 3) == 0) {
        if (k < g.k)
          *reinterpret_cast<float4*>(o) = make_float4(v[0], v[1], v[2], v[3]);
      } else {
#pragma unroll
        for (int q = 0; q < 4; ++q)
          if (k + q < g.k) o[q] = v[q];
      }
    }
  }
}

template <int BN>
__global__ void __launch_bounds__(Cfg<BN, false>::THREADS,
                                  Cfg<BN, false>::MIN_BLOCKS)
conv_wgrad_f32_kernel(const float* __restrict__ x,
                      const float* __restrict__ dy, float* __restrict__ ws,
                      Geom g) {
  f32_body<BN, false>(x, dy, ws, g);
}

template <int BN>
__global__ void __launch_bounds__(Cfg<BN, true>::THREADS,
                                  Cfg<BN, true>::MIN_BLOCKS)
conv_wgrad_f32tap_kernel(const float* __restrict__ x,
                         const float* __restrict__ dy, float* __restrict__ ws,
                         Geom g) {
  f32_body<BN, true>(x, dy, ws, g);
}

template <int BN, bool TAP>
int launch(const float* x, const float* dy, float* ws, const Geom& g,
           int splits, cudaStream_t stream) {
  using C = Cfg<BN, TAP>;
  auto kernel = TAP ? conv_wgrad_f32tap_kernel<BN> : conv_wgrad_f32_kernel<BN>;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, C::BYTES);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((g.m + BM - 1) / BM, (g.k + BN - 1) / BN, splits);
  kernel<<<grid, C::THREADS, C::BYTES, stream>>>(x, dy, ws, g);
  return (int)cudaGetLastError();
}

}  // namespace rt

// --- bf16 off the TMA route: the simple SIMT form ----------------------------------
namespace simt {

constexpr int BM = 64;                   // output rows (kh, kw, c) per tile
constexpr int BN = 64;                   // output columns (k) per tile
constexpr int BL = 32;                   // rows of L staged per step
constexpr int THREADS = 256;
constexpr int LDS = BM + 4;              // shared row stride, 16-byte aligned
constexpr int COLS = BM * BL / THREADS;  // 8 columns each thread stages

struct Geom {
  int h, w, c, oh, ow, k, ksz, stride, pad;
  int l;      // N * OH * OW
  int m;      // ksz * ksz * C
  int chunk;  // rows of L per split, a multiple of BL
  int64_t sxn, sxh, sxw, sxc, sdn, sdh, sdw, sdk;
};

__global__ void __launch_bounds__(THREADS)
conv_wgrad_simt_kernel(const __nv_bfloat16* __restrict__ x,
                       const __nv_bfloat16* __restrict__ dy,
                       float* __restrict__ ws, Geom g) {
  __shared__ __align__(16) float sx[BL][LDS];
  __shared__ __align__(16) float sd[BL][LDS];
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int m0 = blockIdx.x * BM, k0 = blockIdx.y * BN;
  const int l_begin = blockIdx.z * g.chunk;
  const int l_end = min(l_begin + g.chunk, g.l);

  // staging role: row r of each step, columns col + 8*j; eight consecutive
  // lanes take eight consecutive rows of one column, and rows 68 floats
  // apart keep the stores free of bank conflicts
  const int r = (lane & 7) + 8 * (warp & 3);
  const int col = (lane >> 3) + 4 * (warp >> 2);
  int kh[COLS], kw[COLS];
  int64_t xoff[COLS], doff[COLS];
  bool mok[COLS], kok[COLS];
#pragma unroll
  for (int j = 0; j < COLS; ++j) {
    const int m = m0 + col + 8 * j;
    mok[j] = m < g.m;
    const int tap = mok[j] ? m / g.c : 0;
    const int c = mok[j] ? m - tap * g.c : 0;
    kh[j] = tap / g.ksz;
    kw[j] = tap - kh[j] * g.ksz;
    xoff[j] = kh[j] * g.sxh + kw[j] * g.sxw + c * g.sxc;
    const int k = k0 + col + 8 * j;
    kok[j] = k < g.k;
    doff[j] = kok[j] ? k * g.sdk : 0;
  }

  // compute role: rows tm*4.., columns tn*4.. of the tile
  const int tm = tid >> 4, tn = tid & 15;
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  const int ohw = g.oh * g.ow;
  for (int l0 = l_begin; l0 < l_end; l0 += BL) {
    const int l = l0 + r;
    const bool lok = l < l_end;
    int n = 0, oh = 0, ow = 0;
    if (lok) {
      n = l / ohw;
      const int rem = l - n * ohw;
      oh = rem / g.ow;
      ow = rem - oh * g.ow;
    }
    const int ih0 = oh * g.stride - g.pad, iw0 = ow * g.stride - g.pad;
    const __nv_bfloat16* xb = x + n * g.sxn + ih0 * g.sxh + iw0 * g.sxw;
    const __nv_bfloat16* db = dy + n * g.sdn + oh * g.sdh + ow * g.sdw;
#pragma unroll
    for (int j = 0; j < COLS; ++j) {
      const int ih = ih0 + kh[j], iw = iw0 + kw[j];
      float v = 0.f;
      if (lok && mok[j] && ih >= 0 && ih < g.h && iw >= 0 && iw < g.w)
        v = __bfloat162float(xb[xoff[j]]);
      sx[r][col + 8 * j] = v;
      sd[r][col + 8 * j] =
          (lok && kok[j]) ? __bfloat162float(db[doff[j]]) : 0.f;
    }
    __syncthreads();
#pragma unroll 8
    for (int i = 0; i < BL; ++i) {
      const float4 a = *reinterpret_cast<const float4*>(&sx[i][tm * 4]);
      const float4 b = *reinterpret_cast<const float4*>(&sd[i][tn * 4]);
      const float av[4] = {a.x, a.y, a.z, a.w};
      const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
      for (int ii = 0; ii < 4; ++ii)
#pragma unroll
        for (int jj = 0; jj < 4; ++jj)
          acc[ii][jj] = fmaf(av[ii], bv[jj], acc[ii][jj]);
    }
    __syncthreads();
  }

  float* out = ws + (int64_t)blockIdx.z * g.m * g.k;
#pragma unroll
  for (int ii = 0; ii < 4; ++ii) {
    const int m = m0 + tm * 4 + ii;
    if (m >= g.m) continue;
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) {
      const int k = k0 + tn * 4 + jj;
      if (k < g.k) out[(int64_t)m * g.k + k] = acc[ii][jj];
    }
  }
}

}  // namespace simt

// --- the wgmma route's repack: (N, H, W, C) by strides -> NHWC bf16 ------------
namespace rp {

constexpr int TILE = 64;      // 64 positions (h, w) x 64 channels a block
constexpr int THREADS = 256;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// Two consecutive elements of T as one aligned load.
template <typename T> struct Pair;
template <> struct Pair<float> { using type = float2; };
template <> struct Pair<__nv_bfloat16> { using type = __nv_bfloat162; };
__device__ __forceinline__ float2 to_f32x2(float2 v) { return v; }
__device__ __forceinline__ float2 to_f32x2(__nv_bfloat162 v) {
  return __bfloat1622float2(v);
}

// Block (p, c, n) moves positions p * 64 .. and channels c * 64 .. of image
// n through a shared tile: it reads along the positions (contiguous in the
// NCHW views the op passes) and writes along the channels (contiguous in
// NHWC), the cast to bf16 on the way; the tile's rows are 65 floats, so
// its columns are read with at most two-way bank conflicts. PAIRS: every
// channel plane is contiguous (position p at offset p) and starts on a
// pair boundary, H * W is even: each thread reads two positions and
// writes two channels (as bf16x2) at a time, halving the memory
// instructions; else one element a time through any strides.
template <typename T, bool PAIRS>
__global__ void __launch_bounds__(THREADS)
conv_wgrad_repack_kernel(const T* __restrict__ src,
                         __nv_bfloat16* __restrict__ dst, int h, int w,
                         int c, int64_t sn, int64_t sh, int64_t sw,
                         int64_t sc) {
  __shared__ float tile[TILE][TILE + 1];  // [channel][position]
  const int hw = h * w;
  const int p0 = blockIdx.x * TILE, c0 = blockIdx.y * TILE;
  const int64_t n = blockIdx.z;
  const int t = threadIdx.x;
  if constexpr (PAIRS) {
    // read: positions p0 + 2 (t % 32) and + 1 of channels c0 + t / 32 + 8 j
    const int q = 2 * (t % 32), r = t / 32;
    const bool pok = p0 + q < hw;
    const T* from = src + n * sn + (int64_t)(c0 + r) * sc + p0 + q;
#pragma unroll
    for (int j = 0; j < TILE / 8; ++j) {
      float2 v = make_float2(0.f, 0.f);
      if (pok && c0 + r + 8 * j < c)
        v = to_f32x2(*reinterpret_cast<const typename Pair<T>::type*>(
            from + 8 * j * sc));
      tile[r + 8 * j][q] = v.x;
      tile[r + 8 * j][q + 1] = v.y;
    }
    __syncthreads();
    // write: channels c0 + 2 (t % 32) and + 1 at positions p0 + t / 32 + 8 j
    __nv_bfloat16* to = dst + (n * hw + p0 + r) * c + c0 + q;
#pragma unroll
    for (int j = 0; j < TILE / 8; ++j)
      if (p0 + r + 8 * j < hw && c0 + q < c)
        *reinterpret_cast<__nv_bfloat162*>(to + (int64_t)8 * j * c) =
            __floats2bfloat162_rn(tile[q][r + 8 * j], tile[q + 1][r + 8 * j]);
  } else {
    // read: position p0 + t % 64 of channels c0 + t / 64 + 4 j
    const int x = t % TILE, y = t / TILE;
    const int p = p0 + x;
    const int ph = p / w, pw = p - (p / w) * w;
    const T* from = src + n * sn + ph * sh + pw * sw + (int64_t)(c0 + y) * sc;
#pragma unroll 4
    for (int j = 0; j < TILE / 4; ++j)
      tile[y + 4 * j][x] = (p < hw && c0 + y + 4 * j < c)
                               ? to_f32(from[4 * j * sc]) : 0.f;
    __syncthreads();
    __nv_bfloat16* to = dst + (n * hw + p0 + y) * c + c0 + x;
#pragma unroll 4
    for (int j = 0; j < TILE / 4; ++j)
      if (p0 + y + 4 * j < hw && c0 + x < c)
        to[(int64_t)4 * j * c] = __float2bfloat16(tile[x][y + 4 * j]);
  }
}

template <typename T>
void launch(const T* src, __nv_bfloat16* dst, int n, int h, int w, int c,
            int64_t sn, int64_t sh, int64_t sw, int64_t sc,
            cudaStream_t stream) {
  const dim3 grid((unsigned)(((int64_t)h * w + TILE - 1) / TILE),
                  (unsigned)((c + TILE - 1) / TILE), (unsigned)n);
  const bool pairs = sw == 1 && sh == w && sc % 2 == 0 && sn % 2 == 0 &&
                     (int64_t)h * w % 2 == 0 && c % 2 == 0 &&
                     reinterpret_cast<uintptr_t>(src) % (2 * sizeof(T)) == 0;
  if (pairs)
    conv_wgrad_repack_kernel<T, true><<<grid, THREADS, 0, stream>>>(
        src, dst, h, w, c, sn, sh, sw, sc);
  else
    conv_wgrad_repack_kernel<T, false><<<grid, THREADS, 0, stream>>>(
        src, dst, h, w, c, sn, sh, sw, sc);
}

}  // namespace rp

// out[i] = sum of ws[s][i] over s = 0..splits-1, in that order
__global__ void __launch_bounds__(256)
conv_wgrad_reduce_kernel(const float* __restrict__ ws, float* __restrict__ out,
                         int64_t mk, int splits) {
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < mk;
       i += (int64_t)gridDim.x * blockDim.x) {
    float s = 0.f;
    for (int p = 0; p < splits; ++p) s += ws[p * mk + i];
    out[i] = s;
  }
}

bool dims_ok(int n, int h, int w, int c, int oh, int ow, int k, int ksz,
             int stride, int pad, int splits) {
  return n >= 1 && h >= 1 && w >= 1 && c >= 1 && oh >= 1 && ow >= 1 &&
         k >= 1 && ksz >= 1 && stride >= 1 && pad >= 0 && splits >= 1 &&
         splits <= 65535 && (int64_t)n * oh * ow <= INT32_MAX &&
         (int64_t)ksz * ksz * c <= INT32_MAX;
}

}  // namespace

extern "C" {

// The partial kernel of the f32 route: x (N, H, W, C) and dy (N, OH, OW, K)
// f32 by element strides (each tensor's span below 2^31 elements, and H, W
// below 2^15) -> ws, contiguous f32 (splits, M, K). bn: 64 or 128 columns of
// K a block; tap: 1 runs conv_wgrad_f32tap_kernel (C a multiple of 128),
// 0 conv_wgrad_f32_kernel; chunk: rows of L per split, a multiple of 16,
// splits * chunk >= L. Returns a cudaError_t.
int mxtt_conv_wgrad_f32(const float* x, const float* dy, float* ws, int n,
                        int h, int w, int c, int oh, int ow, int k, int ksz,
                        int stride, int pad, int bn, int tap, int splits,
                        int chunk,
                        int64_t sxn, int64_t sxh, int64_t sxw, int64_t sxc,
                        int64_t sdn, int64_t sdh, int64_t sdw, int64_t sdk,
                        void* stream) {
  const int64_t l = (int64_t)n * oh * ow;
  const int64_t big = INT32_MAX;
  if (!dims_ok(n, h, w, c, oh, ow, k, ksz, stride, pad, splits) ||
      (bn != 64 && bn != 128) || (tap && c % rt::BM) || chunk < rt::BL ||
      chunk % rt::BL ||
      (int64_t)splits * chunk < l || h >= (1 << 15) || w >= (1 << 15) ||
      ksz >= (1 << 15) || sxh > big || sxw > big || sxc > big || sdh > big ||
      sdw > big || sdk > big || (int64_t)ksz * sxh + ksz * sxw + c * sxc > big ||
      (int64_t)k * sdk > big || (k + bn - 1) / bn > 65535)
    return (int)cudaErrorInvalidValue;
  rt::Geom g{h, w, c, oh, ow, k, ksz, stride, pad, (int)l, ksz * ksz * c,
             chunk, sxn, sdn, (int)sxh, (int)sxw, (int)sxc, (int)sdh,
             (int)sdw, (int)sdk};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (tap)
    return bn == 128 ? rt::launch<128, true>(x, dy, ws, g, splits, s)
                     : rt::launch<64, true>(x, dy, ws, g, splits, s);
  return bn == 128 ? rt::launch<128, false>(x, dy, ws, g, splits, s)
                   : rt::launch<64, false>(x, dy, ws, g, splits, s);
}

// The partial kernel of the bf16 TMA route: x (N, H, W, C) and dy
// (N, OH, OW, K) contiguous NHWC bf16, 16-byte aligned, C and K multiples
// of 8, stride 1 or 2 (H, W >= stride) -> ws, contiguous f32 (splits, M, K).
// bn: 64 or 128; (bw, bh, bi): an L tile's box along OW, OH, N, of 64
// rows; chunk: L tiles per split, splits * chunk >= the L tiles. Returns a
// cudaError_t.
int mxtt_conv_wgrad_wgmma(const void* x, const void* dy, float* ws, int n,
                          int h, int w, int c, int oh, int ow, int k, int ksz,
                          int stride, int pad, int bn, int bw, int bh, int bi,
                          int splits, int chunk, void* stream) {
  if (!dims_ok(n, h, w, c, oh, ow, k, ksz, stride, pad, splits) ||
      (bn != 64 && bn != 128) || c % 8 || k % 8 || stride > 2 ||
      h < stride || w < stride || bw < 1 || bh < 1 || bi < 1 || bw > 256 ||
      bh > 256 || bi > 256 || bw * bh * bi != wg::BL || chunk < 1 ||
      reinterpret_cast<uintptr_t>(x) % 16 ||
      reinterpret_cast<uintptr_t>(dy) % 16)
    return (int)cudaErrorInvalidValue;
  wg::Geom g;
  g.c = c;
  g.k = k;
  g.ksz = ksz;
  g.stride = stride;
  g.pad = pad;
  g.cb = (c + 63) / 64;
  g.m = ksz * ksz * c;
  g.mt = ksz * ksz * g.cb;
  g.wb = (ow + bw - 1) / bw;
  g.hb = (oh + bh - 1) / bh;
  g.bw = bw;
  g.bh = bh;
  g.bi = bi;
  const int64_t lt = (int64_t)((n + bi - 1) / bi) * g.hb * g.wb;
  if (lt > INT32_MAX || (int64_t)splits * chunk < lt ||
      (k + bn - 1) / bn > 65535 || (g.mt + 1) / 2 > INT32_MAX)
    return (int)cudaErrorInvalidValue;
  g.lt = (int)lt;
  g.chunk = chunk;
  wg::Maps maps;
  const int err = wg::encode_maps(&maps, x, dy, n, h, w, c, oh, ow, k, stride,
                                  bw, bh, bi);
  if (err != 0) return err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return bn == 128 ? wg::launch<128>(maps, ws, g, splits, s)
                   : wg::launch<64>(maps, ws, g, splits, s);
}

// The partial kernel of bf16 off the TMA route: x and dy bf16 by element
// strides -> ws, contiguous f32 (splits, M, K); chunk: rows of L per split,
// a multiple of 32. Returns a cudaError_t.
int mxtt_conv_wgrad_simt(const void* x, const void* dy, float* ws, int n,
                         int h, int w, int c, int oh, int ow, int k, int ksz,
                         int stride, int pad, int splits, int chunk,
                         int64_t sxn, int64_t sxh, int64_t sxw, int64_t sxc,
                         int64_t sdn, int64_t sdh, int64_t sdw, int64_t sdk,
                         void* stream) {
  const int64_t l = (int64_t)n * oh * ow;
  const int64_t m = (int64_t)ksz * ksz * c;
  if (!dims_ok(n, h, w, c, oh, ow, k, ksz, stride, pad, splits) ||
      chunk < simt::BL || chunk % simt::BL || (int64_t)splits * chunk < l ||
      (m + simt::BM - 1) / simt::BM > INT32_MAX ||
      (k + simt::BN - 1) / simt::BN > 65535)
    return (int)cudaErrorInvalidValue;
  simt::Geom g{h, w, c, oh, ow, k, ksz, stride, pad, (int)l, (int)m, chunk,
               sxn, sxh, sxw, sxc, sdn, sdh, sdw, sdk};
  const dim3 grid((unsigned)((m + simt::BM - 1) / simt::BM),
                  (unsigned)((k + simt::BN - 1) / simt::BN), (unsigned)splits);
  simt::conv_wgrad_simt_kernel<<<grid, simt::THREADS, 0,
                                 static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(x),
      static_cast<const __nv_bfloat16*>(dy), ws, g);
  return (int)cudaGetLastError();
}

// The wgmma route's repack: src (N, H, W, C) f32 (dtype 0) or bf16 (1) by
// element strides -> dst, contiguous NHWC bf16. Returns a cudaError_t.
int mxtt_conv_wgrad_repack(const void* src, void* dst, int dtype, int n,
                           int h, int w, int c, int64_t sn, int64_t sh,
                           int64_t sw, int64_t sc, void* stream) {
  if (n < 1 || n > 65535 || h < 1 || w < 1 || c < 1 ||
      (int64_t)h * w > INT32_MAX || (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto* out = static_cast<__nv_bfloat16*>(dst);
  if (dtype == 0)
    rp::launch(static_cast<const float*>(src), out, n, h, w, c, sn, sh, sw,
               sc, s);
  else
    rp::launch(static_cast<const __nv_bfloat16*>(src), out, n, h, w, c, sn,
               sh, sw, sc, s);
  return (int)cudaGetLastError();
}

// out (mk f32) = the sum of the `splits` slices of ws in order. Returns a
// cudaError_t.
int mxtt_conv_wgrad_reduce(const float* ws, float* out, int64_t mk,
                           int splits, void* stream) {
  if (mk < 1 || splits < 1) return (int)cudaErrorInvalidValue;
  const int64_t want = (mk + 255) / 256;
  const int blocks = (int)(want < 132 * 8 ? want : 132 * 8);
  conv_wgrad_reduce_kernel<<<blocks, 256, 0,
                             static_cast<cudaStream_t>(stream)>>>(ws, out, mk,
                                                                  splits);
  return (int)cudaGetLastError();
}

// Dynamic shared memory of a partial kernel: route 0 f32, 1 wgmma; bn 64
// or 128.
int mxtt_conv_wgrad_smem(int route, int bn) {
  if (route == 0)
    return bn == 128 ? rt::Cfg<128, false>::BYTES : rt::Cfg<64, false>::BYTES;
  return bn == 128 ? wg::Layout<128>::BYTES : wg::Layout<64>::BYTES;
}

}  // extern "C"
