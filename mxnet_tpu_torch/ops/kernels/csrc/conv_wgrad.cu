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
// x is (N, H, W, C) and dy (N, OH, OW, K), each read through its four element
// strides, so the NCHW tensors of the op path pass as permute(0, 2, 3, 1)
// views without a copy. The result is f32 HWIO (ksz, ksz, C, K), contiguous:
// an (M = ksz*ksz*C) x K row-major matrix whose row m = (kh*ksz + kw)*C + c.
// Operands are f32 or bf16; products and sums run in f32.
//
// What bounds it on the card: operations. Every 3x3 convolution of
// ResNet-50 at batch 32 is 2*N*OH*OW*C*K*9 = 7.40 GFLOP (the stages trade
// spatial size for channels); on the f32 FMA units (67 TFLOP/s) that is
// 0.110 ms, while x and dy are 13-26 MB in f32, 8 us at 3.35 TB/s.
//
// What this design does about it: the first, simple SIMT form.
//  - The reduction L = N*OH*OW is long (1,568 to 100,352 at batch 32) and
//    the output small (9*64 x 64 at stage 1), so one block per output tile
//    would leave most SMs idle. The Pallas kernel sums image blocks along a
//    sequential grid axis; Hopper blocks run in no order, so the reduction is
//    split instead: block (mt, kt, s) of conv_wgrad_partial_kernel sums rows
//    [s*chunk, (s+1)*chunk) of L for one 64 x 64 output tile into slice s of
//    an f32 workspace (S, M, K), and conv_wgrad_reduce_kernel adds the S
//    slices in the order s = 0..S-1. No atomics, so the gradient repeats
//    bitwise. The wrapper picks S so that about four blocks per SM exist.
//  - Each step stages 32 rows of L: x (32 x 64 columns of m) and dy
//    (32 x 64 columns of k) into shared memory. Eight consecutive lanes take
//    eight consecutive rows of one column (32 contiguous bytes of the NCHW
//    views) and the rows are stored with a stride of 68 floats, so the
//    stores are free of bank conflicts and the reads stay 16-byte vectors.
//    The window's zero padding is a bounds check on the load: no padded copy.
//  - Each of the 256 threads accumulates a 4 x 4 micro-tile in registers
//    with f32 FMAs, from two 16-byte shared loads per 16 FMAs.
// Tensor cores (bf16 wgmma), TMA and larger tiles are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BM = 64;                   // output rows (kh, kw, c) per tile
constexpr int BN = 64;                   // output columns (k) per tile
constexpr int BL = 32;                   // rows of L staged per step
constexpr int THREADS = 256;
constexpr int LDS = BM + 4;              // shared row stride, 16-byte aligned
constexpr int COLS = BM * BL / THREADS;  // 8 columns each thread stages

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

struct Geom {
  int h, w, c, oh, ow, k, ksz, stride, pad;
  int l;      // N * OH * OW
  int m;      // ksz * ksz * C
  int chunk;  // rows of L per split, a multiple of BL
  int64_t sxn, sxh, sxw, sxc, sdn, sdh, sdw, sdk;
};

template <typename T>
__global__ void __launch_bounds__(THREADS)
conv_wgrad_partial_kernel(const T* __restrict__ x, const T* __restrict__ dy,
                          float* __restrict__ ws, Geom g) {
  __shared__ __align__(16) float sx[BL][LDS];
  __shared__ __align__(16) float sd[BL][LDS];
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int m0 = blockIdx.x * BM, k0 = blockIdx.y * BN;
  const int l_begin = blockIdx.z * g.chunk;
  const int l_end = min(l_begin + g.chunk, g.l);

  // staging role: row r of each step, columns col + 8*j
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
    const T* xb = x + n * g.sxn + ih0 * g.sxh + iw0 * g.sxw;
    const T* db = dy + n * g.sdn + oh * g.sdh + ow * g.sdw;
#pragma unroll
    for (int j = 0; j < COLS; ++j) {
      const int ih = ih0 + kh[j], iw = iw0 + kw[j];
      float v = 0.f;
      if (lok && mok[j] && ih >= 0 && ih < g.h && iw >= 0 && iw < g.w)
        v = to_f32(xb[xoff[j]]);
      sx[r][col + 8 * j] = v;
      sd[r][col + 8 * j] = (lok && kok[j]) ? to_f32(db[doff[j]]) : 0.f;
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

// out[i] = sum of ws[s][i] over s = 0..splits-1, in that order
__global__ void __launch_bounds__(THREADS)
conv_wgrad_reduce_kernel(const float* __restrict__ ws, float* __restrict__ out,
                         int64_t mk, int splits) {
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < mk;
       i += (int64_t)gridDim.x * blockDim.x) {
    float s = 0.f;
    for (int p = 0; p < splits; ++p) s += ws[p * mk + i];
    out[i] = s;
  }
}

}  // namespace

extern "C" {

// which: 0 launches conv_wgrad_partial_kernel (x, dy -> ws, `splits` slices
// of M x K), 1 conv_wgrad_reduce_kernel (ws -> out), each on `stream`; the
// caller launches both and counts each. x: (N, H, W, C) and dy: (N, OH, OW, K)
// by element strides; ws: contiguous f32 (splits, M, K); out: contiguous f32
// (ksz, ksz, C, K). chunk: rows of L = N*OH*OW per split, a multiple of 32,
// with splits * chunk >= L. dtype: 0 float32, 1 bfloat16 (x and dy alike).
// Returns a cudaError_t.
int mxtt_conv_wgrad(int which, const void* x, const void* dy, float* ws,
                    float* out, int dtype, int n, int h, int w, int c, int oh,
                    int ow, int k, int ksz, int stride, int pad, int splits,
                    int chunk, int64_t sxn, int64_t sxh, int64_t sxw,
                    int64_t sxc, int64_t sdn, int64_t sdh, int64_t sdw,
                    int64_t sdk, void* stream) {
  const int64_t l = (int64_t)n * oh * ow;
  const int64_t m = (int64_t)ksz * ksz * c;
  if ((which != 0 && which != 1) || (dtype != 0 && dtype != 1) || n < 1 ||
      h < 1 || w < 1 || c < 1 || oh < 1 || ow < 1 || k < 1 || ksz < 1 ||
      stride < 1 || pad < 0 || splits < 1 || splits > 65535 || chunk < BL ||
      chunk % BL || l > INT32_MAX || m > INT32_MAX ||
      (int64_t)splits * chunk < l || (m + BM - 1) / BM > INT32_MAX ||
      (k + BN - 1) / BN > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (which == 1) {
    const int64_t mk = m * k;
    const int64_t want = (mk + THREADS - 1) / THREADS;
    const int blocks = (int)(want < 132 * 8 ? want : 132 * 8);
    conv_wgrad_reduce_kernel<<<blocks, THREADS, 0, s>>>(ws, out, mk, splits);
    return (int)cudaGetLastError();
  }
  Geom g{h, w, c, oh, ow, k, ksz, stride, pad, (int)l, (int)m, chunk,
         sxn, sxh, sxw, sxc, sdn, sdh, sdw, sdk};
  dim3 grid((unsigned)((m + BM - 1) / BM), (unsigned)((k + BN - 1) / BN),
            (unsigned)splits);
  if (dtype == 0)
    conv_wgrad_partial_kernel<float><<<grid, THREADS, 0, s>>>(
        static_cast<const float*>(x), static_cast<const float*>(dy), ws, g);
  else
    conv_wgrad_partial_kernel<__nv_bfloat16><<<grid, THREADS, 0, s>>>(
        static_cast<const __nv_bfloat16*>(x),
        static_cast<const __nv_bfloat16*>(dy), ws, g);
  return (int)cudaGetLastError();
}

}  // extern "C"
