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
// runs in f32 and tanh(c') reads the f32 c', as in the Pallas kernel.
// Every input is read through its (row, column) element strides, so the
// fused RNN op's operands pass as they come: Wh as a view into the packed
// parameter blob at any element offset (no alignment is assumed: the loads
// are scalar), h0 / c0 as broadcast views with stride 0. h' and c' go to
// rows of their own stride (h' straight into ys[t] of the scan's output).
//
// What bounds it on the card: at the LSTM LM's shape, N = 128, H = 512, one
// step is 2*N*4H*H = 268 MFLOP, 4.0 us on the f32 FMA units (67 TFLOP/s),
// against 6.3 MB read and written, 1.9 us at 3.35 TB/s: operations. At
// N = 8 the 4 MB of Wh dominate: bytes, 1.3 us. In bf16 both are bytes.
//
// What this design does about it: the first, simple SIMT form.
//  - One block owns whole hidden units: all four gate rows j, H+j, 2H+j,
//    3H+j of Wh for its BJ units, so the gate maths and the c/h update
//    finish in the block that summed them. No second pass, no grid-wide
//    sync, no atomics. (The Pallas kernel does the whole (N, 4H) product in
//    one VMEM pass; on Hopper that becomes a grid of these blocks.)
//  - A block is WARPS warps over 32 batch rows: lane = row, and each warp
//    takes UPW units, so a thread keeps 4 * UPW f32 sums in registers. Each
//    32-wide chunk of the H-long dot product is staged in shared memory:
//    the h tile (32 rows, a row stride of 36 floats, so a quarter-warp's
//    16-byte reads of eight rows hit all 32 banks once) and the Wh rows
//    (read by all lanes of a warp at once: a broadcast). Per 4 k a thread
//    does one 16-byte h read and 4 * UPW broadcast Wh reads for 16 * UPW
//    FMAs.
//  - Tiles: the wrapper takes the first (UPW, WARPS) of (4, 4), (2, 4),
//    (1, 4), (1, 2), (1, 1) that puts at least 132 blocks (one per SM) in
//    flight, else the last: at H = 512 that is (2, 4) for N = 128 (4 row
//    tiles x 64 unit tiles = 256 blocks of 128 threads) and (1, 2) for
//    N = 8 (256 blocks of 64 threads, 24 of the 32 lanes idle: the step is
//    bound by reading Wh, which 256 blocks share out).
//  - Ragged N and H are masked: rows and units past the edge load zeros
//    and store nothing.
// Tensor cores (wgmma), TMA and keeping Wh resident across steps (a
// persistent kernel over the whole scan) are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int ROWS = 32;     // batch rows per block: one per lane
constexpr int BK = 32;       // k per staged chunk
constexpr int LDS = BK + 4;  // shared row stride (floats), 16-byte aligned

__device__ __forceinline__ float to_f32(float x) { return x; }
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
};

template <typename T, int UPW, int WARPS>
__global__ void __launch_bounds__(WARPS * 32)
lstm_step_kernel(Args a) {
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
    // stage h[r0 .. r0+32, k0 .. k0+32]
#pragma unroll 4
    for (int r = r_s; r < ROWS; r += RSTEP) {
      const int row = r0 + r;
      sh[r][kk_s] = (kok && row < a.n)
                        ? to_f32(h[row * a.h_r + k * a.h_c])
                        : 0.f;
    }
    // stage Wh rows g*H + j0 + u (gate g, unit u of the block)
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
    const float gi = acc[u][0] + to_f32(ib_row[(int64_t)j * a.ib_c]);
    const float gf = acc[u][1] + to_f32(ib_row[(int64_t)(H + j) * a.ib_c]);
    const float gg =
        acc[u][2] + to_f32(ib_row[(int64_t)(2 * H + j) * a.ib_c]);
    const float go =
        acc[u][3] + to_f32(ib_row[(int64_t)(3 * H + j) * a.ib_c]);
    const float c_prev = to_f32(c[row * a.c_r + j * a.c_c]);
    const float c_new = sigmoid(gf) * c_prev + sigmoid(gi) * tanhf(gg);
    store(c_out + j, c_new);
    store(h_out + j, sigmoid(go) * tanhf(c_new));
  }
}

template <typename T, int UPW, int WARPS>
void launch(const Args& a, cudaStream_t s) {
  constexpr int BJ = WARPS * UPW;
  dim3 grid((unsigned)((a.hidden + BJ - 1) / BJ),
            (unsigned)((a.n + ROWS - 1) / ROWS));
  lstm_step_kernel<T, UPW, WARPS><<<grid, WARPS * 32, 0, s>>>(a);
}

template <typename T>
int dispatch(const Args& a, int upw, int warps, cudaStream_t s) {
  if (upw == 4 && warps == 4) launch<T, 4, 4>(a, s);
  else if (upw == 2 && warps == 4) launch<T, 2, 4>(a, s);
  else if (upw == 1 && warps == 4) launch<T, 1, 4>(a, s);
  else if (upw == 1 && warps == 2) launch<T, 1, 2>(a, s);
  else if (upw == 1 && warps == 1) launch<T, 1, 1>(a, s);
  else return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// One step on `stream`. dtype: 0 float32, 1 bfloat16 (all six tensors
// alike). n, hidden >= 1; (upw, warps) one of (4, 4), (2, 4), (1, 4),
// (1, 2), (1, 1). Strides are in elements: ib (N, 4H), h, c (N, H) and
// wh (4H, H) by (row, column); h_out, c_out (N, H) by row, column stride 1.
// The outputs must not overlap the inputs. Returns a cudaError_t.
int mxtt_lstm_step(const void* ib, const void* h, const void* c,
                   const void* wh, void* h_out, void* c_out, int dtype,
                   int n, int hidden, int64_t ib_r, int64_t ib_c,
                   int64_t h_r, int64_t h_c, int64_t c_r, int64_t c_c,
                   int64_t wh_r, int64_t wh_c, int64_t ho_r, int64_t co_r,
                   int upw, int warps, void* stream) {
  if ((dtype != 0 && dtype != 1) || n < 1 || hidden < 1 ||
      (n + ROWS - 1) / ROWS > 65535 || (int64_t)4 * hidden > INT32_MAX)
    return (int)cudaErrorInvalidValue;
  Args a{ib,   h,    c,    wh,   h_out, c_out, n,    hidden, ib_r,
         ib_c, h_r,  h_c,  c_r,  c_c,   wh_r,  wh_c, ho_r,   co_r};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return dispatch<float>(a, upw, warps, s);
  return dispatch<__nv_bfloat16>(a, upw, warps, s);
}

}  // extern "C"
