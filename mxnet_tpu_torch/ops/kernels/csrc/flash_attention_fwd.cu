// Flash-attention forward for Hopper (sm_90a), plain C interface for ctypes.
//
// Replaces: mxnet_tpu/ops/pallas/flash_attention.py `_fa_forward` (:259) and
// its Pallas kernels `_fa_kernel_res` (:90) and `_fa_kernel_stream` (:152).
// Semantics follow `flash_attention()` (:881): O = softmax(scale * Q K^T) V
// with an optional causal mask aligned at tk - tq, grouped-query heads read
// by index (q head h uses kv head h / (H / Hkv)), online softmax with an f32
// running max and sum, f32 accumulation, optional per-row logsumexp (f32).
//
// What bounds it on the card: at the serving path's largest prefill
// (T = 2048, H = 16, D = 128, causal) one call does ~17 GFLOP against ~42 MB
// of q/k/v/o, so it is compute-bound (17 us on bf16 tensor cores, ~260 us at
// the 67 TFLOP/s f32 rate without them, 13 us for the bytes).
//
// What this design does about it: the first, simple form. It keeps the
// (Tq, Tk) score matrix out of device memory — each block owns one
// 64-row query tile of one (batch, head), streams 64-key K/V tiles through
// shared memory, and holds the softmax state and the output accumulator in
// registers — and skips every tile right of the causal diagonal, which
// halves the work at tq == tk. The products run on the f32 FMA units (no
// mma.sync / wgmma) with about one shared-memory load per FMA, so this
// form is far from the bound: 3.1 ms at the shape above on an H100 SXM
// (700 W), timed by chip_smoke.py (PERF.md). Tensor cores, TMA and sharing
// K/V tiles across a GQA group are later work. Ragged Tq/Tk tails are
// masked in the kernel, so every length runs.
// The TPU kernel's resident/streaming split is a VMEM artifact and has no
// counterpart here: nothing in shared memory scales with the sequence.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <float.h>
#include <stdint.h>

namespace {

constexpr int BQ = 64;                 // query rows per block
constexpr int BK = 64;                 // keys per shared-memory tile
constexpr int TPR = 4;                 // threads per query row
constexpr int THREADS = BQ * TPR;      // 256
constexpr int PLD = BK + TPR;          // P row stride: rows in distinct banks
constexpr float NEG = -FLT_MAX;        // finfo(float32).min, the mask value

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

template <int D>
constexpr size_t smem_bytes() {
  // Q, K, V tiles at row stride D + 1 (a row per bank) and the P tile
  return sizeof(float) * (size_t)(3 * BQ * (D + 1) + BQ * PLD);
}

// Thread t owns query row t / TPR of the tile and, within it, the score
// columns and output columns congruent to t % TPR (interleaved, so the
// TPR threads of a row hit neighbouring banks).
template <typename T, int D>
__global__ void __launch_bounds__(THREADS)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o,
                 float* __restrict__ lse, int H, int G, int Tq, int Tk,
                 int64_t q_sb, int64_t q_sh, int64_t q_st,
                 int64_t k_sb, int64_t k_sh, int64_t k_st,
                 int64_t v_sb, int64_t v_sh, int64_t v_st,
                 float scale, int causal) {
  constexpr int LD = D + 1;
  constexpr int SC = BK / TPR;         // score columns per thread
  constexpr int OC = D / TPR;          // output columns per thread
  extern __shared__ float smem[];
  float* Qs = smem;                    // BQ x LD, pre-scaled
  float* Ks = Qs + BQ * LD;            // BK x LD
  float* Vs = Ks + BK * LD;            // BK x LD
  float* Ps = Vs + BK * LD;            // BQ x PLD

  const int tid = threadIdx.x;
  const int row = tid / TPR;
  const int part = tid % TPR;
  const int bh = blockIdx.y;
  const int b = bh / H;
  const int h = bh % H;
  const int hk = h / G;
  const int q0 = blockIdx.x * BQ;
  const int offset = Tk - Tq;
  const int qpos = q0 + row + offset;  // this row's position on the key axis

  const T* qp = q + b * q_sb + h * q_sh;
  const T* kp = k + b * k_sb + hk * k_sh;
  const T* vp = v + b * v_sb + hk * v_sh;

  for (int i = tid; i < BQ * D; i += THREADS) {
    const int r = i / D, c = i % D;
    const int t = q0 + r;
    Qs[r * LD + c] = t < Tq ? to_f32(qp[t * q_st + c]) * scale : 0.f;
  }

  int n_tiles = (Tk + BK - 1) / BK;
  if (causal) {
    // tiles right of the last row's diagonal contribute nothing
    const int q_last = min(q0 + BQ, Tq) - 1;
    n_tiles = min(n_tiles, (q_last + offset) / BK + 1);
  }

  float acc[OC];
#pragma unroll
  for (int e = 0; e < OC; ++e) acc[e] = 0.f;
  float m = NEG, l = 0.f;
  float* prow = Ps + row * PLD;
  const float* qrow = Qs + row * LD;

  for (int tile = 0; tile < n_tiles; ++tile) {
    const int k0 = tile * BK;
    __syncthreads();  // the previous tile's readers are done
    for (int i = tid; i < BK * D; i += THREADS) {
      const int r = i / D, c = i % D;
      const int t = k0 + r;
      const bool ok = t < Tk;
      Ks[r * LD + c] = ok ? to_f32(kp[t * k_st + c]) : 0.f;
      Vs[r * LD + c] = ok ? to_f32(vp[t * v_st + c]) : 0.f;
    }
    __syncthreads();

    float s[SC];
#pragma unroll
    for (int j = 0; j < SC; ++j) s[j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      const float qd = qrow[d];
#pragma unroll
      for (int j = 0; j < SC; ++j) s[j] += qd * Ks[(j * TPR + part) * LD + d];
    }

    float mx = NEG;
#pragma unroll
    for (int j = 0; j < SC; ++j) {
      const int kpos = k0 + j * TPR + part;
      const bool valid = kpos < Tk && (!causal || kpos <= qpos);
      s[j] = valid ? s[j] : NEG;
      mx = fmaxf(mx, s[j]);
    }
#pragma unroll
    for (int w = 1; w < TPR; w <<= 1)
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, w));
    const float m_new = fmaxf(m, mx);
    const float alpha = expf(m - m_new);
    float sum = 0.f;
#pragma unroll
    for (int j = 0; j < SC; ++j) {
      const float p = expf(s[j] - m_new);
      sum += p;
      prow[j * TPR + part] = p;
    }
#pragma unroll
    for (int w = 1; w < TPR; w <<= 1)
      sum += __shfl_xor_sync(0xffffffffu, sum, w);
    l = l * alpha + sum;
    m = m_new;
    __syncwarp();  // the row's TPR threads share a warp

#pragma unroll
    for (int e = 0; e < OC; ++e) acc[e] *= alpha;
#pragma unroll 2
    for (int c = 0; c < BK; ++c) {
      const float p = prow[c];
      const float* vrow = Vs + c * LD;
#pragma unroll
      for (int e = 0; e < OC; ++e) acc[e] += p * vrow[e * TPR + part];
    }
  }

  const int t = q0 + row;
  if (t < Tq) {
    const float inv = 1.f / l;
    T* orow = o + ((int64_t)bh * Tq + t) * D;
#pragma unroll
    for (int e = 0; e < OC; ++e) store(orow + e * TPR + part, acc[e] * inv);
    if (lse != nullptr && part == 0) lse[(int64_t)bh * Tq + t] = m + logf(l);
  }
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, void* o, float* lse,
           int B, int H, int Hkv, int Tq, int Tk,
           int64_t q_sb, int64_t q_sh, int64_t q_st,
           int64_t k_sb, int64_t k_sh, int64_t k_st,
           int64_t v_sb, int64_t v_sh, int64_t v_st,
           float scale, int causal, cudaStream_t stream) {
  const size_t smem = smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((Tq + BQ - 1) / BQ, B * H);
  flash_fwd_kernel<T, D><<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), lse, H, H / Hkv, Tq, Tk,
      q_sb, q_sh, q_st, k_sb, k_sh, k_st, v_sb, v_sh, v_st, scale, causal);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// q: (B, H, Tq, D), k/v: (B, Hkv, Tk, D), each with unit stride on D and the
// given element strides for batch, head and sequence. o: contiguous
// (B, H, Tq, D) of the input type; lse: contiguous (B, H, Tq) f32 or null.
// dtype: 0 float32, 1 bfloat16. D: 64 or 128. Returns a cudaError_t.
int mxtt_flash_attention_fwd(const void* q, const void* k, const void* v,
                             void* o, float* lse, int dtype, int B, int H,
                             int Hkv, int Tq, int Tk, int D,
                             int64_t q_sb, int64_t q_sh, int64_t q_st,
                             int64_t k_sb, int64_t k_sh, int64_t k_st,
                             int64_t v_sb, int64_t v_sh, int64_t v_st,
                             float scale, int causal, void* stream) {
  if (B < 1 || H < 1 || Hkv < 1 || H % Hkv || Tq < 1 || Tk < 1 ||
      B * H > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define MXTT_FA_LAUNCH(T, DD)                                              \
  return launch<T, DD>(q, k, v, o, lse, B, H, Hkv, Tq, Tk, q_sb, q_sh,     \
                       q_st, k_sb, k_sh, k_st, v_sb, v_sh, v_st, scale,    \
                       causal, s)
  if (dtype == 0 && D == 64) MXTT_FA_LAUNCH(float, 64);
  if (dtype == 0 && D == 128) MXTT_FA_LAUNCH(float, 128);
  if (dtype == 1 && D == 64) MXTT_FA_LAUNCH(__nv_bfloat16, 64);
  if (dtype == 1 && D == 128) MXTT_FA_LAUNCH(__nv_bfloat16, 128);
#undef MXTT_FA_LAUNCH
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
