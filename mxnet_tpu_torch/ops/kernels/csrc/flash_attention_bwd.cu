// Flash-attention backward for Hopper (sm_90a), plain C interface for ctypes.
//
// Replaces: mxnet_tpu/ops/pallas/flash_attention.py `_fa_backward` (:618)
// and its Pallas kernels `_fa_bwd_dq_kernel_res` (:351) /
// `_fa_bwd_dq_kernel_stream` (:391) (here: flash_bwd_dq_kernel) and
// `_fa_bwd_dkv_kernel_res` (:461) / `_fa_bwd_dkv_kernel_stream` (:531)
// (here: flash_bwd_dkv_kernel). FlashAttention-2 math from the forward's
// saved per-row logsumexp and D = rowsum(dO * O), which the caller computes
// (as the reference does, :631): p = exp(scale * q.k - lse),
// dS = p * (dO.v - D), dQ = scale * dS K, dK = scale * dS^T Q, dV = p^T dO,
// dK/dV summed over the G query heads that share a kv head (GQA), all in
// f32 whatever the input type, each result cast once on its single store.
//
// What bounds it on the card: 10 * D flops per visible (query, key) pair and
// head (q.k recomputed, dO.v, and the three products into dQ, dK, dV). At
// the training shape (B 4, H 16, Hkv 4, T 2048, D 128, causal) that is
// ~172 GFLOP against ~168 MB of q/k/v/o/dO/dQ/dK/dV in bf16, so the card is
// compute-bound: ~0.17 ms on bf16 tensor cores, ~2.6 ms at the 67 TFLOP/s
// f32 rate without them; the bytes alone take ~0.05 ms.
//
// What this design does about it: the first, simple form, like the forward
// kernel. Neither kernel materializes the (Tq, Tk) score matrix in device
// memory; each streams 64-row tiles through shared memory (f32, one row per
// bank) and skips every tile on the masked side of the causal diagonal.
//  - flash_bwd_dq_kernel: one block per (batch, q head, 64-query tile),
//    looping over the key tiles left of the diagonal; dQ accumulates in f32
//    registers and is written once.
//  - flash_bwd_dkv_kernel: one block per (batch, kv head, 64-key tile),
//    looping over the G query heads of its group and the query tiles at or
//    below the diagonal; dK and dV accumulate in f32 registers and are
//    written once. This is the counterpart of the reference's accumulation
//    over the group in VMEM scratch; there are no atomics anywhere, so the
//    gradients are bitwise repeatable, and dQ needs a kernel of its own
//    rather than FA-2's atomic dQ.
// The products run on the f32 FMA units (no mma.sync / wgmma) with about one
// shared-memory load per FMA, so this form is far from the bound (PERF.md).
// Tensor cores, TMA and keeping K/V in registers are later work. Ragged
// Tq/Tk tails are masked in the kernels, so every length runs.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BQ = 64;                 // query rows per tile
constexpr int BK = 64;                 // key rows per tile
constexpr int TPR = 4;                 // threads per tile row
constexpr int THREADS = 64 * TPR;      // 256: one row of 64 per TPR threads
constexpr int PLD = 64 + TPR;          // P/dS row stride: rows in distinct banks

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

// Copy rows [t0, t0 + 64) of a (T, D) slice at row stride `st` into a
// 64 x (D + 1) f32 tile; rows past T read as zero.
template <typename T, int D>
__device__ __forceinline__ void load_tile(float* dst, const T* src,
                                          int64_t st, int t0, int T_len) {
  for (int i = threadIdx.x; i < 64 * D; i += THREADS) {
    const int r = i / D, c = i % D;
    const int t = t0 + r;
    dst[r * (D + 1) + c] = t < T_len ? to_f32(src[t * st + c]) : 0.f;
  }
}

template <int D>
constexpr size_t dq_smem_bytes() {
  // Q, dO, K, V tiles and the dS tile
  return sizeof(float) * (size_t)(4 * 64 * (D + 1) + BQ * PLD);
}

template <int D>
constexpr size_t dkv_smem_bytes() {
  // K, V, Q, dO tiles, the P and dS tiles, and the tile's lse and D
  return sizeof(float) * (size_t)(4 * 64 * (D + 1) + 2 * BK * PLD + 2 * BQ);
}

// Thread t owns tile row t / TPR and, within it, the columns congruent to
// t % TPR (interleaved, so the TPR threads of a row hit neighbouring banks).
template <typename T, int D>
__global__ void __launch_bounds__(THREADS)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const T* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ dvec, T* __restrict__ dq,
                    int H, int G, int Tq, int Tk,
                    int64_t q_sb, int64_t q_sh, int64_t q_st,
                    int64_t k_sb, int64_t k_sh, int64_t k_st,
                    int64_t v_sb, int64_t v_sh, int64_t v_st,
                    int64_t o_sb, int64_t o_sh, int64_t o_st,
                    float scale, int causal) {
  constexpr int LD = D + 1;
  constexpr int SC = BK / TPR;         // key columns per thread
  constexpr int OC = D / TPR;          // dQ columns per thread
  extern __shared__ float smem[];
  float* Qs = smem;                    // BQ x LD
  float* Os = Qs + BQ * LD;            // BQ x LD, dO
  float* Ks = Os + BQ * LD;            // BK x LD
  float* Vs = Ks + BK * LD;            // BK x LD
  float* Ss = Vs + BK * LD;            // BQ x PLD, dS

  const int tid = threadIdx.x;
  const int row = tid / TPR;
  const int part = tid % TPR;
  const int bh = blockIdx.y;
  const int b = bh / H;
  const int h = bh % H;
  const int hk = h / G;
  const int q0 = blockIdx.x * BQ;
  const int offset = Tk - Tq;
  const int t = q0 + row;
  const int qpos = t + offset;         // this row's position on the key axis

  const T* kp = k + b * k_sb + hk * k_sh;
  const T* vp = v + b * v_sb + hk * v_sh;
  load_tile<T, D>(Qs, q + b * q_sb + h * q_sh, q_st, q0, Tq);
  load_tile<T, D>(Os, dout + b * o_sb + h * o_sh, o_st, q0, Tq);
  const float lse_r = t < Tq ? lse[(int64_t)bh * Tq + t] : 0.f;
  const float d_r = t < Tq ? dvec[(int64_t)bh * Tq + t] : 0.f;

  int n_tiles = (Tk + BK - 1) / BK;
  if (causal) {
    // tiles right of the last row's diagonal contribute nothing
    const int q_last = min(q0 + BQ, Tq) - 1;
    n_tiles = min(n_tiles, (q_last + offset) / BK + 1);
  }

  float acc[OC];
#pragma unroll
  for (int e = 0; e < OC; ++e) acc[e] = 0.f;
  const float* qrow = Qs + row * LD;
  const float* orow = Os + row * LD;
  float* srow = Ss + row * PLD;

  for (int tile = 0; tile < n_tiles; ++tile) {
    const int k0 = tile * BK;
    __syncthreads();  // the previous tile's readers are done
    load_tile<T, D>(Ks, kp, k_st, k0, Tk);
    load_tile<T, D>(Vs, vp, v_st, k0, Tk);
    __syncthreads();

    float s[SC], dp[SC];
#pragma unroll
    for (int j = 0; j < SC; ++j) s[j] = dp[j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      const float qd = qrow[d];
      const float od = orow[d];
#pragma unroll
      for (int j = 0; j < SC; ++j) {
        const int c = (j * TPR + part) * LD + d;
        s[j] += qd * Ks[c];
        dp[j] += od * Vs[c];
      }
    }
#pragma unroll
    for (int j = 0; j < SC; ++j) {
      const int kpos = k0 + j * TPR + part;
      const bool valid = t < Tq && kpos < Tk && (!causal || kpos <= qpos);
      const float p = valid ? expf(s[j] * scale - lse_r) : 0.f;
      srow[j * TPR + part] = p * (dp[j] - d_r);
    }
    __syncwarp();  // the row's TPR threads share a warp

#pragma unroll 2
    for (int c = 0; c < BK; ++c) {
      const float ds = srow[c];
      const float* krow = Ks + c * LD;
#pragma unroll
      for (int e = 0; e < OC; ++e) acc[e] += ds * krow[e * TPR + part];
    }
  }

  if (t < Tq) {
    T* out = dq + ((int64_t)bh * Tq + t) * D;
#pragma unroll
    for (int e = 0; e < OC; ++e) store(out + e * TPR + part, acc[e] * scale);
  }
}

// Thread t owns key row t / TPR of the block's tile and, for the score
// tiles, the query columns congruent to t % TPR.
template <typename T, int D>
__global__ void __launch_bounds__(THREADS)
flash_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const T* __restrict__ dout,
                     const float* __restrict__ lse,
                     const float* __restrict__ dvec, T* __restrict__ dk,
                     T* __restrict__ dv, int H, int Hkv, int Tq, int Tk,
                     int64_t q_sb, int64_t q_sh, int64_t q_st,
                     int64_t k_sb, int64_t k_sh, int64_t k_st,
                     int64_t v_sb, int64_t v_sh, int64_t v_st,
                     int64_t o_sb, int64_t o_sh, int64_t o_st,
                     float scale, int causal) {
  constexpr int LD = D + 1;
  constexpr int SC = BQ / TPR;         // query columns per thread
  constexpr int OC = D / TPR;          // dK / dV columns per thread
  extern __shared__ float smem[];
  float* Ks = smem;                    // BK x LD
  float* Vs = Ks + BK * LD;            // BK x LD
  float* Qs = Vs + BK * LD;            // BQ x LD
  float* Os = Qs + BQ * LD;            // BQ x LD, dO
  float* Ps = Os + BQ * LD;            // BK x PLD, p (key row x query)
  float* Ss = Ps + BK * PLD;           // BK x PLD, dS
  float* Ls = Ss + BK * PLD;           // BQ, the tile's lse
  float* Dd = Ls + BQ;                 // BQ, the tile's D

  const int tid = threadIdx.x;
  const int row = tid / TPR;
  const int part = tid % TPR;
  const int bkv = blockIdx.y;
  const int b = bkv / Hkv;
  const int hk = bkv % Hkv;
  const int G = H / Hkv;
  const int k0 = blockIdx.x * BK;
  const int offset = Tk - Tq;
  const int kpos = k0 + row;

  load_tile<T, D>(Ks, k + b * k_sb + hk * k_sh, k_st, k0, Tk);
  load_tile<T, D>(Vs, v + b * v_sb + hk * v_sh, v_st, k0, Tk);

  float dk_acc[OC], dv_acc[OC];
#pragma unroll
  for (int e = 0; e < OC; ++e) dk_acc[e] = dv_acc[e] = 0.f;
  const float* krow = Ks + row * LD;
  const float* vrow = Vs + row * LD;
  float* prow = Ps + row * PLD;
  float* srow = Ss + row * PLD;

  const int n_q_tiles = (Tq + BQ - 1) / BQ;
  // causal: query tiles whose last position precedes this key tile see
  // none of it
  const int lo = causal ? max(k0 - offset, 0) / BQ : 0;

  for (int g = 0; g < G; ++g) {
    const int h = hk * G + g;
    const int64_t bh = (int64_t)b * H + h;
    const T* qp = q + b * q_sb + h * q_sh;
    const T* op = dout + b * o_sb + h * o_sh;
    for (int qt = lo; qt < n_q_tiles; ++qt) {
      const int q0 = qt * BQ;
      __syncthreads();  // the previous tile's readers are done
      load_tile<T, D>(Qs, qp, q_st, q0, Tq);
      load_tile<T, D>(Os, op, o_st, q0, Tq);
      if (tid < BQ) {
        const int t = q0 + tid;
        Ls[tid] = t < Tq ? lse[bh * Tq + t] : 0.f;
        Dd[tid] = t < Tq ? dvec[bh * Tq + t] : 0.f;
      }
      __syncthreads();

      float s[SC], dp[SC];
#pragma unroll
      for (int j = 0; j < SC; ++j) s[j] = dp[j] = 0.f;
#pragma unroll 4
      for (int d = 0; d < D; ++d) {
        const float kd = krow[d];
        const float vd = vrow[d];
#pragma unroll
        for (int j = 0; j < SC; ++j) {
          const int c = (j * TPR + part) * LD + d;
          s[j] += kd * Qs[c];
          dp[j] += vd * Os[c];
        }
      }
#pragma unroll
      for (int j = 0; j < SC; ++j) {
        const int i = j * TPR + part;
        const int t = q0 + i;
        const bool valid =
            t < Tq && kpos < Tk && (!causal || kpos <= t + offset);
        const float p = valid ? expf(s[j] * scale - Ls[i]) : 0.f;
        prow[i] = p;
        srow[i] = p * (dp[j] - Dd[i]);
      }
      __syncwarp();  // the row's TPR threads share a warp

#pragma unroll 2
      for (int c = 0; c < BQ; ++c) {
        const float p = prow[c];
        const float ds = srow[c];
        const float* oq = Os + c * LD;
        const float* qq = Qs + c * LD;
#pragma unroll
        for (int e = 0; e < OC; ++e) {
          dv_acc[e] += p * oq[e * TPR + part];
          dk_acc[e] += ds * qq[e * TPR + part];
        }
      }
    }
  }

  if (kpos < Tk) {
    const int64_t base = ((int64_t)bkv * Tk + kpos) * D;
#pragma unroll
    for (int e = 0; e < OC; ++e) {
      store(dk + base + e * TPR + part, dk_acc[e] * scale);
      store(dv + base + e * TPR + part, dv_acc[e]);
    }
  }
}

template <typename T, int D>
int launch(int which, const void* q, const void* k, const void* v,
           const void* dout, const float* lse, const float* dvec, void* dq,
           void* dk, void* dv, int B, int H, int Hkv, int Tq, int Tk,
           int64_t q_sb, int64_t q_sh, int64_t q_st,
           int64_t k_sb, int64_t k_sh, int64_t k_st,
           int64_t v_sb, int64_t v_sh, int64_t v_st,
           int64_t o_sb, int64_t o_sh, int64_t o_st,
           float scale, int causal, cudaStream_t stream) {
  const T* qt = static_cast<const T*>(q);
  const T* kt = static_cast<const T*>(k);
  const T* vt = static_cast<const T*>(v);
  const T* ot = static_cast<const T*>(dout);
  cudaError_t err;
  if (which == 0) {
    const size_t dq_smem = dq_smem_bytes<D>();
    err = cudaFuncSetAttribute(flash_bwd_dq_kernel<T, D>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)dq_smem);
    if (err != cudaSuccess) return (int)err;
    flash_bwd_dq_kernel<T, D>
        <<<dim3((Tq + BQ - 1) / BQ, B * H), THREADS, dq_smem, stream>>>(
            qt, kt, vt, ot, lse, dvec, static_cast<T*>(dq), H, H / Hkv, Tq,
            Tk, q_sb, q_sh, q_st, k_sb, k_sh, k_st, v_sb, v_sh, v_st, o_sb,
            o_sh, o_st, scale, causal);
    return (int)cudaGetLastError();
  }
  const size_t dkv_smem = dkv_smem_bytes<D>();
  err = cudaFuncSetAttribute(flash_bwd_dkv_kernel<T, D>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)dkv_smem);
  if (err != cudaSuccess) return (int)err;
  flash_bwd_dkv_kernel<T, D>
      <<<dim3((Tk + BK - 1) / BK, B * Hkv), THREADS, dkv_smem, stream>>>(
          qt, kt, vt, ot, lse, dvec, static_cast<T*>(dk),
          static_cast<T*>(dv), H, Hkv, Tq, Tk, q_sb, q_sh, q_st, k_sb, k_sh,
          k_st, v_sb, v_sh, v_st, o_sb, o_sh, o_st, scale, causal);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// which: 0 launches the dQ kernel (writes dq), 1 the dK/dV kernel (writes
// dk, dv), each on `stream`; the caller launches both and counts each.
// q/dout: (B, H, Tq, D), k/v: (B, Hkv, Tk, D), each with unit stride on D
// and the given element strides for batch, head and sequence. lse/dvec:
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
  if ((which != 0 && which != 1) || B < 1 || H < 1 || Hkv < 1 || H % Hkv ||
      Tq < 1 || Tk < 1 || B * H > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define MXTT_FA_BWD_LAUNCH(T, DD)                                          \
  return launch<T, DD>(which, q, k, v, dout, lse, dvec, dq, dk, dv, B, H,  \
                       Hkv, Tq, Tk, q_sb, q_sh, q_st, k_sb, k_sh, k_st,    \
                       v_sb, v_sh, v_st, o_sb, o_sh, o_st, scale, causal, s)
  if (dtype == 0 && D == 64) MXTT_FA_BWD_LAUNCH(float, 64);
  if (dtype == 0 && D == 128) MXTT_FA_BWD_LAUNCH(float, 128);
  if (dtype == 1 && D == 64) MXTT_FA_BWD_LAUNCH(__nv_bfloat16, 64);
  if (dtype == 1 && D == 128) MXTT_FA_BWD_LAUNCH(__nv_bfloat16, 128);
#undef MXTT_FA_BWD_LAUNCH
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
