// Fused optimizer updates for Hopper (sm_90a), plain C interface for ctypes.
//
// Replaces: mxnet_tpu/ops/pallas/fused_update.py `sgd_mom_update` (:31,
// kernel `_sgd_mom_kernel` :20) and `adam_update` (:60, kernel
// `_adam_kernel` :46). MXNet's conventions: g = clip(rescale * g);
// sgd_mom: mom = momentum * mom - lr * (g + wd * w); w += mom.
// adam: g += wd * w; mean = b1 * mean + (1 - b1) * g;
// var = b2 * var + (1 - b2) * g * g; w -= lr * mean / (sqrt(var) + eps),
// with no bias correction here (the optimizer folds it into lr). f32 math
// whatever the buffer type; the weight and the state(s) are updated in
// place (the reference's input_output_aliases), one launch per parameter.
//
// What bounds it on the card: bytes. Each element reads w, g and the
// state(s) once and writes w and the state(s) once: 20 B (sgd_mom) or
// 28 B (adam) per f32 element at ~0 flop/B, so the LM's 217 M parameters
// take at least ~1.3 ms (sgd_mom) / ~1.8 ms (adam) at 3.35 TB/s.
//
// What this design does about it: one pass, nothing but the buffers
// touched; a grid-stride loop of 16-byte vector loads and stores
// (4 f32 or 8 bf16 elements per thread per step) when every pointer is
// 16-byte aligned, and a scalar loop for the tail (or all of it, when not
// aligned). A launch over many parameters at once is later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int MAX_BLOCKS = 132 * 16;   // enough resident blocks per SM

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void put(float& p, float x) { p = x; }
__device__ __forceinline__ void put(__nv_bfloat16& p, float x) {
  p = __float2bfloat16(x);
}

// 16 bytes of T: the unit of one vector load or store
template <typename T>
struct alignas(16) Pack {
  T x[16 / sizeof(T)];
};

struct SgdArgs {
  float lr, momentum, wd, rescale, clip;
};

struct AdamArgs {
  float lr, beta1, beta2, eps, wd, rescale, clip;
};

// rescale, then clip to [-clip, clip] when clip > 0 (NaN stays NaN)
__device__ __forceinline__ float prep(float g, float rescale, float clip) {
  g *= rescale;
  if (clip > 0.f) g = g < -clip ? -clip : (g > clip ? clip : g);
  return g;
}

template <typename T>
__device__ __forceinline__ void sgd_mom_one(T& w, T g, T& m,
                                            const SgdArgs& a) {
  const float gf = prep(to_f32(g), a.rescale, a.clip);
  const float wf = to_f32(w);
  const float mf = to_f32(m) * a.momentum - a.lr * (gf + a.wd * wf);
  put(m, mf);
  put(w, wf + mf);
}

template <typename T>
__device__ __forceinline__ void adam_one(T& w, T g, T& m, T& v,
                                         const AdamArgs& a) {
  const float wf = to_f32(w);
  const float gf = prep(to_f32(g), a.rescale, a.clip) + a.wd * wf;
  const float mf = a.beta1 * to_f32(m) + (1.f - a.beta1) * gf;
  const float vf = a.beta2 * to_f32(v) + (1.f - a.beta2) * gf * gf;
  put(m, mf);
  put(v, vf);
  put(w, wf - a.lr * mf / (sqrtf(vf) + a.eps));
}

// Elements [0, n_vec * N) go as 16-byte packs, [n_vec * N, n) one by one.
template <typename T>
__global__ void __launch_bounds__(THREADS)
sgd_mom_kernel(T* __restrict__ w, const T* __restrict__ g,
               T* __restrict__ m, int64_t n, int64_t n_vec, SgdArgs a) {
  constexpr int N = 16 / sizeof(T);
  const int64_t stride = (int64_t)gridDim.x * THREADS;
  const int64_t first = (int64_t)blockIdx.x * THREADS + threadIdx.x;
  for (int64_t i = first; i < n_vec; i += stride) {
    Pack<T> pw = reinterpret_cast<const Pack<T>*>(w)[i];
    const Pack<T> pg = reinterpret_cast<const Pack<T>*>(g)[i];
    Pack<T> pm = reinterpret_cast<const Pack<T>*>(m)[i];
#pragma unroll
    for (int e = 0; e < N; ++e) sgd_mom_one(pw.x[e], pg.x[e], pm.x[e], a);
    reinterpret_cast<Pack<T>*>(w)[i] = pw;
    reinterpret_cast<Pack<T>*>(m)[i] = pm;
  }
  for (int64_t i = n_vec * N + first; i < n; i += stride)
    sgd_mom_one(w[i], g[i], m[i], a);
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
adam_kernel(T* __restrict__ w, const T* __restrict__ g, T* __restrict__ m,
            T* __restrict__ v, int64_t n, int64_t n_vec, AdamArgs a) {
  constexpr int N = 16 / sizeof(T);
  const int64_t stride = (int64_t)gridDim.x * THREADS;
  const int64_t first = (int64_t)blockIdx.x * THREADS + threadIdx.x;
  for (int64_t i = first; i < n_vec; i += stride) {
    Pack<T> pw = reinterpret_cast<const Pack<T>*>(w)[i];
    const Pack<T> pg = reinterpret_cast<const Pack<T>*>(g)[i];
    Pack<T> pm = reinterpret_cast<const Pack<T>*>(m)[i];
    Pack<T> pv = reinterpret_cast<const Pack<T>*>(v)[i];
#pragma unroll
    for (int e = 0; e < N; ++e)
      adam_one(pw.x[e], pg.x[e], pm.x[e], pv.x[e], a);
    reinterpret_cast<Pack<T>*>(w)[i] = pw;
    reinterpret_cast<Pack<T>*>(m)[i] = pm;
    reinterpret_cast<Pack<T>*>(v)[i] = pv;
  }
  for (int64_t i = n_vec * N + first; i < n; i += stride)
    adam_one(w[i], g[i], m[i], v[i], a);
}

// Packs when every pointer is 16-byte aligned, else none.
int64_t packs(int64_t n, int item, const void* const* ptrs, int count) {
  for (int i = 0; i < count; ++i)
    if (reinterpret_cast<uintptr_t>(ptrs[i]) % 16) return 0;
  return n / (16 / item);
}

unsigned blocks(int64_t n, int64_t n_vec) {
  const int64_t work = n_vec > 0 ? n_vec : n;
  const int64_t b = (work + THREADS - 1) / THREADS;
  return (unsigned)(b < MAX_BLOCKS ? (b > 0 ? b : 1) : MAX_BLOCKS);
}

}  // namespace

extern "C" {

// w/g/mom: n contiguous elements of one type (dtype 0 float32, 1 bfloat16);
// w and mom are updated in place. Returns a cudaError_t.
int mxtt_sgd_mom_update(void* w, const void* g, void* mom, int64_t n,
                        int dtype, float lr, float momentum, float wd,
                        float rescale, float clip, void* stream) {
  if (n < 1 || (dtype != 0 && dtype != 1)) return (int)cudaErrorInvalidValue;
  const SgdArgs a{lr, momentum, wd, rescale, clip};
  const void* ptrs[3] = {w, g, mom};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    const int64_t nv = packs(n, 4, ptrs, 3);
    sgd_mom_kernel<float><<<blocks(n, nv), THREADS, 0, s>>>(
        static_cast<float*>(w), static_cast<const float*>(g),
        static_cast<float*>(mom), n, nv, a);
  } else {
    const int64_t nv = packs(n, 2, ptrs, 3);
    sgd_mom_kernel<__nv_bfloat16><<<blocks(n, nv), THREADS, 0, s>>>(
        static_cast<__nv_bfloat16*>(w), static_cast<const __nv_bfloat16*>(g),
        static_cast<__nv_bfloat16*>(mom), n, nv, a);
  }
  return (int)cudaGetLastError();
}

// w/g/mean/var: n contiguous elements of one type; w, mean and var are
// updated in place. Returns a cudaError_t.
int mxtt_adam_update(void* w, const void* g, void* mean, void* var,
                     int64_t n, int dtype, float lr, float beta1, float beta2,
                     float eps, float wd, float rescale, float clip,
                     void* stream) {
  if (n < 1 || (dtype != 0 && dtype != 1)) return (int)cudaErrorInvalidValue;
  const AdamArgs a{lr, beta1, beta2, eps, wd, rescale, clip};
  const void* ptrs[4] = {w, g, mean, var};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    const int64_t nv = packs(n, 4, ptrs, 4);
    adam_kernel<float><<<blocks(n, nv), THREADS, 0, s>>>(
        static_cast<float*>(w), static_cast<const float*>(g),
        static_cast<float*>(mean), static_cast<float*>(var), n, nv, a);
  } else {
    const int64_t nv = packs(n, 2, ptrs, 4);
    adam_kernel<__nv_bfloat16><<<blocks(n, nv), THREADS, 0, s>>>(
        static_cast<__nv_bfloat16*>(w), static_cast<const __nv_bfloat16*>(g),
        static_cast<__nv_bfloat16*>(mean), static_cast<__nv_bfloat16*>(var),
        n, nv, a);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
