// adamw_mt: the train step's clipped AdamW over every trainable leaf at
// once (train/optim.py), in three launches a step (for leaves of one dtype):
//   (a) norm_kernel: each CTA's sum of squares of g * inv_accum (the
//       gradient as the optimizer receives it) into one f32 partial slot;
//   (b) finalize_kernel: one CTA sums the slots in a fixed order and writes
//       grad_norm = sqrt(sum) and good = isfinite(loss) & isfinite(grad_norm);
//   (c) update_kernel: clip, moments, bias-corrected update, decay and
//       -lr * u in place on p, mu and nu of every element, gated by good.
// The learning rate and the bias corrections stay the tensor-op path's
// 0-dim ops on the int32 count (train/optim.py::_step_scalars, ~25 launches
// a step whatever the leaf count); (c) reads them, the norm and good from
// device memory, and the caller then adds good to the count. The host reads
// nothing and nothing is copied to the card.
//
// Replaces no TPU kernel: the JAX package leaves optax's chain to XLA, which
// fuses it. In the port the tensor-op path issued ~30 launches a leaf (123
// leaves at m7c-125M, 243 at m7c-350M), each a full pass over its leaf.
//
// Bit-equal to the tensor-op path (train/optim.py::apply_update_plain_, the
// CPU path and the card tests' reference): each tensor op there
// is one f32 operation rounded to the leaf's dtype, and so is each step of
// adamw_elem here: __fmul_rn / __fadd_rn / __fdiv_rn / __fsqrt_rn (never
// contracted into an FMA), rounded to T after each; Python scalars arrive
// cast to f32 as PyTorch casts them; grad_norm, bc1, bc2 and -lr are
// rounded to T as .to(dtype) rounds them. The norm is a sum in another
// order than global_norm's, the same bits on every call: each CTA covers a
// fixed range and every sum runs in a fixed order. Each thread adds its
// ~2,000 squares (m7c-350M) one by one, so it adds them in f64: in f32 its
// norm read 1.9e-6 from global_norm's (an f32 tree) at m7c-350M's leaves
// on an H100.
//
// Leaves travel in the kernel's parameters (apex's multi_tensor_apply
// style), one launch group a dtype: a table of each leaf's pointers and
// its first element in the launch's concatenation of leaves, up to
// MAX_LEAVES a launch (CUDA >= 12.1 takes 32,764 bytes of parameters on
// sm_70+; older toolkits 4,096). The norm of every group goes into one
// array of partial slots, which one finalize sums. CTA b
// covers elements [b * per_cta, (b + 1) * per_cta) of the concatenation and
// finds its first leaf by binary search; where a range crosses a leaf's
// end it goes on into the next leaf. No pointer table lives in device
// memory, so the launches can be captured in a CUDA graph.
// ops/cuda/adamw_mt.py::plan splits the leaves into launches;
// tests/test_torch_adamw_mt.py::segments mirrors `walk` on the CPU.
//
// What bounds it on the H100: bytes. (a) reads g (2 B an element in bf16),
// (c) reads g, p, mu, nu and writes p, mu, nu (14 B): 16 B x 78.3 M
// elements = 1.25 GB, 0.37 ms at 3.35 TB/s, for m7c-125M; 4.6 GB, 1.39 ms,
// for m7c-350M. Design: 16-byte vector loads and stores where all of a
// leaf's pointers are 16-byte aligned (a scalar head up to the first whole
// vector, a scalar tail), scalar elements otherwise; a few CTAs an SM, each
// over one contiguous range, so every load is coalesced.
#include "common.cuh"

namespace {

using nsa::DT_BF16;
using nsa::DT_F32;

constexpr int THREADS = 256;
constexpr int FIN_THREADS = 1024;

#if CUDART_VERSION >= 12010
constexpr int MAX_LEAVES = 768;
constexpr size_t PARAM_BYTES = 32764;
#else
constexpr int MAX_LEAVES = 90;
constexpr size_t PARAM_BYTES = 4096;
#endif

struct NormArgs {
  long long start[MAX_LEAVES + 1];   // leaf j: elements [start[j], start[j+1]) of the launch
  const void* g[MAX_LEAVES];
  int n;
  long long per_cta;
  float inv;                         // 1 / accum
  float* partials;                   // this launch's first slot
};

struct Hyper {                       // the Python scalars, cast to f32
  float inv, max_norm, c1, b1, c2, b2, eps, wd;   // c1 = f32(1 - b1), c2 = f32(1 - b2)
};

struct UpdateArgs {
  long long start[MAX_LEAVES + 1];
  const void* g[MAX_LEAVES];
  void* p[MAX_LEAVES];
  void* mu[MAX_LEAVES];
  void* nu[MAX_LEAVES];
  int n;
  long long per_cta;
  const float* gn;                   // grad_norm (f32)
  const bool* good;
  const float* lr;                   // the schedule at the count before its increment
  const float* bc1;                  // 1 - b1^(count + 1)
  const float* bc2;                  // 1 - b2^(count + 1)
  Hyper h;
};

static_assert(sizeof(NormArgs) <= PARAM_BYTES, "norm table exceeds the kernel parameter space");
static_assert(sizeof(UpdateArgs) <= PARAM_BYTES, "leaf table exceeds the kernel parameter space");

// x rounded to T, back in f32
template <typename T> __device__ __forceinline__ float rnd(float x);
template <> __device__ __forceinline__ float rnd<float>(float x) { return x; }
template <> __device__ __forceinline__ float rnd<__nv_bfloat16>(float x) {
  return __bfloat162float(__float2bfloat16(x));
}

// one tensor op of the tensor-op path: an f32 operation rounded to T
template <typename T> __device__ __forceinline__ float mul(float a, float b) {
  return rnd<T>(__fmul_rn(a, b));
}
template <typename T> __device__ __forceinline__ float add(float a, float b) {
  return rnd<T>(__fadd_rn(a, b));
}
template <typename T> __device__ __forceinline__ float dvd(float a, float b) {
  return rnd<T>(__fdiv_rn(a, b));
}
template <typename T> __device__ __forceinline__ float root(float a) {
  return rnd<T>(__fsqrt_rn(a));
}

// The step's scalars as the tensor-op path holds them.
struct Step {
  float inv, gn, max_norm, c1, b1, c2, b2, bc1, bc2, eps, wd, nlr;
  bool clip;
};

template <typename T>
__device__ __forceinline__ Step step_of(const UpdateArgs& a) {
  const float gn = *a.gn;
  Step k;
  k.inv = a.h.inv;
  k.gn = rnd<T>(gn);                 // grad_norm.to(dtype)
  k.clip = !(gn < a.h.max_norm);     // trigger = grad_norm < max_grad_norm keeps g
  k.max_norm = a.h.max_norm;
  k.c1 = a.h.c1;
  k.b1 = a.h.b1;
  k.c2 = a.h.c2;
  k.b2 = a.h.b2;
  k.bc1 = rnd<T>(*a.bc1);            // bc1.to(dtype)
  k.bc2 = rnd<T>(*a.bc2);
  k.eps = a.h.eps;
  k.wd = a.h.wd;
  k.nlr = rnd<T>(-*a.lr);            // (-lr).to(dtype)
  return k;
}

// train/optim.py::apply_update_ for one element, op for op
template <typename T>
__device__ __forceinline__ void adamw_elem(float& p, float g, float& m, float& v, const Step& k) {
  g = mul<T>(g, k.inv);                                          // g * (1 / accum)
  if (k.clip) g = mul<T>(dvd<T>(g, k.gn), k.max_norm);           // (g / |g|) * max_norm
  m = add<T>(mul<T>(k.c1, g), mul<T>(k.b1, m));                  // (1 - b1) g + b1 mu
  v = add<T>(mul<T>(k.c2, mul<T>(g, g)), mul<T>(k.b2, v));       // (1 - b2) g^2 + b2 nu
  const float d = add<T>(root<T>(dvd<T>(v, k.bc2)), k.eps);      // sqrt(nu / bc2) + eps
  float u = dvd<T>(dvd<T>(m, k.bc1), d);                         // (mu / bc1) / d
  u = add<T>(u, mul<T>(k.wd, p));                                // u + wd p
  u = mul<T>(k.nlr, u);                                          // (-lr) u
  p = add<T>(p, u);
}

// 16 bytes of T from V f32 values (exactly representable in T)
template <typename T> __device__ __forceinline__ uint4 pack(const float* f);
template <> __device__ __forceinline__ uint4 pack<float>(const float* f) {
  const float4 v = make_float4(f[0], f[1], f[2], f[3]);
  return *reinterpret_cast<const uint4*>(&v);
}
template <> __device__ __forceinline__ uint4 pack<__nv_bfloat16>(const float* f) {
  unsigned w[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const __nv_bfloat162 h = __floats2bfloat162_rn(f[2 * i], f[2 * i + 1]);
    w[i] = *reinterpret_cast<const unsigned*>(&h);
  }
  return make_uint4(w[0], w[1], w[2], w[3]);
}

// Calls f(j, s, e) for each piece [s, e) (leaf-relative) of leaf j that
// this CTA's range [b * per_cta, (b + 1) * per_cta) of the launch covers.
// Mirrored by tests/test_torch_adamw_mt.py::segments.
template <typename F>
__device__ __forceinline__ void walk(const long long* start, int n, long long per_cta, F&& f) {
  const long long lo = (long long)blockIdx.x * per_cta;
  const long long end = start[n];
  const long long hi = lo + per_cta < end ? lo + per_cta : end;
  int a = 0, b = n - 1;              // the leaf that holds element lo
  while (a < b) {
    const int m = (a + b) >> 1;
    if (start[m + 1] <= lo) a = m + 1;
    else b = m;
  }
  for (int j = a; j < n && start[j] < hi; ++j) {
    const long long s = lo > start[j] ? lo : start[j];
    const long long e = hi < start[j + 1] ? hi : start[j + 1];
    if (s < e) f(j, s - start[j], e - start[j]);
  }
}

// [s, e) of a leaf as a scalar head up to the first whole vector, vectors,
// and a scalar tail, when `aligned`; all scalar otherwise.
template <int V, typename One, typename Whole>
__device__ __forceinline__ void split(long long s, long long e, bool aligned, One&& one,
                                      Whole&& vec) {
  long long rest = s;
  if (aligned) {
    const long long a0 = (s + V - 1) / V * V;
    const long long a = a0 < e ? a0 : e;
    const long long b = a + (e - a) / V * V;
    for (long long i = s + threadIdx.x; i < a; i += blockDim.x) one(i);
    for (long long i = a + (long long)threadIdx.x * V; i < b; i += (long long)blockDim.x * V)
      vec(i);
    rest = b;
  }
  for (long long i = rest + threadIdx.x; i < e; i += blockDim.x) one(i);
}

__device__ __forceinline__ bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

// Block sum in a fixed order: each warp's xor tree, then the warps in turn.
template <int NT>
__device__ __forceinline__ float block_sum(float x) {
  __shared__ float warp_part[NT / 32];
  x = nsa::warp_sum(x);
  if ((threadIdx.x & 31) == 0) warp_part[threadIdx.x >> 5] = x;
  __syncthreads();
  float s = 0.f;
  if (threadIdx.x == 0)
    for (int w = 0; w < NT / 32; ++w) s += warp_part[w];
  return s;                          // meaningful in thread 0
}

template <typename T>
__global__ void __launch_bounds__(THREADS) norm_kernel(const __grid_constant__ NormArgs a) {
  constexpr int V = nsa::Vec<T>::E;
  double acc = 0.0;
  walk(a.start, a.n, a.per_cta, [&](int j, long long s, long long e) {
    const T* __restrict__ g = static_cast<const T*>(a.g[j]);
    split<V>(
        s, e, aligned16(g),
        [&](long long i) {
          const double x = mul<T>(nsa::to_f(g[i]), a.inv);
          acc = fma(x, x, acc);
        },
        [&](long long i) {
          float f[V];
          nsa::Vec<T>::to_f(__ldg(reinterpret_cast<const uint4*>(g + i)), f);
#pragma unroll
          for (int u = 0; u < V; ++u) {
            const double x = mul<T>(f[u], a.inv);
            acc = fma(x, x, acc);
          }
        });
  });
  const float s = block_sum<THREADS>(static_cast<float>(acc));
  if (threadIdx.x == 0) a.partials[blockIdx.x] = s;
}

__global__ void __launch_bounds__(FIN_THREADS)
    finalize_kernel(const float* __restrict__ partials, int n, const float* __restrict__ loss,
                    float* __restrict__ gn, bool* __restrict__ good) {
  float acc = 0.f;
  for (int i = threadIdx.x; i < n; i += FIN_THREADS) acc += partials[i];
  const float s = block_sum<FIN_THREADS>(acc);
  if (threadIdx.x == 0) {
    const float norm = __fsqrt_rn(s);
    *gn = norm;
    *good = fabsf(*loss) <= FLT_MAX && norm <= FLT_MAX;   // both finite (false for NaN)
  }
}

template <typename T>
__global__ void __launch_bounds__(THREADS) update_kernel(const __grid_constant__ UpdateArgs a) {
  constexpr int V = nsa::Vec<T>::E;
  if (!*a.good) return;              // a skipped step keeps every bit
  const Step k = step_of<T>(a);
  walk(a.start, a.n, a.per_cta, [&](int j, long long s, long long e) {
    T* __restrict__ p = static_cast<T*>(a.p[j]);
    const T* __restrict__ g = static_cast<const T*>(a.g[j]);
    T* __restrict__ mu = static_cast<T*>(a.mu[j]);
    T* __restrict__ nu = static_cast<T*>(a.nu[j]);
    split<V>(
        s, e, aligned16(p) && aligned16(g) && aligned16(mu) && aligned16(nu),
        [&](long long i) {
          float x = nsa::to_f(p[i]), m = nsa::to_f(mu[i]), v = nsa::to_f(nu[i]);
          adamw_elem<T>(x, nsa::to_f(g[i]), m, v, k);
          p[i] = nsa::from_f<T>(x);
          mu[i] = nsa::from_f<T>(m);
          nu[i] = nsa::from_f<T>(v);
        },
        [&](long long i) {
          float fp[V], fg[V], fm[V], fv[V];
          nsa::Vec<T>::to_f(*reinterpret_cast<const uint4*>(p + i), fp);
          nsa::Vec<T>::to_f(__ldg(reinterpret_cast<const uint4*>(g + i)), fg);
          nsa::Vec<T>::to_f(*reinterpret_cast<const uint4*>(mu + i), fm);
          nsa::Vec<T>::to_f(*reinterpret_cast<const uint4*>(nu + i), fv);
#pragma unroll
          for (int u = 0; u < V; ++u) adamw_elem<T>(fp[u], fg[u], fm[u], fv[u], k);
          *reinterpret_cast<uint4*>(p + i) = pack<T>(fp);
          *reinterpret_cast<uint4*>(mu + i) = pack<T>(fm);
          *reinterpret_cast<uint4*>(nu + i) = pack<T>(fv);
        });
  });
}

bool valid(int n, long long per_cta, int ctas, const long long* start) {
  if (n <= 0 || n > MAX_LEAVES || per_cta <= 0 || ctas <= 0 || start[0] != 0) return false;
  for (int j = 0; j < n; ++j)
    if (start[j + 1] < start[j]) return false;
  return (long long)ctas * per_cta >= start[n] && (long long)(ctas - 1) * per_cta < start[n];
}

}  // namespace

extern "C" {

int nsa_adamw_mt_max_leaves() { return MAX_LEAVES; }

// (a) over leaves g[0..n) of one dtype, their elements at start[0..n] of
// the launch (start[0] = 0): partials[b] = sum over CTA b's range of
// (g * inv rounded to the dtype)^2, b < ctas.
int nsa_adamw_mt_norm(int dtype, const long long* start, const void* const* g, int n,
                      long long per_cta, int ctas, float inv, float* partials, void* stream) {
  if (!valid(n, per_cta, ctas, start) || (dtype != DT_F32 && dtype != DT_BF16))
    return (int)cudaErrorInvalidValue;
  NormArgs a{};
  for (int j = 0; j <= n; ++j) a.start[j] = start[j];
  for (int j = 0; j < n; ++j) a.g[j] = g[j];
  a.n = n;
  a.per_cta = per_cta;
  a.inv = inv;
  a.partials = partials;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == DT_BF16) norm_kernel<__nv_bfloat16><<<ctas, THREADS, 0, s>>>(a);
  else norm_kernel<float><<<ctas, THREADS, 0, s>>>(a);
  NSA_LAUNCH_CHECK();
}

// (b) grad_norm = sqrt(sum of partials[0..n) in order; 0 for n = 0), good =
// isfinite(loss) & isfinite(grad_norm)
int nsa_adamw_mt_finalize(const float* partials, int n, const float* loss, float* gn,
                          bool* good, void* stream) {
  if (n < 0) return (int)cudaErrorInvalidValue;
  finalize_kernel<<<1, FIN_THREADS, 0, static_cast<cudaStream_t>(stream)>>>(partials, n, loss,
                                                                            gn, good);
  NSA_LAUNCH_CHECK();
}

// (c) the update of leaves p, g, mu, nu [0..n) in place where *good, at the
// step's lr and bias corrections *lr, *bc1, *bc2 (f32 device scalars).
int nsa_adamw_mt_update(int dtype, const long long* start, const void* const* p,
                        const void* const* g, const void* const* mu, const void* const* nu,
                        int n, long long per_cta, int ctas, const float* gn, const bool* good,
                        const float* lr, const float* bc1, const float* bc2, float inv,
                        float max_norm, float c1, float b1, float c2, float b2, float eps,
                        float wd, void* stream) {
  if (!valid(n, per_cta, ctas, start) || (dtype != DT_F32 && dtype != DT_BF16))
    return (int)cudaErrorInvalidValue;
  UpdateArgs a{};
  for (int j = 0; j <= n; ++j) a.start[j] = start[j];
  for (int j = 0; j < n; ++j) {
    a.p[j] = const_cast<void*>(p[j]);
    a.g[j] = g[j];
    a.mu[j] = const_cast<void*>(mu[j]);
    a.nu[j] = const_cast<void*>(nu[j]);
  }
  a.n = n;
  a.per_cta = per_cta;
  a.gn = gn;
  a.good = good;
  a.lr = lr;
  a.bc1 = bc1;
  a.bc2 = bc2;
  a.h = Hyper{inv, max_norm, c1, b1, c2, b2, eps, wd};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == DT_BF16) update_kernel<__nv_bfloat16><<<ctas, THREADS, 0, s>>>(a);
  else update_kernel<float><<<ctas, THREADS, 0, s>>>(a);
  NSA_LAUNCH_CHECK();
}

}  // extern "C"
