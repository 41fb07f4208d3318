// sel_attn: NSA selection-branch attention in f32 at prefill and in either
// dtype at decode (the bf16 prefill is sel_attn_fwd_mma.cu).
//
// Replaces two TPU kernels:
//   nsa_vibe_tpu/ops/pallas/sel_flash.py::selection_flash_pallas (prefill,
//     kernel _sel_flash_kernel: union of the q-tile's blocks, a mask per row)
//     for f32 operands;
//   nsa_vibe_tpu/ops/pallas/selection.py::selection_attention_pallas (decode,
//     kernel _sel_kernel: per-query walk over the selected blocks).
//
// What it computes, per query (b, s) and KV group g, for all h heads of the
// group: softmax in f32 over the keys of the row's selected blocks taken as
// a SET (-1 slots and repeated ids add nothing; the fused scorer emits
// forced slots that may repeat), key positions clamped to <= t (t per row,
// from tpos[b, s]) and < S_kv; a row with no visible key returns 0.
// Optionally (lse != nullptr, the training forward) the row statistics
// lse [B,S,G,h] f32 = m + log(l), EMPTY_LSE for a row with no key.
//
// Prefill (f32), `sel_attn_kernel`: one block per (b, s, g); thread 0
// compacts the row's selection into a list of distinct visible block ids;
// each block's K/V rows are staged in shared memory as f32 with 16-byte
// loads, eight in flight per thread (rows past S_kv or t are never read).
// What bounds it on the H100: the L2->shared gather of every selected block
// for every query (~4 GB at the m7c prefill shape) and the shared-memory
// reads feeding f32 FMAs (the f32 gates' 5e-5 bounds rule out TF32, so the
// tensor cores are for bf16 only). Every K row read feeds four heads (Q.K)
// and every V row read feeds all h heads (P.V, register slices per thread,
// key splits summed once at the end).
//
// Decode (S = 1, f32 and bf16), split over the selected blocks: one block
// per (b, s, g, slot j) of `sel_attn_split_kernel` (the same code, one
// block id per CTA) takes slot j's block if it is visible and appears in
// no earlier slot (so repeated forced slots count once), and writes the f32
// partial of its keys (unnormalised acc [h, Dv], m [h], l [h]) to its slot
// of a workspace [B,S,G,n]; `sel_attn_combine_kernel` merges the n partials
// of each (b, s, g) in slot order (no float atomics: two launches give the
// same bits). What bounds decode on the H100: the bytes of n blocks of l_sel
// keys per (b, g) (16 x 64 at m7c), ~0.6 us; a CTA that walks them one
// after another is bound by the latency of each block's gather instead,
// so the grid is B*G*n CTAs (128 at B = 4) that fetch them at once. It is
// not the TPU kernel carried over: _sel_kernel walks the n slots in
// sequence with scratch (selection.py:39-93).
#include <type_traits>

#include "common.cuh"

using namespace nsa;

namespace {

constexpr int THREADS = 128;
constexpr int NWARPS = THREADS / 32;

struct Params {
  int S, S_kv, G, h, Dk, Dv, n, l_sel;
  float scale;
};

// floats of one slot's partial in the split design's workspace: acc
// [h][Dv], then m [h] and l [h], padded so that every slot is 16-byte aligned
__host__ __device__ inline size_t ws_pitch(int h, int Dv) {
  return (size_t)h * Dv + round4((size_t)2 * h);
}

// shared-memory carve-up (floats): Q rows, row max/sum/rescale, one block
// of K (pitch Dk+4) and V, logits/probabilities; then the block-id list.
// The K/V area is reused at the end for the per-key-split partial outputs.
struct Smem {
  size_t q, m, l, a, k, v, lg, ids, bytes;
  __host__ __device__ Smem(int h, int Dk, int Dv, int n, int L) {
    q = 0;
    m = q + round4((size_t)h * Dk);
    l = m + round4(h);
    a = l + round4(h);
    k = a + round4(h);
    const size_t partial = (size_t)(THREADS / (Dv / 4)) * h * Dv;
    const size_t kv = round4((size_t)L * (Dk + 4)) + round4((size_t)L * Dv);
    v = k + round4((size_t)L * (Dk + 4));
    lg = k + (kv > partial ? kv : round4(partial));
    ids = lg + round4((size_t)h * L);
    bytes = ids * sizeof(float) + (size_t)n * sizeof(int);
  }
};

// Per block (b, s, g) (SPLIT: per (b, s, g, slot), the slot's block alone),
// for each distinct visible selected block of L keys:
//   A. logits [h, nk]: a thread takes one key and up to 4 heads, so each
//      float4 read of a K row feeds four heads;
//   B. online softmax: one warp per head;
//   C. O += P V: a thread owns 4 output dims of all h heads (HMAX register
//      slices) for one of THREADS/(Dv/4) key splits, so each float4 read of
//      a V row feeds every head; the splits are summed once at the end.
//   SPLIT writes the unnormalised partial (acc [h][Dv], m [h], l [h]) of its
//   block to ws[blockIdx.x] instead of O (an invisible or repeated slot: l
//   = 0, acc = 0).
//   gate [B,S,G] f32 (not SPLIT; null: ungated), the gate-epilogue fold:
//   O = (acc / l) * gate[b, s, g] in f32 (sel_flash.py:169).
template <typename T, int HMAX, bool SPLIT>
__device__ __forceinline__ void sel_attn_body(const T* __restrict__ Q, const T* __restrict__ K,
                                              const T* __restrict__ V,
                                              const int* __restrict__ sel,
                                              const int* __restrict__ tpos, T* __restrict__ O,
                                              float* __restrict__ lse, float* __restrict__ ws,
                                              const Params& p,
                                              const float* __restrict__ gate = nullptr) {
  extern __shared__ __align__(16) float smem[];
  __shared__ int nb_s;
  const int bid = SPLIT ? blockIdx.x / p.n : blockIdx.x;   // (b*S + s)*G + g
  const int slot = SPLIT ? blockIdx.x % p.n : 0;
  const int g = bid % p.G;
  const int bs = bid / p.G;     // b*S + s
  const int b = bs / p.S;
  const int t = tpos[bs];
  const int h = p.h, Dk = p.Dk, Dv = p.Dv, L = p.l_sel;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  const Smem S_(h, Dk, Dv, p.n, L);
  float* q_s = smem + S_.q;          // [h][Dk]
  float* m_s = smem + S_.m;          // [h]
  float* l_s = smem + S_.l;          // [h]
  float* a_s = smem + S_.a;          // [h] rescale of the running output for this block
  float* k_s = smem + S_.k;          // [L][Dk+4]
  float* v_s = smem + S_.v;          // [L][Dv]
  float* lg = smem + S_.lg;          // [h][L] logits, then probabilities
  int* blist = reinterpret_cast<int*>(smem + S_.ids);   // [n] distinct visible block ids
  const int kp = Dk + 4;
  const int ngrp = (h + 3) / 4;      // phase A head groups
  const int d4 = Dv / 4;             // phase C: dims [4*c4, 4*c4+4) for key split ks
  const int nsplit = THREADS / d4;
  const int c4 = tid % d4, ks = tid / d4;
  const bool owner = ks < nsplit;

  const size_t row0 = (size_t)bid * h;   // Q/O row of head 0 in [B,S,G,h]
  load_rows_vec<T>(q_s, Dk, Q + row0 * Dk, Dk, 0, h, h);
  for (int idx = tid; idx < h; idx += THREADS) {
    m_s[idx] = NEG;
    l_s[idx] = 0.f;
  }
  if (tid == 0) {
    const int* sr = sel + (size_t)bid * p.n;
    int nb = 0;
    for (int j = SPLIT ? slot : 0; j < (SPLIT ? slot + 1 : p.n); ++j) {
      const int id = sr[j];
      if (id < 0 || (long long)id * L > t || (long long)id * L >= p.S_kv) continue;
      bool dup = false;
      for (int k = 0; k < (SPLIT ? slot : nb); ++k) dup = dup || (SPLIT ? sr[k] : blist[k]) == id;
      if (!dup) blist[nb++] = id;
    }
    nb_s = nb;
  }
  float4 acc[HMAX];
#pragma unroll
  for (int j = 0; j < HMAX; ++j) acc[j] = make_float4(0.f, 0.f, 0.f, 0.f);
  __syncthreads();
  const int nb = nb_s;
  const T* Kbg = K + ((size_t)b * p.G + g) * p.S_kv * Dk;
  const T* Vbg = V + ((size_t)b * p.G + g) * p.S_kv * Dv;

  for (int bi = 0; bi < nb; ++bi) {
    const int k0 = blist[bi] * L;
    const int kend = min(min(k0 + L, t + 1), p.S_kv);   // visible keys [k0, kend), non-empty
    const int nk = kend - k0;
    __syncthreads();   // previous block's K/V and probabilities consumed
    load_rows_vec<T, 8>(k_s, kp, Kbg, Dk, k0, nk, kend);
    load_rows_vec<T, 8>(v_s, Dv, Vbg, Dv, k0, nk, kend);
    __syncthreads();
    for (int idx = tid; idx < nk * ngrp; idx += THREADS) {   // A
      const int key = idx % nk, j0 = (idx / nk) * 4;
      const float4* kr = reinterpret_cast<const float4*>(k_s + key * kp);
      float s4[4] = {0.f, 0.f, 0.f, 0.f};
      for (int c = 0; c < Dk / 4; ++c) {
        const float4 kv = kr[c];
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const float4 qv = reinterpret_cast<const float4*>(q_s + min(j0 + u, h - 1) * Dk)[c];
          s4[u] = fmaf(qv.x, kv.x, s4[u]);
          s4[u] = fmaf(qv.y, kv.y, s4[u]);
          s4[u] = fmaf(qv.z, kv.z, s4[u]);
          s4[u] = fmaf(qv.w, kv.w, s4[u]);
        }
      }
#pragma unroll
      for (int u = 0; u < 4; ++u)
        if (j0 + u < h) lg[(j0 + u) * L + key] = s4[u] * p.scale;
    }
    __syncthreads();
    for (int j = warp; j < h; j += NWARPS) {   // B
      float* lj = lg + j * L;
      float mx = NEG;
      for (int key = lane; key < nk; key += 32) mx = fmaxf(mx, lj[key]);
      const float m_old = m_s[j];
      const float m_new = fmaxf(m_old, warp_max(mx));
      float ps = 0.f;
      for (int key = lane; key < nk; key += 32) {
        const float e = expf(lj[key] - m_new);
        lj[key] = e;
        ps += e;
      }
      ps = warp_sum(ps);
      if (lane == 0) {
        const float alpha = expf(m_old - m_new);
        a_s[j] = alpha;
        l_s[j] = l_s[j] * alpha + ps;
        m_s[j] = m_new;
      }
    }
    __syncthreads();
    if (owner) {   // C
#pragma unroll
      for (int j = 0; j < HMAX; ++j) {
        if (j < h) {
          const float al = a_s[j];
          acc[j].x *= al;
          acc[j].y *= al;
          acc[j].z *= al;
          acc[j].w *= al;
        }
      }
      for (int key = ks; key < nk; key += nsplit) {
        const float4 vv = *reinterpret_cast<const float4*>(v_s + key * Dv + 4 * c4);
#pragma unroll
        for (int j = 0; j < HMAX; ++j) {
          if (j < h) {
            const float pj = lg[j * L + key];
            acc[j].x = fmaf(pj, vv.x, acc[j].x);
            acc[j].y = fmaf(pj, vv.y, acc[j].y);
            acc[j].z = fmaf(pj, vv.z, acc[j].z);
            acc[j].w = fmaf(pj, vv.w, acc[j].w);
          }
        }
      }
    }
  }
  __syncthreads();   // K/V area free: it now holds the key splits' partial outputs
  float* part = k_s;   // [nsplit][h][Dv]
  if (owner) {
#pragma unroll
    for (int j = 0; j < HMAX; ++j)
      if (j < h) *reinterpret_cast<float4*>(part + ((size_t)ks * h + j) * Dv + 4 * c4) = acc[j];
  }
  __syncthreads();
  float* wsb = SPLIT ? ws + (size_t)blockIdx.x * ws_pitch(h, Dv) : nullptr;   // acc, m, l
  for (int idx = tid; idx < h * d4; idx += THREADS) {
    const int j = idx / d4, c = (idx - j * d4) * 4;
    float4 o = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int k = 0; k < nsplit; ++k) {
      const float4 x = *reinterpret_cast<const float4*>(part + ((size_t)k * h + j) * Dv + c);
      o.x += x.x;
      o.y += x.y;
      o.z += x.z;
      o.w += x.w;
    }
    if (SPLIT) {
      *reinterpret_cast<float4*>(wsb + (size_t)j * Dv + c) = o;
      continue;
    }
    const float den = l_s[j];
    o.x = den > 0.f ? o.x / den : 0.f;
    o.y = den > 0.f ? o.y / den : 0.f;
    o.z = den > 0.f ? o.z / den : 0.f;
    o.w = den > 0.f ? o.w / den : 0.f;
    if (gate != nullptr) {
      const float gv = gate[bid];
      o = make_float4(o.x * gv, o.y * gv, o.z * gv, o.w * gv);
    }
    store4<T>(O + (row0 + j) * Dv + c, o);
  }
  if (SPLIT) {
    for (int j = tid; j < h; j += THREADS) {
      wsb[(size_t)h * Dv + j] = m_s[j];
      wsb[(size_t)h * Dv + h + j] = l_s[j];
    }
  } else if (lse != nullptr) {
    for (int j = tid; j < h; j += THREADS) lse[row0 + j] = row_lse(m_s[j], l_s[j]);
  }
}

template <typename T, int HMAX>
__global__ void __launch_bounds__(THREADS)
sel_attn_kernel(const T* __restrict__ Q, const T* __restrict__ K, const T* __restrict__ V,
                const int* __restrict__ sel, const int* __restrict__ tpos,
                const float* __restrict__ gate, T* __restrict__ O, float* __restrict__ lse,
                Params p) {
  sel_attn_body<T, HMAX, false>(Q, K, V, sel, tpos, O, lse, nullptr, p, gate);
}

template <typename T, int HMAX>
__global__ void __launch_bounds__(THREADS)
sel_attn_split_kernel(const T* __restrict__ Q, const T* __restrict__ K, const T* __restrict__ V,
                      const int* __restrict__ sel, const int* __restrict__ tpos,
                      float* __restrict__ ws, Params p) {
  sel_attn_body<T, HMAX, true>(Q, K, V, sel, tpos, nullptr, nullptr, ws, p);
}

// One block per (b, s, g): O = sum_j acc_j e^(m_j - M) / sum_j l_j e^(m_j - M),
// M = max_j m_j, over the n partials in slot order; empty slots (l = 0,
// acc = 0, m = NEG) add nothing.
template <typename T>
__global__ void __launch_bounds__(THREADS)
sel_attn_combine_kernel(const float* __restrict__ ws, T* __restrict__ O, float* __restrict__ lse,
                        Params p) {
  const int h = p.h, Dv = p.Dv, n = p.n;
  const size_t pitch = ws_pitch(h, Dv);
  const float* wb = ws + (size_t)blockIdx.x * n * pitch;
  const size_t row0 = (size_t)blockIdx.x * h;
  for (int idx = threadIdx.x; idx < h * Dv; idx += THREADS) {
    const int j = idx / Dv, c = idx - j * Dv;
    float M = NEG;
    for (int k = 0; k < n; ++k) M = fmaxf(M, wb[k * pitch + (size_t)h * Dv + j]);
    float l = 0.f, acc = 0.f;
    for (int k = 0; k < n; ++k) {
      const float* part = wb + k * pitch;
      const float e = expf(part[(size_t)h * Dv + j] - M);
      l = fmaf(part[(size_t)h * Dv + h + j], e, l);
      acc = fmaf(part[(size_t)j * Dv + c], e, acc);
    }
    O[(row0 + j) * Dv + c] = from_f<T>(l > 0.f ? acc / l : 0.f);
    if (c == 0 && lse != nullptr) lse[row0 + j] = row_lse(M, l);
  }
}

template <typename T, int HMAX>
int launch(const void* Q, const void* K, const void* V, const int* sel, const int* tpos,
           const float* gate, void* O, float* lse, int B, const Params& p, cudaStream_t stream) {
  const size_t smem = Smem(p.h, p.Dk, p.Dv, p.n, p.l_sel).bytes;
  cudaError_t e = cudaFuncSetAttribute(sel_attn_kernel<T, HMAX>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  const long long grid = (long long)B * p.S * p.G;
  sel_attn_kernel<T, HMAX><<<(unsigned)grid, THREADS, smem, stream>>>(
      static_cast<const T*>(Q), static_cast<const T*>(K), static_cast<const T*>(V), sel, tpos,
      gate, static_cast<T*>(O), lse, p);
  NSA_LAUNCH_CHECK();
}

template <typename T, int HMAX>
int launch_split(const void* Q, const void* K, const void* V, const int* sel, const int* tpos,
                 void* O, float* lse, float* ws, int B, const Params& p, cudaStream_t stream) {
  const size_t smem = Smem(p.h, p.Dk, p.Dv, p.n, p.l_sel).bytes;
  cudaError_t e = cudaFuncSetAttribute(sel_attn_split_kernel<T, HMAX>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  const long long rows = (long long)B * p.S * p.G;
  sel_attn_split_kernel<T, HMAX><<<(unsigned)(rows * p.n), THREADS, smem, stream>>>(
      static_cast<const T*>(Q), static_cast<const T*>(K), static_cast<const T*>(V), sel, tpos,
      ws, p);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  sel_attn_combine_kernel<T><<<(unsigned)rows, THREADS, 0, stream>>>(ws, static_cast<T*>(O), lse,
                                                                     p);
  NSA_LAUNCH_CHECK();
}

// bf16 takes only the split design: its prefill is sel_attn_fwd_mma.cu
template <typename T>
int launch_h(const void* Q, const void* K, const void* V, const int* sel, const int* tpos,
             const float* gate, void* O, float* lse, float* ws, int B, const Params& p,
             cudaStream_t stream) {
  if (ws != nullptr) {   // decode does not fold the gate
    if (gate != nullptr) return (int)cudaErrorInvalidValue;
    return p.h <= 8 ? launch_split<T, 8>(Q, K, V, sel, tpos, O, lse, ws, B, p, stream)
                    : launch_split<T, 16>(Q, K, V, sel, tpos, O, lse, ws, B, p, stream);
  }
  if constexpr (std::is_same<T, float>::value) {
    if (p.h <= 8) return launch<T, 8>(Q, K, V, sel, tpos, gate, O, lse, B, p, stream);
    return launch<T, 16>(Q, K, V, sel, tpos, gate, O, lse, B, p, stream);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

long long nsa_sel_attn_ws_floats(int h, int Dv) { return (long long)ws_pitch(h, Dv); }

long long nsa_sel_attn_smem_bytes(int h, int Dk, int Dv, int n, int l_sel) {
  return (long long)Smem(h, Dk, Dv, n, l_sel).bytes;
}

// ws == nullptr: one block per (b, s, g) (the f32 prefill; f32 only), O
// times gate [B,S,G] f32 where one is given (the gate-epilogue fold).
// ws != nullptr: the split design (decode; gate null), ws an f32 workspace
// of B*S*G*n slots of nsa_sel_attn_ws_floats(h, Dv) floats.
int nsa_sel_attn(int dtype, const void* Q, const void* K, const void* V, const int* sel,
                 const int* tpos, const float* gate, void* O, float* lse, float* ws, int B,
                 int S, int S_kv, int G, int h, int Dk, int Dv, int n, int l_sel, float scale,
                 void* stream) {
  if (n <= 0 || l_sel <= 0 || S_kv <= 0 || h > 16 || Dv % 8 != 0 || Dk % 8 != 0 ||
      Dv / 4 > THREADS)
    return (int)cudaErrorInvalidValue;
  const Params p{S, S_kv, G, h, Dk, Dv, n, l_sel, scale};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == DT_F32) return launch_h<float>(Q, K, V, sel, tpos, gate, O, lse, ws, B, p, s);
  if (dtype == DT_BF16)
    return launch_h<__nv_bfloat16>(Q, K, V, sel, tpos, gate, O, lse, ws, B, p, s);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
