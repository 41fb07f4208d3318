// sel_attn: NSA selection-branch attention, one kernel for prefill and decode.
//
// Replaces two TPU kernels:
//   nsa_vibe_tpu/ops/pallas/sel_flash.py::selection_flash_pallas (prefill,
//     kernel _sel_flash_kernel: union of the q-tile's blocks, a mask per row);
//   nsa_vibe_tpu/ops/pallas/selection.py::selection_attention_pallas (decode,
//     kernel _sel_kernel: per-query gather of the selected blocks).
//
// What it computes, per query (b, s) and KV group g, for all h heads of the
// group: softmax in f32 over the keys of the row's selected blocks taken as
// a SET (-1 slots and repeated ids add nothing; the fused scorer emits
// forced slots that may repeat), key positions clamped to <= t (t per row,
// from tpos[b, s]) and < S_kv; a row with no visible key returns 0.
//
// What bounds it on the H100: each (b, s, g) gathers n * l_sel keys (16 x 64
// at m7c) and shares them across the h heads of the group, the paper's
// group-centric schedule (Fig. 3). At the prefill shape that is ~26 GFLOP;
// the distinct bytes (Q, O and the K/V blocks in use, ~30 MB) are small, so
// on paper the tensor cores bound it (~26 us). This FMA design is bound by
// the L2->shared gather of every selected block for every query (~4 GB at
// the prefill shape) and by shared-memory reads feeding f32 FMAs. At decode
// (S=1) there are only B*G blocks and the gather latency dominates.
// Design: one block per (b, s, g); thread 0 compacts the row's selection
// into a list of distinct visible block ids; each block's K/V rows are
// staged in shared memory as f32 with 16-byte loads, eight in flight per
// thread (rows past S_kv or t are never read). Shared-memory bandwidth is
// what the FMA phases spend, so every K row read feeds four heads (Q·K) and
// every V row read feeds all h heads (P·V, register slices per thread, key
// splits summed once at the end). Sharing blocks across the queries of a
// tile (the TPU union design) is later work.
#include "common.cuh"

using namespace nsa;

namespace {

constexpr int THREADS = 128;
constexpr int NWARPS = THREADS / 32;

struct Params {
  int S, S_kv, G, h, Dk, Dv, n, l_sel;
  float scale;
};

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

// Per block (b, s, g), for each distinct visible selected block of L keys:
//   A. logits [h, nk]: a thread takes one key and up to 4 heads, so each
//      float4 read of a K row feeds four heads;
//   B. online softmax: one warp per head;
//   C. O += P V: a thread owns 4 output dims of all h heads (HMAX register
//      slices) for one of THREADS/(Dv/4) key splits, so each float4 read of
//      a V row feeds every head; the splits are summed once at the end.
template <typename T, int HMAX>
__global__ void __launch_bounds__(THREADS)
sel_attn_kernel(const T* __restrict__ Q, const T* __restrict__ K, const T* __restrict__ V,
                const int* __restrict__ sel, const int* __restrict__ tpos, T* __restrict__ O,
                Params p) {
  extern __shared__ __align__(16) float smem[];
  __shared__ int nb_s;
  const int bid = blockIdx.x;   // (b*S + s)*G + g
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
    for (int j = 0; j < p.n; ++j) {
      const int id = sr[j];
      if (id < 0 || (long long)id * L > t || (long long)id * L >= p.S_kv) continue;
      bool dup = false;
      for (int k = 0; k < nb; ++k) dup = dup || blist[k] == id;
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
    const float den = l_s[j];
    o.x = den > 0.f ? o.x / den : 0.f;
    o.y = den > 0.f ? o.y / den : 0.f;
    o.z = den > 0.f ? o.z / den : 0.f;
    o.w = den > 0.f ? o.w / den : 0.f;
    store4<T>(O + (row0 + j) * Dv + c, o);
  }
}

template <typename T, int HMAX>
int launch(const void* Q, const void* K, const void* V, const int* sel, const int* tpos, void* O,
           int B, const Params& p, cudaStream_t stream) {
  const size_t smem = Smem(p.h, p.Dk, p.Dv, p.n, p.l_sel).bytes;
  cudaError_t e = cudaFuncSetAttribute(sel_attn_kernel<T, HMAX>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  const long long grid = (long long)B * p.S * p.G;
  sel_attn_kernel<T, HMAX><<<(unsigned)grid, THREADS, smem, stream>>>(
      static_cast<const T*>(Q), static_cast<const T*>(K), static_cast<const T*>(V), sel, tpos,
      static_cast<T*>(O), p);
  NSA_LAUNCH_CHECK();
}

template <typename T>
int launch_h(const void* Q, const void* K, const void* V, const int* sel, const int* tpos,
             void* O, int B, const Params& p, cudaStream_t stream) {
  if (p.h <= 8) return launch<T, 8>(Q, K, V, sel, tpos, O, B, p, stream);
  return launch<T, 16>(Q, K, V, sel, tpos, O, B, p, stream);
}

}  // namespace

extern "C" {

long long nsa_sel_attn_smem_bytes(int h, int Dk, int Dv, int n, int l_sel) {
  return (long long)Smem(h, Dk, Dv, n, l_sel).bytes;
}

int nsa_sel_attn(int dtype, const void* Q, const void* K, const void* V, const int* sel,
                 const int* tpos, void* O, int B, int S, int S_kv, int G, int h, int Dk, int Dv,
                 int n, int l_sel, float scale, void* stream) {
  if (n <= 0 || l_sel <= 0 || S_kv <= 0 || h > 16 || Dv % 8 != 0 || Dk % 8 != 0 ||
      Dv / 4 > THREADS)
    return (int)cudaErrorInvalidValue;
  const Params p{S, S_kv, G, h, Dk, Dv, n, l_sel, scale};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == DT_F32) return launch_h<float>(Q, K, V, sel, tpos, O, B, p, s);
  if (dtype == DT_BF16) return launch_h<__nv_bfloat16>(Q, K, V, sel, tpos, O, B, p, s);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
