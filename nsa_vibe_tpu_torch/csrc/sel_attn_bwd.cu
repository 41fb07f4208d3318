// sel_attn_bwd: backward of the NSA selection branch, from the forward's
// row statistics.
//
// Replaces: nsa_vibe_tpu/ops/pallas/sel_flash.py::selection_flash_bwd
// (kernels _sel_dq_kernel and _sel_dkv_kernel: the two-pass design), the
// selection backward of the JAX train step under sel.bwd_onepass = 0
// (ops/tuning.py).
//
// What it computes: dQ, dK, dV of sel_attn's forward (per query (b, s) and
// group g, softmax over the keys of the row's selected blocks taken as a
// SET, key positions <= t = tpos[b, s] and < S_kv) given dO, lse and
// delta = rowsum(dO*O); outputs in the operands' dtype, accumulated in f32
// (notation: bwd_common.cuh). -1 slots and repeated block ids add nothing,
// as in the forward (`member = any(sel_q == blk)`, sel_flash.py).
//
// What bounds it on the H100: at the m7c training shape (B=8, S=2048, G=2,
// h=6, D=64, n=16 blocks of 64) ~5 products over the ~0.17 G visible
// (row, key) pairs, ~0.2 TFLOP, against ~60 MB of distinct operands: the
// tensor cores bound it on paper (~0.2 ms). This f32 FMA design is bound
// by FMA issue, shared-memory reads and, in the dQ pass, by re-gathering
// each query's blocks, as the forward.
// Design, two passes with no float atomics:
//   dQ  (query-major, as sel_attn's forward): one block per (b, s, g);
//       thread 0 compacts the row's selection into distinct visible block
//       ids; each block's K/V rows are staged in shared memory, S and dP
//       are formed for the group's h heads, dS goes to shared memory and
//       dQ stays in registers (4 dims of every head per thread, key
//       splits summed once at the end).
//   dKV (kv-block-major): one block per (b, g, selection block, sub-tile
//       of <= 64 keys, split) keeps its K/V tile in shared memory and
//       streams the query rows whose set holds the block, from an inverse
//       index built by the wrapper on the device (the member tokens of each
//       (b, g, block) in ascending order, and their count), TQ tokens per
//       chunk; dK/dV as in banded_bwd's kv pass. With nsplit > 1 each
//       split takes a contiguous share of the member list and writes an f32
//       partial that `reduce_splits` adds in split order.
#include "bwd_common.cuh"

using namespace nsa;
using namespace nsa::bwd;

namespace {

constexpr int QTHREADS = 128;   // dQ pass (one query per block, as the forward)

struct Params {
  int B, S, S_kv, G, h, Dk, Dv, n, l_sel, TQ, nsplit, inv_pitch;
  float scale;
};

// dQ pass shared memory (floats): Q and dO rows, lse, delta, one block of
// K (pitch Dk+4) and V (pitch Dv+4), dS [h][L]; then the block-id list.
// The K/V area is reused at the end for the key splits' partial dQ.
struct SmemQ {
  size_t q, dO, lse, dl, k, v, ds, ids, bytes;
  __host__ __device__ SmemQ(int h, int Dk, int Dv, int n, int L) {
    q = 0;
    dO = q + round4((size_t)h * Dk);
    lse = dO + round4((size_t)h * Dv);
    dl = lse + round4(h);
    k = dl + round4(h);
    v = k + round4((size_t)L * (Dk + 4));
    const size_t kv = round4((size_t)L * (Dk + 4)) + round4((size_t)L * (Dv + 4));
    const size_t partial = (size_t)(QTHREADS / (Dk / 4)) * h * Dk;
    ds = k + (kv > partial ? kv : round4(partial));
    ids = ds + round4((size_t)h * L);
    bytes = ids * sizeof(float) + (size_t)n * sizeof(int);
  }
};

template <typename T, int HMAX>
__global__ void __launch_bounds__(QTHREADS)
sel_bwd_dq_kernel(const T* __restrict__ Q, const T* __restrict__ K, const T* __restrict__ V,
                  const T* __restrict__ dO, const float* __restrict__ lse,
                  const float* __restrict__ delta, const int* __restrict__ sel,
                  const int* __restrict__ tpos, T* __restrict__ dQ, Params p) {
  extern __shared__ __align__(16) float smem[];
  __shared__ int nb_s;
  const int bid = blockIdx.x;   // (b*S + s)*G + g
  const int g = bid % p.G;
  const int bs = bid / p.G;
  const int b = bs / p.S;
  const int t = tpos[bs];
  const int h = p.h, Dk = p.Dk, Dv = p.Dv, L = p.l_sel;
  const int tid = threadIdx.x;

  const SmemQ S_(h, Dk, Dv, p.n, L);
  float* q_s = smem + S_.q;     // [h][Dk]
  float* do_s = smem + S_.dO;   // [h][Dv]
  float* lse_s = smem + S_.lse;
  float* dl_s = smem + S_.dl;
  float* k_s = smem + S_.k;     // [L][Dk+4]
  float* v_s = smem + S_.v;     // [L][Dv+4]
  float* ds_s = smem + S_.ds;   // [h][L]
  int* blist = reinterpret_cast<int*>(smem + S_.ids);
  const int kp = Dk + 4, vp = Dv + 4;
  const int ngrp = (h + 3) / 4;
  const int d4 = Dk / 4;        // dQ ownership: dims [4*c4, 4*c4+4) for key split ks
  const int nsplit = QTHREADS / d4;
  const int c4 = tid % d4, ks = tid / d4;
  const bool owner = ks < nsplit;

  const size_t row0 = (size_t)bid * h;
  load_rows_vec<T>(q_s, Dk, Q + row0 * Dk, Dk, 0, h, h);
  load_rows_vec<T>(do_s, Dv, dO + row0 * Dv, Dv, 0, h, h);
  for (int j = tid; j < h; j += QTHREADS) {
    lse_s[j] = lse[row0 + j];
    dl_s[j] = delta[row0 + j];
  }
  if (tid == 0) {   // distinct visible block ids, as the forward
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
    const int kend = min(min(k0 + L, t + 1), p.S_kv);   // visible keys [k0, kend)
    const int nk = kend - k0;
    __syncthreads();   // previous block's K/V and dS consumed
    load_rows_vec<T, 8>(k_s, kp, Kbg, Dk, k0, nk, kend);
    load_rows_vec<T, 8>(v_s, vp, Vbg, Dv, k0, nk, kend);
    __syncthreads();
    for (int idx = tid; idx < nk * ngrp; idx += QTHREADS) {   // S, dP -> dS
      const int key = idx % nk, j0 = (idx / nk) * 4;
      float s4[4] = {0.f, 0.f, 0.f, 0.f}, p4[4] = {0.f, 0.f, 0.f, 0.f};
      const float4* kr = reinterpret_cast<const float4*>(k_s + key * kp);
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
      const float4* vr = reinterpret_cast<const float4*>(v_s + key * vp);
      for (int c = 0; c < Dv / 4; ++c) {
        const float4 vv = vr[c];
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const float4 ov = reinterpret_cast<const float4*>(do_s + min(j0 + u, h - 1) * Dv)[c];
          p4[u] = fmaf(ov.x, vv.x, p4[u]);
          p4[u] = fmaf(ov.y, vv.y, p4[u]);
          p4[u] = fmaf(ov.z, vv.z, p4[u]);
          p4[u] = fmaf(ov.w, vv.w, p4[u]);
        }
      }
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int j = j0 + u;
        if (j < h) {
          const float pr = expf(s4[u] * p.scale - lse_s[j]);
          ds_s[j * L + key] = pr * (p4[u] - dl_s[j]);
        }
      }
    }
    __syncthreads();
    if (owner) {   // dQ += dS K
      for (int key = ks; key < nk; key += nsplit) {
        const float4 kv = *reinterpret_cast<const float4*>(k_s + key * kp + 4 * c4);
#pragma unroll
        for (int j = 0; j < HMAX; ++j) {
          if (j < h) {
            const float dsj = ds_s[j * L + key];
            acc[j].x = fmaf(dsj, kv.x, acc[j].x);
            acc[j].y = fmaf(dsj, kv.y, acc[j].y);
            acc[j].z = fmaf(dsj, kv.z, acc[j].z);
            acc[j].w = fmaf(dsj, kv.w, acc[j].w);
          }
        }
      }
    }
  }
  __syncthreads();   // K/V area free: it now holds the key splits' partial dQ
  float* part = k_s;   // [nsplit][h][Dk]
  if (owner) {
#pragma unroll
    for (int j = 0; j < HMAX; ++j)
      if (j < h) *reinterpret_cast<float4*>(part + ((size_t)ks * h + j) * Dk + 4 * c4) = acc[j];
  }
  __syncthreads();
  for (int idx = tid; idx < h * d4; idx += QTHREADS) {
    const int j = idx / d4, c = (idx - j * d4) * 4;
    float4 o = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int k = 0; k < nsplit; ++k) {
      const float4 x = *reinterpret_cast<const float4*>(part + ((size_t)k * h + j) * Dk + c);
      o.x += x.x;
      o.y += x.y;
      o.z += x.z;
      o.w += x.w;
    }
    store4<T>(dQ + (row0 + j) * Dk + c,
              make_float4(o.x * p.scale, o.y * p.scale, o.z * p.scale, o.w * p.scale));
  }
}

// dKV pass shared memory (floats), 256 threads
struct SmemKV {
  size_t q, dO, k, v, p, ds, lse, dl, tok, tpos, total;
  __host__ __device__ SmemKV(int Dk, int Dv) {
    q = 0;
    dO = q + round4((size_t)MAX_ROWS * Dk);
    k = dO + round4((size_t)MAX_ROWS * Dv);
    v = k + round4((size_t)KC * (Dk + 4));
    p = v + round4((size_t)KC * (Dv + 4));
    ds = p + round4((size_t)MAX_ROWS * SP);
    lse = ds + round4((size_t)MAX_ROWS * SP);
    dl = lse + MAX_ROWS;
    tok = dl + MAX_ROWS;    // ints: the chunk's member tokens
    tpos = tok + MAX_ROWS;  // ints: their positions
    total = tpos + MAX_ROWS;
  }
};

template <typename T, typename OutT, int NSK, int NSV>
__global__ void __launch_bounds__(THREADS)
sel_bwd_dkv_kernel(const T* __restrict__ Q, const T* __restrict__ K, const T* __restrict__ V,
                   const T* __restrict__ dO, const float* __restrict__ lse,
                   const float* __restrict__ delta, const int* __restrict__ inv,
                   const int* __restrict__ cnt, const int* __restrict__ tpos,
                   OutT* __restrict__ dK, OutT* __restrict__ dV, Params p) {
  extern __shared__ __align__(16) float smem[];
  const int L = p.l_sel;
  const int nsub = (L + KC - 1) / KC;
  const int NB = (p.S_kv + L - 1) / L;
  int bid = blockIdx.x;
  const int split = bid % p.nsplit;
  bid /= p.nsplit;
  const int sub = bid % nsub;
  bid /= nsub;
  const int jb = bid % NB;
  bid /= NB;
  const int g = bid % p.G;
  const int b = bid / p.G;
  const int k0 = jb * L + sub * KC;
  const int nk = min(min(KC, L - sub * KC), p.S_kv - k0);
  if (nk <= 0) return;   // block-uniform: no key of this tile exists
  const int h = p.h, Dk = p.Dk, Dv = p.Dv;
  const int kp = Dk + 4, vp = Dv + 4;

  const SmemKV S_(Dk, Dv);
  float* q_s = smem + S_.q;
  float* do_s = smem + S_.dO;
  float* k_s = smem + S_.k;
  float* v_s = smem + S_.v;
  float* p_s = smem + S_.p;
  float* ds_s = smem + S_.ds;
  float* lse_s = smem + S_.lse;
  float* dl_s = smem + S_.dl;
  int* tok_s = reinterpret_cast<int*>(smem + S_.tok);
  int* tp_s = reinterpret_cast<int*>(smem + S_.tpos);

  load_rows_vec<T>(k_s, kp, K + ((size_t)b * p.G + g) * p.S_kv * Dk, Dk, k0, KC, k0 + nk);
  load_rows_vec<T>(v_s, vp, V + ((size_t)b * p.G + g) * p.S_kv * Dv, Dv, k0, KC, k0 + nk);
  float4 dk_acc[NSK][4], dv_acc[NSV][4];
#pragma unroll
  for (int i = 0; i < NSK; ++i)
#pragma unroll
    for (int k = 0; k < 4; ++k) dk_acc[i][k] = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
  for (int i = 0; i < NSV; ++i)
#pragma unroll
    for (int k = 0; k < 4; ++k) dv_acc[i][k] = make_float4(0.f, 0.f, 0.f, 0.f);

  // this split's share of the block's member tokens, whole chunks of TQ
  const size_t lst = ((size_t)b * p.G + g) * NB + jb;
  const int* list = inv + lst * p.inv_pitch;
  const int count = cnt[lst];
  const int per = ((count + p.nsplit - 1) / p.nsplit + p.TQ - 1) / p.TQ * p.TQ;
  const int ia = split * per;
  const int ib = min(count, ia + per);

  for (int i0 = ia; i0 < ib; i0 += p.TQ) {
    const int nt = min(p.TQ, ib - i0);
    const int rows = nt * h;
    __syncthreads();   // previous chunk consumed (and the K/V tile staged)
    for (int i = threadIdx.x; i < nt; i += THREADS) {
      const int s = list[i0 + i];
      tok_s[i] = s;
      tp_s[i] = tpos[(size_t)b * p.S + s];
    }
    __syncthreads();
    auto row_of = [&](int r) -> size_t {
      const int i = r / h;
      return (((size_t)b * p.S + tok_s[i]) * p.G + g) * h + (r - i * h);
    };
    load_rows_vec<T>(q_s, Dk, [&](int r) -> const T* { return Q + row_of(r) * Dk; }, Dk, rows);
    load_rows_vec<T>(do_s, Dv, [&](int r) -> const T* { return dO + row_of(r) * Dv; }, Dv,
                     rows);
    for (int r = threadIdx.x; r < rows; r += THREADS) {
      const size_t o = row_of(r);
      lse_s[r] = lse[o];
      dl_s[r] = delta[o];
    }
    __syncthreads();
    scores_and_ds(q_s, do_s, k_s, v_s, lse_s, dl_s, rows, Dk, Dv, kp, vp, p.scale,
                  [&](int r, int key) { return key < nk && k0 + key <= tp_s[r / h]; },
                  p_s, ds_s, SP, 1);
    __syncthreads();
    accumulate_kv<NSV>(dv_acc, p_s, do_s, rows, Dv);
    accumulate_kv<NSK>(dk_acc, ds_s, q_s, rows, Dk);
  }
  const size_t row0 = (((size_t)split * p.B + b) * p.G + g) * p.S_kv + k0;
  store_kv<OutT, NSK>(dk_acc, dK, row0, nk, Dk, p.scale);
  store_kv<OutT, NSV>(dv_acc, dV, row0, nk, Dv, 1.f);
}

template <typename T, int HMAX, int NSK, int NSV>
int launch_ns(const void* Q, const void* K, const void* V, const void* dO, const float* lse,
              const float* delta, const int* sel, const int* tpos, const int* inv,
              const int* cnt, void* dQ, void* dK, void* dV, float* part, const Params& p,
              cudaStream_t stream) {
  const T* q = static_cast<const T*>(Q);
  const T* k = static_cast<const T*>(K);
  const T* v = static_cast<const T*>(V);
  const T* o = static_cast<const T*>(dO);
  const size_t smem_q = SmemQ(p.h, p.Dk, p.Dv, p.n, p.l_sel).bytes;
  cudaError_t e = cudaFuncSetAttribute(sel_bwd_dq_kernel<T, HMAX>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem_q);
  if (e != cudaSuccess) return (int)e;
  const unsigned grid_q = (unsigned)((long long)p.B * p.S * p.G);
  sel_bwd_dq_kernel<T, HMAX><<<grid_q, QTHREADS, smem_q, stream>>>(q, k, v, o, lse, delta, sel,
                                                                  tpos, static_cast<T*>(dQ), p);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;

  const size_t smem = SmemKV(p.Dk, p.Dv).total * sizeof(float);
  const long long nsub = (p.l_sel + KC - 1) / KC;
  const long long NB = (p.S_kv + p.l_sel - 1) / p.l_sel;
  const unsigned grid = (unsigned)((long long)p.B * p.G * NB * nsub * p.nsplit);
  if (p.nsplit == 1) {
    e = cudaFuncSetAttribute(sel_bwd_dkv_kernel<T, T, NSK, NSV>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
    sel_bwd_dkv_kernel<T, T, NSK, NSV><<<grid, THREADS, smem, stream>>>(
        q, k, v, o, lse, delta, inv, cnt, tpos, static_cast<T*>(dK), static_cast<T*>(dV), p);
    return (int)cudaGetLastError();
  }
  const long long nk_el = (long long)p.B * p.G * p.S_kv * p.Dk;
  const long long nv_el = (long long)p.B * p.G * p.S_kv * p.Dv;
  float* part_k = part;
  float* part_v = part + (size_t)p.nsplit * nk_el;
  e = cudaFuncSetAttribute(sel_bwd_dkv_kernel<T, float, NSK, NSV>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  // every key below S_kv lies in exactly one tile, which writes its partial
  // for every split (zeros where the split has no member)
  sel_bwd_dkv_kernel<T, float, NSK, NSV><<<grid, THREADS, smem, stream>>>(
      q, k, v, o, lse, delta, inv, cnt, tpos, part_k, part_v, p);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const int rk = reduce_splits<T>(part_k, dK, nk_el, p.nsplit, stream);
  if (rk != 0) return rk;
  return reduce_splits<T>(part_v, dV, nv_el, p.nsplit, stream);
}

template <typename T, int HMAX>
int launch_kv(const void* Q, const void* K, const void* V, const void* dO, const float* lse,
              const float* delta, const int* sel, const int* tpos, const int* inv,
              const int* cnt, void* dQ, void* dK, void* dV, float* part, const Params& p,
              cudaStream_t stream) {
  const int nk = kv_slices(p.Dk), nv = kv_slices(p.Dv);
  if (nk == 1 && nv == 1)
    return launch_ns<T, HMAX, 1, 1>(Q, K, V, dO, lse, delta, sel, tpos, inv, cnt, dQ, dK, dV,
                                    part, p, stream);
  if (nk == 1)
    return launch_ns<T, HMAX, 1, 2>(Q, K, V, dO, lse, delta, sel, tpos, inv, cnt, dQ, dK, dV,
                                    part, p, stream);
  if (nv == 1)
    return launch_ns<T, HMAX, 2, 1>(Q, K, V, dO, lse, delta, sel, tpos, inv, cnt, dQ, dK, dV,
                                    part, p, stream);
  return launch_ns<T, HMAX, 2, 2>(Q, K, V, dO, lse, delta, sel, tpos, inv, cnt, dQ, dK, dV,
                                  part, p, stream);
}

template <typename T>
int launch(const void* Q, const void* K, const void* V, const void* dO, const float* lse,
           const float* delta, const int* sel, const int* tpos, const int* inv, const int* cnt,
           void* dQ, void* dK, void* dV, float* part, const Params& p, cudaStream_t stream) {
  if (p.h <= 8)
    return launch_kv<T, 8>(Q, K, V, dO, lse, delta, sel, tpos, inv, cnt, dQ, dK, dV, part, p,
                           stream);
  return launch_kv<T, 16>(Q, K, V, dO, lse, delta, sel, tpos, inv, cnt, dQ, dK, dV, part, p,
                          stream);
}

}  // namespace

extern "C" {

long long nsa_sel_attn_bwd_smem_bytes(int which, int h, int Dk, int Dv, int n, int l_sel) {
  if (which == 0) return (long long)SmemQ(h, Dk, Dv, n, l_sel).bytes;
  return (long long)(SmemKV(Dk, Dv).total * sizeof(float));
}

// inv [B,G,NB,inv_pitch] int32: row (b, g, block) lists the member query
// rows s (ascending) whose selection set holds the block; cnt [B,G,NB]
// their number. part: f32 scratch of nsplit * B*G*S_kv*(Dk+Dv) floats when
// nsplit > 1, else unused.
int nsa_sel_attn_bwd(int dtype, const void* Q, const void* K, const void* V, const void* dO,
                     const float* lse, const float* delta, const int* sel, const int* tpos,
                     const int* inv, const int* cnt, void* dQ, void* dK, void* dV, float* part,
                     int B, int S, int S_kv, int G, int h, int Dk, int Dv, int n, int l_sel,
                     int inv_pitch, float scale, int TQ, int nsplit, void* stream) {
  if (n <= 0 || l_sel <= 0 || S_kv <= 0 || h > 16 || TQ <= 0 || TQ * h > MAX_ROWS ||
      nsplit <= 0 || Dk % 8 != 0 || Dv % 8 != 0 || Dk > 128 || Dv > 128 ||
      (nsplit > 1 && part == nullptr))
    return (int)cudaErrorInvalidValue;
  const Params p{B, S, S_kv, G, h, Dk, Dv, n, l_sel, TQ, nsplit, inv_pitch, scale};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == DT_F32)
    return launch<float>(Q, K, V, dO, lse, delta, sel, tpos, inv, cnt, dQ, dK, dV, part, p, s);
  if (dtype == DT_BF16)
    return launch<__nv_bfloat16>(Q, K, V, dO, lse, delta, sel, tpos, inv, cnt, dQ, dK, dV, part,
                                 p, s);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
