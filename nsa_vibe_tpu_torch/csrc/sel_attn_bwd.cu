// sel_attn_bwd: two-pass backward of the NSA selection branch, from the
// forward's row statistics.
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
// h=6, D=64, n=16 blocks of 64) ~5 products of 2 FLOP per visible (row,
// key) pair, ~0.09 TFLOP: 0.0957 ms of bf16 tensor-core time. The dQ pass
// re-reads K/V blocks from L2 (8 MB in bf16), and needs no workspace.
// Design, two passes with no float atomics:
//   dQ  (query-major). bf16: `sel_bwd_dq_union_kernel`, the TPU kernel's
//       design (_sel_dq_kernel) cut for Hopper: one CTA (4 warps) per
//       (b, g, q tile of T tokens, T*h <= 64 rows, warp w rows [16w,
//       16w+16)). It walks the union of the tile's distinct visible blocks
//       (ascending; built on the device as _tile_active + _compact_active
//       build theirs, with each row's membership as a bitmask over the
//       union: ops/cuda/sel_attn_bwd.py::selection_tile_union), K/V tiles
//       of 64 keys double-buffered through cp.async. S = Q K^T and dP =
//       dO V^T run on mma.m16n8k16 (tc.cuh); membership, causality and
//       S_kv are masked in the fragments; dS = P (dP - delta), rounded to
//       bf16 as the TPU kernel rounds it (sel_flash.py:438), is the A
//       operand of dQ += dS K, which stays exact in f32 registers. f32
//       operands keep the FMA design `sel_bwd_dq_kernel`: one block per
//       (b, s, g); thread 0 compacts the row's selection into distinct
//       visible block ids; each block's K/V rows are staged as f32, S and
//       dP are formed for the group's h heads, dS goes to shared memory and
//       dQ stays in registers. (The f32 checks' bounds are 5e-5 relative:
//       TF32 would break them.)
//   dKV (kv-block-major): the kv pass of sel_bwd.cuh without dQ slots
//       (sel_attn_bwd_1p.cu).
#include "bwd_common.cuh"
#include "sel_bwd.cuh"
#include "tc.cuh"

using namespace nsa;
using namespace nsa::bwd;

namespace {

constexpr int QTHREADS = 128;   // dQ pass (one query per block, as the forward)
constexpr float LOG2E = 1.4426950408889634f;

struct Params {
  int B, S, S_kv, G, h, Dk, Dv, n, l_sel, U, W, qT;
  float scale;
};

// ------------------------------------------------------------ f32: FMA

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

template <int HMAX>
__global__ void __launch_bounds__(QTHREADS)
sel_bwd_dq_kernel(const float* __restrict__ Q, const float* __restrict__ K,
                  const float* __restrict__ V, const float* __restrict__ dO,
                  const float* __restrict__ lse, const float* __restrict__ delta,
                  const int* __restrict__ sel, const int* __restrict__ tpos,
                  float* __restrict__ dQ, Params p) {
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
  load_rows_vec<float>(q_s, Dk, Q + row0 * Dk, Dk, 0, h, h);
  load_rows_vec<float>(do_s, Dv, dO + row0 * Dv, Dv, 0, h, h);
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
  const float* Kbg = K + ((size_t)b * p.G + g) * p.S_kv * Dk;
  const float* Vbg = V + ((size_t)b * p.G + g) * p.S_kv * Dv;

  for (int bi = 0; bi < nb; ++bi) {
    const int k0 = blist[bi] * L;
    const int kend = min(min(k0 + L, t + 1), p.S_kv);   // visible keys [k0, kend)
    const int nk = kend - k0;
    __syncthreads();   // previous block's K/V and dS consumed
    load_rows_vec<float, 8>(k_s, kp, Kbg, Dk, k0, nk, kend);
    load_rows_vec<float, 8>(v_s, vp, Vbg, Dv, k0, nk, kend);
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
    store4<float>(dQ + (row0 + j) * Dk + c,
                  make_float4(o.x * p.scale, o.y * p.scale, o.z * p.scale, o.w * p.scale));
  }
}

// ------------------------------------------------------------ bf16: union, tensor cores

template <int DT>
struct Union {
  static constexpr int ROWS = 64;     // query rows (tokens x heads) per q tile
  static constexpr int P = DT + 8;    // tile pitch (tc.cuh)
  static constexpr size_t TILE = (size_t)ROWS * P * 2;   // = KC keys
  // Q, dO, K[2], V[2] (bf16); lse*log2e, delta (f32), positions (int) per
  // row; then the q tile's membership words (int)
  static constexpr size_t Q = 0, DO = TILE, K = 2 * TILE, V = 4 * TILE, STATS = 6 * TILE;
  static constexpr size_t MASK = STATS + (size_t)3 * ROWS * 4;
  static size_t bytes(int qT, int W) { return MASK + (size_t)qT * W * 4; }
};

template <int DT>
__global__ void __launch_bounds__(128)
sel_bwd_dq_union_kernel(const __nv_bfloat16* __restrict__ Q, const __nv_bfloat16* __restrict__ K,
                        const __nv_bfloat16* __restrict__ V, const __nv_bfloat16* __restrict__ dO,
                        const float* __restrict__ lse, const float* __restrict__ delta,
                        const int* __restrict__ tpos, const int* __restrict__ uorder,
                        const int* __restrict__ ucount, const int* __restrict__ umask,
                        __nv_bfloat16* __restrict__ dQ, Params p) {
  using C = Union<DT>;
  constexpr int P = C::P;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int nq = (p.S + p.qT - 1) / p.qT;
  const int qt = blockIdx.x % nq;
  const int bg = blockIdx.x / nq;   // b * G + g
  const int g = bg % p.G, b = bg / p.G;
  const int s0 = qt * p.qT;
  const int h = p.h, Dk = p.Dk, Dv = p.Dv, L = p.l_sel, W = p.W;
  const int R = min(p.qT, p.S - s0) * h;   // live rows of the tile
  const int nsub = (L + KC - 1) / KC;
  const int tid = threadIdx.x, w = tid >> 5, lane = tid & 31, g8 = lane >> 2, t4 = lane & 3;
  const float sl2 = p.scale * LOG2E;

  __nv_bfloat16* q_s = reinterpret_cast<__nv_bfloat16*>(smem_raw + C::Q);
  __nv_bfloat16* do_s = reinterpret_cast<__nv_bfloat16*>(smem_raw + C::DO);
  __nv_bfloat16* k_s = reinterpret_cast<__nv_bfloat16*>(smem_raw + C::K);   // [2][KC][P]
  __nv_bfloat16* v_s = reinterpret_cast<__nv_bfloat16*>(smem_raw + C::V);   // [2][KC][P]
  float* lse_s = reinterpret_cast<float*>(smem_raw + C::STATS);
  float* dl_s = lse_s + C::ROWS;
  int* tp_s = reinterpret_cast<int*>(dl_s + C::ROWS);
  int* mask_s = reinterpret_cast<int*>(smem_raw + C::MASK);   // [qT][W]

  // global row of tile row r: token s0 + r / h, head r % h
  auto grow = [&](int r) -> size_t {
    return (((size_t)b * p.S + s0 + r / h) * p.G + g) * h + r % h;
  };
  // head-width padding: columns [D, DT) stay zero
  for (int idx = tid; idx < C::ROWS * (DT / 8); idx += 128) {
    const int r = idx / (DT / 8), c = (idx % (DT / 8)) * 8;
    const uint4 z = make_uint4(0u, 0u, 0u, 0u);
    if (c >= Dk) {
      *reinterpret_cast<uint4*>(q_s + r * P + c) = z;
      *reinterpret_cast<uint4*>(k_s + r * P + c) = z;
      *reinterpret_cast<uint4*>(k_s + (KC + r) * P + c) = z;
    }
    if (c >= Dv) {
      *reinterpret_cast<uint4*>(do_s + r * P + c) = z;
      *reinterpret_cast<uint4*>(v_s + r * P + c) = z;
      *reinterpret_cast<uint4*>(v_s + (KC + r) * P + c) = z;
    }
  }
  for (int idx = tid; idx < C::ROWS * (Dk / 8); idx += 128) {
    const int r = idx / (Dk / 8), c = (idx % (Dk / 8)) * 8;
    tc::cp_async16(q_s + r * P + c, r < R ? Q + grow(r) * Dk + c : Q, r < R);
  }
  for (int idx = tid; idx < C::ROWS * (Dv / 8); idx += 128) {
    const int r = idx / (Dv / 8), c = (idx % (Dv / 8)) * 8;
    tc::cp_async16(do_s + r * P + c, r < R ? dO + grow(r) * Dv + c : dO, r < R);
  }
  for (int r = tid; r < C::ROWS; r += 128) {
    const bool live = r < R;
    lse_s[r] = live ? lse[grow(r)] * LOG2E : 0.f;
    dl_s[r] = live ? delta[grow(r)] : 0.f;
    tp_s[r] = live ? tpos[(size_t)b * p.S + s0 + r / h] : -1;   // padded rows see no key
  }
  for (int idx = tid; idx < min(p.qT, p.S - s0) * W; idx += 128)
    mask_s[idx] = umask[(((size_t)b * p.S + s0 + idx / W) * p.G + g) * W + idx % W];

  const size_t tile = (size_t)bg * nq + qt;
  const int* order = uorder + tile * p.U;
  const int J = ucount[tile] * nsub;   // key tiles of the union
  const __nv_bfloat16* Kbg = K + (size_t)bg * p.S_kv * Dk;
  const __nv_bfloat16* Vbg = V + (size_t)bg * p.S_kv * Dv;
  auto tile_keys = [&](int j, int& k0) {   // first key and key count of union tile j
    const int sub = j % nsub;
    k0 = order[j / nsub] * L + sub * KC;
    return max(min(min(KC, L - sub * KC), p.S_kv - k0), 0);
  };
  auto issue = [&](int j, int buf) {
    int k0;
    const int nk = tile_keys(j, k0);
    __nv_bfloat16* kb = k_s + buf * KC * P;
    __nv_bfloat16* vb = v_s + buf * KC * P;
    for (int idx = tid; idx < KC * (Dk / 8); idx += 128) {
      const int r = idx / (Dk / 8), c = (idx % (Dk / 8)) * 8;
      tc::cp_async16(kb + r * P + c, r < nk ? Kbg + (size_t)(k0 + r) * Dk + c : K, r < nk);
    }
    for (int idx = tid; idx < KC * (Dv / 8); idx += 128) {
      const int r = idx / (Dv / 8), c = (idx % (Dv / 8)) * 8;
      tc::cp_async16(vb + r * P + c, r < nk ? Vbg + (size_t)(k0 + r) * Dv + c : V, r < nk);
    }
  };

  float dq[DT / 8][4];
#pragma unroll
  for (int i = 0; i < DT / 8; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) dq[i][e] = 0.f;
  const int r0 = 16 * w;   // this warp's rows
  if (J > 0) issue(0, 0);
  tc::cp_async_commit();
  for (int j = 0; j < J; ++j) {
    const int buf = j & 1;
    if (j + 1 < J) {   // the next tile's copy overlaps this tile's math
      issue(j + 1, buf ^ 1);
      tc::cp_async_commit();
      tc::cp_async_wait<1>();
    } else {
      tc::cp_async_wait<0>();
    }
    __syncthreads();
    if (r0 < R) {
      int k0;
      const int nk = tile_keys(j, k0);
      const int u = j / nsub;
      const __nv_bfloat16* kb = k_s + buf * KC * P;
      const __nv_bfloat16* vb = v_s + buf * KC * P;
      float s[KC / 8][4], dp[KC / 8][4];
#pragma unroll
      for (int i = 0; i < KC / 8; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[i][e] = dp[i][e] = 0.f;
      tc::mma_tile<KC / 8, DT / 16, false>(
          s, [&](int ks, uint32_t (&f)[4]) { tc::ldsm_x4(f, tc::a_addr(q_s, P, r0, 16 * ks)); },
          kb, P);
      tc::mma_tile<KC / 8, DT / 16, false>(
          dp, [&](int ks, uint32_t (&f)[4]) { tc::ldsm_x4(f, tc::a_addr(do_s, P, r0, 16 * ks)); },
          vb, P);
      // membership of this thread's two rows in union block u
      bool mem[2];
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const int r = r0 + g8 + 8 * hf;
        mem[hf] = r < R && ((mask_s[(r / h) * W + (u >> 5)] >> (u & 31)) & 1);
      }
      // P and dS in place (C element e: row r0 + g8 (+8 for e >= 2), key 8i + 2 t4 + (e & 1))
#pragma unroll
      for (int i = 0; i < KC / 8; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = r0 + g8 + (e >> 1) * 8, key = 8 * i + 2 * t4 + (e & 1);
          const bool vis = mem[e >> 1] && key < nk && k0 + key <= tp_s[r];
          const float pr = vis ? exp2f(s[i][e] * sl2 - lse_s[r]) : 0.f;
          s[i][e] = pr * (dp[i][e] - dl_s[r]);
        }
      // dQ += dS K (dS rounded to bf16 in the A fragments, K by ldmatrix.trans)
      tc::mma_tile<DT / 8, KC / 16, true>(
          dq, [&](int ks, uint32_t (&f)[4]) { tc::a_from_c(f, s[2 * ks], s[2 * ks + 1]); }, kb,
          P);
    }
    __syncthreads();   // this buffer is refilled next
  }
  tc::cp_async_wait<0>();   // a tile with no union block still staged Q/dO
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    const int r = r0 + g8 + 8 * hf;
    if (r >= R) continue;
    __nv_bfloat16* dst = dQ + grow(r) * Dk;
#pragma unroll
    for (int i = 0; i < DT / 8; ++i) {
      const int dim = 8 * i + 2 * t4;
      if (dim < Dk)
        *reinterpret_cast<uint32_t*>(dst + dim) =
            tc::pack_bf16(dq[i][2 * hf] * p.scale, dq[i][2 * hf + 1] * p.scale);
    }
  }
}

template <typename Kern>
int set_smem(Kern kernel, size_t bytes) {
  return (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   (int)bytes);
}

int launch_dq_f32(const void* Q, const void* K, const void* V, const void* dO, const float* lse,
                  const float* delta, const int* sel, const int* tpos, void* dQ, const Params& p,
                  cudaStream_t stream) {
  const size_t smem = SmemQ(p.h, p.Dk, p.Dv, p.n, p.l_sel).bytes;
  const unsigned grid = (unsigned)((long long)p.B * p.S * p.G);
  auto go = [&](auto kernel) {
    const int e = set_smem(kernel, smem);
    if (e != 0) return e;
    kernel<<<grid, QTHREADS, smem, stream>>>(
        static_cast<const float*>(Q), static_cast<const float*>(K), static_cast<const float*>(V),
        static_cast<const float*>(dO), lse, delta, sel, tpos, static_cast<float*>(dQ), p);
    return (int)cudaGetLastError();
  };
  return p.h <= 8 ? go(sel_bwd_dq_kernel<8>) : go(sel_bwd_dq_kernel<16>);
}

int launch_dq_bf16(const void* Q, const void* K, const void* V, const void* dO, const float* lse,
                   const float* delta, const int* tpos, const int* uorder, const int* ucount,
                   const int* umask, void* dQ, const Params& p, cudaStream_t stream) {
  const unsigned grid = (unsigned)((long long)p.B * p.G * ((p.S + p.qT - 1) / p.qT));
  auto go = [&](auto kernel, size_t smem) {
    const int e = set_smem(kernel, smem);
    if (e != 0) return e;
    kernel<<<grid, 128, smem, stream>>>(
        static_cast<const __nv_bfloat16*>(Q), static_cast<const __nv_bfloat16*>(K),
        static_cast<const __nv_bfloat16*>(V), static_cast<const __nv_bfloat16*>(dO), lse, delta,
        tpos, uorder, ucount, umask, static_cast<__nv_bfloat16*>(dQ), p);
    return (int)cudaGetLastError();
  };
  if (p.Dk > 64 || p.Dv > 64)
    return go(sel_bwd_dq_union_kernel<128>, Union<128>::bytes(p.qT, p.W));
  return go(sel_bwd_dq_union_kernel<64>, Union<64>::bytes(p.qT, p.W));
}

}  // namespace

extern "C" {

// which 0: the dQ pass (h, Dk, Dv, n, l_sel; qT, W for bf16); which 1: the kv pass
long long nsa_sel_attn_bwd_smem_bytes(int which, int dtype, int h, int Dk, int Dv, int n,
                                      int l_sel, int qT, int W) {
  if (which == 1) return nsa::sel::kv_smem_bytes(dtype, Dk, Dv);
  if (dtype == DT_F32) return (long long)SmemQ(h, Dk, Dv, n, l_sel).bytes;
  return (long long)((Dk > 64 || Dv > 64) ? Union<128>::bytes(qT, W) : Union<64>::bytes(qT, W));
}

// inv [B,G,NB,inv_pitch] int32: row (b, g, block) lists the member query
// rows s (ascending) whose selection set holds the block; cnt [B,G,NB]
// their number; work/span: the kv pass's work list (sel_bwd.cuh), items of
// `per` tokens; part: f32 scratch of n_work * ceil(l_sel/64) * 64 *
// (Dk+Dv) floats. bf16 (the union dQ kernel): uorder [B,G,nq,U] the
// distinct visible blocks of each q tile of qT tokens (ascending, columns
// [0, ucount)), ucount [B,G,nq], umask [B,S,G,W] bit u of word u/32 set
// when the row's set holds uorder[u]; sel is then unused. f32: sel
// [B,S,G,n]; the union tables are unused.
int nsa_sel_attn_bwd(int dtype, const void* Q, const void* K, const void* V, const void* dO,
                     const float* lse, const float* delta, const int* sel, const int* tpos,
                     const int* inv, const int* cnt, const int* work, const int* span,
                     const int* uorder, const int* ucount, const int* umask, void* dQ, void* dK,
                     void* dV, float* part, int B, int S, int S_kv, int G, int h, int Dk, int Dv,
                     int n, int l_sel, int inv_pitch, int n_work, int TQ, int per, int U, int W,
                     int qT, float scale, void* stream) {
  if (n <= 0 || l_sel <= 0 || S_kv <= 0 || h <= 0 || h > 16 || Dk % 8 != 0 || Dv % 8 != 0 ||
      Dk > 128 || Dv > 128)
    return (int)cudaErrorInvalidValue;
  const Params p{B, S, S_kv, G, h, Dk, Dv, n, l_sel, U, W, qT, scale};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int e;
  if (dtype == DT_F32) {
    e = launch_dq_f32(Q, K, V, dO, lse, delta, sel, tpos, dQ, p, s);
  } else if (dtype == DT_BF16) {
    if (qT <= 0 || qT * h > Union<64>::ROWS || U <= 0 || W <= 0 || U > 32 * W ||
        uorder == nullptr || ucount == nullptr || umask == nullptr)
      return (int)cudaErrorInvalidValue;
    e = launch_dq_bf16(Q, K, V, dO, lse, delta, tpos, uorder, ucount, umask, dQ, p, s);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  if (e != 0) return e;
  const nsa::sel::KvArgs a{Q, K, V, dO, lse, delta, tpos, inv, cnt, nullptr, work, span, nullptr,
                           nullptr, dK, dV, part, nullptr};
  const nsa::sel::KvParams kp{B, S, S_kv, G, h, Dk, Dv, l_sel, inv_pitch, n_work, TQ, per, scale};
  return nsa::sel::launch_kv(dtype, a, kp, s);
}

}  // extern "C"
