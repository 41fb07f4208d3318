// sel_attn_bwd_1p: one-pass backward of the NSA selection branch, from the
// forward's row statistics.
//
// Replaces: nsa_vibe_tpu/ops/pallas/sel_flash.py::selection_flash_bwd_onepass
// (kernel _sel_onepass_bwd_kernel), the selection backward of the JAX train
// step under sel.bwd_onepass = 1.
//
// What it computes: the same dQ, dK, dV as sel_attn_bwd.cu (the two-pass
// design, sel_flash.py::selection_flash_bwd): per query (b, s) and group g,
// softmax over the keys of the row's selected blocks taken as a SET, key
// positions <= t = tpos[b, s] and < S_kv; -1 slots and repeated block ids
// add nothing; outputs in the operands' dtype, accumulated in f32
// (notation: bwd_common.cuh).
//
// What bounds it on the H100: as sel_attn_bwd's, ~5 products per visible
// (row, key) pair, tensor-core bound on paper; this f32 FMA design is
// bound by FMA issue and shared-memory reads. It drops the two-pass
// design's query-major dQ pass, which re-gathers each query's blocks and
// forms S, P, dP and dS a second time.
// Design: one kv-block-major pass, one block per (b, g, selection block,
// sub-tile of <= 64 keys, split), as sel_attn_bwd's dK/dV pass: it keeps
// its K/V tile in shared memory and streams the member rows of the block
// from the inverse index (ops/cuda/sel_attn_bwd_1p.py::
// selection_slot_index, built on the device), TQ tokens per chunk; dK/dV
// stay in registers. The chunk's dS tile also gives each member row its
// partial dQ = dS K_tile, written to an f32 slot workspace ws[slot][row]
// with slot = rank * nsub + sub, rank = the block's rank among the row's
// distinct visible blocks (ascending id, < n) and nsub the key sub-tiles
// per block; each (slot, row) has exactly one writer (sub-tiles past S_kv
// still write zeros). sum_slots then adds each row's nblk * nsub slots in
// order. dK/dV go through per-split f32 partials summed in split order (one
// split too: the partial is then only cast). No float atomics: two
// launches give identical bits.
#include "bwd_common.cuh"

using namespace nsa;
using namespace nsa::bwd;

namespace {

struct Params {
  int B, S, S_kv, G, h, Dk, Dv, l_sel, TQ, nsplit, inv_pitch;
  float scale;
};

// slots a row (b, s, g, head) wrote: its distinct visible blocks' sub-tiles
struct SelSlots {
  const int* nblk;   // [B,S,G]
  int h, nsub;
  __device__ int operator()(long long row) const { return nblk[row / h] * nsub; }
};

// shared memory (floats), 256 threads
struct Smem {
  size_t q, dO, k, v, p, ds, lse, dl, tok, tpos, rank, total;
  __host__ __device__ Smem(int Dk, int Dv) {
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
    rank = tpos + MAX_ROWS; // ints: the block's rank in each member's set
    total = rank + MAX_ROWS;
  }
};

template <typename T, int NSK, int NSV, int NSQ>
__global__ void __launch_bounds__(THREADS)
sel_bwd_1p_kernel(const T* __restrict__ Q, const T* __restrict__ K, const T* __restrict__ V,
                  const T* __restrict__ dO, const float* __restrict__ lse,
                  const float* __restrict__ delta, const int* __restrict__ inv,
                  const int* __restrict__ cnt, const int* __restrict__ rnk,
                  const int* __restrict__ tpos, float* __restrict__ dK, float* __restrict__ dV,
                  float* __restrict__ ws, Params p) {
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
  // keys of this tile; 0 for a sub-tile past S_kv, which still writes its
  // members' (zero) dQ slots
  const int nk = max(min(min(KC, L - sub * KC), p.S_kv - k0), 0);
  const int h = p.h, Dk = p.Dk, Dv = p.Dv;
  const int kp = Dk + 4, vp = Dv + 4;
  const size_t slot_stride = (size_t)p.B * p.S * p.G * h * Dk;

  const Smem S_(Dk, Dv);
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
  int* rk_s = reinterpret_cast<int*>(smem + S_.rank);

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
  const int* ranks = rnk + lst * p.inv_pitch;
  const int count = cnt[lst];
  const int per = ((count + p.nsplit - 1) / p.nsplit + p.TQ - 1) / p.TQ * p.TQ;
  const int ia = split * per;
  const int ib = min(count, ia + per);
  const int d4 = Dk / 4;

  for (int i0 = ia; i0 < ib; i0 += p.TQ) {
    const int nt = min(p.TQ, ib - i0);
    const int rows = nt * h;
    __syncthreads();   // previous chunk consumed (and the K/V tile staged)
    for (int i = threadIdx.x; i < nt; i += THREADS) {
      const int s = list[i0 + i];
      tok_s[i] = s;
      tp_s[i] = tpos[(size_t)b * p.S + s];
      rk_s[i] = ranks[i0 + i];
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
    float4 q_acc[NSQ][4];
#pragma unroll
    for (int i = 0; i < NSQ; ++i)
#pragma unroll
      for (int r = 0; r < 4; ++r) q_acc[i][r] = make_float4(0.f, 0.f, 0.f, 0.f);
    accumulate_q_rows<NSQ>(q_acc, ds_s, k_s, nk, Dk, kp);
#pragma unroll
    for (int i = 0; i < NSQ; ++i) {
      const int e = threadIdx.x + THREADS * i;
      const int rq = e / d4, c4 = e - (e / d4) * d4;
      if (rq >= MAX_ROWS / 4) continue;
#pragma unroll
      for (int r4 = 0; r4 < 4; ++r4) {
        const int r = 4 * rq + r4;
        if (r < rows) {
          const int slot = rk_s[r / h] * nsub + sub;
          *reinterpret_cast<float4*>(ws + slot * slot_stride + row_of(r) * Dk + 4 * c4) =
              q_acc[i][r4];
        }
      }
    }
  }
  const size_t row0 = (((size_t)split * p.B + b) * p.G + g) * p.S_kv + k0;
  store_kv<float, NSK>(dk_acc, dK, row0, nk, Dk, p.scale);
  store_kv<float, NSV>(dv_acc, dV, row0, nk, Dv, 1.f);
}

template <typename T, int NSK, int NSV>
int launch_ns(const void* Q, const void* K, const void* V, const void* dO, const float* lse,
              const float* delta, const int* tpos, const int* inv, const int* cnt,
              const int* rnk, const int* nblk, void* dQ, void* dK, void* dV, float* part,
              float* ws, const Params& p, cudaStream_t stream) {
  const size_t smem = Smem(p.Dk, p.Dv).total * sizeof(float);
  const int nsub = (p.l_sel + KC - 1) / KC;
  const long long NB = (p.S_kv + p.l_sel - 1) / p.l_sel;
  const unsigned grid = (unsigned)((long long)p.B * p.G * NB * nsub * p.nsplit);
  const long long nk_el = (long long)p.B * p.G * p.S_kv * p.Dk;
  const long long nv_el = (long long)p.B * p.G * p.S_kv * p.Dv;
  float* part_k = part;
  float* part_v = part + (size_t)p.nsplit * nk_el;
  cudaError_t e = cudaFuncSetAttribute(sel_bwd_1p_kernel<T, NSK, NSV, NSK>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  // every key below S_kv lies in exactly one tile, which writes its partial
  // for every split (zeros where the split has no member)
  sel_bwd_1p_kernel<T, NSK, NSV, NSK><<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(Q), static_cast<const T*>(K), static_cast<const T*>(V),
      static_cast<const T*>(dO), lse, delta, inv, cnt, rnk, tpos, part_k, part_v, ws, p);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const int rk = reduce_splits<T>(part_k, dK, nk_el, p.nsplit, stream);
  if (rk != 0) return rk;
  const int rv = reduce_splits<T>(part_v, dV, nv_el, p.nsplit, stream);
  if (rv != 0) return rv;
  const long long rows = (long long)p.B * p.S * p.G * p.h;
  return sum_slots<T>(ws, dQ, rows, p.Dk, SelSlots{nblk, p.h, nsub}, p.scale, stream);
}

template <typename T>
int launch(const void* Q, const void* K, const void* V, const void* dO, const float* lse,
           const float* delta, const int* tpos, const int* inv, const int* cnt, const int* rnk,
           const int* nblk, void* dQ, void* dK, void* dV, float* part, float* ws,
           const Params& p, cudaStream_t stream) {
  const int nk = kv_slices(p.Dk), nv = kv_slices(p.Dv);
  if (nk == 1 && nv == 1)
    return launch_ns<T, 1, 1>(Q, K, V, dO, lse, delta, tpos, inv, cnt, rnk, nblk, dQ, dK, dV,
                              part, ws, p, stream);
  if (nk == 1)
    return launch_ns<T, 1, 2>(Q, K, V, dO, lse, delta, tpos, inv, cnt, rnk, nblk, dQ, dK, dV,
                              part, ws, p, stream);
  if (nv == 1)
    return launch_ns<T, 2, 1>(Q, K, V, dO, lse, delta, tpos, inv, cnt, rnk, nblk, dQ, dK, dV,
                              part, ws, p, stream);
  return launch_ns<T, 2, 2>(Q, K, V, dO, lse, delta, tpos, inv, cnt, rnk, nblk, dQ, dK, dV,
                            part, ws, p, stream);
}

}  // namespace

extern "C" {

long long nsa_sel_attn_bwd_1p_smem_bytes(int Dk, int Dv) {
  return (long long)(Smem(Dk, Dv).total * sizeof(float));
}

// inv/rank [B,G,NB,inv_pitch] int32: row (b, g, block) lists the member
// query rows s (ascending) whose selection set holds the block, and the
// block's rank among each member's distinct visible blocks; cnt [B,G,NB]
// their number; nblk [B,S,G] each row's distinct visible blocks. part: f32
// scratch of nsplit * B*G*S_kv*(Dk+Dv) floats. ws: f32 dQ workspace of max(nblk) * ceil(l_sel/64) * B*S*G*h*Dk
// floats (at most min(n, NB) blocks per row).
int nsa_sel_attn_bwd_1p(int dtype, const void* Q, const void* K, const void* V, const void* dO,
                        const float* lse, const float* delta, const int* tpos, const int* inv,
                        const int* cnt, const int* rank, const int* nblk, void* dQ, void* dK,
                        void* dV, float* part, float* ws, int B, int S, int S_kv, int G, int h,
                        int Dk, int Dv, int l_sel, int inv_pitch, float scale, int TQ,
                        int nsplit, void* stream) {
  if (l_sel <= 0 || S_kv <= 0 || TQ <= 0 || TQ * h > MAX_ROWS || nsplit <= 0 || Dk % 8 != 0 ||
      Dv % 8 != 0 || Dk > 128 || Dv > 128 || part == nullptr || ws == nullptr)
    return (int)cudaErrorInvalidValue;
  const Params p{B, S, S_kv, G, h, Dk, Dv, l_sel, TQ, nsplit, inv_pitch, scale};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == DT_F32)
    return launch<float>(Q, K, V, dO, lse, delta, tpos, inv, cnt, rank, nblk, dQ, dK, dV, part,
                         ws, p, s);
  if (dtype == DT_BF16)
    return launch<__nv_bfloat16>(Q, K, V, dO, lse, delta, tpos, inv, cnt, rank, nblk, dQ, dK,
                                 dV, part, ws, p, s);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
