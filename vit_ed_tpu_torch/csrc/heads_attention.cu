// 4-D attention forward for Hopper (sm_90a), head_dim 16, 32, 64 or 128.
//
// Replaces two TPU kernels of vit_ed_tpu/ops/attention.py: `_fwd_kernel_heads`
// (:219, reached through `_pallas_fwd_heads` :245 by `fused_attention` and
// `fused_attention_heads`, and by every packed wrapper whose geometry is not
// head_dim 64 with C % 128 == 0) and `_fwd_kernel` (:111, reached through
// `_pallas_fwd` :294 by `_fused_attention_padded`). The two compute the same
// function and differ only in which grid axis carries the heads: one TPU
// program takes all heads of a (batch, q block) to fetch K/V in fewer,
// larger DMAs, the other one (batch * head, q block). On Hopper a block takes
// one (batch, head, query tile) either way and reads q, k, v through batch,
// head and row strides, so one kernel serves both. Per head, with T the
// input type:
//
//   l   = dot_f32(q, k) * scale               keys stop at n_keys exactly
//   m   = max_k l;  e = exp(l - m);  s = sum_k e
//   p   = round_T(e / s)                      normalised BEFORE the product
//   out = round_T(sum_k p * v)                f32 accumulate
//
// This is not the pair kernel's chain (pre-rounded q, clamped exp2, deferred
// normalisation): the probabilities are normalised and rounded before PV, so
// the row's final m and s must be known first, and an online softmax that
// rescales an accumulator would round at other points. Up to 128 keys (the
// whole puzzle path) K and V are staged once and a warp keeps its rows' S in
// registers (16 rows x 128 keys: 64 f32 a thread): it takes m and s from
// them, forms p and runs P V, two tile products. Above 128 keys the kernel
// walks them twice, pass 1 for m and s, pass 2 recomputing l to form p and
// accumulate p v: three tile products. The TPU kernels pad Sq and Sk to 128
// and mask the pad keys to -inf; nothing is padded here, ragged tiles are
// masked.
//
// Each query row is computed alone, over the keys in a fixed order that does
// not depend on the tile it sits in or on the batch: the CLS launch
// (n_q_rows = 1) equals row 0 of the full launch and a shared k/v (batch
// stride 0) equals the materialised broadcast bit for bit.
//
// Addressing: every tensor is a base pointer plus batch, head and row strides
// in elements with a unit last stride, so q|k|v are read inside a fused
// [B, S, 3C] projection (head stride D, row stride 3C), k|v inside
// [B, Sk, 2C], a [B, H, S, D] or [B*H, S, D] tensor as it lies, and the output
// is written as [B, Sq, H, D] (merged heads) or [B, H, Sq, D]. The kernel
// allocates nothing.
//
// What bounds it on an H100: at the puzzle shapes (B = 128 pairs, 12 heads,
// S = 65, D = 32) one launch does 4 * 128 * 12 * 65 * 65 * 32 ~ 0.83 GFLOP
// (~0.8 us at 989 TFLOP/s) over ~26 MB moved (~7.6 us at 3.35 TB/s): it is
// memory-bound, and that bound is about the cost of a launch, so launch
// latency and the tile quantisation (65 rows and 65 keys) set the time. At
// B = 64, S = 1025 it is compute-bound (~103 GFLOP useful, ~0.1 ms at 989
// TFLOP/s dense bf16).
//
// The bf16 kernel's design (the backward's, heads_attention_bwd.cu):
//   - fragments by ldmatrix.x4 (S = q K^T) and ldmatrix.x4.trans (P V) from
//     tiles XOR-swizzled by 16-byte chunks, free of bank conflicts;
//   - tiles by cp.async into dynamic shared memory: all of K and V at once
//     up to 128 keys, else a ring of two slots, the next tile's copy issued
//     before the current tile's products, one barrier per tile (pass 1
//     stages K alone);
//   - query rows that fit one block (up to 128 at D <= 64) take one block of
//     as many warps as they need, so S = 65 costs one more warp, not a second
//     block; a longer sequence's last tile keeps only the warps that hold a
//     real row (S = 1025: one), the others leave at once;
//   - a ragged key tile multiplies only its 8-key groups and 16-key k-steps
//     that hold a real key, masks only inside the last group, and a tail of
//     at most 16 keys has its own instantiation;
//   - the one-pass (1 or 2 resident tiles) and two-pass schemes are template
//     instantiations chosen at launch, not a run-time branch;
//   - exp(l - m) as one FFMA and one ex2.approx.ftz (exp2(q.k * scale *
//     log2 e - m * scale * log2 e)), and 1 / s taken once per row;
//   - registers capped (kMaxRegs) for several blocks per SM.
// f32 runs on plain FMA (the tests' type).
//
// Measured on an H100 80GB HBM3 at 700 W (d = 32, 12 heads, bf16): 0.0170
// ms at B = 128, S = 65 (1.39x its 0.0123 at S = 64; 44% of the bytes
// bound), 0.99 ms at B = 64, S = 1025 (~105 TFLOP/s useful, 10.5% of the
// operations bound: three products and an exp per logit on mma.sync), 0.276
// ms for the head_dim 32 scan's chunk (B = 16, shared kv). Above 128 keys
// the rounding of p before P V keeps the second pass (p needs the row's
// final m and s); next there: wgmma.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include "attention_mma.cuh"

namespace {

struct Params {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  long long q_bs, q_hs, q_rs, k_bs, k_hs, k_rs, v_bs, v_hs, v_rs, o_bs, o_hs, o_rs;
  int n_q, n_k;
  float scale;
};

// ---------------------------------------------------------------------------
// float32 kernel, plain FMA (the tests' type; rounding to T is the identity).
// A thread quad owns one query row of the block's 32: each thread holds a
// quarter of the row's head dims, a dot product is the quad's sum of four
// partial dots (fixed order), and each thread accumulates its quarter of the
// output. Three passes over the keys: max, sum, then p and p v.
// ---------------------------------------------------------------------------

constexpr int kFmaRows = 32;
constexpr int kFmaKeys = 32;

// rows r0.. of a strided [n_total, D] f32 matrix into a [ROWS][D] tile;
// rows past the end are zeros
template <int D, int ROWS>
__device__ __forceinline__ void stage_f32(float (*dst)[D], const float* base, long long rs,
                                          int r0, int n_total, int tid) {
  for (int i = tid; i < ROWS * D; i += kThreads) {
    const int r = i / D;
    const int d = i % D;
    const int row = r0 + r;
    dst[r][d] = row < n_total ? base[row * rs + d] : 0.0f;
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads)
heads_attention_fma_f32(const Params p) {
  constexpr int kPart = D / 4;
  __shared__ float ks[kFmaKeys][D];
  __shared__ float vs[kFmaKeys][D];

  const int b = blockIdx.z;
  const int h = blockIdx.y;
  const int tid = threadIdx.x;
  const int r = tid >> 2;
  const int part = tid & 3;
  const int row = blockIdx.x * kFmaRows + r;
  const bool live = row < p.n_q;

  const float* kbase = static_cast<const float*>(p.k) + b * p.k_bs + h * p.k_hs;
  const float* vbase = static_cast<const float*>(p.v) + b * p.v_bs + h * p.v_hs;
  const float* qrow = static_cast<const float*>(p.q) + b * p.q_bs + h * p.q_hs +
                      (live ? row : 0) * p.q_rs + part * kPart;

  float qr[kPart];
#pragma unroll
  for (int d = 0; d < kPart; ++d) qr[d] = live ? qrow[d] : 0.0f;

  // pass 0: the row maximum
  float m = -CUDART_INF_F;
  for (int k0 = 0; k0 < p.n_k; k0 += kFmaKeys) {
    stage_f32<D, kFmaKeys>(ks, kbase, p.k_rs, k0, p.n_k, tid);
    __syncthreads();
    const int n = min(kFmaKeys, p.n_k - k0);
    for (int kr = 0; kr < n; ++kr) {
      float s = 0.0f;
#pragma unroll
      for (int d = 0; d < kPart; ++d) s = fmaf(qr[d], ks[kr][part * kPart + d], s);
      m = fmaxf(m, quad_sum(s) * p.scale);
    }
    __syncthreads();
  }

  // pass 1: the sum of exp(l - m)
  float sum = 0.0f;
  for (int k0 = 0; k0 < p.n_k; k0 += kFmaKeys) {
    stage_f32<D, kFmaKeys>(ks, kbase, p.k_rs, k0, p.n_k, tid);
    __syncthreads();
    const int n = min(kFmaKeys, p.n_k - k0);
    for (int kr = 0; kr < n; ++kr) {
      float s = 0.0f;
#pragma unroll
      for (int d = 0; d < kPart; ++d) s = fmaf(qr[d], ks[kr][part * kPart + d], s);
      sum += expf(quad_sum(s) * p.scale - m);
    }
    __syncthreads();
  }

  // pass 2: p = e / sum, out += p v
  float acc[kPart];
#pragma unroll
  for (int d = 0; d < kPart; ++d) acc[d] = 0.0f;
  for (int k0 = 0; k0 < p.n_k; k0 += kFmaKeys) {
    stage_f32<D, kFmaKeys>(ks, kbase, p.k_rs, k0, p.n_k, tid);
    stage_f32<D, kFmaKeys>(vs, vbase, p.v_rs, k0, p.n_k, tid);
    __syncthreads();
    const int n = min(kFmaKeys, p.n_k - k0);
    for (int kr = 0; kr < n; ++kr) {
      float s = 0.0f;
#pragma unroll
      for (int d = 0; d < kPart; ++d) s = fmaf(qr[d], ks[kr][part * kPart + d], s);
      const float pv = expf(quad_sum(s) * p.scale - m) / sum;
#pragma unroll
      for (int d = 0; d < kPart; ++d) acc[d] = fmaf(pv, vs[kr][part * kPart + d], acc[d]);
    }
    __syncthreads();
  }

  if (live) {
    float* orow = static_cast<float*>(p.o) + b * p.o_bs + h * p.o_hs + row * p.o_rs +
                  part * kPart;
#pragma unroll
    for (int d = 0; d < kPart; ++d) orow[d] = acc[d];
  }
}

// ---------------------------------------------------------------------------
// bf16 tensor-core kernel (fragment layouts, staging and ldmatrix helpers:
// attention_mma.cuh). A block has blockDim.x / 32 warps of 16 query rows;
// a warp holds its rows of q as A fragments. K and V come in 64-key tiles
// by cp.async, either all at once (kNT = 1 or 2 tiles: n_keys <= 128, one
// pass) or through a ring of kStages slots (kNT = 0: two passes).
// ---------------------------------------------------------------------------

template <int D>
struct Bf16Cfg {
  // warps of a block (16 query rows each): as many as the rows when they fit
  // one block, else kLongWarps
  static constexpr int kMaxWarps = D <= 64 ? 8 : 4;
  static constexpr int kLongWarps = 4;
  static constexpr int kN = kTile;           // keys of a staged tile
  static constexpr int kStages = 2;           // slots of the ring
  static constexpr int kResidentTiles = 2;    // one pass up to 128 keys
  static constexpr int kMaxRegs = D <= 32 ? 128 : (D == 64 ? 168 : 255);
  static constexpr int kTileBytes = kN * D * 2;
  static constexpr int kStageBytes = 2 * kTileBytes;   // a K tile, then its V tile
};

// The tile bodies below take the tile's real keys nk and two compile-time
// bounds: kRagged (nk < 64: keys >= nk are masked) and kJ, the 8-key groups
// the code may touch (8; 2 for a last tile of at most 16 keys, such as the
// 65th key of S = 65, so that its fragments are neither zeroed nor scanned
// past the first k-step). Only the groups j < jn that hold a real key are
// multiplied, and only the 16-key k-steps kk < kn of P V.

// exp(scale * (s - m)) of a raw logit s = q.k as exp2(s * c2 - off), with
// c2 = scale * log2 e and off = m * c2: one FFMA and one ex2.approx.ftz
__device__ __forceinline__ float softmax_exp(float s, float c2, float off) {
  return exp2_ftz(fmaf(s, c2, -off));
}

// pass 1 of the ring on one key tile: online row max (mr, of the raw q.k;
// off = mr * scale * log2 e) and sum l of exp2(s * c2 - off), rows g (i = 0)
// and g + 8 (i = 1)
template <int D, bool kRagged, int kJ>
__device__ __forceinline__ void stats_tile(const uint32_t (&qa)[D / 16][4], uint32_t kt,
                                           int nk, int lane, float c2, float (&mr)[2],
                                           float (&off)[2], float (&l)[2]) {
  const int jn = kRagged ? (nk + 7) / 8 : 8;
  const int t = lane & 3;
  float s[8][4];
  mma_frags_tile_t<D, kJ>(s, qa, kt, jn, lane);
  float mx[2] = {-CUDART_INF_F, -CUDART_INF_F};
#pragma unroll
  for (int j = 0; j < kJ; ++j) {
    if (j < jn) {
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        if (kRagged && j * 8 + 2 * t + (c & 1) >= nk) s[j][c] = -CUDART_INF_F;
        mx[c >> 1] = fmaxf(mx[c >> 1], s[j][c]);
      }
    }
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    // every key tile holds a real key, so the new maximum is finite
    mr[i] = fmaxf(mr[i], quad_max(mx[i]));
    const float o = mr[i] * c2;
    l[i] *= exp2_ftz(off[i] - o);
    off[i] = o;
  }
#pragma unroll
  for (int j = 0; j < kJ; ++j) {
    if (j < jn) {
#pragma unroll
      for (int c = 0; c < 4; ++c) l[c >> 1] += softmax_exp(s[j][c], c2, off[c >> 1]);
    }
  }
}

// pass 2 of the ring on one key tile: p = round_bf16(exp2(s * c2 - off) / l)
// (il = 1 / l), acc += p V
template <int D, bool kRagged, int kJ>
__device__ __forceinline__ void pv_tile(const uint32_t (&qa)[D / 16][4], uint32_t kt,
                                        uint32_t vt, int nk, int lane, float c2,
                                        const float (&off)[2], const float (&il)[2],
                                        float (&acc)[D / 8][4]) {
  const int jn = kRagged ? (nk + 7) / 8 : 8;
  const int kn = kRagged ? (nk + 15) / 16 : 4;
  const int t = lane & 3;
  float s[8][4];
  mma_frags_tile_t<D, kJ>(s, qa, kt, jn, lane);
#pragma unroll
  for (int j = 0; j < kJ; ++j) {
    if (j < 2 * kn) {
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int i = c >> 1;
        float pv = softmax_exp(s[j][c], c2, off[i]) * il[i];
        if (kRagged && j * 8 + 2 * t + (c & 1) >= nk) pv = 0.0f;
        s[j][c] = pv;
      }
    }
  }
  mma_acc_tile<D, kJ / 2>(acc, s, vt, kn, lane);
}

// one pass over kNT resident key tiles (K at tile * kStageBytes, V after
// it): the warp keeps S for all its rows' keys in registers, takes m and l
// from them, normalises, and runs P V. The last tile has nk real keys.
template <int D, int kNT, bool kRagged, int kJ>
__device__ __forceinline__ void resident_rows(const uint32_t (&qa)[D / 16][4],
                                              uint32_t ring, int nk, int lane, float c2,
                                              float (&acc)[D / 8][4]) {
  using Cfg = Bf16Cfg<D>;
  const int jn = kRagged ? (nk + 7) / 8 : 8;
  const int kn = kRagged ? (nk + 15) / 16 : 4;
  const int t = lane & 3;
  float s[kNT][8][4];
#pragma unroll
  for (int i = 0; i < kNT; ++i) {
    const uint32_t kt = ring + i * Cfg::kStageBytes;
    if (i < kNT - 1) mma_frags_tile_t<D>(s[i], qa, kt, 8, lane);
    else mma_frags_tile_t<D, kJ>(s[i], qa, kt, jn, lane);
  }
  // groups of the last tile past the real keys (and past kJ) are not read
  auto live = [&](int i, int j) { return i < kNT - 1 || (j < kJ && j < 2 * kn); };
  auto masked = [&](int i, int j, int c) {
    return kRagged && i == kNT - 1 && j * 8 + 2 * t + (c & 1) >= nk;
  };
  float mx[2] = {-CUDART_INF_F, -CUDART_INF_F};
#pragma unroll
  for (int i = 0; i < kNT; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j)
      if (live(i, j))
#pragma unroll
        for (int c = 0; c < 4; ++c)
          if (!masked(i, j, c)) mx[c >> 1] = fmaxf(mx[c >> 1], s[i][j][c]);
  float off[2];
  float l[2] = {0.0f, 0.0f};
#pragma unroll
  for (int r = 0; r < 2; ++r) off[r] = quad_max(mx[r]) * c2;
#pragma unroll
  for (int i = 0; i < kNT; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j)
      if (live(i, j))
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const float e = masked(i, j, c) ? 0.0f : softmax_exp(s[i][j][c], c2, off[c >> 1]);
          s[i][j][c] = e;
          l[c >> 1] += e;
        }
  const float il[2] = {1.0f / quad_sum(l[0]), 1.0f / quad_sum(l[1])};
#pragma unroll
  for (int i = 0; i < kNT; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j)
      if (live(i, j))
#pragma unroll
        for (int c = 0; c < 4; ++c) s[i][j][c] *= il[c >> 1];
#pragma unroll
  for (int i = 0; i < kNT; ++i) {
    const uint32_t vt = ring + i * Cfg::kStageBytes + Cfg::kTileBytes;
    if (i < kNT - 1) mma_acc_tile<D>(acc, s[i], vt, 4, lane);
    else mma_acc_tile<D, kJ / 2>(acc, s[i], vt, kn, lane);
  }
}

template <int D, int kNT>
__global__ void __maxnreg__(Bf16Cfg<D>::kMaxRegs)
heads_attention_mma_bf16(const Params p) {
  using Cfg = Bf16Cfg<D>;
  constexpr int kN = Cfg::kN;
  constexpr int kStages = Cfg::kStages;
  extern __shared__ __align__(128) unsigned char smem[];

  const int b = blockIdx.z;
  const int h = blockIdx.y;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int block_row0 = blockIdx.x * (blockDim.x / 2);   // 16 rows per warp
  const int row0 = block_row0 + (tid >> 5) * 16;
  // the warps of the last query tile past its last row leave at once: the
  // others stage the tiles alone and synchronise among themselves
  if (row0 >= p.n_q) return;
  const int n_threads = min(static_cast<int>(blockDim.x), (p.n_q - block_row0 + 15) / 16 * 32);

  const __nv_bfloat16* qbase =
      static_cast<const __nv_bfloat16*>(p.q) + b * p.q_bs + h * p.q_hs;
  const __nv_bfloat16* kbase =
      static_cast<const __nv_bfloat16*>(p.k) + b * p.k_bs + h * p.k_hs;
  const __nv_bfloat16* vbase =
      static_cast<const __nv_bfloat16*>(p.v) + b * p.v_bs + h * p.v_hs;

  const int n_tiles = (p.n_k + kN - 1) / kN;
  const int last_n = p.n_k - (n_tiles - 1) * kN;  // real keys of the last tile
  __nv_bfloat16* ring = reinterpret_cast<__nv_bfloat16*>(smem);
  // K of a tile into a slot, and its V when the pass needs it
  auto issue = [&](int tile, int slot, bool with_v) {
    __nv_bfloat16* kt = ring + slot * 2 * kN * D;
    stage_async<D, kN>(kt, kbase, p.k_rs, tile * kN, p.n_k, tid, n_threads);
    if (with_v)
      stage_async<D, kN>(kt + kN * D, vbase, p.v_rs, tile * kN, p.n_k, tid, n_threads);
  };
  if (kNT > 0) {
    for (int tile = 0; tile < kNT; ++tile) issue(tile, tile, true);
    cp_async_commit();
  } else {
    // the ring runs above 128 keys only: more tiles than slots
#pragma unroll
    for (int v = 0; v < kStages - 1; ++v) {
      issue(v, v, false);
      cp_async_commit();
    }
  }
  // before the first wait: the global loads overlap the copies in flight
  uint32_t qa[D / 16][4];
  load_a_rows<D>(qa, qbase, p.q_rs, row0, p.n_q, g, t);
  const float c2 = p.scale * kLog2e;
  float acc[D / 8][4];
#pragma unroll
  for (int nb = 0; nb < D / 8; ++nb)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[nb][c] = 0.0f;

  if constexpr (kNT > 0) {
    cp_async_wait<0>();
    bar_sync(n_threads);
    const uint32_t base = smem_u32(ring);
    if (last_n == kN)
      resident_rows<D, kNT, false, 8>(qa, base, kN, lane, c2, acc);
    else if (last_n > 16)
      resident_rows<D, kNT, true, 8>(qa, base, last_n, lane, c2, acc);
    else
      resident_rows<D, kNT, true, 2>(qa, base, last_n, lane, c2, acc);
  } else {
    // virtual tile v of the 2 n in flight: tile v % n_tiles, slot v % kStages;
    // pass 1 stages K alone, pass 2 K and V
    auto advance = [&](int v) {  // tile v landed, the slot of v - 1 is free
      cp_async_wait<kStages - 2>();
      bar_sync(n_threads);
      const int nv = v + kStages - 1;
      if (nv < 2 * n_tiles) issue(nv % n_tiles, nv % kStages, nv >= n_tiles);
      cp_async_commit();
    };
    float mr[2] = {-CUDART_INF_F, -CUDART_INF_F};
    float off[2] = {-CUDART_INF_F, -CUDART_INF_F};
    float l[2] = {0.0f, 0.0f};
    for (int v = 0; v < n_tiles; ++v) {
      advance(v);
      const uint32_t kt = smem_u32(ring + (v % kStages) * 2 * kN * D);
      if (v < n_tiles - 1 || last_n == kN)
        stats_tile<D, false, 8>(qa, kt, kN, lane, c2, mr, off, l);
      else if (last_n > 16)
        stats_tile<D, true, 8>(qa, kt, last_n, lane, c2, mr, off, l);
      else
        stats_tile<D, true, 2>(qa, kt, last_n, lane, c2, mr, off, l);
    }
    const float il[2] = {1.0f / quad_sum(l[0]), 1.0f / quad_sum(l[1])};
    for (int v = n_tiles; v < 2 * n_tiles; ++v) {
      advance(v);
      const uint32_t kt = smem_u32(ring + (v % kStages) * 2 * kN * D);
      const uint32_t vt = kt + Cfg::kTileBytes;
      if (v < 2 * n_tiles - 1 || last_n == kN)
        pv_tile<D, false, 8>(qa, kt, vt, kN, lane, c2, off, il, acc);
      else if (last_n > 16)
        pv_tile<D, true, 8>(qa, kt, vt, last_n, lane, c2, off, il, acc);
      else
        pv_tile<D, true, 2>(qa, kt, vt, last_n, lane, c2, off, il, acc);
    }
  }
  __nv_bfloat16* obase = static_cast<__nv_bfloat16*>(p.o) + b * p.o_bs + h * p.o_hs;
  store_rows<D>(obase, p.o_rs, row0, p.n_q, acc, g, t);
}

// kNT key tiles resident (1 or 2), or 0: the ring
template <int D, int kNT>
int launch_bf16(const Params& p, int batch, int num_heads, cudaStream_t st) {
  using Cfg = Bf16Cfg<D>;
  const int bytes = (kNT > 0 ? kNT : Cfg::kStages) * Cfg::kStageBytes;
  static int set_for = -1;
  if (const int err = allow_smem(heads_attention_mma_bf16<D, kNT>, bytes, set_for))
    return err;
  // one block holds all query rows when they fit, so a 65th row costs one
  // more warp, not a second block
  const int warps =
      p.n_q <= 16 * Cfg::kMaxWarps ? (p.n_q + 15) / 16 : Cfg::kLongWarps;
  const dim3 grid((p.n_q + 16 * warps - 1) / (16 * warps), num_heads, batch);
  heads_attention_mma_bf16<D, kNT><<<grid, 32 * warps, bytes, st>>>(p);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int launch(const Params& p, int dtype, int batch, int num_heads, cudaStream_t st) {
  if (dtype == 1) {
    // K and V of up to 128 keys stay resident: one pass over them
    using Cfg = Bf16Cfg<D>;
    if (p.n_k <= Cfg::kN) return launch_bf16<D, 1>(p, batch, num_heads, st);
    if (p.n_k <= Cfg::kResidentTiles * Cfg::kN)
      return launch_bf16<D, Cfg::kResidentTiles>(p, batch, num_heads, st);
    return launch_bf16<D, 0>(p, batch, num_heads, st);
  } else if (dtype == 0) {
    const dim3 grid((p.n_q + kFmaRows - 1) / kFmaRows, num_heads, batch);
    heads_attention_fma_f32<D><<<grid, kThreads, 0, st>>>(p);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtype: 0 = float32 (plain-FMA kernel), 1 = bfloat16 (tensor-core kernel);
// head_dim: 16, 32, 64 or 128. Strides are in elements. Returns
// cudaGetLastError() after the launch (0 = launched).
extern "C" int heads_attention_forward(
    const void* q, const void* k, const void* v, void* o, int dtype, int head_dim,
    int batch, int num_heads, int n_q_rows, int n_keys,
    long long q_bs, long long q_hs, long long q_rs,
    long long k_bs, long long k_hs, long long k_rs,
    long long v_bs, long long v_hs, long long v_rs,
    long long o_bs, long long o_hs, long long o_rs,
    float scale, void* stream) {
  Params p;
  p.q = q; p.k = k; p.v = v; p.o = o;
  p.q_bs = q_bs; p.q_hs = q_hs; p.q_rs = q_rs;
  p.k_bs = k_bs; p.k_hs = k_hs; p.k_rs = k_rs;
  p.v_bs = v_bs; p.v_hs = v_hs; p.v_rs = v_rs;
  p.o_bs = o_bs; p.o_hs = o_hs; p.o_rs = o_rs;
  p.n_q = n_q_rows; p.n_k = n_keys;
  p.scale = scale;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (head_dim) {
    case 16: return launch<16>(p, dtype, batch, num_heads, st);
    case 32: return launch<32>(p, dtype, batch, num_heads, st);
    case 64: return launch<64>(p, dtype, batch, num_heads, st);
    case 128: return launch<128>(p, dtype, batch, num_heads, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
