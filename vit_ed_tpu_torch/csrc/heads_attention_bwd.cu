// 4-D attention backward for Hopper (sm_90a), head_dim 16, 32, 64 or 128.
//
// Replaces the three backward TPU kernels of vit_ed_tpu/ops/attention.py:
// behind the custom VJPs `_fused_attention_padded_v2` (:390) and
// `_fused_attention_padded` (:368), `_bwd_dq_kernel` (:137, reached through
// `_pallas_dq` :318) by `heads_attention_dq` and `_bwd_dkv_kernel` (:167,
// reached through `_pallas_dkv` :338) by `heads_attention_dkv`; and
// `_pair_bwd_kernel` (:548, reached through `_pair_backward` :613 by the four
// packed VJPs), which computes the same function at head_dim 64 on the fused
// [B, S, C] layout, by the two launched one after the other on the packed
// layout's [B, H, S, D] views. Per batch element and head, with T the input
// type (NOT the pair forward's chain: no pre-rounded q, no exp2 clamp):
//
//   s   = dot_f32(q, k) * scale               keys past the end -> -inf
//   p   = softmax(s)                          f32, max-subtracted
//   dp  = dot_f32(do, v)
//   dl  = rowsum(dp * p)
//   ds  = p * (dp - dl) * scale
//   dq  = round_T(sum_k round_T(ds) * k)      f32 accumulate
//   dv  = round_T(sum_q round_T(p)  * do)     f32 over ALL query rows,
//   dk  = round_T(sum_q round_T(ds) * q)      rounded once at the end
//
// The TPU's dK/dV kernel holds ALL query rows and all keys of one
// (batch * head) in VMEM and is a single program per (batch * head); its dQ
// kernel recomputes the full-key softmax per query block. A Hopper block has
// no such memory, and blocks run in no order, so:
//
//   dq   gridded by query tile: pass 1 walks the keys once for the row
//        maximum m, 1 / sum exp(s - m) and dl (online, rescaled when the
//        maximum grows) and stores the three per (batch, head, row) in f32;
//        pass 2 walks the keys again for ds and dq.
//   dkv  gridded by key tile: keeps its keys' K and V rows in registers,
//        walks ALL query tiles in order, recomputes p and ds from the stored
//        statistics and accumulates dv and dk in f32 registers. It runs after
//        dq on the same stream and reads the statistics dq stored.
//
// No atomics: every sum has a fixed order, so two runs give the same bits.
// The price is recomputation: 9 tile products per (q tile, key tile) where a
// single pass would need 5. The TPU kernels' padding of Sq and Sk to 128 is
// not carried over; ragged tiles are masked (padded query rows get zero
// statistics, so p = exp(0) * 0 = 0 there).
//
// Addressing, as in heads_attention.cu: every tensor is a base pointer plus
// batch, head and row strides in elements with a unit last stride, so q|k|v
// are read inside a fused projection and dq|dk|dv are written straight into
// one fused gradient of the same layout; the CLS VJP (n_q = 1) writes dq into
// row 0 only. A q tile never reads or writes past n_q rows.
//
// What bounds it on an H100: at the puzzle shapes (B = 128 pairs, 12 heads,
// S = 65, D = 32) one backward is 10 * 128 * 12 * 65 * 65 * 32 ~ 2.1 GFLOP
// (~2 us at 989 TFLOP/s) while dq moves ~32 MB and dkv ~38 MB (~9.5 and
// ~11.4 us at 3.35 TB/s): both are memory-bound, at about the cost of their
// launches, so launch latency and tile quantisation (65 = two 64-wide tiles)
// set the time. At B = 64, S = 1025 it is compute-bound (~0.26 ms at 989
// TFLOP/s dense bf16). Simple first: bf16 on mma.sync m16n8k16, f32 on plain
// FMA. At D = 128 the dkv kernel's K/V fragments and four accumulators pass
// the register file and spill; wgmma, TMA and a one-pass design are later
// work.

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
  const void* dout;
  void* dq;
  void* dk;
  void* dv;
  float* stats;  // [3][batch][heads][n_q]: row max, 1 / sum, delta
  long long q_bs, q_hs, q_rs, k_bs, k_hs, k_rs, v_bs, v_hs, v_rs, do_bs, do_hs, do_rs;
  long long dq_bs, dq_hs, dq_rs, dk_bs, dk_hs, dk_rs, dv_bs, dv_hs, dv_rs;
  int n_q, n_k, batch, heads;
  float scale;
};

__device__ __forceinline__ float* stat_ptr(const Params& p, int which, int b, int h) {
  return p.stats + ((static_cast<long long>(which) * p.batch + b) * p.heads + h) * p.n_q;
}

// ---------------------------------------------------------------------------
// float32 kernels, plain FMA (the tests' type; rounding to T is the identity).
// A thread quad owns one row (dq: a query row; dkv: a key) of the block's 32;
// each thread holds a quarter of the head dims, and a dot product is the
// quad's sum of four partial dots in a fixed order.
// ---------------------------------------------------------------------------

constexpr int kFmaTile = 32;  // rows per block, and rows of a staged tile

// rows r0.. of a strided [n_total, D] f32 matrix into a [32][D] tile; rows
// past the end are zeros
template <int D>
__device__ __forceinline__ void stage_f32(float (*dst)[D], const float* base, long long rs,
                                          int r0, int n_total, int tid) {
  for (int i = tid; i < kFmaTile * D; i += kThreads) {
    const int r = i / D;
    const int d = i % D;
    const int row = r0 + r;
    dst[r][d] = row < n_total ? base[row * rs + d] : 0.0f;
  }
}

// the quad's dot product of its row (quarters in registers) with tile row r
template <int D>
__device__ __forceinline__ float quad_dot(const float (&x)[D / 4], const float (*tile)[D],
                                          int r, int part) {
  float s = 0.0f;
#pragma unroll
  for (int d = 0; d < D / 4; ++d) s = fmaf(x[d], tile[r][part * (D / 4) + d], s);
  return quad_sum(s);
}

// dq, f32. Three passes over the keys: row max, then sum and delta, then ds
// and dq.
template <int D>
__global__ void __launch_bounds__(kThreads)
heads_bwd_dq_fma_f32(const Params p) {
  constexpr int kPart = D / 4;
  __shared__ float ks[kFmaTile][D];
  __shared__ float vs[kFmaTile][D];

  const int b = blockIdx.z;
  const int h = blockIdx.y;
  const int tid = threadIdx.x;
  const int part = tid & 3;
  const int row = blockIdx.x * kFmaTile + (tid >> 2);
  const bool live = row < p.n_q;

  const float* kbase = static_cast<const float*>(p.k) + b * p.k_bs + h * p.k_hs;
  const float* vbase = static_cast<const float*>(p.v) + b * p.v_bs + h * p.v_hs;
  const float* qrow = static_cast<const float*>(p.q) + b * p.q_bs + h * p.q_hs +
                      (live ? row : 0) * p.q_rs + part * kPart;
  const float* drow = static_cast<const float*>(p.dout) + b * p.do_bs + h * p.do_hs +
                      (live ? row : 0) * p.do_rs + part * kPart;

  float qr[kPart];
  float dr[kPart];
#pragma unroll
  for (int d = 0; d < kPart; ++d) {
    qr[d] = live ? qrow[d] : 0.0f;
    dr[d] = live ? drow[d] : 0.0f;
  }

  // pass 0: the row maximum
  float m = -CUDART_INF_F;
  for (int k0 = 0; k0 < p.n_k; k0 += kFmaTile) {
    stage_f32<D>(ks, kbase, p.k_rs, k0, p.n_k, tid);
    __syncthreads();
    const int n = min(kFmaTile, p.n_k - k0);
    for (int kr = 0; kr < n; ++kr) m = fmaxf(m, quad_dot<D>(qr, ks, kr, part) * p.scale);
    __syncthreads();
  }

  // pass 1: sum exp(s - m) and sum exp(s - m) * dp
  float l = 0.0f;
  float dnum = 0.0f;
  for (int k0 = 0; k0 < p.n_k; k0 += kFmaTile) {
    stage_f32<D>(ks, kbase, p.k_rs, k0, p.n_k, tid);
    stage_f32<D>(vs, vbase, p.v_rs, k0, p.n_k, tid);
    __syncthreads();
    const int n = min(kFmaTile, p.n_k - k0);
    for (int kr = 0; kr < n; ++kr) {
      const float e = expf(quad_dot<D>(qr, ks, kr, part) * p.scale - m);
      l += e;
      dnum = fmaf(e, quad_dot<D>(dr, vs, kr, part), dnum);
    }
    __syncthreads();
  }
  const float inv_l = 1.0f / l;
  const float delta = dnum * inv_l;
  if (live && part == 0) {
    stat_ptr(p, 0, b, h)[row] = m;
    stat_ptr(p, 1, b, h)[row] = inv_l;
    stat_ptr(p, 2, b, h)[row] = delta;
  }

  // pass 2: ds and dq
  float acc[kPart];
#pragma unroll
  for (int d = 0; d < kPart; ++d) acc[d] = 0.0f;
  for (int k0 = 0; k0 < p.n_k; k0 += kFmaTile) {
    stage_f32<D>(ks, kbase, p.k_rs, k0, p.n_k, tid);
    stage_f32<D>(vs, vbase, p.v_rs, k0, p.n_k, tid);
    __syncthreads();
    const int n = min(kFmaTile, p.n_k - k0);
    for (int kr = 0; kr < n; ++kr) {
      const float pv = expf(quad_dot<D>(qr, ks, kr, part) * p.scale - m) * inv_l;
      const float ds = pv * (quad_dot<D>(dr, vs, kr, part) - delta) * p.scale;
#pragma unroll
      for (int d = 0; d < kPart; ++d) acc[d] = fmaf(ds, ks[kr][part * kPart + d], acc[d]);
    }
    __syncthreads();
  }
  if (live) {
    float* orow = static_cast<float*>(p.dq) + b * p.dq_bs + h * p.dq_hs + row * p.dq_rs +
                  part * kPart;
#pragma unroll
    for (int d = 0; d < kPart; ++d) orow[d] = acc[d];
  }
}

// dkv, f32: the quad keeps its key's K and V quarters in registers and walks
// every query tile in order.
template <int D>
__global__ void __launch_bounds__(kThreads)
heads_bwd_dkv_fma_f32(const Params p) {
  constexpr int kPart = D / 4;
  __shared__ float qs[kFmaTile][D];
  __shared__ float dos[kFmaTile][D];
  __shared__ float sm[kFmaTile];
  __shared__ float sil[kFmaTile];
  __shared__ float sdl[kFmaTile];

  const int b = blockIdx.z;
  const int h = blockIdx.y;
  const int tid = threadIdx.x;
  const int part = tid & 3;
  const int key = blockIdx.x * kFmaTile + (tid >> 2);
  const bool live = key < p.n_k;

  const float* qbase = static_cast<const float*>(p.q) + b * p.q_bs + h * p.q_hs;
  const float* dbase = static_cast<const float*>(p.dout) + b * p.do_bs + h * p.do_hs;
  const float* krow = static_cast<const float*>(p.k) + b * p.k_bs + h * p.k_hs +
                      (live ? key : 0) * p.k_rs + part * kPart;
  const float* vrow = static_cast<const float*>(p.v) + b * p.v_bs + h * p.v_hs +
                      (live ? key : 0) * p.v_rs + part * kPart;
  const float* gm = stat_ptr(p, 0, b, h);
  const float* gil = stat_ptr(p, 1, b, h);
  const float* gdl = stat_ptr(p, 2, b, h);

  float kr[kPart];
  float vr[kPart];
  float dk[kPart];
  float dv[kPart];
#pragma unroll
  for (int d = 0; d < kPart; ++d) {
    kr[d] = live ? krow[d] : 0.0f;
    vr[d] = live ? vrow[d] : 0.0f;
    dk[d] = 0.0f;
    dv[d] = 0.0f;
  }

  for (int q0 = 0; q0 < p.n_q; q0 += kFmaTile) {
    stage_f32<D>(qs, qbase, p.q_rs, q0, p.n_q, tid);
    stage_f32<D>(dos, dbase, p.do_rs, q0, p.n_q, tid);
    if (tid < kFmaTile) {
      const int row = q0 + tid;
      const bool ok = row < p.n_q;
      sm[tid] = ok ? gm[row] : 0.0f;
      sil[tid] = ok ? gil[row] : 0.0f;
      sdl[tid] = ok ? gdl[row] : 0.0f;
    }
    __syncthreads();
    const int n = min(kFmaTile, p.n_q - q0);
    for (int r = 0; r < n; ++r) {
      const float pv = expf(quad_dot<D>(kr, qs, r, part) * p.scale - sm[r]) * sil[r];
      const float ds = pv * (quad_dot<D>(vr, dos, r, part) - sdl[r]) * p.scale;
#pragma unroll
      for (int d = 0; d < kPart; ++d) {
        dv[d] = fmaf(pv, dos[r][part * kPart + d], dv[d]);
        dk[d] = fmaf(ds, qs[r][part * kPart + d], dk[d]);
      }
    }
    __syncthreads();
  }
  if (live) {
    float* okrow = static_cast<float*>(p.dk) + b * p.dk_bs + h * p.dk_hs + key * p.dk_rs +
                   part * kPart;
    float* ovrow = static_cast<float*>(p.dv) + b * p.dv_bs + h * p.dv_hs + key * p.dv_rs +
                   part * kPart;
#pragma unroll
    for (int d = 0; d < kPart; ++d) {
      okrow[d] = dk[d];
      ovrow[d] = dv[d];
    }
  }
}

// ---------------------------------------------------------------------------
// bf16 tensor-core kernels (fragment layouts and tile helpers:
// attention_mma.cuh)
// ---------------------------------------------------------------------------

// dq, bf16: a warp owns 16 query rows and holds their q and do rows as A
// fragments for both passes over the keys.
template <int D>
__global__ void __launch_bounds__(kThreads)
heads_bwd_dq_mma_bf16(const Params p) {
  __shared__ __align__(16) __nv_bfloat16 ks[kTile * (D + 8)];
  __shared__ __align__(16) __nv_bfloat16 vs[kTile * (D + 8)];

  const int b = blockIdx.z;
  const int h = blockIdx.y;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int row0 = blockIdx.x * kTile + warp * 16;
  // a warp whose 16 rows lie past the last query row only helps to stage
  const bool warp_live = row0 < p.n_q;

  const __nv_bfloat16* qbase =
      static_cast<const __nv_bfloat16*>(p.q) + b * p.q_bs + h * p.q_hs;
  const __nv_bfloat16* kbase =
      static_cast<const __nv_bfloat16*>(p.k) + b * p.k_bs + h * p.k_hs;
  const __nv_bfloat16* vbase =
      static_cast<const __nv_bfloat16*>(p.v) + b * p.v_bs + h * p.v_hs;
  const __nv_bfloat16* dbase =
      static_cast<const __nv_bfloat16*>(p.dout) + b * p.do_bs + h * p.do_hs;

  uint32_t qa[D / 16][4];
  uint32_t da[D / 16][4];
  load_a_rows<D>(qa, qbase, p.q_rs, row0, p.n_q, g, t);
  load_a_rows<D>(da, dbase, p.do_rs, row0, p.n_q, g, t);

  float s[8][4];
  float dp[8][4];

  // pass 1: online row max m, sum l and delta numerator n for rows g (0)
  // and g + 8 (1); m is kept equal across the four lanes of a row
  float m0 = -CUDART_INF_F, m1 = -CUDART_INF_F;
  float l0 = 0.0f, l1 = 0.0f, n0 = 0.0f, n1 = 0.0f;
  for (int k0 = 0; k0 < p.n_k; k0 += kTile) {
    stage_bf16<D>(ks, kbase, p.k_rs, k0, p.n_k, tid);
    stage_bf16<D>(vs, vbase, p.v_rs, k0, p.n_k, tid);
    __syncthreads();
    if (warp_live) {
      mma_a_tile_t<D>(s, qa, ks, g, t);
      mma_a_tile_t<D>(dp, da, vs, g, t);
      float mx0 = -CUDART_INF_F, mx1 = -CUDART_INF_F;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int key = k0 + j * 8 + 2 * t + (c & 1);
          const float val = key < p.n_k ? s[j][c] * p.scale : -CUDART_INF_F;
          s[j][c] = val;
          if (c < 2) mx0 = fmaxf(mx0, val); else mx1 = fmaxf(mx1, val);
        }
      }
      // every key tile holds at least one real key, so the new maxima are finite
      const float mn0 = fmaxf(m0, quad_max(mx0));
      const float mn1 = fmaxf(m1, quad_max(mx1));
      const float c0 = expf(m0 - mn0);
      const float c1 = expf(m1 - mn1);
      l0 *= c0; n0 *= c0; m0 = mn0;
      l1 *= c1; n1 *= c1; m1 = mn1;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          if (c < 2) {
            const float e = expf(s[j][c] - m0);
            l0 += e;
            n0 = fmaf(e, dp[j][c], n0);
          } else {
            const float e = expf(s[j][c] - m1);
            l1 += e;
            n1 = fmaf(e, dp[j][c], n1);
          }
        }
      }
    }
    __syncthreads();
  }
  const float il0 = 1.0f / quad_sum(l0);
  const float il1 = 1.0f / quad_sum(l1);
  const float dl0 = quad_sum(n0) * il0;
  const float dl1 = quad_sum(n1) * il1;
  if (t == 0) {
    const int ra = row0 + g;
    const int rb = row0 + g + 8;
    if (ra < p.n_q) {
      stat_ptr(p, 0, b, h)[ra] = m0;
      stat_ptr(p, 1, b, h)[ra] = il0;
      stat_ptr(p, 2, b, h)[ra] = dl0;
    }
    if (rb < p.n_q) {
      stat_ptr(p, 0, b, h)[rb] = m1;
      stat_ptr(p, 1, b, h)[rb] = il1;
      stat_ptr(p, 2, b, h)[rb] = dl1;
    }
  }

  // pass 2: ds = p * (dp - delta) * scale, dq += round(ds) K
  float acc[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[n][c] = 0.0f;
  for (int k0 = 0; k0 < p.n_k; k0 += kTile) {
    stage_bf16<D>(ks, kbase, p.k_rs, k0, p.n_k, tid);
    stage_bf16<D>(vs, vbase, p.v_rs, k0, p.n_k, tid);
    __syncthreads();
    if (warp_live) {
      mma_a_tile_t<D>(s, qa, ks, g, t);
      mma_a_tile_t<D>(dp, da, vs, g, t);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int key = k0 + j * 8 + 2 * t + (c & 1);
          const float mr = c < 2 ? m0 : m1;
          const float ilr = c < 2 ? il0 : il1;
          const float dlr = c < 2 ? dl0 : dl1;
          const float pv = key < p.n_k ? expf(s[j][c] * p.scale - mr) * ilr : 0.0f;
          s[j][c] = pv * (dp[j][c] - dlr) * p.scale;
        }
      }
      mma_acc_tile<D>(acc, s, ks, g, t);
    }
    __syncthreads();
  }
  __nv_bfloat16* obase = static_cast<__nv_bfloat16*>(p.dq) + b * p.dq_bs + h * p.dq_hs;
  store_rows<D>(obase, p.dq_rs, row0, p.n_q, acc, g, t);
}

// dkv, bf16: a warp owns 16 keys, holds their K and V rows as A fragments,
// and walks every query tile in order: S^T = K Q^T and dP^T = V dO^T come out
// keys x rows, so round(p)^T and round(ds)^T are already the A operands of
// dv += p^T dO and dk += ds^T Q.
template <int D>
__global__ void __launch_bounds__(kThreads)
heads_bwd_dkv_mma_bf16(const Params p) {
  __shared__ __align__(16) __nv_bfloat16 qs[kTile * (D + 8)];
  __shared__ __align__(16) __nv_bfloat16 dos[kTile * (D + 8)];
  __shared__ float sm[kTile];
  __shared__ float sil[kTile];
  __shared__ float sdl[kTile];

  const int b = blockIdx.z;
  const int h = blockIdx.y;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int key0 = blockIdx.x * kTile + warp * 16;
  // a warp whose 16 keys lie past the last key only helps to stage
  const bool warp_live = key0 < p.n_k;

  const __nv_bfloat16* qbase =
      static_cast<const __nv_bfloat16*>(p.q) + b * p.q_bs + h * p.q_hs;
  const __nv_bfloat16* kbase =
      static_cast<const __nv_bfloat16*>(p.k) + b * p.k_bs + h * p.k_hs;
  const __nv_bfloat16* vbase =
      static_cast<const __nv_bfloat16*>(p.v) + b * p.v_bs + h * p.v_hs;
  const __nv_bfloat16* dbase =
      static_cast<const __nv_bfloat16*>(p.dout) + b * p.do_bs + h * p.do_hs;
  const float* gm = stat_ptr(p, 0, b, h);
  const float* gil = stat_ptr(p, 1, b, h);
  const float* gdl = stat_ptr(p, 2, b, h);

  uint32_t ka[D / 16][4];
  uint32_t va[D / 16][4];
  load_a_rows<D>(ka, kbase, p.k_rs, key0, p.n_k, g, t);
  load_a_rows<D>(va, vbase, p.v_rs, key0, p.n_k, g, t);

  float dk[D / 8][4];
  float dv[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n) {
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      dk[n][c] = 0.0f;
      dv[n][c] = 0.0f;
    }
  }
  float st[8][4];
  float dpt[8][4];

  for (int q0 = 0; q0 < p.n_q; q0 += kTile) {
    stage_bf16<D>(qs, qbase, p.q_rs, q0, p.n_q, tid);
    stage_bf16<D>(dos, dbase, p.do_rs, q0, p.n_q, tid);
    if (tid < kTile) {
      // padded query rows: zero statistics give p = exp(0) * 0 = 0
      const int row = q0 + tid;
      const bool ok = row < p.n_q;
      sm[tid] = ok ? gm[row] : 0.0f;
      sil[tid] = ok ? gil[row] : 0.0f;
      sdl[tid] = ok ? gdl[row] : 0.0f;
    }
    __syncthreads();
    if (warp_live) {
      mma_a_tile_t<D>(st, ka, qs, g, t);
      mma_a_tile_t<D>(dpt, va, dos, g, t);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int r = j * 8 + 2 * t + (c & 1);
          const int key = key0 + g + (c < 2 ? 0 : 8);
          const float pv = key < p.n_k ? expf(st[j][c] * p.scale - sm[r]) * sil[r] : 0.0f;
          st[j][c] = pv;
          dpt[j][c] = pv * (dpt[j][c] - sdl[r]) * p.scale;
        }
      }
      mma_acc_tile<D>(dv, st, dos, g, t);
      mma_acc_tile<D>(dk, dpt, qs, g, t);
    }
    __syncthreads();
  }
  __nv_bfloat16* okbase = static_cast<__nv_bfloat16*>(p.dk) + b * p.dk_bs + h * p.dk_hs;
  __nv_bfloat16* ovbase = static_cast<__nv_bfloat16*>(p.dv) + b * p.dv_bs + h * p.dv_hs;
  store_rows<D>(okbase, p.dk_rs, key0, p.n_k, dk, g, t);
  store_rows<D>(ovbase, p.dv_rs, key0, p.n_k, dv, g, t);
}

template <int D>
int launch_dq(const Params& p, int dtype, cudaStream_t st) {
  const dim3 block(kThreads);
  if (dtype == 1) {
    const dim3 grid((p.n_q + kTile - 1) / kTile, p.heads, p.batch);
    heads_bwd_dq_mma_bf16<D><<<grid, block, 0, st>>>(p);
  } else if (dtype == 0) {
    const dim3 grid((p.n_q + kFmaTile - 1) / kFmaTile, p.heads, p.batch);
    heads_bwd_dq_fma_f32<D><<<grid, block, 0, st>>>(p);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int launch_dkv(const Params& p, int dtype, cudaStream_t st) {
  const dim3 block(kThreads);
  if (dtype == 1) {
    const dim3 grid((p.n_k + kTile - 1) / kTile, p.heads, p.batch);
    heads_bwd_dkv_mma_bf16<D><<<grid, block, 0, st>>>(p);
  } else if (dtype == 0) {
    const dim3 grid((p.n_k + kFmaTile - 1) / kFmaTile, p.heads, p.batch);
    heads_bwd_dkv_fma_f32<D><<<grid, block, 0, st>>>(p);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtype: 0 = float32 (plain-FMA kernels), 1 = bfloat16 (tensor-core kernels);
// head_dim: 16, 32, 64 or 128. Strides are in elements. `stats` is f32
// scratch of 3 * batch * num_heads * n_q_rows elements, written by
// heads_attention_dq and read by heads_attention_dkv. Both return
// cudaGetLastError() after the launch (0 = launched).
extern "C" int heads_attention_dq(
    const void* q, const void* k, const void* v, const void* dout, void* dq, void* stats,
    int dtype, int head_dim, int batch, int num_heads, int n_q_rows, int n_keys,
    long long q_bs, long long q_hs, long long q_rs,
    long long k_bs, long long k_hs, long long k_rs,
    long long v_bs, long long v_hs, long long v_rs,
    long long do_bs, long long do_hs, long long do_rs,
    long long dq_bs, long long dq_hs, long long dq_rs,
    float scale, void* stream) {
  Params p = {};
  p.q = q; p.k = k; p.v = v; p.dout = dout; p.dq = dq;
  p.stats = static_cast<float*>(stats);
  p.q_bs = q_bs; p.q_hs = q_hs; p.q_rs = q_rs;
  p.k_bs = k_bs; p.k_hs = k_hs; p.k_rs = k_rs;
  p.v_bs = v_bs; p.v_hs = v_hs; p.v_rs = v_rs;
  p.do_bs = do_bs; p.do_hs = do_hs; p.do_rs = do_rs;
  p.dq_bs = dq_bs; p.dq_hs = dq_hs; p.dq_rs = dq_rs;
  p.n_q = n_q_rows; p.n_k = n_keys; p.batch = batch; p.heads = num_heads;
  p.scale = scale;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (head_dim) {
    case 16: return launch_dq<16>(p, dtype, st);
    case 32: return launch_dq<32>(p, dtype, st);
    case 64: return launch_dq<64>(p, dtype, st);
    case 128: return launch_dq<128>(p, dtype, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

extern "C" int heads_attention_dkv(
    const void* q, const void* k, const void* v, const void* dout, void* dk, void* dv,
    void* stats, int dtype, int head_dim, int batch, int num_heads, int n_q_rows,
    int n_keys,
    long long q_bs, long long q_hs, long long q_rs,
    long long k_bs, long long k_hs, long long k_rs,
    long long v_bs, long long v_hs, long long v_rs,
    long long do_bs, long long do_hs, long long do_rs,
    long long dk_bs, long long dk_hs, long long dk_rs,
    long long dv_bs, long long dv_hs, long long dv_rs,
    float scale, void* stream) {
  Params p = {};
  p.q = q; p.k = k; p.v = v; p.dout = dout; p.dk = dk; p.dv = dv;
  p.stats = static_cast<float*>(stats);
  p.q_bs = q_bs; p.q_hs = q_hs; p.q_rs = q_rs;
  p.k_bs = k_bs; p.k_hs = k_hs; p.k_rs = k_rs;
  p.v_bs = v_bs; p.v_hs = v_hs; p.v_rs = v_rs;
  p.do_bs = do_bs; p.do_hs = do_hs; p.do_rs = do_rs;
  p.dk_bs = dk_bs; p.dk_hs = dk_hs; p.dk_rs = dk_rs;
  p.dv_bs = dv_bs; p.dv_hs = dv_hs; p.dv_rs = dv_rs;
  p.n_q = n_q_rows; p.n_k = n_keys; p.batch = batch; p.heads = num_heads;
  p.scale = scale;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (head_dim) {
    case 16: return launch_dkv<16>(p, dtype, st);
    case 32: return launch_dkv<32>(p, dtype, st);
    case 64: return launch_dkv<64>(p, dtype, st);
    case 128: return launch_dkv<128>(p, dtype, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
