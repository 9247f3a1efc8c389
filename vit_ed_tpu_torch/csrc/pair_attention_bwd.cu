// Pair attention backward for Hopper (sm_90a), head_dim 64.
//
// Replaces the TPU kernel `_pair_bwd_kernel` of vit_ed_tpu/ops/attention.py
// (:548), reached through `_pair_backward` (:613) by all four attention
// VJPs: `_packed_bwd` (:670), `_packed_qkv_bwd` (:728), `_packed_q_kv_bwd`
// (:782) and `_packed_qkv_cls_bwd` (:846). Per batch element and head it
// computes, with T the input type (this is NOT the forward's chain: no
// pre-rounded q, no exp2 clamp, a max-subtracted softmax in f32):
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
// The TPU kernel walks the query blocks innermost on one core and carries
// dk/dv in two VMEM accumulators from grid step to grid step. Blocks on the
// card run in no order, so the reduction over query rows is a loop INSIDE a
// block instead, and the work is two launches that share a row-statistics
// buffer (they count as one port of the one TPU kernel):
//
//   A  gridded by query tile (64 rows): pass 1 walks the keys once for the
//      row maximum m, 1 / sum exp(s - m) and dl (online, rescaled when the
//      maximum grows), stores the three per (batch, head, row) in f32; pass
//      2 walks the keys again for ds and dq.
//   B  gridded by key tile: keeps its keys' K and V rows in registers, walks
//      ALL query tiles in order, recomputes p and ds from the stored
//      statistics and accumulates dv and dk in f32 registers.
//
// No atomics: every sum has a fixed order, so two runs give the same bits.
// The price is recomputation: 9 tile products per (q tile, key tile) where
// a single pass would need 5. The TPU kernel's head-pair lane masks (2x the
// useful FLOPs), its 512-row blocks and its sublane padding are not
// carried over: each block works on one head, and ragged edges are masked.
//
// Addressing, as in pair_attention.cu: q, k, v are read and dq, dk, dv are
// written through a base pointer, batch and row strides in elements and a
// column offset each, so the qkv VJP reads q|k|v inside the fused
// [B, S, 3C] projection and writes dq|dk|dv straight into one [B, S, 3C]
// gradient, the q_kv VJP writes dk|dv into [B, Sk, 2C], and the CLS VJP
// (n_q = 1) writes dq into row 0 of a gradient whose other dq rows the
// wrapper zeroes. A q tile never reads or writes past n_q rows.
//
// What bounds it on an H100: at the training shapes (49 pairs, 6 heads,
// Sq = 1025, Sk = 1024) one backward is 10 * 49 * 6 * 1025 * 1024 * 64
// ~ 197 GFLOP useful against ~0.3 GB moved, so it is compute-bound
// (~0.2 ms at 989 TFLOP/s dense bf16); the CLS backward (Sq = 1) is
// memory-bound. Simple first: bf16 runs on mma.sync m16n8k16 with the
// accumulator-as-A-operand trick of the forward, f32 on plain FMA; wgmma,
// TMA and a one-pass design with fewer recomputed products are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr int kHeadDim = 64;
constexpr int kThreads = 128;

struct Params {
  const void* q;
  const void* k;
  const void* v;
  const void* dout;
  void* dq;
  void* dk;
  void* dv;
  float* stats;  // [3][batch][heads][n_q]: row max, 1 / sum, delta
  long long q_bs, q_rs, k_bs, k_rs, v_bs, v_rs, do_bs, do_rs;
  long long dq_bs, dq_rs, dk_bs, dk_rs, dv_bs, dv_rs;
  int q_col, k_col, v_col, dq_col, dk_col, dv_col;
  int n_q, n_k, batch, heads;
  float scale;
};

__device__ __forceinline__ float* stat_ptr(const Params& p, int which, int b, int h) {
  return p.stats + ((static_cast<long long>(which) * p.batch + b) * p.heads + h) * p.n_q;
}

// ---------------------------------------------------------------------------
// float32 kernels, plain FMA (the tests' type; rounding to T is the identity)
// ---------------------------------------------------------------------------

constexpr int kFmaRows = 64;  // query rows per block of kernel A
constexpr int kFmaKeys = 32;  // key tile of kernel A; keys per block of kernel B
constexpr int kFmaQ = 32;     // query tile of kernel B

// rows r0.. of a [n_total, 64] strided matrix into a [ROWS][PITCH] tile
template <int ROWS, int PITCH>
__device__ __forceinline__ void stage_f32(float (*dst)[PITCH], const float* base,
                                          long long rs, int r0, int n_total, int tid) {
  for (int i = tid; i < ROWS * kHeadDim; i += kThreads) {
    const int r = i / kHeadDim;
    const int d = i % kHeadDim;
    const int row = r0 + r;
    dst[r][d] = row < n_total ? base[row * rs + d] : 0.0f;
  }
}

// Kernel A, f32: thread pair (2r, 2r+1) owns query row r of the block; each
// thread scores half of a 32-key tile and accumulates half of dq's 64 dims.
// Three passes over the keys: row max, then sum and delta, then ds and dq.
__global__ void __launch_bounds__(kThreads)
pair_bwd_dq_fma_f32(const Params p) {
  __shared__ float ks[kFmaKeys][kHeadDim];
  __shared__ float vs[kFmaKeys][kHeadDim];
  __shared__ float dss[kFmaRows][kFmaKeys + 1];

  const int b = blockIdx.z;
  const int h = blockIdx.y;
  const int tid = threadIdx.x;
  const int r = tid >> 1;
  const int half = tid & 1;
  const int row = blockIdx.x * kFmaRows + r;
  const bool live = row < p.n_q;

  const float* kbase = static_cast<const float*>(p.k) + b * p.k_bs + p.k_col + h * kHeadDim;
  const float* vbase = static_cast<const float*>(p.v) + b * p.v_bs + p.v_col + h * kHeadDim;
  const float* qrow = static_cast<const float*>(p.q) + b * p.q_bs +
                      (live ? row : 0) * p.q_rs + p.q_col + h * kHeadDim;
  const float* drow = static_cast<const float*>(p.dout) + b * p.do_bs +
                      (live ? row : 0) * p.do_rs + h * kHeadDim;

  float qr[kHeadDim];
  float dr[kHeadDim];
#pragma unroll
  for (int d = 0; d < kHeadDim; ++d) {
    qr[d] = live ? qrow[d] : 0.0f;
    dr[d] = live ? drow[d] : 0.0f;
  }

  // pass 0: the row maximum
  float m = -CUDART_INF_F;
  for (int k0 = 0; k0 < p.n_k; k0 += kFmaKeys) {
    stage_f32<kFmaKeys, kHeadDim>(ks, kbase, p.k_rs, k0, p.n_k, tid);
    __syncthreads();
    for (int j = 0; j < kFmaKeys / 2; ++j) {
      const int kr = half * (kFmaKeys / 2) + j;
      if (k0 + kr < p.n_k) {
        float s = 0.0f;
#pragma unroll
        for (int d = 0; d < kHeadDim; ++d) s = fmaf(qr[d], ks[kr][d], s);
        m = fmaxf(m, s * p.scale);
      }
    }
    __syncthreads();
  }
  m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 1));

  // pass 1: sum exp(s - m) and sum exp(s - m) * dp
  float l = 0.0f;
  float dnum = 0.0f;
  for (int k0 = 0; k0 < p.n_k; k0 += kFmaKeys) {
    stage_f32<kFmaKeys, kHeadDim>(ks, kbase, p.k_rs, k0, p.n_k, tid);
    stage_f32<kFmaKeys, kHeadDim>(vs, vbase, p.v_rs, k0, p.n_k, tid);
    __syncthreads();
    for (int j = 0; j < kFmaKeys / 2; ++j) {
      const int kr = half * (kFmaKeys / 2) + j;
      if (k0 + kr < p.n_k) {
        float s = 0.0f;
        float dp = 0.0f;
#pragma unroll
        for (int d = 0; d < kHeadDim; ++d) {
          s = fmaf(qr[d], ks[kr][d], s);
          dp = fmaf(dr[d], vs[kr][d], dp);
        }
        const float e = expf(s * p.scale - m);
        l += e;
        dnum = fmaf(e, dp, dnum);
      }
    }
    __syncthreads();
  }
  l += __shfl_xor_sync(0xffffffffu, l, 1);
  dnum += __shfl_xor_sync(0xffffffffu, dnum, 1);
  const float inv_l = 1.0f / l;
  const float delta = dnum * inv_l;
  if (live && half == 0) {
    stat_ptr(p, 0, b, h)[row] = m;
    stat_ptr(p, 1, b, h)[row] = inv_l;
    stat_ptr(p, 2, b, h)[row] = delta;
  }

  // pass 2: ds and dq
  float acc[kHeadDim / 2];
#pragma unroll
  for (int d = 0; d < kHeadDim / 2; ++d) acc[d] = 0.0f;
  for (int k0 = 0; k0 < p.n_k; k0 += kFmaKeys) {
    stage_f32<kFmaKeys, kHeadDim>(ks, kbase, p.k_rs, k0, p.n_k, tid);
    stage_f32<kFmaKeys, kHeadDim>(vs, vbase, p.v_rs, k0, p.n_k, tid);
    __syncthreads();
    for (int j = 0; j < kFmaKeys / 2; ++j) {
      const int kr = half * (kFmaKeys / 2) + j;
      float ds = 0.0f;
      if (k0 + kr < p.n_k) {
        float s = 0.0f;
        float dp = 0.0f;
#pragma unroll
        for (int d = 0; d < kHeadDim; ++d) {
          s = fmaf(qr[d], ks[kr][d], s);
          dp = fmaf(dr[d], vs[kr][d], dp);
        }
        const float pv = expf(s * p.scale - m) * inv_l;
        ds = pv * (dp - delta) * p.scale;
      }
      dss[r][kr] = ds;
    }
    __syncthreads();
    for (int kr = 0; kr < kFmaKeys; ++kr) {
      const float ds = dss[r][kr];
#pragma unroll
      for (int d = 0; d < kHeadDim / 2; ++d)
        acc[d] = fmaf(ds, ks[kr][half * (kHeadDim / 2) + d], acc[d]);
    }
    __syncthreads();
  }
  if (live) {
    float* orow = static_cast<float*>(p.dq) + b * p.dq_bs + row * p.dq_rs + p.dq_col +
                  h * kHeadDim + half * (kHeadDim / 2);
#pragma unroll
    for (int d = 0; d < kHeadDim / 2; ++d) orow[d] = acc[d];
  }
}

// Kernel B, f32: a thread quad owns one key of the block's 32; it keeps the
// key's K and V rows in registers and walks every query tile in order. Each
// thread scores a quarter of the tile's rows and accumulates a quarter of
// the 64 dims of dv and dk.
__global__ void __launch_bounds__(kThreads)
pair_bwd_dkv_fma_f32(const Params p) {
  __shared__ float qs[kFmaQ][kHeadDim + 1];
  __shared__ float dos[kFmaQ][kHeadDim + 1];
  __shared__ float ps[kFmaKeys][kFmaQ + 1];
  __shared__ float dss[kFmaKeys][kFmaQ + 1];
  __shared__ float sm[kFmaQ];
  __shared__ float sil[kFmaQ];
  __shared__ float sdl[kFmaQ];

  const int b = blockIdx.z;
  const int h = blockIdx.y;
  const int tid = threadIdx.x;
  const int kl = tid >> 2;
  const int quarter = tid & 3;
  const int key = blockIdx.x * kFmaKeys + kl;
  const bool live = key < p.n_k;

  const float* qbase = static_cast<const float*>(p.q) + b * p.q_bs + p.q_col + h * kHeadDim;
  const float* dbase = static_cast<const float*>(p.dout) + b * p.do_bs + h * kHeadDim;
  const float* krow = static_cast<const float*>(p.k) + b * p.k_bs +
                      (live ? key : 0) * p.k_rs + p.k_col + h * kHeadDim;
  const float* vrow = static_cast<const float*>(p.v) + b * p.v_bs +
                      (live ? key : 0) * p.v_rs + p.v_col + h * kHeadDim;
  const float* gm = stat_ptr(p, 0, b, h);
  const float* gil = stat_ptr(p, 1, b, h);
  const float* gdl = stat_ptr(p, 2, b, h);

  float kr[kHeadDim];
  float vr[kHeadDim];
#pragma unroll
  for (int d = 0; d < kHeadDim; ++d) {
    kr[d] = live ? krow[d] : 0.0f;
    vr[d] = live ? vrow[d] : 0.0f;
  }
  constexpr int kPart = kHeadDim / 4;
  float dk[kPart];
  float dv[kPart];
#pragma unroll
  for (int d = 0; d < kPart; ++d) {
    dk[d] = 0.0f;
    dv[d] = 0.0f;
  }

  for (int q0 = 0; q0 < p.n_q; q0 += kFmaQ) {
    stage_f32<kFmaQ, kHeadDim + 1>(qs, qbase, p.q_rs, q0, p.n_q, tid);
    stage_f32<kFmaQ, kHeadDim + 1>(dos, dbase, p.do_rs, q0, p.n_q, tid);
    if (tid < kFmaQ) {
      // padded query rows: zero statistics give p = exp(0) * 0 = 0
      const int row = q0 + tid;
      const bool ok = row < p.n_q;
      sm[tid] = ok ? gm[row] : 0.0f;
      sil[tid] = ok ? gil[row] : 0.0f;
      sdl[tid] = ok ? gdl[row] : 0.0f;
    }
    __syncthreads();
    for (int j = 0; j < kFmaQ / 4; ++j) {
      const int r = quarter * (kFmaQ / 4) + j;
      float s = 0.0f;
      float dp = 0.0f;
#pragma unroll
      for (int d = 0; d < kHeadDim; ++d) {
        s = fmaf(kr[d], qs[r][d], s);
        dp = fmaf(vr[d], dos[r][d], dp);
      }
      const float pv = live ? expf(s * p.scale - sm[r]) * sil[r] : 0.0f;
      ps[kl][r] = pv;
      dss[kl][r] = pv * (dp - sdl[r]) * p.scale;
    }
    __syncthreads();
    for (int r = 0; r < kFmaQ; ++r) {
      const float pv = ps[kl][r];
      const float ds = dss[kl][r];
#pragma unroll
      for (int d = 0; d < kPart; ++d) {
        dv[d] = fmaf(pv, dos[r][quarter * kPart + d], dv[d]);
        dk[d] = fmaf(ds, qs[r][quarter * kPart + d], dk[d]);
      }
    }
    __syncthreads();
  }
  if (live) {
    float* okrow = static_cast<float*>(p.dk) + b * p.dk_bs + key * p.dk_rs + p.dk_col +
                   h * kHeadDim + quarter * kPart;
    float* ovrow = static_cast<float*>(p.dv) + b * p.dv_bs + key * p.dv_rs + p.dv_col +
                   h * kHeadDim + quarter * kPart;
#pragma unroll
    for (int d = 0; d < kPart; ++d) {
      okrow[d] = dk[d];
      ovrow[d] = dv[d];
    }
  }
}

// ---------------------------------------------------------------------------
// bf16 tensor-core kernels: mma.sync.m16n8k16, 4 warps x 16 rows.
// Fragment layouts (PTX ISA, m16n8k16 .bf16): g = lane / 4, t = lane % 4;
//   A (16x16, row): a0 (g, 2t..2t+1) a1 (g+8, 2t..) a2 (g, 2t+8..) a3 (g+8, 2t+8..)
//   B (16x8, col):  b0 (k 2t..2t+1, n g)  b1 (k 2t+8..2t+9, n g)
//   C (16x8, f32):  c0 c1 (g, 2t..2t+1)   c2 c3 (g+8, 2t..2t+1)
// ---------------------------------------------------------------------------

constexpr int kTile = 64;           // rows of a staged tile, and rows per block
constexpr int kLd = kHeadDim + 8;   // smem row pitch (144 B): conflict-free B loads

__device__ __forceinline__ void mma_16816(float (&d)[4], const uint32_t (&a)[4],
                                          uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// two floats -> bf16x2 (round to nearest even); `lo` in the low half
__device__ __forceinline__ uint32_t pack_f32(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t pack_bf16(__nv_bfloat16 lo, __nv_bfloat16 hi) {
  return static_cast<uint32_t>(__bfloat16_as_ushort(lo)) |
         (static_cast<uint32_t>(__bfloat16_as_ushort(hi)) << 16);
}

// rows r0.. of a [n_total, 64] strided bf16 matrix into a [64][kLd] tile,
// 16-byte chunks; rows past the end are zeros
__device__ __forceinline__ void stage_bf16(__nv_bfloat16* dst, const __nv_bfloat16* base,
                                           long long rs, int r0, int n_total, int tid) {
  for (int i = tid; i < kTile * (kHeadDim / 8); i += kThreads) {
    const int r = i >> 3;
    const int c8 = (i & 7) * 8;
    const int row = r0 + r;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (row < n_total) val = *reinterpret_cast<const uint4*>(base + row * rs + c8);
    *reinterpret_cast<uint4*>(&dst[r * kLd + c8]) = val;
  }
}

// 16 rows (row0 + g, row0 + g + 8) x 64 dims of a strided bf16 matrix as the
// A fragments of 4 k-steps; rows past the end are zeros
__device__ __forceinline__ void load_a_rows(uint32_t (&a)[4][4], const __nv_bfloat16* base,
                                            long long rs, int row0, int n_total,
                                            int g, int t) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = row0 + g + 8 * (i & 1);
      const int col = kk * 16 + 2 * t + 8 * (i >> 1);
      a[kk][i] = row < n_total
          ? *reinterpret_cast<const uint32_t*>(base + row * rs + col) : 0u;
    }
  }
}

// out[j] (16 x 8 per j, 8 tiles) = A (16 x 64, fragments) * tile^T, where the
// tile holds 64 rows x 64 dims: out[., n] = sum_d A[., d] * tile[n][d]
__device__ __forceinline__ void mma_a_tile_t(float (&out)[8][4], const uint32_t (&a)[4][4],
                                             const __nv_bfloat16* tile, int g, int t) {
#pragma unroll
  for (int j = 0; j < 8; ++j) {
#pragma unroll
    for (int c = 0; c < 4; ++c) out[j][c] = 0.0f;
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const __nv_bfloat16* bp = &tile[(j * 8 + g) * kLd + kk * 16 + 2 * t];
      mma_16816(out[j], a[kk], *reinterpret_cast<const uint32_t*>(bp),
                *reinterpret_cast<const uint32_t*>(bp + 8));
    }
  }
}

// acc (16 x 64) += round_bf16(x) (16 x 64 in the accumulator layout, re-used
// as the A operand) * tile (64 rows x 64 dims): acc[., n] += sum_r x[., r] * tile[r][n]
__device__ __forceinline__ void mma_acc_tile(float (&acc)[8][4], const float (&x)[8][4],
                                             const __nv_bfloat16* tile, int g, int t) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    const uint32_t a[4] = {
        pack_f32(x[2 * kk][0], x[2 * kk][1]), pack_f32(x[2 * kk][2], x[2 * kk][3]),
        pack_f32(x[2 * kk + 1][0], x[2 * kk + 1][1]),
        pack_f32(x[2 * kk + 1][2], x[2 * kk + 1][3])};
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      const __nv_bfloat16* bp = &tile[(kk * 16 + 2 * t) * kLd + n * 8 + g];
      mma_16816(acc[n], a, pack_bf16(bp[0], bp[kLd]),
                pack_bf16(bp[8 * kLd], bp[9 * kLd]));
    }
  }
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// 16 rows x 64 dims of f32 accumulators -> bf16, rows past the end skipped
__device__ __forceinline__ void store_rows(__nv_bfloat16* base, long long rs, int row0,
                                           int n_total, const float (&acc)[8][4],
                                           int g, int t) {
  const int ra = row0 + g;
  const int rb = row0 + g + 8;
#pragma unroll
  for (int n = 0; n < 8; ++n) {
    const int col = n * 8 + 2 * t;
    if (ra < n_total)
      *reinterpret_cast<uint32_t*>(base + ra * rs + col) = pack_f32(acc[n][0], acc[n][1]);
    if (rb < n_total)
      *reinterpret_cast<uint32_t*>(base + rb * rs + col) = pack_f32(acc[n][2], acc[n][3]);
  }
}

// Kernel A, bf16: a warp owns 16 query rows and holds their q and do rows as
// A fragments for both passes over the keys.
__global__ void __launch_bounds__(kThreads)
pair_bwd_dq_mma_bf16(const Params p) {
  __shared__ __align__(16) __nv_bfloat16 ks[kTile * kLd];
  __shared__ __align__(16) __nv_bfloat16 vs[kTile * kLd];

  const int b = blockIdx.z;
  const int h = blockIdx.y;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int row0 = blockIdx.x * kTile + warp * 16;

  const __nv_bfloat16* qbase =
      static_cast<const __nv_bfloat16*>(p.q) + b * p.q_bs + p.q_col + h * kHeadDim;
  const __nv_bfloat16* kbase =
      static_cast<const __nv_bfloat16*>(p.k) + b * p.k_bs + p.k_col + h * kHeadDim;
  const __nv_bfloat16* vbase =
      static_cast<const __nv_bfloat16*>(p.v) + b * p.v_bs + p.v_col + h * kHeadDim;
  const __nv_bfloat16* dbase =
      static_cast<const __nv_bfloat16*>(p.dout) + b * p.do_bs + h * kHeadDim;

  uint32_t qa[4][4];
  uint32_t da[4][4];
  load_a_rows(qa, qbase, p.q_rs, row0, p.n_q, g, t);
  load_a_rows(da, dbase, p.do_rs, row0, p.n_q, g, t);

  float s[8][4];
  float dp[8][4];

  // pass 1: online row max m, sum l and delta numerator n for rows g (0)
  // and g + 8 (1); m is kept equal across the four lanes of a row
  float m0 = -CUDART_INF_F, m1 = -CUDART_INF_F;
  float l0 = 0.0f, l1 = 0.0f, n0 = 0.0f, n1 = 0.0f;
  for (int k0 = 0; k0 < p.n_k; k0 += kTile) {
    stage_bf16(ks, kbase, p.k_rs, k0, p.n_k, tid);
    stage_bf16(vs, vbase, p.v_rs, k0, p.n_k, tid);
    __syncthreads();
    mma_a_tile_t(s, qa, ks, g, t);
    mma_a_tile_t(dp, da, vs, g, t);
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
  float acc[8][4];
#pragma unroll
  for (int n = 0; n < 8; ++n)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[n][c] = 0.0f;
  for (int k0 = 0; k0 < p.n_k; k0 += kTile) {
    stage_bf16(ks, kbase, p.k_rs, k0, p.n_k, tid);
    stage_bf16(vs, vbase, p.v_rs, k0, p.n_k, tid);
    __syncthreads();
    mma_a_tile_t(s, qa, ks, g, t);
    mma_a_tile_t(dp, da, vs, g, t);
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
    mma_acc_tile(acc, s, ks, g, t);
    __syncthreads();
  }
  __nv_bfloat16* obase =
      static_cast<__nv_bfloat16*>(p.dq) + b * p.dq_bs + p.dq_col + h * kHeadDim;
  store_rows(obase, p.dq_rs, row0, p.n_q, acc, g, t);
}

// Kernel B, bf16: a warp owns 16 keys, holds their K and V rows as A
// fragments, and walks every query tile in order: S^T = K Q^T and
// dP^T = V dO^T come out keys x rows, so round(p)^T and round(ds)^T are
// already the A operands of dv += p^T dO and dk += ds^T Q.
__global__ void __launch_bounds__(kThreads)
pair_bwd_dkv_mma_bf16(const Params p) {
  __shared__ __align__(16) __nv_bfloat16 qs[kTile * kLd];
  __shared__ __align__(16) __nv_bfloat16 dos[kTile * kLd];
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

  const __nv_bfloat16* qbase =
      static_cast<const __nv_bfloat16*>(p.q) + b * p.q_bs + p.q_col + h * kHeadDim;
  const __nv_bfloat16* kbase =
      static_cast<const __nv_bfloat16*>(p.k) + b * p.k_bs + p.k_col + h * kHeadDim;
  const __nv_bfloat16* vbase =
      static_cast<const __nv_bfloat16*>(p.v) + b * p.v_bs + p.v_col + h * kHeadDim;
  const __nv_bfloat16* dbase =
      static_cast<const __nv_bfloat16*>(p.dout) + b * p.do_bs + h * kHeadDim;
  const float* gm = stat_ptr(p, 0, b, h);
  const float* gil = stat_ptr(p, 1, b, h);
  const float* gdl = stat_ptr(p, 2, b, h);

  uint32_t ka[4][4];
  uint32_t va[4][4];
  load_a_rows(ka, kbase, p.k_rs, key0, p.n_k, g, t);
  load_a_rows(va, vbase, p.v_rs, key0, p.n_k, g, t);

  float dk[8][4];
  float dv[8][4];
#pragma unroll
  for (int n = 0; n < 8; ++n) {
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      dk[n][c] = 0.0f;
      dv[n][c] = 0.0f;
    }
  }
  float st[8][4];
  float dpt[8][4];

  for (int q0 = 0; q0 < p.n_q; q0 += kTile) {
    stage_bf16(qs, qbase, p.q_rs, q0, p.n_q, tid);
    stage_bf16(dos, dbase, p.do_rs, q0, p.n_q, tid);
    if (tid < kTile) {
      // padded query rows: zero statistics give p = exp(0) * 0 = 0
      const int row = q0 + tid;
      const bool ok = row < p.n_q;
      sm[tid] = ok ? gm[row] : 0.0f;
      sil[tid] = ok ? gil[row] : 0.0f;
      sdl[tid] = ok ? gdl[row] : 0.0f;
    }
    __syncthreads();
    mma_a_tile_t(st, ka, qs, g, t);
    mma_a_tile_t(dpt, va, dos, g, t);
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
    mma_acc_tile(dv, st, dos, g, t);
    mma_acc_tile(dk, dpt, qs, g, t);
    __syncthreads();
  }
  __nv_bfloat16* okbase =
      static_cast<__nv_bfloat16*>(p.dk) + b * p.dk_bs + p.dk_col + h * kHeadDim;
  __nv_bfloat16* ovbase =
      static_cast<__nv_bfloat16*>(p.dv) + b * p.dv_bs + p.dv_col + h * kHeadDim;
  store_rows(okbase, p.dk_rs, key0, p.n_k, dk, g, t);
  store_rows(ovbase, p.dv_rs, key0, p.n_k, dv, g, t);
}

}  // namespace

// dtype: 0 = float32 (plain-FMA kernels), 1 = bfloat16 (tensor-core kernels).
// `stats` is f32 scratch of 3 * batch * num_heads * n_q_rows elements.
// Launches kernel A then kernel B on `stream`; returns cudaGetLastError()
// after the launches (0 = launched).
extern "C" int pair_attention_backward(
    const void* q, const void* k, const void* v, const void* dout,
    void* dq, void* dk, void* dv, void* stats, int dtype,
    int batch, int num_heads, int n_q_rows, int n_keys,
    long long q_bs, long long q_rs, int q_col,
    long long k_bs, long long k_rs, int k_col,
    long long v_bs, long long v_rs, int v_col,
    long long do_bs, long long do_rs,
    long long dq_bs, long long dq_rs, int dq_col,
    long long dk_bs, long long dk_rs, int dk_col,
    long long dv_bs, long long dv_rs, int dv_col,
    float scale, void* stream) {
  Params p;
  p.q = q; p.k = k; p.v = v; p.dout = dout;
  p.dq = dq; p.dk = dk; p.dv = dv;
  p.stats = static_cast<float*>(stats);
  p.q_bs = q_bs; p.q_rs = q_rs; p.k_bs = k_bs; p.k_rs = k_rs;
  p.v_bs = v_bs; p.v_rs = v_rs; p.do_bs = do_bs; p.do_rs = do_rs;
  p.dq_bs = dq_bs; p.dq_rs = dq_rs; p.dk_bs = dk_bs; p.dk_rs = dk_rs;
  p.dv_bs = dv_bs; p.dv_rs = dv_rs;
  p.q_col = q_col; p.k_col = k_col; p.v_col = v_col;
  p.dq_col = dq_col; p.dk_col = dk_col; p.dv_col = dv_col;
  p.n_q = n_q_rows; p.n_k = n_keys; p.batch = batch; p.heads = num_heads;
  p.scale = scale;

  const dim3 block(kThreads);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 1) {
    const dim3 grid_a((n_q_rows + kTile - 1) / kTile, num_heads, batch);
    const dim3 grid_b((n_keys + kTile - 1) / kTile, num_heads, batch);
    pair_bwd_dq_mma_bf16<<<grid_a, block, 0, st>>>(p);
    pair_bwd_dkv_mma_bf16<<<grid_b, block, 0, st>>>(p);
  } else if (dtype == 0) {
    const dim3 grid_a((n_q_rows + kFmaRows - 1) / kFmaRows, num_heads, batch);
    const dim3 grid_b((n_keys + kFmaKeys - 1) / kFmaKeys, num_heads, batch);
    pair_bwd_dq_fma_f32<<<grid_a, block, 0, st>>>(p);
    pair_bwd_dkv_fma_f32<<<grid_b, block, 0, st>>>(p);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
