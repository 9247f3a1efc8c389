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
// rescales an accumulator would round at other points. The kernel therefore
// walks the keys twice: pass 1 for m and s, pass 2 recomputes l, forms p and
// accumulates p v. That costs three tile products where the pair kernel does
// two. The TPU kernels pad Sq and Sk to 128 and mask the pad keys to -inf;
// nothing is padded here, ragged tiles are masked.
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
// latency and the tile quantisation (65 rows and 65 keys = two 64-wide
// tiles each) set the time. At B = 64, S = 1025 it is compute-bound (~103 GFLOP useful, ~0.1 ms
// at 989 TFLOP/s dense bf16). Simple first: bf16 on mma.sync m16n8k16 with
// the accumulator re-used as the A operand of PV, f32 on plain FMA; wgmma,
// TMA and keeping a short sequence's K/V resident across both passes are
// later work.

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
// bf16 tensor-core kernel: mma.sync.m16n8k16, 4 warps x 16 query rows
// (fragment layouts, staging and packing: attention_mma.cuh)
// ---------------------------------------------------------------------------

constexpr int kRows = 64;  // query rows per block
constexpr int kKeys = kTile;  // keys per staged tile

// s[j] (16 rows x 8 keys per j, 8 tiles) = q (16 x D, A fragments) * tile^T,
// scaled, keys past the end at -inf
template <int D>
__device__ __forceinline__ void scores(float (&s)[8][4], const uint32_t (&qa)[D / 16][4],
                                       const __nv_bfloat16* ks, int k0, int n_k, float scale,
                                       int g, int t) {
#pragma unroll
  for (int j = 0; j < 8; ++j) {
#pragma unroll
    for (int c = 0; c < 4; ++c) s[j][c] = 0.0f;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const __nv_bfloat16* kp = &ks[(j * 8 + g) * (D + 8) + kk * 16 + 2 * t];
      mma_16816(s[j], qa[kk], *reinterpret_cast<const uint32_t*>(kp),
                *reinterpret_cast<const uint32_t*>(kp + 8));
    }
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int key = k0 + j * 8 + 2 * t + (c & 1);
      s[j][c] = key < n_k ? s[j][c] * scale : -CUDART_INF_F;
    }
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads)
heads_attention_mma_bf16(const Params p) {
  constexpr int kLd = D + 8;
  __shared__ __align__(16) __nv_bfloat16 ks[kKeys * kLd];
  __shared__ __align__(16) __nv_bfloat16 vs[kKeys * kLd];

  const int b = blockIdx.z;
  const int h = blockIdx.y;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int row0 = blockIdx.x * kRows + warp * 16;
  // a warp whose 16 rows lie past the last query row (S = 65: three of the
  // second tile's four) only helps to stage the tiles
  const bool warp_live = row0 < p.n_q;

  const __nv_bfloat16* qbase =
      static_cast<const __nv_bfloat16*>(p.q) + b * p.q_bs + h * p.q_hs;
  const __nv_bfloat16* kbase =
      static_cast<const __nv_bfloat16*>(p.k) + b * p.k_bs + h * p.k_hs;
  const __nv_bfloat16* vbase =
      static_cast<const __nv_bfloat16*>(p.v) + b * p.v_bs + h * p.v_hs;

  // 16 query rows x D dims as the A fragments of D / 16 k-steps
  uint32_t qa[D / 16][4];
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = row0 + g + 8 * (i & 1);
      const int col = kk * 16 + 2 * t + 8 * (i >> 1);
      qa[kk][i] = row < p.n_q
          ? *reinterpret_cast<const uint32_t*>(qbase + row * p.q_rs + col) : 0u;
    }
  }

  float s[8][4];

  // pass 1: row maximum m and sum l of exp(. - m) for rows g (0) and g + 8
  // (1), online over the key tiles; m is kept equal across a row's four lanes
  float m0 = -CUDART_INF_F, m1 = -CUDART_INF_F;
  float l0 = 0.0f, l1 = 0.0f;
  for (int k0 = 0; k0 < p.n_k; k0 += kKeys) {
    stage_bf16<D>(ks, kbase, p.k_rs, k0, p.n_k, tid);
    __syncthreads();
    if (warp_live) {
      scores<D>(s, qa, ks, k0, p.n_k, p.scale, g, t);
      float mx0 = -CUDART_INF_F, mx1 = -CUDART_INF_F;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        mx0 = fmaxf(mx0, fmaxf(s[j][0], s[j][1]));
        mx1 = fmaxf(mx1, fmaxf(s[j][2], s[j][3]));
      }
      // every key tile holds at least one real key, so the new maxima are finite
      const float mn0 = fmaxf(m0, quad_max(mx0));
      const float mn1 = fmaxf(m1, quad_max(mx1));
      l0 *= expf(m0 - mn0);
      l1 *= expf(m1 - mn1);
      m0 = mn0;
      m1 = mn1;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        l0 += expf(s[j][0] - m0) + expf(s[j][1] - m0);
        l1 += expf(s[j][2] - m1) + expf(s[j][3] - m1);
      }
    }
    __syncthreads();
  }
  l0 = quad_sum(l0);
  l1 = quad_sum(l1);

  // pass 2: p = round_bf16(exp(l - m) / sum), out += p V. The S accumulators
  // of key tiles 2kk and 2kk + 1 are the A fragment of k-step kk of P V.
  float acc[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[n][c] = 0.0f;
  for (int k0 = 0; k0 < p.n_k; k0 += kKeys) {
    stage_bf16<D>(ks, kbase, p.k_rs, k0, p.n_k, tid);
    stage_bf16<D>(vs, vbase, p.v_rs, k0, p.n_k, tid);
    __syncthreads();
    if (warp_live) {
      scores<D>(s, qa, ks, k0, p.n_k, p.scale, g, t);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        s[j][0] = expf(s[j][0] - m0) / l0;
        s[j][1] = expf(s[j][1] - m0) / l0;
        s[j][2] = expf(s[j][2] - m1) / l1;
        s[j][3] = expf(s[j][3] - m1) / l1;
      }
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const uint32_t pa[4] = {
            pack_f32(s[2 * kk][0], s[2 * kk][1]), pack_f32(s[2 * kk][2], s[2 * kk][3]),
            pack_f32(s[2 * kk + 1][0], s[2 * kk + 1][1]),
            pack_f32(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
        for (int n = 0; n < D / 8; ++n) {
          const __nv_bfloat16* vp = &vs[(kk * 16 + 2 * t) * kLd + n * 8 + g];
          mma_16816(acc[n], pa, pack_bf16(vp[0], vp[kLd]),
                    pack_bf16(vp[8 * kLd], vp[9 * kLd]));
        }
      }
    }
    __syncthreads();
  }

  __nv_bfloat16* obase = static_cast<__nv_bfloat16*>(p.o) + b * p.o_bs + h * p.o_hs;
  const int ra = row0 + g;
  const int rb = row0 + g + 8;
#pragma unroll
  for (int n = 0; n < D / 8; ++n) {
    const int col = n * 8 + 2 * t;
    if (ra < p.n_q)
      *reinterpret_cast<uint32_t*>(obase + ra * p.o_rs + col) = pack_f32(acc[n][0], acc[n][1]);
    if (rb < p.n_q)
      *reinterpret_cast<uint32_t*>(obase + rb * p.o_rs + col) = pack_f32(acc[n][2], acc[n][3]);
  }
}

template <int D>
int launch(const Params& p, int dtype, int batch, int num_heads, cudaStream_t st) {
  const dim3 block(kThreads);
  if (dtype == 1) {
    const dim3 grid((p.n_q + kRows - 1) / kRows, num_heads, batch);
    heads_attention_mma_bf16<D><<<grid, block, 0, st>>>(p);
  } else if (dtype == 0) {
    const dim3 grid((p.n_q + kFmaRows - 1) / kFmaRows, num_heads, batch);
    heads_attention_fma_f32<D><<<grid, block, 0, st>>>(p);
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
