// Pair attention forward for Hopper (sm_90a), head_dim 64.
//
// Replaces the TPU kernel `_pair_kernel` of vit_ed_tpu/ops/attention.py
// (:471) in every forward launch its wrappers make: `_pair_forward_qkv`
// (:687), `_pair_forward_q_kv_shared` (:887), `_pair_forward_qkv_cls`
// (:794), `_pair_forward_q_kv` (:740) and `_pair_forward` (:500). Per head
// it computes the TPU kernel's chain exactly, with T the input type:
//
//   qs  = round_T(q * (scale * log2(e)))
//   l   = dot_f32(qs, k)                      per key, f32 accumulate
//   e   = round_T(exp2(min(l, 80)))           static clamp, no max-subtract
//   out = round_T(sum_k(e * v) / sum_k(e))    denominator: the ROUNDED e, f32
//
// Without a max-subtract there is no online-softmax rescaling: one pass
// over the keys builds numerator and denominator together, and the key
// loop stops at n_keys exactly (keys past the end contribute nothing). The
// TPU kernel's head-pair lane masking (two heads per 128-lane tile, half
// of every product on zeros) is not carried over: each block works on one
// head, so no FLOP is wasted.
//
// Addressing: three base pointers with batch and row strides in elements
// and one column offset per stream, so one kernel reads q|k|v inside the
// fused [B, S, 3C] projection, k|v inside [B, Sk, 2C], and a shared kv row
// (batch stride 0) without a split or a copy. n_q_rows lets the CLS launch
// compute a single query row. The kernel allocates nothing; the output is
// a [B, n_q_rows, C] tensor (its strides are passed too).
//
// What bounds it on an H100: at the flagship shapes (B = 64 pairs, 6 heads,
// S = 1025) one launch does 4 * 64 * 6 * 1025^2 * 64 ~ 103 GFLOP and reads
// ~0.1 GB, so it is compute-bound: ~105 us at 989 TFLOP/s dense bf16. One
// 64-pair chunk of ViTED.score_tokens_row launches the qkv wrapper 10 times
// (S = 1025), the shared-kv wrapper 11 times with Sq = 1025 and once with
// Sq = 1 (Sk = 1024 each time), and the CLS wrapper once. The CLS launch is
// memory-bound: it reads ~100 MB of K/V, ~30 us at 3.35 TB/s.
//
// Design (simple first, fast later): bf16 runs on the tensor cores through
// mma.sync m16n8k16 (f32 accumulate). A block of 4 warps takes 64 query
// rows of one (batch, head); each warp holds its 16 rows of qs as A
// fragments in registers for the whole key loop. K/V tiles of 64 keys are
// staged through shared memory with 16-byte loads; S = qs K^T comes out of
// 32 mma per warp in the accumulator layout, which is re-used directly as
// the A operand of P V (e rounded to bf16 packs two keys per register).
// float32 (the tests' type) runs on plain FMA. wgmma, TMA pipelines and a
// shared-kv tile kept resident across pairs are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "attention_mma.cuh"

namespace {

constexpr int kHeadDim = 64;
constexpr float kExp2Clamp = 80.0f;  // _EXP2_CLAMP of the TPU kernel
constexpr int kRows = 64;             // query rows per block (both kernels)

struct Params {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  long long q_bs, q_rs, k_bs, k_rs, v_bs, v_rs, o_bs, o_rs;
  int q_col, k_col, v_col;
  int n_q, n_k;
  float scale_log2e;
};

// ---------------------------------------------------------------------------
// float32 kernel, plain FMA (the tests' type; rounding to T is the identity).
// Thread pair (2r, 2r+1) owns query row r of the block: each computes the
// scores of half of a 32-key tile, and the output for half of the 64 dims.
// ---------------------------------------------------------------------------

constexpr int kFmaKeys = 32;

__global__ void __launch_bounds__(kThreads)
pair_attention_fma_f32(const Params p) {
  __shared__ float ks[kFmaKeys][kHeadDim];
  __shared__ float vs[kFmaKeys][kHeadDim];
  __shared__ float ps[kRows][kFmaKeys + 1];

  const int b = blockIdx.z;
  const int h = blockIdx.y;
  const int tid = threadIdx.x;
  const int r = tid >> 1;
  const int half = tid & 1;
  const int row = blockIdx.x * kRows + r;
  const bool live = row < p.n_q;

  const float* kbase = static_cast<const float*>(p.k) + b * p.k_bs + p.k_col + h * kHeadDim;
  const float* vbase = static_cast<const float*>(p.v) + b * p.v_bs + p.v_col + h * kHeadDim;

  float qs[kHeadDim];
  const float* qrow = static_cast<const float*>(p.q) + b * p.q_bs +
                      (live ? row : 0) * p.q_rs + p.q_col + h * kHeadDim;
#pragma unroll
  for (int d = 0; d < kHeadDim; ++d) qs[d] = live ? qrow[d] * p.scale_log2e : 0.0f;

  float acc[kHeadDim / 2];
#pragma unroll
  for (int d = 0; d < kHeadDim / 2; ++d) acc[d] = 0.0f;
  float den = 0.0f;

  for (int k0 = 0; k0 < p.n_k; k0 += kFmaKeys) {
    for (int i = tid; i < kFmaKeys * kHeadDim; i += kThreads) {
      const int kr = i / kHeadDim;
      const int d = i % kHeadDim;
      const int key = k0 + kr;
      const bool ok = key < p.n_k;
      ks[kr][d] = ok ? kbase[key * p.k_rs + d] : 0.0f;
      vs[kr][d] = ok ? vbase[key * p.v_rs + d] : 0.0f;
    }
    __syncthreads();

#pragma unroll 4
    for (int j = 0; j < kFmaKeys / 2; ++j) {
      const int kr = half * (kFmaKeys / 2) + j;
      float l = 0.0f;
#pragma unroll
      for (int d = 0; d < kHeadDim; ++d) l = fmaf(qs[d], ks[kr][d], l);
      const float e = (k0 + kr < p.n_k) ? exp2f(fminf(l, kExp2Clamp)) : 0.0f;
      ps[r][kr] = e;
      den += e;
    }
    __syncthreads();

    for (int kr = 0; kr < kFmaKeys; ++kr) {
      const float e = ps[r][kr];
#pragma unroll
      for (int d = 0; d < kHeadDim / 2; ++d)
        acc[d] = fmaf(e, vs[kr][half * (kHeadDim / 2) + d], acc[d]);
    }
    __syncthreads();
  }

  den += __shfl_xor_sync(0xffffffffu, den, 1);
  if (live) {
    float* orow = static_cast<float*>(p.o) + b * p.o_bs + row * p.o_rs +
                  h * kHeadDim + half * (kHeadDim / 2);
#pragma unroll
    for (int d = 0; d < kHeadDim / 2; ++d) orow[d] = acc[d] / den;
  }
}

// ---------------------------------------------------------------------------
// bf16 tensor-core kernel: mma.sync.m16n8k16, 4 warps x 16 query rows
// (fragment layouts and packing: attention_mma.cuh)
// ---------------------------------------------------------------------------

constexpr int kMmaKeys = 64;
constexpr int kLd = kHeadDim + 8;  // smem row pitch (144 B): conflict-free B loads

__global__ void __launch_bounds__(kThreads)
pair_attention_mma_bf16(const Params p) {
  __shared__ __align__(16) __nv_bfloat16 ks[kMmaKeys * kLd];
  __shared__ __align__(16) __nv_bfloat16 vs[kMmaKeys * kLd];

  const int b = blockIdx.z;
  const int h = blockIdx.y;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int row0 = blockIdx.x * kRows + warp * 16;

  const __nv_bfloat16* qbase =
      static_cast<const __nv_bfloat16*>(p.q) + b * p.q_bs + p.q_col + h * kHeadDim;
  const __nv_bfloat16* kbase =
      static_cast<const __nv_bfloat16*>(p.k) + b * p.k_bs + p.k_col + h * kHeadDim;
  const __nv_bfloat16* vbase =
      static_cast<const __nv_bfloat16*>(p.v) + b * p.v_bs + p.v_col + h * kHeadDim;

  // qs = round_bf16(q * scale * log2 e) as A fragments, 4 k-steps of 16 dims
  uint32_t qa[4][4];
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = row0 + g + 8 * (i & 1);
      const int col = kk * 16 + 2 * t + 8 * (i >> 1);
      float x0 = 0.0f, x1 = 0.0f;
      if (row < p.n_q) {
        const __nv_bfloat16* src = qbase + row * p.q_rs + col;
        x0 = __bfloat162float(src[0]) * p.scale_log2e;
        x1 = __bfloat162float(src[1]) * p.scale_log2e;
      }
      qa[kk][i] = pack_f32(x0, x1);
    }
  }

  float acc[8][4];
#pragma unroll
  for (int n = 0; n < 8; ++n)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[n][c] = 0.0f;
  float den0 = 0.0f;  // rows g and g + 8, this thread's keys only
  float den1 = 0.0f;

  for (int k0 = 0; k0 < p.n_k; k0 += kMmaKeys) {
    // stage the K and V tiles: 64 keys x 64 dims, 16-byte chunks
    for (int i = tid; i < kMmaKeys * (kHeadDim / 8); i += kThreads) {
      const int kr = i >> 3;
      const int c8 = (i & 7) * 8;
      const int key = k0 + kr;
      uint4 kv = make_uint4(0u, 0u, 0u, 0u);
      uint4 vv = make_uint4(0u, 0u, 0u, 0u);
      if (key < p.n_k) {
        kv = *reinterpret_cast<const uint4*>(kbase + key * p.k_rs + c8);
        vv = *reinterpret_cast<const uint4*>(vbase + key * p.v_rs + c8);
      }
      *reinterpret_cast<uint4*>(&ks[kr * kLd + c8]) = kv;
      *reinterpret_cast<uint4*>(&vs[kr * kLd + c8]) = vv;
    }
    __syncthreads();

    // S = qs K^T for 16 rows x 64 keys: 8 key tiles of 8
    float s[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int c = 0; c < 4; ++c) s[j][c] = 0.0f;
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const __nv_bfloat16* kp = &ks[(j * 8 + g) * kLd + kk * 16 + 2 * t];
        mma_16816(s[j], qa[kk], *reinterpret_cast<const uint32_t*>(kp),
                  *reinterpret_cast<const uint32_t*>(kp + 8));
      }
    }

    // e = round_bf16(exp2(min(l, 80))); keys past the end give 0
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int key = k0 + j * 8 + 2 * t + (c & 1);
        const float e = key < p.n_k
            ? __bfloat162float(__float2bfloat16_rn(exp2f(fminf(s[j][c], kExp2Clamp))))
            : 0.0f;
        s[j][c] = e;
        if (c < 2) den0 += e; else den1 += e;
      }
    }

    // out += e V: the S accumulators of key tiles 2kk, 2kk+1 are the
    // A fragment of k-step kk
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const uint32_t pa[4] = {
          pack_f32(s[2 * kk][0], s[2 * kk][1]), pack_f32(s[2 * kk][2], s[2 * kk][3]),
          pack_f32(s[2 * kk + 1][0], s[2 * kk + 1][1]),
          pack_f32(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
      for (int n = 0; n < 8; ++n) {
        const __nv_bfloat16* vp = &vs[(kk * 16 + 2 * t) * kLd + n * 8 + g];
        mma_16816(acc[n], pa, pack_bf16(vp[0], vp[kLd]),
                  pack_bf16(vp[8 * kLd], vp[9 * kLd]));
      }
    }
    __syncthreads();
  }

  // the four lanes of a row (same g) hold disjoint key subsets
  den0 += __shfl_xor_sync(0xffffffffu, den0, 1);
  den0 += __shfl_xor_sync(0xffffffffu, den0, 2);
  den1 += __shfl_xor_sync(0xffffffffu, den1, 1);
  den1 += __shfl_xor_sync(0xffffffffu, den1, 2);

  __nv_bfloat16* obase = static_cast<__nv_bfloat16*>(p.o) + b * p.o_bs + h * kHeadDim;
  const int ra = row0 + g;
  const int rb = row0 + g + 8;
#pragma unroll
  for (int n = 0; n < 8; ++n) {
    const int col = n * 8 + 2 * t;
    if (ra < p.n_q)
      *reinterpret_cast<uint32_t*>(obase + ra * p.o_rs + col) =
          pack_f32(acc[n][0] / den0, acc[n][1] / den0);
    if (rb < p.n_q)
      *reinterpret_cast<uint32_t*>(obase + rb * p.o_rs + col) =
          pack_f32(acc[n][2] / den1, acc[n][3] / den1);
  }
}

}  // namespace

// dtype: 0 = float32 (plain-FMA kernel), 1 = bfloat16 (tensor-core kernel).
// Returns cudaGetLastError() after the launch (0 = launched).
extern "C" int pair_attention_forward(
    const void* q, const void* k, const void* v, void* o, int dtype,
    int batch, int num_heads, int n_q_rows, int n_keys,
    long long q_bs, long long q_rs, int q_col,
    long long k_bs, long long k_rs, int k_col,
    long long v_bs, long long v_rs, int v_col,
    long long o_bs, long long o_rs, float scale_log2e, void* stream) {
  Params p;
  p.q = q; p.k = k; p.v = v; p.o = o;
  p.q_bs = q_bs; p.q_rs = q_rs; p.k_bs = k_bs; p.k_rs = k_rs;
  p.v_bs = v_bs; p.v_rs = v_rs; p.o_bs = o_bs; p.o_rs = o_rs;
  p.q_col = q_col; p.k_col = k_col; p.v_col = v_col;
  p.n_q = n_q_rows; p.n_k = n_keys;
  p.scale_log2e = scale_log2e;

  const dim3 grid((n_q_rows + kRows - 1) / kRows, num_heads, batch);
  const dim3 block(kThreads);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 1) {
    pair_attention_mma_bf16<<<grid, block, 0, st>>>(p);
  } else if (dtype == 0) {
    pair_attention_fma_f32<<<grid, block, 0, st>>>(p);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
