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
// Design: bf16 runs on the tensor cores through mma.sync m16n8k16 (f32
// accumulate), the backward's recipe (heads_attention_bwd.cu). A block of
// 8 warps takes 128 query rows of one (batch, head) (4 warps and 64 rows
// for a launch of at most 64 rows, the CLS row); each warp holds its 16
// rows of qs as A fragments in registers for the whole key loop. K and V
// tiles of 64 keys come by cp.async into a ring of three XOR-swizzled
// slots, the copies of the next two tiles in flight during the current
// tile's products, one barrier per tile. S = qs K^T comes from ldmatrix.x4 B fragments, e V from
// ldmatrix.x4.trans ones, with the accumulator layout of S re-used as the A
// operand (e rounded to bf16 packs two keys per register). A ragged last key
// tile multiplies only its groups and k-steps that hold a real key (a tail
// of at most 16 keys has its own instantiation); the last query tile keeps
// only the warps that hold a real row (S = 1025: one of eight). Per logit the
// chain costs a min, one ex2.approx.ftz and half a bf16x2 pack: e stays
// packed as the A operand, and its row sums come from one more mma per
// k-step against a column of ones, not from f32 adds. float32 (the tests'
// type) runs on plain FMA.
//
// Measured on an H100 80GB HBM3 at 700 W (B = 64, S = 1025, bf16): qkv 0.48
// ms (~216 TFLOP/s useful, 22% of the operations bound), kv_shared 0.46,
// CLS 0.043 (71% of its bytes bound). Next: wgmma, and the shared-kv tile
// kept resident across several pairs of a chunk.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "attention_mma.cuh"

namespace {

constexpr int kHeadDim = 64;
constexpr float kExp2Clamp = 80.0f;  // _EXP2_CLAMP of the TPU kernel
constexpr int kRows = 64;             // query rows per block of the f32 kernel

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
// bf16 tensor-core kernel (fragment layouts, staging and ldmatrix helpers:
// attention_mma.cuh): kW warps x 16 query rows per block, each warp holding
// its rows of qs as A fragments; K and V tiles of 64 keys come by cp.async
// through a ring of kStages slots, kStages - 1 tiles ahead of the products.
// ---------------------------------------------------------------------------

// three slots (48 KB): the CLS launch (one warp a block, bound by bytes)
// keeps two tiles in flight; the long launches are no faster with it
constexpr int kStages = 3;
constexpr int kTileBytes = kTile * kHeadDim * 2;   // 8 KB; a slot: K, then V
// an SM holds 2 blocks of 8 warps or 4 of 4
constexpr int kMaxRegs = 128;

// bf16 1.0 in both halves: the B fragment of a column of ones
constexpr uint32_t kOnes = 0x3F803F80u;

// one key tile with nk real keys: e = round_bf16(exp2(min(qs.k, 80))), packed
// two keys a register as the A operand of acc += e V and of den += e 1 (the
// rows' sums of the rounded e, in f32 on the tensor cores: den[0] and den[1]
// hold row g's, den[2] and den[3] row g + 8's). kRagged (nk < 64) masks keys
// >= nk; kJ bounds the 8-key groups touched (2 for a last tile of at most 16
// keys); only the groups j < jn with a real key are multiplied, and only the
// 16-key k-steps kk < kn of e V.
template <bool kRagged, int kJ>
__device__ __forceinline__ void pair_tile(const uint32_t (&qa)[kHeadDim / 16][4],
                                          uint32_t kt, uint32_t vt, int nk, int lane,
                                          float (&acc)[kHeadDim / 8][4], float (&den)[4]) {
  const int jn = kRagged ? (nk + 7) / 8 : 8;
  const int kn = kRagged ? (nk + 15) / 16 : 4;
  const int t = lane & 3;
  float s[8][4];
  mma_frags_tile_t<kHeadDim, kJ>(s, qa, kt, jn, lane);
#pragma unroll
  for (int kk = 0; kk < kJ / 2; ++kk) {
    if (kk < kn) {
      // A fragment: a[2 h + r] holds group 2 kk + h, row g + 8 r, keys 2t, 2t + 1
      uint32_t a[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int j = 2 * kk + (i >> 1);
        const int c = 2 * (i & 1);
        float e0 = exp2_ftz(fminf(s[j][c], kExp2Clamp));
        float e1 = exp2_ftz(fminf(s[j][c + 1], kExp2Clamp));
        if (kRagged) {
          const int key = j * 8 + 2 * t;
          if (key >= nk) e0 = 0.0f;
          if (key + 1 >= nk) e1 = 0.0f;
        }
        a[i] = pack_f32(e0, e1);
      }
      mma_acc_kstep<kHeadDim>(acc, a, vt, kk, lane);
      mma_16816(den, a, kOnes, kOnes);
    }
  }
}

// kW warps, 16 query rows each
template <int kW>
__global__ void __maxnreg__(kMaxRegs) pair_attention_mma_bf16(const Params p) {
  __shared__ __align__(128) __nv_bfloat16 ring[kStages * 2 * kTile * kHeadDim];

  const int b = blockIdx.z;
  const int h = blockIdx.y;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int block_row0 = blockIdx.x * 16 * kW;
  const int row0 = block_row0 + (tid >> 5) * 16;
  // the warps of the last query tile past its last row (S = 1025: seven of
  // the 9th tile's eight) leave at once; the others stage the tiles alone
  // and synchronise among themselves
  if (row0 >= p.n_q) return;
  const int n_threads = min(kW * 32, (p.n_q - block_row0 + 15) / 16 * 32);

  const __nv_bfloat16* qbase =
      static_cast<const __nv_bfloat16*>(p.q) + b * p.q_bs + p.q_col + h * kHeadDim;
  const __nv_bfloat16* kbase =
      static_cast<const __nv_bfloat16*>(p.k) + b * p.k_bs + p.k_col + h * kHeadDim;
  const __nv_bfloat16* vbase =
      static_cast<const __nv_bfloat16*>(p.v) + b * p.v_bs + p.v_col + h * kHeadDim;

  const int n_tiles = (p.n_k + kTile - 1) / kTile;
  const int last_n = p.n_k - (n_tiles - 1) * kTile;  // real keys of the last tile
  auto issue = [&](int tile) {
    __nv_bfloat16* kt = ring + (tile % kStages) * 2 * kTile * kHeadDim;
    stage_async<kHeadDim, kTile>(kt, kbase, p.k_rs, tile * kTile, p.n_k, tid, n_threads);
    stage_async<kHeadDim, kTile>(kt + kTile * kHeadDim, vbase, p.v_rs, tile * kTile, p.n_k,
                                 tid, n_threads);
  };
#pragma unroll
  for (int v = 0; v < kStages - 1; ++v) {
    if (v < n_tiles) issue(v);
    cp_async_commit();
  }

  // before the first wait: qs = round_bf16(q * scale * log2 e) as A
  // fragments, 4 k-steps of 16 dims, rows past the end zero
  uint32_t qa[kHeadDim / 16][4];
#pragma unroll
  for (int kk = 0; kk < kHeadDim / 16; ++kk) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = row0 + g + 8 * (i & 1);
      const int col = kk * 16 + 2 * t + 8 * (i >> 1);
      float x0 = 0.0f, x1 = 0.0f;
      if (row < p.n_q) {
        const __nv_bfloat162 x =
            *reinterpret_cast<const __nv_bfloat162*>(qbase + row * p.q_rs + col);
        x0 = __low2float(x) * p.scale_log2e;
        x1 = __high2float(x) * p.scale_log2e;
      }
      qa[kk][i] = pack_f32(x0, x1);
    }
  }

  float acc[kHeadDim / 8][4];
#pragma unroll
  for (int n = 0; n < kHeadDim / 8; ++n)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[n][c] = 0.0f;
  float den[4] = {0.0f, 0.0f, 0.0f, 0.0f};

  for (int tile = 0; tile < n_tiles; ++tile) {
    cp_async_wait<kStages - 2>();
    bar_sync(n_threads);  // tile landed for every thread; the slot of tile - 1 is free
    if (tile + kStages - 1 < n_tiles) issue(tile + kStages - 1);
    cp_async_commit();
    const uint32_t kt = smem_u32(ring + (tile % kStages) * 2 * kTile * kHeadDim);
    const uint32_t vt = kt + kTileBytes;
    if (tile < n_tiles - 1 || last_n == kTile)
      pair_tile<false, 8>(qa, kt, vt, kTile, lane, acc, den);
    else if (last_n > 16)
      pair_tile<true, 8>(qa, kt, vt, last_n, lane, acc, den);
    else
      pair_tile<true, 2>(qa, kt, vt, last_n, lane, acc, den);
  }

  const float den0 = den[0];
  const float den1 = den[2];
  __nv_bfloat16* obase = static_cast<__nv_bfloat16*>(p.o) + b * p.o_bs + h * kHeadDim;
  const int ra = row0 + g;
  const int rb = row0 + g + 8;
#pragma unroll
  for (int n = 0; n < kHeadDim / 8; ++n) {
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

  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 1) {
    // 8 warps share each staged tile among 128 rows; a launch of at most 64
    // rows (the CLS row: one live warp a block, bound by bytes) takes 4-warp
    // blocks, twice as many of which fit an SM
    if (n_q_rows <= 64) {
      const dim3 grid((n_q_rows + 63) / 64, num_heads, batch);
      pair_attention_mma_bf16<4><<<grid, 4 * 32, 0, st>>>(p);
    } else {
      const dim3 grid((n_q_rows + 127) / 128, num_heads, batch);
      pair_attention_mma_bf16<8><<<grid, 8 * 32, 0, st>>>(p);
    }
  } else if (dtype == 0) {
    const dim3 grid((n_q_rows + kRows - 1) / kRows, num_heads, batch);
    pair_attention_fma_f32<<<grid, kThreads, 0, st>>>(p);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
