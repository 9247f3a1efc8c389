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
// not carried over.
//
// Addressing, as in heads_attention.cu: every tensor is a base pointer plus
// batch, head and row strides in elements with a unit last stride, so q|k|v
// are read inside a fused projection and dq|dk|dv are written straight into
// one fused gradient of the same layout; the CLS VJP (n_q = 1) writes dq into
// row 0 only. A q tile never reads or writes past n_q rows.
//
// What bounds it on an H100. At B = 49 pairs, 6 heads, S = 1025, D = 64 (the
// hisfrag training step) the 9 products are 356 GFLOP, 0.36 ms at the dense
// bf16 peak of 989 TFLOP/s (mma.sync reaches less), while the bytes (q, k,
// v, do once, three gradients once) take ~0.02 ms at 3.35 TB/s: it is bound
// by operations. Three exp2 per logit and ~10 f32 operations around each
// are another ~0.3 ms at the f32 issue rate. At the puzzle shapes (B = 128,
// 12 heads, S = 65, D = 32) it is bound by bytes (~10 us) and by launch
// latency. Measured on an H100 80GB HBM3 at 700 W: dq + dkv 1.59 ms at the
// hisfrag shape (223 TFLOP/s executed), 0.061 ms at the puzzle's S = 65.
//
// The bf16 kernels' design, and why:
//   - fragments by ldmatrix.x4 (two n-blocks of S / dP per instruction) and
//     ldmatrix.x4.trans (two n-blocks of dq / dv / dk) from tiles
//     XOR-swizzled by 16-byte chunks, so that no ldmatrix has a bank
//     conflict: with 16-bit shared loads per B fragment the load/store unit,
//     not the tensor cores, sets the pace;
//   - tiles by cp.async into a ring of kStages buffers in dynamic shared
//     memory, the next tile's copy issued before the current tile's
//     products, one barrier per tile: nothing waits on a synchronous copy;
//   - a ragged last tile computes only its 8-wide groups and 16-deep k-steps
//     that hold a real key (dq) or query row (dkv), and rows that fit one
//     block (up to 128 at D <= 64) take one block of as many warps as they
//     need: S = 65 costs one more warp, not a second block and a masked
//     second tile;
//   - registers are capped (kMaxRegs) so that 3 blocks of 4 warps (D = 64)
//     or 4 (D = 32) share an SM to hide latency. Longer sequences take
//     4-warp blocks of 64 rows: 8-warp blocks of 128 rows (each staged tile
//     feeding twice the rows) measured slower on the H100, with one block
//     per SM at ~240 registers.
// When all key tiles of a (batch, head) fit in the ring (S <= 128: the whole
// puzzle path), dq stages K and V once for both passes, in an instantiation
// of its own chosen at launch: a run-time branch between the two schemes
// cost the long sequences' dq ~5% at D = 32. The softmax is taken
// as exp2(s * scale * log2 e - m * log2 e), one FFMA and one ex2.approx.ftz;
// the statistics keep m in the units of s. The f32 kernels (the tests' type)
// are plain FMA, one thread quad per row.

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
// bf16 tensor-core kernels (fragment layouts, staging and ldmatrix helpers:
// attention_mma.cuh). A block has blockDim.x / 32 warps of 16 rows each
// (dq: query rows, dkv: keys; block_warps picks the count at launch); the
// streamed operand comes in 64-row tiles through a ring of kStages buffers
// in dynamic shared memory, the copy of a tile issued one tile ahead of its
// products.
// ---------------------------------------------------------------------------

template <int D>
struct Bf16Cfg {
  // warps of a block (16 rows each: query rows in dq, keys in dkv): as many
  // as the rows when they fit one block, else kLongWarps
  static constexpr int kMaxWarps = D <= 64 ? 8 : 4;
  static constexpr int kLongWarps = 4;
  static constexpr int kN = 64;              // rows of a streamed tile
  static constexpr int kStages = 2;
  // registers per thread: 3 blocks of 4 warps per SM at D = 64, 4 at D <= 32
  // (a few bytes spill at D = 64); D = 128 takes what it needs
  static constexpr int kMaxRegs = D == 64 ? 168 : (D == 128 ? 255 : 128);
  static constexpr int kTileBytes = kN * D * 2;
  // dq: K and V tiles; dkv: Q and dO tiles plus m, 1 / l, delta of their rows
  static constexpr int kDqStageBytes = 2 * kTileBytes;
  static constexpr int kDkvStageBytes = 2 * kTileBytes + 3 * kN * 4;
};

// The tile bodies below take the tile's real rows nk (keys in dq, query rows
// in dkv) and two compile-time bounds: kRagged (nk < 64: mask and skip what
// is past nk) and kJ, the 8-row groups the code may touch (8; 2 for a last
// tile of at most 16 rows, such as the 65th row of S = 65, so that its
// fragments are neither zeroed nor scanned past the first k-step).

// pass 1 of dq on one key tile: online row max, sum and delta numerator for
// rows g (i = 0) and g + 8 (i = 1). Only the 8-key groups j < jn (those that
// hold a real key) are computed; with kRagged, keys >= nk are masked.
template <int D, bool kRagged, int kJ>
__device__ __forceinline__ void dq_pass1_tile(const uint32_t (&qa)[D / 16][4],
                                              const uint32_t (&da)[D / 16][4], uint32_t kt,
                                              uint32_t vt, int nk, int lane, float c2,
                                              float scale, float (&mr)[2], float (&off)[2],
                                              float (&l)[2], float (&n)[2]) {
  const int jn = kRagged ? (nk + 7) / 8 : 8;
  const int t = lane & 3;
  float s[8][4];
  float dp[8][4];
  mma_frags_tile_t<D, kJ>(s, qa, kt, jn, lane);
  mma_frags_tile_t<D, kJ>(dp, da, vt, jn, lane);
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
    const float o = mr[i] * scale * kLog2e;
    const float corr = exp2_ftz(off[i] - o);
    l[i] *= corr;
    n[i] *= corr;
    off[i] = o;
  }
#pragma unroll
  for (int j = 0; j < kJ; ++j) {
    if (j < jn) {
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int i = c >> 1;
        const float e = exp2_ftz(fmaf(s[j][c], c2, -off[i]));
        l[i] += e;
        n[i] = fmaf(e, dp[j][c], n[i]);
      }
    }
  }
}

// pass 2 of dq on one key tile: ds = p (dp - delta) scale, acc += round(ds) K,
// over the 16-key k-steps that hold a real key
template <int D, bool kRagged, int kJ>
__device__ __forceinline__ void dq_pass2_tile(const uint32_t (&qa)[D / 16][4],
                                              const uint32_t (&da)[D / 16][4], uint32_t kt,
                                              uint32_t vt, int nk, int lane, float c2,
                                              float scale, const float (&off)[2],
                                              const float (&il)[2], const float (&dl)[2],
                                              float (&acc)[D / 8][4]) {
  const int jn = kRagged ? (nk + 7) / 8 : 8;
  const int kn = kRagged ? (nk + 15) / 16 : 4;
  const int t = lane & 3;
  float s[8][4];
  float dp[8][4];
  mma_frags_tile_t<D, kJ>(s, qa, kt, jn, lane);
  mma_frags_tile_t<D, kJ>(dp, da, vt, jn, lane);
#pragma unroll
  for (int j = 0; j < kJ; ++j) {
    if (j < 2 * kn) {
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int i = c >> 1;
        float pv = exp2_ftz(fmaf(s[j][c], c2, -off[i])) * il[i];
        if (kRagged && j * 8 + 2 * t + (c & 1) >= nk) pv = 0.0f;
        s[j][c] = pv * (dp[j][c] - dl[i]) * scale;
      }
    }
  }
  mma_acc_tile<D, kJ / 2>(acc, s, kt, kn, lane);
}

// dq, bf16: a warp owns 16 query rows and holds their q and do rows as A
// fragments. Pass 1 walks the key tiles for the row statistics, pass 2 walks
// them again for dq; both passes run through one ring of K/V tiles (2 n
// tiles in order), except with kResident (the n tiles fit in the ring: the
// launch checks): then they are staged once and both passes read them there.
template <int D, bool kResident>
__global__ void __maxnreg__(Bf16Cfg<D>::kMaxRegs)
heads_bwd_dq_mma_bf16(const Params p) {
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
  const int row0 = (blockIdx.x * blockDim.x + tid) / 32 * 16;
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

  const int n_tiles = (p.n_k + kN - 1) / kN;
  const int last_n = p.n_k - (n_tiles - 1) * kN;  // real keys of the last tile
  __nv_bfloat16* ring = reinterpret_cast<__nv_bfloat16*>(smem);
  auto issue = [&](int tile, int slot) {
    __nv_bfloat16* kt = ring + slot * 2 * kN * D;
    stage_async<D, kN>(kt, kbase, p.k_rs, tile * kN, p.n_k, tid, blockDim.x);
    stage_async<D, kN>(kt + kN * D, vbase, p.v_rs, tile * kN, p.n_k, tid, blockDim.x);
  };
  // virtual tile v of the 2 n in flight: tile v % n_tiles, slot v % kStages
  if (kResident) {
    for (int tile = 0; tile < n_tiles; ++tile) issue(tile, tile);
    cp_async_commit();
  } else {
#pragma unroll
    for (int v = 0; v < kStages - 1; ++v) {
      issue(v, v);
      cp_async_commit();
    }
  }
  // before the first wait: the global loads overlap the copies in flight
  uint32_t qa[D / 16][4];
  uint32_t da[D / 16][4];
  if (warp_live) {
    load_a_rows<D>(qa, qbase, p.q_rs, row0, p.n_q, g, t);
    load_a_rows<D>(da, dbase, p.do_rs, row0, p.n_q, g, t);
  }
  if (kResident) {
    cp_async_wait<0>();
    __syncthreads();
  }
  auto advance = [&](int v) {  // tile v landed, the slot of v - 1 is free
    if (kResident) return;
    cp_async_wait<kStages - 2>();
    __syncthreads();
    const int nv = v + kStages - 1;
    if (nv < 2 * n_tiles) issue(nv % n_tiles, nv % kStages);
    cp_async_commit();
  };
  auto slot_of = [&](int v) {
    return smem_u32(ring + (kResident ? v % n_tiles : v % kStages) * 2 * kN * D);
  };
  const float c2 = p.scale * kLog2e;

  // pass 1; mr is the raw row max of q.k, off = mr * scale * log2 e
  float mr[2] = {-CUDART_INF_F, -CUDART_INF_F};
  float off[2] = {-CUDART_INF_F, -CUDART_INF_F};
  float l[2] = {0.0f, 0.0f};
  float n[2] = {0.0f, 0.0f};
  for (int v = 0; v < n_tiles; ++v) {
    advance(v);
    if (!warp_live) continue;
    const uint32_t kt = slot_of(v);
    const uint32_t vt = kt + kN * D * 2;
    if (v < n_tiles - 1 || last_n == kN)
      dq_pass1_tile<D, false, 8>(qa, da, kt, vt, kN, lane, c2, p.scale, mr, off, l, n);
    else if (last_n > 16)
      dq_pass1_tile<D, true, 8>(qa, da, kt, vt, last_n, lane, c2, p.scale, mr, off, l, n);
    else
      dq_pass1_tile<D, true, 2>(qa, da, kt, vt, last_n, lane, c2, p.scale, mr, off, l, n);
  }
  float il[2];
  float dl[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    il[i] = 1.0f / quad_sum(l[i]);
    dl[i] = quad_sum(n[i]) * il[i];
  }
  if (warp_live && t == 0) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int r = row0 + g + 8 * i;
      if (r < p.n_q) {
        // the softmax max in the units of s = q.k * scale; pass 2 and the
        // dkv kernel both take their exp2 offset as m * log2 e from it
        stat_ptr(p, 0, b, h)[r] = mr[i] * p.scale;
        stat_ptr(p, 1, b, h)[r] = il[i];
        stat_ptr(p, 2, b, h)[r] = dl[i];
      }
    }
  }

  // pass 2
  float acc[D / 8][4];
#pragma unroll
  for (int nb = 0; nb < D / 8; ++nb)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[nb][c] = 0.0f;
  for (int v = n_tiles; v < 2 * n_tiles; ++v) {
    advance(v);
    if (!warp_live) continue;
    const uint32_t kt = slot_of(v);
    const uint32_t vt = kt + kN * D * 2;
    if (v < 2 * n_tiles - 1 || last_n == kN)
      dq_pass2_tile<D, false, 8>(qa, da, kt, vt, kN, lane, c2, p.scale, off, il, dl, acc);
    else if (last_n > 16)
      dq_pass2_tile<D, true, 8>(qa, da, kt, vt, last_n, lane, c2, p.scale, off, il, dl, acc);
    else
      dq_pass2_tile<D, true, 2>(qa, da, kt, vt, last_n, lane, c2, p.scale, off, il, dl, acc);
  }
  if (warp_live) {
    __nv_bfloat16* obase = static_cast<__nv_bfloat16*>(p.dq) + b * p.dq_bs + h * p.dq_hs;
    store_rows<D>(obase, p.dq_rs, row0, p.n_q, acc, g, t);
  }
}

// dkv on one query tile: S^T = K Q^T and dP^T = V dO^T come out keys x rows,
// so round(p)^T and round(ds)^T are already the A operands of dv += p^T dO
// and dk += ds^T Q. Only the 8-row groups with a real query row, and the
// 16-row k-steps that hold one, are computed; rows past the end carry zero
// statistics (p = exp2(0) * 0 = 0) and zero q / do rows.
template <int D, bool kRagged, int kJ>
__device__ __forceinline__ void dkv_tile(const uint32_t (&ka)[D / 16][4],
                                         const uint32_t (&va)[D / 16][4], uint32_t qt,
                                         uint32_t dt, const float* st_m, int nr, int lane,
                                         float c2, float scale, float (&dk)[D / 8][4],
                                         float (&dv)[D / 8][4]) {
  constexpr int kN = Bf16Cfg<D>::kN;
  const int jn = kRagged ? (nr + 7) / 8 : 8;
  const int kn = kRagged ? (nr + 15) / 16 : 4;
  const int t = lane & 3;
  float st[8][4];
  float dpt[8][4];
  mma_frags_tile_t<D, kJ>(st, ka, qt, jn, lane);
  mma_frags_tile_t<D, kJ>(dpt, va, dt, jn, lane);
#pragma unroll
  for (int j = 0; j < kJ; ++j) {
    if (j < 2 * kn) {
      const int r = j * 8 + 2 * t;  // rows r (c = 0, 2) and r + 1 (c = 1, 3)
      const float2 m = *reinterpret_cast<const float2*>(st_m + r);
      const float2 il = *reinterpret_cast<const float2*>(st_m + kN + r);
      const float2 dl = *reinterpret_cast<const float2*>(st_m + 2 * kN + r);
      const float o[2] = {m.x * kLog2e, m.y * kLog2e};
      const float ilr[2] = {il.x, il.y};
      const float dlr[2] = {dl.x, dl.y};
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int i = c & 1;
        const float pv = exp2_ftz(fmaf(st[j][c], c2, -o[i])) * ilr[i];
        st[j][c] = pv;
        dpt[j][c] = pv * (dpt[j][c] - dlr[i]) * scale;
      }
    }
  }
  mma_acc_tile<D, kJ / 2>(dv, st, dt, kn, lane);
  mma_acc_tile<D, kJ / 2>(dk, dpt, qt, kn, lane);
}

// dkv, bf16: a warp owns 16 keys and holds their K and V rows as A
// fragments; the block walks every query tile in order (Q, dO and the
// statistics dq stored, through the ring) and accumulates dk and dv in f32
// registers.
template <int D>
__global__ void __maxnreg__(Bf16Cfg<D>::kMaxRegs)
heads_bwd_dkv_mma_bf16(const Params p) {
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
  const int key0 = (blockIdx.x * blockDim.x + tid) / 32 * 16;
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
  const float* gstat = stat_ptr(p, 0, b, h);
  const long long stat_stride = static_cast<long long>(p.batch) * p.heads * p.n_q;

  const int n_tiles = (p.n_q + kN - 1) / kN;
  const int last_n = p.n_q - (n_tiles - 1) * kN;  // real query rows of the last tile
  auto stage = [&](int slot) { return smem + slot * Cfg::kDkvStageBytes; };
  auto issue = [&](int tile) {
    unsigned char* st = stage(tile % kStages);
    __nv_bfloat16* qt = reinterpret_cast<__nv_bfloat16*>(st);
    stage_async<D, kN>(qt, qbase, p.q_rs, tile * kN, p.n_q, tid, blockDim.x);
    stage_async<D, kN>(qt + kN * D, dbase, p.do_rs, tile * kN, p.n_q, tid, blockDim.x);
    // m, 1 / l, delta of the tile's rows; zeros past the end
    float* sm = reinterpret_cast<float*>(st + 2 * Cfg::kTileBytes);
    for (int i = tid; i < 3 * kN; i += blockDim.x) {
      const int which = i / kN;
      const int row = tile * kN + i % kN;
      const bool ok = row < p.n_q;
      cp_async_4(smem_u32(sm + i), gstat + which * stat_stride + (ok ? row : 0), ok ? 4 : 0);
    }
  };
#pragma unroll
  for (int v = 0; v < kStages - 1; ++v) {
    if (v < n_tiles) issue(v);
    cp_async_commit();
  }
  uint32_t ka[D / 16][4];
  uint32_t va[D / 16][4];
  if (warp_live) {
    load_a_rows<D>(ka, kbase, p.k_rs, key0, p.n_k, g, t);
    load_a_rows<D>(va, vbase, p.v_rs, key0, p.n_k, g, t);
  }
  float dk[D / 8][4];
  float dv[D / 8][4];
#pragma unroll
  for (int nb = 0; nb < D / 8; ++nb) {
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      dk[nb][c] = 0.0f;
      dv[nb][c] = 0.0f;
    }
  }
  const float c2 = p.scale * kLog2e;

  for (int tile = 0; tile < n_tiles; ++tile) {
    cp_async_wait<kStages - 2>();
    __syncthreads();  // tile landed for every thread; the slot of tile - 1 is free
    if (tile + kStages - 1 < n_tiles) issue(tile + kStages - 1);
    cp_async_commit();
    if (!warp_live) continue;
    unsigned char* st = stage(tile % kStages);
    const uint32_t qt = smem_u32(st);
    const uint32_t dt = qt + Cfg::kTileBytes;
    const float* sm = reinterpret_cast<const float*>(st + 2 * Cfg::kTileBytes);
    if (tile < n_tiles - 1 || last_n == kN)
      dkv_tile<D, false, 8>(ka, va, qt, dt, sm, kN, lane, c2, p.scale, dk, dv);
    else if (last_n > 16)
      dkv_tile<D, true, 8>(ka, va, qt, dt, sm, last_n, lane, c2, p.scale, dk, dv);
    else
      dkv_tile<D, true, 2>(ka, va, qt, dt, sm, last_n, lane, c2, p.scale, dk, dv);
  }
  if (warp_live) {
    __nv_bfloat16* okbase = static_cast<__nv_bfloat16*>(p.dk) + b * p.dk_bs + h * p.dk_hs;
    __nv_bfloat16* ovbase = static_cast<__nv_bfloat16*>(p.dv) + b * p.dv_bs + h * p.dv_hs;
    store_rows<D>(okbase, p.dk_rs, key0, p.n_k, dk, g, t);
    store_rows<D>(ovbase, p.dv_rs, key0, p.n_k, dv, g, t);
  }
}

// warps per block for `rows` query rows (dq) or keys (dkv): one block holds
// them all when they fit, so a ragged 65th row costs one more warp, not one
// more block
template <int D>
int block_warps(int rows) {
  using Cfg = Bf16Cfg<D>;
  return rows <= 16 * Cfg::kMaxWarps ? (rows + 15) / 16 : Cfg::kLongWarps;
}

template <int D, bool kResident>
int launch_dq_bf16(const Params& p, cudaStream_t st) {
  using Cfg = Bf16Cfg<D>;
  const int bytes = Cfg::kStages * Cfg::kDqStageBytes;
  static int set_for = -1;
  if (const int err = allow_smem(heads_bwd_dq_mma_bf16<D, kResident>, bytes, set_for))
    return err;
  const int warps = block_warps<D>(p.n_q);
  const dim3 grid((p.n_q + 16 * warps - 1) / (16 * warps), p.heads, p.batch);
  heads_bwd_dq_mma_bf16<D, kResident><<<grid, 32 * warps, bytes, st>>>(p);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int launch_dq(const Params& p, int dtype, cudaStream_t st) {
  if (dtype == 1) {
    // K and V of a (batch, head) fit the ring: stage them once for both passes
    using Cfg = Bf16Cfg<D>;
    return p.n_k <= Cfg::kStages * Cfg::kN ? launch_dq_bf16<D, true>(p, st)
                                           : launch_dq_bf16<D, false>(p, st);
  } else if (dtype == 0) {
    const dim3 grid((p.n_q + kFmaTile - 1) / kFmaTile, p.heads, p.batch);
    heads_bwd_dq_fma_f32<D><<<grid, kThreads, 0, st>>>(p);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int launch_dkv(const Params& p, int dtype, cudaStream_t st) {
  if (dtype == 1) {
    using Cfg = Bf16Cfg<D>;
    const int bytes = Cfg::kStages * Cfg::kDkvStageBytes;
    static int set_for = -1;
    if (const int err = allow_smem(heads_bwd_dkv_mma_bf16<D>, bytes, set_for)) return err;
    const int warps = block_warps<D>(p.n_k);
    const dim3 grid((p.n_k + 16 * warps - 1) / (16 * warps), p.heads, p.batch);
    heads_bwd_dkv_mma_bf16<D><<<grid, 32 * warps, bytes, st>>>(p);
  } else if (dtype == 0) {
    const dim3 grid((p.n_k + kFmaTile - 1) / kFmaTile, p.heads, p.batch);
    heads_bwd_dkv_fma_f32<D><<<grid, kThreads, 0, st>>>(p);
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
