// Device helpers shared by the attention kernels of this directory
// (pair_attention.cu, heads_attention.cu, heads_attention_bwd.cu): the bf16 tensor-core product mma.sync.m16n8k16,
// bf16 packing, reductions over the four lanes that share a fragment row,
// and the 64-row tiles the kernels stage in shared memory and multiply.
// Every kernel block has kThreads threads: 4 warps x 16 rows.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

constexpr int kThreads = 128;
constexpr int kTile = 64;  // rows of a staged tile, and rows per block

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// ---------------------------------------------------------------------------
// bf16 tensor cores: mma.sync.m16n8k16, 4 warps x 16 rows.
// Fragment layouts (PTX ISA, m16n8k16 .bf16): g = lane / 4, t = lane % 4;
//   A (16x16, row): a0 (g, 2t..2t+1) a1 (g+8, 2t..) a2 (g, 2t+8..) a3 (g+8, 2t+8..)
//   B (16x8, col):  b0 (k 2t..2t+1, n g)  b1 (k 2t+8..2t+9, n g)
//   C (16x8, f32):  c0 c1 (g, 2t..2t+1)   c2 c3 (g+8, 2t..2t+1)
// ---------------------------------------------------------------------------

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

// rows r0.. of a strided [n_total, D] bf16 matrix into a [64][D + 8] tile
// (the pitch keeps the B-fragment loads free of bank conflicts), 16-byte
// chunks; rows past the end are zeros
template <int D>
__device__ __forceinline__ void stage_bf16(__nv_bfloat16* dst, const __nv_bfloat16* base,
                                           long long rs, int r0, int n_total, int tid) {
  // unsigned on purpose: kChunks is a power of two, and only unsigned
  // division by it is a plain shift; with signed arithmetic here the
  // backward kernels at head_dim 64 ran measurably slower
  constexpr int kChunks = D / 8;
  for (int i = tid; i < kTile * kChunks; i += kThreads) {
    const int r = static_cast<unsigned>(i) / kChunks;
    const int c8 = (static_cast<unsigned>(i) % kChunks) * 8;
    const int row = r0 + r;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (row < n_total) val = *reinterpret_cast<const uint4*>(base + row * rs + c8);
    *reinterpret_cast<uint4*>(&dst[r * (D + 8) + c8]) = val;
  }
}

// 16 rows (row0 + g, row0 + g + 8) x D dims of a strided bf16 matrix as the
// A fragments of D / 16 k-steps; rows past the end are zeros
template <int D>
__device__ __forceinline__ void load_a_rows(uint32_t (&a)[D / 16][4],
                                            const __nv_bfloat16* base, long long rs,
                                            int row0, int n_total, int g, int t) {
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = row0 + g + 8 * (i & 1);
      const int col = kk * 16 + 2 * t + 8 * (i >> 1);
      a[kk][i] = row < n_total
          ? *reinterpret_cast<const uint32_t*>(base + row * rs + col) : 0u;
    }
  }
}

// out[j] (16 x 8 per j, 8 tiles) = A (16 x D, fragments) * tile^T, where the
// tile holds 64 rows x D dims: out[., n] = sum_d A[., d] * tile[n][d]
template <int D>
__device__ __forceinline__ void mma_a_tile_t(float (&out)[8][4],
                                             const uint32_t (&a)[D / 16][4],
                                             const __nv_bfloat16* tile, int g, int t) {
#pragma unroll
  for (int j = 0; j < 8; ++j) {
#pragma unroll
    for (int c = 0; c < 4; ++c) out[j][c] = 0.0f;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const __nv_bfloat16* bp = &tile[(j * 8 + g) * (D + 8) + kk * 16 + 2 * t];
      mma_16816(out[j], a[kk], *reinterpret_cast<const uint32_t*>(bp),
                *reinterpret_cast<const uint32_t*>(bp + 8));
    }
  }
}

// acc (16 x D) += round_bf16(x) (16 x 64 in the accumulator layout, re-used
// as the A operand) * tile (64 rows x D dims): acc[., n] += sum_r x[., r] * tile[r][n]
template <int D>
__device__ __forceinline__ void mma_acc_tile(float (&acc)[D / 8][4], const float (&x)[8][4],
                                             const __nv_bfloat16* tile, int g, int t) {
  constexpr int kLd = D + 8;
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    const uint32_t a[4] = {
        pack_f32(x[2 * kk][0], x[2 * kk][1]), pack_f32(x[2 * kk][2], x[2 * kk][3]),
        pack_f32(x[2 * kk + 1][0], x[2 * kk + 1][1]),
        pack_f32(x[2 * kk + 1][2], x[2 * kk + 1][3])};
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      const __nv_bfloat16* bp = &tile[(kk * 16 + 2 * t) * kLd + n * 8 + g];
      mma_16816(acc[n], a, pack_bf16(bp[0], bp[kLd]),
                pack_bf16(bp[8 * kLd], bp[9 * kLd]));
    }
  }
}

// 16 rows x D dims of f32 accumulators -> bf16, rows past the end skipped
template <int D>
__device__ __forceinline__ void store_rows(__nv_bfloat16* base, long long rs, int row0,
                                           int n_total, const float (&acc)[D / 8][4],
                                           int g, int t) {
  const int ra = row0 + g;
  const int rb = row0 + g + 8;
#pragma unroll
  for (int n = 0; n < D / 8; ++n) {
    const int col = n * 8 + 2 * t;
    if (ra < n_total)
      *reinterpret_cast<uint32_t*>(base + ra * rs + col) = pack_f32(acc[n][0], acc[n][1]);
    if (rb < n_total)
      *reinterpret_cast<uint32_t*>(base + rb * rs + col) = pack_f32(acc[n][2], acc[n][3]);
  }
}
