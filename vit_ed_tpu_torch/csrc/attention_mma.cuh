// Device helpers shared by the attention kernels of this directory
// (pair_attention.cu, heads_attention.cu, heads_attention_bwd.cu): the bf16
// tensor-core product mma.sync.m16n8k16, bf16 packing, reductions over the
// four lanes that share a fragment row, the exp2 of the softmaxes, the
// asynchronous staging (cp.async into XOR-swizzled tiles of kTile rows) and
// the ldmatrix fragment loads that all bf16 kernels use, and the host-side
// opt-in to more than 48 KB of dynamic shared memory. The f32 kernels run in
// blocks of kThreads threads.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

constexpr int kThreads = 128;  // threads of an f32 kernel's block
constexpr int kTile = 64;      // rows of a staged bf16 tile
constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// ---------------------------------------------------------------------------
// bf16 tensor cores: mma.sync.m16n8k16, 16 rows a warp.
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

// exp2 on the special function unit alone: results below 2^-126 flush to
// zero (a probability that small is far below the tolerance of any sum here)
__device__ __forceinline__ float exp2_ftz(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// a barrier of the block's first n_threads threads (a multiple of 32): the
// warps of a block past the last row return at once and never arrive
__device__ __forceinline__ void bar_sync(int n_threads) {
  asm volatile("bar.sync 1, %0;\n" :: "r"(n_threads) : "memory");
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

// ---------------------------------------------------------------------------
// Asynchronous staging and ldmatrix fragments (every bf16 kernel).
// A staged tile is [rows][D] bf16 in shared memory, XOR-swizzled by 16-byte
// chunks: the eight rows an ldmatrix 8x8 matrix reads (eight consecutive
// rows, one chunk column) land in eight different 16-byte bank groups, with
// no padding. Tiles start at multiples of 128 bytes.
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// element offset of chunk c (8 elements) of row r in a swizzled [rows][D] tile
template <int D>
__device__ __forceinline__ int swz(int r, int c) {
  constexpr int kChunks = D / 8;
  // rows sharing one 128-byte line (4, 2, 1): the XOR key changes per line
  constexpr int kShift = kChunks >= 8 ? 0 : (kChunks == 4 ? 1 : 2);
  constexpr int kMask = (kChunks >= 8 ? 8 : kChunks) - 1;
  return r * D + ((c ^ ((r >> kShift) & kMask)) << 3);
}

// 16 (or 4) bytes global -> shared without a register round trip;
// src_bytes = 0 writes zeros (rows past the end; src must still be valid)
__device__ __forceinline__ void cp_async_16(uint32_t dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(dst), "l"(src), "r"(src_bytes) : "memory");
}

__device__ __forceinline__ void cp_async_4(uint32_t dst, const void* src, int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(dst), "l"(src), "r"(src_bytes) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most N of this thread's committed groups are in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// rows r0 .. r0 + kRows - 1 of a strided [n_total, D] bf16 matrix into a
// swizzled tile, by the block's n_threads threads; rows past the end are
// zero-filled. Unsigned on purpose: kChunks is a power of two, and only
// unsigned division by it is a plain shift; with signed arithmetic here the
// backward kernels at head_dim 64 ran measurably slower.
template <int D, int kRows>
__device__ __forceinline__ void stage_async(__nv_bfloat16* dst, const __nv_bfloat16* base,
                                            long long rs, int r0, int n_total, int tid,
                                            int n_threads) {
  constexpr unsigned kChunks = D / 8;
  for (unsigned i = tid; i < kRows * kChunks; i += n_threads) {
    const unsigned r = i / kChunks;
    const unsigned c = i % kChunks;
    const int row = r0 + static_cast<int>(r);
    const bool ok = row < n_total;
    cp_async_16(smem_u32(dst + swz<D>(r, c)), base + (ok ? row : 0) * rs + c * 8,
                ok ? 16 : 0);
  }
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(addr));
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(addr));
}

// out[j] (16 x 8) = A (16 x D, fragments in registers) * tile^T for the
// 8-row groups j < jn of a swizzled [64][D] tile at shared address `tile`:
// out[j][., n] = sum_d A[., d] * tile[8 j + n][d]. Groups jn <= j < kJ stay
// zero, groups from kJ on are not touched (jn <= kJ, kJ even).
// One ldmatrix.x4 gives the B fragments of two groups at one 16-deep k-step.
template <int D, int kJ = 8>
__device__ __forceinline__ void mma_frags_tile_t(float (&out)[8][4],
                                                 const uint32_t (&a)[D / 16][4],
                                                 uint32_t tile, int jn, int lane) {
  const int mi = lane >> 3;
  const int lr = (mi >> 1) * 8 + (lane & 7);
  const int lc = mi & 1;
#pragma unroll
  for (int j = 0; j < kJ; ++j)
#pragma unroll
    for (int c = 0; c < 4; ++c) out[j][c] = 0.0f;
#pragma unroll
  for (int jp = 0; jp < kJ / 2; ++jp) {
    if (2 * jp < jn) {
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        uint32_t b[4];
        ldsm_x4(b, tile + 2 * swz<D>(16 * jp + lr, 2 * kk + lc));
        mma_16816(out[2 * jp], a[kk], b[0], b[1]);
        if (2 * jp + 1 < jn) mma_16816(out[2 * jp + 1], a[kk], b[2], b[3]);
      }
    }
  }
}

// acc (16 x D) += A (16 x 16, bf16 fragments in registers) * rows 16 kk ..
// 16 kk + 15 of a swizzled [64][D] tile at shared address `tile`: one k-step
// of the accumulate products. ldmatrix.x4.trans gives the B fragments of two
// 8-wide n-blocks.
template <int D>
__device__ __forceinline__ void mma_acc_kstep(float (&acc)[D / 8][4], const uint32_t (&a)[4],
                                              uint32_t tile, int kk, int lane) {
  const int mi = lane >> 3;
  const int lr = (mi & 1) * 8 + (lane & 7);
  const int lc = mi >> 1;
#pragma unroll
  for (int np = 0; np < D / 16; ++np) {
    uint32_t b[4];
    ldsm_x4_t(b, tile + 2 * swz<D>(16 * kk + lr, 2 * np + lc));
    mma_16816(acc[2 * np], a, b[0], b[1]);
    mma_16816(acc[2 * np + 1], a, b[2], b[3]);
  }
}

// acc (16 x D) += round_bf16(x) (16 x 64 in the accumulator layout, re-used
// as the A operand) * tile (swizzled [64][D]) over the 16-row k-steps
// kk < kn (kn <= kK): acc[., n] += sum_r x[., r] * tile[r][n].
template <int D, int kK = 4>
__device__ __forceinline__ void mma_acc_tile(float (&acc)[D / 8][4], const float (&x)[8][4],
                                             uint32_t tile, int kn, int lane) {
#pragma unroll
  for (int kk = 0; kk < kK; ++kk) {
    if (kk < kn) {
      const uint32_t a[4] = {
          pack_f32(x[2 * kk][0], x[2 * kk][1]), pack_f32(x[2 * kk][2], x[2 * kk][3]),
          pack_f32(x[2 * kk + 1][0], x[2 * kk + 1][1]),
          pack_f32(x[2 * kk + 1][2], x[2 * kk + 1][3])};
      mma_acc_kstep<D>(acc, a, tile, kk, lane);
    }
  }
}

// dynamic shared memory above the default 48 KB must be opted into, per
// kernel and device; `set_for` remembers the device it was done for
template <typename Kernel>
int allow_smem(Kernel kernel, int bytes, int& set_for) {
  if (bytes <= 48 * 1024) return 0;
  int dev = 0;
  cudaGetDevice(&dev);
  if (set_for == dev) return 0;
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err == cudaSuccess) set_for = dev;
  return static_cast<int>(err);
}
