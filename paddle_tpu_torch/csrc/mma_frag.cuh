// Tensor-core building blocks for the port's sm_90a kernels: warp-level
// mma.sync products with their fragment index maps, ldmatrix, cp.async and
// the 3xTF32 split. Header only; kernels.lib_path hashes it into every
// kernel's library name, so an edit here rebuilds each kernel.
//
// Fragment maps (PTX ISA, "Matrix fragments for mma.m16n8k16" and
// ".m16n8k8"), with g = lane / 4 and t = lane % 4:
// - accumulator of m16n8 (both shapes), f32: c0 (g, 2t), c1 (g, 2t + 1),
//   c2 (g + 8, 2t), c3 (g + 8, 2t + 1) as (row, column);
// - m16n8k16 bf16: A (16 x 16, row) a0 (g, 2t..2t+1), a1 (g + 8, 2t..),
//   a2 (g, 2t+8..), a3 (g + 8, 2t+8..), two values a register, the lower
//   column in the low half; B (16 x 8, col) b0 (k 2t..2t+1, n g),
//   b1 (k 2t+8..2t+9, n g);
// - m16n8k8 tf32: A (16 x 8) a0 (g, t), a1 (g + 8, t), a2 (g, t + 4),
//   a3 (g + 8, t + 4); B (8 x 8) b0 (k t, n g), b1 (k t + 4, n g).
//
// Two warp-level products cover what a flash-attention kernel multiplies:
// - mma_nt: acc[16 x 8*NT] += A[16 x KD] * B[8*NT x KD]^T, both operands in
//   shared memory, row-major, contiguous along the reduced dimension (S = Q
//   K^T, dP = dO V^T and their transposes), acc zero on entry for the
//   accuracy below;
// - mma_rt: acc[16 x 8*ND] += P[16 x 8*NK] * X[8*NK x 8*ND], P the
//   accumulator tiles of an mma_nt, re-used in registers as the A operand
//   (FlashAttention-2's accumulator-to-operand reuse), X in shared memory,
//   row-major [k][n] (dV += P^T dO, dK += dS^T Q, dQ += dS K).
// Tiles in shared memory have rows of D + kPad<T> elements: 16 bytes of
// padding make ldmatrix (either dtype; 8 rows of 16 bytes a phase) and
// mma_rt's tf32 fragment loads (f32; rows a multiple of 32 banks plus 4
// apart) free of bank conflicts.
//
// bf16 operands run m16n8k16 with f32 accumulators; the accumulator is
// rounded to bf16 (round to nearest even) when it becomes an A operand
// (set_tile).
// f32 operands run m16n8k8 TF32 in the 3xTF32 split: x = hi + lo with
// hi = tf32(x) and lo = tf32(x - hi), both rounded to nearest, ties away
// (tf32_rna), and a*b ~ a_lo*b_hi + a_hi*b_lo + a_hi*b_hi, accumulated in
// f32. hi carries 11 significant bits and lo the next 11, so each operand
// keeps ~22 of f32's 24 bits and the dropped a_lo*b_lo term is ~2^-22 of
// the product: about f32 accuracy from TF32 tensor cores.
// Accumulation: a tensor-core mma rounds its f32 sum toward zero, so each
// mma into an accumulator costs up to one ulp of it, always the same way.
// Taken in the plain order (three mma per k into one accumulator) over a
// long reduction, that bias reaches ~1e-5 of the result (a dK of 512
// queries: 192 mma). So the tf32 products add the small terms of every k
// first, while the accumulator is still small, then the big ones, and
// mma_rt sums each call into a fresh partial that is added to acc in f32:
// 8 mma at full size per 64 of k instead of 24 per 8. In mma_rt the
// TF32 reduction index is permuted within each group of 8 (physical t ->
// logical 2t, t + 4 -> 2t + 1) so that the A operand is the accumulator's
// own registers, with no shuffle; B is loaded with the same permutation.
#pragma once

#include <cuda_bf16.h>
#include <cstdint>
#include <type_traits>

namespace ptpu {

template <typename T>
constexpr int kPad = 16 / static_cast<int>(sizeof(T));

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, asynchronous; zero-filled (nothing read) when
// !valid.
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

// 4 bytes global -> shared, asynchronous; zero-filled when !valid.
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(valid ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most N of this thread's committed groups are in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// x rounded to tf32 (10 explicit mantissa bits), to nearest, ties away
// from zero: half of the 13 dropped bits added to the magnitude, then
// cleared. This is cvt.rna.tf32.f32 for every finite x and for infinities
// (a carry into the exponent rounds up to the next power of two or to
// infinity) in two integer operations; sm_90 has no single instruction
// for the cvt, which also screens NaN. A NaN may come out as an infinity
// here, but its split's lo part, x - hi, is NaN, so NaN still reaches
// the product.
__device__ __forceinline__ uint32_t tf32_rna(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

__device__ __forceinline__ void split_tf32(float x, uint32_t& hi,
                                           uint32_t& lo) {
  hi = tf32_rna(x);
  lo = tf32_rna(x - __uint_as_float(hi));
}

// One pass of d += a * b in the 3xTF32 split: pass 0 adds the small terms
// a_lo * b_hi + a_hi * b_lo, pass 1 the big one a_hi * b_hi. b0, b1 are
// the B fragment's f32 values, split here.
__device__ __forceinline__ void mma_tf32x3_pass(float (&d)[4],
                                                const uint32_t (&a_hi)[4],
                                                const uint32_t (&a_lo)[4],
                                                float b0, float b1, int pass) {
  uint32_t b0_hi, b0_lo, b1_hi, b1_lo;
  split_tf32(b0, b0_hi, b0_lo);
  split_tf32(b1, b1_hi, b1_lo);
  if (pass == 0) {
    mma_tf32(d, a_lo, b0_hi, b1_hi);
    mma_tf32(d, a_hi, b0_lo, b1_lo);
  } else {
    mma_tf32(d, a_hi, b0_hi, b1_hi);
  }
}

__device__ __forceinline__ void split4(const float (&x)[4], uint32_t (&hi)[4],
                                       uint32_t (&lo)[4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) split_tf32(x[i], hi[i], lo[i]);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// mma_rt's A operand, NK accumulator tiles kept in registers: bf16 as
// packed pairs (rounded once, half the registers), f32 as they are (split
// where they are used).
template <typename T, int NK>
struct RegA {
  uint32_t v[NK][2];
};
template <int NK>
struct RegA<float, NK> {
  float v[NK][4];
};

// Tile j of a from one accumulator tile x (c0..c3).
template <typename T, int NK>
__device__ __forceinline__ void set_tile(RegA<T, NK>& a, int j,
                                         const float (&x)[4]) {
  if constexpr (std::is_same_v<T, float>) {
#pragma unroll
    for (int e = 0; e < 4; ++e) a.v[j][e] = x[e];
  } else {
    a.v[j][0] = pack_bf16(x[0], x[1]);
    a.v[j][1] = pack_bf16(x[2], x[3]);
  }
}

// acc[j] (rows 16 x columns 8j..8j+7) += A[16 x KD] * B[8*NT x KD]^T. A and
// B point at the warp's first row of each operand in shared memory, rows
// of KD + kPad<T> elements.
template <typename T, int KD, int NT>
__device__ __forceinline__ void mma_nt(float (&acc)[NT][4],
                                       const T* __restrict__ A,
                                       const T* __restrict__ B, int lane) {
  static_assert(NT % 2 == 0, "B tiles are loaded two at a time");
  constexpr int LD = KD + kPad<T>;
  // ldmatrix.x4 row addresses: lane l reads row l % 8 of matrix l / 8, a
  // row of 16 bytes: 8 bf16 or 4 f32 (kChunk). A: matrices (rows 0-7 |
  // 8-15) x (the first | second kChunk of k) give a0..a3. B: n rows 0-7
  // at both chunks of k (b0, b1 of tile 2jp), then n rows 8-15 (tile
  // 2jp + 1). With 32-bit elements a lane receives element (g, t) of each
  // 8 x 4 matrix, which is the tf32 fragment map, so f32 loads as bf16
  // does.
  constexpr int kChunk = 16 / static_cast<int>(sizeof(T));
  const T* a_ptr = A + (lane & 15) * LD + (lane >> 4) * kChunk;
  const T* b_ptr = B + ((lane & 7) + (lane >> 4) * 8) * LD +
                   ((lane >> 3) & 1) * kChunk;
  if constexpr (std::is_same_v<T, float>) {
    // 3xTF32, the small terms of every k first, then the big ones (see
    // the note on accumulation above)
#pragma unroll
    for (int pass = 0; pass < 2; ++pass) {
#pragma unroll
      for (int kk = 0; kk < KD / 8; ++kk) {
        uint32_t ar[4];
        ldmatrix_x4(ar, a_ptr + kk * 8);
        const float a[4] = {__uint_as_float(ar[0]), __uint_as_float(ar[1]),
                            __uint_as_float(ar[2]), __uint_as_float(ar[3])};
        uint32_t a_hi[4], a_lo[4];
        split4(a, a_hi, a_lo);
#pragma unroll
        for (int jp = 0; jp < NT / 2; ++jp) {
          uint32_t b[4];
          ldmatrix_x4(b, b_ptr + jp * 16 * LD + kk * 8);
          mma_tf32x3_pass(acc[2 * jp], a_hi, a_lo, __uint_as_float(b[0]),
                          __uint_as_float(b[1]), pass);
          mma_tf32x3_pass(acc[2 * jp + 1], a_hi, a_lo, __uint_as_float(b[2]),
                          __uint_as_float(b[3]), pass);
        }
      }
    }
  } else {
#pragma unroll
    for (int kk = 0; kk < KD / 16; ++kk) {
      uint32_t a[4];
      ldmatrix_x4(a, a_ptr + kk * 16);
#pragma unroll
      for (int jp = 0; jp < NT / 2; ++jp) {
        uint32_t b[4];
        ldmatrix_x4(b, b_ptr + jp * 16 * LD + kk * 16);
        mma_bf16(acc[2 * jp], a, b[0], b[1]);
        mma_bf16(acc[2 * jp + 1], a, b[2], b[3]);
      }
    }
  }
}

// acc[j] (rows 16 x columns 8j..8j+7) += P[16 x 8*NK] * X[8*NK x 8*ND]. P
// is NK accumulator tiles in registers (set_tile); X points at row 0 of a
// row-major [k][n] tile in shared memory, rows of 8*ND + kPad<T> elements.
template <typename T, int NK, int ND>
__device__ __forceinline__ void mma_rt(float (&acc)[ND][4],
                                       const RegA<T, NK>& P,
                                       const T* __restrict__ X, int lane) {
  constexpr int LD = ND * 8 + kPad<T>;
  if constexpr (std::is_same_v<T, float>) {
    // 3xTF32 into a fresh partial sum, small terms first, added to acc once
    // (see the note on accumulation above); columns in chunks of JC tiles
    // bound the partial's registers
    constexpr int JC = ND < 8 ? ND : 4;
    const int g = lane >> 2, t = lane & 3;
#pragma unroll
    for (int c = 0; c < ND; c += JC) {
      float part[JC][4] = {};
#pragma unroll
      for (int pass = 0; pass < 2; ++pass) {
#pragma unroll
        for (int kk = 0; kk < NK; ++kk) {
          // physical k t holds logical k 2t (c0, c2), t + 4 logical 2t + 1
          const float a[4] = {P.v[kk][0], P.v[kk][2], P.v[kk][1],
                              P.v[kk][3]};
          uint32_t a_hi[4], a_lo[4];
          split4(a, a_hi, a_lo);
          const float* x_row = X + (kk * 8 + 2 * t) * LD + c * 8 + g;
#pragma unroll
          for (int j = 0; j < JC; ++j) {
            mma_tf32x3_pass(part[j], a_hi, a_lo, x_row[j * 8],
                            x_row[LD + j * 8], pass);
          }
        }
      }
#pragma unroll
      for (int j = 0; j < JC; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[c + j][e] += part[j][e];
    }
  } else {
    static_assert(NK % 2 == 0 && ND % 2 == 0,
                  "bf16 tiles pair up along k and n");
    // ldmatrix.x4.trans: matrices (k 0-7 | 8-15) x (n 0-7 | 8-15) give b0,
    // b1 of tile 2jd, then b0, b1 of tile 2jd + 1.
    const T* x_ptr = X + (lane & 15) * LD + (lane >> 4) * 8;
#pragma unroll
    for (int kk = 0; kk < NK / 2; ++kk) {
      const uint32_t a[4] = {P.v[2 * kk][0], P.v[2 * kk][1],
                             P.v[2 * kk + 1][0], P.v[2 * kk + 1][1]};
#pragma unroll
      for (int jd = 0; jd < ND / 2; ++jd) {
        uint32_t b[4];
        ldmatrix_x4_trans(b, x_ptr + kk * 16 * LD + jd * 16);
        mma_bf16(acc[2 * jd], a, b[0], b[1]);
        mma_bf16(acc[2 * jd + 1], a, b[2], b[3]);
      }
    }
  }
}

}  // namespace ptpu
