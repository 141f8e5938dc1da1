// Tile movement shared by the port's flash-attention kernels
// (flash_attn_fwd.cu, flash_attn_bwd.cu): a [B, H, S, D] operand given by
// its element strides, rows of one head copied into padded shared-memory
// tiles (rows of D + kPad<T> elements, as mma_frag.cuh reads them) and a
// warp's accumulator rows written back. Header only; kernels.lib_path
// hashes it into every kernel's library name.
#pragma once

#include <cuda_bf16.h>

#include <cstdint>

#include "mma_frag.cuh"

namespace ptpu {

struct Strides {
  long long b, h, s, d;  // in elements
};

// Whether every row of x is a run of 16-byte vectors that cp.async (or a
// 16-byte store) can move: a 16-byte aligned base, heads and rows, unit
// stride along d, and d * sizeof(T) a multiple of 16.
template <typename T>
bool rows_are_vectors(const void* x, const Strides& s, int B, int H, int d) {
  constexpr long long kSize = sizeof(T);
  return (d * kSize) % 16 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
         s.d == 1 && (s.s * kSize) % 16 == 0 &&
         (B == 1 || (s.b * kSize) % 16 == 0) &&
         (H == 1 || (s.h * kSize) % 16 == 0);
}

// Rows [r0, r0 + ROWS) of one head of x into dst, rows of D + kPad<T>
// elements, zero past `rows` and past `d`, by the block's THREADS threads.
// vec: 16-byte cp.async (the caller commits and waits); else plain loads
// and stores.
template <typename T, int D, int ROWS, int THREADS>
__device__ __forceinline__ void load_tile(T* __restrict__ dst,
                                          const T* __restrict__ x, Strides st,
                                          int r0, int rows, int d, bool vec) {
  constexpr int LD = D + kPad<T>;
  if (vec) {
    constexpr int kChunk = 16 / static_cast<int>(sizeof(T));
    constexpr int kPerRow = D / kChunk;
    for (int i = threadIdx.x; i < ROWS * kPerRow; i += THREADS) {
      const int r = i / kPerRow, c = (i % kPerRow) * kChunk;
      const bool ok = r0 + r < rows && c < d;
      cp_async16(dst + r * LD + c, ok ? x + (r0 + r) * st.s + c : x, ok);
    }
  } else {
    for (int i = threadIdx.x; i < ROWS * D; i += THREADS) {
      const int r = i / D, c = i % D;
      T val = T(0.f);
      if (r0 + r < rows && c < d) val = x[(r0 + r) * st.s + c * st.d];
      dst[r * LD + c] = val;
    }
  }
}

__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

// A warp's accumulator, 16 rows x 8 * ND columns, into out's rows r0 ..
// r0 + 15, skipping rows past `rows` and columns past d, element by element
// through the strides.
template <typename T, int ND>
__device__ __forceinline__ void store_rows(T* __restrict__ out, Strides st,
                                           const float (&acc)[ND][4], int r0,
                                           int rows, int d, int lane) {
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int row = r0 + g + 8 * half;
    if (row >= rows) continue;
#pragma unroll
    for (int j = 0; j < ND; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = j * 8 + 2 * t + e;
        if (col < d) {
          store(out + row * st.s + col * st.d, acc[j][2 * half + e]);
        }
      }
    }
  }
}

}  // namespace ptpu
