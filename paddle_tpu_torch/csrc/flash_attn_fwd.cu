// Flash-attention forward for Hopper on the tensor cores: O = softmax(scale
// * Q K^T [+ causal mask]) V, Q [B, H, Sq, D], K and V [B, H, Sk, D], any
// strides, f32 or bf16.
//
// Replaces the TPU kernel that paddle_tpu's fused_multihead_attention calls
// (paddle_tpu/ops/nn_ops.py:714-722): the forward of JAX 0.9.0's Pallas
// flash attention, jax/experimental/pallas/ops/tpu/flash_attention.py,
// _flash_attention_impl :589, pallas_call :758 (body
// _flash_attention_kernel_single_batch :434).
//
// Bound on an H100 SXM: 4 * B * H * Sq * Sk * D operations (two products)
// against the bytes of Q, K, V and O, each read or written once. BERT-base
// at batch 8, S = 512, D = 64: 6.44 GFLOP. bf16: 6.5 us at the 989 TFLOP/s
// tensor-core peak against 25 MB, 7.5 us at 3.35 TB/s, so bound by bytes
// (a little). f32: 50 MB, 15 us of bytes; its products run in the 3xTF32
// split, three TF32 products for each f32 one, so its operations take
// 3 * 6.44 GFLOP / 495 TFLOP/s = 39 us on the tensor cores (96 us at the
// 67 TFLOP/s of f32 on the CUDA cores): bound by operations.
//
// What the design does about that bound:
// - Both products run on the tensor cores with mma.sync (mma_frag.cuh has
//   the fragment maps and the two warp products). bf16: m16n8k16 with f32
//   accumulators. f32: m16n8k8 TF32 in the 3xTF32 split, the small terms
//   first and each step's P V in a fresh partial (mma_frag.cuh says why:
//   the tensor cores round each sum toward zero), which keeps the f32
//   tolerance of ops/flash_attention.py (1e-5 of max|v|).
// - One block of 4 warps per (b*h, 64 query rows), 16 rows a warp. The Q
//   tile is staged once in shared memory; a loop walks tiles of BK keys (the
//   TPU grid's sequential key axis becomes this loop) through a double
//   buffer filled by cp.async: tile i + 1 is in flight while tile i is
//   multiplied, with one __syncthreads a tile. Each tile is kept in its own
//   dtype, rows padded by 16 bytes (conflict-free ldmatrix and tf32 loads),
//   zero-filled past Sk and past d. Where an operand's rows are not 16-byte
//   vectors (stride along d other than 1, or misaligned), the same tiles
//   are filled by plain loads (attn_tiles.cuh). At batch 1 the grid is
//   8 x 12 = 96 blocks for 132 SMs; each block's time then sets the
//   launch's, which is still 6x (bf16) and 2x (f32) below the CUDA-core
//   kernel's, so no smaller block is launched there.
// - S = Q K^T (mma_nt) lands in the accumulator fragments; the online
//   softmax runs on them in registers, in the log2 domain (scores times
//   scale * log2 e in f32). A row's values lie on the 4 lanes of a quad, so
//   its max takes two shuffles; its sum stays per lane until the end. O is
//   rescaled by exp2(m_old - m_new) only when a row's max moves, and a row
//   with no key kept so far (m = -inf) gets p = 0 rather than a NaN.
// - P = exp2(s - m) stays in registers as the A operand of P V (mma_rt),
//   V read from shared memory as [key][d] (ldmatrix.trans in bf16). In
//   bf16, P is rounded to bf16 for that product, as the TPU kernel does
//   (p.astype(v.dtype) :471); the row sum l adds the f32 values, as there.
//   No P goes through shared memory.
// - Masks (keys at or past Sk; with causal, keys j > i + Sk - Sq) are
//   applied on the fragments only in tiles that cross Sk or the diagonal;
//   key tiles wholly past the diagonal of the block's last row are skipped.
// - Epilogue: O / l in the input dtype, through the warp's own rows of the
//   Q tile so that each row is written as 16-byte vectors where the output
//   allows (else element by element through its strides). The [Sq, Sk]
//   scores never leave the SM.
// - With a non-null lse, each query row's log-sum-exp of the scaled scores,
//   ln(sum_j exp(scale * s_ij)) = (m + log2 l) * ln 2, is written as f32
//   [B, H, Sq], contiguous: the residual the backward kernels
//   (flash_attn_bwd.cu) recompute P from, the port's form of the l and m
//   that JAX's _flash_attention_fwd saves (:246-251). Serving passes null.
// - f32 is bound by instruction issue rather than by the tensor cores:
//   every warp loads and splits each operand of each mma itself, in both
//   passes. So operands come in by ldmatrix in either dtype, the split
//   rounds with two integer operations (mma_frag.cuh), and exp2 is one
//   MUFU instruction (ex2 below).
// - BK = 64 keys a step, 32 for f32 at D = 128, where the accumulators are
//   largest. Shared memory (Q, then two K and two V tiles), D = 32 / 64 /
//   128: bf16 25 / 45 / 85 KB; f32 45 / 85 / 99 KB. Each launch raises the
//   dynamic shared-memory limit first. The launch bound lets the compiler
//   take the registers it wants (bf16 at D = 64: 157, 3 blocks an SM, ran
//   7% faster than at 101 and 4 blocks); f32 takes about 255 either way,
//   2 blocks an SM. Measured resources, times and the variants that lost:
//   PERF.md.
//
// C interface, loaded with ctypes (paddle_tpu_torch/ops/flash_attention.py).
// The launch is on the caller's stream, allocates nothing and does not
// synchronise; the return value is the first CUDA error, if any.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "attn_tiles.cuh"
#include "mma_frag.cuh"

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kRows = 16 * kWarps;  // query rows of a block
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

using ptpu::load_tile;
using ptpu::Strides;

// Keys a loop step takes: 64, halved for f32 at D = 128, where the
// accumulators and the tf32 products' partial sum are largest.
template <typename T, int D>
constexpr int kStepKeys = D <= 64 || sizeof(T) == 2 ? 64 : 32;

// K/V tiles in the ring: tile i + kStages - 1 is in flight while tile i is
// multiplied. Three ran no faster in bf16 and cost f32 a block an SM.
constexpr int kStages = 2;

template <typename T, int D>
constexpr int smem_bytes() {
  constexpr int LD = D + ptpu::kPad<T>, BK = kStepKeys<T, D>;
  // Q [kRows][LD]; K, V [kStages][BK][LD]
  return static_cast<int>(sizeof(T)) * (kRows * LD + 2 * kStages * BK * LD);
}

// 2^x by one MUFU.EX2 (relative error about 2^-22): exp2f adds a range
// fix-up so as to return denormals, and the softmax's p <= 1 loses
// nothing to flushing values below 2^-126 to zero.
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ void store_pair(float* p, float x, float y) {
  *reinterpret_cast<float2*>(p) = make_float2(x, y);
}
__device__ __forceinline__ void store_pair(__nv_bfloat16* p, float x,
                                           float y) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(x, y);
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads, 1)
    flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, T* __restrict__ o,
                     float* __restrict__ lse, Strides sq, Strides sk,
                     Strides sv, Strides so, int H, int Sq, int Sk, int d,
                     float scale_log2, int causal, int vec_in, int vec_out) {
  constexpr int LD = D + ptpu::kPad<T>, BK = kStepKeys<T, D>;
  constexpr int NK = BK / 8, ND = D / 8;
  extern __shared__ float4 smem4[];
  T* Qs = reinterpret_cast<T*>(smem4);  // [kRows][LD]
  T* Ks = Qs + kRows * LD;              // [kStages][BK][LD]
  T* Vs = Ks + kStages * BK * LD;       // [kStages][BK][LD]

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const int m0 = blockIdx.x * kRows;
  const T* qh = q + b * sq.b + h * sq.h;
  const T* kh = k + b * sk.b + h * sk.h;
  const T* vh = v + b * sv.b + h * sv.h;
  // causal: key j is kept for row i if j <= i + offset
  const int offset = Sk - Sq;

  int n_end = Sk;
  if (causal) {
    const int last = m0 + kRows - 1 + offset + 1;  // keys the last row keeps
    n_end = last < Sk ? last : Sk;
  }
  // tile i (keys i * BK ..) into ring slot i % kStages, if it exists; one
  // commit group a tile either way, so that wait<kStages - 2> means "tile i
  // has landed"
  auto load_step = [&](int i) {
    const int n0 = i * BK, slot = i % kStages;
    if (n0 < n_end) {
      load_tile<T, D, BK, kThreads>(Ks + slot * BK * LD, kh, sk, n0, Sk, d,
                                    vec_in);
      load_tile<T, D, BK, kThreads>(Vs + slot * BK * LD, vh, sv, n0, Sk, d,
                                    vec_in);
    }
    ptpu::cp_async_commit();
  };
  load_tile<T, D, kRows, kThreads>(Qs, qh, sq, m0, Sq, d, vec_in);
#pragma unroll
  for (int i = 0; i < kStages - 1; ++i) load_step(i);

  // this thread's rows: row0 (accumulator entries 0, 1) and row0 + 8 (2, 3)
  const int row0 = m0 + warp * 16 + g;
  float acc[ND][4];
#pragma unroll
  for (int j = 0; j < ND; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
  float m_run[2] = {-INFINITY, -INFINITY};  // row max, log2 domain
  float l_run[2] = {0.f, 0.f};              // this lane's part of the row sum

  T* q_warp = Qs + warp * 16 * LD;
  for (int i = 0, n0 = 0; n0 < n_end; ++i, n0 += BK) {
    // tile i has landed, and every warp is done with tile i - 1, whose
    // slot the next load refills
    ptpu::cp_async_wait<kStages - 2>();
    __syncthreads();
    load_step(i + kStages - 1);

    const T* k_t = Ks + (i % kStages) * BK * LD;
    const T* v_t = Vs + (i % kStages) * BK * LD;

    // S = Q K^T: 16 queries x BK keys a warp
    float s[NK][4];
#pragma unroll
    for (int j = 0; j < NK; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
    ptpu::mma_nt<T, D, NK>(s, q_warp, k_t, lane);

    // scale into the log2 domain, mask, and each row's max over the tile
    const bool edge = n0 + BK > Sk || (causal && n0 + BK - 1 > m0 + offset);
    float m_tile[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int j = 0; j < NK; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[j][e] * scale_log2;
        if (edge) {
          const int key = n0 + j * 8 + 2 * t + (e & 1);
          const int row = row0 + 8 * (e >> 1);
          if (!(key < Sk && (!causal || key <= row + offset))) x = -INFINITY;
        }
        s[j][e] = x;
        m_tile[e >> 1] = fmaxf(m_tile[e >> 1], x);
      }
    }
    float m_use[2];
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      float mt = m_tile[half];
      mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, 1));
      mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, 2));
      const float m_new = fmaxf(m_run[half], mt);
      // a row with no key kept so far has m_new = -inf: its p are 0
      m_use[half] = m_new == -INFINITY ? 0.f : m_new;
      if (m_new != m_run[half]) {
        const float alpha = ex2(m_run[half] - m_use[half]);
        l_run[half] *= alpha;
#pragma unroll
        for (int j = 0; j < ND; ++j) {
          acc[j][2 * half] *= alpha;
          acc[j][2 * half + 1] *= alpha;
        }
        m_run[half] = m_new;
      }
    }

    // P = exp2(s - m) as the A operand of P V
    ptpu::RegA<T, NK> p_a;
#pragma unroll
    for (int j = 0; j < NK; ++j) {
      float p[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        p[e] = ex2(s[j][e] - m_use[e >> 1]);
        l_run[e >> 1] += p[e];
      }
      ptpu::set_tile(p_a, j, p);
    }
    ptpu::mma_rt<T, NK, ND>(acc, p_a, v_t, lane);
  }
  ptpu::cp_async_wait<0>();

  // the row sums over the quad, then O / l and the log-sum-exp
  float inv[2];
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    float l = l_run[half];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    // every row below Sq keeps a key (the wrapper refuses causal Sq > Sk
    // and Sk = 0), so l > 0 there; the guard keeps other rows finite
    inv[half] = l > 0.f ? 1.f / l : 0.f;
    const int row = row0 + 8 * half;
    if (lse != nullptr && t == 0 && row < Sq) {
      lse[static_cast<long long>(bh) * Sq + row] =
          l > 0.f ? (m_run[half] + log2f(l)) * kLn2 : 0.f;
    }
  }
  T* oh = o + b * so.b + h * so.h;
  if (vec_out) {
    // the warp's 16 rows through its own rows of the Q tile, which only
    // this warp read, then out as 16-byte vectors
    __syncwarp();
#pragma unroll
    for (int j = 0; j < ND; ++j) {
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        store_pair(q_warp + (g + 8 * half) * LD + j * 8 + 2 * t,
                   acc[j][2 * half] * inv[half],
                   acc[j][2 * half + 1] * inv[half]);
      }
    }
    __syncwarp();
    constexpr int kChunk = 16 / static_cast<int>(sizeof(T));
    constexpr int kPerRow = D / kChunk;
    for (int i = lane; i < 16 * kPerRow; i += 32) {
      const int r = i / kPerRow, c = (i % kPerRow) * kChunk;
      const int row = m0 + warp * 16 + r;
      if (row < Sq && c < d) {
        *reinterpret_cast<float4*>(oh + row * so.s + c) =
            *reinterpret_cast<const float4*>(q_warp + r * LD + c);
      }
    }
  } else {
#pragma unroll
    for (int j = 0; j < ND; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[j][e] *= inv[e >> 1];
    ptpu::store_rows<T, ND>(oh, so, acc, m0 + warp * 16, Sq, d, lane);
  }
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   float* lse, const Strides* st, int B, int H, int Sq,
                   int Sk, int d, float scale, int causal,
                   cudaStream_t stream) {
  constexpr int bytes = smem_bytes<T, D>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      bytes);
  if (err != cudaSuccess) return err;
  const bool vec_in = ptpu::rows_are_vectors<T>(q, st[0], B, H, d) &&
                      ptpu::rows_are_vectors<T>(k, st[1], B, H, d) &&
                      ptpu::rows_are_vectors<T>(v, st[2], B, H, d);
  const bool vec_out = ptpu::rows_are_vectors<T>(o, st[3], B, H, d);
  const dim3 grid((Sq + kRows - 1) / kRows, B * H);
  flash_fwd_kernel<T, D><<<grid, kThreads, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), lse, st[0], st[1],
      st[2], st[3], H, Sq, Sk, d, scale * kLog2e, causal, vec_in, vec_out);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_dim(const void* q, const void* k, const void* v, void* o,
                       float* lse, const Strides* st, int B, int H, int Sq,
                       int Sk, int d, float scale, int causal,
                       cudaStream_t stream) {
  if (d <= 32) {
    return launch<T, 32>(q, k, v, o, lse, st, B, H, Sq, Sk, d, scale, causal,
                         stream);
  }
  if (d <= 64) {
    return launch<T, 64>(q, k, v, o, lse, st, B, H, Sq, Sk, d, scale, causal,
                         stream);
  }
  if (d <= 128) {
    return launch<T, 128>(q, k, v, o, lse, st, B, H, Sq, Sk, d, scale,
                          causal, stream);
  }
  return cudaErrorInvalidValue;
}

}  // namespace

// strides: 16 element strides, (b, h, s, d) of q, k, v and o in that order.
// lse: null, or f32 [B, H, Sq] contiguous for the rows' log-sum-exp.
// dtype: 0 = float32, 1 = bfloat16. Requires 1 <= d <= 128, Sk >= 1, and
// Sq <= Sk when causal (the Python wrapper checks).
extern "C" int ptpu_flash_attn_fwd(const void* q, const void* k, const void* v,
                                   void* o, float* lse,
                                   const long long* strides, int B, int H,
                                   int Sq, int Sk, int d, float scale,
                                   int causal, int dtype, int device,
                                   void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  Strides st[4];
  for (int i = 0; i < 4; ++i) {
    st[i] = Strides{strides[4 * i], strides[4 * i + 1], strides[4 * i + 2],
                    strides[4 * i + 3]};
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      err = launch_dim<float>(q, k, v, o, lse, st, B, H, Sq, Sk, d, scale,
                              causal, s);
      break;
    case 1:
      err = launch_dim<__nv_bfloat16>(q, k, v, o, lse, st, B, H, Sq, Sk, d,
                                      scale, causal, s);
      break;
    default:
      err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}
