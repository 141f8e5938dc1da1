// Flash-attention backward for Hopper on the tensor cores: dQ, dK and dV of
// O = softmax(scale * Q K^T [+ causal mask]) V, from Q, K, V, dO, the
// forward's per-row log-sum-exp `lse` and di = rowsum(dO * O), both f32
// [B, H, Sq]. Q and dO are [B, H, Sq, D], K and V [B, H, Sk, D], any strides.
//
// Replaces the two TPU kernels of JAX 0.9.0's Pallas flash attention
// backward (jax/experimental/pallas/ops/tpu/flash_attention.py), which
// paddle_tpu's fused_multihead_attention reaches when it is differentiated
// on a TPU (paddle_tpu/ops/nn_ops.py:714-722):
// - _flash_attention_bwd_dkv :941 (pallas_call :1121, body
//   _flash_attention_dkv_kernel :796) by flash_bwd_dkv_kernel below;
// - _flash_attention_bwd_dq :1287 (pallas_call :1456, body
//   _flash_attention_dq_kernel :1146) by flash_bwd_dq_kernel.
//
// Both recompute P from the saved log-sum-exp instead of storing it:
//   P  = exp2(s * scale * log2(e) - lse * log2(e)),   s = q . k
//   dS = scale * P o (dO V^T - di)
//   dV = sum_q P^T dO,   dK = sum_q dS^T Q,   dQ = sum_k dS K
// with the port's forward semantics: the scale multiplies the f32 scores,
// and with causal key j is kept for query i when j <= i + Sk - Sq (the TPU
// kernels' col <= row is the same mask when Sq = Sk, the only case the JAX
// op sends them). As on the TPU, P and dS (scale included) are rounded to
// the input dtype before the second products (p.T.astype :900, ds.T.astype
// :918, ds.astype :1258): in bf16 a real rounding, in f32 none.
//
// Bound on an H100 SXM: four [Sq, Sk, D] products in dkv (S, dP, dV, dK)
// and three in dq (S, dP, dQ), 8 * B * H * Sq * Sk * D and
// 6 * B * H * Sq * Sk * D operations. BERT-base at batch 8, S = 512,
// D = 64: 12.9 and 9.7 GFLOP against 76 and 63 MB (f32) read or written
// once. bf16: 13.0 and 9.8 us at the 989 TFLOP/s tensor-core peak, against
// 11 and 9 us for the halved bytes at 3.35 TB/s, so bound by operations.
// f32: 192 and 144 us at the 67 TFLOP/s f32 peak of the CUDA cores (23 and
// 19 us of bytes).
//
// What the design does about that bound:
// - Every product runs on the tensor cores with mma.sync (mma_frag.cuh has
//   the fragment maps). bf16: m16n8k16, bf16 operands, f32 accumulators.
//   f32: m16n8k8 TF32 in the 3xTF32 split (a*b ~ a_lo*b_hi + a_hi*b_lo +
//   a_hi*b_hi): plain TF32 keeps 11 significant bits, which would make an
//   f32 gradient a TF32 one; the split keeps ~22, within the f32
//   tolerance (ops/flash_attention.py grad_tolerance, 1e-5 of the largest
//   value), at up to a third of the 495 TFLOP/s TF32 rate, above the
//   67 TFLOP/s of f32 on the CUDA cores. So f32 still means f32. The
//   tensor cores round each mma's sum toward zero; the tf32 products order
//   their accumulation so that this bias stays near 1e-6 (mma_frag.cuh).
// - Two kernels, as on the TPU, neither with atomics, so both are
//   deterministic. Blocks of 4 warps; each warp owns 16 rows of the block's
//   64 (keys in dkv, queries in dq) and keeps its accumulators in registers.
//   dkv: one block per (b*h, 64 keys), K and V staged once, a loop over
//   query tiles of BQ rows (the TPU grid's sequential q_seq_index axis,
//   :822-826 and :930-934, becomes this loop): S^T = K Q^T and dP^T = V dO^T
//   (mma_nt), P^T and dS^T on the accumulator fragments, then dV += P^T dO
//   and dK += dS^T Q (mma_rt) with P^T and dS^T re-used in registers as the
//   A operand (in bf16 packed to bf16 pairs at once, which frees the
//   registers for a third block an SM). dq: one block per (b*h, 64 queries), Q and dO staged once, a
//   loop over key tiles of BK: S = Q K^T, dP = dO V^T, dQ += dS K.
// - Each operand is staged once, in its own dtype. Q and dO (dkv) and K (dq)
//   serve as B both of a product that reduces over d (ldmatrix) and of one
//   that reduces over rows (ldmatrix.trans in bf16, the transposed fragment
//   indexing of the TF32 path in f32). Rows are padded by 16 bytes, which
//   makes both reads free of bank conflicts.
// - The streamed tiles (Q, dO, lse and di in dkv; K and V in dq) go through
//   a double buffer filled by cp.async: tile t + 1 is in flight while tile t
//   is multiplied. Rows past S and columns past d are zero-filled by the
//   copy (src-size 0). Where an operand's rows are not 16-byte vectors
//   (stride along d other than 1, or misaligned), the same tiles are
//   filled by plain loads instead.
// - A step takes BQ (dkv) or BK (dq) = 64 rows at D <= 64 and 32 at
//   D = 128, where the dK and dV (or dQ) accumulators of 16 rows x 128
//   columns take 128 (64) registers a thread; half that in f32, whose
//   products also hold a partial sum. Masked entries (keys at or past Sk,
//   queries at or past Sq, and with causal keys j > i + Sk - Sq) get P = 0,
//   tested only in tiles that cross an edge or the diagonal; with causal,
//   dkv starts at the first query tile that sees its keys and dq stops
//   after the last key tile its rows see.
// - dQ, dK and dV are written once, in the input's dtype, through the
//   strides the wrapper passes (it allocates [B, S, H, D] memory).
// Resources (nvcc 12.9 -Xptxas -v, sm_90a), D = 32 / 64 / 128:
//   dkv bf16: 166 / 166 / 246 registers, 31 / 55 / 68.5 KB shared memory;
//   dkv f32:  166 / 254 / 255 registers, 36.5 / 68.5 / 99.2 KB (D = 128
//             spills 540 bytes);
//   dq bf16:  128 / 128 / 127 registers, 30 / 54 / 68 KB;
//   dq f32:   126 / 255 / 254 registers, 36 / 68 / 99 KB.
// At D = 64 that is 3 blocks (12 warps) an SM for bf16 dkv, 4 for bf16 dq
// and 2 for f32. Each launch raises the dynamic shared-memory limit first.
//
// C interface, loaded with ctypes (paddle_tpu_torch/ops/flash_attention.py).
// Each launch is on the caller's stream, allocates nothing and does not
// synchronise; the return value is the first CUDA error, if any.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "attn_tiles.cuh"
#include "mma_frag.cuh"

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kRows = 16 * kWarps;  // keys of a dkv block, queries of a dq one
constexpr float kLog2e = 1.4426950408889634f;

using ptpu::load_tile;
using ptpu::store_rows;
using ptpu::Strides;

// Query (dkv) or key (dq) rows a loop step takes: 64, halved at D = 128,
// where the accumulators are largest, and halved again for f32, whose tf32
// products also hold a partial sum (mma_frag.cuh).
template <typename T, int D>
constexpr int kStepRows = (D <= 64 ? 64 : 32) / (sizeof(T) == 4 ? 2 : 1);

// ROWS f32 values x[r0..] into dst, zero past `rows`, by 4-byte cp.async.
template <int ROWS>
__device__ __forceinline__ void load_rows(float* __restrict__ dst,
                                          const float* __restrict__ x, int r0,
                                          int rows) {
  for (int i = threadIdx.x; i < ROWS; i += kThreads) {
    const bool ok = r0 + i < rows;
    ptpu::cp_async4(dst + i, ok ? x + r0 + i : x, ok);
  }
}

template <typename T, int D>
constexpr int dkv_smem_bytes() {
  constexpr int LD = D + ptpu::kPad<T>, BQ = kStepRows<T, D>;
  // K, V [kRows][LD]; Q, dO [2][BQ][LD]; lse, di [2][BQ]
  return static_cast<int>(sizeof(T)) * (2 * kRows * LD + 4 * BQ * LD) +
         4 * 4 * BQ;
}

template <typename T, int D>
constexpr int dq_smem_bytes() {
  constexpr int LD = D + ptpu::kPad<T>, BK = kStepRows<T, D>;
  // Q, dO [kRows][LD]; K, V [2][BK][LD]
  return static_cast<int>(sizeof(T)) * (2 * kRows * LD + 4 * BK * LD);
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                         const T* __restrict__ v, const T* __restrict__ dout,
                         const float* __restrict__ lse,
                         const float* __restrict__ di, T* __restrict__ dk,
                         T* __restrict__ dv, Strides sq, Strides sk,
                         Strides sv, Strides sdo, Strides sdk, Strides sdv,
                         int H, int Sq, int Sk, int d, float scale,
                         float scale_log2, int causal, int vec) {
  constexpr int LD = D + ptpu::kPad<T>, BQ = kStepRows<T, D>;
  constexpr int NQ = BQ / 8, ND = D / 8;
  extern __shared__ float4 smem4[];
  T* Ks = reinterpret_cast<T*>(smem4);  // [kRows][LD]
  T* Vs = Ks + kRows * LD;              // [kRows][LD]
  T* Qs = Vs + kRows * LD;              // [2][BQ][LD]
  T* dOs = Qs + 2 * BQ * LD;            // [2][BQ][LD]
  float* lse_s = reinterpret_cast<float*>(dOs + 2 * BQ * LD);  // [2][BQ]
  float* di_s = lse_s + 2 * BQ;                                // [2][BQ]

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const int n0 = blockIdx.x * kRows;
  const T* qh = q + b * sq.b + h * sq.h;
  const T* kh = k + b * sk.b + h * sk.h;
  const T* vh = v + b * sv.b + h * sv.h;
  const T* doh = dout + b * sdo.b + h * sdo.h;
  const float* lse_h = lse + static_cast<long long>(bh) * Sq;
  const float* di_h = di + static_cast<long long>(bh) * Sq;
  const int offset = Sk - Sq;  // causal: key j is kept for row i if j <= i + offset

  int m_begin = 0;
  if (causal) {  // the first query that keeps key n0 is n0 - offset
    const int first = n0 - offset > 0 ? n0 - offset : 0;
    m_begin = first / BQ * BQ;
  }
  auto load_step = [&](int m0, int buf) {
    load_tile<T, D, BQ, kThreads>(
        Qs + buf * BQ * LD, qh, sq, m0, Sq, d, vec);
    load_tile<T, D, BQ, kThreads>(
        dOs + buf * BQ * LD, doh, sdo, m0, Sq, d, vec);
    load_rows<BQ>(lse_s + buf * BQ, lse_h, m0, Sq);
    load_rows<BQ>(di_s + buf * BQ, di_h, m0, Sq);
  };
  load_tile<T, D, kRows, kThreads>(Ks, kh, sk, n0, Sk, d, vec);
  load_tile<T, D, kRows, kThreads>(Vs, vh, sv, n0, Sk, d, vec);
  if (m_begin < Sq) load_step(m_begin, 0);
  ptpu::cp_async_commit();

  float dk_acc[ND][4], dv_acc[ND][4];
#pragma unroll
  for (int j = 0; j < ND; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk_acc[j][e] = dv_acc[j][e] = 0.f;

  const T* k_warp = Ks + warp * 16 * LD;
  const T* v_warp = Vs + warp * 16 * LD;
  const int key0 = n0 + warp * 16 + g;  // this thread's keys: key0, key0 + 8
  int buf = 0;
  for (int m0 = m_begin; m0 < Sq; m0 += BQ, buf ^= 1) {
    if (m0 + BQ < Sq) load_step(m0 + BQ, buf ^ 1);
    ptpu::cp_async_commit();
    ptpu::cp_async_wait<1>();  // all but the tile just requested
    __syncthreads();

    const T* q_t = Qs + buf * BQ * LD;
    const T* do_t = dOs + buf * BQ * LD;
    const float* lse_t = lse_s + buf * BQ;
    const float* di_t = di_s + buf * BQ;

    // S^T = K Q^T and dP^T = V dO^T: keys x queries
    float s[NQ][4], dp[NQ][4];
#pragma unroll
    for (int j = 0; j < NQ; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
    ptpu::mma_nt<T, D, NQ>(s, k_warp, q_t, lane);
    ptpu::mma_nt<T, D, NQ>(dp, v_warp, do_t, lane);

    // P^T and dS^T (scale included) on the fragments, as A operands
    const bool edge = m0 + BQ > Sq || n0 + kRows > Sk ||
                      (causal && n0 + kRows - 1 > m0 + offset);
    ptpu::RegA<T, NQ> p_a, ds_a;
#pragma unroll
    for (int j = 0; j < NQ; ++j) {
      float p[4], ds[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int ql = j * 8 + 2 * t + (e & 1);
        p[e] = exp2f(s[j][e] * scale_log2 - lse_t[ql] * kLog2e);
        if (edge) {
          const int key = key0 + (e >> 1) * 8, row = m0 + ql;
          if (!(key < Sk && row < Sq && (!causal || key <= row + offset))) {
            p[e] = 0.f;
          }
        }
        ds[e] = p[e] * (dp[j][e] - di_t[ql]) * scale;
      }
      ptpu::set_tile(p_a, j, p);
      ptpu::set_tile(ds_a, j, ds);
    }

    // dV += P^T dO and dK += dS^T Q over the step's queries
    ptpu::mma_rt<T, NQ, ND>(dv_acc, p_a, do_t, lane);
    ptpu::mma_rt<T, NQ, ND>(dk_acc, ds_a, q_t, lane);
    __syncthreads();  // this buffer is refilled two steps on
  }
  ptpu::cp_async_wait<0>();

  store_rows<T, ND>(dk + b * sdk.b + h * sdk.h, sdk, dk_acc, n0 + warp * 16,
                    Sk, d, lane);
  store_rows<T, ND>(dv + b * sdv.b + h * sdv.h, sdv, dv_acc, n0 + warp * 16,
                    Sk, d, lane);
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v, const T* __restrict__ dout,
                        const float* __restrict__ lse,
                        const float* __restrict__ di, T* __restrict__ dq,
                        Strides sq, Strides sk, Strides sv, Strides sdo,
                        Strides sdq, int H, int Sq, int Sk, int d,
                        float scale, float scale_log2, int causal, int vec) {
  constexpr int LD = D + ptpu::kPad<T>, BK = kStepRows<T, D>;
  constexpr int NK = BK / 8, ND = D / 8;
  extern __shared__ float4 smem4[];
  T* Qs = reinterpret_cast<T*>(smem4);  // [kRows][LD]
  T* dOs = Qs + kRows * LD;             // [kRows][LD]
  T* Ks = dOs + kRows * LD;             // [2][BK][LD]
  T* Vs = Ks + 2 * BK * LD;             // [2][BK][LD]

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const int m0 = blockIdx.x * kRows;
  const T* qh = q + b * sq.b + h * sq.h;
  const T* kh = k + b * sk.b + h * sk.h;
  const T* vh = v + b * sv.b + h * sv.h;
  const T* doh = dout + b * sdo.b + h * sdo.h;
  const int offset = Sk - Sq;  // causal: key j is kept for row i if j <= i + offset

  int n_end = Sk;
  if (causal) {
    const int last = m0 + kRows - 1 + offset + 1;  // keys the last row keeps
    n_end = last < Sk ? last : Sk;
  }
  auto load_step = [&](int n0, int buf) {
    load_tile<T, D, BK, kThreads>(Ks + buf * BK * LD, kh, sk, n0, Sk, d, vec);
    load_tile<T, D, BK, kThreads>(Vs + buf * BK * LD, vh, sv, n0, Sk, d, vec);
  };
  load_tile<T, D, kRows, kThreads>(Qs, qh, sq, m0, Sq, d, vec);
  load_tile<T, D, kRows, kThreads>(dOs, doh, sdo, m0, Sq, d, vec);
  load_step(0, 0);
  ptpu::cp_async_commit();

  // this thread's rows: row0 and row0 + 8
  const int row0 = m0 + warp * 16 + g;
  float lse_r[2], di_r[2];
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int row = row0 + 8 * half;
    const long long at = static_cast<long long>(bh) * Sq + row;
    lse_r[half] = row < Sq ? lse[at] * kLog2e : 0.f;
    di_r[half] = row < Sq ? di[at] : 0.f;
  }
  float acc[ND][4];
#pragma unroll
  for (int j = 0; j < ND; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;

  const T* q_warp = Qs + warp * 16 * LD;
  const T* do_warp = dOs + warp * 16 * LD;
  int buf = 0;
  for (int n0 = 0; n0 < n_end; n0 += BK, buf ^= 1) {
    if (n0 + BK < n_end) load_step(n0 + BK, buf ^ 1);
    ptpu::cp_async_commit();
    ptpu::cp_async_wait<1>();  // all but the tile just requested
    __syncthreads();

    const T* k_t = Ks + buf * BK * LD;
    const T* v_t = Vs + buf * BK * LD;

    // S = Q K^T and dP = dO V^T: queries x keys
    float s[NK][4], dp[NK][4];
#pragma unroll
    for (int j = 0; j < NK; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
    ptpu::mma_nt<T, D, NK>(s, q_warp, k_t, lane);
    ptpu::mma_nt<T, D, NK>(dp, do_warp, v_t, lane);

    // dS (scale included) on the fragments, as the A operand
    const bool edge = m0 + kRows > Sq || n0 + BK > Sk ||
                      (causal && n0 + BK - 1 > m0 + offset);
    ptpu::RegA<T, NK> ds_a;
#pragma unroll
    for (int j = 0; j < NK; ++j) {
      float ds[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int half = e >> 1;
        float p = exp2f(s[j][e] * scale_log2 - lse_r[half]);
        if (edge) {
          const int key = n0 + j * 8 + 2 * t + (e & 1), row = row0 + 8 * half;
          if (!(key < Sk && row < Sq && (!causal || key <= row + offset))) {
            p = 0.f;
          }
        }
        ds[e] = p * (dp[j][e] - di_r[half]) * scale;
      }
      ptpu::set_tile(ds_a, j, ds);
    }

    // dQ += dS K over the step's keys
    ptpu::mma_rt<T, NK, ND>(acc, ds_a, k_t, lane);
    __syncthreads();  // this buffer is refilled two steps on
  }
  ptpu::cp_async_wait<0>();

  store_rows<T, ND>(dq + b * sdq.b + h * sdq.h, sdq, acc, m0 + warp * 16, Sq,
                    d, lane);
}

struct Args {
  const void *q, *k, *v, *dout;
  const float *lse, *di;
  void *dq, *dk, *dv;
  Strides st[6];  // q, k, v, dO, then dK, dV (dkv) or dQ (dq)
  int B, H, Sq, Sk, d;
  float scale;
  int causal;
};

// Whether every row of q, k, v and dO is a run of 16-byte vectors
// (attn_tiles.cuh).
template <typename T>
bool vec_rows(const Args& a) {
  const void* ptrs[4] = {a.q, a.k, a.v, a.dout};
  for (int i = 0; i < 4; ++i) {
    if (!ptpu::rows_are_vectors<T>(ptrs[i], a.st[i], a.B, a.H, a.d)) {
      return false;
    }
  }
  return true;
}

template <typename T, int D>
cudaError_t launch_dkv(const Args& a, cudaStream_t stream) {
  constexpr int bytes = dkv_smem_bytes<T, D>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dkv_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      bytes);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.Sk + kRows - 1) / kRows, a.B * a.H);
  flash_bwd_dkv_kernel<T, D><<<grid, kThreads, bytes, stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), static_cast<const T*>(a.dout), a.lse, a.di,
      static_cast<T*>(a.dk), static_cast<T*>(a.dv), a.st[0], a.st[1],
      a.st[2], a.st[3], a.st[4], a.st[5], a.H, a.Sq, a.Sk, a.d, a.scale,
      a.scale * kLog2e, a.causal, vec_rows<T>(a));
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t launch_dq(const Args& a, cudaStream_t stream) {
  constexpr int bytes = dq_smem_bytes<T, D>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dq_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      bytes);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.Sq + kRows - 1) / kRows, a.B * a.H);
  flash_bwd_dq_kernel<T, D><<<grid, kThreads, bytes, stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), static_cast<const T*>(a.dout), a.lse, a.di,
      static_cast<T*>(a.dq), a.st[0], a.st[1], a.st[2], a.st[3], a.st[4],
      a.H, a.Sq, a.Sk, a.d, a.scale, a.scale * kLog2e, a.causal,
      vec_rows<T>(a));
  return cudaGetLastError();
}

template <bool DKV, typename T, int D>
cudaError_t launch_one(const Args& a, cudaStream_t stream) {
  if constexpr (DKV) {
    return launch_dkv<T, D>(a, stream);
  } else {
    return launch_dq<T, D>(a, stream);
  }
}

template <bool DKV, typename T>
cudaError_t launch_dim(const Args& a, cudaStream_t stream) {
  if (a.d <= 32) return launch_one<DKV, T, 32>(a, stream);
  if (a.d <= 64) return launch_one<DKV, T, 64>(a, stream);
  if (a.d <= 128) return launch_one<DKV, T, 128>(a, stream);
  return cudaErrorInvalidValue;
}

template <bool DKV>
int run(Args& a, const long long* strides, int n_strides, int dtype,
        int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  for (int i = 0; i < n_strides; ++i) {
    a.st[i] = Strides{strides[4 * i], strides[4 * i + 1], strides[4 * i + 2],
                      strides[4 * i + 3]};
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      err = launch_dim<DKV, float>(a, s);
      break;
    case 1:
      err = launch_dim<DKV, __nv_bfloat16>(a, s);
      break;
    default:
      err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

}  // namespace

// strides: element strides (b, h, s, d) of q, k, v, dO, dK and dV in that
// order (24 values). lse and di: f32 [B, H, Sq], contiguous. dtype: 0 =
// float32, 1 = bfloat16, for q, k, v, dO, dK and dV alike. Requires
// 1 <= d <= 128, Sk >= 1, and Sq <= Sk when causal (the wrapper checks).
extern "C" int ptpu_flash_attn_bwd_dkv(const void* q, const void* k,
                                       const void* v, const void* dout,
                                       const float* lse, const float* di,
                                       void* dk, void* dv,
                                       const long long* strides, int B, int H,
                                       int Sq, int Sk, int d, float scale,
                                       int causal, int dtype, int device,
                                       void* stream) {
  Args a{q, k, v, dout, lse, di, nullptr, dk, dv, {}, B, H, Sq, Sk, d, scale,
         causal};
  return run<true>(a, strides, 6, dtype, device, stream);
}

// strides: element strides (b, h, s, d) of q, k, v, dO and dQ in that order
// (20 values); the rest as for ptpu_flash_attn_bwd_dkv, and Sq >= 1.
extern "C" int ptpu_flash_attn_bwd_dq(const void* q, const void* k,
                                      const void* v, const void* dout,
                                      const float* lse, const float* di,
                                      void* dq, const long long* strides,
                                      int B, int H, int Sq, int Sk, int d,
                                      float scale, int causal, int dtype,
                                      int device, void* stream) {
  Args a{q, k, v, dout, lse, di, dq, nullptr, nullptr, {}, B, H, Sq, Sk, d,
         scale, causal};
  return run<false>(a, strides, 5, dtype, device, stream);
}
