// Flash-attention backward for Hopper: dQ, dK and dV of
// O = softmax(scale * Q K^T [+ causal mask]) V, from Q, K, V, dO, the
// forward's per-row log-sum-exp `lse` and di = rowsum(dO * O), both f32
// [B, H, Sq]. Q and dO are [B, H, Sq, D], K and V [B, H, Sk, D], any strides.
//
// Replaces the two TPU kernels of JAX 0.9.0's Pallas flash attention
// backward (jax/experimental/pallas/ops/tpu/flash_attention.py), which
// paddle_tpu's fused_multihead_attention reaches when it is differentiated
// on a TPU (paddle_tpu/ops/nn_ops.py:714-722):
// - _flash_attention_bwd_dkv :941 (pallas_call :1121, body :800-938) by
//   flash_bwd_dkv_kernel below;
// - _flash_attention_bwd_dq :1287 (pallas_call :1456) by flash_bwd_dq_kernel.
//
// Both recompute P from the saved log-sum-exp instead of storing it:
//   P  = exp2(s * scale * log2(e) - lse * log2(e)),   s = q . k
//   dV = sum_q P^T dO           dS = P o (dO V^T - di)
//   dK = scale * sum_q dS^T Q   dQ = scale * sum_k dS K
// with the port's forward semantics: the scale multiplies the f32 scores,
// and with causal key j is kept for query i when j <= i + Sk - Sq (the
// TPU kernels' col <= row is the same mask when Sq = Sk, the only case the
// JAX op sends them).
//
// Bound on an H100 SXM: four [Sq, Sk, D] products in dkv (S, dP, dV, dK)
// and three in dq (S, dP, dQ), so 8 * B * H * Sq * Sk * D and
// 6 * B * H * Sq * Sk * D operations. BERT-base at batch 8, S = 512, D = 64,
// f32: 12.9 GFLOP (192 us at the 67 TFLOP/s f32 CUDA-core peak) and
// 9.7 GFLOP (144 us), against 76 and 63 MB read or written once (23 and
// 19 us at 3.35 TB/s): bound by operations. In bf16 the bound is the larger
// of the halved bytes and the operations at the 989 TFLOP/s tensor-core
// peak (13 and 10 us); these first kernels compute in f32 on the CUDA cores
// either way (wgmma, TMA and tensor cores are later work).
//
// Design, simple first, laid out as flash_attn_fwd.cu:
// - Two kernels, as on the TPU, neither with atomics, so both are
//   deterministic. dkv: one block of 256 threads per (b*h, 64 keys); a loop
//   over query tiles of 32 rows (the TPU grid's sequential q_seq_index axis,
//   :822-826 and :930-934, becomes this loop) keeps dK and dV for the
//   block's keys in registers. dq: one block per (b*h, 64 queries); a loop
//   over key tiles of 64 keeps dQ in registers.
// - Tiles are staged in shared memory as f32, zero-filled past S and past
//   D: transposed ([d][row], rows padded by 4) for the products that reduce
//   over d, row-major ([row][d]) for those that reduce over rows. Threads
//   form a 16 x 16 grid; each reads 16-byte (or 8-byte) vectors from both
//   operands for every 8 or 16 fused multiply-adds.
// - dkv: thread (ty, tx) owns keys ty*4..+4 against queries tx*2..+2 of the
//   S^T and dP^T tiles, and keys ty*4..+4 x D/16 columns of dK and dV. P^T
//   and dS^T go through shared memory ([q][key]) to the dV and dK products.
// - dq: thread (ty, tx) owns queries ty*4..+4 against keys tx*4..+4 of the
//   S and dP tiles, and queries ty*4..+4 x D/16 columns of dQ; dS goes
//   through shared memory ([key][q]) to the dQ product.
// - Masked entries (keys at or past Sk, queries at or past Sq, and with
//   causal keys j > i + Sk - Sq) get P = 0; with causal, dkv starts at the
//   first query tile that sees its keys and dq stops after the last key
//   tile its rows see. Rows and keys past S are computed and not written.
// - dQ, dK and dV are written once, in the input's dtype, through the
//   strides the wrapper passes (it allocates [B, S, H, D] memory).
// Shared memory: dkv 52 / 87 / 157 KB and dq 60 / 103 / 189 KB for
// D <= 32 / 64 / 128, so each launch raises the dynamic shared-memory
// limit first.
//
// C interface, loaded with ctypes (paddle_tpu_torch/ops/flash_attention.py).
// Each launch is on the caller's stream, allocates nothing and does not
// synchronise; the return value is the first CUDA error, if any.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;   // 16 x 16
constexpr int kTile = 64;       // dkv: keys per block; dq: queries per block
                                // and keys per step
constexpr int kQStep = 32;      // dkv: queries per step
constexpr int kLd = kTile + 4;  // row length of 64-row transposed tiles
constexpr int kLdQ = kQStep + 4;  // row length of 32-row transposed tiles
constexpr float kLog2e = 1.4426950408889634f;

struct Strides {
  long long b, h, s, d;  // in elements
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

// Output column of accumulator slot c (0 <= c < D/16) for thread column tx,
// as in flash_attn_fwd.cu: groups of 4 at a stride of 64.
template <int D>
__device__ __forceinline__ int out_col(int tx, int c) {
  if constexpr (D == 32) {
    return tx * 2 + c;
  } else {
    return (c >> 2) * 64 + tx * 4 + (c & 3);
  }
}

// The D/16 values of row-major row `row` ([.][D]) that thread column tx
// multiplies, at columns out_col<D>(tx, c).
template <int D>
__device__ __forceinline__ void load_cols(const float* __restrict__ row,
                                          int tx, float* out) {
  if constexpr (D == 32) {
    const float2 t = *reinterpret_cast<const float2*>(row + tx * 2);
    out[0] = t.x;
    out[1] = t.y;
  } else {
#pragma unroll
    for (int g = 0; g < D / 64; ++g) {
      const float4 t = *reinterpret_cast<const float4*>(row + g * 64 + tx * 4);
      out[4 * g] = t.x;
      out[4 * g + 1] = t.y;
      out[4 * g + 2] = t.z;
      out[4 * g + 3] = t.w;
    }
  }
}

// Stage rows [r0, r0 + ROWS) of one head of x into shared memory as f32,
// zero past `rows` and past `d`. Transposed: dst[c * LD + r]; else
// dst[r * D + c]. Consecutive threads read consecutive columns.
template <typename T, int D, int ROWS, int LD, bool TRANSPOSE>
__device__ __forceinline__ void stage(const T* __restrict__ x, Strides st,
                                      int r0, int rows, int d,
                                      float* __restrict__ dst) {
  for (int i = threadIdx.x; i < ROWS * D; i += kThreads) {
    const int r = i / D, c = i % D;
    float val = 0.f;
    if (r0 + r < rows && c < d) {
      val = to_f32(x[(r0 + r) * st.s + c * st.d]);
    }
    if (TRANSPOSE) {
      dst[c * LD + r] = val;
    } else {
      dst[r * D + c] = val;
    }
  }
}

template <int D>
constexpr int dkv_smem_floats() {
  // Kt, Vt [D][kLd]; Qt, dOt [D][kLdQ]; Qs, dOs [kQStep][D];
  // Ps, dSs [kQStep][kLd]; lse, di [kQStep]
  return 2 * D * kLd + 2 * D * kLdQ + 2 * kQStep * D + 2 * kQStep * kLd +
         2 * kQStep;
}

template <int D>
constexpr int dq_smem_floats() {
  // Qt, dOt, Kt, Vt [D][kLd]; Ks [kTile][D]; dSt [kTile][kLd]
  return 4 * D * kLd + kTile * D + kTile * kLd;
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
                         float scale_log2, int causal) {
  constexpr int kCols = D / 16;
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  float* Kt = smem;                      // [D][kLd]
  float* Vt = Kt + D * kLd;              // [D][kLd]
  float* Qt = Vt + D * kLd;              // [D][kLdQ]
  float* dOt = Qt + D * kLdQ;            // [D][kLdQ]
  float* Qs = dOt + D * kLdQ;            // [kQStep][D]
  float* dOs = Qs + kQStep * D;          // [kQStep][D]
  float* Ps = dOs + kQStep * D;          // [kQStep][kLd]: P^T as [q][key]
  float* dSs = Ps + kQStep * kLd;        // [kQStep][kLd]: dS^T as [q][key]
  float* lse_s = dSs + kQStep * kLd;     // [kQStep], times log2(e)
  float* di_s = lse_s + kQStep;          // [kQStep]

  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const int n0 = blockIdx.x * kTile;
  const T* qh = q + b * sq.b + h * sq.h;
  const T* kh = k + b * sk.b + h * sk.h;
  const T* vh = v + b * sv.b + h * sv.h;
  const T* doh = dout + b * sdo.b + h * sdo.h;
  const float* lse_h = lse + static_cast<long long>(bh) * Sq;
  const float* di_h = di + static_cast<long long>(bh) * Sq;
  const int offset = Sk - Sq;  // causal: key j is kept for row i if j <= i + offset

  stage<T, D, kTile, kLd, true>(kh, sk, n0, Sk, d, Kt);
  stage<T, D, kTile, kLd, true>(vh, sv, n0, Sk, d, Vt);

  float dk_acc[4][kCols], dv_acc[4][kCols];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < kCols; ++c) dk_acc[i][c] = dv_acc[i][c] = 0.f;

  int m_begin = 0;
  if (causal) {  // the first query that keeps key n0 is n0 - offset
    const int first = n0 - offset > 0 ? n0 - offset : 0;
    m_begin = first / kQStep * kQStep;
  }
  for (int m0 = m_begin; m0 < Sq; m0 += kQStep) {
    __syncthreads();  // the previous step's tiles are consumed
    stage<T, D, kQStep, kLdQ, true>(qh, sq, m0, Sq, d, Qt);
    stage<T, D, kQStep, kLdQ, true>(doh, sdo, m0, Sq, d, dOt);
    stage<T, D, kQStep, kLdQ, false>(qh, sq, m0, Sq, d, Qs);
    stage<T, D, kQStep, kLdQ, false>(doh, sdo, m0, Sq, d, dOs);
    if (threadIdx.x < kQStep) {
      const int row = m0 + threadIdx.x;
      lse_s[threadIdx.x] = row < Sq ? lse_h[row] * kLog2e : 0.f;
      di_s[threadIdx.x] = row < Sq ? di_h[row] : 0.f;
    }
    __syncthreads();

    // S^T = K Q^T and dP^T = V dO^T: keys ty*4..+4 x queries tx*2..+2
    float s[4][2], dp[4][2];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 8
    for (int c = 0; c < D; ++c) {
      const float4 kv = *reinterpret_cast<const float4*>(Kt + c * kLd + ty * 4);
      const float4 vv = *reinterpret_cast<const float4*>(Vt + c * kLd + ty * 4);
      const float2 qv = *reinterpret_cast<const float2*>(Qt + c * kLdQ + tx * 2);
      const float2 ov = *reinterpret_cast<const float2*>(dOt + c * kLdQ + tx * 2);
      const float ka[4] = {kv.x, kv.y, kv.z, kv.w};
      const float va[4] = {vv.x, vv.y, vv.z, vv.w};
      const float qa[2] = {qv.x, qv.y};
      const float oa[2] = {ov.x, ov.y};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          s[i][j] = fmaf(ka[i], qa[j], s[i][j]);
          dp[i][j] = fmaf(va[i], oa[j], dp[i][j]);
        }
    }

    // P and dS, written transposed for the dV and dK products
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int ql = tx * 2 + j, row = m0 + ql;
      float p[4], ds[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int key = n0 + ty * 4 + i;
        const bool keep =
            key < Sk && row < Sq && (!causal || key <= row + offset);
        p[i] = keep ? exp2f(s[i][j] * scale_log2 - lse_s[ql]) : 0.f;
        ds[i] = p[i] * (dp[i][j] - di_s[ql]);
      }
      *reinterpret_cast<float4*>(Ps + ql * kLd + ty * 4) =
          make_float4(p[0], p[1], p[2], p[3]);
      *reinterpret_cast<float4*>(dSs + ql * kLd + ty * 4) =
          make_float4(ds[0], ds[1], ds[2], ds[3]);
    }
    __syncthreads();

    // dV += P^T dO and dK += dS^T Q over the step's queries
#pragma unroll 4
    for (int ql = 0; ql < kQStep; ++ql) {
      const float4 pv = *reinterpret_cast<const float4*>(Ps + ql * kLd + ty * 4);
      const float4 sv4 =
          *reinterpret_cast<const float4*>(dSs + ql * kLd + ty * 4);
      const float pa[4] = {pv.x, pv.y, pv.z, pv.w};
      const float sa[4] = {sv4.x, sv4.y, sv4.z, sv4.w};
      float ob[kCols], qb[kCols];
      load_cols<D>(dOs + ql * D, tx, ob);
      load_cols<D>(Qs + ql * D, tx, qb);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < kCols; ++c) {
          dv_acc[i][c] = fmaf(pa[i], ob[c], dv_acc[i][c]);
          dk_acc[i][c] = fmaf(sa[i], qb[c], dk_acc[i][c]);
        }
    }
  }

  T* dkh = dk + b * sdk.b + h * sdk.h;
  T* dvh = dv + b * sdv.b + h * sdv.h;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int key = n0 + ty * 4 + i;
    if (key >= Sk) continue;
#pragma unroll
    for (int c = 0; c < kCols; ++c) {
      const int col = out_col<D>(tx, c);
      if (col < d) {
        store(dkh + key * sdk.s + col * sdk.d, dk_acc[i][c] * scale);
        store(dvh + key * sdv.s + col * sdv.d, dv_acc[i][c]);
      }
    }
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v, const T* __restrict__ dout,
                        const float* __restrict__ lse,
                        const float* __restrict__ di, T* __restrict__ dq,
                        Strides sq, Strides sk, Strides sv, Strides sdo,
                        Strides sdq, int H, int Sq, int Sk, int d,
                        float scale, float scale_log2, int causal) {
  constexpr int kCols = D / 16;
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  float* Qt = smem;                // [D][kLd]
  float* dOt = Qt + D * kLd;       // [D][kLd]
  float* Kt = dOt + D * kLd;       // [D][kLd]
  float* Vt = Kt + D * kLd;        // [D][kLd]
  float* Ks = Vt + D * kLd;        // [kTile][D]
  float* dSt = Ks + kTile * D;     // [kTile][kLd]: dS^T as [key][q]

  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const int m0 = blockIdx.x * kTile;
  const T* qh = q + b * sq.b + h * sq.h;
  const T* kh = k + b * sk.b + h * sk.h;
  const T* vh = v + b * sv.b + h * sv.h;
  const T* doh = dout + b * sdo.b + h * sdo.h;
  const int offset = Sk - Sq;  // causal: key j is kept for row i if j <= i + offset

  stage<T, D, kTile, kLd, true>(qh, sq, m0, Sq, d, Qt);
  stage<T, D, kTile, kLd, true>(doh, sdo, m0, Sq, d, dOt);

  float lse_r[4], di_r[4], acc[4][kCols];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = m0 + ty * 4 + i;
    const long long at = static_cast<long long>(bh) * Sq + row;
    lse_r[i] = row < Sq ? lse[at] * kLog2e : 0.f;
    di_r[i] = row < Sq ? di[at] : 0.f;
#pragma unroll
    for (int c = 0; c < kCols; ++c) acc[i][c] = 0.f;
  }

  int n_end = Sk;
  if (causal) {
    const int last = m0 + kTile - 1 + offset + 1;  // keys the last row keeps
    n_end = last < Sk ? last : Sk;
  }
  for (int n0 = 0; n0 < n_end; n0 += kTile) {
    __syncthreads();  // the previous step's Kt, Vt, Ks and dSt are consumed
    stage<T, D, kTile, kLd, true>(kh, sk, n0, Sk, d, Kt);
    stage<T, D, kTile, kLd, true>(vh, sv, n0, Sk, d, Vt);
    stage<T, D, kTile, kLd, false>(kh, sk, n0, Sk, d, Ks);
    __syncthreads();

    // S = Q K^T and dP = dO V^T: queries ty*4..+4 x keys tx*4..+4
    float s[4][4], dp[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 4
    for (int c = 0; c < D; ++c) {
      const float4 qv = *reinterpret_cast<const float4*>(Qt + c * kLd + ty * 4);
      const float4 ov = *reinterpret_cast<const float4*>(dOt + c * kLd + ty * 4);
      const float4 kv = *reinterpret_cast<const float4*>(Kt + c * kLd + tx * 4);
      const float4 vv = *reinterpret_cast<const float4*>(Vt + c * kLd + tx * 4);
      const float qa[4] = {qv.x, qv.y, qv.z, qv.w};
      const float oa[4] = {ov.x, ov.y, ov.z, ov.w};
      const float ka[4] = {kv.x, kv.y, kv.z, kv.w};
      const float va[4] = {vv.x, vv.y, vv.z, vv.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          s[i][j] = fmaf(qa[i], ka[j], s[i][j]);
          dp[i][j] = fmaf(oa[i], va[j], dp[i][j]);
        }
    }

    // dS, written transposed ([key][q]) for the dQ product
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int key = n0 + tx * 4 + j;
      float ds[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int row = m0 + ty * 4 + i;
        const bool keep =
            key < Sk && row < Sq && (!causal || key <= row + offset);
        const float p = keep ? exp2f(s[i][j] * scale_log2 - lse_r[i]) : 0.f;
        ds[i] = p * (dp[i][j] - di_r[i]);
      }
      *reinterpret_cast<float4*>(dSt + (tx * 4 + j) * kLd + ty * 4) =
          make_float4(ds[0], ds[1], ds[2], ds[3]);
    }
    __syncthreads();

    // dQ += dS K over the step's keys
#pragma unroll 4
    for (int kk = 0; kk < kTile; ++kk) {
      const float4 sv4 =
          *reinterpret_cast<const float4*>(dSt + kk * kLd + ty * 4);
      const float sa[4] = {sv4.x, sv4.y, sv4.z, sv4.w};
      float kb[kCols];
      load_cols<D>(Ks + kk * D, tx, kb);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < kCols; ++c) acc[i][c] = fmaf(sa[i], kb[c], acc[i][c]);
    }
  }

  T* dqh = dq + b * sdq.b + h * sdq.h;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = m0 + ty * 4 + i;
    if (row >= Sq) continue;
#pragma unroll
    for (int c = 0; c < kCols; ++c) {
      const int col = out_col<D>(tx, c);
      if (col < d) store(dqh + row * sdq.s + col * sdq.d, acc[i][c] * scale);
    }
  }
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

template <typename T, int D>
cudaError_t launch_dkv(const Args& a, cudaStream_t stream) {
  const int bytes = dkv_smem_floats<D>() * static_cast<int>(sizeof(float));
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dkv_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      bytes);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.Sk + kTile - 1) / kTile, a.B * a.H);
  flash_bwd_dkv_kernel<T, D><<<grid, kThreads, bytes, stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), static_cast<const T*>(a.dout), a.lse, a.di,
      static_cast<T*>(a.dk), static_cast<T*>(a.dv), a.st[0], a.st[1],
      a.st[2], a.st[3], a.st[4], a.st[5], a.H, a.Sq, a.Sk, a.d, a.scale,
      a.scale * kLog2e, a.causal);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t launch_dq(const Args& a, cudaStream_t stream) {
  const int bytes = dq_smem_floats<D>() * static_cast<int>(sizeof(float));
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dq_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      bytes);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.Sq + kTile - 1) / kTile, a.B * a.H);
  flash_bwd_dq_kernel<T, D><<<grid, kThreads, bytes, stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), static_cast<const T*>(a.dout), a.lse, a.di,
      static_cast<T*>(a.dq), a.st[0], a.st[1], a.st[2], a.st[3], a.st[4],
      a.H, a.Sq, a.Sk, a.d, a.scale, a.scale * kLog2e, a.causal);
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
