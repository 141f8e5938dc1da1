// Flash-attention forward for Hopper: O = softmax(scale * Q K^T [+ causal
// mask]) V, Q [B, H, Sq, D], K and V [B, H, Sk, D], any strides.
//
// Replaces the TPU kernel that paddle_tpu's fused_multihead_attention calls
// (paddle_tpu/ops/nn_ops.py:714-722): the forward of JAX 0.9.0's Pallas
// flash attention, jax/experimental/pallas/ops/tpu/flash_attention.py,
// _flash_attention_impl :589, pallas_call :758.
//
// Bound on an H100 SXM: 4 * B * H * Sq * Sk * D operations against the
// bytes of Q, K, V and O, each read or written once. BERT-base at batch 8,
// S = 512, D = 64, f32: 6.44 GFLOP, 96 us at the 67 TFLOP/s f32 CUDA-core
// peak, against 50 MB, 15 us at 3.35 TB/s. So the kernel is bound by
// operations; in bf16 the bound is the 989 TFLOP/s tensor-core peak, which
// this kernel does not reach: it converts bf16 to f32 as it loads and does
// all arithmetic in f32 on the CUDA cores (wgmma, TMA and tensor cores are
// later work).
//
// Design for that bound, simple first:
// - One block of 256 threads per (b*h, tile of 64 query rows). The Q tile
//   is staged once in shared memory; a loop walks the K/V tiles of 64 keys
//   (the TPU grid's sequential key axis becomes this loop), each staged in
//   shared memory as f32, zero-filled past Sk and past D.
// - Threads form a 16 x 16 grid. Each computes a 4 x 4 patch of the 64 x 64
//   score tile and holds 4 query rows x D/16 output columns of the
//   accumulator in registers. Both products read two 16-byte vectors from
//   shared memory for every 16 fused multiply-adds: Q and K are stored
//   transposed ([d][row]), P transposed ([key][row]), V as [key][d].
// - Online softmax in the log2 domain: scores are scaled by scale*log2(e)
//   in f32; each row keeps its running max m and sum l in f32 (the 16
//   threads of a row agree through warp shuffles), and the accumulator is
//   rescaled by exp2(m_old - m_new) when the max moves.
// - Masking: keys at or past Sk, and with causal keys j > i + Sk - Sq, get
//   -inf; key tiles wholly past the causal diagonal of the block's last row
//   are skipped. Query rows past Sq are computed and not written.
// - O is written once, divided by l, in the input's dtype. The [Sq, Sk]
//   scores never leave the SM.
// - With a non-null lse, each query row's log-sum-exp of the scaled scores,
//   ln(sum_j exp(scale * s_ij)) = (m + log2 l) * ln 2, is written as f32
//   [B, H, Sq], contiguous: the residual the backward kernels
//   (flash_attn_bwd.cu) recompute P from, the port's form of the l and m
//   that JAX's _flash_attention_fwd saves (:246-251). Serving passes null.
// Shared memory: 44 KB (D <= 32), 68 KB (D <= 64), 118 KB (D <= 128), so the
// launch raises the dynamic shared-memory limit first.
//
// C interface, loaded with ctypes (paddle_tpu_torch/ops/flash_attention.py).
// The launch is on the caller's stream, allocates nothing and does not
// synchronise; the return value is the first CUDA error, if any.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kBlockM = 64;    // query rows per block
constexpr int kBlockN = 64;    // keys per tile
constexpr int kThreads = 256;  // 16 x 16
constexpr int kLdm = kBlockM + 4;  // row length of the transposed tiles
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

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

// Output column of accumulator slot c (0 <= c < D/16) for thread column tx:
// groups of 4 at a stride of 64 keep the 16-byte reads of V conflict-free.
template <int D>
__device__ __forceinline__ int out_col(int tx, int c) {
  if constexpr (D == 32) {
    return tx * 2 + c;
  } else {
    return (c >> 2) * 64 + tx * 4 + (c & 3);
  }
}

template <int D>
constexpr int smem_floats() {
  return 2 * D * kLdm + kBlockN * (D + 4) + kBlockN * kLdm;
}

// Stage rows [r0, r0 + 64) of one head of x into shared memory as f32,
// zero past `rows` and past `d`. Transposed: dst[c * kLdm + r]; else
// dst[r * (D + 4) + c]. Consecutive threads read consecutive columns.
template <typename T, int D, bool TRANSPOSE>
__device__ __forceinline__ void stage(const T* __restrict__ x, Strides st,
                                      int r0, int rows, int d,
                                      float* __restrict__ dst) {
  for (int i = threadIdx.x; i < 64 * D; i += kThreads) {
    const int r = i / D, c = i % D;
    float val = 0.f;
    if (r0 + r < rows && c < d) {
      val = to_f32(x[(r0 + r) * st.s + c * st.d]);
    }
    if (TRANSPOSE) {
      dst[c * kLdm + r] = val;
    } else {
      dst[r * (D + 4) + c] = val;
    }
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
    flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, T* __restrict__ o,
                     float* __restrict__ lse, Strides sq, Strides sk,
                     Strides sv, Strides so, int H, int Sq, int Sk, int d,
                     float scale_log2, int causal) {
  constexpr int kCols = D / 16;  // accumulator columns per thread
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  float* Qt = smem;                    // [D][kLdm]
  float* Kt = Qt + D * kLdm;           // [D][kLdm]
  float* Vs = Kt + D * kLdm;           // [kBlockN][D + 4]
  float* Pt = Vs + kBlockN * (D + 4);  // [kBlockN][kLdm]

  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const int m0 = blockIdx.x * kBlockM;
  const T* qh = q + b * sq.b + h * sq.h;
  const T* kh = k + b * sk.b + h * sk.h;
  const T* vh = v + b * sv.b + h * sv.h;
  const int offset = Sk - Sq;  // causal: key j is kept for row i if j <= i + offset

  stage<T, D, true>(qh, sq, m0, Sq, d, Qt);

  float acc[4][kCols];
  float m_run[4], l_run[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m_run[i] = -INFINITY;
    l_run[i] = 0.f;
#pragma unroll
    for (int c = 0; c < kCols; ++c) acc[i][c] = 0.f;
  }

  int n_end = Sk;
  if (causal) {
    const int last = m0 + kBlockM - 1 + offset + 1;  // keys the last row keeps
    n_end = last < Sk ? last : Sk;
  }
  for (int n0 = 0; n0 < n_end; n0 += kBlockN) {
    __syncthreads();  // the previous tile's Kt, Vs and Pt are consumed
    stage<T, D, true>(kh, sk, n0, Sk, d, Kt);
    stage<T, D, false>(vh, sv, n0, Sk, d, Vs);
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int c = 0; c < D; ++c) {
      const float4 a = *reinterpret_cast<const float4*>(Qt + c * kLdm + ty * 4);
      const float4 bb = *reinterpret_cast<const float4*>(Kt + c * kLdm + tx * 4);
      const float av[4] = {a.x, a.y, a.z, a.w};
      const float bv[4] = {bb.x, bb.y, bb.z, bb.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(av[i], bv[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = m0 + ty * 4 + i;
      float mt = -INFINITY;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = n0 + tx * 4 + j;
        const bool keep = col < Sk && (!causal || col <= row + offset);
        s[i][j] = keep ? s[i][j] * scale_log2 : -INFINITY;
        mt = fmaxf(mt, s[i][j]);
      }
      // the 16 threads of a row are lanes that differ in their low 4 bits
#pragma unroll
      for (int w = 1; w < 16; w <<= 1) {
        mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, w));
      }
      const float m_new = fmaxf(m_run[i], mt);
      // a row with no key kept so far has m_new = -inf: its p and alpha are 0
      const float m_use = m_new == -INFINITY ? 0.f : m_new;
      const float alpha = exp2f(m_run[i] - m_use);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = exp2f(s[i][j] - m_use);
        rs += s[i][j];
      }
#pragma unroll
      for (int w = 1; w < 16; w <<= 1) {
        rs += __shfl_xor_sync(0xffffffffu, rs, w);
      }
      l_run[i] = l_run[i] * alpha + rs;
      m_run[i] = m_new;
#pragma unroll
      for (int c = 0; c < kCols; ++c) acc[i][c] *= alpha;
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      *reinterpret_cast<float4*>(Pt + (tx * 4 + j) * kLdm + ty * 4) =
          make_float4(s[0][j], s[1][j], s[2][j], s[3][j]);
    }
    __syncthreads();

#pragma unroll 4
    for (int kk = 0; kk < kBlockN; ++kk) {
      const float4 a = *reinterpret_cast<const float4*>(Pt + kk * kLdm + ty * 4);
      const float av[4] = {a.x, a.y, a.z, a.w};
      const float* vrow = Vs + kk * (D + 4);
      float bv[kCols];
      if constexpr (D == 32) {
        const float2 t = *reinterpret_cast<const float2*>(vrow + tx * 2);
        bv[0] = t.x;
        bv[1] = t.y;
      } else {
#pragma unroll
        for (int g = 0; g < kCols / 4; ++g) {
          const float4 t =
              *reinterpret_cast<const float4*>(vrow + g * 64 + tx * 4);
          bv[4 * g] = t.x;
          bv[4 * g + 1] = t.y;
          bv[4 * g + 2] = t.z;
          bv[4 * g + 3] = t.w;
        }
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < kCols; ++c) acc[i][c] = fmaf(av[i], bv[c], acc[i][c]);
    }
  }

  T* oh = o + b * so.b + h * so.h;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = m0 + ty * 4 + i;
    if (row >= Sq) continue;
    if (lse != nullptr && tx == 0) {
      // every row keeps a key (the wrapper refuses causal Sq > Sk and Sk = 0),
      // so l > 0 and m is finite; the guard keeps a row without one finite
      lse[bh * Sq + row] =
          l_run[i] > 0.f ? (m_run[i] + log2f(l_run[i])) * kLn2 : 0.f;
    }
    const float inv = 1.f / l_run[i];
#pragma unroll
    for (int c = 0; c < kCols; ++c) {
      const int col = out_col<D>(tx, c);
      if (col < d) store(oh + row * so.s + col * so.d, acc[i][c] * inv);
    }
  }
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   float* lse, const Strides* st, int B, int H, int Sq,
                   int Sk, int d, float scale, int causal,
                   cudaStream_t stream) {
  const int bytes = smem_floats<D>() * static_cast<int>(sizeof(float));
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      bytes);
  if (err != cudaSuccess) return err;
  const dim3 grid((Sq + kBlockM - 1) / kBlockM, B * H);
  flash_fwd_kernel<T, D><<<grid, kThreads, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), lse, st[0], st[1],
      st[2], st[3], H, Sq, Sk, d, scale * kLog2e, causal);
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
