// Fused batch-norm apply for Hopper: y = act(x * k[c] + b[c]).
//
// Replaces the TPU kernel paddle_tpu/ops/pallas_bn.py:_fwd_impl (its
// pl.pallas_call at :48, kernel body _kernel at :24): one pass over x,
// with the per-channel k and b cast to x's dtype and act None or relu.
//
// Bound on an H100 SXM: the kernel does 2 operations per element and moves
// 2 * numel * itemsize bytes (x read once, y written once; k and b are a
// few KB), so it is memory-bound at 3.35 TB/s by a wide margin.
//
// Design for that bound: x is viewed as [outer, C, inner] (NCHW: inner =
// H*W; NHWC or 2-D: inner = 1). Each thread of a grid-stride loop moves one
// 16-byte vector (4 f32 or 8 bf16 contiguous elements), so consecutive
// threads read consecutive 16-byte words. The channel of the vector's first
// element comes from its flat index by two 32-bit divisions; the channel of
// the next elements by counting the position within `inner`, so the vector
// may cross channels and inner = 49 (7x7) or 1 needs no padding. k and b
// come through the read-only cache. The last n % VEC elements are a masked
// scalar tail. When x is not 16-byte aligned, the same kernel runs one
// element per thread (VEC = 1).
//
// Numerics: k and b are rounded to x's dtype, then x*k and +b are each
// rounded in f32 (no fused multiply-add) and the result is rounded once to
// x's dtype. For f32 that is bit-identical to PyTorch's `x * k + b`; for
// bf16, PyTorch rounds x*k to bf16 before the add and may differ by 1 ulp.
//
// C interface, loaded with ctypes (paddle_tpu_torch/ops/bn_apply.py). The
// launch is on the caller's stream, allocates nothing and does not
// synchronise; the return value is cudaGetLastError() after the launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr unsigned kMaxBlocks = 1u << 16;

__device__ __forceinline__ void load_vec(const float* p, float (&v)[4]) {
  const float4 q = __ldg(reinterpret_cast<const float4*>(p));
  v[0] = q.x;
  v[1] = q.y;
  v[2] = q.z;
  v[3] = q.w;
}

__device__ __forceinline__ void store_vec(float* p, const float (&v)[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}

__device__ __forceinline__ void load_vec(const __nv_bfloat16* p,
                                         float (&v)[8]) {
  const uint4 q = __ldg(reinterpret_cast<const uint4*>(p));
  const unsigned w[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    // little-endian: the element at the lower address is the low half
    v[2 * i] = __uint_as_float(w[i] << 16);
    v[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}

__device__ __forceinline__ unsigned bf16_bits(float f) {
  return static_cast<unsigned>(__bfloat16_as_ushort(__float2bfloat16_rn(f)));
}

__device__ __forceinline__ void store_vec(__nv_bfloat16* p,
                                          const float (&v)[8]) {
  unsigned w[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    w[i] = bf16_bits(v[2 * i]) | (bf16_bits(v[2 * i + 1]) << 16);
  }
  *reinterpret_cast<uint4*>(p) = make_uint4(w[0], w[1], w[2], w[3]);
}

__device__ __forceinline__ float load1(const float* p) { return __ldg(p); }

__device__ __forceinline__ float load1(const __nv_bfloat16* p) {
  return __bfloat162float(__ldg(p));
}

__device__ __forceinline__ void store1(float* p, float v) { *p = v; }

__device__ __forceinline__ void store1(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

// a per-channel f32 parameter as x's dtype (the `.astype(x.dtype)` of _kernel)
__device__ __forceinline__ float param(const float* p, unsigned ch,
                                       const float*) {
  return __ldg(p + ch);
}

__device__ __forceinline__ float param(const float* p, unsigned ch,
                                       const __nv_bfloat16*) {
  return __bfloat162float(__float2bfloat16_rn(__ldg(p + ch)));
}

template <bool RELU>
__device__ __forceinline__ float apply(float x, float k, float b) {
  const float y = __fadd_rn(__fmul_rn(x, k), b);
  if (RELU) {
    return y < 0.f ? 0.f : y;  // NaN stays NaN, as in max(y, 0)
  }
  return y;
}

template <typename T, int VEC, bool RELU>
__global__ void __launch_bounds__(kThreads)
    bn_apply_kernel(const T* __restrict__ x, const float* __restrict__ k,
                    const float* __restrict__ b, T* __restrict__ y,
                    unsigned n, unsigned inner, unsigned c) {
  const unsigned nvec = n / VEC;
  const unsigned tid = blockIdx.x * blockDim.x + threadIdx.x;
  const unsigned stride = gridDim.x * blockDim.x;
  for (unsigned v = tid; v < nvec; v += stride) {
    const unsigned i0 = v * VEC;
    const unsigned q = i0 / inner;
    unsigned pos = i0 - q * inner;
    unsigned ch = q % c;
    float kk = param(k, ch, x);
    float bb = param(b, ch, x);
    if constexpr (VEC == 1) {
      store1(y + i0, apply<RELU>(load1(x + i0), kk, bb));
    } else {
      float e[VEC];
      load_vec(x + i0, e);
#pragma unroll
      for (int j = 0; j < VEC; ++j) {
        e[j] = apply<RELU>(e[j], kk, bb);
        if (++pos == inner) {
          pos = 0;
          if (++ch == c) ch = 0;
          kk = param(k, ch, x);
          bb = param(b, ch, x);
        }
      }
      store_vec(y + i0, e);
    }
  }
  // masked tail: the last n % VEC elements, one per thread
  const unsigned tail = n - nvec * VEC;
  if (tid < tail) {
    const unsigned i = nvec * VEC + tid;
    const unsigned ch = (i / inner) % c;
    store1(y + i, apply<RELU>(load1(x + i), param(k, ch, x), param(b, ch, x)));
  }
}

template <typename T, int VEC, bool RELU>
cudaError_t launch(const void* x, const float* k, const float* b, void* y,
                   unsigned n, unsigned inner, unsigned c, cudaStream_t s) {
  const unsigned work = n / VEC > 0 ? n / VEC : 1;
  unsigned blocks = (work + kThreads - 1) / kThreads;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  bn_apply_kernel<T, VEC, RELU><<<blocks, kThreads, 0, s>>>(
      static_cast<const T*>(x), k, b, static_cast<T*>(y), n, inner, c);
  return cudaGetLastError();
}

template <typename T, int VEC>
cudaError_t launch_act(const void* x, const float* k, const float* b, void* y,
                       unsigned n, unsigned inner, unsigned c, int relu,
                       cudaStream_t s) {
  return relu ? launch<T, VEC, true>(x, k, b, y, n, inner, c, s)
              : launch<T, VEC, false>(x, k, b, y, n, inner, c, s);
}

template <typename T>
cudaError_t launch_dtype(const void* x, const float* k, const float* b,
                         void* y, unsigned n, unsigned inner, unsigned c,
                         int relu, int vectorize, cudaStream_t s) {
  constexpr int kVec = 16 / sizeof(T);
  return vectorize ? launch_act<T, kVec>(x, k, b, y, n, inner, c, relu, s)
                   : launch_act<T, 1>(x, k, b, y, n, inner, c, relu, s);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. vectorize: x and y are 16-byte aligned.
extern "C" int ptpu_bn_apply(const void* x, const float* k, const float* b,
                             void* y, unsigned n, unsigned inner, unsigned c,
                             int dtype, int relu, int vectorize, int device,
                             void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      err = launch_dtype<float>(x, k, b, y, n, inner, c, relu, vectorize, s);
      break;
    case 1:
      err = launch_dtype<__nv_bfloat16>(x, k, b, y, n, inner, c, relu,
                                        vectorize, s);
      break;
    default:
      err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}
