// Fused instance norm (+ AdaIN affine) (+ activation), forward and backward,
// for sm_90a.
//
// Forward (K1) replaces the TPU kernel
// aclgan_tpu/ops/pallas/instance_norm.py::_fwd_kernel (launched by
// _fwd_pallas). Same function: per (sample, channel) row, mean and centered
// biased variance in f32, rsqrt(var + eps), optional
// y * scale[row] + shift[row], then relu / lrelu(0.2) / tanh / none, stored in
// the input's dtype.
//
// Backward (K2) replaces _bwd_kernel (launched by _bwd_pallas): the
// activation gate taken from the saved output y, the stats recomputed from x,
// dx = rsig * s * (dyp - mean(dyp) - xhat * mean(dyp * xhat)) in x's dtype, and
// per row dscale = sum(dyp * xhat), dshift = sum(dyp) in f32.
//
// Layout: x is NCHW-contiguous, seen as rows = N*C rows of row_len = H*W
// contiguous elements; scale/shift are (N, C) f32, so row r uses scale[r].
// One 256-thread block per row. The TPU kernel held a whole sample slab in
// VMEM; a 65,536-element row (256 KB in f32) does not fit in shared memory,
// so every pass streams the row from global memory / L2: pass 1 sums, pass 2
// sums squared deviations from the mean, pass 3 normalizes and stores.
//
// Bound on an H100: memory. The forward must read x once and write y once
// (2 * 2 bytes per element in bf16); the kernel reads x three times, so its
// traffic is 2x the bound whenever a layer's rows overflow the 50 MB L2. The
// backward must read x, y and dy once and write dx once (4 * 2 bytes per
// element in bf16); the kernel streams x four times and y and dy twice (8
// reads), so it moves up to 2.25x the bound's bytes: with ~1,000 rows in
// flight the rows of a 64x256^2 layer (384 KB of x, y and dy each in bf16)
// do not stay in L2 between passes. Taking (mean, rsig) saved by the forward
// would drop two passes; the kernel recomputes them so that it stays a
// function of (x, scale, y, dy), as _bwd_pallas is.
//
// The split form (K1m, K1a, K2m, K2a, below) computes the same two functions
// when a row's elements are spread over ranks (H sharding): K1m and K2m
// reduce this rank's part of each row to two f32 sums, the caller
// all-reduces them over the ranks, and K1a and K2a apply the result. They
// replace the same two TPU kernels, on the path where the JAX package lets
// GSPMD split the statistics. Bound: bytes. K1m reads x once and K1a reads x
// and writes y once, so the split forward reads x twice where the bound
// reads it once; K2m reads x, y, dy and K2a reads them again and writes dx.
// One 256-thread block a row, as K1 and K2.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

enum Activation { kNone = 0, kRelu = 1, kLrelu = 2, kTanh = 3 };

__device__ __forceinline__ float load_f32(const float* p) { return *p; }
__device__ __forceinline__ float load_f32(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void store_f32(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_f32(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);  // round to nearest even, as XLA's convert
}

// Sum of v over the block; every thread receives the total.
__device__ __forceinline__ float block_sum(float v, float* smem) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  if (lane == 0) smem[warp] = v;
  __syncthreads();
  v = lane < kWarps ? smem[lane] : 0.f;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  __syncthreads();  // smem is free for the next call
  return v;
}

__device__ __forceinline__ float activate(float v, int act) {
  switch (act) {
    case kRelu: return fmaxf(v, 0.f);
    case kLrelu: return v >= 0.f ? v : 0.2f * v;
    case kTanh: return tanhf(v);
    default: return v;
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
instance_norm_fwd_kernel(const T* __restrict__ x, const float* __restrict__ scale,
                         const float* __restrict__ shift, T* __restrict__ y,
                         int64_t row_len, float eps, int act) {
  __shared__ float smem[kWarps];
  const int64_t row = blockIdx.x;
  const T* xr = x + row * row_len;
  T* yr = y + row * row_len;
  const float inv_len = 1.f / static_cast<float>(row_len);

  float acc = 0.f;
#pragma unroll 4
  for (int64_t i = threadIdx.x; i < row_len; i += kThreads) acc += load_f32(xr + i);
  const float mean = block_sum(acc, smem) * inv_len;

  acc = 0.f;
#pragma unroll 4
  for (int64_t i = threadIdx.x; i < row_len; i += kThreads) {
    const float d = load_f32(xr + i) - mean;
    acc += d * d;
  }
  const float rsig = rsqrtf(block_sum(acc, smem) * inv_len + eps);

  const bool affine = scale != nullptr;
  const float s = affine ? scale[row] : 1.f;
  const float b = affine ? shift[row] : 0.f;
#pragma unroll 4
  for (int64_t i = threadIdx.x; i < row_len; i += kThreads) {
    float v = (load_f32(xr + i) - mean) * rsig;
    if (affine) v = v * s + b;
    store_f32(yr + i, activate(v, act));
  }
}


// Upstream gradient through the activation, from the activation's output y
// (relu and lrelu keep the sign of their input; tanh' = 1 - y^2).
__device__ __forceinline__ float gate(float dy, float y, int act) {
  switch (act) {
    case kRelu: return y > 0.f ? dy : 0.f;
    case kLrelu: return y >= 0.f ? dy : 0.2f * dy;
    case kTanh: return dy * (1.f - y * y);
    default: return dy;
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
instance_norm_bwd_kernel(const T* __restrict__ x, const float* __restrict__ scale,
                         const T* __restrict__ y, const T* __restrict__ dy,
                         T* __restrict__ dx, float* __restrict__ dscale,
                         float* __restrict__ dshift, int64_t row_len, float eps,
                         int act) {
  __shared__ float smem[kWarps];
  const int64_t row = blockIdx.x;
  const int64_t off = row * row_len;
  const T* xr = x + off;
  const T* yr = y + off;
  const T* dyr = dy + off;
  T* dxr = dx + off;
  const float inv_len = 1.f / static_cast<float>(row_len);

  // pass 1: mean
  float acc = 0.f;
#pragma unroll 4
  for (int64_t i = threadIdx.x; i < row_len; i += kThreads) acc += load_f32(xr + i);
  const float mean = block_sum(acc, smem) * inv_len;

  // pass 2: centered variance
  acc = 0.f;
#pragma unroll 4
  for (int64_t i = threadIdx.x; i < row_len; i += kThreads) {
    const float d = load_f32(xr + i) - mean;
    acc += d * d;
  }
  const float rsig = rsqrtf(block_sum(acc, smem) * inv_len + eps);

  // pass 3: gated dy, with sum(dyp) and sum(dyp * xhat)
  float s_dy = 0.f, s_dyx = 0.f;
#pragma unroll 4
  for (int64_t i = threadIdx.x; i < row_len; i += kThreads) {
    const float g = gate(load_f32(dyr + i), load_f32(yr + i), act);
    s_dy += g;
    s_dyx += g * ((load_f32(xr + i) - mean) * rsig);
  }
  s_dy = block_sum(s_dy, smem);
  s_dyx = block_sum(s_dyx, smem);

  const float s = scale != nullptr ? scale[row] : 1.f;
  if (dscale != nullptr && threadIdx.x == 0) {
    dscale[row] = s_dyx;
    dshift[row] = s_dy;
  }

  // pass 4: dx
  const float m_dy = s_dy * inv_len;
  const float m_dyx = s_dyx * inv_len;
  const float k = rsig * s;
#pragma unroll 4
  for (int64_t i = threadIdx.x; i < row_len; i += kThreads) {
    const float g = gate(load_f32(dyr + i), load_f32(yr + i), act);
    const float xhat = (load_f32(xr + i) - mean) * rsig;
    store_f32(dxr + i, k * (g - m_dy - xhat * m_dyx));
  }
}


// ---------------------------------------------------------------------------
// The split form, for rows whose elements lie on several ranks (an
// activation sharded over H): each rank reduces its part of a row, the
// caller all-reduces the partial sums over the ranks, and a second kernel
// applies the result. Statistics follow the JAX sharded form
// (aclgan_tpu/parallel/halo.py:146-157): mean = sum(x) / n,
// var = max(sum(x^2) / n - mean^2, 0), rsig = rsqrt(var + eps), with n the
// row's global length; the caller computes them from the all-reduced sums.
//
// K1m: per row, the f32 (sum x, sum x^2) of this rank's part, into out[2 row].
template <typename T>
__global__ void __launch_bounds__(kThreads)
row_moments_kernel(const T* __restrict__ x, float* __restrict__ out, int64_t row_len) {
  __shared__ float smem[kWarps];
  const int64_t row = blockIdx.x;
  const T* xr = x + row * row_len;
  float s = 0.f, ss = 0.f;
#pragma unroll 4
  for (int64_t i = threadIdx.x; i < row_len; i += kThreads) {
    const float v = load_f32(xr + i);
    s += v;
    ss += v * v;
  }
  s = block_sum(s, smem);
  ss = block_sum(ss, smem);
  if (threadIdx.x == 0) {
    out[2 * row] = s;
    out[2 * row + 1] = ss;
  }
}

// K1a: y = act((x - mean[row]) * rsig[row] * s + b), cast to x's dtype.
template <typename T>
__global__ void __launch_bounds__(kThreads)
apply_kernel(const T* __restrict__ x, const float* __restrict__ mean,
             const float* __restrict__ rsig, const float* __restrict__ scale,
             const float* __restrict__ shift, T* __restrict__ y, int64_t row_len,
             int act) {
  const int64_t row = blockIdx.x;
  const T* xr = x + row * row_len;
  T* yr = y + row * row_len;
  const float m = mean[row];
  const float r = rsig[row];
  const bool affine = scale != nullptr;
  const float s = affine ? scale[row] : 1.f;
  const float b = affine ? shift[row] : 0.f;
#pragma unroll 4
  for (int64_t i = threadIdx.x; i < row_len; i += kThreads) {
    float v = (load_f32(xr + i) - m) * r;
    if (affine) v = v * s + b;
    store_f32(yr + i, activate(v, act));
  }
}

// K2m: per row of this rank's part, dyp = dy gated through the activation
// from y (as K2), xhat = (x - mean[row]) * rsig[row]; writes the f32
// (sum dyp, sum dyp * xhat) into out[2 row].
template <typename T>
__global__ void __launch_bounds__(kThreads)
bwd_row_sums_kernel(const T* __restrict__ x, const T* __restrict__ y,
                    const T* __restrict__ dy, const float* __restrict__ mean,
                    const float* __restrict__ rsig, float* __restrict__ out,
                    int64_t row_len, int act) {
  __shared__ float smem[kWarps];
  const int64_t row = blockIdx.x;
  const int64_t off = row * row_len;
  const float m = mean[row];
  const float r = rsig[row];
  float s_dy = 0.f, s_dyx = 0.f;
#pragma unroll 4
  for (int64_t i = threadIdx.x; i < row_len; i += kThreads) {
    const float g = gate(load_f32(dy + off + i), load_f32(y + off + i), act);
    s_dy += g;
    s_dyx += g * ((load_f32(x + off + i) - m) * r);
  }
  s_dy = block_sum(s_dy, smem);
  s_dyx = block_sum(s_dyx, smem);
  if (threadIdx.x == 0) {
    out[2 * row] = s_dy;
    out[2 * row + 1] = s_dyx;
  }
}

// K2a: dx = rsig * s * (dyp - sums[2 row] / n - xhat * sums[2 row + 1] / n)
// from the all-reduced sums and the row's global length n.
template <typename T>
__global__ void __launch_bounds__(kThreads)
bwd_apply_kernel(const T* __restrict__ x, const T* __restrict__ y,
                 const T* __restrict__ dy, const float* __restrict__ mean,
                 const float* __restrict__ rsig, const float* __restrict__ scale,
                 const float* __restrict__ sums, T* __restrict__ dx, int64_t row_len,
                 float inv_n, int act) {
  const int64_t row = blockIdx.x;
  const int64_t off = row * row_len;
  const float m = mean[row];
  const float r = rsig[row];
  const float k = r * (scale != nullptr ? scale[row] : 1.f);
  const float m_dy = sums[2 * row] * inv_n;
  const float m_dyx = sums[2 * row + 1] * inv_n;
#pragma unroll 4
  for (int64_t i = threadIdx.x; i < row_len; i += kThreads) {
    const float g = gate(load_f32(dy + off + i), load_f32(y + off + i), act);
    const float xhat = (load_f32(x + off + i) - m) * r;
    store_f32(dx + off + i, k * (g - m_dy - xhat * m_dyx));
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. scale/shift: both null (IN) or both
// (rows,) f32 (AdaIN). Launches on `stream`; returns cudaGetLastError().
extern "C" int aclgan_instance_norm_fwd(const void* x, const float* scale,
                                        const float* shift, void* y, long long rows,
                                        long long row_len, int dtype, int act,
                                        float eps, void* stream) {
  const dim3 grid(static_cast<unsigned>(rows));
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    instance_norm_fwd_kernel<float><<<grid, kThreads, 0, st>>>(
        static_cast<const float*>(x), scale, shift, static_cast<float*>(y), row_len,
        eps, act);
  } else if (dtype == 1) {
    instance_norm_fwd_kernel<__nv_bfloat16><<<grid, kThreads, 0, st>>>(
        static_cast<const __nv_bfloat16*>(x), scale, shift,
        static_cast<__nv_bfloat16*>(y), row_len, eps, act);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

// dtype and act as for the forward; x, y, dy and dx share one layout.
// scale: null (IN: s = 1) or (rows,) f32. dscale/dshift: both null (no
// affine: nothing is summed out) or both (rows,) f32 outputs.
extern "C" int aclgan_instance_norm_bwd(const void* x, const float* scale,
                                        const void* y, const void* dy, void* dx,
                                        float* dscale, float* dshift, long long rows,
                                        long long row_len, int dtype, int act,
                                        float eps, void* stream) {
  const dim3 grid(static_cast<unsigned>(rows));
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    instance_norm_bwd_kernel<float><<<grid, kThreads, 0, st>>>(
        static_cast<const float*>(x), scale, static_cast<const float*>(y),
        static_cast<const float*>(dy), static_cast<float*>(dx), dscale, dshift,
        row_len, eps, act);
  } else if (dtype == 1) {
    instance_norm_bwd_kernel<__nv_bfloat16><<<grid, kThreads, 0, st>>>(
        static_cast<const __nv_bfloat16*>(x), scale,
        static_cast<const __nv_bfloat16*>(y), static_cast<const __nv_bfloat16*>(dy),
        static_cast<__nv_bfloat16*>(dx), dscale, dshift, row_len, eps, act);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

// The split form's four entry points. dtype, act and the layout as above;
// mean, rsig (rows,) f32; out and sums (rows, 2) f32; scale/shift null or
// (rows,) f32. K1m and K2m write every row of `out`; K2a takes inv_n =
// 1 / (the row's global length).
#define ACLGAN_DISPATCH(KERNEL, ...)                                          \
  do {                                                                        \
    const dim3 grid(static_cast<unsigned>(rows));                             \
    cudaStream_t st = static_cast<cudaStream_t>(stream);                      \
    if (dtype == 0) {                                                         \
      using T = float;                                                        \
      KERNEL<T><<<grid, kThreads, 0, st>>>(__VA_ARGS__);                      \
    } else if (dtype == 1) {                                                  \
      using T = __nv_bfloat16;                                                \
      KERNEL<T><<<grid, kThreads, 0, st>>>(__VA_ARGS__);                      \
    } else {                                                                  \
      return static_cast<int>(cudaErrorInvalidValue);                         \
    }                                                                         \
    return static_cast<int>(cudaGetLastError());                              \
  } while (0)

extern "C" int aclgan_instance_norm_row_moments(const void* x, float* out, long long rows,
                                                long long row_len, int dtype,
                                                void* stream) {
  ACLGAN_DISPATCH(row_moments_kernel, static_cast<const T*>(x), out, row_len);
}

extern "C" int aclgan_instance_norm_apply(const void* x, const float* mean,
                                          const float* rsig, const float* scale,
                                          const float* shift, void* y, long long rows,
                                          long long row_len, int dtype, int act,
                                          void* stream) {
  ACLGAN_DISPATCH(apply_kernel, static_cast<const T*>(x), mean, rsig, scale, shift,
                  static_cast<T*>(y), row_len, act);
}

extern "C" int aclgan_instance_norm_bwd_row_sums(const void* x, const void* y,
                                                 const void* dy, const float* mean,
                                                 const float* rsig, float* out,
                                                 long long rows, long long row_len,
                                                 int dtype, int act, void* stream) {
  ACLGAN_DISPATCH(bwd_row_sums_kernel, static_cast<const T*>(x), static_cast<const T*>(y),
                  static_cast<const T*>(dy), mean, rsig, out, row_len, act);
}

extern "C" int aclgan_instance_norm_bwd_apply(const void* x, const void* y, const void* dy,
                                              const float* mean, const float* rsig,
                                              const float* scale, const float* sums,
                                              void* dx, long long rows, long long row_len,
                                              float inv_n, int dtype, int act,
                                              void* stream) {
  ACLGAN_DISPATCH(bwd_apply_kernel, static_cast<const T*>(x), static_cast<const T*>(y),
                  static_cast<const T*>(dy), mean, rsig, scale, sums, static_cast<T*>(dx),
                  row_len, inv_n, act);
}

#undef ACLGAN_DISPATCH

extern "C" const char* aclgan_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
