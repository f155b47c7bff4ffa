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
// activation gate taken from the saved output y, xhat from the statistics K1
// saved, dx = rsig * s * (dyp - mean(dyp) - xhat * mean(dyp * xhat)) in x's dtype, and
// per row dscale = sum(dyp * xhat), dshift = sum(dyp) in f32.
//
// Layout: x is NCHW-contiguous, seen as rows = N*C rows of row_len = H*W
// contiguous elements; scale/shift are (N, C) f32, so row r uses scale[r].
// K1 can also write each row's f32 (mean, rsig), (N, C), and K2 takes them
// instead of recomputing them: the autograd pair saves K1's for K2, so K2 is
// the function of (x, scale, y, dy) that _bwd_pallas is, given the
// statistics of x that the forward computed (the no-grad op asks for none).
//
// Bound on an H100: bytes. The forward must read x once and write y once
// (2 * 2 bytes an element in bf16); the backward must read x, y and dy once
// and write dx once (4 * 2 bytes). Both reduce each row before they can
// write it, so a kernel that streams the row from global memory reads it
// again after each reduction. The TPU kernel held a whole sample slab in
// VMEM; here the row is held in registers instead: each thread loads its
// share of the row once, as packed 16-byte words (a narrower word, down to
// one element, where the launch plan finds a base or a row length off 16
// bytes), all of its loads issued before any arithmetic. A row longer than
// one 256-thread CTA holds is split into whole-vector chunks over a thread
// block cluster of 2, 4 or 8 CTAs (chunk_bounds); each CTA reduces its chunk,
// and every CTA adds the cluster's partial sums in rank order through
// distributed shared memory, so all CTAs of a row hold the same bits of each
// statistic and no float atomics are used (two launches give the same bits).
// K1 on chip reads x once and writes y once: sum -> mean, centered sum of
// squares -> rsig, then normalize / affine / activation / cast from the
// registers. K2 on chip reads x, y and dy once and writes dx once: the gated
// dy and xhat from the saved statistics, their two row sums, then dx.
//
// Registers are the budget: what bounds the on-chip kernels is the CTAs an
// SM holds while others wait on their reductions. A thread holds at most 32
// elements of each input in bf16 (K1: 16 registers of x, 32 once unpacked;
// K2: 48 registers of x, y and dy), so a row of up to 8 x 256 x 32 = 65,536
// elements (every row of the 256^2 model) goes on chip. In f32 K2 holds 16
// (the same 48 registers), so its rows above 32,768 elements stream; K1
// holds 64 (64 registers: f32 needs no unpacking), so its rows up to 131,072
// elements go on chip and a 16,384-element row (the f32 checks' 128^2 layers)
// takes one CTA. One CTA sums a row in the streaming variant's order, bit for
// bit; phase 23 of chip_smoke.py (two data-parallel ranks against one
// process, f32, a discriminator with IN) moved across its 1e-3 bar under a
// change of that rounding alone (2 CTAs: 1.13e-3; one CTA: 1.6e-4). f32 is
// the checking dtype (the training path runs in bf16). A kernel is built for
// its full load count and for half, taken where a chunk fits (a 4,096-element
// row on one CTA), so that a short row's CTA takes fewer registers; K2 keeps
// dyp and xhat as two floats an element after its loads (the three inputs
// unpacked would be three).
// The plan comes from the
// wrapper (`ops/kernels/instance_norm.py::_fused_plan`); a row that does not
// fit on 8 CTAs takes the streaming variant, one CTA a row: K1 streams x
// three times (sum, centered sum of squares, normalize), K2 streams x, y and
// dy twice (the two sums, then dx), each with the plan's loads.
//
// The split form (K1m, K1a, K2m, K2a, below) computes the same two functions
// when a row's elements are spread over ranks (H sharding): K1m and K2m
// reduce this rank's part of each row to two f32 sums, the caller
// all-reduces them over the ranks, and K1a and K2a apply the result. They
// replace the same two TPU kernels, on the path where the JAX package lets
// GSPMD split the statistics. Bound: bytes. K1m reads x once and K1a reads x
// and writes y once, so the split forward reads x twice where the bound
// reads it once; K2m reads x, y, dy and K2a reads them again and writes dx.
// K1a and K2a read and write each byte once, so their design is bytes in
// flight too: 16-byte loads and stores, and a long row cut into chunks on
// separate CTAs (below). K1a also takes the all-reduced sums and computes the
// statistics itself, so a sharded layer's forward is K1m, the all-reduce and
// K1a, with nothing between.
//
// K1m and K2m read each byte once and reuse none, so their bound is bytes
// and their design is bytes in flight. On a rank's layers (128-1,536 rows of
// 8,192-131,072 elements) one block a row with scalar loads kept 1-2 blocks
// and ~2 KB of loads on an SM for the long rows. Here each thread issues
// several 16-byte loads (uint4 through the read-only path; a narrower word,
// down to one element, where the launch plan finds a base or a row length
// off 16 bytes) before it adds any, and a long row is split over a thread
// block cluster of 2-8 CTAs whose partial sums meet in distributed shared
// memory, so that rows x CTAs fills the 132 SMs. TMA and wgmma have nothing
// to do here: there is no tile to reuse and no product to take. The plan
// (CTAs a row, elements a load) is computed by the wrapper
// (`ops/kernels/instance_norm.py::_split_plan`) and passed in; on the short
// rows of a rank's 64x128 layers each launch's device time is a few
// microseconds, below the host's cost of issuing it, and the wrapper's host
// path is what sets their time.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

#include <initializer_list>

namespace cg = cooperative_groups;

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

// ---------------------------------------------------------------------------
// The split form, for rows whose elements lie on several ranks (an
// activation sharded over H): each rank reduces its part of a row, the
// caller all-reduces the partial sums over the ranks, and a second kernel
// applies the result. Statistics follow the JAX sharded form
// (aclgan_tpu/parallel/halo.py:146-157): mean = sum(x) / n,
// var = max(sum(x^2) / n - mean^2, 0), rsig = rsqrt(var + eps), with n the
// row's global length; K1a computes them from the all-reduced sums.
//
// K1m and K2m stream their rows once and reuse nothing, so what bounds them
// is bytes in flight: 16-byte loads (vec elements a load, from the launch
// plan), kLoads of them issued by each thread before it sums any, and a long
// row split over a cluster of ctas CTAs, so that a layer's 128-1,536 rows
// fill the 132 SMs. Each CTA reduces a contiguous chunk of whole vectors
// (chunk_bounds; the last CTA also takes the row_len % vec elements past the
// last vector, one at a time) to two f32 sums; after cluster.sync(), rank 0
// adds the CTAs' sums in rank order through distributed shared memory and
// writes the row. No float atomics: the same bits every run.
constexpr int kLoads = 8;     // K1m: 8 x 16 bytes in flight a thread
constexpr int kSumLoads = 4;  // K2m: 4 x 3 x 16 bytes (x, y, dy)

// vec elements of T as one 2-, 4-, 8- or 16-byte word
template <int BYTES> struct Word;
template <> struct Word<2> { using type = unsigned short; };
template <> struct Word<4> { using type = unsigned int; };
template <> struct Word<8> { using type = uint2; };
template <> struct Word<16> { using type = uint4; };

template <typename T, int VEC>
struct Pack {
  using W = typename Word<VEC * sizeof(T)>::type;
  W w;
  __device__ __forceinline__ float operator[](int i) const {
    return load_f32(reinterpret_cast<const T*>(&w) + i);
  }
};

// One load through the read-only path; p is aligned to VEC elements.
template <typename T, int VEC>
__device__ __forceinline__ Pack<T, VEC> load_pack(const T* p) {
  using W = typename Pack<T, VEC>::W;
  return Pack<T, VEC>{__ldg(reinterpret_cast<const W*>(p))};
}

// CTA `rank` of `ctas` takes the vectors [lo, hi) of a row of n_vec whole
// vectors: runs of ceil(n_vec / ctas), the last ones possibly short or
// empty (`ops/kernels/instance_norm.py::_chunk_bounds` is the same split).
__device__ __forceinline__ void chunk_bounds(int64_t n_vec, int rank, int ctas,
                                             int64_t* lo, int64_t* hi) {
  const int64_t per = (n_vec + ctas - 1) / ctas;
  const int64_t start = rank * per;
  *lo = start < n_vec ? start : n_vec;
  *hi = *lo + per < n_vec ? *lo + per : n_vec;
}

// Writes the row's two sums from each CTA's (a, b), held by its thread 0.
// Over a cluster, rank 0 adds them in rank order; the last cluster.sync()
// keeps every CTA's shared memory alive until rank 0 has read it.
__device__ __forceinline__ void write_row_sums(float* out, float a, float b, int rank,
                                               int ctas, float2* partial) {
  if (ctas == 1) {
    if (threadIdx.x == 0) {
      out[0] = a;
      out[1] = b;
    }
    return;
  }
  cg::cluster_group cluster = cg::this_cluster();
  if (threadIdx.x == 0) *partial = make_float2(a, b);
  cluster.sync();
  if (rank == 0 && threadIdx.x == 0) {
    float2 t = *partial;
    for (int r = 1; r < ctas; ++r) {
      const float2 p = *cluster.map_shared_rank(partial, r);
      t.x += p.x;
      t.y += p.y;
    }
    out[0] = t.x;
    out[1] = t.y;
  }
  cluster.sync();
}

// K1m: per row, the f32 (sum x, sum x^2) of this rank's part, into out[2 row].
// The grid is rows * ctas CTAs, in clusters of ctas along x when ctas > 1, so
// CTA blockIdx.x is rank blockIdx.x % ctas of row blockIdx.x / ctas.
template <typename T, int VEC>
__global__ void __launch_bounds__(kThreads)
row_moments_kernel(const T* __restrict__ x, float* __restrict__ out, int64_t row_len,
                   int ctas) {
  __shared__ float smem[kWarps];
  __shared__ float2 partial;
  const int rank = static_cast<int>(blockIdx.x % ctas);
  const int64_t row = blockIdx.x / ctas;
  const T* xr = x + row * row_len;
  const int64_t n_vec = row_len / VEC;
  int64_t lo, hi;
  chunk_bounds(n_vec, rank, ctas, &lo, &hi);
  float s = 0.f, ss = 0.f;
  for (int64_t i0 = lo + threadIdx.x; i0 < hi; i0 += kThreads * kLoads) {
    Pack<T, VEC> p[kLoads];
#pragma unroll
    for (int u = 0; u < kLoads; ++u) {
      if (i0 + u * kThreads < hi) p[u] = load_pack<T, VEC>(xr + (i0 + u * kThreads) * VEC);
    }
#pragma unroll
    for (int u = 0; u < kLoads; ++u) {
      if (i0 + u * kThreads < hi) {
#pragma unroll
        for (int e = 0; e < VEC; ++e) {
          const float v = p[u][e];
          s += v;
          ss += v * v;
        }
      }
    }
  }
  if (rank == ctas - 1) {
    for (int64_t i = n_vec * VEC + threadIdx.x; i < row_len; i += kThreads) {
      const float v = load_f32(xr + i);
      s += v;
      ss += v * v;
    }
  }
  s = block_sum(s, smem);
  ss = block_sum(ss, smem);
  write_row_sums(out + 2 * row, s, ss, rank, ctas, &partial);
}

// Stores VEC floats as one word of VEC elements of T at p (aligned to VEC
// elements), each rounded as store_f32 does.
template <typename T, int VEC>
__device__ __forceinline__ void store_pack(T* p, const float (&v)[VEC]) {
  Pack<T, VEC> o;
#pragma unroll
  for (int e = 0; e < VEC; ++e) store_f32(reinterpret_cast<T*>(&o.w) + e, v[e]);
  *reinterpret_cast<typename Pack<T, VEC>::W*>(p) = o.w;
}

// K1a and K2a read each byte once and reduce nothing, so they are bound by
// bytes in flight as K1m and K2m are, and need no cluster: the grid is rows x
// chunks CTAs (CTA blockIdx.x is chunk blockIdx.x % chunks of row
// blockIdx.x / chunks, the chunks as chunk_bounds splits a row, the last one
// also taking the row_len % vec tail), so that a rank's 128-256 long rows
// fill the 132 SMs. Each CTA reads its row's scalars once; each thread
// issues all its loads (uint4, or a narrower word where the plan says) before
// any arithmetic, and stores uint4 too. Elementwise, so two launches give the
// same bits.
constexpr int kApplyLoads = 8;     // K1a: 8 x 16 bytes of x in flight a thread
constexpr int kBwdApplyLoads = 4;  // K2a: 4 x 3 x 16 bytes (x, y, dy)

// K1a: from the row's all-reduced (sum x, sum x^2) over n elements, mean =
// s / n, var = max(ss / n - mean^2, 0), rsig = rsqrt(var + eps) in f32, in
// `_stats`'s order (no multiply-add contraction); then y = act((x - mean) *
// rsig * scale + shift), cast to x's dtype. Chunk 0 of each row writes its
// mean and rsig, (rows,) f32, for the backward.
template <typename T, int VEC>
__global__ void __launch_bounds__(kThreads)
apply_kernel(const T* __restrict__ x, const float* __restrict__ moments,
             const float* __restrict__ scale, const float* __restrict__ shift,
             T* __restrict__ y, float* __restrict__ mean_out, float* __restrict__ rsig_out,
             int64_t row_len, float n, float eps, int act, int chunks) {
  const int chunk = static_cast<int>(blockIdx.x % chunks);
  const int64_t row = blockIdx.x / chunks;
  const float m = __fdiv_rn(moments[2 * row], n);
  const float var = __fsub_rn(__fdiv_rn(moments[2 * row + 1], n), __fmul_rn(m, m));
  const float r = rsqrtf(__fadd_rn(var < 0.f ? 0.f : var, eps));  // NaN stays NaN
  if (chunk == 0 && threadIdx.x == 0) {
    mean_out[row] = m;
    rsig_out[row] = r;
  }
  const bool affine = scale != nullptr;
  const float s = affine ? scale[row] : 1.f;
  const float b = affine ? shift[row] : 0.f;
  const T* xr = x + row * row_len;
  T* yr = y + row * row_len;
  const int64_t n_vec = row_len / VEC;
  int64_t lo, hi;
  chunk_bounds(n_vec, chunk, chunks, &lo, &hi);
  for (int64_t i0 = lo + threadIdx.x; i0 < hi; i0 += kThreads * kApplyLoads) {
    Pack<T, VEC> p[kApplyLoads];
#pragma unroll
    for (int u = 0; u < kApplyLoads; ++u) {
      if (i0 + u * kThreads < hi) p[u] = load_pack<T, VEC>(xr + (i0 + u * kThreads) * VEC);
    }
#pragma unroll
    for (int u = 0; u < kApplyLoads; ++u) {
      if (i0 + u * kThreads < hi) {
        float v[VEC];
#pragma unroll
        for (int e = 0; e < VEC; ++e) {
          v[e] = (p[u][e] - m) * r;
          if (affine) v[e] = v[e] * s + b;
          v[e] = activate(v[e], act);
        }
        store_pack<T, VEC>(yr + (i0 + u * kThreads) * VEC, v);
      }
    }
  }
  if (chunk == chunks - 1) {
    for (int64_t i = n_vec * VEC + threadIdx.x; i < row_len; i += kThreads) {
      float v = (load_f32(xr + i) - m) * r;
      if (affine) v = v * s + b;
      store_f32(yr + i, activate(v, act));
    }
  }
}

// K2m: per row of this rank's part, dyp = dy gated through the activation
// from y (as K2), xhat = (x - mean[row]) * rsig[row]; writes the f32
// (sum dyp, sum dyp * xhat) into out[2 row]. Grid, chunks and clusters as
// K1m.
template <typename T, int VEC>
__global__ void __launch_bounds__(kThreads)
bwd_row_sums_kernel(const T* __restrict__ x, const T* __restrict__ y,
                    const T* __restrict__ dy, const float* __restrict__ mean,
                    const float* __restrict__ rsig, float* __restrict__ out,
                    int64_t row_len, int act, int ctas) {
  __shared__ float smem[kWarps];
  __shared__ float2 partial;
  const int rank = static_cast<int>(blockIdx.x % ctas);
  const int64_t row = blockIdx.x / ctas;
  const int64_t off = row * row_len;
  const T* xr = x + off;
  const T* yr = y + off;
  const T* dyr = dy + off;
  const float m = mean[row];
  const float r = rsig[row];
  const int64_t n_vec = row_len / VEC;
  int64_t lo, hi;
  chunk_bounds(n_vec, rank, ctas, &lo, &hi);
  float s_dy = 0.f, s_dyx = 0.f;
  for (int64_t i0 = lo + threadIdx.x; i0 < hi; i0 += kThreads * kSumLoads) {
    Pack<T, VEC> px[kSumLoads], py[kSumLoads], pd[kSumLoads];
#pragma unroll
    for (int u = 0; u < kSumLoads; ++u) {
      const int64_t i = i0 + u * kThreads;
      if (i < hi) {
        px[u] = load_pack<T, VEC>(xr + i * VEC);
        py[u] = load_pack<T, VEC>(yr + i * VEC);
        pd[u] = load_pack<T, VEC>(dyr + i * VEC);
      }
    }
#pragma unroll
    for (int u = 0; u < kSumLoads; ++u) {
      if (i0 + u * kThreads < hi) {
#pragma unroll
        for (int e = 0; e < VEC; ++e) {
          const float g = gate(pd[u][e], py[u][e], act);
          s_dy += g;
          s_dyx += g * ((px[u][e] - m) * r);
        }
      }
    }
  }
  if (rank == ctas - 1) {
    for (int64_t i = n_vec * VEC + threadIdx.x; i < row_len; i += kThreads) {
      const float g = gate(load_f32(dyr + i), load_f32(yr + i), act);
      s_dy += g;
      s_dyx += g * ((load_f32(xr + i) - m) * r);
    }
  }
  s_dy = block_sum(s_dy, smem);
  s_dyx = block_sum(s_dyx, smem);
  write_row_sums(out + 2 * row, s_dy, s_dyx, rank, ctas, &partial);
}

// K2a: dx = rsig * s * (dyp - sums[2 row] / n - xhat * sums[2 row + 1] / n)
// from the all-reduced sums and the row's global length n (inv_n = 1 / n).
// Grid and chunks as K1a.
template <typename T, int VEC>
__global__ void __launch_bounds__(kThreads)
bwd_apply_kernel(const T* __restrict__ x, const T* __restrict__ y,
                 const T* __restrict__ dy, const float* __restrict__ mean,
                 const float* __restrict__ rsig, const float* __restrict__ scale,
                 const float* __restrict__ sums, T* __restrict__ dx, int64_t row_len,
                 float inv_n, int act, int chunks) {
  const int chunk = static_cast<int>(blockIdx.x % chunks);
  const int64_t row = blockIdx.x / chunks;
  const int64_t off = row * row_len;
  const T* xr = x + off;
  const T* yr = y + off;
  const T* dyr = dy + off;
  T* dxr = dx + off;
  const float m = mean[row];
  const float r = rsig[row];
  const float k = r * (scale != nullptr ? scale[row] : 1.f);
  const float m_dy = sums[2 * row] * inv_n;
  const float m_dyx = sums[2 * row + 1] * inv_n;
  const int64_t n_vec = row_len / VEC;
  int64_t lo, hi;
  chunk_bounds(n_vec, chunk, chunks, &lo, &hi);
  for (int64_t i0 = lo + threadIdx.x; i0 < hi; i0 += kThreads * kBwdApplyLoads) {
    Pack<T, VEC> px[kBwdApplyLoads], py[kBwdApplyLoads], pd[kBwdApplyLoads];
#pragma unroll
    for (int u = 0; u < kBwdApplyLoads; ++u) {
      const int64_t i = i0 + u * kThreads;
      if (i < hi) {
        px[u] = load_pack<T, VEC>(xr + i * VEC);
        py[u] = load_pack<T, VEC>(yr + i * VEC);
        pd[u] = load_pack<T, VEC>(dyr + i * VEC);
      }
    }
#pragma unroll
    for (int u = 0; u < kBwdApplyLoads; ++u) {
      if (i0 + u * kThreads < hi) {
        float v[VEC];
#pragma unroll
        for (int e = 0; e < VEC; ++e) {
          const float g = gate(pd[u][e], py[u][e], act);
          const float xhat = (px[u][e] - m) * r;
          v[e] = k * (g - m_dy - xhat * m_dyx);
        }
        store_pack<T, VEC>(dxr + (i0 + u * kThreads) * VEC, v);
      }
    }
  }
  if (chunk == chunks - 1) {
    for (int64_t i = n_vec * VEC + threadIdx.x; i < row_len; i += kThreads) {
      const float g = gate(load_f32(dyr + i), load_f32(yr + i), act);
      const float xhat = (load_f32(xr + i) - m) * r;
      store_f32(dxr + i, k * (g - m_dy - xhat * m_dyx));
    }
  }
}

// ---------------------------------------------------------------------------
// K1 and K2 (the unsharded pair; design in the header). The grid of the on-chip
// variants is rows * ctas CTAs, in clusters of ctas along x when ctas > 1, so
// CTA blockIdx.x is rank blockIdx.x % ctas of row blockIdx.x / ctas; the
// streaming variants run one CTA a row.
// Elements of each input a thread of an on-chip kernel holds, at most (the
// header says why): K1 32 in bf16, 64 in f32; K2 32 in bf16, 16 in f32.
template <typename T, int INPUTS>
__host__ __device__ constexpr int row_elems() {
  return sizeof(T) == 2 ? 32 : (INPUTS == 1 ? 64 : 16);
}

// A float or float2 from another lane of the warp, and the sum of two.
__device__ __forceinline__ float shfl_from(float v, int lane) {
  return __shfl_sync(0xffffffffu, v, lane);
}
__device__ __forceinline__ float2 shfl_from(float2 v, int lane) {
  return make_float2(__shfl_sync(0xffffffffu, v.x, lane), __shfl_sync(0xffffffffu, v.y, lane));
}
__device__ __forceinline__ float add(float a, float b) { return a + b; }
__device__ __forceinline__ float2 add(float2 a, float2 b) {
  return make_float2(a.x + b.x, a.y + b.y);
}

// The row's total of a value whose CTA total v every thread holds: v itself
// on one CTA; over a cluster, each CTA's thread 0 publishes its v in `slot`,
// and after cluster.sync() every warp reads the ctas slots (lane r reads
// rank r's) and adds them in rank order, so every thread of every CTA of the
// row gets the same bits. The caller ends with a cluster.sync() after its last
// row_total, so that no CTA exits while another may still read its slot.
template <typename V>
__device__ __forceinline__ V row_total(V v, int ctas, V* slot) {
  if (ctas == 1) return v;
  cg::cluster_group cluster = cg::this_cluster();
  if (threadIdx.x == 0) *slot = v;
  cluster.sync();
  const int lane = threadIdx.x & 31;
  const V mine = *cluster.map_shared_rank(slot, lane < ctas ? lane : 0);
  V t = shfl_from(mine, 0);
  for (int r = 1; r < ctas; ++r) t = add(t, shfl_from(mine, r));
  return t;
}

// Sum of v.x and of v.y over the block; every thread receives both.
__device__ __forceinline__ float2 block_sum2(float2 v, float2* smem) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    v.x += __shfl_xor_sync(0xffffffffu, v.x, o);
    v.y += __shfl_xor_sync(0xffffffffu, v.y, o);
  }
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  if (lane == 0) smem[warp] = v;
  __syncthreads();
  v = lane < kWarps ? smem[lane] : make_float2(0.f, 0.f);
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    v.x += __shfl_xor_sync(0xffffffffu, v.x, o);
    v.y += __shfl_xor_sync(0xffffffffu, v.y, o);
  }
  __syncthreads();
  return v;
}

// The last cluster barrier of an on-chip kernel, split: each CTA arrives
// once it has read the other CTAs' slots, stores its outputs, and waits at
// its end, so that no CTA exits (freeing its slots) while another may still
// read them, and the stores overlap the barrier.
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
}

// K1 on chip: the CTA's chunk of the row (chunk_bounds) in registers, LOADS
// vectors of VEC elements a thread, then mean, rsig and y as the header says,
// in the arithmetic order of the streaming variant. Rank 0's thread 0 writes
// (mean, rsig) when mean_out is not null.
template <typename T, int VEC, int LOADS>
__global__ void __launch_bounds__(kThreads)
instance_norm_fwd_onchip_kernel(const T* __restrict__ x, const float* __restrict__ scale,
                                const float* __restrict__ shift, T* __restrict__ y,
                                float* __restrict__ mean_out, float* __restrict__ rsig_out,
                                int64_t row_len, float eps, int act, int ctas) {
  __shared__ float smem[kWarps];
  __shared__ float partial[2];
  const int rank = static_cast<int>(blockIdx.x % ctas);
  const int64_t row = blockIdx.x / ctas;
  const T* xr = x + row * row_len;
  T* yr = y + row * row_len;
  int64_t lo, hi;
  chunk_bounds(row_len / VEC, rank, ctas, &lo, &hi);
  const int64_t i0 = lo + threadIdx.x;
  Pack<T, VEC> p[LOADS];
#pragma unroll
  for (int u = 0; u < LOADS; ++u) {
    if (i0 + u * kThreads < hi) p[u] = load_pack<T, VEC>(xr + (i0 + u * kThreads) * VEC);
  }
  const float inv_len = 1.f / static_cast<float>(row_len);
  float acc = 0.f;
#pragma unroll
  for (int u = 0; u < LOADS; ++u) {
    if (i0 + u * kThreads < hi) {
#pragma unroll
      for (int e = 0; e < VEC; ++e) acc += p[u][e];
    }
  }
  const float mean = row_total(block_sum(acc, smem), ctas, &partial[0]) * inv_len;
  acc = 0.f;
#pragma unroll
  for (int u = 0; u < LOADS; ++u) {
    if (i0 + u * kThreads < hi) {
#pragma unroll
      for (int e = 0; e < VEC; ++e) {
        const float d = p[u][e] - mean;
        acc += d * d;
      }
    }
  }
  const float rsig =
      rsqrtf(row_total(block_sum(acc, smem), ctas, &partial[1]) * inv_len + eps);
  if (ctas > 1) cluster_arrive();  // this CTA has read every rank's partial[1]
  if (mean_out != nullptr && rank == 0 && threadIdx.x == 0) {
    mean_out[row] = mean;
    rsig_out[row] = rsig;
  }
  const bool affine = scale != nullptr;
  const float s = affine ? scale[row] : 1.f;
  const float b = affine ? shift[row] : 0.f;
#pragma unroll
  for (int u = 0; u < LOADS; ++u) {
    if (i0 + u * kThreads < hi) {
      float v[VEC];
#pragma unroll
      for (int e = 0; e < VEC; ++e) {
        v[e] = (p[u][e] - mean) * rsig;
        if (affine) v[e] = v[e] * s + b;
        v[e] = activate(v[e], act);
      }
      store_pack<T, VEC>(yr + (i0 + u * kThreads) * VEC, v);
    }
  }
  if (ctas > 1) cluster_wait();  // every rank has read this CTA's partial[1]
}

// K1 streaming: one CTA a row, x streamed three times with the plan's loads.
template <typename T, int VEC>
__global__ void __launch_bounds__(kThreads)
instance_norm_fwd_kernel(const T* __restrict__ x, const float* __restrict__ scale,
                         const float* __restrict__ shift, T* __restrict__ y,
                         float* __restrict__ mean_out, float* __restrict__ rsig_out,
                         int64_t row_len, float eps, int act) {
  __shared__ float smem[kWarps];
  const int64_t row = blockIdx.x;
  const T* xr = x + row * row_len;
  T* yr = y + row * row_len;
  const int64_t n_vec = row_len / VEC;
  const float inv_len = 1.f / static_cast<float>(row_len);

  float acc = 0.f;
#pragma unroll 4
  for (int64_t i = threadIdx.x; i < n_vec; i += kThreads) {
    const Pack<T, VEC> p = load_pack<T, VEC>(xr + i * VEC);
#pragma unroll
    for (int e = 0; e < VEC; ++e) acc += p[e];
  }
  const float mean = block_sum(acc, smem) * inv_len;

  acc = 0.f;
#pragma unroll 4
  for (int64_t i = threadIdx.x; i < n_vec; i += kThreads) {
    const Pack<T, VEC> p = load_pack<T, VEC>(xr + i * VEC);
#pragma unroll
    for (int e = 0; e < VEC; ++e) {
      const float d = p[e] - mean;
      acc += d * d;
    }
  }
  const float rsig = rsqrtf(block_sum(acc, smem) * inv_len + eps);
  if (mean_out != nullptr && threadIdx.x == 0) {
    mean_out[row] = mean;
    rsig_out[row] = rsig;
  }

  const bool affine = scale != nullptr;
  const float s = affine ? scale[row] : 1.f;
  const float b = affine ? shift[row] : 0.f;
#pragma unroll 4
  for (int64_t i = threadIdx.x; i < n_vec; i += kThreads) {
    const Pack<T, VEC> p = load_pack<T, VEC>(xr + i * VEC);
    float v[VEC];
#pragma unroll
    for (int e = 0; e < VEC; ++e) {
      v[e] = (p[e] - mean) * rsig;
      if (affine) v[e] = v[e] * s + b;
      v[e] = activate(v[e], act);
    }
    store_pack<T, VEC>(yr + i * VEC, v);
  }
}

// K2 on chip: the CTA's chunk of x, y and dy in registers; dyp = dy gated
// from y, xhat = (x - mean[row]) * rsig[row], kept as two floats an element
// (fewer registers than the three inputs unpacked) for dx; the row's (sum
// dyp, sum dyp * xhat) over the CTA and the cluster; rank 0's thread 0
// writes dshift and dscale (when dscale is not null); dx = rsig * s * (dyp -
// sum dyp / n - xhat * sum(dyp * xhat) / n).
template <typename T, int VEC, int LOADS>
__global__ void __launch_bounds__(kThreads)
instance_norm_bwd_onchip_kernel(const T* __restrict__ x, const float* __restrict__ scale,
                                const T* __restrict__ y, const T* __restrict__ dy,
                                const float* __restrict__ mean, const float* __restrict__ rsig,
                                T* __restrict__ dx, float* __restrict__ dscale,
                                float* __restrict__ dshift, int64_t row_len, int act,
                                int ctas) {
  __shared__ float2 smem[kWarps];
  __shared__ float2 partial;
  const int rank = static_cast<int>(blockIdx.x % ctas);
  const int64_t row = blockIdx.x / ctas;
  const int64_t off = row * row_len;
  const T* xr = x + off;
  const T* yr = y + off;
  const T* dyr = dy + off;
  T* dxr = dx + off;
  int64_t lo, hi;
  chunk_bounds(row_len / VEC, rank, ctas, &lo, &hi);
  const int64_t i0 = lo + threadIdx.x;
  float g[LOADS][VEC], xh[LOADS][VEC];
  {
    Pack<T, VEC> px[LOADS], py[LOADS], pd[LOADS];
#pragma unroll
    for (int u = 0; u < LOADS; ++u) {
      const int64_t i = i0 + u * kThreads;
      if (i < hi) {
        px[u] = load_pack<T, VEC>(xr + i * VEC);
        py[u] = load_pack<T, VEC>(yr + i * VEC);
        pd[u] = load_pack<T, VEC>(dyr + i * VEC);
      }
    }
    const float m = mean[row];
    const float r = rsig[row];
#pragma unroll
    for (int u = 0; u < LOADS; ++u) {
#pragma unroll
      for (int e = 0; e < VEC; ++e) {
        g[u][e] = gate(pd[u][e], py[u][e], act);
        xh[u][e] = (px[u][e] - m) * r;
      }
    }
  }
  float2 acc = make_float2(0.f, 0.f);
#pragma unroll
  for (int u = 0; u < LOADS; ++u) {
    if (i0 + u * kThreads < hi) {
#pragma unroll
      for (int e = 0; e < VEC; ++e) {
        acc.x += g[u][e];
        acc.y += g[u][e] * xh[u][e];
      }
    }
  }
  const float2 t = row_total(block_sum2(acc, smem), ctas, &partial);
  if (ctas > 1) cluster_arrive();  // this CTA has read every rank's `partial`
  if (dscale != nullptr && rank == 0 && threadIdx.x == 0) {
    dscale[row] = t.y;
    dshift[row] = t.x;
  }
  const float inv_len = 1.f / static_cast<float>(row_len);
  const float m_dy = t.x * inv_len;
  const float m_dyx = t.y * inv_len;
  const float k = rsig[row] * (scale != nullptr ? scale[row] : 1.f);
#pragma unroll
  for (int u = 0; u < LOADS; ++u) {
    if (i0 + u * kThreads < hi) {
      float v[VEC];
#pragma unroll
      for (int e = 0; e < VEC; ++e) v[e] = k * (g[u][e] - m_dy - xh[u][e] * m_dyx);
      store_pack<T, VEC>(dxr + (i0 + u * kThreads) * VEC, v);
    }
  }
  if (ctas > 1) cluster_wait();  // every rank has read this CTA's `partial`
}

// K2 streaming: one CTA a row; x, y and dy streamed twice with the plan's
// loads (the two sums, then dx), the statistics read as on chip.
template <typename T, int VEC>
__global__ void __launch_bounds__(kThreads)
instance_norm_bwd_kernel(const T* __restrict__ x, const float* __restrict__ scale,
                         const T* __restrict__ y, const T* __restrict__ dy,
                         const float* __restrict__ mean, const float* __restrict__ rsig,
                         T* __restrict__ dx, float* __restrict__ dscale,
                         float* __restrict__ dshift, int64_t row_len, int act) {
  __shared__ float2 smem[kWarps];
  const int64_t row = blockIdx.x;
  const int64_t off = row * row_len;
  const T* xr = x + off;
  const T* yr = y + off;
  const T* dyr = dy + off;
  T* dxr = dx + off;
  const int64_t n_vec = row_len / VEC;
  const float m = mean[row];
  const float r = rsig[row];

  float2 acc = make_float2(0.f, 0.f);
#pragma unroll 4
  for (int64_t i = threadIdx.x; i < n_vec; i += kThreads) {
    const Pack<T, VEC> px = load_pack<T, VEC>(xr + i * VEC);
    const Pack<T, VEC> py = load_pack<T, VEC>(yr + i * VEC);
    const Pack<T, VEC> pd = load_pack<T, VEC>(dyr + i * VEC);
#pragma unroll
    for (int e = 0; e < VEC; ++e) {
      const float g = gate(pd[e], py[e], act);
      acc.x += g;
      acc.y += g * ((px[e] - m) * r);
    }
  }
  const float2 t = block_sum2(acc, smem);
  if (dscale != nullptr && threadIdx.x == 0) {
    dscale[row] = t.y;
    dshift[row] = t.x;
  }

  const float inv_len = 1.f / static_cast<float>(row_len);
  const float m_dy = t.x * inv_len;
  const float m_dyx = t.y * inv_len;
  const float k = r * (scale != nullptr ? scale[row] : 1.f);
#pragma unroll 4
  for (int64_t i = threadIdx.x; i < n_vec; i += kThreads) {
    const Pack<T, VEC> px = load_pack<T, VEC>(xr + i * VEC);
    const Pack<T, VEC> py = load_pack<T, VEC>(yr + i * VEC);
    const Pack<T, VEC> pd = load_pack<T, VEC>(dyr + i * VEC);
    float v[VEC];
#pragma unroll
    for (int e = 0; e < VEC; ++e) {
      const float g = gate(pd[e], py[e], act);
      const float xhat = (px[e] - m) * r;
      v[e] = k * (g - m_dy - xhat * m_dyx);
    }
    store_pack<T, VEC>(dxr + i * VEC, v);
  }
}

// A load of vec elements of T: vec a power of two within 16 bytes that
// divides the row length, every base aligned to it.
template <typename T>
bool load_ok(std::initializer_list<const void*> bases, long long row_len, int vec) {
  if (vec < 1 || (vec & (vec - 1)) || vec * sizeof(T) > 16 || row_len % vec) return false;
  for (const void* p : bases)
    if (reinterpret_cast<uintptr_t>(p) % (vec * sizeof(T))) return false;
  return true;
}

// K1m's and K2m's launch: the plan (ctas_per_row, vec) comes from
// `ops/kernels/instance_norm.py::_split_plan`. A plan the kernels cannot run
// (ctas not 1, 2, 4 or 8; a load load_ok refuses; more than 2^31 - 1 CTAs)
// returns cudaErrorInvalidValue and launches nothing.
template <typename T>
bool plan_ok(std::initializer_list<const void*> bases, long long rows, long long row_len,
             int ctas, int vec) {
  if (ctas != 1 && ctas != 2 && ctas != 4 && ctas != 8) return false;
  return rows * ctas <= INT_MAX && load_ok<T>(bases, row_len, vec);
}

// K1a's and K2a's launch: the plan (chunks_per_row, vec) comes from
// `_apply_plan`. A plan they cannot run (fewer than 1 chunk; a load load_ok
// refuses; more than 2^31 - 1 CTAs) returns cudaErrorInvalidValue and
// launches nothing.
template <typename T>
bool apply_plan_ok(std::initializer_list<const void*> bases, long long rows,
                   long long row_len, int chunks, int vec) {
  return chunks >= 1 && rows * chunks <= INT_MAX && load_ok<T>(bases, row_len, vec);
}

// rows * ctas CTAs of kThreads threads on `st`, in clusters of ctas along x
// when ctas > 1; returns the launch's error or cudaGetLastError().
template <typename... Params, typename... Args>
int launch_split(void (*kernel)(Params...), long long rows, int ctas, cudaStream_t st,
                 Args... args) {
  cudaLaunchAttribute cluster;
  cluster.id = cudaLaunchAttributeClusterDimension;
  cluster.val.clusterDim.x = static_cast<unsigned>(ctas);
  cluster.val.clusterDim.y = 1;
  cluster.val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(rows * ctas));
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = st;
  cfg.attrs = &cluster;
  cfg.numAttrs = ctas > 1 ? 1 : 0;
  const cudaError_t err = cudaLaunchKernelEx(&cfg, kernel, args...);
  return static_cast<int>(err != cudaSuccess ? err : cudaGetLastError());
}

template <typename T>
int row_moments(const void* x, float* out, long long rows, long long row_len, int ctas,
                int vec, cudaStream_t st) {
  if (!plan_ok<T>({x}, rows, row_len, ctas, vec)) return static_cast<int>(cudaErrorInvalidValue);
  const T* xp = static_cast<const T*>(x);
  const int64_t n = row_len;
  switch (vec) {
    case 1: return launch_split(row_moments_kernel<T, 1>, rows, ctas, st, xp, out, n, ctas);
    case 2: return launch_split(row_moments_kernel<T, 2>, rows, ctas, st, xp, out, n, ctas);
    case 4: return launch_split(row_moments_kernel<T, 4>, rows, ctas, st, xp, out, n, ctas);
    default:
      if constexpr (sizeof(T) == 2)
        return launch_split(row_moments_kernel<T, 8>, rows, ctas, st, xp, out, n, ctas);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

template <typename T>
int bwd_row_sums(const void* x, const void* y, const void* dy, const float* mean,
                 const float* rsig, float* out, long long rows, long long row_len, int act,
                 int ctas, int vec, cudaStream_t st) {
  if (!plan_ok<T>({x, y, dy}, rows, row_len, ctas, vec))
    return static_cast<int>(cudaErrorInvalidValue);
  const T* xp = static_cast<const T*>(x);
  const T* yp = static_cast<const T*>(y);
  const T* dyp = static_cast<const T*>(dy);
  const int64_t n = row_len;
#define ACLGAN_SUMS(V)                                                                  \
  launch_split(bwd_row_sums_kernel<T, V>, rows, ctas, st, xp, yp, dyp, mean, rsig, out, \
               n, act, ctas)
  switch (vec) {
    case 1: return ACLGAN_SUMS(1);
    case 2: return ACLGAN_SUMS(2);
    case 4: return ACLGAN_SUMS(4);
    default:
      if constexpr (sizeof(T) == 2) return ACLGAN_SUMS(8);
  }
#undef ACLGAN_SUMS
  return static_cast<int>(cudaErrorInvalidValue);
}

// rows * chunks CTAs of kThreads threads on `st`; returns cudaGetLastError().
template <typename... Params, typename... Args>
int launch_apply(void (*kernel)(Params...), long long rows, int chunks, cudaStream_t st,
                 Args... args) {
  kernel<<<static_cast<unsigned>(rows * chunks), kThreads, 0, st>>>(args...);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int run_apply(const void* x, const float* moments, const float* scale, const float* shift,
          void* y, float* mean, float* rsig, long long rows, long long row_len, float n,
          float eps, int act, int chunks, int vec, cudaStream_t st) {
  if (!apply_plan_ok<T>({x, y}, rows, row_len, chunks, vec))
    return static_cast<int>(cudaErrorInvalidValue);
  const T* xp = static_cast<const T*>(x);
  T* yp = static_cast<T*>(y);
  const int64_t len = row_len;
#define ACLGAN_APPLY(V)                                                                  \
  launch_apply(apply_kernel<T, V>, rows, chunks, st, xp, moments, scale, shift, yp, mean, \
               rsig, len, n, eps, act, chunks)
  switch (vec) {
    case 1: return ACLGAN_APPLY(1);
    case 2: return ACLGAN_APPLY(2);
    case 4: return ACLGAN_APPLY(4);
    default:
      if constexpr (sizeof(T) == 2) return ACLGAN_APPLY(8);
  }
#undef ACLGAN_APPLY
  return static_cast<int>(cudaErrorInvalidValue);
}

template <typename T>
int run_bwd_apply(const void* x, const void* y, const void* dy, const float* mean,
              const float* rsig, const float* scale, const float* sums, void* dx,
              long long rows, long long row_len, float inv_n, int act, int chunks, int vec,
              cudaStream_t st) {
  if (!apply_plan_ok<T>({x, y, dy, dx}, rows, row_len, chunks, vec))
    return static_cast<int>(cudaErrorInvalidValue);
  const T* xp = static_cast<const T*>(x);
  const T* yp = static_cast<const T*>(y);
  const T* dyp = static_cast<const T*>(dy);
  T* dxp = static_cast<T*>(dx);
  const int64_t len = row_len;
#define ACLGAN_BWD_APPLY(V)                                                             \
  launch_apply(bwd_apply_kernel<T, V>, rows, chunks, st, xp, yp, dyp, mean, rsig, scale, \
               sums, dxp, len, inv_n, act, chunks)
  switch (vec) {
    case 1: return ACLGAN_BWD_APPLY(1);
    case 2: return ACLGAN_BWD_APPLY(2);
    case 4: return ACLGAN_BWD_APPLY(4);
    default:
      if constexpr (sizeof(T) == 2) return ACLGAN_BWD_APPLY(8);
  }
#undef ACLGAN_BWD_APPLY
  return static_cast<int>(cudaErrorInvalidValue);
}

// K1's and K2's launch: the plan (ctas_per_row, vec, on_chip) comes from
// `ops/kernels/instance_norm.py::_fused_plan`. A plan they cannot run (a
// load load_ok refuses; more than 2^31 - 1 CTAs; on chip: ctas not 1, 2, 4
// or 8, or a chunk larger than the CTA's threads hold; streaming: ctas not
// 1) returns cudaErrorInvalidValue and launches nothing.
template <typename T, int INPUTS>
bool fused_plan_ok(std::initializer_list<const void*> bases, long long rows,
                   long long row_len, int ctas, int vec, int on_chip) {
  if (!load_ok<T>(bases, row_len, vec) || rows * ctas > INT_MAX) return false;
  if (!on_chip) return ctas == 1;
  if (ctas != 1 && ctas != 2 && ctas != 4 && ctas != 8) return false;
  const long long per_cta = (row_len / vec + ctas - 1) / ctas;  // vectors
  return per_cta <= static_cast<long long>(kThreads) * (row_elems<T, INPUTS>() / vec);
}

// The on-chip kernels hold LOADS vectors a thread: row_elems / VEC, or half
// that where the chunk fits (a 4,096-element row on one CTA), so that a
// short row's CTA takes fewer registers and an SM holds more of them.
template <typename T, int INPUTS, int VEC>
constexpr int max_loads() {
  return row_elems<T, INPUTS>() / VEC;
}

template <typename T, int VEC>
int launch_fwd(const T* x, const float* scale, const float* shift, T* y, float* mean,
               float* rsig, long long rows, int64_t row_len, float eps, int act, int ctas,
               int on_chip, cudaStream_t st) {
  constexpr int kMax = max_loads<T, 1, VEC>();
  if (!on_chip)
    return launch_apply(instance_norm_fwd_kernel<T, VEC>, rows, 1, st, x, scale, shift, y,
                        mean, rsig, row_len, eps, act);
  if ((row_len / VEC + ctas - 1) / ctas <= static_cast<int64_t>(kThreads) * (kMax / 2))
    return launch_split(instance_norm_fwd_onchip_kernel<T, VEC, kMax / 2>, rows, ctas, st, x,
                        scale, shift, y, mean, rsig, row_len, eps, act, ctas);
  return launch_split(instance_norm_fwd_onchip_kernel<T, VEC, kMax>, rows, ctas, st, x,
                      scale, shift, y, mean, rsig, row_len, eps, act, ctas);
}

template <typename T, int VEC>
int launch_bwd(const T* x, const float* scale, const T* y, const T* dy, const float* mean,
               const float* rsig, T* dx, float* dscale, float* dshift, long long rows,
               int64_t row_len, int act, int ctas, int on_chip, cudaStream_t st) {
  constexpr int kMax = max_loads<T, 3, VEC>();
  if (!on_chip)
    return launch_apply(instance_norm_bwd_kernel<T, VEC>, rows, 1, st, x, scale, y, dy, mean,
                        rsig, dx, dscale, dshift, row_len, act);
  if ((row_len / VEC + ctas - 1) / ctas <= static_cast<int64_t>(kThreads) * (kMax / 2))
    return launch_split(instance_norm_bwd_onchip_kernel<T, VEC, kMax / 2>, rows, ctas, st, x,
                        scale, y, dy, mean, rsig, dx, dscale, dshift, row_len, act, ctas);
  return launch_split(instance_norm_bwd_onchip_kernel<T, VEC, kMax>, rows, ctas, st, x, scale,
                      y, dy, mean, rsig, dx, dscale, dshift, row_len, act, ctas);
}

template <typename T>
int run_fwd(const void* x, const float* scale, const float* shift, void* y, float* mean,
            float* rsig, long long rows, long long row_len, float eps, int act, int ctas,
            int vec, int on_chip, cudaStream_t st) {
  if (!fused_plan_ok<T, 1>({x, y}, rows, row_len, ctas, vec, on_chip) ||
      (mean == nullptr) != (rsig == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const T* xp = static_cast<const T*>(x);
  T* yp = static_cast<T*>(y);
  const int64_t len = row_len;
#define ACLGAN_FWD(V) \
  launch_fwd<T, V>(xp, scale, shift, yp, mean, rsig, rows, len, eps, act, ctas, on_chip, st)
  switch (vec) {
    case 1: return ACLGAN_FWD(1);
    case 2: return ACLGAN_FWD(2);
    case 4: return ACLGAN_FWD(4);
    default:
      if constexpr (sizeof(T) == 2) return ACLGAN_FWD(8);
  }
#undef ACLGAN_FWD
  return static_cast<int>(cudaErrorInvalidValue);
}

template <typename T>
int run_bwd(const void* x, const float* scale, const void* y, const void* dy,
            const float* mean, const float* rsig, void* dx, float* dscale, float* dshift,
            long long rows, long long row_len, int act, int ctas, int vec, int on_chip,
            cudaStream_t st) {
  if (!fused_plan_ok<T, 3>({x, y, dy, dx}, rows, row_len, ctas, vec, on_chip) ||
      mean == nullptr || rsig == nullptr || (dscale == nullptr) != (dshift == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const T* xp = static_cast<const T*>(x);
  const T* yp = static_cast<const T*>(y);
  const T* dyp = static_cast<const T*>(dy);
  T* dxp = static_cast<T*>(dx);
  const int64_t len = row_len;
#define ACLGAN_BWD(V)                                                                      \
  launch_bwd<T, V>(xp, scale, yp, dyp, mean, rsig, dxp, dscale, dshift, rows, len, act, ctas, \
                   on_chip, st)
  switch (vec) {
    case 1: return ACLGAN_BWD(1);
    case 2: return ACLGAN_BWD(2);
    case 4: return ACLGAN_BWD(4);
    default:
      if constexpr (sizeof(T) == 2) return ACLGAN_BWD(8);
  }
#undef ACLGAN_BWD
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. scale/shift: both null (IN) or both
// (rows,) f32 (AdaIN). mean/rsig: both null (the no-grad op) or both (rows,)
// f32 outputs, each row's statistics. The plan (ctas_per_row, vec, on_chip)
// as `_fused_plan` gives it. Launches on `stream`; returns the launch's error
// or cudaGetLastError().
extern "C" int aclgan_instance_norm_fwd(const void* x, const float* scale,
                                        const float* shift, void* y, float* mean,
                                        float* rsig, long long rows, long long row_len,
                                        int dtype, int act, float eps, int ctas_per_row,
                                        int vec, int on_chip, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return run_fwd<float>(x, scale, shift, y, mean, rsig, rows, row_len, eps, act,
                          ctas_per_row, vec, on_chip, st);
  if (dtype == 1)
    return run_fwd<__nv_bfloat16>(x, scale, shift, y, mean, rsig, rows, row_len, eps, act,
                                  ctas_per_row, vec, on_chip, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

// dtype, act and the plan as for the forward; x, y, dy and dx share one
// layout. scale: null (IN: s = 1) or (rows,) f32. mean, rsig: (rows,) f32,
// the forward's. dscale/dshift: both null (no affine: nothing is summed out)
// or both (rows,) f32 outputs, every row written.
extern "C" int aclgan_instance_norm_bwd(const void* x, const float* scale, const void* y,
                                        const void* dy, const float* mean,
                                        const float* rsig, void* dx, float* dscale,
                                        float* dshift, long long rows, long long row_len,
                                        int dtype, int act, int ctas_per_row, int vec,
                                        int on_chip, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return run_bwd<float>(x, scale, y, dy, mean, rsig, dx, dscale, dshift, rows, row_len,
                          act, ctas_per_row, vec, on_chip, st);
  if (dtype == 1)
    return run_bwd<__nv_bfloat16>(x, scale, y, dy, mean, rsig, dx, dscale, dshift, rows,
                                  row_len, act, ctas_per_row, vec, on_chip, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

// The split form's four entry points. dtype, act and the layout as above;
// mean, rsig (rows,) f32; moments, out and sums (rows, 2) f32; scale/shift
// null or (rows,) f32. K1m and K2m write every row of `out` and take the
// launch plan (ctas_per_row, vec); K1a and K2a take theirs as
// (chunks_per_row, vec). K1a takes n = the row's global length and writes y,
// mean and rsig; K2a takes inv_n = 1 / n.
extern "C" int aclgan_instance_norm_row_moments(const void* x, float* out, long long rows,
                                                long long row_len, int dtype,
                                                int ctas_per_row, int vec, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return row_moments<float>(x, out, rows, row_len, ctas_per_row, vec, st);
  if (dtype == 1)
    return row_moments<__nv_bfloat16>(x, out, rows, row_len, ctas_per_row, vec, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" int aclgan_instance_norm_apply(const void* x, const float* moments,
                                          const float* scale, const float* shift, void* y,
                                          float* mean, float* rsig, long long rows,
                                          long long row_len, long long n, float eps,
                                          int dtype, int act, int chunks_per_row, int vec,
                                          void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float nf = static_cast<float>(n);  // as torch divides an f32 tensor by an int
  if (dtype == 0)
    return run_apply<float>(x, moments, scale, shift, y, mean, rsig, rows, row_len, nf, eps,
                            act, chunks_per_row, vec, st);
  if (dtype == 1)
    return run_apply<__nv_bfloat16>(x, moments, scale, shift, y, mean, rsig, rows, row_len,
                                    nf, eps, act, chunks_per_row, vec, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" int aclgan_instance_norm_bwd_row_sums(const void* x, const void* y,
                                                 const void* dy, const float* mean,
                                                 const float* rsig, float* out,
                                                 long long rows, long long row_len,
                                                 int dtype, int act, int ctas_per_row,
                                                 int vec, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return bwd_row_sums<float>(x, y, dy, mean, rsig, out, rows, row_len, act,
                               ctas_per_row, vec, st);
  if (dtype == 1)
    return bwd_row_sums<__nv_bfloat16>(x, y, dy, mean, rsig, out, rows, row_len, act,
                                       ctas_per_row, vec, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" int aclgan_instance_norm_bwd_apply(const void* x, const void* y, const void* dy,
                                              const float* mean, const float* rsig,
                                              const float* scale, const float* sums,
                                              void* dx, long long rows, long long row_len,
                                              float inv_n, int dtype, int act,
                                              int chunks_per_row, int vec, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return run_bwd_apply<float>(x, y, dy, mean, rsig, scale, sums, dx, rows, row_len, inv_n,
                                act, chunks_per_row, vec, st);
  if (dtype == 1)
    return run_bwd_apply<__nv_bfloat16>(x, y, dy, mean, rsig, scale, sums, dx, rows,
                                        row_len, inv_n, act, chunks_per_row, vec, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" const char* aclgan_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
