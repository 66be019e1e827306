// LayerNorm over the last dimension, forward and backward, reading and
// writing the compute dtype with fp32 statistics.
//
// Replaces no TPU kernel: the JAX package leaves flax's LayerNorm to XLA,
// which fuses it with the casts around it. Eager PyTorch does not, so the
// port's plain chain (cast the input to fp32, widen γ and β, ATen's fp32
// LayerNorm, cast the output back) moved ≈ 20 bytes an element for the 4
// that the work needs (read bf16, write bf16), and its backward saved the
// fp32 copy of the input. These kernels compute the same function at the
// same precision: x and γ, β are read in their stored dtypes (bf16 or fp32)
// and widened in registers, μ and σ² are two passes over the row held in
// registers (not E[x²] − E[x]²), y = (x − μ)·rstd·γ + β in fp32 is rounded
// once to the output dtype, and μ, rstd (fp32, one pair a row) are kept for
// the backward, which reads x in its own dtype.
//
// What bounds them on an H100: bytes (a handful of FLOP an element, far
// below the ≈ 295 FLOP a byte where the tensor cores would be the limit).
// So each element is read and written once: a row lives in the registers
// of one warp (32 lanes × 4 vectors of 8 elements, up to 1024 wide) or of a
// few warps of one block, each lane on 16-byte vectors with neighbouring
// lanes on neighbouring addresses; a block holds 8 warps, several rows.
//
// layer_norm_fwd_kernel: one row a row group (blockDim.y warps), the row's
// sum and then its centred sum of squares reduced by shuffles (and through
// shared memory across the group's warps, in a fixed order).
//
// layer_norm_bwd_dx_kernel: dx = rstd·(g − mean(g) − x̂·mean(g·x̂)) with
// g = dy·γ and x̂ = (x − μ)·rstd, in fp32, rounded once to x's dtype. Where
// γ or β needs its gradient, the grid is persistent (as many blocks as are
// resident, each walking the row groups blockIdx.x, blockIdx.x + grid, …)
// and each lane accumulates dγ = Σ dy·x̂ and dβ = Σ dy for its columns in
// registers; the block sums its row groups' partials in shared memory in a
// fixed order and writes one partial row. layer_norm_bwd_dgamma_kernel sums
// the partial rows, also in a fixed order: no float atomics, so two runs
// give the same bits.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "vec8.cuh"

namespace {

using ste::bf16;
using ste::kVec;
using ste::load8;
using ste::store8;

constexpr int kFwdVecs = 4;        // vectors a lane holds in the forward
constexpr int kBwdVecs = 2;        // and in the backward (beside 2 accumulators)
constexpr int kBlockWarps = 8;
constexpr int kMaxWidth = 4096;
constexpr int kBwdBlocksPerSm = 2;
constexpr int kSumRows = 16;       // row slices of the partial sum kernel

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// The sum of `v` over the row group of this thread (blockDim.y warps of
// one row, threadIdx.z the row); every lane of the group gets it. `red`
// holds kBlockWarps floats and is not reused before a block barrier.
__device__ __forceinline__ float row_sum(float v, float* red) {
  v = warp_sum(v);
  const int wpr = blockDim.y;
  if (wpr == 1) return v;
  const int base = threadIdx.z * wpr;
  if (threadIdx.x == 0) red[base + threadIdx.y] = v;
  __syncthreads();
  float s = 0.f;
  for (int w = 0; w < wpr; ++w) s += red[base + w];
  return s;
}

template <typename TIn, typename TOut, typename TW>
__global__ void __launch_bounds__(kBlockWarps * 32)
layer_norm_fwd_kernel(const TIn* __restrict__ x, const TW* __restrict__ gamma,
                      const TW* __restrict__ beta, TOut* __restrict__ y,
                      float* __restrict__ mean_out, float* __restrict__ rstd_out,
                      int rows, int width, float eps) {
  __shared__ float red[2][kBlockWarps];
  const int span = 32 * blockDim.y;                  // lanes a row
  const int t = threadIdx.x + 32 * threadIdx.y;      // lane in the row
  const int row = blockIdx.x * blockDim.z + threadIdx.z;
  const int nvec = width / kVec;
  const bool live = row < rows;
  const size_t off = static_cast<size_t>(live ? row : 0) * width;
  float v[kFwdVecs][kVec];
  float sum = 0.f;
#pragma unroll
  for (int k = 0; k < kFwdVecs; ++k) {
    const int c = t + k * span;
    if (live && c < nvec) {
      load8(x + off + c * kVec, v[k]);
    } else {
#pragma unroll
      for (int i = 0; i < kVec; ++i) v[k][i] = 0.f;
    }
#pragma unroll
    for (int i = 0; i < kVec; ++i) sum += v[k][i];
  }
  const float mean = row_sum(sum, red[0]) / width;
  float sq = 0.f;
#pragma unroll
  for (int k = 0; k < kFwdVecs; ++k) {
    if (t + k * span < nvec) {
#pragma unroll
      for (int i = 0; i < kVec; ++i) {
        const float d = v[k][i] - mean;
        sq += d * d;
      }
    }
  }
  const float rstd = 1.f / sqrtf(row_sum(sq, red[1]) / width + eps);
  if (!live) return;
#pragma unroll
  for (int k = 0; k < kFwdVecs; ++k) {
    const int c = t + k * span;
    if (c < nvec) {
      float g[kVec], b[kVec], o[kVec];
      load8(gamma + c * kVec, g);
      load8(beta + c * kVec, b);
#pragma unroll
      for (int i = 0; i < kVec; ++i) o[i] = (v[k][i] - mean) * rstd * g[i] + b[i];
      store8(y + off + c * kVec, o);
    }
  }
  if (t == 0) {
    mean_out[row] = mean;
    rstd_out[row] = rstd;
  }
}

// The block's sum of `acc` (each lane's columns) over its row groups, in
// order of threadIdx.z, through `cols` ([blockDim.z][width]), into `out`.
__device__ __forceinline__ void block_partial(const float (&acc)[kBwdVecs][kVec],
                                              float* cols, float* out, int width) {
  const int span = 32 * blockDim.y;
  const int t = threadIdx.x + 32 * threadIdx.y;
  const int nvec = width / kVec;
#pragma unroll
  for (int k = 0; k < kBwdVecs; ++k) {
    const int c = t + k * span;
    if (c < nvec) store8(cols + threadIdx.z * width + c * kVec, acc[k]);
  }
  __syncthreads();
  if (threadIdx.z == 0) {
#pragma unroll
    for (int k = 0; k < kBwdVecs; ++k) {
      const int c = t + k * span;
      if (c < nvec) {
        float s[kVec];
        load8(cols + c * kVec, s);
        for (int z = 1; z < blockDim.z; ++z) {
          float r[kVec];
          load8(cols + z * width + c * kVec, r);
#pragma unroll
          for (int i = 0; i < kVec; ++i) s[i] += r[i];
        }
        store8(out + c * kVec, s);
      }
    }
  }
  __syncthreads();
}

template <typename TIn, typename TOut, typename TW, bool kAffine>
__global__ void __launch_bounds__(kBlockWarps * 32, kBwdBlocksPerSm)
layer_norm_bwd_dx_kernel(const TOut* __restrict__ dy, const TIn* __restrict__ x,
                         const TW* __restrict__ gamma,
                         const float* __restrict__ mean,
                         const float* __restrict__ rstd, TIn* __restrict__ dx,
                         float* __restrict__ part, int rows, int width) {
  extern __shared__ __align__(16) float cols[];    // [blockDim.z][width]
  __shared__ float red[2][2][kBlockWarps];         // [parity][a, b][warp]
  const int span = 32 * blockDim.y;
  const int t = threadIdx.x + 32 * threadIdx.y;
  const int nvec = width / kVec;
  const float inv_n = 1.f / width;
  float acc_g[kBwdVecs][kVec], acc_b[kBwdVecs][kVec];
  if constexpr (kAffine) {
#pragma unroll
    for (int k = 0; k < kBwdVecs; ++k)
#pragma unroll
      for (int i = 0; i < kVec; ++i) acc_g[k][i] = acc_b[k][i] = 0.f;
  }
  int parity = 0;
  for (int first = blockIdx.x * blockDim.z; first < rows;
       first += gridDim.x * blockDim.z, parity ^= 1) {
    const int row = first + threadIdx.z;
    const bool live = row < rows;
    const size_t off = static_cast<size_t>(live ? row : 0) * width;
    const float mu = live ? mean[row] : 0.f;
    const float rs = live ? rstd[row] : 0.f;
    float xh[kBwdVecs][kVec], g[kBwdVecs][kVec];
    float a = 0.f, b = 0.f;
#pragma unroll
    for (int k = 0; k < kBwdVecs; ++k) {
      const int c = t + k * span;
      if (live && c < nvec) {
        float xv[kVec], dv[kVec], gv[kVec];
        load8(x + off + c * kVec, xv);
        load8(dy + off + c * kVec, dv);
        load8(gamma + c * kVec, gv);
#pragma unroll
        for (int i = 0; i < kVec; ++i) {
          xh[k][i] = (xv[i] - mu) * rs;
          g[k][i] = dv[i] * gv[i];
          a += g[k][i];
          b += g[k][i] * xh[k][i];
          if constexpr (kAffine) {
            acc_g[k][i] += dv[i] * xh[k][i];
            acc_b[k][i] += dv[i];
          }
        }
      } else {
#pragma unroll
        for (int i = 0; i < kVec; ++i) xh[k][i] = g[k][i] = 0.f;
      }
    }
    if (dx != nullptr) {
      const float ma = row_sum(a, red[parity][0]) * inv_n;
      const float mb = row_sum(b, red[parity][1]) * inv_n;
      if (live) {
#pragma unroll
        for (int k = 0; k < kBwdVecs; ++k) {
          const int c = t + k * span;
          if (c < nvec) {
            float o[kVec];
#pragma unroll
            for (int i = 0; i < kVec; ++i) o[i] = rs * (g[k][i] - ma - xh[k][i] * mb);
            store8(dx + off + c * kVec, o);
          }
        }
      }
    }
  }
  if constexpr (kAffine) {        // this block's partial dγ, then dβ
    block_partial(acc_g, cols, part + static_cast<size_t>(blockIdx.x) * width, width);
    block_partial(acc_b, cols,
                  part + (static_cast<size_t>(gridDim.x) + blockIdx.x) * width, width);
  }
}

// dγ (blockIdx.y 0) or dβ (1): the sum of `blocks` partial rows, column by
// column; a block of 32 columns × kSumRows slices, each slice summing the
// rows s, s + kSumRows, …, then the slices summed in order.
__global__ void __launch_bounds__(32 * kSumRows)
layer_norm_bwd_dgamma_kernel(const float* __restrict__ part, int blocks,
                             int width, float* __restrict__ dgamma,
                             float* __restrict__ dbeta) {
  __shared__ float slice[kSumRows][33];
  const int col = blockIdx.x * 32 + threadIdx.x;
  const float* p = part + static_cast<size_t>(blockIdx.y) * blocks * width;
  float s = 0.f;
  if (col < width)
    for (int r = threadIdx.y; r < blocks; r += kSumRows)
      s += p[static_cast<size_t>(r) * width + col];
  slice[threadIdx.y][threadIdx.x] = s;
  __syncthreads();
  if (threadIdx.y != 0 || col >= width) return;
  float total = 0.f;
  for (int r = 0; r < kSumRows; ++r) total += slice[r][threadIdx.x];
  (blockIdx.y == 0 ? dgamma : dbeta)[col] = total;
}

// warps a row: enough lanes that each holds at most `vecs` vectors
int warps_per_row(int width, int vecs) {
  const int per_warp = 32 * vecs * kVec;
  return (width + per_warp - 1) / per_warp;
}

dim3 row_block(int width, int vecs) {
  const int wpr = warps_per_row(width, vecs);
  return dim3(32, wpr, wpr >= kBlockWarps ? 1 : kBlockWarps / wpr);
}

bool bad_width(int width) {
  return width < kVec || width > kMaxWidth || width % kVec != 0;
}

struct FwdArgs {
  const void *x, *gamma, *beta;
  void* y;
  float *mean, *rstd;
  int rows, width;
  float eps;
  cudaStream_t stream;
};

struct BwdArgs {
  const void *dy, *x, *gamma;
  const float *mean, *rstd;
  void* dx;
  float *part, *dgamma, *dbeta;
  int rows, width, blocks;
  cudaStream_t stream;
};

template <typename TIn, typename TOut, typename TW>
struct Fwd {
  static int run(const FwdArgs& a) {
    const dim3 block = row_block(a.width, kFwdVecs);
    const int grid = (a.rows + block.z - 1) / block.z;
    layer_norm_fwd_kernel<TIn, TOut, TW><<<grid, block, 0, a.stream>>>(
        static_cast<const TIn*>(a.x), static_cast<const TW*>(a.gamma),
        static_cast<const TW*>(a.beta), static_cast<TOut*>(a.y), a.mean,
        a.rstd, a.rows, a.width, a.eps);
    return static_cast<int>(cudaGetLastError());
  }
};

template <typename TIn, typename TOut, typename TW>
struct Bwd {
  template <bool kAffine>
  static void launch(const BwdArgs& a, dim3 block, int grid, size_t smem) {
    layer_norm_bwd_dx_kernel<TIn, TOut, TW, kAffine><<<grid, block, smem, a.stream>>>(
        static_cast<const TOut*>(a.dy), static_cast<const TIn*>(a.x),
        static_cast<const TW*>(a.gamma), a.mean, a.rstd,
        static_cast<TIn*>(a.dx), a.part, a.rows, a.width);
  }

  static int run(const BwdArgs& a) {
    const dim3 block = row_block(a.width, kBwdVecs);
    const int groups = (a.rows + block.z - 1) / block.z;
    if (a.dgamma == nullptr) {
      launch<false>(a, block, groups, 0);
      return static_cast<int>(cudaGetLastError());
    }
    if (a.blocks < 1 || a.blocks > groups) return static_cast<int>(cudaErrorInvalidValue);
    launch<true>(a, block, a.blocks, sizeof(float) * block.z * a.width);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    layer_norm_bwd_dgamma_kernel<<<dim3((a.width + 31) / 32, 2), dim3(32, kSumRows), 0,
                                   a.stream>>>(a.part, a.blocks, a.width, a.dgamma,
                                               a.dbeta);
    return static_cast<int>(cudaGetLastError());
  }
};

// dtype codes: 0 float32, 1 bfloat16
template <template <class, class, class> class L, class A>
int dispatch(int in_dt, int out_dt, int w_dt, const A& a) {
  if (in_dt < 0 || in_dt > 1 || out_dt < 0 || out_dt > 1 || w_dt < 0 || w_dt > 1)
    return static_cast<int>(cudaErrorInvalidValue);
  switch (in_dt * 4 + out_dt * 2 + w_dt) {
    case 0: return L<float, float, float>::run(a);
    case 1: return L<float, float, bf16>::run(a);
    case 2: return L<float, bf16, float>::run(a);
    case 3: return L<float, bf16, bf16>::run(a);
    case 4: return L<bf16, float, float>::run(a);
    case 5: return L<bf16, float, bf16>::run(a);
    case 6: return L<bf16, bf16, float>::run(a);
    default: return L<bf16, bf16, bf16>::run(a);
  }
}

}  // namespace

// y, μ and rstd of `rows` contiguous rows of `width` (a multiple of 8, up
// to 4096), every pointer 16-byte aligned.
extern "C" int ste_layer_norm_fwd(const void* x, const void* gamma,
                                  const void* beta, void* y, float* mean,
                                  float* rstd, int rows, int width, float eps,
                                  int in_dtype, int out_dtype, int w_dtype,
                                  int device, void* stream) {
  if (rows < 1 || bad_width(width)) return static_cast<int>(cudaErrorInvalidValue);
  cudaSetDevice(device);
  const FwdArgs a{x, gamma, beta, y, mean, rstd, rows, width, eps,
                  static_cast<cudaStream_t>(stream)};
  return dispatch<Fwd>(in_dtype, out_dtype, w_dtype, a);
}

// dx (null: not wanted) and, where dgamma and dbeta are given, dγ and dβ in
// fp32 through `part` ([2, blocks, width] fp32 scratch) from `blocks`
// persistent blocks (ste_layer_norm_bwd_blocks).
extern "C" int ste_layer_norm_bwd(const void* dy, const void* x,
                                  const void* gamma, const float* mean,
                                  const float* rstd, void* dx, float* part,
                                  float* dgamma, float* dbeta, int rows,
                                  int width, int blocks, int in_dtype,
                                  int out_dtype, int w_dtype, int device,
                                  void* stream) {
  if (rows < 1 || bad_width(width) || (dgamma == nullptr) != (dbeta == nullptr) ||
      (dgamma != nullptr && part == nullptr) || (dx == nullptr && dgamma == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaSetDevice(device);
  const BwdArgs a{dy, x, gamma, mean, rstd, dx, part, dgamma, dbeta, rows, width,
                  blocks, static_cast<cudaStream_t>(stream)};
  return dispatch<Bwd>(in_dtype, out_dtype, w_dtype, a);
}

// The persistent backward's blocks for `rows` rows of `width`: one for
// each row group, at most kBwdBlocksPerSm a multiprocessor of `device`.
extern "C" int ste_layer_norm_bwd_blocks(int rows, int width, int device,
                                         int* blocks) {
  if (rows < 1 || bad_width(width)) return static_cast<int>(cudaErrorInvalidValue);
  int sms = 0;
  cudaError_t err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 block = row_block(width, kBwdVecs);
  const int groups = (rows + block.z - 1) / block.z;
  *blocks = groups < kBwdBlocksPerSm * sms ? groups : kBwdBlocksPerSm * sms;
  return 0;
}
