// Relative_key flash attention, backward (bf16 or fp32 in, fp32 accumulate).
//
// Replaces the Pallas TPU kernel
// speech_transcript_embeddings_tpu/ops/flash_attention.py::_bwd_kernel (:278).
// For each batch·head row, with q_s = q·scale rounded to q's dtype, the
// forward's lse, and dd[i] = rowsum(dO∘O)[i] (computed by the wrapper):
//
//   s[i, j]   = q_s[i]·k[j] + qE[i, c(j − i)]  (j < len),  NEG (j ≥ len)
//   p[i, j]   = exp(s[i, j] − lse[i])
//   ds[i, j]  = p[i, j]·(dO[i]·v[j] − dd[i])
//   dv[j]     = Σ_i round(p[i, j])·dO[i]
//   dk[j]     = Σ_i round(ds[i, j])·q_s[i]
//   dqE[i, c] = Σ_{j: c(j − i) = c} ds[i, j]      (fp32, padded keys included)
//   dq[i]     = round(round(Σ_j round(ds[i, j])·k[j] + Σ_c round(dqE[i, c])·E[c])
//                     · 1/√hd)
//   dE[c]     = Σ_rows Σ_i dqE[i, c]·q_s[i]
//
// with c(d) = clip(d, −L, R) + L and qE = q_s·Eᵀ rounded to q's dtype, as the
// TPU kernel rounds it. The keys t..t_pad−1 that the TPU kernel pads to (zero
// k and v) matter only in a clip with no valid frame: there lse = NEG (log
// t_pad vanishes beside 1e30 in fp32), p = 1 on every key, and each padded
// key adds ds = −dd[i] to dqE, as the TPU kernel's additive mask does.
//
// What bounds it on an H100: ≈7·T²·hd FMAs per row (two score products, the
// dq and dk/dv updates), run on the CUDA cores in fp32 in this version. The
// FlashAttention-2 split into two kernels means no block carries a sum and
// nothing needs atomics. Kernel A runs one block per (row, 64-query tile), one
// thread per query, and loops over the keys for dq and dqE; it also writes
// the tile's qE to a scratch buffer. Kernel B runs one block per (row, 64-key
// tile), one thread per key, loops over the queries for dk and dv, and reads
// qE from that buffer instead of computing it again. Both recompute p from
// lse. Each thread's accumulators (dq, or dk and dv) live in shared memory
// as float4 columns, and every product reads its shared-memory operand as a
// broadcast float4, so one shared-memory access feeds four FMAs. The bias
// gradient is indexed by c(j − i) into a shared-memory dqE column per thread
// — no one-hot selection matmuls and no rev∘shear∘rev roll, which were TPU
// workarounds. dE is a sum over every row and query: kernel A writes one
// [num_pos, hd] partial per block and the wrapper sums them (deterministic,
// no atomics). This CUDA-core pair serves fp32 inputs and head dims that are
// not a multiple of 16; bf16 inputs with hd a multiple of 16 (the
// conformer's hd 64) go to the tensor-core pair below.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "mma_bf16.cuh"

namespace {

constexpr int kBM = 64;      // queries (A) or keys (B) per block = threads
constexpr int kBN = 32;      // keys (A) or queries (B) per shared-memory tile
constexpr int kChunk = 16;   // of those, per register chunk
constexpr float kNeg = -1e30f;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) {
  return x;
}
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(
    float x) {
  return __float2bfloat16(x);
}
template <typename T> __device__ __forceinline__ float round_to(float x) {
  return to_f(from_f<T>(x));
}

template <int HDP>
__device__ __forceinline__ float dot_row(const float* a, const float* b) {
  const float4* b4 = reinterpret_cast<const float4*>(b);
  float a0 = 0.f, a1 = 0.f, a2 = 0.f, a3 = 0.f;
#pragma unroll
  for (int d4 = 0; d4 < HDP / 4; ++d4) {
    const float4 x = b4[d4];
    a0 = fmaf(a[4 * d4 + 0], x.x, a0);
    a1 = fmaf(a[4 * d4 + 1], x.y, a1);
    a2 = fmaf(a[4 * d4 + 2], x.z, a2);
    a3 = fmaf(a[4 * d4 + 3], x.w, a3);
  }
  return (a0 + a1) + (a2 + a3);
}

// ---- kernel A: dq, dqE, qE and the dE partials ----------------------------

// acc4[d4] += w · row[4·d4 .. 4·d4+3] for a thread's float4 accumulator column
// (acc4 points at this thread's first float4; columns are kBM float4 apart)
template <int HDP>
__device__ __forceinline__ void axpy_row(float4* acc4, const float* row,
                                         float w) {
  const float4* r4 = reinterpret_cast<const float4*>(row);
#pragma unroll 4
  for (int d4 = 0; d4 < HDP / 4; ++d4) {
    float4 a = acc4[d4 * kBM];
    const float4 x = r4[d4];
    a.x = fmaf(w, x.x, a.x);
    a.y = fmaf(w, x.y, a.y);
    a.z = fmaf(w, x.z, a.z);
    a.w = fmaf(w, x.w, a.w);
    acc4[d4 * kBM] = a;
  }
}

// acc4[d4] += Σ_c w[c] · rows[c][4·d4 ..] over a chunk of kChunk rows
template <int HDP>
__device__ __forceinline__ void axpy_chunk(float4* acc4, const float* rows,
                                           const float* w) {
#pragma unroll 2
  for (int d4 = 0; d4 < HDP / 4; ++d4) {
    float4 a = acc4[d4 * kBM];
#pragma unroll
    for (int c = 0; c < kChunk; ++c) {
      const float4 x = reinterpret_cast<const float4*>(rows + c * HDP)[d4];
      a.x = fmaf(w[c], x.x, a.x);
      a.y = fmaf(w[c], x.y, a.y);
      a.z = fmaf(w[c], x.z, a.z);
      a.w = fmaf(w[c], x.w, a.w);
    }
    acc4[d4 * kBM] = a;
  }
}

template <typename T, int HDP>
__global__ void __launch_bounds__(kBM)
flash_rel_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v, const T* __restrict__ e,
                        const int* __restrict__ lengths,
                        const T* __restrict__ dout,
                        const float* __restrict__ lse,
                        const float* __restrict__ dd, T* __restrict__ dq,
                        float* __restrict__ qe_out,
                        float* __restrict__ de_part, int t, int t_pad, int hd,
                        int num_pos, int left, int nh, float scale,
                        float dq_scale, int union_floats) {
  extern __shared__ __align__(16) float smem[];
  // union: the K/V tiles in the key loop, then E, then the q_s rows
  float* k_s = smem;                               // [kBN][HDP]
  float* v_s = k_s + kBN * HDP;                    // [kBN][HDP]
  float* e_s = smem;                               // [num_pos][HDP]
  float* q_sm = smem;                              // [kBM][HDP + 1]
  float4* dq4 = reinterpret_cast<float4*>(smem + union_floats);
                                                   // [HDP/4][kBM]
  float* qe_s = smem + union_floats + kBM * HDP;   // [num_pos][kBM]
  float* dqe_s = qe_s + num_pos * kBM;             // [num_pos][kBM]
  const int row = blockIdx.y;
  const int tid = threadIdx.x;
  const int i = blockIdx.x * kBM + tid;
  const bool valid = i < t;
  const int limit = lengths[row / nh];
  const int right = num_pos - 1 - left;
  const int64_t base = static_cast<int64_t>(row) * t * hd;

  float qr[HDP], dor[HDP];
#pragma unroll
  for (int d = 0; d < HDP; ++d) {
    const bool in = valid && d < hd;
    const int64_t off = base + static_cast<int64_t>(i) * hd + d;
    qr[d] = in ? round_to<T>(to_f(q[off]) * scale) : 0.0f;
    dor[d] = in ? to_f(dout[off]) : 0.0f;
  }
  const float lse_i = valid ? lse[static_cast<int64_t>(row) * t + i] : 0.0f;
  const float dd_i = valid ? dd[static_cast<int64_t>(row) * t + i] : 0.0f;
  float* qe_row = qe_out + (static_cast<int64_t>(row) * t + i) * num_pos;
  for (int p = 0; p < num_pos; ++p) {
    float acc = 0.0f;
#pragma unroll
    for (int d = 0; d < HDP; ++d)
      if (d < hd) acc = fmaf(qr[d], to_f(e[p * hd + d]), acc);
    qe_s[p * kBM + tid] = round_to<T>(acc);
    dqe_s[p * kBM + tid] = 0.0f;
    if (valid) qe_row[p] = round_to<T>(acc);
  }
  float4* my_dq = dq4 + tid;
  for (int d4 = 0; d4 < HDP / 4; ++d4)
    my_dq[d4 * kBM] = make_float4(0.f, 0.f, 0.f, 0.f);

  for (int j0 = 0; j0 < t; j0 += kBN) {
    __syncthreads();
    for (int idx = tid; idx < kBN * HDP; idx += kBM) {
      const int jj = idx / HDP, d = idx - jj * HDP;
      const int j = j0 + jj;
      const bool in = j < t && d < hd;
      const int64_t off = base + static_cast<int64_t>(j) * hd + d;
      k_s[idx] = in ? to_f(k[off]) : 0.0f;
      v_s[idx] = in ? to_f(v[off]) : 0.0f;
    }
    __syncthreads();
    const int jn = min(kBN, t - j0);
    for (int jc = 0; jc < jn; jc += kChunk) {
      float dsc[kChunk];
      bool any = false;
#pragma unroll
      for (int c = 0; c < kChunk; ++c) {
        dsc[c] = 0.0f;
        const int jj = jc + c, j = j0 + jj;
        if (!valid || jj >= jn) continue;
        const int dist = min(max(j - i, -left), right) + left;
        const float s = j >= limit
            ? kNeg
            : dot_row<HDP>(qr, k_s + jj * HDP) + qe_s[dist * kBM + tid];
        const float p = expf(s - lse_i);
        if (p == 0.0f) continue;
        const float ds = p * (dot_row<HDP>(dor, v_s + jj * HDP) - dd_i);
        dqe_s[dist * kBM + tid] += ds;
        dsc[c] = round_to<T>(ds);
        any = true;
      }
      if (any) axpy_chunk<HDP>(my_dq, k_s + jc * HDP, dsc);
    }
  }
  // the padded keys t..t_pad-1: zero k and v, so only dqE sees them, and
  // only in a row whose every key is masked (p = exp(NEG − lse) ≠ 0)
  if (valid) {
    const float p_pad = expf(kNeg - lse_i);
    if (p_pad != 0.0f) {
      const float ds = p_pad * (0.0f - dd_i);
      for (int j = t; j < t_pad; ++j)
        dqe_s[(min(max(j - i, -left), right) + left) * kBM + tid] += ds;
    }
  }
  __syncthreads();
  // dq += round(dqE)·E, then the 1/√hd scale
  for (int idx = tid; idx < num_pos * HDP; idx += kBM) {
    const int p = idx / HDP, d = idx - p * HDP;
    e_s[idx] = d < hd ? to_f(e[p * hd + d]) : 0.0f;
  }
  __syncthreads();
  for (int p = 0; p < num_pos; ++p)
    axpy_row<HDP>(my_dq, e_s + p * HDP, round_to<T>(dqe_s[p * kBM + tid]));
  if (valid) {
    for (int d4 = 0; d4 < HDP / 4; ++d4) {
      const float4 a = my_dq[d4 * kBM];
      const float w[4] = {a.x, a.y, a.z, a.w};
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int d = 4 * d4 + c;
        if (d < hd)
          dq[base + static_cast<int64_t>(i) * hd + d] =
              from_f<T>(round_to<T>(w[c]) * dq_scale);
      }
    }
  }
  __syncthreads();
  // dE partial of this block: Σ_i dqE[i, c]·q_s[i, d]
  float* q_row = q_sm + tid * (HDP + 1);
#pragma unroll
  for (int d = 0; d < HDP; ++d) q_row[d] = qr[d];
  __syncthreads();
  float* part = de_part +
      (static_cast<int64_t>(row) * gridDim.x + blockIdx.x) * num_pos * hd;
  for (int idx = tid; idx < num_pos * hd; idx += kBM) {
    const int p = idx / hd, d = idx - p * hd;
    float acc = 0.0f;
    for (int r = 0; r < kBM; ++r)
      acc = fmaf(dqe_s[p * kBM + r], q_sm[r * (HDP + 1) + d], acc);
    part[idx] = acc;
  }
}

// ---- kernel B: dk and dv ----------------------------------------------------

// a[d4] += w1·x1[4·d4 ..] and b[d4] += w2·x2[4·d4 ..] over a chunk of rows
template <int HDP>
__device__ __forceinline__ void axpy2_chunk(float4* a4, float4* b4,
                                            const float* xa, const float* xb,
                                            const float* wa, const float* wb) {
#pragma unroll 2
  for (int d4 = 0; d4 < HDP / 4; ++d4) {
    float4 a = a4[d4 * kBM], b = b4[d4 * kBM];
#pragma unroll
    for (int c = 0; c < kChunk; ++c) {
      const float4 x = reinterpret_cast<const float4*>(xa + c * HDP)[d4];
      const float4 y = reinterpret_cast<const float4*>(xb + c * HDP)[d4];
      a.x = fmaf(wa[c], x.x, a.x);
      a.y = fmaf(wa[c], x.y, a.y);
      a.z = fmaf(wa[c], x.z, a.z);
      a.w = fmaf(wa[c], x.w, a.w);
      b.x = fmaf(wb[c], y.x, b.x);
      b.y = fmaf(wb[c], y.y, b.y);
      b.z = fmaf(wb[c], y.z, b.z);
      b.w = fmaf(wb[c], y.w, b.w);
    }
    a4[d4 * kBM] = a;
    b4[d4 * kBM] = b;
  }
}

template <typename T, int HDP>
__global__ void __launch_bounds__(kBM)
flash_rel_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                         const T* __restrict__ v,
                         const int* __restrict__ lengths,
                         const T* __restrict__ dout,
                         const float* __restrict__ lse,
                         const float* __restrict__ dd,
                         const float* __restrict__ qe_in, T* __restrict__ dk,
                         T* __restrict__ dv, int t, int hd, int num_pos,
                         int left, int nh, float scale) {
  extern __shared__ __align__(16) float smem[];
  float* qs_s = smem;                              // [kBN][HDP]
  float* do_s = qs_s + kBN * HDP;                  // [kBN][HDP]
  float4* dk4 = reinterpret_cast<float4*>(do_s + kBN * HDP);  // [HDP/4][kBM]
  float4* dv4 = dk4 + (HDP / 4) * kBM;                         // [HDP/4][kBM]
  float* qe_t = reinterpret_cast<float*>(dv4 + (HDP / 4) * kBM);
                                                   // [kBN][num_pos]
  float* lse_s = qe_t + kBN * num_pos;             // [kBN]
  float* dd_s = lse_s + kBN;                       // [kBN]
  const int row = blockIdx.y;
  const int tid = threadIdx.x;
  const int j = blockIdx.x * kBM + tid;
  const bool valid = j < t;
  const int limit = lengths[row / nh];
  const int right = num_pos - 1 - left;
  const int64_t base = static_cast<int64_t>(row) * t * hd;

  float kr[HDP], vr[HDP];
#pragma unroll
  for (int d = 0; d < HDP; ++d) {
    const bool in = valid && d < hd;
    const int64_t off = base + static_cast<int64_t>(j) * hd + d;
    kr[d] = in ? to_f(k[off]) : 0.0f;
    vr[d] = in ? to_f(v[off]) : 0.0f;
  }
  float4* my_dk = dk4 + tid;
  float4* my_dv = dv4 + tid;
  for (int d4 = 0; d4 < HDP / 4; ++d4)
    my_dk[d4 * kBM] = my_dv[d4 * kBM] = make_float4(0.f, 0.f, 0.f, 0.f);

  for (int i0 = 0; i0 < t; i0 += kBN) {
    __syncthreads();
    for (int idx = tid; idx < kBN * HDP; idx += kBM) {
      const int ii = idx / HDP, d = idx - ii * HDP;
      const int i = i0 + ii;
      const bool in = i < t && d < hd;
      const int64_t off = base + static_cast<int64_t>(i) * hd + d;
      qs_s[idx] = in ? round_to<T>(to_f(q[off]) * scale) : 0.0f;
      do_s[idx] = in ? to_f(dout[off]) : 0.0f;
    }
    const int in_ = min(kBN, t - i0);
    // qE of this query tile, written by kernel A
    const float* qe_tile = qe_in + (static_cast<int64_t>(row) * t + i0) *
                                       num_pos;
    for (int idx = tid; idx < kBN * num_pos; idx += kBM)
      qe_t[idx] = idx < in_ * num_pos ? qe_tile[idx] : 0.0f;
    if (tid < kBN) {
      const int i = i0 + tid;
      lse_s[tid] = i < t ? lse[static_cast<int64_t>(row) * t + i] : 0.0f;
      dd_s[tid] = i < t ? dd[static_cast<int64_t>(row) * t + i] : 0.0f;
    }
    __syncthreads();
    for (int ic = 0; ic < in_; ic += kChunk) {
      float pc[kChunk], dsc[kChunk];
      bool any = false;
#pragma unroll
      for (int c = 0; c < kChunk; ++c) {
        pc[c] = dsc[c] = 0.0f;
        const int ii = ic + c, i = i0 + ii;
        if (!valid || ii >= in_) continue;
        const int dist = min(max(j - i, -left), right) + left;
        const float s = j >= limit
            ? kNeg
            : dot_row<HDP>(kr, qs_s + ii * HDP) + qe_t[ii * num_pos + dist];
        const float p = expf(s - lse_s[ii]);
        if (p == 0.0f) continue;
        const float ds = p * (dot_row<HDP>(vr, do_s + ii * HDP) - dd_s[ii]);
        pc[c] = round_to<T>(p);
        dsc[c] = round_to<T>(ds);
        any = true;
      }
      if (any)
        axpy2_chunk<HDP>(my_dv, my_dk, do_s + ic * HDP, qs_s + ic * HDP, pc,
                         dsc);
    }
  }
  if (valid) {
    for (int d4 = 0; d4 < HDP / 4; ++d4) {
      const float4 a = my_dk[d4 * kBM], b = my_dv[d4 * kBM];
      const float wk[4] = {a.x, a.y, a.z, a.w};
      const float wv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int d = 4 * d4 + c;
        if (d >= hd) continue;
        const int64_t off = base + static_cast<int64_t>(j) * hd + d;
        dk[off] = from_f<T>(wk[c]);
        dv[off] = from_f<T>(wv[c]);
      }
    }
  }
}

template <typename T, int HDP>
int launch(const void* q, const void* k, const void* v, const void* e,
           const int* lengths, const void* dout, const float* lse,
           const float* dd, void* dq, void* dk, void* dv, float* qe_buf,
           float* de_part, int bh, int t, int t_pad, int hd, int num_pos,
           int left, int nh, float scale, float dq_scale,
           cudaStream_t stream) {
  const int union_floats =
      max(max(2 * kBN * HDP, num_pos * HDP), kBM * (HDP + 1));
  const size_t smem_a =
      (union_floats + kBM * HDP + 2 * num_pos * kBM) * sizeof(float);
  const size_t smem_b = (2 * kBN * HDP + 2 * kBM * HDP + kBN * num_pos +
                         2 * kBN) * sizeof(float);
  auto ka = flash_rel_bwd_dq_kernel<T, HDP>;
  auto kb = flash_rel_bwd_dkv_kernel<T, HDP>;
  cudaError_t err = cudaFuncSetAttribute(
      ka, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem_a));
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaFuncSetAttribute(kb, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem_b));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((t + kBM - 1) / kBM, bh);
  const T* qt = static_cast<const T*>(q);
  const T* kt = static_cast<const T*>(k);
  const T* vt = static_cast<const T*>(v);
  const T* et = static_cast<const T*>(e);
  const T* dot = static_cast<const T*>(dout);
  ka<<<grid, kBM, smem_a, stream>>>(
      qt, kt, vt, et, lengths, dot, lse, dd, static_cast<T*>(dq), qe_buf,
      de_part, t, t_pad, hd, num_pos, left, nh, scale, dq_scale,
      union_floats);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  kb<<<grid, kBM, smem_b, stream>>>(
      qt, kt, vt, lengths, dot, lse, dd, qe_buf, static_cast<T*>(dk),
      static_cast<T*>(dv), t, hd, num_pos, left, nh, scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch_hd(const void* q, const void* k, const void* v, const void* e,
                const int* lengths, const void* dout, const float* lse,
                const float* dd, void* dq, void* dk, void* dv, float* qe_buf,
                float* de_part, int bh, int t, int t_pad, int hd, int num_pos,
                int left, int nh, float scale, float dq_scale,
                cudaStream_t s) {
#define STE_LAUNCH(HDP)                                                       \
  return launch<T, HDP>(q, k, v, e, lengths, dout, lse, dd, dq, dk, dv,       \
                        qe_buf, de_part, bh, t, t_pad, hd, num_pos, left, nh, \
                        scale, dq_scale, s)
  if (hd <= 16) STE_LAUNCH(16);
  if (hd <= 32) STE_LAUNCH(32);
  if (hd <= 64) STE_LAUNCH(64);
  STE_LAUNCH(128);
#undef STE_LAUNCH
}

// ---- bf16 on the tensor cores ----------------------------------------------
//
// The same gradients for bf16 inputs with hd a multiple of 16 (≤ 128), every
// tile product on the tensor cores (mma.sync.m16n8k16, bf16 in, fp32
// accumulate) with the rounding points above. What bounds it: ≈10·T²·hd FLOP
// per row (five T×T×hd products) against ≈T·hd·16 bytes, so compute. The
// FlashAttention-2 split stays: kernel A (4 warps, 16 queries each, per
// 64-query tile) streams K and V tiles through a two-stage cp.async ring
// and keeps dq in registers; kernel B (4 warps, 16 keys each, per 64-key
// tile) streams q_s, dO, qE, lse and dd tiles the same way and keeps dk and
// dv in registers. Each warp works on 64 columns at a time (32 for hd > 64,
// so that its score and dP tiles fit in registers). Scores are recomputed
// from lse.
//
// The relative bias by its band: a warp's tile whose every j − i ≤ −L
// adds the row constant qE[i, 0], one whose every j − i ≥ R adds
// qE[i, L + R]; only tiles that straddle the band index qE per element. In
// kernel A the bias gradient of an interior column c (0 < c < L + R) comes
// from exactly one key per query, so each lane adds its ds to dqE[i, c] in
// shared memory with no race; the two clipped columns take a per-lane sum
// in registers, reduced over the quad in a fixed order (deterministic, no
// atomics). dq += round(dqE)·E and the dE partial Σ_i dqE[i, c]·q_s[i] are
// tensor-core products too; the dE product splits fp32 dqE into a bf16 pair
// (hi + lo), which keeps ≈16 mantissa bits, so dE sees dqE unrounded as the
// twin does. Kernel A also writes q_s and qE (fp32, np_pad columns) to
// scratch for kernel B.

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kTile = 64;    // queries (A) or keys (B) per block and per tile

// copy a [64][np_pad] fp32 tile (global row stride np_pad) into shared
// memory, zero rows at or past `valid_rows`
__device__ __forceinline__ void f32_tile_to_smem(float* dst, const float* src,
                                                 int np_pad, int valid_rows,
                                                 int tid) {
  const int chunks = np_pad / 4;
  for (int idx = tid; idx < kTile * chunks; idx += kThreads) {
    const int r = idx / chunks, ch = idx - r * chunks;
    const bool ok = r < valid_rows;
    ste_mma::cp_async16(dst + r * np_pad + ch * 4,
                        src + (ok ? r : 0) * np_pad + ch * 4, ok);
  }
}

// A fragments of a warp's 16 rows: held in registers when they fit beside
// the accumulators (hd ≤ 64), else reloaded from shared memory per k-step
template <int HD>
struct RowFrags {
  static constexpr bool kHeld = HD <= 64;
  uint32_t f[kHeld ? HD / 16 : 1][4];
  const __nv_bfloat16* base;
  __device__ __forceinline__ void init(const __nv_bfloat16* b, int lane) {
    base = b;
    if (kHeld) {
#pragma unroll
      for (int kk = 0; kk < (kHeld ? HD / 16 : 1); ++kk)
        ste_mma::load_a(f[kk], b + kk * 16, HD + 8, lane);
    }
  }
  __device__ __forceinline__ const uint32_t* get(int kk, uint32_t* tmp,
                                                 int lane) const {
    if (kHeld) return f[kHeld ? kk : 0];
    ste_mma::load_a(tmp, base + kk * 16, HD + 8, lane);
    return tmp;
  }
};

template <int HD>
__global__ void __launch_bounds__(kThreads)
flash_rel_bwd_dq_mma_kernel(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
    const __nv_bfloat16* __restrict__ v, const __nv_bfloat16* __restrict__ e,
    const int* __restrict__ lengths, const __nv_bfloat16* __restrict__ dout,
    const float* __restrict__ lse, const float* __restrict__ dd,
    __nv_bfloat16* __restrict__ dq, __nv_bfloat16* __restrict__ qs_out,
    float* __restrict__ qe_out, float* __restrict__ de_part, int t, int t_pad,
    int num_pos, int np_pad, int left, int nh, float scale, float dq_scale) {
  using namespace ste_mma;
  constexpr int LD = HD + 8;
  // columns per warp step: 64 where the score and dP tiles fit in
  // registers beside the accumulators (hd ≤ 64), else 32
  constexpr int kCols = HD <= 64 ? 64 : 32;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* q_s = reinterpret_cast<__nv_bfloat16*>(smem_raw);  // [64][LD]
  __nv_bfloat16* do_s = q_s + kTile * LD;                          // [64][LD]
  __nv_bfloat16* e_s = do_s + kTile * LD;                     // [np_pad][LD]
  __nv_bfloat16* kv_s = e_s + np_pad * LD;              // [2][k, v][64][LD]
  float* qe_s = reinterpret_cast<float*>(kv_s + 4 * kTile * LD);
                                                            // [64][np_pad]
  float* dqe_s = qe_s + kTile * np_pad;                     // [64][np_pad]
  const int row = blockIdx.y;
  const int i0 = blockIdx.x * kTile;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, c4 = lane & 3;
  const int limit = lengths[row / nh];
  const int right = num_pos - 1 - left;
  const int lr = left + right;
  const int64_t base = static_cast<int64_t>(row) * t * HD;
  const int64_t row_t = static_cast<int64_t>(row) * t;
  const __nv_bfloat16* kb = k + base;
  const __nv_bfloat16* vb = v + base;
  // keys at or past the clip's length have p = exp(NEG − lse) = 0 unless
  // every key is masked (lse = NEG), so only such a clip walks them all
  const int n_tiles = ((limit > 0 ? limit : t) + kTile - 1) / kTile;

  auto load_kv = [&](int jt, int stage) {
    __nv_bfloat16* dst = kv_s + stage * 2 * kTile * LD;
    const int j0 = jt * kTile;
    tile_to_smem<kTile, HD, kThreads>(dst, kb + j0 * HD, t - j0, tid);
    tile_to_smem<kTile, HD, kThreads>(dst + kTile * LD, vb + j0 * HD, t - j0,
                                      tid);
  };
  load_kv(0, 0);
  cp_async_commit();

  // q_s = round(q·scale) (also to scratch for kernel B), dO, E, dqE = 0
  for (int idx = tid; idx < kTile * HD / 8; idx += kThreads) {
    const int r = idx / (HD / 8), d = (idx - r * (HD / 8)) * 8;
    const bool in = i0 + r < t;
    const int64_t off = base + (i0 + r) * HD + d;
    uint4 raw = make_uint4(0, 0, 0, 0), dor = make_uint4(0, 0, 0, 0);
    if (in) {
      raw = *reinterpret_cast<const uint4*>(q + off);
      dor = *reinterpret_cast<const uint4*>(dout + off);
    }
    __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&raw);
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const float2 f = __bfloat1622float2(h[u]);
      h[u] = __floats2bfloat162_rn(f.x * scale, f.y * scale);
    }
    *reinterpret_cast<uint4*>(q_s + r * LD + d) = raw;
    *reinterpret_cast<uint4*>(do_s + r * LD + d) = dor;
    if (in) *reinterpret_cast<uint4*>(qs_out + off) = raw;
  }
  for (int idx = tid; idx < np_pad * HD / 8; idx += kThreads) {
    const int p = idx / (HD / 8), d = (idx - p * (HD / 8)) * 8;
    uint4 raw = make_uint4(0, 0, 0, 0);
    if (p < num_pos) raw = *reinterpret_cast<const uint4*>(e + p * HD + d);
    *reinterpret_cast<uint4*>(e_s + p * LD + d) = raw;
  }
  for (int idx = tid; idx < kTile * np_pad; idx += kThreads)
    dqe_s[idx] = 0.0f;
  __syncthreads();

  const int wr = warp * 16;
  const int li[2] = {wr + g, wr + g + 8};
  const int qi[2] = {i0 + li[0], i0 + li[1]};
  RowFrags<HD> qf, df;
  qf.init(q_s + wr * LD, lane);
  df.init(do_s + wr * LD, lane);
  // qE rows of this warp, rounded to bf16 (fp32 in smem and scratch)
  for (int n0 = 0; n0 < np_pad; n0 += 16) {
    float acc[2][4] = {};
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk) {
      uint32_t tmp[4], b[4];
      const uint32_t* a = qf.get(kk, tmp, lane);
      load_b_nk(b, e_s + n0 * LD + kk * 16, LD, lane);
      mma(acc[0], a, b);
      mma(acc[1], a, b + 2);
    }
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int x = 0; x < 4; ++x) {
        const int r = x >> 1, col = n0 + nt * 8 + 2 * c4 + (x & 1);
        const float val = round_bf16(acc[nt][x]);
        qe_s[li[r] * np_pad + col] = val;
        if (qi[r] < t) qe_out[(row_t + qi[r]) * np_pad + col] = val;
      }
  }
  __syncwarp();

  float lse_r[2], dd_r[2], b_lo[2], b_hi[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    lse_r[r] = qi[r] < t ? lse[row_t + qi[r]] : INFINITY;   // p = 0 past t
    dd_r[r] = qi[r] < t ? dd[row_t + qi[r]] : 0.0f;
    b_lo[r] = qe_s[li[r] * np_pad];
    b_hi[r] = qe_s[li[r] * np_pad + lr];
  }
  float dqa[HD / 8][4] = {};
  float lo[2] = {0.f, 0.f}, hi[2] = {0.f, 0.f};   // dqE[:, 0], dqE[:, L+R]

  for (int jt = 0; jt < n_tiles; ++jt) {
    if (jt + 1 < n_tiles) load_kv(jt + 1, (jt + 1) & 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const __nv_bfloat16* k_t = kv_s + (jt & 1) * 2 * kTile * LD;
    const __nv_bfloat16* v_t = k_t + kTile * LD;
#pragma unroll 1
    for (int h = 0; h < kTile / kCols; ++h) {
      const int j0 = jt * kTile + h * kCols;
      if (j0 >= t || (limit > 0 && j0 >= limit)) break;
      float s[kCols / 8][4] = {}, dp[kCols / 8][4] = {};
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk) {
        uint32_t t1[4], t2[4];
        const uint32_t* qa = qf.get(kk, t1, lane);
        const uint32_t* da = df.get(kk, t2, lane);
#pragma unroll
        for (int np = 0; np < kCols / 16; ++np) {
          uint32_t b[4];
          load_b_nk(b, k_t + (h * kCols + np * 16) * LD + kk * 16, LD, lane);
          mma(s[2 * np], qa, b);
          mma(s[2 * np + 1], qa, b + 2);
          load_b_nk(b, v_t + (h * kCols + np * 16) * LD + kk * 16, LD, lane);
          mma(dp[2 * np], da, b);
          mma(dp[2 * np + 1], da, b + 2);
        }
      }
      const int iw = i0 + wr;
      const bool all_lo = j0 + kCols - 1 - iw <= -left;
      const bool all_hi = j0 - (iw + 15) >= right;
      if (j0 + kCols <= limit && (all_lo || all_hi)) {
        // valid keys outside the band: a row-constant bias, whose gradient
        // is the row sum of ds
#pragma unroll
        for (int nt = 0; nt < kCols / 8; ++nt)
#pragma unroll
          for (int x = 0; x < 4; ++x) {
            const int r = x >> 1;
            const float p = __expf(s[nt][x] + (all_lo ? b_lo[r] : b_hi[r]) -
                                   lse_r[r]);
            const float ds = p * (dp[nt][x] - dd_r[r]);
            if (all_lo) lo[r] += ds;
            else hi[r] += ds;
            s[nt][x] = ds;
          }
      } else if (j0 + kCols <= limit) {
        // valid keys in the band: the bias and its gradient by element; an
        // interior column c gets one key per query, so no race
#pragma unroll
        for (int nt = 0; nt < kCols / 8; ++nt)
#pragma unroll
          for (int x = 0; x < 4; ++x) {
            const int r = x >> 1;
            const int j = j0 + nt * 8 + 2 * c4 + (x & 1);
            const int c = min(max(j - qi[r], -left), right) + left;
            const float p = __expf(s[nt][x] + qe_s[li[r] * np_pad + c] -
                                   lse_r[r]);
            const float ds = p * (dp[nt][x] - dd_r[r]);
            lo[r] += c == 0 ? ds : 0.0f;
            hi[r] += c == lr ? ds : 0.0f;
            if (c > 0 && c < lr) dqe_s[li[r] * np_pad + c] += ds;
            s[nt][x] = ds;
          }
      } else {
        // the last step: masked keys and keys past t
#pragma unroll
        for (int nt = 0; nt < kCols / 8; ++nt)
#pragma unroll
          for (int x = 0; x < 4; ++x) {
            const int r = x >> 1;
            const int j = j0 + nt * 8 + 2 * c4 + (x & 1);
            float ds = 0.0f;
            if (j < t) {
              const int c = min(max(j - qi[r], -left), right) + left;
              const float sv = j >= limit
                  ? kNeg : s[nt][x] + qe_s[li[r] * np_pad + c];
              const float p = __expf(sv - lse_r[r]);
              ds = p * (dp[nt][x] - dd_r[r]);
              // an interior column c gets one key per query: no race
              if (c == 0) lo[r] += ds;
              else if (c == lr) hi[r] += ds;
              else dqe_s[li[r] * np_pad + c] += ds;
            }
            s[nt][x] = ds;
          }
      }
      // dq += round(ds)·k
#pragma unroll
      for (int kk = 0; kk < kCols / 16; ++kk) {
        uint32_t a[4];
        acc_to_a(a, s[2 * kk], s[2 * kk + 1]);
#pragma unroll
        for (int dp2 = 0; dp2 < HD / 16; ++dp2) {
          uint32_t b[4];
          load_b_kn(b, k_t + (h * kCols + kk * 16) * LD + dp2 * 16, LD, lane);
          mma(dqa[2 * dp2], a, b);
          mma(dqa[2 * dp2 + 1], a, b + 2);
        }
      }
    }
    __syncthreads();
  }

  // the clipped columns: quad sums in a fixed order; then the padded keys
  // t..t_pad-1 (zero k and v, so only dqE sees them, and only in a row
  // whose every key is masked: p = exp(NEG − lse) ≠ 0)
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    lo[r] += __shfl_xor_sync(0xffffffffu, lo[r], 1);
    lo[r] += __shfl_xor_sync(0xffffffffu, lo[r], 2);
    hi[r] += __shfl_xor_sync(0xffffffffu, hi[r], 1);
    hi[r] += __shfl_xor_sync(0xffffffffu, hi[r], 2);
    if (c4 != 0) continue;
    float* drow = dqe_s + li[r] * np_pad;
    drow[0] += lo[r];
    drow[lr] += hi[r];
    const float p_pad = __expf(kNeg - lse_r[r]);
    if (qi[r] < t && p_pad != 0.0f) {
      const float ds = -p_pad * dd_r[r];
      for (int j = t; j < t_pad; ++j)
        drow[min(max(j - qi[r], -left), right) + left] += ds;
    }
  }
  __syncwarp();

  // dq += round(dqE)·E, then round, scale by 1/√hd, round
  for (int kc = 0; kc < np_pad; kc += 16) {
    uint32_t a[4];
    const float* d0 = dqe_s + li[0] * np_pad + kc + 2 * c4;
    const float* d1 = dqe_s + li[1] * np_pad + kc + 2 * c4;
    a[0] = pack_bf16(d0[0], d0[1]);
    a[1] = pack_bf16(d1[0], d1[1]);
    a[2] = pack_bf16(d0[8], d0[9]);
    a[3] = pack_bf16(d1[8], d1[9]);
#pragma unroll
    for (int dp2 = 0; dp2 < HD / 16; ++dp2) {
      uint32_t b[4];
      load_b_kn(b, e_s + kc * LD + dp2 * 16, LD, lane);
      mma(dqa[2 * dp2], a, b);
      mma(dqa[2 * dp2 + 1], a, b + 2);
    }
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (qi[r] >= t) continue;
    __nv_bfloat16* drow = dq + base + qi[r] * HD;
#pragma unroll
    for (int dt = 0; dt < HD / 8; ++dt)
      *reinterpret_cast<__nv_bfloat162*>(drow + dt * 8 + 2 * c4) =
          __floats2bfloat162_rn(round_bf16(dqa[dt][2 * r]) * dq_scale,
                                round_bf16(dqa[dt][2 * r + 1]) * dq_scale);
  }
  __syncthreads();

  // dE partial of this block: Σ_i dqE[i, c]·q_s[i, d], dqE as hi + lo bf16
  float* part = de_part +
      (static_cast<int64_t>(row) * gridDim.x + blockIdx.x) * num_pos * HD;
  for (int mt = warp; mt < np_pad / 16; mt += kWarps) {
    float acc[HD / 8][4] = {};
#pragma unroll
    for (int ks = 0; ks < kTile / 16; ++ks) {
      float x[8];   // A[m = c][k = i] = dqE[i][c] in fragment order
      const int ca = mt * 16 + g, ia = ks * 16 + 2 * c4;
      x[0] = dqe_s[ia * np_pad + ca];
      x[1] = dqe_s[(ia + 1) * np_pad + ca];
      x[2] = dqe_s[ia * np_pad + ca + 8];
      x[3] = dqe_s[(ia + 1) * np_pad + ca + 8];
      x[4] = dqe_s[(ia + 8) * np_pad + ca];
      x[5] = dqe_s[(ia + 9) * np_pad + ca];
      x[6] = dqe_s[(ia + 8) * np_pad + ca + 8];
      x[7] = dqe_s[(ia + 9) * np_pad + ca + 8];
      uint32_t ahi[4], alo[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const float h0 = round_bf16(x[2 * u]), h1 = round_bf16(x[2 * u + 1]);
        ahi[u] = pack_bf16(h0, h1);
        alo[u] = pack_bf16(x[2 * u] - h0, x[2 * u + 1] - h1);
      }
#pragma unroll
      for (int dp2 = 0; dp2 < HD / 16; ++dp2) {
        uint32_t b[4];
        load_b_kn(b, q_s + ks * 16 * LD + dp2 * 16, LD, lane);
        mma(acc[2 * dp2], ahi, b);
        mma(acc[2 * dp2 + 1], ahi, b + 2);
        mma(acc[2 * dp2], alo, b);
        mma(acc[2 * dp2 + 1], alo, b + 2);
      }
    }
#pragma unroll
    for (int dt = 0; dt < HD / 8; ++dt)
#pragma unroll
      for (int xx = 0; xx < 4; ++xx) {
        const int c = mt * 16 + g + 8 * (xx >> 1);
        if (c < num_pos)
          part[c * HD + dt * 8 + 2 * c4 + (xx & 1)] = acc[dt][xx];
      }
  }
}

template <int HD>
__global__ void __launch_bounds__(kThreads)
flash_rel_bwd_dkv_mma_kernel(
    const __nv_bfloat16* __restrict__ qs, const __nv_bfloat16* __restrict__ k,
    const __nv_bfloat16* __restrict__ v, const int* __restrict__ lengths,
    const __nv_bfloat16* __restrict__ dout, const float* __restrict__ lse,
    const float* __restrict__ dd, const float* __restrict__ qe_in,
    __nv_bfloat16* __restrict__ dk, __nv_bfloat16* __restrict__ dv, int t,
    int num_pos, int np_pad, int left, int nh) {
  using namespace ste_mma;
  constexpr int LD = HD + 8;
  // columns per warp step: 64 where the score and dP tiles fit in
  // registers beside the accumulators (hd ≤ 64), else 32
  constexpr int kCols = HD <= 64 ? 64 : 32;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* k_s = reinterpret_cast<__nv_bfloat16*>(smem_raw);  // [64][LD]
  __nv_bfloat16* v_s = k_s + kTile * LD;                           // [64][LD]
  __nv_bfloat16* qd_s = v_s + kTile * LD;         // [2][q_s, dO][64][LD]
  float* qe_s = reinterpret_cast<float*>(qd_s + 4 * kTile * LD);
                                                    // [2][64][np_pad]
  float* ld_s = qe_s + 2 * kTile * np_pad;          // [2][lse, dd][64]
  const int row = blockIdx.y;
  const int j0 = blockIdx.x * kTile;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, c4 = lane & 3;
  const int limit = lengths[row / nh];
  const int right = num_pos - 1 - left;
  const int64_t base = static_cast<int64_t>(row) * t * HD;
  const int64_t row_t = static_cast<int64_t>(row) * t;
  const int n_tiles = (t + kTile - 1) / kTile;
  const int wr = warp * 16;
  const int kj[2] = {j0 + wr + g, j0 + wr + g + 8};   // this lane's keys

  if (limit > 0 && j0 >= limit) {
    // masked keys of a clip with valid ones: p = 0, so dk = dv = 0
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      if (kj[r] >= t) continue;
#pragma unroll
      for (int dt = 0; dt < HD / 8; ++dt) {
        const int64_t off = base + kj[r] * HD + dt * 8 + 2 * c4;
        *reinterpret_cast<__nv_bfloat162*>(dk + off) =
            __floats2bfloat162_rn(0.0f, 0.0f);
        *reinterpret_cast<__nv_bfloat162*>(dv + off) =
            __floats2bfloat162_rn(0.0f, 0.0f);
      }
    }
    return;
  }

  auto load_q = [&](int it, int stage) {
    const int i0 = it * kTile;
    __nv_bfloat16* dst = qd_s + stage * 2 * kTile * LD;
    tile_to_smem<kTile, HD, kThreads>(dst, qs + base + i0 * HD, t - i0, tid);
    tile_to_smem<kTile, HD, kThreads>(dst + kTile * LD, dout + base + i0 * HD,
                                      t - i0, tid);
    f32_tile_to_smem(qe_s + stage * kTile * np_pad,
                     qe_in + (row_t + i0) * np_pad, np_pad, t - i0, tid);
    if (tid < kTile) {     // plain loads: lse and dd rows are not 16-aligned
      const int i = i0 + tid;
      ld_s[stage * 2 * kTile + tid] = i < t ? lse[row_t + i] : INFINITY;
      ld_s[stage * 2 * kTile + kTile + tid] = i < t ? dd[row_t + i] : 0.0f;
    }
  };
  tile_to_smem<kTile, HD, kThreads>(k_s, k + base + j0 * HD, t - j0, tid);
  tile_to_smem<kTile, HD, kThreads>(v_s, v + base + j0 * HD, t - j0, tid);
  load_q(0, 0);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();

  RowFrags<HD> kf, vf;
  kf.init(k_s + wr * LD, lane);
  vf.init(v_s + wr * LD, lane);
  float dka[HD / 8][4] = {}, dva[HD / 8][4] = {};
  const bool keys_valid = j0 + wr + 16 <= limit;   // every key of the warp

  for (int it = 0; it < n_tiles; ++it) {
    if (it + 1 < n_tiles) load_q(it + 1, (it + 1) & 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const int st = it & 1;
    const __nv_bfloat16* q_t = qd_s + st * 2 * kTile * LD;
    const __nv_bfloat16* do_t = q_t + kTile * LD;
    const float* qe_t = qe_s + st * kTile * np_pad;
    const float* lse_t = ld_s + st * 2 * kTile;
    const float* dd_t = lse_t + kTile;
#pragma unroll 1
    for (int h = 0; h < kTile / kCols; ++h) {
      const int iq = it * kTile + h * kCols;
      if (iq >= t) break;
      // sᵀ = k·q_sᵀ and dPᵀ = v·dOᵀ for 16 keys × 32 queries
      float s[kCols / 8][4] = {}, dp[kCols / 8][4] = {};
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk) {
        uint32_t t1[4], t2[4];
        const uint32_t* ka = kf.get(kk, t1, lane);
        const uint32_t* va = vf.get(kk, t2, lane);
#pragma unroll
        for (int np = 0; np < kCols / 16; ++np) {
          uint32_t b[4];
          load_b_nk(b, q_t + (h * kCols + np * 16) * LD + kk * 16, LD, lane);
          mma(s[2 * np], ka, b);
          mma(s[2 * np + 1], ka, b + 2);
          load_b_nk(b, do_t + (h * kCols + np * 16) * LD + kk * 16, LD, lane);
          mma(dp[2 * np], va, b);
          mma(dp[2 * np + 1], va, b + 2);
        }
      }
      const int jw = j0 + wr;
      const bool all_lo = jw + 15 - iq <= -left;
      const bool all_hi = jw - (iq + kCols - 1) >= right;
      if (keys_valid && (all_lo || all_hi)) {
        // valid keys outside the band: the bias is qE[i, 0] or qE[i, L+R]
        const int c = all_lo ? 0 : left + right;
#pragma unroll
        for (int nt = 0; nt < kCols / 8; ++nt)
#pragma unroll
          for (int x = 0; x < 4; ++x) {
            const int il = h * kCols + nt * 8 + 2 * c4 + (x & 1);
            const float p = __expf(s[nt][x] + qe_t[il * np_pad + c] -
                                   lse_t[il]);          // 0 for queries ≥ t
            dp[nt][x] = p * (dp[nt][x] - dd_t[il]);
            s[nt][x] = p;
          }
      } else if (keys_valid) {
        // valid keys in the band: the bias by element
#pragma unroll
        for (int nt = 0; nt < kCols / 8; ++nt)
#pragma unroll
          for (int x = 0; x < 4; ++x) {
            const int il = h * kCols + nt * 8 + 2 * c4 + (x & 1);
            const int c = min(max(kj[x >> 1] - it * kTile - il, -left),
                              right) + left;
            const float p = __expf(s[nt][x] + qe_t[il * np_pad + c] -
                                   lse_t[il]);          // 0 for queries ≥ t
            dp[nt][x] = p * (dp[nt][x] - dd_t[il]);
            s[nt][x] = p;
          }
      } else {
        // keys at or past the clip's length or t
#pragma unroll
        for (int nt = 0; nt < kCols / 8; ++nt)
#pragma unroll
          for (int x = 0; x < 4; ++x) {
            const int j = kj[x >> 1];
            const int il = h * kCols + nt * 8 + 2 * c4 + (x & 1);
            const int i = it * kTile + il;
            float p = 0.0f, ds = 0.0f;
            if (j < t) {
              const int c = min(max(j - i, -left), right) + left;
              const float sv = j >= limit
                  ? kNeg : s[nt][x] + qe_t[il * np_pad + c];
              p = __expf(sv - lse_t[il]);
              ds = p * (dp[nt][x] - dd_t[il]);
            }
            s[nt][x] = p;
            dp[nt][x] = ds;
          }
      }
      // dv += round(pᵀ)·dO, dk += round(dsᵀ)·q_s
#pragma unroll
      for (int kk = 0; kk < kCols / 16; ++kk) {
        uint32_t pa[4], sa[4];
        acc_to_a(pa, s[2 * kk], s[2 * kk + 1]);
        acc_to_a(sa, dp[2 * kk], dp[2 * kk + 1]);
#pragma unroll
        for (int dp2 = 0; dp2 < HD / 16; ++dp2) {
          uint32_t b[4];
          load_b_kn(b, do_t + (h * kCols + kk * 16) * LD + dp2 * 16, LD, lane);
          mma(dva[2 * dp2], pa, b);
          mma(dva[2 * dp2 + 1], pa, b + 2);
          load_b_kn(b, q_t + (h * kCols + kk * 16) * LD + dp2 * 16, LD, lane);
          mma(dka[2 * dp2], sa, b);
          mma(dka[2 * dp2 + 1], sa, b + 2);
        }
      }
    }
    __syncthreads();
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (kj[r] >= t) continue;
    const int64_t off = base + kj[r] * HD;
#pragma unroll
    for (int dt = 0; dt < HD / 8; ++dt) {
      *reinterpret_cast<__nv_bfloat162*>(dk + off + dt * 8 + 2 * c4) =
          __floats2bfloat162_rn(dka[dt][2 * r], dka[dt][2 * r + 1]);
      *reinterpret_cast<__nv_bfloat162*>(dv + off + dt * 8 + 2 * c4) =
          __floats2bfloat162_rn(dva[dt][2 * r], dva[dt][2 * r + 1]);
    }
  }
}

template <int HD>
int launch_mma(const void* q, const void* k, const void* v, const void* e,
               const int* lengths, const void* dout, const float* lse,
               const float* dd, void* dq, void* dk, void* dv, void* qs_buf,
               float* qe_buf, float* de_part, int bh, int t, int t_pad,
               int num_pos, int np_pad, int left, int nh, float scale,
               float dq_scale, cudaStream_t stream) {
  using bf = __nv_bfloat16;
  constexpr size_t kRow = (HD + 8) * sizeof(bf);
  const size_t smem_a = (6 * kTile + np_pad) * kRow +
                        2 * static_cast<size_t>(kTile) * np_pad * 4;
  const size_t smem_b = 6 * kTile * kRow +
                        2 * static_cast<size_t>(kTile) * np_pad * 4 +
                        4 * kTile * 4;
  auto ka = flash_rel_bwd_dq_mma_kernel<HD>;
  auto kb = flash_rel_bwd_dkv_mma_kernel<HD>;
  cudaError_t err = cudaFuncSetAttribute(
      ka, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem_a));
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaFuncSetAttribute(kb, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem_b));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((t + kTile - 1) / kTile, bh);
  ka<<<grid, kThreads, smem_a, stream>>>(
      static_cast<const bf*>(q), static_cast<const bf*>(k),
      static_cast<const bf*>(v), static_cast<const bf*>(e), lengths,
      static_cast<const bf*>(dout), lse, dd, static_cast<bf*>(dq),
      static_cast<bf*>(qs_buf), qe_buf, de_part, t, t_pad, num_pos, np_pad,
      left, nh, scale, dq_scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  kb<<<grid, kThreads, smem_b, stream>>>(
      static_cast<const bf*>(qs_buf), static_cast<const bf*>(k),
      static_cast<const bf*>(v), lengths, static_cast<const bf*>(dout), lse,
      dd, qe_buf, static_cast<bf*>(dk), static_cast<bf*>(dv), t, num_pos,
      np_pad, left, nh);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// bf16 only, hd a multiple of 16 up to 128; np_pad = num_pos rounded up to
// 16. qs_buf is bf16 scratch of bh·t·hd (q_s, written by kernel A), qe_buf
// fp32 scratch of bh·t·np_pad (qE), de_part ⌈t/64⌉·bh partials of
// [num_pos, hd] (the wrapper sums them). Returns cudaGetLastError() after the
// launches, or cudaErrorInvalidValue for shapes the kernels do not take.
extern "C" int ste_flash_rel_bwd_mma(
    const void* q, const void* k, const void* v, const void* e,
    const int* lengths, const void* dout, const float* lse, const float* dd,
    void* dq, void* dk, void* dv, void* qs_buf, float* qe_buf,
    float* de_part, int bh, int t, int t_pad, int hd, int num_pos, int left,
    int nh, float scale, float dq_scale, int device, void* stream) {
  const int np_pad = (num_pos + 15) / 16 * 16;
  if (hd % 16 != 0 || hd < 16 || hd > 128 || num_pos < 1 || num_pos > 128 ||
      t < 1 || t_pad < t || nh < 1 || left < 0 || left >= num_pos || bh < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaSetDevice(device);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define STE_LAUNCH(HD)                                                       \
  return launch_mma<HD>(q, k, v, e, lengths, dout, lse, dd, dq, dk, dv,     \
                        qs_buf, qe_buf, de_part, bh, t, t_pad, num_pos,     \
                        np_pad, left, nh, scale, dq_scale, s)
  switch (hd) {
    case 16: STE_LAUNCH(16);
    case 32: STE_LAUNCH(32);
    case 48: STE_LAUNCH(48);
    case 64: STE_LAUNCH(64);
    case 80: STE_LAUNCH(80);
    case 96: STE_LAUNCH(96);
    case 112: STE_LAUNCH(112);
    default: STE_LAUNCH(128);
  }
#undef STE_LAUNCH
}

// dtype: 0 = float32, 1 = bfloat16. qe_buf is fp32 scratch of bh·t·num_pos
// (kernel A writes qE there, kernel B reads it); de_part holds ⌈t/64⌉·bh
// partials of [num_pos, hd] (the wrapper sums them). Returns
// cudaGetLastError() after the launches, or cudaErrorInvalidValue for shapes
// the kernels do not take.
extern "C" int ste_flash_rel_bwd(const void* q, const void* k, const void* v,
                                 const void* e, const int* lengths,
                                 const void* dout, const float* lse,
                                 const float* dd, void* dq, void* dk,
                                 void* dv, float* qe_buf, float* de_part,
                                 int bh, int t, int t_pad, int hd,
                                 int num_pos, int left, int nh, float scale,
                                 float dq_scale, int dtype, int device,
                                 void* stream) {
  if (hd < 1 || hd > 128 || num_pos < 1 || num_pos > 128 || t < 1 ||
      t_pad < t || nh < 1 || left < 0 || left >= num_pos || bh < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaSetDevice(device);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1)
    return dispatch_hd<__nv_bfloat16>(q, k, v, e, lengths, dout, lse, dd, dq,
                                      dk, dv, qe_buf, de_part, bh, t, t_pad,
                                      hd, num_pos, left, nh, scale, dq_scale,
                                      s);
  if (dtype == 0)
    return dispatch_hd<float>(q, k, v, e, lengths, dout, lse, dd, dq, dk, dv,
                              qe_buf, de_part, bh, t, t_pad, hd, num_pos,
                              left, nh, scale, dq_scale, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
