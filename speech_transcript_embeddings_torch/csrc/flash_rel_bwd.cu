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
// conformer's hd 64) go to the wgmma pair of flash_rel_bwd_sm90.cu.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

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

}  // namespace

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
