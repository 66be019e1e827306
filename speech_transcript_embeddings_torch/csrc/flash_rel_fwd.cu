// Relative_key flash attention, forward (bf16 or fp32 in, fp32 accumulate).
//
// Replaces the Pallas TPU kernel
// speech_transcript_embeddings_tpu/ops/flash_attention.py::_fwd_kernel (:237).
// For each batch·head row, with q_s = q·scale rounded to q's dtype:
//
//   s[i, j] = q_s[i]·k[j] + qE[i, clip(j − i, −L, R) + L]     (j < len)
//   s[i, j] = NEG = −1e30                                     (j ≥ len)
//   out[i]  = softmax_j(s[i, :])·v,   lse[i] = m + log l
//
// where qE = q_s·Eᵀ rounded to q's dtype (as the TPU kernel rounds it) and
// len is the clip's valid length (one per batch row, row / num_heads). The
// finite NEG keeps a clip with no valid frame finite: every score is NEG,
// the softmax is uniform over the t_pad (128-multiple) keys that the TPU
// kernel pads to, so the t_pad − t padded keys (zero values) are counted in
// l at the end.
//
// What bounds it on an H100: at the conformer's T ≤ 1536 and hd 64 the
// score matrix is small (T² per row) and the work is ≈4·T²·hd FLOP per row;
// this first version runs it on the CUDA cores in fp32, so it is bound by
// FMA issue and by latency (one thread per query row), not by memory.
// Design: one block per (row, 64-query tile), one thread per query row that
// keeps its scaled q and its output accumulator in registers; K and V tiles
// are staged in shared memory as fp32 and read as float4 broadcasts; qE is
// computed once per query tile into shared memory ([num_pos][64], indexed by
// clip(j − i) + L — no one-hot selection matmuls and no roll shear, which
// were TPU workarounds); the online softmax rescales once per 16 keys. The
// TPU kernel's whole-row VMEM chunking and MAX_T_PAD limit do not apply.
// This CUDA-core kernel serves fp32 inputs and head dims that are not a
// multiple of 16; bf16 inputs with hd a multiple of 16 (the conformer's hd
// 64) go to flash_rel_fwd_wgmma_kernel (flash_rel_fwd_sm90.cu), which uses
// the tensor cores.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kBM = 64;      // query rows per block = threads per block
constexpr int kBN = 32;      // keys per shared-memory tile
constexpr int kChunk = 16;   // keys per online-softmax rescale
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
// round an fp32 value to T's precision and back (identity for fp32)
template <typename T> __device__ __forceinline__ float round_to(float x) {
  return to_f(from_f<T>(x));
}

template <typename T, int HDP>
__global__ void __launch_bounds__(kBM)
flash_rel_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const T* __restrict__ e,
                     const int* __restrict__ lengths, T* __restrict__ out,
                     float* __restrict__ lse, int t, int t_pad, int hd,
                     int num_pos, int left, int nh, float scale) {
  extern __shared__ __align__(16) float smem[];
  float* k_s = smem;                    // [kBN][HDP]
  float* v_s = k_s + kBN * HDP;         // [kBN][HDP]
  float* qe_s = v_s + kBN * HDP;        // [num_pos][kBM]
  const int row = blockIdx.y;
  const int tid = threadIdx.x;
  const int i = blockIdx.x * kBM + tid;
  const int limit = lengths[row / nh];
  const int right = num_pos - 1 - left;
  const int64_t base = static_cast<int64_t>(row) * t * hd;

  float qr[HDP];
#pragma unroll
  for (int d = 0; d < HDP; ++d)
    qr[d] = (i < t && d < hd)
                ? round_to<T>(to_f(q[base + static_cast<int64_t>(i) * hd + d]) *
                              scale)
                : 0.0f;
  for (int p = 0; p < num_pos; ++p) {
    float acc = 0.0f;
#pragma unroll
    for (int d = 0; d < HDP; ++d)
      if (d < hd) acc = fmaf(qr[d], to_f(e[p * hd + d]), acc);
    qe_s[p * kBM + tid] = round_to<T>(acc);
  }

  float o[HDP];
#pragma unroll
  for (int d = 0; d < HDP; ++d) o[d] = 0.0f;
  float m = -INFINITY, l = 0.0f;

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
      float s[kChunk];
      float cmax = -INFINITY;
#pragma unroll
      for (int c = 0; c < kChunk; ++c) {
        const int jj = jc + c, j = j0 + jj;
        float sv;
        if (jj >= jn) {
          sv = -INFINITY;                      // past the last key
        } else if (j >= limit) {
          sv = kNeg;                           // masked key
        } else {
          const float4* kr = reinterpret_cast<const float4*>(k_s + jj * HDP);
          float a0 = 0.f, a1 = 0.f, a2 = 0.f, a3 = 0.f;
#pragma unroll
          for (int d4 = 0; d4 < HDP / 4; ++d4) {
            const float4 kv = kr[d4];
            a0 = fmaf(qr[4 * d4 + 0], kv.x, a0);
            a1 = fmaf(qr[4 * d4 + 1], kv.y, a1);
            a2 = fmaf(qr[4 * d4 + 2], kv.z, a2);
            a3 = fmaf(qr[4 * d4 + 3], kv.w, a3);
          }
          const int dist = min(max(j - i, -left), right) + left;
          sv = (a0 + a1) + (a2 + a3) + qe_s[dist * kBM + tid];
        }
        s[c] = sv;
        cmax = fmaxf(cmax, sv);
      }
      const float m_new = fmaxf(m, cmax);
      const float corr = expf(m - m_new);
      l *= corr;
#pragma unroll
      for (int d = 0; d < HDP; ++d) o[d] *= corr;
#pragma unroll
      for (int c = 0; c < kChunk; ++c) {
        if (jc + c >= jn) break;
        const float pj = expf(s[c] - m_new);
        l += pj;
        const float4* vr =
            reinterpret_cast<const float4*>(v_s + (jc + c) * HDP);
#pragma unroll
        for (int d4 = 0; d4 < HDP / 4; ++d4) {
          const float4 vv = vr[d4];
          o[4 * d4 + 0] = fmaf(pj, vv.x, o[4 * d4 + 0]);
          o[4 * d4 + 1] = fmaf(pj, vv.y, o[4 * d4 + 1]);
          o[4 * d4 + 2] = fmaf(pj, vv.z, o[4 * d4 + 2]);
          o[4 * d4 + 3] = fmaf(pj, vv.w, o[4 * d4 + 3]);
        }
      }
      m = m_new;
    }
  }
  // the TPU kernel's padded keys t..t_pad-1 (score NEG, value 0): they
  // count only in a row whose every key is masked (m == NEG)
  l += static_cast<float>(t_pad - t) * expf(kNeg - m);
  if (i < t) {
#pragma unroll
    for (int d = 0; d < HDP; ++d)
      if (d < hd) out[base + static_cast<int64_t>(i) * hd + d] =
                      from_f<T>(o[d] / l);
    lse[static_cast<int64_t>(row) * t + i] = m + logf(l);
  }
}

template <typename T, int HDP>
int launch(const void* q, const void* k, const void* v, const void* e,
           const int* lengths, void* out, float* lse, int bh, int t,
           int t_pad, int hd, int num_pos, int left, int nh, float scale,
           cudaStream_t stream) {
  auto kern = flash_rel_fwd_kernel<T, HDP>;
  const size_t smem = (2 * kBN * HDP + num_pos * kBM) * sizeof(float);
  cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       static_cast<int>(smem));
  dim3 grid((t + kBM - 1) / kBM, bh);
  kern<<<grid, kBM, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(e), lengths,
      static_cast<T*>(out), lse, t, t_pad, hd, num_pos, left, nh, scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch_hd(const void* q, const void* k, const void* v, const void* e,
                const int* lengths, void* out, float* lse, int bh, int t,
                int t_pad, int hd, int num_pos, int left, int nh, float scale,
                cudaStream_t s) {
  if (hd <= 16)
    return launch<T, 16>(q, k, v, e, lengths, out, lse, bh, t, t_pad, hd,
                         num_pos, left, nh, scale, s);
  if (hd <= 32)
    return launch<T, 32>(q, k, v, e, lengths, out, lse, bh, t, t_pad, hd,
                         num_pos, left, nh, scale, s);
  if (hd <= 64)
    return launch<T, 64>(q, k, v, e, lengths, out, lse, bh, t, t_pad, hd,
                         num_pos, left, nh, scale, s);
  return launch<T, 128>(q, k, v, e, lengths, out, lse, bh, t, t_pad, hd,
                        num_pos, left, nh, scale, s);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. Returns cudaGetLastError() after the
// launch, or cudaErrorInvalidValue for shapes the kernel does not take.
extern "C" int ste_flash_rel_fwd(const void* q, const void* k, const void* v,
                                 const void* e, const int* lengths, void* out,
                                 float* lse, int bh, int t, int t_pad, int hd,
                                 int num_pos, int left, int nh, float scale,
                                 int dtype, int device, void* stream) {
  if (hd < 1 || hd > 128 || num_pos < 1 || num_pos > 128 || t < 1 ||
      t_pad < t || nh < 1 || left < 0 || left >= num_pos)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaSetDevice(device);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1)
    return dispatch_hd<__nv_bfloat16>(q, k, v, e, lengths, out, lse, bh, t,
                                      t_pad, hd, num_pos, left, nh, scale, s);
  if (dtype == 0)
    return dispatch_hd<float>(q, k, v, e, lengths, out, lse, bh, t, t_pad,
                              hd, num_pos, left, nh, scale, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
