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
// 64) go to flash_rel_fwd_mma_kernel below, which uses the tensor cores.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "mma_bf16.cuh"

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

// ---- bf16 on the tensor cores ----------------------------------------------
//
// The same function for bf16 q, k, v and E with hd a multiple of 16 (≤ 128),
// with the TPU kernel's numerics: bf16 operands, fp32 accumulate
// (mma.sync.m16n8k16), qE and p rounded to bf16 before their products.
// What bounds it: ≈4·T²·hd FLOP per row against T·hd·8 bytes, so compute on
// the tensor cores. Design: one block of 4 warps per (row, 64-query tile),
// each warp owns 16 query rows. The warp keeps its q_s fragments in
// registers; K and V tiles of 64 keys stream through a two-stage cp.async
// ring in shared memory, so the next tile's copy overlaps this tile's
// products. qE = q_s·Eᵀ (E padded to np_pad rows of zeros) is one more
// tensor-core product per block, kept in shared memory as fp32. The bias is
// added by band: a (16-query, 64-key) tile whose every j − i ≤ −L takes the
// row constant qE[i, 0], one whose every j − i ≥ R takes qE[i, L + R], and
// only the ≤ 3 tiles that straddle the band index qE per element. The online
// softmax runs on the accumulator fragments (a row lives in one quad of
// lanes), and p, rounded to bf16 in registers, is the A operand of p·v.

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kTile = 64;    // queries per block, keys per K/V tile

template <int HD>
__global__ void __launch_bounds__(kThreads)
flash_rel_fwd_mma_kernel(const __nv_bfloat16* __restrict__ q,
                         const __nv_bfloat16* __restrict__ k,
                         const __nv_bfloat16* __restrict__ v,
                         const __nv_bfloat16* __restrict__ e,
                         const int* __restrict__ lengths,
                         __nv_bfloat16* __restrict__ out,
                         float* __restrict__ lse, int t, int t_pad,
                         int num_pos, int np_pad, int left, int nh,
                         float scale) {
  using namespace ste_mma;
  constexpr int LD = HD + 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* q_s = reinterpret_cast<__nv_bfloat16*>(smem_raw);  // [64][LD]
  __nv_bfloat16* kv_s = q_s + kTile * LD;              // [2][k, v][64][LD]
  __nv_bfloat16* e_s = kv_s + 2 * kTile * LD;  // [np_pad][LD] in stage 1,
                                               // until the key loop starts
  float* qe_s = reinterpret_cast<float*>(kv_s + 4 * kTile * LD);
                                                           // [64][np_pad]
  const int row = blockIdx.y;
  const int i0 = blockIdx.x * kTile;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, c4 = lane & 3;
  const int limit = lengths[row / nh];
  const int right = num_pos - 1 - left;
  const int lr = left + right;
  const __nv_bfloat16* qb = q + static_cast<int64_t>(row) * t * HD;
  const __nv_bfloat16* kb = k + static_cast<int64_t>(row) * t * HD;
  const __nv_bfloat16* vb = v + static_cast<int64_t>(row) * t * HD;
  // keys at or past the clip's length have p = exp(NEG − m) = 0 unless
  // every key is masked, so only a clip with no valid key walks them all
  const int n_tiles = ((limit > 0 ? limit : t) + kTile - 1) / kTile;

  auto load_kv = [&](int jt, int stage) {
    __nv_bfloat16* dst = kv_s + stage * 2 * kTile * LD;
    const int j0 = jt * kTile;
    tile_to_smem<kTile, HD, kThreads>(dst, kb + j0 * HD, t - j0, tid);
    tile_to_smem<kTile, HD, kThreads>(dst + kTile * LD, vb + j0 * HD, t - j0,
                                      tid);
  };
  // q and E (zero rows past num_pos) in one copy group, the first K/V tile
  // in the next, so the qE product overlaps the K/V copy
  tile_to_smem<kTile, HD, kThreads>(q_s, qb + i0 * HD, t - i0, tid);
  for (int idx = tid; idx < np_pad * HD / 8; idx += kThreads) {
    const int p = idx / (HD / 8), d = (idx - p * (HD / 8)) * 8;
    cp_async16(e_s + p * LD + d, e + (p < num_pos ? p : 0) * HD + d,
               p < num_pos);
  }
  cp_async_commit();
  load_kv(0, 0);
  cp_async_commit();
  cp_async_wait<1>();
  __syncthreads();

  // q_s = round(q·scale), in the A fragments of the warp's 16 rows
  const int wr = warp * 16;            // the warp's first row in the tile
  uint32_t qf[HD / 16][4];
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk) {
    load_a(qf[kk], q_s + wr * LD + kk * 16, LD, lane);
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const float2 f = __bfloat1622float2(
          *reinterpret_cast<const __nv_bfloat162*>(&qf[kk][u]));
      qf[kk][u] = pack_bf16(f.x * scale, f.y * scale);
    }
  }

  // qE rows of this warp, rounded to bf16, 16 positions at a time
  for (int n0 = 0; n0 < np_pad; n0 += 16) {
    float acc[2][4] = {};
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk) {
      uint32_t b[4];
      load_b_nk(b, e_s + n0 * LD + kk * 16, LD, lane);
      mma(acc[0], qf[kk], b);
      mma(acc[1], qf[kk], b + 2);
    }
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int x = 0; x < 4; ++x)
        qe_s[(wr + g + 8 * (x >> 1)) * np_pad + n0 + nt * 8 + 2 * c4 +
             (x & 1)] = round_bf16(acc[nt][x]);
  }
  __syncthreads();                     // E (stage 1) is free for K and V

  const int li[2] = {wr + g, wr + g + 8};            // rows in the tile
  const int qi[2] = {i0 + li[0], i0 + li[1]};        // query indices
  const float b_lo[2] = {qe_s[li[0] * np_pad], qe_s[li[1] * np_pad]};
  const float b_hi[2] = {qe_s[li[0] * np_pad + lr], qe_s[li[1] * np_pad + lr]};
  float o[HD / 8][4] = {};
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};

  for (int jt = 0; jt < n_tiles; ++jt) {
    if (jt + 1 < n_tiles) load_kv(jt + 1, (jt + 1) & 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const __nv_bfloat16* k_t = kv_s + (jt & 1) * 2 * kTile * LD;
    const __nv_bfloat16* v_t = k_t + kTile * LD;
    const int j0 = jt * kTile;

    float s[kTile / 8][4] = {};
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk)
#pragma unroll
      for (int np = 0; np < kTile / 16; ++np) {
        uint32_t b[4];
        load_b_nk(b, k_t + np * 16 * LD + kk * 16, LD, lane);
        mma(s[2 * np], qf[kk], b);
        mma(s[2 * np + 1], qf[kk], b + 2);
      }

    // the bias by band and the key mask (warp-uniform branches): a tile of
    // valid keys outside the band adds one constant per row
    const int iw = i0 + wr;
    const bool all_lo = j0 + kTile - 1 - iw <= -left;
    const bool all_hi = j0 - (iw + 15) >= right;
    const bool full = j0 + kTile <= limit;
    float mx[2] = {-INFINITY, -INFINITY};
    if (full && (all_lo || all_hi)) {
#pragma unroll
      for (int nt = 0; nt < kTile / 8; ++nt)
#pragma unroll
        for (int x = 0; x < 4; ++x) {
          const int r = x >> 1;
          s[nt][x] += all_lo ? b_lo[r] : b_hi[r];
          mx[r] = fmaxf(mx[r], s[nt][x]);
        }
    } else if (full) {
      // valid keys in the band: the bias by element
#pragma unroll
      for (int nt = 0; nt < kTile / 8; ++nt)
#pragma unroll
        for (int x = 0; x < 4; ++x) {
          const int r = x >> 1;
          const int j = j0 + nt * 8 + 2 * c4 + (x & 1);
          const int c = min(max(j - qi[r], -left), right) + left;
          s[nt][x] += qe_s[li[r] * np_pad + c];
          mx[r] = fmaxf(mx[r], s[nt][x]);
        }
    } else {
      // the last tile: masked keys and keys past t
#pragma unroll
      for (int nt = 0; nt < kTile / 8; ++nt)
#pragma unroll
        for (int x = 0; x < 4; ++x) {
          const int r = x >> 1;
          const int j = j0 + nt * 8 + 2 * c4 + (x & 1);
          float sv;
          if (j >= t) {
            sv = -INFINITY;                        // past the last key
          } else if (j >= limit) {
            sv = kNeg;                             // masked key
          } else {
            const int c = min(max(j - qi[r], -left), right) + left;
            sv = s[nt][x] + qe_s[li[r] * np_pad + c];
          }
          s[nt][x] = sv;
          mx[r] = fmaxf(mx[r], sv);
        }
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float m_new = fmaxf(m[r], mx[r]);
      const float corr = __expf(m[r] - m_new);
      m[r] = m_new;
      l[r] *= corr;
#pragma unroll
      for (int dt = 0; dt < HD / 8; ++dt) {
        o[dt][2 * r] *= corr;
        o[dt][2 * r + 1] *= corr;
      }
    }
#pragma unroll
    for (int nt = 0; nt < kTile / 8; ++nt)
#pragma unroll
      for (int x = 0; x < 4; ++x) {
        const float p = __expf(s[nt][x] - m[x >> 1]);
        l[x >> 1] += p;
        s[nt][x] = p;
      }
    // o += round(p)·v
#pragma unroll
    for (int kk = 0; kk < kTile / 16; ++kk) {
      uint32_t a[4];
      acc_to_a(a, s[2 * kk], s[2 * kk + 1]);
#pragma unroll
      for (int dp = 0; dp < HD / 16; ++dp) {
        uint32_t b[4];
        load_b_kn(b, v_t + kk * 16 * LD + dp * 16, LD, lane);
        mma(o[2 * dp], a, b);
        mma(o[2 * dp + 1], a, b + 2);
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    // the padded keys t..t_pad-1 (score NEG, value 0): they count only in
    // a row whose every key is masked (m == NEG)
    l[r] += static_cast<float>(t_pad - t) * __expf(kNeg - m[r]);
    if (qi[r] >= t) continue;
    const float inv = 1.0f / l[r];
    __nv_bfloat16* orow = out + (static_cast<int64_t>(row) * t + qi[r]) * HD;
#pragma unroll
    for (int dt = 0; dt < HD / 8; ++dt)
      *reinterpret_cast<__nv_bfloat162*>(orow + dt * 8 + 2 * c4) =
          __floats2bfloat162_rn(o[dt][2 * r] * inv, o[dt][2 * r + 1] * inv);
    if (c4 == 0)
      lse[static_cast<int64_t>(row) * t + qi[r]] = m[r] + logf(l[r]);
  }
}

template <int HD>
int launch_mma(const void* q, const void* k, const void* v, const void* e,
               const int* lengths, void* out, float* lse, int bh, int t,
               int t_pad, int num_pos, int np_pad, int left, int nh,
               float scale, cudaStream_t stream) {
  auto kern = flash_rel_fwd_mma_kernel<HD>;
  const size_t smem = 5 * kTile * (HD + 8) * 2 +
                      static_cast<size_t>(kTile) * np_pad * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid((t + kTile - 1) / kTile, bh);
  kern<<<grid, kThreads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<const __nv_bfloat16*>(e),
      lengths, static_cast<__nv_bfloat16*>(out), lse, t, t_pad, num_pos,
      np_pad, left, nh, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// bf16 only, hd a multiple of 16 up to 128, np_pad = num_pos rounded up to
// 16. Returns cudaGetLastError() after the launch, or cudaErrorInvalidValue
// for shapes the kernel does not take.
extern "C" int ste_flash_rel_fwd_mma(const void* q, const void* k,
                                     const void* v, const void* e,
                                     const int* lengths, void* out,
                                     float* lse, int bh, int t, int t_pad,
                                     int hd, int num_pos, int left, int nh,
                                     float scale, int device, void* stream) {
  const int np_pad = (num_pos + 15) / 16 * 16;
  if (hd % 16 != 0 || hd < 16 || hd > 128 || num_pos < 1 || num_pos > 128 ||
      t < 1 || t_pad < t || nh < 1 || left < 0 || left >= num_pos || bh < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaSetDevice(device);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define STE_LAUNCH(HD)                                                       \
  return launch_mma<HD>(q, k, v, e, lengths, out, lse, bh, t, t_pad,        \
                        num_pos, np_pad, left, nh, scale, s)
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
