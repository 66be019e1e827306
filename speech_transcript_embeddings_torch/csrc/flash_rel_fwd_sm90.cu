// Relative_key flash attention, forward, bf16 on Hopper's wgmma fed by TMA.
//
// Replaces the Pallas TPU kernel
// speech_transcript_embeddings_tpu/ops/flash_attention.py::_fwd_kernel (:237)
// for bf16 inputs with hd a multiple of 16 up to 128 (the conformer's hd 64):
// the out and lse of flash_rel_fwd.cu's header, at the rounding points that
// rel_attention_reference follows. q_s = round(q·scale) with scale the bf16
// rounding of 1/√hd, qE = round(q_s·Eᵀ), fp32 scores with the clipped-distance
// bias and the additive NEG key mask, l summed from the unrounded p, p rounded
// to bf16 for p·v, the t_pad − t padded keys (score NEG, value 0) counted in
// l, out = round(o / l) and lse = m + log l.
//
// What bounds it on an H100: 4·T²·hd FLOP a row against ≈8·T·hd bytes (q, k,
// v in, out back), so the bytes at the serving and training lengths (t_pad
// 256, 512) and the tensor cores, whose full rate only wgmma reaches, at the
// 30 s bucket (t_pad 1536). The mma.sync kernel this replaces ran 16×8×16
// products per warp, reloaded every B fragment with ldmatrix and held 64-key
// tiles of K and V in a cp.async ring: bound by shared-memory traffic, issue
// and two blocks an SM.
//
// The design: one warpgroup (4 warps, 128 threads) per block, which owns 64
// queries of one batch·head row (the wgmma M) and walks the keys in tiles of
// kN rows. q arrives by TMA into a 64-row tile in the 128-byte swizzle and is
// scaled in place; each warp then holds its 16 rows of q_s in registers, the
// A operand of every product. K and V tiles arrive by TMA (3-D tensor maps
// over [bh, t, hd], rows and columns past the tensor zero-filled) into a ring
// of kStages stages with a full mbarrier each; one thread starts the copies
// and refills a stage once every thread has passed the block barrier that
// ends its use. Per tile: S = q_s·Kᵀ is one wgmma group with K read K-major
// from shared memory; the bias and mask go on the accumulators; the online
// softmax runs on them (a row lives in one quad of lanes; in a tile of one
// bias per row, the bias and log2 e fold into one FFMA an element); o +=
// round(p)·V is a wgmma with p as the A operand from registers and V, the
// tile that fed S, read MN-major through the transpose bit. qE = q_s·Eᵀ (E
// padded to np_pad zero rows) is one mma.sync product a block before the
// walk, kept in shared memory as bf16 (exact: its values are rounded to
// bf16); np_pad varies with the band, and a wgmma would need an
// instantiation for each width. The bias goes by band per warp (16 rows × kN
// keys): a step whose every j − i ≤ −L adds the row constant qE[i, 0], one
// whose every j − i ≥ R adds qE[i, L + R], only steps that straddle the band
// gather qE per element. The block counts its clip's valid keys (the positive
// entries of the mask row) itself, while q and the first tile are in flight,
// so the wrapper runs no reduction of its own. Key tiles past a clip's length
// are skipped (p = 0), except in a clip with no valid key, which walks them
// all. Blocks are small, 4 an SM at hd ≤ 64 (≈46 KB of shared memory, ≤ 128
// registers a thread); a fifth did not help, nor did a third ring stage or
// 64-key tiles at the main path's lengths. What did: q_s in registers, which
// halves the shared-memory operand traffic of a tile (an S product from
// shared memory re-reads the 8 KB q_s tile for every 32 keys). No atomics:
// two launches give the same bits.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <atomic>

#include "mma_bf16.cuh"
#include "sm90.cuh"

namespace {

using bf16 = __nv_bfloat16;
using ste_sm90::encode_3d;
using ste_sm90::Tile;

constexpr int kThreads = 128;   // one warpgroup
constexpr int kM = 64;          // queries a block owns
constexpr int kN = 32;          // keys of a K/V tile, the columns of a step
constexpr int kStages = 2;      // K/V ring depth
constexpr int kMinBlocks = 4;   // blocks an SM at hd ≤ 64 (≤ 128 registers)
// 1: the relative bias qE[i, clip(j − i) + L] on the scores. 0 (an
// ablation only, scripts/torch_flash_ablate.py): no qE product and no bias,
// i.e. the function with E = 0
constexpr int kRelBias = 1;
constexpr float kNeg = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;

// a score plus its bias (qE at p, or the value b), or the score alone
// without the bias
__device__ __forceinline__ float biased(float s, const bf16* p) {
  if constexpr (kRelBias != 0) return s + ste_sm90::bf_at(p);
  else return s;
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

template <int HD>
struct Smem {
  static constexpr int kQ = Tile<HD, kM>::kBytes;     // q_s
  static constexpr int kKV = Tile<HD, kN>::kBytes;    // a K or V tile
  int q, kv, qe, e, bar, red, total;
  __host__ __device__ explicit Smem(int np_pad) {
    q = 0;
    kv = q + kQ;                         // [stage][k, v]
    qe = kv + kStages * 2 * kKV;         // bf16 [64][np_pad]
    e = qe + kM * np_pad * 2;            // bf16 [np_pad][HD + 8]
    bar = e + np_pad * (HD + 8) * 2;     // [stage], q
    red = bar + (kStages + 1) * 8;       // int [4]: the length's warp sums
    total = red + 16 + 1024;             // + alignment
  }
};

// the number of positive entries of row b of a [B, t] mask (mask_kind 0:
// bool bytes, 1: int32, 2: float32), counted by the block; `red` holds the
// warps' sums
__device__ __forceinline__ int valid_length(const void* mask, int mask_kind,
                                           int b, int t, int tid, int* red) {
  const int64_t base = static_cast<int64_t>(b) * t;
  int n = 0;
  if (mask_kind == 0) {
    const uint8_t* m = static_cast<const uint8_t*>(mask) + base;
    for (int j = tid; j < t; j += kThreads) n += m[j] != 0;
  } else if (mask_kind == 1) {
    const int* m = static_cast<const int*>(mask) + base;
    for (int j = tid; j < t; j += kThreads) n += m[j] > 0;
  } else {
    const float* m = static_cast<const float*>(mask) + base;
    for (int j = tid; j < t; j += kThreads) n += m[j] > 0.0f;
  }
  n = __reduce_add_sync(0xffffffffu, n);
  if ((tid & 31) == 0) red[tid >> 5] = n;
  __syncthreads();
  return red[0] + red[1] + red[2] + red[3];
}

template <int HD>
__global__ void __launch_bounds__(kThreads, HD <= 64 ? kMinBlocks : 2)
flash_rel_fwd_wgmma_kernel(const __grid_constant__ CUtensorMap tm_q,
                           const __grid_constant__ CUtensorMap tm_k,
                           const __grid_constant__ CUtensorMap tm_v,
                           const bf16* __restrict__ e,
                           const void* __restrict__ kv_mask, int mask_kind,
                           bf16* __restrict__ out, float* __restrict__ lse,
                           int t, int t_pad, int num_pos, int np_pad,
                           int left, int nh, float scale) {
  using namespace ste_sm90;
  using ste_mma::acc_to_a;
  using ste_mma::load_b_nk;
  using ste_mma::mma;
  constexpr int kChunks = Tile<HD, kM>::kChunks;
  constexpr int kKV = Smem<HD>::kKV;
  constexpr int LD = HD + 8;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* sm = aligned_smem(smem_raw);
  const Smem<HD> lay(np_pad);
  unsigned char* q_s = sm + lay.q;
  unsigned char* kv_s = sm + lay.kv;
  bf16* qe_s = reinterpret_cast<bf16*>(sm + lay.qe);
  bf16* e_s = reinterpret_cast<bf16*>(sm + lay.e);
  uint64_t* full = reinterpret_cast<uint64_t*>(sm + lay.bar);
  uint64_t* q_bar = full + kStages;
  int* red = reinterpret_cast<int*>(sm + lay.red);

  const int row = blockIdx.y;
  const int i0 = blockIdx.x * kM;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, c4 = lane & 3;
  const int right = num_pos - 1 - left;
  const int lr = left + right;
  const int64_t row_t = static_cast<int64_t>(row) * t;

  auto fetch_kv = [&](int jt, int stage) {   // one thread
    unsigned char* dst = kv_s + stage * 2 * kKV;
    mbar_expect_tx(&full[stage], 2 * kKV);
#pragma unroll
    for (int c = 0; c < kChunks; ++c) {
      tma_load_3d(dst + c * kN * 128, &tm_k, &full[stage], 64 * c, jt * kN,
                  row);
      tma_load_3d(dst + kKV + c * kN * 128, &tm_v, &full[stage], 64 * c,
                  jt * kN, row);
    }
  };
  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) mbar_init(&full[s], 1);
    mbar_init(q_bar, 1);
    mbar_init_fence();
  }
  __syncthreads();
  if (tid == 0) {
    mbar_expect_tx(q_bar, Smem<HD>::kQ);
#pragma unroll
    for (int c = 0; c < kChunks; ++c)
      tma_load_3d(q_s + c * kM * 128, &tm_q, q_bar, 64 * c, i0, row);
    fetch_kv(0, 0);                    // every clip walks its first tile
  }
  if constexpr (kRelBias != 0)
    load_e<HD, kThreads>(e_s, e, num_pos, np_pad, tid);
  const int limit = valid_length(kv_mask, mask_kind, row / nh, t, tid, red);
  // keys at or past the clip's length have p = exp(NEG − m) = 0 unless
  // every key is masked, so only a clip with no valid key walks them all
  const int n_tiles = ((limit > 0 ? limit : t) + kN - 1) / kN;
  if (tid == 0)
    for (int s = 1; s < kStages && s < n_tiles; ++s) fetch_kv(s, s);

  mbar_wait(q_bar, 0);
  // q_s = round(q·scale) in place (elementwise, so the swizzle does not
  // matter; rows past t are zeros and stay so)
  for (int p = tid; p < kChunks * kM * 8; p += kThreads) {
    uint4 raw = *reinterpret_cast<uint4*>(q_s + p * 16);
    __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&raw);
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const float2 f = __bfloat1622float2(h[u]);
      h[u] = __floats2bfloat162_rn(f.x * scale, f.y * scale);
    }
    *reinterpret_cast<uint4*>(q_s + p * 16) = raw;
  }
  __syncthreads();

  const int wr = warp * 16;            // the warp's first row in the tile
  const int li[2] = {wr + g, wr + g + 8};
  const int qi[2] = {i0 + li[0], i0 + li[1]};
  // the warp's 16 rows of q_s, the A operand of every product from here on
  uint32_t qf[HD / 16][4];
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk)
    load_a_sw(qf[kk], q_s, wr, kk * 16, lane);
  float b_lo[2], b_hi[2];
  if constexpr (kRelBias != 0) {
    // qE rows of this warp, rounded to bf16; each warp reads only its own
    // rows
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
        for (int r = 0; r < 2; ++r)
          *reinterpret_cast<__nv_bfloat162*>(
              qe_s + li[r] * np_pad + n0 + nt * 8 + 2 * c4) =
              __floats2bfloat162_rn(acc[nt][2 * r], acc[nt][2 * r + 1]);
    }
    __syncwarp();
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      b_lo[r] = bf_at(qe_s + li[r] * np_pad);
      b_hi[r] = bf_at(qe_s + li[r] * np_pad + lr);
    }
  }
  float o[HD / 2];
#pragma unroll
  for (int x = 0; x < HD / 2; ++x) o[x] = 0.0f;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  const int iw = i0 + wr;

  for (int jt = 0; jt < n_tiles; ++jt) {
    const int st = jt % kStages;
    mbar_wait(&full[st], (jt / kStages) & 1);
    const unsigned char* k_t = kv_s + st * 2 * kKV;
    const unsigned char* v_t = k_t + kKV;
    const int j0 = jt * kN;
    // s = q_s·kᵀ: 64 queries × kN keys, q_s from registers
    float s[kN / 2];
#pragma unroll
    for (int x = 0; x < kN / 2; ++x) s[x] = 0.0f;
    fence_regs(s);
    fence_regs(qf);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk)
      wgmma_rs<kN>(s, qf[kk], desc_k<kN>(k_t, 0, kk), 1);
    wgmma_commit();
    wgmma_wait0();
    fence_regs(s);
    fence_regs(qf);

    // the bias by band and the key mask (warp-uniform branches); without
    // the bias every tile of valid keys takes the row-constant branch
    const bool all_lo = j0 + kN - 1 - iw <= -left;
    const bool all_hi = j0 - (iw + 15) >= right;
    float mx[2] = {-INFINITY, -INFINITY};
    const bool row_const = j0 + kN <= limit && (!kRelBias || all_lo || all_hi);
    float bias[2] = {0.0f, 0.0f};
    if (row_const) {
      // valid keys outside the band: one constant per row, added to the
      // row max here and folded into p's exponent below
#pragma unroll
      for (int x = 0; x < kN / 2; ++x) {
        const int r = (x >> 1) & 1;
        mx[r] = fmaxf(mx[r], s[x]);
      }
      if constexpr (kRelBias != 0) {
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          bias[r] = all_lo ? b_lo[r] : b_hi[r];
          mx[r] += bias[r];
        }
      }
    } else if (j0 + kN <= limit) {
      // valid keys in the band: the bias by element
#pragma unroll
      for (int x = 0; x < kN / 2; ++x) {
        const int r = (x >> 1) & 1;
        const int j = j0 + (x >> 2) * 8 + 2 * c4 + (x & 1);
        const int c = min(max(j - qi[r], -left), right) + left;
        s[x] += bf_at(qe_s + li[r] * np_pad + c);
        mx[r] = fmaxf(mx[r], s[x]);
      }
    } else {
      // the last tile: masked keys and keys past t
#pragma unroll
      for (int x = 0; x < kN / 2; ++x) {
        const int r = (x >> 1) & 1;
        const int j = j0 + (x >> 2) * 8 + 2 * c4 + (x & 1);
        float sv;
        if (j >= t) {
          sv = -INFINITY;                        // past the last key
        } else if (j >= limit) {
          sv = kNeg;                             // masked key
        } else {
          const int c = min(max(j - qi[r], -left), right) + left;
          sv = biased(s[x], qe_s + li[r] * np_pad + c);
        }
        s[x] = sv;
        mx[r] = fmaxf(mx[r], sv);
      }
    }
    // the online softmax, once a tile
    float corr[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float m_new = fmaxf(m[r], mx[r]);
      corr[r] = __expf(m[r] - m_new);
      m[r] = m_new;
      l[r] *= corr[r];
    }
#pragma unroll
    for (int x = 0; x < HD / 2; ++x) o[x] *= corr[(x >> 1) & 1];
    if (row_const) {
      // p = 2^(s·log2 e − (m − bias)·log2 e), one FFMA an element (every
      // key is valid, so m is finite; a row of NEG would lose p = 1 here)
      float ms[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) ms[r] = (m[r] - bias[r]) * kLog2e;
#pragma unroll
      for (int x = 0; x < kN / 2; ++x) {
        const int r = (x >> 1) & 1;
        const float p = ex2(fmaf(s[x], kLog2e, -ms[r]));
        l[r] += p;
        s[x] = p;
      }
    } else {
#pragma unroll
      for (int x = 0; x < kN / 2; ++x) {
        const int r = (x >> 1) & 1;
        const float p = __expf(s[x] - m[r]);
        l[r] += p;
        s[x] = p;
      }
    }
    // o += round(p)·v: A = p from registers, B = the same V tile read
    // MN-major
    uint32_t a[kN / 16][4];
#pragma unroll
    for (int kk = 0; kk < kN / 16; ++kk)
      acc_to_a(a[kk], &s[8 * kk], &s[8 * kk + 4]);
    fence_regs(a);
    fence_regs(o);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kN / 16; ++kk)
      wgmma_rs_t<HD>(o, a[kk], desc_mn<kN>(v_t, 16 * kk), 1);
    wgmma_commit();
    wgmma_wait0();
    fence_regs(a);
    fence_regs(o);
    __syncthreads();                       // every thread is done with st
    if (tid == 0 && jt + kStages < n_tiles) fetch_kv(jt + kStages, st);
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    // the padded keys t..t_pad-1 (score NEG, value 0): they count only in
    // a row whose every key is masked (m == NEG)
    l[r] += static_cast<float>(t_pad - t) * __expf(kNeg - m[r]);
    if (qi[r] >= t) continue;
    bf16* orow = out + (row_t + qi[r]) * HD;
#pragma unroll
    for (int dt = 0; dt < HD / 8; ++dt)
      *reinterpret_cast<__nv_bfloat162*>(orow + dt * 8 + 2 * c4) =
          __floats2bfloat162_rn(o[4 * dt + 2 * r] / l[r],
                                o[4 * dt + 2 * r + 1] / l[r]);
    if (c4 == 0) lse[row_t + qi[r]] = m[r] + logf(l[r]);
  }
}

template <int HD>
int launch(const void* q, const void* k, const void* v, const void* e,
           const void* kv_mask, int mask_kind, void* out, float* lse, int bh,
           int t,
           int t_pad, int num_pos, int np_pad, int left, int nh, float scale,
           int device, cudaStream_t stream) {
  CUtensorMap m_q, m_k, m_v;
  if (!encode_3d(&m_q, q, bh, t, HD, 64, kM, true) ||
      !encode_3d(&m_k, k, bh, t, HD, 64, kN, true) ||
      !encode_3d(&m_v, v, bh, t, HD, 64, kN, true))
    return static_cast<int>(cudaErrorInvalidValue);
  auto kern = flash_rel_fwd_wgmma_kernel<HD>;
  // the shared memory of the largest band (np_pad 128), set once per
  // instantiation and device
  static std::atomic<uint32_t> ready{0};
  const uint32_t bit = device < 32 ? 1u << device : 0u;
  if (!(ready.load() & bit)) {
    const cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
        Smem<HD>(128).total);
    if (err != cudaSuccess) return static_cast<int>(err);
    ready.fetch_or(bit);
  }
  using bf = __nv_bfloat16;
  const dim3 grid((t + kM - 1) / kM, bh);
  kern<<<grid, kThreads, Smem<HD>(np_pad).total, stream>>>(
      m_q, m_k, m_v, static_cast<const bf*>(e), kv_mask, mask_kind,
      static_cast<bf*>(out), lse, t, t_pad, num_pos, np_pad, left, nh, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// bf16 only, hd a multiple of 16 up to 128; q, k, v, E contiguous with a
// 16-byte aligned start; kv_mask a contiguous [bh / nh, t] mask of bool
// bytes (mask_kind 0), int32 (1) or float32 (2), a key valid where its
// entry is positive. Returns cudaGetLastError() after the launch, or
// cudaErrorInvalidValue for shapes the kernel does not take or a tensor map
// that cannot be encoded.
extern "C" int ste_flash_rel_fwd_wgmma(const void* q, const void* k,
                                       const void* v, const void* e,
                                       const void* kv_mask, int mask_kind,
                                       void* out, float* lse, int bh, int t,
                                       int t_pad, int hd, int num_pos,
                                       int left, int nh, float scale,
                                       int device, void* stream) {
  const int np_pad = (num_pos + 15) / 16 * 16;
  if (hd % 16 != 0 || hd < 16 || hd > 128 || num_pos < 1 || num_pos > 128 ||
      t < 1 || t_pad < t || nh < 1 || left < 0 || left >= num_pos ||
      bh < 1 || mask_kind < 0 || mask_kind > 2)
    return static_cast<int>(cudaErrorInvalidValue);
  int current = -1;
  if (cudaGetDevice(&current) != cudaSuccess || current != device)
    cudaSetDevice(device);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define STE_LAUNCH(HD)                                                       \
  return launch<HD>(q, k, v, e, kv_mask, mask_kind, out, lse, bh, t, t_pad, \
                    num_pos, np_pad, left, nh, scale, device, s)
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
