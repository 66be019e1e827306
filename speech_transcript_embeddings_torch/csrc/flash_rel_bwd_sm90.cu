// Relative_key flash attention, backward, bf16 on Hopper's wgmma fed by TMA.
//
// Replaces the Pallas TPU kernel
// speech_transcript_embeddings_tpu/ops/flash_attention.py::_bwd_kernel (:278)
// for bf16 inputs with hd a multiple of 16 up to 128 (the conformer's hd 64):
// the same gradients and rounding points as flash_rel_bwd.cu's header states
// and as rel_attention_bwd_reference computes (p rounded for dv, ds rounded
// for dq and dk, dqE fp32 with the padded keys, dq += round(dqE)·E then
// scaled in fp32 and rounded, dE = Σ dqEᵀ·q_s with dqE unrounded).
//
// What bounds it on an H100: ≈10·T²·hd FLOP a row (the seven T×T×hd products
// of the two kernels, five of them distinct) against ≈16·T·hd bytes, so the
// tensor cores, whose full rate only wgmma reaches. The mma.sync pair this
// replaces ran 16×8×16 products per warp and reloaded every B fragment
// with ldmatrix, so shared-memory traffic and instruction count bound it;
// its kernel B streamed an fp32 qE row per key tile, and the wrapper
// computed dd in two more passes.
//
// The design: one warpgroup (4 warps, 128 threads) per block, which owns 64
// rows (the wgmma M) and walks the other side in tiles of 32 rows, one
// 64×32 step each. Every T×T×hd product is a wgmma (m64nNk16, bf16 in, fp32
// in registers): the two score products read both operands from shared
// memory (K-major); the gradient products take round(p) or round(ds) from
// the score accumulators as the A operand in registers and read the same
// tile the score product used, MN-major through the transpose bit, so each
// tile is loaded once and feeds every product. Tiles arrive by TMA (3-D
// tensor maps over [bh, t, hd], rows past t zero-filled, the 128-byte
// swizzle) into a ring of stages with a full mbarrier each; one
// thread starts the copies and refills a stage once every thread has
// passed the block barrier that ends its use. The loop is latency-bound
// (each step waits for its products), so blocks are kept small for
// residency, 4 an SM at hd ≤ 64: 32-row tiles, and in kernel A one stage
// and E staged through space that is free at the time (its shared
// memory), in kernel B ≤ 128 registers a thread. The FlashAttention-2
// split into two kernels stays (no block carries a sum, no atomics, two
// launches give the same bits):
//
//   kernel A (dq_wgmma), one block per (row, 64 queries), walks the key
//   tiles: S = q_s·Kᵀ, dP = dO·Vᵀ, dq += round(dS)·K. Before the walk it
//   computes q_s = round(q·scale), dd = rowsum(dO∘O) in fp32 and qE =
//   round(q_s·Eᵀ), and writes q_s (bf16), qE (bf16, exact: its values are
//   rounded to bf16) and dd (fp32) to scratch for kernel B. After it, dq +=
//   round(dqE)·E and the block's dE partial Σ_i dqE[i]·q_s[i] (fp32 dqE as a
//   bf16 hi + lo pair) run once a block on mma.sync.
//   kernel B (dkv_wgmma), one block per (row, 64 keys), walks the query
//   tiles: Sᵀ = K·q_sᵀ, dPᵀ = V·dOᵀ, dv += round(Pᵀ)·dO, dk += round(dSᵀ)·q_s,
//   with q_s, dO and qE by TMA and lse and dd by plain loads (a row of t
//   fp32 values is not 16-byte aligned when t % 4 ≠ 0).
//
// The relative bias by its band, per warp (16 rows × 32 columns): a step
// whose every j − i ≤ −L adds the row constant qE[i, 0], one whose every
// j − i ≥ R adds qE[i, L + R], only steps that straddle the band gather qE
// per element. In kernel A an interior bias column c (0 < c < L + R) gets
// one key per query, so each lane adds its ds to dqE[i, c] in shared memory
// without a race; the two clipped columns take a per-lane sum reduced over
// the quad in a fixed order. Key tiles past a clip's length are skipped
// (p = 0), except in a clip with no valid frame (lse = NEG, p = 1 on every
// key), where every key and, for dqE, every padded key t..t_pad−1 counts.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "mma_bf16.cuh"
#include "sm90.cuh"

namespace {

using bf16 = __nv_bfloat16;
using ste_sm90::align1k;
using ste_sm90::encode_3d;
using ste_sm90::max_of;
using ste_sm90::Tile;

constexpr int kThreads = 128;   // one warpgroup
constexpr int kM = 64;          // rows a block owns: queries (A), keys (B)
constexpr int kN = 32;          // rows of a streamed tile, the columns of a
                                // step: keys (A), queries (B)
// TMA ring depths: kernel A trades its second stage for a fourth block an
// SM (hd ≤ 64), which hides more of the walk's latency than prefetching does
constexpr int kStagesA = 1;
constexpr int kStagesB = 2;
// 1: the relative bias on the recomputed scores (kernels A and B) and its
// gradient dqE (kernel A: dq += round(dqE)·E and the dE partials). 0 (an
// ablation only, scripts/torch_flash_ablate.py): kRelBias = 0 recomputes p
// without qE (the function with E = 0, as the forward built with it);
// kRelBiasGrad = 0 drops dqE, so dq has no E term and dE is 0
constexpr int kRelBias = 1;
constexpr int kRelBiasGrad = 1;
constexpr float kNeg = -1e30f;

// a score plus its bias (qE at p, or the value b), or the score alone
// without the bias
__device__ __forceinline__ float biased(float s, const bf16* p) {
  if constexpr (kRelBias != 0) return s + ste_sm90::bf_at(p);
  else return s;
}

__device__ __forceinline__ float biased(float s, float b) {
  if constexpr (kRelBias != 0) return s + b;
  else return s;
}

// B fragments of two n-tiles (16 k × 16 n) of a swizzled 64-row [k][n] tile
__device__ __forceinline__ void load_b_kn_sw(uint32_t* b,
                                             const unsigned char* tile,
                                             int k0, int n0, int lane) {
  const int r = k0 + (lane & 7) + ((lane >> 3) & 1) * 8;
  const int c = n0 + (lane >> 4) * 8;
  ste_mma::ldsm_x4_t(b, tile + ste_sm90::sw_off<kM>(r, c));
}

// ---- kernel A: dq, dqE, q_s, qE, dd and the dE partials --------------------

template <int HD>
struct SmemA {
  static constexpr int kQ = Tile<HD, kM>::kBytes;     // q_s or dO
  static constexpr int kKV = Tile<HD, kN>::kBytes;    // a K or V tile
  int q, d, kv, qe, dqe, dd, bar, total;
  __host__ __device__ explicit SmemA(int np_pad) {
    const int e_bytes = np_pad * (HD + 8) * 2;
    q = 0;
    d = q + kQ;               // dO; with the ring, E after the key walk
    kv = d + kQ;              // [stage][k, v]
    qe = kv + align1k(max_of(kStagesA * 2 * kKV, e_bytes - kQ));  // bf16
    dqe = qe + align1k(kM * np_pad * 2);   // f32 [64][np_pad]; E before
    dd = dqe + align1k(max_of(kM * np_pad * 4, e_bytes));   // f32 [64]
    bar = dd + kM * 4;                     // [stage], q/dO
    total = bar + (kStagesA + 1) * 8 + 1024;   // + alignment
  }
};

template <int HD>
__global__ void __launch_bounds__(kThreads, HD <= 64 ? 4 : 1)
flash_rel_bwd_dq_wgmma_kernel(
    const __grid_constant__ CUtensorMap tm_q,
    const __grid_constant__ CUtensorMap tm_k,
    const __grid_constant__ CUtensorMap tm_v,
    const __grid_constant__ CUtensorMap tm_do, const bf16* __restrict__ e,
    const int* __restrict__ lengths, const bf16* __restrict__ out,
    const float* __restrict__ lse, bf16* __restrict__ dq,
    bf16* __restrict__ qs_out, bf16* __restrict__ qe_out,
    float* __restrict__ dd_out, float* __restrict__ de_part, int t,
    int t_pad, int num_pos, int np_pad, int left, int nh, float scale,
    float dq_scale) {
  using namespace ste_sm90;
  using ste_mma::acc_to_a;
  using ste_mma::load_b_kn;
  using ste_mma::load_b_nk;
  using ste_mma::mma;
  using ste_mma::pack_bf16;
  using ste_mma::round_bf16;
  constexpr int kChunks = Tile<HD, kM>::kChunks;
  constexpr int kKV = SmemA<HD>::kKV;
  constexpr int LD = HD + 8;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* sm = aligned_smem(smem_raw);
  const SmemA<HD> lay(np_pad);
  unsigned char* q_s = sm + lay.q;
  unsigned char* do_s = sm + lay.d;
  unsigned char* kv_s = sm + lay.kv;
  bf16* qe_s = reinterpret_cast<bf16*>(sm + lay.qe);
  float* dqe_s = reinterpret_cast<float*>(sm + lay.dqe);
  float* dd_s = reinterpret_cast<float*>(sm + lay.dd);
  uint64_t* full = reinterpret_cast<uint64_t*>(sm + lay.bar);
  uint64_t* qd_bar = full + kStagesA;

  const int row = blockIdx.y;
  const int i0 = blockIdx.x * kM;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, c4 = lane & 3;
  const int limit = lengths[row / nh];
  const int right = num_pos - 1 - left;
  const int lr = left + right;
  const int64_t base = static_cast<int64_t>(row) * t * HD;
  const int64_t row_t = static_cast<int64_t>(row) * t;
  // keys at or past the clip's length have p = exp(NEG − lse) = 0 unless
  // every key is masked (lse = NEG), so only such a clip walks them all
  const int n_tiles = ((limit > 0 ? limit : t) + kN - 1) / kN;

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
    for (int s = 0; s < kStagesA; ++s) mbar_init(&full[s], 1);
    mbar_init(qd_bar, 1);
    mbar_init_fence();
  }
  __syncthreads();
  if (tid == 0) {
    mbar_expect_tx(qd_bar, 2 * SmemA<HD>::kQ);
#pragma unroll
    for (int c = 0; c < kChunks; ++c) {
      tma_load_3d(q_s + c * kM * 128, &tm_q, qd_bar, 64 * c, i0, row);
      tma_load_3d(do_s + c * kM * 128, &tm_do, qd_bar, 64 * c, i0, row);
    }
    for (int s = 0; s < kStagesA && s < n_tiles; ++s) fetch_kv(s, s);
  }
  // E for the qE product, in the space dqE takes later
  bf16* e_s = reinterpret_cast<bf16*>(dqe_s);
  if constexpr (kRelBias != 0)
    load_e<HD, kThreads>(e_s, e, num_pos, np_pad, tid);

  mbar_wait(qd_bar, 0);
  // q_s = round(q·scale) in place (elementwise, so the swizzle does not
  // matter), and to scratch for kernel B
  for (int p = tid; p < kChunks * kM * 8; p += kThreads) {
    const int r = (p >> 3) & (kM - 1);
    const int col = (p >> 9) * 64 + (((p & 7) ^ (r & 7)) << 3);
    uint4 raw = *reinterpret_cast<uint4*>(q_s + p * 16);
    __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&raw);
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const float2 f = __bfloat1622float2(h[u]);
      h[u] = __floats2bfloat162_rn(f.x * scale, f.y * scale);
    }
    *reinterpret_cast<uint4*>(q_s + p * 16) = raw;
    if (i0 + r < t && col < HD)
      *reinterpret_cast<uint4*>(qs_out + base + (i0 + r) * HD + col) = raw;
  }
  // dd = rowsum(dO∘O) in fp32: two threads a row, each summing its half of
  // the columns in order, then half 0 + half 1
  {
    const int r = tid >> 1, half = tid & 1;
    const bool in = i0 + r < t;
    float acc = 0.0f;
    for (int gi = half * (HD / 16); gi < (half + 1) * (HD / 16); ++gi) {
      const uint4 dr = *reinterpret_cast<const uint4*>(
          do_s + sw_off<kM>(r, gi * 8));
      uint4 orw = make_uint4(0, 0, 0, 0);
      if (in)
        orw = *reinterpret_cast<const uint4*>(out + base + (i0 + r) * HD +
                                              gi * 8);
      const __nv_bfloat162* dh = reinterpret_cast<const __nv_bfloat162*>(&dr);
      const __nv_bfloat162* oh = reinterpret_cast<const __nv_bfloat162*>(&orw);
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const float2 a = __bfloat1622float2(dh[u]);
        const float2 b = __bfloat1622float2(oh[u]);
        acc = fmaf(a.x, b.x, acc);
        acc = fmaf(a.y, b.y, acc);
      }
    }
    const float other = __shfl_xor_sync(0xffffffffu, acc, 1);
    const float dd_v = half == 0 ? acc + other : other + acc;
    if (half == 0) {
      dd_s[r] = in ? dd_v : 0.0f;
      if (in) dd_out[row_t + i0 + r] = dd_v;
    }
  }
  fence_proxy_async();   // q_s (written here) is read by wgmma
  __syncthreads();

  const int wr = warp * 16;
  const int li[2] = {wr + g, wr + g + 8};
  const int qi[2] = {i0 + li[0], i0 + li[1]};
  // qE rows of this warp, rounded to bf16 (smem and scratch)
  if constexpr (kRelBias != 0) {
    for (int n0 = 0; n0 < np_pad; n0 += 16) {
      float acc[2][4] = {};
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk) {
        uint32_t a[4], b[4];
        load_a_sw(a, q_s, wr, kk * 16, lane);
        load_b_nk(b, e_s + n0 * LD + kk * 16, LD, lane);
        mma(acc[0], a, b);
        mma(acc[1], a, b + 2);
      }
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int col = n0 + nt * 8 + 2 * c4;
          const __nv_bfloat162 v =
              __floats2bfloat162_rn(acc[nt][2 * r], acc[nt][2 * r + 1]);
          *reinterpret_cast<__nv_bfloat162*>(qe_s + li[r] * np_pad + col) =
              v;
          if (qi[r] < t)
            *reinterpret_cast<__nv_bfloat162*>(
                qe_out + (row_t + qi[r]) * np_pad + col) = v;
        }
    }
  }
  __syncthreads();       // E is read: its space becomes dqE = 0
  if constexpr (kRelBiasGrad != 0) {
    for (int idx = tid; idx < kM * np_pad; idx += kThreads) dqe_s[idx] = 0.0f;
    __syncthreads();
  }

  float lse_r[2], dd_r[2], b_lo[2], b_hi[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    lse_r[r] = qi[r] < t ? lse[row_t + qi[r]] : INFINITY;   // p = 0 past t
    dd_r[r] = dd_s[li[r]];
    if constexpr (kRelBias != 0) {
      b_lo[r] = bf_at(qe_s + li[r] * np_pad);
      b_hi[r] = bf_at(qe_s + li[r] * np_pad + lr);
    } else {
      b_lo[r] = b_hi[r] = 0.0f;
    }
  }
  float dqa[HD / 2];
#pragma unroll
  for (int x = 0; x < HD / 2; ++x) dqa[x] = 0.0f;
  float lo[2] = {0.f, 0.f}, hi[2] = {0.f, 0.f};   // dqE[:, 0], dqE[:, L+R]
  const int iw = i0 + wr;

  for (int jt = 0; jt < n_tiles; ++jt) {
    const int st = jt % kStagesA;
    mbar_wait(&full[st], (jt / kStagesA) & 1);
    const unsigned char* k_t = kv_s + st * 2 * kKV;
    const unsigned char* v_t = k_t + kKV;
    const int j0 = jt * kN;
    // s = q_s·kᵀ and dP = dO·vᵀ: 64 queries × 32 keys
    float s[kN / 2], dp[kN / 2];
#pragma unroll
    for (int x = 0; x < kN / 2; ++x) s[x] = dp[x] = 0.0f;
    fence_regs(s);
    fence_regs(dp);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk)
      wgmma_ss<kN>(s, desc_k<kM>(q_s, 0, kk), desc_k<kN>(k_t, 0, kk), 1);
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk)
      wgmma_ss<kN>(dp, desc_k<kM>(do_s, 0, kk), desc_k<kN>(v_t, 0, kk), 1);
    wgmma_commit();
    wgmma_wait0();
    fence_regs(s);
    fence_regs(dp);
    const bool all_lo = j0 + kN - 1 - iw <= -left;
    const bool all_hi = j0 - (iw + 15) >= right;
    // with neither the bias nor its gradient, every tile of valid keys
    // takes the first branch
    if (j0 + kN <= limit &&
        (!(kRelBias || kRelBiasGrad) || all_lo || all_hi)) {
      // valid keys outside the band: a row-constant bias, whose gradient
      // is the row sum of ds
#pragma unroll
      for (int x = 0; x < kN / 2; ++x) {
        const int r = (x >> 1) & 1;
        const float p = __expf(biased(s[x], all_lo ? b_lo[r] : b_hi[r]) -
                               lse_r[r]);
        const float ds = p * (dp[x] - dd_r[r]);
        if constexpr (kRelBiasGrad != 0) {
          if (all_lo) lo[r] += ds;
          else hi[r] += ds;
        }
        s[x] = ds;
      }
    } else if (j0 + kN <= limit) {
      // valid keys in the band: the bias and its gradient by element; an
      // interior column c gets one key per query, so no race
#pragma unroll
      for (int x = 0; x < kN / 2; ++x) {
        const int r = (x >> 1) & 1;
        const int j = j0 + (x >> 2) * 8 + 2 * c4 + (x & 1);
        const int c = min(max(j - qi[r], -left), right) + left;
        const float p = __expf(biased(s[x], qe_s + li[r] * np_pad + c) -
                               lse_r[r]);
        const float ds = p * (dp[x] - dd_r[r]);
        if constexpr (kRelBiasGrad != 0) {
          lo[r] += c == 0 ? ds : 0.0f;
          hi[r] += c == lr ? ds : 0.0f;
          if (c > 0 && c < lr) dqe_s[li[r] * np_pad + c] += ds;
        }
        s[x] = ds;
      }
    } else {
      // the last tile: masked keys and keys past t
#pragma unroll
      for (int x = 0; x < kN / 2; ++x) {
        const int r = (x >> 1) & 1;
        const int j = j0 + (x >> 2) * 8 + 2 * c4 + (x & 1);
        float ds = 0.0f;
        if (j < t) {
          const int c = min(max(j - qi[r], -left), right) + left;
          const float sv = j >= limit
              ? kNeg : biased(s[x], qe_s + li[r] * np_pad + c);
          const float p = __expf(sv - lse_r[r]);
          ds = p * (dp[x] - dd_r[r]);
          // an interior column c gets one key per query: no race
          if constexpr (kRelBiasGrad != 0) {
            if (c == 0) lo[r] += ds;
            else if (c == lr) hi[r] += ds;
            else dqe_s[li[r] * np_pad + c] += ds;
          }
        }
        s[x] = ds;
      }
    }
    __syncwarp();
    // dq += round(ds)·k: A = ds from registers, B = the same K tile read
    // MN-major
    uint32_t a[kN / 16][4];
#pragma unroll
    for (int kk = 0; kk < kN / 16; ++kk)
      acc_to_a(a[kk], &s[8 * kk], &s[8 * kk + 4]);
    fence_regs(a);
    fence_regs(dqa);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kN / 16; ++kk)
      wgmma_rs_t<HD>(dqa, a[kk], desc_mn<kN>(k_t, 16 * kk), 1);
    wgmma_commit();
    wgmma_wait0();
    fence_regs(a);
    fence_regs(dqa);
    __syncthreads();                       // every thread is done with st
    if (tid == 0 && jt + kStagesA < n_tiles) fetch_kv(jt + kStagesA, st);
  }

  if constexpr (kRelBiasGrad != 0) {
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
    // E again, in the space dO and the K/V ring took (every tile was waited
    // for)
    e_s = reinterpret_cast<bf16*>(do_s);
    load_e<HD, kThreads>(e_s, e, num_pos, np_pad, tid);
    __syncthreads();

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
        mma(&dqa[8 * dp2], a, b);
        mma(&dqa[8 * dp2 + 4], a, b + 2);
      }
    }
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (qi[r] >= t) continue;
    bf16* drow = dq + base + qi[r] * HD;
#pragma unroll
    for (int dt = 0; dt < HD / 8; ++dt)
      *reinterpret_cast<__nv_bfloat162*>(drow + dt * 8 + 2 * c4) =
          __floats2bfloat162_rn(round_bf16(dqa[4 * dt + 2 * r]) * dq_scale,
                                round_bf16(dqa[4 * dt + 2 * r + 1]) *
                                    dq_scale);
  }

  // dE partial of this block: Σ_i dqE[i, c]·q_s[i, d], dqE as hi + lo bf16
  float* part = de_part +
      (static_cast<int64_t>(row) * gridDim.x + blockIdx.x) * num_pos * HD;
  if constexpr (kRelBiasGrad == 0) {
    for (int idx = tid; idx < num_pos * HD; idx += kThreads)
      part[idx] = 0.0f;
    return;
  }
  for (int mt = warp; mt < np_pad / 16; mt += kThreads / 32) {
    float acc[HD / 8][4] = {};
#pragma unroll
    for (int ks = 0; ks < kM / 16; ++ks) {
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
        load_b_kn_sw(b, q_s, ks * 16, dp2 * 16, lane);
        mma(acc[2 * dp2], ahi, b);
        mma(acc[2 * dp2 + 1], ahi, b + 2);
        mma(acc[2 * dp2], alo, b);
        mma(acc[2 * dp2 + 1], alo, b + 2);
      }
    }
#pragma unroll
    for (int dt = 0; dt < HD / 8; ++dt)
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int c = mt * 16 + g + 8 * r;
        if (c < num_pos)
          *reinterpret_cast<float2*>(part + c * HD + dt * 8 + 2 * c4) =
              make_float2(acc[dt][2 * r], acc[dt][2 * r + 1]);
      }
  }
}

// ---- kernel B: dk and dv ----------------------------------------------------

template <int HD>
struct SmemB {
  static constexpr int kKV = Tile<HD, kM>::kBytes;    // K or V
  static constexpr int kQ = Tile<HD, kN>::kBytes;     // a q_s or dO tile
  int k, v, stage, stage_bytes, qe_off, ld_off, bar, total;
  __host__ __device__ explicit SmemB(int np_pad) {
    k = 0;
    v = kKV;
    stage = 2 * kKV;                  // [stage][q_s, dO, qE, lse, dd]
    qe_off = 2 * kQ;
    ld_off = qe_off + align1k(kN * np_pad * 2);
    stage_bytes = ld_off + 1024;      // lse and dd, 32 fp32 each
    bar = stage + kStagesB * stage_bytes;   // [stage], k/v
    total = bar + (kStagesB + 1) * 8 + 1024;
  }
};

template <int HD>
__global__ void __launch_bounds__(kThreads, HD <= 64 ? 4 : 1)
flash_rel_bwd_dkv_wgmma_kernel(
    const __grid_constant__ CUtensorMap tm_k,
    const __grid_constant__ CUtensorMap tm_v,
    const __grid_constant__ CUtensorMap tm_qs,
    const __grid_constant__ CUtensorMap tm_do,
    const __grid_constant__ CUtensorMap tm_qe,
    const int* __restrict__ lengths, const float* __restrict__ lse,
    const float* __restrict__ dd, bf16* __restrict__ dk,
    bf16* __restrict__ dv, int t, int num_pos, int np_pad, int left,
    int nh) {
  using namespace ste_sm90;
  using ste_mma::acc_to_a;
  constexpr int kChunks = Tile<HD, kM>::kChunks;
  constexpr int kQ = SmemB<HD>::kQ;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* sm = aligned_smem(smem_raw);
  const SmemB<HD> lay(np_pad);
  unsigned char* k_s = sm + lay.k;
  unsigned char* v_s = sm + lay.v;
  uint64_t* full = reinterpret_cast<uint64_t*>(sm + lay.bar);
  uint64_t* kv_bar = full + kStagesB;

  const int row = blockIdx.y;
  const int j0 = blockIdx.x * kM;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, c4 = lane & 3;
  const int limit = lengths[row / nh];
  const int right = num_pos - 1 - left;
  const int64_t base = static_cast<int64_t>(row) * t * HD;
  const int64_t row_t = static_cast<int64_t>(row) * t;
  const int n_tiles = (t + kN - 1) / kN;
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

  auto stage_at = [&](int s) { return sm + lay.stage + s * lay.stage_bytes; };
  const int q_bytes = 2 * kQ + (kRelBias ? kN * np_pad * 2 : 0);
  auto fetch_q = [&](int it, int s) {          // one thread
    unsigned char* dst = stage_at(s);
    mbar_expect_tx(&full[s], q_bytes);
#pragma unroll
    for (int c = 0; c < kChunks; ++c) {
      tma_load_3d(dst + c * kN * 128, &tm_qs, &full[s], 64 * c, it * kN,
                  row);
      tma_load_3d(dst + kQ + c * kN * 128, &tm_do, &full[s], 64 * c,
                  it * kN, row);
    }
    if constexpr (kRelBias != 0)
      tma_load_3d(dst + lay.qe_off, &tm_qe, &full[s], 0, it * kN, row);
  };
  auto load_ld = [&](int it, int s) {          // plain loads, 32 threads
    float* ld = reinterpret_cast<float*>(stage_at(s) + lay.ld_off);
    if (tid < kN) {
      const int i = it * kN + tid;
      ld[tid] = i < t ? lse[row_t + i] : INFINITY;   // p = 0 past t
      ld[kN + tid] = i < t ? dd[row_t + i] : 0.0f;
    }
  };
  if (tid == 0) {
    for (int s = 0; s < kStagesB; ++s) mbar_init(&full[s], 1);
    mbar_init(kv_bar, 1);
    mbar_init_fence();
  }
  __syncthreads();
  if (tid == 0) {
    mbar_expect_tx(kv_bar, 2 * SmemB<HD>::kKV);
#pragma unroll
    for (int c = 0; c < kChunks; ++c) {
      tma_load_3d(k_s + c * kM * 128, &tm_k, kv_bar, 64 * c, j0, row);
      tma_load_3d(v_s + c * kM * 128, &tm_v, kv_bar, 64 * c, j0, row);
    }
    for (int s = 0; s < kStagesB && s < n_tiles; ++s) fetch_q(s, s);
  }
  for (int s = 0; s < kStagesB && s < n_tiles; ++s) load_ld(s, s);
  __syncthreads();
  mbar_wait(kv_bar, 0);

  float dka[HD / 2], dva[HD / 2];
#pragma unroll
  for (int x = 0; x < HD / 2; ++x) dka[x] = dva[x] = 0.0f;
  const bool keys_valid = j0 + wr + 16 <= limit;   // every key of the warp
  const int jw = j0 + wr;

  for (int it = 0; it < n_tiles; ++it) {
    const int st = it % kStagesB;
    mbar_wait(&full[st], (it / kStagesB) & 1);
    const unsigned char* q_t = stage_at(st);
    const unsigned char* do_t = q_t + kQ;
    const bf16* qe_t = reinterpret_cast<const bf16*>(q_t + lay.qe_off);
    const float* lse_t = reinterpret_cast<const float*>(q_t + lay.ld_off);
    const float* dd_t = lse_t + kN;
    const int iq = it * kN;
    // sᵀ = k·q_sᵀ and dPᵀ = v·dOᵀ: 64 keys × 32 queries
    float s[kN / 2], dp[kN / 2];
#pragma unroll
    for (int x = 0; x < kN / 2; ++x) s[x] = dp[x] = 0.0f;
    fence_regs(s);
    fence_regs(dp);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk)
      wgmma_ss<kN>(s, desc_k<kM>(k_s, 0, kk), desc_k<kN>(q_t, 0, kk), 1);
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk)
      wgmma_ss<kN>(dp, desc_k<kM>(v_s, 0, kk), desc_k<kN>(do_t, 0, kk), 1);
    wgmma_commit();
    wgmma_wait0();
    fence_regs(s);
    fence_regs(dp);
    const bool all_lo = jw + 15 - iq <= -left;
    const bool all_hi = jw - (iq + kN - 1) >= right;
    if (keys_valid && (!kRelBias || all_lo || all_hi)) {
      // valid keys outside the band: the bias is qE[i, 0] or qE[i, L+R]
      // (every tile of valid keys without the bias)
      const int c = all_lo ? 0 : left + right;
#pragma unroll
      for (int x = 0; x < kN / 2; ++x) {
        const int il = (x >> 2) * 8 + 2 * c4 + (x & 1);
        const float p = __expf(biased(s[x], qe_t + il * np_pad + c) -
                               lse_t[il]);              // 0 for queries ≥ t
        dp[x] = p * (dp[x] - dd_t[il]);
        s[x] = p;
      }
    } else if (keys_valid) {
      // valid keys in the band: the bias by element
#pragma unroll
      for (int x = 0; x < kN / 2; ++x) {
        const int il = (x >> 2) * 8 + 2 * c4 + (x & 1);
        const int c = min(max(kj[(x >> 1) & 1] - iq - il, -left), right) +
                      left;
        const float p = __expf(biased(s[x], qe_t + il * np_pad + c) -
                               lse_t[il]);              // 0 for queries ≥ t
        dp[x] = p * (dp[x] - dd_t[il]);
        s[x] = p;
      }
    } else {
      // keys at or past the clip's length or t
#pragma unroll
      for (int x = 0; x < kN / 2; ++x) {
        const int j = kj[(x >> 1) & 1];
        const int il = (x >> 2) * 8 + 2 * c4 + (x & 1);
        float p = 0.0f, ds = 0.0f;
        if (j < t) {
          const int c = min(max(j - iq - il, -left), right) + left;
          const float sv = j >= limit
              ? kNeg : biased(s[x], qe_t + il * np_pad + c);
          p = __expf(sv - lse_t[il]);
          ds = p * (dp[x] - dd_t[il]);
        }
        s[x] = p;
        dp[x] = ds;
      }
    }
    __syncwarp();
    // dv += round(pᵀ)·dO, dk += round(dsᵀ)·q_s: A from registers, B the
    // same dO and q_s tiles read MN-major
    uint32_t pa[kN / 16][4], sa[kN / 16][4];
#pragma unroll
    for (int kk = 0; kk < kN / 16; ++kk) {
      acc_to_a(pa[kk], &s[8 * kk], &s[8 * kk + 4]);
      acc_to_a(sa[kk], &dp[8 * kk], &dp[8 * kk + 4]);
    }
    fence_regs(pa);
    fence_regs(sa);
    fence_regs(dka);
    fence_regs(dva);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kN / 16; ++kk) {
      wgmma_rs_t<HD>(dva, pa[kk], desc_mn<kN>(do_t, 16 * kk), 1);
      wgmma_rs_t<HD>(dka, sa[kk], desc_mn<kN>(q_t, 16 * kk), 1);
    }
    wgmma_commit();
    wgmma_wait0();
    fence_regs(pa);
    fence_regs(sa);
    fence_regs(dka);
    fence_regs(dva);
    __syncthreads();                       // every thread is done with st
    if (it + kStagesB < n_tiles) {
      if (tid == 0) fetch_q(it + kStagesB, st);
      load_ld(it + kStagesB, st);   // read after the next block barrier
    }
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (kj[r] >= t) continue;
    const int64_t off = base + kj[r] * HD;
#pragma unroll
    for (int dt = 0; dt < HD / 8; ++dt) {
      *reinterpret_cast<__nv_bfloat162*>(dk + off + dt * 8 + 2 * c4) =
          __floats2bfloat162_rn(dka[4 * dt + 2 * r], dka[4 * dt + 2 * r + 1]);
      *reinterpret_cast<__nv_bfloat162*>(dv + off + dt * 8 + 2 * c4) =
          __floats2bfloat162_rn(dva[4 * dt + 2 * r], dva[4 * dt + 2 * r + 1]);
    }
  }
}

// ---- host side ---------------------------------------------------------------

template <int HD>
int launch(const void* q, const void* k, const void* v, const void* e,
           const int* lengths, const void* out, const void* dout,
           const float* lse, void* dq, void* dk, void* dv, void* qs_buf,
           void* qe_buf, float* dd_buf, float* de_part, int bh, int t,
           int t_pad, int num_pos, int np_pad, int left, int nh, float scale,
           float dq_scale, cudaStream_t stream) {
  // kernel A: q and dO in 64-row tiles, K and V in 32-row tiles; kernel B
  // the other way round, with q_s and qE
  CUtensorMap a_q, a_do, a_k, a_v, b_k, b_v, b_qs, b_do, b_qe;
  if (!encode_3d(&a_q, q, bh, t, HD, 64, kM, true) ||
      !encode_3d(&a_do, dout, bh, t, HD, 64, kM, true) ||
      !encode_3d(&a_k, k, bh, t, HD, 64, kN, true) ||
      !encode_3d(&a_v, v, bh, t, HD, 64, kN, true) ||
      !encode_3d(&b_k, k, bh, t, HD, 64, kM, true) ||
      !encode_3d(&b_v, v, bh, t, HD, 64, kM, true) ||
      !encode_3d(&b_qs, qs_buf, bh, t, HD, 64, kN, true) ||
      !encode_3d(&b_do, dout, bh, t, HD, 64, kN, true) ||
      !encode_3d(&b_qe, qe_buf, bh, t, np_pad, np_pad, kN, false))
    return static_cast<int>(cudaErrorInvalidValue);
  const int smem_a = SmemA<HD>(np_pad).total;
  const int smem_b = SmemB<HD>(np_pad).total;
  auto ka = flash_rel_bwd_dq_wgmma_kernel<HD>;
  auto kb = flash_rel_bwd_dkv_wgmma_kernel<HD>;
  cudaError_t err = cudaFuncSetAttribute(
      ka, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_a);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaFuncSetAttribute(kb, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem_b);
  if (err != cudaSuccess) return static_cast<int>(err);
  using bf = __nv_bfloat16;
  const dim3 grid((t + kM - 1) / kM, bh);
  ka<<<grid, kThreads, smem_a, stream>>>(
      a_q, a_k, a_v, a_do, static_cast<const bf*>(e), lengths,
      static_cast<const bf*>(out), lse, static_cast<bf*>(dq),
      static_cast<bf*>(qs_buf), static_cast<bf*>(qe_buf), dd_buf, de_part, t,
      t_pad, num_pos, np_pad, left, nh, scale, dq_scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  kb<<<grid, kThreads, smem_b, stream>>>(
      b_k, b_v, b_qs, b_do, b_qe, lengths, lse, dd_buf, static_cast<bf*>(dk),
      static_cast<bf*>(dv), t, num_pos, np_pad, left, nh);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// bf16 only, hd a multiple of 16 up to 128; np_pad = num_pos rounded up to
// 16. Every tensor is contiguous with a 16-byte aligned start. Scratch:
// qs_buf bf16 bh·t·hd (q_s), qe_buf bf16 bh·t·np_pad (qE), dd_buf fp32 bh·t
// (dd), all written by kernel A and read by kernel B; de_part ⌈t/64⌉·bh
// partials of [num_pos, hd] (the wrapper sums them). Returns
// cudaGetLastError() after the launches, or cudaErrorInvalidValue for
// shapes the kernels do not take or a tensor map that cannot be encoded.
extern "C" int ste_flash_rel_bwd_wgmma(
    const void* q, const void* k, const void* v, const void* e,
    const int* lengths, const void* out, const void* dout, const float* lse,
    void* dq, void* dk, void* dv, void* qs_buf, void* qe_buf, float* dd_buf,
    float* de_part, int bh, int t, int t_pad, int hd, int num_pos, int left,
    int nh, float scale, float dq_scale, int device, void* stream) {
  const int np_pad = (num_pos + 15) / 16 * 16;
  if (hd % 16 != 0 || hd < 16 || hd > 128 || num_pos < 1 || num_pos > 128 ||
      t < 1 || t_pad < t || nh < 1 || left < 0 || left >= num_pos || bh < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaSetDevice(device);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define STE_LAUNCH(HD)                                                       \
  return launch<HD>(q, k, v, e, lengths, out, dout, lse, dq, dk, dv, qs_buf, \
                    qe_buf, dd_buf, de_part, bh, t, t_pad, num_pos, np_pad,  \
                    left, nh, scale, dq_scale, s)
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
