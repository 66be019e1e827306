// Log-mel frontend kernels (w2v-bert-2.0 / SeamlessM4T numerics), fp32.
//
// Replaces the two Pallas TPU kernels of
// speech_transcript_embeddings_tpu/ops/frontend_pallas.py:
//   * _kernel       (:70)  — tiled unnormalised log-mel (the 30 s bucket),
//   * _fused_kernel (:141) — whole-clip log-mel + masked per-bin
//                            normalisation (buckets up to 15.4 s).
// Here one pair of kernels serves every bucket: ste_log_mel computes the raw
// log-mel [B, F, n_mels] and ste_log_mel_normalize the masked per-bin
// mean / ddof-1 std normalisation, stride stacking and frame mask. The
// TPU's VMEM gate that split K1 from K2 has no meaning on this card.
//
// What bounds them on an H100: bytes. The raw log-mel's least work (the
// pre-steps, a 512-point real FFT, 501 mel nonzeros, the log: ≈15 kFLOP a
// frame) takes less time at the fp32 peak than reading the wave and writing
// the log-mel at 3.35 TB/s; the normalisation reads the log-mel once and
// writes the stacked features. The TPU computes the DFT as a dense matmul
// (400 × 514 MACs a frame) because its MXU makes that cheap; on CUDA cores
// it is ≈29× the least work, so:
//
// log_mel_fft_kernel: a block owns 16 consecutive frames and reads their
// overlapping waveform span into shared memory once; one warp per frame.
// Preemphasis is a high-pass: after it the lowest FFT bins hold ~1e-3 of
// the frame's power. An fp32 FFT of the preemphasised frame (even/odd
// packed into a 256-point FFT) rounds the lowest mel bins to errors up to
// ~50× the twin's, past the tests' 2e-4 tolerance
// (scripts/torch_log_mel_fft_accuracy.py). So the kernel moves the
// preemphasis to the frequency domain, exactly: with d the DC-removed
// frame, s[j] = d[j-1]
// (s[0] = d[0]), u = povey·d and v = Δpovey·s (Δpovey[j] = povey[j] −
// povey[j−1], both zero outside the frame),
//     X_k = (1 − p·e^{-2πik/512})·U_k − p·V_k.
// u and 128·v (a power of two, so the two have like magnitudes) are the
// real and imaginary parts of one 512-point complex FFT (16 values a lane,
// Stockham radix-8 stages exchanged through a padded shared buffer); a
// two-signal split separates U_k and V_k. Then power, the mel product over
// each filter's nonzero range only, logf. Twiddles, the window, its steps
// and the preemphasis response come from host tables built in float64 (no
// device sinf/cosf).
//
// log_mel_normalize_kernel: a cluster of 8 blocks per clip; each block takes
// a contiguous slice of the frames (all bins), keeps it in shared memory,
// computes per-bin (count, mean, M2) of its valid frames, publishes them,
// and after cluster.sync() reads the 8 ranks' partials at once through
// distributed shared memory and merges them in rank order by Chan's formula
// (deterministic); then it writes its slice of the stacked features and of
// the mask, and waits on the cluster barrier only before it exits. 8·B
// blocks instead of ceil(n_mels/32)·B, with a critical path of a few
// memory latencies: at small batches the kernel is latency-bound, not
// bandwidth-bound.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kHop = 160;
constexpr int kWin = 400;
constexpr int kFft = 512;
constexpr int kFreq = kFft / 2 + 1;        // 257 bins
// tile sizes (scripts/torch_log_mel_times.py --variant builds others)
constexpr int kWarps = 8;
constexpr int kFramesPerWarp = 2;
constexpr int kMinBlocks = 3;              // ≤ 85 registers: 24 warps an SM
constexpr int kFrames = kWarps * kFramesPerWarp;   // frames per block
constexpr int kSpan = (kFrames - 1) * kHop + kWin;
constexpr int kBuf = kFft + kFft / 8;      // FFT buffer padded 1 in 8
// dynamic shared memory of the FFT kernel, in floats: the wave span, the
// window and its steps (kWin + 1, rounded up), then 8-byte aligned the
// twiddles and the preemphasis response (float2), then re/im per warp
constexpr int kOffWin = kSpan;
constexpr int kOffStep = kOffWin + kWin;
constexpr int kOffTw = kOffStep + kWin + 4;
constexpr int kOffResp = kOffTw + 2 * kFft;
constexpr int kOffBuf = kOffResp + 2 * (kFreq + 1);
constexpr int kFftSmem = (kOffBuf + kWarps * 2 * kBuf) * sizeof(float);
static_assert(kOffTw % 2 == 0 && kOffResp % 2 == 0, "float2 alignment");

struct cpx {
  float x, y;
};

__device__ __forceinline__ cpx add(cpx a, cpx b) { return {a.x + b.x, a.y + b.y}; }
__device__ __forceinline__ cpx sub(cpx a, cpx b) { return {a.x - b.x, a.y - b.y}; }
__device__ __forceinline__ cpx mul(cpx a, float2 w) {
  return {a.x * w.x - a.y * w.y, a.x * w.y + a.y * w.x};
}
// index into the padded buffer: one float of padding every 8, so the
// stage writes of stride 8 fall on distinct banks
__device__ __forceinline__ int pad(int i) { return i + (i >> 3); }

// in-place 4-point DFT (e^{-2πi nk/4}), natural order
__device__ __forceinline__ void dft4(cpx& a0, cpx& a1, cpx& a2, cpx& a3) {
  const cpx t0 = add(a0, a2), t2 = sub(a0, a2), t1 = add(a1, a3);
  const cpx t3 = {a1.y - a3.y, a3.x - a1.x};   // (a1 − a3)·(−i)
  a0 = add(t0, t1);
  a2 = sub(t0, t1);
  a1 = add(t2, t3);
  a3 = sub(t2, t3);
}

// in-place 8-point DFT: a radix-2 step, then two 4-point DFTs
__device__ __forceinline__ void dft8(cpx* v) {
  constexpr float h = 0.70710678118654752f;
  cpx a[4], b[4];
#pragma unroll
  for (int n = 0; n < 4; ++n) {
    a[n] = add(v[n], v[n + 4]);
    b[n] = sub(v[n], v[n + 4]);
  }
  b[1] = {h * (b[1].x + b[1].y), h * (b[1].y - b[1].x)};   // · e^{-iπ/4}
  b[2] = {b[2].y, -b[2].x};                                // · (−i)
  b[3] = {h * (b[3].y - b[3].x), -h * (b[3].x + b[3].y)};  // · e^{-3iπ/4}
  dft4(a[0], a[1], a[2], a[3]);
  dft4(b[0], b[1], b[2], b[3]);
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    v[2 * k] = a[k];
    v[2 * k + 1] = b[k];
  }
}

// 512-point complex FFT of one warp's frame. On entry lane l holds
// z[j + 64 r] in v[p][r] for its two butterflies j = l + 32 p; on exit
// re/im hold Z in natural order. Stockham radix-8 stages Ns = 1, 8, 64:
// butterfly j reads z[j + 64 r], twiddles by W_{8·Ns}^{r·(j mod Ns)}
// (entry r·(j mod Ns)·64/Ns of the W_512 table), writes
// (j / Ns)·8·Ns + j mod Ns + r·Ns.
__device__ __forceinline__ void fft512(cpx (&v)[2][8], float* re, float* im,
                                       const float2* tw, int lane) {
#pragma unroll
  for (int p = 0; p < 2; ++p) {              // stage 1: no twiddles
    const int j = lane + 32 * p;
    dft8(v[p]);
#pragma unroll
    for (int r = 0; r < 8; ++r) {
      re[pad(8 * j + r)] = v[p][r].x;
      im[pad(8 * j + r)] = v[p][r].y;
    }
  }
  __syncwarp();
#pragma unroll
  for (int p = 0; p < 2; ++p) {              // stage 2: read all, then write
    const int j = lane + 32 * p;
#pragma unroll
    for (int r = 0; r < 8; ++r) {
      v[p][r] = {re[pad(j + 64 * r)], im[pad(j + 64 * r)]};
      if (r) v[p][r] = mul(v[p][r], tw[8 * r * (j & 7)]);
    }
  }
  __syncwarp();
#pragma unroll
  for (int p = 0; p < 2; ++p) {
    const int j = lane + 32 * p;
    dft8(v[p]);
    const int d = (j >> 3) * 64 + (j & 7);
#pragma unroll
    for (int r = 0; r < 8; ++r) {
      re[pad(d + 8 * r)] = v[p][r].x;
      im[pad(d + 8 * r)] = v[p][r].y;
    }
  }
  __syncwarp();
  // stage 3: butterfly j reads and writes the same eight positions
  // j + 64 r, which no other lane touches
#pragma unroll
  for (int p = 0; p < 2; ++p) {
    const int j = lane + 32 * p;
#pragma unroll
    for (int r = 0; r < 8; ++r) {
      v[p][r] = {re[pad(j + 64 * r)], im[pad(j + 64 * r)]};
      if (r) v[p][r] = mul(v[p][r], tw[r * j]);
    }
    dft8(v[p]);
#pragma unroll
    for (int r = 0; r < 8; ++r) {
      re[pad(j + 64 * r)] = v[p][r].x;
      im[pad(j + 64 * r)] = v[p][r].y;
    }
  }
  __syncwarp();
}

__global__ void __launch_bounds__(kWarps * 32, kMinBlocks)
log_mel_fft_kernel(const float* __restrict__ wave, int n,
                   const float* __restrict__ window,
                   const float* __restrict__ window_step,
                   const float2* __restrict__ twiddle,
                   const float2* __restrict__ response,
                   const int* __restrict__ mel_ranges,
                   const float* __restrict__ mel_weights, int n_mels,
                   float v_coef, float mel_floor, float* __restrict__ out,
                   int num_frames) {
  extern __shared__ __align__(16) float smem[];
  float* wav_s = smem;
  float* win_s = smem + kOffWin;
  float* step_s = smem + kOffStep;
  float2* tw_s = reinterpret_cast<float2*>(smem + kOffTw);
  float2* resp_s = reinterpret_cast<float2*>(smem + kOffResp);
  const int b = blockIdx.y;
  const int f0 = blockIdx.x * kFrames;
  const float* w = wave + static_cast<int64_t>(b) * n;
  const int64_t s0 = static_cast<int64_t>(f0) * kHop;
  for (int i = threadIdx.x; i < kSpan; i += blockDim.x) {
    const int64_t idx = s0 + i;
    // Kaldi 16-bit scaling; frames past the waveform read zeros
    wav_s[i] = idx < n ? w[idx] * 32768.0f : 0.0f;
  }
  for (int i = threadIdx.x; i < kWin; i += blockDim.x) win_s[i] = window[i];
  for (int i = threadIdx.x; i <= kWin; i += blockDim.x)
    step_s[i] = window_step[i];
  for (int i = threadIdx.x; i < kFft; i += blockDim.x) tw_s[i] = twiddle[i];
  for (int i = threadIdx.x; i < kFreq; i += blockDim.x)
    resp_s[i] = response[i];
  __syncthreads();

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float* re = smem + kOffBuf + warp * 2 * kBuf;
  float* im = re + kBuf;
  for (int q = 0; q < kFramesPerWarp; ++q) {
    const int fl = q * kWarps + warp;
    const int frame = f0 + fl;
    if (frame >= num_frames) break;            // warp-uniform
    const float* x = wav_s + fl * kHop;
    float sum = 0.0f;
    for (int j = lane; j < kWin; j += 32) sum += x[j];
#pragma unroll
    for (int o = 16; o; o >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
    const float mean = sum / kWin;             // every lane: the same sum

    // z[m] = u[m] + i·v[m] at m = lane + 32 (p + 2 r): u = window · d,
    // v = 128·Δwindow · s (the table holds the scaled steps)
    cpx v[2][8];
#pragma unroll
    for (int p = 0; p < 2; ++p)
#pragma unroll
      for (int r = 0; r < 8; ++r) {
        const int m = lane + 32 * p + 64 * r;
        v[p][r] = {0.0f, 0.0f};
        if (m < kWin) v[p][r].x = win_s[m] * (x[m] - mean);
        if (m <= kWin) v[p][r].y = step_s[m] * (x[m ? m - 1 : 0] - mean);
      }
    fft512(v, re, im, tw_s, lane);

    // two-signal split: U_k = (Z_k + conj Z_{-k}) / 2,
    // V_k = (Z_k − conj Z_{-k}) / 2i; X_k = H_k U_k − (p / 128)·V_k
    float pk[(kFreq + 31) / 32];
#pragma unroll
    for (int t = 0; t < (kFreq + 31) / 32; ++t) {
      const int k = lane + 32 * t;
      if (k < kFreq) {
        const int kb = (kFft - k) & (kFft - 1);
        const cpx a = {re[pad(k)], im[pad(k)]};
        const cpx c = {re[pad(kb)], -im[pad(kb)]};
        const cpx u = {0.5f * (a.x + c.x), 0.5f * (a.y + c.y)};
        const cpx d = {0.5f * (a.x - c.x), 0.5f * (a.y - c.y)};
        const cpx hu = mul(u, resp_s[k]);
        const float xr = hu.x - v_coef * d.y, xi = hu.y + v_coef * d.x;
        pk[t] = xr * xr + xi * xi;
      }
    }
    __syncwarp();                              // Z read by every lane
    float* pw = re;                            // the power spectrum, unpadded
#pragma unroll
    for (int t = 0; t < (kFreq + 31) / 32; ++t)
      if (lane + 32 * t < kFreq) pw[lane + 32 * t] = pk[t];
    __syncwarp();

    // sparse mel product over each filter's nonzero FFT bins, then log
    float* row = out + (static_cast<int64_t>(b) * num_frames + frame) * n_mels;
    for (int m = lane; m < n_mels; m += 32) {
      const int start = __ldg(mel_ranges + 3 * m);
      const int len = __ldg(mel_ranges + 3 * m + 1);
      const float* wt = mel_weights + __ldg(mel_ranges + 3 * m + 2);
      float acc = 0.0f;
      for (int i = 0; i < len; ++i)
        acc = fmaf(pw[start + i], __ldg(wt + i), acc);
      row[m] = logf(fmaxf(acc, mel_floor));
    }
    __syncwarp();                              // pw read before the next frame
  }
}

constexpr int kRanks = 8;          // blocks (cluster ranks) per clip
constexpr int kNormThreads = 512;  // lanes = kNormThreads / n_mels
constexpr size_t kMaxSmem = 200 * 1024;

// Masked per-utterance, per-bin normalisation (mean and ddof-1 std over the
// valid frames, rsqrt(var + 1e-7), padding → 0) with the stride stacking and
// the frame mask of frontend.normalize_and_stack. The block first copies its
// whole slice to shared memory, without waiting for the clip's length.
// Thread (l, m) of a block of lanes × n_mels threads then sums (x − K) and
// (x − K)² over frames l, l + lanes, ... of bin m, K being the slice's first
// frame of the bin (a value of the data, so the shifted sums lose no
// precision); the lanes' sums give the slice's (count, mean, M2). The
// ranks' partials merge in rank order by the multi-way form of Chan et
// al.'s formula: mean = Σ n_q·mean_q / n, M2 = Σ M2_q + n_q·(mean_q −
// mean)², one division and no chain of them. Stacking is a reshape: feat
// [B, F/stride, n_mels·stride] is the normalised [B, F, n_mels] in memory,
// so the slice is written as one contiguous run (float4 when
// n_mels % 4 == 0).
__global__ void __launch_bounds__(kNormThreads)
log_mel_normalize_kernel(const float* __restrict__ lm,
                         const int* __restrict__ num_samples, int num_frames,
                         int n_mels, int stride, int frame_length, int hop,
                         int per_bin, int slice, int cached,
                         float* __restrict__ feat, int* __restrict__ mask) {
  extern __shared__ __align__(16) float smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int b = blockIdx.y;
  const int tid = threadIdx.x, lanes = blockDim.x / n_mels;
  const int m = tid % n_mels, l = tid / n_mels;
  const int ns = num_samples[b];               // used after the slice load
  const int f0 = rank * slice, f1 = min(f0 + slice, num_frames);
  const float* x = lm + (static_cast<int64_t>(b) * num_frames + f0) * n_mels;
  float* cache = smem;                         // [slice, n_mels] if cached
  float* red = smem + (cached ? slice * n_mels : 0);   // [2, lanes, n_mels]
  float* part = red + 2 * lanes * n_mels;      // this slice's mean, M2
  float* stat = part + 2 * n_mels;             // the clip's mean, 1/std
  // 16-byte rows at every frame
  const bool vec = (n_mels & 3) == 0 &&
                   ((reinterpret_cast<uintptr_t>(lm) |
                     reinterpret_cast<uintptr_t>(feat)) & 15) == 0;
  if (cached) {
    const int count = max(0, f1 - f0) * n_mels;
    if (vec) {
      const float4* src = reinterpret_cast<const float4*>(x);
      float4* dst = reinterpret_cast<float4*>(cache);
#pragma unroll 4
      for (int i = tid; i < count / 4; i += blockDim.x) dst[i] = __ldg(src + i);
    } else {
#pragma unroll 4
      for (int i = tid; i < count; i += blockDim.x) cache[i] = __ldg(x + i);
    }
  }
  const int valid = ns >= frame_length ? 1 + (ns - frame_length) / hop : 0;
  const int fv = max(f0, min(f1, valid));      // valid frames: [f0, fv)
  if (cached) __syncthreads();
  auto at = [&](int f) {                       // f relative to f0
    return cached ? cache[f * n_mels + m]
                  : x[static_cast<int64_t>(f) * n_mels + m];
  };

  if (per_bin) {
    const int count = fv - f0;
    const float shift = count ? at(0) : 0.0f;
    float s1 = 0.0f, s2 = 0.0f;
    for (int f = l; f < count; f += lanes) {
      const float c = at(f) - shift;
      s1 += c;
      s2 = fmaf(c, c, s2);
    }
    red[tid] = s1;
    red[lanes * n_mels + tid] = s2;
    __syncthreads();
    if (l == 0) {                              // the lanes, in order
      float t1 = 0.0f, t2 = 0.0f;
      for (int i = 0; i < lanes; ++i) {
        t1 += red[i * n_mels + m];
        t2 += red[(lanes + i) * n_mels + m];
      }
      const float d = count ? t1 / count : 0.0f;
      part[m] = shift + d;                     // the slice's mean
      part[n_mels + m] = fmaxf(t2 - t1 * d, 0.0f);   // and M2
    }
    cluster.sync();                            // every slice's partials out
    if (l == 0) {
      // every rank's partials in flight at once, merged in rank order
      float qm[kRanks], qm2[kRanks], qn[kRanks], n = 0.0f, mu = 0.0f;
#pragma unroll
      for (int q = 0; q < kRanks; ++q) {
        const float* rp = cluster.map_shared_rank(part, q);
        qm[q] = rp[m];
        qm2[q] = rp[n_mels + m];
        const int q0 = q * slice;
        qn[q] = static_cast<float>(
            max(0, min(min(q0 + slice, num_frames), valid) - q0));
        n += qn[q];
        mu = fmaf(qn[q], qm[q], mu);
      }
      mu = n > 0.0f ? mu / n : 0.0f;
      float s2c = 0.0f;
#pragma unroll
      for (int q = 0; q < kRanks; ++q) {
        const float delta = qm[q] - mu;
        s2c += qm2[q] + qn[q] * delta * delta;
      }
      stat[m] = mu;
      stat[n_mels + m] = rsqrtf(s2c / fmaxf(n - 1.0f, 1.0f) + 1e-7f);
    }
    // this block is done reading the other ranks; it waits for them to be
    // done with its partials only before it exits
    asm volatile("barrier.cluster.arrive;\n" ::: "memory");
  } else if (l == 0) {
    stat[m] = 0.0f;
    stat[n_mels + m] = 1.0f;
  }
  __syncthreads();

  float* dst = feat + (static_cast<int64_t>(b) * num_frames + f0) * n_mels;
  const int nvalid = (fv - f0) * n_mels, total = (f1 - f0) * n_mels;
  if (vec && cached) {
    for (int i = 4 * tid; i < total; i += 4 * blockDim.x) {
      float4 o = {0.0f, 0.0f, 0.0f, 0.0f};
      if (i < nvalid) {
        const float4 v = *reinterpret_cast<const float4*>(cache + i);
        const int mm = i % n_mels;
        o = {(v.x - stat[mm]) * stat[n_mels + mm],
             (v.y - stat[mm + 1]) * stat[n_mels + mm + 1],
             (v.z - stat[mm + 2]) * stat[n_mels + mm + 2],
             (v.w - stat[mm + 3]) * stat[n_mels + mm + 3]};
      }
      *reinterpret_cast<float4*>(dst + i) = o;
    }
  } else {
    const float mean = stat[m], inv = stat[n_mels + m];
    for (int f = l; f < f1 - f0; f += lanes)
      dst[static_cast<int64_t>(f) * n_mels + m] =
          f < fv - f0 ? (at(f) - mean) * inv : 0.0f;
  }
  const int t2 = num_frames / stride;
  for (int i = f0 / stride + tid; i < f1 / stride; i += blockDim.x)
    mask[static_cast<int64_t>(b) * t2 + i] =
        (i * stride + stride - 1) < valid ? 1 : 0;
  if (per_bin) asm volatile("barrier.cluster.wait;\n" ::: "memory");
}

}  // namespace

extern "C" int ste_log_mel(const float* wave, int batch, int n,
                           const float* window, const float* window_step,
                           const float* twiddles, const float* response,
                           const int* mel_ranges, const float* mel_weights,
                           int n_mels, float v_coef, float mel_floor,
                           float* out, int num_frames, int device,
                           void* stream) {
  cudaSetDevice(device);
  cudaError_t err = cudaFuncSetAttribute(
      log_mel_fft_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kFftSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid((num_frames + kFrames - 1) / kFrames, batch);
  log_mel_fft_kernel<<<grid, kWarps * 32, kFftSmem,
                       static_cast<cudaStream_t>(stream)>>>(
      wave, n, window, window_step, reinterpret_cast<const float2*>(twiddles),
      reinterpret_cast<const float2*>(response), mel_ranges, mel_weights,
      n_mels, v_coef, mel_floor, out, num_frames);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int ste_log_mel_normalize(const float* logmel,
                                     const int* num_samples, int batch,
                                     int num_frames, int n_mels, int stride,
                                     int frame_length, int hop, int per_bin,
                                     float* features, int* mask, int device,
                                     void* stream) {
  cudaSetDevice(device);
  if (n_mels < 1 || n_mels > kNormThreads || stride < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const int lanes = kNormThreads / n_mels;
  const int per_rank = (num_frames + kRanks * stride - 1) / (kRanks * stride);
  const int slice = per_rank * stride;
  const size_t extra =
      static_cast<size_t>(2 * lanes + 4) * n_mels * sizeof(float);
  const size_t cache = static_cast<size_t>(slice) * n_mels * sizeof(float);
  const int cached = cache + extra <= kMaxSmem;
  const size_t bytes = extra + (cached ? cache : 0);
  cudaError_t err = cudaFuncSetAttribute(
      log_mel_normalize_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = kRanks;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3(kRanks, batch);
  config.blockDim = dim3(lanes * n_mels);
  config.dynamicSmemBytes = bytes;
  config.stream = static_cast<cudaStream_t>(stream);
  config.attrs = attr;
  config.numAttrs = 1;
  err = cudaLaunchKernelEx(&config, log_mel_normalize_kernel, logmel,
                           num_samples, num_frames, n_mels, stride,
                           frame_length, hop, per_bin, slice, cached,
                           features, mask);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}
