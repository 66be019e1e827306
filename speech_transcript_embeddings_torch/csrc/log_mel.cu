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
// What bounds it on an H100: fp32 FMA on the CUDA cores. Per frame the
// folded remove-DC ∘ preemphasis ∘ Povey window ∘ rDFT-512 matrix costs
// 400 × 514 FMA and the mel product 257 × n_mels FMA: ≈0.7 GFLOP for a
// 15 s clip (1,536 frames), ≈5.6 GFLOP for a batch of four 30 s clips. The
// products are plain fp32 FMA (no TF32), matching Precision.HIGHEST.
// Design: a block owns TF consecutive frames. The overlapping frames are
// read straight from the waveform into shared memory once (no [B,F,400]
// frame matrix in device memory and no shifted copies, which were a Mosaic
// workaround); each thread owns one frequency bin k and keeps the cos and
// sin sums of all TF frames in registers, so every transform element read
// from L2 feeds 2·TF FMAs; the wave is read as float4 broadcasts from shared
// memory. The power spectrum stays in shared memory for the mel product.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kHop = 160;
constexpr int kWin = 400;
constexpr int kFreq = 257;                 // fft 512 → 257 bins
constexpr int kTrWidth = 2 * kFreq;        // transform [400, cos 257 | sin 257]
constexpr int kFrames = 16;                // frames per block (TF)
constexpr int kSpan = (kFrames - 1) * kHop + kWin;
constexpr int kThreads = 288;              // ≥ 257 bins, whole warps
constexpr int kPowStride = kFreq + 3;

__global__ void __launch_bounds__(kThreads)
log_mel_kernel(const float* __restrict__ wave, int n,
               const float* __restrict__ tr, const float* __restrict__ mel,
               int n_mels, float mel_floor, float* __restrict__ out,
               int num_frames) {
  __shared__ __align__(16) float wav_s[kSpan];
  __shared__ float pow_s[kFrames * kPowStride];
  const int b = blockIdx.y;
  const int f0 = blockIdx.x * kFrames;
  const float* w = wave + static_cast<int64_t>(b) * n;
  const int64_t s0 = static_cast<int64_t>(f0) * kHop;
  for (int i = threadIdx.x; i < kSpan; i += kThreads) {
    const int64_t idx = s0 + i;
    // Kaldi 16-bit scaling; frames past the waveform read zeros
    wav_s[i] = idx < n ? w[idx] * 32768.0f : 0.0f;
  }
  __syncthreads();

  const int k = threadIdx.x;
  if (k < kFreq) {
    float ac[kFrames], as[kFrames];
#pragma unroll
    for (int f = 0; f < kFrames; ++f) ac[f] = as[f] = 0.0f;
    for (int n0 = 0; n0 < kWin; n0 += 4) {
      float tc[4], ts[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        tc[u] = __ldg(tr + (n0 + u) * kTrWidth + k);
        ts[u] = __ldg(tr + (n0 + u) * kTrWidth + kFreq + k);
      }
#pragma unroll
      for (int f = 0; f < kFrames; ++f) {
        const float4 x = *reinterpret_cast<const float4*>(wav_s + f * kHop + n0);
        ac[f] = fmaf(x.x, tc[0], ac[f]);
        as[f] = fmaf(x.x, ts[0], as[f]);
        ac[f] = fmaf(x.y, tc[1], ac[f]);
        as[f] = fmaf(x.y, ts[1], as[f]);
        ac[f] = fmaf(x.z, tc[2], ac[f]);
        as[f] = fmaf(x.z, ts[2], as[f]);
        ac[f] = fmaf(x.w, tc[3], ac[f]);
        as[f] = fmaf(x.w, ts[3], as[f]);
      }
    }
#pragma unroll
    for (int f = 0; f < kFrames; ++f)
      pow_s[f * kPowStride + k] = ac[f] * ac[f] + as[f] * as[f];
  }
  __syncthreads();

  // mel product + log: warps walk consecutive mel bins of one frame, so the
  // power value is a shared-memory broadcast and the filter row coalesced
  for (int idx = threadIdx.x; idx < kFrames * n_mels; idx += kThreads) {
    const int f = idx / n_mels, m = idx - f * n_mels;
    const int frame = f0 + f;
    if (frame >= num_frames) continue;
    const float* p = pow_s + f * kPowStride;
    float acc = 0.0f;
    for (int kk = 0; kk < kFreq; ++kk)
      acc = fmaf(p[kk], __ldg(mel + kk * n_mels + m), acc);
    out[(static_cast<int64_t>(b) * num_frames + frame) * n_mels + m] =
        logf(fmaxf(acc, mel_floor));
  }
}

constexpr int kBins = 32;      // mel bins per block (one warp row)
constexpr int kLanes = 16;     // frame lanes per block

// Masked per-utterance, per-bin normalisation (mean and ddof-1 std over the
// valid frames, rsqrt(var + 1e-7), padding → 0) with the stride stacking and
// the frame mask of frontend.normalize_and_stack. Memory-bound and small
// (a 30 s clip's log-mel is 1 MB): block (b, 32 bins), 16 frame lanes, three
// passes (mean, variance, write) that read 128-byte rows.
__global__ void __launch_bounds__(kBins * kLanes)
log_mel_normalize_kernel(const float* __restrict__ lm,
                         const int* __restrict__ num_samples, int num_frames,
                         int n_mels, int stride, int frame_length, int hop,
                         int per_bin, float* __restrict__ feat,
                         int* __restrict__ mask) {
  __shared__ float red[kLanes][kBins];
  const int b = blockIdx.y;
  const int bx = threadIdx.x, ly = threadIdx.y;
  const int m = blockIdx.x * kBins + bx;
  const int ns = num_samples[b];
  const int valid = ns >= frame_length ? 1 + (ns - frame_length) / hop : 0;
  const int upto = valid < num_frames ? valid : num_frames;
  const float* x = lm + static_cast<int64_t>(b) * num_frames * n_mels;
  const bool on = m < n_mels;

  float mean = 0.0f, inv = 1.0f;
  if (per_bin) {
    const float count = fmaxf(static_cast<float>(valid), 1.0f);
    float s = 0.0f;
    if (on)
      for (int f = ly; f < upto; f += kLanes) s += x[f * n_mels + m];
    red[ly][bx] = s;
    __syncthreads();
    if (ly == 0) {
      float t = 0.0f;
      for (int i = 0; i < kLanes; ++i) t += red[i][bx];
      red[0][bx] = t / count;
    }
    __syncthreads();
    mean = red[0][bx];
    __syncthreads();
    float v = 0.0f;
    if (on)
      for (int f = ly; f < upto; f += kLanes) {
        const float c = x[f * n_mels + m] - mean;
        v += c * c;
      }
    red[ly][bx] = v;
    __syncthreads();
    if (ly == 0) {
      float t = 0.0f;
      for (int i = 0; i < kLanes; ++i) t += red[i][bx];
      red[0][bx] = rsqrtf(t / fmaxf(count - 1.0f, 1.0f) + 1e-7f);
    }
    __syncthreads();
    inv = red[0][bx];
  }
  const int t2 = num_frames / stride;
  const int width = n_mels * stride;
  if (on)
    for (int f = ly; f < num_frames; f += kLanes) {
      const float val = f < valid ? (x[f * n_mels + m] - mean) * inv : 0.0f;
      feat[(static_cast<int64_t>(b) * t2 + f / stride) * width +
           (f % stride) * n_mels + m] = val;
    }
  if (blockIdx.x == 0)
    for (int i = ly * kBins + bx; i < t2; i += kBins * kLanes)
      mask[static_cast<int64_t>(b) * t2 + i] =
          (i * stride + stride - 1) < valid ? 1 : 0;
}

}  // namespace

extern "C" int ste_log_mel(const float* wave, int batch, int n,
                           const float* transform, const float* mel,
                           int n_mels, float mel_floor, float* out,
                           int num_frames, int device, void* stream) {
  cudaSetDevice(device);
  dim3 grid((num_frames + kFrames - 1) / kFrames, batch);
  log_mel_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      wave, n, transform, mel, n_mels, mel_floor, out, num_frames);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int ste_log_mel_normalize(const float* logmel,
                                     const int* num_samples, int batch,
                                     int num_frames, int n_mels, int stride,
                                     int frame_length, int hop, int per_bin,
                                     float* features, int* mask, int device,
                                     void* stream) {
  cudaSetDevice(device);
  dim3 grid((n_mels + kBins - 1) / kBins, batch);
  dim3 block(kBins, kLanes);
  log_mel_normalize_kernel<<<grid, block, 0,
                             static_cast<cudaStream_t>(stream)>>>(
      logmel, num_samples, num_frames, n_mels, stride, frame_length, hop,
      per_bin, features, mask);
  return static_cast<int>(cudaGetLastError());
}
