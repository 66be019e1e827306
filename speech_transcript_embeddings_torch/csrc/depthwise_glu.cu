// The conformer conv module's middle, forward and backward: the GLU of the
// pointwise1 output and the causal depthwise convolution over time, on the
// [B, T, ·] row-major activations the products read and write.
//
//   a, g = x[..., :C], x[..., C:]          x: [B, T, 2C]
//   u[b, t, c] = a · σ(g)
//   y[b, t, c] = Σ_{k<K} w[c, k] · u[b, t − (K−1) + k, c]   (u = 0 before t = 0)
//
// Replaces no TPU kernel: the JAX package writes the module in flax
// (`feature_group_count` = channels) and XLA fuses the GLU into the
// convolution. Eager PyTorch did not: sigmoid, mul, a transpose that F.pad
// wrote into a padded [B, C, T + K − 1], ATen's depthwise kernel (reads that
// stride 2 KB from thread to thread), the transpose back and the depthwise
// norm's copy of it moved each element about seven times, and the backward
// as many again, with the weight cast to bf16 and its gradient cast back.
//
// Their roofline bound on an H100 is bytes: the forward reads x once and
// writes y once (6 B a position and channel in bf16) against 31 fused
// multiply-adds, the backward reads x and dy and writes dx (10 B) against
// 62, in fp32 at 67 TFLOP/s about half the bytes' time. So the activations
// move in 16-byte vectors along C, neighbouring threads on neighbouring
// channels, and everything between is kept on chip.
//
// An item is one batch row, a strip of T and a slice of 32 channels. The
// grid is persistent: a few blocks a channel slice (two a multiprocessor in
// all), each walking the items blockIdx.y, blockIdx.y + gridDim.y, … of its
// slice. A block copies an item's rows and their K − 1 = 30 halo rows into
// shared memory as they are stored (cp.async, 16 bytes a copy, zeros
// outside [0, T)), so the next item's copies are in flight while this
// item's taps run; it widens them to fp32 there (the GLU computed once for
// each element read), the taps beside them. Then each thread takes one
// channel and kRows consecutive times and slides a window of kRows values
// down the 31 taps: one shared-memory load of the window and one of the tap
// for kRows multiply-adds, all in fp32. Taps sit at the end of a 31-tap
// window (zeros before them), so every K ≤ 31 runs the same code. Outputs
// go back through shared memory and out as 16-byte vectors, rounded once
// to the activations' dtype.
//
// What bounds them in fact is instruction throughput: a copy of the
// forward without its loads ran nearly as long (0.138 against 0.142 ms at
// [64, 512, 1024], 16 times a thread), so the taps (31 multiply-adds an
// output, ≈ 47 µs there) and the GLU's two multi-function-unit operations
// an element set the pace; 32 times a thread spend fewer shared-memory
// loads on them, and the copies in flight across an item's taps beat
// loading through registers (0.113 against 0.140 ms).
//
// depthwise_glu_fwd_kernel: strip 256, 32 times a thread (the halo re-reads
// 12% of the input, mostly from L2, where the neighbouring strip's block
// has just put it).
//
// depthwise_glu_bwd_kernel: with σ = σ(g),
//   du[t] = Σ_k w[c, k] · dy[t + (K−1) − k]            (dy = 0 past T)
//   da = du · σ,  dg = du · a · σ · (1 − σ)             → dx [B, T, 2C]
//   dw[c, k] = Σ_{b,t} u[b, t] · dy[b, t + (K−1) − k]
// over a strip of 128 with its 30 halo rows of dy after it; both sums slide
// the same window of dy. Where the weight needs its gradient, each thread
// keeps its 31 tap sums in registers across its block's items, the block
// adds its thread groups' sums in a fixed order and writes one fp32
// partial;
// depthwise_glu_bwd_dw_kernel adds the partials in a fixed order and rounds
// once to the weight's dtype. No float atomics: two runs give the same bits.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_bf16.cuh"
#include "vec8.cuh"

namespace {

using ste::bf16;
using ste::from_float;
using ste::kVec;
using ste::load8;
using ste::store8;
using ste::to_float;

constexpr int kTaps = 31;                   // the window: K ≤ kTaps taps at its end
constexpr int kHalo = kTaps - 1;
constexpr int kSlice = 32;                  // channels a block, one a thread of a group
constexpr int kSliceVecs = kSlice / kVec;   // 16-byte vectors (of bf16) a row of the slice
constexpr int kFwdGroups = 8;               // groups of kSlice threads, one a run of times
constexpr int kFwdRows = 32;                // times a thread
constexpr int kFwdStrip = kFwdGroups * kFwdRows;
constexpr int kBwdGroups = 8;
constexpr int kBwdRows = 16;
constexpr int kBwdStrip = kBwdGroups * kBwdRows;
constexpr int kFwdBlocksPerSm = 2;
constexpr int kBwdBlocksPerSm = 2;
constexpr int kMaxGridY = 65535;
constexpr int kSumThreads = 256;

// Shared memory a block: the input as read (dtype T) and in fp32, the taps.
// Forward: a, g of the strip and its halo; u. Backward: dy with its halo,
// a and g of the strip; dy, u and σ(g) in fp32.
template <typename T>
constexpr size_t fwd_smem() {
  return kSlice * ((kFwdStrip + kHalo) * (2 * sizeof(T) + sizeof(float)) +
                   kTaps * sizeof(float));
}
template <typename T>
constexpr size_t bwd_smem() {
  return kSlice * ((kBwdStrip + kHalo + 2 * kBwdStrip) * sizeof(T) +
                   (kBwdStrip + kHalo + 2 * kBwdStrip + kTaps) * sizeof(float));
}

// σ(g) = 1 / (1 + e^−g) by the multi-function unit: the exponential
// (ex2.approx) and the reciprocal, each within 2 ulp; 1 + e^−g past 2^126
// gives 0, as σ is there
__device__ __forceinline__ float sigmoid(float g) { return __fdividef(1.f, 1.f + __expf(-g)); }

// sw[j][l]: the window's tap j of channel c0 + l (the K taps at its end,
// zeros before them and past the channels); `reversed` stores tap
// kHalo − j at j.
template <typename TW>
__device__ __forceinline__ void load_taps(const TW* __restrict__ w, float* sw, int c0,
                                          int channels, int taps, bool reversed) {
  for (int i = threadIdx.x; i < kTaps * kSlice; i += blockDim.x) {
    const int j = i / kSlice, c = c0 + i % kSlice;
    const int k = (reversed ? kHalo - j : j) - (kTaps - taps);
    sw[i] = (k >= 0 && c < channels) ? to_float(w[static_cast<size_t>(c) * taps + k]) : 0.f;
  }
}

// One thread's kRows sums Σ_j tap[j] · rows[r + j] (r < kRows), with `rows`
// its column of a [·][kSlice] tile from row `first` and `taps` a
// [kTaps][kSlice] tile; `each(j, r, v)` sees every window value v =
// rows[r + j] as it is used.
template <int kRows, typename F>
__device__ __forceinline__ void slide(const float* rows, const float* taps, int first,
                                      int lane, float (&acc)[kRows], F each) {
  float win[kRows];
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    acc[r] = 0.f;
    win[r] = rows[(first + r) * kSlice + lane];
  }
#pragma unroll
  for (int j = 0; j < kTaps; ++j) {
    const float tap = taps[j * kSlice + lane];
    if (j > 0) win[(j + kRows - 1) % kRows] = rows[(first + j + kRows - 1) * kSlice + lane];
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const float v = win[(r + j) % kRows];
      acc[r] = fmaf(tap, v, acc[r]);
      each(j, r, v);
    }
  }
}

// Starts the 16-byte copies of `rows` rows of one slice, from time `t0`
// of batch row `b` of `src` (`width` elements a row; the slice starts at
// `col`), into `dst` ([rows][kSlice] of T): zeros outside [0, time) and
// past `channels`. No wait.
template <typename T>
__device__ __forceinline__ void fetch_rows(T* dst, const T* src, int rows, int b, int t0,
                                           int time, size_t width, int col, int c0,
                                           int channels) {
  constexpr int kChunks = kSlice * sizeof(T) / 16;   // 16-byte chunks a row
  constexpr int kPer = 16 / sizeof(T);
  for (int v = threadIdx.x; v < rows * kChunks; v += blockDim.x) {
    const int i = v / kChunks, q = v % kChunks, t = t0 + i;
    const bool valid = t >= 0 && t < time && c0 + q * kPer < channels;
    const T* from = valid ? src + (static_cast<size_t>(b) * time + t) * width + col + q * kPer
                          : src;
    ste_mma::cp_async16(dst + i * kSlice + q * kPer, from, valid);
  }
}

// The GLU of `rows` rows of raw a and g ([rows][kSlice] of T) into u (and,
// where `s` is given, σ(g) into it), fp32 [rows][kSlice].
template <typename T>
__device__ __forceinline__ void glu_rows(const T* ra, const T* rg, float* u, float* s,
                                         int rows) {
  for (int v = threadIdx.x; v < rows * kSliceVecs; v += blockDim.x) {
    const int at = (v / kSliceVecs) * kSlice + (v % kSliceVecs) * kVec;
    float a[kVec], g[kVec];
    load8(ra + at, a);
    load8(rg + at, g);
#pragma unroll
    for (int i = 0; i < kVec; ++i) {
      g[i] = sigmoid(g[i]);
      a[i] *= g[i];
    }
    store8(u + at, a);
    if (s != nullptr) store8(s + at, g);
  }
}

// Each block walks the items (batch row, strip) blockIdx.y, blockIdx.y +
// gridDim.y, … of its channel slice; the next item's input streams into
// shared memory (cp.async) while this one's taps run.
template <typename T, typename TW>
__global__ void __launch_bounds__(kFwdGroups * kSlice, kFwdBlocksPerSm)
depthwise_glu_fwd_kernel(const T* __restrict__ x, const TW* __restrict__ w,
                         T* __restrict__ y, int batch, int time, int channels, int taps) {
  constexpr int kThreads = kFwdGroups * kSlice;
  constexpr int kRowsIn = kFwdStrip + kHalo;
  extern __shared__ __align__(16) unsigned char smem_bytes[];
  T* ra = reinterpret_cast<T*>(smem_bytes);            // [kRowsIn][kSlice]: a, as read
  T* rg = ra + kRowsIn * kSlice;                       // g
  float* su = reinterpret_cast<float*>(rg + kRowsIn * kSlice);   // u at t0 − kHalo + i
  float* sw = su + kRowsIn * kSlice;                   // [kTaps][kSlice]
  const int lane = threadIdx.x % kSlice, first = (threadIdx.x / kSlice) * kFwdRows;
  const int c0 = blockIdx.x * kSlice;
  const int strips = (time + kFwdStrip - 1) / kFwdStrip, items = batch * strips;
  const size_t width = 2 * static_cast<size_t>(channels);
  const auto fetch = [&](int item) {
    const int b = item / strips, t0 = (item % strips) * kFwdStrip - kHalo;
    fetch_rows(ra, x, kRowsIn, b, t0, time, width, c0, c0, channels);
    fetch_rows(rg, x, kRowsIn, b, t0, time, width, channels + c0, c0, channels);
    ste_mma::cp_async_commit();
  };
  load_taps(w, sw, c0, channels, taps, false);
  if (blockIdx.y < items) fetch(blockIdx.y);
  for (int item = blockIdx.y; item < items; item += gridDim.y) {
    const int b = item / strips, t0 = (item % strips) * kFwdStrip;
    ste_mma::cp_async_wait<0>();
    __syncthreads();                       // its input has landed; su is free
    glu_rows(ra, rg, su, static_cast<float*>(nullptr), kRowsIn);
    __syncthreads();
    if (item + gridDim.y < items) fetch(item + gridDim.y);
    float acc[kFwdRows];
    slide<kFwdRows>(su, sw, first, lane, acc, [](int, int, float) {});
    __syncthreads();                       // every window has read su
#pragma unroll
    for (int r = 0; r < kFwdRows; ++r) su[(first + r) * kSlice + lane] = acc[r];
    __syncthreads();
    for (int v = threadIdx.x; v < kFwdStrip * kSliceVecs; v += kThreads) {
      const int t = t0 + v / kSliceVecs, c = c0 + (v % kSliceVecs) * kVec;
      if (t < time && c < channels) {
        float o[kVec];
        load8(su + (v / kSliceVecs) * kSlice + (v % kSliceVecs) * kVec, o);
        store8(y + (static_cast<size_t>(b) * time + t) * channels + c, o);
      }
    }
  }
}

template <typename T, typename TW, bool kDw>
__global__ void __launch_bounds__(kBwdGroups * kSlice, kBwdBlocksPerSm)
depthwise_glu_bwd_kernel(const T* __restrict__ dy, const T* __restrict__ x,
                         const TW* __restrict__ w, T* __restrict__ dx,
                         float* __restrict__ part, int batch, int time, int channels,
                         int taps) {
  constexpr int kThreads = kBwdGroups * kSlice;
  constexpr int kRowsDy = kBwdStrip + kHalo;
  extern __shared__ __align__(16) unsigned char smem_bytes[];
  T* rdy = reinterpret_cast<T*>(smem_bytes);           // [kRowsDy][kSlice]: dy, as read
  T* ra = rdy + kRowsDy * kSlice;                      // [kBwdStrip][kSlice]: a
  T* rg = ra + kBwdStrip * kSlice;                     // g
  float* sdy = reinterpret_cast<float*>(rg + kBwdStrip * kSlice);   // dy at t0 + i
  float* su = sdy + kRowsDy * kSlice;                  // [kBwdStrip][kSlice]: u, then da
  float* ss = su + kBwdStrip * kSlice;                 // σ(g), then dg
  float* sw = ss + kBwdStrip * kSlice;                 // [kTaps][kSlice], reversed
  const int lane = threadIdx.x % kSlice, first = (threadIdx.x / kSlice) * kBwdRows;
  const int c0 = blockIdx.x * kSlice;
  const int strips = (time + kBwdStrip - 1) / kBwdStrip, items = batch * strips;
  const size_t width = 2 * static_cast<size_t>(channels);
  const auto fetch = [&](int item) {
    const int b = item / strips, t0 = (item % strips) * kBwdStrip;
    fetch_rows(rdy, dy, kRowsDy, b, t0, time, static_cast<size_t>(channels), c0, c0,
               channels);
    fetch_rows(ra, x, kBwdStrip, b, t0, time, width, c0, c0, channels);
    fetch_rows(rg, x, kBwdStrip, b, t0, time, width, channels + c0, c0, channels);
    ste_mma::cp_async_commit();
  };
  load_taps(w, sw, c0, channels, taps, true);
  float dw[kTaps];                         // this thread's tap sums, tap kHalo − j at j
#pragma unroll
  for (int j = 0; j < kTaps; ++j) dw[j] = 0.f;
  if (blockIdx.y < items) fetch(blockIdx.y);
  for (int item = blockIdx.y; item < items; item += gridDim.y) {
    const int b = item / strips, t0 = (item % strips) * kBwdStrip;
    ste_mma::cp_async_wait<0>();
    __syncthreads();                       // its input has landed; the last item is out
    for (int v = threadIdx.x; v < kRowsDy * kSliceVecs; v += kThreads) {
      const int at = (v / kSliceVecs) * kSlice + (v % kSliceVecs) * kVec;
      float d[kVec];
      load8(rdy + at, d);
      store8(sdy + at, d);
    }
    glu_rows(ra, rg, su, ss, kBwdStrip);
    __syncthreads();
    if (item + gridDim.y < items) fetch(item + gridDim.y);
    float u[kBwdRows], du[kBwdRows];
    if constexpr (kDw) {
#pragma unroll
      for (int r = 0; r < kBwdRows; ++r) u[r] = su[(first + r) * kSlice + lane];
    }
    float tap_sum = 0.f;
    slide<kBwdRows>(sdy, sw, first, lane, du, [&](int j, int r, float v) {
      if constexpr (kDw) {
        tap_sum = fmaf(u[r], v, r == 0 ? 0.f : tap_sum);
        if (r == kBwdRows - 1) dw[j] += tap_sum;
      }
    });
    if (dx != nullptr) {
      // da, dg over this thread's own u and σ (no other thread reads them)
#pragma unroll
      for (int r = 0; r < kBwdRows; ++r) {
        const int at = (first + r) * kSlice + lane;
        const float s = ss[at], uv = su[at];
        su[at] = du[r] * s;
        ss[at] = du[r] * uv * (1.f - s);
      }
      __syncthreads();
      for (int v = threadIdx.x; v < kBwdStrip * kSliceVecs; v += kThreads) {
        const int t = t0 + v / kSliceVecs, c = c0 + (v % kSliceVecs) * kVec;
        if (t < time && c < channels) {
          const int at = (v / kSliceVecs) * kSlice + (v % kSliceVecs) * kVec;
          T* row = dx + (static_cast<size_t>(b) * time + t) * width + c;
          float o[kVec];
          load8(su + at, o);
          store8(row, o);
          load8(ss + at, o);
          store8(row + channels, o);
        }
      }
    }
  }
  if constexpr (kDw) {
    // the block's sums: its groups in order, through shared memory
    __syncthreads();
    float* sum = sdy;                      // [kTaps][kSlice]
    for (int group = 0; group < kBwdGroups; ++group) {
      if (static_cast<int>(threadIdx.x / kSlice) == group) {
#pragma unroll
        for (int j = 0; j < kTaps; ++j)
          sum[j * kSlice + lane] = (group ? sum[j * kSlice + lane] : 0.f) + dw[j];
      }
      __syncthreads();
    }
    for (int i = threadIdx.x; i < kTaps * kSlice; i += kThreads) {
      const int c = c0 + i % kSlice;
      if (c < channels)
        part[(static_cast<size_t>(blockIdx.y) * kTaps + i / kSlice) * channels + c] = sum[i];
    }
  }
}

// dw[c, 0, k] = Σ_p part[p][K − 1 − k][c] over the `blocks` partials in
// order, rounded once to the weight's dtype.
template <typename TW>
__global__ void __launch_bounds__(kSumThreads)
depthwise_glu_bwd_dw_kernel(const float* __restrict__ part, int blocks, int channels,
                            int taps, TW* __restrict__ dw) {
  const int i = blockIdx.x * kSumThreads + threadIdx.x;
  if (i >= taps * channels) return;
  const int k = i / channels, c = i % channels;
  const float* p = part + static_cast<size_t>(taps - 1 - k) * channels + c;
  float s = 0.f;
  for (int q = 0; q < blocks; ++q) s += p[static_cast<size_t>(q) * kTaps * channels];
  dw[static_cast<size_t>(c) * taps + k] = from_float<TW>(s);
}

struct Args {
  const void *dy, *x, *w;
  void *y, *dx, *dw;
  float* part;
  int batch, time, channels, taps, blocks;
  cudaStream_t stream;
};

int items(int batch, int time, int strip) { return batch * ((time + strip - 1) / strip); }

int slices(int channels) { return (channels + kSlice - 1) / kSlice; }

// The persistent grid's blocks a channel slice: `per_sm` a multiprocessor
// shared among the slices, at least one, at most one an item.
int blocks_a_slice(int items, int channels, int sms, int per_sm) {
  int p = per_sm * sms / slices(channels);
  p = p < 1 ? 1 : p;
  p = p > items ? items : p;
  return p < kMaxGridY ? p : kMaxGridY;
}

template <typename K>
cudaError_t allow_smem(K kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

template <typename T, typename TW>
struct Fwd {
  static int run(const Args& a) {
    const int n = items(a.batch, a.time, kFwdStrip);
    if (a.blocks < 1 || a.blocks > n) return static_cast<int>(cudaErrorInvalidValue);
    auto kernel = depthwise_glu_fwd_kernel<T, TW>;
    const cudaError_t err = allow_smem(kernel, fwd_smem<T>());
    if (err != cudaSuccess) return static_cast<int>(err);
    kernel<<<dim3(slices(a.channels), a.blocks), kFwdGroups * kSlice, fwd_smem<T>(),
                                                    a.stream>>>(
        static_cast<const T*>(a.x), static_cast<const TW*>(a.w), static_cast<T*>(a.y),
        a.batch, a.time, a.channels, a.taps);
    return static_cast<int>(cudaGetLastError());
  }
};

template <typename T, typename TW>
struct Bwd {
  template <bool kDw>
  static int launch(const Args& a) {
    auto kernel = depthwise_glu_bwd_kernel<T, TW, kDw>;
    const cudaError_t err = allow_smem(kernel, bwd_smem<T>());
    if (err != cudaSuccess) return static_cast<int>(err);
    kernel<<<dim3(slices(a.channels), a.blocks), kBwdGroups * kSlice, bwd_smem<T>(),
                                                    a.stream>>>(
        static_cast<const T*>(a.dy), static_cast<const T*>(a.x),
        static_cast<const TW*>(a.w), static_cast<T*>(a.dx), a.part, a.batch, a.time,
        a.channels, a.taps);
    return static_cast<int>(cudaGetLastError());
  }

  static int run(const Args& a) {
    const int n = items(a.batch, a.time, kBwdStrip);
    if (a.blocks < 1 || a.blocks > n) return static_cast<int>(cudaErrorInvalidValue);
    if (a.dw == nullptr) return launch<false>(a);
    const int err = launch<true>(a);
    if (err != 0) return err;
    const int outs = a.taps * a.channels;
    depthwise_glu_bwd_dw_kernel<TW><<<(outs + kSumThreads - 1) / kSumThreads, kSumThreads,
                                      0, a.stream>>>(a.part, a.blocks, a.channels, a.taps,
                                                     static_cast<TW*>(a.dw));
    return static_cast<int>(cudaGetLastError());
  }
};

// dtype codes: 0 float32, 1 bfloat16
template <template <class, class> class L>
int dispatch(int x_dt, int w_dt, const Args& a) {
  if (x_dt < 0 || x_dt > 1 || w_dt < 0 || w_dt > 1) return static_cast<int>(cudaErrorInvalidValue);
  switch (x_dt * 2 + w_dt) {
    case 0: return L<float, float>::run(a);
    case 1: return L<float, bf16>::run(a);
    case 2: return L<bf16, float>::run(a);
    default: return L<bf16, bf16>::run(a);
  }
}

bool bad_shape(int batch, int time, int channels, int taps) {
  return batch < 1 || time < 1 || channels < kVec || channels % kVec != 0 || taps < 1 ||
         taps > kTaps;
}

}  // namespace

// y [B, T, C] from x [B, T, 2C] and w [C, 1, K] (C a multiple of 8, K ≤ 31),
// every pointer 16-byte aligned, x and y of one dtype, by `blocks` blocks a
// channel slice (ste_depthwise_glu_blocks).
extern "C" int ste_depthwise_glu_fwd(const void* x, const void* w, void* y, int batch,
                                     int time, int channels, int taps, int blocks,
                                     int x_dtype, int w_dtype, int device, void* stream) {
  if (bad_shape(batch, time, channels, taps)) return static_cast<int>(cudaErrorInvalidValue);
  cudaSetDevice(device);
  Args a{};
  a.x = x;
  a.w = w;
  a.y = y;
  a.batch = batch;
  a.time = time;
  a.channels = channels;
  a.taps = taps;
  a.blocks = blocks;
  a.stream = static_cast<cudaStream_t>(stream);
  return dispatch<Fwd>(x_dtype, w_dtype, a);
}

// dx [B, T, 2C] in x's dtype (null: not wanted) and, where dw is given, dw
// [C, 1, K] in w's dtype through `part` ([blocks, 31, C] fp32 scratch), by
// `blocks` blocks a channel slice (ste_depthwise_glu_blocks).
extern "C" int ste_depthwise_glu_bwd(const void* dy, const void* x, const void* w, void* dx,
                                     float* part, void* dw, int batch, int time,
                                     int channels, int taps, int blocks, int x_dtype,
                                     int w_dtype, int device, void* stream) {
  if (bad_shape(batch, time, channels, taps) || (dx == nullptr && dw == nullptr) ||
      (dw != nullptr && part == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaSetDevice(device);
  Args a{};
  a.dy = dy;
  a.x = x;
  a.w = w;
  a.dx = dx;
  a.dw = dw;
  a.part = part;
  a.batch = batch;
  a.time = time;
  a.channels = channels;
  a.taps = taps;
  a.blocks = blocks;
  a.stream = static_cast<cudaStream_t>(stream);
  return dispatch<Bwd>(x_dtype, w_dtype, a);
}

// The persistent grids' blocks a channel slice on `device`: the forward's
// and the backward's (fixed for a shape and a card, so the weight
// gradient's partial sums, and its bits, repeat).
extern "C" int ste_depthwise_glu_blocks(int batch, int time, int channels, int device,
                                        int* fwd_blocks, int* bwd_blocks) {
  if (bad_shape(batch, time, channels, 1)) return static_cast<int>(cudaErrorInvalidValue);
  int sms = 0;
  const cudaError_t err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return static_cast<int>(err);
  *fwd_blocks = blocks_a_slice(items(batch, time, kFwdStrip), channels, sms, kFwdBlocksPerSm);
  *bwd_blocks = blocks_a_slice(items(batch, time, kBwdStrip), channels, sms, kBwdBlocksPerSm);
  return 0;
}
