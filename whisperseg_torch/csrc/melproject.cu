// Log-mel projection: power spectrum -> mel filterbank -> log10, fused.
//
// Replaces whisperseg_tpu/ops/logmel_pallas.py::melproject_pallas (the Pallas
// TPU kernel of the JAX package's frontend).
//
// Function, per frame f of batch item b:
//   out[b, m, f] = log10(max(sum_k (re[b,k,f]^2 + im[b,k,f]^2) * mel[k, m], 1e-10))
// in plain float32 FMAs (no TF32: the log compression turns a 1e-3 relative
// error of the mel sum into a visible feature error).
//
// Bound on an H100: memory. At the main path's shape (32 kHz audio, n_fft 512,
// 4 clips of 1000 frames) the kernel reads an 8.2 MB spectrum and writes a
// 1.3 MB output while doing about 0.17 GFLOP, so moving the bytes takes longer
// than the arithmetic. The power spectrum, the largest intermediate, never
// reaches device memory.
//
// Design: one block of 128 threads per tile of 32 frames of one clip. The
// block walks the frequency bins in chunks of 32. For each chunk it stages the
// power of its 32 frames and the chunk's rows of the mel matrix in shared
// memory, so the mel matrix (82 KB at n_fft 512, 1.3 MB at n_fft 8192) is
// never held whole. The staging loop maps consecutive threads onto whichever
// of the bin and frame axes is contiguous in memory, so the same kernel reads
// the TPU kernel's [B, 2*f_pad, F] layout and torch.fft.rfft's interleaved
// complex [B, F, n_freq] output in place, both coalesced. Each thread then
// owns one frame and a quarter of the mel bins and keeps those sums in
// registers; a warp shares one mel group, so its reads of the staged mel rows
// are broadcasts.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kFrames = 32;                  // frames per block
constexpr int kBins = 32;                    // frequency bins per chunk
constexpr int kGroups = 4;                   // mel groups per frame
constexpr int kThreads = kFrames * kGroups;  // 128
constexpr int kMaxMel = 128;

template <int PER>  // mel bins per group; kGroups * PER >= n_mel
__global__ void __launch_bounds__(kThreads)
melproject_kernel(const float* __restrict__ base, long long sb, long long sk,
                  long long sf, long long im_off, const float* __restrict__ mel,
                  float* __restrict__ out, int n_frames, int n_freq, int n_mel) {
  __shared__ float power[kFrames][kBins + 1];
  __shared__ float mel_rows[kBins][kGroups * PER];

  const int b = blockIdx.y;
  const int f0 = blockIdx.x * kFrames;
  const int tid = threadIdx.x;
  const int frame = tid % kFrames;
  const int group = tid / kFrames;
  const bool bins_minor = sk < sf;
  const float* src = base + b * sb;

  float acc[PER];
#pragma unroll
  for (int j = 0; j < PER; ++j) acc[j] = 0.f;

  for (int k0 = 0; k0 < n_freq; k0 += kBins) {
    for (int i = tid; i < kFrames * kBins; i += kThreads) {
      const int kl = bins_minor ? i % kBins : i / kFrames;
      const int fl = bins_minor ? i / kBins : i % kFrames;
      const int k = k0 + kl;
      const int f = f0 + fl;
      float p = 0.f;
      if (k < n_freq && f < n_frames) {
        const float* a = src + k * sk + f * sf;
        const float re = a[0];
        const float im = a[im_off];
        p = re * re + im * im;
      }
      power[fl][kl] = p;
    }
    for (int i = tid; i < kBins * kGroups * PER; i += kThreads) {
      const int kl = i / (kGroups * PER);
      const int m = i % (kGroups * PER);
      const int k = k0 + kl;
      mel_rows[kl][m] =
          (k < n_freq && m < n_mel) ? mel[(long long)k * n_mel + m] : 0.f;
    }
    __syncthreads();
#pragma unroll 4
    for (int kl = 0; kl < kBins; ++kl) {
      const float p = power[frame][kl];
#pragma unroll
      for (int j = 0; j < PER; ++j)
        acc[j] = fmaf(p, mel_rows[kl][group * PER + j], acc[j]);
    }
    __syncthreads();
  }

  const int f = f0 + frame;
  if (f >= n_frames) return;
#pragma unroll
  for (int j = 0; j < PER; ++j) {
    const int m = group * PER + j;
    if (m < n_mel)
      out[((long long)b * n_mel + m) * n_frames + f] =
          log10f(fmaxf(acc[j], 1e-10f));
  }
}

}  // namespace

// reim: the spectrum, read through strides (in floats): element (b, k, f) of
// the real part sits at base + b*sb + k*sk + f*sf, the imaginary part im_off
// floats after it. mel: [n_freq, n_mel] contiguous. out: [batch, n_mel,
// n_frames] contiguous. Returns the cudaGetLastError() code of the launch.
extern "C" int ws_melproject(const float* base, long long sb, long long sk,
                             long long sf, long long im_off, const float* mel,
                             float* out, int batch, int n_frames, int n_freq,
                             int n_mel, cudaStream_t stream) {
  if (batch <= 0 || n_frames <= 0 || n_freq <= 0 || n_mel <= 0 ||
      n_mel > kMaxMel)
    return (int)cudaErrorInvalidValue;
  const dim3 grid((n_frames + kFrames - 1) / kFrames, batch);
  if (n_mel <= kGroups * 20)
    melproject_kernel<20><<<grid, kThreads, 0, stream>>>(
        base, sb, sk, sf, im_off, mel, out, n_frames, n_freq, n_mel);
  else
    melproject_kernel<32><<<grid, kThreads, 0, stream>>>(
        base, sb, sk, sf, im_off, mel, out, n_frames, n_freq, n_mel);
  return (int)cudaGetLastError();
}
