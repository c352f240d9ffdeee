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
// 1.3 MB output; at n_fft 8192 the spectrum is 131 MB. The power spectrum,
// the largest intermediate, never reaches device memory.
//
// Design.
//   * Only each mel column's band is summed. A slaney filterbank is
//     triangular: 2.4 % of its entries are nonzero, and the nonzeros of a
//     column form one run of bins. `rows` [n_mel, 2] holds each column's
//     first and one-past-last nonzero row and `weights` the matrix
//     transposed, so that a band's weights are contiguous
//     (ops/logmel.py::mel_bands, made on the device from the matrix). A
//     thread sums its column's band in ascending bin order with fmaf, so the
//     result is the dense sum's bit for bit: an FMA with a zero weight and a
//     finite non-negative power adds +0. Bins outside every band are never
//     read.
//   * One block of 256 threads per 4 frames of one clip (1000 blocks at the
//     main path's shape). It stages the power of its frames over every bin
//     some band covers (whole rows up to n_fft 8192, 64 KB of shared memory;
//     wider spectra in pieces), each (bin, frame) power computed once; then
//     every thread runs its columns' bands at once. Several blocks an SM
//     overlap one block's loads with another's sums.
//   * torch.fft.rfft's interleaved complex [B, F, n_freq] output (re, im
//     adjacent, bins minor) is read by 16-byte loads of two bins, each
//     frame's row at its own 16-byte boundary (a row may start 8 bytes off
//     it), 4 loads in flight a thread; any other layout (the TPU kernel's
//     [B, 2*f_pad, F]) by 4-byte loads that map consecutive threads onto its
//     contiguous axis.
//   * Thread (slot, frame) sums the columns slot and slot + 64 of its frame,
//     so the 8 columns of a warp are neighbours with bands of about one
//     width; a band's weights stream through L1, read once for the 4
//     frames.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxMel = 128;
constexpr int kWideFrames = 8;               // frames a block while its rows take <= 48 KB
constexpr int kNarrowFrames = 4;             // frames a block above
constexpr int kMaxPiece = 4608;              // bins staged at once
constexpr int kInFlight = 4;                 // loads a thread issues before it stores
constexpr int kUnroll = 8;                   // band terms whose loads precede their FMAs

struct Spectrum {
  const float* base;  // element (b, k, f): base[b*sb + k*sk + f*sf], imaginary im_off after
  long long sb, sk, sf, im_off;
  int n_frames, n_freq;
};

__device__ __forceinline__ float power_of(float re, float im) { return re * re + im * im; }

// Stages the power of bins [k0, k1) of this block's frames into
// power[fl * ld + k - k0]. Interleaved layout (VEC: sk 2, im_off 1, 16-byte
// aligned base, even sb / sf): each load takes bins kk, kk + 1 of one frame,
// the pair starting at the frame row's 16-byte boundary; the bins of a pair
// outside [k0, k1) are neither read nor staged.
template <bool VEC, int FRAMES>
__device__ __forceinline__ void stage(const Spectrum& s, int b, int f0, int k0, int k1,
                                      float* power, int ld) {
  const int frames = min(FRAMES, s.n_frames - f0);
  if (VEC) {
    const int pairs = (k1 - k0) / 2 + 1;  // per frame, enough from either parity
    for (int i0 = 0; i0 < frames * pairs; i0 += kThreads * kInFlight) {
      float4 v[kInFlight];
      int fl[kInFlight], kk[kInFlight];
#pragma unroll
      for (int u = 0; u < kInFlight; ++u) {
        const int i = i0 + u * kThreads + threadIdx.x;
        fl[u] = i / pairs;
        const long long row = b * s.sb + (f0 + fl[u]) * s.sf;  // even
        const int h = (int)((row / 2) & 1);  // bins k with k - h even start 16 bytes
        kk[u] = k0 - ((k0 + h) & 1) + 2 * (i % pairs);
        v[u] = make_float4(0.f, 0.f, 0.f, 0.f);
        if (i >= frames * pairs) continue;
        const float* src = s.base + row + 2LL * kk[u];
        const bool lo = kk[u] >= k0 && kk[u] < k1;
        const bool hi = kk[u] + 1 >= k0 && kk[u] + 1 < k1;
        if (lo && hi) {
          v[u] = __ldg(reinterpret_cast<const float4*>(src));
        } else if (lo) {
          const float2 x = __ldg(reinterpret_cast<const float2*>(src));
          v[u].x = x.x;
          v[u].y = x.y;
        } else if (hi) {
          const float2 x = __ldg(reinterpret_cast<const float2*>(src + 2));
          v[u].z = x.x;
          v[u].w = x.y;
        }
      }
#pragma unroll
      for (int u = 0; u < kInFlight; ++u) {
        if (i0 + u * kThreads + (int)threadIdx.x >= frames * pairs) continue;
        float* dst = power + fl[u] * ld - k0;
        if (kk[u] >= k0 && kk[u] < k1) dst[kk[u]] = power_of(v[u].x, v[u].y);
        if (kk[u] + 1 >= k0 && kk[u] + 1 < k1) dst[kk[u] + 1] = power_of(v[u].z, v[u].w);
      }
    }
  } else {
    // element i: (bin k0 + kl, frame f0 + fl), consecutive threads on
    // whichever of the two axes is contiguous in memory
    const bool bins_minor = s.sk < s.sf;
    const int len = k1 - k0;
    for (int i0 = 0; i0 < frames * len; i0 += kThreads * kInFlight) {
      float2 v[kInFlight];
#pragma unroll
      for (int u = 0; u < kInFlight; ++u) {
        const int i = i0 + u * kThreads + threadIdx.x;
        const int kl = bins_minor ? i % len : i / frames;
        const int fl = bins_minor ? i / len : i % frames;
        v[u] = make_float2(0.f, 0.f);
        if (i < frames * len) {
          const float* a = s.base + b * s.sb + (k0 + kl) * s.sk + (f0 + fl) * s.sf;
          v[u] = make_float2(__ldg(a), __ldg(a + s.im_off));
        }
      }
#pragma unroll
      for (int u = 0; u < kInFlight; ++u) {
        const int i = i0 + u * kThreads + threadIdx.x;
        const int kl = bins_minor ? i % len : i / frames;
        const int fl = bins_minor ? i / len : i % frames;
        if (i < frames * len) power[fl * ld + kl] = power_of(v[u].x, v[u].y);
      }
    }
  }
}

template <bool VEC, int FRAMES>
__global__ void __launch_bounds__(kThreads)
melproject_kernel(const Spectrum s, const float* __restrict__ weights,
                  const int* __restrict__ rows, float* __restrict__ out, int n_mel,
                  int piece) {
  constexpr int kSlots = kThreads / FRAMES;               // column slots
  constexpr int kPer = (kMaxMel + kSlots - 1) / kSlots;  // columns a slot
  extern __shared__ float power[];  // [FRAMES][piece + 1]
  __shared__ int band[kMaxMel][2];
  __shared__ int span[2];  // the bins any band covers

  const int b = blockIdx.y;
  const int f0 = blockIdx.x * FRAMES;
  const int tid = threadIdx.x;
  const int fl = tid % FRAMES;
  const int slot = tid / FRAMES;
  const int ld = piece + 1;

  for (int i = tid; i < 2 * n_mel; i += kThreads) band[i / 2][i % 2] = rows[i];
  __syncthreads();
  if (tid < 32) {
    int lo = s.n_freq, hi = 0;
    for (int m = tid; m < n_mel; m += 32) {
      if (band[m][0] < band[m][1]) {
        lo = min(lo, band[m][0]);
        hi = max(hi, band[m][1]);
      }
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      lo = min(lo, __shfl_xor_sync(0xffffffffu, lo, off));
      hi = max(hi, __shfl_xor_sync(0xffffffffu, hi, off));
    }
    if (tid == 0) {
      span[0] = lo;
      span[1] = hi;
    }
  }
  __syncthreads();
  const int klo = span[0], khi = span[1];

  float acc[kPer];
#pragma unroll
  for (int j = 0; j < kPer; ++j) acc[j] = 0.f;
  for (int k0 = klo; k0 < khi; k0 += piece) {
    const int k1 = min(k0 + piece, khi);
    if (k0 > klo) __syncthreads();  // the last piece's sums are done
    stage<VEC, FRAMES>(s, b, f0, k0, k1, power, ld);
    __syncthreads();
    const float* p = power + fl * ld;
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      const int m = slot + j * kSlots;
      if (m < n_mel) {
        const int lo = max(band[m][0], k0), hi = min(band[m][1], k1);
        const float* w = weights + (long long)m * s.n_freq;
        float a = acc[j];
        for (int k = lo; k < hi; k += kUnroll) {  // a group's loads, then its FMAs in order
          const int rem = hi - k;
          float pw[kUnroll], wt[kUnroll];
#pragma unroll
          for (int t = 0; t < kUnroll; ++t) {
            pw[t] = t < rem ? p[k + t - k0] : 0.f;
            wt[t] = t < rem ? __ldg(w + k + t) : 0.f;
          }
#pragma unroll
          for (int t = 0; t < kUnroll; ++t)
            if (t < rem) a = fmaf(pw[t], wt[t], a);
        }
        acc[j] = a;
      }
    }
  }

  const int f = f0 + fl;
  if (f >= s.n_frames) return;
#pragma unroll
  for (int j = 0; j < kPer; ++j) {
    const int m = slot + j * kSlots;
    if (m < n_mel)
      out[((long long)b * n_mel + m) * s.n_frames + f] = log10f(fmaxf(acc[j], 1e-10f));
  }
}

}  // namespace

// reim: the spectrum, read through strides (in floats): element (b, k, f) of
// the real part sits at base + b*sb + k*sk + f*sf, the imaginary part im_off
// floats after it. weights: the mel matrix transposed, [n_mel, n_freq]
// contiguous. rows: int32 [n_mel, 2], each column's first and one-past-last
// row that may be nonzero (every nonzero of the column inside it; an empty
// band sums to 0). out: [batch, n_mel, n_frames] contiguous. Returns the
// cudaGetLastError() code of the launch.
extern "C" int ws_melproject(const float* base, long long sb, long long sk,
                             long long sf, long long im_off, const float* weights,
                             const int* rows, float* out, int batch,
                             int n_frames, int n_freq, int n_mel,
                             cudaStream_t stream) {
  if (batch <= 0 || batch > 65535 || n_frames <= 0 || n_freq <= 0 || n_mel <= 0 ||
      n_mel > kMaxMel)
    return (int)cudaErrorInvalidValue;
  const Spectrum s = {base, sb, sk, sf, im_off, n_frames, n_freq};
  const int piece = n_freq < kMaxPiece ? n_freq : kMaxPiece;
  const bool wide = (long long)sizeof(float) * kWideFrames * (piece + 1) <= 48 * 1024;
  const int frames = wide ? kWideFrames : kNarrowFrames;
  const dim3 grid((n_frames + frames - 1) / frames, batch);
  const int smem = (int)sizeof(float) * frames * (piece + 1);
  const bool vec = sk == 2 && im_off == 1 && sb % 2 == 0 && sf % 2 == 0 &&
                   reinterpret_cast<uintptr_t>(base) % 16 == 0;
  auto kernel = vec ? (wide ? melproject_kernel<true, kWideFrames>
                            : melproject_kernel<true, kNarrowFrames>)
                    : (wide ? melproject_kernel<false, kWideFrames>
                            : melproject_kernel<false, kNarrowFrames>);
  cudaError_t err = cudaSuccess;
  // above 48 KB only by the attribute, set on every such launch: it belongs
  // to the current device context
  if (smem > 48 * 1024)
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<grid, kThreads, smem, stream>>>(s, weights, rows, out, n_mel, piece);
  return (int)cudaGetLastError();
}
