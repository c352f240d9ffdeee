// Fused dequantize-and-multiply for int8 and packed-int4 weights (w8a16, w4a16).
//
// Replaces whisperseg_tpu/ops/quant.py::_qdot_pallas_w8a16 and
// ::_qdot_pallas_w4a16 (the Pallas TPU kernels behind inference_dtype "int8"
// and "int4").
//
// Function (both kernels), for x [M, K] and a quantized weight [K, N]:
//   y[m, n] = sum_k bf16(x[m, k]) * w[k, n]        (float32 accumulation)
//   w8a16:  w[k, n] = bf16( bf16(q[k, n]) * bf16(scale[n]) ),  q int8
//   w4a16:  w[k, n] = bf16( bf16(q[k, n]) * bf16(scale[k / gs, n]) ), q a
//           signed nibble: byte i of column n holds row i in its low nibble
//           and row i + K/2 in its high nibble; gs = K / groups.
// The dequantized weight never reaches device memory. The product of two bf16
// values is exact in float32, so the float32 FMAs below give the sum a bf16
// matrix unit with float32 accumulation gives, up to its order.
//
// Bound on an H100: memory. The callers are the decode step and the prefill
// (M = 16 to 48 rows), where every weight byte is used by a few rows only:
// the int8 (or nibble) weight stream, K*N (K*N/2) bytes, outweighs the
// arithmetic by far. At these sizes (0.26 to 1 MB of weights) the launch
// itself is of the same order as the stream.
//
// Design: a block of 8 warps owns 8 rows of x and 128 output columns. A lane
// owns 4 adjacent columns, so a warp reads 128 contiguous weight bytes per
// contraction row; the 8 warps split the contraction rows of each staged
// chunk, each loading 8 rows ahead of their use (with 8 to 80 blocks on 132
// SMs, loads in flight are what hides the memory's latency), and their
// partial sums are added in a fixed order through shared
// memory (no atomics: the result is the same from run to run). x is rounded
// to bf16 once, while it is staged in shared memory. Every K and N is taken:
// ragged edges are masked, and the 4-byte weight load falls back to single
// bytes where N is not a multiple of 4. The w4a16 kernel indexes the scale
// group per element, because the two nibbles of one byte lie K/2 rows apart
// and, with K = 384 and groups of 128, in different phases of their groups.
// More rows than 8 go to further blocks (blockIdx.y), which read the same
// weights through L2.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kCols = 4;                 // output columns per lane
constexpr int kTileN = 32 * kCols;       // 128 columns per block
constexpr int kTileM = 8;                // rows of x per block
constexpr int kChunk = 256;              // contraction rows staged per pass
constexpr int kBatch = 8;                // weight rows a warp loads ahead
constexpr int kChunk4 = kChunk / 2;      // w4a16: byte rows, two rows each
static_assert(kChunk4 % (kWarps * kBatch) == 0, "whole batches per chunk");

__device__ __forceinline__ float bf16_round(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

__device__ __forceinline__ float load_x(const float* x, long long i) {
  return bf16_round(x[i]);
}
__device__ __forceinline__ float load_x(const __nv_bfloat16* x, long long i) {
  return __bfloat162float(x[i]);
}

// Stage rows [m0, m0 + kTileM) x columns [c0, min(c0 + CHUNK, c_end)) of
// x [m, ld] into xs[CHUNK][kTileM], rounded to bf16, zero beyond the edges.
template <int CHUNK, typename XT>
__device__ __forceinline__ void stage_x(const XT* __restrict__ x,
                                        float (*xs)[kTileM], int m0, int c0,
                                        int c_end, int m, int ld) {
  for (int i = threadIdx.x; i < CHUNK * kTileM; i += kThreads) {
    const int kl = i % CHUNK;
    const int ml = i / CHUNK;
    float v = 0.f;
    if (c0 + kl < c_end && m0 + ml < m)
      v = load_x(x, (long long)(m0 + ml) * ld + c0 + kl);
    xs[kl][ml] = v;
  }
}

// Four weight bytes of one contraction row, columns n0 .. n0 + 3.
__device__ __forceinline__ void load_bytes(const int8_t* __restrict__ row,
                                           int n0, int n, bool vec,
                                           int (&q)[kCols]) {
  if (vec) {
    const char4 p = *reinterpret_cast<const char4*>(row + n0);
    q[0] = p.x; q[1] = p.y; q[2] = p.z; q[3] = p.w;
  } else {
#pragma unroll
    for (int c = 0; c < kCols; ++c) q[c] = (n0 + c < n) ? row[n0 + c] : 0;
  }
}

__device__ __forceinline__ void load_scales(const float* __restrict__ row,
                                            int n0, int n, float (&s)[kCols]) {
#pragma unroll
  for (int c = 0; c < kCols; ++c)
    s[c] = (n0 + c < n) ? bf16_round(row[n0 + c]) : 0.f;
}

__device__ __forceinline__ void accumulate(float (&acc)[kTileM][kCols],
                                           const float (*xs)[kTileM], int kl,
                                           const float (&w)[kCols]) {
  const float4 a = *reinterpret_cast<const float4*>(&xs[kl][0]);
  const float4 b = *reinterpret_cast<const float4*>(&xs[kl][4]);
  const float xv[kTileM] = {a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w};
#pragma unroll
  for (int mi = 0; mi < kTileM; ++mi)
#pragma unroll
    for (int c = 0; c < kCols; ++c) acc[mi][c] = fmaf(xv[mi], w[c], acc[mi][c]);
}

// Add the warps' partial sums in warp order and write the block's tile of y.
__device__ __forceinline__ void reduce_and_store(
    float (&acc)[kTileM][kCols], float (*red)[kTileM][kTileN],
    float* __restrict__ y, int m0, int nb, int m, int n) {
  const int lane = threadIdx.x % 32;
  const int warp = threadIdx.x / 32;
#pragma unroll
  for (int mi = 0; mi < kTileM; ++mi)
#pragma unroll
    for (int c = 0; c < kCols; ++c) red[warp][mi][lane * kCols + c] = acc[mi][c];
  __syncthreads();
  for (int i = threadIdx.x; i < kTileM * kTileN; i += kThreads) {
    const int mi = i / kTileN;
    const int nl = i % kTileN;
    if (m0 + mi >= m || nb + nl >= n) continue;
    float sum = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) sum += red[w][mi][nl];
    y[(long long)(m0 + mi) * n + nb + nl] = sum;
  }
}

template <typename XT>
__global__ void __launch_bounds__(kThreads)
qdot_w8a16_kernel(const XT* __restrict__ x, const int8_t* __restrict__ w,
                  const float* __restrict__ scale, float* __restrict__ y, int m,
                  int k, int n) {
  __shared__ __align__(16) float xs[kChunk][kTileM];
  __shared__ float red[kWarps][kTileM][kTileN];

  const int lane = threadIdx.x % 32;
  const int warp = threadIdx.x / 32;
  const int nb = blockIdx.x * kTileN;
  const int n0 = nb + lane * kCols;
  const int m0 = blockIdx.y * kTileM;
  const bool vec = (n % kCols == 0) && n0 < n;

  float sc[kCols];
  load_scales(scale, n0, n, sc);
  float acc[kTileM][kCols];
#pragma unroll
  for (int mi = 0; mi < kTileM; ++mi)
#pragma unroll
    for (int c = 0; c < kCols; ++c) acc[mi][c] = 0.f;

  for (int k0 = 0; k0 < k; k0 += kChunk) {
    stage_x<kChunk>(x, xs, m0, k0, k, m, k);
    __syncthreads();
    const int kend = min(kChunk, k - k0);
    if (n0 < n) {
      for (int kb = warp; kb < kend; kb += kWarps * kBatch) {
        // all loads of a batch are started before the first is used; rows
        // past the edge count as zero weights (x is staged as zero there)
        int q[kBatch][kCols];
#pragma unroll
        for (int u = 0; u < kBatch; ++u) {
          const int kl = kb + u * kWarps;
          if (kl < kend) {
            load_bytes(w + (long long)(k0 + kl) * n, n0, n, vec, q[u]);
          } else {
#pragma unroll
            for (int c = 0; c < kCols; ++c) q[u][c] = 0;
          }
        }
#pragma unroll
        for (int u = 0; u < kBatch; ++u) {
          float wv[kCols];
#pragma unroll
          for (int c = 0; c < kCols; ++c)
            wv[c] = bf16_round((float)q[u][c] * sc[c]);
          accumulate(acc, xs, kb + u * kWarps, wv);
        }
      }
    }
    __syncthreads();
  }
  reduce_and_store(acc, red, y, m0, nb, m, n);
}

template <typename XT>
__global__ void __launch_bounds__(kThreads)
qdot_w4a16_kernel(const XT* __restrict__ x, const int8_t* __restrict__ packed,
                  const float* __restrict__ scale, float* __restrict__ y, int m,
                  int k, int n, int gs) {
  __shared__ __align__(16) float xs_lo[kChunk4][kTileM];
  __shared__ __align__(16) float xs_hi[kChunk4][kTileM];
  __shared__ float red[kWarps][kTileM][kTileN];

  const int lane = threadIdx.x % 32;
  const int warp = threadIdx.x / 32;
  const int nb = blockIdx.x * kTileN;
  const int n0 = nb + lane * kCols;
  const int m0 = blockIdx.y * kTileM;
  const bool vec = (n % kCols == 0) && n0 < n;
  const int half = k / 2;

  float acc[kTileM][kCols];
#pragma unroll
  for (int mi = 0; mi < kTileM; ++mi)
#pragma unroll
    for (int c = 0; c < kCols; ++c) acc[mi][c] = 0.f;

  float s_lo[kCols], s_hi[kCols];
  int g_lo = -1, g_hi = -1;  // groups whose scales s_lo / s_hi hold

  // byte row i carries contraction rows i (low nibble) and i + half (high)
  for (int i0 = 0; i0 < half; i0 += kChunk4) {
    stage_x<kChunk4>(x, xs_lo, m0, i0, half, m, k);
    stage_x<kChunk4>(x, xs_hi, m0, half + i0, k, m, k);
    __syncthreads();
    const int kend = min(kChunk4, half - i0);
    if (n0 < n) {
      for (int kb = warp; kb < kend; kb += kWarps * kBatch) {
        int p[kBatch][kCols];  // loaded ahead, zero past the edge (see w8a16)
#pragma unroll
        for (int u = 0; u < kBatch; ++u) {
          const int kl = kb + u * kWarps;
          if (kl < kend) {
            load_bytes(packed + (long long)(i0 + kl) * n, n0, n, vec, p[u]);
          } else {
#pragma unroll
            for (int c = 0; c < kCols; ++c) p[u][c] = 0;
          }
        }
#pragma unroll
        for (int u = 0; u < kBatch; ++u) {
          const int kl = kb + u * kWarps;
          const int i = min(i0 + kl, half - 1);  // a row whose group exists
          if (i / gs != g_lo) {
            g_lo = i / gs;
            load_scales(scale + (long long)g_lo * n, n0, n, s_lo);
          }
          if ((i + half) / gs != g_hi) {
            g_hi = (i + half) / gs;
            load_scales(scale + (long long)g_hi * n, n0, n, s_hi);
          }
          float w_lo[kCols], w_hi[kCols];
#pragma unroll
          for (int c = 0; c < kCols; ++c) {
            const int lo_u = p[u][c] & 15;
            const int lo = lo_u - (lo_u > 7 ? 16 : 0);  // sign-extend the nibble
            const int hi = p[u][c] >> 4;                // arithmetic: floor(p / 16)
            w_lo[c] = bf16_round((float)lo * s_lo[c]);
            w_hi[c] = bf16_round((float)hi * s_hi[c]);
          }
          accumulate(acc, xs_lo, kl, w_lo);
          accumulate(acc, xs_hi, kl, w_hi);
        }
      }
    }
    __syncthreads();
  }
  reduce_and_store(acc, red, y, m0, nb, m, n);
}

inline dim3 grid_for(int m, int n) {
  return dim3((n + kTileN - 1) / kTileN, (m + kTileM - 1) / kTileM);
}

}  // namespace

// x: [m, k] contiguous, float32 or (x_is_bf16) bfloat16. w: int8 [k, n]
// contiguous. scale: float32 [n]. y: float32 [m, n] contiguous. Returns the
// cudaGetLastError() code of the launch.
extern "C" int ws_qdot_w8a16(const void* x, int x_is_bf16, const int8_t* w,
                             const float* scale, float* y, int m, int k, int n,
                             cudaStream_t stream) {
  if (m <= 0 || k <= 0 || n <= 0) return (int)cudaErrorInvalidValue;
  if (x_is_bf16)
    qdot_w8a16_kernel<<<grid_for(m, n), kThreads, 0, stream>>>(
        static_cast<const __nv_bfloat16*>(x), w, scale, y, m, k, n);
  else
    qdot_w8a16_kernel<<<grid_for(m, n), kThreads, 0, stream>>>(
        static_cast<const float*>(x), w, scale, y, m, k, n);
  return (int)cudaGetLastError();
}

// As above with packed: int8 [k / 2, n] (two nibbles a byte) and scale:
// float32 [groups, n]; k even and a multiple of groups.
extern "C" int ws_qdot_w4a16(const void* x, int x_is_bf16, const int8_t* packed,
                             const float* scale, float* y, int m, int k, int n,
                             int groups, cudaStream_t stream) {
  if (m <= 0 || k <= 0 || n <= 0 || groups <= 0 || k % 2 || k % groups)
    return (int)cudaErrorInvalidValue;
  const int gs = k / groups;
  if (x_is_bf16)
    qdot_w4a16_kernel<<<grid_for(m, n), kThreads, 0, stream>>>(
        static_cast<const __nv_bfloat16*>(x), packed, scale, y, m, k, n, gs);
  else
    qdot_w4a16_kernel<<<grid_for(m, n), kThreads, 0, stream>>>(
        static_cast<const float*>(x), packed, scale, y, m, k, n, gs);
  return (int)cudaGetLastError();
}
