// Non-causal head-major attention for the encoder, with a key-length mask.
//
// Replaces whisperseg_tpu/ops/attention.py::fused_attention_head_major (the
// Pallas TPU kernel every encoder layer of the JAX package runs).
//
// Function, per batch item b, query head h and query row i:
//   s[j]  = (q[b,h,i,:] . kt[b,h/g,:,j]) * hd^-0.5, or -1e30 where j >= valid_len
//   p[j]  = exp(s[j] - max(s)) rounded to the input type
//   o     = (sum_j p[j] v[b,h/g,j,:]) / sum_j p[j]   (in the input type)
// with g = H / Hkv query heads sharing one K/V head (grouped-query attention).
//
// Bound on an H100: at the main path's shape (base model: B 4, H 8, Sp 512,
// hd 64, bf16) the kernel must move 8.4 MB (q, k, v in, o out) and do about
// 2.1 GFLOP, so device memory bounds it at about 2.5 us even on tensor cores.
// This first version does its products in float32 FMAs on the CUDA cores, so in
// practice the FMA issue rate and shared-memory reads bound it; tensor cores
// (mma/wgmma) and TMA are later work.
//
// Design: the TPU kernel keeps the whole [Sp, Sp] float32 score tile in VMEM
// (1 MB at Sp 512), which does not fit in a Hopper block's 227 KB of shared
// memory. Here one block of 256 threads owns one (b, h, 64-row query tile) and
// walks 64-key tiles with an online softmax: running max m and sum l per row,
// the output accumulator rescaled by exp(m_old - m_new) when the max grows.
// K tiles come from the pre-transposed kt, so their loads are coalesced along
// keys; key tiles wholly at or beyond valid_len are skipped (when valid_len >
// 0), which changes nothing because their weights are exactly 0. Each thread
// holds a 4-row by (hd/16)-column slice of the output in registers. Shared
// memory rows are padded so the score, softmax and PV phases read without
// bank conflicts. At B 4, H 8, Sp 512 the grid is 256 blocks for 132 SMs.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kRows = 64;    // query rows per block
constexpr int kKeys = 64;    // keys per tile
constexpr int kThreads = 256;
constexpr int kScoreLd = kKeys + 4;

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

template <int HD>
constexpr int smem_floats() {
  return kRows * (HD + 4)      // q tile
         + HD * kKeys          // k^T tile
         + kKeys * HD          // v tile
         + kRows * kScoreLd    // scores / probabilities
         + 3 * kRows;          // running max, running sum, rescale factor
}

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads)
attention_hm_kernel(const T* __restrict__ q, const T* __restrict__ kt,
                    const T* __restrict__ v, T* __restrict__ o, int H, int Hkv,
                    int Sp, int valid_len, float scale) {
  constexpr int kQLd = HD + 4;
  constexpr int kCols = HD / 16;  // output columns per thread
  extern __shared__ float smem[];
  float* qs = smem;
  float* ks = qs + kRows * kQLd;
  float* vs = ks + HD * kKeys;
  float* ss = vs + kKeys * HD;
  float* m_s = ss + kRows * kScoreLd;
  float* l_s = m_s + kRows;
  float* a_s = l_s + kRows;

  const int q0 = blockIdx.x * kRows;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / (H / Hkv);
  const int tid = threadIdx.x;
  const int ty = tid / 16;  // 0..15: rows ty*4 .. ty*4+3
  const int tx = tid % 16;  // columns tx + 16*j

  const T* qg = q + ((long long)(b * H + h) * Sp + q0) * HD;
  const T* ktg = kt + (long long)(b * Hkv + hk) * HD * Sp;
  const T* vg = v + (long long)(b * Hkv + hk) * Sp * HD;

  for (int i = tid; i < kRows * HD; i += kThreads)
    qs[(i / HD) * kQLd + i % HD] = to_float(qg[i]);
  for (int i = tid; i < kRows; i += kThreads) {
    m_s[i] = -INFINITY;
    l_s[i] = 0.f;
  }

  float acc[4][kCols];
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int c = 0; c < kCols; ++c) acc[r][c] = 0.f;

  const int live = valid_len > 0 ? min(valid_len, Sp) : Sp;
  const int n_tiles = (live + kKeys - 1) / kKeys;

  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = t * kKeys;
    for (int i = tid; i < HD * kKeys; i += kThreads) {
      const int d = i / kKeys, c = i % kKeys;
      ks[d * kKeys + c] = to_float(ktg[(long long)d * Sp + k0 + c]);
    }
    for (int i = tid; i < kKeys * HD; i += kThreads)
      vs[i] = to_float(vg[(long long)k0 * HD + i]);
    __syncthreads();

    // scores for rows ty*4+r, keys tx+16*j
    float s[4][4];
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[r][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < HD; ++d) {
      float qv[4], kv[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) qv[r] = qs[(ty * 4 + r) * kQLd + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) kv[j] = ks[d * kKeys + tx + 16 * j];
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[r][j] = fmaf(qv[r], kv[j], s[r][j]);
    }
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = tx + 16 * j;
        const bool masked = valid_len <= k0 + col;
        ss[(ty * 4 + r) * kScoreLd + col] = masked ? -1e30f : s[r][j] * scale;
      }
    __syncthreads();

    // online softmax: 4 neighbouring lanes per row, keys part + 4*i
    {
      const int row = tid / 4, part = tid % 4;
      float* srow = ss + row * kScoreLd;
      const float m_old = m_s[row];
      float mx = -INFINITY;
#pragma unroll
      for (int i = 0; i < kKeys / 4; ++i) mx = fmaxf(mx, srow[part + 4 * i]);
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m_old, mx);
      float sum = 0.f;
#pragma unroll
      for (int i = 0; i < kKeys / 4; ++i) {
        const float p = to_float(from_float<T>(expf(srow[part + 4 * i] - m_new)));
        srow[part + 4 * i] = p;
        sum += p;
      }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      if (part == 0) {
        const float alpha = expf(m_old - m_new);
        l_s[row] = l_s[row] * alpha + sum;
        m_s[row] = m_new;
        a_s[row] = alpha;
      }
    }
    __syncthreads();

    // rescale and accumulate p @ v
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const float alpha = a_s[ty * 4 + r];
#pragma unroll
      for (int c = 0; c < kCols; ++c) acc[r][c] *= alpha;
    }
#pragma unroll 4
    for (int k = 0; k < kKeys; ++k) {
      float pv[4], vv[kCols];
#pragma unroll
      for (int r = 0; r < 4; ++r) pv[r] = ss[(ty * 4 + r) * kScoreLd + k];
#pragma unroll
      for (int c = 0; c < kCols; ++c) vv[c] = vs[k * HD + tx + 16 * c];
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < kCols; ++c) acc[r][c] = fmaf(pv[r], vv[c], acc[r][c]);
    }
    __syncthreads();
  }

  T* og = o + ((long long)(b * H + h) * Sp + q0) * HD;
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int row = ty * 4 + r;
    const float inv = 1.f / l_s[row];
#pragma unroll
    for (int c = 0; c < kCols; ++c)
      og[row * HD + tx + 16 * c] = from_float<T>(acc[r][c] * inv);
  }
}

template <typename T, int HD>
int launch(const void* q, const void* kt, const void* v, void* o, int B, int H,
           int Hkv, int Sp, int valid_len, float scale, cudaStream_t stream) {
  constexpr size_t bytes = smem_floats<HD>() * sizeof(float);
  // The shared-memory limit is an attribute of the current device's context,
  // so it is raised on every launch (a cheap call), never cached per process.
  const cudaError_t err = cudaFuncSetAttribute(
      attention_hm_kernel<T, HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)bytes);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(Sp / kRows, H, B);
  attention_hm_kernel<T, HD><<<grid, kThreads, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(kt),
      static_cast<const T*>(v), static_cast<T*>(o), H, Hkv, Sp, valid_len,
      scale);
  return (int)cudaGetLastError();
}

}  // namespace

// q: [B, H, Sp, hd]; kt: [B, Hkv, hd, Sp]; v: [B, Hkv, Sp, hd]; o: [B, H, Sp,
// hd]; all contiguous, of one type: float32 (is_bf16 = 0) or bfloat16
// (is_bf16 = 1). Sp must be a multiple of 64, hd 64 or 128, H a multiple of
// Hkv; scale multiplies the float32 scores (hd^-0.5). Returns the
// cudaGetLastError() code of the launch.
extern "C" int ws_attention_hm(const void* q, const void* kt, const void* v,
                               void* o, int B, int H, int Hkv, int Sp, int hd,
                               int valid_len, float scale, int is_bf16,
                               cudaStream_t stream) {
  if (B <= 0 || H <= 0 || Hkv <= 0 || H % Hkv != 0 || Sp <= 0 ||
      Sp % kRows != 0)
    return (int)cudaErrorInvalidValue;
  if (hd == 64)
    return is_bf16 ? launch<__nv_bfloat16, 64>(q, kt, v, o, B, H, Hkv, Sp,
                                               valid_len, scale, stream)
                   : launch<float, 64>(q, kt, v, o, B, H, Hkv, Sp, valid_len,
                                       scale, stream);
  if (hd == 128)
    return is_bf16 ? launch<__nv_bfloat16, 128>(q, kt, v, o, B, H, Hkv, Sp,
                                                valid_len, scale, stream)
                   : launch<float, 128>(q, kt, v, o, B, H, Hkv, Sp, valid_len,
                                        scale, stream);
  return (int)cudaErrorInvalidValue;
}
