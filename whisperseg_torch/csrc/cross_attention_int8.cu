// Single-query cross-attention on int8 K/V with per-(position, kv head)
// scales: the decode step's cross-attention under int8_kv.
//
// Replaces whisperseg_tpu/ops/cross_attention.py::cross_attention_int8 (the
// Pallas TPU kernel).
//
// Function, per batch row b and query head h (kv head kh = h / groups), with
// the roundings of the TPU kernel's body:
//   score[s] = ( sum_d bf16( bf16(q[b, h, d]) * bf16(K[b, s, kh, d]) ) )
//              * k_scale[b, s, kh] * (1 / sqrt(hd))         float32 sum
//   p        = softmax over s < seq_len of score            float32
//   w[s]     = bf16( p[s] * v_scale[b, s, kh] )
//   out[b, h, d] = sum_s w[s] * V[b, s, kh, d]              float32 sum
// Positions at or beyond seq_len are never read. The query heads of a group
// read the same K/V.
//
// Bound on an H100: memory. K and V are read once each (2 * B * S * Dkv
// bytes, 8.2 MB at B 16, S 500, Dkv 512) for about 2 operations a byte. The
// dequantized K/V never reach device memory.
//
// Design: one block of 256 threads per (batch row, kv head); at the base
// model's decode step that is 128 blocks for 132 SMs. The block loops over
// the query heads of its group, so a group's K/V come from L1/L2 after the
// first head. Scores: a thread owns whole positions and reads its K row in
// 16-byte pieces. The row of scores, then of weights, lives in shared memory
// (one float a position). Max and sum are block reductions (warp shuffles,
// then one value a warp). Output: thread (c, j) sums 4 adjacent columns of V
// (one 4-byte load a position) over the positions j, j + J, ..., so the
// threads of a warp read adjacent bytes of two V rows; the J partial sums of
// a column are added in a fixed order.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxHeadDim = 256;
constexpr int kMaxSeqLen = 8192;

__device__ __forceinline__ float bf16_round(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

template <bool IS_MAX>
__device__ __forceinline__ float block_reduce(float v, float* scratch) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float o = __shfl_xor_sync(0xffffffffu, v, off);
    v = IS_MAX ? fmaxf(v, o) : v + o;
  }
  __syncthreads();  // scratch may still be read from an earlier reduction
  if (threadIdx.x % 32 == 0) scratch[threadIdx.x / 32] = v;
  __syncthreads();
  float r = scratch[0];
#pragma unroll
  for (int w = 1; w < kWarps; ++w) r = IS_MAX ? fmaxf(r, scratch[w]) : r + scratch[w];
  return r;
}

__global__ void __launch_bounds__(kThreads)
cross_attention_int8_kernel(const float* __restrict__ q,
                            const int8_t* __restrict__ kq,
                            const __nv_bfloat16* __restrict__ ks,
                            const int8_t* __restrict__ vq,
                            const __nv_bfloat16* __restrict__ vs,
                            float* __restrict__ out, int sp, int seq_len,
                            int hkv, int groups, int hd, int hd_p2,
                            float inv_sqrt) {
  extern __shared__ float row[];  // [seq_len] scores, then weights
  __shared__ float qb[kMaxHeadDim];
  __shared__ float part[4 * kThreads];
  __shared__ float scratch[kWarps];

  const int kh = blockIdx.x;
  const int b = blockIdx.y;
  const int tid = threadIdx.x;
  const int dkv = hkv * hd;
  const int dq = dkv * groups;
  const long long base = (long long)b * sp;   // first position of this row
  const bool vec = hd % 16 == 0;              // K rows then start 16-aligned

  for (int g = 0; g < groups; ++g) {
    const int head = kh * groups + g;
    if (tid < hd) qb[tid] = bf16_round(q[(long long)b * dq + head * hd + tid]);
    __syncthreads();

    float lmax = -INFINITY;
    for (int s = tid; s < seq_len; s += kThreads) {
      const int8_t* kr = kq + (base + s) * dkv + kh * hd;
      float a = 0.f;
      if (vec) {
        for (int d0 = 0; d0 < hd; d0 += 16) {
          const int4 pk = *reinterpret_cast<const int4*>(kr + d0);
          const int8_t* e = reinterpret_cast<const int8_t*>(&pk);
#pragma unroll
          for (int j = 0; j < 16; ++j)
            a += bf16_round(qb[d0 + j] * (float)e[j]);
        }
      } else {
        for (int d = 0; d < hd; ++d) a += bf16_round(qb[d] * (float)kr[d]);
      }
      a = a * __bfloat162float(ks[(base + s) * hkv + kh]) * inv_sqrt;
      row[s] = a;
      lmax = fmaxf(lmax, a);
    }
    const float m = block_reduce<true>(lmax, scratch);

    float lsum = 0.f;
    for (int s = tid; s < seq_len; s += kThreads) {
      const float e = expf(row[s] - m);
      row[s] = e;
      lsum += e;
    }
    const float l = block_reduce<false>(lsum, scratch);

    for (int s = tid; s < seq_len; s += kThreads)
      row[s] = bf16_round(row[s] / l * __bfloat162float(vs[(base + s) * hkv + kh]));
    __syncthreads();

    // thread (c, j): columns c * vw .. c * vw + vw - 1 of V over the
    // positions j, j + nj, ...; vw = 4 bytes a load where hd allows it
    const int vw = hd % 4 == 0 ? 4 : 1;
    const int cols = hd_p2 / vw;
    const int c = tid % cols;
    const int j = tid / cols;
    const int nj = kThreads / cols;
    float a[4] = {0.f, 0.f, 0.f, 0.f};
    if (c * vw < hd) {
      const int8_t* vc = vq + base * dkv + kh * hd + c * vw;
      if (vw == 4) {
#pragma unroll 4
        for (int s = j; s < seq_len; s += nj) {
          const char4 v4 = *reinterpret_cast<const char4*>(vc + (long long)s * dkv);
          const float w = row[s];
          a[0] = fmaf(w, (float)v4.x, a[0]);
          a[1] = fmaf(w, (float)v4.y, a[1]);
          a[2] = fmaf(w, (float)v4.z, a[2]);
          a[3] = fmaf(w, (float)v4.w, a[3]);
        }
      } else {
        for (int s = j; s < seq_len; s += nj)
          a[0] = fmaf(row[s], (float)vc[(long long)s * dkv], a[0]);
      }
    }
    float* mine = part + (j * cols + c) * vw;
    mine[0] = a[0];
    if (vw == 4) { mine[1] = a[1]; mine[2] = a[2]; mine[3] = a[3]; }
    __syncthreads();
    if (tid < hd) {
      float sum = 0.f;
      for (int jj = 0; jj < nj; ++jj)
        sum += part[(jj * cols + tid / vw) * vw + tid % vw];
      out[(long long)b * dq + head * hd + tid] = sum;
    }
    __syncthreads();  // qb, row and part are rewritten by the next head
  }
}

}  // namespace

// q, out: float32 [batch, hkv * groups * hd] (head-major; the query heads of
// one kv head adjacent). kq, vq: int8 [batch, sp, hkv * hd]. ks, vs: bfloat16
// [batch, sp, hkv]. All contiguous. Positions >= seq_len are ignored.
// inv_sqrt: 1 / sqrt(hd) as the caller rounds it. Returns the
// cudaGetLastError() code of the launch.
extern "C" int ws_cross_attention_int8(const float* q, const int8_t* kq,
                                       const __nv_bfloat16* ks, const int8_t* vq,
                                       const __nv_bfloat16* vs, float* out,
                                       int batch, int sp, int seq_len, int hkv,
                                       int groups, int hd, float inv_sqrt,
                                       cudaStream_t stream) {
  if (batch <= 0 || hkv <= 0 || groups <= 0 || hd <= 0 || hd > kMaxHeadDim ||
      seq_len <= 0 || seq_len > sp || seq_len > kMaxSeqLen)
    return (int)cudaErrorInvalidValue;
  int hd_p2 = 1;
  while (hd_p2 < hd) hd_p2 *= 2;
  const dim3 grid(hkv, batch);
  const size_t smem = sizeof(float) * (size_t)seq_len;
  cross_attention_int8_kernel<<<grid, kThreads, smem, stream>>>(
      q, kq, ks, vq, vs, out, sp, seq_len, hkv, groups, hd, hd_p2, inv_sqrt);
  return (int)cudaGetLastError();
}
