// Non-causal head-major attention for the encoder, with a key-length mask.
//
// Replaces whisperseg_tpu/ops/attention.py::fused_attention_head_major (the
// Pallas TPU kernel every encoder layer of the JAX package runs) and, with
// the row log-sum-exp, the forward of JAX's stock Pallas flash attention
// (flash_attention.py:758), which the JAX package runs when the encoder
// trains.
//
// Function, per batch item b, query head h and query row i:
//   s[j]  = (q[b,h,i,:] . kt[b,h/g,:,j]) * hd^-0.5, or -1e30 where j >= valid_len
//   p[j]  = exp(s[j] - max(s)) rounded to the input type
//   o     = (sum_j p[j] v[b,h/g,j,:]) / sum_j p[j]   (in the input type)
// with g = H / Hkv query heads sharing one K/V head (grouped-query attention).
// When the caller passes an ``lse`` buffer (training), each row also writes
// its float32 log-sum-exp max(s) + log(sum_j p[j]): the residual the
// backward kernels (attention_bwd.cu) rebuild the probabilities from, as
// JAX's stock flash-attention forward saves its row statistics l and m.
//
// The TPU kernel keeps the whole [Sp, Sp] float32 score tile in VMEM (1 MB
// at Sp 512), which does not fit in a Hopper block's 227 KB of shared
// memory. Here a block owns one (b, h, 64-row query tile) and walks 64-key
// tiles with an online softmax: running max m and sum l per row, the output
// accumulator and l rescaled by exp(m_old - m_new) when the max grows, and p
// rounded against the running max m_new (so p and l differ from a
// two-pass softmax's by a few bf16 ulps). l sums the rounded p. Only the
// key tiles below valid_len are walked (all Sp when valid_len <= 0, where
// every key is masked and the weights are uniform, as in the Pallas
// kernel): the skipped tiles' weights are exactly 0.
//
// Bound on an H100: at the main path's shape (base model: B 4, H 8, Sp 512,
// 500 valid keys, hd 64, bf16) the kernel must move 8.4 MB (q, k, v in, o
// out) and do 2 products of 2 B H Sp valid hd = 1.05 GFLOP, so device memory
// bounds it at about 2.5 us (the products take 2.1 us on the tensor cores).
//
// bfloat16 (serving and training): the products run on the tensor cores
// (mma.sync m16n8k16, float32 accumulators, mma_tiles.cuh), in the layout of
// attention_bwd.cu's dQ kernel. One block of 4 warps per (64-row query
// tile, head, batch); each warp owns 16 rows. The q tile arrives by cp.async
// and is then held as mma A fragments in registers. K^T [hd][64 keys] and V
// [64 keys][hd] tiles stream in by 16-byte cp.async, double-buffered, rows
// padded by 16 bytes so that ldmatrix reads them without bank conflicts.
// S = q K^T leaves each thread 2 rows x 16 keys of scores; the row max
// takes two shuffles within a quad of lanes; p = exp(s - m_new) (expf, as
// the float32 kernel) is rounded to bf16 straight into the A fragments of
// P V, and l adds those rounded values back in float32. The output is
// staged in q's place in shared memory and written with 16-byte stores;
// lanes tg == 0 write the log-sum-exp. 46 KB of shared memory at hd 64,
// 89 KB at hd 128.
//
// float32 (compute_dtype float32, the golden table, the finite-difference
// checks): the first design, float32 FMAs on the CUDA cores, bound by the
// FMA issue rate and shared-memory reads. One block of 256 threads per
// (b, h, 64-row query tile); K tiles come from the pre-transposed kt, so
// their loads are coalesced along keys; each thread holds a 4-row by
// (hd/16)-column slice of the output in registers; shared-memory rows are
// padded so the score, softmax and PV phases read without bank conflicts.
//
// At B 4, H 8, Sp 512 either grid is 256 blocks for 132 SMs. The
// shared-memory limit is raised on every launch: it is an attribute of the
// current device's context.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "mma_tiles.cuh"

namespace {

constexpr int kRows = 64;    // query rows per block
constexpr int kKeys = 64;    // keys per tile

// ------------------------------------------------ float32, on the CUDA cores

constexpr int kThreads = 256;
constexpr int kScoreLd = kKeys + 4;

template <int HD>
constexpr int smem_floats() {
  return kRows * (HD + 4)      // q tile
         + HD * kKeys          // k^T tile
         + kKeys * HD          // v tile
         + kRows * kScoreLd    // scores / probabilities
         + 3 * kRows;          // running max, running sum, rescale factor
}

template <int HD>
__global__ void __launch_bounds__(kThreads)
attention_hm_kernel(const float* __restrict__ q, const float* __restrict__ kt,
                    const float* __restrict__ v, float* __restrict__ o,
                    float* __restrict__ lse, int H, int Hkv, int Sp,
                    int valid_len, float scale) {
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

  const float* qg = q + ((long long)(b * H + h) * Sp + q0) * HD;
  const float* ktg = kt + (long long)(b * Hkv + hk) * HD * Sp;
  const float* vg = v + (long long)(b * Hkv + hk) * Sp * HD;

  for (int i = tid; i < kRows * HD; i += kThreads)
    qs[(i / HD) * kQLd + i % HD] = qg[i];
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
      ks[d * kKeys + c] = ktg[(long long)d * Sp + k0 + c];
    }
    for (int i = tid; i < kKeys * HD; i += kThreads)
      vs[i] = vg[(long long)k0 * HD + i];
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
        const float p = expf(srow[part + 4 * i] - m_new);
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

  float* og = o + ((long long)(b * H + h) * Sp + q0) * HD;
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int row = ty * 4 + r;
    const float inv = 1.f / l_s[row];
#pragma unroll
    for (int c = 0; c < kCols; ++c) og[row * HD + tx + 16 * c] = acc[r][c] * inv;
  }
  if (lse != nullptr && tid < kRows)
    lse[(long long)(b * H + h) * Sp + q0 + tid] = m_s[tid] + logf(l_s[tid]);
}

// ------------------------------------------------ bf16, on the tensor cores

using bf16 = __nv_bfloat16;
using tiles::cp_async_16;

constexpr int kTcThreads = 128;      // 4 warps, 16 query rows each
constexpr int kPad = 8;              // bf16 of padding at the end of a tile row
constexpr int kKtLd = kKeys + kPad;  // row stride of a K^T tile [hd][64 keys]

template <int HD>
constexpr int tc_smem_bytes() {
  constexpr int ld = HD + kPad;
  return 2 * (kRows * ld + 2 * (HD * kKtLd + kKeys * ld));  // q, 2 x (K^T, V)
}

// Copies a [rows][HD] bf16 tile (row stride HD in device memory) into shared
// memory with row stride HD + kPad, 16 bytes a copy.
template <int HD>
__device__ __forceinline__ void copy_rows(bf16* dst, const bf16* src, int rows,
                                          int tid) {
  constexpr int chunks = HD / 8;
  for (int i = tid; i < rows * chunks; i += kTcThreads)
    cp_async_16(dst + (i / chunks) * (HD + kPad) + (i % chunks) * 8,
                src + (long long)i * 8);
}

// Copies the [HD][64 keys] tile at key k0 of K^T [HD][Sp] into shared memory
// with row stride kKtLd.
template <int HD>
__device__ __forceinline__ void copy_kt(bf16* dst, const bf16* kt, int Sp,
                                        int k0, int tid) {
  for (int i = tid; i < HD * 8; i += kTcThreads)
    cp_async_16(dst + (i / 8) * kKtLd + (i % 8) * 8,
                kt + (long long)(i / 8) * Sp + k0 + (i % 8) * 8);
}

__device__ __forceinline__ float2 unpack_bf16(uint32_t v) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&v));
}

template <int HD>
__global__ void __launch_bounds__(kTcThreads)
attention_hm_tc_kernel(const bf16* __restrict__ q, const bf16* __restrict__ kt,
                       const bf16* __restrict__ v, bf16* __restrict__ o,
                       float* __restrict__ lse, int H, int Hkv, int Sp,
                       int valid_len, float scale) {
  constexpr int kLd = HD + kPad;
  constexpr int kStage = HD * kKtLd + kKeys * kLd;  // bf16 of one stage: K^T, V
  constexpr int kNt = HD / 8;                        // n tiles of the output
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* qs = reinterpret_cast<bf16*>(smem_raw);  // q, then o: [row][d]
  bf16* stages = qs + kRows * kLd;                // 2 x (K^T [d][key], V [key][d])

  const int q0 = blockIdx.x * kRows;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / (H / Hkv);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int gr = lane / 4, tg = lane % 4;
  const long long head = (long long)b * H + h;
  const bf16* ktg = kt + ((long long)b * Hkv + hk) * HD * Sp;
  const bf16* vg = v + ((long long)b * Hkv + hk) * Sp * HD;

  copy_rows<HD>(qs, q + (head * Sp + q0) * HD, kRows, tid);
  auto load_tile = [&](int t) {  // K^T and V of key tile t into stage t % 2
    bf16* st = stages + (t % 2) * kStage;
    copy_kt<HD>(st, ktg, Sp, t * kKeys, tid);
    copy_rows<HD>(st + HD * kKtLd, vg + (long long)t * kKeys * HD, kKeys, tid);
  };
  load_tile(0);
  tiles::cp_async_commit();  // q and tile 0: one group

  // this thread's rows in the fragments: gr and gr + 8 of the warp's 16
  uint32_t aq[HD / 16][4];
  float acc[kNt][4];
#pragma unroll
  for (int n = 0; n < kNt; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
  float m_lo = -INFINITY, m_hi = -INFINITY, l_lo = 0.f, l_hi = 0.f;

  const int live = valid_len > 0 ? min(valid_len, Sp) : Sp;
  const int n_tiles = (live + kKeys - 1) / kKeys;
  for (int t = 0; t < n_tiles; ++t) {
    if (t + 1 < n_tiles) {
      load_tile(t + 1);
      tiles::cp_async_commit();
      tiles::cp_async_wait<1>();
    } else {
      tiles::cp_async_wait<0>();
    }
    __syncthreads();
    if (t == 0) {
#pragma unroll
      for (int ks = 0; ks < HD / 16; ++ks)
        tiles::ldsm_a(aq[ks], qs, kLd, warp * 16, ks * 16, lane);
    }
    const bf16* kts = stages + (t % 2) * kStage;
    const bf16* vs = kts + HD * kKtLd;

    // S = q K^T: this warp's 16 rows x 64 keys
    float s[kKeys / 8][4];
#pragma unroll
    for (int n = 0; n < kKeys / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = 0.f;
#pragma unroll
    for (int ks = 0; ks < HD / 16; ++ks)
#pragma unroll
      for (int j = 0; j < kKeys / 16; ++j) {
        uint32_t bk[4];
        tiles::ldsm_b_trans(bk, kts, kKtLd, ks * 16, j * 16, lane);
        tiles::mma_bf16(s[2 * j], aq[ks], bk[0], bk[1]);
        tiles::mma_bf16(s[2 * j + 1], aq[ks], bk[2], bk[3]);
      }

    // scaled scores, -1e30 at masked keys (only the last live tile has any,
    // or every tile when valid_len <= 0); the rows' maxima over the quad
    const int k0 = t * kKeys;
    const bool edge = k0 + kKeys > valid_len;
    float mx_lo = -INFINITY, mx_hi = -INFINITY;
#pragma unroll
    for (int n = 0; n < kKeys / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = k0 + n * 8 + 2 * tg + (e & 1);
        s[n][e] = (edge && key >= valid_len) ? -1e30f : s[n][e] * scale;
        if (e < 2) mx_lo = fmaxf(mx_lo, s[n][e]);
        else mx_hi = fmaxf(mx_hi, s[n][e]);
      }
#pragma unroll
    for (int x = 1; x <= 2; x *= 2) {
      mx_lo = fmaxf(mx_lo, __shfl_xor_sync(0xffffffffu, mx_lo, x));
      mx_hi = fmaxf(mx_hi, __shfl_xor_sync(0xffffffffu, mx_hi, x));
    }
    const float mn_lo = fmaxf(m_lo, mx_lo), mn_hi = fmaxf(m_hi, mx_hi);
    const float alpha_lo = expf(m_lo - mn_lo), alpha_hi = expf(m_hi - mn_hi);
    m_lo = mn_lo;
    m_hi = mn_hi;

    // p = exp(s - m_new) rounded to bf16 as the A fragments of P V over the
    // keys; l adds the rounded values
    uint32_t pa[kKeys / 16][4];
    float sum_lo = 0.f, sum_hi = 0.f;
#pragma unroll
    for (int n = 0; n < kKeys / 8; ++n) {
      const uint32_t lo = tiles::pack_bf16(expf(s[n][0] - mn_lo), expf(s[n][1] - mn_lo));
      const uint32_t hi = tiles::pack_bf16(expf(s[n][2] - mn_hi), expf(s[n][3] - mn_hi));
      pa[n / 2][(n % 2) * 2] = lo;
      pa[n / 2][(n % 2) * 2 + 1] = hi;
      const float2 flo = unpack_bf16(lo), fhi = unpack_bf16(hi);
      sum_lo += flo.x + flo.y;
      sum_hi += fhi.x + fhi.y;
    }
#pragma unroll
    for (int x = 1; x <= 2; x *= 2) {
      sum_lo += __shfl_xor_sync(0xffffffffu, sum_lo, x);
      sum_hi += __shfl_xor_sync(0xffffffffu, sum_hi, x);
    }
    l_lo = l_lo * alpha_lo + sum_lo;
    l_hi = l_hi * alpha_hi + sum_hi;

    // acc = acc * alpha + P V, V [key][d] read as B (k rows of n)
#pragma unroll
    for (int n = 0; n < kNt; ++n) {
      acc[n][0] *= alpha_lo;
      acc[n][1] *= alpha_lo;
      acc[n][2] *= alpha_hi;
      acc[n][3] *= alpha_hi;
    }
#pragma unroll
    for (int j = 0; j < kKeys / 16; ++j)
#pragma unroll
      for (int np = 0; np < HD / 16; ++np) {
        uint32_t bv[4];
        tiles::ldsm_b_trans(bv, vs, kLd, j * 16, np * 16, lane);
        tiles::mma_bf16(acc[2 * np], pa[j], bv[0], bv[1]);
        tiles::mma_bf16(acc[2 * np + 1], pa[j], bv[2], bv[3]);
      }
    __syncthreads();  // stage t % 2 is free for tile t + 2
  }

  // o = acc / l, staged in q's place (q lives in registers since tile 0),
  // then written with 16-byte stores
  const float inv_lo = 1.f / l_lo, inv_hi = 1.f / l_hi;
  const int row = warp * 16 + gr;
#pragma unroll
  for (int n = 0; n < kNt; ++n) {
    const int d = n * 8 + 2 * tg;
    *reinterpret_cast<uint32_t*>(qs + row * kLd + d) =
        tiles::pack_bf16(acc[n][0] * inv_lo, acc[n][1] * inv_lo);
    *reinterpret_cast<uint32_t*>(qs + (row + 8) * kLd + d) =
        tiles::pack_bf16(acc[n][2] * inv_hi, acc[n][3] * inv_hi);
  }
  if (lse != nullptr && tg == 0) {
    lse[head * Sp + q0 + row] = m_lo + logf(l_lo);
    lse[head * Sp + q0 + row + 8] = m_hi + logf(l_hi);
  }
  __syncthreads();
  bf16* og = o + (head * Sp + q0) * HD;
  for (int i = tid; i < kRows * HD / 8; i += kTcThreads) {
    const int r = i / (HD / 8), c = i % (HD / 8);
    *reinterpret_cast<uint4*>(og + (long long)i * 8) =
        *reinterpret_cast<const uint4*>(qs + r * kLd + c * 8);
  }
}

// ---------------------------------------------------------------- launches

struct Args {
  const void *q, *kt, *v;
  void* o;
  float* lse;
  int B, H, Hkv, Sp, valid_len;
  float scale;
  cudaStream_t stream;
};

template <int HD>
int launch_f32(const Args& a) {
  constexpr size_t bytes = smem_floats<HD>() * sizeof(float);
  // The shared-memory limit is an attribute of the current device's context,
  // so it is raised on every launch (a cheap call), never cached per process.
  const cudaError_t err = cudaFuncSetAttribute(
      attention_hm_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)bytes);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(a.Sp / kRows, a.H, a.B);
  attention_hm_kernel<HD><<<grid, kThreads, bytes, a.stream>>>(
      static_cast<const float*>(a.q), static_cast<const float*>(a.kt),
      static_cast<const float*>(a.v), static_cast<float*>(a.o), a.lse, a.H,
      a.Hkv, a.Sp, a.valid_len, a.scale);
  return (int)cudaGetLastError();
}

template <int HD>
int launch_tc(const Args& a) {
  // the tensor-core kernel copies and stores 16 bytes at a time
  const void* ptrs[] = {a.q, a.kt, a.v, a.o};
  for (const void* p : ptrs)
    if (reinterpret_cast<uintptr_t>(p) % 16) return (int)cudaErrorMisalignedAddress;
  constexpr size_t bytes = tc_smem_bytes<HD>();
  const cudaError_t err = cudaFuncSetAttribute(
      attention_hm_tc_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)bytes);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(a.Sp / kRows, a.H, a.B);
  attention_hm_tc_kernel<HD><<<grid, kTcThreads, bytes, a.stream>>>(
      static_cast<const bf16*>(a.q), static_cast<const bf16*>(a.kt),
      static_cast<const bf16*>(a.v), static_cast<bf16*>(a.o), a.lse, a.H,
      a.Hkv, a.Sp, a.valid_len, a.scale);
  return (int)cudaGetLastError();
}

}  // namespace

// q: [B, H, Sp, hd]; kt: [B, Hkv, hd, Sp]; v: [B, Hkv, Sp, hd]; o: [B, H, Sp,
// hd]; all contiguous, of one type: float32 (is_bf16 = 0, the FMA kernel) or
// bfloat16 (is_bf16 = 1, the tensor-core kernel, which needs q, kt, v and o
// 16-byte aligned). lse: NULL, or float32 [B, H, Sp] for the rows'
// log-sum-exp. Sp must be a multiple of 64, hd 64 or 128, H a multiple of
// Hkv; scale multiplies the float32 scores (hd^-0.5). Returns the
// cudaGetLastError() code of the launch.
extern "C" int ws_attention_hm(const void* q, const void* kt, const void* v,
                               void* o, float* lse, int B, int H, int Hkv,
                               int Sp, int hd, int valid_len, float scale,
                               int is_bf16, cudaStream_t stream) {
  if (B <= 0 || H <= 0 || Hkv <= 0 || H % Hkv != 0 || Sp <= 0 ||
      Sp % kRows != 0)
    return (int)cudaErrorInvalidValue;
  const Args a{q, kt, v, o, lse, B, H, Hkv, Sp, valid_len, scale, stream};
  if (hd == 64) return is_bf16 ? launch_tc<64>(a) : launch_f32<64>(a);
  if (hd == 128) return is_bf16 ? launch_tc<128>(a) : launch_f32<128>(a);
  return (int)cudaErrorInvalidValue;
}
