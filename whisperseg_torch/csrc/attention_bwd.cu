// Backward of the non-causal head-major encoder attention (attention.cu):
// the dK/dV kernel and the dQ kernel.
//
// Replaces the two backward kernels of JAX's stock Pallas flash attention
// (jax/experimental/pallas/ops/tpu/flash_attention.py:
// _flash_attention_bwd_dkv, pallas_call at :1121, and
// _flash_attention_bwd_dq, pallas_call at :1456), which the JAX package
// reaches from whisperseg_tpu/ops/attention.py::self_attention through
// _flash when the encoder is trained. As in that kernel's custom VJP,
// D = rowsum(o * dO) is computed outside the kernels, and the probabilities
// are rebuilt from the forward's saved row statistics (here the row
// log-sum-exp that attention.cu writes).
//
// Function, per batch item b and query head h (K/V head h / g, g = H / Hkv),
// scale = hd^-0.5, keys at or beyond valid_len masked:
//   S  = q k^T * scale            P  = exp(S - lse)   (0 at masked keys)
//   dP = dO v^T                   dS = P * (dP - D) * scale
//   dV = sum over the g heads of P^T dO
//   dK = sum over the g heads of dS^T q
//   dQ = dS k
// All sums in float32, in a fixed order and without atomics, so two runs give
// identical gradients. Outputs are written in the input type: dK in K's
// transposed layout [B, Hkv, hd, Sp], dV [B, Hkv, Sp, hd], dQ [B, H, Sp, hd].
//
// Bound on an H100: at the training path's shape (base model: B 4, H 8,
// Sp 512, 500 valid keys, hd 64, bf16) the dK/dV kernel does 4 products of
// 2 B H Sp valid hd = 1.05 GFLOP, the dQ kernel 3, which on the tensor cores
// (989 TFLOP/s) take 4.2 and 3.2 us, about as long as their bytes take at
// 3.35 TB/s (12.7 and 10.6 MB: 3.8 and 3.2 us).
//
// bfloat16 (the training path): the products run on the tensor cores
// (mma.sync m16n8k16, float32 accumulators, mma_tiles.cuh), as in
// FlashAttention-2's backward. Like the stock kernel, P is rounded to bf16
// before dV = P^T dO, and dS (scale folded in) before dK = dS^T q and
// dQ = dS k; each is rounded from its float32 accumulator fragment and
// repacked in registers as the A operand of the next product, never stored.
// Tiles stay bf16 in shared memory, rows padded by 16 bytes so that ldmatrix
// reads them without bank conflicts, and arrive by 16-byte cp.async copies,
// double-buffered so the next tile loads while this one computes.
//   * dK/dV: one block of 4 warps per (64-key tile, kv head, batch); each
//     warp owns 16 keys. K^T and V of the tile stay in shared memory; the
//     block walks the group's g query heads and every query tile of R rows
//     (64 at hd 64, 32 at hd 128, where dK and dV take 128 accumulator
//     registers a thread) and streams q, dO, lse and D. Per tile a warp
//     computes S^T = K q^T and dP^T = V dO^T, then dV += P^T dO and
//     dK += dS^T q. A key tile wholly at or beyond valid_len writes zeros
//     and returns. 55 KB of shared memory at hd 64, 70 KB at hd 128.
//   * dQ: one block of 4 warps per (64-row query tile, head, batch); each
//     warp owns 16 rows. q and dO stay in shared memory; the block walks
//     the key tiles below valid_len, streaming K^T and V, and computes
//     S = q K^T and dP = dO V^T, then dQ += dS K. 54 KB at hd 64, 104 KB at
//     hd 128.
// Masked keys get P = 0 by a select, so dK = dV = 0 exactly at padded keys
// whatever their K and V hold.
//
// float32 (compute_dtype float32 and the finite-difference checks): the
// first design, float32 FMAs on the CUDA cores, bound by the FMA rate and
// shared-memory reads. dK/dV: one block per (64-key tile, kv head,
// batch), K^T and V^T in shared memory, the g heads and all 64-row query
// tiles walked, dV and dK accumulated in registers (each thread 4 keys x
// hd/16 columns of each). dQ: one block per (64-row query tile, head,
// batch) over the key tiles below valid_len. Shared-memory layouts are
// chosen so that every inner loop reads either a broadcast or 16
// consecutive words per half warp: K^T as given, V transposed with rows
// padded to 65 in the dK/dV kernel; K and V row-major with rows padded to
// hd + 1 in the dQ kernel; q and dO rows padded to hd + 4. At hd 64 each
// kernel uses 86 KB of shared memory (152 KB at hd 128).
//
// The shared-memory limit is raised on every launch: it is an attribute of
// the current device's context.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "mma_tiles.cuh"

namespace {

constexpr int kRows = 64;  // query rows per tile
constexpr int kKeys = 64;  // keys per tile
constexpr int kThreads = 256;
constexpr int kPLd = kKeys + 4;  // row stride of the P / dS tile

__device__ __forceinline__ float to_float(float x) { return x; }
template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) { return x; }

template <int HD>
constexpr int dkv_smem_floats() {
  return HD * kKeys            // K^T tile [HD][64]
         + HD * (kKeys + 1)    // V^T tile [HD][65]
         + 2 * kRows * (HD + 4)  // q and dO tiles [64][HD + 4]
         + kRows * kPLd        // P, then dS [64 rows][64 keys]
         + 2 * kRows;          // lse, D
}

template <int HD>
constexpr int dq_smem_floats() {
  return 2 * kRows * (HD + 4)   // q and dO tiles [64][HD + 4]
         + 2 * kKeys * (HD + 1)  // K and V tiles [64][HD + 1]
         + kRows * kPLd         // dS [64 rows][64 keys]
         + 2 * kRows;           // lse, D
}

// Loads a [64][HD] row tile of a [.., Sp, HD] tensor into shared memory with
// rows of stride HD + 4.
template <typename T, int HD>
__device__ __forceinline__ void load_rows(float* dst, const T* src, int tid) {
  for (int i = tid; i < kRows * HD; i += kThreads)
    dst[(i / HD) * (HD + 4) + i % HD] = to_float(src[i]);
}

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads)
attention_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ kt,
                         const T* __restrict__ v, const T* __restrict__ dout,
                         const float* __restrict__ lse,
                         const float* __restrict__ delta, T* __restrict__ dkt,
                         T* __restrict__ dv, int H, int Hkv, int Sp,
                         int valid_len, float scale) {
  constexpr int kLd = HD + 4;
  constexpr int kVLd = kKeys + 1;
  constexpr int kCols = HD / 16;  // accumulator columns per thread
  extern __shared__ float smem[];
  float* ks = smem;                 // K^T: [d][key]
  float* vts = ks + HD * kKeys;     // V^T: [c][key], stride 65
  float* qs = vts + HD * kVLd;      // q: [row][d]
  float* dos = qs + kRows * kLd;    // dO: [row][c]
  float* ps = dos + kRows * kLd;    // P, then dS: [row][key]
  float* lse_s = ps + kRows * kPLd;
  float* d_s = lse_s + kRows;

  const int k0 = blockIdx.x * kKeys;
  const int hk = blockIdx.y;
  const int b = blockIdx.z;
  const int g = H / Hkv;
  const int tid = threadIdx.x;
  const int ty = tid / 16;  // keys ty*4 .. ty*4+3 of the accumulators
  const int tx = tid % 16;  // columns tx + 16*c; keys tx + 16*j of S^T

  T* dktg = dkt + (long long)(b * Hkv + hk) * HD * Sp;
  T* dvg = dv + ((long long)(b * Hkv + hk) * Sp + k0) * HD;
  if (k0 >= valid_len) {  // every key of the tile is masked
    for (int i = tid; i < HD * kKeys; i += kThreads) {
      dktg[(long long)(i / kKeys) * Sp + k0 + i % kKeys] = from_float<T>(0.f);
      dvg[i] = from_float<T>(0.f);
    }
    return;
  }

  const T* ktg = kt + (long long)(b * Hkv + hk) * HD * Sp;
  const T* vg = v + ((long long)(b * Hkv + hk) * Sp + k0) * HD;
  for (int i = tid; i < HD * kKeys; i += kThreads) {
    const int d = i / kKeys, c = i % kKeys;
    ks[i] = to_float(ktg[(long long)d * Sp + k0 + c]);
  }
  for (int i = tid; i < kKeys * HD; i += kThreads)
    vts[(i % HD) * kVLd + i / HD] = to_float(vg[i]);

  bool live[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) live[j] = k0 + tx + 16 * j < valid_len;

  float dk[4][kCols], dva[4][kCols];
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int c = 0; c < kCols; ++c) dk[r][c] = dva[r][c] = 0.f;

  for (int gi = 0; gi < g; ++gi) {
    const long long head = (long long)b * H + hk * g + gi;
    for (int r0 = 0; r0 < Sp; r0 += kRows) {
      __syncthreads();  // the previous tile's readers are done
      load_rows<T, HD>(qs, q + (head * Sp + r0) * HD, tid);
      load_rows<T, HD>(dos, dout + (head * Sp + r0) * HD, tid);
      if (tid < kRows) {
        lse_s[tid] = lse[head * Sp + r0 + tid];
        d_s[tid] = delta[head * Sp + r0 + tid];
      }
      __syncthreads();

      // S^T and dP^T for rows ty*4+r, keys tx+16*j
      float s[4][4], dp[4][4];
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[r][j] = dp[r][j] = 0.f;
#pragma unroll 8
      for (int d = 0; d < HD; ++d) {
        float qv[4], dov[4], kv[4], vv[4];
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          qv[r] = qs[(ty * 4 + r) * kLd + d];
          dov[r] = dos[(ty * 4 + r) * kLd + d];
        }
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          kv[j] = ks[d * kKeys + tx + 16 * j];
          vv[j] = vts[d * kVLd + tx + 16 * j];
        }
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            s[r][j] = fmaf(qv[r], kv[j], s[r][j]);
            dp[r][j] = fmaf(dov[r], vv[j], dp[r][j]);
          }
      }
      float p[4][4];
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          p[r][j] = live[j] ? expf(s[r][j] * scale - lse_s[ty * 4 + r]) : 0.f;
          ps[(ty * 4 + r) * kPLd + tx + 16 * j] = p[r][j];
        }
      __syncthreads();

      // dV += P^T dO for keys ty*4+r, columns tx+16*c
#pragma unroll 4
      for (int row = 0; row < kRows; ++row) {
        float pv[4], dov[kCols];
#pragma unroll
        for (int r = 0; r < 4; ++r) pv[r] = ps[row * kPLd + ty * 4 + r];
#pragma unroll
        for (int c = 0; c < kCols; ++c) dov[c] = dos[row * kLd + tx + 16 * c];
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int c = 0; c < kCols; ++c) dva[r][c] = fmaf(pv[r], dov[c], dva[r][c]);
      }
      __syncthreads();  // P is read; overwrite it with dS

#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          ps[(ty * 4 + r) * kPLd + tx + 16 * j] =
              p[r][j] * (dp[r][j] - d_s[ty * 4 + r]);
      __syncthreads();

      // dK += dS^T q for keys ty*4+r, columns tx+16*c
#pragma unroll 4
      for (int row = 0; row < kRows; ++row) {
        float dsv[4], qv[kCols];
#pragma unroll
        for (int r = 0; r < 4; ++r) dsv[r] = ps[row * kPLd + ty * 4 + r];
#pragma unroll
        for (int c = 0; c < kCols; ++c) qv[c] = qs[row * kLd + tx + 16 * c];
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int c = 0; c < kCols; ++c) dk[r][c] = fmaf(dsv[r], qv[c], dk[r][c]);
      }
    }
  }

#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int c = 0; c < kCols; ++c)
      dvg[(ty * 4 + r) * HD + tx + 16 * c] = from_float<T>(dva[r][c]);

  // dK goes out transposed: stage it as [d][key] (stride 65) so that the
  // global writes run along keys.
  __syncthreads();
  float* stage = qs;  // HD * 65 floats fit in the q and dO tiles
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int c = 0; c < kCols; ++c)
      stage[(tx + 16 * c) * kVLd + ty * 4 + r] = dk[r][c] * scale;
  __syncthreads();
  for (int i = tid; i < HD * kKeys; i += kThreads) {
    const int d = i / kKeys, key = i % kKeys;
    dktg[(long long)d * Sp + k0 + key] = from_float<T>(stage[d * kVLd + key]);
  }
}

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads)
attention_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ kt,
                        const T* __restrict__ v, const T* __restrict__ dout,
                        const float* __restrict__ lse,
                        const float* __restrict__ delta, T* __restrict__ dq,
                        int H, int Hkv, int Sp, int valid_len, float scale) {
  constexpr int kLd = HD + 4;
  constexpr int kKLd = HD + 1;
  constexpr int kCols = HD / 16;
  extern __shared__ float smem[];
  float* qs = smem;                 // q: [row][d]
  float* dos = qs + kRows * kLd;    // dO: [row][c]
  float* krs = dos + kRows * kLd;   // K: [key][d], stride HD + 1
  float* vrs = krs + kKeys * kKLd;  // V: [key][c], stride HD + 1
  float* dss = vrs + kKeys * kKLd;  // dS: [row][key]
  float* lse_s = dss + kRows * kPLd;
  float* d_s = lse_s + kRows;

  const int q0 = blockIdx.x * kRows;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / (H / Hkv);
  const int tid = threadIdx.x;
  const int ty = tid / 16;  // rows ty*4 .. ty*4+3
  const int tx = tid % 16;  // keys tx + 16*j; columns tx + 16*c
  const long long head = (long long)b * H + h;

  load_rows<T, HD>(qs, q + (head * Sp + q0) * HD, tid);
  load_rows<T, HD>(dos, dout + (head * Sp + q0) * HD, tid);
  if (tid < kRows) {
    lse_s[tid] = lse[head * Sp + q0 + tid];
    d_s[tid] = delta[head * Sp + q0 + tid];
  }

  float acc[4][kCols];
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int c = 0; c < kCols; ++c) acc[r][c] = 0.f;

  const T* ktg = kt + (long long)(b * Hkv + hk) * HD * Sp;
  const T* vg = v + (long long)(b * Hkv + hk) * Sp * HD;
  const int n_tiles = (min(valid_len, Sp) + kKeys - 1) / kKeys;
  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = t * kKeys;
    __syncthreads();  // the previous tile's readers are done
    for (int i = tid; i < HD * kKeys; i += kThreads) {
      const int d = i / kKeys, key = i % kKeys;
      krs[key * kKLd + d] = to_float(ktg[(long long)d * Sp + k0 + key]);
    }
    for (int i = tid; i < kKeys * HD; i += kThreads)
      vrs[(i / HD) * kKLd + i % HD] = to_float(vg[(long long)k0 * HD + i]);
    __syncthreads();

    float s[4][4], dp[4][4];
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[r][j] = dp[r][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < HD; ++d) {
      float qv[4], dov[4], kv[4], vv[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        qv[r] = qs[(ty * 4 + r) * kLd + d];
        dov[r] = dos[(ty * 4 + r) * kLd + d];
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        kv[j] = krs[(tx + 16 * j) * kKLd + d];
        vv[j] = vrs[(tx + 16 * j) * kKLd + d];
      }
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          s[r][j] = fmaf(qv[r], kv[j], s[r][j]);
          dp[r][j] = fmaf(dov[r], vv[j], dp[r][j]);
        }
    }
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int row = ty * 4 + r;
        const float p = k0 + tx + 16 * j < valid_len
                            ? expf(s[r][j] * scale - lse_s[row])
                            : 0.f;
        dss[row * kPLd + tx + 16 * j] = p * (dp[r][j] - d_s[row]);
      }
    __syncthreads();

    // dQ += dS k for rows ty*4+r, columns tx+16*c
#pragma unroll 4
    for (int key = 0; key < kKeys; ++key) {
      float dsv[4], kv[kCols];
#pragma unroll
      for (int r = 0; r < 4; ++r) dsv[r] = dss[(ty * 4 + r) * kPLd + key];
#pragma unroll
      for (int c = 0; c < kCols; ++c) kv[c] = krs[key * kKLd + tx + 16 * c];
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < kCols; ++c) acc[r][c] = fmaf(dsv[r], kv[c], acc[r][c]);
    }
  }

  T* dqg = dq + (head * Sp + q0) * HD;
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int c = 0; c < kCols; ++c)
      dqg[(ty * 4 + r) * HD + tx + 16 * c] = from_float<T>(acc[r][c] * scale);
}

// ------------------------------------------------ bf16, on the tensor cores

using bf16 = __nv_bfloat16;
using tiles::cp_async_16;

constexpr int kTcThreads = 128;  // 4 warps, 16 keys (dK/dV) or rows (dQ) each
constexpr int kPad = 8;          // bf16 of padding at the end of a tile row
constexpr int kKtLd = kKeys + kPad;  // row stride of a K^T tile [hd][64 keys]

// Query rows per streamed tile of the dK/dV kernel.
template <int HD>
__host__ __device__ constexpr int dkv_tc_rows() { return HD == 64 ? 64 : 32; }

template <int HD>
constexpr int dkv_tc_smem_bytes() {
  constexpr int ld = HD + kPad, rows = dkv_tc_rows<HD>();
  return 2 * (HD * kKtLd + kKeys * ld + 2 * 2 * rows * ld)  // K^T, V, 2 x (q, dO)
         + 4 * 2 * 2 * rows;                                 // 2 x (lse, D)
}

template <int HD>
constexpr int dq_tc_smem_bytes() {
  constexpr int ld = HD + kPad;
  return 2 * (2 * kRows * ld + 2 * (HD * kKtLd + kKeys * ld));  // q, dO, 2 x (K^T, V)
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

template <int HD>
__global__ void __launch_bounds__(kTcThreads)
attention_bwd_dkv_tc_kernel(const bf16* __restrict__ q, const bf16* __restrict__ kt,
                            const bf16* __restrict__ v, const bf16* __restrict__ dout,
                            const float* __restrict__ lse,
                            const float* __restrict__ delta, bf16* __restrict__ dkt,
                            bf16* __restrict__ dv, int H, int Hkv, int Sp,
                            int valid_len, float scale) {
  constexpr int R = dkv_tc_rows<HD>();
  constexpr int kLd = HD + kPad;
  constexpr int kStage = 2 * R * kLd;  // bf16 of one stage: q, then dO
  constexpr int kNt = HD / 8;          // n tiles of 8 columns of dK, dV
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* kts = reinterpret_cast<bf16*>(smem_raw);  // K^T: [d][key]
  bf16* vs = kts + HD * kKtLd;                     // V: [key][d]
  bf16* stages = vs + kKeys * kLd;                 // 2 x (q, dO): [row][d]
  float* stats = reinterpret_cast<float*>(stages + 2 * kStage);  // 2 x (lse, D)

  const int k0 = blockIdx.x * kKeys;
  const int hk = blockIdx.y;
  const int b = blockIdx.z;
  const int g = H / Hkv;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int gr = lane / 4, tg = lane % 4;
  const long long kvh = (long long)b * Hkv + hk;
  bf16* dktg = dkt + kvh * HD * Sp + k0;
  bf16* dvg = dv + (kvh * Sp + k0) * HD;
  if (k0 >= valid_len) {  // every key of the tile is masked
    const uint4 zero = make_uint4(0, 0, 0, 0);
    for (int i = tid; i < HD * 8; i += kTcThreads) {
      *reinterpret_cast<uint4*>(dktg + (long long)(i / 8) * Sp + (i % 8) * 8) = zero;
      *reinterpret_cast<uint4*>(dvg + (long long)i * 8) = zero;
    }
    return;
  }

  copy_kt<HD>(kts, kt + kvh * HD * Sp, Sp, k0, tid);
  copy_rows<HD>(vs, v + (kvh * Sp + k0) * HD, kKeys, tid);
  const int per_head = Sp / R;
  const int n_tiles = g * per_head;
  auto load_tile = [&](int t) {  // q, dO, lse, D of tile t into stage t % 2
    const long long row0 = ((long long)b * H + hk * g + t / per_head) * Sp
                           + (t % per_head) * R;
    bf16* qs = stages + (t % 2) * kStage;
    copy_rows<HD>(qs, q + row0 * HD, R, tid);
    copy_rows<HD>(qs + R * kLd, dout + row0 * HD, R, tid);
    float* st = stats + (t % 2) * 2 * R;
    if (tid < R / 4) cp_async_16(st + 4 * tid, lse + row0 + 4 * tid);
    else if (tid < R / 2)
      cp_async_16(st + R + 4 * (tid - R / 4), delta + row0 + 4 * (tid - R / 4));
  };
  load_tile(0);
  tiles::cp_async_commit();

  // this thread's keys in the accumulator fragments: key_lo and key_lo + 8
  const int key_lo = k0 + warp * 16 + gr;
  const bool live_lo = key_lo < valid_len, live_hi = key_lo + 8 < valid_len;
  float dva[kNt][4], dka[kNt][4];
#pragma unroll
  for (int n = 0; n < kNt; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dva[n][e] = dka[n][e] = 0.f;

  for (int t = 0; t < n_tiles; ++t) {
    if (t + 1 < n_tiles) {
      load_tile(t + 1);
      tiles::cp_async_commit();
      tiles::cp_async_wait<1>();
    } else {
      tiles::cp_async_wait<0>();
    }
    __syncthreads();
    const bf16* qs = stages + (t % 2) * kStage;
    const bf16* dos = qs + R * kLd;
    const float* lse_s = stats + (t % 2) * 2 * R;
    const float* d_s = lse_s + R;

    // S^T = K q^T and dP^T = V dO^T: this warp's 16 keys x R rows
    float s[R / 8][4], dp[R / 8][4];
#pragma unroll
    for (int n = 0; n < R / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = dp[n][e] = 0.f;
#pragma unroll
    for (int ks = 0; ks < HD / 16; ++ks) {
      uint32_t ak[4], av[4];
      tiles::ldsm_a_trans(ak, kts, kKtLd, ks * 16, warp * 16, lane);
      tiles::ldsm_a(av, vs, kLd, warp * 16, ks * 16, lane);
#pragma unroll
      for (int j = 0; j < R / 16; ++j) {
        uint32_t bq[4], bd[4];
        tiles::ldsm_b(bq, qs, kLd, j * 16, ks * 16, lane);
        tiles::ldsm_b(bd, dos, kLd, j * 16, ks * 16, lane);
        tiles::mma_bf16(s[2 * j], ak, bq[0], bq[1]);
        tiles::mma_bf16(s[2 * j + 1], ak, bq[2], bq[3]);
        tiles::mma_bf16(dp[2 * j], av, bd[0], bd[1]);
        tiles::mma_bf16(dp[2 * j + 1], av, bd[2], bd[3]);
      }
    }

    // P^T and dS^T, rounded to bf16 as A fragments over the rows
    uint32_t pa[R / 16][4], dsa[R / 16][4];
#pragma unroll
    for (int n = 0; n < R / 8; ++n) {
      const int row = n * 8 + 2 * tg;
      const float l0 = lse_s[row], l1 = lse_s[row + 1];
      const float d0 = d_s[row], d1 = d_s[row + 1];
      const float p0 = live_lo ? __expf(s[n][0] * scale - l0) : 0.f;
      const float p1 = live_lo ? __expf(s[n][1] * scale - l1) : 0.f;
      const float p2 = live_hi ? __expf(s[n][2] * scale - l0) : 0.f;
      const float p3 = live_hi ? __expf(s[n][3] * scale - l1) : 0.f;
      pa[n / 2][(n % 2) * 2] = tiles::pack_bf16(p0, p1);
      pa[n / 2][(n % 2) * 2 + 1] = tiles::pack_bf16(p2, p3);
      dsa[n / 2][(n % 2) * 2] = tiles::pack_bf16(p0 * (dp[n][0] - d0) * scale,
                                                 p1 * (dp[n][1] - d1) * scale);
      dsa[n / 2][(n % 2) * 2 + 1] = tiles::pack_bf16(p2 * (dp[n][2] - d0) * scale,
                                                     p3 * (dp[n][3] - d1) * scale);
    }

    // dV += P^T dO and dK += dS^T q
#pragma unroll
    for (int j = 0; j < R / 16; ++j)
#pragma unroll
      for (int np = 0; np < HD / 16; ++np) {
        uint32_t bd[4], bq[4];
        tiles::ldsm_b_trans(bd, dos, kLd, j * 16, np * 16, lane);
        tiles::ldsm_b_trans(bq, qs, kLd, j * 16, np * 16, lane);
        tiles::mma_bf16(dva[2 * np], pa[j], bd[0], bd[1]);
        tiles::mma_bf16(dva[2 * np + 1], pa[j], bd[2], bd[3]);
        tiles::mma_bf16(dka[2 * np], dsa[j], bq[0], bq[1]);
        tiles::mma_bf16(dka[2 * np + 1], dsa[j], bq[2], bq[3]);
      }
    __syncthreads();  // stage t % 2 is free for tile t + 2
  }

  // Stage dV as [key][d] in V's place and dK^T as [d][key] in K^T's, then
  // write both with 16-byte stores.
  const int key = warp * 16 + gr;
#pragma unroll
  for (int n = 0; n < kNt; ++n) {
    const int d = n * 8 + 2 * tg;
    *reinterpret_cast<uint32_t*>(vs + key * kLd + d) =
        tiles::pack_bf16(dva[n][0], dva[n][1]);
    *reinterpret_cast<uint32_t*>(vs + (key + 8) * kLd + d) =
        tiles::pack_bf16(dva[n][2], dva[n][3]);
    kts[d * kKtLd + key] = __float2bfloat16_rn(dka[n][0]);
    kts[(d + 1) * kKtLd + key] = __float2bfloat16_rn(dka[n][1]);
    kts[d * kKtLd + key + 8] = __float2bfloat16_rn(dka[n][2]);
    kts[(d + 1) * kKtLd + key + 8] = __float2bfloat16_rn(dka[n][3]);
  }
  __syncthreads();
  for (int i = tid; i < kKeys * HD / 8; i += kTcThreads) {
    const int r = i / (HD / 8), c = i % (HD / 8);
    *reinterpret_cast<uint4*>(dvg + (long long)i * 8) =
        *reinterpret_cast<const uint4*>(vs + r * kLd + c * 8);
  }
  for (int i = tid; i < HD * 8; i += kTcThreads)
    *reinterpret_cast<uint4*>(dktg + (long long)(i / 8) * Sp + (i % 8) * 8) =
        *reinterpret_cast<const uint4*>(kts + (i / 8) * kKtLd + (i % 8) * 8);
}

template <int HD>
__global__ void __launch_bounds__(kTcThreads)
attention_bwd_dq_tc_kernel(const bf16* __restrict__ q, const bf16* __restrict__ kt,
                           const bf16* __restrict__ v, const bf16* __restrict__ dout,
                           const float* __restrict__ lse,
                           const float* __restrict__ delta, bf16* __restrict__ dq,
                           int H, int Hkv, int Sp, int valid_len, float scale) {
  constexpr int kLd = HD + kPad;
  constexpr int kStage = HD * kKtLd + kKeys * kLd;  // bf16 of one stage: K^T, V
  constexpr int kNt = HD / 8;                        // n tiles of dQ
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* qs = reinterpret_cast<bf16*>(smem_raw);  // q: [row][d]
  bf16* dos = qs + kRows * kLd;                   // dO: [row][d]
  bf16* stages = dos + kRows * kLd;               // 2 x (K^T [d][key], V [key][d])

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
  copy_rows<HD>(dos, dout + (head * Sp + q0) * HD, kRows, tid);
  auto load_tile = [&](int t) {  // K^T and V of key tile t into stage t % 2
    bf16* st = stages + (t % 2) * kStage;
    copy_kt<HD>(st, ktg, Sp, t * kKeys, tid);
    copy_rows<HD>(st + HD * kKtLd, vg + (long long)t * kKeys * HD, kKeys, tid);
  };
  load_tile(0);
  tiles::cp_async_commit();

  // this thread's rows in the fragments: row_lo and row_lo + 8
  const long long row_lo = head * Sp + q0 + warp * 16 + gr;
  const float l_lo = lse[row_lo], l_hi = lse[row_lo + 8];
  const float d_lo = delta[row_lo], d_hi = delta[row_lo + 8];
  float acc[kNt][4];
#pragma unroll
  for (int n = 0; n < kNt; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;

  const int n_tiles = (min(valid_len, Sp) + kKeys - 1) / kKeys;
  for (int t = 0; t < n_tiles; ++t) {
    if (t + 1 < n_tiles) {
      load_tile(t + 1);
      tiles::cp_async_commit();
      tiles::cp_async_wait<1>();
    } else {
      tiles::cp_async_wait<0>();
    }
    __syncthreads();
    const bf16* kts = stages + (t % 2) * kStage;
    const bf16* vs = kts + HD * kKtLd;

    // S = q K^T and dP = dO V^T: this warp's 16 rows x 64 keys
    float s[kKeys / 8][4], dp[kKeys / 8][4];
#pragma unroll
    for (int n = 0; n < kKeys / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = dp[n][e] = 0.f;
#pragma unroll
    for (int ks = 0; ks < HD / 16; ++ks) {
      uint32_t aq[4], ad[4];
      tiles::ldsm_a(aq, qs, kLd, warp * 16, ks * 16, lane);
      tiles::ldsm_a(ad, dos, kLd, warp * 16, ks * 16, lane);
#pragma unroll
      for (int j = 0; j < kKeys / 16; ++j) {
        uint32_t bk[4], bv[4];
        tiles::ldsm_b_trans(bk, kts, kKtLd, ks * 16, j * 16, lane);
        tiles::ldsm_b(bv, vs, kLd, j * 16, ks * 16, lane);
        tiles::mma_bf16(s[2 * j], aq, bk[0], bk[1]);
        tiles::mma_bf16(s[2 * j + 1], aq, bk[2], bk[3]);
        tiles::mma_bf16(dp[2 * j], ad, bv[0], bv[1]);
        tiles::mma_bf16(dp[2 * j + 1], ad, bv[2], bv[3]);
      }
    }

    // dS, rounded to bf16 as A fragments over the keys
    uint32_t dsa[kKeys / 16][4];
#pragma unroll
    for (int n = 0; n < kKeys / 8; ++n) {
      const int key = t * kKeys + n * 8 + 2 * tg;
      const bool live0 = key < valid_len, live1 = key + 1 < valid_len;
      const float p0 = live0 ? __expf(s[n][0] * scale - l_lo) : 0.f;
      const float p1 = live1 ? __expf(s[n][1] * scale - l_lo) : 0.f;
      const float p2 = live0 ? __expf(s[n][2] * scale - l_hi) : 0.f;
      const float p3 = live1 ? __expf(s[n][3] * scale - l_hi) : 0.f;
      dsa[n / 2][(n % 2) * 2] = tiles::pack_bf16(p0 * (dp[n][0] - d_lo) * scale,
                                                 p1 * (dp[n][1] - d_lo) * scale);
      dsa[n / 2][(n % 2) * 2 + 1] = tiles::pack_bf16(p2 * (dp[n][2] - d_hi) * scale,
                                                     p3 * (dp[n][3] - d_hi) * scale);
    }

    // dQ += dS K, K read from K^T [d][key] as B^T
#pragma unroll
    for (int j = 0; j < kKeys / 16; ++j)
#pragma unroll
      for (int np = 0; np < HD / 16; ++np) {
        uint32_t bk[4];
        tiles::ldsm_b(bk, kts, kKtLd, np * 16, j * 16, lane);
        tiles::mma_bf16(acc[2 * np], dsa[j], bk[0], bk[1]);
        tiles::mma_bf16(acc[2 * np + 1], dsa[j], bk[2], bk[3]);
      }
    __syncthreads();  // stage t % 2 is free for tile t + 2
  }

  // Stage dQ in q's place, then write it with 16-byte stores.
  const int row = warp * 16 + gr;
#pragma unroll
  for (int n = 0; n < kNt; ++n) {
    const int d = n * 8 + 2 * tg;
    *reinterpret_cast<uint32_t*>(qs + row * kLd + d) =
        tiles::pack_bf16(acc[n][0], acc[n][1]);
    *reinterpret_cast<uint32_t*>(qs + (row + 8) * kLd + d) =
        tiles::pack_bf16(acc[n][2], acc[n][3]);
  }
  __syncthreads();
  bf16* dqg = dq + (head * Sp + q0) * HD;
  for (int i = tid; i < kRows * HD / 8; i += kTcThreads) {
    const int r = i / (HD / 8), c = i % (HD / 8);
    *reinterpret_cast<uint4*>(dqg + (long long)i * 8) =
        *reinterpret_cast<const uint4*>(qs + r * kLd + c * 8);
  }
}

// ---------------------------------------------------------------- launches

struct Args {
  const void *q, *kt, *v, *dout;
  const float *lse, *delta;
  int B, H, Hkv, Sp, valid_len;
  float scale;
  cudaStream_t stream;
};

// The shared-memory limit is an attribute of the current device's context,
// so it is raised on every launch (a cheap call), never cached per process.
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

template <typename T, int HD>
int launch_dkv(const Args& a, void* dkt, void* dv) {
  constexpr size_t bytes = dkv_smem_floats<HD>() * sizeof(float);
  const cudaError_t err = allow_smem(attention_bwd_dkv_kernel<T, HD>, bytes);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(a.Sp / kKeys, a.Hkv, a.B);
  attention_bwd_dkv_kernel<T, HD><<<grid, kThreads, bytes, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.kt),
      static_cast<const T*>(a.v), static_cast<const T*>(a.dout), a.lse,
      a.delta, static_cast<T*>(dkt), static_cast<T*>(dv), a.H, a.Hkv, a.Sp,
      a.valid_len, a.scale);
  return (int)cudaGetLastError();
}

template <typename T, int HD>
int launch_dq(const Args& a, void* dq) {
  constexpr size_t bytes = dq_smem_floats<HD>() * sizeof(float);
  const cudaError_t err = allow_smem(attention_bwd_dq_kernel<T, HD>, bytes);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(a.Sp / kRows, a.H, a.B);
  attention_bwd_dq_kernel<T, HD><<<grid, kThreads, bytes, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.kt),
      static_cast<const T*>(a.v), static_cast<const T*>(a.dout), a.lse,
      a.delta, static_cast<T*>(dq), a.H, a.Hkv, a.Sp, a.valid_len, a.scale);
  return (int)cudaGetLastError();
}

// The tensor-core kernels copy and store 16 bytes at a time.
bool aligned16(const Args& a, const void* out0, const void* out1) {
  const void* ptrs[] = {a.q, a.kt, a.v, a.dout, a.lse, a.delta, out0, out1};
  for (const void* p : ptrs)
    if (reinterpret_cast<uintptr_t>(p) % 16) return false;
  return true;
}

template <int HD>
int launch_dkv_tc(const Args& a, void* dkt, void* dv) {
  if (!aligned16(a, dkt, dv)) return (int)cudaErrorMisalignedAddress;
  constexpr size_t bytes = dkv_tc_smem_bytes<HD>();
  const cudaError_t err = allow_smem(attention_bwd_dkv_tc_kernel<HD>, bytes);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(a.Sp / kKeys, a.Hkv, a.B);
  attention_bwd_dkv_tc_kernel<HD><<<grid, kTcThreads, bytes, a.stream>>>(
      static_cast<const bf16*>(a.q), static_cast<const bf16*>(a.kt),
      static_cast<const bf16*>(a.v), static_cast<const bf16*>(a.dout), a.lse,
      a.delta, static_cast<bf16*>(dkt), static_cast<bf16*>(dv), a.H, a.Hkv,
      a.Sp, a.valid_len, a.scale);
  return (int)cudaGetLastError();
}

template <int HD>
int launch_dq_tc(const Args& a, void* dq) {
  if (!aligned16(a, dq, dq)) return (int)cudaErrorMisalignedAddress;
  constexpr size_t bytes = dq_tc_smem_bytes<HD>();
  const cudaError_t err = allow_smem(attention_bwd_dq_tc_kernel<HD>, bytes);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(a.Sp / kRows, a.H, a.B);
  attention_bwd_dq_tc_kernel<HD><<<grid, kTcThreads, bytes, a.stream>>>(
      static_cast<const bf16*>(a.q), static_cast<const bf16*>(a.kt),
      static_cast<const bf16*>(a.v), static_cast<const bf16*>(a.dout), a.lse,
      a.delta, static_cast<bf16*>(dq), a.H, a.Hkv, a.Sp, a.valid_len, a.scale);
  return (int)cudaGetLastError();
}

bool valid_shape(int B, int H, int Hkv, int Sp, int valid_len) {
  return B > 0 && H > 0 && Hkv > 0 && H % Hkv == 0 && Sp > 0 &&
         Sp % kRows == 0 && valid_len > 0;
}

}  // namespace

// q, dout: [B, H, Sp, hd]; kt: [B, Hkv, hd, Sp]; v: [B, Hkv, Sp, hd]; lse
// (the forward's row log-sum-exp) and delta (rowsum(o * dO)): float32
// [B, H, Sp]. Outputs dkt [B, Hkv, hd, Sp] and dv [B, Hkv, Sp, hd]. All
// contiguous; q, kt, v, dout and the outputs of one type, float32
// (is_bf16 = 0, the FMA kernels) or bfloat16 (is_bf16 = 1, the tensor-core
// kernels, which need every pointer 16-byte aligned). Sp a multiple of 64,
// hd 64 or 128, H a multiple of Hkv, valid_len >= 1. Returns the
// cudaGetLastError() code of the launch.
extern "C" int ws_attention_bwd_dkv(const void* q, const void* kt,
                                    const void* v, const void* dout,
                                    const float* lse, const float* delta,
                                    void* dkt, void* dv, int B, int H, int Hkv,
                                    int Sp, int hd, int valid_len, float scale,
                                    int is_bf16, cudaStream_t stream) {
  if (!valid_shape(B, H, Hkv, Sp, valid_len)) return (int)cudaErrorInvalidValue;
  const Args a{q, kt, v, dout, lse, delta, B, H, Hkv, Sp, valid_len, scale,
               stream};
  if (hd == 64)
    return is_bf16 ? launch_dkv_tc<64>(a, dkt, dv) : launch_dkv<float, 64>(a, dkt, dv);
  if (hd == 128)
    return is_bf16 ? launch_dkv_tc<128>(a, dkt, dv)
                   : launch_dkv<float, 128>(a, dkt, dv);
  return (int)cudaErrorInvalidValue;
}

// The same inputs; output dq [B, H, Sp, hd] in the input type.
extern "C" int ws_attention_bwd_dq(const void* q, const void* kt,
                                   const void* v, const void* dout,
                                   const float* lse, const float* delta,
                                   void* dq, int B, int H, int Hkv, int Sp,
                                   int hd, int valid_len, float scale,
                                   int is_bf16, cudaStream_t stream) {
  if (!valid_shape(B, H, Hkv, Sp, valid_len)) return (int)cudaErrorInvalidValue;
  const Args a{q, kt, v, dout, lse, delta, B, H, Hkv, Sp, valid_len, scale,
               stream};
  if (hd == 64)
    return is_bf16 ? launch_dq_tc<64>(a, dq) : launch_dq<float, 64>(a, dq);
  if (hd == 128)
    return is_bf16 ? launch_dq_tc<128>(a, dq) : launch_dq<float, 128>(a, dq);
  return (int)cudaErrorInvalidValue;
}
