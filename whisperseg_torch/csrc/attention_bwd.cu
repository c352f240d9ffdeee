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
//   dP = dO v^T                   dS = P * (dP - D)
//   dV = sum over the g heads of P^T dO
//   dK = sum over the g heads of dS^T q * scale
//   dQ = dS k * scale
// All sums in float32, in a fixed order and without atomics, so two runs give
// identical gradients. Outputs are written in the input type: dK in K's
// transposed layout [B, Hkv, hd, Sp], dV [B, Hkv, Sp, hd], dQ [B, H, Sp, hd].
//
// Bound on an H100: at the training path's shape (base model: B 4, H 8,
// Sp 512, 500 valid keys, hd 64, bf16) the backward must move about 14 MB
// (q, k, v, o, dO and lse in; dq, dk, dv out) and do 5 products of
// 2 B H Sp valid hd = 0.52 GFLOP each; on the tensor cores that is about
// 4 us, set by the bytes. This first version does its products in float32
// FMAs on the CUDA cores (67 TFLOP/s peak, in practice much less), so the
// FMA issue rate and shared-memory reads bound it; mma.sync / wgmma and TMA
// are later work.
//
// Design. The TPU kernels walk a sequential grid and carry dK/dV (or dQ)
// across grid steps in VMEM scratch. Hopper blocks run in no order, so each
// output tile is owned by one block that loops over the other axis itself:
//   * dK/dV: one block per (64-key tile, kv head, batch). K and V of the
//     tile stay in shared memory; the block walks the g query heads of its
//     group and every 64-row query tile, recomputes S^T and dP^T for the
//     tile, and accumulates dV and dK in registers (each thread 4 keys x
//     hd/16 columns of each). A key tile wholly at or beyond valid_len
//     writes zeros and returns.
//   * dQ: one block per (64-row query tile, head, batch); it walks the key
//     tiles below valid_len and accumulates dQ in registers.
// Shared-memory layouts are chosen so that every inner loop reads either a
// broadcast or 16 consecutive words per half warp: K^T as given, V
// transposed with rows padded to 65 in the dK/dV kernel; K and V row-major
// with rows padded to hd + 1 in the dQ kernel; q and dO rows padded to
// hd + 4. At hd 64 each kernel uses 86 KB of shared memory (152 KB at
// hd 128), so the limit is raised on every launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kRows = 64;  // query rows per tile
constexpr int kKeys = 64;  // keys per tile
constexpr int kThreads = 256;
constexpr int kPLd = kKeys + 4;  // row stride of the P / dS tile

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

struct Args {
  const void *q, *kt, *v, *dout;
  const float *lse, *delta;
  int B, H, Hkv, Sp, valid_len;
  float scale;
  cudaStream_t stream;
};

template <typename T, int HD>
int launch_dkv(const Args& a, void* dkt, void* dv) {
  constexpr size_t bytes = dkv_smem_floats<HD>() * sizeof(float);
  // The shared-memory limit is an attribute of the current device's context,
  // so it is raised on every launch (a cheap call), never cached per process.
  const cudaError_t err = cudaFuncSetAttribute(
      attention_bwd_dkv_kernel<T, HD>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
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
  const cudaError_t err = cudaFuncSetAttribute(
      attention_bwd_dq_kernel<T, HD>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(a.Sp / kRows, a.H, a.B);
  attention_bwd_dq_kernel<T, HD><<<grid, kThreads, bytes, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.kt),
      static_cast<const T*>(a.v), static_cast<const T*>(a.dout), a.lse,
      a.delta, static_cast<T*>(dq), a.H, a.Hkv, a.Sp, a.valid_len, a.scale);
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
// (is_bf16 = 0) or bfloat16 (is_bf16 = 1). Sp a multiple of 64, hd 64 or
// 128, H a multiple of Hkv, valid_len >= 1. Returns the cudaGetLastError()
// code of the launch.
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
    return is_bf16 ? launch_dkv<__nv_bfloat16, 64>(a, dkt, dv)
                   : launch_dkv<float, 64>(a, dkt, dv);
  if (hd == 128)
    return is_bf16 ? launch_dkv<__nv_bfloat16, 128>(a, dkt, dv)
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
    return is_bf16 ? launch_dq<__nv_bfloat16, 64>(a, dq)
                   : launch_dq<float, 64>(a, dq);
  if (hd == 128)
    return is_bf16 ? launch_dq<__nv_bfloat16, 128>(a, dq)
                   : launch_dq<float, 128>(a, dq);
  return (int)cudaErrorInvalidValue;
}
