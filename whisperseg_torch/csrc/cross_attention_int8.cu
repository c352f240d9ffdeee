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
// Design. One thread-block cluster per (batch row, kv head), launched with
// cudaLaunchKernelEx; its blocks split the positions: block r takes
// positions [r * per_block, (r + 1) * per_block) below seq_len (possibly
// none). The cluster size and per_block come from
// ops/cross_attention.py::cross_attention_plan (512 blocks at the base
// model's decode step, where one block a (row, kv head) gave 128). A block
// of 4 warps:
//   1. scores: LANES threads share a position (hd / 16 of them, rounded up
//      to a power of 2), each reads 16 bytes of its K row; a thread loads 4
//      positions before it uses any. The int8 values become exact bf16 pairs
//      by byte permutes (no conversion instruction), the products are
//      rounded by packed bf16 multiplies, and the 4 positions' sums run as
//      independent chains; the lanes' sums are added by shuffles. Each K
//      piece meets every query head of the group, so a group's heads share
//      one read of K (and below, of V). V is asked for once K has landed,
//      as the scores start, so that K does not share the memory's rate with
//      it; later passes (more than 4 positions a thread) go into L2 ahead.
//   2. the softmax keeps the TPU kernel's rounding point: w is rounded to
//      bf16 from the probability under the GLOBAL max and sum, never from a
//      partial merged afterwards. Each block sends its local max to every
//      block of the cluster; each then takes the maximum of the maxima in
//      rank order, computes its exponentials and sends its sum; the sums
//      are added in rank order. Only then are the weights formed, once a
//      position.
//   3. P V: thread (slot, piece) sums 16 columns of V over positions slot,
//      slot + slots, ...; the slots of a warp are added by a butterfly of
//      shuffles, the warps in order through shared memory, and each output
//      element is sent to the block that adds the cluster's partials in
//      rank order.
// The exchanges do not use cluster barriers: a value goes by st.async
// straight into the receiver's shared memory and is counted there on an
// mbarrier, which the receiver alone waits on. One launch, a fixed order of
// every sum, no atomics and no scratch in device memory: reruns are
// bit-identical.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 128;
constexpr int kMinBlocks = 5;    // resident blocks an SM the registers must allow
constexpr int kWarps = kThreads / 32;
constexpr int kPiece = 16;       // head columns a thread takes: one 16-byte load
constexpr int kInFlight = 4;     // positions a thread loads before it uses any
constexpr int kQPairs = 2;       // q pairs a thread loads with K and V (the rest after)
constexpr int kMaxHeadDim = 256;
constexpr int kMaxSeqLen = 8192;
constexpr int kMaxCluster = 8;
constexpr int kMaxSmem = 232448;
constexpr unsigned kFull = 0xffffffffu;

struct Params {
  const float* q;
  const int8_t* kq;
  const __nv_bfloat16* ks;
  const int8_t* vq;
  const __nv_bfloat16* vs;
  float* out;
  int sp, seq_len, hkv, groups, hd;
  int per_block;  // positions a block
  int vec;        // K / V rows 16-byte aligned: one 16-byte load a piece
  float inv_sqrt;
};

// threads a position for head_dim hd
inline int lanes_for(int hd) {
  int lanes = 1;
  while (lanes * kPiece < hd) lanes *= 2;
  return lanes;
}

// floats of dynamic shared memory: four mbarriers (8 floats), scores /
// exponentials, then weights [groups][per_block], k_scale [per_block],
// bf16-rounded q as bf16 pairs [groups][lanes * 8], the warps' partial P V
// [kWarps][lanes * 16], the cluster's maxima and sums [2][cluster][groups],
// the cluster's partial outputs [cluster][groups * hd], and the first
// pass's V rows [min(per_block, pass)][hd] as int8 from the next 16-byte
// boundary
inline long long smem_floats(int groups, int hd, int per_block, int cluster) {
  const long long cols = (long long)lanes_for(hd) * kPiece;
  return 8 + (long long)(groups + 1) * per_block + groups * cols / 2 + kWarps * cols +
         2LL * cluster * groups + (long long)cluster * groups * hd;
}

__device__ __forceinline__ float bf16_round(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// 16 int8 values of a row piece holding `cols` valid values (0-16); the rest 0
// The load is volatile so that it is issued where it stands, ahead of the
// barriers before its first use, and not moved down to that use.
__device__ __forceinline__ uint4 load_piece(const int8_t* src, int cols, bool vec) {
  if (vec && cols == kPiece) {
    uint4 v;
    asm volatile("ld.global.nc.v4.u32 {%0, %1, %2, %3}, [%4];"
                 : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
                 : "l"(__cvta_generic_to_global(src)));
    return v;
  }
  uint32_t w[4] = {0u, 0u, 0u, 0u};
#pragma unroll
  for (int j = 0; j < kPiece; ++j)
    if (j < cols) w[j / 4] |= (uint32_t)(uint8_t)src[j] << (8 * (j % 4));
  return make_uint4(w[0], w[1], w[2], w[3]);
}

// the 4 signed bytes of x as exact floats: 2^23 + (byte + 128), less
// 2^23 + 128 (a byte permute and an add each, where a conversion
// instruction runs at an eighth of the rate)
__device__ __forceinline__ void bytes_to_floats(uint32_t x, float* f) {
  const uint32_t u = x ^ 0x80808080u;
  f[0] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7650)) - 8388736.f;
  f[1] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7651)) - 8388736.f;
  f[2] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7652)) - 8388736.f;
  f[3] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7653)) - 8388736.f;
}

// bf16 pair (lo, hi) from two floats that bf16 holds exactly
__device__ __forceinline__ uint32_t pack_exact(float lo, float hi) {
  return __byte_perm(__float_as_uint(lo), __float_as_uint(hi), 0x7632);
}

// bf16(a * b) for each half of two bf16 pairs: the exact product rounded
// to nearest even, as bf16(float(a) * float(b)) rounds it
__device__ __forceinline__ uint32_t mul_bf16x2(uint32_t a, uint32_t b) {
  __nv_bfloat162 x = *reinterpret_cast<__nv_bfloat162*>(&a);
  __nv_bfloat162 y = *reinterpret_cast<__nv_bfloat162*>(&b);
  __nv_bfloat162 r = __hmul2(x, y);
  return *reinterpret_cast<uint32_t*>(&r);
}

__device__ __forceinline__ void prefetch_l2(const void* ptr) {
  asm volatile("prefetch.global.L2 [%0];" ::"l"(__cvta_generic_to_global(ptr)));
}

// The exchanges between the blocks of a cluster: a block sends each value
// by st.async straight into the receiving block's shared memory, which
// counts the bytes on an mbarrier of its own; the receiver waits on that
// mbarrier alone, not on a barrier of the whole cluster.
__device__ __forceinline__ uint32_t smem_addr(const void* ptr) {
  return (uint32_t)__cvta_generic_to_shared(ptr);
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(smem_addr(bar)));
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
               ::"r"(smem_addr(bar)), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar) {
  asm volatile(
      "{\n"
      ".reg .pred done;\n"
      "WAIT%=:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 done, [%0], 0;\n"
      "@!done bra WAIT%=;\n"
      "}\n" ::"r"(smem_addr(bar))
      : "memory");
}

// value into `dst` of block `rank`, counted on that block's `bar`
__device__ __forceinline__ void send(float* dst, uint64_t* bar, int rank, float value) {
  uint32_t remote_dst, remote_bar;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;"
               : "=r"(remote_dst) : "r"(smem_addr(dst)), "r"(rank));
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;"
               : "=r"(remote_bar) : "r"(smem_addr(bar)), "r"(rank));
  asm volatile("st.async.shared::cluster.mbarrier::complete_tx::bytes.b32 [%0], %1, [%2];"
               ::"r"(remote_dst), "r"(__float_as_uint(value)), "r"(remote_bar) : "memory");
}

// LANES threads a position: hd / 16 of them, rounded up to a power of 2
template <int LANES>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
cross_attention_int8_kernel(const Params p) {
  constexpr int kSlots = kThreads / LANES;  // positions a block takes at once
  constexpr int cols_p = LANES * kPiece;
  constexpr int pass = kSlots * kInFlight;  // positions a pass of the block
  extern __shared__ float smem[];
  const int G = p.groups, hd = p.hd, pb = p.per_block;

  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int csize = (int)cluster.num_blocks();
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem);  // maxima, sums, outputs
  float* row = smem + 8;                       // [G][pb] scores, then exponentials
  float* ksc = row + G * pb;                   // [pb]
  uint32_t* qb = reinterpret_cast<uint32_t*>(ksc + pb);  // [G][cols_p / 2] bf16 pairs
  float* part = ksc + pb + G * cols_p / 2;     // [kWarps][cols_p]
  float* got_max = part + kWarps * cols_p;     // [csize][G], block r's in row r
  float* got_sum = got_max + csize * G;        // [csize][G]
  float* got_out = got_sum + csize * G;        // [csize][G * hd]

  const int kh = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int piece = tid % LANES, slot = tid / LANES;
  const int dkv = p.hkv * hd, dq = dkv * G;
  const int s0 = rank * pb;
  const int n = max(0, min(pb, p.seq_len - s0));  // this block's positions
  const long long first = (long long)b * p.sp + s0;
  const int cols = min(max(hd - piece * kPiece, 0), kPiece);
  const int8_t* kbase = p.kq + first * dkv + kh * hd + piece * kPiece;
  const int8_t* vbase = p.vq + first * dkv + kh * hd + piece * kPiece;
  const bool vec = p.vec != 0;
  // output elements e with (e / kThreads) % csize == rank are added here
  int owned = 0;
  for (int e0 = rank * kThreads; e0 < G * hd; e0 += csize * kThreads)
    owned += min(kThreads, G * hd - e0);
  if (tid == 0) {
    mbar_init(bars, 4 * csize * G);
    mbar_init(bars + 1, 4 * csize * G);
    mbar_init(bars + 2, 4 * csize * owned);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  // every block's mbarriers are ready before any block sends: arrive now
  // (the fence above has published them), wait before the first send
  asm volatile("barrier.cluster.arrive.relaxed.aligned;" ::: "memory");

  // the loads of the first pass in the order they are needed: q, K and
  // k_scale before anything is computed; V and v_scale once the scores
  // start, so that K does not share the memory's rate with them
  const int q_pairs = G * cols_p / 2;
  float2 qv[kQPairs];
#pragma unroll
  for (int t = 0; t < kQPairs; ++t) {
    const int i = tid + t * kThreads;
    qv[t] = make_float2(0.f, 0.f);
    if (i < q_pairs) {
      const int g = i / (cols_p / 2), d = 2 * (i % (cols_p / 2));
      const float* qg = p.q + (long long)b * dq + (kh * G + g) * hd;
      if (d < hd) qv[t].x = qg[d];
      if (d + 1 < hd) qv[t].y = qg[d + 1];
    }
  }
  uint4 kv[kInFlight], vv[kInFlight];
#pragma unroll
  for (int u = 0; u < kInFlight; ++u) {
    const int i = u * kSlots + slot;
    kv[u] = i < n ? load_piece(kbase + (long long)i * dkv, cols, vec) : make_uint4(0u, 0u, 0u, 0u);
  }
  const bool scale_thread = tid < n;  // this thread loads position tid's scales
  const __nv_bfloat16 zero = __float2bfloat16_rn(0.f);
  const __nv_bfloat16 ks0 = scale_thread ? p.ks[(first + tid) * p.hkv + kh] : zero;
  if (cols > 0)
    for (int i = pass + slot; i < n; i += kSlots) {  // later passes: into L2
      prefetch_l2(kbase + (long long)i * dkv);
      prefetch_l2(vbase + (long long)i * dkv);
    }
#pragma unroll
  for (int t = 0; t < kQPairs; ++t) {
    const int i = tid + t * kThreads;
    if (i < q_pairs) qb[i] = pack_exact(bf16_round(qv[t].x), bf16_round(qv[t].y));
  }
  for (int i = tid + kQPairs * kThreads; i < q_pairs; i += kThreads) {
    const int g = i / (cols_p / 2), d = 2 * (i % (cols_p / 2));
    const float* qg = p.q + (long long)b * dq + (kh * G + g) * hd;
    qb[i] = pack_exact(d < hd ? bf16_round(qg[d]) : 0.f,
                       d + 1 < hd ? bf16_round(qg[d + 1]) : 0.f);
  }
  if (scale_thread) ksc[tid] = __bfloat162float(ks0);
  for (int i = tid + kThreads; i < n; i += kThreads)
    ksc[i] = __bfloat162float(p.ks[(first + i) * p.hkv + kh]);
  __syncthreads();
#pragma unroll
  for (int u = 0; u < kInFlight; ++u) {
    const int i = u * kSlots + slot;
    vv[u] = i < n ? load_piece(vbase + (long long)i * dkv, cols, vec) : make_uint4(0u, 0u, 0u, 0u);
  }
  const __nv_bfloat16 vs0 = scale_thread ? p.vs[(first + tid) * p.hkv + kh] : zero;

  // 1. scores: sum_j bf16(bf16(q_j) * K_j) in order j = 0, 1, ..., then the
  // lanes of the position by shuffles
  for (int i0 = 0; i0 < n; i0 += pass) {
    if (i0 > 0) {
#pragma unroll
      for (int u = 0; u < kInFlight; ++u) {
        const int i = i0 + u * kSlots + slot;
        kv[u] = i < n ? load_piece(kbase + (long long)i * dkv, cols, vec)
                      : make_uint4(0u, 0u, 0u, 0u);
      }
    }
    // K as exact bf16 pairs, then each query head against the 4 positions
    // at once (4 independent chains of adds)
    uint32_t k2[kInFlight][kPiece / 2];
#pragma unroll
    for (int u = 0; u < kInFlight; ++u) {
      const uint32_t words[4] = {kv[u].x, kv[u].y, kv[u].z, kv[u].w};
#pragma unroll
      for (int t = 0; t < 4; ++t) {
        float f[4];
        bytes_to_floats(words[t], f);
        k2[u][2 * t] = pack_exact(f[0], f[1]);
        k2[u][2 * t + 1] = pack_exact(f[2], f[3]);
      }
    }
    for (int g = 0; g < G; ++g) {
      const uint32_t* qg = qb + g * (cols_p / 2) + piece * (kPiece / 2);
      float a[kInFlight];
#pragma unroll
      for (int u = 0; u < kInFlight; ++u) a[u] = 0.f;
#pragma unroll
      for (int t = 0; t < kPiece / 2; ++t) {
        const uint32_t qt = qg[t];
#pragma unroll
        for (int u = 0; u < kInFlight; ++u) {
          const uint32_t pr = mul_bf16x2(qt, k2[u][t]);
          a[u] += __uint_as_float(pr << 16);
          a[u] += __uint_as_float(pr & 0xffff0000u);
        }
      }
#pragma unroll
      for (int u = 0; u < kInFlight; ++u) {
#pragma unroll
        for (int off = 1; off < LANES; off <<= 1) a[u] += __shfl_xor_sync(kFull, a[u], off);
        const int i = i0 + u * kSlots + slot;
        if (piece == 0 && i < n) row[g * pb + i] = a[u] * ksc[i] * p.inv_sqrt;
      }
    }
  }
  __syncthreads();

  // 2. the cluster's maximum: each block's sent to every block, then read
  // there in rank order
  asm volatile("barrier.cluster.wait.acquire.aligned;" ::: "memory");
  for (int g = warp; g < G; g += kWarps) {
    float m = -INFINITY;
    for (int i = lane; i < n; i += 32) m = fmaxf(m, row[g * pb + i]);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) m = fmaxf(m, __shfl_xor_sync(kFull, m, off));
    if (lane < csize) send(got_max + rank * G + g, bars, lane, m);
  }
  mbar_wait(bars);

  // the sum of exponentials: each block's, sent, added in rank order
  for (int g = warp; g < G; g += kWarps) {
    float m = got_max[g];
    for (int r = 1; r < csize; ++r) m = fmaxf(m, got_max[r * G + g]);
    float l = 0.f;
    for (int i = lane; i < n; i += 32) {
      const float e = expf(row[g * pb + i] - m);
      row[g * pb + i] = e;
      l += e;
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) l += __shfl_xor_sync(kFull, l, off);
    if (lane < csize) send(got_sum + rank * G + g, bars + 1, lane, l);
  }
  __syncthreads();  // each position's exponentials, for the thread of the position
  mbar_wait(bars + 1);

  // 3. the weights, rounded from the global probability: thread t those of
  // positions t, t + 128, ...
  for (int i = tid; i < n; i += kThreads) {
    const float vsi = __bfloat162float(i == tid ? vs0 : p.vs[(first + i) * p.hkv + kh]);
    for (int g = 0; g < G; ++g) {
      float l = got_sum[g];
      for (int r = 1; r < csize; ++r) l += got_sum[r * G + g];
      row[g * pb + i] = bf16_round(row[g * pb + i] / l * vsi);
    }
  }
  __syncthreads();

  // 4. P V, one query head at a time; the first pass's V is still in
  // registers. Output element e of the block's partial goes to block
  // (e / 128) % csize, which adds the cluster's partials.
  for (int g = 0; g < G; ++g) {
    float acc[kPiece];
#pragma unroll
    for (int j = 0; j < kPiece; ++j) acc[j] = 0.f;
    for (int i0 = 0; i0 < n; i0 += pass) {
#pragma unroll
      for (int u = 0; u < kInFlight; ++u) {
        const int i = i0 + u * kSlots + slot;
        const uint4 x = i0 == 0 ? vv[u]
                        : i < n ? load_piece(vbase + (long long)i * dkv, cols, vec)
                                : make_uint4(0u, 0u, 0u, 0u);
        if (i >= n) continue;
        const uint32_t words[4] = {x.x, x.y, x.z, x.w};
        float v[kPiece];
#pragma unroll
        for (int t = 0; t < 4; ++t) bytes_to_floats(words[t], v + 4 * t);
        const float w = row[g * pb + i];
#pragma unroll
        for (int j = 0; j < kPiece; ++j) acc[j] = fmaf(w, v[j], acc[j]);
      }
    }
    // the slots of a warp (the lane bits above `piece`) by a butterfly that
    // halves the columns a thread holds at each step, then the warps
    int base = 0, size = kPiece;  // the columns acc[0 .. size) stand for
    bool writer = true;
#pragma unroll
    for (int off = LANES; off < 32; off <<= 1) {
      const bool upper = (lane & off) != 0;
      if (size > 1) {
        const int half = size / 2;
#pragma unroll
        for (int t = 0; t < kPiece / 2; ++t) {
          if (t < half) {
            const float mine = upper ? acc[t + half] : acc[t];
            const float theirs =
                __shfl_xor_sync(kFull, upper ? acc[t] : acc[t + half], off);
            acc[t] = mine + theirs;
          }
        }
        base += upper ? half : 0;
        size = half;
      } else {
        acc[0] += __shfl_xor_sync(kFull, acc[0], off);
        writer = writer && !upper;
      }
    }
    if (writer) {
      float* dst = part + warp * cols_p + piece * kPiece + base;
#pragma unroll
      for (int t = 0; t < kPiece; ++t)
        if (t < size) dst[t] = acc[t];
    }
    __syncthreads();
    for (int d = tid; d < hd; d += kThreads) {
      float s = part[d];
      for (int w = 1; w < kWarps; ++w) s += part[w * cols_p + d];
      const int e = g * hd + d;
      send(got_out + rank * G * hd + e, bars + 2, (e / kThreads) % csize, s);
    }
    __syncthreads();  // part is rewritten by the next head
  }

  // 5. the cluster's partial outputs, added in rank order. Every value a
  // block is sent is one it waits for, so no block leaves while another can
  // still write to it.
  mbar_wait(bars + 2);
  for (int e = rank * kThreads + tid; e < G * hd; e += csize * kThreads) {
    float s = got_out[e];
    for (int r = 1; r < csize; ++r) s += got_out[r * G * hd + e];
    const int g = e / hd, d = e % hd;
    p.out[(long long)b * dq + (kh * G + g) * hd + d] = s;
  }
}

inline bool aligned16(const void* ptr) {
  return reinterpret_cast<uintptr_t>(ptr) % 16 == 0;
}

}  // namespace

// q, out: float32 [batch, hkv * groups * hd] (head-major; the query heads of
// one kv head adjacent). kq, vq: int8 [batch, sp, hkv * hd]. ks, vs: bfloat16
// [batch, sp, hkv]. All contiguous. Positions >= seq_len are ignored.
// inv_sqrt: 1 / sqrt(hd) as the caller rounds it. The plan
// (ops/cross_attention.py::cross_attention_plan): `cluster` blocks a (row,
// kv head), `per_block` positions each; a plan that does not cover seq_len
// or exceeds this source's limits is refused. Returns the cudaGetLastError()
// code of the launch.
extern "C" int ws_cross_attention_int8(const float* q, const int8_t* kq,
                                       const __nv_bfloat16* ks, const int8_t* vq,
                                       const __nv_bfloat16* vs, float* out,
                                       int batch, int sp, int seq_len, int hkv,
                                       int groups, int hd, float inv_sqrt,
                                       int cluster, int per_block,
                                       cudaStream_t stream) {
  if (batch <= 0 || hkv <= 0 || groups <= 0 || hd <= 0 || hd > kMaxHeadDim ||
      seq_len <= 0 || seq_len > sp || seq_len > kMaxSeqLen || batch > 65535 ||
      hkv > 65535)
    return (int)cudaErrorInvalidValue;
  if (cluster < 1 || cluster > kMaxCluster || per_block < 1 ||
      (long long)cluster * per_block < seq_len)
    return (int)cudaErrorInvalidValue;
  const long long smem = 4 * smem_floats(groups, hd, per_block, cluster);
  if (smem > kMaxSmem) return (int)cudaErrorInvalidValue;

  Params p;
  p.q = q; p.kq = kq; p.ks = ks; p.vq = vq; p.vs = vs; p.out = out;
  p.sp = sp; p.seq_len = seq_len; p.hkv = hkv; p.groups = groups; p.hd = hd;
  p.per_block = per_block;
  p.vec = hd % kPiece == 0 && aligned16(kq) && aligned16(vq);
  p.inv_sqrt = inv_sqrt;

  const int lanes = lanes_for(hd);
  auto kernel = lanes == 1   ? cross_attention_int8_kernel<1>
                : lanes == 2 ? cross_attention_int8_kernel<2>
                : lanes == 4 ? cross_attention_int8_kernel<4>
                : lanes == 8 ? cross_attention_int8_kernel<8>
                             : cross_attention_int8_kernel<16>;
  cudaError_t err = cudaSuccess;
  // above 48 KB only by the attribute, set on every such launch: it belongs
  // to the current device context
  if (smem > 48 * 1024)
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cluster, hkv, batch);
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = (size_t)smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kernel, p);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}
