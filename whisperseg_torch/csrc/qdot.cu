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
// The dequantized weight never reaches device memory.
//
// Bound on an H100: memory at the callers that matter most, the decode step
// (M = 16 rows) and the prefill (M = 48), where each weight byte serves a
// few rows only. A launch streams 0.26 to 1 MB of weights (base model), a
// fraction of a microsecond at 3.35 TB/s, so what sets its time is latency:
// how many of those bytes are in flight at once, and the launch itself. At
// M 512 (a one-window batch's encoder) the products' operations come first.
//
// Design. The piece size, cluster size and rows of x a chunk come from
// ops/quant.py::qdot_plan and are checked here against this source's limits
// (plan_ok); the tile width, the grid and the shared memory follow from
// them:
//   * A block of 4 warps owns a tile of 64 output columns, one chunk of
//     m_chunk rows of x (16 to 64; the grid's third dimension walks the
//     chunks) and pieces of the contraction: k_slice weight rows (w4a16:
//     k_slice byte rows, which carry contraction rows i and i + K/2, so
//     2 k_slice rows). The pieces of one (column tile, chunk) go to the
//     blocks of one thread-block cluster (at most 8, the portable size),
//     block r taking pieces r, r + cluster, ... At the decode shapes the
//     plan cuts K into one piece a block (the base model's decode products
//     launch 64 to 256 blocks, where a tile of rows x columns launched 8 to
//     32); at more rows it cuts K into pieces of 64 contraction rows and
//     picks the smallest cluster that gives the card at least 384 blocks
//     (about 3 an SM), so that a block walks several pieces and the chunks
//     fill the card.
//   * A block copies a piece into shared memory with 16-byte cp.async
//     copies, all issued before the first is waited on, and stages its
//     columns of x as bf16 meanwhile; it then dequantizes the piece to bf16
//     in shared memory, with the roundings of the function above, and
//     multiplies: mma.sync m16n8k16 with x as A (ldmatrix) and the weights
//     as B (ldmatrix.trans), float32 accumulators; each warp owns 16
//     columns. The w4a16 piece's local rows are its low nibbles, then its
//     high ones; the scale group is taken per element, since the two
//     nibbles of a byte lie K/2 rows apart (with K = 384 and groups of 128,
//     in different phases of their groups).
//   * A block with several pieces double-buffers them: the next piece's
//     weights, and where x is bf16 with 16-byte aligned rows its columns of
//     x, arrive by cp.async while this one multiplies (the wrapper rounds a
//     float32 x of more than 64 rows to bf16 first, since every column tile
//     reads all of it); a float32 x is loaded and rounded piece by piece.
//   * Each block writes its float32 partial tile into its own shared memory.
//     After a cluster barrier, block r adds the partial tiles of rows r,
//     r + cluster, ... in rank order, reading the other blocks' tiles through
//     distributed shared memory, and writes y. A fixed order of sums, no
//     atomics and no scratch: the result is the same from run to run.
//   * Rows of a piece beyond K, columns beyond N and rows beyond M are zero
//     in shared memory. Where N is not a multiple of 16 or a pointer is not
//     16-byte aligned, weights arrive by single bytes and x element by element.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_tiles.cuh"

namespace cg = cooperative_groups;

namespace {

using bf16 = __nv_bfloat16;

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kTileN = 64;          // output columns of a block, 16 a warp
constexpr int kLdW = kTileN + 8;    // bf16 row stride of the weights: 144 B
constexpr int kLdRed = kTileN + 8;  // float row stride of a partial tile
constexpr int kMaxCluster = 8;
constexpr int kMaxRows = 640;       // contraction rows of one piece
constexpr int kMaxChunk = 64;       // rows of x a block multiplies at a time
constexpr int kMaxSmem = 232448;    // a block's shared memory on the H100

struct Params {
  const void* x;
  const int8_t* w;     // int8 [rows, n]: values (w8a16) or packed (w4a16)
  const float* scale;  // [n] (w8a16) or [groups, n] (w4a16)
  float* y;
  int m, k, n;
  int rows;    // storage rows of w: k (w8a16), k / 2 (w4a16)
  int gs;      // w4a16: contraction rows per scale group
  int ks;      // storage rows of one piece
  int pieces;  // ceil(rows / ks)
  int mc;      // rows of x per chunk
  int nb;      // buffers of x and of the stored piece: 2 where a block has
               // more than one piece, else 1
  bool x_vec, x_async, w_vec, y_vec;
};

// Dynamic shared memory in bytes for kr contraction rows (ks storage rows)
// a piece, mc rows of x a chunk and nb buffers (2 for a block with more
// than one piece, else 1):
//   wb   bf16 [kr][kLdW]           the dequantized piece
//   xs   bf16 [nb][mc][kr + 8]     x, rounded to bf16
//   wq   int8 [nb][ks][kTileN]     the piece as stored
//   part float [mc][kLdRed]        the block's partial tile
// Row strides of 16 bytes past a multiple of 32 keep ldmatrix free of bank
// conflicts and every region 16-byte aligned. ops/quant.py::_smem_bytes
// computes the same to choose mc within kMaxSmem.
constexpr int smem_bytes(int kr, int ks, int mc, int nb) {
  return kr * kLdW * 2 + nb * (mc * (kr + 8) * 2 + ks * kTileN) + mc * kLdRed * 4;
}

__device__ __forceinline__ float bf16_round(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

__device__ __forceinline__ void load_scales(const float* __restrict__ row,
                                            int n0, int n, float (&s)[4]) {
#pragma unroll
  for (int e = 0; e < 4; ++e) s[e] = (n0 + e < n) ? bf16_round(row[n0 + e]) : 0.f;
}

// Starts the copy of piece `piece` (tile columns [n0, n0 + kTileN)) into wq.
// The aligned path leaves its copies in flight (the caller commits them);
// the ragged one copies byte by byte.
__device__ __forceinline__ void load_piece(const Params& p, int8_t* wq,
                                           int piece, int n0) {
  const int r0 = piece * p.ks;
  const int nrows = min(p.ks, p.rows - r0);
  if (p.w_vec) {
    for (int i = threadIdx.x; i < nrows * (kTileN / 16); i += kThreads) {
      const int r = i / (kTileN / 16), col = (i % (kTileN / 16)) * 16;
      if (n0 + col < p.n)  // n % 16 == 0: the 16 bytes are all in range
        tiles::cp_async_16(wq + r * kTileN + col,
                           p.w + (long long)(r0 + r) * p.n + n0 + col);
    }
  } else {
    for (int i = threadIdx.x; i < nrows * kTileN; i += kThreads) {
      const int r = i / kTileN, col = i % kTileN;
      if (n0 + col < p.n) wq[i] = p.w[(long long)(r0 + r) * p.n + n0 + col];
    }
  }
}

// Four elements of x from `row`, columns col .. col + 3 of which the first
// `valid` exist (zero past them), as loaded: four float32 or four bf16.
__device__ __forceinline__ float4 x_load(const float* row, int col, int valid,
                                         bool vec) {
  if (vec && valid == 4) return *reinterpret_cast<const float4*>(row + col);
  float v[4];
#pragma unroll
  for (int e = 0; e < 4; ++e) v[e] = e < valid ? row[col + e] : 0.f;
  return make_float4(v[0], v[1], v[2], v[3]);
}
__device__ __forceinline__ uint2 x_load(const bf16* row, int col, int valid,
                                        bool vec) {
  if (vec && valid == 4) return *reinterpret_cast<const uint2*>(row + col);
  const uint16_t* bits = reinterpret_cast<const uint16_t*>(row + col);
  uint32_t h[4];
#pragma unroll
  for (int e = 0; e < 4; ++e) h[e] = e < valid ? bits[e] : 0u;
  return make_uint2(h[0] | (h[1] << 16), h[2] | (h[3] << 16));
}
// ... and as four bf16 (rounded to nearest even).
__device__ __forceinline__ uint2 to_bf16(float4 f) {
  return make_uint2(tiles::pack_bf16(f.x, f.y), tiles::pack_bf16(f.z, f.w));
}
__device__ __forceinline__ uint2 to_bf16(uint2 h) { return h; }

// x rows [m0, m0 + mc) at the contraction rows of piece `piece` into
// xs [mc][kr + 8] as bf16, zero beyond M and K.
// w4a16: local columns [0, ks) are rows piece * ks + i, columns [ks, 2 ks)
// rows K/2 + piece * ks + i. A thread starts kBatch loads before it stores
// any, so that their latencies overlap (and overlap the copies in flight).
template <int BITS, typename XT>
__device__ __forceinline__ void stage_x(const Params& p, bf16* xs, int m0,
                                        int piece) {
  constexpr int kPer = BITS == 8 ? 1 : 2;
  constexpr int kBatch = 8;
  const XT* x = static_cast<const XT*>(p.x) + (long long)m0 * p.k;
  const int rows = p.m - m0;  // rows of x from m0 on
  const int kr = kPer * p.ks, ldx = kr + 8, quads = kr / 4;
  const int r0 = piece * p.ks;
  // quad i = threadIdx.x + n * kThreads is (row, q) = (i / quads, i % quads),
  // stepped without a division
  const int step_row = kThreads / quads, step_q = kThreads % quads;
  int row = threadIdx.x / quads, q = threadIdx.x % quads;
  while (row < p.mc) {
    decltype(x_load(x, 0, 0, false)) raw[kBatch];
    int dst[kBatch];
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      dst[u] = -1;
      if (row < p.mc) {
        const int kk = q * 4;
        const bool high = BITS == 4 && kk >= p.ks;  // ks % 8 == 0: no quad straddles
        const int srow = r0 + (high ? kk - p.ks : kk);
        const int col = high ? p.rows + srow : srow;
        const int valid = row < rows ? max(0, min(4, p.rows - srow)) : 0;
        raw[u] = x_load(x + (long long)min(row, rows - 1) * p.k, col, valid,
                        p.x_vec);
        dst[u] = row * ldx + kk;
        row += step_row;
        q += step_q;
        if (q >= quads) {
          q -= quads;
          ++row;
        }
      }
    }
#pragma unroll
    for (int u = 0; u < kBatch; ++u)
      if (dst[u] >= 0) *reinterpret_cast<uint2*>(xs + dst[u]) = to_bf16(raw[u]);
  }
}

// The same for a bf16 x whose rows are 16-byte aligned (x_async): starts
// cp.async copies of 8 elements (the caller commits them); zeros beyond M
// and K are stored directly.
template <int BITS>
__device__ __forceinline__ void copy_x(const Params& p, bf16* xs, int m0,
                                       int piece) {
  constexpr int kPer = BITS == 8 ? 1 : 2;
  const bf16* x = static_cast<const bf16*>(p.x);
  const int kr = kPer * p.ks, ldx = kr + 8, octs = kr / 8;
  const int r0 = piece * p.ks;
  for (int i = threadIdx.x; i < p.mc * octs; i += kThreads) {
    const int row = i / octs, kk = (i % octs) * 8;
    const bool high = BITS == 4 && kk >= p.ks;  // ks % 8 == 0: no octet straddles
    const int srow = r0 + (high ? kk - p.ks : kk);
    bf16* dst = xs + row * ldx + kk;
    if (m0 + row < p.m && srow < p.rows)  // rows % 8 == 0: all 8 in range
      tiles::cp_async_16(dst, x + (long long)(m0 + row) * p.k +
                                  (high ? p.rows + srow : srow));
    else
      *reinterpret_cast<uint4*>(dst) = make_uint4(0, 0, 0, 0);
  }
}

// wq (piece `piece` as stored) -> wb (bf16 [kr][kLdW]); rows beyond the
// weight's and columns beyond n are zero. A thread owns 4 columns: column
// c4 = (threadIdx.x % 16) * 4 of the tile, whose w8a16 bf16 scales s8 the
// caller loaded.
template <int BITS>
__device__ __forceinline__ void dequantize(const Params& p, const int8_t* wq,
                                           bf16* wb, int piece, int n0,
                                           const float (&s8)[4]) {
  const int c4 = (threadIdx.x % (kTileN / 4)) * 4;
  const int r0 = piece * p.ks;
  // w4a16: the bf16 scales of the groups of this thread's current low and
  // high rows, which hold for storage rows [*_begin, *_end) (no division on
  // the way through a group)
  float s_lo[4] = {s8[0], s8[1], s8[2], s8[3]}, s_hi[4] = {0.f, 0.f, 0.f, 0.f};
  int lo_begin = 0, lo_end = 0, hi_begin = 0, hi_end = 0;
#pragma unroll 4
  for (int r = threadIdx.x / (kTileN / 4); r < p.ks; r += kThreads / (kTileN / 4)) {
    const int srow = r0 + r;
    const bool ok = srow < p.rows;
    const uint32_t word = ok ? *reinterpret_cast<const uint32_t*>(wq + r * kTileN + c4) : 0u;
    if (BITS == 8) {
      float v[4];
#pragma unroll
      for (int e = 0; e < 4; ++e)  // q * s is exact in float32: one rounding
        v[e] = (float)(int8_t)(word >> (8 * e)) * s_lo[e];
      *reinterpret_cast<uint2*>(wb + r * kLdW + c4) =
          make_uint2(tiles::pack_bf16(v[0], v[1]), tiles::pack_bf16(v[2], v[3]));
    } else {
      if (ok && (srow < lo_begin || srow >= lo_end)) {
        const int g = srow / p.gs;
        load_scales(p.scale + (long long)g * p.n, n0 + c4, p.n, s_lo);
        lo_begin = g * p.gs;
        lo_end = lo_begin + p.gs;
      }
      if (ok && (srow < hi_begin || srow >= hi_end)) {  // row rows + srow
        const int g = (p.rows + srow) / p.gs;
        load_scales(p.scale + (long long)g * p.n, n0 + c4, p.n, s_hi);
        hi_begin = g * p.gs - p.rows;
        hi_end = hi_begin + p.gs;
      }
      float lo[4], hi[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int b = (int8_t)(word >> (8 * e));
        const int lo_u = b & 15;
        lo[e] = (float)(lo_u - (lo_u > 7 ? 16 : 0)) * s_lo[e];  // sign-extended
        hi[e] = (float)(b >> 4) * s_hi[e];  // arithmetic shift: floor(b / 16)
      }
      *reinterpret_cast<uint2*>(wb + r * kLdW + c4) =
          make_uint2(tiles::pack_bf16(lo[0], lo[1]), tiles::pack_bf16(lo[2], lo[3]));
      *reinterpret_cast<uint2*>(wb + (p.ks + r) * kLdW + c4) =
          make_uint2(tiles::pack_bf16(hi[0], hi[1]), tiles::pack_bf16(hi[2], hi[3]));
    }
  }
}

// Every region and buffer of the layout of smem_bytes starts on a 16-byte
// boundary; the compiler is told so, or it splits 8- and 16-byte accesses
// at offsets it cannot bound.
template <typename T>
__device__ __forceinline__ T* assume16(T* ptr) {
  return static_cast<T*>(__builtin_assume_aligned(ptr, 16));
}

// Buffer j % nb (nb is 1 or 2) of `count` elements each from `base`.
template <typename T>
__device__ __forceinline__ T* buffer(T* base, int j, int nb, int count) {
  return assume16(base + (j & (nb - 1)) * count);
}

template <int BITS, typename XT>
__global__ void __launch_bounds__(kThreads) qdot_kernel(const Params p) {
  constexpr int kPer = BITS == 8 ? 1 : 2;
  constexpr int kTiles = kMaxChunk / 16;
  constexpr bool kBf16X = sizeof(XT) == 2;
  extern __shared__ __align__(16) unsigned char smem[];
  const int kr = kPer * p.ks, ldx = kr + 8;
  bf16* wb = reinterpret_cast<bf16*>(smem);
  bf16* xs = assume16(wb + kr * kLdW);
  int8_t* wq = assume16(reinterpret_cast<int8_t*>(xs + p.nb * p.mc * ldx));
  float* part = assume16(reinterpret_cast<float*>(wq + p.nb * p.ks * kTileN));

  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int csize = (int)cluster.num_blocks();
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int gr = lane / 4, tg = lane % 4;
  const int n0 = blockIdx.x * kTileN;
  const int m0 = blockIdx.z * p.mc;  // this cluster's chunk of x
  const int rows_here = min(p.mc, p.m - m0);
  const int mtiles = (rows_here + 15) / 16;
  const int mine = (p.pieces - rank + csize - 1) / csize;  // pieces of this block
  const bool async_x = kBf16X && p.x_async;

  // Stage j multiplies piece rank + j * csize. Its weight copy and (async_x)
  // its x copy go to buffers j % nb, one cp.async group.
  auto fetch = [&](int j) {
    const int piece = rank + j * csize;
    load_piece(p, buffer(wq, j, p.nb, p.ks * kTileN), piece, n0);
    if (async_x) copy_x<BITS>(p, buffer(xs, j, p.nb, p.mc * ldx), m0, piece);
    tiles::cp_async_commit();
  };
  fetch(0);
  float s8[4] = {0.f, 0.f, 0.f, 0.f};  // w8a16: this thread's columns' scales

  float acc[kTiles][2][4] = {};
  for (int j = 0; j < mine; ++j) {
    const int piece = rank + j * csize;
    bf16* xc = buffer(xs, j, p.nb, p.mc * ldx);
    if (j > 0) __syncthreads();  // stage j - 1's readers of wb and buffers (j + 1) % nb are done
    if (j + 1 < mine) fetch(j + 1);
    if (!async_x) stage_x<BITS, XT>(p, xc, m0, piece);  // while the copies fly
    if (j + 1 < mine) tiles::cp_async_wait<1>();
    else tiles::cp_async_wait<0>();
    __syncthreads();
    if (BITS == 8 && j == 0)  // read once the copies have landed: no earlier
      load_scales(p.scale, n0 + (threadIdx.x % (kTileN / 4)) * 4, p.n, s8);
    dequantize<BITS>(p, buffer(wq, j, p.nb, p.ks * kTileN), wb, piece, n0, s8);
    __syncthreads();
    for (int kk = 0; kk < kr; kk += 16) {
      uint32_t b[4];  // this warp's 16 columns: b0, b1 of two n8 tiles
      tiles::ldsm_b_trans(b, wb, kLdW, kk, warp * 16, lane);
#pragma unroll
      for (int t = 0; t < kTiles; ++t) {
        if (t < mtiles) {
          uint32_t a[4];
          tiles::ldsm_a(a, xc, ldx, t * 16, kk, lane);
          tiles::mma_bf16(acc[t][0], a, b[0], b[1]);
          tiles::mma_bf16(acc[t][1], a, b[2], b[3]);
        }
      }
    }
  }

#pragma unroll
  for (int t = 0; t < kTiles; ++t) {
    if (t < mtiles) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float* at = part + (t * 16 + gr) * kLdRed + warp * 16 + h * 8 + 2 * tg;
        *reinterpret_cast<float2*>(at) = make_float2(acc[t][h][0], acc[t][h][1]);
        *reinterpret_cast<float2*>(at + 8 * kLdRed) =
            make_float2(acc[t][h][2], acc[t][h][3]);
      }
    }
  }
  cluster.sync();  // every block's partial tile is written

  // block `rank` sums rows rank, rank + csize, ... over the blocks in rank order
  const int my_rows = (rows_here - rank + csize - 1) / csize;
  for (int i = threadIdx.x; i < my_rows * (kTileN / 4); i += kThreads) {
    const int row = rank + (i / (kTileN / 4)) * csize;
    const int col = (i % (kTileN / 4)) * 4;
    if (n0 + col >= p.n) continue;
    float* src = part + row * kLdRed + col;
    float4 v[kMaxCluster];  // all loads in flight before the first add
#pragma unroll
    for (int q = 0; q < kMaxCluster; ++q)
      if (q < csize)
        v[q] = *reinterpret_cast<const float4*>(cluster.map_shared_rank(src, q));
    float4 sum = v[0];
#pragma unroll
    for (int q = 1; q < kMaxCluster; ++q) {
      if (q < csize) {
        sum.x += v[q].x; sum.y += v[q].y; sum.z += v[q].z; sum.w += v[q].w;
      }
    }
    float* out = p.y + (long long)(m0 + row) * p.n + n0 + col;
    if (p.y_vec) {
      *reinterpret_cast<float4*>(out) = sum;
    } else {
      const float sv[4] = {sum.x, sum.y, sum.z, sum.w};
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (n0 + col + e < p.n) out[e] = sv[e];
    }
  }
  cluster.sync();  // no block leaves while another still reads its tile
}

inline bool aligned16(const void* ptr) {
  return reinterpret_cast<uintptr_t>(ptr) % 16 == 0;
}

// The plan from ops/quant.py::qdot_plan, checked against this source's
// limits: a refused plan is an error, never a different kernel.
template <int BITS>
bool plan_ok(const Params& p, int cluster, int smem) {
  constexpr int kPer = BITS == 8 ? 1 : 2;
  constexpr int kUnit = 16 / kPer;  // a piece is whole k16 steps
  if (p.ks <= 0 || p.ks % kUnit || kPer * p.ks > kMaxRows) return false;
  if (p.mc < 16 || p.mc > kMaxChunk || p.mc % 16) return false;
  if (cluster < 1 || cluster > min(kMaxCluster, p.pieces)) return false;
  return smem <= kMaxSmem;
}

template <int BITS, typename XT>
int launch(const Params& p, int cluster, int smem, cudaStream_t stream) {
  auto kernel = qdot_kernel<BITS, XT>;
  cudaError_t err = cudaSuccess;
  // above 48 KB only by the attribute, set on every such launch: it belongs
  // to the current device context
  if (smem > 48 * 1024)
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               smem);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((p.n + kTileN - 1) / kTileN, cluster, (p.m + p.mc - 1) / p.mc);
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = cluster;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kernel, p);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

template <int BITS>
int run(Params p, int x_is_bf16, int k_slice, int cluster, int m_chunk,
        cudaStream_t stream) {
  constexpr int kPer = BITS == 8 ? 1 : 2;
  p.ks = k_slice;
  p.pieces = k_slice > 0 ? (p.rows + k_slice - 1) / k_slice : 0;
  p.mc = m_chunk;
  p.nb = p.pieces > cluster ? 2 : 1;
  const int smem = smem_bytes(kPer * p.ks, p.ks, p.mc, p.nb);
  // 16-byte paths: K % 8 == 0 keeps every quad of x (w4a16: both halves)
  // aligned, rows % 8 == 0 every octet of a bf16 x, N % 16 == 0 every 16
  // weight bytes of a row
  p.x_vec = p.k % 8 == 0 && aligned16(p.x);
  p.x_async = x_is_bf16 && p.x_vec && p.rows % 8 == 0;
  p.w_vec = p.n % 16 == 0 && aligned16(p.w);
  p.y_vec = p.n % 4 == 0 && aligned16(p.y);
  if (!plan_ok<BITS>(p, cluster, smem)) return (int)cudaErrorInvalidValue;
  return x_is_bf16 ? launch<BITS, bf16>(p, cluster, smem, stream)
                   : launch<BITS, float>(p, cluster, smem, stream);
}

}  // namespace

// x: [m, k] contiguous, float32 or (x_is_bf16) bfloat16. w: int8 [k, n]
// contiguous. scale: float32 [n]. y: float32 [m, n] contiguous. The last
// three ints are the plan of ops/quant.py::qdot_plan. Returns the CUDA error
// code of the launch (cudaErrorInvalidValue for a refused shape or plan).
extern "C" int ws_qdot_w8a16(const void* x, int x_is_bf16, const int8_t* w,
                             const float* scale, float* y, int m, int k, int n,
                             int k_slice, int cluster, int m_chunk,
                             cudaStream_t stream) {
  if (m <= 0 || k <= 0 || n <= 0) return (int)cudaErrorInvalidValue;
  Params p = {};
  p.x = x; p.w = w; p.scale = scale; p.y = y;
  p.m = m; p.k = k; p.n = n; p.rows = k; p.gs = k;
  return run<8>(p, x_is_bf16, k_slice, cluster, m_chunk, stream);
}

// As above with packed: int8 [k / 2, n] (two nibbles a byte) and scale:
// float32 [groups, n]; k even and a multiple of groups.
extern "C" int ws_qdot_w4a16(const void* x, int x_is_bf16, const int8_t* packed,
                             const float* scale, float* y, int m, int k, int n,
                             int groups, int k_slice, int cluster, int m_chunk,
                             cudaStream_t stream) {
  if (m <= 0 || k <= 0 || n <= 0 || groups <= 0 || k % 2 || k % groups)
    return (int)cudaErrorInvalidValue;
  Params p = {};
  p.x = x; p.w = packed; p.scale = scale; p.y = y;
  p.m = m; p.k = k; p.n = n; p.rows = k / 2; p.gs = k / groups;
  return run<4>(p, x_is_bf16, k_slice, cluster, m_chunk, stream);
}
