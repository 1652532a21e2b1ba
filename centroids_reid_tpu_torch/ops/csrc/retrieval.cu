// Retrieval kernels for Hopper (sm_90a): the three kernels that carry the
// serving path's top-k selection against a device-resident gallery.
//
//   K1 crt_scores          scores = gn - 2 q.g^T             (bf16 in, fp32 out)
//   K2 crt_stream_topk     streaming top-k at bf16 key resolution, k <= 32,
//                          never materialises the Q x G score matrix
//   K3 crt_kpass_topk      exact fp32 k smallest of each row, row in smem
//
// Plain C interface, loaded with ctypes (ops/_build.py). Every entry point
// launches on the stream it is given, allocates nothing, and returns
// cudaGetLastError() so the Python wrapper can raise on a refused launch.
//
// Shape contract (checked by the wrappers in ops/retrieval.py): q [Q, D] and
// g [G, D] row-major bf16, Q % 128 == 0, G % 128 == 0, D % 32 == 0;
// gn [G] fp32 with +inf on gallery pad rows, so a pad row never wins.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

using namespace nvcuda;

namespace {

typedef unsigned long long u64;

constexpr int BM = 128;       // query rows per block tile
constexpr int BN = 128;       // gallery rows per block tile
constexpr int BK = 32;        // depth per shared-memory stage
constexpr int LDS = BK + 8;   // bf16 row stride of the A/B stages (80 B: wmma
                              // needs a multiple of 8 elements, +8 staggers banks)
constexpr int LDC = BN + 4;   // fp32 row stride of the score tile
constexpr int THREADS = 256;  // 8 warps: 2 (rows) x 4 (cols), 64 x 32 each
constexpr u64 KEY_MAX = ~0ull;

constexpr size_t kStageBytes = 2 * BM * LDS * sizeof(__nv_bfloat16);
constexpr size_t kTileBytes = BM * LDC * sizeof(float);
constexpr size_t kListBytes = BM * 32 * sizeof(u64);

typedef wmma::fragment<wmma::accumulator, 16, 16, 16, float> Acc;

// One BM x BN tile of q.g^T with fp32 accumulation on the tensor cores
// (mma.sync through wmma), written to the shared fp32 tile Cs. The whole
// block takes part; Cs is complete after the trailing __syncthreads().
__device__ void dot_tile(const __nv_bfloat16* __restrict__ q,
                         const __nv_bfloat16* __restrict__ g, int D, int q0,
                         int g0, __nv_bfloat16* As, __nv_bfloat16* Bs,
                         float* Cs) {
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int wm = warp / 4, wn = warp % 4;
  Acc c[4][2];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(c[i][j], 0.0f);

  for (int k0 = 0; k0 < D; k0 += BK) {
    // 128 rows x 32 bf16 = 512 16-byte vectors per operand, 2 per thread
    for (int v = tid; v < BM * BK / 8; v += THREADS) {
      const int r = v / (BK / 8), col = (v % (BK / 8)) * 8;
      *reinterpret_cast<uint4*>(&As[r * LDS + col]) =
          *reinterpret_cast<const uint4*>(&q[(size_t)(q0 + r) * D + k0 + col]);
      *reinterpret_cast<uint4*>(&Bs[r * LDS + col]) =
          *reinterpret_cast<const uint4*>(&g[(size_t)(g0 + r) * D + k0 + col]);
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> a[4];
      // B = g^T: gallery row n holds column n of B, so Bs is B col-major
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::col_major> b[2];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        wmma::load_matrix_sync(a[i], As + (wm * 64 + i * 16) * LDS + kk, LDS);
#pragma unroll
      for (int j = 0; j < 2; ++j)
        wmma::load_matrix_sync(b[j], Bs + (wn * 32 + j * 16) * LDS + kk, LDS);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) wmma::mma_sync(c[i][j], a[i], b[j], c[i][j]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j)
      wmma::store_matrix_sync(Cs + (wm * 64 + i * 16) * LDC + wn * 32 + j * 16,
                              c[i][j], LDC, wmma::mem_row_major);
  __syncthreads();
}

// ---------------------------------------------------------------------------
// K1. Replaces centroids_reid_tpu/ops/retrieval.py::_score_block_kernel (via
// _scores_pallas). At the serving shape (Q = 128, G = 100352, D = 2048) the
// kernel reads the 411 MB bf16 gallery once and writes a 51 MB fp32 score
// matrix against 53 GFLOP, so it is bound by device-memory bandwidth, not
// by the tensor cores. Design: each block owns one 128 x 128 output tile,
// stages 128 x 32 operand slices through shared memory, and writes the
// gn - 2 q.g epilogue with 16-byte stores. Double buffering (cp.async/TMA)
// and wgmma are left for later work.
// ---------------------------------------------------------------------------
__global__ void __launch_bounds__(THREADS)
scores_kernel(const __nv_bfloat16* __restrict__ q,
              const __nv_bfloat16* __restrict__ g,
              const float* __restrict__ gn, float* __restrict__ out, int G,
              int D) {
  extern __shared__ __align__(128) unsigned char smem[];
  __nv_bfloat16* As = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* Bs = As + BM * LDS;
  float* Cs = reinterpret_cast<float*>(smem + kStageBytes);
  const int q0 = blockIdx.y * BM, g0 = blockIdx.x * BN;
  dot_tile(q, g, D, q0, g0, As, Bs, Cs);
  for (int v = threadIdx.x; v < BM * BN / 4; v += THREADS) {
    const int r = v / (BN / 4), col = (v % (BN / 4)) * 4;
    const float4 acc = *reinterpret_cast<const float4*>(&Cs[r * LDC + col]);
    const float4 n = *reinterpret_cast<const float4*>(&gn[g0 + col]);
    float4 o;
    o.x = n.x - 2.0f * acc.x;
    o.y = n.y - 2.0f * acc.y;
    o.z = n.z - 2.0f * acc.z;
    o.w = n.w - 2.0f * acc.w;
    *reinterpret_cast<float4*>(&out[(size_t)(q0 + r) * G + g0 + col]) = o;
  }
}

// ---------------------------------------------------------------------------
// K2. Replaces centroids_reid_tpu/ops/retrieval.py::_retrieval_kernel with
// _merge_topk_packed, _mono16 and _unpack_value (via _topk_pallas(packed=
// True)). The TPU walks the gallery tiles in order and carries the running
// top-k in VMEM; Hopper blocks run in no order, so the gallery is split
// across blocks (pass 1: each block keeps a top-k of its split), and a
// second pass merges the per-split lists.
//
// Order: a 64-bit key (mono16(bf16_rn(score)) << 32 | global column). The
// TPU kernel's key is (mono16 << 16 | buffer column), and its buffer keeps
// the earlier best entries ahead of the tile, so it orders by (bf16 score,
// global column) too; the wider key carries the global column directly.
// The TPU kernel starts from k entries (+inf, column 0) that win every tie
// at +inf; the lists here start from the same keys.
//
// Bound: like K1 it reads the gallery once (411 MB at the serving shape)
// and never writes the score matrix. The merge costs one ballot per 32
// candidates once a row's list is full; a candidate enters only if it
// beats the row's k-th key, which a random gallery rarely does.
// ---------------------------------------------------------------------------
__device__ __forceinline__ u64 make_key(float s, unsigned col) {
  const unsigned bits = __bfloat16_as_ushort(__float2bfloat16_rn(s));
  const unsigned u = (bits & 0x8000u) ? (0xFFFFu - bits) : (bits | 0x8000u);
  return ((u64)u << 32) | col;
}

__device__ __forceinline__ float key_value(u64 key) {
  const unsigned u = (unsigned)(key >> 32);
  const unsigned bits = (u >= 0x8000u) ? (u - 0x8000u) : (0xFFFFu - u);
  return __uint_as_float(bits << 16);
}

// mono16(bf16(+inf)) << 32 | column 0: the TPU kernel's initial entry
constexpr u64 KEY_INIT = (u64)(0x7F80u | 0x8000u) << 32;

// Warp-wide insert of one warp-uniform key into the sorted list held one
// entry per lane (lane i = i-th smallest; lanes >= k hold KEY_MAX).
__device__ __forceinline__ void list_insert(u64& mine, u64& thr, u64 x, int k,
                                            int lane) {
  const int pos = __popc(__ballot_sync(0xffffffffu, mine < x));
  const u64 up = __shfl_up_sync(0xffffffffu, mine, 1);
  if (lane == pos) mine = x;
  else if (lane > pos) mine = up;
  if (lane >= k) mine = KEY_MAX;
  thr = __shfl_sync(0xffffffffu, mine, k - 1);
}

// Offer the 32 keys held one per lane to the list.
__device__ __forceinline__ void list_offer(u64& mine, u64& thr, u64 key, int k,
                                           int lane) {
  unsigned ball = __ballot_sync(0xffffffffu, key < thr);
  while (ball) {
    const int src = __ffs(ball) - 1;
    ball &= ball - 1;
    const u64 x = __shfl_sync(0xffffffffu, key, src);
    if (x < thr) list_insert(mine, thr, x, k, lane);
  }
}

__global__ void __launch_bounds__(THREADS)
stream_topk_partial_kernel(const __nv_bfloat16* __restrict__ q,
                           const __nv_bfloat16* __restrict__ g,
                           const float* __restrict__ gn,
                           u64* __restrict__ part, int G, int D, int k,
                           int split_cols, int n_splits) {
  extern __shared__ __align__(128) unsigned char smem[];
  __nv_bfloat16* As = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* Bs = As + BM * LDS;
  float* Cs = reinterpret_cast<float*>(smem + kStageBytes);
  u64* L = reinterpret_cast<u64*>(smem + kStageBytes + kTileBytes);
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int q0 = blockIdx.y * BM, s = blockIdx.x;
  const int c_begin = s * split_cols;
  const int c_end = min(G, c_begin + split_cols);

  for (int i = threadIdx.x; i < BM * 32; i += THREADS)
    L[i] = (i % 32) < k ? KEY_INIT : KEY_MAX;
  __syncthreads();

  for (int g0 = c_begin; g0 < c_end; g0 += BN) {
    dot_tile(q, g, D, q0, g0, As, Bs, Cs);
    // each warp merges the tile into the lists of its 16 rows
    for (int rr = 0; rr < BM / 8; ++rr) {
      const int r = warp * (BM / 8) + rr;
      u64 mine = L[r * 32 + lane];
      u64 thr = __shfl_sync(0xffffffffu, mine, k - 1);
      for (int c0 = 0; c0 < BN; c0 += 32) {
        const int col = g0 + c0 + lane;
        const float sc = gn[col] - 2.0f * Cs[r * LDC + c0 + lane];
        list_offer(mine, thr, make_key(sc, (unsigned)col), k, lane);
      }
      L[r * 32 + lane] = mine;
    }
    __syncthreads();  // Cs is rewritten by the next tile
  }
  for (int i = threadIdx.x; i < BM * k; i += THREADS) {
    const int r = i / k, j = i % k;
    part[((size_t)(q0 + r) * n_splits + s) * k + j] = L[r * 32 + j];
  }
}

// Pass 2: one warp per query row merges the n_splits * k partial keys.
__global__ void stream_topk_merge_kernel(const u64* __restrict__ part,
                                         float* __restrict__ val,
                                         int64_t* __restrict__ idx, int Q,
                                         int n, int k) {
  const int lane = threadIdx.x % 32;
  const int row = blockIdx.x * (blockDim.x / 32) + threadIdx.x / 32;
  if (row >= Q) return;  // warp-uniform
  const u64* p = part + (size_t)row * n;
  u64 mine = KEY_MAX, thr = KEY_MAX;
  for (int c0 = 0; c0 < n; c0 += 32) {
    const u64 key = (c0 + lane < n) ? p[c0 + lane] : KEY_MAX;
    list_offer(mine, thr, key, k, lane);
  }
  if (lane < k) {
    val[(size_t)row * k + lane] = key_value(mine);
    idx[(size_t)row * k + lane] = (int64_t)(mine & 0xFFFFFFFFull);
  }
}

// ---------------------------------------------------------------------------
// K3. Replaces centroids_reid_tpu/ops/retrieval.py::_vmem_topk_kernel (via
// _vmem_topk): the exact fp32 k smallest of each row, ties to the lowest
// column (lax.top_k's order). The TPU kernel rescans the whole VMEM block
// on each of its k passes. Here one block holds one row (W <= 32768, 128 KB)
// in shared memory; each thread keeps the (min, column) of its own strided
// elements in registers, so a pass is one block-wide reduction and a rescan
// by the single thread that owned the winner. Bound: the k reductions'
// barrier latency, not bandwidth (the row is read from device memory once).
// A taken element becomes NaN, which every comparison skips, so a row with
// fewer than k finite values still returns k distinct columns.
// ---------------------------------------------------------------------------
__device__ __forceinline__ bool before(float v1, int i1, float v2, int i2) {
  return v1 < v2 || (v1 == v2 && i1 < i2);
}

__device__ __forceinline__ void local_min(const float* row, int W, float& bv,
                                          int& bi) {
  bv = __int_as_float(0x7f800000);  // +inf
  bi = 0x7fffffff;
  for (int i = threadIdx.x; i < W; i += blockDim.x) {
    const float v = row[i];
    if (v == v && before(v, i, bv, bi)) {
      bv = v;
      bi = i;
    }
  }
}

__global__ void kpass_topk_kernel(const float* __restrict__ x,
                                  float* __restrict__ val,
                                  int64_t* __restrict__ idx, int W, int k) {
  extern __shared__ __align__(16) float row[];
  __shared__ float red_v[32];
  __shared__ int red_i[32];
  __shared__ int sel_i;
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int nwarps = blockDim.x / 32;
  const float* xr = x + (size_t)blockIdx.x * W;
  for (int i = threadIdx.x; i < W; i += blockDim.x) row[i] = xr[i];
  __syncthreads();
  float bv;
  int bi;
  local_min(row, W, bv, bi);

  for (int p = 0; p < k; ++p) {
    float v = bv;
    int i = bi;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      const float ov = __shfl_down_sync(0xffffffffu, v, off);
      const int oi = __shfl_down_sync(0xffffffffu, i, off);
      if (before(ov, oi, v, i)) {
        v = ov;
        i = oi;
      }
    }
    if (lane == 0) {
      red_v[warp] = v;
      red_i[warp] = i;
    }
    __syncthreads();
    if (warp == 0) {
      v = lane < nwarps ? red_v[lane] : __int_as_float(0x7f800000);
      i = lane < nwarps ? red_i[lane] : 0x7fffffff;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        const float ov = __shfl_down_sync(0xffffffffu, v, off);
        const int oi = __shfl_down_sync(0xffffffffu, i, off);
        if (before(ov, oi, v, i)) {
          v = ov;
          i = oi;
        }
      }
      if (lane == 0) {
        sel_i = i;
        val[(size_t)blockIdx.x * k + p] = v;
        idx[(size_t)blockIdx.x * k + p] = i;
      }
    }
    __syncthreads();
    const int s = sel_i;
    if (s < W && s % blockDim.x == threadIdx.x) {
      row[s] = __int_as_float(0x7fc00000);  // NaN: taken
      local_min(row, W, bv, bi);
    }
  }
}

}  // namespace

extern "C" {

int crt_abi_version() { return 2; }

int crt_scores(const void* q, const void* g, const float* gn, float* out,
               int Q, int G, int D, void* stream) {
  const size_t smem = kStageBytes + kTileBytes;
  cudaError_t e = cudaFuncSetAttribute(
      scores_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  dim3 grid(G / BN, Q / BM);
  scores_kernel<<<grid, THREADS, smem, (cudaStream_t)stream>>>(
      (const __nv_bfloat16*)q, (const __nv_bfloat16*)g, gn, out, G, D);
  return (int)cudaGetLastError();
}

// part: scratch of Q * n_splits * k keys, n_splits = ceil(G / split_cols).
int crt_stream_topk(const void* q, const void* g, const float* gn, void* part,
                    float* val, int64_t* idx, int Q, int G, int D, int k,
                    int split_cols, void* stream) {
  const size_t smem = kStageBytes + kTileBytes + kListBytes;
  cudaError_t e = cudaFuncSetAttribute(stream_topk_partial_kernel,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)smem);
  if (e != cudaSuccess) return (int)e;
  const int n_splits = (G + split_cols - 1) / split_cols;
  dim3 grid(n_splits, Q / BM);
  stream_topk_partial_kernel<<<grid, THREADS, smem, (cudaStream_t)stream>>>(
      (const __nv_bfloat16*)q, (const __nv_bfloat16*)g, gn, (u64*)part, G, D,
      k, split_cols, n_splits);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  stream_topk_merge_kernel<<<(Q + 7) / 8, 256, 0, (cudaStream_t)stream>>>(
      (const u64*)part, val, idx, Q, n_splits * k, k);
  return (int)cudaGetLastError();
}

int crt_kpass_topk(const float* x, float* val, int64_t* idx, int Q, int W,
                   int k, void* stream) {
  const size_t smem = (size_t)W * sizeof(float);
  cudaError_t e = cudaFuncSetAttribute(
      kpass_topk_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return (int)e;
  int threads = W >= 1024 ? 1024 : ((W + 31) / 32) * 32;
  kpass_topk_kernel<<<Q, threads, smem, (cudaStream_t)stream>>>(x, val, idx,
                                                                 W, k);
  return (int)cudaGetLastError();
}

}  // extern "C"
