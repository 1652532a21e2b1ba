// The streaming evaluator's distance-and-rank kernel for Hopper (sm_90a):
//
//   K7 crt_stream_extract  each hit's distance, read out of its score tile
//   K7 crt_stream_count    for each kept gallery row that falls under a
//                          query's farthest hit, the number of the query's
//                          hits it precedes, as a histogram
//
// It replaces no TPU kernel: the JAX package's streaming evaluator
// (centroids_reid_tpu/metrics/streaming_eval.py) is plain jnp. It was
// added because the port's two passes ran each [128, 8192] score tile
// through cuBLAS and then ranked with a chain of eager operators over
// padded int64 keys, three quarters of the card's time in an evaluation.
//
// Bound: fp32 FLOPs. A pass over Q queries and G gallery rows of D floats
// is 2 Q G D FLOP on the CUDA cores (no TF32, no tensor cores: the
// evaluation is exact fp32), 7.1 TFLOP at Market-1501 + 500k distractors,
// 106 ms at 67 TFLOP/s; its bytes (the gallery once, 4.2 GB, the queries
// from L2) take 1.3 ms.
//
// Design. One GEMM core, classic SIMT: a block computes a 64 x 256 tile
// of query x gallery dot products, 128 threads of 8 x 16 outputs each
// (thread (ty, tx) owns query rows ty + 8 i and gallery rows tx + 16 j, so
// that the lanes of a quarter warp read eight consecutive shared-memory
// rows: conflict free with rows of BK + 4 floats), 255 registers and two
// blocks an SM. K slices of BK floats arrive by cp.async in a ring of
// STAGES stages, rows past Q or G and columns past D zero-filled. Each
// output element is one thread's chain of FFMAs over k = 0 .. D - 1 in
// order, with no split of K, so a (query, row) pair gets the same bits in
// both launches, whatever its tile: a hit's distance in the count is the
// one the extract wrote. The grid is one dimension, query tiles fastest,
// so the query tiles that share a gallery tile run together and read it
// from L2. Measured at the cell's shape on an H100 (700 W, SM clock 1,980
// MHz): 128 x 128 tiles of 8 x 8 outputs a thread ran 37.5 TFLOP/s, these
// 41.9, about cuBLAS's fp32 GEMM; the K depth (8-32), the ring (2-4
// stages), 1 or 2 blocks an SM and the FFMA order within a k slice moved
// it by under 1 TFLOP/s, or down.
//
// The distance, from the norms made once per evaluation: euclidean
// (qn + gn) - 2 acc from squared norms, as losses/distances.py's squared_
// euclidean_dist; cosine |1 - (acc qn) gn| clamped to 1e-12 from inverse
// norms, so no normalised copy of the rows is needed.
//
// The epilogue is a few operations an element against 2 D FLOP:
//   extract: a row of the query's pid goes, unless it is junk (same pid
//     and camera), to a binary search of its index in the query's hits
//     (ascending), and its distance is stored in that slot;
//   count: a row whose (distance, index) is not below the query's farthest
//     hit precedes no hit (one compare, almost every row). Any other kept
//     row's key is searched among the query's sorted hit keys: p = the
//     number of hit keys <= its key, and hist[q, p] += 1 (a warp-aggregated
//     atomic). The wrapper's inclusive prefix sum over p gives each hit
//     the number of kept rows before it; a hit's own key is not below
//     itself, so it never counts itself.
//
// Plain C interface, loaded with ctypes (ops/_build.py). Every entry point
// launches on the stream it is given, allocates nothing, and returns
// cudaGetLastError() (or the error of a step before the launch).
//
// Shape contract (checked by ops/stream_rank.py): q [Q, D] and g [G, D]
// fp32 row-major, D % 4 == 0, 16-byte aligned; qn [Q], gn [G] fp32
// (squared norms, or inverse norms for cosine); pids and cameras int64;
// hits [Q, H] int64 (extract: the hits' gallery indices, ascending,
// num_rel[q] of them; count: their order keys, ascending), num_rel [Q]
// int32; dpos [Q, H] fp32 and hist [Q, H] int32, zeroed by the wrapper;
// j0 the global index of g's row 0.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

typedef long long i64;

constexpr int BM = 64;         // query rows per tile
constexpr int BN = 256;        // gallery rows per tile
constexpr int TM = 8;          // query rows per thread
constexpr int TN = 16;         // gallery rows per thread
constexpr int TY = BM / TM;    // threads along the queries
constexpr int TX = BN / TN;    // threads along the gallery
constexpr int THREADS = TX * TY;
constexpr int MINB = 2;        // blocks per SM the registers allow
constexpr int BK = 16;         // depth per stage
constexpr int STAGES = 3;      // cp.async ring
constexpr int LDS = BK + 4;    // floats per shared-memory row
constexpr int kStageFloats = (BM + BN) * LDS;
constexpr int kSmemBytes = STAGES * kStageFloats * 4;
static_assert(BM * BK % (4 * THREADS) == 0 && BN * BK % (4 * THREADS) == 0,
              "whole 16-byte chunks per thread");
static_assert(TX % 8 == 0, "a quarter warp reads eight gallery rows");

enum Mode { kExtract = 0, kCount = 1 };

struct Params {
  const float* q;
  const float* g;
  const float* qn;
  const float* gn;
  const i64* q_pids;
  const i64* g_pids;
  const i64* q_cams;
  const i64* g_cams;
  const i64* hits;
  const int* num_rel;
  float* dpos;
  int* hist;
  int Q, G, D, H, j0, m_tiles;
};

__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           bool valid) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Depth k0 .. k0 + BK of the ROWS rows of x from r0 (rows past n and
// columns past D zero-filled), as 16-byte chunks: a warp reads eight rows'
// 64 contiguous bytes each.
template <int ROWS>
__device__ __forceinline__ void load_rows(float* st, const float* x, int r0,
                                          int n, int D, int k0) {
  constexpr int CH = BK / 4;
#pragma unroll
  for (int t = 0; t < ROWS * CH / THREADS; ++t) {
    const int idx = threadIdx.x + t * THREADS;
    const int r = idx / CH, c = idx % CH;
    const int k = k0 + 4 * c;
    const bool v = k < D && r0 + r < n;
    cp_async16(st + r * LDS + 4 * c, v ? x + (size_t)(r0 + r) * D + k : x,
               v);
  }
}

// One ring stage: the query tile's rows, then the gallery tile's.
__device__ __forceinline__ void load_stage(float* st, const Params& p, int m0,
                                           int n0, int k0) {
  load_rows<BM>(st, p.q, m0, p.Q, p.D, k0);
  load_rows<BN>(st + BM * LDS, p.g, n0, p.G, p.D, k0);
}

template <bool COSINE>
__device__ __forceinline__ float distance(float acc, float qn, float gn) {
  if (COSINE)
    return fmaxf(fabsf(__fsub_rn(1.0f, __fmul_rn(__fmul_rn(acc, qn), gn))),
                 1e-12f);
  return __fsub_rn(__fadd_rn(qn, gn), __fmul_rn(2.0f, acc));
}

// The int64 key ordered as (d, j): -0.0 folded to +0.0, the float's bits
// made monotone, j below (ops/stream_rank.py::order_key).
__device__ __forceinline__ i64 order_key(float d, int j) {
  int bits = __float_as_int(d);
  if (bits == (int)0x80000000) bits = 0;
  const int mono = bits < 0 ? bits ^ 0x7FFFFFFF : bits;
  return (i64)mono * 4294967296LL + j;
}

// Row col of the gallery is junk for query q: same pid and same camera
// (camera bit set under `respect`, the centroid protocol's bitmasks).
template <bool RESPECT>
__device__ __forceinline__ bool junk(const Params& p, int q, int col) {
  if (p.q_pids[q] != p.g_pids[col]) return false;
  const i64 qc = p.q_cams[q], gc = p.g_cams[col];
  return RESPECT ? ((gc >> qc) & 1) != 0 : gc == qc;
}

template <bool RESPECT>
__device__ __noinline__ void extract_hit(const Params& p, int q, int col,
                                         float d) {
  if (junk<RESPECT>(p, q, col)) return;
  const i64 jg = p.j0 + col;
  const i64* pos = p.hits + (size_t)q * p.H;
  const int n = p.num_rel[q];
  int lo = 0, hi = n;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (pos[mid] < jg) lo = mid + 1;
    else hi = mid;
  }
  if (lo < n && pos[lo] == jg) p.dpos[(size_t)q * p.H + lo] = d;
}

template <bool RESPECT>
__device__ __noinline__ void count_row(const Params& p, int q, int col,
                                       float d) {
  if (junk<RESPECT>(p, q, col)) return;
  const i64 key = order_key(d, p.j0 + col);
  const i64* keys = p.hits + (size_t)q * p.H;
  int lo = 0, hi = p.num_rel[q];
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (keys[mid] <= key) lo = mid + 1;
    else hi = mid;
  }
  int* slot = p.hist + (size_t)q * p.H + lo;
  // the lanes here together that add to one slot add once
  const unsigned peers =
      __match_any_sync(__activemask(), (unsigned long long)slot);
  if ((int)(threadIdx.x & 31) == __ffs(peers) - 1)
    atomicAdd(slot, __popc(peers));
}

template <int MODE, bool COSINE, bool RESPECT>
__global__ void __launch_bounds__(THREADS, MINB)
    stream_rank_kernel(const __grid_constant__ Params p) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int m0 = (blockIdx.x % p.m_tiles) * BM;
  const int n0 = (blockIdx.x / p.m_tiles) * BN;
  const int tx = threadIdx.x % TX, ty = threadIdx.x / TX;
  const int kt_n = (p.D + BK - 1) / BK;

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.0f;

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < kt_n) load_stage(smem + s * kStageFloats, p, m0, n0, s * BK);
    cp_async_commit();
  }
  for (int kt = 0; kt < kt_n; ++kt) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();
    const int nk = kt + STAGES - 1;
    if (nk < kt_n)
      load_stage(smem + (nk % STAGES) * kStageFloats, p, m0, n0, nk * BK);
    cp_async_commit();
    const float* as = smem + (kt % STAGES) * kStageFloats;
    const float* bs = as + BM * LDS;
#pragma unroll
    for (int kk = 0; kk < BK; kk += 4) {
      float4 a[TM];
#pragma unroll
      for (int i = 0; i < TM; ++i)
        a[i] =
            *reinterpret_cast<const float4*>(as + (ty + TY * i) * LDS + kk);
#pragma unroll
      for (int j = 0; j < TN; ++j) {
        const float4 b =
            *reinterpret_cast<const float4*>(bs + (tx + TX * j) * LDS + kk);
#pragma unroll
        for (int i = 0; i < TM; ++i) {
          acc[i][j] = fmaf(a[i].x, b.x, acc[i][j]);
          acc[i][j] = fmaf(a[i].y, b.y, acc[i][j]);
          acc[i][j] = fmaf(a[i].z, b.z, acc[i][j]);
          acc[i][j] = fmaf(a[i].w, b.w, acc[i][j]);
        }
      }
    }
  }
  cp_async_wait<0>();

  float qn[TM], gn[TN];
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int q = m0 + ty + TY * i;
    qn[i] = q < p.Q ? p.qn[q] : 0.0f;
  }
#pragma unroll
  for (int j = 0; j < TN; ++j) {
    const int col = n0 + tx + TX * j;
    gn[j] = col < p.G ? p.gn[col] : 0.0f;
  }

  if (MODE == kExtract) {
    i64 qp[TM], gp[TN];
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      const int q = m0 + ty + TY * i;
      qp[i] = q < p.Q ? p.q_pids[q] : 0;
    }
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int col = n0 + tx + TX * j;
      gp[j] = col < p.G ? p.g_pids[col] : 0;
    }
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      const int q = m0 + ty + TY * i;
#pragma unroll
      for (int j = 0; j < TN; ++j) {
        const int col = n0 + tx + TX * j;
        if (qp[i] == gp[j] && q < p.Q && col < p.G)
          extract_hit<RESPECT>(p, q, col,
                               distance<COSINE>(acc[i][j], qn[i], gn[j]));
      }
    }
  } else {
    // each query's farthest hit as (distance, index); -inf where the query
    // has none (or is past Q), so that no row falls under it
    float fd[TM];
    int fj[TM];
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      const int q = m0 + ty + TY * i;
      fd[i] = -INFINITY;
      fj[i] = 0;
      const int n = q < p.Q ? p.num_rel[q] : 0;
      if (n > 0) {
        const i64 key = p.hits[(size_t)q * p.H + n - 1];
        const int mono = (int)(key >> 32);
        fd[i] = __int_as_float(mono < 0 ? mono ^ 0x7FFFFFFF : mono);
        fj[i] = (int)(key & 0xFFFFFFFFLL);
      }
    }
#pragma unroll
    for (int i = 0; i < TM; ++i) {
#pragma unroll
      for (int j = 0; j < TN; ++j) {
        const int col = n0 + tx + TX * j;
        const float d = distance<COSINE>(acc[i][j], qn[i], gn[j]);
        if ((d < fd[i] || (d == fd[i] && p.j0 + col < fj[i])) && col < p.G)
          count_row<RESPECT>(p, m0 + ty + TY * i, col, d);
      }
    }
  }
}

template <int MODE, bool COSINE, bool RESPECT>
int launch(const Params& p, cudaStream_t stream) {
  const i64 blocks = (i64)p.m_tiles * ((p.G + BN - 1) / BN);
  if (blocks == 0) return 0;
  if (blocks > 0x7FFFFFFFLL) return (int)cudaErrorInvalidValue;
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= 64)
    return (int)cudaErrorInvalidDevice;
  static bool smem_set[64] = {};   // the attribute, once per device
  if (!smem_set[dev]) {
    const cudaError_t e = cudaFuncSetAttribute(
        stream_rank_kernel<MODE, COSINE, RESPECT>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
    if (e != cudaSuccess) return (int)e;
    smem_set[dev] = true;
  }
  stream_rank_kernel<MODE, COSINE, RESPECT>
      <<<(unsigned)blocks, THREADS, kSmemBytes, stream>>>(p);
  return (int)cudaGetLastError();
}

template <int MODE>
int dispatch(const Params& p, int cosine, int respect, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (cosine)
    return respect ? launch<MODE, true, true>(p, s)
                   : launch<MODE, true, false>(p, s);
  return respect ? launch<MODE, false, true>(p, s)
                 : launch<MODE, false, false>(p, s);
}

Params params(const float* q, const float* g, const float* qn,
              const float* gn, const i64* q_pids, const i64* g_pids,
              const i64* q_cams, const i64* g_cams, const i64* hits,
              const int* num_rel, int Q, int G, int D, int H, int j0) {
  Params p = {};
  p.q = q;
  p.g = g;
  p.qn = qn;
  p.gn = gn;
  p.q_pids = q_pids;
  p.g_pids = g_pids;
  p.q_cams = q_cams;
  p.g_cams = g_cams;
  p.hits = hits;
  p.num_rel = num_rel;
  p.Q = Q;
  p.G = G;
  p.D = D;
  p.H = H;
  p.j0 = j0;
  p.m_tiles = (Q + BM - 1) / BM;
  return p;
}

}  // namespace

extern "C" {

// pos [Q, H]: each query's hits by ascending gallery index; dpos [Q, H]
// zeroed: each hit in g's rows gets its distance.
int crt_stream_extract(const float* q, const float* g, const float* qn,
                       const float* gn, const i64* q_pids, const i64* g_pids,
                       const i64* q_cams, const i64* g_cams, const i64* pos,
                       const int* num_rel, float* dpos, int Q, int G, int D,
                       int H, int j0, int cosine, int respect, void* stream) {
  if (D % 4 != 0 || Q < 0 || G < 0 || H < 1) return (int)cudaErrorInvalidValue;
  Params p = params(q, g, qn, gn, q_pids, g_pids, q_cams, g_cams, pos,
                    num_rel, Q, G, D, H, j0);
  p.dpos = dpos;
  return dispatch<kExtract>(p, cosine, respect, stream);
}

// keys [Q, H]: each query's hit keys, ascending; hist [Q, H] zeroed: the
// kept rows of g under each query's farthest hit, by the number of hit
// keys at or below their own.
int crt_stream_count(const float* q, const float* g, const float* qn,
                     const float* gn, const i64* q_pids, const i64* g_pids,
                     const i64* q_cams, const i64* g_cams, const i64* keys,
                     const int* num_rel, int* hist, int Q, int G, int D,
                     int H, int j0, int cosine, int respect, void* stream) {
  if (D % 4 != 0 || Q < 0 || G < 0 || H < 1) return (int)cudaErrorInvalidValue;
  Params p = params(q, g, qn, gn, q_pids, g_pids, q_cams, g_cams, keys,
                    num_rel, Q, G, D, H, j0);
  p.hist = hist;
  return dispatch<kCount>(p, cosine, respect, stream);
}

}  // extern "C"
