// Retrieval kernels for Hopper (sm_90a): the kernels that carry the serving
// path's top-k selection against a device-resident gallery.
//
//   K1 crt_scores          scores = gn - 2 q.g^T             (bf16 in, fp32 out)
//   K2 crt_stream_topk     streaming top-k at bf16 key resolution, k <= 32,
//                          never materialises the Q x G score matrix
//   K2u crt_stream_topk_unpacked  the same selection by exact fp32 score
//   K3 crt_kpass_topk      exact fp32 k smallest of each row: a radix
//                          select on the row in shared memory
//
// Plain C interface, loaded with ctypes (ops/_build.py). Every entry point
// launches on the stream it is given, allocates nothing, and returns
// cudaGetLastError() (or the error of a step before the launch) so the
// Python wrapper can raise on a refused launch.
//
// Shape contract (checked by the wrappers in ops/retrieval.py): q [Q, D] and
// g [G, D] row-major bf16, Q % 128 == 0, G % 128 == 0, D % 32 == 0, 16-byte
// aligned; gn [G] fp32 with +inf on gallery pad rows, so a pad row never wins.
//
// K1 and K2 share one mainloop (produce / mma_tile below). One producer
// thread issues TMA loads of 64-deep q and g slices into a ring of
// shared-memory stages (completion on mbarriers); two consumer warpgroups
// run wgmma on the stages that have arrived and release each stage through
// its empty barrier (K2 adds a selector warpgroup, see there). Registers
// and shared memory per block, from ptxas and the sizes below: K1 168
// registers at 288 threads, 197,696 B; K2's pass 1 128 registers at 512
// threads, 199,760 B; so one block per SM. The gallery rows are wgmma's M side
// (64 per warpgroup, 128 per tile), the 128 query rows its N side; both
// operands are K-major, as they lie in memory, in 128-byte swizzled rows.
// TMA zero-fills boxes past D, so a ragged last stage (D = 32, 96, ...) adds
// zeros to the dot products and needs no masking. One block per SM walks
// its share of the tiles (persistent), so no partial wave is left over.
// The tensor maps are encoded on the host at each call; the encoder comes
// from cudaGetDriverEntryPoint, so the library needs no link to libcuda.
// The TMA, mbarrier, descriptor and wgmma helpers live in hopper.cuh,
// shared with K4 (retrieval_int8.cu); the kernels are each source's own.

#include "hopper.cuh"

namespace {

constexpr int TILE_G = 128;    // gallery rows per tile (wgmma M, 64 per warpgroup)
constexpr int TILE_Q = 128;    // query rows per tile (wgmma N)
constexpr int BK = 64;         // depth per ring stage: 128-byte bf16 rows
constexpr int STAGES = 4;      // ring depth
constexpr int CONSUMERS = 2;   // consumer (MMA) warpgroups
constexpr int THREADS = CONSUMERS * 128 + 32;   // K1: + one producer warp
constexpr unsigned kStageBytes = (TILE_Q + TILE_G) * BK * 2;   // 32 KB
constexpr unsigned kRingBytes = STAGES * kStageBytes;
constexpr unsigned kBarBytes = 2 * STAGES * 8;
constexpr u64 KEY_MAX = ~0ull;

// ------------------------------------------------------------- mainloop --

// Tile t covers gallery rows (t % n_gt) * 128 and query rows (t / n_gt) *
// 128. The producer fills the ring for tiles t_begin, t_begin + t_step, ...
// < t_end, nk stages each, in the order the consumers take them.
__device__ __forceinline__ void produce(const CUtensorMap* qmap,
                                        const CUtensorMap* gmap,
                                        unsigned char* ring, u64* full,
                                        u64* empty, int t_begin, int t_end,
                                        int t_step, int n_gt, int nk) {
  int it = 0;
  for (int t = t_begin; t < t_end; t += t_step) {
    const int g0 = (t % n_gt) * TILE_G, q0 = (t / n_gt) * TILE_Q;
    for (int ks = 0; ks < nk; ++ks, ++it) {
      const int s = it % STAGES;
      mbar_wait(&empty[s], ((it / STAGES) & 1) ^ 1);
      unsigned char* st = ring + s * kStageBytes;
      mbar_expect_tx(&full[s], kStageBytes);
      tma_load(st, qmap, &full[s], ks * BK, q0);
      tma_load(st + TILE_Q * BK * 2, gmap, &full[s], ks * BK, g0);
    }
  }
}

// One tile's product for consumer warpgroup wg: d = g[64 rows of wg] .
// q[128]^T over the full depth, stage by stage as the ring fills; each
// warp releases a stage once its wgmma group on it has completed.
__device__ __forceinline__ void mma_tile(float (&d)[64],
                                         const unsigned char* ring, u64* full,
                                         u64* empty, int& it, int nk,
                                         int wg) {
  for (int ks = 0; ks < nk; ++ks, ++it) {
    const int s = it % STAGES;
    mbar_wait(&full[s], (it / STAGES) & 1);
    __syncwarp();   // wgmma is .aligned: the warp issues it converged
    const unsigned char* st = ring + s * kStageBytes;
    const u64 db = sw128_desc(st);
    const u64 da = sw128_desc(st + TILE_Q * BK * 2 + wg * 64 * BK * 2);
    fence_operands(d);
    asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk)
      wgmma_m64n128k16(d, da + 2 * kk, db + 2 * kk, ks > 0 || kk > 0);
    asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
    asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
    fence_operands(d);
    if (threadIdx.x % 32 == 0) mbar_arrive(&empty[s]);
  }
}

__device__ __forceinline__ void init_ring_barriers(u64* full, u64* empty) {
  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], CONSUMERS * 4);   // one arrival per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
}

// ---------------------------------------------------------------------------
// K1. Replaces centroids_reid_tpu/ops/retrieval.py::_score_block_kernel (via
// _scores_pallas). At the serving shape (Q = 128, G = 100352, D = 2048) it
// reads the 411 MB bf16 gallery once and writes a 51 MB fp32 score matrix
// against 53 GFLOP: device-memory bandwidth bounds it, not the tensor
// cores. Design: the shared TMA ring + wgmma mainloop keeps loads in flight
// under the products; one persistent block per SM walks the 128 x 128
// output tiles (stride gridDim.x); the epilogue forms gn - 2 acc from the
// registers, stages each warpgroup's 128 x 64 fp32 half-tile in shared
// memory (128-byte swizzle, no bank conflicts) and writes it with TMA
// stores, which drain while the next tile's loads and products run.
// ---------------------------------------------------------------------------
constexpr unsigned kScoreStageBytes = CONSUMERS * 2 * TILE_Q * 32 * 4;
constexpr unsigned kScoresSmem = kRingBytes + kScoreStageBytes + kBarBytes + 1024;

__global__ void __launch_bounds__(THREADS, 1)
scores_kernel(const __grid_constant__ CUtensorMap qmap,
              const __grid_constant__ CUtensorMap gmap,
              const __grid_constant__ CUtensorMap omap,
              const float* __restrict__ gn, int G, int Q, int D) {
  unsigned char* smem = smem_base();
  unsigned char* ring = smem;
  float* staging = reinterpret_cast<float*>(smem + kRingBytes);
  u64* full = reinterpret_cast<u64*>(smem + kRingBytes + kScoreStageBytes);
  u64* empty = full + STAGES;
  const int n_gt = G / TILE_G, n_tiles = n_gt * (Q / TILE_Q);
  const int nk = (D + BK - 1) / BK;
  init_ring_barriers(full, empty);
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == CONSUMERS) {
    if (threadIdx.x == CONSUMERS * 128)
      produce(&qmap, &gmap, ring, full, empty, blockIdx.x, n_tiles,
              gridDim.x, n_gt, nk);
    return;
  }
  const int tw = threadIdx.x % 128, w = tw / 32, lane = threadIdx.x % 32;
  // this warpgroup's two 32-column chunks [128 query rows][32 fp32]
  float* S = staging + wg * 2 * TILE_Q * 32;
  float d[64] = {};
  int it = 0;
  for (int t = blockIdx.x; t < n_tiles; t += gridDim.x) {
    const int g0 = (t % n_gt) * TILE_G, q0 = (t / n_gt) * TILE_Q;
    mma_tile(d, ring, full, empty, it, nk, wg);
    const int gl = 16 * w + (lane >> 2);   // + 8 for v >= 2
    const float gn0 = gn[g0 + wg * 64 + gl], gn1 = gn[g0 + wg * 64 + gl + 8];
    float* chunk = S + (w >> 1) * TILE_Q * 32;   // 16 rows of a warp: one chunk
    if (tw == 0) bulk_wait_read();   // the previous tile's stores have read S
    wg_sync(1 + wg);
#pragma unroll
    for (int j = 0; j < 16; ++j)
#pragma unroll
      for (int v = 0; v < 4; ++v) {
        const int qr = 8 * j + 2 * (lane & 3) + (v & 1);
        const int gc = (gl + 8 * (v >> 1)) & 31;
        chunk[qr * 32 + ((((gc >> 2) ^ (qr & 7)) << 2) | (gc & 3))] =
            ((v >> 1) ? gn1 : gn0) - 2.0f * d[4 * j + v];
      }
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
    wg_sync(1 + wg);
    if (tw == 0) {
      tma_store(&omap, S, g0 + wg * 64, q0);
      tma_store(&omap, S + TILE_Q * 32, g0 + wg * 64 + 32, q0);
      bulk_commit();
    }
  }
  if (tw == 0) bulk_wait();
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
// at +inf; the lists here start from the same keys. Since every key holds
// its global column, the k smallest keys are the same whatever order the
// blocks visit the tiles in, so the result is bit-identical to the plain
// version's sort.
//
// K2u. Replaces the same _retrieval_kernel with _merge_topk (via
// _topk_pallas(packed=False)): the TPU kernel selects by the exact fp32
// score with jnp.min / argmin over [best entries | tile], i.e. by (fp32
// score, global column). The same two passes run on the key
// (mono32(score) << 32 | global column): mono32 is the order-preserving
// map of the fp32 bits, with -0.0 folded to +0.0 (min/argmin treat them as
// equal, so the column decides), and key_value inverts it exactly. Only
// the key functions differ (template parameter kPacked).
//
// Bound: like K1 it reads the gallery once (411 MB at the serving shape)
// and never writes the score matrix. Design: the shared TMA + wgmma
// mainloop; grid = (splits, query tiles) with splits x query tiles <= the
// SM count, each block walking an even share of the gallery tiles (one
// wave, no tail). Selection runs on its own warpgroup, beside the two MMA
// warpgroups: after each tile an MMA thread forms gn - 2 acc from its
// registers and stores its 64 scores at fixed slots of a shared exchange
// tile, signals the selector (mbarrier) and goes on with the next tile's
// products. On this card any pause of the MMA warpgroups between tiles
// costs far more than its instructions: every block pauses at the same
// moment, device memory idles, and each restart waits out the loaded
// memory latency, so a per-tile filter of a few hundred instructions in
// the MMA warpgroups costs many times its own run time. Each selector
// thread owns one query row: one float compare rejects every score above
// its list's limit; the rest build their key and enter a sorted list of
// K >= k keys held in its
// registers, one candidate per round for all 32 rows of a warp at once, so
// a warp pays for its busiest row and not for the union of its rows. The
// list ends as the block's partial list of its row; pass 2 merges the
// splits' lists.
// ---------------------------------------------------------------------------
template <bool kPacked>
__device__ __forceinline__ u64 make_key(float s, unsigned col) {
  if constexpr (kPacked) {
    const unsigned bits = __bfloat16_as_ushort(__float2bfloat16_rn(s));
    const unsigned u = (bits & 0x8000u) ? (0xFFFFu - bits) : (bits | 0x8000u);
    return ((u64)u << 32) | col;
  }
  unsigned bits = __float_as_uint(s);
  if (bits == 0x80000000u) bits = 0u;  // -0.0 orders as +0.0
  const unsigned u = (bits & 0x80000000u) ? ~bits : (bits | 0x80000000u);
  return ((u64)u << 32) | col;
}

template <bool kPacked>
__device__ __forceinline__ float key_value(u64 key) {
  const unsigned u = (unsigned)(key >> 32);
  if constexpr (kPacked) {
    const unsigned bits = (u >= 0x8000u) ? (u - 0x8000u) : (0xFFFFu - u);
    return __uint_as_float(bits << 16);
  }
  return __uint_as_float((u & 0x80000000u) ? (u & 0x7FFFFFFFu) : ~u);
}

// mono(+inf) << 32 | column 0: the TPU kernel's initial entry
template <bool kPacked>
struct KeyInit {
  static constexpr u64 value =
      kPacked ? (u64)(0x7F80u | 0x8000u) << 32
              : (u64)(0x7F800000u | 0x80000000u) << 32;
};

// K2's block: two MMA warpgroups (the ring's consumers), a selector
// warpgroup and a producer warpgroup (one thread issues the TMA loads).
constexpr int STREAM_THREADS = (CONSUMERS + 2) * 128;
constexpr int SELECTOR = CONSUMERS, PRODUCER = CONSUMERS + 1;   // warpgroups
// The tile of scores handed from the MMA warpgroups to the selector,
// [128 slots][LDX query rows] fp32: slot 64 wg + 16 w + 2 (lane / 4) + e
// holds gallery row 64 wg + 16 w + lane / 4 + 8 e of the tile. The row
// pitch of 132 floats keeps the stores at two-way bank conflicts and the
// selector's loads conflict-free.
constexpr int LDX = TILE_Q + 4;
constexpr unsigned kExchangeBytes = TILE_G * LDX * 4;
constexpr unsigned kStreamSmem =
    kRingBytes + kExchangeBytes + kBarBytes + 2 * 8 + 1024;
static_assert(kStreamSmem <= 232448, "K2 exceeds the shared memory of a block");

// Insert x into a sorted list of K keys held in registers; the largest
// falls out, and x = KEY_MAX leaves the list as it is. Every entry is
// chosen independently from its neighbours (no chain through x), and the
// indices are compile-time, so the list never leaves registers.
template <int K>
__device__ __forceinline__ void reg_insert(u64 (&lst)[K], u64 x) {
  bool below[K];   // a prefix of trues: the entries that stay in place
#pragma unroll
  for (int j = 0; j < K; ++j) below[j] = lst[j] < x;
#pragma unroll
  for (int j = K - 1; j > 0; --j)
    lst[j] = below[j] ? lst[j] : (below[j - 1] ? x : lst[j - 1]);
  lst[0] = below[0] ? lst[0] : x;
}

// The largest score whose key could still fall below key thr: for K2 the
// bf16 value one step above thr's (any score that rounds to thr's value or
// below lies under it), for K2u thr's fp32 value itself. A score above it
// cannot enter the list, so most scores are rejected by one float compare.
template <bool kPacked>
__device__ __forceinline__ float score_limit(u64 thr) {
  if constexpr (kPacked) {
    const u64 u = thr >> 32;   // mono16 of thr's bf16 value
    return key_value<true>((u < 0xFF80u ? u + 1 : 0xFF80u) << 32);
  }
  return key_value<false>(thr);
}

// K: list length, 12 (k <= 12, as the serving path's k = 10) or 32. A
// list keeps the K smallest keys of its row's candidates; its first k are
// the k smallest.
template <bool kPacked, int K>
__global__ void __launch_bounds__(STREAM_THREADS, 1)
stream_topk_partial_kernel(const __grid_constant__ CUtensorMap qmap,
                           const __grid_constant__ CUtensorMap gmap,
                           const float* __restrict__ gn,
                           u64* __restrict__ part, int G, int D, int k,
                           int n_splits) {
  unsigned char* smem = smem_base();
  unsigned char* ring = smem;
  float* X = reinterpret_cast<float*>(smem + kRingBytes);   // [slot][row]
  u64* full = reinterpret_cast<u64*>(smem + kRingBytes + kExchangeBytes);
  u64* empty = full + STAGES;
  u64* xfull = empty + STAGES;   // X holds a tile's scores
  u64* xempty = xfull + 1;       // the selector has read them
  const int n_gt = G / TILE_G, split = blockIdx.x, qt = blockIdx.y;
  const int nk = (D + BK - 1) / BK;
  // an even share of the gallery tiles: [s n_gt / n, (s + 1) n_gt / n)
  const int t_begin = qt * n_gt + (int)((long long)split * n_gt / n_splits);
  const int t_end = qt * n_gt + (int)((long long)(split + 1) * n_gt / n_splits);
  init_ring_barriers(full, empty);
  if (threadIdx.x == 0) {
    mbar_init(xfull, CONSUMERS * 128);
    mbar_init(xempty, 128);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / 128, tw = threadIdx.x % 128;
  if (wg == PRODUCER) {
    if (tw == 0)
      produce(&qmap, &gmap, ring, full, empty, t_begin, t_end, 1, n_gt, nk);
    return;
  }
  if (wg == SELECTOR) {
    // thread tw owns query row tw: one float compare rejects a score that
    // cannot enter its list; the rest build their key
    u64 lst[K];
#pragma unroll
    for (int j = 0; j < K; ++j) lst[j] = KeyInit<kPacked>::value;
    for (int t = t_begin, u = 0; t < t_end; ++t, ++u) {
      mbar_wait(xfull, u & 1);
      const int g0 = (t % n_gt) * TILE_G;
      // the slots whose score passes the limit at the start of the tile
      const float lim = score_limit<kPacked>(lst[K - 1]);
      unsigned m[TILE_G / 32];
#pragma unroll
      for (int wi = 0; wi < TILE_G / 32; ++wi) {
        m[wi] = 0;
#pragma unroll
        for (int b = 0; b < 32; ++b)
          m[wi] |= (unsigned)(X[(32 * wi + b) * LDX + tw] <= lim) << b;
      }
      // insert them one per round, every lane at once (a lane with none
      // left, or whose candidate no longer beats its list, inserts
      // KEY_MAX), so a warp runs as many rounds as its busiest row has
      // candidates; a round in which no lane inserts skips the insert
      while (__any_sync(0xffffffffu, (m[0] | m[1] | m[2] | m[3]) != 0)) {
        u64 x = KEY_MAX;
        const int wi = m[0] ? 0 : m[1] ? 1 : m[2] ? 2 : m[3] ? 3 : -1;
        if (wi >= 0) {
          const unsigned word = wi == 0 ? m[0] : wi == 1 ? m[1]
                                : wi == 2 ? m[2] : m[3];
          const int slot = 32 * wi + __ffs(word) - 1;
          const unsigned rest = word & (word - 1);
          if (wi == 0) m[0] = rest;
          else if (wi == 1) m[1] = rest;
          else if (wi == 2) m[2] = rest;
          else m[3] = rest;
          const unsigned col = g0 + 16 * (slot >> 4) + ((slot & 15) >> 1) +
                               8 * (slot & 1);
          const u64 key = make_key<kPacked>(X[slot * LDX + tw], col);
          if (key < lst[K - 1]) x = key;
        }
        if (__any_sync(0xffffffffu, x != KEY_MAX)) reg_insert(lst, x);
      }
      mbar_arrive(xempty);
    }
    u64* out = part + ((size_t)(qt * TILE_Q + tw) * n_splits + split) * k;
#pragma unroll
    for (int j = 0; j < K; ++j)
      if (j < k) out[j] = lst[j];
    return;
  }
  // an MMA warpgroup: the product of its 64 gallery rows of each tile, then
  // the scores gn - 2 acc into X for the selector
  const int w = tw / 32, lane = threadIdx.x % 32;
  float d[64] = {};
  int it = 0;
  for (int t = t_begin, u = 0; t < t_end; ++t, ++u) {
    mma_tile(d, ring, full, empty, it, nk, wg);
    const int gr = wg * 64 + 16 * w + (lane >> 2);   // and gr + 8
    const float gn0 = gn[(t % n_gt) * TILE_G + gr];
    const float gn1 = gn[(t % n_gt) * TILE_G + gr + 8];
    mbar_wait(xempty, (u & 1) ^ 1);
    float* Xw = X + (wg * 64 + 16 * w + 2 * (lane >> 2)) * LDX + 2 * (lane & 3);
#pragma unroll
    for (int i = 0; i < 64; ++i)
      Xw[((i >> 1) & 1) * LDX + 8 * (i >> 2) + (i & 1)] =
          (((i >> 1) & 1) ? gn1 : gn0) - 2.0f * d[i];
    mbar_arrive(xfull);
  }
}

// Pass 2: one block per query row merges the n_splits sorted partial lists
// by tournament. Thread s holds the head of split s's list; each of k
// rounds takes the block-wide smallest (key, split) and advances that
// split's head: k rounds of one reduction each, where a warp-wide insert
// of every candidate would walk them one after another.
constexpr int MAX_SPLITS = 1024;   // one thread per split

__device__ __forceinline__ void min_pair(u64& v, int& s, int off) {
  const u64 ov = __shfl_xor_sync(0xffffffffu, v, off);
  const int os = __shfl_xor_sync(0xffffffffu, s, off);
  if (ov < v || (ov == v && os < s)) {
    v = ov;
    s = os;
  }
}

template <bool kPacked>
__global__ void __launch_bounds__(MAX_SPLITS)
stream_topk_merge_kernel(const u64* __restrict__ part, float* __restrict__ val,
                         int64_t* __restrict__ idx, int n_splits, int k) {
  __shared__ u64 red_v[MAX_SPLITS / 32];
  __shared__ int red_s[MAX_SPLITS / 32];
  const int s = threadIdx.x, lane = s % 32, warp = s / 32;
  const int n_warps = blockDim.x / 32;
  const u64* p = part + ((size_t)blockIdx.x * n_splits + s) * k;
  u64 head = s < n_splits ? p[0] : KEY_MAX;
  u64 next = s < n_splits && k > 1 ? p[1] : KEY_MAX;   // loaded ahead
  int pos = 0;
  for (int r = 0; r < k; ++r) {
    u64 v = head;
    int w = s;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) min_pair(v, w, off);
    if (lane == 0) {
      red_v[warp] = v;
      red_s[warp] = w;
    }
    __syncthreads();
    v = lane < n_warps ? red_v[lane] : KEY_MAX;
    w = lane < n_warps ? red_s[lane] : MAX_SPLITS;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) min_pair(v, w, off);
    if (s == w) {   // the winning split advances
      head = next;
      ++pos;
      next = pos + 1 < k ? p[pos + 1] : KEY_MAX;
    }
    if (s == 0) {
      val[(size_t)blockIdx.x * k + r] = key_value<kPacked>(v);
      idx[(size_t)blockIdx.x * k + r] = (int64_t)(v & 0xFFFFFFFFull);
    }
    __syncthreads();   // red_v is rewritten by the next round
  }
}

// ---------------------------------------------------------------------------
// K3. Replaces centroids_reid_tpu/ops/retrieval.py::_vmem_topk_kernel (via
// _vmem_topk): the exact fp32 k smallest of each row, ordered by (value,
// column), ties to the lower column (lax.top_k's order, and that of a stable
// sort). The TPU kernel rescans its VMEM block on each of k passes; a port
// of that shape costs k block-wide reductions, whatever W. Here one block
// holds one row (W <= 32768, 128 KB) in shared memory as order keys and
// finds the k-th smallest key T by a radix select, most significant byte
// first: each of at most four passes builds a 256-bucket histogram of the
// keys that share the digits found so far (one sub-histogram per warp, so
// the shared-memory atomics of different warps never meet) and one warp
// scans it for the bucket that holds rank k. A pass stops the select early
// when its bucket holds exactly the keys still needed. The block then
// compacts, in column order, every key below T and the first k - c_lt
// columns whose key equals T (each warp walks its own contiguous chunk, 32
// columns per step, and ranks by ballot), and orders those k entries by
// (key, column): where k is at most the block's threads (every path's k),
// each thread counts the entries below its own, which is its output slot,
// with no barrier; above that, a bitonic sort of the k columns in shared
// memory, one barrier per step. Values are read back from the row itself,
// so they are bit-identical to the input.
//
// Order key: mono32 as K2u's (-0.0 folded to +0.0), except that every NaN
// maps to one key above +inf, so NaNs come last in column order, as the
// plain version's torch.sort puts them.
//
// Bound: one read of the row from device memory and the launch; the work is
// four passes over the row in shared memory plus a sort of k entries, so it
// hardly grows with k.
//
// Shared memory (the wrapper's plan, ops/retrieval.py::_kpass_plan, sizes
// it with the same formula as kpass_smem_bytes): keys [W] u32 | work: the
// warps' histograms, then the k (key << 32 | column) entries to rank or
// the n_sort u16 columns to sort | hist [256] | per-warp counts [64] |
// broadcast [4].
// ---------------------------------------------------------------------------
constexpr unsigned short SORT_PAD = 0xFFFF;   // sorts after every column

__host__ __device__ __forceinline__ int round4(int n) { return (n + 3) / 4 * 4; }

__host__ __device__ __forceinline__ int kpass_work_words(int nwarps,
                                                         int n_sort) {
  const int a = nwarps * 256, b = (n_sort + 1) / 2;
  return round4(a > b ? a : b);
}

size_t kpass_smem_bytes(int W, int threads, int n_sort) {
  return 4 * ((size_t)round4(W) + kpass_work_words(threads / 32, n_sort) +
              256 + 64 + 4);
}

__device__ __forceinline__ unsigned order_key(float v) {
  unsigned b = __float_as_uint(v);
  if (v != v) return 0xFFFFFFFFu;        // every NaN: one key above +inf
  if (b == 0x80000000u) b = 0u;          // -0.0 orders as +0.0
  return (b & 0x80000000u) ? ~b : (b | 0x80000000u);
}

// (key, column) order of two columns; SORT_PAD after everything
__device__ __forceinline__ bool sorts_before(const unsigned* keys, unsigned a,
                                             unsigned b) {
  if (a == SORT_PAD) return false;
  if (b == SORT_PAD) return true;
  const unsigned ka = keys[a], kb = keys[b];
  return ka < kb || (ka == kb && a < b);
}

// Bitonic sort of n (a power of two) columns by sorts_before, by the
// block, one barrier per step.
__device__ __forceinline__ void bitonic_sort(unsigned short* sel,
                                             const unsigned* keys, int n,
                                             int t, int nt) {
  for (int size = 2; size <= n; size <<= 1)
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      for (int i = t; i < n / 2; i += nt) {
        const int lo = ((i & ~(stride - 1)) << 1) | (i & (stride - 1));
        const int hi = lo + stride;
        const unsigned a = sel[lo], b = sel[hi];
        if (sorts_before(keys, b, a) == ((lo & size) == 0)) {
          sel[lo] = (unsigned short)b;
          sel[hi] = (unsigned short)a;
        }
      }
      __syncthreads();
    }
}

__global__ void __launch_bounds__(1024)
kpass_topk_kernel(const float* __restrict__ x, float* __restrict__ val,
                  int64_t* __restrict__ idx, int W, int k, int n_sort) {
  extern __shared__ __align__(16) unsigned kp_smem[];
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int nthreads = blockDim.x, nwarps = nthreads / 32;
  unsigned* keys = kp_smem;
  unsigned* work = keys + round4(W);
  unsigned* hist = work + kpass_work_words(nwarps, n_sort);
  unsigned* wcnt = hist + 256;   // [warp]: keys below, [32 + warp]: equal
  unsigned* bcast = wcnt + 64;
  const float* xr = x + (size_t)blockIdx.x * W;

  // 1. the row, once, as order keys (16-byte loads where rows allow them)
  if ((W & 3) == 0 && ((size_t)xr & 15) == 0) {
    const float4* x4 = reinterpret_cast<const float4*>(xr);
    uint4* k4 = reinterpret_cast<uint4*>(keys);
    for (int i = tid; i < W / 4; i += nthreads) {
      const float4 v = x4[i];
      k4[i] = make_uint4(order_key(v.x), order_key(v.y), order_key(v.z),
                         order_key(v.w));
    }
  } else {
    for (int i = tid; i < W; i += nthreads) keys[i] = order_key(xr[i]);
  }

  // 2. radix select of the k-th smallest key: after the loop the keys whose
  // top 32 - shift bits are below prefix number c_lt < k, and those equal
  // to it hold rank k
  unsigned prefix = 0, c_lt = 0;
  int shift = 32;
  for (int s = 24; s >= 0; s -= 8) {
    for (int i = tid; i < nwarps * 256; i += nthreads) work[i] = 0;
    __syncthreads();   // (on the first pass also: the keys are in place)
    unsigned* wh = work + warp * 256;
    for (int i = tid; i < W; i += nthreads) {
      const unsigned key = keys[i];
      if (shift == 32 || (key >> shift) == prefix)
        atomicAdd(&wh[(key >> s) & 255u], 1u);
    }
    __syncthreads();
    for (int b = tid; b < 256; b += nthreads) {
      unsigned sum = 0;
      for (int w = 0; w < nwarps; ++w) sum += work[w * 256 + b];
      hist[b] = sum;
    }
    __syncthreads();
    if (warp == 0) {
      // lane l scans buckets 8 l .. 8 l + 7; need is a 1-based rank among
      // the keys that match the prefix
      const unsigned need = (unsigned)k - c_lt;
      unsigned c[8], local = 0;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        c[j] = hist[8 * lane + j];
        local += c[j];
      }
      unsigned inc = local;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const unsigned t = __shfl_up_sync(0xffffffffu, inc, off);
        if (lane >= off) inc += t;
      }
      unsigned below = inc - local;
      if (below < need && need <= inc) {
        int d = 0;
        unsigned cnt = 0;
        bool found = false;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          if (!found && below + c[j] >= need) {
            d = 8 * lane + j;
            cnt = c[j];
            found = true;
          }
          if (!found) below += c[j];
        }
        bcast[0] = (unsigned)d;
        bcast[1] = below;
        bcast[2] = cnt;
      }
    }
    __syncthreads();
    prefix = (prefix << 8) | bcast[0];
    c_lt += bcast[1];
    shift = s;
    if (bcast[2] == (unsigned)k - c_lt) break;   // the bucket is all taken
  }

  // 3. compaction in column order into work (the histograms are dead): keys
  // below the prefix to slots [0, c_lt), the first need equal ones after
  const unsigned need = (unsigned)k - c_lt;
  const int chunk = ((W + nwarps - 1) / nwarps + 31) / 32 * 32;
  const int c0 = warp * chunk, c1 = min(W, c0 + chunk);
  unsigned n_lt = 0, n_eq = 0;
  for (int base = c0; base < c1; base += 32) {
    const int c = base + lane;
    const unsigned hi = c < c1 ? keys[c] >> shift : 0u;
    n_lt += __popc(__ballot_sync(0xffffffffu, c < c1 && hi < prefix));
    n_eq += __popc(__ballot_sync(0xffffffffu, c < c1 && hi == prefix));
  }
  if (lane == 0) {
    wcnt[warp] = n_lt;
    wcnt[32 + warp] = n_eq;
  }
  __syncthreads();
  unsigned off_lt = 0, off_eq = 0;
  for (int w = 0; w < warp; ++w) {
    off_lt += wcnt[w];
    off_eq += wcnt[32 + w];
  }
  // where k <= the block's threads, the selected entries are written as
  // (key << 32 | column) and ranked by one thread each (no barrier
  // steps); else as u16 columns for the bitonic sort
  const bool rank_sort = k <= nthreads;
  u64* comp = reinterpret_cast<u64*>(work);
  unsigned short* sel = reinterpret_cast<unsigned short*>(work);
  const unsigned below_me = (1u << lane) - 1u;
  for (int base = c0; base < c1; base += 32) {
    const int c = base + lane;
    const unsigned key = c < c1 ? keys[c] : 0u;
    const unsigned hi = key >> shift;
    const unsigned m_lt = __ballot_sync(0xffffffffu, c < c1 && hi < prefix);
    const unsigned m_eq = __ballot_sync(0xffffffffu, c < c1 && hi == prefix);
    unsigned slot = ~0u;
    if ((m_lt >> lane) & 1u) slot = off_lt + __popc(m_lt & below_me);
    if ((m_eq >> lane) & 1u) {
      const unsigned r = off_eq + __popc(m_eq & below_me);
      if (r < need) slot = c_lt + r;
    }
    if (slot != ~0u) {
      if (rank_sort)
        comp[slot] = ((u64)key << 32) | (unsigned)c;
      else
        sel[slot] = (unsigned short)c;
    }
    off_lt += __popc(m_lt);
    off_eq += __popc(m_eq);
  }
  if (rank_sort) {
    __syncthreads();
    if (tid < k) {
      // 4. its rank among the k (key, column) entries is its output slot
      const u64 v = comp[tid];
      unsigned r = 0;
#pragma unroll 8
      for (int j = 0; j < k; ++j) r += comp[j] < v ? 1u : 0u;
      const unsigned c = (unsigned)(v & 0xFFFFFFFFull);
      idx[(size_t)blockIdx.x * k + r] = (int64_t)c;
      val[(size_t)blockIdx.x * k + r] = xr[c];
    }
    return;
  }
  for (int i = k + tid; i < n_sort; i += nthreads) sel[i] = SORT_PAD;
  __syncthreads();

  // 4. sort the k columns by (key, column); values from the row itself
  bitonic_sort(sel, keys, n_sort, tid, nthreads);
  for (int r = tid; r < k; r += nthreads) {
    const unsigned c = sel[r];
    idx[(size_t)blockIdx.x * k + r] = (int64_t)c;
    val[(size_t)blockIdx.x * k + r] = xr[c];
  }
}

// ------------------------------------------------------------------ host --

int operand_maps(CUtensorMap* qm, CUtensorMap* gm, const void* q,
                 const void* g, int Q, int G, int D) {
  int rc = make_map(qm, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, q, D, Q, BK,
                    TILE_Q);
  if (rc == 0)
    rc = make_map(gm, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, g, D, G, BK,
                  TILE_G);
  return rc;
}


template <bool kPacked, int K>
int launch_partial(const CUtensorMap& qm, const CUtensorMap& gm,
                   const float* gn, void* part, int Q, int G, int D, int k,
                   int n_splits, cudaStream_t stream) {
  cudaError_t e = cudaFuncSetAttribute(stream_topk_partial_kernel<kPacked, K>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)kStreamSmem);
  if (e != cudaSuccess) return (int)e;
  dim3 grid(n_splits, Q / TILE_Q);
  stream_topk_partial_kernel<kPacked, K><<<grid, STREAM_THREADS, kStreamSmem,
                                           stream>>>(
      qm, gm, gn, (u64*)part, G, D, k, n_splits);
  return (int)cudaGetLastError();
}

// part: scratch of Q * n_splits * k keys; 1 <= n_splits <= G / 128.
template <bool kPacked>
int launch_stream_topk(const void* q, const void* g, const float* gn,
                       void* part, float* val, int64_t* idx, int Q, int G,
                       int D, int k, int n_splits, cudaStream_t stream) {
  if (n_splits < 1 || n_splits > G / TILE_G || n_splits > MAX_SPLITS ||
      k < 1 || k > 32)
    return (int)cudaErrorInvalidValue;
  CUtensorMap qm, gm;
  int rc = operand_maps(&qm, &gm, q, g, Q, G, D);
  if (rc != 0) return rc;
  // the list length: a list longer than k lets more candidates through
  rc = k <= 12 ? launch_partial<kPacked, 12>(qm, gm, gn, part, Q, G, D, k,
                                             n_splits, stream)
               : launch_partial<kPacked, 32>(qm, gm, gn, part, Q, G, D, k,
                                             n_splits, stream);
  if (rc != 0) return rc;
  stream_topk_merge_kernel<kPacked><<<Q, (n_splits + 31) / 32 * 32, 0,
                                      stream>>>((const u64*)part, val, idx,
                                                n_splits, k);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int crt_abi_version() { return 10; }

// The SM count of the current device (cudaDevAttrMultiProcessorCount), from
// which the wrapper plans K2's persistent grid; -1 on error.
int crt_sm_count() { return sm_count(); }

int crt_scores(const void* q, const void* g, const float* gn, float* out,
               int Q, int G, int D, void* stream) {
  const int n_tiles = (G / TILE_G) * (Q / TILE_Q);
  if (n_tiles == 0) return 0;
  CUtensorMap qm, gm, om;
  int rc = operand_maps(&qm, &gm, q, g, Q, G, D);
  if (rc == 0)
    rc = make_map(&om, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, out, G, Q, 32,
                  TILE_Q);
  if (rc != 0) return rc;
  const int sms = sm_count();
  if (sms < 1) return (int)cudaErrorInvalidDevice;
  cudaError_t e = cudaFuncSetAttribute(
      scores_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)kScoresSmem);
  if (e != cudaSuccess) return (int)e;
  scores_kernel<<<n_tiles < sms ? n_tiles : sms, THREADS, kScoresSmem,
                  (cudaStream_t)stream>>>(qm, gm, om, gn, G, Q, D);
  return (int)cudaGetLastError();
}

// K2: selection at bf16 key resolution.
int crt_stream_topk(const void* q, const void* g, const float* gn, void* part,
                    float* val, int64_t* idx, int Q, int G, int D, int k,
                    int n_splits, void* stream) {
  return launch_stream_topk<true>(q, g, gn, part, val, idx, Q, G, D, k,
                                  n_splits, (cudaStream_t)stream);
}

// K2u: selection by the exact fp32 score.
int crt_stream_topk_unpacked(const void* q, const void* g, const float* gn,
                             void* part, float* val, int64_t* idx, int Q,
                             int G, int D, int k, int n_splits,
                             void* stream) {
  return launch_stream_topk<false>(q, g, gn, part, val, idx, Q, G, D, k,
                                   n_splits, (cudaStream_t)stream);
}

// K3: one block of `threads` per row; n_sort, the power of two >= k that
// the bitonic sort runs on, and smem come from the wrapper's plan.
int crt_kpass_topk(const float* x, float* val, int64_t* idx, int Q, int W,
                   int k, int threads, int n_sort, int smem, void* stream) {
  if (k < 1 || k > W || W > 32768 || threads < 32 || threads > 1024 ||
      threads % 32 != 0 || n_sort < k || (n_sort & (n_sort - 1)) != 0 ||
      (size_t)smem < kpass_smem_bytes(W, threads, n_sort))
    return (int)cudaErrorInvalidValue;
  // raise the kernel's shared-memory limit only when a launch needs more
  // than an earlier one did (per device): one attribute call, not one per
  // launch
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= 64)
    return (int)cudaErrorInvalidDevice;
  static int smem_set[64] = {};
  if (smem > smem_set[dev]) {
    cudaError_t e = cudaFuncSetAttribute(
        kpass_topk_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
    smem_set[dev] = smem;
  }
  kpass_topk_kernel<<<Q, threads, smem, (cudaStream_t)stream>>>(
      x, val, idx, W, k, n_sort);
  return (int)cudaGetLastError();
}

}  // extern "C"
