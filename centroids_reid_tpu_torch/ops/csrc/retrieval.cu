// Retrieval kernels for Hopper (sm_90a): the kernels that carry the serving
// path's top-k selection against a device-resident gallery.
//
//   K1 crt_scores          scores = gn - 2 q.g^T             (bf16 in, fp32 out)
//   K2 crt_stream_topk     streaming top-k at bf16 key resolution, k <= 32,
//                          never materialises the Q x G score matrix
//   K2u crt_stream_topk_unpacked  the same selection by exact fp32 score
//   K3 crt_kpass_topk      exact fp32 k smallest of each row, row in smem
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

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

typedef unsigned long long u64;

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

// ------------------------------------------------------------ primitives --

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

// Dynamic shared memory rounded up to the 1024-byte alignment that the
// 128-byte swizzle pattern of TMA and wgmma needs.
__device__ __forceinline__ unsigned char* smem_base() {
  extern __shared__ unsigned char smem_raw[];
  const unsigned pad = (1024u - (smem_u32(smem_raw) & 1023u)) & 1023u;
  return smem_raw + pad;
}

__device__ __forceinline__ void mbar_init(u64* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_u32(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(u64* bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
                   smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(u64* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(smem_u32(bar))
               : "memory");
}

// Wait until the phase of the given parity has completed.
__device__ __forceinline__ void mbar_wait(u64* bar, unsigned parity) {
  const unsigned addr = smem_u32(bar);
  unsigned done = 0;
  while (!done) {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
  }
}

__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map,
                                         u64* bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4}], [%2];" ::"r"(smem_u32(dst)),
      "l"((u64)map), "r"(smem_u32(bar)), "r"(c0), "r"(c1)
      : "memory");
}

__device__ __forceinline__ void tma_store(const CUtensorMap* map,
                                          const void* src, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.global.shared::cta.bulk_group [%0, {%2, %3}], "
      "[%1];" ::"l"((u64)map),
      "r"(smem_u32(src)), "r"(c0), "r"(c1)
      : "memory");
}

__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;" ::: "memory");
}

__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read 0;" ::: "memory");
}

__device__ __forceinline__ void bulk_wait() {
  asm volatile("cp.async.bulk.wait_group 0;" ::: "memory");
}

// Barrier over one consumer warpgroup (ids 1, 2).
__device__ __forceinline__ void wg_sync(int id) {
  asm volatile("bar.sync %0, 128;" ::"r"(id) : "memory");
}

// wgmma descriptor of a K-major tile of 128-byte rows in 128-byte swizzle:
// 8-row groups 1024 B apart (stride byte offset); the leading offset is
// unused for this layout. One k16 step is +32 B on the start address.
__device__ __forceinline__ u64 sw128_desc(const void* tile) {
  return (u64)((smem_u32(tile) & 0x3FFFFu) >> 4) | ((u64)1 << 16) |
         ((u64)(1024 >> 4) << 32) | ((u64)1 << 62);
}

__device__ __forceinline__ void fence_operands(float (&d)[64]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// D[64 x 128] (+)= A[64 x 16] B[16 x 128], bf16 in, fp32 accumulate; thread
// t of the warpgroup holds D[16 w + t/4 % 8 (+8)][8 j + 2 (t % 4) (+1)] in
// d[4 j ..], w = warp of the warpgroup.
__device__ __forceinline__ void wgmma_m64n128k16(float (&d)[64], u64 da,
                                                 u64 db, int accumulate) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39,"
      "%40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55,"
      "%56, %57, %58, %59, %60, %61, %62, %63},"
      " %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(accumulate));
}

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

// ------------------------------------------------------------------ host --

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

EncodeTiled tensor_map_encoder() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                cudaEnableDefault, &found) == cudaSuccess &&
        found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// A row-major [rows, inner] tensor read or written in boxes of [box_rows,
// box_inner] with 128-byte swizzle; elements past the edge read as zero.
int make_map(CUtensorMap* map, CUtensorMapDataType type, int elem_bytes,
             const void* base, int inner, int rows, int box_inner,
             int box_rows) {
  const EncodeTiled encode = tensor_map_encoder();
  if (encode == nullptr) return (int)cudaErrorNotSupported;
  const cuuint64_t dims[2] = {(cuuint64_t)inner, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)inner * elem_bytes};
  const cuuint32_t box[2] = {(cuuint32_t)box_inner, (cuuint32_t)box_rows};
  const cuuint32_t unit[2] = {1, 1};
  const CUresult r = encode(
      map, type, 2, const_cast<void*>(base), dims, strides, box, unit,
      CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
      CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

int operand_maps(CUtensorMap* qm, CUtensorMap* gm, const void* q,
                 const void* g, int Q, int G, int D) {
  int rc = make_map(qm, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, q, D, Q, BK,
                    TILE_Q);
  if (rc == 0)
    rc = make_map(gm, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, g, D, G, BK,
                  TILE_G);
  return rc;
}

int sm_count() {
  int dev = 0, n = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev) !=
          cudaSuccess)
    return -1;
  return n;
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

int crt_abi_version() { return 4; }

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
