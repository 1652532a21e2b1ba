// The int8 gallery's score kernel for Hopper (sm_90a).
//
//   K4 crt_scores_i8   scores = gn - 2 s (q.q8^T)   (bf16 q, int8 codes, fp32 out)
//
// Plain C interface, loaded with ctypes (ops/_build.py); launches on the
// stream it is given, allocates nothing, returns cudaGetLastError().
//
// Shape contract (checked by ops/retrieval_int8.py::scores_i8): q [Q, D]
// row-major bf16, codes [G, D] row-major int8, s and gn [G] fp32 (gn +inf
// on pad rows), Q % 128 == 0, G % 128 == 0, D % 32 == 0, 16-byte aligned.

#include "hopper.cuh"

namespace {

constexpr int TILE_G = 256;    // gallery rows per tile (wgmma M: 2 x 64 per warpgroup)
constexpr int TILE_Q = 128;    // query rows per tile (wgmma N)
constexpr int BK = 64;         // depth per ring stage: 128-byte q rows, 64-byte code rows
constexpr int STAGES = 4;      // ring depth
constexpr int CONSUMERS = 2;   // consumer (MMA) warpgroups
// + a producer warpgroup (one thread issues the loads): setmaxnreg moves
// registers between whole warpgroups, and each consumer holds two 64 x 128
// fp32 accumulators (128 registers) beside its A fragments
constexpr int THREADS = (CONSUMERS + 1) * 128;
constexpr int PRODUCER_REGS = 40, CONSUMER_REGS = 232;
constexpr unsigned kQBytes = TILE_Q * BK * 2;          // 16 KB, 128-byte swizzle
constexpr unsigned kCodeBytes = TILE_G * BK;           // 16 KB, unswizzled
constexpr unsigned kStageBytes = kQBytes + kCodeBytes; // 32 KB (1024-aligned)
constexpr unsigned kRingBytes = STAGES * kStageBytes;
// one 64-row half of a warpgroup's output at a time: [128 query rows][32]
// fp32 chunks, two per warpgroup
constexpr unsigned kStagingBytes = CONSUMERS * 2 * TILE_Q * 32 * 4;
constexpr unsigned kBarBytes = 2 * STAGES * 8;
constexpr unsigned kSmem = kRingBytes + kStagingBytes + kBarBytes + 1024;
static_assert(kStageBytes % 1024 == 0, "stages must keep the swizzle alignment");
static_assert(kSmem <= 232448, "K4 exceeds the shared memory of a block");

// ---------------------------------------------------------------------------
// K4. Replaces centroids_reid_tpu/ops/retrieval_int8.py::_score_block_kernel_i8
// (via _scores_pallas_i8). At the serving shape (Q = 128, G = 100352,
// D = 2048) it reads the 206 MB int8 gallery once, half of K1's bf16 read,
// and writes the same 51 MB fp32 score matrix against 53 GFLOP: at least
// 0.077 ms at 3.35 TB/s, a bound of bytes as for K1.
//
// Design: K1's shape (retrieval.cu) with its own body. One producer thread
// keeps a 4-stage ring of TMA loads in flight (64-deep slices of the 128
// query rows, bf16 in 128-byte swizzle, and of 256 gallery code rows, int8,
// 64-byte rows unswizzled; completion on mbarriers). Two consumer
// warpgroups run wgmma m64n128k16 with the gallery rows as M (two 64-row
// products each, which share the query operand) and the queries as N.
//
// wgmma multiplies no int8 by bf16, and takes A from registers or from a
// bf16 tile, so each consumer thread reads its A fragment of codes from
// shared memory (one 16-byte load per row and k16 step; the four threads of
// a quad read the same row, and the two rows of an 8-thread phase lie 64
// bytes apart, so no bank conflicts) and widens it to bf16 in registers: a
// byte permute builds the fp32 2^23 + 128 + code, one fp32 subtract leaves
// the code, and a second permute packs the high halves of two such floats
// as a bf16 pair (exact: |code| <= 127 fits in bf16's 8 significant bits).
// The register-A form of wgmma then multiplies. Each consumer widens the
// next stage while the current stage's products run (two sets of A
// fragments), so the tensor cores do not wait on the widening.
//
// What bounds it here is the loads into shared memory, not the products:
// the query slice is re-read from L2 once per gallery tile. At K1's 128
// gallery rows per tile it would be 2/3 of the bytes the SMs load (512 KB of
// bf16 q beside 256 KB of codes); at 256 rows it is half. Two 64 x 128 fp32
// accumulators per consumer need more registers than an even split of the
// block gives, so the producer is a whole warpgroup that hands its
// registers to the consumers (setmaxnreg).
//
// The per-row scale is applied after the product, as the TPU kernel does,
// with explicitly rounded operations (a contracted fma of gn - 2 (s dot)
// would round differently from the plain version). Blocks are persistent,
// one per SM, striding over the 256 x 128 output tiles; the epilogue stages
// each 64-row product's 128 x 64 fp32 block in 128-byte swizzle and writes
// it with TMA stores that drain under the next tile's loads and products.
// TMA zero-fills boxes past D, so a ragged last stage (D = 32, 96, ...)
// adds zeros to the dot products, and boxes past G (G % 256 == 128), whose
// rows the epilogue skips.
// ---------------------------------------------------------------------------

// The bf16 pair of codes (byte b, byte b + 1) of word w, b in {0, 2}, given
// as the permute selectors 0x7650 + b and 0x7651 + b.
__device__ __forceinline__ unsigned widen_pair(unsigned w, unsigned sel_lo,
                                               unsigned sel_hi) {
  const unsigned u = w ^ 0x80808080u;   // code + 128 in each byte
  const float f0 = __fsub_rn(__uint_as_float(__byte_perm(u, 0x4B000000u, sel_lo)),
                             8388736.0f);   // 2^23 + 128
  const float f1 = __fsub_rn(__uint_as_float(__byte_perm(u, 0x4B000000u, sel_hi)),
                             8388736.0f);
  return __byte_perm(__float_as_uint(f0), __float_as_uint(f1), 0x7632);
}

// One stage's A fragments of this thread, widened: [k16 step][product m]
// [register], rows ar + 64 m (and + 8) of the stage's code tile.
typedef unsigned Frags[BK / 16][2][4];

__device__ __forceinline__ void widen_stage(Frags& a,
                                            const unsigned char* codes,
                                            bool hi_word, unsigned sel_lo,
                                            unsigned sel_hi) {
#pragma unroll
  for (int kk = 0; kk < BK / 16; ++kk)
#pragma unroll
    for (int m = 0; m < 2; ++m) {
      const unsigned char* c = codes + m * 64 * BK + 16 * kk;
      const uint4 r0 = *reinterpret_cast<const uint4*>(c);
      const uint4 r1 = *reinterpret_cast<const uint4*>(c + 8 * BK);
      a[kk][m][0] = widen_pair(hi_word ? r0.y : r0.x, sel_lo, sel_hi);
      a[kk][m][1] = widen_pair(hi_word ? r1.y : r1.x, sel_lo, sel_hi);
      a[kk][m][2] = widen_pair(hi_word ? r0.w : r0.z, sel_lo, sel_hi);
      a[kk][m][3] = widen_pair(hi_word ? r1.w : r1.z, sel_lo, sel_hi);
    }
}

// The stage's eight products (4 k16 steps x 2 row blocks) as one wgmma
// group; the caller waits for it.
__device__ __forceinline__ void mma_stage(float (&d)[2][64], const Frags& a,
                                          const unsigned char* st,
                                          bool first) {
  __syncwarp();   // wgmma is .aligned: the warp issues it converged
  const u64 db = sw128_desc(st);
  fence_operands(d[0]);
  fence_operands(d[1]);
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
#pragma unroll
  for (int kk = 0; kk < BK / 16; ++kk)
#pragma unroll
    for (int m = 0; m < 2; ++m)
      wgmma_m64n128k16_rs(d[m], a[kk][m], db + 2 * kk, !first || kk > 0);
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}

__device__ __forceinline__ void produce_i8(const CUtensorMap* qmap,
                                           const CUtensorMap* cmap,
                                           unsigned char* ring, u64* full,
                                           u64* empty, int n_tiles, int n_gt,
                                           int nk) {
  int it = 0;
  for (int t = blockIdx.x; t < n_tiles; t += gridDim.x) {
    const int g0 = (t % n_gt) * TILE_G, q0 = (t / n_gt) * TILE_Q;
    for (int ks = 0; ks < nk; ++ks, ++it) {
      const int s = it % STAGES;
      mbar_wait(&empty[s], ((it / STAGES) & 1) ^ 1);
      unsigned char* st = ring + s * kStageBytes;
      mbar_expect_tx(&full[s], kStageBytes);
      tma_load(st, qmap, &full[s], ks * BK, q0);
      tma_load(st + kQBytes, cmap, &full[s], ks * BK, g0);
    }
  }
}

__global__ void __launch_bounds__(THREADS, 1)
scores_i8_kernel(const __grid_constant__ CUtensorMap qmap,
                 const __grid_constant__ CUtensorMap cmap,
                 const __grid_constant__ CUtensorMap omap,
                 const float* __restrict__ scale,
                 const float* __restrict__ gn, int G, int Q, int D) {
  unsigned char* smem = smem_base();
  unsigned char* ring = smem;
  float* staging = reinterpret_cast<float*>(smem + kRingBytes);
  u64* full = reinterpret_cast<u64*>(smem + kRingBytes + kStagingBytes);
  u64* empty = full + STAGES;
  const int n_gt = (G + TILE_G - 1) / TILE_G, n_tiles = n_gt * (Q / TILE_Q);
  const int nk = (D + BK - 1) / BK;
  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], CONSUMERS * 4);   // one arrival per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == CONSUMERS) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;" ::"n"(PRODUCER_REGS));
    if (threadIdx.x == CONSUMERS * 128)
      produce_i8(&qmap, &cmap, ring, full, empty, n_tiles, n_gt, nk);
    return;
  }
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;" ::"n"(CONSUMER_REGS));
  const int tw = threadIdx.x % 128, w = tw / 32, lane = threadIdx.x % 32;
  // this thread's A rows in product m (128 wg + 64 m + 16 w + lane / 4, and
  // + 8) and the words and bytes of its columns 2 (lane % 4) .. + 1 (and
  // + 8) in a k16 step
  const int ar = wg * 128 + 16 * w + (lane >> 2);
  const bool hi_word = (lane & 3) >= 2;
  const unsigned sel_lo = 0x7650u + 2u * (lane & 1);
  const unsigned sel_hi = sel_lo + 1u;
  // this warpgroup's two 32-column chunks [128 query rows][32 fp32]
  float* S = staging + wg * 2 * TILE_Q * 32;
  float d[2][64] = {};
  Frags a0, a1;
  int it = 0;
  for (int t = blockIdx.x; t < n_tiles; t += gridDim.x) {
    const int g0 = (t % n_gt) * TILE_G, q0 = (t / n_gt) * TILE_Q;
    // software-pipelined: the next stage is widened into the other set of
    // fragments while this stage's products run, so the tensor cores do
    // not wait on the widening
    const unsigned char* st = ring + (it % STAGES) * kStageBytes;
    mbar_wait(&full[it % STAGES], (it / STAGES) & 1);
    widen_stage(a0, st + kQBytes + ar * BK, hi_word, sel_lo, sel_hi);
    for (int ks = 0; ks < nk; ks += 2) {
      mma_stage(d, a0, st, ks == 0);
      const unsigned char* next = ring + ((it + 1) % STAGES) * kStageBytes;
      if (ks + 1 < nk) {
        mbar_wait(&full[(it + 1) % STAGES], ((it + 1) / STAGES) & 1);
        widen_stage(a1, next + kQBytes + ar * BK, hi_word, sel_lo, sel_hi);
      }
      asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
      fence_operands(d[0]);
      fence_operands(d[1]);
      if (lane == 0) mbar_arrive(&empty[it % STAGES]);
      ++it;
      if (ks + 1 >= nk) break;
      st = next;
      mma_stage(d, a1, st, false);
      next = ring + ((it + 1) % STAGES) * kStageBytes;
      if (ks + 2 < nk) {
        mbar_wait(&full[(it + 1) % STAGES], ((it + 1) / STAGES) & 1);
        widen_stage(a0, next + kQBytes + ar * BK, hi_word, sel_lo, sel_hi);
      }
      asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
      fence_operands(d[0]);
      fence_operands(d[1]);
      if (lane == 0) mbar_arrive(&empty[it % STAGES]);
      ++it;
      st = next;
    }
    // epilogue, one 64-row product at a time: gn - 2 (s acc), rounded op by
    // op, through the staging chunks; rows past G (a half tile) are skipped
    const int gl = 16 * w + (lane >> 2);   // + 8 for v >= 2
#pragma unroll
    for (int m = 0; m < 2; ++m) {
      const int gb = g0 + wg * 128 + m * 64;   // G % 128 == 0: all or none
      if (gb >= G) continue;
      const float s0 = scale[gb + gl], s1 = scale[gb + gl + 8];
      const float n0 = gn[gb + gl], n1 = gn[gb + gl + 8];
      float* chunk = S + (w >> 1) * TILE_Q * 32;   // 16 rows of a warp: one chunk
      if (tw == 0) bulk_wait_read();   // the previous stores have read S
      wg_sync(1 + wg);
#pragma unroll
      for (int j = 0; j < 16; ++j)
#pragma unroll
        for (int v = 0; v < 4; ++v) {
          const int qr = 8 * j + 2 * (lane & 3) + (v & 1);
          const int gc = (gl + 8 * (v >> 1)) & 31;
          const float sc = (v >> 1) ? s1 : s0, nn = (v >> 1) ? n1 : n0;
          chunk[qr * 32 + ((((gc >> 2) ^ (qr & 7)) << 2) | (gc & 3))] =
              __fsub_rn(nn, __fmul_rn(2.0f, __fmul_rn(sc, d[m][4 * j + v])));
        }
      asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
      wg_sync(1 + wg);
      if (tw == 0) {
        tma_store(&omap, S, gb, q0);
        tma_store(&omap, S + TILE_Q * 32, gb + 32, q0);
        bulk_commit();
      }
    }
  }
  if (tw == 0) bulk_wait();
}

}  // namespace

extern "C" {

// n_blocks: the persistent grid, 1 <= n_blocks <= the number of 256 x 128
// output tiles (the wrapper's plan: one block per SM at most).
int crt_scores_i8(const void* q, const void* codes, const float* scale,
                  const float* gn, float* out, int Q, int G, int D,
                  int n_blocks, void* stream) {
  const int n_tiles = (G + TILE_G - 1) / TILE_G * (Q / TILE_Q);
  if (n_tiles == 0) return 0;
  if (n_blocks < 1 || n_blocks > n_tiles) return (int)cudaErrorInvalidValue;
  CUtensorMap qm, cm, om;
  int rc = make_map(&qm, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, q, D, Q, BK,
                    TILE_Q);
  if (rc == 0)
    rc = make_map(&cm, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, codes, D, G, BK,
                  TILE_G, CU_TENSOR_MAP_SWIZZLE_NONE);
  if (rc == 0)
    rc = make_map(&om, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, out, G, Q, 32,
                  TILE_Q);
  if (rc != 0) return rc;
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= 64)
    return (int)cudaErrorInvalidDevice;
  static bool smem_set[64] = {};   // the attribute, once per device
  if (!smem_set[dev]) {
    cudaError_t e = cudaFuncSetAttribute(
        scores_i8_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)kSmem);
    if (e != cudaSuccess) return (int)e;
    smem_set[dev] = true;
  }
  scores_i8_kernel<<<n_blocks, THREADS, kSmem, (cudaStream_t)stream>>>(
      qm, cm, om, scale, gn, G, Q, D);
  return (int)cudaGetLastError();
}

}  // extern "C"
