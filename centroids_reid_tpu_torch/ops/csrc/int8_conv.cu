// int8 conv + requantization kernels for Hopper (sm_90a): the fused convs
// of the int8 PTQ embed (models/quantized.py).
//
//   K5 crt_matmul_requant    int8 [M, K] x [K, N] -> int8 [M, N]; replaces
//     centroids_reid_tpu/ops/int8_conv.py::_matmul_requant
//   K6 crt_conv3x3_requant   stride-1, pad-1 3x3 int8 conv over NHWC
//     [B, H, W, K]; replaces
//     centroids_reid_tpu/ops/int8_conv.py::_conv3x3_requant
//
// Both accumulate exactly in int32 on the int8 tensor cores and apply the
// serving epilogue before anything leaves the block: per-channel fp32 scale
// and bias, an optional int8 residual times a scalar, an optional ReLU,
// rounding half away from zero and a clip to +-127. Plain C interface,
// loaded with ctypes (ops/_build.py); launches on the stream it is given,
// allocates nothing, returns cudaGetLastError().
//
// Shape contract (checked by ops/int8_conv.py): K % 64 == 0, N % 64 == 0,
// every M; all tensors contiguous and 16-byte aligned. The weights come
// K-major: [N, K] for K5, [9, N, K] (tap-major HWIO, transposed) for K6,
// because 8-bit wgmma reads both operands K-major only.
//
// What bounds them on an H100 (chip_smoke.py phase 7 prints each shape's
// bound). At 8 images per embed call (M = 1,024 to 16,384) a launch moves
// 0.1-2.5 MB and does 0.1-5 GOP: a bound of 0.3-3 us, under the latency of
// one launch and one pass of the pipeline, so latency bounds them: the
// deep layers have 8 row tiles for 132 SMs. At 256 images layer 1's 1x1
// convs (K = 64 or 256, M = 524,288) are bound by bytes and the deep 3x3
// convs (K = N = 512, 4,608-deep products) by int8 operations.
//
// Design, one kernel for both (TAPS = 1 or 9), an implicit GEMM: output row
// m is pixel (b, h, w) of the NHWC tensor, and tap (dh, dw) of the 3x3 conv
// reads input row m + dh W + dw, or zero where (h + dh, w + dw) lies outside
// the image (the padding). A block owns a 128 x BN output tile (BN = 128,
// or 64 where N % 128 != 0) and walks its share of the taps x K stages.
//
// * Split-K where the tiles are few: the wrapper (ops/int8_conv.py::
//   _requant_plan) splits the stages of a tile 2 ways where the blocks
//   still fit one per SM and each split keeps 8 stages (the kernel takes up
//   to 8). The splits of a tile run as one thread-block cluster: each
//   stores its int32 partial tile in its own shared memory, and after a
//   cluster barrier each adds its column slice of the tile (BN / splits
//   columns) over the cluster's shared memory and runs the epilogue on that
//   slice. No workspace, no atomics, no second launch; integer sums are
//   exact in any order: |acc| <= 9 x 512 x 127 x 128 < 2^31.
// * Loads stay in flight: thread 0 keeps a ring of TMA loads STAGES - 1
//   stages ahead of the products, on mbarriers. Stages are 128 channels
//   deep in 128-byte swizzle (a 64-byte row per TMA request loads at about
//   half the rate), or 64 deep in 64-byte swizzle where K = 64; three of
//   them at one block per SM where the blocks fit one per SM, else two (at
//   BN = 128) with two blocks per SM, so that one block's epilogue runs
//   under the other's products; five of the 64-deep ones (launch_bn). K5
//   reads a 2D map over the activations [M, K]; both read one over the
//   packed weights [TAPS N, K]. K6, where W divides 128 and a tile stays in
//   one image (every shape of the embed), reads a 4D map over NHWC in boxes
//   of whole image rows: tap (dh, dw) loads (b, h0 + dh, dw, k0), and TMA's
//   zero fill outside the image is the padding. Elsewhere K6 loads the 128
//   rows from m0 + dh W + dw of the 2D map (zero before 0 and past M), and
//   the consumer warpgroup zeroes in shared memory the rows that fall
//   outside their image, only in the stages whose tap has such rows: any
//   B, H, W, tiles across images, ragged M.
// * int8 wgmma m64nBNk32 with s32 accumulators in registers: two consumer
//   warpgroups of 64 rows each; the next stage's products start before
//   the previous stage's are waited for.
// * The epilogue runs on the accumulator fragments in registers, with
//   requant()'s explicitly rounded operations, instantiated per ReLU and
//   residual (no branch per element) and without a quarter-rate conversion
//   where an exact full-rate one exists. Its operands (the slice's scale and
//   bias by bulk copies, its residual tile by TMA) load under the products.
//   Each thread writes its adjacent column pairs over its own residual
//   bytes in a swizzled int8 tile in shared memory (no bank conflicts), and
//   each warpgroup writes its 64 rows with one TMA store, which clips rows
//   past M: coalesced stores where 2-byte stores from registers would
//   scatter.
// 256 threads, 128 registers (162 at one block per SM), no spills.

#include <cooperative_groups.h>

#include "hopper.cuh"

namespace {

namespace cg = cooperative_groups;

constexpr int BM = 128;             // output rows per tile: 64 per consumer
constexpr int CONSUMERS = 2;        // consumer (wgmma) warpgroups
// No producer warp: 8 warps a block keep two blocks per SM at 128
// registers a thread (a ninth warp puts five warps of the two blocks on one
// of the SM's four register files, which caps them at 96 and spills the
// 64 accumulators of a 128-wide tile). Thread 0 starts the loads.
constexpr int THREADS = CONSUMERS * 128;
constexpr int MAX_SPLITS = 8;                   // portable cluster size

// A launch's pipeline: BK input channels per stage (64-byte rows in
// 64-byte swizzle, or 128 in 128-byte swizzle) and a ring of STAGES; two
// blocks per SM leave each 113 KB of shared memory.
template <int BN, int BK, int STAGES>
struct Layout {
  static constexpr unsigned kABytes = BM * BK;
  static constexpr unsigned kStage = kABytes + BN * BK;
  static constexpr unsigned kRing = STAGES * kStage;
  // after the products the ring holds the int32 partial tile (split-K);
  // the int8 output tile is written over the residual tile it replaces
  static constexpr unsigned kPartial = BM * BN * 4;
  static constexpr unsigned kTile = BM * BN;               // int8
  static constexpr unsigned kRes = kRing;
  static constexpr unsigned kScale = kRes + kTile, kBias = kScale + 4 * BN;
  static constexpr unsigned kBars = kBias + 4 * BN;   // full, empty, epi
  static constexpr unsigned kFlags = kBars + (2 * STAGES + 1) * 8;
  static constexpr unsigned kSmem = kFlags + 16 + 1024;
  static_assert(kStage % 1024 == 0 && kTile % 1024 == 0,
                "tiles keep the swizzle alignment");
  static_assert(kPartial <= kRing, "the partial tile fits the ring");
};

struct Epilogue {
  const float* scale;      // [N]
  const float* bias;       // [N]
  const int8_t* res;       // [M, N] or null
  const float* res_scale;  // [1], read when res is set
  int relu;
};

// An int8 value as fp32, exactly, with full-rate operations: the bits of
// 2^23 + (r + 128), less 2^23 + 128 (int-to-float conversions run at a
// quarter of the rate).
__device__ __forceinline__ float i8_to_f32(int r) {
  return __fsub_rn(__int_as_float(0x4B000000 + 128 + r), 8388736.0f);
}

// trunc(t) for 0 <= t < 2^22: 2^23 + t rounded toward zero holds floor(t)
// in its low bits (no quarter-rate float-to-int conversion).
__device__ __forceinline__ int trunc_nonneg(float t) {
  return __float_as_int(__fadd_rz(t, 8388608.0f)) - 0x4B000000;
}

// The epilogue of centroids_reid_tpu/ops/int8_conv.py::_epilogue, op for op,
// every operation rounded explicitly so no fma contraction changes a bit.
template <bool RELU, bool RES>
__device__ __forceinline__ signed char requant(int acc, float s, float b,
                                               int r, float rs) {
  float t = __fadd_rn(__fmul_rn(__int2float_rn(acc), s), b);
  if (RES) t = __fadd_rn(t, __fmul_rn(i8_to_f32(r), rs));
  if (RELU) {   // t >= 0.5
    return (signed char)trunc_nonneg(
        __fadd_rn(fminf(fmaxf(t, 0.0f), 127.0f), 0.5f));
  }
  t = fminf(fmaxf(t, -127.0f), 127.0f);
  t = __fadd_rn(t, t >= 0.0f ? 0.5f : -0.5f);   // |t| >= 0.5
  const int v = trunc_nonneg(fabsf(t));
  return (signed char)(t < 0.0f ? -v : v);
}

template <int BN, int BK>
__device__ __forceinline__ void mma_stage(int (&d)[BN / 2], u64 da, u64 db) {
#pragma unroll
  for (int kk = 0; kk < BK / 32; ++kk) {
    if constexpr (BN == 128)
      wgmma_m64n128k32_s8(d, da + 2 * kk, db + 2 * kk);
    else
      wgmma_m64n64k32_s8(d, da + 2 * kk, db + 2 * kk);
  }
}

// The TMA swizzle of an int8 tile of cw-byte rows (cw = 16 .. 128): row r's
// 16-byte chunk c sits at chunk c ^ swz_row(r, cw) of the row.
__device__ __forceinline__ int swz_row(int r, int cw) {
  return cw == 128 ? (r & 7) : cw == 64 ? ((r >> 1) & 3)
         : cw == 32 ? ((r >> 2) & 1) : 0;
}

// The epilogue of this thread's fragment pairs (rows r0 and r0 + 8, the
// column groups j0 .. j1 of the tile, all of them unless SLICED) from the
// accumulators into the swizzled output tile, reading the residual tile.
template <int BN, bool RELU, bool RES, bool SLICED>
__device__ __forceinline__ void epilogue(const int (&d)[BN / 2], int r0,
                                         int c2, int j0, int j1, int cw,
                                         const float* scale_s,
                                         const float* bias_s,
                                         const unsigned char* res_s,
                                         unsigned char* out_s, float rs) {
  const int x0 = swz_row(r0, cw), x1 = swz_row(r0 + 8, cw);
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
    if (SLICED && (j < j0 || j >= j1)) continue;
    const int c = 8 * (j - j0) + c2;
    const int a0 = r0 * cw + (((c >> 4) ^ x0) << 4) + (c & 15);
    const int a1 = (r0 + 8) * cw + (((c >> 4) ^ x1) << 4) + (c & 15);
    const float2 s = *reinterpret_cast<const float2*>(&scale_s[c]);
    const float2 b = *reinterpret_cast<const float2*>(&bias_s[c]);
    char2 q0 = make_char2(0, 0), q1 = make_char2(0, 0);
    if (RES) {
      q0 = *reinterpret_cast<const char2*>(res_s + a0);
      q1 = *reinterpret_cast<const char2*>(res_s + a1);
    }
    char2 o0, o1;
    o0.x = requant<RELU, RES>(d[4 * j], s.x, b.x, q0.x, rs);
    o0.y = requant<RELU, RES>(d[4 * j + 1], s.y, b.y, q0.y, rs);
    o1.x = requant<RELU, RES>(d[4 * j + 2], s.x, b.x, q1.x, rs);
    o1.y = requant<RELU, RES>(d[4 * j + 3], s.y, b.y, q1.y, rs);
    *reinterpret_cast<char2*>(out_s + a0) = o0;
    *reinterpret_cast<char2*>(out_s + a1) = o1;
  }
}

template <int BN, bool SLICED>
__device__ __forceinline__ void epilogue_for(const Epilogue& ep,
                                             const int (&d)[BN / 2], int r0,
                                             int c2, int j0, int j1, int cw,
                                             const float* scale_s,
                                             const float* bias_s,
                                             const unsigned char* res_s,
                                             unsigned char* out_s) {
  const float rs = ep.res ? *ep.res_scale : 0.0f;
  if (ep.relu && ep.res)
    epilogue<BN, true, true, SLICED>(d, r0, c2, j0, j1, cw, scale_s, bias_s,
                                     res_s, out_s, rs);
  else if (ep.relu)
    epilogue<BN, true, false, SLICED>(d, r0, c2, j0, j1, cw, scale_s, bias_s,
                                      res_s, out_s, rs);
  else if (ep.res)
    epilogue<BN, false, true, SLICED>(d, r0, c2, j0, j1, cw, scale_s, bias_s,
                                      res_s, out_s, rs);
  else
    epilogue<BN, false, false, SLICED>(d, r0, c2, j0, j1, cw, scale_s,
                                       bias_s, res_s, out_s, rs);
}

CUtensorMapSwizzle swizzle_for(int cw) {
  return cw == 128 ? CU_TENSOR_MAP_SWIZZLE_128B
         : cw == 64 ? CU_TENSOR_MAP_SWIZZLE_64B
         : cw == 32 ? CU_TENSOR_MAP_SWIZZLE_32B : CU_TENSOR_MAP_SWIZZLE_NONE;
}

// grid: (row tiles, N / BN, splits), clusters of (1, 1, splits). rows: the
// K6 rows per 4D box (0: the 2D map and the shared-memory padding). rmap
// and omap: boxes of [64 rows, BN / splits columns].
template <int TAPS, int BN, int BK, int STAGES, int MINB>
__global__ void __launch_bounds__(THREADS, MINB)
requant_gemm_kernel(const __grid_constant__ CUtensorMap xmap,
                    const __grid_constant__ CUtensorMap wmap,
                    const __grid_constant__ CUtensorMap rmap,
                    const __grid_constant__ CUtensorMap omap, Epilogue ep,
                    int M, int K, int N, int H, int W, int rows,
                    int splits) {
  using L = Layout<BN, BK, STAGES>;
  constexpr int R = BN / 2;   // accumulator registers per thread
  constexpr unsigned kABytes = L::kABytes;
  unsigned char* smem = smem_base();
  unsigned char* res_s = smem + L::kRes;
  unsigned char* out_s = res_s;   // written over the residual it reads
  int* part_s = reinterpret_cast<int*>(smem);
  const float* scale_s = reinterpret_cast<const float*>(smem + L::kScale);
  const float* bias_s = reinterpret_cast<const float*>(smem + L::kBias);
  u64* full = reinterpret_cast<u64*>(smem + L::kBars);
  u64* empty = full + STAGES;
  u64* epi = empty + STAGES;
  int* flags = reinterpret_cast<int*>(smem + L::kFlags);
  const int ks = (K + BK - 1) / BK, n_stages = TAPS * ks, split = blockIdx.z;
  const int s0 = (int)((long long)split * n_stages / splits);
  const int n_it = (int)((long long)(split + 1) * n_stages / splits) - s0;
  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * BN;
  // this block's column slice of the tile for the epilogue
  const int cw = BN / splits, c0 = split * cw;
  if (threadIdx.x == 0) {
    prefetch_map(&xmap);
    prefetch_map(&wmap);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], CONSUMERS * 4);   // one arrival per warp
    }
    mbar_init(epi, 1);
    flags[0] = flags[1] = 0;
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  // stage it of this block's share into its ring slot, once the slot's
  // previous stage is released (thread 0 only)
  const int b0 = rows ? m0 / (H * W) : 0, h0 = rows ? m0 % (H * W) / W : 0;
  auto load = [&](int it) {
    const int slot = it % STAGES;
    mbar_wait(&empty[slot], ((it / STAGES) & 1) ^ 1);
    const int gs = s0 + it, tap = gs / ks, k0 = (gs - tap * ks) * BK;
    const int dh = TAPS == 9 ? tap / 3 - 1 : 0;
    const int dw = TAPS == 9 ? tap % 3 - 1 : 0;
    unsigned char* st = smem + slot * L::kStage;
    mbar_expect_tx(&full[slot], L::kStage);
    if (TAPS == 9 && rows)
      tma_load_4d(st, &xmap, &full[slot], k0, dw, h0 + dh, b0);
    else
      tma_load(st, &xmap, &full[slot], k0, m0 + dh * W + dw);
    tma_load(st + kABytes, &wmap, &full[slot], k0, tap * N + n0);
  };
  if (threadIdx.x == 0) {
    for (int it = 0; it < STAGES - 1 && it < n_it; ++it) load(it);
    // the epilogue's operands for this block's slice, under the products
    mbar_expect_tx(epi, 8 * cw + (ep.res ? BM * cw : 0));
    bulk_load(smem + L::kScale, ep.scale + n0 + c0, 4 * cw, epi);
    bulk_load(smem + L::kBias, ep.bias + n0 + c0, 4 * cw, epi);
    if (ep.res) {
      tma_load(res_s, &rmap, epi, n0 + c0, m0);
      tma_load(res_s + 64 * cw, &rmap, epi, n0 + c0, m0 + 64);
    }
  }

  const int wg = threadIdx.x / 128, tw = threadIdx.x % 128;
  const int w = tw / 32, lane = threadIdx.x % 32;
  // K6 on the 2D map: this thread zeroes half (BK / 2 bytes) of A row prow
  // where the row's pixel is outside the image for the stage's tap; need:
  // the taps for which any row of this warpgroup is, so the others skip
  const int prow = 64 * wg + (tw >> 1);
  unsigned valid = 0x1FF, need = 0;
  if (TAPS == 9 && !rows) {
    const int m = m0 + prow;
    if (m < M) {
      const int h = (m / W) % H, x = m % W;
      valid = 0;
#pragma unroll
      for (int tap = 0; tap < 9; ++tap) {
        const int hh = h + tap / 3 - 1, xx = x + tap % 3 - 1;
        if (hh >= 0 && hh < H && xx >= 0 && xx < W) valid |= 1u << tap;
      }
    }
    const unsigned inv = __reduce_or_sync(0xffffffffu, ~valid & 0x1FFu);
    if (lane == 0) atomicOr(&flags[wg], (int)inv);
    wg_sync(1 + wg);
    need = (unsigned)flags[wg];
  }

  int d[R];
#pragma unroll
  for (int i = 0; i < R; ++i) d[i] = 0;
  for (int it = 0; it < n_it; ++it) {
    const int slot = it % STAGES;
    unsigned char* st = smem + slot * L::kStage;
    mbar_wait(&full[slot], (it / STAGES) & 1);
    if (TAPS == 9 && !rows) {
      const int tap = (s0 + it) / ks;
      if ((need >> tap) & 1u) {   // uniform over the warpgroup
        if (!((valid >> tap) & 1u)) {
          int4* p =
              reinterpret_cast<int4*>(st + prow * BK + (tw & 1) * BK / 2);
#pragma unroll
          for (int i = 0; i < BK / 32; ++i) p[i] = make_int4(0, 0, 0, 0);
        }
        asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
        wg_sync(1 + wg);
      }
    }
    __syncwarp();   // wgmma is .aligned: the warp runs it converged
    fence_operands(d);
    asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
    if constexpr (BK == 128)
      mma_stage<BN, BK>(d, sw128_desc(st + 64 * wg * BK),
                        sw128_desc(st + kABytes));
    else
      mma_stage<BN, BK>(d, sw64_desc(st + 64 * wg * BK),
                        sw64_desc(st + kABytes));
    asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
    // the previous stage's products are done: give its slot back
    asm volatile("wgmma.wait_group.sync.aligned 1;" ::: "memory");
    fence_operands(d);
    if (it > 0 && lane == 0) mbar_arrive(&empty[(it - 1) % STAGES]);
    // STAGES - 1 stages ahead, into the slot just released (by both
    // warpgroups: thread 0 waits for the other one there)
    if (threadIdx.x == 0 && it + STAGES - 1 < n_it) load(it + STAGES - 1);
  }
  asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
  fence_operands(d);
  __syncthreads();   // the ring is free: no product reads it any more

  const int ct = threadIdx.x;
  const int j0 = c0 / 8, j1 = j0 + cw / 8;   // this slice's column groups
  if (splits > 1) {
    // partial tiles, thread-major, then the slice's sums over the cluster
#pragma unroll
    for (int r = 0; r < R; ++r) part_s[r * 256 + ct] = d[r];
    cluster_arrive();
    cluster_wait();
    // plain loads through the cluster's shared-memory window, so that the
    // compiler keeps many in flight
    const cg::cluster_group cluster = cg::this_cluster();
#pragma unroll
    for (int j = 0; j < BN / 8; ++j) {
      if (j < j0 || j >= j1) continue;
#pragma unroll
      for (int v = 0; v < 4; ++v) d[4 * j + v] = 0;
    }
    for (int q = 0; q < splits; ++q) {
      const int* peer = cluster.map_shared_rank(part_s, q) + ct;
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {
        if (j < j0 || j >= j1) continue;
#pragma unroll
        for (int v = 0; v < 4; ++v) d[4 * j + v] += peer[(4 * j + v) * 256];
      }
    }
    cluster_arrive();   // done reading the others' partials
  }

  mbar_wait(epi, 0);
  const int r0 = 64 * wg + 16 * w + (lane >> 2), c2 = 2 * (lane & 3);
  if (splits > 1)
    epilogue_for<BN, true>(ep, d, r0, c2, j0, j1, cw, scale_s, bias_s, res_s,
                           out_s);
  else
    epilogue_for<BN, false>(ep, d, r0, c2, 0, BN / 8, BN, scale_s, bias_s,
                            res_s, out_s);
  // the others may still read this block's partial tile, which the output
  // tile does not overlap
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
  wg_sync(1 + wg);
  if (tw == 0) {
    tma_store(&omap, out_s + wg * 64 * cw, n0 + c0, m0 + 64 * wg);
    bulk_commit();
    bulk_wait_read();   // the tile stays until the store has read it
  }
  if (splits > 1) cluster_wait();   // no block leaves while read
}

template <int TAPS, int BN, int BK, int STAGES, int MINB>
int launch_cfg(const void* x, const void* w, const Epilogue& ep, void* out,
               int B, int M, int K, int N, int H, int W, int splits,
               cudaStream_t stream) {
  using L = Layout<BN, BK, STAGES>;
  const CUtensorMapSwizzle kswz =
      BK == 128 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_64B;
  const int cw = BN / splits;
  // K6 in boxes of whole image rows where W divides the tile's 128 rows
  // and a tile stays in one image
  const int rows = TAPS == 9 && BM % W == 0 && (H * W) % BM == 0 ? BM / W : 0;
  CUtensorMap xm, wm, rm, om;
  int rc = rows ? make_map_rows(&xm, x, B, H, W, K, rows, BK, kswz)
                : make_map(&xm, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, x, K, M, BK,
                           BM, kswz);
  if (rc == 0)
    rc = make_map(&wm, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, w, K, TAPS * N, BK,
                  BN, kswz);
  if (rc == 0)
    rc = make_map(&om, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, out, N, M, cw, 64,
                  swizzle_for(cw));
  // without a residual the kernel never reads the map
  rm = CUtensorMap{};
  if (rc == 0 && ep.res)
    rc = make_map(&rm, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, ep.res, N, M, cw, 64,
                  swizzle_for(cw));
  if (rc != 0) return rc;
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= 64)
    return (int)cudaErrorInvalidDevice;
  auto kernel = requant_gemm_kernel<TAPS, BN, BK, STAGES, MINB>;
  static bool smem_set[64] = {};   // the attribute, once per device
  if (!smem_set[dev]) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)L::kSmem);
    if (e != cudaSuccess) return (int)e;
    smem_set[dev] = true;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((M + BM - 1) / BM, N / BN, splits);
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = L::kSmem;
  cfg.stream = stream;
  cudaLaunchAttribute cluster[1];
  cluster[0].id = cudaLaunchAttributeClusterDimension;
  cluster[0].val.clusterDim.x = 1;
  cluster[0].val.clusterDim.y = 1;
  cluster[0].val.clusterDim.z = splits;
  cfg.attrs = cluster;
  cfg.numAttrs = splits > 1;   // a cluster launch schedules blocks slower
  const cudaError_t e = cudaLaunchKernelEx(&cfg, kernel, xm, wm, rm, om, ep,
                                           M, K, N, H, W, rows, splits);
  return e != cudaSuccess ? (int)e : (int)cudaGetLastError();
}

// The current device's SM count, read once per device.
int device_sms() {
  static int sms[64] = {};
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= 64) return -1;
  if (sms[dev] == 0) sms[dev] = sm_count();
  return sms[dev];
}

// The pipeline of one launch, as the header describes (each choice was the
// faster one on an H100 at the embed's shapes).
template <int TAPS, int BN>
int launch_bn(const void* x, const void* w, const Epilogue& ep, void* out,
              int B, int M, int K, int N, int H, int W, int splits,
              cudaStream_t stream) {
  if (K == 64)
    return launch_cfg<TAPS, BN, 64, 5, 2>(x, w, ep, out, B, M, K, N, H, W,
                                          splits, stream);
  const long long blocks = (long long)((M + BM - 1) / BM) * (N / BN) * splits;
  if (BN == 64 || blocks > device_sms())
    return launch_cfg<TAPS, BN, 128, BN == 128 ? 2 : 3, 2>(
        x, w, ep, out, B, M, K, N, H, W, splits, stream);
  return launch_cfg<TAPS, BN, 128, 3, 1>(x, w, ep, out, B, M, K, N, H, W,
                                         splits, stream);
}

template <int TAPS>
int launch(const void* x, const void* w, const float* scale,
           const float* bias, const void* res, const float* res_scale,
           int relu, void* out, int B, int H, int W, int K, int N, int bn,
           int splits, void* stream) {
  const int M = B * H * W;
  if (M == 0) return 0;
  // splits: a power of two up to the cluster size, at least one 128-deep
  // stage (or the one 64-deep stage of K = 64) and 16 epilogue columns each
  if ((bn != 64 && bn != 128) || K % 64 || N % bn || splits < 1 ||
      splits > MAX_SPLITS || (splits & (splits - 1)) ||
      splits > TAPS * ((K + 127) / 128) || bn / splits < 16)
    return (int)cudaErrorInvalidValue;
  const Epilogue ep{scale, bias, (const int8_t*)res, res_scale, relu};
  if (bn == 128)
    return launch_bn<TAPS, 128>(x, w, ep, out, B, M, K, N, H, W, splits,
                                (cudaStream_t)stream);
  return launch_bn<TAPS, 64>(x, w, ep, out, B, M, K, N, H, W, splits,
                             (cudaStream_t)stream);
}

}  // namespace

extern "C" {

// Dynamic shared memory of one block at tile width bn (64 or 128) and
// stage depth bk (64 or 128), with the ring launch_bn() gives it at two
// blocks per SM.
int crt_requant_smem_bytes(int bn, int bk) {
  if (bk == 64)
    return bn == 128 ? (int)Layout<128, 64, 5>::kSmem
                     : (int)Layout<64, 64, 5>::kSmem;
  return bn == 128 ? (int)Layout<128, 128, 2>::kSmem
                   : (int)Layout<64, 128, 3>::kSmem;
}

// x: [M, K]; w: K-major [N, K]; res and res_scale may be null (no
// residual). bn: the tile width (128 needs N % 128 == 0); splits: K
// splits of a tile, one cluster: 1, 2, 4 or 8, at most the 128-deep stages
// of K (one where K = 64) and bn / 16.
int crt_matmul_requant(const void* x, const void* w, const float* scale,
                       const float* bias, const void* res,
                       const float* res_scale, int relu, void* out, int M,
                       int K, int N, int bn, int splits, void* stream) {
  return launch<1>(x, w, scale, bias, res, res_scale, relu, out, 1, M, 1, K,
                   N, bn, splits, stream);
}

// x: NHWC [B, H, W, K]; w: K-major taps [9, N, K] (HWIO [3, 3, K, N] with
// each tap transposed); splits at most 9 x the stages of K; the rest as
// above.
int crt_conv3x3_requant(const void* x, const void* w, const float* scale,
                        const float* bias, const void* res,
                        const float* res_scale, int relu, void* out, int B,
                        int H, int W, int K, int N, int bn, int splits,
                        void* stream) {
  return launch<9>(x, w, scale, bias, res, res_scale, relu, out, B, H, W, K,
                   N, bn, splits, stream);
}

}  // extern "C"
