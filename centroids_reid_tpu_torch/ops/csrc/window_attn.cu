// Swin's window attention over a block's real tokens for Hopper (sm_90a):
//
//   K9 crt_window_attn   o = softmax(q k^T / sqrt(32) + table) v for every
//                        image, 7x7 window and head of one Swin block, read
//                        from the qkv of the image's real tokens and written
//                        to the real tokens' rows of o
//
// It replaces no TPU kernel: the JAX package has no Swin. It was added for
// SOLIDER-REID's Swin-B (models/swin.py), where each block padded its map to
// a multiple of the window, rolled and partitioned it (one row gather),
// materialised the bias + shift mask per image, ran SDPA's memory-efficient
// kernel on 49-token windows in 64-row tiles, and gathered the result back:
// about 1.6 s of card time an evaluation of market-swin-eval for 0.14 s of
// bytes, with qkv and proj run on the padded rows too.
//
// Bound: bytes. For each (window, head) q k^T and p v are 4 x 49 x 49 x 32
// = 307 kFLOP against 12.5 KB of q, k, v and o: 24 FLOP/B, far under the
// card's 295 FLOP/B ridge. One pass reads each real token's qkv (3C bf16)
// and writes its o (C bf16): at Swin-B's 384x128 and a batch of 256 that is
// 805, 403, 201 and 101 MB at stages 1-4, 0.240, 0.120, 0.060 and 0.030 ms
// at 3.35 TB/s. The tables (bias + shift mask, fp32, 0.2-3.5 MB a block)
// are read from L2.
//
// Design. A block of 4 warps holds one (window, head) and walks over IMAGES
// images. It first lists the window's real tokens in window order (a padded
// position, row >= h or column >= w of the padded map, is no token of the
// image) and writes once, in every stage of its ring, what no image changes:
// a padded position's k and v rows are the qkv bias's (a zero row through
// qkv is its bias, bit for bit), rows past the window zero. Per image only
// the real tokens' q, k and v head slices (64 bytes each) are gathered into
// shared memory, as 16-byte cp.async copies whose offsets the block computed
// once, neighbouring threads on neighbouring addresses, in a ring of STAGES
// images so that the next image's loads are in flight while one is computed.
// The real queries are compacted: Q row k holds the k-th real token, K and V
// rows stay by window position, so a warp takes 16 real queries and warps
// past them skip the image (at 24x8, stage 3, 17 or 18 of 32 warps' worth of
// queries remain). S = Q K^T on mma.sync m16n8k16 bf16 (56 key columns, 7
// tiles), fp32 accumulate; the block's table slice, at the compacted
// queries' rows, lives in registers in the accumulator's layout, read once
// for all its images, with -inf in columns 49-55; softmax in fp32 (exp2 with
// log2(e) folded into the scale and the table), P rounded to bf16
// unnormalised, O = P V (64 keys, V read with ldmatrix.trans), divided by
// the fp32 row sum; the warp's O is staged in its own Q rows and written as
// 16-byte stores to row y * w + x of the image. Tiles have 64-byte rows with
// the 16-byte chunks XOR-swizzled by row pair: ldmatrix's 8 rows hit 8
// distinct bank quads. wgmma buys nothing at 24 FLOP/B.
//
// Numerics: scores and softmax in fp32 with the table added in fp32 (the
// path it replaced rounded bias + mask to bf16 first), P in bf16 for P V as
// the memory-efficient kernel rounds it, o rounded to bf16 to nearest even.
//
// Plain C interface, loaded with ctypes (ops/_build.py). The entry point
// launches on the stream it is given, allocates nothing, and returns
// cudaGetLastError() (or cudaErrorInvalidValue for arguments it refuses).
//
// Shape contract (checked by ops/window_attn.py): qkv [B, h * w, 3C] bf16
// row-major, laid out [3, heads, 32] along its last dimension; bias [3C]
// bf16; table fp32 [windows or 1, heads, 49, >= 49] with strides
// table_lead (0: one table for every window), table_head, table_row and 1;
// order [windows * 49] int32, the padded map's row (y * wp + x) of each
// window token; o [B, h * w, C] bf16; qkv, bias and o 16-byte aligned.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int WIN = 7;
constexpr int N = WIN * WIN;       // tokens a window
constexpr int D = 32;              // head width
constexpr int WARPS = 4;           // 16 query rows each
constexpr int ROWS = 16 * WARPS;   // a tile's rows: 49 padded to 64
constexpr int KT = 7;              // n8 tiles of key columns: 56 >= 49
constexpr int CHUNKS = D * 2 / 16; // 16-byte chunks of a head's row
constexpr int TILE = ROWS * 64;    // bytes of a q, k or v tile
// Tuned on the four stage shapes at a batch of 256 (H100): a block walks
// over 16 images to amortise its set-up (8 images a block took 5-20 %
// longer, 4 images 30-60 %); six blocks an SM (80 registers, 27.6 KB of
// shared memory) with one image loading while one is computed matched or
// beat four or five blocks with two images loading.
constexpr int STAGES = 2;          // images in the ring
constexpr int IMAGES = 16;         // images a block walks over
constexpr int MIN_BLOCKS = 6;      // blocks an SM holds: 80 registers
constexpr float LOG2E = 1.4426950408889634f;

struct Params {
  const __nv_bfloat16* qkv;
  const __nv_bfloat16* bias;
  const float* table;
  const int* order;
  __nv_bfloat16* out;
  long long table_lead;
  int table_head;
  int table_row;
  int batch, h, w, wp, heads, windows;
  float scale_log2;
};

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

// Byte offset of 16-byte chunk c of row r in a tile of 64-byte rows: the
// chunks of a row pair are XOR-permuted, so that 8 consecutive rows of one
// chunk lie in 8 distinct groups of 4 banks.
__device__ __forceinline__ int swz(int r, int c) {
  return r * 64 + ((c ^ ((r >> 1) & 3)) << 4);
}

__device__ __forceinline__ void cp_async16(unsigned dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int PENDING>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(PENDING) : "memory");
}

__device__ __forceinline__ void ldsm_x4(unsigned addr, unsigned (&r)[4]) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

__device__ __forceinline__ void ldsm_x4_t(unsigned addr, unsigned (&r)[4]) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// c[16 x 8] += a[16 x 16] b[16 x 8], bf16 in, fp32 accumulate.
__device__ __forceinline__ void mma_bf16(float (&c)[4], const unsigned (&a)[4],
                                         unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Two values as a bf16 pair (lo in the low half), rounded to nearest even.
__device__ __forceinline__ unsigned pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const unsigned*>(&v);
}

// 2^x, flushing results below 2^-126 to 0 (a masked key's weight).
__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__global__ void __launch_bounds__(WARPS * 32, MIN_BLOCKS)
    window_attn_kernel(const Params p) {
  __shared__ __align__(128) unsigned char tiles[STAGES * 3 * TILE];
  __shared__ int at[ROWS];        // a window position's token row, or -1
  __shared__ int real_row[N];     // the k-th real token's row in the image
  __shared__ int real_pos[N];     // ... and its window position
  // an image's 16-byte copies: (source offset << 10) | destination offset,
  // both in 16-byte units, from the image's qkv and the stage's tiles
  __shared__ unsigned copies[N * 3 * CHUNKS];
  __shared__ int nreal;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, q4 = lane & 3;   // the mma fragments' row, pair
  const int m0 = warp * 16;
  const int head = blockIdx.x % p.heads;
  const int win = (blockIdx.x / p.heads) % p.windows;
  const int first = blockIdx.x / (p.heads * p.windows) * IMAGES;
  const int last = min(first + IMAGES, p.batch);
  const int C = p.heads * D;
  const size_t row3 = 3 * (size_t)C;
  const size_t hw = (size_t)p.h * p.w;

  // the window's real tokens, compacted in window order (warp 0)
  if (warp == 0) {
    int count = 0;
#pragma unroll
    for (int base = 0; base < ROWS; base += 32) {
      const int t = base + lane;
      int s = -1;
      if (t < N) {
        const int r = p.order[win * N + t];
        const int y = r / p.wp, x = r - y * p.wp;
        if (y < p.h && x < p.w) s = y * p.w + x;
      }
      at[t] = s;
      const unsigned real = __ballot_sync(0xffffffffu, s >= 0);
      if (s >= 0) {
        const int k = count + __popc(real & ((1u << lane) - 1u));
        real_row[k] = s;
        real_pos[k] = t;
      }
      count += __popc(real);
    }
    if (lane == 0) nreal = count;
  }
  __syncthreads();
  const int nq = nreal;

  // What no image loads, in every stage: Q rows past the real queries
  // zero; K and V rows of a padded position the bias's k and v, past 49
  // zero.
  for (int i = tid; i < STAGES * 3 * ROWS * CHUNKS; i += WARPS * 32) {
    const int c = i % CHUNKS, r = (i / CHUNKS) % ROWS;
    const int part = (i / (CHUNKS * ROWS)) % 3, stage = i / (CHUNKS * ROWS * 3);
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (part == 0 ? r < nq : r < N && at[r] >= 0) continue;
    if (part > 0 && r < N)
      v = *reinterpret_cast<const uint4*>(p.bias + part * C + head * D + c * 8);
    *reinterpret_cast<uint4*>(tiles + (stage * 3 + part) * TILE + swz(r, c)) =
        v;
  }
  // each 16-byte copy of an image: token k's q to Q row k, its k and v to
  // the rows of its window position
  const int ncopies = nq * 3 * CHUNKS;
  for (int i = tid; i < ncopies; i += WARPS * 32) {
    const int k = i / (3 * CHUNKS), part = (i / CHUNKS) % 3, c = i % CHUNKS;
    const unsigned from = (real_row[k] * (unsigned)row3 + part * C + head * D
                           + c * 8) / 8;
    copies[i] = from << 10
                | (part * TILE + swz(part == 0 ? k : real_pos[k], c)) / 16;
  }

  // the block's table slice in the accumulator's layout, times log2(e),
  // its rows those of the compacted queries; -inf in the 7 padded key
  // columns, 0 past the real queries
  float tb[KT][4];
  const float* tab = p.table + win * p.table_lead + (size_t)head * p.table_head;
#pragma unroll
  for (int j = 0; j < KT; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = m0 + g + (e >> 1) * 8, c = j * 8 + 2 * q4 + (e & 1);
      tb[j][e] = c >= N    ? -INFINITY
                 : r >= nq ? 0.f
                           : __ldg(tab + (size_t)real_pos[r] * p.table_row + c)
                                 * LOG2E;
    }
  }
  __syncthreads();
  const bool active = m0 < nq;

  auto load = [&](int b, int stage) {
    const __nv_bfloat16* img = p.qkv + (size_t)b * hw * row3;
    const unsigned base = smem_u32(tiles + stage * 3 * TILE);
    for (int i = tid; i < ncopies; i += WARPS * 32) {
      const unsigned cp = copies[i];
      cp_async16(base + (cp & 1023u) * 16, img + (size_t)(cp >> 10) * 8);
    }
  };

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (first + s < last) load(first + s, s);
    cp_async_commit();
  }
  for (int b = first, it = 0; b < last; ++b, ++it) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();   // image b landed; every warp is done with b - 1
    if (b + STAGES - 1 < last) load(b + STAGES - 1, (it + STAGES - 1) % STAGES);
    cp_async_commit();
    if (!active) continue;
    const unsigned qs = smem_u32(tiles + (it % STAGES) * 3 * TILE);
    const unsigned ks = qs + TILE, vs = ks + TILE;

    // S = Q K^T: the warp's 16 query rows against 56 key columns
    unsigned qa[2][4];
#pragma unroll
    for (int kk = 0; kk < 2; ++kk)
      ldsm_x4(qs + swz(m0 + (lane & 15), 2 * kk + (lane >> 4)), qa[kk]);
    float acc[KT][4];
#pragma unroll
    for (int j = 0; j < KT; ++j) {
      unsigned kb[4];
      ldsm_x4(ks + swz(j * 8 + (lane & 7), lane >> 3), kb);
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
      mma_bf16(acc[j], qa[0], kb[0], kb[1]);
      mma_bf16(acc[j], qa[1], kb[2], kb[3]);
    }

    // softmax over each row (rows g and g + 8 of the warp's 16), base 2
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int j = 0; j < KT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        acc[j][e] = fmaf(acc[j][e], p.scale_log2, tb[j][e]);
        mx[e >> 1] = fmaxf(mx[e >> 1], acc[j][e]);
      }
    float sum[2] = {0.f, 0.f};
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
    }
#pragma unroll
    for (int j = 0; j < KT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        acc[j][e] = exp2_approx(acc[j][e] - mx[e >> 1]);
        sum[e >> 1] += acc[j][e];
      }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      sum[i] += __shfl_xor_sync(0xffffffffu, sum[i], 1);
      sum[i] += __shfl_xor_sync(0xffffffffu, sum[i], 2);
    }

    // O = P V over 64 keys (P's columns 56-63 are 0)
    float o[4][4];
#pragma unroll
    for (int n = 0; n < 4; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[n][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      unsigned pa[4];
      pa[0] = pack_bf16(acc[2 * kk][0], acc[2 * kk][1]);
      pa[1] = pack_bf16(acc[2 * kk][2], acc[2 * kk][3]);
      if (2 * kk + 1 < KT) {
        pa[2] = pack_bf16(acc[2 * kk + 1][0], acc[2 * kk + 1][1]);
        pa[3] = pack_bf16(acc[2 * kk + 1][2], acc[2 * kk + 1][3]);
      } else {
        pa[2] = pa[3] = 0u;
      }
#pragma unroll
      for (int np = 0; np < 2; ++np) {
        unsigned vb[4];
        ldsm_x4_t(vs + swz(16 * kk + (lane & 7) + ((lane >> 3) & 1) * 8,
                           2 * np + (lane >> 4)),
                  vb);
        mma_bf16(o[2 * np], pa, vb[0], vb[1]);
        mma_bf16(o[2 * np + 1], pa, vb[2], vb[3]);
      }
    }

    // normalise, stage in the warp's own Q rows (read, and not loaded
    // again before the next barrier; rows past the real queries keep
    // finite values that no output reads), and write the real queries'
    // rows as 16-byte stores
    const float inv0 = 1.f / sum[0], inv1 = 1.f / sum[1];
    unsigned char* st = tiles + (it % STAGES) * 3 * TILE + m0 * 64;
#pragma unroll
    for (int n = 0; n < 4; ++n) {
      *reinterpret_cast<unsigned*>(st + swz(g, n) + 4 * q4) =
          pack_bf16(o[n][0] * inv0, o[n][1] * inv0);
      *reinterpret_cast<unsigned*>(st + swz(g + 8, n) + 4 * q4) =
          pack_bf16(o[n][2] * inv1, o[n][3] * inv1);
    }
    __syncwarp();
    __nv_bfloat16* out = p.out + (size_t)b * hw * C + head * D;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int r = half * 8 + (lane >> 2), c = lane & 3;
      if (m0 + r < nq)
        *reinterpret_cast<uint4*>(out + (size_t)real_row[m0 + r] * C + c * 8) =
            *reinterpret_cast<const uint4*>(st + swz(r, c));
    }
    __syncwarp();
  }
  cp_async_wait<0>();
}

}  // namespace

extern "C" {

// One Swin block's window attention: batch images of an h x w map padded
// to hp x wp (multiples of 7, less than a window more), heads of width 32.
// table_lead 0: one table [heads, 49, >= 49] for every window.
int crt_window_attn(const void* qkv, const void* bias, const void* table,
                    long long table_lead, int table_head, int table_row,
                    const void* order, void* out, int batch, int h, int w,
                    int hp, int wp, int heads, void* stream) {
  if (batch < 0 || h < 1 || w < 1 || heads < 1 || table_row < N
      || hp != (h + WIN - 1) / WIN * WIN || wp != (w + WIN - 1) / WIN * WIN)
    return (int)cudaErrorInvalidValue;
  // the copies' source offsets: 22 bits of 16-byte units an image
  if ((long long)h * w * 3 * heads * D > (8ll << 22))
    return (int)cudaErrorInvalidValue;
  if (batch == 0) return 0;
  Params p{static_cast<const __nv_bfloat16*>(qkv),
           static_cast<const __nv_bfloat16*>(bias),
           static_cast<const float*>(table),
           static_cast<const int*>(order),
           static_cast<__nv_bfloat16*>(out),
           table_lead, table_head, table_row,
           batch, h, w, wp, heads, hp / WIN * (wp / WIN),
           LOG2E / sqrtf((float)D)};
  const long long blocks =
      (long long)((batch + IMAGES - 1) / IMAGES) * p.windows * heads;
  if (blocks > INT_MAX) return (int)cudaErrorInvalidValue;
  window_attn_kernel<<<(unsigned)blocks, WARPS * 32, 0,
                       static_cast<cudaStream_t>(stream)>>>(p);
  return (int)cudaGetLastError();
}

}  // extern "C"
