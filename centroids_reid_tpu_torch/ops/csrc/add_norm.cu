// The residual add, LayerNorm and cast of one pre-norm site of a ViT block
// for Hopper (sm_90a):
//
//   K8 crt_add_norm   x_new = x + delta (in the residual stream's type,
//                     fp32 or bf16), y = LayerNorm(x_new) with fp32
//                     statistics, y written in fp32 or bf16, in one pass
//                     over each row
//
// It replaces no TPU kernel: the JAX package has no ViT. It was added for
// TransReID's blocks (models/transreid.py), where bf16 autocast keeps the
// residual stream and the LayerNorms in fp32 and casts each LayerNorm's
// output to bf16 for the next linear: three memory-bound passes a site
// (the add: read 4 + 2 B, write 4; the LayerNorm: read 4, write 4; the
// cast: read 4, write 2), 24 bytes an element, about as much card time in
// an evaluation as the GEMMs.
//
// Bound: bytes. One pass reads x (4 B) and delta (2 B bf16, 4 B fp32, or
// none) and writes x_new (4 B, only with delta) and y (2 B bf16 or 4 B
// fp32): 12 bytes an element at a bf16 site with delta, half the three
// passes'. At [54,016, 768] (TransReID's [256, 211] tokens) that is 498 MB,
// 0.149 ms at 3.35 TB/s; the few FLOPs an element are nothing beside it.
//
// Design. One warp a row, the row in registers: lane l holds the 8-element
// chunks l, l + 32, ... (24 values at D = 768), so every access is a
// 16-byte load or store per lane: a warp's bf16 access covers 512
// contiguous bytes, its two fp32 accesses 1,024 between them. The row is read
// once and written once: the mean, then the variance about it (two passes
// over the registers, warp shuffles between lanes), both in fp32. A block
// holds 8 rows (256 threads); the grid one block per 8 rows, 6,752 blocks
// at 54,016 rows, so the card has many warps of loads in flight on every
// SM. D is a template parameter, so the loops unroll and the register
// arrays have fixed sizes; only 768 (ViT-B, TransReID's) is dispatched, and
// another width is added with the configuration that runs it.
//
// The residual stream is fp32 (autocast's) or bf16 (a model cast wholly to
// bf16, as the benchmark's bf16 control runs it): a bf16 stream has bf16
// x, delta, x_new, weight and bias, and the same fp32 arithmetic inside,
// as PyTorch's bf16 add and LayerNorm compute; it moves 8 bytes an element
// with delta and a bf16 y.
//
// Numerics follow what autocast computes today: x + delta in fp32 (a bf16
// delta widened exactly, so x_new is bit for bit PyTorch's add; with a bf16
// stream the fp32 sum rounded to bf16 to nearest even, as PyTorch's bf16
// add, and the statistics taken over the rounded x_new); mean and
// biased variance in fp32, rstd = rsqrtf(var + eps), y = w (rstd (x -
// mean)) + b as PyTorch's vectorized LayerNorm writes it; y rounded to
// bf16 to nearest even, as the cast before the linear does. The statistics
// are summed in another order than PyTorch's Welford, so y can differ from
// autocast's by fp32 rounding (one bf16 ulp after the cast).
//
// Plain C interface, loaded with ctypes (ops/_build.py). The entry point
// launches on the stream it is given, allocates nothing, and returns
// cudaGetLastError() (or cudaErrorInvalidValue for arguments it refuses).
//
// Shape contract (checked by ops/add_norm.py): x [rows, D] row-major, fp32
// or bf16 (the stream's type); delta [rows, D] fp32 or bf16 with an fp32
// stream, bf16 with a bf16 one (or null); w and b [D] and x_out [rows, D]
// (written only with delta) in the stream's type; y [rows, D] fp32 or
// bf16; all 16-byte aligned.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int WARPS = 8;   // rows per block, one warp a row
constexpr int VEC = 8;     // elements a lane moves at once

enum Delta { kNone = 0, kF32 = 1, kBF16 = 2 };

struct Params {
  const void* x;
  const void* delta;
  const void* w;
  const void* b;
  void* x_out;
  void* y;
  int rows;
  float eps;
};

// Streamed (read once): x and delta.
__device__ __forceinline__ void load8(const float* p, float* v) {
  const float4 a = __ldcs(reinterpret_cast<const float4*>(p));
  const float4 c = __ldcs(reinterpret_cast<const float4*>(p) + 1);
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = c.x; v[5] = c.y; v[6] = c.z; v[7] = c.w;
}

// A bf16 is the top half of the fp32 with the same value: widening is a
// shift, exact.
__device__ __forceinline__ void load8(const __nv_bfloat16* p, float* v) {
  const uint4 u = __ldcs(reinterpret_cast<const uint4*>(p));
  const unsigned w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    v[2 * j] = __uint_as_float(w[j] << 16);
    v[2 * j + 1] = __uint_as_float(w[j] & 0xffff0000u);
  }
}

// Read by every row: the LayerNorm's weight and bias, from L1 / L2.
__device__ __forceinline__ void load8_cached(const float* p, float* v) {
  const float4 a = __ldg(reinterpret_cast<const float4*>(p));
  const float4 c = __ldg(reinterpret_cast<const float4*>(p) + 1);
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = c.x; v[5] = c.y; v[6] = c.z; v[7] = c.w;
}

__device__ __forceinline__ void load8_cached(const __nv_bfloat16* p,
                                             float* v) {
  const uint4 u = __ldg(reinterpret_cast<const uint4*>(p));
  const unsigned w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    v[2 * j] = __uint_as_float(w[j] << 16);
    v[2 * j + 1] = __uint_as_float(w[j] & 0xffff0000u);
  }
}

__device__ __forceinline__ void store8(float* p, const float* v) {
  reinterpret_cast<float4*>(p)[0] = make_float4(v[0], v[1], v[2], v[3]);
  reinterpret_cast<float4*>(p)[1] = make_float4(v[4], v[5], v[6], v[7]);
}

// Rounded to nearest even, as PyTorch's cast to bf16.
__device__ __forceinline__ unsigned pack_bf16(float lo, float hi) {
  return (unsigned)__bfloat16_as_ushort(__float2bfloat16_rn(lo))
         | ((unsigned)__bfloat16_as_ushort(__float2bfloat16_rn(hi)) << 16);
}

__device__ __forceinline__ void store8(__nv_bfloat16* p, const float* v) {
  *reinterpret_cast<uint4*>(p) =
      make_uint4(pack_bf16(v[0], v[1]), pack_bf16(v[2], v[3]),
                 pack_bf16(v[4], v[5]), pack_bf16(v[6], v[7]));
}

__device__ __forceinline__ float warp_sum(float s) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) s += __shfl_xor_sync(0xffffffffu, s, off);
  return s;
}

template <int D, bool X_BF16, int DELTA, bool Y_BF16>
__global__ void __launch_bounds__(WARPS * 32)
    add_norm_kernel(const Params p) {
  static_assert(D % VEC == 0, "whole 16-byte chunks");
  static_assert(!X_BF16 || DELTA != kF32, "a bf16 stream takes a bf16 delta");
  using TX = std::conditional_t<X_BF16, __nv_bfloat16, float>;
  using TY = std::conditional_t<Y_BF16, __nv_bfloat16, float>;
  const TX* x = static_cast<const TX*>(p.x);
  constexpr int CHUNKS = D / VEC;
  constexpr int PER_LANE = (CHUNKS + 31) / 32;
  constexpr bool kFull = CHUNKS % 32 == 0;   // every lane owns PER_LANE chunks
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * WARPS + (threadIdx.x >> 5);
  if (row >= p.rows) return;
  const size_t base = (size_t)row * D;

  // x + delta, the whole row in registers; every load issued before the
  // first sum needs it
  float v[PER_LANE][VEC];
#pragma unroll
  for (int i = 0; i < PER_LANE; ++i) {
    const int e = (lane + 32 * i) * VEC;
    if (kFull || e < D) {
      load8(x + base + e, v[i]);
      if constexpr (DELTA != kNone) {
        float d[VEC];
        if constexpr (DELTA == kBF16) {
          load8(static_cast<const __nv_bfloat16*>(p.delta) + base + e, d);
        } else {
          load8(static_cast<const float*>(p.delta) + base + e, d);
        }
#pragma unroll
        for (int j = 0; j < VEC; ++j) v[i][j] += d[j];
        if constexpr (X_BF16) {
#pragma unroll
          for (int j = 0; j < VEC; ++j)
            v[i][j] = __bfloat162float(__float2bfloat16_rn(v[i][j]));
        }
      }
    } else {
#pragma unroll
      for (int j = 0; j < VEC; ++j) v[i][j] = 0.f;
    }
  }

  float s = 0.f;
#pragma unroll
  for (int i = 0; i < PER_LANE; ++i)
#pragma unroll
    for (int j = 0; j < VEC; ++j) s += v[i][j];
  const float mean = warp_sum(s) / D;

  float q = 0.f;
#pragma unroll
  for (int i = 0; i < PER_LANE; ++i) {
    const int e = (lane + 32 * i) * VEC;
    if (kFull || e < D) {
#pragma unroll
      for (int j = 0; j < VEC; ++j) {
        const float c = v[i][j] - mean;
        q += c * c;
      }
    }
  }
  const float rstd = rsqrtf(warp_sum(q) / D + p.eps);

#pragma unroll
  for (int i = 0; i < PER_LANE; ++i) {
    const int e = (lane + 32 * i) * VEC;
    if (kFull || e < D) {
      if constexpr (DELTA != kNone)
        store8(static_cast<TX*>(p.x_out) + base + e, v[i]);
      float g[VEC], bb[VEC], o[VEC];
      load8_cached(static_cast<const TX*>(p.w) + e, g);
      load8_cached(static_cast<const TX*>(p.b) + e, bb);
#pragma unroll
      for (int j = 0; j < VEC; ++j) o[j] = g[j] * (rstd * (v[i][j] - mean)) + bb[j];
      store8(static_cast<TY*>(p.y) + base + e, o);
    }
  }
}

template <int D, bool X_BF16, int DELTA, bool Y_BF16>
int launch(const Params& p, cudaStream_t stream) {
  const int blocks = (p.rows + WARPS - 1) / WARPS;
  add_norm_kernel<D, X_BF16, DELTA, Y_BF16>
      <<<blocks, WARPS * 32, 0, stream>>>(p);
  return (int)cudaGetLastError();
}

template <int D, bool X_BF16, int DELTA>
int launch_y(const Params& p, int y_bf16, cudaStream_t stream) {
  return y_bf16 ? launch<D, X_BF16, DELTA, true>(p, stream)
                : launch<D, X_BF16, DELTA, false>(p, stream);
}

template <int D>
int launch_delta(const Params& p, int x_bf16, int delta_kind, int y_bf16,
                 cudaStream_t stream) {
  if (x_bf16) {
    switch (delta_kind) {
      case kNone: return launch_y<D, true, kNone>(p, y_bf16, stream);
      case kBF16: return launch_y<D, true, kBF16>(p, y_bf16, stream);
    }
    return (int)cudaErrorInvalidValue;
  }
  switch (delta_kind) {
    case kNone: return launch_y<D, false, kNone>(p, y_bf16, stream);
    case kF32: return launch_y<D, false, kF32>(p, y_bf16, stream);
    case kBF16: return launch_y<D, false, kBF16>(p, y_bf16, stream);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// x_bf16: the stream's type (x, w, b, x_out) is bf16 (1) or fp32 (0);
// delta_kind: 0 none (x_out not written), 1 fp32 (fp32 stream only), 2
// bf16; y_bf16: y's type is bf16 (1) or fp32 (0). D must be 768.
int crt_add_norm(const void* x, int x_bf16, const void* delta,
                 int delta_kind, const void* w, const void* b, void* x_out,
                 void* y, int y_bf16, int rows, int D, float eps,
                 void* stream) {
  if (rows < 0 || delta_kind < kNone || delta_kind > kBF16
      || (x_bf16 && delta_kind == kF32)
      || (delta_kind != kNone && (delta == nullptr || x_out == nullptr)))
    return (int)cudaErrorInvalidValue;
  if (rows == 0) return 0;
  const Params p{x, delta, w, b, x_out, y, rows, eps};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D != 768) return (int)cudaErrorInvalidValue;
  return launch_delta<768>(p, x_bf16, delta_kind, y_bf16, s);
}

}  // extern "C"
