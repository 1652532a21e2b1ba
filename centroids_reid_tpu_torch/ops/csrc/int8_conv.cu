// int8 conv + requantization kernels for Hopper (sm_90a): the fused convs
// of the int8 PTQ embed (models/quantized.py).
//
//   K5 crt_matmul_requant    int8 [M, K] x [K, N] -> int8 [M, N]
//   K6 crt_conv3x3_requant   stride-1, pad-1 3x3 int8 conv over NHWC rows
//                            [B*H*W, K] with HWIO weights [9, K, N]
//
// Both accumulate exactly in int32 on the int8 tensor cores and apply the
// serving epilogue before anything leaves the block: per-channel fp32 scale
// and bias, an optional int8 residual times a scalar, an optional ReLU,
// rounding half away from zero and a clip to +-127. Plain C interface,
// loaded with ctypes (ops/_build.py); launches on the stream it is given,
// allocates nothing, returns cudaGetLastError().
//
// Shape contract (checked by ops/int8_conv.py): K % 64 == 0, N % 64 == 0,
// every M; all tensors contiguous and 16-byte aligned.

#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

namespace {

using namespace nvcuda;

constexpr int BM = 128;       // output rows (pixels) per block
constexpr int BN = 64;        // output channels per block
constexpr int BK = 64;        // input channels per shared-memory stage
constexpr int THREADS = 256;  // 8 warps: 4 (rows) x 2 (channels), 32 x 32 each
// The operand stages are stored in slabs of 16 columns: slab s holds
// columns [16 s, 16 s + 16) of every row, 16 contiguous bytes per row, so
// every 16 x 16 int8 fragment starts on the 32-byte boundary that
// load_matrix_sync requires. The extra 32 bytes per slab put the 8 rows x
// 4 slabs that one quarter-warp stores on distinct banks.
constexpr int SLAB_A = BM * 16 + 32;
constexpr int SLAB_B = BK * 16 + 32;
constexpr int LDC = BN + 4;   // int32 row stride of the accumulator tile

typedef wmma::fragment<wmma::accumulator, 16, 16, 16, int> Acc;

struct Epilogue {
  const float* scale;      // [N]
  const float* bias;       // [N]
  const int8_t* res;       // [M, N] or null
  const float* res_scale;  // [1], read when res is set
  int relu;
};

// The epilogue of centroids_reid_tpu/ops/int8_conv.py::_epilogue, op for op,
// every operation rounded explicitly so no fma contraction changes a bit.
__device__ __forceinline__ signed char requant(int acc, float s, float b,
                                               signed char r, float rs,
                                               const Epilogue& e) {
  float t = __fadd_rn(__fmul_rn(__int2float_rn(acc), s), b);
  if (e.res) t = __fadd_rn(t, __fmul_rn(__int2float_rn(r), rs));
  if (e.relu) {
    t = __fadd_rn(fminf(fmaxf(t, 0.0f), 127.0f), 0.5f);
  } else {
    t = fminf(fmaxf(t, -127.0f), 127.0f);
    t = __fadd_rn(t, t >= 0.0f ? 0.5f : -0.5f);
  }
  return (signed char)__float2int_rz(t);
}

// ---------------------------------------------------------------------------
// K5 (TAPS = 1). Replaces centroids_reid_tpu/ops/int8_conv.py::_matmul_requant.
// K6 (TAPS = 9). Replaces centroids_reid_tpu/ops/int8_conv.py::_conv3x3_requant.
//
// An implicit GEMM: output row m is pixel (b, h, w) of the NHWC tensor; tap
// (dh, dw) of the 3x3 conv reads input row m + dh W + dw, or zeros where
// (h + dh, w + dw) lies outside the image (the zero padding). The TPU kernel
// rolls whole-image tiles and masks the wrapped rows; here each block reads
// the rows it needs directly, so a tile may span images. Each block owns a
// 128 x 64 output tile and walks taps x K in 64-deep stages through shared
// memory; wmma m16n16k16 on signed char with int32 accumulation is exact.
// The int32 tile goes through shared memory to the epilogue, which writes
// int8 with 4-byte stores. Bound: at the embed's shapes (K, N <= 2048,
// M = 1024 .. 16384 at 8 images) the int8 tensor-core work is small and the
// kernel is bound by its unpipelined loads and the block's barrier latency;
// cp.async / TMA pipelining and wgmma are later work.
// ---------------------------------------------------------------------------
template <int TAPS>
__global__ void __launch_bounds__(THREADS)
requant_gemm_kernel(const int8_t* __restrict__ x, const int8_t* __restrict__ w,
                    Epilogue ep, int8_t* __restrict__ out, int M, int K, int N,
                    int H, int W) {
  __shared__ __align__(128) signed char As[BK / 16 * SLAB_A];
  __shared__ __align__(128) signed char Bs[BN / 16 * SLAB_B];
  __shared__ __align__(128) int Cs[BM * LDC];
  const int tid = threadIdx.x, warp = tid / 32;
  const int wm = warp / 2, wn = warp % 2;
  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * BN;

  // This thread stages A rows ra and ra + 64 (slab sa of each) and B row kb
  // (slab sb): 16-byte vectors, four consecutive threads per 64-byte row.
  const int ra = tid / 4, sa = tid % 4, kb = tid / 4, sb = tid % 4;
  bool live[2];
  int ph[2], pw[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int m = m0 + ra + 64 * i;
    live[i] = m < M;
    ph[i] = (m / W) % H;
    pw[i] = m % W;
  }

  Acc c[2][2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(c[i][j], 0);

  for (int tap = 0; tap < TAPS; ++tap) {
    const int dh = TAPS == 9 ? tap / 3 - 1 : 0;
    const int dw = TAPS == 9 ? tap % 3 - 1 : 0;
    bool ok[2];
#pragma unroll
    for (int i = 0; i < 2; ++i)
      ok[i] = live[i] && ph[i] + dh >= 0 && ph[i] + dh < H && pw[i] + dw >= 0 &&
              pw[i] + dw < W;
    const int shift = dh * W + dw;
    for (int k0 = 0; k0 < K; k0 += BK) {
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int r = ra + 64 * i;
        int4 v = make_int4(0, 0, 0, 0);
        if (ok[i])
          v = *reinterpret_cast<const int4*>(
              &x[(size_t)(m0 + r + shift) * K + k0 + sa * 16]);
        *reinterpret_cast<int4*>(&As[sa * SLAB_A + r * 16]) = v;
      }
      *reinterpret_cast<int4*>(&Bs[sb * SLAB_B + kb * 16]) =
          *reinterpret_cast<const int4*>(
              &w[((size_t)tap * K + k0 + kb) * N + n0 + sb * 16]);
      __syncthreads();
#pragma unroll
      for (int s = 0; s < BK / 16; ++s) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, signed char, wmma::row_major> a[2];
        wmma::fragment<wmma::matrix_b, 16, 16, 16, signed char, wmma::row_major> b[2];
#pragma unroll
        for (int i = 0; i < 2; ++i)
          wmma::load_matrix_sync(a[i], As + s * SLAB_A + (wm * 32 + i * 16) * 16, 16);
#pragma unroll
        for (int j = 0; j < 2; ++j)
          wmma::load_matrix_sync(b[j], Bs + (wn * 2 + j) * SLAB_B + s * 16 * 16, 16);
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int j = 0; j < 2; ++j) wmma::mma_sync(c[i][j], a[i], b[j], c[i][j]);
      }
      __syncthreads();
    }
  }
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j)
      wmma::store_matrix_sync(Cs + (wm * 32 + i * 16) * LDC + wn * 32 + j * 16,
                              c[i][j], LDC, wmma::mem_row_major);
  __syncthreads();

  const float rs = ep.res ? *ep.res_scale : 0.0f;
  for (int v = tid; v < BM * BN / 4; v += THREADS) {
    const int r = v / (BN / 4), c4 = (v % (BN / 4)) * 4;
    const int m = m0 + r;
    if (m >= M) continue;
    const int n = n0 + c4;
    const int4 a = *reinterpret_cast<const int4*>(&Cs[r * LDC + c4]);
    const float4 s = *reinterpret_cast<const float4*>(&ep.scale[n]);
    const float4 b = *reinterpret_cast<const float4*>(&ep.bias[n]);
    char4 rv = make_char4(0, 0, 0, 0);
    if (ep.res) rv = *reinterpret_cast<const char4*>(&ep.res[(size_t)m * N + n]);
    char4 o;
    o.x = requant(a.x, s.x, b.x, rv.x, rs, ep);
    o.y = requant(a.y, s.y, b.y, rv.y, rs, ep);
    o.z = requant(a.z, s.z, b.z, rv.z, rs, ep);
    o.w = requant(a.w, s.w, b.w, rv.w, rs, ep);
    *reinterpret_cast<char4*>(&out[(size_t)m * N + n]) = o;
  }
}

template <int TAPS>
int launch(const void* x, const void* w, const float* scale, const float* bias,
           const void* res, const float* res_scale, int relu, void* out, int M,
           int K, int N, int H, int W, void* stream) {
  if (M == 0) return 0;
  const Epilogue ep{scale, bias, (const int8_t*)res, res_scale, relu};
  dim3 grid((M + BM - 1) / BM, N / BN);
  requant_gemm_kernel<TAPS><<<grid, THREADS, 0, (cudaStream_t)stream>>>(
      (const int8_t*)x, (const int8_t*)w, ep, (int8_t*)out, M, K, N, H, W);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// res and res_scale may be null (no residual).
int crt_matmul_requant(const void* x, const void* w, const float* scale,
                       const float* bias, const void* res,
                       const float* res_scale, int relu, void* out, int M,
                       int K, int N, void* stream) {
  return launch<1>(x, w, scale, bias, res, res_scale, relu, out, M, K, N, 1, 1,
                   stream);
}

// x: NHWC rows [B*H*W, K]; w: HWIO [3, 3, K, N] = [9, K, N].
int crt_conv3x3_requant(const void* x, const void* w, const float* scale,
                        const float* bias, const void* res,
                        const float* res_scale, int relu, void* out, int B,
                        int H, int W, int K, int N, void* stream) {
  return launch<9>(x, w, scale, bias, res, res_scale, relu, out, B * H * W, K,
                   N, H, W, stream);
}

}  // extern "C"
