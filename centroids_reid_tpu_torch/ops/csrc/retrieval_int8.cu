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

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

using namespace nvcuda;

namespace {

constexpr int BM = 128;       // query rows per block tile
constexpr int BN = 128;       // gallery rows per block tile
constexpr int BK = 32;        // depth per shared-memory stage
constexpr int LDS = BK + 8;   // bf16 row stride of the A/B stages (80 B)
constexpr int LDC = BN + 4;   // fp32 row stride of the score tile
constexpr int THREADS = 256;  // 8 warps: 2 (rows) x 4 (cols), 64 x 32 each

constexpr size_t kStageBytes = 2 * BM * LDS * sizeof(__nv_bfloat16);
constexpr size_t kTileBytes = BM * LDC * sizeof(float);

typedef wmma::fragment<wmma::accumulator, 16, 16, 16, float> Acc;

// ---------------------------------------------------------------------------
// K4. Replaces centroids_reid_tpu/ops/retrieval_int8.py::_score_block_kernel_i8
// (via _scores_pallas_i8). At the serving shape (Q = 128, G = 100352,
// D = 2048) it reads the 206 MB int8 gallery once, half of K1's bf16 read,
// and writes the same 51 MB fp32 score matrix against 53 GFLOP, so
// device-memory bandwidth bounds it as it bounds K1. Design: K1's tile
// (retrieval.cu: one 128 x 128 output tile per block, 128 x 32 stages
// through shared memory, bf16 wmma with fp32 accumulation); each thread
// issues its two query loads and its one 16-byte code load before any
// store, and widens the 16 codes to bf16 on the way into shared memory
// (exact: every code lies in [-127, 127]). The per-row scale is applied
// after the product, as the TPU kernel does, with explicitly rounded
// operations: a contracted fma of gn - 2 (s dot) would round differently
// from the plain version.
// ---------------------------------------------------------------------------
__global__ void __launch_bounds__(THREADS)
scores_i8_kernel(const __nv_bfloat16* __restrict__ q,
                 const int8_t* __restrict__ codes,
                 const float* __restrict__ scale,
                 const float* __restrict__ gn, float* __restrict__ out, int G,
                 int D) {
  extern __shared__ __align__(128) unsigned char smem[];
  __nv_bfloat16* As = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* Bs = As + BM * LDS;
  float* Cs = reinterpret_cast<float*>(smem + kStageBytes);
  const int tid = threadIdx.x, warp = tid / 32;
  const int wm = warp / 4, wn = warp % 4;
  const int q0 = blockIdx.y * BM, g0 = blockIdx.x * BN;
  // this thread's query vectors (rows qr and qr + 64, 8 bf16 at qc) and
  // code vector (row gr, 16 codes at gc) of each stage
  const int qr = tid / (BK / 8), qc = (tid % (BK / 8)) * 8;
  const int gr = tid / (BK / 16), gc = (tid % (BK / 16)) * 16;
  const __nv_bfloat16* qp = q + (size_t)(q0 + qr) * D + qc;
  const int8_t* gp = codes + (size_t)(g0 + gr) * D + gc;

  Acc c[4][2];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(c[i][j], 0.0f);

  for (int k0 = 0; k0 < D; k0 += BK) {
    const uint4 qa = *reinterpret_cast<const uint4*>(qp + k0);
    const uint4 qb = *reinterpret_cast<const uint4*>(qp + (size_t)64 * D + k0);
    const uint4 raw = *reinterpret_cast<const uint4*>(gp + k0);
    *reinterpret_cast<uint4*>(&As[qr * LDS + qc]) = qa;
    *reinterpret_cast<uint4*>(&As[(qr + 64) * LDS + qc]) = qb;
    const unsigned words[4] = {raw.x, raw.y, raw.z, raw.w};
    __nv_bfloat162* dst = reinterpret_cast<__nv_bfloat162*>(&Bs[gr * LDS + gc]);
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const unsigned w = words[i / 2] >> (16 * (i % 2));
      dst[i] = __floats2bfloat162_rn((float)(signed char)(w & 0xFFu),
                                     (float)(signed char)(w >> 8));
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> a[4];
      // B = codes^T: gallery row n holds column n of B, so Bs is B col-major
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

  for (int v = tid; v < BM * BN / 4; v += THREADS) {
    const int r = v / (BN / 4), col = (v % (BN / 4)) * 4;
    const float4 acc = *reinterpret_cast<const float4*>(&Cs[r * LDC + col]);
    const float4 s = *reinterpret_cast<const float4*>(&scale[g0 + col]);
    const float4 n = *reinterpret_cast<const float4*>(&gn[g0 + col]);
    float4 o;
    o.x = __fsub_rn(n.x, __fmul_rn(2.0f, __fmul_rn(s.x, acc.x)));
    o.y = __fsub_rn(n.y, __fmul_rn(2.0f, __fmul_rn(s.y, acc.y)));
    o.z = __fsub_rn(n.z, __fmul_rn(2.0f, __fmul_rn(s.z, acc.z)));
    o.w = __fsub_rn(n.w, __fmul_rn(2.0f, __fmul_rn(s.w, acc.w)));
    *reinterpret_cast<float4*>(&out[(size_t)(q0 + r) * G + g0 + col]) = o;
  }
}

}  // namespace

extern "C" {

int crt_scores_i8(const void* q, const void* codes, const float* scale,
                  const float* gn, float* out, int Q, int G, int D,
                  void* stream) {
  const size_t smem = kStageBytes + kTileBytes;
  cudaError_t e = cudaFuncSetAttribute(
      scores_i8_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return (int)e;
  dim3 grid(G / BN, Q / BM);
  scores_i8_kernel<<<grid, THREADS, smem, (cudaStream_t)stream>>>(
      (const __nv_bfloat16*)q, (const int8_t*)codes, scale, gn, out, G, D);
  return (int)cudaGetLastError();
}

}  // extern "C"
