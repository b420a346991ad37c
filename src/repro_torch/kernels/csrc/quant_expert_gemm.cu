// Routed MoE expert GEMM: one launch for all experts of a W8A8 stack.
//
// Replaces src/repro/kernels/ops.py:quant_expert_gemm, a Python loop over
// the E experts of the Pallas quant_linear kernel
// (src/repro/kernels/quant_linear.py:quant_linear). For each expert e,
// the G x C routed rows of the int8 codes (G, E, C, D), row (g, c) at
// offset ((g E + e) C + c) D, are multiplied by w_q[e] (D, F) int8 with
// int32 sums, and the epilogue writes acc * (x_scale * w_scale[e, n]) as
// float32 (G, E, C, F): quant_linear's epilogue, in its order. x_scale is
// per expert (E,) (static scales; a scalar plan scale arrives broadcast)
// or per row (G E C,) (per-token scales from dynamic_quant, which quantized
// the whole routed buffer in one launch before this one, as the JAX
// wrapper quantizes it in one op).
//
// Bound on the H100: at decode (8 slots: G = 1, C = 3, E = 8) the int8
// weight stack, E D F bytes (805 MB for mixtral-8x22b's 6144 x 16384
// experts), over 3.35 TB/s: about 0.24 ms a GEMM; the operations (2 G C D F
// E int8) are 100x below that. At a (4, 128) forward (C = 160) the bytes
// still bound it.
//
// Design: experts on blockIdx.z, so one launch covers the stack; per expert
// the 64 x 64 dp4a tile of quant_linear.cu over rows (G C) and columns F
// (blockIdx.y, blockIdx.x), masking the ragged edges of C, D and F: 256
// threads, each with a 4 x 4 register tile of int32 sums, walking D in
// 32-byte stages through shared memory, w[e] transposed on the way in so
// that four consecutive k of one column pack into the word __dp4a takes.
// Each weight byte is read once per 64 rows (once at decode), in 32-byte
// warp loads. At C = 3 a 64-row tile is 95% empty, so the row groups past
// the tile's live rows skip their products (quant_linear's tile computes
// all 64). Each block still walks D in turn with no loads in flight ahead
// of the products, so latency, not the bytes, bounds it: wgmma, a small-M
// tile and split-K are later work.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBM = 64;
constexpr int kBN = 64;
constexpr int kBK = 32;            // bytes of D per stage
constexpr int kKW = kBK / 4;       // packed 32-bit words per tile row
constexpr int kThreads = 256;

__device__ __forceinline__ unsigned pack4(const int8_t* p) {
  return (unsigned)(uint8_t)p[0] | ((unsigned)(uint8_t)p[1] << 8) |
         ((unsigned)(uint8_t)p[2] << 16) | ((unsigned)(uint8_t)p[3] << 24);
}

// row r = (g, c) of expert e sits at flat row (g E + e) C + c
__device__ __forceinline__ long long flat_row(int r, int e, int E, int C) {
  return ((long long)(r / C) * E + e) * C + r % C;
}

// acc[i][j] += sum_k x[row ty + 16 i][k] * w[k][n0 + tx + 16 j], thread
// (tx, ty) = (tid % 16, tid / 16). x_row: the first byte of this thread's
// loader row (tile row tid / 4), or nullptr past the tile's edge (zeros are
// staged). rows: the tile's live rows (1..64); empty row groups skip their
// products. vec_x: x rows may be read 8 bytes at a time.
__device__ __forceinline__ void mainloop(int (&acc)[4][4],
                                         const int8_t* x_row,
                                         const int8_t* __restrict__ wq,
                                         int N, int K, int n0, int rows,
                                         int vec_x) {
  __shared__ int As[kBM][kKW + 1];   // +1 word: no bank conflicts by row
  __shared__ int Bs[kBN][kKW + 1];
  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;
  const int a_row = tid >> 2;
  const int a_k = (tid & 3) * 8;
  const int b_col = tid & 63;
  const int b_k = (tid >> 6) * 8;

#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0;

  for (int k0 = 0; k0 < K; k0 += kBK) {
    {
      const int k = k0 + a_k;
      unsigned w0 = 0u, w1 = 0u;
      if (x_row != nullptr) {
        const int8_t* src = x_row + k;
        if (vec_x && k < K) {
          const int2 v = *reinterpret_cast<const int2*>(src);
          w0 = (unsigned)v.x;
          w1 = (unsigned)v.y;
        } else if (!vec_x) {
          int8_t b[8];
#pragma unroll
          for (int e = 0; e < 8; ++e) b[e] = (k + e < K) ? src[e] : (int8_t)0;
          w0 = pack4(b);
          w1 = pack4(b + 4);
        }
      }
      As[a_row][a_k / 4] = (int)w0;
      As[a_row][a_k / 4 + 1] = (int)w1;
    }
    {
      const int n = n0 + b_col;
      const int k = k0 + b_k;
      int8_t b[8];
#pragma unroll
      for (int e = 0; e < 8; ++e)
        b[e] = (n < N && k + e < K) ? wq[(long long)(k + e) * N + n] : (int8_t)0;
      Bs[b_col][b_k / 4] = (int)pack4(b);
      Bs[b_col][b_k / 4 + 1] = (int)pack4(b + 4);
    }
    __syncthreads();
    if (ty < rows) {                   // else all four rows are empty
#pragma unroll
      for (int kk = 0; kk < kKW; ++kk) {
        int b[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) b[j] = Bs[tx + 16 * j][kk];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          if (ty + 16 * i >= rows) continue;   // an empty row: no products
          const int a = As[ty + 16 * i][kk];
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] = __dp4a(a, b[j], acc[i][j]);
        }
      }
    }
    __syncthreads();
  }
}

__global__ void __launch_bounds__(kThreads)
quant_expert_gemm_kernel(const int8_t* __restrict__ xq,
                         const int8_t* __restrict__ wq,
                         const float* __restrict__ w_scale,
                         const float* __restrict__ x_scale, int xs_per_row,
                         float* __restrict__ out, int G, int E, int C, int D,
                         int F, int vec_x) {
  const int e = blockIdx.z;
  const int rows = G * C;
  const int tx = threadIdx.x & 15;
  const int ty = threadIdx.x >> 4;
  const int m0 = blockIdx.y * kBM;
  const int n0 = blockIdx.x * kBN;
  const int lr = m0 + (threadIdx.x >> 2);      // this thread's loader row
  int acc[4][4];
  mainloop(acc, lr < rows ? xq + flat_row(lr, e, E, C) * D : nullptr,
           wq + (long long)e * D * F, F, D, n0, min(kBM, rows - m0), vec_x);

  const float* ws = w_scale + (long long)e * F;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = m0 + ty + 16 * i;
    if (r >= rows) continue;
    const long long flat = flat_row(r, e, E, C);
    const float xs = xs_per_row ? x_scale[flat] : x_scale[e];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + tx + 16 * j;
      if (n >= F) continue;
      out[flat * F + n] = (float)acc[i][j] * (xs * ws[n]);
    }
  }
}

}  // namespace

// x_q (G, E, C, D) int8; w_q (E, D, F) int8; w_scale (E, F) float32;
// x_scale (E,) float32 (xs_per_row 0) or (G E C,) (xs_per_row 1); out
// (G, E, C, F) float32. vec_x: code rows may be read 8 bytes at a time
// (D % 8 == 0 and x_q 8-byte aligned).
extern "C" int samp_quant_expert_gemm(const void* x_q, const void* w_q,
                                      const void* w_scale,
                                      const void* x_scale, int xs_per_row,
                                      void* out, int G, int E, int C, int D,
                                      int F, int vec_x, void* stream) {
  if (G > 0 && E > 0 && C > 0 && F > 0) {
    const dim3 grid((F + kBN - 1) / kBN, (G * C + kBM - 1) / kBM, E);
    quant_expert_gemm_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
        (const int8_t*)x_q, (const int8_t*)w_q, (const float*)w_scale,
        (const float*)x_scale, xs_per_row, (float*)out, G, E, C, D, F,
        vec_x);
  }
  return (int)cudaGetLastError();
}
