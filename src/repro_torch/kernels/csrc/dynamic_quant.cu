// Per-token dynamic int8 quantization.
//
// Replaces src/repro/kernels/dynamic_quant.py:dynamic_quant (the Pallas
// _kernel): per-row amax, scale = max(amax, 1e-8) / 127, and codes
// q = clip(rint(x / scale), -128, 127); returns q (M, D) int8 and the
// (M, 1) float32 row scales the next quant_linear consumes.
//
// Bound on the H100: bytes. The kernel reads 4 bytes and writes 1 byte per
// element (plus 4 per row) and does a handful of operations per element,
// far below the card's ~300 operations-per-byte balance point.
//
// Design: one block of 256 threads per row. A block-wide max reduction
// (warp shuffles, then one word per warp in shared memory) gives the row
// amax; the second pass re-reads the row, which a 768- or 3072-wide f32 row
// leaves in L1, so device memory sees one read and one write per element.
// The divide is IEEE (no fast math) and rintf rounds half to even, so the
// codes equal the plain version's bit for bit.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__device__ float block_max(float v, float* red) {
  for (int off = 16; off > 0; off >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  if (lane == 0) red[warp] = v;
  __syncthreads();
  float m = red[0];
  for (int w = 1; w < (int)(blockDim.x >> 5); ++w) m = fmaxf(m, red[w]);
  return m;
}

__global__ void __launch_bounds__(kThreads)
dynamic_quant_kernel(const float* __restrict__ x, int8_t* __restrict__ q,
                     float* __restrict__ scale, int D) {
  __shared__ float red[kThreads / 32];
  const long long row = blockIdx.x;
  const float* xr = x + row * D;
  int8_t* qr = q + row * D;
  float amax = 0.0f;
  for (int i = threadIdx.x; i < D; i += blockDim.x)
    amax = fmaxf(amax, fabsf(xr[i]));
  amax = block_max(amax, red);
  const float s = fmaxf(amax, 1e-8f) / 127.0f;
  for (int i = threadIdx.x; i < D; i += blockDim.x) {
    const float c = fminf(fmaxf(rintf(xr[i] / s), -128.0f), 127.0f);
    qr[i] = (int8_t)(int)c;
  }
  if (threadIdx.x == 0) scale[row] = s;
}

}  // namespace

// x: (M, D) float32, q: (M, D) int8, scale: (M,) float32; all contiguous.
extern "C" int samp_dynamic_quant(const void* x, void* q, void* scale, int M,
                                  int D, void* stream) {
  if (M > 0 && D > 0) {
    dynamic_quant_kernel<<<M, kThreads, 0, (cudaStream_t)stream>>>(
        (const float*)x, (int8_t*)q, (float*)scale, D);
  }
  return (int)cudaGetLastError();
}
