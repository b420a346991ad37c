// Per-token dynamic int8 quantization.
//
// Replaces src/repro/kernels/dynamic_quant.py:dynamic_quant (the Pallas
// _kernel): per-row amax, scale = max(amax, 1e-8) / 127, and codes
// q = clip(rint(x / scale), -128, 127); returns q (M, D) int8 and the
// (M, 1) float32 row scales the next quant_linear consumes.
//
// Bound on the H100: bytes. The kernel reads 4 bytes and writes 1 byte per
// element (plus 4 per row) and does a handful of operations per element,
// far below the card's ~300 operations-per-byte balance point. At decode
// (M = 8) a call moves tens of KB, so one round trip to memory and the
// launch set its time, not the bytes.
//
// Design: each row is read from device memory once, into registers, by
// 16-byte float4 loads, consecutive threads on consecutive 16 bytes (4-byte
// loads where a row does not start 16-byte aligned: D % 4 != 0, or a view
// that starts off alignment); its amax is an exact fmaxf reduction (warp
// shuffles, then one word a warp in shared memory where a row spans
// warps), so its order does not matter; the codes are taken from the
// registers and stored 4 to a 32-bit word. The block is shaped to the row
// (plan()): below 264 rows (two for each of the 132 SMs: decode, the MoE
// routed buffers) one row a block, with as many threads as it takes to hold
// the row one float4 each (D / 4: 192 threads at D = 768, 224 at 896),
// two, four or eight each past 1024 threads (608 threads of two at 4864,
// 1024 of four at 16384), so that one round trip loads the row; from 264
// rows (an encoder forward's M = 1024) one warp or more a row, each thread
// up to eight float4s, several rows a block (8 rows of 32 threads at
// D = 768, 2 rows of 96 at 3072). A row of more than 32768 values, too
// wide for eight float4s in each of 1024 threads, streams: one block of
// 1024 threads a row reads it twice, the amax in the first read and the
// codes in the second (from L2, where the first read left it). The divide
// is IEEE (no fast math) and rintf rounds half to even, so the codes equal
// the plain version's bit for bit.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxThreads = 1024;
constexpr int kMaxVec = 8;           // float4s a thread
constexpr int kChunk = 8;            // float4s a streamed pass has in flight
constexpr int kManyRows = 2 * 132;   // from here several rows a block

struct Plan {
  int vpt;   // float4s a thread (1, 2, 4 or 8), 0 where the row streams
  int tpr;   // threads a row, a multiple of 32
  int rpb;   // rows a block
};

__host__ __device__ inline int warps_for(int nvec, int vpt) {
  return (nvec + 32 * vpt - 1) / (32 * vpt);
}

__host__ __device__ inline Plan plan(int M, int D) {
  const int nvec = (D + 3) / 4;
  Plan p;
  p.vpt = 1;
  if (M >= kManyRows) {
    p.tpr = 32 * warps_for(nvec, kMaxVec);
    while (p.vpt < kMaxVec && p.vpt * p.tpr < nvec) p.vpt *= 2;
    p.rpb = p.tpr < 256 ? 256 / p.tpr : 1;
  } else {
    while (p.vpt < kMaxVec && 32 * warps_for(nvec, p.vpt) > kMaxThreads)
      p.vpt *= 2;
    p.tpr = 32 * warps_for(nvec, p.vpt);
    p.rpb = 1;
  }
  if (p.tpr > kMaxThreads) {        // too wide for the registers: streamed
    p.vpt = 0;
    p.tpr = kMaxThreads;
    p.rpb = 1;
  }
  return p;
}

__device__ __forceinline__ uint32_t code(float x, float s) {
  const float c = fminf(fmaxf(rintf(x / s), -128.0f), 127.0f);
  return (uint32_t)(uint8_t)(int8_t)(int)c;
}

__device__ __forceinline__ float amax4(float a, float4 v) {
  return fmaxf(fmaxf(a, fmaxf(fabsf(v.x), fabsf(v.y))),
               fmaxf(fabsf(v.z), fabsf(v.w)));
}

// float4 i of a row, 4-byte loads where the row is not 16-byte aligned
// (zeros past D)
template <bool VEC>
__device__ __forceinline__ float4 load4(const float* xr, int i, int D) {
  if (VEC) return __ldg(reinterpret_cast<const float4*>(xr) + i);
  const int e = 4 * i;
  float4 v = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  v.x = __ldg(xr + e);
  if (e + 1 < D) v.y = __ldg(xr + e + 1);
  if (e + 2 < D) v.z = __ldg(xr + e + 2);
  if (e + 3 < D) v.w = __ldg(xr + e + 3);
  return v;
}

// the codes of float4 i at scale s, 4 to a 32-bit word
template <bool VEC>
__device__ __forceinline__ void store4(int8_t* qr, int i, float4 v, float s,
                                       int D) {
  if (VEC) {
    reinterpret_cast<uint32_t*>(qr)[i] = code(v.x, s) | code(v.y, s) << 8
                                         | code(v.z, s) << 16
                                         | code(v.w, s) << 24;
    return;
  }
  const int e = 4 * i;
  qr[e] = (int8_t)code(v.x, s);
  if (e + 1 < D) qr[e + 1] = (int8_t)code(v.y, s);
  if (e + 2 < D) qr[e + 2] = (int8_t)code(v.z, s);
  if (e + 3 < D) qr[e + 3] = (int8_t)code(v.w, s);
}

// the amax of a row's tpr threads: warp shuffles, then one word a warp in
// shared memory where a row spans warps (tpr is block-uniform)
__device__ __forceinline__ float row_amax(float amax, float* red, int lr,
                                          int tpr) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, off));
  if (tpr > 32) {
    const int wpr = tpr / 32;
    if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = amax;
    __syncthreads();
    amax = red[lr * wpr];
    for (int w = 1; w < wpr; ++w) amax = fmaxf(amax, red[lr * wpr + w]);
  }
  return amax;
}

// VPT > 0: a row held in VPT float4s a thread; VPT == 0: one row a block,
// read twice, kChunk float4s a thread in flight at a time
template <int VPT, bool VEC>
__global__ void __launch_bounds__(kMaxThreads)
dynamic_quant_kernel(const float* __restrict__ x, int8_t* __restrict__ q,
                     float* __restrict__ scale,
                     const float* __restrict__ amax_in, int M, int D,
                     int tpr) {
  __shared__ float red[kMaxThreads / 32];
  const int lr = threadIdx.x / tpr;          // row within the block
  const int tr = threadIdx.x - lr * tpr;     // thread within the row
  const long long row = (long long)blockIdx.x * (blockDim.x / tpr) + lr;
  const bool live = row < M;
  const float* xr = x + row * D;
  const int nvec = (D + 3) / 4;

  float4 val[VPT > 0 ? VPT : kChunk];
  float amax = 0.0f;
  if constexpr (VPT > 0) {
#pragma unroll
    for (int k = 0; k < VPT; ++k) {
      const int i = tr + k * tpr;            // float4 of the row
      val[k] = live && i < nvec ? load4<VEC>(xr, i, D)
                                : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      amax = amax4(amax, val[k]);            // zeros leave the max as it is
    }
  } else {
    for (int i0 = tr; i0 < nvec; i0 += kChunk * tpr) {
#pragma unroll
      for (int c = 0; c < kChunk; ++c) {
        const int i = i0 + c * tpr;
        val[c] = live && i < nvec ? load4<VEC>(xr, i, D)
                                  : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      }
#pragma unroll
      for (int c = 0; c < kChunk; ++c) amax = amax4(amax, val[c]);
    }
  }
  amax = row_amax(amax, red, lr, tpr);
  if (!live) return;
  // the scale-in mode: the row's amax over the whole row, of which this x
  // holds one rank's columns (a tensor-parallel mesh)
  if (amax_in != nullptr) amax = amax_in[row];
  const float s = fmaxf(amax, 1e-8f) / 127.0f;
  int8_t* qr = q + row * D;
  if constexpr (VPT > 0) {
#pragma unroll
    for (int k = 0; k < VPT; ++k) {
      const int i = tr + k * tpr;
      if (i >= nvec) break;
      store4<VEC>(qr, i, val[k], s, D);
    }
  } else {
    for (int i0 = tr; i0 < nvec; i0 += kChunk * tpr) {
#pragma unroll
      for (int c = 0; c < kChunk; ++c) {
        const int i = i0 + c * tpr;
        if (i < nvec) val[c] = load4<VEC>(xr, i, D);
      }
#pragma unroll
      for (int c = 0; c < kChunk; ++c) {
        const int i = i0 + c * tpr;
        if (i < nvec) store4<VEC>(qr, i, val[c], s, D);
      }
    }
  }
  if (tr == 0) scale[row] = s;
}

template <int VPT>
void launch(const float* x, int8_t* q, float* scale, const float* amax_in,
            int M, int D, const Plan& p, bool vec, cudaStream_t st) {
  const int blocks = (M + p.rpb - 1) / p.rpb;
  if (vec)
    dynamic_quant_kernel<VPT, true><<<blocks, p.tpr * p.rpb, 0, st>>>(
        x, q, scale, amax_in, M, D, p.tpr);
  else
    dynamic_quant_kernel<VPT, false><<<blocks, p.tpr * p.rpb, 0, st>>>(
        x, q, scale, amax_in, M, D, p.tpr);
}

}  // namespace

// The block plan for M rows of D values: float4s a thread, threads a row,
// rows a block (out[0..2]); no float4s a thread where the row streams.
extern "C" void samp_dynamic_quant_plan(int M, int D, int* out) {
  const Plan p = plan(M, D);
  out[0] = p.vpt;
  out[1] = p.tpr;
  out[2] = p.rpb;
}

// x: (M, D) float32, q: (M, D) int8, scale: (M,) float32; all contiguous,
// rows of any width. amax_in: null, or (M,) float32 row amaxes that take the
// place of the rows' own (the scale-in mode of a tensor-parallel mesh, where
// x is one rank's columns and the scale is the whole row's).
extern "C" int samp_dynamic_quant(const void* x, void* q, void* scale,
                                  const void* amax_in, int M, int D,
                                  void* stream) {
  if (M > 0 && D > 0) {
    const Plan p = plan(M, D);
    const bool vec = D % 4 == 0 && (uintptr_t)x % 16 == 0 &&
                     (uintptr_t)q % 4 == 0;
    const auto* xf = (const float*)x;
    auto* qq = (int8_t*)q;
    auto* sc = (float*)scale;
    auto* st = (cudaStream_t)stream;
    const auto* am = (const float*)amax_in;
    switch (p.vpt) {
      case 1: launch<1>(xf, qq, sc, am, M, D, p, vec, st); break;
      case 2: launch<2>(xf, qq, sc, am, M, D, p, vec, st); break;
      case 4: launch<4>(xf, qq, sc, am, M, D, p, vec, st); break;
      case 8: launch<8>(xf, qq, sc, am, M, D, p, vec, st); break;
      default: launch<0>(xf, qq, sc, am, M, D, p, vec, st); break;
    }
  }
  return (int)cudaGetLastError();
}
