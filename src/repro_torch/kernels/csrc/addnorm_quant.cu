// Fused residual add + bias + LayerNorm/RMSNorm + int8 requantization.
//
// Replaces src/repro/kernels/addnorm_quant.py:82, the Pallas _kernel of
// addnorm_quant. Per row of D:
//   h = x * x_in_scale + residual + bias        (written out: the residual)
//   y = layernorm(h) * gamma + beta   or   rmsnorm(h) * gamma   (eps 1e-6)
//   q = clip(rint(y / x_scale), -128, 127)      (feeds the next quant GEMM)
// x arrives as float32 or as int8 codes (dequantized by x_in_scale).
//
// Bound on the H100: bytes. Per element it reads x and the residual and
// writes h and q (13 bytes for float x, 10 for int8 x) against some ten
// operations, far below the card's ~300 operations-per-byte balance point.
// At decode (8 rows) a call moves tens of KB: one round trip to memory and
// the launch set its time, not the bytes.
//
// Design: one read of each input, the row held in registers. Two warps (64
// threads) hold a row: thread l of the row loads the float4s at elements
// 256 k + 4 l (k = 0, 1, ...; char4 for int8 x; 4-byte loads where a row
// is not 16-byte aligned), every load issued before the first sum, and
// writes h as float4 and the codes 4 to a 32-bit word. The norm statistics
// must sum in row_sum's order (kernels/addnorm_quant.py), the order of the
// reference backend's norms, which models 256 threads: thread t adds x[t],
// x[t + 256], ... in turn, each warp of 32 adds its partials in a butterfly
// (offsets 16, 8, 4, 2, 1), and the 8 warp sums are added in turn. Thread
// l holds virtual threads 4 l .. 4 l + 3 for every k, so it folds over k
// in registers; virtual thread 4 l + c sits in virtual warp l >> 3 at
// virtual lane 4 (l & 7) + c, so the butterfly's offsets 16, 8 and 4 are
// shuffles to lanes l ^ 4, l ^ 2, l ^ 1, and 2 and 1 are adds between the
// registers c ^ 2, c ^ 1 (float addition commutes, so each pair sums to the
// same bits); the 8 virtual-warp sums take one shared-memory exchange and
// are added in turn. Each reduction (the mean, then the squared deviations
// from it, the two-pass variance the JAX kernel computes; or the sum of
// squares for RMSNorm) is that one exchange and one barrier. The block is
// shaped to the rows (plan()): below 264 rows (decode) one row a block, so
// the rows spread over the SMs; from 264 (an encoder forward's 1024) two
// rows a block of 128 threads (on the H100 1.5-4% faster than four). A
// thread holds up to 32 float4s of h (rows of up to 8192 values) and, up
// to 2048 values, gamma and beta beside it, read with x so that the row is
// one round trip to memory; a wider row streams in the same order, 8
// float4s a thread in flight at a time: the first read writes h, and the
// variance and the codes read the thread's own h back (from L2). The
// divides by D and by x_scale are IEEE, 1 / sqrtf is correctly rounded (no
// fast math) and rintf rounds half to even, as the plain version computes
// them (the codes' divides cost 6-10% of the kernel on the H100); the build
// keeps -fmad=false, so h equals the plain version's bit for bit and the
// statistics round alike. 1 / sqrtf can differ from XLA's rsqrt in the
// last ulp, which moves a code at a rounding tie against the JAX package,
// inside the kernel's stated budget.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kRowThreads = 64;      // two warps a row
constexpr int kVirtualWarps = 8;     // row_sum's 256 threads
constexpr int kMaxVec = 32;          // float4s of h a thread holds
constexpr int kManyRows = 2 * 132;   // from here several rows a block
constexpr int kRowsPerBlock = 2;
constexpr int kPrefetchVec = 8;      // gamma, beta read with h up to here
constexpr int kChunk = 8;            // float4s a streamed pass has in flight

struct Plan {
  int vpt;   // float4s a thread holds (1 .. 32), 0 where the row streams
  int rpb;   // rows a block
};

__host__ __device__ inline Plan plan(int M, int D) {
  const int need = ((D + 3) / 4 + kRowThreads - 1) / kRowThreads;
  Plan p;
  p.vpt = 1;
  while (p.vpt < need) p.vpt *= 2;
  if (p.vpt > kMaxVec) p.vpt = 0;
  p.rpb = M >= kManyRows ? kRowsPerBlock : 1;
  return p;
}

struct Args {
  const float* xf;       // float x, or null
  const int8_t* xq;      // int8 x, or null
  const float* res;
  const float* bias;
  const float* gamma;
  const float* beta;     // or null
  const float* x_scale;
  const float* x_in_scale;  // or null (1.0)
  float* h;
  int8_t* q;
  int M, D, rms;
  float eps;
};

__device__ __forceinline__ float4 zero4() {
  return make_float4(0.0f, 0.0f, 0.0f, 0.0f);
}

// float4 i of a D-long vector: one 16-byte load, or 4-byte loads of the
// elements below D (zeros past it)
template <bool VEC>
__device__ __forceinline__ float4 get4(const float* p, int i, int D) {
  if (VEC) return __ldg(reinterpret_cast<const float4*>(p) + i);
  const int e = 4 * i;
  float4 v = zero4();
  v.x = __ldg(p + e);
  if (e + 1 < D) v.y = __ldg(p + e + 1);
  if (e + 2 < D) v.z = __ldg(p + e + 2);
  if (e + 3 < D) v.w = __ldg(p + e + 3);
  return v;
}

template <bool VEC>
__device__ __forceinline__ float4 get4(const int8_t* p, int i, int D) {
  if (VEC) {
    const char4 c = __ldg(reinterpret_cast<const char4*>(p) + i);
    return make_float4(c.x, c.y, c.z, c.w);
  }
  const int e = 4 * i;
  float4 v = zero4();
  v.x = p[e];
  if (e + 1 < D) v.y = p[e + 1];
  if (e + 2 < D) v.z = p[e + 2];
  if (e + 3 < D) v.w = p[e + 3];
  return v;
}

// h's float4 i of the row at element `base`: (x * x_in_scale + residual)
// + bias, each step rounded
template <bool VEC, bool I8>
__device__ __forceinline__ float4 form_h(const Args& a, long long base, int i,
                                         float xs_in) {
  const float4 x = I8 ? get4<VEC>(a.xq + base, i, a.D)
                      : get4<VEC>(a.xf + base, i, a.D);
  const float4 r = get4<VEC>(a.res + base, i, a.D);
  const float4 b = get4<VEC>(a.bias, i, a.D);
  return make_float4((x.x * xs_in + r.x) + b.x, (x.y * xs_in + r.y) + b.y,
                     (x.z * xs_in + r.z) + b.z, (x.w * xs_in + r.w) + b.w);
}

template <bool VEC>
__device__ __forceinline__ void put_h(float* h, int i, float4 v, int D) {
  if (VEC) {
    reinterpret_cast<float4*>(h)[i] = v;
    return;
  }
  const int e = 4 * i;
  h[e] = v.x;
  if (e + 1 < D) h[e + 1] = v.y;
  if (e + 2 < D) h[e + 2] = v.z;
  if (e + 3 < D) h[e + 3] = v.w;
}

// the thread's own h read back (written by this kernel: not through the
// read-only cache)
template <bool VEC>
__device__ __forceinline__ float4 own_h(const float* h, int i, int D) {
  if (VEC) return reinterpret_cast<const float4*>(h)[i];
  const int e = 4 * i;
  float4 v = zero4();
  v.x = h[e];
  if (e + 1 < D) v.y = h[e + 1];
  if (e + 2 < D) v.z = h[e + 2];
  if (e + 3 < D) v.w = h[e + 3];
  return v;
}

__device__ __forceinline__ float4 square4(float4 v) {
  return make_float4(v.x * v.x, v.y * v.y, v.z * v.z, v.w * v.w);
}

// (h - mu)^2 of float4 i, zeros past D (row_sum pads the squares)
__device__ __forceinline__ float4 deviation4(float4 v, float mu, int i,
                                             int D) {
  const int e = 4 * i;
  const float dx = v.x - mu, dy = v.y - mu, dz = v.z - mu, dw = v.w - mu;
  return make_float4(e < D ? dx * dx : 0.0f, e + 1 < D ? dy * dy : 0.0f,
                     e + 2 < D ? dz * dz : 0.0f, e + 3 < D ? dw * dw : 0.0f);
}

// virtual thread 4 l + c adds its next value: the first one starts it
__device__ __forceinline__ void fold(float (&p)[4], float4 v, bool first) {
  if (first) {
    p[0] = v.x; p[1] = v.y; p[2] = v.z; p[3] = v.w;
  } else {
    p[0] += v.x; p[1] += v.y; p[2] += v.z; p[3] += v.w;
  }
}

// The row's sum in row_sum's order from the 4 virtual threads of each of
// its 64 lanes (tr, the lane in the row): the warp butterfly's offsets 16,
// 8 and 4 as shuffles to lanes tr ^ 4, ^ 2, ^ 1, then 2 and 1 between the
// registers; the 8 virtual-warp sums (lane tr holds virtual warp tr >> 3)
// through `red`, added in turn. Every thread of the block calls it.
__device__ __forceinline__ float row_reduce(float (&p)[4], float* red,
                                            int tr) {
#pragma unroll
  for (int off = 4; off > 0; off >>= 1) {
#pragma unroll
    for (int c = 0; c < 4; ++c)
      p[c] += __shfl_xor_sync(0xffffffffu, p[c], off);
  }
  const float w = (p[0] + p[2]) + (p[1] + p[3]);
  if ((tr & 7) == 0) red[tr >> 3] = w;
  __syncthreads();
  float t = red[0];
#pragma unroll
  for (int j = 1; j < kVirtualWarps; ++j) t += red[j];
  return t;
}

__device__ __forceinline__ uint32_t code(float y, float s) {
  const float c = fminf(fmaxf(rintf(y / s), -128.0f), 127.0f);
  return (uint32_t)(uint8_t)(int8_t)(int)c;
}

// gamma and beta of float4 i (beta zeros where there is none)
template <bool VEC>
__device__ __forceinline__ void affine4(const Args& a, int i, float4& g,
                                        float4& b) {
  g = get4<VEC>(a.gamma, i, a.D);
  b = a.beta != nullptr ? get4<VEC>(a.beta, i, a.D) : zero4();
}

// y of float4 i from h, the statistics, gamma and beta, coded at s and
// stored
template <bool VEC>
__device__ __forceinline__ void put_codes(const Args& a, long long base,
                                          int i, float4 v, float4 g,
                                          float4 b, float mu, float r,
                                          float s) {
  float4 y;
  if (a.rms) {
    y = make_float4((v.x * r) * g.x, (v.y * r) * g.y, (v.z * r) * g.z,
                    (v.w * r) * g.w);
  } else {
    y = make_float4(((v.x - mu) * r) * g.x + b.x, ((v.y - mu) * r) * g.y + b.y,
                    ((v.z - mu) * r) * g.z + b.z,
                    ((v.w - mu) * r) * g.w + b.w);
  }
  int8_t* q = a.q + base;
  if (VEC) {
    reinterpret_cast<uint32_t*>(q)[i] = code(y.x, s) | code(y.y, s) << 8
                                        | code(y.z, s) << 16
                                        | code(y.w, s) << 24;
    return;
  }
  const int e = 4 * i;
  q[e] = (int8_t)code(y.x, s);
  if (e + 1 < a.D) q[e + 1] = (int8_t)code(y.y, s);
  if (e + 2 < a.D) q[e + 2] = (int8_t)code(y.z, s);
  if (e + 3 < a.D) q[e + 3] = (int8_t)code(y.w, s);
}

// VPT > 0: the row held in VPT float4s a thread (every loop unrolled, so
// `held` stays in registers); VPT == 0: streamed, h read back
template <int VPT, bool VEC, bool I8>
__global__ void __launch_bounds__(kRowThreads * kRowsPerBlock)
addnorm_quant_kernel(const Args a) {
  __shared__ float red[2][kRowsPerBlock][kVirtualWarps];
  const int lr = threadIdx.x / kRowThreads;   // row within the block
  const int tr = threadIdx.x % kRowThreads;   // lane within the row
  const long long row =
      (long long)blockIdx.x * (blockDim.x / kRowThreads) + lr;
  const bool live = row < a.M;
  const long long base = row * a.D;
  const int nvec = (a.D + 3) / 4;
  const float xs_in = a.x_in_scale != nullptr ? *a.x_in_scale : 1.0f;
  const float s = *a.x_scale;
  float* hr = a.h + base;
  // gamma and beta come in with x, so a row held in registers is one
  // round trip to memory
  constexpr bool kPrefetch = VPT > 0 && VPT <= kPrefetchVec;
  float4 held[VPT > 0 ? VPT : 1];
  float4 gk[kPrefetch ? VPT : 1], bk[kPrefetch ? VPT : 1];
  const int nk = (nvec + kRowThreads - 1) / kRowThreads;   // streamed
  float p[4];

  // the one read: h, written out, and the first sum (of h, or of its
  // squares for RMSNorm)
  if constexpr (VPT > 0) {
#pragma unroll
    for (int k = 0; k < VPT; ++k) {
      const int i = tr + k * kRowThreads;
      held[k] = live && i < nvec ? form_h<VEC, I8>(a, base, i, xs_in)
                                 : zero4();
      if constexpr (kPrefetch) {
        if (live && i < nvec) affine4<VEC>(a, i, gk[k], bk[k]);
      }
    }
#pragma unroll
    for (int k = 0; k < VPT; ++k) {
      const int i = tr + k * kRowThreads;
      if (live && i < nvec) put_h<VEC>(hr, i, held[k], a.D);
      fold(p, a.rms ? square4(held[k]) : held[k], k == 0);
    }
  } else {
    // kChunk float4s in flight at a time, folded in order
    for (int k0 = 0; k0 < nk; k0 += kChunk) {
      float4 v[kChunk];
#pragma unroll
      for (int c = 0; c < kChunk; ++c) {
        const int i = tr + (k0 + c) * kRowThreads;
        v[c] = live && i < nvec ? form_h<VEC, I8>(a, base, i, xs_in)
                                : zero4();
      }
#pragma unroll
      for (int c = 0; c < kChunk && k0 + c < nk; ++c) {
        const int i = tr + (k0 + c) * kRowThreads;
        if (live && i < nvec) put_h<VEC>(hr, i, v[c], a.D);
        fold(p, a.rms ? square4(v[c]) : v[c], k0 + c == 0);
      }
    }
  }
  const float sum = row_reduce(p, red[0][lr], tr);

  float mu = 0.0f, var;
  if (a.rms) {
    var = sum / (float)a.D;
  } else {
    mu = sum / (float)a.D;
    if constexpr (VPT > 0) {
#pragma unroll
      for (int k = 0; k < VPT; ++k)
        fold(p, deviation4(held[k], mu, tr + k * kRowThreads, a.D), k == 0);
    } else {
      for (int k0 = 0; k0 < nk; k0 += kChunk) {
        float4 v[kChunk];
#pragma unroll
        for (int c = 0; c < kChunk; ++c) {
          const int i = tr + (k0 + c) * kRowThreads;
          v[c] = live && i < nvec ? own_h<VEC>(hr, i, a.D) : zero4();
        }
#pragma unroll
        for (int c = 0; c < kChunk && k0 + c < nk; ++c)
          fold(p, deviation4(v[c], mu, tr + (k0 + c) * kRowThreads, a.D),
               k0 + c == 0);
      }
    }
    var = row_reduce(p, red[1][lr], tr) / (float)a.D;
  }
  if (!live) return;
  const float r = 1.0f / sqrtf(var + a.eps);
  float4 g, b;
  if constexpr (VPT > 0) {
#pragma unroll
    for (int k = 0; k < VPT; ++k) {
      const int i = tr + k * kRowThreads;
      if (i >= nvec) break;
      if constexpr (kPrefetch) {
        g = gk[k];
        b = bk[k];
      } else {
        affine4<VEC>(a, i, g, b);
      }
      put_codes<VEC>(a, base, i, held[k], g, b, mu, r, s);
    }
  } else {
    for (int k0 = 0; k0 < nk; k0 += kChunk) {
      float4 v[kChunk], gc[kChunk], bc[kChunk];
#pragma unroll
      for (int c = 0; c < kChunk; ++c) {
        const int i = tr + (k0 + c) * kRowThreads;
        if (i < nvec) {
          v[c] = own_h<VEC>(hr, i, a.D);
          affine4<VEC>(a, i, gc[c], bc[c]);
        }
      }
#pragma unroll
      for (int c = 0; c < kChunk; ++c) {
        const int i = tr + (k0 + c) * kRowThreads;
        if (i < nvec) put_codes<VEC>(a, base, i, v[c], gc[c], bc[c], mu, r, s);
      }
    }
  }
}

template <int VPT>
void launch(const Args& a, const Plan& p, bool vec, bool i8,
            cudaStream_t st) {
  const int blocks = (a.M + p.rpb - 1) / p.rpb;
  const int threads = kRowThreads * p.rpb;
  if (vec && i8)
    addnorm_quant_kernel<VPT, true, true><<<blocks, threads, 0, st>>>(a);
  else if (vec)
    addnorm_quant_kernel<VPT, true, false><<<blocks, threads, 0, st>>>(a);
  else if (i8)
    addnorm_quant_kernel<VPT, false, true><<<blocks, threads, 0, st>>>(a);
  else
    addnorm_quant_kernel<VPT, false, false><<<blocks, threads, 0, st>>>(a);
}

}  // namespace

// The block plan for M rows of D values: float4s a thread holds (0 where
// the row streams), threads a row, rows a block (out[0..2]).
extern "C" void samp_addnorm_quant_plan(int M, int D, int* out) {
  const Plan p = plan(M, D);
  out[0] = p.vpt;
  out[1] = kRowThreads;
  out[2] = p.rpb;
}

// x: (M, D) float32 (x_is_int8 = 0) or int8 (x_is_int8 = 1); residual, h:
// (M, D) float32; bias, gamma: (D,); beta: (D,) or null; x_scale: device
// scalar; x_in_scale: device scalar or null (1.0); q: (M, D) int8; all
// contiguous, rows of any width.
extern "C" int samp_addnorm_quant(const void* x, int x_is_int8,
                                  const void* residual, const void* bias,
                                  const void* gamma, const void* beta,
                                  const void* x_scale, const void* x_in_scale,
                                  void* h, void* q, int M, int D, int rms,
                                  float eps, void* stream) {
  if (M > 0 && D > 0) {
    Args a;
    a.xf = x_is_int8 ? nullptr : (const float*)x;
    a.xq = x_is_int8 ? (const int8_t*)x : nullptr;
    a.res = (const float*)residual;
    a.bias = (const float*)bias;
    a.gamma = (const float*)gamma;
    a.beta = (const float*)beta;
    a.x_scale = (const float*)x_scale;
    a.x_in_scale = (const float*)x_in_scale;
    a.h = (float*)h;
    a.q = (int8_t*)q;
    a.M = M;
    a.D = D;
    a.rms = rms;
    a.eps = eps;
    auto a16 = [](const void* ptr) { return (uintptr_t)ptr % 16 == 0; };
    const bool vec = D % 4 == 0 && (uintptr_t)x % (x_is_int8 ? 4 : 16) == 0
                     && a16(residual) && a16(bias) && a16(gamma)
                     && (beta == nullptr || a16(beta)) && a16(h)
                     && (uintptr_t)q % 4 == 0;
    const Plan p = plan(M, D);
    auto* st = (cudaStream_t)stream;
    const bool i8 = x_is_int8 != 0;
    switch (p.vpt) {
      case 1: launch<1>(a, p, vec, i8, st); break;
      case 2: launch<2>(a, p, vec, i8, st); break;
      case 4: launch<4>(a, p, vec, i8, st); break;
      case 8: launch<8>(a, p, vec, i8, st); break;
      case 16: launch<16>(a, p, vec, i8, st); break;
      case 32: launch<32>(a, p, vec, i8, st); break;
      default: launch<0>(a, p, vec, i8, st); break;
    }
  }
  return (int)cudaGetLastError();
}
