// Float online-softmax attention (flash attention) for long-context prefill.
//
// Replaces src/repro/kernels/flash_attention.py:flash_attention (the Pallas
// _kernel). For one (batch, query head h) and query row i, over keys j with
// positions arange(Sq) and arange(Sk) (both from 0):
//   s[j] = sum_d (q[i][d] * scale) * k[j][d]               float32
//   s[j] = tanh(s[j] / cap) * cap                          optional softcap
//   s[j] = NEG_INF where causal and j > i, or window and j <= i - window
//   online softmax over the key blocks that run:
//     m' = max(m, max_j s); a = exp(m - m'); p[j] = exp(s[j] - m')
//     l = l * a + sum_j p[j];  acc[d] = acc[d] * a + sum_j p[j] v[j][d]
//   out = acc / max(l, 1e-30), cast to q's dtype (round to nearest even)
// GQA: query head h reads KV head h / (Hq / Hkv). NEG_INF is finite
// (-0.7 FLT_MAX), and m starts at NEG_INF, as in the JAX kernel.
//
// Which key blocks run is part of the result. The JAX grid skips a whole
// logical (bq x bk) block when causal and k_lo > q_lo + bq - 1, or with a
// window when k_lo + bk - 1 <= q_lo - window. For a row i those rules leave
// one contiguous range of keys [lo(i), hi(i)) whose blocks run; a key
// outside it is absent (it adds nothing, not even to the max), a masked key
// inside it is NEG_INF. So a row with no valid key returns 0 where none of
// its blocks runs, and the mean of v over the run blocks' keys where some
// do (exp(NEG_INF - NEG_INF) = 1), never NaN; on every other row the
// kernel's own tiles change the result by rounding only, since a NEG_INF
// entry seen before the row's first valid key is washed out by
// a = exp(NEG_INF - m') = 0.
//
// Bound on the H100: operations. At the long-context shapes (S = 32768) a
// call reads q, k and v once and writes out once, about 0.3 GB at d = 64,
// against 4 d float32 operations per run (query, key) pair: 1.9e12 for
// qwen2's causal 32k prefill, 29 ms at the 67 TFLOP/s of the CUDA cores
// against 0.1 ms of bytes. This first kernel runs its products on the CUDA
// cores in float32 (no tensor cores: the JAX kernel computes in float32, and
// TF32 would keep three digits); wgmma and TMA are later work.
//
// Design: one block of 128 threads per (batch x query head, tile of BQ
// query rows), the heaviest causal tiles first. The block stages its rows
// of q * scale in shared memory once, then walks the key tiles of its
// range: K and V tiles of BK keys are staged as float32 in shared memory
// (row stride D + 4 floats, so float4 reads of eight rows hit distinct
// banks) and shared by all BQ rows. Thread (ty, tx), ty = tid / 8, holds
// rows ty + 16 r and key columns tx + 8 n of a tile: its RM x CN scores come
// from float4 reads of q and k and explicit fmaf (the build's -fmad=false
// stops contraction, not explicit FMAs). The row max and sum are shuffles
// over the row's 8 lanes; the probabilities go to a per-row shared buffer
// and each thread adds P.V into its RM x (D / 8) accumulator (columns
// tx + 8 n) held in registers across the key loop. Head dims 16, 32, 64,
// 128 and 256 are instantiated; a dim in between is zero-padded up to the
// next. exp is expf, tanh tanhf, division IEEE: no fast math.
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

// the Python constant -0.7 * float32 max, rounded once to float
constexpr float kNegInf = (float)(-0.7 * 3.4028234663852886e38);
constexpr int kThreads = 128;
constexpr int kTX = 8;                      // lanes sharing one row group
constexpr int kTY = kThreads / kTX;         // row groups in a block

// (query rows, keys) of a tile for each instantiated head dim: 64 x 64 up
// to d = 64, fewer keys at 128 and fewer rows at 256, to hold the
// accumulator in registers and the block's shared memory near 100 KB.
template <int D> struct Tile;
template <> struct Tile<16> { static constexpr int BQ = 64, BK = 64; };
template <> struct Tile<32> { static constexpr int BQ = 64, BK = 64; };
template <> struct Tile<64> { static constexpr int BQ = 64, BK = 64; };
template <> struct Tile<128> { static constexpr int BQ = 64, BK = 32; };
template <> struct Tile<256> { static constexpr int BQ = 32, BK = 32; };

template <int D>
constexpr size_t smem_bytes() {
  return 4 * ((size_t)Tile<D>::BQ * (D + 4) + 2 * (size_t)Tile<D>::BK * (D + 4)
              + (size_t)Tile<D>::BQ * (Tile<D>::BK + 4));
}

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float to_f(__half x) { return __half2float(x); }

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) {
  return x;
}
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(
    float x) {
  return __float2bfloat16_rn(x);
}
template <> __device__ __forceinline__ __half from_f<__half>(float x) {
  return __float2half_rn(x);
}

// The keys [lo, hi) whose logical (bq, bk) blocks run for query row i.
__device__ __forceinline__ void key_range(int i, int Sk, int bq, int bk,
                                          int causal, int use_window,
                                          int window, int& lo, int& hi) {
  const long long q_lo = (long long)(i / bq) * bq;
  long long l = 0, h = Sk;
  if (causal) {          // run iff k_lo <= q_lo + bq - 1
    const long long nb = (q_lo + bq - 1) / bk + 1;
    h = nb * bk < h ? nb * bk : h;
  }
  if (use_window) {      // run iff k_lo + bk - 1 > q_lo - window
    const long long t = q_lo - window - bk + 1;
    if (t >= 0) l = (t / bk + 1) * bk;
  }
  lo = (int)(l < Sk ? l : Sk);
  hi = (int)h;
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ out, int Hq,
                       int Hkv, int Sq, int Sk, int d, int bq, int bk,
                       int causal, int use_window, int window, int use_cap,
                       float cap, float scale) {
  constexpr int BQ = Tile<D>::BQ, BK = Tile<D>::BK;
  constexpr int RM = BQ / kTY;             // rows a thread holds
  constexpr int CN = BK / kTX;             // key columns a thread scores
  constexpr int DN = D / kTX;              // output dims a thread holds
  constexpr int QS = D + 4;                // q, K, V row stride (floats)
  constexpr int PS = BK + 4;               // probability row stride
  extern __shared__ float4 smem4[];
  float* Qs = reinterpret_cast<float*>(smem4);
  float* Ks = Qs + BQ * QS;
  float* Vs = Ks + BK * QS;
  float* Ps = Vs + BK * QS;

  const int tid = threadIdx.x;
  const int tx = tid % kTX;
  const int ty = tid / kTX;
  const int qt = gridDim.x - 1 - blockIdx.x;   // heaviest causal tiles first
  const int bh = blockIdx.y;
  const int b = bh / Hq;
  const int hk = (bh % Hq) / (Hq / Hkv);
  const int q0 = qt * BQ;
  const T* qg = q + (size_t)bh * Sq * d;
  const T* kg = k + ((size_t)b * Hkv + hk) * Sk * d;
  const T* vg = v + ((size_t)b * Hkv + hk) * Sk * d;
  T* og = out + (size_t)bh * Sq * d;

  // q * scale in float32, as the JAX kernel scales it; padding is zero
  for (int x = tid; x < BQ * D; x += kThreads) {
    const int r = x / D, e = x % D;
    float val = 0.0f;
    if (q0 + r < Sq && e < d) val = to_f(qg[(size_t)(q0 + r) * d + e]) * scale;
    Qs[r * QS + e] = val;
  }

  int lo[RM], hi[RM];
#pragma unroll
  for (int i = 0; i < RM; ++i) {
    const int r = q0 + ty + kTY * i;
    if (r < Sq) {
      key_range(r, Sk, bq, bk, causal, use_window, window, lo[i], hi[i]);
    } else {
      lo[i] = hi[i] = 0;
    }
  }
  // the block's keys: lo and hi grow with the row
  const int last = (q0 + BQ < Sq ? q0 + BQ : Sq) - 1;
  int blo, bhi, dummy;
  key_range(q0, Sk, bq, bk, causal, use_window, window, blo, dummy);
  key_range(last, Sk, bq, bk, causal, use_window, window, dummy, bhi);

  float m[RM], l[RM], acc[RM][DN];
#pragma unroll
  for (int i = 0; i < RM; ++i) {
    m[i] = kNegInf;
    l[i] = 0.0f;
#pragma unroll
    for (int n = 0; n < DN; ++n) acc[i][n] = 0.0f;
  }

  for (int k0 = (blo / BK) * BK; k0 < bhi; k0 += BK) {
    __syncthreads();                 // the last tile's reads are done
    for (int x = tid; x < BK * D; x += kThreads) {
      const int c = x / D, e = x % D;
      const int j = k0 + c;
      float kv = 0.0f, vv = 0.0f;
      if (j < Sk && e < d) {
        kv = to_f(kg[(size_t)j * d + e]);
        vv = to_f(vg[(size_t)j * d + e]);
      }
      Ks[c * QS + e] = kv;
      Vs[c * QS + e] = vv;
    }
    __syncthreads();

    float s[RM][CN];
#pragma unroll
    for (int i = 0; i < RM; ++i)
#pragma unroll
      for (int n = 0; n < CN; ++n) s[i][n] = 0.0f;
#pragma unroll 4
    for (int e = 0; e < D; e += 4) {
      float4 qv[RM], kv[CN];
#pragma unroll
      for (int i = 0; i < RM; ++i)
        qv[i] = *reinterpret_cast<const float4*>(&Qs[(ty + kTY * i) * QS + e]);
#pragma unroll
      for (int n = 0; n < CN; ++n)
        kv[n] = *reinterpret_cast<const float4*>(&Ks[(tx + kTX * n) * QS + e]);
#pragma unroll
      for (int i = 0; i < RM; ++i)
#pragma unroll
        for (int n = 0; n < CN; ++n) {
          float a = s[i][n];
          a = fmaf(qv[i].x, kv[n].x, a);
          a = fmaf(qv[i].y, kv[n].y, a);
          a = fmaf(qv[i].z, kv[n].z, a);
          a = fmaf(qv[i].w, kv[n].w, a);
          s[i][n] = a;
        }
    }

#pragma unroll
    for (int i = 0; i < RM; ++i) {
      const int r = q0 + ty + kTY * i;
      float mx = -INFINITY;
#pragma unroll
      for (int n = 0; n < CN; ++n) {
        const int j = k0 + tx + kTX * n;
        float x = s[i][n];
        if (j < lo[i] || j >= hi[i]) {
          x = -INFINITY;             // its block does not run: absent
        } else {
          if (use_cap) x = tanhf(x / cap) * cap;
          if ((causal && j > r) ||
              (use_window && (long long)j <= (long long)r - window))
            x = kNegInf;
        }
        s[i][n] = x;
        mx = fmaxf(mx, x);
      }
#pragma unroll
      for (int off = 1; off < kTX; off <<= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      const float alpha = expf(m[i] - m_new);
      float sum = 0.0f;
#pragma unroll
      for (int n = 0; n < CN; ++n) {
        const float p = expf(s[i][n] - m_new);   // absent: exp(-inf) = 0
        Ps[(ty + kTY * i) * PS + tx + kTX * n] = p;
        sum += p;
      }
#pragma unroll
      for (int off = 1; off < kTX; off <<= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      l[i] = l[i] * alpha + sum;
      m[i] = m_new;
#pragma unroll
      for (int n = 0; n < DN; ++n) acc[i][n] = acc[i][n] * alpha;
    }
    __syncwarp();                    // a row group's lanes share one warp

#pragma unroll 2
    for (int c = 0; c < BK; c += 4) {
      float pr[RM][4];
#pragma unroll
      for (int i = 0; i < RM; ++i) {
        const float4 t =
            *reinterpret_cast<const float4*>(&Ps[(ty + kTY * i) * PS + c]);
        pr[i][0] = t.x;
        pr[i][1] = t.y;
        pr[i][2] = t.z;
        pr[i][3] = t.w;
      }
#pragma unroll
      for (int cc = 0; cc < 4; ++cc)
#pragma unroll
        for (int n = 0; n < DN; ++n) {
          const float vn = Vs[(c + cc) * QS + tx + kTX * n];
#pragma unroll
          for (int i = 0; i < RM; ++i)
            acc[i][n] = fmaf(pr[i][cc], vn, acc[i][n]);
        }
    }
  }

#pragma unroll
  for (int i = 0; i < RM; ++i) {
    const int r = q0 + ty + kTY * i;
    if (r >= Sq) continue;
    const float den = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int n = 0; n < DN; ++n) {
      const int e = tx + kTX * n;
      if (e < d) og[(size_t)r * d + e] = from_f<T>(acc[i][n] / den);
    }
  }
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, void* out, int B,
           int Hq, int Hkv, int Sq, int Sk, int d, int bq, int bk,
           int causal, int use_window, int window, int use_cap, float cap,
           float scale, cudaStream_t stream) {
  constexpr size_t bytes = smem_bytes<D>();
  if (bytes > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        flash_attention_kernel<T, D>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (err != cudaSuccess) return (int)err;
  }
  const dim3 grid((Sq + Tile<D>::BQ - 1) / Tile<D>::BQ, B * Hq);
  flash_attention_kernel<T, D><<<grid, kThreads, bytes, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (T*)out, Hq, Hkv, Sq, Sk, d, bq,
      bk, causal, use_window, window, use_cap, cap, scale);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(int dp, const void* q, const void* k, const void* v, void* out,
             int B, int Hq, int Hkv, int Sq, int Sk, int d, int bq, int bk,
             int causal, int use_window, int window, int use_cap, float cap,
             float scale, cudaStream_t stream) {
#define SAMP_FA_CASE(DIM)                                                   \
  case DIM:                                                                 \
    return launch<T, DIM>(q, k, v, out, B, Hq, Hkv, Sq, Sk, d, bq, bk,      \
                          causal, use_window, window, use_cap, cap, scale,  \
                          stream);
  switch (dp) {
    SAMP_FA_CASE(16)
    SAMP_FA_CASE(32)
    SAMP_FA_CASE(64)
    SAMP_FA_CASE(128)
    SAMP_FA_CASE(256)
  }
#undef SAMP_FA_CASE
  return (int)cudaErrorInvalidValue;
}

// the instantiated head dim a head dim d runs at (0: none, d > 256)
int padded_dim(int d) {
  for (int dp = 16; dp <= 256; dp *= 2)
    if (d <= dp) return dp;
  return 0;
}

}  // namespace

// Bytes of dynamic shared memory one block takes at head dim d (0 above
// 256).
extern "C" long long samp_flash_attention_smem(int d) {
  switch (padded_dim(d)) {
    case 16: return (long long)smem_bytes<16>();
    case 32: return (long long)smem_bytes<32>();
    case 64: return (long long)smem_bytes<64>();
    case 128: return (long long)smem_bytes<128>();
    case 256: return (long long)smem_bytes<256>();
  }
  return 0;
}

// q (B, Hq, Sq, d), k and v (B, Hkv, Sk, d), out (B, Hq, Sq, d): contiguous,
// all of one dtype (0 float32, 1 bfloat16, 2 float16), Hq % Hkv == 0,
// 1 <= d <= 256, Sq % bq == 0 and Sk % bk == 0. use_window selects the
// window mask, use_cap the softcap; scale multiplies q.
extern "C" int samp_flash_attention(const void* q, const void* k,
                                    const void* v, void* out, int dtype,
                                    int B, int Hq, int Hkv, int Sq, int Sk,
                                    int d, int bq, int bk, int causal,
                                    int use_window, int window, int use_cap,
                                    float cap, float scale, void* stream) {
  const int dp = padded_dim(d);
  if (dp == 0 || Hkv <= 0 || Hq % Hkv || bq <= 0 || bk <= 0)
    return (int)cudaErrorInvalidValue;
  if (B <= 0 || Hq <= 0 || Sq <= 0 || Sk <= 0)
    return (int)cudaGetLastError();
  const cudaStream_t st = (cudaStream_t)stream;
  switch (dtype) {
    case 0:
      return dispatch<float>(dp, q, k, v, out, B, Hq, Hkv, Sq, Sk, d, bq, bk,
                             causal, use_window, window, use_cap, cap, scale,
                             st);
    case 1:
      return dispatch<__nv_bfloat16>(dp, q, k, v, out, B, Hq, Hkv, Sq, Sk, d,
                                     bq, bk, causal, use_window, window,
                                     use_cap, cap, scale, st);
    case 2:
      return dispatch<__half>(dp, q, k, v, out, B, Hq, Hkv, Sq, Sk, d, bq, bk,
                              causal, use_window, window, use_cap, cap, scale,
                              st);
  }
  return (int)cudaErrorInvalidValue;
}
