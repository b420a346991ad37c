// Paged decode attention over an int8 KV pool, with dequantization fused
// into both dots, an online softmax across pages, and the optional
// two-pass uint8 softmax.
//
// Replaces src/repro/kernels/decode_attention.py:decode_attention (the
// Pallas _decode_kernel). One query token per slot; for slot b, KV head h
// and query row i of the GQA group (query head h * g + i), over the slot's
// live pages j (table entry >= 0 and length > j * PS):
//   s[t] = (sum_d (q[d] * scale) * k8[t][d]) * k_scale[t]     (+ softcap)
//   s[t] = NEG_INF where j * PS + t >= length                  (finite mask)
//   m' = max(m, max_t s); a = exp(m - m'); p[t] = exp(s[t] - m')
//   l = l * a + sum_t p[t];  acc[d] = acc[d] * a + sum_t (p[t] * v_scale[t]) v8[t][d]
//   out = acc / max(l, 1e-30)
// With p_scale, pass 1 takes m and l only, and pass 2 revisits every live
// page: p = exp(s - m) / max(l, 1e-30), codes clip(rint(p / p_scale), 0,
// 255), acc[d] += sum_t ((codes * p_scale) * v_scale[t]) v8[t][d], already
// normalized. k_scale / v_scale are per-token scale pages (NP, PS, Hkv) or
// calibrated per-head (Hkv,) vectors. A slot of length 0 writes zeros.
//
// Bound on the H100: bytes, and in practice latency. One call reads each
// live page of K and V once (PS * hd bytes per head each) plus its scales,
// a few hundred KB at the serving shapes, about 0.1 us at 3.35 TB/s; the
// grid is only B x Hkv = 16 blocks on 132 SMs, so the time is the latency
// of one block walking its pages in turn. Splitting a slot's pages across
// blocks with a combine pass (flash-decoding) is later work.
//
// Design: one block of 256 threads per (slot, KV head). The block reads its
// page-table row and length itself (the Pallas kernel's scalar prefetch),
// skips -1 entries and pages past the length, and keeps the running max,
// denominator and the (g, hd) accumulator in shared memory. Each live page
// is staged in shared memory as float (K and V, PS x hd on an odd word
// stride, so lanes reading one dim of different tokens hit distinct banks)
// with its per-token scales. Then thread (i, t) forms one score: the hd
// products are added in halves (d with d + hd/2, then with d + hd/4, ...)
// in registers; one thread per query row takes the max, the exponentials
// and their sum over the page's tokens, again in halves; and thread (i, d)
// forms its output dim's P.V sum over the tokens in halves. Those orders
// are what the plain version (repro_torch.kernels.decode_attention,
// tree_sum) repeats, so the two round alike. Division is IEEE, rounding is
// rintf (half to even), exp is expf: no fast math, -fmad=false.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
// the Python constant -0.7 * float32 max, rounded once to float
constexpr float kNegInf = (float)(-0.7 * 3.4028234663852886e38);

// Shared-memory layout of one block, in floats.
struct Layout {
  int rs;                        // row stride of q, K and V (hd | 1)
  size_t q_off, k_off, v_off, ks_off, vs_off, s_off, acc_off, m_off, l_off,
      a_off, floats;
};

__host__ __device__ inline Layout layout(int g, int hd, int ps) {
  Layout L;
  L.rs = hd | 1;
  size_t off = 0;
  L.q_off = off;   off += (size_t)g * L.rs;
  L.k_off = off;   off += (size_t)ps * L.rs;
  L.v_off = off;   off += (size_t)ps * L.rs;
  L.ks_off = off;  off += ps;
  L.vs_off = off;  off += ps;
  L.s_off = off;   off += (size_t)g * ps;     // scores, then P.V weights
  L.acc_off = off; off += (size_t)g * hd;
  L.m_off = off;   off += g;
  L.l_off = off;   off += g;
  L.a_off = off;   off += g;
  L.floats = off;
  return L;
}

template <int HD, int PS>
__global__ void __launch_bounds__(kThreads)
decode_attention_kernel(const float* __restrict__ q,
                        const int8_t* __restrict__ k_pages,
                        const int8_t* __restrict__ v_pages,
                        const float* __restrict__ k_scale,
                        const float* __restrict__ v_scale,
                        const int* __restrict__ page_table,
                        const int* __restrict__ lengths,
                        const float* __restrict__ p_scale,
                        float* __restrict__ out, int Hkv, int g, int pps,
                        int num_pages, int per_head, float scale,
                        int use_cap, float cap) {
  extern __shared__ float smem[];
  const Layout L = layout(g, HD, PS);
  float* qs = smem + L.q_off;
  float* ks = smem + L.k_off;
  float* vs = smem + L.v_off;
  float* ksc = smem + L.ks_off;
  float* vsc = smem + L.vs_off;
  float* sw = smem + L.s_off;
  float* acc = smem + L.acc_off;
  float* m = smem + L.m_off;
  float* l = smem + L.l_off;
  float* alpha = smem + L.a_off;
  const int tid = threadIdx.x;
  const int b = blockIdx.x / Hkv;
  const int h = blockIdx.x - b * Hkv;
  const int length = lengths[b];
  const int* table = page_table + (size_t)b * pps;
  const bool quant_p = p_scale != nullptr;
  const float pscale = quant_p ? *p_scale : 1.0f;
  const float* qg = q + ((size_t)b * Hkv + h) * g * HD;

  for (int idx = tid; idx < g * HD; idx += kThreads) {
    const int i = idx / HD;
    const int d = idx - i * HD;
    qs[i * L.rs + d] = qg[idx] * scale;
    acc[idx] = 0.0f;
  }
  for (int i = tid; i < g; i += kThreads) {
    m[i] = kNegInf;
    l[i] = 0.0f;
  }

  const int passes = quant_p ? 2 : 1;
  for (int pass = 0; pass < passes; ++pass) {
    const bool pv_pass = pass == passes - 1;   // accumulates P.V
    for (int j = 0; j < pps; ++j) {
      const int pg = table[j];
      if (pg < 0 || pg >= num_pages || length <= j * PS) continue;
      __syncthreads();                         // previous page fully used
      // stage the page's K and V rows of head h, widened to float
      const size_t page_base = (size_t)pg * PS * Hkv * HD;
      for (int w = tid; w < PS * (HD / 4); w += kThreads) {
        const int t = w / (HD / 4);
        const int d = (w - t * (HD / 4)) * 4;
        const size_t src = page_base + ((size_t)t * Hkv + h) * HD + d;
        const char4 kk = *reinterpret_cast<const char4*>(k_pages + src);
        const char4 vv = *reinterpret_cast<const char4*>(v_pages + src);
        float* kr = ks + t * L.rs + d;
        float* vr = vs + t * L.rs + d;
        kr[0] = (float)kk.x; kr[1] = (float)kk.y;
        kr[2] = (float)kk.z; kr[3] = (float)kk.w;
        vr[0] = (float)vv.x; vr[1] = (float)vv.y;
        vr[2] = (float)vv.z; vr[3] = (float)vv.w;
      }
      for (int t = tid; t < PS; t += kThreads) {
        const size_t si = ((size_t)pg * PS + t) * Hkv + h;
        ksc[t] = per_head ? k_scale[h] : k_scale[si];
        vsc[t] = per_head ? v_scale[h] : v_scale[si];
      }
      __syncthreads();

      // scores: thread (i, t), the hd products added in halves
      for (int idx = tid; idx < g * PS; idx += kThreads) {
        const int i = idx / PS;
        const int t = idx - i * PS;
        const float* qr = qs + i * L.rs;
        const float* kr = ks + t * L.rs;
        float v[HD / 2];
#pragma unroll
        for (int d = 0; d < HD / 2; ++d)
          v[d] = qr[d] * kr[d] + qr[d + HD / 2] * kr[d + HD / 2];
#pragma unroll
        for (int w = HD / 4; w >= 1; w >>= 1) {
#pragma unroll
          for (int d = 0; d < w; ++d) v[d] = v[d] + v[d + w];
        }
        float s = v[0] * ksc[t];
        if (use_cap) s = tanhf(s / cap) * cap;
        if (j * PS + t >= length) s = kNegInf;
        sw[idx] = s;
      }
      __syncthreads();

      // one thread per query row: the softmax statistics of this page, and
      // the weights P.V takes (p * v_scale, or the dequantized codes)
      for (int i = tid; i < g; i += kThreads) {
        float* row = sw + i * PS;
        float p[PS];
        if (!quant_p || pass == 0) {
          float mx = row[0];
#pragma unroll
          for (int t = 1; t < PS; ++t) mx = fmaxf(mx, row[t]);
          const float m_new = fmaxf(m[i], mx);
          const float a = expf(m[i] - m_new);
#pragma unroll
          for (int t = 0; t < PS; ++t) p[t] = expf(row[t] - m_new);
          float sum[PS];
#pragma unroll
          for (int t = 0; t < PS; ++t) sum[t] = p[t];
#pragma unroll
          for (int w = PS / 2; w >= 1; w >>= 1) {
#pragma unroll
            for (int t = 0; t < w; ++t) sum[t] = sum[t] + sum[t + w];
          }
          l[i] = l[i] * a + sum[0];
          m[i] = m_new;
          alpha[i] = a;
          if (!quant_p) {
#pragma unroll
            for (int t = 0; t < PS; ++t) row[t] = p[t] * vsc[t];
          }
        } else {
          const float denom = fmaxf(l[i], 1e-30f);
#pragma unroll
          for (int t = 0; t < PS; ++t) {
            const float pt = expf(row[t] - m[i]) / denom;
            const float c = fminf(fmaxf(rintf(pt / pscale), 0.0f), 255.0f);
            row[t] = (c * pscale) * vsc[t];
          }
        }
      }
      __syncthreads();

      // P.V: thread (i, d), the tokens added in halves
      if (pv_pass) {
        for (int idx = tid; idx < g * HD; idx += kThreads) {
          const int i = idx / HD;
          const int d = idx - i * HD;
          const float* row = sw + i * PS;
          float v[PS / 2];
#pragma unroll
          for (int t = 0; t < PS / 2; ++t)
            v[t] = row[t] * vs[t * L.rs + d] +
                   row[t + PS / 2] * vs[(t + PS / 2) * L.rs + d];
#pragma unroll
          for (int w = PS / 4; w >= 1; w >>= 1) {
#pragma unroll
            for (int t = 0; t < w; ++t) v[t] = v[t] + v[t + w];
          }
          acc[idx] = quant_p ? acc[idx] + v[0]
                             : acc[idx] * alpha[i] + v[0];
        }
      }
    }
  }
  __syncthreads();

  float* og = out + ((size_t)b * Hkv + h) * g * HD;
  for (int idx = tid; idx < g * HD; idx += kThreads) {
    const int i = idx / HD;
    og[idx] = quant_p ? acc[idx] : acc[idx] / fmaxf(l[i], 1e-30f);
  }
}

template <int HD, int PS>
cudaError_t launch(dim3 grid, size_t bytes, cudaStream_t stream,
                   const float* q, const int8_t* k, const int8_t* v,
                   const float* ks, const float* vs, const int* table,
                   const int* lengths, const float* p_scale, float* out,
                   int Hkv, int g, int pps, int num_pages, int per_head,
                   float scale, int use_cap, float cap) {
  if (bytes > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        decode_attention_kernel<HD, PS>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (err != cudaSuccess) return err;
  }
  decode_attention_kernel<HD, PS><<<grid, kThreads, bytes, stream>>>(
      q, k, v, ks, vs, table, lengths, p_scale, out, Hkv, g, pps, num_pages,
      per_head, scale, use_cap, cap);
  return cudaSuccess;
}

template <int HD>
cudaError_t launch_ps(int ps, dim3 grid, size_t bytes, cudaStream_t stream,
                      const float* q, const int8_t* k, const int8_t* v,
                      const float* ks, const float* vs, const int* table,
                      const int* lengths, const float* p_scale, float* out,
                      int Hkv, int g, int pps, int num_pages, int per_head,
                      float scale, int use_cap, float cap) {
#define SAMP_DECODE_PS(PSV)                                                 \
  case PSV:                                                                 \
    return launch<HD, PSV>(grid, bytes, stream, q, k, v, ks, vs, table,     \
                           lengths, p_scale, out, Hkv, g, pps, num_pages,   \
                           per_head, scale, use_cap, cap);
  switch (ps) {
    SAMP_DECODE_PS(4)
    SAMP_DECODE_PS(8)
    SAMP_DECODE_PS(16)
    SAMP_DECODE_PS(32)
    default:
      return cudaErrorInvalidValue;
  }
#undef SAMP_DECODE_PS
}

}  // namespace

// q (B, Hkv, g, hd) float32; k_pages, v_pages (num_pages, ps, Hkv, hd) int8;
// k_scale, v_scale float32 (num_pages, ps, Hkv), or (Hkv,) when per_head;
// page_table (B, pps) int32, -1 = unallocated; lengths (B,) int32; p_scale a
// device scalar, or null for the one-pass softmax; out (B, Hkv, g, hd)
// float32. hd in {16, 32, 64, 128}, ps in {4, 8, 16, 32}, all contiguous.
// use_cap selects the softcap cap. Returns the launch's CUDA error code.
extern "C" int samp_decode_attention(
    const void* q, const void* k_pages, const void* v_pages,
    const void* k_scale, const void* v_scale, const void* page_table,
    const void* lengths, const void* p_scale, void* out, int B, int Hkv,
    int g, int hd, int ps, int pps, int num_pages, int per_head,
    int quant_p, float scale, int use_cap, float cap, void* stream) {
  if (B <= 0 || Hkv <= 0 || g <= 0) return (int)cudaGetLastError();
  const size_t bytes = layout(g, hd, ps).floats * sizeof(float);
  const dim3 grid(B * Hkv);
  const cudaStream_t st = (cudaStream_t)stream;
  const float* ps_ptr = quant_p ? (const float*)p_scale : nullptr;
  cudaError_t err;
#define SAMP_DECODE_HD(HDV)                                                 \
  case HDV:                                                                 \
    err = launch_ps<HDV>(ps, grid, bytes, st, (const float*)q,              \
                         (const int8_t*)k_pages, (const int8_t*)v_pages,    \
                         (const float*)k_scale, (const float*)v_scale,      \
                         (const int*)page_table, (const int*)lengths,       \
                         ps_ptr, (float*)out, Hkv, g, pps, num_pages,       \
                         per_head, scale, use_cap, cap);                    \
    break;
  switch (hd) {
    SAMP_DECODE_HD(16)
    SAMP_DECODE_HD(32)
    SAMP_DECODE_HD(64)
    SAMP_DECODE_HD(128)
    default:
      err = cudaErrorInvalidValue;
  }
#undef SAMP_DECODE_HD
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}
