// Paged decode attention over an int8 KV pool, with dequantization fused
// into both dots, an online softmax across pages split over blocks
// (flash-decoding), and the optional two-pass uint8 softmax.
//
// Replaces src/repro/kernels/decode_attention.py:decode_attention (the
// Pallas _decode_kernel). One query token per slot; for slot b, KV head h
// and query row i of the GQA group (query head h * g + i), over the slot's
// live pages j (table entry >= 0 and length > j * ps), ps the page size:
//   s[t] = (sum_d (q[d] * scale) * k8[t][d]) * k_scale[t]     (+ softcap)
//   s[t] = NEG_INF where j * ps + t >= length                  (finite mask)
//   m' = max(m, max_t s); a = exp(m - m'); p[t] = exp(s[t] - m')
//   l = l * a + sum_t p[t]
//   acc[d] = acc[d] * a + sum_t (p[t] * v_scale[t]) v8[t][d]
//   out = acc / max(l, 1e-30)
// That recurrence runs over each split of P consecutive table entries
// (pages j in [s P, s P + P)) from m = NEG_INF, l = 0, acc = 0, giving
// (m_s, l_s, acc_s); an empty split keeps those. With S = ceil(pps / P)
// splits, the combine is
//   m = max_s m_s;  w_s = exp(m_s - m);
//   l = l_0 w_0 + l_1 w_1 + ...;  acc = acc_0 w_0 + acc_1 w_1 + ...
// added in split order from the first term (S = 1: out = acc_0 / l_0, the
// page-sequential recurrence). With p_scale, the splits' (m_s, l_s) combine
// into the exact m and l, and pass 2 revisits each split's live pages:
// p = exp(s - m) / max(l, 1e-30), codes clip(rint(p / p_scale), 0, 255),
// acc_s[d] += sum_t ((codes * p_scale) * v_scale[t]) v8[t][d], already
// normalized; out = acc_0 + acc_1 + ... in split order. k_scale / v_scale
// are per-token scale pages (NP, ps, Hkv) or calibrated per-head (Hkv,)
// vectors. A slot of length 0 writes zeros.
//
// Bound on the H100: bytes, and in practice latency. One call reads each
// live page of K and V once (ps * hd bytes per head each) plus its scales,
// a few hundred KB at the serving shapes, about 0.1 us at 3.35 TB/s. One
// block per (slot, KV head) would make B x Hkv = 16 blocks on 132 SMs, each
// walking its slot's pages in turn, a time that grows with the context; so
// the pages are split over blocks: P = ceil(pps / 32) table entries a
// split, from the table's width alone (never the SM count or the lengths,
// so the plain version repeats the order on the CPU): at most 32 splits,
// 128 blocks at the qwen2 decode tick (pps 8, one page a block), 512 at
// 4096 cached tokens on pages of 16 (pps 256, 8 pages a block).
//
// Design: one block of 256 threads per (slot, KV head, chunk of at most
// 32 query rows of the GQA group; the caller picks the chunk so a block's
// shared memory fits, and a larger group takes several blocks, each staging
// the head's pages itself) and split s. The block reads its page-table row
// and length itself (the Pallas kernel's scalar prefetch), skips -1 entries
// and pages past the length, and keeps the running max, denominator and the
// (rows, hd) accumulator in shared memory. Each live page is staged in
// shared memory as float (K and V, PS x HD on an odd word stride, so lanes
// reading one dim of different tokens hit distinct banks) with its
// per-token scales. Where a block of one query row cannot hold both pages
// (head dim 256 with pages of 128 tokens: 2 x 128 x 257 floats, 263 KB,
// over the 227 KB a block may take), K and V share one page buffer: K is
// staged, the scores are taken, and V is staged into the same buffer while
// the warps take the softmax statistics, which read neither; the barrier
// after them then orders V's staging before P.V too, so the sums keep
// their order and no barrier is added. Every other shape keeps two
// buffers, staged together. The kernel is instantiated at the power-of-two
// head dims HD in {16, ..., 256} and page sizes PS in {4, ..., 128}; a head
// dim hd <= HD and a page size ps <= PS in between run zero-padded to HD
// and PS (K, V, q and the scales of the padding are 0, and a padded token's
// probability is 0 and takes no part in the max). Then thread (i, t) forms
// one score: the HD products are added in halves (d with d + HD/2, then
// with d + HD/4, ...) in registers; one warp per query row takes the max,
// the exponentials and their sum over the page's tokens, again in halves
// (lanes add the halves by shuffles in the same order); and thread (i, d)
// forms its output dim's P.V sum over the tokens in halves. Those orders
// are what the plain version (repro_torch.kernels.decode_attention,
// tree_sum, which zero-pads to the next power of two) repeats, so the two
// round alike: the extra halves of a wider instantiation add exact zeros.
// With S > 1 each block writes (m_s, l_s, acc_s) to a float workspace and
// bumps its group's counter (int32, zeroed by the wrapper); the group's last
// block applies the combine and writes out, so a call is one launch. With
// p_scale and S > 1 a call is two launches: the first writes each split's
// (m_s, l_s); in the second every block combines them into m and l (the
// same order in each), runs pass 2 over its split, and the last block of the
// group adds the accs. A head dim over 256 runs the wide kernel at the end
// of this file, in the same orders. Division is IEEE, rounding is rintf (half to even),
// exp is expf: no fast math, -fmad=false.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxSplits = 32;
// the Python constant -0.7 * float32 max, rounded once to float
constexpr float kNegInf = (float)(-0.7 * 3.4028234663852886e38);

// what one walk over a split's pages does
enum Walk {
  kOnline,   // one-pass softmax: m, l and acc
  kStats,    // p_scale pass 1: m and l only
  kCodes,    // p_scale pass 2: acc of the coded final probabilities
};

// the shared memory a block may take on the H100 (227 KB, opt-in)
constexpr size_t kMaxSmem = 232448;

// Shared-memory layout of one block of `rows` query rows, in floats; with
// `two` K and V each have a page buffer, else they share one (v_off ==
// k_off).
struct Layout {
  int rs;                        // row stride of q, K and V (HD | 1)
  size_t q_off, k_off, v_off, ks_off, vs_off, s_off, acc_off, m_off, l_off,
      a_off, w_off, f_off, floats;
};

__host__ __device__ constexpr Layout layout(int rows, int HD, int PS,
                                            bool two) {
  Layout L{};
  L.rs = HD | 1;
  size_t off = 0;
  L.q_off = off;   off += (size_t)rows * L.rs;
  L.k_off = off;   off += (size_t)PS * L.rs;
  L.v_off = two ? off : L.k_off;
  if (two) off += (size_t)PS * L.rs;
  L.ks_off = off;  off += PS;
  L.vs_off = off;  off += PS;
  L.s_off = off;   off += (size_t)rows * PS;  // scores, then P.V weights
  L.acc_off = off; off += (size_t)rows * HD;
  L.m_off = off;   off += rows;
  L.l_off = off;   off += rows;
  L.a_off = off;   off += rows;
  L.w_off = off;   off += (size_t)rows * kMaxSplits;  // combine weights
  L.f_off = off;   off += 1;                 // the last-block flag
  L.floats = off;
  return L;
}

// whether an instantiation stages K and V in two buffers: where a block of
// one query row fits with both
__host__ __device__ constexpr bool two_buffers(int HD, int PS) {
  return layout(1, HD, PS, true).floats * sizeof(float) <= kMaxSmem;
}

__host__ __device__ constexpr Layout layout(int rows, int HD, int PS) {
  return layout(rows, HD, PS, two_buffers(HD, PS));
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
                        float* __restrict__ out, int Hkv, int g, int rows,
                        int hd, int ps, int pps, int num_pages, int per_head,
                        float scale, int use_cap, float cap, int split_pages,
                        int splits, int phase, float* __restrict__ work,
                        int* __restrict__ counters) {
  extern __shared__ float smem[];
  constexpr bool kTwo = two_buffers(HD, PS);
  const Layout L = layout(rows, HD, PS);
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
  float* wts = smem + L.w_off;
  int* last = reinterpret_cast<int*>(smem + L.f_off);
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  constexpr int TK = PS > 32 ? PS / 32 : 1;           // tokens a lane
  const int split = blockIdx.x % splits;
  const int grp = blockIdx.x / splits;                // (slot, head, chunk)
  const int chunks = (g + rows - 1) / rows;
  const int bh = grp / chunks;
  const int i0 = (grp - bh * chunks) * rows;          // first query row
  const int gn = min(rows, g - i0);                   // rows of this block
  const int b = bh / Hkv;
  const int h = bh - b * Hkv;
  const int length = lengths[b];
  const int* table = page_table + (size_t)b * pps;
  const int j0 = split * split_pages;
  const int j1 = min(pps, j0 + split_pages);
  // the split's first table entry, read before q so the two loads overlap
  const int pg0 = j0 < j1 ? table[j0] : -1;
  const bool quant_p = p_scale != nullptr;
  const float pscale = quant_p ? *p_scale : 1.0f;
  const float* qg = q + (((size_t)b * Hkv + h) * g + i0) * hd;
  float* og = out + (((size_t)b * Hkv + h) * g + i0) * hd;
  // this group's partials: (m_s, l_s) of each split and row, then acc_s
  const size_t groups = gridDim.x / splits;
  float* stats = work + (size_t)grp * splits * rows * 2;
  float* accs = work + groups * splits * rows * 2
                + (size_t)grp * splits * rows * hd;
  // four codes a word when every row of a page starts on a word
  const bool words = hd % 4 == 0 &&
                     ((uintptr_t)k_pages & 3) == 0 &&
                     ((uintptr_t)v_pages & 3) == 0;

  for (int idx = tid; idx < gn * HD; idx += kThreads) {
    const int i = idx / HD;
    const int d = idx - i * HD;
    qs[i * L.rs + d] = d < hd ? qg[(size_t)i * hd + d] * scale : 0.0f;
    acc[idx] = 0.0f;
  }
  for (int i = tid; i < gn; i += kThreads) {
    m[i] = kNegInf;
    l[i] = 0.0f;
  }
  // the padding of K and V (dims hd..HD, tokens ps..PS) stays zero (with
  // one buffer both loops clear it)
  for (int idx = tid; idx < PS * HD; idx += kThreads) {
    const int t = idx / HD;
    const int d = idx - t * HD;
    ks[t * L.rs + d] = 0.0f;
    vs[t * L.rs + d] = 0.0f;
  }
  for (int t = tid; t < PS; t += kThreads) {
    ksc[t] = 0.0f;
    vsc[t] = 0.0f;
  }

  // the page recurrence over this split's live pages
  auto walk = [&](Walk mode) {
    for (int j = j0; j < j1; ++j) {
      const int pg = j == j0 ? pg0 : table[j];
      if (pg < 0 || pg >= num_pages || length <= j * ps) continue;
      __syncthreads();                         // previous page fully used
      // the page's per-token scales (thread t, ps <= kThreads), loaded
      // before its codes so that the loads overlap
      float kst = 0.0f, vst = 0.0f;
      if (tid < ps) {
        const size_t si = ((size_t)pg * ps + tid) * Hkv + h;
        kst = per_head ? k_scale[h] : k_scale[si];
        vst = per_head ? v_scale[h] : v_scale[si];
      }
      // stage the page's rows of head h, widened to float: K, and V with
      // it where it has a buffer of its own (pass 1 of p_scale needs no V)
      const bool need_v = mode != kStats;
      const size_t page_base = (size_t)pg * ps * Hkv * hd;
      auto stage = [&](bool with_k, bool with_v) {
        if (words) {
          const int hw = hd / 4;
          for (int w = tid; w < ps * hw; w += kThreads) {
            const int t = w / hw;
            const int d = (w - t * hw) * 4;
            const size_t src = page_base + ((size_t)t * Hkv + h) * hd + d;
            if (with_k) {
              const char4 kk =
                  *reinterpret_cast<const char4*>(k_pages + src);
              float* kr = ks + t * L.rs + d;
              kr[0] = (float)kk.x; kr[1] = (float)kk.y;
              kr[2] = (float)kk.z; kr[3] = (float)kk.w;
            }
            if (with_v) {
              const char4 vv =
                  *reinterpret_cast<const char4*>(v_pages + src);
              float* vr = vs + t * L.rs + d;
              vr[0] = (float)vv.x; vr[1] = (float)vv.y;
              vr[2] = (float)vv.z; vr[3] = (float)vv.w;
            }
          }
        } else {
          for (int e = tid; e < ps * hd; e += kThreads) {
            const int t = e / hd;
            const int d = e - t * hd;
            const size_t src = page_base + ((size_t)t * Hkv + h) * hd + d;
            if (with_k) ks[t * L.rs + d] = (float)k_pages[src];
            if (with_v) vs[t * L.rs + d] = (float)v_pages[src];
          }
        }
      };
      stage(true, kTwo && need_v);
      if (tid < ps) {
        ksc[tid] = kst;
        vsc[tid] = vst;
      }
      __syncthreads();

      // scores: thread (i, t), the HD products added in halves
      for (int idx = tid; idx < gn * PS; idx += kThreads) {
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
        if (j * ps + t >= length) s = kNegInf;
        sw[idx] = s;
      }
      __syncthreads();
      // one buffer: V over K, which no thread reads any more; the warps'
      // statistics below read only the scores and the scales
      if (!kTwo && need_v) stage(false, true);

      // one warp per query row, lane l holding tokens l + 32 k: the softmax
      // statistics of this page (the max by shuffles; the exponentials'
      // sum in halves, within a lane while the halves are 32 tokens or
      // more apart, then by shuffles), and the weights P.V takes (p *
      // v_scale, or the dequantized codes); a padded token (t >= ps) has
      // weight 0
      for (int i = tid >> 5; i < gn; i += kThreads / 32) {
        float* row = sw + i * PS;
        if (mode != kCodes) {
          float mx = kNegInf;
#pragma unroll
          for (int k = 0; k < TK; ++k)
            if (lane + 32 * k < ps) mx = fmaxf(mx, row[lane + 32 * k]);
#pragma unroll
          for (int o = 16; o >= 1; o >>= 1)
            mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
          const float m_old = m[i];
          const float m_new = fmaxf(m_old, mx);
          const float a = expf(m_old - m_new);
          float x[TK];
#pragma unroll
          for (int k = 0; k < TK; ++k) {
            const int t = lane + 32 * k;
            x[k] = t < ps ? expf(row[t] - m_new) : 0.0f;
            if (mode == kOnline && t < PS) row[t] = x[k] * vsc[t];
          }
#pragma unroll
          for (int w = PS / 2; w >= 32; w >>= 1) {
#pragma unroll
            for (int k = 0; k < w / 32; ++k) x[k] = x[k] + x[k + w / 32];
          }
#pragma unroll
          for (int w = (PS < 32 ? PS : 32) / 2; w >= 1; w >>= 1)
            x[0] = x[0] + __shfl_down_sync(0xffffffffu, x[0], w);
          __syncwarp();                 // every lane has read m[i]
          if (lane == 0) {
            l[i] = l[i] * a + x[0];
            m[i] = m_new;
            alpha[i] = a;
          }
        } else {
          const float denom = fmaxf(l[i], 1e-30f);
#pragma unroll
          for (int k = 0; k < TK; ++k) {
            const int t = lane + 32 * k;
            if (t >= PS) continue;
            float w = 0.0f;
            if (t < ps) {
              const float pt = expf(row[t] - m[i]) / denom;
              const float c = fminf(fmaxf(rintf(pt / pscale), 0.0f), 255.0f);
              w = (c * pscale) * vsc[t];
            }
            row[t] = w;
          }
        }
      }
      __syncthreads();

      // P.V: thread (i, d), the tokens added in halves
      if (mode != kStats) {
        for (int idx = tid; idx < gn * HD; idx += kThreads) {
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
          acc[idx] = mode == kCodes ? acc[idx] + v[0]
                                    : acc[idx] * alpha[i] + v[0];
        }
      }
    }
    __syncthreads();
  };

  auto save_stats = [&]() {
    for (int i = tid; i < gn; i += kThreads) {
      stats[((size_t)split * rows + i) * 2] = m[i];
      stats[((size_t)split * rows + i) * 2 + 1] = l[i];
    }
  };
  auto save_acc = [&]() {
    for (int idx = tid; idx < gn * HD; idx += kThreads) {
      const int i = idx / HD;
      const int d = idx - i * HD;
      if (d < hd) accs[((size_t)split * rows + i) * hd + d] = acc[idx];
    }
  };
  // whether this block is the group's last to finish; its partials are
  // then all visible
  auto arrive = [&]() {
    __threadfence();
    __syncthreads();
    if (tid == 0) *last = atomicAdd(counters + grp, 1) == splits - 1;
    __syncthreads();
    if (!*last) return false;
    __threadfence();
    return true;
  };
  // m = max_s m_s, w_s = exp(m_s - m) (into wts), l = sum_s l_s w_s in
  // split order from the first term
  auto combine_stats = [&]() {
    for (int i = tid; i < gn; i += kThreads) {
      float mx = kNegInf;
      for (int s = 0; s < splits; ++s)
        mx = fmaxf(mx, __ldcg(stats + ((size_t)s * rows + i) * 2));
      float sum = 0.0f;
      for (int s = 0; s < splits; ++s) {
        const float* st = stats + ((size_t)s * rows + i) * 2;
        const float w = expf(__ldcg(st) - mx);
        const float t = __ldcg(st + 1) * w;
        sum = s == 0 ? t : sum + t;
        wts[i * kMaxSplits + s] = w;
      }
      m[i] = mx;
      l[i] = sum;
    }
    __syncthreads();
  };

  // this launch's walks: the one-pass softmax, or p_scale's pass 1 (a
  // launch of its own when S > 1) and pass 2, which with S > 1 starts from
  // the splits' combined m and l (one copy of the page loop in the code)
  const int w0 = !quant_p ? kOnline
                          : phase == 0 || splits == 1 ? kStats : kCodes;
  const int w1 = !quant_p ? kOnline : phase == 0 ? kStats : kCodes;
  if (w0 == kCodes) combine_stats();
  for (int w = w0; w <= w1; ++w) walk((Walk)w);
  if (quant_p && phase == 0) {
    save_stats();
    return;
  }
  if (splits > 1) {
    if (!quant_p) save_stats();
    save_acc();
    if (!arrive()) return;
    if (!quant_p) combine_stats();
  }
  // out: acc_s weighted by w_s and divided by l, or with p_scale the
  // already normalized accs added
  for (int idx = tid; idx < gn * HD; idx += kThreads) {
    const int i = idx / HD;
    const int d = idx - i * HD;
    if (d >= hd) continue;
    float a = acc[idx];
    if (splits > 1) {
      const float* col = accs + (size_t)i * hd + d;
      const float* wi = wts + i * kMaxSplits;
      a = quant_p ? __ldcg(col) : __ldcg(col) * wi[0];
      for (int s = 1; s < splits; ++s) {
        const float x = __ldcg(col + (size_t)s * rows * hd);
        a = a + (quant_p ? x : x * wi[s]);
      }
    }
    og[(size_t)i * hd + d] = quant_p ? a : a / fmaxf(l[i], 1e-30f);
  }
}

struct Args {
  const float* q;
  const int8_t* k;
  const int8_t* v;
  const float* ks;
  const float* vs;
  const int* table;
  const int* lengths;
  const float* p_scale;
  float* out;
  int Hkv, g, rows, hd, ps, pps, num_pages, per_head;
  float scale;
  int use_cap;
  float cap;
  int split_pages, splits;
  float* work;
  int* counters;
};

template <int HD, int PS>
cudaError_t launch(int blocks, cudaStream_t stream, const Args& a) {
  const size_t bytes = layout(a.rows, HD, PS).floats * sizeof(float);
  if (bytes > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        decode_attention_kernel<HD, PS>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (err != cudaSuccess) {
      cudaGetLastError();                      // leave no sticky error
      return err;
    }
  }
  // p_scale over several splits: the splits' statistics first
  const bool two = a.p_scale != nullptr && a.splits > 1;
  for (int phase = two ? 0 : 1; phase < 2; ++phase) {
    decode_attention_kernel<HD, PS><<<blocks, kThreads, bytes, stream>>>(
        a.q, a.k, a.v, a.ks, a.vs, a.table, a.lengths, a.p_scale, a.out,
        a.Hkv, a.g, a.rows, a.hd, a.ps, a.pps, a.num_pages, a.per_head,
        a.scale, a.use_cap, a.cap, a.split_pages, a.splits, phase, a.work,
        a.counters);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  return cudaSuccess;
}

// the smallest instantiated width >= n, or 0 past the widest
inline int width(int n, int lo, int hi) {
  int w = lo;
  while (w < n && w < hi) w *= 2;
  return n <= w ? w : 0;
}

template <int HD>
cudaError_t launch_ps(int PS, int blocks, cudaStream_t stream,
                      const Args& a) {
  switch (PS) {
    case 4: return launch<HD, 4>(blocks, stream, a);
    case 8: return launch<HD, 8>(blocks, stream, a);
    case 16: return launch<HD, 16>(blocks, stream, a);
    case 32: return launch<HD, 32>(blocks, stream, a);
    case 64: return launch<HD, 64>(blocks, stream, a);
    case 128: return launch<HD, 128>(blocks, stream, a);
    default: return cudaErrorInvalidValue;
  }
}

// ---------------------------------------------------------------------------
// Head dims over 256: the wide kernel
// ---------------------------------------------------------------------------
// A simple kernel that takes any head dim hd and page size ps, where the
// instantiations' staged pages and unrolled halves would not fit, and keeps
// the plain version's orders, so it is bit for bit the plain version too.
// One block of 256 threads per (slot, KV head, query row of the group,
// chunk of 256 output columns); a chunk's block recomputes the row's scores
// and statistics, and walks every split of the slot's pages in turn (the
// splits' (m_s, l_s, acc_s) in registers, then the same combine), so a
// call is one launch. Per live page:
//  * the scores: warp w takes tokens w, w + 8, ...; lane l holds dims
//    l + 32 u (u < HD / 32, HD the head dim's next power of two) and adds
//    their products over u, then the lanes add by shuffles (16, 8, ... 1).
//    That is tree_sum's order over HD: its halves pair the top bits of d
//    first (u's), then the low five (the lanes');
//  * every thread takes the page's max and the new m itself, thread t the
//    exponential (or the code) of token t into shared memory, and every
//    thread adds the exponentials over the page's tokens in halves (l, the
//    same in each) and its column's P.V terms in halves (acc).
// A sum in halves over n = 2^k terms is streamed (halving_sum): its tree is
// the tree of adjacent pairs over the bit-reversed indices, so the terms
// arrive in bit-reversed order and merge on a binary counter of partial
// sums.
constexpr int kWideThreads = 256;         // threads, and columns a block

// the least k with 2^k >= n
__host__ __device__ inline int log2_ceil(int n) {
  int k = 0;
  while ((1 << k) < n) ++k;
  return k;
}

// sum of f(0), ..., f(2^bits - 1) in tree_sum's order (x[i] + x[i + n/2],
// then halves of that, ...)
template <class F>
__device__ __forceinline__ float halving_sum(int bits, F&& f) {
  float part[32];
  int top = 0;
  for (int r = 0; r < (1 << bits); ++r) {
    float x = f(bits ? (int)(__brev((unsigned)r) >> (32 - bits)) : 0);
    for (int c = r; c & 1; c >>= 1) x = part[--top] + x;
    part[top++] = x;
  }
  return part[0];
}

__global__ void __launch_bounds__(kWideThreads)
decode_attention_wide_kernel(const float* __restrict__ q,
                             const int8_t* __restrict__ k_pages,
                             const int8_t* __restrict__ v_pages,
                             const float* __restrict__ k_scale,
                             const float* __restrict__ v_scale,
                             const int* __restrict__ page_table,
                             const int* __restrict__ lengths,
                             const float* __restrict__ p_scale,
                             float* __restrict__ out, int Hkv, int g, int hd,
                             int ps, int pps, int num_pages, int per_head,
                             float scale, int use_cap, float cap,
                             int split_pages, int splits) {
  extern __shared__ float smem[];
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int chunks = (hd + kWideThreads - 1) / kWideThreads;
  const int row = blockIdx.x / chunks;               // (slot, head, i)
  const int d = (blockIdx.x - row * chunks) * kWideThreads + tid;
  const int bh = row / g;
  const int b = bh / Hkv;
  const int h = bh - b * Hkv;
  const int length = lengths[b];
  const int* table = page_table + (size_t)b * pps;
  const int dbits = log2_ceil(hd) - 5;               // u's bits
  const int tbits = log2_ceil(ps);                   // a page's tokens
  const int W = 1 << tbits;
  float* qs = smem;                                  // hd
  float* sc = qs + hd;                               // W scores
  float* ex = sc + W;                                // W exponentials
  float* wt = ex + W;                                // W P.V weights
  const bool quant_p = p_scale != nullptr;
  const float pscale = quant_p ? *p_scale : 1.0f;
  for (int e = tid; e < hd; e += kWideThreads)
    qs[e] = q[(size_t)row * hd + e] * scale;
  for (int t = tid; t < W; t += kWideThreads) {
    ex[t] = 0.0f;
    wt[t] = 0.0f;
  }

  // one live page j: the scores into sc, then the walk's update
  auto page = [&](int j, int pg, Walk mode, float& m, float& l, float& acc,
                  float m_all, float denom) {
    __syncthreads();                         // the last page fully used
    const size_t page_base = (size_t)pg * ps;
    for (int t = warp; t < ps; t += kWideThreads / 32) {
      const int8_t* kr = k_pages + ((page_base + t) * Hkv + h) * hd;
      float x = halving_sum(dbits, [&](int u) {
        const int e = lane + 32 * u;
        return e < hd ? qs[e] * (float)kr[e] : 0.0f;
      });
#pragma unroll
      for (int o = 16; o >= 1; o >>= 1)
        x = x + __shfl_down_sync(0xffffffffu, x, o);
      if (lane == 0) {
        float s = x * (per_head ? k_scale[h]
                                : k_scale[(page_base + t) * Hkv + h]);
        if (use_cap) s = tanhf(s / cap) * cap;
        if (j * ps + t >= length) s = kNegInf;
        sc[t] = s;
      }
    }
    __syncthreads();
    float a = 1.0f;
    if (mode != kCodes) {
      float mx = kNegInf;
      for (int t = 0; t < ps; ++t) mx = fmaxf(mx, sc[t]);
      const float m_new = fmaxf(m, mx);
      a = expf(m - m_new);
      for (int t = tid; t < ps; t += kWideThreads) {
        ex[t] = expf(sc[t] - m_new);
        wt[t] = ex[t] * (per_head ? v_scale[h]
                                  : v_scale[(page_base + t) * Hkv + h]);
      }
      m = m_new;
    } else {
      for (int t = tid; t < ps; t += kWideThreads) {
        const float pt = expf(sc[t] - m_all) / denom;
        const float c = fminf(fmaxf(rintf(pt / pscale), 0.0f), 255.0f);
        wt[t] = (c * pscale) * (per_head ? v_scale[h]
                                         : v_scale[(page_base + t) * Hkv
                                                   + h]);
      }
    }
    __syncthreads();
    if (mode != kCodes) l = l * a + halving_sum(tbits, [&](int t) {
      return ex[t];
    });
    if (mode != kStats && d < hd) {
      const int8_t* vc = v_pages + (page_base * Hkv + h) * hd + d;
      const float pvs = halving_sum(tbits, [&](int t) {
        return t < ps ? wt[t] * (float)vc[(size_t)t * Hkv * hd] : 0.0f;
      });
      acc = mode == kCodes ? acc + pvs : acc * a + pvs;
    }
  };
  auto walk = [&](int s, Walk mode, float& m, float& l, float& acc,
                  float m_all, float denom) {
    const int j1 = min(pps, (s + 1) * split_pages);
    for (int j = s * split_pages; j < j1; ++j) {
      const int pg = table[j];
      if (pg < 0 || pg >= num_pages || length <= j * ps) continue;
      page(j, pg, mode, m, l, acc, m_all, denom);
    }
  };

  float ms[kMaxSplits], ls[kMaxSplits], as[kMaxSplits], ws[kMaxSplits];
  for (int s = 0; s < splits; ++s) {
    float m = kNegInf, l = 0.0f, acc = 0.0f;
    walk(s, quant_p ? kStats : kOnline, m, l, acc, 0.0f, 1.0f);
    ms[s] = m;
    ls[s] = l;
    as[s] = acc;
  }
  float l_all = ls[0], m_all = ms[0];
  if (splits > 1) {
    for (int s = 1; s < splits; ++s) m_all = fmaxf(m_all, ms[s]);
    for (int s = 0; s < splits; ++s) {
      ws[s] = expf(ms[s] - m_all);
      const float t = ls[s] * ws[s];
      l_all = s == 0 ? t : l_all + t;
    }
  }
  const float denom = fmaxf(l_all, 1e-30f);
  float o;
  if (!quant_p) {
    o = splits > 1 ? as[0] * ws[0] : as[0];
    for (int s = 1; s < splits; ++s) o = o + as[s] * ws[s];
    o = o / denom;
  } else {
    for (int s = 0; s < splits; ++s) {
      float m = m_all, l = 0.0f, acc = 0.0f;
      walk(s, kCodes, m, l, acc, m_all, denom);
      o = s == 0 ? acc : o + acc;
    }
  }
  if (d < hd) out[(size_t)row * hd + d] = o;
}

cudaError_t launch_wide(int B, cudaStream_t stream, const Args& a) {
  const int W = 1 << log2_ceil(a.ps);
  const size_t bytes = ((size_t)a.hd + 3 * W) * sizeof(float);
  if (bytes > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        decode_attention_wide_kernel,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (err != cudaSuccess) {
      cudaGetLastError();                      // leave no sticky error
      return err;
    }
  }
  const int blocks = B * a.Hkv * a.g *
                     ((a.hd + kWideThreads - 1) / kWideThreads);
  decode_attention_wide_kernel<<<blocks, kWideThreads, bytes, stream>>>(
      a.q, a.k, a.v, a.ks, a.vs, a.table, a.lengths, a.p_scale, a.out, a.Hkv,
      a.g, a.hd, a.ps, a.pps, a.num_pages, a.per_head, a.scale, a.use_cap,
      a.cap, a.split_pages, a.splits);
  return cudaGetLastError();
}

}  // namespace

// Bytes of dynamic shared memory a block of `rows` query rows takes at head
// dim hd and page size ps (0 for a shape no instantiation takes).
extern "C" long long samp_decode_attention_smem(int rows, int hd, int ps) {
  const int HD = width(hd, 16, 256);
  const int PS = width(ps, 4, 128);
  if (rows <= 0 || hd <= 0 || ps <= 0 || HD == 0 || PS == 0) return 0;
  return (long long)(layout(rows, HD, PS).floats * sizeof(float));
}

// q (B, Hkv, g, hd) float32; k_pages, v_pages (num_pages, ps, Hkv, hd) int8;
// k_scale, v_scale float32 (num_pages, ps, Hkv), or (Hkv,) when per_head;
// page_table (B, pps) int32, -1 = unallocated; lengths (B,) int32; p_scale a
// device scalar, or null for the one-pass softmax; out (B, Hkv, g, hd)
// float32, all contiguous. hd <= 256 with ps <= 128: `rows` (<= 32) query
// rows of the group per block, with samp_decode_attention_smem(rows, hd, ps)
// within the card's opt-in limit; hd over 256 (any ps) runs the wide
// kernel, which takes neither `rows` nor work and counters. use_cap selects the softcap cap.
// split_pages: table entries a split (>= 1); with S = max(1, ceil(pps /
// split_pages)) <= 32 splits over 1, work holds groups S rows (2 + hd)
// floats and counters `groups` int32 zeros, groups = B Hkv ceil(g / rows).
// Returns the launch's CUDA error code.
extern "C" int samp_decode_attention(
    const void* q, const void* k_pages, const void* v_pages,
    const void* k_scale, const void* v_scale, const void* page_table,
    const void* lengths, const void* p_scale, void* out, int B, int Hkv,
    int g, int rows, int hd, int ps, int pps, int num_pages, int per_head,
    int quant_p, float scale, int use_cap, float cap, int split_pages,
    void* work, void* counters, void* stream) {
  if (B <= 0 || Hkv <= 0 || g <= 0) return (int)cudaGetLastError();
  const bool wide = hd > 256;
  const int HD = width(hd, 16, 256);
  const int PS = width(ps, 4, 128);
  if ((!wide && (HD == 0 || PS == 0 || rows <= 0 || rows > 32)) || hd <= 0 ||
      ps <= 0 || split_pages <= 0 || pps < 0)
    return (int)cudaErrorInvalidValue;
  const int splits = pps > split_pages ? (pps + split_pages - 1) / split_pages
                                       : 1;
  if (splits > kMaxSplits ||
      (!wide && splits > 1 && (!work || !counters)))
    return (int)cudaErrorInvalidValue;
  const Args a{(const float*)q, (const int8_t*)k_pages,
               (const int8_t*)v_pages, (const float*)k_scale,
               (const float*)v_scale, (const int*)page_table,
               (const int*)lengths,
               quant_p ? (const float*)p_scale : nullptr, (float*)out, Hkv,
               g, rows, hd, ps, pps, num_pages, per_head, scale, use_cap,
               cap, split_pages, splits, (float*)work, (int*)counters};
  const cudaStream_t st = (cudaStream_t)stream;
  if (wide) return (int)launch_wide(B, st, a);
  const int blocks = B * Hkv * ((g + rows - 1) / rows) * splits;
  cudaError_t err;
  switch (HD) {
    case 16: err = launch_ps<16>(PS, blocks, st, a); break;
    case 32: err = launch_ps<32>(PS, blocks, st, a); break;
    case 64: err = launch_ps<64>(PS, blocks, st, a); break;
    case 128: err = launch_ps<128>(PS, blocks, st, a); break;
    case 256: err = launch_ps<256>(PS, blocks, st, a); break;
    default: err = cudaErrorInvalidValue;
  }
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}
