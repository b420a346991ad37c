// Fused token + position + segment embedding.
//
// Replaces src/repro/kernels/fused_embed.py:fused_embed (the Pallas _kernel
// driven by scalar-prefetched ids): out[i] = tok[tokens[i]]
// + pos[positions[i]] + seg[segments[i]], in one pass instead of three
// gathers and two adds. (The TPU kernel's token-row scale has no caller:
// archs that scale embeddings do so after the sum.)
//
// Bound on the H100: bytes. Each output row reads three table rows and
// writes one (16 bytes per element in float32) with two adds per element.
//
// Design: one block per output row. The block reads its own three indices
// (the TPU kernel's scalar prefetch becomes three loads by every thread of
// the block, served from one cache line), then moves the rows with 16-byte
// float4 loads and stores when D is a multiple of 4 and the tables are
// 16-byte aligned. Indices are clamped into their tables, as the plain
// version clamps them, so a bad id cannot read outside a table.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;

__device__ __forceinline__ int clamp_index(int i, int n) {
  return i < 0 ? 0 : (i >= n ? n - 1 : i);
}

__global__ void __launch_bounds__(kThreads)
fused_embed_kernel(const int* __restrict__ tokens,
                   const int* __restrict__ positions,
                   const int* __restrict__ segments,
                   const float* __restrict__ tok, const float* __restrict__ pos,
                   const float* __restrict__ seg, float* __restrict__ out,
                   int D, int V, int P, int S, int vec4) {
  const long long row = blockIdx.x;
  const long long t = clamp_index(tokens[row], V);
  const long long p = clamp_index(positions[row], P);
  const long long g = seg != nullptr ? clamp_index(segments[row], S) : 0;
  if (vec4) {
    const float4* tr = reinterpret_cast<const float4*>(tok + t * D);
    const float4* pr = reinterpret_cast<const float4*>(pos + p * D);
    const float4* sr = seg != nullptr
                           ? reinterpret_cast<const float4*>(seg + g * D)
                           : nullptr;
    float4* o = reinterpret_cast<float4*>(out + row * D);
    for (int i = threadIdx.x; i < D / 4; i += blockDim.x) {
      const float4 a = tr[i];
      const float4 b = pr[i];
      const float4 c = sr != nullptr ? sr[i] : make_float4(0.f, 0.f, 0.f, 0.f);
      o[i] = make_float4((a.x + b.x) + c.x, (a.y + b.y) + c.y,
                         (a.z + b.z) + c.z, (a.w + b.w) + c.w);
    }
  } else {
    for (int i = threadIdx.x; i < D; i += blockDim.x) {
      const float a = tok[t * D + i];
      const float c = seg != nullptr ? seg[g * D + i] : 0.0f;
      out[row * D + i] = (a + pos[p * D + i]) + c;
    }
  }
}

}  // namespace

// tokens, positions: (N,) int32; segments: (N,) int32 or null (with seg
// null); tok (V, D), pos (P, D), seg (S, D) float32; out (N, D) float32.
extern "C" int samp_fused_embed(const void* tokens, const void* positions,
                                const void* segments, const void* tok,
                                const void* pos, const void* seg, void* out,
                                int N, int D, int V, int P, int S, int vec4,
                                void* stream) {
  if (N > 0 && D > 0) {
    fused_embed_kernel<<<N, kThreads, 0, (cudaStream_t)stream>>>(
        (const int*)tokens, (const int*)positions, (const int*)segments,
        (const float*)tok, (const float*)pos, (const float*)seg, (float*)out,
        D, V, P, S, vec4);
  }
  return (int)cudaGetLastError();
}
