// BS-RoFormer's rotary embedding of the queries and keys, fused, for Hopper
// (sm_90a).
//
// A port-side kernel: no Pallas kernel of musicfpaugment_tpu is replaced (the
// JAX package has no BS-RoFormer). The plain version is
// models/bs_roformer.py's RotaryEmbedding.rotate, x * cos + rotate_half(x) *
// sin on q and on k, each a strided view of the QKV projection's output: a
// product, a negation of every odd channel, a stack of the pairs, a second
// product and a sum, each a pass over the whole tensor, most of them on
// PyTorch's strided element-wise path. This kernel reads q and k once from the
// projection and writes them rotated once, in the (S, heads, n, 64) layout
// scaled_dot_product_attention takes; v is not touched.
//
// What bounds it on an H100: nothing but bytes. Per element one read and one
// write of 4 bytes against two products and a sum (0.75 operations a byte),
// far under the card's ~20 float32 operations a byte; the (n, 64) cos and
// sin tables (75 KB at n = 146) stay in L2 and L1. The design moves the bytes
// as the memory likes them, in 16-byte loads and stores: a thread takes one
// float4 (two interleaved pairs of one head of q or of k) of each of four
// consecutive tokens (s, t), so a block reads each token's q and k rows (2 x
// heads x 256 contiguous bytes) and writes 256 contiguous bytes a head and
// token; a thread's four loads are in flight before its first store;
// threadIdx gives the head and the tensor without a division, and the grid is
// 1-D (the band layers' 18,688 sequences x 8 heads are past the 65,535 limit
// of the y and z axes).
//
// Arithmetic: each output is rounded as the plain chain rounds it, the two
// products and the sum each once, in round-to-nearest, with no contraction to
// an FMA: out[2i] = x[2i] cos[2i] + (-x[2i+1]) sin[2i], out[2i+1] = x[2i+1]
// cos[2i+1] + x[2i] sin[2i+1]. The angles are the table's, never recomputed
// here, so the kernel's output is the plain version's bit for bit.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kHeadDim = 64;
constexpr int kVecs = kHeadDim / 4;  // float4s a head's row
constexpr int kMaxHeads = 32;        // 2 x 16 x heads threads a block, at most 1,024
constexpr int kTokens = 4;           // tokens a block: its loads in flight before a store

__device__ __forceinline__ float turn(float x, float c, float partner, float s) {
  return __fadd_rn(__fmul_rn(x, c), __fmul_rn(partner, s));
}

// qkv: (S, n, 3, heads, 64) contiguous; cos_t, sin_t: (n, 64) contiguous;
// out: (2, S, heads, n, 64) contiguous, q then k. Block (kVecs, heads, 2): x
// the float4 of the head's row, y the head, z q or k; block b takes the
// tokens s * n + t from b * kTokens on, the last block fewer.
__global__ void __launch_bounds__(2 * kVecs * kMaxHeads)
    rope_qk_kernel(const float4* __restrict__ qkv, const float4* __restrict__ cos_t,
                   const float4* __restrict__ sin_t, float4* __restrict__ out, int S,
                   int n, int tokens) {
  const int v = threadIdx.x, h = threadIdx.y, which = threadIdx.z;
  const int heads = blockDim.y;
  const int first = blockIdx.x * kTokens;
  const int64_t token_vecs = (int64_t)3 * heads * kVecs;
  const int lane = (which * heads + h) * kVecs + v;
  float4 x[kTokens] = {};
#pragma unroll
  for (int i = 0; i < kTokens; ++i)
    if (first + i < tokens) x[i] = __ldg(qkv + (first + i) * token_vecs + lane);
  int s = first / n;
  int t = first - s * n;
#pragma unroll
  for (int i = 0; i < kTokens; ++i) {
    if (first + i < tokens) {
      const float4 c = __ldg(cos_t + t * kVecs + v);
      const float4 sn = __ldg(sin_t + t * kVecs + v);
      float4 r;
      r.x = turn(x[i].x, c.x, -x[i].y, sn.x);
      r.y = turn(x[i].y, c.y, x[i].x, sn.y);
      r.z = turn(x[i].z, c.z, -x[i].w, sn.z);
      r.w = turn(x[i].w, c.w, x[i].z, sn.w);
      out[(((int64_t)which * S + s) * heads + h) * n * kVecs + t * kVecs + v] = r;
    }
    if (++t == n) {
      t = 0;
      ++s;
    }
  }
}

}  // namespace

// qkv: (S, n, 3 x heads x 64) float32, contiguous and 16-byte aligned, on the
// current device; cos_t, sin_t: (n, 64) float32, contiguous, 16-byte aligned;
// out: (2, S, heads, n, 64) float32, contiguous, 16-byte aligned, not
// overlapping qkv. Returns a cudaError_t.
extern "C" int mfpa_rope_qk(const void* qkv, const void* cos_t, const void* sin_t,
                            void* out, int S, int n, int heads, void* stream) {
  if (S < 0 || n < 1 || heads < 1 || heads > kMaxHeads) return (int)cudaErrorInvalidValue;
  const int64_t tokens = (int64_t)S * n;
  if (tokens == 0) return (int)cudaSuccess;
  if (tokens > 0x7FFFFFFF - kTokens) return (int)cudaErrorInvalidValue;
  const dim3 block(kVecs, heads, 2);
  const unsigned blocks = (unsigned)((tokens + kTokens - 1) / kTokens);
  rope_qk_kernel<<<blocks, block, 0, (cudaStream_t)stream>>>(
      (const float4*)qkv, (const float4*)cos_t, (const float4*)sin_t, (float4*)out, S, n,
      (int)tokens);
  return (int)cudaGetLastError();
}
