// Flax's dropout with JAX's threefry draws, fused, for Hopper (sm_90a).
//
// A port-side kernel: no Pallas kernel of musicfpaugment_tpu is replaced.
// XLA generates the JAX package's dropout (flax.linen.Dropout at the five
// sites of musicfpaugment_tpu/models/unet.py:115-127): a threefry-2x32 hash
// of every element's counter under the site's key, a float32 uniform from
// the hash's bits, a compare with the keep probability and a select. The
// plain PyTorch version of that (core/prng.py over int64 counters) is ~150
// elementwise passes, each a read and a write of the whole tensor; this
// kernel makes it one pass, from (key, element index) with no stored state,
// so the backward pass recomputes the mask from the same key and counters
// and nothing is saved between the two.
//
// Layout: the port's activations are NCHW, the JAX model's NHWC, and the
// mask is drawn over the JAX layout: element (b, c, h, w) takes the 64-bit
// counter offset + ((b*H + h)*W + w)*C + c, where offset is the first
// counter of this rank's slice of the global batch (lo*H*W*C). A block takes
// one (b, c) plane, H*W elements contiguous in NCHW, so reads and writes are
// coalesced and a counter is the plane's first plus C per element: no
// division per element (64-bit division is a long software routine here).
//
// What bounds it on an H100: per element ~80 32-bit integer operations (20
// threefry rounds of add, rotate, xor; six key injections; the uniform's
// shift, or and compare; the index arithmetic) against one read and one
// write of 2 (bfloat16) or 4 (float32) bytes. At the training shape (128 x
// (257, 94), base 64: 203.4M elements a step) that is ~16 G operations
// against 0.8 GB (bf16) or 1.6 GB (f32), so bytes bound the float32 pass and
// operations come close in bfloat16. The design does about that: one
// element a thread, no shared memory, every operation in registers.
//
// Arithmetic: the keep test is u < keep with u JAX's float32 uniform
// (bits >> 9 | 0x3F800000 as a float, minus 1) whatever the activation's
// type, as jax.random.bernoulli with x64 off. A kept element is
// x / keep_t, keep_t the keep probability rounded to the activation's type
// (Flax divides by a weak-typed Python float), as an IEEE float division
// (rounded to bfloat16 after, for bfloat16), which is what the plain version
// computes on both devices.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ uint32_t rotl(uint32_t x, int r) {
  return __funnelshift_l(x, x, r);
}

// Threefry-2x32, 20 rounds, as jax._src.prng.threefry_2x32 (and
// core/prng.py's threefry2x32). Returns the xor of the two output words:
// JAX's 32 random bits of a counter.
__device__ __forceinline__ uint32_t threefry_bits(uint32_t k0, uint32_t k1,
                                                  uint32_t x0, uint32_t x1) {
  const uint32_t ks[3] = {k0, k1, k0 ^ k1 ^ 0x1BD11BDAu};
  const int rot[2][4] = {{13, 15, 26, 6}, {17, 29, 16, 24}};
  x0 += ks[0];
  x1 += ks[1];
#pragma unroll
  for (int block = 0; block < 5; ++block) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      x0 += x1;
      x1 = rotl(x1, rot[block % 2][i]) ^ x0;
    }
    x0 += ks[(block + 1) % 3];
    x1 += ks[(block + 2) % 3] + (uint32_t)(block + 1);
  }
  return x0 ^ x1;
}

__device__ __forceinline__ bool keep_element(uint32_t k0, uint32_t k1,
                                             uint64_t counter, float keep) {
  const uint32_t bits = threefry_bits(k0, k1, (uint32_t)(counter >> 32),
                                      (uint32_t)counter);
  const float u = __uint_as_float((bits >> 9) | 0x3F800000u) - 1.0f;
  return u < keep;
}

template <typename T>
struct Scale;

template <>
struct Scale<float> {
  static __device__ __forceinline__ float apply(float x, float keep_t) {
    return x / keep_t;
  }
  static __device__ __forceinline__ float zero() { return 0.0f; }
};

template <>
struct Scale<__nv_bfloat16> {
  static __device__ __forceinline__ __nv_bfloat16 apply(__nv_bfloat16 x,
                                                        float keep_t) {
    return __float2bfloat16_rn(__bfloat162float(x) / keep_t);
  }
  static __device__ __forceinline__ __nv_bfloat16 zero() {
    return __float2bfloat16_rn(0.0f);
  }
};

// x, out: (B, C, H, W) contiguous. One block a (b, c) plane of H*W
// contiguous elements (so no thread divides), its threads striding over it.
template <typename T>
__global__ void __launch_bounds__(kThreads)
    dropout_kernel(const T* __restrict__ x, T* __restrict__ out, int C, int hw,
                   uint32_t k0, uint32_t k1, uint64_t offset, float keep,
                   float keep_t) {
  const int64_t plane = blockIdx.x;
  const int64_t b = plane / C;
  const int64_t c = plane - b * C;
  const int64_t base = plane * hw;
  // counter of (b, c, s) in the NHWC layout: offset + (b*hw + s)*C + c
  const uint64_t first = offset + (uint64_t)(b * hw * C + c);
  for (int s = threadIdx.x; s < hw; s += blockDim.x) {
    const uint64_t counter = first + (uint64_t)s * (uint64_t)C;
    const T v = x[base + s];
    out[base + s] = keep_element(k0, k1, counter, keep) ? Scale<T>::apply(v, keep_t)
                                                        : Scale<T>::zero();
  }
}

template <typename T>
int launch(const void* x, void* out, int64_t B, int C, int hw, uint32_t k0,
           uint32_t k1, uint64_t offset, float keep, float keep_t,
           cudaStream_t s) {
  const int64_t planes = B * C;
  if (planes == 0) return (int)cudaSuccess;
  if (planes > 0x7FFFFFFF) return (int)cudaErrorInvalidValue;
  // a warp-multiple no wider than the plane (small planes leave no lanes idle)
  int threads = ((hw + 31) / 32) * 32;
  if (threads > kThreads) threads = kThreads;
  dropout_kernel<T><<<(unsigned)planes, threads, 0, s>>>(
      (const T*)x, (T*)out, C, hw, k0, k1, offset, keep, keep_t);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 float32, 1 bfloat16. x and out: (B, C, H, W)
// contiguous on the current device, not overlapping. keep: the float32 keep
// probability of the test; keep_t: the same rounded to the activation's type.
extern "C" int mfpa_dropout_threefry(const void* x, void* out, int dtype,
                                     int64_t B, int C, int H, int W,
                                     uint32_t k0, uint32_t k1,
                                     uint64_t offset, float keep,
                                     float keep_t, void* stream) {
  if (B < 0 || C < 1 || H < 1 || W < 1 || (int64_t)H * W > 0x7FFFFFFF)
    return (int)cudaErrorInvalidValue;
  const int hw = H * W;
  cudaStream_t s = (cudaStream_t)stream;
  switch (dtype) {
    case 0:
      return launch<float>(x, out, B, C, hw, k0, k1, offset, keep, keep_t, s);
    case 1:
      return launch<__nv_bfloat16>(x, out, B, C, hw, k0, k1, offset, keep,
                                   keep_t, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
