// Decaying-threshold peak prune, forward and backward, for Hopper (sm_90a).
//
// Replaces the two Pallas TPU kernels of
// musicfpaugment_tpu/afp/audfprint/peaks_pallas.py:
//   fwd_kernel <- _fwd_kernel (peaks_pallas.py:60-110, forward_prune_pallas)
//   bwd_kernel <- _bwd_kernel (peaks_pallas.py:113-160, backward_prune_pallas),
//                 with the same-bin next-column kill of peaks_pallas.py:259-261
//                 done in the kernel, and the per-row valid_frames semantics of
//                 the scan version (peaks.py:198-244), which the Pallas kernel
//                 lacks.
//
// What bounds it on an H100: not bytes. At the query shape (B=128, C=251,
// F=256) the forward pass reads 33 MB and writes 8 MB, ~12 us at 3.35 TB/s,
// and does ~1e8 simple operations. The limiter is latency: each row is a
// chain of C dependent column steps, each with up to maxpks=5 dependent warp
// argmax reductions (5 shuffle rounds each) and a shared-memory Gaussian
// lookup per bin. Rows are independent, so the design puts one row on one
// warp and runs all rows at once; the per-row chain is left as it is (a
// later change can split a column's candidates across fewer rounds or
// overlap the next column's load with this column's reductions).
//
// Design:
//   * one warp per batch row, WARPS_PER_BLOCK rows per block, no state
//     shared between blocks. The TPU kernel's sequential grid axis (column
//     tiles with the envelope carried in VMEM) becomes a loop over columns
//     inside the warp, with the envelope in registers: lane l holds bins
//     [l*NB, (l+1)*NB), NB = F/32.
//   * input is time-major (B, C, F) float32, so one column of one row is a
//     contiguous F-float read by the warp; output is (B, C, F) uint8.
//   * local maxima need each lane's edge neighbours: __shfl_up/down_sync.
//   * argmax is a __shfl_xor_sync butterfly over (value, bin) with ties to
//     the lowest bin, the order of jnp.argmax and lax.top_k; a -inf
//     maximum means no peak is left.
//   * the Gaussian is not evaluated here: g[d] = exp(-0.5 (d/f_sd)^2),
//     d = |i - p|, arrives as a float32 table built on the host exactly as
//     the plain version builds its (F, F) table, and is kept in shared
//     memory. Every bump is then the same IEEE product val * g[d] as in the
//     plain version, and max-merges are exact, so the masks agree bit for
//     bit.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kWarp = 32;
constexpr int kWarpsPerBlock = 4;
constexpr unsigned kFull = 0xffffffffu;

// warp-wide argmax of (v, i); ties go to the lowest i
__device__ __forceinline__ void warp_argmax(float& v, int& i) {
#pragma unroll
  for (int off = kWarp / 2; off > 0; off >>= 1) {
    const float ov = __shfl_xor_sync(kFull, v, off);
    const int oi = __shfl_xor_sync(kFull, i, off);
    if (ov > v || (ov == v && oi < i)) {
      v = ov;
      i = oi;
    }
  }
}

// this lane's best (value, bin) over its NB bins; ties to the lowest bin
template <int NB>
__device__ __forceinline__ void lane_argmax(const float (&vals)[NB], int base,
                                            float& v, int& i) {
  v = vals[0];
  i = base;
#pragma unroll
  for (int k = 1; k < NB; ++k) {
    if (vals[k] > v) {
      v = vals[k];
      i = base + k;
    }
  }
}

// local-max mask of one column (bit k = bin base+k):
// nbr[i] = v[i] >= v[i-1] with nbr[0] = true and nbr[F] = false,
// max[i] = nbr[i] && !nbr[i+1]
template <int NB>
__device__ __forceinline__ unsigned locmax_bits(const float (&v)[NB], int lane) {
  const float left = __shfl_up_sync(kFull, v[NB - 1], 1);
  const float right = __shfl_down_sync(kFull, v[0], 1);
  unsigned bits = 0;
#pragma unroll
  for (int k = 0; k < NB; ++k) {
    const bool prev_up =
        k == 0 ? (lane == 0 ? true : v[0] >= left) : v[k] >= v[k - 1];
    const bool next_up =
        k == NB - 1 ? (lane == kWarp - 1 ? false : right >= v[k])
                    : v[k + 1] >= v[k];
    if (prev_up && !next_up) bits |= 1u << k;
  }
  return bits;
}

// th = max(0, max over local maxima p of v: v[p] * g[|i - p|])
template <int NB>
__device__ void spread_init(const float (&v)[NB], float (&th)[NB],
                            float* scratch, const float* g, int lane) {
  constexpr int F = NB * kWarp;
  const int base = lane * NB;
  const unsigned lm = locmax_bits<NB>(v, lane);
#pragma unroll
  for (int k = 0; k < NB; ++k) {
    scratch[base + k] = (lm >> k) & 1u ? v[k] : -INFINITY;
    th[k] = 0.0f;
  }
  __syncwarp();
  for (int p = 0; p < F; ++p) {
    const float vp = scratch[p];
    if (vp == -INFINITY) continue;
#pragma unroll
    for (int k = 0; k < NB; ++k) {
      th[k] = fmaxf(th[k], __fmul_rn(vp, g[abs(base + k - p)]));
    }
  }
  __syncwarp();
}

// th[i] = max(th[i], val * g[|i - pos|])
template <int NB>
__device__ __forceinline__ void bump(float (&th)[NB], const float* g, int base,
                                     float val, int pos) {
#pragma unroll
  for (int k = 0; k < NB; ++k) {
    th[k] = fmaxf(th[k], __fmul_rn(val, g[abs(base + k - pos)]));
  }
}

template <int NB>
__device__ __forceinline__ void load_col(const float* src, float (&v)[NB]) {
#pragma unroll
  for (int k = 0; k < NB; ++k) v[k] = src[k];
}

template <int NB>
__device__ __forceinline__ void store_bits(uint8_t* dst, unsigned bits) {
#pragma unroll
  for (int k = 0; k < NB; ++k) dst[k] = (bits >> k) & 1u;
}

template <int NB>
__global__ void __launch_bounds__(kWarpsPerBlock * kWarp)
    fwd_kernel(const float* __restrict__ sgram, uint8_t* __restrict__ out,
               const float* __restrict__ gauss, int B, int C, float a_dec,
               int maxpks) {
  constexpr int F = NB * kWarp;
  extern __shared__ float smem[];
  float* g = smem;
  for (int t = threadIdx.x; t < F; t += blockDim.x) g[t] = gauss[t];
  __syncthreads();

  const int warp = threadIdx.x / kWarp;
  const int lane = threadIdx.x % kWarp;
  const int b = blockIdx.x * kWarpsPerBlock + warp;
  if (b >= B) return;
  float* scratch = smem + F + warp * F;
  const int base = lane * NB;
  const float* row = sgram + (size_t)b * C * F + base;
  uint8_t* orow = out + (size_t)b * C * F + base;

  // envelope start: spread of the max over the first min(10, C) columns
  float v[NB];
#pragma unroll
  for (int k = 0; k < NB; ++k) v[k] = -INFINITY;
  const int c0 = C < 10 ? C : 10;
  for (int c = 0; c < c0; ++c) {
#pragma unroll
    for (int k = 0; k < NB; ++k) v[k] = fmaxf(v[k], row[(size_t)c * F + k]);
  }
  float th[NB];
  spread_init<NB>(v, th, scratch, g, lane);

  for (int c = 0; c < C; ++c) {
    load_col<NB>(row + (size_t)c * F, v);
    // candidates: local maxima above the column-start envelope
    const unsigned lm = locmax_bits<NB>(v, lane);
    float vals[NB];
#pragma unroll
    for (int k = 0; k < NB; ++k) {
      vals[k] = ((lm >> k) & 1u) && v[k] > th[k] ? v[k] : -INFINITY;
    }
    // accept up to maxpks of them, largest first; each raises the envelope
    unsigned peaks = 0;
    for (int r = 0; r < maxpks; ++r) {
      float best;
      int pos;
      lane_argmax<NB>(vals, base, best, pos);
      warp_argmax(best, pos);
      if (best == -INFINITY) break;
#pragma unroll
      for (int k = 0; k < NB; ++k) {
        if (base + k == pos) {
          peaks |= 1u << k;
          vals[k] = -INFINITY;
        }
      }
      bump<NB>(th, g, base, best, pos);
    }
#pragma unroll
    for (int k = 0; k < NB; ++k) th[k] = __fmul_rn(th[k], a_dec);
    store_bits<NB>(orow + (size_t)c * F, peaks);
  }
}

template <int NB>
__global__ void __launch_bounds__(kWarpsPerBlock * kWarp)
    bwd_kernel(const float* __restrict__ sgram,
               const uint8_t* __restrict__ fwd_peaks,
               const int* __restrict__ valid_frames,
               uint8_t* __restrict__ out, const float* __restrict__ gauss,
               int B, int C, float a_dec, int maxpks) {
  constexpr int F = NB * kWarp;
  extern __shared__ float smem[];
  float* g = smem;
  for (int t = threadIdx.x; t < F; t += blockDim.x) g[t] = gauss[t];
  __syncthreads();

  const int warp = threadIdx.x / kWarp;
  const int lane = threadIdx.x % kWarp;
  const int b = blockIdx.x * kWarpsPerBlock + warp;
  if (b >= B) return;
  float* scratch = smem + F + warp * F;
  const int base = lane * NB;
  const float* row = sgram + (size_t)b * C * F + base;
  const uint8_t* prow = fwd_peaks + (size_t)b * C * F + base;
  uint8_t* orow = out + (size_t)b * C * F + base;

  int vf = valid_frames ? valid_frames[b] : C;
  vf = vf < 0 ? 0 : (vf > C ? C : vf);
  // columns at or past the row's valid count hold no peaks
  for (int c = vf; c < C; ++c) store_bits<NB>(orow + (size_t)c * F, 0u);
  if (vf == 0) return;

  // envelope start: spread of the last valid column; it is frozen across
  // the padded columns, so the scan simply starts at column vf - 1
  float v[NB];
  load_col<NB>(row + (size_t)(vf - 1) * F, v);
  float th[NB];
  spread_init<NB>(v, th, scratch, g, lane);

  unsigned kept_next = 0;  // kept bits of column c + 1
  for (int c = vf - 1; c >= 0; --c) {
    load_col<NB>(row + (size_t)c * F, v);
    float vals[NB];
#pragma unroll
    for (int k = 0; k < NB; ++k) {
      vals[k] = prow[(size_t)c * F + k] ? v[k] : -INFINITY;
    }
    // re-test the forward peaks in descending order; a kept peak raises
    // the envelope for the smaller ones
    unsigned kept = 0;
    for (int r = 0; r < maxpks; ++r) {
      float best;
      int pos;
      lane_argmax<NB>(vals, base, best, pos);
      warp_argmax(best, pos);
      if (best == -INFINITY) break;
      float mine = 0.0f;
#pragma unroll
      for (int k = 0; k < NB; ++k) {
        if (base + k == pos) mine = th[k];
      }
      const float thr = __shfl_sync(kFull, mine, pos / NB);
      const bool keep = best >= thr;
      if (keep) bump<NB>(th, g, base, best, pos);
#pragma unroll
      for (int k = 0; k < NB; ++k) {
        if (base + k == pos) {
          vals[k] = -INFINITY;
          if (keep) kept |= 1u << k;
        }
      }
    }
#pragma unroll
    for (int k = 0; k < NB; ++k) th[k] = __fmul_rn(th[k], a_dec);
    // a kept peak deletes a same-bin peak in the next column
    if (c + 1 < vf) store_bits<NB>(orow + (size_t)(c + 1) * F, kept_next & ~kept);
    kept_next = kept;
  }
  store_bits<NB>(orow, kept_next);
}

size_t smem_bytes(int F) {
  return (size_t)F * (1 + kWarpsPerBlock) * sizeof(float);
}

}  // namespace

#define MFPA_NB_CASES(X) \
  X(1) X(2) X(3) X(4) X(5) X(6) X(7) X(8) \
  X(9) X(10) X(11) X(12) X(13) X(14) X(15) X(16)

extern "C" int mfpa_forward_prune(const float* sgram, uint8_t* out,
                                  const float* gauss, int B, int C, int F,
                                  float a_dec, int maxpks, void* stream) {
  if (B < 1 || C < 1 || F % kWarp != 0 || F < kWarp || F > 16 * kWarp)
    return (int)cudaErrorInvalidValue;
  const dim3 grid((B + kWarpsPerBlock - 1) / kWarpsPerBlock);
  const dim3 block(kWarpsPerBlock * kWarp);
  const size_t smem = smem_bytes(F);
  cudaStream_t s = (cudaStream_t)stream;
  switch (F / kWarp) {
#define X(NB)                                                             \
  case NB:                                                                \
    fwd_kernel<NB><<<grid, block, smem, s>>>(sgram, out, gauss, B, C,     \
                                             a_dec, maxpks);              \
    break;
    MFPA_NB_CASES(X)
#undef X
  }
  return (int)cudaGetLastError();
}

extern "C" int mfpa_backward_prune(const float* sgram, const uint8_t* peaks,
                                   const int* valid_frames, uint8_t* out,
                                   const float* gauss, int B, int C, int F,
                                   float a_dec, int maxpks, void* stream) {
  if (B < 1 || C < 1 || F % kWarp != 0 || F < kWarp || F > 16 * kWarp)
    return (int)cudaErrorInvalidValue;
  const dim3 grid((B + kWarpsPerBlock - 1) / kWarpsPerBlock);
  const dim3 block(kWarpsPerBlock * kWarp);
  const size_t smem = smem_bytes(F);
  cudaStream_t s = (cudaStream_t)stream;
  switch (F / kWarp) {
#define X(NB)                                                             \
  case NB:                                                                \
    bwd_kernel<NB><<<grid, block, smem, s>>>(sgram, peaks, valid_frames,  \
                                             out, gauss, B, C, a_dec,     \
                                             maxpks);                     \
    break;
    MFPA_NB_CASES(X)
#undef X
  }
  return (int)cudaGetLastError();
}
