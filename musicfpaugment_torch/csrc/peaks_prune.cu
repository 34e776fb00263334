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
// What bounds it on an H100: not bytes and not operations, but the chain of
// column steps. At the query shape (B=128, C=251, F=256) the forward pass
// moves 41 MB (~12 us at 3.35 TB/s) and does ~1e8 simple operations, yet a
// row is C column steps that depend on each other through the envelope, and
// rows are the only parallelism (one warp each, alone on its scheduler).
// The kernel's time is therefore C times the length of one step of the
// slowest row, whatever the batch, until the batch fills the card. A lone
// warp runs in order and waits out every latency, so a step costs its
// dependent instructions at 4 to 6 cycles each plus each shuffle, vote,
// reduction and shared-memory read at 25 to 35.
//
// The first version of this file (a shuffle butterfly per argmax, one more
// argmax to find a column empty, loads at their use) took about 2,000 cycles
// a step: 0.358 ms for 251 columns. This one takes about 700 to 800 at the
// query shape and 600 to 670 at the ingest shape, reckoned at the card's
// maximum SM clock (chip_smoke.py prints it as step_cycles_at_max_clock;
// PERF.md has the numbers): about 360 for a column without candidates (a
// launch with maxpks 0), the rest for the rounds. What the step is made of,
// and what shortens it:
//
//   * loads ahead of use. Input is time-major (B, C, F) float32, so one
//     column of a row is F*4 contiguous bytes. Each warp keeps the next
//     kPrefetchDepth columns (the backward kernel also their forward-mask
//     bytes) on their way into a ring of slots in shared memory: cp.async,
//     16 bytes per lane per request, one commit group per column, and
//     cp.async.wait_group leaves the newest kPrefetchDepth - 1 groups in
//     flight while the oldest is consumed. A step never waits on L2 or
//     device memory. (A ring of registers did not do: a wait on a load's
//     scoreboard is a wait on every load started before it was read.) The
//     edge bins of the neighbouring lanes, which the local-maximum test
//     needs, are read from the slot as well, not shuffled.
//   * argmax in two warp reductions. Each float maps to a 32-bit key whose
//     unsigned order is the float order (+0.0f is added first, so -0.0 and
//     +0.0 share a key; a negative has all bits flipped, a non-negative its
//     top bit set; key 0 means "no candidate"; the forward pass's candidates
//     are positive, and there the float's own bits serve). A lane keeps its
//     best (key, bin), ties to the lower bin; __reduce_max_sync gives the
//     warp's maximum key, and __reduce_min_sync over the bins of the lanes
//     that hold it gives the lowest such bin: the order of jnp.argmax and
//     lax.top_k. The winning value is taken back from the key (the same bits
//     as the float plus 0.0f).
//   * a lane's best is kept from round to round. Only the winner's lane
//     looks again, and only at its set candidate bits (a lane mostly has
//     none or one), taking each value from its registers by a select tree.
//   * no empty argmax: one __any_sync skips a column without candidates, and
//     a maximum key of 0 ends the rounds.
//   * candidates and masks are NB-bit words per lane. Clearing the winner
//     and setting its output bit is one shift on the owning lane. Masks
//     leave as one word of up to 8 bytes per lane (one 8-byte store for
//     F = 256), and the backward kernel reads the forward mask from its slot
//     the same way; bits and 0/1 bytes are exchanged by a multiply and a
//     mask.
//   * the backward pass fetches the envelope at the winner's bin (a select
//     tree on the owning lane) with one shuffle.
//   * the Gaussian is not evaluated here: g[d] = exp(-0.5 (d/f_sd)^2),
//     d = |i - p|, arrives as a float32 table built on the host exactly as
//     the plain version builds its (F, F) table. In shared memory it is
//     mirrored around its centre, so a lane's NB bins read NB consecutive
//     entries without an abs, and kept in 4 copies shifted by one entry
//     each, so that for any peak position one copy has the lane's entries
//     16-byte aligned: a bump is one address and NB/4 float4 reads. Every
//     bump is the same IEEE product val * g[d] as in the plain version
//     (__fmul_rn), merges are fmaxf, so the masks agree bit for bit.
//   * the initial envelope walks only the local maxima: per bin slot one
//     ballot, then one shuffle per set bit.
//
// One warp per batch row, kWarpsPerBlock rows per block, no state shared
// between blocks; the envelope lives in registers. The TPU kernel's
// sequential grid axis (column tiles with the envelope carried in VMEM) is
// the loop over columns inside the warp.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kWarp = 32;
constexpr int kWarpsPerBlock = 4;
constexpr int kPrefetchDepth = 4;  // columns in flight per warp
constexpr int kGaussCopies = 4;
constexpr unsigned kFull = 0xffffffffu;

// ---- float <-> ordered key

// unsigned order of the key == float order; -0.0 and +0.0 share a key
__device__ __forceinline__ unsigned float_key(float v) {
  const unsigned u = __float_as_uint(__fadd_rn(v, 0.0f));
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

__device__ __forceinline__ float key_float(unsigned key) {
  return __uint_as_float((key & 0x80000000u) ? (key ^ 0x80000000u) : ~key);
}

// The forward pass's candidates all lie above an envelope that is >= 0, so
// they are positive, and a positive float's own bits are its key without the
// top bit: the same order, and nothing to compute. kPositive picks that.
template <bool kPositive>
__device__ __forceinline__ unsigned candidate_key(float v) {
  return kPositive ? __float_as_uint(v) : float_key(v);
}

template <bool kPositive>
__device__ __forceinline__ float candidate_value(unsigned key) {
  return kPositive ? __uint_as_float(key) : key_float(key);
}

// ---- Gaussian table in shared memory
//
// g2[j] = g[|j - (F - 1)|], j in [0, 2F - 1), is the table mirrored around
// F - 1, so that a lane's NB bins read NB consecutive entries starting at
// base - pos + F - 1, with no abs. Copy s of kGaussCopies holds g2 shifted by
// s entries: whatever pos is, one of the copies has that start 16-byte
// aligned, and the lane reads its entries as float4 (NB % 4 == 0).

__device__ __forceinline__ void load_gauss(float* gs, const float* gauss, int F) {
  for (int t = threadIdx.x; t < kGaussCopies * 2 * F; t += blockDim.x) {
    const int d = abs(t % (2 * F) + t / (2 * F) - (F - 1));
    gs[t] = d < F ? gauss[d] : 0.0f;
  }
  __syncthreads();
}

// th[i] = max(th[i], val * g[|i - pos|])
template <int NB>
__device__ __forceinline__ void bump(float (&th)[NB], const float* gs, int base,
                                     float val, int pos) {
  constexpr int F = NB * kWarp;
  const int c = F - 1 - pos;
  const float* p = gs + (c & 3) * 2 * F + base + (c & ~3);
  if constexpr (NB % 4 == 0) {
#pragma unroll
    for (int j = 0; j < NB / 4; ++j) {
      const float4 t = reinterpret_cast<const float4*>(p)[j];
      th[4 * j] = fmaxf(th[4 * j], __fmul_rn(val, t.x));
      th[4 * j + 1] = fmaxf(th[4 * j + 1], __fmul_rn(val, t.y));
      th[4 * j + 2] = fmaxf(th[4 * j + 2], __fmul_rn(val, t.z));
      th[4 * j + 3] = fmaxf(th[4 * j + 3], __fmul_rn(val, t.w));
    }
  } else {
#pragma unroll
    for (int k = 0; k < NB; ++k) th[k] = fmaxf(th[k], __fmul_rn(val, p[k]));
  }
}

// ---- a lane's NB floats of one column, in the widest aligned requests

template <int NB>
__device__ __forceinline__ void load_col(const float* src, float (&v)[NB]) {
  if constexpr (NB % 4 == 0) {
#pragma unroll
    for (int j = 0; j < NB / 4; ++j) {
      const float4 t = reinterpret_cast<const float4*>(src)[j];
      v[4 * j] = t.x;
      v[4 * j + 1] = t.y;
      v[4 * j + 2] = t.z;
      v[4 * j + 3] = t.w;
    }
  } else if constexpr (NB % 2 == 0) {
#pragma unroll
    for (int j = 0; j < NB / 2; ++j) {
      const float2 t = reinterpret_cast<const float2*>(src)[j];
      v[2 * j] = t.x;
      v[2 * j + 1] = t.y;
    }
  } else {
#pragma unroll
    for (int k = 0; k < NB; ++k) v[k] = src[k];
  }
}

// ---- the per-warp ring of columns in shared memory, filled by cp.async
//
// A slot holds one whole column of the warp's row. The warp copies it
// together, 16 bytes per request; cp.async.wait_group lets the newest
// kPrefetchDepth - 1 copies stay in flight while the oldest is consumed,
// which register loads cannot do (a wait on their scoreboard is a wait on
// all of them).

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(d), "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}

template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(kPending) : "memory");
}

// the warp copies kChunks 16-byte chunks
template <int kChunks>
__device__ __forceinline__ void warp_copy_async(void* dst, const void* src, int lane) {
#pragma unroll
  for (int i = 0; i < (kChunks + kWarp - 1) / kWarp; ++i) {
    const int chunk = i * kWarp + lane;
    if (chunk < kChunks) {
      cp_async16(static_cast<char*>(dst) + 16 * chunk,
                 static_cast<const char*>(src) + 16 * chunk);
    }
  }
}

// this lane's NB bins of the column in a slot, and the bins next to them
// (the other lanes' edge bins, read from the slot instead of by shuffle;
// unused at the row's two ends)
template <int NB>
__device__ __forceinline__ void read_slot(const float* slot, int lane,
                                          float (&v)[NB], float& left,
                                          float& right) {
  const int base = lane * NB;
  load_col<NB>(slot + base, v);
  left = slot[lane == 0 ? 0 : base - 1];
  right = slot[lane == kWarp - 1 ? base : base + NB];
}

// a[idx] for a runtime idx in [0, NB), as a tree of selects over registers
template <int NB>
__device__ __forceinline__ float pick(const float (&a)[NB], int idx) {
  constexpr int kLevels = NB > 8 ? 4 : NB > 4 ? 3 : NB > 2 ? 2 : NB > 1 ? 1 : 0;
  float t[1 << kLevels];
#pragma unroll
  for (int k = 0; k < (1 << kLevels); ++k) t[k] = a[k < NB ? k : NB - 1];
#pragma unroll
  for (int lvl = 0; lvl < kLevels; ++lvl) {
    const bool odd = (idx >> lvl) & 1;
#pragma unroll
    for (int j = 0; j < (1 << (kLevels - 1 - lvl)); ++j) {
      t[j] = odd ? t[2 * j + 1] : t[2 * j];
    }
  }
  return t[0];
}

// ---- a lane's NB mask bytes of one column as words of up to 8 bytes

template <int BYTES> struct UIntOf;
template <> struct UIntOf<1> { using type = uint8_t; };
template <> struct UIntOf<2> { using type = uint16_t; };
template <> struct UIntOf<4> { using type = uint32_t; };
template <> struct UIntOf<8> { using type = uint64_t; };

template <int NB>
struct MaskCol {
  static constexpr int kBytes = NB % 8 == 0 ? 8 : NB % 4 == 0 ? 4 : NB % 2 == 0 ? 2 : 1;
  static constexpr int kWords = NB / kBytes;
  using Word = typename UIntOf<kBytes>::type;
  Word w[kWords];
};

template <int NB>
__device__ __forceinline__ void load_mask(const uint8_t* src, MaskCol<NB>& m) {
  using Word = typename MaskCol<NB>::Word;
#pragma unroll
  for (int j = 0; j < MaskCol<NB>::kWords; ++j) {
    m.w[j] = reinterpret_cast<const Word*>(src)[j];
  }
}

// 0/1 bytes -> bits (bit k = byte k)
template <int NB>
__device__ __forceinline__ unsigned mask_bits(const MaskCol<NB>& m) {
  unsigned bits = 0;
#pragma unroll
  for (int j = 0; j < MaskCol<NB>::kWords; ++j) {
    const uint64_t w = (uint64_t)m.w[j] & 0x0101010101010101ull;
    bits |= (unsigned)((w * 0x0102040810204080ull) >> 56) << (j * MaskCol<NB>::kBytes);
  }
  return bits;
}

// bits -> 0/1 bytes (byte k = bit k), stored as words
template <int NB>
__device__ __forceinline__ void store_bits(uint8_t* dst, unsigned bits) {
  using Word = typename MaskCol<NB>::Word;
  constexpr int kBytes = MaskCol<NB>::kBytes;
#pragma unroll
  for (int j = 0; j < MaskCol<NB>::kWords; ++j) {
    const uint64_t x = (bits >> (j * kBytes)) & ((1u << kBytes) - 1u);
    uint64_t t = (x * 0x0101010101010101ull) & 0x8040201008040201ull;
    t = ((t + 0x7f7f7f7f7f7f7f7full) >> 7) & 0x0101010101010101ull;
    reinterpret_cast<Word*>(dst)[j] = (Word)t;
  }
}

// ---- local maxima and the initial envelope

// local-max mask of one column (bit k = bin base+k):
// nbr[i] = v[i] >= v[i-1] with nbr[0] = true and nbr[F] = false,
// max[i] = nbr[i] && !nbr[i+1]; with kGated only where v[i] > gate[i] too
template <int NB, bool kGated>
__device__ __forceinline__ unsigned locmax_bits(const float (&v)[NB], float left,
                                                float right,
                                                const float (&gate)[NB], int lane) {
  unsigned bits = 0;
#pragma unroll
  for (int k = 0; k < NB; ++k) {
    const bool prev_up =
        k == 0 ? (lane == 0 ? true : v[0] >= left) : v[k] >= v[k - 1];
    const bool next_up =
        k == NB - 1 ? (lane == kWarp - 1 ? false : right >= v[k])
                    : v[k + 1] >= v[k];
    if (prev_up && !next_up && (!kGated || v[k] > gate[k])) bits |= 1u << k;
  }
  return bits;
}

// th = max(0, max over local maxima p of v: v[p] * g[|i - p|]); only the
// local maxima are visited: per bin slot k one ballot over the lanes, then
// one shuffle per set bit. left / right are the neighbouring lanes' edge bins.
template <int NB>
__device__ __forceinline__ void spread_init(const float (&v)[NB], float left,
                                            float right, float (&th)[NB],
                                            const float* gs, int lane) {
  const int base = lane * NB;
  const unsigned lm = locmax_bits<NB, false>(v, left, right, v, lane);
#pragma unroll
  for (int k = 0; k < NB; ++k) th[k] = 0.0f;
#pragma unroll
  for (int k = 0; k < NB; ++k) {
    unsigned ball = __ballot_sync(kFull, (lm >> k) & 1u);
    while (ball) {
      const int src = __ffs(ball) - 1;
      ball &= ball - 1;
      const float vp = __shfl_sync(kFull, v[k], src);
      bump<NB>(th, gs, base, vp, src * NB + k);
    }
  }
}

// ---- the warp's largest remaining candidate

// this lane's best key over its candidate bits, ties to the lower bin; 0 if
// it has none. bk is the bin's slot in the lane. Only the set bits are
// visited (mostly none or one), each value taken by a select tree.
template <int NB, bool kPositive>
__device__ __forceinline__ void lane_best(const float (&v)[NB], unsigned cand,
                                          unsigned& best, int& bk) {
  best = 0u;
  bk = 0;
  while (cand) {
    const int k = __ffs(cand) - 1;
    cand &= cand - 1;
    const unsigned key = candidate_key<kPositive>(pick<NB>(v, k));
    if (key > best) {
      best = key;
      bk = k;
    }
  }
}

// The warp's maximum key and the lowest bin that holds it (mypos is this
// lane's best bin): two reductions. 0 when no lane has a candidate left.
// Lane l holds bins [l*NB, (l+1)*NB), so with lane_best's tie rule that is
// the lowest bin among equal values, the order of jnp.argmax and lax.top_k.
__device__ __forceinline__ unsigned warp_best(unsigned best, int mypos, int& pos) {
  const unsigned top = __reduce_max_sync(kFull, best);
  pos = __reduce_min_sync(kFull, best == top ? mypos : 0x7fffffff);
  return top;
}

// ---- kernels

// shared memory: the Gaussian copies, then per warp kPrefetchDepth column
// slots of F floats, then (backward only) per warp as many mask slots of F
// bytes
__host__ __device__ constexpr size_t gauss_floats(int F) {
  return (size_t)kGaussCopies * 2 * F;
}

size_t smem_bytes(int F, bool with_masks) {
  const size_t slots = (size_t)kWarpsPerBlock * kPrefetchDepth * F;
  return (gauss_floats(F) + slots) * sizeof(float) + (with_masks ? slots : 0);
}

template <int NB>
__global__ void __launch_bounds__(kWarpsPerBlock * kWarp)
    fwd_kernel(const float* __restrict__ sgram, uint8_t* __restrict__ out,
               const float* __restrict__ gauss, int B, int C, float a_dec,
               int maxpks) {
  constexpr int F = NB * kWarp;
  extern __shared__ __align__(16) float gs[];
  load_gauss(gs, gauss, F);

  const int warp = threadIdx.x / kWarp;
  const int lane = threadIdx.x % kWarp;
  const int b = blockIdx.x * kWarpsPerBlock + warp;
  if (b >= B) return;
  const int base = lane * NB;
  const float* row = sgram + (size_t)b * C * F;
  uint8_t* orow = out + (size_t)b * C * F + base;
  float* ring = gs + gauss_floats(F) + (size_t)warp * kPrefetchDepth * F;

  // the first kPrefetchDepth columns start on their way
#pragma unroll
  for (int d = 0; d < kPrefetchDepth; ++d) {
    if (d < C) warp_copy_async<F / 4>(ring + d * F, row + (size_t)d * F, lane);
    cp_async_commit();
  }

  // envelope start: spread of the max over the first min(10, C) columns
  float th[NB];
  {
    float v[NB];
#pragma unroll
    for (int k = 0; k < NB; ++k) v[k] = -INFINITY;
#pragma unroll
    for (int c = 0; c < 10; ++c) {
      if (c < C) {
        float t[NB];
        load_col<NB>(row + (size_t)c * F + base, t);
#pragma unroll
        for (int k = 0; k < NB; ++k) v[k] = fmaxf(v[k], t[k]);
      }
    }
    const float left = __shfl_up_sync(kFull, v[NB - 1], 1);
    const float right = __shfl_down_sync(kFull, v[0], 1);
    spread_init<NB>(v, left, right, th, gs, lane);
  }

  for (int cb = 0; cb < C; cb += kPrefetchDepth) {
#pragma unroll
    for (int d = 0; d < kPrefetchDepth; ++d) {
      const int c = cb + d;
      if (c >= C) break;
      // column c has landed in slot d; take it out and send the slot for
      // column c + kPrefetchDepth
      float v[NB], left, right;
      cp_async_wait<kPrefetchDepth - 1>();
      __syncwarp();
      read_slot<NB>(ring + d * F, lane, v, left, right);
      __syncwarp();
      if (c + kPrefetchDepth < C) {
        warp_copy_async<F / 4>(ring + d * F,
                               row + (size_t)(c + kPrefetchDepth) * F, lane);
      }
      cp_async_commit();

      // candidates: local maxima above the column-start envelope
      unsigned cand = locmax_bits<NB, true>(v, left, right, th, lane);

      // accept up to maxpks of them, largest first; each raises the envelope
      unsigned peaks = 0;
      if (maxpks > 0 && __any_sync(kFull, cand != 0u)) {
        unsigned best;
        int bk;
        lane_best<NB, true>(v, cand, best, bk);
        for (int r = 0; r < maxpks; ++r) {
          int pos;
          const unsigned top = warp_best(best, base + bk, pos);
          if (top == 0u) break;
          if ((unsigned)(pos - base) < (unsigned)NB) {
            // only the winner's lane has to look again
            peaks |= 1u << bk;
            cand &= ~(1u << bk);
            lane_best<NB, true>(v, cand, best, bk);
          }
          bump<NB>(th, gs, base, candidate_value<true>(top), pos);
        }
      }
#pragma unroll
      for (int k = 0; k < NB; ++k) th[k] = __fmul_rn(th[k], a_dec);
      store_bits<NB>(orow + (size_t)c * F, peaks);
    }
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
  extern __shared__ __align__(16) float gs[];
  load_gauss(gs, gauss, F);

  const int warp = threadIdx.x / kWarp;
  const int lane = threadIdx.x % kWarp;
  const int b = blockIdx.x * kWarpsPerBlock + warp;
  if (b >= B) return;
  const int base = lane * NB;
  const float* row = sgram + (size_t)b * C * F;
  const uint8_t* prow = fwd_peaks + (size_t)b * C * F;
  uint8_t* orow = out + (size_t)b * C * F + base;
  float* ring = gs + gauss_floats(F) + (size_t)warp * kPrefetchDepth * F;
  uint8_t* mring =
      reinterpret_cast<uint8_t*>(gs + gauss_floats(F) +
                                 (size_t)kWarpsPerBlock * kPrefetchDepth * F) +
      (size_t)warp * kPrefetchDepth * F;

  int vf = valid_frames ? valid_frames[b] : C;
  vf = vf < 0 ? 0 : (vf > C ? C : vf);
  // columns at or past the row's valid count hold no peaks
  for (int c = vf; c < C; ++c) store_bits<NB>(orow + (size_t)c * F, 0u);
  if (vf == 0) return;

  // the last kPrefetchDepth valid columns and their forward-mask bytes start
  // on their way; the scan runs right to left from column vf - 1
#pragma unroll
  for (int d = 0; d < kPrefetchDepth; ++d) {
    const int c = vf - 1 - d;
    if (c >= 0) {
      warp_copy_async<F / 4>(ring + d * F, row + (size_t)c * F, lane);
      warp_copy_async<F / 16>(mring + d * F, prow + (size_t)c * F, lane);
    }
    cp_async_commit();
  }

  // envelope start: spread of the last valid column; it is frozen across
  // the padded columns, so the scan simply starts at column vf - 1
  float th[NB];
  {
    float v[NB], left, right;
    cp_async_wait<kPrefetchDepth - 1>();
    __syncwarp();
    read_slot<NB>(ring, lane, v, left, right);
    spread_init<NB>(v, left, right, th, gs, lane);
  }

  unsigned kept_next = 0;  // kept bits of column c + 1
  for (int cb = vf - 1; cb >= 0; cb -= kPrefetchDepth) {
#pragma unroll
    for (int d = 0; d < kPrefetchDepth; ++d) {
      const int c = cb - d;
      if (c < 0) break;
      // column c has landed in slot d; take it out and send the slot for
      // column c - kPrefetchDepth
      float v[NB], left, right;
      MaskCol<NB> mcol;
      cp_async_wait<kPrefetchDepth - 1>();
      __syncwarp();
      read_slot<NB>(ring + d * F, lane, v, left, right);
      load_mask<NB>(mring + d * F + base, mcol);
      __syncwarp();
      if (c - kPrefetchDepth >= 0) {
        warp_copy_async<F / 4>(ring + d * F,
                               row + (size_t)(c - kPrefetchDepth) * F, lane);
        warp_copy_async<F / 16>(mring + d * F,
                                prow + (size_t)(c - kPrefetchDepth) * F, lane);
      }
      cp_async_commit();

      // candidates: the column's forward peaks. One that is -inf is taken
      // last and never passes the test, as in the plain version.
      unsigned cand = mask_bits<NB>(mcol);

      // re-test them in descending order; a kept peak raises the envelope
      // for the smaller ones
      unsigned kept = 0;
      if (maxpks > 0 && __any_sync(kFull, cand != 0u)) {
        unsigned best;
        int bk;
        lane_best<NB, false>(v, cand, best, bk);
        for (int r = 0; r < maxpks; ++r) {
          int pos;
          const unsigned top = warp_best(best, base + bk, pos);
          if (top == 0u) break;
          const float thr = __shfl_sync(kFull, pick<NB>(th, bk), pos / NB);
          const float val = candidate_value<false>(top);
          const bool keep = val >= thr;
          if ((unsigned)(pos - base) < (unsigned)NB) {
            // only the winner's lane has to look again
            if (keep) kept |= 1u << bk;
            cand &= ~(1u << bk);
            lane_best<NB, false>(v, cand, best, bk);
          }
          if (keep) bump<NB>(th, gs, base, val, pos);
        }
      }
#pragma unroll
      for (int k = 0; k < NB; ++k) th[k] = __fmul_rn(th[k], a_dec);
      // a kept peak deletes a same-bin peak in the next column
      if (c + 1 < vf) {
        store_bits<NB>(orow + (size_t)(c + 1) * F, kept_next & ~kept);
      }
      kept_next = kept;
    }
  }
  store_bits<NB>(orow, kept_next);
}

bool bad_shape(int B, int C, int F) {
  return B < 1 || C < 1 || F % kWarp != 0 || F < kWarp || F > 16 * kWarp;
}

// a block may use more than 48 KB of dynamic shared memory only after this
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)smem);
}

}  // namespace

#define MFPA_NB_CASES(X) \
  X(1) X(2) X(3) X(4) X(5) X(6) X(7) X(8) \
  X(9) X(10) X(11) X(12) X(13) X(14) X(15) X(16)

// sgram: (B, C, F) float32, 16-byte aligned; out: (B, C, F) uint8, 8-byte
// aligned; gauss: (F,) float32
extern "C" int mfpa_forward_prune(const float* sgram, uint8_t* out,
                                  const float* gauss, int B, int C, int F,
                                  float a_dec, int maxpks, void* stream) {
  if (bad_shape(B, C, F)) return (int)cudaErrorInvalidValue;
  const dim3 grid((B + kWarpsPerBlock - 1) / kWarpsPerBlock);
  const dim3 block(kWarpsPerBlock * kWarp);
  const size_t smem = smem_bytes(F, false);
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t err = cudaSuccess;
  switch (F / kWarp) {
#define X(NB)                                                             \
  case NB:                                                                \
    err = allow_smem(fwd_kernel<NB>, smem);                               \
    if (err != cudaSuccess) return (int)err;                              \
    fwd_kernel<NB><<<grid, block, smem, s>>>(sgram, out, gauss, B, C,     \
                                             a_dec, maxpks);              \
    break;
    MFPA_NB_CASES(X)
#undef X
  }
  return (int)cudaGetLastError();
}

// as above; peaks: (B, C, F) uint8 of 0/1 bytes, 16-byte aligned;
// valid_frames: (B,) int32 or null
extern "C" int mfpa_backward_prune(const float* sgram, const uint8_t* peaks,
                                   const int* valid_frames, uint8_t* out,
                                   const float* gauss, int B, int C, int F,
                                   float a_dec, int maxpks, void* stream) {
  if (bad_shape(B, C, F)) return (int)cudaErrorInvalidValue;
  const dim3 grid((B + kWarpsPerBlock - 1) / kWarpsPerBlock);
  const dim3 block(kWarpsPerBlock * kWarp);
  const size_t smem = smem_bytes(F, true);
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t err = cudaSuccess;
  switch (F / kWarp) {
#define X(NB)                                                             \
  case NB:                                                                \
    err = allow_smem(bwd_kernel<NB>, smem);                               \
    if (err != cudaSuccess) return (int)err;                              \
    bwd_kernel<NB><<<grid, block, smem, s>>>(sgram, peaks, valid_frames,  \
                                             out, gauss, B, C, a_dec,     \
                                             maxpks);                     \
    break;
    MFPA_NB_CASES(X)
#undef X
  }
  return (int)cudaGetLastError();
}
