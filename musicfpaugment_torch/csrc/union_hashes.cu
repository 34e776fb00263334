// The audfprint matcher's hashing stage for Hopper (sm_90a): every time
// shift's peak mask of a query batch to the ascending, deduplicated union of
// the shifts' (time, hash) landmark pairs, compacted, in one launch.
//
// It replaces no TPU kernel: the JAX package hashes with XLA
// (musicfpaugment_tpu/afp/audfprint/landmarks.py: hashes_from_masks_batched,
// sort_dedup_hashes, compact_valid_first). The port's plain chain of the same
// three functions (landmarks.union_hashes_plain) is the reference it must
// equal bit for bit, and on the card it was about 1,000 PyTorch launches a
// batch of 128 queries x 4 shifts, ~48 ms of device time: per shift a long
// cumsum over each query's mask, five 64-offset chunks of the pairing grid
// with an int64 cumsum over 163,840 rows of 64 each (one 512-thread block a
// row: the innermost-dim scan's grid starves when rows outnumber their
// length), a three-pass rank loop, a stable int64 sort; then a 15,360-wide
// sort, the dedup and a compaction scan.
//
// What bounds it on an H100: neither bytes nor operations. At the query
// shape (B = 128, F = 256, C = 251/250, 4 shifts) the stage reads 32.9 MB of
// mask bytes and writes 4.2 MB, ~11 us at 3.35 TB/s, and does a few million
// integer operations. A query's work is a chain of dependent steps (find the
// peaks in order, pair each with the next ones, order and deduplicate the
// union), so what costs is latency: barriers, the round trips of the loads,
// and launches. What the design does about that:
//
//   * one block a query, one launch a batch; everything between the masks
//     and the output stays in the block's workspace (shared memory, or a
//     slice of the scratch buffer in device memory where a long input does not
//     fit: ~98 KB at 8 s x 4 shifts, ~370 KB at 30 s).
//   * the shifts come as a table (24 bytes a shift) that the host call
//     copies into the head of the launch's scratch buffer on its stream,
//     so the number of shifts has no fixed limit; each shift's first peak
//     slot and peak count live in the workspace.
//   * peaks by ballot-free bit counting: the masks are time-major (C, F)
//     0/1 bytes, so (column, bin) order is memory order. Each thread reads
//     128 contiguous bytes (eight 16-byte loads, all in flight at once), turns
//     them into 128 bits, and one block prefix count over the threads' bit
//     counts gives every set cell its peak index; a whole 8 s shift is one
//     64 KB tile. Reading stops once the shift's P peaks are found.
//   * pairing from shared memory: a thread walks its peak's successors until
//     it has MAXPAIRSPERPEAK pairs, leaves the window, or dt reaches
//     TARGETDT (columns never decrease along the peaks, so nothing later
//     pairs). It is done twice, once to count each column's pairs and once
//     to place them; the walk is a few shared-memory reads a peak, cheaper
//     than keeping S * P * 3 pairs twice.
//   * order and dedup without a sort: a time is its anchor's column, so a
//     count by column and one prefix sum give each column a bucket in
//     (time) order, the pairs of every shift go into their bucket, and inside
//     a bucket (a few entries at real density) each pair finds by a linear
//     scan whether it is the first of its value and how many distinct values
//     lie below it. A second prefix sum over the columns' distinct counts
//     gives each first pair its output lane.
//
// Per-shift dedup then cross-shift dedup (the plain chain) is the same set
// as one dedup of the union, which this kernel computes.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kVec = 8;  // 16-byte loads a thread a tile
constexpr int kTileBytes = kThreads * kVec * 16;  // 64 KB of mask a tile
constexpr unsigned kFull = 0xffffffffu;
// landmarks.py: MAXPAIRSPERPEAK, MINDT, TARGETDT, TARGETDF
constexpr int kMaxPairs = 3;
constexpr int kMinDt = 2;
constexpr int kTargetDt = 63;
constexpr int kTargetDf = 31;
constexpr int kWindow = 320;  // hashes_from_masks_batched's window
// a peak is (column << kBinBits) | bin in one word: F <= 1024, C < 2^22
constexpr int kBinBits = 10;
constexpr unsigned kBinMask = (1u << kBinBits) - 1;
// a workspace up to this size lives in shared memory (227 KB a block, less
// the scan's static array)
constexpr long long kSharedLimit = 220 * 1024;

// one shift's masks, a row of the table the wrapper hands the kernel in
// device memory (three int64 words a shift)
struct Shift {
  const uint8_t* mask;  // query 0: (C_s, F) 0/1 bytes
  long long row_stride;  // bytes from one query to the next
  int cols;  // C_s
  int max_peaks;  // P_s
};
static_assert(sizeof(Shift) == 24, "the wrapper writes three int64 words a shift");

// Exclusive prefix sum of v over the block; *total gets the sum. Every
// thread of the block calls it.
__device__ int block_exclusive_scan(int v, int* total) {
  __shared__ int warp_sums[kWarps];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int x = v;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int y = __shfl_up_sync(kFull, x, d);
    if (lane >= d) x += y;
  }
  if (lane == 31) warp_sums[warp] = x;
  __syncthreads();
  if (warp == 0) {
    int w = lane < kWarps ? warp_sums[lane] : 0;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int y = __shfl_up_sync(kFull, w, d);
      if (lane >= d) w += y;
    }
    if (lane < kWarps) warp_sums[lane] = w;
  }
  __syncthreads();
  *total = warp_sums[kWarps - 1];
  const int excl = x - v + (warp ? warp_sums[warp - 1] : 0);
  __syncthreads();  // warp_sums is free for the next call
  return excl;
}

// a[0..n) to its exclusive prefix sums in place, a[n] = the sum.
__device__ void scan_array(int* a, int n) {
  const int per = (n + kThreads - 1) / kThreads;
  const int lo = min(n, (int)threadIdx.x * per), hi = min(n, lo + per);
  int sum = 0;
  for (int i = lo; i < hi; ++i) sum += a[i];
  int total;
  int run = block_exclusive_scan(sum, &total);
  for (int i = lo; i < hi; ++i) {
    const int v = a[i];
    a[i] = run;
    run += v;
  }
  if (threadIdx.x == 0) a[n] = total;
  __syncthreads();
}

// 4 mask bytes -> 4 bits, byte k (nonzero or not) at bit k
__device__ __forceinline__ unsigned nibble(unsigned w) {
  return ((__vcmpne4(w, 0u) & 0x01010101u) * 0x01020408u) >> 24;
}

__device__ __forceinline__ unsigned bits16(uint4 v) {
  return nibble(v.x) | (nibble(v.y) << 4) | (nibble(v.z) << 8) | (nibble(v.w) << 12);
}

// The first P set cells of one query's (C, F) mask (len = C * F bytes), in
// memory order, i.e. (column, bin) order, into pk as (col << kBinBits) | bin.
// Returns min(set cells, P).
__device__ int extract_peaks(const uint8_t* row, int len, int F, int P, uint32_t* pk) {
  int count = 0;
  for (int base = 0; base < len && count < P; base += kTileBytes) {
    const int start = base + (int)threadIdx.x * (kVec * 16);
    uint4 v[kVec];
#pragma unroll
    for (int k = 0; k < kVec; ++k) {
      const int o = start + k * 16;
      v[k] = o < len ? __ldg(reinterpret_cast<const uint4*>(row + o)) : make_uint4(0u, 0u, 0u, 0u);
    }
    unsigned bits[kVec / 2];
    int n = 0;
#pragma unroll
    for (int k = 0; k < kVec / 2; ++k) {
      bits[k] = bits16(v[2 * k]) | (bits16(v[2 * k + 1]) << 16);
      n += __popc(bits[k]);
    }
    int total;
    int rank = count + block_exclusive_scan(n, &total);
#pragma unroll
    for (int k = 0; k < kVec / 2; ++k) {
      unsigned b = bits[k];
      while (b && rank < P) {
        const int pos = start + k * 32 + __ffs(b) - 1;
        b &= b - 1;
        const int col = pos / F;
        pk[rank++] = ((unsigned)col << kBinBits) | (unsigned)(pos - col * F);
      }
    }
    count += total;
  }
  return min(count, P);
}

// Peak i's pairs among its n peaks: the first kMaxPairs of peaks
// i+1 .. min(i + kWindow, n - 1) with kMinDt <= dt < kTargetDt and
// |df| < kTargetDf, as hashes ((bin & 255) << 12) | ((df & 63) << 6) |
// (dt & 63) in h0..h2. Returns their count; *col gets the anchor's column.
__device__ __forceinline__ int pair_peak(const uint32_t* pk, int i, int n, int* col,
                                         unsigned& h0, unsigned& h1, unsigned& h2) {
  const unsigned a = pk[i];
  const int ci = (int)(a >> kBinBits), bi = (int)(a & kBinMask);
  *col = ci;
  const int end = min(i + kWindow, n - 1);
  int k = 0;
  for (int j = i + 1; j <= end; ++j) {
    const unsigned q = pk[j];
    const int dt = (int)(q >> kBinBits) - ci;
    if (dt >= kTargetDt) break;  // columns never decrease along the peaks
    if (dt < kMinDt) continue;
    const int df = (int)(q & kBinMask) - bi;
    if (df > -kTargetDf && df < kTargetDf) {
      const unsigned h =
          ((unsigned)(bi & 255) << 12) | ((unsigned)(df & 63) << 6) | (unsigned)(dt & 63);
      if (k == 0) h0 = h;
      else if (k == 1) h1 = h;
      else h2 = h;
      if (++k == kMaxPairs) break;
    }
  }
  return k;
}

// the column whose bucket holds pair k: off[c] <= k < off[c + 1]
__device__ __forceinline__ int column_of(const int* off, int c_max, int k) {
  int lo = 0, hi = c_max;
  while (hi - lo > 1) {
    const int mid = (lo + hi) >> 1;
    if (off[mid] <= k) lo = mid;
    else hi = mid;
  }
  return lo;
}

// One block a query. The workspace (shared memory, or this block's slice of
// scratch) holds, in 4-byte words: each shift's first slot in the peaks and
// its count of kept peaks (S each), every shift's peaks (sum of P_s), the
// columns' pair counts, cursors and distinct counts (c_max + 1 each), the
// pairs in column buckets (3 * sum of P_s); then one first-of-its-value byte
// a pair.
__global__ void __launch_bounds__(kThreads)
union_hashes_kernel(const Shift* __restrict__ sh, int S, int F, int out_len, int c_max,
                    int peak_total, uint8_t* scratch, long long ws_bytes, int* times,
                    int* hashes, long long* n_valid) {
  extern __shared__ __align__(16) uint8_t smem[];
  const int b = blockIdx.x;
  uint8_t* ws = scratch ? scratch + (long long)b * ws_bytes : smem;
  int* s_first = reinterpret_cast<int*>(ws);
  int* s_n = s_first + S;
  uint32_t* pk = reinterpret_cast<uint32_t*>(s_n + S);
  int* col_off = reinterpret_cast<int*>(pk + peak_total);
  int* col_cur = col_off + (c_max + 1);
  int* col_uni = col_cur + (c_max + 1);
  uint32_t* bucket = reinterpret_cast<uint32_t*>(col_uni + (c_max + 1));
  uint8_t* first = reinterpret_cast<uint8_t*>(bucket + kMaxPairs * peak_total);

  for (int c = threadIdx.x; c < 3 * (c_max + 1); c += kThreads) col_off[c] = 0;
  if (threadIdx.x == 0) {
    int acc = 0;
    for (int s = 0; s < S; ++s) {
      s_first[s] = acc;
      acc += sh[s].max_peaks;
    }
  }
  __syncthreads();

  // each shift's peaks, and the count of pairs anchored in each column
  for (int s = 0; s < S; ++s) {
    const Shift shift = sh[s];
    const uint8_t* row = shift.mask + (long long)b * shift.row_stride;
    uint32_t* p = pk + s_first[s];
    const int n = extract_peaks(row, shift.cols * F, F, shift.max_peaks, p);
    if (threadIdx.x == 0) s_n[s] = n;
    __syncthreads();  // the shift's peaks are all in p
    for (int i = threadIdx.x; i < n; i += kThreads) {
      int col;
      unsigned h0 = 0, h1 = 0, h2 = 0;
      const int k = pair_peak(p, i, n, &col, h0, h1, h2);
      if (k) atomicAdd(&col_off[col], k);
    }
  }
  __syncthreads();
  scan_array(col_off, c_max);  // col_off[c_max]: pairs of every shift
  for (int c = threadIdx.x; c < c_max; c += kThreads) col_cur[c] = col_off[c];
  __syncthreads();

  // every shift's pairs into their column's bucket
  for (int s = 0; s < S; ++s) {
    const uint32_t* p = pk + s_first[s];
    const int n = s_n[s];
    for (int i = threadIdx.x; i < n; i += kThreads) {
      int col;
      unsigned h0 = 0, h1 = 0, h2 = 0;
      const int k = pair_peak(p, i, n, &col, h0, h1, h2);
      if (k) {
        const int slot = atomicAdd(&col_cur[col], k);
        bucket[slot] = h0;
        if (k > 1) bucket[slot + 1] = h1;
        if (k > 2) bucket[slot + 2] = h2;
      }
    }
  }
  __syncthreads();

  // the first pair of each value in its bucket, and each column's distinct count
  const int pairs = col_off[c_max];
  for (int k = threadIdx.x; k < pairs; k += kThreads) {
    const int c = column_of(col_off, c_max, k);
    const unsigned v = bucket[k];
    bool is_first = true;
    for (int j = col_off[c]; j < k; ++j) {
      if (bucket[j] == v) {
        is_first = false;
        break;
      }
    }
    first[k] = is_first;
    if (is_first) atomicAdd(&col_uni[c], 1);
  }
  __syncthreads();
  scan_array(col_uni, c_max);  // col_uni[c_max]: distinct pairs

  // each distinct pair to its lane: the pairs of earlier columns, then the
  // distinct values below it in its own column
  const int distinct = col_uni[c_max];
  int* t_out = times + (long long)b * out_len;
  int* h_out = hashes + (long long)b * out_len;
  for (int k = threadIdx.x; k < pairs; k += kThreads) {
    if (!first[k]) continue;
    const int c = column_of(col_off, c_max, k);
    const unsigned v = bucket[k];
    int pos = col_uni[c];
    for (int j = col_off[c], e = col_off[c + 1]; j < e; ++j) pos += first[j] && bucket[j] < v;
    if (pos < out_len) {
      t_out[pos] = c;
      h_out[pos] = (int)v;
    }
  }
  for (int pos = distinct + (int)threadIdx.x; pos < out_len; pos += kThreads) {
    t_out[pos] = 0;
    h_out[pos] = 0;
  }
  if (threadIdx.x == 0) n_valid[b] = distinct;
}

// Bytes of one block's workspace, or -1 for sizes the kernel does not take:
// S >= 1, F a multiple of 16 up to 1024, every C_s <= c_max < 2^22, fewer than
// 2^31 pairs.
long long workspace_bytes(int S, int F, int c_max, int peak_total) {
  if (S < 1 || F < 16 || F > (1 << kBinBits) || F % 16 || c_max < 0 ||
      c_max >= (1 << (32 - kBinBits)) || (long long)c_max * F > 0x7FFFFFFFLL || peak_total < 0 ||
      (long long)peak_total * kMaxPairs >= 0x7FFFFFFFLL)
    return -1;
  const long long words = 2LL * S + peak_total + 3LL * (c_max + 1) + kMaxPairs * (long long)peak_total;
  return (4 * words + kMaxPairs * (long long)peak_total + 15) / 16 * 16;
}

// the table of shifts at the head of the scratch buffer, 16-byte aligned
long long table_bytes(int S) { return ((long long)S * sizeof(Shift) + 15) / 16 * 16; }

// devices on which the kernel may take kSharedLimit bytes of shared memory
bool g_shared_raised[64] = {};

}  // namespace

// Bytes of the device scratch buffer a launch needs (the table of shifts,
// then B workspaces where one does not fit shared memory), or -1 for sizes
// the kernel does not take: S >= 1, F a multiple of 16 up to 1024, c_max (the
// widest shift's columns) < 2^22, peak_total (the sum of the shifts' P_s)
// below 2^31 / 3.
extern "C" long long mfpa_union_hashes_scratch_bytes(int S, int B, int F, int c_max,
                                                     int peak_total) {
  const long long bytes = workspace_bytes(S, F, c_max, peak_total);
  if (bytes < 0 || B < 0) return -1;
  return table_bytes(S) + (bytes <= kSharedLimit ? 0 : B * bytes);
}

// shifts: S Shift rows in host memory (three int64 words a shift): the
// shift's (B, C_s, F) 0/1 bytes on the current device, query b at mask + b *
// row_stride, each query's C_s * F bytes contiguous and 16-byte aligned;
// then C_s | P_s << 32. c_max and peak_total are the largest C_s and the sum
// of the P_s. scratch: mfpa_union_hashes_scratch_bytes bytes of device
// memory. times and hashes: (B, out_len) int32; n_valid: (B,) int64.
extern "C" int mfpa_union_hashes(const void* shifts, int S, int B, int F, int c_max,
                                 int peak_total, int out_len, void* scratch, void* times,
                                 void* hashes, void* n_valid, void* stream) {
  const long long bytes = workspace_bytes(S, F, c_max, peak_total);
  if (bytes < 0 || B < 0 || out_len < 0 || scratch == nullptr) return (int)cudaErrorInvalidValue;
  if (B == 0) return (int)cudaSuccess;
  const cudaStream_t st = (cudaStream_t)stream;
  uint8_t* table = (uint8_t*)scratch;
  // a pageable source: the call returns once the bytes are staged (it may
  // first wait for the stream, whose tier readback follows anyway)
  cudaError_t err = cudaMemcpyAsync(table, shifts, (size_t)S * sizeof(Shift),
                                    cudaMemcpyHostToDevice, st);
  if (err != cudaSuccess) return (int)err;
  const bool in_shared = bytes <= kSharedLimit;
  const size_t smem = in_shared ? (size_t)bytes : 0;
  if (smem > 48 * 1024) {
    int dev = 0;
    err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return (int)err;
    if (dev >= 64 || !g_shared_raised[dev]) {
      err = cudaFuncSetAttribute(union_hashes_kernel,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kSharedLimit);
      if (err != cudaSuccess) return (int)err;
      if (dev < 64) g_shared_raised[dev] = true;
    }
  }
  union_hashes_kernel<<<B, kThreads, smem, st>>>(
      (const Shift*)table, S, F, out_len, c_max, peak_total,
      in_shared ? nullptr : table + table_bytes(S), bytes, (int*)times, (int*)hashes,
      (long long*)n_valid);
  return (int)cudaGetLastError();
}
