// Greedy NMS scan: one CTA a sample, one launch a call.
//
// Replaces no TPU kernel: the JAX package runs the scan as a loop inside
// jit (mssvt_tpu/ops/nms.py); the port's plain version
// (kernels/nms.py greedy_plain) is a host loop of K iterations of five
// small launches each, which left the card idle for the whole post-
// processing. The suppression matrix (B, K, K) bool stays where
// ops/nms.py computes it (centre distance, or the rotated IoU on the CPU),
// or arrives packed (the rotated IoU on the card, csrc/nms_iou.cu); this
// kernel only walks it in score order, with the same result bit for bit: a
// candidate is kept when it is valid and no kept candidate before it
// suppresses it; only over[i][j] with j > i counts.
//
// Bound: the upper triangle of `over` read once (K^2 / 2 bytes a sample,
// ~0.1 us at K = 500 over 3.35 TB/s), against K serial steps. Design, in
// the mask layout of the reference's iou3d_nms_kernel.cu:
//   1. every warp packs rows: bit j of row i's word j / 64 is over[i][j]
//      for j > i; a warp loads 16 rows before it packs them, so that many
//      loads are in flight (4 bytes a lane where K % 4 == 0, else one);
//      words left of the diagonal are neither written nor read. The rows
//      stay in shared memory while ((K + 4) * ceil(K / 64) + 1) * 8 bytes
//      fit, else they go to a global scratch buffer the wrapper allocates
//      (K > 1 344). The packed entry (mssvt_nms_greedy_packed) takes rows
//      already packed so (csrc/nms_iou.cu writes them): it copies their
//      upper words to shared memory where they fit, else scans them in
//      place;
//   2. one warp scans 64 candidates a step: the step's diagonal words are
//      fetched a step ahead (two a lane) and broadcast by shuffles, so the
//      serial chain of a candidate is a few 32-bit register operations on
//      the step's suppression word; the step's kept rows are then ORed
//      into the later words (a lane a word, predicated independent loads).
//      The scan stops once post_max are kept: no later slot is written.
//   3. the whole CTA writes the kept candidates' `order` to their running
//      slots (a count a word, kept by the scan) and -1 after them.
#include "common.h"

namespace {

constexpr int NMS_THREADS = 512;
constexpr int NMS_WARPS = NMS_THREADS / 32;
constexpr int PACK_BATCH = 16;  // rows a warp loads before it packs them
constexpr size_t SMEM_MAX = 227 * 1024;
constexpr unsigned FULL = 0xffffffffu;

typedef unsigned long long u64;

// The bits of row i's word w that the scan may read: j > i and j < k.
__device__ __forceinline__ u64 upper_mask(int i, int w, int k) {
  u64 m = ~0ull;
  const int from = i + 1 - w * 64;
  if (from > 0) m = from >= 64 ? 0 : m << from;
  const int to = k - w * 64;
  if (to < 64) m &= ~0ull >> (64 - to);
  return m;
}

// Step 1, WIDE (K % 4 == 0 and `over` 4-byte aligned): a lane loads 4
// bytes of a 128-byte chunk (words 2m and 2m + 1), makes them 4 bits,
// and 8 lanes OR their nibbles into 32 bits. Else two byte loads a lane
// and two ballots a word. Either way a warp takes every NMS_WARPS-th row
// of a chunk or word and loads PACK_BATCH rows before it packs them.
template <bool WIDE>
__device__ __forceinline__ void pack_rows(const uint8_t* __restrict__ ob,
                                          int k, int words, u64* rows,
                                          int lane, int warp) {
  if (WIDE) {
    for (int m = 0; m < (words + 1) / 2; ++m) {
      const int jb = m * 128 + 4 * lane;
      const int rows_end = min(k, (m + 1) * 128);  // rows i, i / 64 <= 2m + 1
      for (int i0 = warp; i0 < rows_end; i0 += NMS_WARPS * PACK_BATCH) {
        unsigned x[PACK_BATCH];
#pragma unroll
        for (int u = 0; u < PACK_BATCH; ++u) {
          const int i = i0 + u * NMS_WARPS;
          x[u] = i < rows_end && jb < k
                     ? *(const unsigned*)(ob + (size_t)i * k + jb) : 0u;
        }
#pragma unroll
        for (int u = 0; u < PACK_BATCH; ++u) {
          const int i = i0 + u * NMS_WARPS;
          if (i >= rows_end) break;  // the same i on every lane
          unsigned v = __vcmpne4(x[u], 0u) & 0x01010101u;
          v = (v | v >> 7 | v >> 14 | v >> 21) & 0xFu;
          v <<= 4 * (lane & 7);
          v |= __shfl_xor_sync(FULL, v, 1);
          v |= __shfl_xor_sync(FULL, v, 2);
          v |= __shfl_xor_sync(FULL, v, 4);
          const unsigned up = __shfl_down_sync(FULL, v, 8);
          const int w = 2 * m + (lane >> 4);
          if ((lane & 15) == 0 && w < words && w >= i / 64)
            rows[(size_t)i * words + w] =
                (((u64)up << 32) | v) & upper_mask(i, w, k);
        }
      }
    }
  } else {
    for (int w = 0; w < words; ++w) {
      const int j0 = w * 64 + lane, j1 = j0 + 32;
      const int rows_end = min(k, (w + 1) * 64);  // rows i, i / 64 <= w
      for (int i0 = warp; i0 < rows_end; i0 += NMS_WARPS * PACK_BATCH) {
        bool a[PACK_BATCH], c[PACK_BATCH];
#pragma unroll
        for (int u = 0; u < PACK_BATCH; ++u) {
          const uint8_t* row = ob + (size_t)(i0 + u * NMS_WARPS) * k;
          const bool in = i0 + u * NMS_WARPS < rows_end;
          a[u] = in && j0 < k && row[j0];
          c[u] = in && j1 < k && row[j1];
        }
#pragma unroll
        for (int u = 0; u < PACK_BATCH; ++u) {
          const int i = i0 + u * NMS_WARPS;
          if (i >= rows_end) break;  // the same i on every lane
          const unsigned lo = __ballot_sync(FULL, a[u]);
          const unsigned hi = __ballot_sync(FULL, c[u]);
          if (lane == 0)
            rows[(size_t)i * words + w] =
                (((u64)hi << 32) | lo) & upper_mask(i, w, k);
        }
      }
    }
  }
}

// Where the rows come from: the bool matrix packed by pack_rows<WIDE>,
// or rows packed already (csrc/nms_iou.cu), copied to shared memory or
// scanned in place in device memory.
enum Source { SRC_BYTES, SRC_WIDE, SRC_PACKED_COPY, SRC_PACKED_IN_PLACE };

template <Source SRC>
__global__ void __launch_bounds__(NMS_THREADS)
nms_greedy_kernel(const uint8_t* __restrict__ over,
                  const u64* __restrict__ packed,
                  const uint8_t* __restrict__ valid,
                  const int64_t* __restrict__ order, int k, int post_max,
                  u64* __restrict__ scratch, int* __restrict__ sel,
                  int* __restrict__ num) {
  extern __shared__ u64 smem[];
  const int b = blockIdx.x;
  const int words = (k + 63) / 64;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  u64* sup = smem;                  // suppressed candidates
  u64* vbits = smem + words;        // valid candidates
  u64* keepw = smem + 2 * words;    // kept candidates
  int* base = (int*)(smem + 3 * words);  // kept before each word
  int* s_kept = (int*)(smem + 4 * words);  // kept in all
  u64* own = scratch ? scratch + (size_t)b * k * words : smem + 4 * words + 1;
  const u64* in =
      SRC >= SRC_PACKED_COPY ? packed + (size_t)b * k * words : nullptr;
  const u64* rows = SRC == SRC_PACKED_IN_PLACE ? in : own;
  const uint8_t* vb = valid + (size_t)b * k;

  // 1. pack the validity and the rows' strict upper triangles
  for (int w = threadIdx.x; w < words; w += NMS_THREADS) sup[w] = keepw[w] = 0;
  for (int w = warp; w < words; w += NMS_WARPS) {
    const int j0 = w * 64 + lane, j1 = j0 + 32;
    const unsigned lo = __ballot_sync(FULL, j0 < k && vb[j0]);
    const unsigned hi = __ballot_sync(FULL, j1 < k && vb[j1]);
    if (lane == 0) vbits[w] = ((u64)hi << 32) | lo;
  }
  if (SRC == SRC_BYTES || SRC == SRC_WIDE) {
    pack_rows<(SRC == SRC_WIDE)>(over + (size_t)b * k * k, k, words, own,
                                 lane, warp);
  } else if (SRC == SRC_PACKED_COPY) {
    // the words at or right of each row's diagonal word, coalesced
    for (int x = threadIdx.x; x < k * words; x += NMS_THREADS)
      if (x % words >= x / words / 64) own[x] = in[x];
  }
  __syncthreads();

  // 2. the ordered scan, 64 candidates a step, by warp 0; the next step's
  // diagonal words are fetched while this one runs
  if (warp == 0) {
    int kept = 0;
    u64 d0n = lane < k ? rows[(size_t)lane * words] : 0;
    u64 d1n = lane + 32 < k ? rows[(size_t)(lane + 32) * words] : 0;
    for (int c = 0; c < words && kept < post_max; ++c) {
      const u64 d0 = d0n, d1 = d1n;
      const int r0 = (c + 1) * 64 + lane, r1 = r0 + 32;
      d0n = r0 < k ? rows[(size_t)r0 * words + c + 1] : 0;
      d1n = r1 < k ? rows[(size_t)r1 * words + c + 1] : 0;
      // rows 0-31 of the step test the low half and suppress in both;
      // rows 32-63 test and suppress in the high half alone (their
      // diagonal words hold only bits above them). m is all ones where a
      // candidate is kept: the chain is a few 32-bit operations a
      // candidate, no branch. Bits of vbits past k are zero: those rows
      // are never kept.
      unsigned clo = (unsigned)sup[c], chi = (unsigned)(sup[c] >> 32);
      const unsigned vlo = (unsigned)vbits[c];
      const unsigned vhi = (unsigned)(vbits[c] >> 32);
      unsigned klo = 0, khi = 0;
#pragma unroll
      for (int r = 0; r < 32; ++r) {
        const unsigned dlo = __shfl_sync(FULL, (unsigned)d0, r);
        const unsigned dhi = __shfl_sync(FULL, (unsigned)(d0 >> 32), r);
        const unsigned m = 0u - ((vlo & ~clo) >> r & 1u);
        clo |= dlo & m;
        chi |= dhi & m;
        klo |= m & (1u << r);
      }
#pragma unroll
      for (int r = 0; r < 32; ++r) {
        const unsigned dhi = __shfl_sync(FULL, (unsigned)(d1 >> 32), r);
        const unsigned m = 0u - ((vhi & ~chi) >> r & 1u);
        chi |= dhi & m;
        khi |= m & (1u << r);
      }
      const u64 keep = ((u64)khi << 32) | klo;
      if (lane == 0) {
        keepw[c] = keep;
        base[c] = kept;
      }
      kept += __popcll(keep);
      // the kept rows suppress in the later words (each lane owns its words)
      for (int w = c + 1 + lane; w < words; w += 32) {
        u64 acc = sup[w];
        const u64* col = rows + (size_t)c * 64 * words + w;
#pragma unroll 16
        for (int r = 0; r < 64; ++r)
          if (keep >> r & 1) acc |= col[(size_t)r * words];
        sup[w] = acc;
      }
      __syncwarp();
    }
    if (lane == 0) *s_kept = kept;
  }
  __syncthreads();

  // 3. the kept candidates' order to their running slots, -1 after
  const int n = min(*s_kept, post_max);
  int* out = sel + (size_t)b * post_max;
  for (int i = threadIdx.x; i < k; i += NMS_THREADS) {
    const u64 kw = keepw[i >> 6];
    const int bit = i & 63;
    if (kw >> bit & 1) {
      const int slot = base[i >> 6] + __popcll(kw & ((1ull << bit) - 1));
      if (slot < post_max) out[slot] = (int)order[(size_t)b * k + i];
    }
  }
  for (int s = n + threadIdx.x; s < post_max; s += NMS_THREADS) out[s] = -1;
  if (threadIdx.x == 0) num[b] = n;
}

template <Source SRC>
int launch(const void* over, const void* packed, const void* valid,
           const void* order, int b, int k, int post_max, void* scratch,
           void* sel, void* num, size_t smem, cudaStream_t stream) {
  // the kernel has no static shared memory, so all of SMEM_MAX may be
  // dynamic
  static size_t smem_set = 48 * 1024;
  if (smem > smem_set) {
    const cudaError_t err = cudaFuncSetAttribute(
        nms_greedy_kernel<SRC>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
    smem_set = smem;
  }
  nms_greedy_kernel<SRC><<<b, NMS_THREADS, smem, stream>>>(
      (const uint8_t*)over, (const u64*)packed, (const uint8_t*)valid,
      (const int64_t*)order, k, post_max, (u64*)scratch, (int*)sel,
      (int*)num);
  return launch_status();
}

}  // namespace

// over (B, K, K) bool, valid (B, K) bool, order (B, K) int64, all
// contiguous; sel (B, post_max) int32, num (B,) int32. scratch: null when
// ((K + 4) * ceil(K / 64) + 1) * 8 bytes fit in shared memory, else B * K
// * ceil(K / 64) 8-byte words of device memory.
MSSVT_API int mssvt_nms_greedy(const void* over, const void* valid,
                               const void* order, int b, int k, int post_max,
                               void* scratch, void* sel, void* num,
                               cudaStream_t stream) {
  if (k < 0 || post_max < 0) return (int)cudaErrorInvalidValue;
  if (b <= 0) return 0;
  const size_t words = (size_t)(k + 63) / 64;
  const size_t smem = ((scratch ? 4 : k + 4) * words + 1) * sizeof(u64);
  if (smem > SMEM_MAX) return (int)cudaErrorInvalidValue;
  if (k % 4 == 0 && (uintptr_t)over % 4 == 0)
    return launch<SRC_WIDE>(over, nullptr, valid, order, b, k, post_max,
                            scratch, sel, num, smem, stream);
  return launch<SRC_BYTES>(over, nullptr, valid, order, b, k, post_max,
                           scratch, sel, num, smem, stream);
}

// rows (B, K, ceil(K / 64)) 8-byte words as mssvt_nms_iou_mask writes them
// (bit j of row i's word j / 64 for j > i; words left of the diagonal are
// not read); valid, order, sel, num as above. The rows are copied to shared
// memory where ((K + 4) * ceil(K / 64) + 1) * 8 bytes fit, else read in
// place.
MSSVT_API int mssvt_nms_greedy_packed(const void* rows, const void* valid,
                                      const void* order, int b, int k,
                                      int post_max, void* sel, void* num,
                                      cudaStream_t stream) {
  if (k < 0 || post_max < 0) return (int)cudaErrorInvalidValue;
  if (b <= 0) return 0;
  const size_t words = (size_t)(k + 63) / 64;
  const size_t shared = ((k + 4) * words + 1) * sizeof(u64);
  if (shared <= SMEM_MAX)
    return launch<SRC_PACKED_COPY>(nullptr, rows, valid, order, b, k,
                                   post_max, nullptr, sel, num, shared,
                                   stream);
  return launch<SRC_PACKED_IN_PLACE>(nullptr, rows, valid, order, b, k,
                                     post_max, nullptr, sel, num,
                                     (4 * words + 1) * sizeof(u64), stream);
}
