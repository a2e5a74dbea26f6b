// K1: per-window nearest-first capacity fill.
//
// Replaces the TPU kernel fill_capacity_buffer (mssvt_tpu/ops/pallas_fill.py,
// _fill_kernel -> _fill_kernel_body / _fill_logshift). On the TPU the
// per-row rank came from an MXU dot with a static triangular matrix and the
// compaction from a log-step lane shift; here one warp owns one window row
// and walks its K table positions in chunks of 32: a lane's exclusive rank
// is the carried hit count plus __popc of the ballot of lower lanes, and
// hit r is stored straight to slot r while r < cap.
//
// Bound: device memory. Every box entry is read once (K = 648 int32 per
// row at block 0) and every output written once; the arithmetic is a few
// integer ops per entry. The column permutation (source layout -> table
// order) is a per-position index into the row, so a warp's 32 loads fall
// within one 2.6 KB row and are served by L1/L2 sectors rather than being
// coalesced; the design accepts that for simplicity.
//
// The TPU kernel's bf16 three-plane row transport (and its 24-bit voxel-row
// limit) is a TPU artefact and is not carried over: rows stay int32.
#include "common.h"

namespace {

constexpr int WARPS = 8;

__global__ void fill_kernel(const int* __restrict__ box, int nw, int k,
                            int cap, const int* __restrict__ src_of,
                            const int* __restrict__ offs_t,
                            const int* __restrict__ elig_bits, int s0, int cv,
                            const int* __restrict__ num_valid,
                            int* __restrict__ vox, int* __restrict__ off,
                            int* __restrict__ rank_own, int* __restrict__ cnt) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * WARPS + (threadIdx.x >> 5);
  if (row >= nw) return;
  const bool live = num_valid == nullptr || row < __ldg(num_valid);
  int* vrow = vox + (size_t)row * cap;
  int* orow = off + (size_t)row * cap;
  int filled = 0;
  if (live) {
    const int* brow = box + (size_t)row * k;
    const unsigned lt = (1u << lane) - 1u;
    int carry = 0;
    int c[8] = {0, 0, 0, 0, 0, 0, 0, 0};  // per-lane eligibility counts
    for (int base = 0; base < k; base += 32) {
      const int t = base + lane;
      int val = -1, src = -1;
      if (t < k) {
        src = src_of ? __ldg(src_of + t) : t;
        val = __ldg(brow + src);
      }
      const bool occ = val >= 0;
      const unsigned ballot = __ballot_sync(0xffffffffu, occ);
      const int rank = carry + __popc(ballot & lt);
      if (occ && rank < cap) {
        vrow[rank] = val;
        orow[rank] = __ldg(offs_t + t);
      }
      if (rank_own != nullptr && src >= s0 && src < s0 + cv)
        rank_own[(size_t)row * cv + (src - s0)] = rank;
      if (occ && elig_bits != nullptr) {
        const int bits = __ldg(elig_bits + t);
#pragma unroll
        for (int e = 0; e < 8; ++e) c[e] += (bits >> e) & 1;
      }
      carry += __popc(ballot);
    }
    filled = carry < cap ? carry : cap;
    if (cnt != nullptr) {
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        int v = c[e];
        for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
        if (lane == e) cnt[(size_t)row * 8 + e] = v;
      }
    }
  } else {
    if (rank_own != nullptr)
      for (int j = lane; j < cv; j += 32) rank_own[(size_t)row * cv + j] = 0;
    if (cnt != nullptr && lane < 8) cnt[(size_t)row * 8 + lane] = 0;
  }
  for (int j = filled + lane; j < cap; j += 32) {
    vrow[j] = -1;
    orow[j] = PACK5_ZERO;
  }
}

}  // namespace

MSSVT_API int mssvt_fill(const int* box, int nw, int k, int cap,
                         const int* src_of, const int* offs_t,
                         const int* elig_bits, int s0, int cv,
                         const int* num_valid, int* vox, int* off,
                         int* rank_own, int* cnt, cudaStream_t stream) {
  if (nw <= 0) return 0;
  const int blocks = (nw + WARPS - 1) / WARPS;
  fill_kernel<<<blocks, WARPS * 32, 0, stream>>>(
      box, nw, k, cap, src_of, offs_t, elig_bits, s0, cv, num_valid, vox, off,
      rank_own, cnt);
  return launch_status();
}
