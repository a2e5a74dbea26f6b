// K1: per-window nearest-first capacity fill.
//
// Replaces the TPU kernel fill_capacity_buffer (mssvt_tpu/ops/pallas_fill.py,
// _fill_kernel -> _fill_kernel_body / _fill_logshift). On the TPU the
// per-row rank came from an MXU dot with a static triangular matrix and the
// compaction from a log-step lane shift. Here a warp owns a window row and
// walks its K table positions in chunks of 32: a lane's exclusive rank is
// the carried hit count plus __popc of the ballot of lower lanes, and hit r
// lands in slot r while r < cap.
//
// Bound: device memory. Every live box row is read once (K = 648 int32 at
// block 0) and every output row written once; the arithmetic is a few
// integer operations an entry. The design keeps device memory to whole rows:
//   - a persistent grid (SMs x CTAs an SM) whose CTAs first copy the static
//     per-position table into shared memory: the source column of each
//     table position, its packed offset, and per chunk of 32 positions one
//     lane mask for each eligibility column;
//   - each warp walks the rows warp, warp + total warps, ...; a live row
//     (below num_valid) comes into a ring of the warp's shared memory with
//     16-byte cp.async (a head and a tail of up to three entries with 4-byte
//     ones, since a row of K % 4 != 0 entries starts anywhere), so the next
//     rows are in flight while the current one is scanned: one at K = 648,
//     seven for rows of at most 189 entries;
//   - the scan's column permutation (box[row][src_of[t]]) reads shared
//     memory; hits go to a shared staging row of cap slots, ranks of the
//     window's own cells to a shared row of cv, eligibility counts come from
//     __popc(ballot & mask) in lanes 0..7;
//   - each output row, padding included, goes out whole with 16-byte stores
//     (scalar ones where cap or cv is no multiple of 4). Dead rows (at or
//     past num_valid) read nothing and write their constant rows the same way.
//
// The TPU kernel's bf16 three-plane row transport (and its 24-bit voxel-row
// limit) is a TPU artefact and is not carried over: rows stay int32.
#include <algorithm>

#include "common.h"

namespace {

constexpr int WARPS = 8;  // warps a CTA, at most
constexpr int SMEM_MAX = 227 * 1024;
constexpr int RING_WORDS = 1536;  // a warp's ring: 8 rows at K <= 189, else 2

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_u32(dst)),
               "l"(src) : "memory");
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(smem_u32(dst)),
               "l"(src) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__host__ __device__ inline int round4(int v) { return (v + 3) & ~3; }

// Shared-memory words: the table (K source columns, K offsets, 8 masks a
// chunk) once a CTA, then per warp its ring of `stages` rows and its
// staging rows.
struct FillLayout {
  int k, cap, cv, chunks, tab, ring_row, per_warp;
  __host__ __device__ FillLayout(int k_, int cap_, int cv_, int stages)
      : k(k_), cap(cap_), cv(cv_), chunks((k_ + 31) / 32),
        tab(round4(2 * k_ + 8 * ((k_ + 31) / 32))), ring_row(round4(k_ + 3)),
        per_warp(stages * round4(k_ + 3) + 2 * round4(cap_) + round4(cv_) + 8) {}
  __host__ __device__ size_t bytes(int warps) const {
    return (size_t)(tab + warps * per_warp) * sizeof(int);
  }
};

// Entry phase of a row in 4-byte words: entry j of the row sits at
// slot + phase + j, so the 16-byte aligned entries land 16-byte aligned.
__device__ __forceinline__ int row_phase(const int* row) {
  return (int)(((uintptr_t)row >> 2) & 3);
}

__device__ __forceinline__ void stage_row(int* slot, const int* row, int k, int lane) {
  const int a = row_phase(row);
  const int head = min((4 - a) & 3, k);
  const int body = (k - head) >> 2;
  int* dst = slot + a;
  if (lane < head) cp_async4(dst + lane, row + lane);
  for (int q = lane; q < body; q += 32)
    cp_async16(dst + head + 4 * q, row + head + 4 * q);
  const int t = head + 4 * body + lane;
  if (t < k) cp_async4(dst + t, row + t);
}

// Copies len words from shared memory (or writes `fill` where src is null),
// 16 bytes a lane where vec.
__device__ __forceinline__ void put_row(int* dst, const int* src, int fill,
                                        int len, bool vec, int lane) {
  if (vec) {
    const int4 f = make_int4(fill, fill, fill, fill);
    for (int q = lane; q < len / 4; q += 32)
      reinterpret_cast<int4*>(dst)[q] = src ? reinterpret_cast<const int4*>(src)[q] : f;
  } else {
    for (int j = lane; j < len; j += 32) dst[j] = src ? src[j] : fill;
  }
}

// STAGES rows a warp's ring: the next STAGES - 1 rows are in flight while
// one is scanned. flags: bit 0, cap % 4 == 0 (16-byte vox/off rows); bit 1,
// cv % 4 == 0.
template <int STAGES>
__global__ void fill_kernel(
    const int* __restrict__ box, int nw, int k, int cap,
    const int* __restrict__ tab, int ne, int s0, int cv,
    const int* __restrict__ num_valid, int* __restrict__ vox,
    int* __restrict__ off, int* __restrict__ rank_own, int* __restrict__ cnt,
    int flags) {
  extern __shared__ __align__(16) int smem[];
  const FillLayout L(k, cap, cv, STAGES);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int warps = blockDim.x >> 5;
  int* s_src = smem;
  int* s_offs = smem + k;
  const uint32_t* s_emask = reinterpret_cast<const uint32_t*>(smem + 2 * k);
  for (int i = threadIdx.x; i < 2 * k + 8 * L.chunks; i += blockDim.x) smem[i] = __ldg(tab + i);
  __syncthreads();

  int* ring = smem + L.tab + warp * L.per_warp;
  int* svox = ring + STAGES * L.ring_row;
  int* soff = svox + round4(cap);
  int* srank = soff + round4(cap);
  int* scnt = srank + round4(cv);
  const bool vec_cap = flags & 1, vec_cv = flags & 2;
  const int nv = num_valid == nullptr ? nw : min(max(__ldg(num_valid), 0), nw);
  const int stride = gridDim.x * warps;
  const unsigned lt = (1u << lane) - 1u;

  int r = blockIdx.x * warps + warp;
  for (int s = 0; s < STAGES - 1; ++s) {
    const int rs = r + s * stride;
    if (rs < nv) stage_row(ring + s * L.ring_row, box + (size_t)rs * k, k, lane);
    cp_async_commit();
  }
  for (int j = 0; r < nw; ++j, r += stride) {
    const int nxt = r + (STAGES - 1) * stride;  // into the slot scanned last
    if (nxt < nv)
      stage_row(ring + ((j + STAGES - 1) % STAGES) * L.ring_row, box + (size_t)nxt * k, k, lane);
    cp_async_commit();
    int* vrow = vox + (size_t)r * cap;
    int* orow = off + (size_t)r * cap;
    if (r >= nv) {
      put_row(vrow, nullptr, -1, cap, vec_cap, lane);
      put_row(orow, nullptr, PACK5_ZERO, cap, vec_cap, lane);
      if (rank_own != nullptr) {
        put_row(rank_own + (size_t)r * cv, nullptr, 0, cv, vec_cv, lane);
        put_row(cnt + (size_t)r * 8, nullptr, 0, 8, true, lane);
      }
      continue;  // no row was staged into this iteration's slot
    }
    cp_async_wait<STAGES - 1>();  // this row's copies: all but the newest groups
    __syncwarp();
    const int* srow = ring + (j % STAGES) * L.ring_row + row_phase(box + (size_t)r * k);
    int carry = 0, ecount = 0;
    for (int c = 0; c < L.chunks; ++c) {
      const int t = c * 32 + lane;
      int val = -1, src = -1;
      if (t < k) {
        src = s_src[t];
        val = srow[src];
      }
      const bool occ = val >= 0;
      const unsigned ballot = __ballot_sync(0xffffffffu, occ);
      const int rank = carry + __popc(ballot & lt);
      if (occ && rank < cap) {
        svox[rank] = val;
        soff[rank] = s_offs[t];
      }
      if ((unsigned)(src - s0) < (unsigned)cv) srank[src - s0] = rank;
      if (lane < ne) ecount += __popc(ballot & s_emask[c * 8 + lane]);
      carry += __popc(ballot);
    }
    for (int s = min(carry, cap) + lane; s < cap; s += 32) {
      svox[s] = -1;
      soff[s] = PACK5_ZERO;
    }
    if (lane < 8) scnt[lane] = ecount;  // 0 past the eligibility columns
    __syncwarp();
    put_row(vrow, svox, 0, cap, vec_cap, lane);
    put_row(orow, soff, 0, cap, vec_cap, lane);
    if (rank_own != nullptr) {
      put_row(rank_own + (size_t)r * cv, srank, 0, cv, vec_cv, lane);
      put_row(cnt + (size_t)r * 8, scnt, 0, 8, true, lane);
    }
    __syncwarp();  // the ring slot and staging rows are free again
  }
  cp_async_wait<0>();
}

int sm_count() {
  static int n = 0;
  if (n == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
  }
  return n;
}

using FillKernel = decltype(&fill_kernel<2>);

// The launch shape for a table of K entries a row: ring depth (8 rows where
// 8 fit in RING_WORDS: short rows need more of them in flight; else 2),
// warps a CTA (8, fewer where the shared memory would not fit) and CTAs an
// SM (occupancy API).
struct FillPlan {
  FillKernel kernel;
  int warps, per_sm;
  size_t smem;
};

// Plans are kept per (K, cap, cv): a model has a few fixed tables, and the
// occupancy query would otherwise cost host time at every launch.
int plan_fill(int k, int cap, int cv, FillPlan& p) {
  struct Entry { int k, cap, cv; FillPlan p; };
  static Entry cache[16];
  static int cached = 0;
  static size_t smem_set[2] = {0, 0};  // dynamic shared memory allowed: 2, 8 rows
  if (k < 0 || cap < 0 || cv < 0) return (int)cudaErrorInvalidValue;
  for (int i = 0; i < cached; ++i) {
    if (cache[i].k == k && cache[i].cap == cap && cache[i].cv == cv) {
      p = cache[i].p;
      return 0;
    }
  }
  const int deep = round4(k + 3) * 8 <= RING_WORDS;
  const int stages = deep ? 8 : 2;
  p.kernel = deep ? fill_kernel<8> : fill_kernel<2>;
  const FillLayout L(k, cap, cv, stages);
  p.warps = WARPS;
  while (p.warps > 1 && L.bytes(p.warps) > (size_t)SMEM_MAX) --p.warps;
  p.smem = L.bytes(p.warps);
  if (p.smem > (size_t)SMEM_MAX) return (int)cudaErrorInvalidValue;
  if (p.smem > smem_set[deep]) {
    const cudaError_t err = cudaFuncSetAttribute(
        p.kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)p.smem);
    if (err != cudaSuccess) return (int)err;
    smem_set[deep] = p.smem;
  }
  const cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &p.per_sm, p.kernel, p.warps * 32, p.smem);
  if (err != cudaSuccess) return (int)err;
  if (cached < 16) cache[cached++] = Entry{k, cap, cv, p};
  return 0;
}

}  // namespace

// tab: K source columns (table position -> column of box), K packed offsets,
// then for each chunk of 32 positions 8 lane masks (bit l of mask e: position
// chunk * 32 + l is eligible for buffer e; e < ne). rank_own and cnt are both
// given (own slab [s0, s0 + cv)) or both null (cv = 0).
MSSVT_API int mssvt_fill(const int* box, int nw, int k, int cap,
                         const int* tab, int ne, int s0, int cv,
                         const int* num_valid, int* vox, int* off,
                         int* rank_own, int* cnt, cudaStream_t stream) {
  if (ne < 0 || ne > 8) return (int)cudaErrorInvalidValue;
  if (nw <= 0) return 0;
  FillPlan p;
  const int err = plan_fill(k, cap, cv, p);
  if (err != 0) return err;
  const long long want = ((long long)nw + p.warps - 1) / p.warps;
  const int blocks = (int)std::min<long long>(want, (long long)sm_count() * std::max(p.per_sm, 1));
  const int flags = (cap % 4 == 0 ? 1 : 0) | (cv % 4 == 0 ? 2 : 0);
  p.kernel<<<blocks, p.warps * 32, p.smem, stream>>>(
      box, nw, k, cap, tab, ne, s0, cv, num_valid, vox, off, rank_own, cnt, flags);
  return launch_status();
}

// out: shared-memory bytes of a CTA, CTAs an SM, registers a thread, warps a
// CTA, for a table of K entries a row.
MSSVT_API int mssvt_fill_plan(int k, int cap, int cv, int* out) {
  FillPlan p;
  const int err = plan_fill(k, cap, cv, p);
  if (err != 0) return err;
  cudaFuncAttributes attr;
  const cudaError_t e = cudaFuncGetAttributes(&attr, p.kernel);
  if (e != cudaSuccess) return (int)e;
  out[0] = (int)p.smem;
  out[1] = p.per_sm;
  out[2] = attr.numRegs;
  out[3] = p.warps;
  return 0;
}
