// PointNet++'s ball query: for each query, the first nsample support points
// in index order that are valid and lie inside the ball, one launch a call.
//
// Replaces no TPU kernel: the JAX package's ball_query
// (mssvt_tpu/ops/pointnet2.py) is plain jnp, a dense (B, M, N) distance and
// mask under jit. The port's plain version (kernels/ball_query.py
// ball_query_plain) builds the same pairs as tensors: three (B, M, N) f32
// difference planes, their squares and sums, a bool mask, an int32 running
// count and a searchsorted a slot, about 20 launches and ~9.7 GB of traffic
// a call at PointRCNN's first level (2 x 4 096 queries over 16 384 points).
//
// Bound: a full walk is B * M * N pairs of 8 single-rounded f32 operations
// (3 differences, 3 squares, 2 sums) and a compare, ~16 us at 67 TFLOP/s at
// that level; the bytes are the support points and queries read once and
// the slots written once (~0.5 MB in, ~1.6 MB out). So the kernel is bound
// by instruction issue and shared-memory reads, and the design keeps both
// few a pair:
//   - a CTA takes QUERIES_PER_CTA queries of one frame (grid: query blocks,
//     frames), a warp Q of them, their coordinates in registers;
//   - the CTA stages the frame's support points in tiles of up to TILE
//     points in shared memory, one float4 a point (x, y, z, unused), with x
//     set to NaN where the point is invalid or past N, so that no pair
//     with it is a hit (NaN < r2 is false, as the plain version's mask);
//   - a step of a warp reads 32 consecutive points with one 16-byte load a
//     lane and tests them against each of its Q unfinished queries: the
//     ballot of the hits, a popc prefix over the lower lanes and the
//     query's running count place each hit in index order straight into
//     its slot; a query is finished at nsample hits, a warp leaves the
//     tile when its Q queries are, the CTA the walk when all its warps are
//     (a barrier's AND at the end of each tile), else at the end of N;
//   - after the walk each warp fills a query's unfilled slots with slot 0's
//     index (0 where the query found nothing) and writes its empty flag.
//     Every slot is written once.
// The geometry follows the call: the tile is the frame's N rounded up to a
// warp's 32 when N is below TILE, and a frame's query blocks are
// ceil(M / QUERIES_PER_CTA). nsample and N are bounded only by int32.
//
// Rounding: d2 = ((qx-px)*(qx-px) + (qy-py)*(qy-py)) + (qz-pz)*(qz-pz), each
// operation an explicitly rounded intrinsic so that nvcc contracts nothing
// into an FMA, and d2 < r2 with r2 = radius^2 rounded to f32 by the
// wrapper: the plain version's bits, hit for hit.
#include "common.h"

namespace {

constexpr int WARPS = 8;                        // warps a CTA
constexpr int Q = 2;                            // queries a warp
constexpr int QUERIES_PER_CTA = WARPS * Q;
constexpr int THREADS = WARPS * 32;
constexpr int TILE = 1024;                      // support points a tile
constexpr unsigned FULL = 0xffffffffu;

struct Strides {
  long long b, n, c;  // frame, row and coordinate strides, in elements
};

__global__ void __launch_bounds__(THREADS)
ball_query_kernel(const float* __restrict__ xyz, Strides sx,
                  const float* __restrict__ new_xyz, Strides sq,
                  const uint8_t* __restrict__ valid, long long vb,
                  long long vn, int n, int m, int nsample, float r2,
                  int* __restrict__ idx, uint8_t* __restrict__ empty) {
  __shared__ float4 tile[TILE];
  const int b = blockIdx.y;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const unsigned lower = (1u << lane) - 1u;
  const float* px = xyz + b * sx.b;
  const uint8_t* pv = valid ? valid + b * vb : nullptr;

  float qx[Q], qy[Q], qz[Q];
  int cnt[Q], first[Q];
  int* out[Q];
  const int m0 = blockIdx.x * QUERIES_PER_CTA + warp * Q;
#pragma unroll
  for (int q = 0; q < Q; ++q) {
    const int mq = m0 + q;
    first[q] = 0;
    out[q] = idx + ((long long)b * m + mq) * nsample;
    if (mq < m) {
      const float* p = new_xyz + b * sq.b + mq * sq.n;
      qx[q] = p[0];
      qy[q] = p[sq.c];
      qz[q] = p[2 * sq.c];
      cnt[q] = 0;
    } else {  // past M: finished before it starts
      qx[q] = qy[q] = qz[q] = 0.f;
      cnt[q] = nsample;
    }
  }

  for (int base = 0; base < n; base += TILE) {
    const int staged = min(TILE, (n - base + 31) & ~31);
    for (int i = threadIdx.x; i < staged; i += THREADS) {
      const int j = base + i;
      float4 v = make_float4(__int_as_float(0x7fc00000), 0.f, 0.f, 0.f);
      if (j < n && (pv == nullptr || pv[j * vn])) {
        const float* p = px + j * sx.n;
        v = make_float4(p[0], p[sx.c], p[2 * sx.c], 0.f);
      }
      tile[i] = v;
    }
    __syncthreads();
    bool done = true;
#pragma unroll
    for (int q = 0; q < Q; ++q) done = done && cnt[q] >= nsample;
    for (int s = 0; s < staged && !done; s += 32) {
      const float4 p = tile[s + lane];
      const int j = base + s + lane;
      done = true;
#pragma unroll
      for (int q = 0; q < Q; ++q) {
        if (cnt[q] >= nsample) continue;  // warp-uniform
        const float dx = __fsub_rn(qx[q], p.x);
        const float dy = __fsub_rn(qy[q], p.y);
        const float dz = __fsub_rn(qz[q], p.z);
        const float d2 = __fadd_rn(
            __fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)),
            __fmul_rn(dz, dz));
        const bool hit = d2 < r2;
        const unsigned mask = __ballot_sync(FULL, hit);
        if (mask) {
          if (cnt[q] == 0) first[q] = base + s + __ffs(mask) - 1;
          const int pos = cnt[q] + __popc(mask & lower);
          if (hit && pos < nsample) out[q][pos] = j;
          cnt[q] += __popc(mask);
        }
        done = done && cnt[q] >= nsample;
      }
    }
    if (__syncthreads_and(done)) break;
  }

#pragma unroll
  for (int q = 0; q < Q; ++q) {
    const int mq = m0 + q;
    if (mq >= m) continue;
    const int c = min(cnt[q], nsample);
    for (int s = c + lane; s < nsample; s += 32) out[q][s] = first[q];
    if (lane == 0) empty[(long long)b * m + mq] = c == 0;
  }
}

}  // namespace

// xyz (b, n, 3) and new_xyz (b, m, 3) f32 at the given element strides,
// valid (b, n) one byte a point or null; idx (b, m, nsample) int32 and
// empty (b, m) one byte, contiguous.
MSSVT_API int mssvt_ball_query(const void* xyz, long long xb, long long xn,
                               long long xc, const void* new_xyz,
                               long long qb, long long qn, long long qc,
                               const void* valid, long long vb, long long vn,
                               int b, int n, int m, int nsample, float r2,
                               void* idx, void* empty, cudaStream_t stream) {
  if (b < 0 || n < 0 || m < 0 || nsample < 1 || b > 65535)
    return (int)cudaErrorInvalidValue;
  if (b == 0 || m == 0) return 0;
  const int blocks = (m + QUERIES_PER_CTA - 1) / QUERIES_PER_CTA;
  ball_query_kernel<<<dim3(blocks, b), THREADS, 0, stream>>>(
      (const float*)xyz, Strides{xb, xn, xc}, (const float*)new_xyz,
      Strides{qb, qn, qc}, (const uint8_t*)valid, vb, vn, n, m, nsample, r2,
      (int*)idx, (uint8_t*)empty);
  return launch_status();
}
