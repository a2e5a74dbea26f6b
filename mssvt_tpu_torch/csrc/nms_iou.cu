// Rotated-IoU suppression mask of the greedy NMS, written as the scan's
// packed rows: one launch a call.
//
// Replaces no TPU kernel: the JAX package computes the candidates' IoU
// inside jit (mssvt_tpu/ops/nms.py, box_ops.pairwise_iou_bev). The port's
// plain version (ops/nms.py _overlaps: pairwise_iou_bev in row blocks,
// then > thresh) is ~350 elementwise launches a row block over (B, rows, K,
// 4, 2) temporaries and a (B, K, K) bool matrix that the scan
// (csrc/nms.cu) then packs again. Here bit j of row i's word j / 64 is
// IoU(box i, box j) > thresh for j > i, in the layout of the reference's
// iou3d_nms_kernel.cu; mssvt_nms_greedy_packed scans it as it stands.
//
// Bound: ~470 f32 operations a pair past the early-out (two clipping
// passes of 16 edge-half-plane tests, IEEE divisions among them) against
// boxes in and K^2 / 2 bits out (~8 MiB at 4 x 4 096): operations. Design:
//   - a CTA takes a (row tile, column tile) of 64 x 64 candidates of one
//     sample, column tile >= row tile only; it stages its 64 row and 64
//     column boxes in shared memory once, already as corners, edge
//     vectors, area and an early-out reach; a thread tests one row box
//     against the columns and lists the pairs past the early-out, then the
//     CTA's threads share the list (a warp whose 32 rows test one column
//     at a time runs the full IoU whenever one row is near: on an H100 at
//     B 4, K 4 096 with 2.6% of the pairs near, 1.10 ms a call against
//     0.108 ms with the list); each row's 64 bits are one word (words
//     left of the diagonal are neither written nor read);
//   - early-out: where the centres lie further apart than the two
//     circumradii plus a slack of 1e-4 of the coordinates' scale (1e-4
//     at the origin), every clipped edge is empty in the plain algorithm
//     too, so its IoU is exactly 0 and the bit (0 > thresh, thresh >= 0)
//     is 0. Rounding moves a computed corner or half-plane by ~1e-7 of
//     that scale and EPS by at most 1e-6 m (sides of >= MIN_SIDE), both
//     far inside the slack. Boxes narrower than MIN_SIDE (against a
//     zero-size column box a box's IoU is far above 1, however far),
//     non-finite or negative sizes never take it (kernels/nms_iou.far_apart is the same
//     test in PyTorch);
//   - otherwise the plain algorithm step for step (box_ops.py): corners,
//     each edge clipped to the other quad's four half-planes as a
//     parameter interval, the closed A pass and the open B pass with the
//     same EPS rules, the shoelace sum of each pass in the order torch's
//     reduction of four takes, the union clamp at 1e-6, IoU > thresh. Every
//     operation is an explicitly rounded intrinsic, so nvcc contracts
//     nothing into an FMA the plain version does not have.
#include "common.h"

namespace {

constexpr int TILE = 64;
constexpr float EPS = 1e-8f;          // box_ops.EPS
constexpr float MIN_SIDE = 1e-2f;     // narrower boxes: no early-out
constexpr float SLACK = 1e-4f;        // early-out slack over the scale
constexpr float UNION_MIN = 1e-6f;    // pairwise_iou_bev's union clamp

typedef unsigned long long u64;

__device__ __forceinline__ float fadd(float a, float b) {
  return __fadd_rn(a, b);
}
__device__ __forceinline__ float fsub(float a, float b) {
  return __fsub_rn(a, b);
}
__device__ __forceinline__ float fmul(float a, float b) {
  return __fmul_rn(a, b);
}

// torch.maximum / torch.minimum / clamp: a NaN operand gives NaN
__device__ __forceinline__ float tmax(float a, float b) {
  return (a > b || isnan(a)) ? a : b;
}
__device__ __forceinline__ float tmin(float a, float b) {
  return (a < b || isnan(a)) ? a : b;
}
__device__ __forceinline__ float clamp01(float t) {
  return isnan(t) ? t : fminf(fmaxf(t, 0.f), 1.f);
}

// What every pair needs of one box: box_ops.boxes_to_corners_bev's ccw
// corners, the edges c[k + 1] - c[k], dx * dy and the early-out reach
// (+inf where the box may not take the early-out, NaN where not finite).
struct Box {
  float cx[4], cy[4], ex[4], ey[4];
  float area, x, y, reach;
};

__device__ __forceinline__ void load_box(const float* __restrict__ p,
                                         Box& q) {
  const float x = p[0], y = p[1], dx = p[3], dy = p[4], h = p[6];
  const float c = cosf(h), s = sinf(h);
  const float hx = __fdiv_rn(dx, 2.f), hy = __fdiv_rn(dy, 2.f);
  const float lx[4] = {hx, -hx, -hx, hx}, ly[4] = {hy, hy, -hy, -hy};
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    q.cx[k] = fadd(fsub(fmul(lx[k], c), fmul(ly[k], s)), x);
    q.cy[k] = fadd(fadd(fmul(lx[k], s), fmul(ly[k], c)), y);
  }
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    q.ex[k] = fsub(q.cx[(k + 1) & 3], q.cx[k]);
    q.ey[k] = fsub(q.cy[(k + 1) & 3], q.cy[k]);
  }
  q.area = fmul(dx, dy);
  q.x = x;
  q.y = y;
  const float r = fmul(0.5f, sqrtf(fadd(fmul(dx, dx), fmul(dy, dy))));
  const float scale = fadd(fadd(fadd(0.5f, fabsf(x)), fabsf(y)), r);
  const float reach = fadd(r, fmul(SLACK, scale));
  q.reach = (dx >= MIN_SIDE && dy >= MIN_SIDE) ? reach : INFINITY;
}

// box_ops._clipped_edge_cross_sum: the quad (p, d) clipped to the
// half-planes of (h, e); B_PASS is the open pass (bound EPS, collinear
// anti-parallel edges kept).
template <bool B_PASS>
__device__ __forceinline__ float clipped_sum(const float* px, const float* py,
                                             const float* dx, const float* dy,
                                             const float* hx, const float* hy,
                                             const float* hex,
                                             const float* hey) {
  const float bound = B_PASS ? EPS : -EPS;
  float cr[4];
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    float t0 = 0.f, t1 = 1.f;
    bool dead = false;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const float relx = fsub(px[e], hx[k]), rely = fsub(py[e], hy[k]);
      const float num = fsub(fmul(hex[k], rely), fmul(hey[k], relx));
      const float den = fsub(fmul(hex[k], dy[e]), fmul(hey[k], dx[e]));
      const float aden = fabsf(den);
      const float safe = aden < EPS ? (den >= 0.f ? EPS : -EPS) : den;
      const float tc = __fdiv_rn(fsub(bound, num), safe);
      t0 = tmax(t0, den > EPS ? tc : 0.f);
      t1 = tmin(t1, den < -EPS ? tc : 1.f);
      bool kill = aden <= EPS && num < bound;
      if (B_PASS) {
        const bool collinear = aden <= EPS && fabsf(num) <= EPS;
        const bool anti =
            fadd(fmul(dx[e], hex[k]), fmul(dy[e], hey[k])) < 0.f;
        kill = kill && !(collinear && anti);
      }
      dead = dead || kill;
    }
    t0 = clamp01(t0);
    t1 = clamp01(t1);
    const float p1x = fadd(px[e], fmul(t0, dx[e]));
    const float p1y = fadd(py[e], fmul(t0, dy[e]));
    const float p2x = fadd(px[e], fmul(t1, dx[e]));
    const float p2y = fadd(py[e], fmul(t1, dy[e]));
    const float c = fsub(fmul(p1x, p2y), fmul(p1y, p2x));
    cr[e] = (!dead && t1 > t0) ? c : 0.f;
  }
  // torch's sum over a contiguous last dim of 4 on the card: 0 + 2 and
  // 1 + 3 first
  return fadd(fadd(cr[0], cr[2]), fadd(cr[1], cr[3]));
}

// The boxes of a tile in shared memory, one array a field.
struct Tile {
  float cx[4][TILE], cy[4][TILE], ex[4][TILE], ey[4][TILE];
  float area[TILE], x[TILE], y[TILE], reach[TILE];

  __device__ __forceinline__ void put(int t, const Box& q) {
#pragma unroll
    for (int m = 0; m < 4; ++m) {
      cx[m][t] = q.cx[m];
      cy[m][t] = q.cy[m];
      ex[m][t] = q.ex[m];
      ey[m][t] = q.ey[m];
    }
    area[t] = q.area;
    x[t] = q.x;
    y[t] = q.y;
    reach[t] = q.reach;
  }

  __device__ __forceinline__ void get(int t, Box& q) const {
#pragma unroll
    for (int m = 0; m < 4; ++m) {
      q.cx[m] = cx[m][t];
      q.cy[m] = cy[m][t];
      q.ex[m] = ex[m][t];
      q.ey[m] = ey[m][t];
    }
    q.area = area[t];
  }
};

// pairwise_iou_bev(a, b) > thresh, a the row box, b the column box
__device__ __forceinline__ bool overlaps(const Box& a, const Box& b,
                                         float thresh) {
  const float sa = clipped_sum<false>(a.cx, a.cy, a.ex, a.ey, b.cx, b.cy,
                                      b.ex, b.ey);
  const float sb = clipped_sum<true>(b.cx, b.cy, b.ex, b.ey, a.cx, a.cy,
                                     a.ex, a.ey);
  const float inter = fmul(0.5f, fabsf(fadd(sa, sb)));
  const float uni = fsub(fadd(a.area, b.area), inter);
  const float den = isnan(uni) ? uni : fmaxf(uni, UNION_MIN);
  return __fdiv_rn(inter, den) > thresh;
}

// One CTA a (column tile, row tile, sample), a thread a row (then a pair):
//   1. the tile's 64 row and 64 column boxes to shared memory;
//   2. each thread tests its row against the columns right of the diagonal
//      (the early-out) and lists the pairs past it;
//   3. the CTA's threads share the listed pairs, so the full IoU runs
//      without divergence whatever row a near pair falls in, and set the
//      pairs' bits in the rows' words (shared atomics);
//   4. each thread writes its row's word.
__global__ void __launch_bounds__(TILE)
nms_iou_mask_kernel(const float* __restrict__ boxes, int k, int c,
                    float thresh, u64* __restrict__ out) {
  const int ct = blockIdx.x, rt = blockIdx.y, b = blockIdx.z;
  if (ct < rt) return;  // left of the diagonal: never read
  __shared__ Tile rows, cols;
  __shared__ u64 bits[TILE];
  __shared__ unsigned short pairs[TILE * TILE];  // row * 64 + column
  __shared__ int listed;
  const int t = threadIdx.x;
  const float* base = boxes + (size_t)b * k * c;
  const int i = rt * TILE + t, j = ct * TILE + t;
  Box q;
  if (i < k) {
    load_box(base + (size_t)i * c, q);
    rows.put(t, q);
  }
  if (j < k) {
    Box qc;
    load_box(base + (size_t)j * c, qc);
    cols.put(t, qc);
  }
  bits[t] = 0;
  if (t == 0) listed = 0;
  __syncthreads();

  if (i < k) {
    const int n = min(TILE, k - ct * TILE);
    u64 near = 0;
    for (int jj = ct == rt ? t + 1 : 0; jj < n; ++jj) {
      const float gx = fsub(q.x, cols.x[jj]), gy = fsub(q.y, cols.y[jj]);
      const float reach = fadd(q.reach, cols.reach[jj]);
      // past the reach the IoU is exactly 0: no bit
      if (!(fadd(fmul(gx, gx), fmul(gy, gy)) > fmul(reach, reach)))
        near |= 1ull << jj;
    }
    int at = atomicAdd(&listed, __popcll(near));
    for (; near; near &= near - 1)
      pairs[at++] = (unsigned short)(t * TILE + __ffsll(near) - 1);
  }
  __syncthreads();

  for (int p = t; p < listed; p += TILE) {
    const int r = pairs[p] / TILE, cc = pairs[p] % TILE;
    Box a, bx;
    rows.get(r, a);
    cols.get(cc, bx);
    if (overlaps(a, bx, thresh))
      atomicOr(&bits[r], 1ull << cc);
  }
  __syncthreads();
  if (i < k) out[((size_t)b * k + i) * ((k + TILE - 1) / TILE) + ct] = bits[t];
}

}  // namespace

// boxes (B, K, C) f32 contiguous, C >= 7 ((x, y, z, dx, dy, dz, heading,
// ...)); out (B, K, ceil(K / 64)) 8-byte words: word w of row i for w >=
// i / 64 written, the others left as they are. thresh >= 0.
MSSVT_API int mssvt_nms_iou_mask(const void* boxes, int b, int k, int c,
                                 float thresh, void* out,
                                 cudaStream_t stream) {
  if (b < 0 || k < 0 || c < 7 || !(thresh >= 0.f))
    return (int)cudaErrorInvalidValue;
  if (b == 0 || k == 0) return 0;
  const int tiles = (k + TILE - 1) / TILE;
  if (tiles > 65535 || b > 65535) return (int)cudaErrorInvalidValue;
  nms_iou_mask_kernel<<<dim3(tiles, tiles, b), TILE, 0, stream>>>(
      (const float*)boxes, k, c, thresh, (u64*)out);
  return launch_status();
}
