// K2, K2b, K2c: farthest-point sampling (FPS) over coordinate planes.
//
// K2 (fps_kernel<PER, true>): FPS with selected plane values.
// Replaces the TPU kernel farthest_point_sample_planes_pallas_t_sel
// (mssvt_tpu/ops/pallas_fps.py, _fps_kernel_t_sel -> _fps_t_sel_body). The
// TPU kernel kept a (N, 128-window) tile in VMEM and ran the sequential loop
// with full-width one-hot reductions; here one warp owns one row (window),
// holds its N <= 256 points in registers (element j in lane j % 32, slot
// j / 32), fetches the last pick's coordinates with a shuffle from its
// owner lane, and finds the next pick with a warp-shuffle argmax whose ties
// go to the lowest index.
//
// Bound: latency of the npoint-1 dependent iterations (each a 5-step shuffle
// reduction), not bytes: the planes are read once and the picks written once
// (~1 KB per row in, ~0.6 KB out). Many rows in flight (8 warps a block, one
// row a warp) hide that latency across the SMs.
//
// Rounding: the distance is built from __fsub_rn/__fmul_rn/__fadd_rn so that
// no FMA contraction changes it; it then matches the plain PyTorch version
// ((dx*dx + dy*dy) + dz*dz, each op rounded) bit for bit, and so do the
// picks.
//
// K2b (fps_kernel<PER, false>) replaces farthest_point_sample_planes_pallas_t
// (_fps_kernel_t, the layout JAX's sampling.farthest_point_sample_planes
// takes on the TPU): the same one-warp-per-row loop for N <= 256 with the
// picks as its only output: no aux planes, no selections, no dead rows.
//
// K2c (fps_block_kernel) replaces farthest_point_sample_planes_pallas
// (_fps_kernel, the row layout, any N): one CTA of 256 threads owns one row
// and keeps its three planes and the min-distance cache in shared memory
// (16 N bytes, so N <= 14 336 in a CTA's 227 KB); each thread strides over
// the points, and the argmax is a warp-shuffle reduction per warp, then one
// over the 8 warp results, both with ties to the lowest index. Two block
// barriers an iteration bound it (latency, as K2); bytes are one read of
// the planes and one write of the picks.
#include <limits.h>
#include <math.h>

#include "common.h"

namespace {

constexpr int WARPS = 8;
constexpr int MAX_PLANES = 8;

struct Planes {
  const float* p[MAX_PLANES];
};

template <int PER, bool SEL>
__global__ void fps_kernel(Planes planes, int nplanes, int rows, int n,
                           int npoint, int nw_half,
                           const int* __restrict__ num_valid,
                           int* __restrict__ idx, float* __restrict__ sels) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * WARPS + (threadIdx.x >> 5);
  if (row >= rows) return;
  int* irow = idx + (size_t)row * npoint;
  if (SEL && num_valid != nullptr) {
    const int local = (nw_half > 0 && row >= nw_half) ? row - nw_half : row;
    if (local >= __ldg(num_valid)) {
      for (int j = lane; j < npoint; j += 32) {
        irow[j] = 0;
        for (int p = 0; p < nplanes; ++p)
          sels[((size_t)p * rows + row) * npoint + j] = 0.f;
      }
      return;
    }
  }
  const size_t off = (size_t)row * n;
  float x[PER], y[PER], z[PER], md[PER];
#pragma unroll
  for (int s = 0; s < PER; ++s) {
    const int j = s * 32 + lane;
    const bool in = j < n;
    x[s] = in ? __ldg(planes.p[0] + off + j) : 0.f;
    y[s] = in ? __ldg(planes.p[1] + off + j) : 0.f;
    z[s] = in ? __ldg(planes.p[2] + off + j) : 0.f;
    md[s] = in ? 1e10f : -INFINITY;  // padding lanes are never picked
  }
  int last = 0;
  for (int i = 0; i < npoint; ++i) {
    if (lane == 0) irow[i] = last;
    // values of every plane at pick i (aux planes read straight from memory)
    if (SEL && lane < nplanes)
      sels[((size_t)lane * rows + row) * npoint + i] =
          __ldg(planes.p[lane] + off + last);
    if (i == npoint - 1) break;
    const int owner = last & 31, slot = last >> 5;
    float ox = 0.f, oy = 0.f, oz = 0.f;
#pragma unroll
    for (int s = 0; s < PER; ++s)
      if (s == slot) { ox = x[s]; oy = y[s]; oz = z[s]; }
    const float lx = __shfl_sync(0xffffffffu, ox, owner);
    const float ly = __shfl_sync(0xffffffffu, oy, owner);
    const float lz = __shfl_sync(0xffffffffu, oz, owner);
    float best = -INFINITY;
    int bi = 0x7fffffff;
#pragma unroll
    for (int s = 0; s < PER; ++s) {
      const int j = s * 32 + lane;
      if (j < n) {
        const float dx = __fsub_rn(x[s], lx);
        const float dy = __fsub_rn(y[s], ly);
        const float dz = __fsub_rn(z[s], lz);
        const float d = __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)),
                                  __fmul_rn(dz, dz));
        md[s] = fminf(md[s], d);
        if (md[s] > best) { best = md[s]; bi = j; }  // j rises: lowest wins ties
      }
    }
    for (int o = 16; o > 0; o >>= 1) {
      const float ob = __shfl_xor_sync(0xffffffffu, best, o);
      const int oi = __shfl_xor_sync(0xffffffffu, bi, o);
      if (ob > best || (ob == best && oi < bi)) { best = ob; bi = oi; }
    }
    last = bi;
  }
}

template <int PER, bool SEL>
void launch(const Planes& pl, int nplanes, int rows, int n, int npoint,
            int nw_half, const int* nv, int* idx, float* sels,
            cudaStream_t stream) {
  const int blocks = (rows + WARPS - 1) / WARPS;
  fps_kernel<PER, SEL><<<blocks, WARPS * 32, 0, stream>>>(
      pl, nplanes, rows, n, npoint, nw_half, nv, idx, sels);
}

template <bool SEL>
void launch_warp(const Planes& pl, int nplanes, int rows, int n, int npoint,
                 int nw_half, const int* nv, int* idx, float* sels,
                 cudaStream_t stream) {
  switch ((n + 31) / 32) {
    case 1: launch<1, SEL>(pl, nplanes, rows, n, npoint, nw_half, nv, idx, sels, stream); break;
    case 2: launch<2, SEL>(pl, nplanes, rows, n, npoint, nw_half, nv, idx, sels, stream); break;
    case 3: launch<3, SEL>(pl, nplanes, rows, n, npoint, nw_half, nv, idx, sels, stream); break;
    case 4: launch<4, SEL>(pl, nplanes, rows, n, npoint, nw_half, nv, idx, sels, stream); break;
    case 5: launch<5, SEL>(pl, nplanes, rows, n, npoint, nw_half, nv, idx, sels, stream); break;
    case 6: launch<6, SEL>(pl, nplanes, rows, n, npoint, nw_half, nv, idx, sels, stream); break;
    case 7: launch<7, SEL>(pl, nplanes, rows, n, npoint, nw_half, nv, idx, sels, stream); break;
    default: launch<8, SEL>(pl, nplanes, rows, n, npoint, nw_half, nv, idx, sels, stream); break;
  }
}

constexpr int BT = 256;            // threads of a K2c CTA
constexpr int MAX_N_BLOCK = 14336;  // 16 N bytes of shared memory

__global__ void __launch_bounds__(BT) fps_block_kernel(
    const float* __restrict__ x, const float* __restrict__ y,
    const float* __restrict__ z, int n, int npoint, int* __restrict__ idx) {
  extern __shared__ float fsm[];
  __shared__ float wbest[BT / 32];
  __shared__ int wbi[BT / 32];
  __shared__ int s_last;
  float* sx = fsm;
  float* sy = sx + n;
  float* sz = sy + n;
  float* md = sz + n;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const size_t off = (size_t)blockIdx.x * n;
  int* irow = idx + (size_t)blockIdx.x * npoint;
  for (int j = tid; j < n; j += BT) {
    sx[j] = __ldg(x + off + j);
    sy[j] = __ldg(y + off + j);
    sz[j] = __ldg(z + off + j);
    md[j] = 1e10f;
  }
  __syncthreads();
  int last = 0;
  for (int i = 0; i < npoint; ++i) {
    if (tid == 0) irow[i] = last;
    if (i == npoint - 1) break;
    const float lx = sx[last], ly = sy[last], lz = sz[last];
    float best = -INFINITY;
    int bi = INT_MAX;
    for (int j = tid; j < n; j += BT) {
      const float dx = __fsub_rn(sx[j], lx);
      const float dy = __fsub_rn(sy[j], ly);
      const float dz = __fsub_rn(sz[j], lz);
      const float d = __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)),
                                __fmul_rn(dz, dz));
      const float m = fminf(md[j], d);
      md[j] = m;
      if (m > best) { best = m; bi = j; }  // j rises: lowest wins ties
    }
    for (int o = 16; o > 0; o >>= 1) {
      const float ob = __shfl_xor_sync(0xffffffffu, best, o);
      const int oi = __shfl_xor_sync(0xffffffffu, bi, o);
      if (ob > best || (ob == best && oi < bi)) { best = ob; bi = oi; }
    }
    if (lane == 0) { wbest[warp] = best; wbi[warp] = bi; }
    __syncthreads();
    if (warp == 0) {
      best = lane < BT / 32 ? wbest[lane] : -INFINITY;
      bi = lane < BT / 32 ? wbi[lane] : INT_MAX;
      for (int o = 16; o > 0; o >>= 1) {
        const float ob = __shfl_xor_sync(0xffffffffu, best, o);
        const int oi = __shfl_xor_sync(0xffffffffu, bi, o);
        if (ob > best || (ob == best && oi < bi)) { best = ob; bi = oi; }
      }
      if (lane == 0) s_last = bi;
    }
    __syncthreads();
    last = s_last;
  }
}

}  // namespace

MSSVT_API int mssvt_fps(const float* const* planes, int nplanes, int rows,
                        int n, int npoint, int nw_half, const int* num_valid,
                        int* idx, float* sels, cudaStream_t stream) {
  if (nplanes < 3 || nplanes > MAX_PLANES || n < 1 || n > 256 || npoint < 1)
    return (int)cudaErrorInvalidValue;
  if (rows <= 0) return 0;
  Planes pl{};
  for (int i = 0; i < nplanes; ++i) pl.p[i] = planes[i];
  launch_warp<true>(pl, nplanes, rows, n, npoint, nw_half, num_valid, idx, sels, stream);
  return launch_status();
}

// K2b: picks only, one warp per row, n <= 256.
MSSVT_API int mssvt_fps_picks_warp(const float* x, const float* y,
                                   const float* z, int rows, int n, int npoint,
                                   int* idx, cudaStream_t stream) {
  if (n < 1 || n > 256 || npoint < 1) return (int)cudaErrorInvalidValue;
  if (rows <= 0) return 0;
  Planes pl{};
  pl.p[0] = x; pl.p[1] = y; pl.p[2] = z;
  launch_warp<false>(pl, 3, rows, n, npoint, 0, nullptr, idx, nullptr, stream);
  return launch_status();
}

// K2c: picks only, one CTA per row, n <= MAX_N_BLOCK.
MSSVT_API int mssvt_fps_picks_block(const float* x, const float* y,
                                    const float* z, int rows, int n, int npoint,
                                    int* idx, cudaStream_t stream) {
  if (n < 1 || n > MAX_N_BLOCK || npoint < 1) return (int)cudaErrorInvalidValue;
  if (rows <= 0) return 0;
  const size_t smem = (size_t)4 * n * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      fps_block_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  fps_block_kernel<<<rows, BT, smem, stream>>>(x, y, z, n, npoint, idx);
  return launch_status();
}
