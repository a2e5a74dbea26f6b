// K2, K2b, K2c: farthest-point sampling (FPS) over coordinate planes.
//
// K2 (fps_kernel<G, P, true>): FPS with selected plane values.
// Replaces the TPU kernel farthest_point_sample_planes_pallas_t_sel
// (mssvt_tpu/ops/pallas_fps.py, _fps_kernel_t_sel -> _fps_t_sel_body). The
// TPU kernel kept a (N, 128-window) tile in VMEM and ran the sequential loop
// with full-width one-hot reductions. Here a row (window) takes a group of G
// lanes of a warp (32 / G rows a warp; G = 4 at N <= 32, 8 at N <= 96, 16
// at N <= 192, 32 at N <= 256) and each lane holds a contiguous run of
// P <= 12 points in registers, so that lane order is index order.
//
// Bound: latency and instruction count of the npoint - 1 dependent
// iterations, not bytes: the planes are read once and the picks written once
// (~1.5 KB per row in, ~0.6 KB out). At N = 96 one warp a row spent ~100
// instructions a row and iteration, ~60% of them fetching the last pick (a
// register select, 3 shuffles), the (value, index) shuffle argmax (10
// shuffles) and five scattered stores. Now an iteration of a group
//   - reads the last pick's coordinates from the row's planes, staged once
//     in shared memory with 16-byte loads (a broadcast read);
//   - updates its P min-distances and keeps its own best (strict > over
//     ascending indices: the first maximum);
//   - takes the group's maximum as the float's bits (every min-distance is
//     a finite f32 >= +0, so its bits order as unsigned integers) in
//     log2(G) one-word xor shuffles, finds the lowest lane holding it by a
//     ballot, and fetches that lane's index with one shuffle. Ties go to
//     the lowest index, as torch.argmax's do; padding points carry +0 past
//     every real point and never win;
//   - appends the pick to the row's list in shared memory.
// After the loop the group writes the picks and every plane's values at
// them (x, y, z from the staged planes, aux planes gathered from global
// memory) as whole rows, 16 bytes a lane; dead rows write zeros the same
// way. Group-masked shuffles let dead and live rows share a warp.
//
// Rounding: the distance is built from __fsub_rn/__fmul_rn/__fadd_rn so that
// no FMA contraction changes it; it then matches the plain PyTorch version
// ((dx*dx + dy*dy) + dz*dz, each op rounded) bit for bit, and so do the
// picks.
//
// K2b (fps_kernel<G, P, false>) replaces farthest_point_sample_planes_pallas_t
// (_fps_kernel_t, the layout JAX's sampling.farthest_point_sample_planes
// takes on the TPU): the same loop for N <= 256 with the picks as its only
// output: no aux planes, no selections, no dead rows.
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

// Shared-memory words of one row: its x, y, z planes (N rounded up to 4
// each) and its picks (npoint rounded up to 4).
__host__ __device__ inline int row_words(int n, int npoint) {
  return 3 * ((n + 3) & ~3) + ((npoint + 3) & ~3);
}

__device__ __forceinline__ uint32_t bits32(int v) { return (uint32_t)v; }
__device__ __forceinline__ uint32_t bits32(float v) { return __float_as_uint(v); }

// Writes a row of npoint values, 16 bytes a lane where vec, from value(e).
template <int G, typename V, typename F>
__device__ __forceinline__ void write_row(V* out, int npoint, bool vec, int lig,
                                          F value) {
  if (vec) {
    for (int e = 4 * lig; e < npoint; e += 4 * G)
      *reinterpret_cast<uint4*>(out + e) =
          make_uint4(bits32(value(e)), bits32(value(e + 1)),
                     bits32(value(e + 2)), bits32(value(e + 3)));
  } else {
    for (int e = lig; e < npoint; e += G) out[e] = value(e);
  }
}

// flags: bit 0, N % 4 == 0 and the x/y/z planes 16-byte aligned (staging
// by float4); bit 1, npoint % 4 == 0 (16-byte output rows).
template <int G, int P, bool SEL>
__global__ void __launch_bounds__(WARPS * 32) fps_kernel(
    Planes planes, int nplanes, int rows, int n, int npoint, int nw_half,
    const int* __restrict__ num_valid, int* __restrict__ idx,
    float* __restrict__ sels, int flags) {
  extern __shared__ __align__(16) float fsm[];
  const int lane = threadIdx.x & 31, lig = lane % G;
  const unsigned gmask = (0xffffffffu >> (32 - G)) << (lane - lig);
  const int slot = (threadIdx.x >> 5) * (32 / G) + lane / G;  // row of the CTA
  const int row = blockIdx.x * (WARPS * 32 / G) + slot;
  if (row >= rows) return;  // whole groups leave; shuffles are group-masked
  const bool vec_out = flags & 2;
  int* irow = idx + (size_t)row * npoint;
  if (SEL && num_valid != nullptr) {
    const int local = (nw_half > 0 && row >= nw_half) ? row - nw_half : row;
    if (local >= __ldg(num_valid)) {
      write_row<G>(irow, npoint, vec_out, lig, [](int) { return 0; });
      for (int p = 0; p < nplanes; ++p)
        write_row<G>(sels + ((size_t)p * rows + row) * npoint, npoint, vec_out,
                     lig, [](int) { return 0.f; });
      return;
    }
  }
  const int ns = (n + 3) & ~3;
  float* sx = fsm + (size_t)slot * row_words(n, npoint);
  int* spick = (int*)(sx + 3 * ns);
  const size_t off = (size_t)row * n;
  if (flags & 1) {
    const int n4 = n / 4;
    for (int e = lig; e < 3 * n4; e += G) {
      const int p = e / n4, c = (e % n4) * 4;
      *reinterpret_cast<float4*>(sx + p * ns + c) =
          __ldg(reinterpret_cast<const float4*>(planes.p[p] + off + c));
    }
  } else {
    for (int e = lig; e < 3 * n; e += G) sx[(e / n) * ns + e % n] = __ldg(planes.p[e / n] + off + e % n);
  }
  __syncwarp(gmask);
  float x[P], y[P], z[P], md[P];
#pragma unroll
  for (int s = 0; s < P; ++s) {
    const int j = lig * P + s;
    const bool in = j < n;
    x[s] = in ? sx[j] : 0.f;
    y[s] = in ? sx[ns + j] : 0.f;
    z[s] = in ? sx[2 * ns + j] : 0.f;
    md[s] = in ? 1e10f : 0.f;  // padding: +0, after every real point
  }
  int last = 0;
  for (int i = 0; i < npoint; ++i) {
    if (lig == 0) spick[i] = last;
    if (i == npoint - 1) break;
    const float lx = sx[last], ly = sx[ns + last], lz = sx[2 * ns + last];
    float best = -1.f;
    int bs = 0;
#pragma unroll
    for (int s = 0; s < P; ++s) {
      const float dx = __fsub_rn(x[s], lx);
      const float dy = __fsub_rn(y[s], ly);
      const float dz = __fsub_rn(z[s], lz);
      const float d = __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)),
                                __fmul_rn(dz, dz));
      md[s] = fminf(md[s], d);
      if (md[s] > best) { best = md[s]; bs = s; }  // s rises: lowest wins ties
    }
    const unsigned bits = __float_as_uint(best);
    unsigned gmax = bits;
#pragma unroll
    for (int o = G / 2; o > 0; o >>= 1) gmax = max(gmax, __shfl_xor_sync(gmask, gmax, o));
    const int winner = __ffs(__ballot_sync(gmask, bits == gmax) & gmask) - 1;
    last = __shfl_sync(gmask, lig * P + bs, winner);
  }
  __syncwarp(gmask);
  write_row<G>(irow, npoint, vec_out, lig, [&](int e) { return spick[e]; });
  if (SEL) {
    for (int p = 0; p < nplanes; ++p) {
      const float* src = p < 3 ? sx + p * ns : planes.p[p] + off;
      write_row<G>(sels + ((size_t)p * rows + row) * npoint, npoint, vec_out,
                   lig, [&](int e) { return p < 3 ? src[spick[e]] : __ldg(src + spick[e]); });
    }
  }
}

template <int G, int P, bool SEL>
int launch(const Planes& pl, int nplanes, int rows, int n, int npoint,
           int nw_half, const int* nv, int* idx, float* sels,
           cudaStream_t stream) {
  const int rpc = WARPS * 32 / G;  // rows a CTA
  const size_t smem = (size_t)rpc * row_words(n, npoint) * sizeof(float);
  if (smem > 227 * 1024) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      fps_kernel<G, P, SEL>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  bool aligned = n % 4 == 0;
  for (int p = 0; p < 3; ++p) aligned = aligned && ((uintptr_t)pl.p[p] & 15) == 0;
  const int flags = (aligned ? 1 : 0) | (npoint % 4 == 0 ? 2 : 0);
  fps_kernel<G, P, SEL><<<(rows + rpc - 1) / rpc, WARPS * 32, smem, stream>>>(
      pl, nplanes, rows, n, npoint, nw_half, nv, idx, sels, flags);
  return launch_status();
}

// (G lanes a row, P points a lane) by N: G * P >= N.
template <bool SEL>
int launch_rows(const Planes& pl, int nplanes, int rows, int n, int npoint,
                int nw_half, const int* nv, int* idx, float* sels,
                cudaStream_t stream) {
  if (n <= 32) return launch<4, 8, SEL>(pl, nplanes, rows, n, npoint, nw_half, nv, idx, sels, stream);
  if (n <= 64) return launch<8, 8, SEL>(pl, nplanes, rows, n, npoint, nw_half, nv, idx, sels, stream);
  if (n <= 96) return launch<8, 12, SEL>(pl, nplanes, rows, n, npoint, nw_half, nv, idx, sels, stream);
  if (n <= 128) return launch<16, 8, SEL>(pl, nplanes, rows, n, npoint, nw_half, nv, idx, sels, stream);
  if (n <= 192) return launch<16, 12, SEL>(pl, nplanes, rows, n, npoint, nw_half, nv, idx, sels, stream);
  return launch<32, 8, SEL>(pl, nplanes, rows, n, npoint, nw_half, nv, idx, sels, stream);
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
  return launch_rows<true>(pl, nplanes, rows, n, npoint, nw_half, num_valid, idx, sels, stream);
}

// K2b: picks only, a group of lanes a row, n <= 256.
MSSVT_API int mssvt_fps_picks_warp(const float* x, const float* y,
                                   const float* z, int rows, int n, int npoint,
                                   int* idx, cudaStream_t stream) {
  if (n < 1 || n > 256 || npoint < 1) return (int)cudaErrorInvalidValue;
  if (rows <= 0) return 0;
  Planes pl{};
  pl.p[0] = x; pl.p[1] = y; pl.p[2] = z;
  return launch_rows<false>(pl, 3, rows, n, npoint, 0, nullptr, idx, nullptr, stream);
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
