// K2, K2b, K2c and the masked FPS: farthest-point sampling over coordinate
// planes.
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
// (_fps_kernel, the row layout, any N): one CTA owns one row, each thread a
// contiguous run of PB = 16 points (so lane order and warp order are index
// order), 32 * ceil(N / 512) threads, N <= 16 384. The loop is bound by
// instruction issue (~10 single-rounded f32 operations a point and
// iteration; the bytes are one read of the planes and one write of the
// picks), so an iteration spends as little as it can beside them:
//   - x, y, z and the min-distance of a thread's points live in registers
//     (N <= 8 192; up to N = 2 048 the CTA has at most 128 threads and is
//     built for 6 CTAs an SM, 80 registers). Above that x, y, z sit in
//     shared memory, transposed so that the threads' reads are
//     conflict-free, and the min-distances stay in registers;
//   - a thread keeps only the maximum of its min-distances (one fmaxf a
//     point, no index); the warp's is a max of the bits (every min-distance is a
//     finite f32 >= +0, so its bits order as unsigned integers; padding
//     carries +0 after every real point) in one redux.sync, and the lowest
//     lane holding it by a ballot. Only that lane then looks for its first
//     point holding the maximum (the thread keeps the maxima of its four
//     groups of four points, so the search takes the first group holding it,
//     then the point in it), reads the point's coordinates from a copy
//     of the planes in shared memory, and writes (bits, index, x, y, z) to
//     its warp's slot of a double-buffered array;
//   - one __syncthreads an iteration; then every warp reduces the slots
//     itself the same way (the lowest warp wins ties) and takes the next
//     pick's coordinates straight from the winning slot. A fast warp cannot
//     overwrite a slot that a slow one still reads: it passes the next
//     barrier first;
//   - the picks go to a list in shared memory and out once as 16-byte rows
//     (thread 0 stores each pick directly where the list does not fit).
//
// The masked FPS (fps_masked_kernel, no TPU kernel: the JAX package's
// sector FPS is a plain loop) is K2c's loop with a row of valid flags:
// PV-RCNN++'s sectorised keypoint sampling, the sectors' rows (frame-major
// planes read once a frame, rows r of frame r % frames) and then the
// union's. An invalid point's min-distance is -1 and never moves, the first
// pick is the first valid point, and the keys the warps compare map -1 to 0
// and a finite f32 >= +0 to its bits plus one, so every valid point wins
// over every invalid one and ties still go to the lowest index. It computes
// what the plain loop (kernels/fps.py fps_masked_plain) computes, pick for
// pick. It shares K2c's body (fps_block_body, MASKED a template parameter),
// so K2c compiles to the code it had.
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

constexpr int PB = 16;              // points a thread of a K2c CTA
constexpr int MAX_N_BLOCK = 16384;  // PB * 1024
constexpr int SMEM_MAX = 227 * 1024;

// K2c, one CTA a row. SMEM_XYZ: x, y, z in shared memory, transposed (plane
// p, point tid * PB + s at sp[(p * PB + s) * MAXT + tid]); else in
// registers, with a copy of the planes in shared memory (plane p, point j at
// sp[p * ns + j]) from which the winning lane reads its coordinates. flags:
// bit 0, N % 4 == 0 and the planes 16-byte aligned (float4 loads); bit 1,
// npoint % 4 == 0 (16-byte pick rows); bit 2, the pick list fits in shared
// memory (always so for the register form; else thread 0 stores each pick
// as it is made). MASKED: the masked FPS (see the top of the file); row r
// reads the planes of frame r % frames and its own row of valid flags, and
// padding starts at -1 with the invalid points.
template <int MAXT, bool SMEM_XYZ, bool MASKED>
__device__ __forceinline__ void fps_block_body(
    const float* __restrict__ x, const float* __restrict__ y,
    const float* __restrict__ z, const uint8_t* __restrict__ valid,
    int frames, int n, int npoint, int* __restrict__ idx, int flags) {
  extern __shared__ __align__(16) float fsm[];
  __shared__ uint2 skey[2][32];    // a warp's winner: (key, index)
  __shared__ float4 sxyz[2][32];   // and its coordinates
  const int nt = blockDim.x, tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nwarps = nt >> 5, ns = (n + 3) & ~3;
  const size_t off = (size_t)(MASKED ? blockIdx.x % frames : blockIdx.x) * n;
  const float* xr = x + off;
  const float* yr = y + off;
  const float* zr = z + off;
  int* irow = idx + (size_t)blockIdx.x * npoint;
  float* sp = fsm;
  const bool list = !SMEM_XYZ || (flags & 4);
  int* spick = (int*)(fsm + (SMEM_XYZ ? 3 * PB * MAXT : 3 * ns));
  float px[SMEM_XYZ ? 1 : PB], py[SMEM_XYZ ? 1 : PB], pz[SMEM_XYZ ? 1 : PB], md[PB];
  if constexpr (SMEM_XYZ) {
    for (int e = tid; e < PB * nt; e += nt) {
      const int q = (e % PB) * MAXT + e / PB;
      const bool in = e < n;
      sp[q] = in ? __ldg(xr + e) : 0.f;
      sp[PB * MAXT + q] = in ? __ldg(yr + e) : 0.f;
      sp[2 * PB * MAXT + q] = in ? __ldg(zr + e) : 0.f;
    }
  } else if (flags & 1) {
#pragma unroll
    for (int q = 0; q < PB / 4; ++q) {
      const int j = tid * PB + 4 * q;
      const bool in = j < n;
      const float4 a = in ? __ldg(reinterpret_cast<const float4*>(xr + j)) : make_float4(0, 0, 0, 0);
      const float4 b = in ? __ldg(reinterpret_cast<const float4*>(yr + j)) : make_float4(0, 0, 0, 0);
      const float4 c = in ? __ldg(reinterpret_cast<const float4*>(zr + j)) : make_float4(0, 0, 0, 0);
      px[4 * q] = a.x; px[4 * q + 1] = a.y; px[4 * q + 2] = a.z; px[4 * q + 3] = a.w;
      py[4 * q] = b.x; py[4 * q + 1] = b.y; py[4 * q + 2] = b.z; py[4 * q + 3] = b.w;
      pz[4 * q] = c.x; pz[4 * q + 1] = c.y; pz[4 * q + 2] = c.z; pz[4 * q + 3] = c.w;
      if (in) {
        *reinterpret_cast<float4*>(sp + j) = a;
        *reinterpret_cast<float4*>(sp + ns + j) = b;
        *reinterpret_cast<float4*>(sp + 2 * ns + j) = c;
      }
    }
  } else {
#pragma unroll
    for (int s = 0; s < PB; ++s) {
      const int j = tid * PB + s;
      const bool in = j < n;
      px[s] = in ? __ldg(xr + j) : 0.f;
      py[s] = in ? __ldg(yr + j) : 0.f;
      pz[s] = in ? __ldg(zr + j) : 0.f;
      if (in) {
        sp[j] = px[s];
        sp[ns + j] = py[s];
        sp[2 * ns + j] = pz[s];
      }
    }
  }
  int first = 0;
  if constexpr (MASKED) {
    __shared__ int sfirst;
    const uint8_t* vr = valid + (size_t)blockIdx.x * n;
    int own = n;  // the thread's first valid point
#pragma unroll
    for (int s = PB - 1; s >= 0; --s) {
      const int j = tid * PB + s;
      const bool ok = j < n && __ldg(vr + j) != 0;
      md[s] = ok ? 1e10f : -1.f;  // invalid and padding: -1
      if (ok) own = j;
    }
    if (tid == 0) sfirst = n;
    __syncthreads();
    if (own < n) atomicMin(&sfirst, own);
    __syncthreads();
    first = sfirst < n ? sfirst : 0;
  } else {
#pragma unroll
    for (int s = 0; s < PB; ++s) md[s] = tid * PB + s < n ? 1e10f : 0.f;  // padding: +0
  }
  if (tid == 0) {
    if (list) spick[0] = first;
    else irow[0] = first;
  }
  __syncthreads();
  float lx = __ldg(xr + first), ly = __ldg(yr + first), lz = __ldg(zr + first);
  // iteration i writes slot buffer i & 1; two iterations a turn make it a
  // constant (fewer address instructions than the loop spends otherwise)
  auto step = [&](int i, int buf) {
#pragma unroll
    for (int s = 0; s < PB; ++s) {
      float xs, ys, zs;
      if constexpr (SMEM_XYZ) {
        xs = sp[s * MAXT + tid];
        ys = sp[(PB + s) * MAXT + tid];
        zs = sp[(2 * PB + s) * MAXT + tid];
      } else {
        xs = px[s];
        ys = py[s];
        zs = pz[s];
      }
      const float dx = __fsub_rn(xs, lx);
      const float dy = __fsub_rn(ys, ly);
      const float dz = __fsub_rn(zs, lz);
      const float d = __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)),
                                __fmul_rn(dz, dz));
      md[s] = fminf(md[s], d);
    }
    // the thread's maximum, by groups of 4 points
    float gm[PB / 4];
#pragma unroll
    for (int q = 0; q < PB / 4; ++q)
      gm[q] = fmaxf(fmaxf(md[4 * q], md[4 * q + 1]), fmaxf(md[4 * q + 2], md[4 * q + 3]));
    float best = gm[0];
#pragma unroll
    for (int q = 1; q < PB / 4; ++q) best = fmaxf(best, gm[q]);
    // the warp's first maximum: a max of the keys, the lowest lane holding it
    const unsigned bits = MASKED ? (best < 0.f ? 0u : __float_as_uint(best) + 1u)
                                 : __float_as_uint(best);
    const unsigned m = __reduce_max_sync(0xffffffffu, bits);
    const int wl = __ffs(__ballot_sync(0xffffffffu, bits == m)) - 1;
    if (lane == wl) {
      // the lane's first point holding its maximum: the first group, then
      // the first point of it (point by point at 1 024 threads, which leave
      // 64 registers)
      int bs = 0;
      if constexpr (SMEM_XYZ) {
#pragma unroll
        for (int s = PB - 1; s >= 0; --s)
          if (md[s] == best) bs = s;
      } else {
        int g = PB / 4 - 1;
#pragma unroll
        for (int q = PB / 4 - 2; q >= 0; --q)
          if (gm[q] == best) g = q;
        float v0 = md[0], v1 = md[1], v2 = md[2];
#pragma unroll
        for (int q = 1; q < PB / 4; ++q)
          if (g == q) { v0 = md[4 * q]; v1 = md[4 * q + 1]; v2 = md[4 * q + 2]; }
        bs = 4 * g + (v0 == best ? 0 : v1 == best ? 1 : v2 == best ? 2 : 3);
      }
      const int j = tid * PB + bs;
      float4 c;
      if constexpr (SMEM_XYZ)
        c = make_float4(sp[bs * MAXT + tid], sp[(PB + bs) * MAXT + tid],
                        sp[(2 * PB + bs) * MAXT + tid], 0.f);
      else
        c = make_float4(sp[j], sp[ns + j], sp[2 * ns + j], 0.f);
      skey[buf][warp] = make_uint2(bits, (unsigned)j);
      sxyz[buf][warp] = c;
    }
    __syncthreads();  // the one barrier of an iteration
    // every warp reduces the slots itself: the lowest warp wins ties
    const uint2 kv = lane < nwarps ? skey[buf][lane] : make_uint2(0u, 0u);
    const unsigned mm = __reduce_max_sync(0xffffffffu, kv.x);
    const int ww = __ffs(__ballot_sync(0xffffffffu, lane < nwarps && kv.x == mm)) - 1;
    const int last = (int)__shfl_sync(0xffffffffu, kv.y, ww);
    const float4 c = sxyz[buf][ww];
    lx = c.x; ly = c.y; lz = c.z;
    if (tid == 0) {
      if (list) spick[i] = last;
      else irow[i] = last;
    }
  };
  int i = 1;
  for (; i + 1 < npoint; i += 2) {
    step(i, 1);
    step(i + 1, 0);
  }
  if (i < npoint) step(i, 1);
  if (list) {
    __syncthreads();
    if (flags & 2) {
      for (int q = tid; q < npoint / 4; q += nt)
        reinterpret_cast<int4*>(irow)[q] = reinterpret_cast<const int4*>(spick)[q];
    } else {
      for (int e = tid; e < npoint; e += nt) irow[e] = spick[e];
    }
  }
}

template <int MAXT, int MINB, bool SMEM_XYZ>
__global__ void __launch_bounds__(MAXT, MINB)
fps_block_kernel(const float* __restrict__ x, const float* __restrict__ y,
                 const float* __restrict__ z, int n, int npoint,
                 int* __restrict__ idx, int flags) {
  fps_block_body<MAXT, SMEM_XYZ, false>(x, y, z, nullptr, 1, n, npoint, idx, flags);
}

// The masked FPS: rows of frames r % frames, each with its own valid flags.
template <int MAXT, int MINB, bool SMEM_XYZ>
__global__ void __launch_bounds__(MAXT, MINB)
fps_masked_kernel(const float* __restrict__ x, const float* __restrict__ y,
                  const float* __restrict__ z, const uint8_t* __restrict__ valid,
                  int frames, int n, int npoint, int* __restrict__ idx, int flags) {
  fps_block_body<MAXT, SMEM_XYZ, true>(x, y, z, valid, frames, n, npoint, idx, flags);
}

template <int MAXT, int MINB, bool SMEM_XYZ, bool MASKED>
int launch_block(const float* x, const float* y, const float* z,
                 const uint8_t* valid, int frames, int rows, int n, int npoint,
                 int* idx, cudaStream_t stream) {
  const int nt = 32 * ((n + 32 * PB - 1) / (32 * PB));  // warps cover N
  const size_t fixed = 2 * 32 * (sizeof(uint2) + sizeof(float4));  // static slots
  size_t smem = (SMEM_XYZ ? (size_t)3 * PB * MAXT : (size_t)3 * ((n + 3) & ~3)) * sizeof(float);
  const size_t picks = (size_t)((npoint + 3) & ~3) * sizeof(int);
  const bool aligned = n % 4 == 0 && (((uintptr_t)x | (uintptr_t)y | (uintptr_t)z) & 15) == 0;
  int flags = (aligned ? 1 : 0) | (npoint % 4 == 0 ? 2 : 0);
  if (fixed + smem + picks <= (size_t)SMEM_MAX) {
    flags |= 4;
    smem += picks;
  } else if (!SMEM_XYZ) {
    return (int)cudaErrorInvalidValue;  // the caller takes the SMEM_XYZ form
  }
  cudaError_t err;
  if constexpr (MASKED) {
    auto kernel = fps_masked_kernel<MAXT, MINB, SMEM_XYZ>;
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    kernel<<<rows, nt, smem, stream>>>(x, y, z, valid, frames, n, npoint, idx, flags);
  } else {
    auto kernel = fps_block_kernel<MAXT, MINB, SMEM_XYZ>;
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    kernel<<<rows, nt, smem, stream>>>(x, y, z, n, npoint, idx, flags);
  }
  return launch_status();
}

// Whether the register form's planes and pick list fit in a CTA.
bool fits_registers(int n, int npoint) {
  return 2 * 32 * (sizeof(uint2) + sizeof(float4)) + 3 * ((n + 3) & ~3) * sizeof(float) +
             ((npoint + 3) & ~3) * sizeof(int) <= (size_t)SMEM_MAX;
}

// K2c and the masked FPS by N: registers up to 128 threads with 6 CTAs an
// SM (80 registers), up to 512 with one; above N = 8 192 (or where the
// planes' copy and the pick list do not fit) x, y, z go to shared memory.
template <bool MASKED>
int launch_block_rows(const float* x, const float* y, const float* z,
                      const uint8_t* valid, int frames, int rows, int n,
                      int npoint, int* idx, cudaStream_t stream) {
  if (fits_registers(n, npoint)) {
    if (n <= PB * 128)
      return launch_block<128, 6, false, MASKED>(x, y, z, valid, frames, rows, n, npoint, idx, stream);
    if (n <= PB * 512)
      return launch_block<512, 1, false, MASKED>(x, y, z, valid, frames, rows, n, npoint, idx, stream);
  }
  return launch_block<1024, 1, true, MASKED>(x, y, z, valid, frames, rows, n, npoint, idx, stream);
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
  return launch_block_rows<false>(x, y, z, nullptr, 1, rows, n, npoint, idx, stream);
}

// The masked FPS: (frames, n) planes, (rows, n) valid flags (one byte a
// point), rows a multiple of frames; picks only, one CTA per row.
MSSVT_API int mssvt_fps_picks_masked(const float* x, const float* y,
                                     const float* z, const uint8_t* valid,
                                     int frames, int rows, int n, int npoint,
                                     int* idx, cudaStream_t stream) {
  if (n < 1 || n > MAX_N_BLOCK || npoint < 1 || frames < 1 || rows % frames != 0)
    return (int)cudaErrorInvalidValue;
  if (rows <= 0) return 0;
  return launch_block_rows<true>(x, y, z, valid, frames, rows, n, npoint, idx, stream);
}
