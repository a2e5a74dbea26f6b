// K4: fused residual + LayerNorm + FFN tail of an MsSVT block.
//
// Replaces the TPU kernel fused_residual_ffn (mssvt_tpu/ops/pallas_ffn.py,
// _ffn_kernel): out = x + W2 relu(W1 LN(x) + b1) + b2, LN statistics in f32
// (eps given), the LN output and the hidden activation rounded to the
// compute type, both products accumulated in f32. The TPU kernel always
// rounds to bf16; this kernel takes the model's compute type (bf16 for
// mssvt.yaml, which is exactly the TPU kernel; f32 for the f32 configs,
// which is exactly the JAX CPU path).
//
// One CTA owns a tile of 32 rows: x, the LN output and the hidden tile stay
// in shared memory, so each row's C inputs are read once and its C outputs
// written once (the TPU kernel's one-pass property).
//
// Bound: at the card's peaks, device memory, narrowly: 4*C*F FLOP per row
// against 4*C bytes (bf16 in + out) is 256 FLOP/B at C=128, F=256, just
// below the bf16 tensor-core ridge (~295). In bf16 both products run on the
// tensor cores as 16x16x16 WMMA tiles (mma.sync; weights read through
// L1/L2, each weight fragment feeding the tile's rows). The f32 path runs
// them as FMA loops on the CUDA cores, register-blocked over the rows.
#include <mma.h>

#include <type_traits>

#include "common.h"

namespace {

constexpr int NT = 256;
constexpr int R = 32;  // rows per CTA
constexpr int NWARP = NT / 32;
namespace wm = nvcuda::wmma;
using BF = __nv_bfloat16;

// Both products on the tensor cores (bf16 in, f32 accumulation); each warp
// owns whole 16x16 output tiles and applies the epilogue through a private
// 16x16 f32 scratch.
__device__ void ffn_mma(const float* xs, const BF* ln, BF* hs, float* scratch,
                        const BF* __restrict__ w1, const float* __restrict__ b1,
                        const BF* __restrict__ w2, const float* __restrict__ b2,
                        BF* __restrict__ out, int row0, int nrow, int c, int f) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  wm::fragment<wm::accumulator, 16, 16, 16, float> acc;
  wm::fragment<wm::matrix_a, 16, 16, 16, BF, wm::row_major> fa;
  wm::fragment<wm::matrix_b, 16, 16, 16, BF, wm::row_major> fb;
  // hidden = round(relu(LN W1 + b1))
  for (int t = warp; t < (R / 16) * (f / 16); t += NWARP) {
    const int r0 = (t / (f / 16)) * 16, j0 = (t % (f / 16)) * 16;
    wm::fill_fragment(acc, 0.f);
    for (int k0 = 0; k0 < c; k0 += 16) {
      wm::load_matrix_sync(fa, ln + r0 * c + k0, c);
      wm::load_matrix_sync(fb, w1 + (size_t)k0 * f + j0, f);
      wm::mma_sync(acc, fa, fb, acc);
    }
    wm::store_matrix_sync(scratch, acc, 16, wm::mem_row_major);
    __syncwarp();
    for (int e = lane; e < 256; e += 32) {
      const int r = r0 + e / 16, j = j0 + e % 16;
      hs[r * f + j] = __float2bfloat16_rn(fmaxf(scratch[e] + __ldg(b1 + j), 0.f));
    }
    __syncwarp();
  }
  __syncthreads();
  // out = round(x + (hidden W2 + b2))
  for (int t = warp; t < (R / 16) * (c / 16); t += NWARP) {
    const int r0 = (t / (c / 16)) * 16, c0 = (t % (c / 16)) * 16;
    wm::fill_fragment(acc, 0.f);
    for (int k0 = 0; k0 < f; k0 += 16) {
      wm::load_matrix_sync(fa, hs + r0 * f + k0, f);
      wm::load_matrix_sync(fb, w2 + (size_t)k0 * c + c0, c);
      wm::mma_sync(acc, fa, fb, acc);
    }
    wm::store_matrix_sync(scratch, acc, 16, wm::mem_row_major);
    __syncwarp();
    for (int e = lane; e < 256; e += 32) {
      const int r = r0 + e / 16, ch = c0 + e % 16;
      if (r < nrow)
        out[(size_t)(row0 + r) * c + ch] =
            __float2bfloat16_rn(xs[r * c + ch] + (scratch[e] + __ldg(b2 + ch)));
    }
    __syncwarp();
  }
}

template <typename T>
__global__ void __launch_bounds__(NT) ffn_kernel(
    const T* __restrict__ x, const float* __restrict__ ln_scale,
    const float* __restrict__ ln_bias, const T* __restrict__ w1,
    const float* __restrict__ b1, const T* __restrict__ w2,
    const float* __restrict__ b2, T* __restrict__ out, int v, int c, int f,
    float eps, int use_mma) {
  using E = Elem<T>;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  float* xs = (float*)smem_raw;   // R x c
  T* ln = (T*)(xs + R * c);       // R x c
  T* hs = ln + R * c;             // R x f
  float* scratch = (float*)(hs + R * f) + (threadIdx.x >> 5) * 256;  // WMMA
  const int row0 = blockIdx.x * R;
  const int nrow = min(R, v - row0);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;

  for (int e = threadIdx.x; e < R * c; e += NT) {
    const int r = e / c;
    xs[e] = r < nrow ? E::load(x + (size_t)row0 * c + e) : 0.f;
  }
  __syncthreads();

  // LayerNorm: one warp per row
  for (int r = warp; r < R; r += NT / 32) {
    const float* xr = xs + r * c;
    float s = 0.f;
    for (int i = lane; i < c; i += 32) s += xr[i];
    for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
    const float mean = s / c;
    float q = 0.f;
    for (int i = lane; i < c; i += 32) { const float dd = xr[i] - mean; q += dd * dd; }
    for (int o = 16; o > 0; o >>= 1) q += __shfl_xor_sync(0xffffffffu, q, o);
    const float inv = rsqrtf(q / c + eps);
    for (int i = lane; i < c; i += 32)
      E::store(ln + r * c + i, (xr[i] - mean) * inv * __ldg(ln_scale + i) + __ldg(ln_bias + i));
  }
  __syncthreads();

  if constexpr (std::is_same<T, BF>::value) {
    if (use_mma) {
      ffn_mma(xs, ln, hs, scratch, w1, b1, w2, b2, out, row0, nrow, c, f);
      return;
    }
  }

  // FMA path. hidden = round(relu(LN W1 + b1)): thread per feature, all rows
  for (int j = threadIdx.x; j < f; j += NT) {
    float acc[R];
#pragma unroll
    for (int r = 0; r < R; ++r) acc[r] = 0.f;
    for (int i = 0; i < c; ++i) {
      const float wv = E::load(w1 + (size_t)i * f + j);
#pragma unroll
      for (int r = 0; r < R; ++r) acc[r] += E::load(ln + r * c + i) * wv;
    }
    const float bj = __ldg(b1 + j);
#pragma unroll
    for (int r = 0; r < R; ++r) E::store(hs + r * f + j, fmaxf(acc[r] + bj, 0.f));
  }
  __syncthreads();

  // out = x + (hidden W2 + b2): thread = (row lane, channel)
  const int lanes = NT / c;
  const int ch = threadIdx.x % c, tl = threadIdx.x / c;
  if (tl < lanes) {
    constexpr int MAXR = R;  // rows per thread <= R / lanes <= R
    float acc[MAXR];
#pragma unroll
    for (int u = 0; u < MAXR; ++u) acc[u] = 0.f;
    for (int j = 0; j < f; ++j) {
      const float wv = E::load(w2 + (size_t)j * c + ch);
#pragma unroll
      for (int u = 0; u < MAXR; ++u) {
        const int r = tl + u * lanes;
        if (r < R) acc[u] += E::load(hs + r * f + j) * wv;
      }
    }
    const float bc = __ldg(b2 + ch);
#pragma unroll
    for (int u = 0; u < MAXR; ++u) {
      const int r = tl + u * lanes;
      if (r < nrow) E::store(out + (size_t)(row0 + r) * c + ch, xs[r * c + ch] + (acc[u] + bc));
    }
  }
}

template <typename T>
int launch(const void* x, const float* s, const float* b, const void* w1,
           const float* b1, const void* w2, const float* b2, void* out, int v,
           int c, int f, float eps, cudaStream_t stream) {
  const int use_mma = std::is_same<T, BF>::value && c % 16 == 0 && f % 16 == 0;
  const size_t smem = (size_t)R * c * sizeof(float) + (size_t)R * c * sizeof(T) +
                      (size_t)R * f * sizeof(T) +
                      (use_mma ? NWARP * 256 * sizeof(float) : 0);
  if (smem > 227 * 1024) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      ffn_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  ffn_kernel<T><<<(v + R - 1) / R, NT, smem, stream>>>(
      (const T*)x, s, b, (const T*)w1, b1, (const T*)w2, b2, (T*)out, v, c, f, eps,
      use_mma);
  return launch_status();
}

}  // namespace

MSSVT_API int mssvt_ffn(const void* x, const float* ln_scale,
                        const float* ln_bias, const void* w1, const float* b1,
                        const void* w2, const float* b2, void* out, int v,
                        int c, int f, float eps, int is_bf16,
                        cudaStream_t stream) {
  if (c % 32 || c > NT || f % 32 || f > 1024) return (int)cudaErrorInvalidValue;
  if (v <= 0) return 0;
  return is_bf16 ? launch<__nv_bfloat16>(x, ln_scale, ln_bias, w1, b1, w2, b2, out, v, c, f, eps, stream)
                 : launch<float>(x, ln_scale, ln_bias, w1, b1, w2, b2, out, v, c, f, eps, stream);
}
