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
// Bound: at the card's peaks, device memory, narrowly: 4*C*F FLOP per row
// against 4*C bytes (bf16 in + out) is 256 FLOP/B at C=128, F=256, just
// below the bf16 tensor-core ridge (~295). So a row must be read once and
// written once, and the two products must run on the tensor cores without
// their operands or results leaving the SM.
//
// bf16 (ffn_mma_kernel, (C, F) = (128, 256) or (64, 128), the repo's
// configs): a persistent grid (the SMs x the CTAs an SM holds, from the
// occupancy API) whose CTAs copy W1 and W2 into shared memory once, rows
// padded by 16 bytes. Staging is the point here: one CTA a tile of 32 rows
// read all 128 KB of weights from L2 for every tile (~1.4 GB a launch at
// block 0 against the kernel's 184 MB). A fixed grid of walking CTAs was
// slower for the attention forwards, which stage nothing per CTA; here it
// is what lets the weights be read once. 219 KB of shared memory at
// C = 128 leave one CTA of eight warps an SM, so the CTA's two groups of
// four warps walk tiles of TR rows each on their own, with their own
// barriers: one group's LayerNorm and stores overlap the other's products
// (on an H100 at block 0 of mssvt.yaml, 0.199 ms against 0.218 for one
// group of eight warps on 64-row tiles). A group's tile arrives by
// 16-byte cp.async into a ring of two stages, so tile i + 1 loads while
// tile i computes. A warp normalises rows from registers (C/32 channels a
// lane, f32 statistics by shuffles) into a padded tile; both products are
// mma.sync m16n8k16 with ldmatrix fragments (B with .trans from the
// weights in flax's (in, out) layout), each warp owning the tile's rows x
// an N/4-column strip, and their epilogues run from the accumulators: +b1,
// relu, round into the padded hidden tile; +b2, + x, round over the x
// tile itself, which then leaves 16 bytes a thread.
//
// f32 (ffn_fma_kernel, any C % 32 == 0 <= 256, F % 32 == 0 <= 1024): one CTA
// a tile of 32 rows, FMA loops on the CUDA cores, register-blocked over the
// rows; it serves the tiny f32 configs and is not tuned.
#include <algorithm>

#include "attention_common.cuh"

namespace {

constexpr int GROUPS = 2;        // bf16: warp groups of a CTA
constexpr int GT = NT / GROUPS;  // threads of a group
constexpr int TR = 32;           // rows of a group's bf16 tile
constexpr int R = 32;            // rows of an f32 tile

__device__ __forceinline__ void cp16(void* s, const void* g, bool valid) {
  // 16 bytes global -> shared; zeros where !valid
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(smem_u32(s)), "l"(g), "r"(valid ? 16 : 0) : "memory");
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}
// Barrier of one warp group (named barrier 1 + group; 0 is __syncthreads').
__device__ __forceinline__ void group_sync(int group) {
  asm volatile("bar.sync %0, %1;\n" :: "r"(1 + group), "n"(GT) : "memory");
}

// Byte offsets of one bf16 CTA's shared memory; rows padded by 16 bytes so
// that ldmatrix and the epilogues' 4-byte accesses meet no bank conflict.
// A group's regions follow the other's: x ring, LN tile, hidden tile.
template <int C, int F>
struct FfnPlan {
  static constexpr int LDC = C + 8, LDF = F + 8;
  static constexpr int XR = 2 * TR, GR = GROUPS * TR;            // rows
  static constexpr size_t W1 = 0;                                // C x LDF
  static constexpr size_t W2 = W1 + (size_t)C * LDF * 2;         // F x LDC
  static constexpr size_t X = W2 + (size_t)F * LDC * 2;          // GROUPS x XR x LDC
  static constexpr size_t LN = X + (size_t)GROUPS * XR * LDC * 2;  // GR x LDC
  static constexpr size_t H = LN + (size_t)GR * LDC * 2;         // GR x LDF
  static constexpr size_t B1 = H + (size_t)GR * LDF * 2;         // F f32
  static constexpr size_t B2 = B1 + (size_t)F * 4;               // C f32
  static constexpr size_t TOTAL = B2 + (size_t)C * 4;
};

// Rows of g (row stride N elements) into shared memory (row stride ld),
// 16 bytes a thread of the nt threads from tid; rows at or past `valid` are
// zero-filled.
template <int N>
__device__ __forceinline__ void copy_rows(BF* s, int ld, const BF* g, int rows,
                                          int valid, int tid, int nt) {
  constexpr int N8 = N / 8;
  for (int e = tid; e < rows * N8; e += nt) {
    const int r = e / N8, c = (e % N8) * 8;
    const bool ok = r < valid;
    cp16(s + r * ld + c, g + (size_t)(ok ? r : 0) * N + c, ok);
  }
}

// LayerNorm of a group's tile: a warp takes TR / 4 rows at once, a lane
// C / 32 consecutive channels of each (one 8- or 4-byte shared load).
template <int C>
__device__ __forceinline__ void layer_norm_tile(const BF* xt, BF* ln,
                                                const float (&sc)[C / 32],
                                                const float (&bi)[C / 32],
                                                float eps, int warp, int lane) {
  constexpr int CPL = C / 32, RPW = TR * GROUPS / NWARP, LD = C + 8;
  static_assert(CPL == 2 || CPL == 4, "4 or 2 channels a lane");
  float v[RPW][CPL], s[RPW], q[RPW];
#pragma unroll
  for (int i = 0; i < RPW; ++i) {
    const BF* p = xt + (warp * RPW + i) * LD + lane * CPL;
    uint32_t w[CPL / 2];
    if constexpr (CPL == 4) {
      const uint2 u = *reinterpret_cast<const uint2*>(p);
      w[0] = u.x; w[1] = u.y;
    } else {
      w[0] = *reinterpret_cast<const uint32_t*>(p);
    }
    s[i] = 0.f;
#pragma unroll
    for (int j = 0; j < CPL / 2; ++j) {
      const float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w[j]));
      v[i][2 * j] = f.x;
      v[i][2 * j + 1] = f.y;
      s[i] += f.x + f.y;
    }
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
#pragma unroll
    for (int i = 0; i < RPW; ++i) s[i] += __shfl_xor_sync(0xffffffffu, s[i], o);
#pragma unroll
  for (int i = 0; i < RPW; ++i) {
    s[i] /= C;  // the mean
    q[i] = 0.f;
#pragma unroll
    for (int j = 0; j < CPL; ++j) {
      v[i][j] -= s[i];
      q[i] += v[i][j] * v[i][j];
    }
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
#pragma unroll
    for (int i = 0; i < RPW; ++i) q[i] += __shfl_xor_sync(0xffffffffu, q[i], o);
#pragma unroll
  for (int i = 0; i < RPW; ++i) {
    const float inv = rsqrtf(q[i] / C + eps);
    uint32_t w[CPL / 2];
#pragma unroll
    for (int j = 0; j < CPL / 2; ++j)
      w[j] = pack2(v[i][2 * j] * inv * sc[2 * j] + bi[2 * j],
                   v[i][2 * j + 1] * inv * sc[2 * j + 1] + bi[2 * j + 1]);
    BF* p = ln + (warp * RPW + i) * LD + lane * CPL;
    if constexpr (CPL == 4) *reinterpret_cast<uint2*>(p) = make_uint2(w[0], w[1]);
    else *reinterpret_cast<uint32_t*>(p) = w[0];
  }
}

// acc = A (TR x K, shared, row stride lda) x B (K x N, shared, row stride
// ldb) over the strip of warp `warp` (0-3) of a group: every row, columns
// (N / 4) * warp..; acc[m][j] is the m16n8 tile at row 16 m, column 8 j of
// the strip.
template <int K, int N>
__device__ __forceinline__ void strip_product(const BF* A, int lda, const BF* B,
                                              int ldb, int warp, int lane,
                                              float (&acc)[2][N / 32][4]) {
  static_assert(TR == 32, "two m16 row tiles a strip");
  constexpr int NT8 = N / 32;
  const int n0 = warp * (N / 4);
#pragma unroll
  for (int m = 0; m < 2; ++m)
#pragma unroll
    for (int j = 0; j < NT8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[m][j][e] = 0.f;
#pragma unroll 4
  for (int k = 0; k < K; k += 16) {
    uint32_t a0[4], a1[4];
    ldsm4(a0, addr_a(A, lda, 0, k, lane));
    ldsm4(a1, addr_a(A, lda, 16, k, lane));
#pragma unroll
    for (int j = 0; j < NT8 / 2; ++j) {
      uint32_t b[4];
      ldsm4t(b, addr_bt(B, ldb, n0 + 16 * j, k, lane));
      mma16816(acc[0][2 * j], a0, b[0], b[1]);
      mma16816(acc[0][2 * j + 1], a0, b[2], b[3]);
      mma16816(acc[1][2 * j], a1, b[0], b[1]);
      mma16816(acc[1][2 * j + 1], a1, b[2], b[3]);
    }
  }
}

template <int C, int F>
__global__ void __launch_bounds__(NT, 1) ffn_mma_kernel(
    const BF* __restrict__ x, const float* __restrict__ ln_scale,
    const float* __restrict__ ln_bias, const BF* __restrict__ w1,
    const float* __restrict__ b1, const BF* __restrict__ w2,
    const float* __restrict__ b2, BF* __restrict__ out, int v, float eps) {
  using P = FfnPlan<C, F>;
  constexpr int LDC = P::LDC, LDF = P::LDF;
  extern __shared__ __align__(128) unsigned char smem[];
  BF* sw1 = (BF*)(smem + P::W1);
  BF* sw2 = (BF*)(smem + P::W2);
  BF* sx = (BF*)(smem + P::X);
  BF* sln = (BF*)(smem + P::LN);
  BF* sh = (BF*)(smem + P::H);
  float* sb1 = (float*)(smem + P::B1);
  float* sb2 = (float*)(smem + P::B2);
  const int group = threadIdx.x / GT, gtid = threadIdx.x % GT;
  const int warp = gtid >> 5, lane = threadIdx.x & 31;  // warp of the group
  const int g_ = lane >> 2, t_ = lane & 3;
  const int ntiles = (v + TR - 1) / TR;
  sx += group * P::XR * LDC;
  sln += group * TR * LDC;
  sh += group * TR * LDF;

  // the weights once, with each group's first tile
  copy_rows<F>(sw1, LDF, w1, C, C, threadIdx.x, NT);
  copy_rows<C>(sw2, LDC, w2, F, F, threadIdx.x, NT);
  int tile = blockIdx.x * GROUPS + group;
  if (tile < ntiles)
    copy_rows<C>(sx, LDC, x + (size_t)tile * TR * C, TR, v - tile * TR, gtid, GT);
  cp_commit();
  for (int e = threadIdx.x; e < F; e += NT) sb1[e] = b1[e];
  for (int e = threadIdx.x; e < C; e += NT) sb2[e] = b2[e];
  float sc[C / 32], bi[C / 32];
#pragma unroll
  for (int j = 0; j < C / 32; ++j) {
    sc[j] = __ldg(ln_scale + lane * (C / 32) + j);
    bi[j] = __ldg(ln_bias + lane * (C / 32) + j);
  }

  cp_wait_all();
  __syncthreads();  // both groups read all of the weights

  for (int it = 0; tile < ntiles; ++it, tile += gridDim.x * GROUPS) {
    BF* xt = sx + (it & 1) * TR * LDC;
    const int row0 = tile * TR, nrow = min(TR, v - row0);
    // tile `it` has landed, and the other stage's rows have left
    cp_wait_all();
    group_sync(group);
    const int next = tile + gridDim.x * GROUPS;
    if (next < ntiles) {
      copy_rows<C>(sx + ((it + 1) & 1) * TR * LDC, LDC,
                   x + (size_t)next * TR * C, TR, v - next * TR, gtid, GT);
      cp_commit();
    }
    layer_norm_tile<C>(xt, sln, sc, bi, eps, warp, lane);
    group_sync(group);
    {  // hidden = round(relu(LN W1 + b1))
      float acc[2][F / 32][4];
      strip_product<C, F>(sln, LDC, sw1, LDF, warp, lane, acc);
      const int n0 = warp * (F / 4);
#pragma unroll
      for (int m = 0; m < 2; ++m)
#pragma unroll
        for (int j = 0; j < F / 32; ++j) {
          const int c = n0 + 8 * j + 2 * t_;
          const float2 b = *reinterpret_cast<const float2*>(sb1 + c);
          BF* o = sh + (16 * m + g_) * LDF + c;
          *(uint32_t*)o = pack2(fmaxf(acc[m][j][0] + b.x, 0.f), fmaxf(acc[m][j][1] + b.y, 0.f));
          *(uint32_t*)(o + 8 * LDF) =
              pack2(fmaxf(acc[m][j][2] + b.x, 0.f), fmaxf(acc[m][j][3] + b.y, 0.f));
        }
    }
    group_sync(group);
    {  // out = round(x + (hidden W2 + b2)), over the x tile (each element
       // read and written by the one thread that owns it)
      float acc[2][C / 32][4];
      strip_product<F, C>(sh, LDF, sw2, LDC, warp, lane, acc);
      const int n0 = warp * (C / 4);
#pragma unroll
      for (int m = 0; m < 2; ++m)
#pragma unroll
        for (int j = 0; j < C / 32; ++j) {
          const int c = n0 + 8 * j + 2 * t_;
          const float2 b = *reinterpret_cast<const float2*>(sb2 + c);
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            uint32_t* o = (uint32_t*)(xt + (16 * m + g_ + 8 * h) * LDC + c);
            const float2 xv = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(o));
            *o = pack2(xv.x + (acc[m][j][2 * h] + b.x), xv.y + (acc[m][j][2 * h + 1] + b.y));
          }
        }
    }
    group_sync(group);
    constexpr int C8 = C / 8;
    for (int e = gtid; e < nrow * C8; e += GT) {
      const int r = e / C8, c = (e % C8) * 8;
      *reinterpret_cast<uint4*>(out + (size_t)(row0 + r) * C + c) =
          *reinterpret_cast<const uint4*>(xt + r * LDC + c);
    }
  }
}

template <int C, int F>
int launch_mma(const void* x, const float* s, const float* b, const void* w1,
               const float* b1, const void* w2, const float* b2, void* out,
               int v, float eps, cudaStream_t stream) {
  const size_t smem = FfnPlan<C, F>::TOTAL;
  auto kernel = ffn_mma_kernel<C, F>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  int dev = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return (int)err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return (int)err;
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, NT, smem)) != cudaSuccess)
    return (int)err;
  if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  const int walkers = (v + TR - 1) / TR;  // a group's tiles, at most one each
  kernel<<<std::min((walkers + GROUPS - 1) / GROUPS, sms * per_sm), NT, smem, stream>>>(
      (const BF*)x, s, b, (const BF*)w1, b1, (const BF*)w2, b2, (BF*)out, v, eps);
  return launch_status();
}

// The f32 route: x, the LN output and the hidden tile in shared memory.
__global__ void __launch_bounds__(NT) ffn_fma_kernel(
    const float* __restrict__ x, const float* __restrict__ ln_scale,
    const float* __restrict__ ln_bias, const float* __restrict__ w1,
    const float* __restrict__ b1, const float* __restrict__ w2,
    const float* __restrict__ b2, float* __restrict__ out, int v, int c, int f,
    float eps) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  float* xs = (float*)smem_raw;  // R x c
  float* ln = xs + R * c;        // R x c
  float* hs = ln + R * c;        // R x f
  const int row0 = blockIdx.x * R;
  const int nrow = min(R, v - row0);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;

  for (int e = threadIdx.x; e < R * c; e += NT)
    xs[e] = e / c < nrow ? x[(size_t)row0 * c + e] : 0.f;
  __syncthreads();

  // LayerNorm: one warp per row
  for (int r = warp; r < R; r += NWARP) {
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
      ln[r * c + i] = (xr[i] - mean) * inv * __ldg(ln_scale + i) + __ldg(ln_bias + i);
  }
  __syncthreads();

  // hidden = relu(LN W1 + b1): thread per feature, all rows
  for (int j = threadIdx.x; j < f; j += NT) {
    float acc[R];
#pragma unroll
    for (int r = 0; r < R; ++r) acc[r] = 0.f;
    for (int i = 0; i < c; ++i) {
      const float wv = w1[(size_t)i * f + j];
#pragma unroll
      for (int r = 0; r < R; ++r) acc[r] += ln[r * c + i] * wv;
    }
    const float bj = __ldg(b1 + j);
#pragma unroll
    for (int r = 0; r < R; ++r) hs[r * f + j] = fmaxf(acc[r] + bj, 0.f);
  }
  __syncthreads();

  // out = x + (hidden W2 + b2): thread = (row lane, channel)
  const int lanes = NT / c;
  const int ch = threadIdx.x % c, tl = threadIdx.x / c;
  if (tl < lanes) {
    float acc[R];  // rows per thread <= R / lanes <= R
#pragma unroll
    for (int u = 0; u < R; ++u) acc[u] = 0.f;
    for (int j = 0; j < f; ++j) {
      const float wv = w2[(size_t)j * c + ch];
#pragma unroll
      for (int u = 0; u < R; ++u) {
        const int r = tl + u * lanes;
        if (r < R) acc[u] += hs[r * f + j] * wv;
      }
    }
    const float bc = __ldg(b2 + ch);
#pragma unroll
    for (int u = 0; u < R; ++u) {
      const int r = tl + u * lanes;
      if (r < nrow) out[(size_t)(row0 + r) * c + ch] = xs[r * c + ch] + (acc[u] + bc);
    }
  }
}

int launch_fma(const float* x, const float* s, const float* b, const float* w1,
               const float* b1, const float* w2, const float* b2, float* out,
               int v, int c, int f, float eps, cudaStream_t stream) {
  const size_t smem = (size_t)R * (2 * c + f) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      ffn_fma_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  ffn_fma_kernel<<<(v + R - 1) / R, NT, smem, stream>>>(x, s, b, w1, b1, w2, b2,
                                                         out, v, c, f, eps);
  return launch_status();
}

}  // namespace

// bf16 takes (C, F) = (128, 256) or (64, 128); f32 C % 32 == 0 <= 256 and
// F % 32 == 0 <= 1024.
MSSVT_API int mssvt_ffn(const void* x, const float* ln_scale,
                        const float* ln_bias, const void* w1, const float* b1,
                        const void* w2, const float* b2, void* out, int v,
                        int c, int f, float eps, int is_bf16,
                        cudaStream_t stream) {
  const bool mma128 = c == 128 && f == 256, mma64 = c == 64 && f == 128;
  const bool fma = c % 32 == 0 && c <= NT && f % 32 == 0 && f <= 1024;
  if (is_bf16 ? !(mma128 || mma64) : !fma) return (int)cudaErrorInvalidValue;
  if (v <= 0) return 0;
  if (!is_bf16)
    return launch_fma((const float*)x, ln_scale, ln_bias, (const float*)w1, b1,
                      (const float*)w2, b2, (float*)out, v, c, f, eps, stream);
  return mma128 ? launch_mma<128, 256>(x, ln_scale, ln_bias, w1, b1, w2, b2, out, v, eps, stream)
                : launch_mma<64, 128>(x, ln_scale, ln_bias, w1, b1, w2, b2, out, v, eps, stream);
}

// Shared memory of one bf16 CTA, the CTAs an SM holds (occupancy API) and
// its registers a thread, into out[0..2].
MSSVT_API int mssvt_ffn_plan(int c, int f, int* out) {
  if (c == 128 && f == 256)
    return plan_occupancy(ffn_mma_kernel<128, 256>, FfnPlan<128, 256>::TOTAL, out);
  if (c == 64 && f == 128)
    return plan_occupancy(ffn_mma_kernel<64, 128>, FfnPlan<64, 128>::TOTAL, out);
  return (int)cudaErrorInvalidValue;
}
