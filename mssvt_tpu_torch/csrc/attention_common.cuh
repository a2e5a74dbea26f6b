// Pieces shared by the window-attention kernels: K3, the assembled forward
// (attention.cu), K5, its backward (attention_bwd.cu), K6, the forward on
// pre-assembled tokens (attention_qk.cu), and K7, its backward
// (attention_qk_bwd.cu; the backward's own shared pieces are in
// attention_bwd_common.cuh). Here: the head/group layout, the assembled
// input layout and its host-side parsing, the token assembly with the JAX
// kernel's bf16 rounding points (K3, K5), the token load (K6, K7), the
// block-diagonal projections (FMA loops and 16x16x16 WMMA tiles), and the
// per-window forward core from the tokens in shared memory to the output
// projection (K3, K6).
#pragma once

#include <mma.h>

#include <type_traits>

#include "common.h"

namespace {

constexpr int NT = 256;  // threads per CTA
constexpr int MAX_GROUPS = 4;
constexpr int RB = 8;    // tokens per thread in the FMA projection loops
constexpr int NWARP = NT / 32;
namespace wm = nvcuda::wmma;
using BF = __nv_bfloat16;
using Frag = wm::fragment<wm::accumulator, 16, 16, 16, float>;

// The assembled inputs of one call (the contract of
// fused_window_attention_assembled).
struct AsmIn {
  const void* win1; const void* k2; const int* fps1; const uint8_t* kmask;
  const void* q_ext; const float* q_keep;
  const float* krel[3]; const float* qrel[3];
  const void* base; const void* posw;
  const void* w[4];  // q, k, v, out projection (D x D, block diagonal)
  const void* b[4];
  const float* key_bias; const void* pad_row; const int* num_valid;
  int nw, n1cap, nk1, nk2, nq, d, groups, q_prefix;
  int heads[MAX_GROUPS];
  float scale;
};

struct Layout {
  int nk_tot, nk, ph, tot_heads;
  int nqp;      // query rows in shared memory (nq, padded to 16 for WMMA)
  int use_mma;  // bf16 with head width and key stripe multiples of 16
  int gstart[MAX_GROUPS + 1];  // channel start of each head group
  int head_group[64];
};

__host__ __device__ inline size_t align128(size_t x) {
  return (x + 127) & ~size_t(127);
}

// Head/group layout of d channels and nk_tot keys over `groups` head groups
// of heads[g] heads each. Returns a cudaError_t.
inline int derive_layout(int d, int nq, int nk_tot, int groups, const int* heads,
                         Layout& L) {
  int tot = 0;
  for (int g = 0; g < MAX_GROUPS; ++g) tot += g < groups ? heads[g] : 0;
  if (groups < 1 || groups > MAX_GROUPS || tot < 1 || tot > 64 || d % tot ||
      d % 32 || d > NT || nk_tot % groups || nq < 1)
    return (int)cudaErrorInvalidValue;
  L.tot_heads = tot;
  L.ph = d / tot;
  L.nk_tot = nk_tot;
  L.nk = nk_tot / groups;
  int h = 0, c = 0;
  for (int g = 0; g < groups; ++g) {
    L.gstart[g] = c;
    for (int j = 0; j < heads[g]; ++j) L.head_group[h++] = g;
    c += heads[g] * L.ph;
  }
  L.gstart[groups] = c;
  return 0;
}

// Fills the inputs from the pointer array (win1, k2, fps1, kmask, q_ext,
// q_keep, krel x3, qrel x3, base, posw, wq, wk, wv, wp, bq, bk, bv, bp,
// key_bias, pad_row, num_valid) and dims (nw, n1cap, nk1, nk2, nq, d, groups,
// q_prefix, heads[4]); derives the layout. Returns a cudaError_t.
inline int parse_inputs(const void* const* p, const int* dims, float scale,
                        AsmIn& a, Layout& L) {
  a.win1 = p[0]; a.k2 = p[1]; a.fps1 = (const int*)p[2];
  a.kmask = (const uint8_t*)p[3]; a.q_ext = p[4]; a.q_keep = (const float*)p[5];
  for (int i = 0; i < 3; ++i) { a.krel[i] = (const float*)p[6 + i]; a.qrel[i] = (const float*)p[9 + i]; }
  a.base = p[12]; a.posw = p[13];
  for (int i = 0; i < 4; ++i) { a.w[i] = p[14 + i]; a.b[i] = p[18 + i]; }
  a.key_bias = (const float*)p[22]; a.pad_row = p[23];
  a.num_valid = (const int*)p[24];
  a.nw = dims[0]; a.n1cap = dims[1]; a.nk1 = dims[2]; a.nk2 = dims[3];
  a.nq = dims[4]; a.d = dims[5]; a.groups = dims[6]; a.q_prefix = dims[7];
  a.scale = scale;
  for (int g = 0; g < MAX_GROUPS; ++g) a.heads[g] = g < a.groups ? dims[8 + g] : 0;
  return derive_layout(a.d, a.nq, a.nk1 + a.nk2, a.groups, a.heads, L);
}

// Tensor cores for bf16 when every tile lies inside one head and one stripe;
// query rows padded to 16 then.
template <typename T>
inline void set_mma(int d, int nq, Layout& L) {
  L.use_mma = std::is_same<T, BF>::value && d % 16 == 0 && L.ph % 16 == 0 &&
              L.nk % 16 == 0;
  L.nqp = L.use_mma ? (nq + 15) / 16 * 16 : nq;
}

__device__ __forceinline__ int group_of(const Layout& L, int c, int groups) {
  int g = 0;
  while (g + 1 < groups && c >= L.gstart[g + 1]) ++g;
  return g;
}

// Pre-relu position activation rx*w0 + ry*w1 + rz*w2 + base, rounded to the
// compute type after every op as the JAX kernel's bf16 ops are.
template <typename T>
__device__ __forceinline__ float pos_pre(float rx, float ry, float rz, float w0,
                                         float w1, float w2, float bs) {
  using E = Elem<T>;
  float pre = E::round(E::round(rx) * w0);
  pre = E::round(pre + E::round(E::round(ry) * w1));
  pre = E::round(pre + E::round(E::round(rz) * w2));
  return E::round(pre + bs);
}

// Assembles window w's tokens into shared memory: nq query rows (then zero
// rows up to nqp) followed by nk_tot key rows, each (row stride d)
//   q = raw * keep + relu(pos(q_rel)),  raw = win1[:nq] or q_ext
//   k = [pick of win1 (zero if masked/out of range; pad_row if masked and
//        pad_row is given) | k2] + relu(pos(k_rel))
template <typename T>
__device__ void assemble(const AsmIn& a, const Layout& L, int w, T* tokq) {
  using E = Elem<T>;
  const int d = a.d, nq = a.nq, nk1 = a.nk1, nqp = L.nqp, nk_tot = L.nk_tot;
  const T* win1 = (const T*)a.win1 + (size_t)w * a.n1cap * d;
  const T* k2 = (const T*)a.k2 + (size_t)w * a.nk2 * d;
  const T* posw = (const T*)a.posw;
  const T* base = (const T*)a.base + (size_t)w * d;
  for (int e = threadIdx.x; e < (nqp + nk_tot) * d; e += NT) {
    const int r = e / d, c = e % d;
    if (r >= nq && r < nqp) { E::store(tokq + e, 0.f); continue; }
    const float w0 = E::load(posw + c), w1 = E::load(posw + d + c),
                w2 = E::load(posw + 2 * d + c), bs = E::load(base + c);
    float rx, ry, rz, raw;
    if (r < nq) {
      const size_t pi = (size_t)w * nq + r;
      rx = a.qrel[0][pi]; ry = a.qrel[1][pi]; rz = a.qrel[2][pi];
      const float q0 = a.q_prefix
          ? E::load(win1 + (size_t)r * d + c)
          : E::load((const T*)a.q_ext + ((size_t)w * nq + r) * d + c);
      raw = E::round(q0 * E::round(a.q_keep[pi]));
    } else {
      const int j = r - nqp;
      const size_t pi = (size_t)w * nk_tot + j;
      rx = a.krel[0][pi]; ry = a.krel[1][pi]; rz = a.krel[2][pi];
      if (j < nk1) {
        const size_t mi = (size_t)w * nk1 + j;
        const int f = a.fps1[mi];
        const bool masked = a.kmask[mi] != 0;
        raw = 0.f;
        if (masked) {
          if (a.pad_row) raw = E::load((const T*)a.pad_row + (size_t)w * d + c);
        } else if (f >= 0 && f < a.n1cap) {
          raw = E::load(win1 + (size_t)f * d + c);
        }
      } else {
        raw = E::load(k2 + (size_t)(j - nk1) * d + c);
      }
    }
    const float pre = pos_pre<T>(rx, ry, rz, w0, w1, w2, bs);
    E::store(tokq + e, raw + fmaxf(pre, 0.f));
  }
}

// out[r][c] = round(sum_{i in group(c)} tok[r][i] * W[i][c] + b[c]) for
// r < ntok; tok and out live in shared memory (row stride d).
template <typename T>
__device__ void project(const T* tok, int ntok, const T* __restrict__ W,
                        const T* __restrict__ bvec, T* out, const Layout& L,
                        int d, int groups, T* gout) {
  using E = Elem<T>;
  const int lanes = NT / d;  // token lanes: thread = (lane tl, channel c)
  const int c = threadIdx.x % d, tl = threadIdx.x / d;
  if (tl < lanes) {
    const int g = group_of(L, c, groups);
    const int i0 = L.gstart[g], i1 = L.gstart[g + 1];
    const float bias = E::load(bvec + c);
    for (int r0 = tl * RB; r0 < ntok; r0 += lanes * RB) {
      float acc[RB];
#pragma unroll
      for (int u = 0; u < RB; ++u) acc[u] = 0.f;
      for (int i = i0; i < i1; ++i) {
        const float wv = E::load(W + (size_t)i * d + c);
#pragma unroll
        for (int u = 0; u < RB; ++u)
          if (r0 + u < ntok) acc[u] += E::load(tok + (r0 + u) * d + i) * wv;
      }
#pragma unroll
      for (int u = 0; u < RB; ++u)
        if (r0 + u < ntok) {
          const float v = acc[u] + bias;
          if (gout) E::store(gout + (size_t)(r0 + u) * d + c, v);
          else E::store(out + (r0 + u) * d + c, v);
        }
    }
  }
}

// WMMA helpers (bf16 inputs, f32 accumulation). Each warp owns whole 16x16
// output tiles; its accumulator goes through a private 16x16 f32 scratch so
// that bias and rounding are applied per element.
__device__ void tile_epilogue(const Frag& acc, float* scratch, BF* out, int ld,
                              int r0, int c0, int rows, const BF* bvec) {
  const int lane = threadIdx.x & 31;
  wm::store_matrix_sync(scratch, acc, 16, wm::mem_row_major);
  __syncwarp();
  for (int e = lane; e < 256; e += 32) {
    const int r = r0 + e / 16, c = c0 + e % 16;
    const float b = bvec ? __bfloat162float(bvec[c]) : 0.f;
    if (r < rows) out[(size_t)r * ld + c] = __float2bfloat16_rn(scratch[e] + b);
  }
  __syncwarp();
}

// out[r][c] = round(tok[r][group(c)] . W[group(c)][c] + b[c]) for r < rows,
// over ntok_pad (multiple of 16) token rows; only diagonal blocks multiply.
__device__ void project_mma(const BF* tok, int ntok_pad, const BF* W,
                            const BF* bvec, BF* out, int rows, const Layout& L,
                            int d, int groups, float* scratch) {
  const int warp = threadIdx.x >> 5;
  const int tc = d / 16;
  for (int t = warp; t < (ntok_pad / 16) * tc; t += NWARP) {
    const int r0 = (t / tc) * 16, c0 = (t % tc) * 16;
    const int g = group_of(L, c0, groups);
    Frag acc;
    wm::fill_fragment(acc, 0.f);
    for (int k0 = L.gstart[g]; k0 < L.gstart[g + 1]; k0 += 16) {
      wm::fragment<wm::matrix_a, 16, 16, 16, BF, wm::row_major> fa;
      wm::fragment<wm::matrix_b, 16, 16, 16, BF, wm::row_major> fb;
      wm::load_matrix_sync(fa, tok + r0 * d + k0, d);
      wm::load_matrix_sync(fb, W + (size_t)k0 * d + c0, d);
      wm::mma_sync(acc, fa, fb, acc);
    }
    tile_epilogue(acc, scratch, out, d, r0, c0, rows, bvec);
  }
}

// Copies window tokens that are already assembled (K6, K7) into shared
// memory: nq query rows (then zero rows up to nqp) followed by nk_tot key
// rows, 16 bytes a thread (d % 32 == 0 keeps every row a multiple of 16
// bytes; the wrapper checks the base pointers).
template <typename T>
__device__ void load_tokens(const T* gq, const T* gk, int nq, int nqp,
                            int nk_tot, int d, T* tokq) {
  constexpr int V = 16 / sizeof(T);
  const uint4* q4 = (const uint4*)gq;
  const uint4* k4 = (const uint4*)gk;
  uint4* tq4 = (uint4*)tokq;
  uint4* tk4 = (uint4*)(tokq + (size_t)nqp * d);
  const int nq4 = nq * d / V, nqp4 = nqp * d / V, nk4 = nk_tot * d / V;
  for (int e = threadIdx.x; e < nqp4; e += NT)
    tq4[e] = e < nq4 ? __ldg(q4 + e) : make_uint4(0u, 0u, 0u, 0u);
  for (int e = threadIdx.x; e < nk4; e += NT) tk4[e] = __ldg(k4 + e);
}

// Shared-memory plan of the forward kernels (byte offsets, 128-aligned);
// the same code sizes the launch on the host:
//   [0, r0): q/k tokens (T) | later scores (f32) + softmax weights (bf16)
//   [r0, ..): Qp (later O), Kp, Vp (T); per-warp 16x16 f32 scratch (WMMA)
struct FwdPlan {
  size_t s_bytes, r0, total;
  __host__ __device__ FwdPlan(const Layout& L, int d, size_t es) {
    const size_t hq = (size_t)L.tot_heads * L.nqp * L.nk;
    const size_t tok = (size_t)(L.nqp + L.nk_tot) * d * es;
    s_bytes = align128(hq * sizeof(float));
    const size_t sa = s_bytes + (L.use_mma ? hq * sizeof(BF) : 0);
    r0 = align128(tok > sa ? tok : sa);
    total = r0 + (size_t)(L.nqp + 2 * L.nk_tot) * d * es +
            (L.use_mma ? NWARP * 256 * sizeof(float) : 0);
  }
};

// The per-window forward from the tokens in shared memory (at sm.tokq, as
// assemble/load_tokens leave them; the caller has synchronised) to the
// output rows in global memory:
//   2. q/k/v projections with the block-diagonal weights, f32 accumulation,
//      + bias, rounded to T;
//   3. per head: scores against its own group's key stripe, * scale + kb,
//      softmax in f32, weights rounded to T, value product in f32;
//   4. output projection + bias, written in T.
// `a` supplies w[4], b[4], scale, nq, d, groups (AsmIn or the K6 inputs).
// Pointers into the shared memory of one forward CTA (FwdPlan). Built before
// the tokens are assembled or loaded: the compiler then keeps fewer
// registers live through the core (64 against 80 a thread in bf16).
template <typename T>
struct FwdSmem {
  T *tokq, *tokk, *Qp, *Kp, *Vp;
  float *S, *scratch;
  BF* A_;
  __device__ __forceinline__ FwdSmem(unsigned char* smem_raw, const Layout& L, int d) {
    const int nqp = L.nqp, nk_tot = L.nk_tot;
    const FwdPlan P(L, d, sizeof(T));
    tokq = (T*)smem_raw;
    tokk = tokq + nqp * d;
    S = (float*)smem_raw;
    A_ = (BF*)(smem_raw + P.s_bytes);
    Qp = (T*)(smem_raw + P.r0);
    Kp = Qp + nqp * d;
    Vp = Kp + nk_tot * d;
    scratch = (float*)(Vp + nk_tot * d) + (threadIdx.x >> 5) * 256;
  }
};

template <typename T, typename A>
__device__ __forceinline__ void attention_core(const A& a, const Layout& L,
                                               const FwdSmem<T>& sm,
                                               const float* kb, T* gout) {
  using E = Elem<T>;
  const int d = a.d, nq = a.nq;
  const int nk_tot = L.nk_tot, nk = L.nk, ph = L.ph, H = L.tot_heads;
  const int nqp = L.nqp;
  T* tokq = sm.tokq;
  T* tokk = sm.tokk;
  float* S = sm.S;
  BF* A_ = sm.A_;
  T* Qp = sm.Qp;
  T* Kp = sm.Kp;
  T* Vp = sm.Vp;
  float* scratch = sm.scratch;

  if constexpr (std::is_same<T, BF>::value) {
    if (L.use_mma) {
      // 2. projections on the tensor cores
      project_mma(tokq, nqp, (const BF*)a.w[0], (const BF*)a.b[0], Qp, nqp, L, d, a.groups, scratch);
      project_mma(tokk, nk_tot, (const BF*)a.w[1], (const BF*)a.b[1], Kp, nk_tot, L, d, a.groups, scratch);
      project_mma(tokk, nk_tot, (const BF*)a.w[2], (const BF*)a.b[2], Vp, nk_tot, L, d, a.groups, scratch);
      __syncthreads();
      // 3. per-head scores Q_h K_h^T over the head group's key stripe
      const int warp = threadIdx.x >> 5;
      const int tq = nqp / 16, tk = nk / 16;
      for (int t = warp; t < H * tq * tk; t += NWARP) {
        const int h = t / (tq * tk), q0 = ((t / tk) % tq) * 16, k0 = (t % tk) * 16;
        const int key0 = L.head_group[h] * nk + k0;
        wm::fragment<wm::accumulator, 16, 16, 16, float> acc;
        wm::fill_fragment(acc, 0.f);
        for (int c0 = 0; c0 < ph; c0 += 16) {
          wm::fragment<wm::matrix_a, 16, 16, 16, BF, wm::row_major> fa;
          wm::fragment<wm::matrix_b, 16, 16, 16, BF, wm::col_major> fb;
          wm::load_matrix_sync(fa, Qp + q0 * d + h * ph + c0, d);
          wm::load_matrix_sync(fb, Kp + key0 * d + h * ph + c0, d);
          wm::mma_sync(acc, fa, fb, acc);
        }
        wm::store_matrix_sync(S + (h * nqp + q0) * nk + k0, acc, nk, wm::mem_row_major);
      }
      __syncthreads();
      for (int row = threadIdx.x; row < H * nqp; row += NT) {
        float* sr = S + row * nk;
        const float* kbg = kb + L.head_group[row / nqp] * nk;
        float m = -INFINITY;
        for (int j = 0; j < nk; ++j) { sr[j] = sr[j] * a.scale + kbg[j]; m = fmaxf(m, sr[j]); }
        float sum = 0.f;
        for (int j = 0; j < nk; ++j) { const float ex = expf(sr[j] - m); sr[j] = ex; sum += ex; }
        const float inv = 1.f / (sum + 1e-30f);
        for (int j = 0; j < nk; ++j) A_[row * nk + j] = __float2bfloat16_rn(sr[j] * inv);
      }
      __syncthreads();
      // value products A_h V_h into O (aliases Qp, dead after the scores)
      BF* O = Qp;
      const int tc = ph / 16;
      for (int t = warp; t < H * tq * tc; t += NWARP) {
        const int h = t / (tq * tc), q0 = ((t / tc) % tq) * 16, c0 = (t % tc) * 16;
        const int key0 = L.head_group[h] * nk;
        wm::fragment<wm::accumulator, 16, 16, 16, float> acc;
        wm::fill_fragment(acc, 0.f);
        for (int k0 = 0; k0 < nk; k0 += 16) {
          wm::fragment<wm::matrix_a, 16, 16, 16, BF, wm::row_major> fa;
          wm::fragment<wm::matrix_b, 16, 16, 16, BF, wm::row_major> fb;
          wm::load_matrix_sync(fa, A_ + (h * nqp + q0) * nk + k0, nk);
          wm::load_matrix_sync(fb, Vp + (key0 + k0) * d + h * ph + c0, d);
          wm::mma_sync(acc, fa, fb, acc);
        }
        tile_epilogue(acc, scratch, O, d, q0, h * ph + c0, nqp, nullptr);
      }
      __syncthreads();
      // 4. output projection straight to global memory
      project_mma(O, nqp, (const BF*)a.w[3], (const BF*)a.b[3], (BF*)gout, nq, L, d, a.groups, scratch);
      return;
    }
  }

  // FMA path: 2. projections (block-diagonal: group channels only)
  project<T>(tokq, nq, (const T*)a.w[0], (const T*)a.b[0], Qp, L, d, a.groups, nullptr);
  project<T>(tokk, nk_tot, (const T*)a.w[1], (const T*)a.b[1], Kp, L, d, a.groups, nullptr);
  project<T>(tokk, nk_tot, (const T*)a.w[2], (const T*)a.b[2], Vp, L, d, a.groups, nullptr);
  __syncthreads();

  // 3. scores over each head's own key stripe, then row softmax
  for (int e = threadIdx.x; e < H * nq * nk; e += NT) {
    const int h = e / (nq * nk), qi = (e / nk) % nq, kj = e % nk;
    const int key = L.head_group[h] * nk + kj;
    const T* qrow = Qp + qi * d + h * ph;
    const T* krow = Kp + key * d + h * ph;
    float s = 0.f;
    for (int c = 0; c < ph; ++c) s += E::load(qrow + c) * E::load(krow + c);
    S[e] = s * a.scale + kb[key];
  }
  __syncthreads();
  for (int row = threadIdx.x; row < H * nq; row += NT) {
    float* sr = S + row * nk;
    float m = -INFINITY;
    for (int j = 0; j < nk; ++j) m = fmaxf(m, sr[j]);
    float sum = 0.f;
    for (int j = 0; j < nk; ++j) { const float ex = expf(sr[j] - m); sr[j] = ex; sum += ex; }
    const float inv = 1.f / (sum + 1e-30f);
    for (int j = 0; j < nk; ++j) sr[j] = E::round(sr[j] * inv);
  }
  __syncthreads();

  // value product into O (aliases Qp, dead after the scores)
  T* O = Qp;
  for (int e = threadIdx.x; e < nq * d; e += NT) {
    const int qi = e / d, c = e % d, h = c / ph;
    const int g = L.head_group[h];
    const float* ar = S + (h * nq + qi) * nk;
    float acc = 0.f;
    for (int kj = 0; kj < nk; ++kj) acc += ar[kj] * E::load(Vp + (g * nk + kj) * d + c);
    E::store(O + e, acc);
  }
  __syncthreads();

  // 4. output projection straight to global memory
  project<T>(O, nq, (const T*)a.w[3], (const T*)a.b[3], nullptr, L, d, a.groups, gout);
}

}  // namespace
