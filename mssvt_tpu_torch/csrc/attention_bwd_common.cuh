// Pieces shared by the attention backward kernels: K5, the backward of the
// assembled attention (attention_bwd.cu), and K7, the backward of the
// attention on pre-assembled tokens (attention_qk_bwd.cu). Both recompute
// the forward per window from the tokens in shared memory and run the same
// chain rule back with the JAX kernels' rounding points; they differ only in
// where the tokens come from and where dQ3/dK3 go. Here: the shared-memory
// plan, the per-window backward (WMMA tiles in bf16, FMA loops in f32), the
// split-K weight product over written-out operands and the fixed-order
// final sums (no float atomics: repeated calls are bit-identical).
#pragma once

#include "attention_common.cuh"

namespace {

constexpr int GT = 64;  // weight-product output tile (GT x GT)
constexpr int KC = 32;  // weight-product token rows per shared-memory stage

// Shared-memory plan of the per-window backward kernels (byte offsets,
// 128-aligned); the same code sizes the launch on the host. n1cap is K5's
// win1 capacity (0 for K7, which has no assembly tail). Regions are reused
// once dead:
//   tok:  q/k tokens -> dA (f32) -> dQ|dK|dV -> the tail's dwin1 sums (f32)
//   qkv:  Qp|Kp|Vp -> dQ3|dK3
//   gs:   g -> dS
//   ab:   A in the compute type (f32: A itself, no copy)
struct Plan {
  size_t tok, qkv, af, ab, gs, dout, cs, part, scratch, total;
  __host__ __device__ Plan(const Layout& L, int d, int n1cap, size_t es) {
    const size_t hq = (size_t)L.tot_heads * L.nqp * L.nk;
    const size_t rows = (size_t)(L.nqp + 2 * L.nk_tot) * d * es;
    const size_t r1[4] = {(size_t)(L.nqp + L.nk_tot) * d * es, hq * 4, rows,
                          (size_t)n1cap * d * 4};
    size_t m1 = 0;
    for (int i = 0; i < 4; ++i) m1 = r1[i] > m1 ? r1[i] : m1;
    const size_t g = (size_t)L.nqp * d * es, sds = hq * es;
    size_t o = 0;
    tok = o;  o += align128(m1);
    qkv = o;  o += align128(rows);
    af = o;   o += align128(hq * 4);
    ab = o;   o += es == 4 ? 0 : align128(hq * es);
    gs = o;   o += align128(g > sds ? g : sds);
    dout = o; o += align128(g);
    cs = o;   o += align128((size_t)4 * d * 4);
    part = o; o += align128((size_t)7 * d * 4);
    scratch = o;
    o += L.use_mma ? (size_t)NWARP * 256 * 4 : 0;
    total = o;
  }
};

// Softmax over each (head, query) row of the head's key stripe: Af keeps the
// f32 probabilities, Ab their rounding to the compute type.
template <typename T>
__device__ void softmax_rows(float* Af, T* Ab, const float* kb, const Layout& L,
                             float scale) {
  using E = Elem<T>;
  const int nk = L.nk;
  for (int row = threadIdx.x; row < L.tot_heads * L.nqp; row += NT) {
    float* sr = Af + (size_t)row * nk;
    const float* kbg = kb + L.head_group[row / L.nqp] * nk;
    float m = -INFINITY;
    for (int j = 0; j < nk; ++j) { sr[j] = sr[j] * scale + kbg[j]; m = fmaxf(m, sr[j]); }
    float sum = 0.f;
    for (int j = 0; j < nk; ++j) { const float ex = expf(sr[j] - m); sr[j] = ex; sum += ex; }
    const float den = sum + 1e-30f;
    for (int j = 0; j < nk; ++j) {
      const float p = sr[j] / den;
      sr[j] = p;
      E::store(Ab + (size_t)row * nk + j, p);
    }
  }
}

// WMMA epilogue of a column-strip product: rounds the 16x16 tile into `out`
// (shared, row stride d) and, for rows < grows, `gout` (global, row stride
// d); lanes 0-15 add their column's 16 unrounded values to `colsum`.
__device__ void strip_epilogue(const Frag& acc, float* scratch, BF* out,
                               BF* gout, int d, int r0, int c0, int grows,
                               float& colsum) {
  const int lane = threadIdx.x & 31;
  wm::store_matrix_sync(scratch, acc, 16, wm::mem_row_major);
  __syncwarp();
  if (lane < 16) {
    float s = 0.f;
    for (int r = 0; r < 16; ++r) s += scratch[r * 16 + lane];
    colsum += s;
  }
  for (int e = lane; e < 256; e += 32) {
    const int r = r0 + e / 16, c = c0 + e % 16;
    const BF v = __float2bfloat16_rn(scratch[e]);
    out[(size_t)r * d + c] = v;
    if (r < grows) gout[(size_t)r * d + c] = v;
  }
  __syncwarp();
}

__device__ void zero_tile(BF* out, BF* gout, int d, int r0, int c0) {
  const int lane = threadIdx.x & 31;
  for (int e = lane; e < 256; e += 32) {
    const int r = r0 + e / 16, c = c0 + e % 16;
    out[(size_t)r * d + c] = __float2bfloat16_rn(0.f);
    gout[(size_t)r * d + c] = __float2bfloat16_rn(0.f);
  }
}

using FragA = wm::fragment<wm::matrix_a, 16, 16, 16, BF, wm::row_major>;
using FragAc = wm::fragment<wm::matrix_a, 16, 16, 16, BF, wm::col_major>;
using FragB = wm::fragment<wm::matrix_b, 16, 16, 16, BF, wm::row_major>;
using FragBc = wm::fragment<wm::matrix_b, 16, 16, 16, BF, wm::col_major>;

// The products of the backward on the tensor cores (bf16, use_mma). Shared
// buffers as in window_backward; global outputs already offset to window w.
// `a` supplies w[4], scale, nq, d, groups (K5's or K7's arguments).
template <typename A>
__device__ void backward_mma(const A& a, const Layout& L, const BF* Qp,
                             const BF* Kp, const BF* Vp, const float* Af,
                             const BF* Ab, const BF* Gs, BF* dO, float* dA,
                             BF* dS, BF* dQ, BF* dK, BF* dV, BF* dQ3, BF* dK3,
                             float* cs, float* scratch, BF* dqs_g, BF* dks_g,
                             BF* dvs_g) {
  const int d = a.d, nq = a.nq, groups = a.groups;
  const int nk_tot = L.nk_tot, nk = L.nk, ph = L.ph, H = L.tot_heads, nqp = L.nqp;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int tq = nqp / 16, tk = nk / 16, tc = d / 16;
  const BF* W[4] = {(const BF*)a.w[0], (const BF*)a.w[1], (const BF*)a.w[2],
                    (const BF*)a.w[3]};
  // dO = round(G Wp^T), contracting each output channel's group block
  for (int t = warp; t < tq * tc; t += NWARP) {
    const int q0 = (t / tc) * 16, i0 = (t % tc) * 16;
    const int g = group_of(L, i0, groups);
    Frag acc;
    wm::fill_fragment(acc, 0.f);
    for (int c = L.gstart[g]; c < L.gstart[g + 1]; c += 16) {
      FragA fa; FragBc fb;
      wm::load_matrix_sync(fa, Gs + q0 * d + c, d);
      wm::load_matrix_sync(fb, W[3] + (size_t)i0 * d + c, d);
      wm::mma_sync(acc, fa, fb, acc);
    }
    tile_epilogue(acc, scratch, dO, d, q0, i0, nqp, nullptr);
  }
  __syncthreads();
  // dA_h = dO_h V_h^T over the head's channels and its group's key stripe
  for (int t = warp; t < H * tq * tk; t += NWARP) {
    const int h = t / (tq * tk), q0 = ((t / tk) % tq) * 16, j0 = (t % tk) * 16;
    const int key0 = L.head_group[h] * nk + j0;
    Frag acc;
    wm::fill_fragment(acc, 0.f);
    for (int c0 = 0; c0 < ph; c0 += 16) {
      FragA fa; FragBc fb;
      wm::load_matrix_sync(fa, dO + q0 * d + h * ph + c0, d);
      wm::load_matrix_sync(fb, Vp + key0 * d + h * ph + c0, d);
      wm::mma_sync(acc, fa, fb, acc);
    }
    wm::store_matrix_sync(dA + (h * nqp + q0) * nk + j0, acc, nk, wm::mem_row_major);
  }
  __syncthreads();
  // dS = round(A * (dA - rowsum(dA * A)) * scale)
  for (int row = threadIdx.x; row < H * nqp; row += NT) {
    const float* ar = Af + (size_t)row * nk;
    const float* dr = dA + (size_t)row * nk;
    float rs = 0.f;
    for (int j = 0; j < nk; ++j) rs += dr[j] * ar[j];
    for (int j = 0; j < nk; ++j)
      dS[(size_t)row * nk + j] = __float2bfloat16_rn(ar[j] * (dr[j] - rs) * a.scale);
  }
  __syncthreads();
  // dV, dQ, dK: each warp owns 16-column strips (inside one head), so the
  // bias cotangents (column sums of the f32 products) are summed by one warp
  for (int ct = warp; ct < tc; ct += NWARP) {
    const int c0 = ct * 16, h = c0 / ph, s0 = L.head_group[h] * nk;
    const BF* abh = Ab + (size_t)h * nqp * nk;
    const BF* dsh = dS + (size_t)h * nqp * nk;
    float cv = 0.f, cq = 0.f, ck = 0.f;
    for (int j0 = 0; j0 < nk_tot; j0 += 16) {  // dV = A^T dO
      if (j0 < s0 || j0 >= s0 + nk) { zero_tile(dV, dvs_g, d, j0, c0); continue; }
      Frag acc;
      wm::fill_fragment(acc, 0.f);
      for (int q0 = 0; q0 < nqp; q0 += 16) {
        FragAc fa; FragB fb;
        wm::load_matrix_sync(fa, abh + q0 * nk + (j0 - s0), nk);
        wm::load_matrix_sync(fb, dO + q0 * d + c0, d);
        wm::mma_sync(acc, fa, fb, acc);
      }
      strip_epilogue(acc, scratch, dV, dvs_g, d, j0, c0, nk_tot, cv);
    }
    for (int q0 = 0; q0 < nqp; q0 += 16) {  // dQ = dS K
      Frag acc;
      wm::fill_fragment(acc, 0.f);
      for (int jl = 0; jl < nk; jl += 16) {
        FragA fa; FragB fb;
        wm::load_matrix_sync(fa, dsh + q0 * nk + jl, nk);
        wm::load_matrix_sync(fb, Kp + (s0 + jl) * d + c0, d);
        wm::mma_sync(acc, fa, fb, acc);
      }
      strip_epilogue(acc, scratch, dQ, dqs_g, d, q0, c0, nq, cq);
    }
    for (int j0 = 0; j0 < nk_tot; j0 += 16) {  // dK = dS^T Q
      if (j0 < s0 || j0 >= s0 + nk) { zero_tile(dK, dks_g, d, j0, c0); continue; }
      Frag acc;
      wm::fill_fragment(acc, 0.f);
      for (int q0 = 0; q0 < nqp; q0 += 16) {
        FragAc fa; FragB fb;
        wm::load_matrix_sync(fa, dsh + q0 * nk + (j0 - s0), nk);
        wm::load_matrix_sync(fb, Qp + q0 * d + c0, d);
        wm::mma_sync(acc, fa, fb, acc);
      }
      strip_epilogue(acc, scratch, dK, dks_g, d, j0, c0, nk_tot, ck);
    }
    if (lane < 16) {
      cs[c0 + lane] = cq;
      cs[d + c0 + lane] = ck;
      cs[2 * d + c0 + lane] = cv;
    }
  }
  __syncthreads();
  // back through the projections (diagonal blocks of Wq, Wk, Wv)
  for (int t = warp; t < tq * tc; t += NWARP) {
    const int q0 = (t / tc) * 16, i0 = (t % tc) * 16;
    const int g = group_of(L, i0, groups);
    Frag acc;
    wm::fill_fragment(acc, 0.f);
    for (int c = L.gstart[g]; c < L.gstart[g + 1]; c += 16) {
      FragA fa; FragBc fb;
      wm::load_matrix_sync(fa, dQ + q0 * d + c, d);
      wm::load_matrix_sync(fb, W[0] + (size_t)i0 * d + c, d);
      wm::mma_sync(acc, fa, fb, acc);
    }
    tile_epilogue(acc, scratch, dQ3, d, q0, i0, nqp, nullptr);
  }
  for (int t = warp; t < (nk_tot / 16) * tc; t += NWARP) {
    const int j0 = (t / tc) * 16, i0 = (t % tc) * 16;
    const int g = group_of(L, i0, groups);
    Frag acc;
    wm::fill_fragment(acc, 0.f);
    for (int c = L.gstart[g]; c < L.gstart[g + 1]; c += 16) {
      FragA fa; FragBc fb;
      wm::load_matrix_sync(fa, dK + j0 * d + c, d);
      wm::load_matrix_sync(fb, W[1] + (size_t)i0 * d + c, d);
      wm::mma_sync(acc, fa, fb, acc);
    }
    for (int c = L.gstart[g]; c < L.gstart[g + 1]; c += 16) {
      FragA fa; FragBc fb;
      wm::load_matrix_sync(fa, dV + j0 * d + c, d);
      wm::load_matrix_sync(fb, W[2] + (size_t)i0 * d + c, d);
      wm::mma_sync(acc, fa, fb, acc);
    }
    tile_epilogue(acc, scratch, dK3, d, j0, i0, nk_tot, nullptr);
  }
}

// The same products as FMA loops (f32, or bf16 layouts the tiles do not
// fit); nqp == nq here. Column sums: one thread per column, in row order.
template <typename T, typename A>
__device__ void backward_fma(const A& a, const Layout& L, const T* Qp,
                             const T* Kp, const T* Vp, const float* Af,
                             const T* Ab, const T* Gs, T* dO, float* dA, T* dS,
                             T* dQ, T* dK, T* dV, T* dQ3, T* dK3, float* cs,
                             T* dqs_g, T* dks_g, T* dvs_g) {
  using E = Elem<T>;
  const int d = a.d, nq = a.nq, groups = a.groups;
  const int nk_tot = L.nk_tot, nk = L.nk, ph = L.ph, H = L.tot_heads;
  const T* W[4] = {(const T*)a.w[0], (const T*)a.w[1], (const T*)a.w[2],
                   (const T*)a.w[3]};
  for (int e = threadIdx.x; e < nq * d; e += NT) {  // dO = round(G Wp^T)
    const int q = e / d, i = e % d, g = group_of(L, i, groups);
    float acc = 0.f;
    for (int c = L.gstart[g]; c < L.gstart[g + 1]; ++c)
      acc += E::load(Gs + q * d + c) * E::load(W[3] + (size_t)i * d + c);
    E::store(dO + e, acc);
  }
  __syncthreads();
  for (int e = threadIdx.x; e < H * nq * nk; e += NT) {  // dA = dO_h V_h^T
    const int h = e / (nq * nk), q = (e / nk) % nq, j = e % nk;
    const int key = L.head_group[h] * nk + j;
    float acc = 0.f;
    for (int c = h * ph; c < (h + 1) * ph; ++c)
      acc += E::load(dO + q * d + c) * E::load(Vp + key * d + c);
    dA[e] = acc;
  }
  __syncthreads();
  for (int row = threadIdx.x; row < H * nq; row += NT) {
    const float* ar = Af + (size_t)row * nk;
    const float* dr = dA + (size_t)row * nk;
    float rs = 0.f;
    for (int j = 0; j < nk; ++j) rs += dr[j] * ar[j];
    for (int j = 0; j < nk; ++j) E::store(dS + (size_t)row * nk + j, ar[j] * (dr[j] - rs) * a.scale);
  }
  __syncthreads();
  for (int c = threadIdx.x; c < d; c += NT) {
    const int h = c / ph, s0 = L.head_group[h] * nk;
    const T* abh = Ab + (size_t)h * nq * nk;
    const T* dsh = dS + (size_t)h * nq * nk;
    float cv = 0.f, cq = 0.f, ck = 0.f;
    for (int j = 0; j < nk_tot; ++j) {
      float av = 0.f, ak = 0.f;
      if (j >= s0 && j < s0 + nk) {
        for (int q = 0; q < nq; ++q) {
          av += E::load(abh + q * nk + (j - s0)) * E::load(dO + q * d + c);
          ak += E::load(dsh + q * nk + (j - s0)) * E::load(Qp + q * d + c);
        }
      }
      cv += av;
      ck += ak;
      E::store(dV + j * d + c, av);
      E::store(dvs_g + (size_t)j * d + c, av);
      E::store(dK + j * d + c, ak);
      E::store(dks_g + (size_t)j * d + c, ak);
    }
    for (int q = 0; q < nq; ++q) {
      float acc = 0.f;
      for (int jl = 0; jl < nk; ++jl)
        acc += E::load(dsh + q * nk + jl) * E::load(Kp + (s0 + jl) * d + c);
      cq += acc;
      E::store(dQ + q * d + c, acc);
      E::store(dqs_g + (size_t)q * d + c, acc);
    }
    cs[c] = cq;
    cs[d + c] = ck;
    cs[2 * d + c] = cv;
  }
  __syncthreads();
  for (int e = threadIdx.x; e < nq * d; e += NT) {  // dQ3 = round(dQ Wq^T)
    const int q = e / d, i = e % d, g = group_of(L, i, groups);
    float acc = 0.f;
    for (int c = L.gstart[g]; c < L.gstart[g + 1]; ++c)
      acc += E::load(dQ + q * d + c) * E::load(W[0] + (size_t)i * d + c);
    E::store(dQ3 + e, acc);
  }
  for (int e = threadIdx.x; e < nk_tot * d; e += NT) {
    const int j = e / d, i = e % d, g = group_of(L, i, groups);
    float acc = 0.f;
    for (int c = L.gstart[g]; c < L.gstart[g + 1]; ++c)
      acc += E::load(dK + j * d + c) * E::load(W[1] + (size_t)i * d + c);
    for (int c = L.gstart[g]; c < L.gstart[g + 1]; ++c)
      acc += E::load(dV + j * d + c) * E::load(W[2] + (size_t)i * d + c);
    E::store(dK3 + e, acc);
  }
}

// Pointers into the shared memory of one per-window backward CTA (Plan).
template <typename T>
struct BwdSmem {
  T *tokq, *tokk, *Qp, *Kp, *Vp, *dQ3, *dK3, *Ab, *Gs, *dS, *dO, *dQ, *dK, *dV;
  float *dA, *Af, *cs, *part, *scratch;
  __device__ BwdSmem(unsigned char* smem_raw, const Plan& P, const Layout& L,
                     int d) {
    const int nqp = L.nqp, nk_tot = L.nk_tot;
    tokq = (T*)(smem_raw + P.tok);
    tokk = tokq + nqp * d;
    dA = (float*)(smem_raw + P.tok);  // after the projections
    Qp = (T*)(smem_raw + P.qkv);
    Kp = Qp + nqp * d;
    Vp = Kp + nk_tot * d;
    dQ3 = Qp;  // after dQ, dK, dV
    dK3 = dQ3 + nqp * d;
    Af = (float*)(smem_raw + P.af);
    Ab = (T*)(smem_raw + (sizeof(T) == 4 ? P.af : P.ab));
    Gs = (T*)(smem_raw + P.gs);
    dS = Gs;  // after dO
    dO = (T*)(smem_raw + P.dout);
    dQ = (T*)(smem_raw + P.tok);  // after dS
    dK = dQ + nqp * d;
    dV = dK + nk_tot * d;
    cs = (float*)(smem_raw + P.cs);      // dbq, dbk, dbv, dbp of a window
    part = (float*)(smem_raw + P.part);  // the CTA's partial sums
    scratch = (float*)(smem_raw + P.scratch) + (threadIdx.x >> 5) * 256;
  }
};

// One window's backward from its q/k tokens in shared memory (s.tokq, s.tokk;
// the caller has synchronised): recomputes the forward (projections, scores,
// softmax, the attention output O), then runs the chain rule back. Leaves
// dQ3 (nqp x d) and dK3 (nk_tot x d), the cotangents of the raw tokens, in
// s.dQ3/s.dK3 and the window's bias cotangents (dbq, dbk, dbv, dbp) in s.cs,
// and writes the weight-product operands round(dQ), round(dK), round(dV),
// round(O) to dqs/dks/dvs/os. Ends synchronised.
template <typename T, typename A>
__device__ __forceinline__ void window_backward(const A& a, const Layout& L,
                                                const BwdSmem<T>& s, const T* g,
                                                const float* kb, T* dqs, T* dks,
                                                T* dvs, T* os) {
  using E = Elem<T>;
  const int d = a.d, nq = a.nq;
  const int nk_tot = L.nk_tot, nk = L.nk, ph = L.ph, H = L.tot_heads, nqp = L.nqp;
  for (int e = threadIdx.x; e < nqp * d; e += NT) {
    if (e < nq * d) s.Gs[e] = g[e];
    else E::store(s.Gs + e, 0.f);
  }
  for (int c = threadIdx.x; c < d; c += NT) {  // dbp
    float sum = 0.f;
    for (int q = 0; q < nq; ++q) sum += E::load(g + q * d + c);
    s.cs[3 * d + c] = sum;
  }
  bool mma = false;
  if constexpr (std::is_same<T, BF>::value) {
    if (L.use_mma) {
      mma = true;
      project_mma(s.tokq, nqp, (const BF*)a.w[0], (const BF*)a.b[0], s.Qp, nqp, L, d, a.groups, s.scratch);
      project_mma(s.tokk, nk_tot, (const BF*)a.w[1], (const BF*)a.b[1], s.Kp, nk_tot, L, d, a.groups, s.scratch);
      project_mma(s.tokk, nk_tot, (const BF*)a.w[2], (const BF*)a.b[2], s.Vp, nk_tot, L, d, a.groups, s.scratch);
      __syncthreads();
      const int warp = threadIdx.x >> 5;
      const int tq = nqp / 16, tk = nk / 16;
      for (int t = warp; t < H * tq * tk; t += NWARP) {
        const int h = t / (tq * tk), q0 = ((t / tk) % tq) * 16, k0 = (t % tk) * 16;
        const int key0 = L.head_group[h] * nk + k0;
        Frag acc;
        wm::fill_fragment(acc, 0.f);
        for (int c0 = 0; c0 < ph; c0 += 16) {
          FragA fa; FragBc fb;
          wm::load_matrix_sync(fa, s.Qp + q0 * d + h * ph + c0, d);
          wm::load_matrix_sync(fb, s.Kp + key0 * d + h * ph + c0, d);
          wm::mma_sync(acc, fa, fb, acc);
        }
        wm::store_matrix_sync(s.Af + (h * nqp + q0) * nk + k0, acc, nk, wm::mem_row_major);
      }
      __syncthreads();
      softmax_rows<T>(s.Af, s.Ab, kb, L, a.scale);
      __syncthreads();
      const int tc = ph / 16;
      for (int t = warp; t < H * tq * tc; t += NWARP) {
        const int h = t / (tq * tc), q0 = ((t / tc) % tq) * 16, c0 = (t % tc) * 16;
        const int key0 = L.head_group[h] * nk;
        Frag acc;
        wm::fill_fragment(acc, 0.f);
        for (int k0 = 0; k0 < nk; k0 += 16) {
          FragA fa; FragB fb;
          wm::load_matrix_sync(fa, (const BF*)s.Ab + (h * nqp + q0) * nk + k0, nk);
          wm::load_matrix_sync(fb, (const BF*)s.Vp + (key0 + k0) * d + h * ph + c0, d);
          wm::mma_sync(acc, fa, fb, acc);
        }
        tile_epilogue(acc, s.scratch, (BF*)os, d, q0, h * ph + c0, nq, nullptr);
      }
      __syncthreads();
      backward_mma(a, L, s.Qp, s.Kp, s.Vp, s.Af, s.Ab, s.Gs, s.dO, s.dA, s.dS,
                   s.dQ, s.dK, s.dV, s.dQ3, s.dK3, s.cs, s.scratch, dqs, dks, dvs);
    }
  }
  if (!mma) {
    project<T>(s.tokq, nq, (const T*)a.w[0], (const T*)a.b[0], s.Qp, L, d, a.groups, nullptr);
    project<T>(s.tokk, nk_tot, (const T*)a.w[1], (const T*)a.b[1], s.Kp, L, d, a.groups, nullptr);
    project<T>(s.tokk, nk_tot, (const T*)a.w[2], (const T*)a.b[2], s.Vp, L, d, a.groups, nullptr);
    __syncthreads();
    for (int e = threadIdx.x; e < H * nq * nk; e += NT) {
      const int h = e / (nq * nk), qi = (e / nk) % nq, kj = e % nk;
      const int key = L.head_group[h] * nk + kj;
      float sc = 0.f;
      for (int c = h * ph; c < (h + 1) * ph; ++c)
        sc += E::load(s.Qp + qi * d + c) * E::load(s.Kp + key * d + c);
      s.Af[e] = sc;
    }
    __syncthreads();
    softmax_rows<T>(s.Af, s.Ab, kb, L, a.scale);
    __syncthreads();
    for (int e = threadIdx.x; e < nq * d; e += NT) {
      const int qi = e / d, c = e % d, h = c / ph;
      const int key0 = L.head_group[h] * nk;
      float acc = 0.f;
      for (int kj = 0; kj < nk; ++kj)
        acc += E::load(s.Ab + (h * nq + qi) * nk + kj) * E::load(s.Vp + (key0 + kj) * d + c);
      E::store(os + e, acc);
    }
    __syncthreads();
    backward_fma<T>(a, L, s.Qp, s.Kp, s.Vp, s.Af, s.Ab, s.Gs, s.dO, s.dA, s.dS,
                    s.dQ, s.dK, s.dV, s.dQ3, s.dK3, s.cs, dqs, dks, dvs);
  }
  __syncthreads();
}

struct WArgs {
  const void* x[4];  // q tokens, k tokens, k tokens, O
  const void* y[4];  // round(dQ), round(dK), round(dV), g
  int ntok[4];
  const int* num_valid;
  int nw, d, nsplit;
  float* wpart;  // (4, nsplit, d, d)
};

// dW_m = X_m^T Y_m over the token range of split blockIdx.y: each CTA one
// GT x GT output tile (blockIdx.x) of matrix blockIdx.z; f32 partial out.
template <typename T>
__global__ void __launch_bounds__(NT) wgrad_kernel(WArgs a) {
  using E = Elem<T>;
  __shared__ __align__(128) T Xs[KC * GT];
  __shared__ __align__(128) T Ys[KC * GT];
  const int m = blockIdx.z, s = blockIdx.y, d = a.d;
  const int tiles = (d + GT - 1) / GT;
  const int i0 = (blockIdx.x / tiles) * GT, j0 = (blockIdx.x % tiles) * GT;
  int nv = a.num_valid ? __ldg(a.num_valid) : a.nw;  // null: every window
  nv = nv < 0 ? 0 : (nv > a.nw ? a.nw : nv);
  const long rows = (long)nv * a.ntok[m];
  const long chunk = ((rows + a.nsplit - 1) / a.nsplit + KC - 1) / KC * KC;
  const long t0 = s * chunk, t1 = t0 + chunk < rows ? t0 + chunk : rows;
  const T* X = (const T*)a.x[m];
  const T* Y = (const T*)a.y[m];
  float* out = a.wpart + ((size_t)m * a.nsplit + s) * d * d;
  const int warp = threadIdx.x >> 5;
  // WMMA: warp w owns the 16-row stripe (w / 2) and 32 columns (w % 2) of
  // the tile; FMA: thread owns a 4 x 4 block
  Frag acc[2];
  float f[4][4];
  const bool mma = std::is_same<T, BF>::value && d % 16 == 0;
  const int ri = (warp >> 1) * 16, rj = (warp & 1) * 32;
  const int fi = (threadIdx.x / 16) * 4, fj = (threadIdx.x % 16) * 4;
  wm::fill_fragment(acc[0], 0.f);
  wm::fill_fragment(acc[1], 0.f);
  for (int u = 0; u < 4; ++u)
    for (int v = 0; v < 4; ++v) f[u][v] = 0.f;
  for (long tb = t0; tb < t1; tb += KC) {
    for (int e = threadIdx.x; e < KC * GT; e += NT) {
      const int r = e / GT, c = e % GT;
      const long t = tb + r;
      const bool ok = t < t1;
      if (ok && i0 + c < d) Xs[e] = X[t * d + i0 + c];
      else E::store(Xs + e, 0.f);
      if (ok && j0 + c < d) Ys[e] = Y[t * d + j0 + c];
      else E::store(Ys + e, 0.f);
    }
    __syncthreads();
    if constexpr (std::is_same<T, BF>::value) {
      if (mma) {
        for (int k = 0; k < KC; k += 16) {
          FragAc fa;
          wm::load_matrix_sync(fa, (const BF*)Xs + k * GT + ri, GT);
          for (int v = 0; v < 2; ++v) {
            FragB fb;
            wm::load_matrix_sync(fb, (const BF*)Ys + k * GT + rj + 16 * v, GT);
            wm::mma_sync(acc[v], fa, fb, acc[v]);
          }
        }
      }
    }
    if (!mma) {
      for (int k = 0; k < KC; ++k)
        for (int u = 0; u < 4; ++u) {
          const float xv = E::load(Xs + k * GT + fi + u);
          for (int v = 0; v < 4; ++v) f[u][v] += xv * E::load(Ys + k * GT + fj + v);
        }
    }
    __syncthreads();
  }
  if (mma) {
    for (int v = 0; v < 2; ++v) {
      const int ii = i0 + ri, jj = j0 + rj + 16 * v;
      if (ii < d && jj < d)
        wm::store_matrix_sync(out + (size_t)ii * d + jj, acc[v], d, wm::mem_row_major);
    }
  } else {
    for (int u = 0; u < 4; ++u)
      for (int v = 0; v < 4; ++v) {
        const int ii = i0 + fi + u, jj = j0 + fj + v;
        if (ii < d && jj < d) out[(size_t)ii * d + jj] = f[u][v];
      }
  }
}

// dw[m][i][j] = sum over splits (in order); db / dpos_w = sum over the CTA
// partials of npart rows each (4 bias rows, then K5's 3 dpos_w rows)
__global__ void finalize_kernel(const float* wpart, const float* cpart,
                                int nsplit, int ncta, int npart, int d,
                                float* dw, float* db, float* dposw) {
  const long e = (long)blockIdx.x * blockDim.x + threadIdx.x;
  const long nwt = 4L * d * d;
  if (e < nwt) {
    const long m = e / ((long)d * d), r = e % ((long)d * d);
    float s = 0.f;
    for (int sp = 0; sp < nsplit; ++sp) s += wpart[(m * nsplit + sp) * d * d + r];
    dw[e] = s;
  } else if (e < nwt + (long)npart * d) {
    const int k = (int)((e - nwt) / d), c = (int)((e - nwt) % d);
    float s = 0.f;
    for (int b = 0; b < ncta; ++b) s += cpart[((size_t)b * npart + k) * d + c];
    if (k < 4) db[k * d + c] = s;
    else dposw[(k - 4) * d + c] = s;
  }
}

// The weight product and the fixed-order sums, after the per-window kernel.
template <typename T>
int launch_wgrad_finalize(const WArgs& wa, const float* cpart, int ncta,
                          int npart, float* dw, float* db, float* dposw,
                          cudaStream_t stream) {
  const int tiles = (wa.d + GT - 1) / GT;
  wgrad_kernel<T><<<dim3(tiles * tiles, wa.nsplit, 4), NT, 0, stream>>>(wa);
  if (int st = launch_status()) return st;
  const long n = 4L * wa.d * wa.d + (long)npart * wa.d;
  finalize_kernel<<<(unsigned)((n + NT - 1) / NT), NT, 0, stream>>>(
      wa.wpart, cpart, wa.nsplit, ncta, npart, wa.d, dw, db, dposw);
  return launch_status();
}

}  // namespace
