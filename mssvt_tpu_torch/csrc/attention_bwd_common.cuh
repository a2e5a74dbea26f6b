// Pieces shared by the attention backward kernels: K5, the backward of the
// assembled attention (attention_bwd.cu), and K7, the backward of the
// attention on pre-assembled tokens (attention_qk_bwd.cu). Both recompute
// the forward per window from the tokens in shared memory and run the same
// chain rule back with the JAX kernels' rounding points; they differ only in
// where the tokens come from and where dQ3/dK3 go.
//
// What bounds them on an H100: on paper device memory (a window's tokens and
// g read once, its cotangents written once); in fact the latency of many
// small dependent phases, since a window's products are far too small to
// fill an SM. The design therefore
//   - runs the bf16 products as mma.sync m16n8k16 tiles whose documented
//     register layout lets every epilogue (bias, rounding, stores, column
//     sums) happen from registers; rows in shared memory are padded by 16
//     bytes so ldmatrix reads meet no bank conflict;
//   - gives each warp a whole (head, 16-query) unit for scores, softmax, O,
//     dA, dS and dQ, with the row reductions as quad shuffles, and a (head,
//     16-key) unit for dV and dK: four block barriers inside a window's
//     backward, none inside a phase;
//   - keeps the per-window kernel at <= 113 KB of shared memory and <= 128
//     registers, so that two CTAs share an SM and one's global loads overlap
//     the other's arithmetic;
//   - writes the weight-product operands once, 16 bytes a thread, and
//     multiplies them in a second kernel in which one CTA owns the whole
//     D x D tile of one matrix for its row range (every operand byte read
//     once; wgmma m64n128k16 from a cp.async ring at D = 128);
//   - sums everything that crosses windows in a fixed order (per-CTA
//     partials walked in window order, split partials summed in order): no
//     float atomics, bit-identical on repeat, independent of the SM count.
// The f32 path, and bf16 layouts the tiles do not fit, run FMA loops. The
// tensor-core primitives, the row copies, the strip projections and the
// (head, 16 queries) unit from the scores to O are attention_common.cuh's,
// shared with the forwards.
#pragma once

#include "attention_common.cuh"

namespace {

constexpr int GT = 64;       // FMA weight-product output tile (GT x GT)
constexpr int KC = 32;       // FMA weight-product token rows per stage
constexpr int WG_ROWS = 64;  // wgmma weight product: token rows per stage
constexpr int WG_STAGES = 4;
constexpr int WG_D = 128;    // the width the wgmma weight product is built for

// ------------------------------------------------------ shared-memory plan
// Byte offsets (128-aligned) of the per-window backward kernels; the same
// code sizes the launch on the host. Token rows have stride ld (d + 8
// elements on the mma path, d else), probability rows stride lda (nk + 8 or
// nk). tail_bytes are the partial sums of K5's assembly tail and stage_bytes
// its staged planes (both 0 for K7). Regions are reused once dead:
//   tokq:  q tokens -> O (until written out) -> dQ3
//   tokk:  k tokens -> dQ (first nqp rows); with dO behind it the partial
//          sums of K5's tail
//   kp/vp: Kp, Vp -> dK, dV
//   gs:    g -> dS; with ab (and af, daf) behind it: dK3
struct Plan {
  int ld, lda;
  size_t tokq, tokk, dout, qp, kp, vp, gs, ab, af, daf, colp, part, stage, total;
  __host__ __device__ Plan(const Layout& L, int d, size_t tail_bytes,
                           size_t stage_bytes, size_t es) {
    const bool mma = L.use_mma;
    ld = mma ? d + 8 : d;
    lda = mma ? L.nk + 8 : L.nk;
    const size_t hq = (size_t)L.tot_heads * L.nqp;
    const size_t qrows = align128((size_t)L.nqp * ld * es);
    const size_t krows = align128((size_t)L.nk_tot * ld * es);
    const size_t probs = align128(hq * lda * es);
    size_t o = 0;
    tokq = o; o += qrows;
    const size_t kq = krows > qrows ? krows : qrows;  // k tokens, later dQ
    tokk = o; o += kq;
    dout = o; o += tail_bytes > kq + qrows ? align128(tail_bytes - kq) : qrows;
    qp = o;   o += qrows;
    kp = o;   o += krows;
    vp = o;   o += krows;
    gs = o;   o += qrows > probs ? qrows : probs;
    ab = o;   o += mma || es == 2 ? probs : 0;  // f32: A itself, no copy
    af = o;   o += mma ? 0 : align128(hq * L.nk * 4);
    daf = o;  o += mma ? 0 : align128(hq * L.nk * 4);
    if (o - gs < krows) o = gs + krows;  // dK3 spans gs..
    const size_t ntile = L.nqp / 16 + 2 * (L.nk / 16);
    colp = o; o += align128((mma ? ntile : 3) * d * 4);
    part = o; o += align128((size_t)7 * d * 4);
    stage = o; o += align128(stage_bytes);
    total = o;
  }
};

// Pointers into the shared memory of one per-window backward CTA (Plan).
template <typename T>
struct BwdSmem {
  int ld, lda;
  T *tokq, *tokk, *Os, *dQ, *dO, *Qp, *Kp, *Vp, *dK, *dV, *Gs, *dS, *Ab, *dQ3, *dK3;
  float *Af, *dA, *colp, *part, *tail;
  unsigned char* stage;
  __device__ BwdSmem(unsigned char* smem_raw, const Plan& P) {
    ld = P.ld; lda = P.lda;
    tokq = (T*)(smem_raw + P.tokq);
    tokk = (T*)(smem_raw + P.tokk);
    Os = tokq;   // after the projections
    dQ3 = tokq;  // after O is written out
    dQ = tokk;   // after the projections
    tail = (float*)(smem_raw + P.tokk);  // K5's assembly tail
    dO = (T*)(smem_raw + P.dout);
    Qp = (T*)(smem_raw + P.qp);
    Kp = (T*)(smem_raw + P.kp);
    Vp = (T*)(smem_raw + P.vp);
    dK = Kp;  // after dQ
    dV = Vp;
    Gs = (T*)(smem_raw + P.gs);
    dS = Gs;   // after dO
    dK3 = Gs;  // after dK, dV
    Af = (float*)(smem_raw + P.af);
    Ab = (T*)(smem_raw + (P.ab == P.af && sizeof(T) == 4 ? P.af : P.ab));
    dA = (float*)(smem_raw + P.daf);
    colp = (float*)(smem_raw + P.colp);  // column-sum partials of a window
    part = (float*)(smem_raw + P.part);  // the CTA's partial sums
    stage = smem_raw + P.stage;
  }
};

// ------------------------------------------------------------- the FMA path
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

// One window's backward as FMA loops (f32, or bf16 layouts the tiles do not
// fit); nqp == nq, ld == d, lda == nk. Contract as window_backward below;
// the operands go straight to global memory.
template <typename T, typename A>
__device__ void window_backward_fma(const A& a, const Layout& L,
                                    const BwdSmem<T>& s, const float* kb,
                                    T* dqs_g, T* dks_g, T* dvs_g, T* os_g) {
  using E = Elem<T>;
  const int d = a.d, nq = a.nq, groups = a.groups;
  const int nk_tot = L.nk_tot, nk = L.nk, ph = L.ph, H = L.tot_heads;
  const T* W[4] = {(const T*)a.w[0], (const T*)a.w[1], (const T*)a.w[2],
                   (const T*)a.w[3]};
  for (int c = threadIdx.x; c < d; c += NT) {  // dbp
    float sum = 0.f;
    for (int q = 0; q < nq; ++q) sum += E::load(s.Gs + q * d + c);
    s.part[3 * d + c] += sum;
  }
  project<T>(s.tokq, nq, W[0], (const T*)a.b[0], s.Qp, L, d, groups, nullptr);
  project<T>(s.tokk, nk_tot, W[1], (const T*)a.b[1], s.Kp, L, d, groups, nullptr);
  project<T>(s.tokk, nk_tot, W[2], (const T*)a.b[2], s.Vp, L, d, groups, nullptr);
  for (int e = threadIdx.x; e < nq * d; e += NT) {  // dO = round(G Wp^T)
    const int q = e / d, i = e % d, g = group_of(L, i, groups);
    float acc = 0.f;
    for (int c = L.gstart[g]; c < L.gstart[g + 1]; ++c)
      acc += E::load(s.Gs + q * d + c) * E::load(W[3] + (size_t)i * d + c);
    E::store(s.dO + e, acc);
  }
  __syncthreads();
  for (int e = threadIdx.x; e < H * nq * nk; e += NT) {
    const int h = e / (nq * nk), qi = (e / nk) % nq, kj = e % nk;
    const int key = L.head_group[h] * nk + kj;
    float sc = 0.f, da = 0.f;
    for (int c = h * ph; c < (h + 1) * ph; ++c) {
      sc += E::load(s.Qp + qi * d + c) * E::load(s.Kp + key * d + c);
      da += E::load(s.dO + qi * d + c) * E::load(s.Vp + key * d + c);
    }
    s.Af[e] = sc;
    s.dA[e] = da;  // dA = dO_h V_h^T
  }
  __syncthreads();
  softmax_rows<T>(s.Af, s.Ab, kb, L, a.scale);
  __syncthreads();
  for (int e = threadIdx.x; e < nq * d; e += NT) {  // O = A V
    const int qi = e / d, c = e % d, h = c / ph;
    const int key0 = L.head_group[h] * nk;
    float acc = 0.f;
    for (int kj = 0; kj < nk; ++kj)
      acc += E::load(s.Ab + (h * nq + qi) * nk + kj) * E::load(s.Vp + (key0 + kj) * d + c);
    E::store(os_g + e, acc);
  }
  // dS = round(A * (dA - rowsum(dA * A)) * scale), over g (dead after dO)
  for (int row = threadIdx.x; row < H * nq; row += NT) {
    const float* ar = s.Af + (size_t)row * nk;
    const float* dr = s.dA + (size_t)row * nk;
    float rs = 0.f;
    for (int j = 0; j < nk; ++j) rs += dr[j] * ar[j];
    for (int j = 0; j < nk; ++j) E::store(s.dS + (size_t)row * nk + j, ar[j] * (dr[j] - rs) * a.scale);
  }
  __syncthreads();
  // dQ, then dK and dV over Kp and Vp: one thread per column, in row order,
  // so a column's projections are read before they are written over
  for (int c = threadIdx.x; c < d; c += NT) {
    const int h = c / ph, s0 = L.head_group[h] * nk;
    const T* abh = s.Ab + (size_t)h * nq * nk;
    const T* dsh = s.dS + (size_t)h * nq * nk;
    float cv = 0.f, cq = 0.f, ck = 0.f;
    for (int q = 0; q < nq; ++q) {
      float acc = 0.f;
      for (int jl = 0; jl < nk; ++jl)
        acc += E::load(dsh + q * nk + jl) * E::load(s.Kp + (s0 + jl) * d + c);
      cq += acc;
      E::store(s.dQ + q * d + c, acc);
      E::store(dqs_g + (size_t)q * d + c, acc);
    }
    for (int j = 0; j < nk_tot; ++j) {
      float av = 0.f, ak = 0.f;
      if (j >= s0 && j < s0 + nk) {
        for (int q = 0; q < nq; ++q) {
          av += E::load(abh + q * nk + (j - s0)) * E::load(s.dO + q * d + c);
          ak += E::load(dsh + q * nk + (j - s0)) * E::load(s.Qp + q * d + c);
        }
      }
      cv += av;
      ck += ak;
      E::store(s.dV + j * d + c, av);
      E::store(dvs_g + (size_t)j * d + c, av);
      E::store(s.dK + j * d + c, ak);
      E::store(dks_g + (size_t)j * d + c, ak);
    }
    s.part[c] += cq;
    s.part[d + c] += ck;
    s.part[2 * d + c] += cv;
  }
  __syncthreads();
  for (int e = threadIdx.x; e < nq * d; e += NT) {  // dQ3 = round(dQ Wq^T)
    const int q = e / d, i = e % d, g = group_of(L, i, groups);
    float acc = 0.f;
    for (int c = L.gstart[g]; c < L.gstart[g + 1]; ++c)
      acc += E::load(s.dQ + q * d + c) * E::load(W[0] + (size_t)i * d + c);
    E::store(s.dQ3 + e, acc);
  }
  for (int e = threadIdx.x; e < nk_tot * d; e += NT) {
    const int j = e / d, i = e % d, g = group_of(L, i, groups);
    float acc = 0.f;
    for (int c = L.gstart[g]; c < L.gstart[g + 1]; ++c)
      acc += E::load(s.dK + j * d + c) * E::load(W[1] + (size_t)i * d + c);
    for (int c = L.gstart[g]; c < L.gstart[g + 1]; ++c)
      acc += E::load(s.dV + j * d + c) * E::load(W[2] + (size_t)i * d + c);
    E::store(s.dK3 + e, acc);
  }
  __syncthreads();
}

// ------------------------------------------------------------- the mma path
// Sum of a 16-row accumulator tile's columns: rows g then g + 8 in the
// thread, then the eight row lanes by xor shuffles (a fixed tree). Lanes
// 0-3 end with the sums of columns 2t (lo) and 2t + 1 (hi).
__device__ __forceinline__ void column_sums(const float (&c)[4], float& lo, float& hi) {
  lo = c[0] + c[2];
  hi = c[1] + c[3];
#pragma unroll
  for (int m = 4; m < 32; m <<= 1) {
    lo += __shfl_xor_sync(0xffffffffu, lo, m);
    hi += __shfl_xor_sync(0xffffffffu, hi, m);
  }
}

// One window's backward on the tensor cores (bf16, L.use_mma). `wt` are the
// q, k, v projection weights transposed ([output][input] channel), so that
// every weight fragment is two 4-byte global loads.
template <typename A>
__device__ void window_backward_mma(const A& a, const Layout& L,
                                    const BwdSmem<BF>& s, const float* kb,
                                    BF* dqs_g, BF* os_g) {
  const int d = a.d, nq = a.nq, groups = a.groups, ld = s.ld, lda = s.lda;
  const int nk_tot = L.nk_tot, nk = L.nk, ph = L.ph, H = L.tot_heads, nqp = L.nqp;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g_ = lane >> 2, t_ = lane & 3;
  const int tq = nqp / 16, tk = nk / 16;
  float* colq = s.colp;                 // [tq][d]
  float* colk = colq + (size_t)tq * d;  // [tk][d]
  float* colv = colk + (size_t)tk * d;  // [tk][d]

  // 1. dbp from g's columns; the projections Qp, Kp, Vp and dO = round(G Wp^T)
  for (int c = threadIdx.x; c < d; c += NT) {
    float sum = 0.f;
    for (int q = 0; q < nq; ++q) sum += __bfloat162float(s.Gs[(size_t)q * ld + c]);
    s.part[3 * d + c] += sum;
  }
  project_strips(s.tokq, (const BF*)a.wt[0], nullptr, nullptr, (const BF*)a.b[0], s.Qp, nqp, ld, L, d, groups);
  project_strips(s.tokk, (const BF*)a.wt[1], nullptr, nullptr, (const BF*)a.b[1], s.Kp, nk_tot, ld, L, d, groups);
  project_strips(s.tokk, (const BF*)a.wt[2], nullptr, nullptr, (const BF*)a.b[2], s.Vp, nk_tot, ld, L, d, groups);
  project_strips(s.Gs, (const BF*)a.w[3], nullptr, nullptr, nullptr, s.dO, nqp, ld, L, d, groups);
  __syncthreads();

  // 2. per (head, 16 queries), in one warp: scores, softmax, O, dA, dS, dQ
  for (int u = warp; u < H * tq; u += NWARP) {
    const int h = u / tq, q0 = (u % tq) * 16;
    const int key0 = L.head_group[h] * nk, ch0 = h * ph;
    float p[MAXNKT][4];
    uint32_t pa[MAXNKT / 2][4];  // round(P) as A fragments (k = keys)
    unit_softmax(s.Qp, s.Kp, ld, q0, ch0, key0, nk, ph, kb, a.scale, lane, p);
    unit_pack(p, nk, pa);
    BF* abr = s.Ab + (size_t)(h * nqp + q0 + g_) * lda + 2 * t_;
#pragma unroll
    for (int j = 0; j < MAXNKT; ++j) {
      if (j * 8 < nk) {
        *(uint32_t*)(abr + j * 8) = pa[j / 2][(j & 1) * 2];
        *(uint32_t*)(abr + (size_t)8 * lda + j * 8) = pa[j / 2][(j & 1) * 2 + 1];
      }
    }
    unit_value(pa, s.Vp, s.Os, ld, q0, ch0, key0, nk, ph, lane);
    float da[MAXNKT][4];  // dA = dO_h V_h^T
#pragma unroll
    for (int j = 0; j < MAXNKT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) da[j][e] = 0.f;
    for (int c = 0; c < ph; c += 16) {
      uint32_t af[4];
      ldsm4(af, addr_a(s.dO, ld, q0, ch0 + c, lane));
#pragma unroll
      for (int jp = 0; jp < MAXNKT / 2; ++jp) {
        if (jp * 16 < nk) {
          uint32_t bf[4];
          ldsm4(bf, addr_b(s.Vp, ld, key0 + jp * 16, ch0 + c, lane));
          mma16816(da[2 * jp], af, bf[0], bf[1]);
          mma16816(da[2 * jp + 1], af, bf[2], bf[3]);
        }
      }
    }
    // dS = round(P * (dA - rowsum(dA * P)) * scale)
    float r0 = 0.f, r1 = 0.f;
#pragma unroll
    for (int j = 0; j < MAXNKT; ++j) {
      if (j * 8 < nk) {
        r0 += da[j][0] * p[j][0] + da[j][1] * p[j][1];
        r1 += da[j][2] * p[j][2] + da[j][3] * p[j][3];
      }
    }
    r0 = quad_sum(r0);
    r1 = quad_sum(r1);
    uint32_t dsa[MAXNKT / 2][4];
    BF* dsr = s.dS + (size_t)(h * nqp + q0 + g_) * lda + 2 * t_;
#pragma unroll
    for (int j = 0; j < MAXNKT; ++j) {
      if (j * 8 < nk) {
        const uint32_t lo = pack2(p[j][0] * (da[j][0] - r0) * a.scale,
                                  p[j][1] * (da[j][1] - r0) * a.scale);
        const uint32_t hi = pack2(p[j][2] * (da[j][2] - r1) * a.scale,
                                  p[j][3] * (da[j][3] - r1) * a.scale);
        dsa[j / 2][(j & 1) * 2] = lo;
        dsa[j / 2][(j & 1) * 2 + 1] = hi;
        *(uint32_t*)(dsr + j * 8) = lo;
        *(uint32_t*)(dsr + (size_t)8 * lda + j * 8) = hi;
      }
    }
    for (int c = 0; c < ph; c += 16) {  // dQ = dS K_h
      float o[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
#pragma unroll
      for (int jp = 0; jp < MAXNKT / 2; ++jp) {
        if (jp * 16 < nk) {
          uint32_t bf[4];
          ldsm4t(bf, addr_bt(s.Kp, ld, ch0 + c, key0 + jp * 16, lane));
          mma16816(o[0], dsa[jp], bf[0], bf[1]);
          mma16816(o[1], dsa[jp], bf[2], bf[3]);
        }
      }
#pragma unroll
      for (int n = 0; n < 2; ++n) {
        const int col = ch0 + c + 8 * n + 2 * t_;
        float lo, hi;
        column_sums(o[n], lo, hi);
        if (lane < 4) {
          colq[(size_t)(q0 / 16) * d + col] = lo;
          colq[(size_t)(q0 / 16) * d + col + 1] = hi;
        }
        BF* op = s.dQ + (size_t)(q0 + g_) * ld + col;
        *(uint32_t*)op = pack2(o[n][0], o[n][1]);
        *(uint32_t*)(op + (size_t)8 * ld) = pack2(o[n][2], o[n][3]);
      }
    }
  }
  __syncthreads();

  // 3. O and round(dQ) go out; per (head, 16 keys): dV = P^T dO and
  //    dK = dS^T Q inside the head's stripe, zeros outside it
  store_rows<BF>(os_g, nq, d, ld, s.Os);
  store_rows<BF>(dqs_g, nq, d, ld, s.dQ);
  for (int u = warp; u < H * (nk_tot / 16); u += NWARP) {
    const int h = u / (nk_tot / 16), j0 = (u % (nk_tot / 16)) * 16;
    const int key0 = L.head_group[h] * nk, ch0 = h * ph;
    if (j0 < key0 || j0 >= key0 + nk) {
      for (int e = lane; e < 16 * (ph / 2); e += 32) {
        const size_t off = (size_t)(j0 + e / (ph / 2)) * ld + ch0 + 2 * (e % (ph / 2));
        *(uint32_t*)(s.dK + off) = 0u;
        *(uint32_t*)(s.dV + off) = 0u;
      }
      continue;
    }
    const int jl = j0 - key0;
    const BF* abh = s.Ab + (size_t)h * nqp * lda;
    const BF* dsh = s.dS + (size_t)h * nqp * lda;
    for (int c = 0; c < ph; c += 16) {
      float dv[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
      float dk[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
      for (int qk = 0; qk < nqp; qk += 16) {
        uint32_t af[4], bf[4];
        ldsm4t(af, addr_at(abh, lda, jl, qk, lane));
        ldsm4t(bf, addr_bt(s.dO, ld, ch0 + c, qk, lane));
        mma16816(dv[0], af, bf[0], bf[1]);
        mma16816(dv[1], af, bf[2], bf[3]);
        ldsm4t(af, addr_at(dsh, lda, jl, qk, lane));
        ldsm4t(bf, addr_bt(s.Qp, ld, ch0 + c, qk, lane));
        mma16816(dk[0], af, bf[0], bf[1]);
        mma16816(dk[1], af, bf[2], bf[3]);
      }
#pragma unroll
      for (int n = 0; n < 2; ++n) {
        const int col = ch0 + c + 8 * n + 2 * t_;
        float lo, hi;
        column_sums(dv[n], lo, hi);
        if (lane < 4) {
          colv[(size_t)(jl / 16) * d + col] = lo;
          colv[(size_t)(jl / 16) * d + col + 1] = hi;
        }
        column_sums(dk[n], lo, hi);
        if (lane < 4) {
          colk[(size_t)(jl / 16) * d + col] = lo;
          colk[(size_t)(jl / 16) * d + col + 1] = hi;
        }
        const size_t off = (size_t)(j0 + g_) * ld + col;
        *(uint32_t*)(s.dV + off) = pack2(dv[n][0], dv[n][1]);
        *(uint32_t*)(s.dV + off + (size_t)8 * ld) = pack2(dv[n][2], dv[n][3]);
        *(uint32_t*)(s.dK + off) = pack2(dk[n][0], dk[n][1]);
        *(uint32_t*)(s.dK + off + (size_t)8 * ld) = pack2(dk[n][2], dk[n][3]);
      }
    }
  }
  __syncthreads();

  // 4. back through the projections; the window's bias sums join the CTA's
  //    partial, tiles in order
  project_strips(s.dQ, (const BF*)a.w[0], nullptr, nullptr, nullptr, s.dQ3, nqp, ld, L, d, groups);
  project_strips(s.dK, (const BF*)a.w[1], s.dV, (const BF*)a.w[2], nullptr, s.dK3, nk_tot, ld, L, d, groups);
  for (int c = threadIdx.x; c < d; c += NT) {
    float cq = 0.f, ck = 0.f, cv = 0.f;
    for (int t = 0; t < tq; ++t) cq += colq[(size_t)t * d + c];
    for (int t = 0; t < tk; ++t) { ck += colk[(size_t)t * d + c]; cv += colv[(size_t)t * d + c]; }
    s.part[c] += cq;
    s.part[d + c] += ck;
    s.part[2 * d + c] += cv;
  }
  __syncthreads();
}

// One window's backward from its q/k tokens and g in shared memory (s.tokq,
// s.tokk, s.Gs; the caller has synchronised): recomputes the forward
// (projections, scores, softmax, the attention output O), then runs the
// chain rule back. Leaves dQ3 (nqp x ld) and dK3 (nk_tot x ld), the
// cotangents of the raw tokens, in s.dQ3/s.dK3, adds the window's bias
// cotangents (dbq, dbk, dbv, dbp) to s.part, and writes the weight-product
// operands round(dQ), round(dK), round(dV), round(O) to dqs/dks/dvs/os.
// Ends synchronised; dks/dvs are still being written (nothing reads them
// before the kernel ends).
template <typename T, typename A>
__device__ __forceinline__ void window_backward(const A& a, const Layout& L,
                                                const BwdSmem<T>& s,
                                                const float* kb, T* dqs, T* dks,
                                                T* dvs, T* os) {
  if constexpr (std::is_same<T, BF>::value) {
    if (L.use_mma) {
      window_backward_mma(a, L, s, kb, dqs, os);
      store_rows<BF>(dks, L.nk_tot, a.d, s.ld, s.dK);
      store_rows<BF>(dvs, L.nk_tot, a.d, s.ld, s.dV);
      return;
    }
  }
  window_backward_fma<T>(a, L, s, kb, dqs, dks, dvs, os);
}

// ------------------------------------------------------- the weight product
struct WArgs {
  const void* x[4];  // q tokens, k tokens, k tokens, O
  const void* y[4];  // round(dQ), round(dK), round(dV), g
  int ntok[4];
  int x_by_win[4], y_by_win[4];  // rows at list[p] (else at position p)
  const int* list;       // listed windows in order; null: 0, 1, 2, ...
  const int* count;      // number of listed windows (clamped to [0, nw])
  int nw, d, nsplit;
  float* wpart;  // (4, nsplit, d, d)
};

__device__ __forceinline__ int listed_count(const int* count, int nw) {
  const int n = __ldg(count);
  return n < 0 ? 0 : (n > nw ? nw : n);
}

// Row r of matrix m's virtual row space (listed windows back to back) ->
// element offset of the row in an operand array.
__device__ __forceinline__ size_t row_offset(const int* list, int by_win, long r,
                                             int ntok, int d) {
  const long p = r / ntok;
  const long w = by_win && list ? (long)__ldg(list + p) : p;
  return (size_t)(w * ntok + (r - p * ntok)) * d;
}

// The split's row range [t0, t1) of matrix m: whole listed windows, the same
// number for every split.
__device__ __forceinline__ void split_rows(const WArgs& a, int m, int s, long& t0,
                                           long& t1) {
  const long nl = listed_count(a.count, a.nw);
  const long per = (nl + a.nsplit - 1) / a.nsplit;
  const long w0 = s * per < nl ? s * per : nl;
  const long w1 = w0 + per < nl ? w0 + per : nl;
  t0 = w0 * a.ntok[m];
  t1 = w1 * a.ntok[m];
}

// dW_m = X_m^T Y_m over the row range of split blockIdx.y as FMA loops (f32,
// or widths the wgmma kernel is not built for): each CTA one GT x GT output
// tile (blockIdx.x) of matrix blockIdx.z; f32 partial out.
template <typename T>
__global__ void __launch_bounds__(NT) wgrad_fma_kernel(WArgs a) {
  using E = Elem<T>;
  __shared__ __align__(128) T Xs[KC * GT];
  __shared__ __align__(128) T Ys[KC * GT];
  const int m = blockIdx.z, s = blockIdx.y, d = a.d;
  const int tiles = (d + GT - 1) / GT;
  const int i0 = (blockIdx.x / tiles) * GT, j0 = (blockIdx.x % tiles) * GT;
  long t0, t1;
  split_rows(a, m, s, t0, t1);
  const T* X = (const T*)a.x[m];
  const T* Y = (const T*)a.y[m];
  float* out = a.wpart + ((size_t)m * a.nsplit + s) * d * d;
  float f[4][4];  // thread owns a 4 x 4 block
  const int fi = (threadIdx.x / 16) * 4, fj = (threadIdx.x % 16) * 4;
  for (int u = 0; u < 4; ++u)
    for (int v = 0; v < 4; ++v) f[u][v] = 0.f;
  for (long tb = t0; tb < t1; tb += KC) {
    for (int e = threadIdx.x; e < KC * GT; e += NT) {
      const int r = e / GT, c = e % GT;
      const long t = tb + r;
      const bool ok = t < t1;
      if (ok && i0 + c < d) Xs[e] = X[row_offset(a.list, a.x_by_win[m], t, a.ntok[m], d) + i0 + c];
      else E::store(Xs + e, 0.f);
      if (ok && j0 + c < d) Ys[e] = Y[row_offset(a.list, a.y_by_win[m], t, a.ntok[m], d) + j0 + c];
      else E::store(Ys + e, 0.f);
    }
    __syncthreads();
    for (int k = 0; k < KC; ++k)
      for (int u = 0; u < 4; ++u) {
        const float xv = E::load(Xs + k * GT + fi + u);
        for (int v = 0; v < 4; ++v) f[u][v] += xv * E::load(Ys + k * GT + fj + v);
      }
    __syncthreads();
  }
  for (int u = 0; u < 4; ++u)
    for (int v = 0; v < 4; ++v) {
      const int ii = i0 + fi + u, jj = j0 + fj + v;
      if (ii < d && jj < d) out[(size_t)ii * d + jj] = f[u][v];
    }
}

// The same product at d == WG_D in bf16 on wgmma: CTA (split blockIdx.x,
// matrix blockIdx.y) owns the whole d x d tile, so every operand row is read
// once. A ring of WG_STAGES stages of WG_ROWS token rows (cp.async, 16 bytes
// a thread; X and Y each as two 64-column halves of 128-byte rows in the
// 128-byte swizzle) feeds two warpgroups; warpgroup g multiplies X columns
// [64 g, 64 g + 64) (the M side, token-major and hence the transposed
// operand) by all 128 Y columns: wgmma m64n128k16, 64 f32 accumulators a
// thread.
#define MSSVT_R8(b) "+f"(acc[b]), "+f"(acc[b + 1]), "+f"(acc[b + 2]), "+f"(acc[b + 3]), \
                    "+f"(acc[b + 4]), "+f"(acc[b + 5]), "+f"(acc[b + 6]), "+f"(acc[b + 7])
__device__ __forceinline__ void wgmma_m64n128k16_tt(float (&acc)[64], uint64_t da,
                                                    uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 1, 1;\n"
      "}\n"
      : MSSVT_R8(0), MSSVT_R8(8), MSSVT_R8(16), MSSVT_R8(24), MSSVT_R8(32),
        MSSVT_R8(40), MSSVT_R8(48), MSSVT_R8(56)
      : "l"(da), "l"(db), "r"(1));
}
#undef MSSVT_R8

// Shared-memory matrix descriptor of an operand whose M/N side is contiguous
// (128-byte rows, 128-byte swizzle): lbo = bytes between 64-element blocks of
// the M/N side, sbo = bytes between groups of 8 rows of the K side.
__device__ __forceinline__ uint64_t wg_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32) | ((uint64_t)1 << 62);
}

constexpr int WG_HALF = WG_ROWS * 128;       // bytes of one 64-column half
constexpr int WG_STAGE = 4 * WG_HALF;        // X lo, X hi, Y lo, Y hi
constexpr int WG_SMEM = WG_STAGES * WG_STAGE + 1024;

__global__ void __launch_bounds__(NT, 1) wgrad_wgmma_kernel(WArgs a) {
  extern __shared__ unsigned char wg_raw[];
  const int s = blockIdx.x, m = blockIdx.y, d = WG_D;
  const uint32_t base = (smem_u32(wg_raw) + 1023u) & ~1023u;
  long t0, t1;
  split_rows(a, m, s, t0, t1);
  const BF* X = (const BF*)a.x[m];
  const BF* Y = (const BF*)a.y[m];
  const int ntok = a.ntok[m], xw = a.x_by_win[m], yw = a.y_by_win[m];
  const int ntile = (int)((t1 - t0 + WG_ROWS - 1) / WG_ROWS);
  const int wg = threadIdx.x >> 7;
  float acc[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.f;

  // thread -> 16-byte chunk ch of rows r0 + 16 i: chunk ch of a 256-byte row
  // lands in half ch / 8 at chunk (ch % 8) ^ (row % 8)
  const int ch = threadIdx.x & 15, r0 = threadIdx.x >> 4;
  auto fetch = [&](int tile) {
    const uint32_t st = base + (uint32_t)(tile % WG_STAGES) * WG_STAGE;
    if (tile < ntile) {
#pragma unroll
      for (int i = 0; i < WG_ROWS / 16; ++i) {
        const int r = r0 + 16 * i;
        const long t = t0 + (long)tile * WG_ROWS + r;
        const bool ok = t < t1;
        const long tc = ok ? t : t0;
        const BF* xs = X + row_offset(a.list, xw, tc, ntok, d) + ch * 8;
        const BF* ys = Y + row_offset(a.list, yw, tc, ntok, d) + ch * 8;
        const uint32_t dst = st + (uint32_t)(ch >> 3) * WG_HALF + (uint32_t)r * 128 +
                             (uint32_t)(((ch & 7) ^ (r & 7)) << 4);
        const int n = ok ? 16 : 0;  // 0: the 16 bytes are zero-filled
        asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
                     :: "r"(dst), "l"(xs), "r"(n) : "memory");
        asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
                     :: "r"(dst + 2 * WG_HALF), "l"(ys), "r"(n) : "memory");
      }
    }
    asm volatile("cp.async.commit_group;\n" ::: "memory");
  };
  for (int tl = 0; tl < WG_STAGES - 1; ++tl) fetch(tl);
  for (int tile = 0; tile < ntile; ++tile) {
    asm volatile("cp.async.wait_group %0;\n" :: "n"(WG_STAGES - 2) : "memory");
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();  // the tile has landed; the stage of tile - 1 is free
    fetch(tile + WG_STAGES - 1);
    const uint32_t st = base + (uint32_t)(tile % WG_STAGES) * WG_STAGE;
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
    for (int k = 0; k < WG_ROWS / 16; ++k) {
      const uint64_t da = wg_desc(st + (uint32_t)wg * WG_HALF + k * 2048, WG_HALF, 1024);
      const uint64_t db = wg_desc(st + 2 * WG_HALF + k * 2048, WG_HALF, 1024);
      wgmma_m64n128k16_tt(acc, da, db);
    }
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
    asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
  }
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  // accumulator i of thread (warp w4 of the group, g = lane / 4, t = lane % 4):
  // row 16 w4 + g + 8 ((i / 2) % 2), column 8 (i / 4) + 2 t + i % 2
  float* out = a.wpart + ((size_t)m * a.nsplit + s) * d * d;
  const int lane = threadIdx.x & 31, w4 = (threadIdx.x >> 5) & 3;
  const int row = 64 * wg + 16 * w4 + (lane >> 2), col = 2 * (lane & 3);
#pragma unroll
  for (int n = 0; n < 16; ++n) {
    *(float2*)(out + (size_t)row * d + 8 * n + col) = make_float2(acc[4 * n], acc[4 * n + 1]);
    *(float2*)(out + (size_t)(row + 8) * d + 8 * n + col) = make_float2(acc[4 * n + 2], acc[4 * n + 3]);
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
  bool fma = true;
  if constexpr (std::is_same<T, BF>::value) {
    if (wa.d == WG_D) {
      fma = false;
      cudaError_t err = cudaFuncSetAttribute(
          wgrad_wgmma_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, WG_SMEM);
      if (err != cudaSuccess) return (int)err;
      wgrad_wgmma_kernel<<<dim3(wa.nsplit, 4), NT, WG_SMEM, stream>>>(wa);
    }
  }
  if (fma) {
    const int tiles = (wa.d + GT - 1) / GT;
    wgrad_fma_kernel<T><<<dim3(tiles * tiles, wa.nsplit, 4), NT, 0, stream>>>(wa);
  }
  if (int st = launch_status()) return st;
  const long n = 4L * wa.d * wa.d + (long)npart * wa.d;
  finalize_kernel<<<(unsigned)((n + NT - 1) / NT), NT, 0, stream>>>(
      wa.wpart, cpart, wa.nsplit, ncta, npart, wa.d, dw, db, dposw);
  return launch_status();
}

}  // namespace
