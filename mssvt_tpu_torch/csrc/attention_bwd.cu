// K5: backward of the assembled mixed-scale window attention (K3).
//
// Replaces the TPU kernel _asm_attn_bwd_impl
// (mssvt_tpu/ops/pallas_attention.py, _attn_assembled_bwd_kernel ->
// _attn_assembled_bwd_body / _bwd_qstk_core), the backward of the custom VJP
// _asm_attn_train. Three launches:
//
// 1. attn_bwd_kernel: a fixed grid of CTAs; CTA b walks windows
//    w = b, b + grid, ... in order. Per live window it recomputes K3's
//    assembly, projections and softmax in shared memory (attention_common.cuh,
//    the same code and bf16 rounding points), then runs the chain rule back:
//      dO = round(g Wp^T); per head dA = dO V^T, dV = A^T dO,
//      dS = round(A * (dA - rowsum(dA * A)) * scale), dQ = dS K, dK = dS^T Q;
//      dQ3 = round(round(dQ) Wq^T), dK3 = round(round(dK) Wk^T + round(dV) Wv^T)
//    (block-diagonal products: only each head group's diagonal block), and
//    splits dQ3/dK3 through the assembly: relu masks from the recomputed
//    pre-activations -> dpos_base and the window's dpos_w rows; the FPS picks'
//    one-hot transpose -> dwin1 (repeated picks of a slot sum, in key order);
//    pad picks -> dpad_row; q_prefix rows -> dwin1, else dq_ext; the k2 rows
//    -> dk2. The per-window bias and dpos_w sums are added, in window order,
//    to the CTA's own partial in shared memory, written once at the end.
//    For the weight cotangents it writes each live window's product operands
//    (its q/k tokens, round(dQ), round(dK), round(dV), round(O)) to scratch.
// (The per-window backward, the weight product and the final sums are shared
// with K7 through attention_bwd_common.cuh.)
// 2. wgrad_kernel: dW_m = X_m^T Y_m over all live tokens (a split-K product:
//    each CTA owns a 64x64 output tile of one matrix and a fixed token range,
//    and writes its f32 partial).
// 3. finalize_kernel: sums the partials of (2) and the CTA partials of (1)
//    in a fixed order.
// No float atomics anywhere: a repeated call gives bit-identical results. A
// 4 x D x D f32 weight partial (256 KB at D = 128) does not fit a CTA's
// shared memory, hence the operand write-out and the separate product; it
// costs ~72 KB of extra writes and reads per window at block 0 of mssvt.yaml.
//
// In bf16 the products run as 16x16x16 WMMA tiles with f32 accumulation
// (query rows padded to 16); the f32 path runs FMA loops. The bias
// cotangents sum the unrounded f32 products: in the WMMA path each warp owns
// whole 16-column strips, so every column is summed by one warp, in row
// order. Windows at or past num_valid get zero cotangents and add nothing.
//
// Bound: device memory at the card's peaks (as K3: per window the raw inputs
// and g are read once and the cotangents written once; ~2.5x K3's products).
#include "attention_bwd_common.cuh"

namespace {

struct BwdArgs : AsmIn {
  const void* g;
  void *dwin1, *dk2, *dqext, *dpad, *dbase;
  void *xq, *xk, *dqs, *dks, *dvs, *os;  // weight-product operands
  float* cpart;                          // (grid, 7, d) CTA partials
};

template <typename T>
__global__ void __launch_bounds__(NT) attn_bwd_kernel(BwdArgs a, Layout L) {
  using E = Elem<T>;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const int d = a.d, nq = a.nq, nk1 = a.nk1, nk2 = a.nk2, n1cap = a.n1cap;
  const int nk_tot = L.nk_tot;
  const Plan P(L, d, n1cap, sizeof(T));
  const BwdSmem<T> sm(smem_raw, P, L, d);
  T* tokq = sm.tokq;
  T* tokk = sm.tokk;
  float* acc1 = (float*)(smem_raw + P.tok);  // dwin1 sums, in the tail
  T* dQ3 = sm.dQ3;
  T* dK3 = sm.dK3;
  float* cs = sm.cs;      // dbq, dbk, dbv, dbp of a window
  float* part = sm.part;  // the CTA's 7 x d partial
  int nv = __ldg(a.num_valid);
  nv = nv < 0 ? 0 : (nv > a.nw ? a.nw : nv);
  const T* posw = (const T*)a.posw;
  for (int e = threadIdx.x; e < 7 * d; e += NT) part[e] = 0.f;

  for (int w = blockIdx.x; w < a.nw; w += gridDim.x) {
    T* dwin1 = (T*)a.dwin1 + (size_t)w * n1cap * d;
    T* dk2 = (T*)a.dk2 + (size_t)w * nk2 * d;
    T* dqext = a.q_prefix ? nullptr : (T*)a.dqext + (size_t)w * nq * d;
    T* dpad = (T*)a.dpad + (size_t)w * d;
    T* dbase = (T*)a.dbase + (size_t)w * d;
    if (w >= nv) {
      for (int e = threadIdx.x; e < n1cap * d; e += NT) E::store(dwin1 + e, 0.f);
      for (int e = threadIdx.x; e < nk2 * d; e += NT) E::store(dk2 + e, 0.f);
      if (dqext)
        for (int e = threadIdx.x; e < nq * d; e += NT) E::store(dqext + e, 0.f);
      for (int e = threadIdx.x; e < d; e += NT) { E::store(dpad + e, 0.f); E::store(dbase + e, 0.f); }
      continue;
    }
    T* xq = (T*)a.xq + (size_t)w * nq * d;
    T* xk = (T*)a.xk + (size_t)w * nk_tot * d;

    // 1. recompute K3's forward: tokens (also the weight-product operands),
    //    projections, scores and softmax, the attention output O; then the
    //    chain rule back to dQ3/dK3 (attention_bwd_common.cuh)
    assemble<T>(a, L, w, tokq);
    __syncthreads();
    for (int e = threadIdx.x; e < nq * d; e += NT) xq[e] = tokq[e];
    for (int e = threadIdx.x; e < nk_tot * d; e += NT) xk[e] = tokk[e];
    window_backward<T>(a, L, sm, (const T*)a.g + (size_t)w * nq * d,
                       a.key_bias + (size_t)w * nk_tot,
                       (T*)a.dqs + (size_t)w * nq * d,
                       (T*)a.dks + (size_t)w * nk_tot * d,
                       (T*)a.dvs + (size_t)w * nk_tot * d,
                       (T*)a.os + (size_t)w * nq * d);

    // 2. through the assembly, one thread per channel: relu masks from the
    //    recomputed pre-activations, the picks' one-hot transpose, pad picks,
    //    query rows; the window's sums go to the CTA partial
    for (int c = threadIdx.x; c < d; c += NT) {
      const float w0 = E::load(posw + c), w1 = E::load(posw + d + c),
                  w2 = E::load(posw + 2 * d + c),
                  bs = E::load((const T*)a.base + (size_t)w * d + c);
      for (int s = 0; s < n1cap; ++s) acc1[s * d + c] = 0.f;
      float dp = 0.f, sk = 0.f, sq = 0.f;
      float pk[3] = {0.f, 0.f, 0.f}, pq[3] = {0.f, 0.f, 0.f};
      for (int j = 0; j < nk_tot; ++j) {
        const size_t pi = (size_t)w * nk_tot + j;
        const float r[3] = {a.krel[0][pi], a.krel[1][pi], a.krel[2][pi]};
        const float gv = E::load(dK3 + j * d + c);
        const float dz = pos_pre<T>(r[0], r[1], r[2], w0, w1, w2, bs) > 0.f ? gv : 0.f;
        sk += dz;
        for (int k = 0; k < 3; ++k) pk[k] += E::round(r[k]) * dz;
        if (j < nk1) {
          const size_t mi = (size_t)w * nk1 + j;
          const int f = a.fps1[mi];
          if (a.kmask[mi]) dp += gv;
          else if (f >= 0 && f < n1cap) acc1[f * d + c] += gv;
        } else {
          E::store(dk2 + (size_t)(j - nk1) * d + c, gv);
        }
      }
      for (int q = 0; q < nq; ++q) {
        const size_t pi = (size_t)w * nq + q;
        const float r[3] = {a.qrel[0][pi], a.qrel[1][pi], a.qrel[2][pi]};
        const float gv = E::load(dQ3 + q * d + c);
        const float dz = pos_pre<T>(r[0], r[1], r[2], w0, w1, w2, bs) > 0.f ? gv : 0.f;
        sq += dz;
        for (int k = 0; k < 3; ++k) pq[k] += E::round(r[k]) * dz;
        const float raw = E::round(gv * E::round(a.q_keep[pi]));
        if (a.q_prefix) acc1[q * d + c] += raw;
        else E::store(dqext + (size_t)q * d + c, raw);
      }
      for (int s = 0; s < n1cap; ++s) E::store(dwin1 + (size_t)s * d + c, acc1[s * d + c]);
      E::store(dpad + c, dp);
      E::store(dbase + c, sk + sq);
      for (int k = 0; k < 4; ++k) part[k * d + c] += cs[k * d + c];
      for (int k = 0; k < 3; ++k) part[(4 + k) * d + c] += pk[k] + pq[k];
    }
    __syncthreads();
  }
  for (int e = threadIdx.x; e < 7 * d; e += NT)
    a.cpart[(size_t)blockIdx.x * 7 * d + e] = part[e];
}

template <typename T>
int launch_bwd(BwdArgs& a, Layout L, WArgs& wa, int ncta, float* dw, float* db,
               float* dposw, cudaStream_t stream) {
  set_mma<T>(a.d, a.nq, L);
  if (ncta > 0) {
    const Plan P(L, a.d, a.n1cap, sizeof(T));
    if (P.total > 227 * 1024) return (int)cudaErrorInvalidValue;
    cudaError_t err = cudaFuncSetAttribute(
        attn_bwd_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)P.total);
    if (err != cudaSuccess) return (int)err;
    attn_bwd_kernel<T><<<ncta, NT, P.total, stream>>>(a, L);
    if (int st = launch_status()) return st;
  }
  return launch_wgrad_finalize<T>(wa, a.cpart, ncta, 7, dw, db, dposw, stream);
}

}  // namespace

// ptrs: the 25 inputs of mssvt_attention (num_valid required), then
//       g; dwin1, dk2, dq_ext, dpad, dbase; the scratch xq, xk, dqs, dks,
//       dvs, os, wpart, cpart; the f32 outputs dw (4, d, d), db (4, d),
//       dposw (3, d)
// dims: nw, n1cap, nk1, nk2, nq, d, groups, q_prefix, heads[4], nsplit, ncta
MSSVT_API int mssvt_attention_bwd(const void* const* p, const int* dims,
                                  float scale, int is_bf16,
                                  cudaStream_t stream) {
  BwdArgs a{};
  Layout L{};
  const int err = parse_inputs(p, dims, scale, a, L);
  if (err) return err;
  if (a.num_valid == nullptr || a.pad_row == nullptr)
    return (int)cudaErrorInvalidValue;
  a.g = p[25];
  a.dwin1 = (void*)p[26]; a.dk2 = (void*)p[27]; a.dqext = (void*)p[28];
  a.dpad = (void*)p[29]; a.dbase = (void*)p[30];
  a.xq = (void*)p[31]; a.xk = (void*)p[32]; a.dqs = (void*)p[33];
  a.dks = (void*)p[34]; a.dvs = (void*)p[35]; a.os = (void*)p[36];
  a.cpart = (float*)p[38];
  const int nsplit = dims[12], ncta = dims[13];
  if (nsplit < 1 || ncta < 0 || (ncta == 0 && a.nw > 0) ||
      (!a.q_prefix && a.dqext == nullptr))
    return (int)cudaErrorInvalidValue;
  WArgs wa{};
  const int nk_tot = a.nk1 + a.nk2;
  const void* xs[4] = {a.xq, a.xk, a.xk, a.os};
  const void* ys[4] = {a.dqs, a.dks, a.dvs, a.g};
  const int nt[4] = {a.nq, nk_tot, nk_tot, a.nq};
  for (int m = 0; m < 4; ++m) { wa.x[m] = xs[m]; wa.y[m] = ys[m]; wa.ntok[m] = nt[m]; }
  wa.num_valid = a.num_valid;
  wa.nw = a.nw; wa.d = a.d; wa.nsplit = nsplit;
  wa.wpart = (float*)p[37];
  float* dw = (float*)p[39];
  float* db = (float*)p[40];
  float* dposw = (float*)p[41];
  return is_bf16
      ? launch_bwd<__nv_bfloat16>(a, L, wa, ncta, dw, db, dposw, stream)
      : launch_bwd<float>(a, L, wa, ncta, dw, db, dposw, stream);
}
