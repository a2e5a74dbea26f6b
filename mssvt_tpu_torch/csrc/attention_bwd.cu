// K5: backward of the assembled mixed-scale window attention (K3).
//
// Replaces the TPU kernel _asm_attn_bwd_impl
// (mssvt_tpu/ops/pallas_attention.py, _attn_assembled_bwd_kernel ->
// _attn_assembled_bwd_body / _bwd_qstk_core), the backward of the custom VJP
// _asm_attn_train. Three launches:
//
// 1. attn_bwd_kernel: a fixed grid of CTAs; CTA b walks windows
//    w = b, b + grid, ... in order. Per live window it stages the window's
//    rel planes, picks, masks and q_keep in shared memory, recomputes K3's
//    assembly from them (attention_common.cuh's assemble_staged, the function
//    K3 itself runs, here keeping one relu bit per token and channel),
//    recomputes the projections and softmax and runs the chain rule back
//    (attention_bwd_common.cuh):
//      dO = round(g Wp^T); per head dA = dO V^T, dV = A^T dO,
//      dS = round(A * (dA - rowsum(dA * A)) * scale), dQ = dS K, dK = dS^T Q;
//      dQ3 = round(round(dQ) Wq^T), dK3 = round(round(dK) Wk^T + round(dV) Wv^T)
//    (block-diagonal products: only each head group's diagonal block), and
//    splits dQ3/dK3 through the assembly from shared memory alone: the relu
//    bits -> dpos_base and the window's dpos_w rows (a thread sums two
//    channels over a run of tokens, the runs are joined in order); the FPS
//    picks' one-hot transpose -> dwin1 (each slot gathers its picks in key
//    order); pad picks -> dpad_row; q_prefix rows -> dwin1, else dq_ext; the
//    k2 rows -> dk2. The per-window bias and dpos_w sums are added, in window order, to
//    the CTA's own partial in shared memory, written once at the end. For
//    the weight cotangents it writes each live window's product operands
//    (its q/k tokens, round(dQ), round(dK), round(dV), round(O)) to scratch.
// 2. the weight product dW_m = X_m^T Y_m over all live tokens (split-K over
//    whole windows; each CTA owns the whole D x D tile of one matrix and
//    writes its f32 partial).
// 3. finalize_kernel: sums the partials of (2) and the CTA partials of (1)
//    in a fixed order.
// No float atomics anywhere: a repeated call gives bit-identical results. A
// 4 x D x D f32 weight partial (256 KB at D = 128) is the whole register
// file of an SM, hence the operand write-out and the separate product: once
// every operand byte is read once it costs ~170 KB of extra traffic per
// window at block 0 of mssvt.yaml, a few milliseconds a call.
//
// Windows at or past num_valid get zero cotangents and add nothing.
//
// Bound: device memory at the card's peaks (as K3: per window the raw inputs
// and g are read once and the cotangents written once; ~2.5x K3's products).
// What holds it in fact, and the design's answers, are in
// attention_bwd_common.cuh.
#include "attention_bwd_common.cuh"

namespace {

struct BwdArgs : AsmIn {
  const void* wt[3];  // q, k, v projections transposed (mma path)
  const void* g;
  void *dwin1, *dk2, *dqext, *dpad, *dbase;
  void *xq, *xk, *dqs, *dks, *dvs, *os;  // weight-product operands
  float* cpart;                          // (grid, 7, d) CTA partials
};

// Bytes of the tail's partial sums (at most NT / (d / 2) runs x 5 x d floats).
constexpr size_t TAIL_BYTES = (size_t)10 * NT * 4;

// Splits dQ3/dK3 (shared, row stride ld) through the assembly, reading shared
// memory only. dwin1: a thread owns eight channels of a slot and gathers the
// slot's picks in key order, then its q_prefix row. The sums over tokens
// (dpos_base, dpad_row, the window's dpos_w rows): a thread owns two channels
// and a run of tokens (keys, then queries); the runs' partials go through
// `red` and are joined in order by one thread a channel.
template <typename T>
__device__ void assembly_tail(const BwdArgs& a, const Layout& L, int w,
                              const Stage& st, const T* dQ3, const T* dK3,
                              int ld, float* red, float* part) {
  using E = Elem<T>;
  const int d = a.d, nq = a.nq, nk1 = a.nk1, nk2 = a.nk2, n1cap = a.n1cap;
  const int nk_tot = L.nk_tot, c8 = d / 8;
  store_rows<T>((T*)a.dk2 + (size_t)w * nk2 * d, nk2, d, ld, dK3 + (size_t)nk1 * ld);
  if (!a.q_prefix) {
    T* dqext = (T*)a.dqext + (size_t)w * nq * d;
    for (int e = threadIdx.x; e < nq * c8; e += NT) {
      const int q = e / c8, ch = (e % c8) * 8;
      const float keep = E::round(st.qkeep[q]);
      float v[8];
      Vec8<T>::load(dQ3 + (size_t)q * ld + ch, v);
#pragma unroll
      for (int i = 0; i < 8; ++i) v[i] *= keep;
      Vec8<T>::store(dqext + (size_t)q * d + ch, v);
    }
  }
  T* dwin1 = (T*)a.dwin1 + (size_t)w * n1cap * d;
  for (int e = threadIdx.x; e < n1cap * c8; e += NT) {
    const int s = e / c8, ch = (e % c8) * 8;
    float acc[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
    for (int j = 0; j < nk1; ++j) {
      if (st.fps[j] == s && !st.kmask[j]) {
        float v[8];
        Vec8<T>::load(dK3 + (size_t)j * ld + ch, v);
#pragma unroll
        for (int i = 0; i < 8; ++i) acc[i] += v[i];
      }
    }
    if (a.q_prefix && s < nq) {
      const float keep = E::round(st.qkeep[s]);
      float v[8];
      Vec8<T>::load(dQ3 + (size_t)s * ld + ch, v);
#pragma unroll
      for (int i = 0; i < 8; ++i) acc[i] += E::round(v[i] * keep);
    }
    Vec8<T>::store(dwin1 + (size_t)s * d + ch, acc);
  }
  const int np = d / 2, ng = NT / np, ntok = nk_tot + nq;
  const int per = (ntok + ng - 1) / ng;
  const int tg = threadIdx.x / np, c = 2 * (threadIdx.x % np);
  if (tg < ng) {
    float sz[2] = {0.f, 0.f}, dp[2] = {0.f, 0.f};
    float pw[3][2] = {{0.f, 0.f}, {0.f, 0.f}, {0.f, 0.f}};
    const int t1 = (tg + 1) * per < ntok ? (tg + 1) * per : ntok;
    for (int t = tg * per; t < t1; ++t) {
      const bool key = t < nk_tot;
      const int j = key ? t : t - nk_tot;
      const T* row = (key ? dK3 : dQ3) + (size_t)j * ld + c;
      const float g0 = E::load(row), g1 = E::load(row + 1);
      const uint32_t bits = st.relu[(size_t)(key ? nq + j : j) * c8 + c / 8] >> (c & 7);
      const float z0 = bits & 1u ? g0 : 0.f, z1 = bits & 2u ? g1 : 0.f;
      sz[0] += z0;
      sz[1] += z1;
      for (int k = 0; k < 3; ++k) {
        const float r = E::round(key ? st.krel[k * nk_tot + j] : st.qrel[k * nq + j]);
        pw[k][0] += r * z0;
        pw[k][1] += r * z1;
      }
      if (key && j < nk1 && st.kmask[j]) { dp[0] += g0; dp[1] += g1; }
    }
    float* rd = red + (size_t)tg * 5 * d + c;
    rd[0] = sz[0]; rd[1] = sz[1];
    rd[d] = dp[0]; rd[d + 1] = dp[1];
    for (int k = 0; k < 3; ++k) { rd[(2 + k) * d] = pw[k][0]; rd[(2 + k) * d + 1] = pw[k][1]; }
  }
  __syncthreads();
  for (int cc = threadIdx.x; cc < d; cc += NT) {
    float v[5] = {0.f, 0.f, 0.f, 0.f, 0.f};
    for (int g = 0; g < ng; ++g)
      for (int k = 0; k < 5; ++k) v[k] += red[((size_t)g * 5 + k) * d + cc];
    E::store((T*)a.dbase + (size_t)w * d + cc, v[0]);
    E::store((T*)a.dpad + (size_t)w * d + cc, v[1]);
    for (int k = 0; k < 3; ++k) part[(4 + k) * d + cc] += v[2 + k];
  }
}

template <typename T>
__global__ void __launch_bounds__(NT, 2) attn_bwd_kernel(BwdArgs a, Layout L) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const int d = a.d, nq = a.nq, nk1 = a.nk1, nk2 = a.nk2, n1cap = a.n1cap;
  const int nk_tot = L.nk_tot;
  const Plan P(L, d, TAIL_BYTES, Stage::bytes(nq, nk1, nk_tot, d, true), sizeof(T));
  const BwdSmem<T> sm(smem_raw, P);
  const Stage st(sm.stage, nq, nk1, nk_tot, d);
  const int ld = sm.ld;
  int nv = __ldg(a.num_valid);
  nv = nv < 0 ? 0 : (nv > a.nw ? a.nw : nv);
  for (int e = threadIdx.x; e < 7 * d; e += NT) sm.part[e] = 0.f;

  for (int w = blockIdx.x; w < a.nw; w += gridDim.x) {
    if (w >= nv) {
      zero_rows<T>((T*)a.dwin1 + (size_t)w * n1cap * d, (size_t)n1cap * d);
      zero_rows<T>((T*)a.dk2 + (size_t)w * nk2 * d, (size_t)nk2 * d);
      if (!a.q_prefix) zero_rows<T>((T*)a.dqext + (size_t)w * nq * d, (size_t)nq * d);
      zero_rows<T>((T*)a.dpad + (size_t)w * d, (size_t)d);
      zero_rows<T>((T*)a.dbase + (size_t)w * d, (size_t)d);
      continue;
    }
    // 1. recompute K3's forward: tokens (also the weight-product operands),
    //    projections, scores and softmax, the attention output O; then the
    //    chain rule back to dQ3/dK3 (attention_bwd_common.cuh)
    assemble_staged<T, true>(a, L, w, st, sm.tokq, sm.tokk, ld);
    load_rows<T>((const T*)a.g + (size_t)w * nq * d, nq, L.nqp, d, ld, sm.Gs);
    __syncthreads();
    store_rows<T>((T*)a.xq + (size_t)w * nq * d, nq, d, ld, sm.tokq);
    store_rows<T>((T*)a.xk + (size_t)w * nk_tot * d, nk_tot, d, ld, sm.tokk);
    window_backward<T>(a, L, sm, a.key_bias + (size_t)w * nk_tot,
                       (T*)a.dqs + (size_t)w * nq * d,
                       (T*)a.dks + (size_t)w * nk_tot * d,
                       (T*)a.dvs + (size_t)w * nk_tot * d,
                       (T*)a.os + (size_t)w * nq * d);
    // 2. through the assembly
    assembly_tail<T>(a, L, w, st, sm.dQ3, sm.dK3, ld, sm.tail, sm.part);
    __syncthreads();
  }
  for (int e = threadIdx.x; e < 7 * d; e += NT)
    a.cpart[(size_t)blockIdx.x * 7 * d + e] = sm.part[e];
}

template <typename T>
int launch_bwd(BwdArgs& a, Layout L, WArgs& wa, int ncta, float* dw, float* db,
               float* dposw, cudaStream_t stream) {
  set_mma<T>(a.d, a.nq, L);
  if (ncta > 0) {
    const Plan P(L, a.d, TAIL_BYTES, Stage::bytes(a.nq, a.nk1, L.nk_tot, a.d, true), sizeof(T));
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
//       dposw (3, d); wq, wk, wv transposed
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
  for (int i = 0; i < 3; ++i) a.wt[i] = p[42 + i];
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
  wa.list = nullptr;  // the live windows are the prefix 0 .. num_valid - 1
  wa.count = a.num_valid;
  wa.nw = a.nw; wa.d = a.d; wa.nsplit = nsplit;
  wa.wpart = (float*)p[37];
  float* dw = (float*)p[39];
  float* db = (float*)p[40];
  float* dposw = (float*)p[41];
  return is_bf16
      ? launch_bwd<__nv_bfloat16>(a, L, wa, ncta, dw, db, dposw, stream)
      : launch_bwd<float>(a, L, wa, ncta, dw, db, dposw, stream);
}

// dims: nw, n1cap, nk1, nk2, nq, d, groups, q_prefix, heads[4] -> out: the
// per-window kernel's shared-memory bytes, its CTAs per SM, its registers
MSSVT_API int mssvt_attention_bwd_plan(const int* dims, int is_bf16, int* out) {
  Layout L{};
  const int nk1 = dims[2], nk_tot = dims[2] + dims[3];
  const int nq = dims[4], d = dims[5];
  const int err = derive_layout(d, nq, nk_tot, dims[6], dims + 8, L);
  if (err) return err;
  const size_t stage = Stage::bytes(nq, nk1, nk_tot, d, true);
  if (is_bf16) {
    set_mma<__nv_bfloat16>(d, nq, L);
    return plan_occupancy(attn_bwd_kernel<__nv_bfloat16>, Plan(L, d, TAIL_BYTES, stage, 2).total, out);
  }
  set_mma<float>(d, nq, L);
  return plan_occupancy(attn_bwd_kernel<float>, Plan(L, d, TAIL_BYTES, stage, 4).total, out);
}
