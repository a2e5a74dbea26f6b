// K7: backward of the window attention on pre-assembled tokens (K6).
//
// Replaces the TPU kernel _fused_attention_bwd_impl
// (mssvt_tpu/ops/pallas_attention.py, _attn_bwd_kernel -> _bwd_qstk_core /
// _finish_bwd), the backward of the custom VJP _fused_attention. Returns dq
// and dk in the tokens' type and the (4, D, D) weight and (4, D) bias
// cotangents in f32; key_bias gets none. One call is four steps on one
// stream:
//
// 0. the live-window list. live_flags_kernel reads g once, a warp per
//    window, flags the windows whose g has any nonzero element and zeroes dq
//    and dk of the others (16-byte stores); live_list_kernel, one CTA, scans
//    the flags and writes the flagged windows' indices in window order, and
//    their number (a block scan: no atomics, the order is the windows').
//    For a window with g = 0 the chain rule gives dO = dA = dS = dQ = dK =
//    dV = 0, dWp = O^T g = 0 and dbp = 0: every skipped term is an exact
//    zero, so the list changes no result. (A NaN or Inf among a skipped
//    window's tokens, which 0 * NaN would have spread, becomes a zero.) In
//    training most windows are skipped: masked queries and rows the loss
//    never reaches carry a zero cotangent.
// 1. attn_qk_bwd_kernel: a fixed grid of CTAs; CTA b walks list positions
//    p = b, b + grid, ... in order. Per listed window it copies the q/k
//    tokens and g into shared memory, recomputes the forward and runs the
//    chain rule back (attention_bwd_common.cuh):
//      dO = round(round(g) Wp^T); per head dA = dO V^T, dV = A^T dO,
//      dS = round(A * (dA - rowsum(dA * A)) * scale), dQ = dS K, dK = dS^T Q;
//      dq = round(dQ) Wq^T, dk = round(dK) Wk^T + round(dV) Wv^T
//    and writes dq/dk. The bias cotangents sum the unrounded f32 dQ/dK/dV
//    (and g) per window into the CTA's own partial in shared memory, written
//    once at the end. For the weight cotangents it writes round(dQ),
//    round(dK), round(dV) and round(O) to scratch at the list position; the
//    raw tokens and g are the inputs themselves, read at the window's index.
// 2. the weight product dW_m = X_m^T Y_m over the listed windows' rows
//    (split-K over whole windows, f32 partials).
// 3. finalize_kernel: sums the partials of (2) and the CTA partials of (1)
//    in a fixed order.
// The TPU kernel accumulates dW/db into one resident block across its
// sequential grid; here CTAs run in no order, so the sums take the fixed
// walk and the two extra passes instead: no float atomics, bit-identical on
// repeat.
//
// Bound: device memory at the card's peaks (g of every window and the
// tokens of the listed ones read once, dq and dk written once). What holds
// it in fact, and the design's answers, are in attention_bwd_common.cuh.
#include "attention_bwd_common.cuh"

namespace {

struct QkBwdArgs {
  const void* q; const void* k;
  const void* w[4];   // q, k, v, out projection (D x D, block diagonal)
  const void* wt[3];  // q, k, v projections transposed (mma path)
  const void* b[4];
  const float* key_bias;
  const void* g;
  void *dq, *dk;
  void *dqs, *dks, *dvs, *os;  // weight-product operands, by list position
  float* cpart;                // (grid, 4, d) CTA partials
  int* flags;                  // (nw) scratch of the pre-pass
  int* list;                   // (nw + 1): listed windows, then their number
  int nw, nq, nk_tot, d, groups;
  int heads[MAX_GROUPS];
  float scale;
};

// flags[w] = any element of g's window w is nonzero (-0 counts as zero, NaN
// as nonzero); windows without one get zero dq and dk. One warp a window.
template <typename T>
__global__ void __launch_bounds__(NT) live_flags_kernel(QkBwdArgs a) {
  constexpr int V = 16 / sizeof(T);
  constexpr uint32_t MAG = sizeof(T) == 2 ? 0x7FFF7FFFu : 0x7FFFFFFFu;
  const int lane = threadIdx.x & 31;
  const int w = blockIdx.x * NWARP + (threadIdx.x >> 5);
  if (w >= a.nw) return;
  const size_t nq4 = (size_t)a.nq * a.d / V, nk4 = (size_t)a.nk_tot * a.d / V;
  const uint4* g4 = (const uint4*)a.g + (size_t)w * nq4;
  uint32_t any = 0u;
  for (size_t e = lane; e < nq4; e += 32) {
    const uint4 u = __ldg(g4 + e);
    any |= (u.x | u.y | u.z | u.w) & MAG;
  }
  const bool live = __any_sync(0xffffffffu, any != 0u);
  if (lane == 0) a.flags[w] = live;
  if (live) return;
  uint4* q4 = (uint4*)a.dq + (size_t)w * nq4;
  uint4* k4 = (uint4*)a.dk + (size_t)w * nk4;
  for (size_t e = lane; e < nq4; e += 32) q4[e] = make_uint4(0u, 0u, 0u, 0u);
  for (size_t e = lane; e < nk4; e += 32) k4[e] = make_uint4(0u, 0u, 0u, 0u);
}

// list[0..n) = the flagged windows in window order, list[nw] = n. One CTA of
// 1024 threads: thread i owns a run of consecutive windows.
__global__ void __launch_bounds__(1024) live_list_kernel(const int* flags, int nw,
                                                         int* list) {
  __shared__ int warp_tot[32];
  const int tid = threadIdx.x, lane = tid & 31, wid = tid >> 5;
  const int per = (nw + 1023) / 1024;
  const int lo = tid * per < nw ? tid * per : nw;
  const int hi = lo + per < nw ? lo + per : nw;
  int n = 0;
  for (int w = lo; w < hi; ++w) n += flags[w] != 0;
  int incl = n;  // inclusive scan over the warp, then over the warps
  for (int o = 1; o < 32; o <<= 1) {
    const int v = __shfl_up_sync(0xffffffffu, incl, o);
    if (lane >= o) incl += v;
  }
  if (lane == 31) warp_tot[wid] = incl;
  __syncthreads();
  if (wid == 0) {
    int t = warp_tot[lane];
    for (int o = 1; o < 32; o <<= 1) {
      const int v = __shfl_up_sync(0xffffffffu, t, o);
      if (lane >= o) t += v;
    }
    warp_tot[lane] = t;
  }
  __syncthreads();
  int pos = incl - n + (wid ? warp_tot[wid - 1] : 0);
  for (int w = lo; w < hi; ++w)
    if (flags[w] != 0) list[pos++] = w;
  if (tid == 1023) list[nw] = pos;
}

template <typename T>
__global__ void __launch_bounds__(NT, 2) attn_qk_bwd_kernel(QkBwdArgs a, Layout L) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const int d = a.d, nq = a.nq, nk_tot = L.nk_tot;
  const Plan P(L, d, 0, 0, sizeof(T));
  const BwdSmem<T> sm(smem_raw, P);
  const int ld = sm.ld;
  for (int e = threadIdx.x; e < 4 * d; e += NT) sm.part[e] = 0.f;
  const int nl = listed_count(a.list + a.nw, a.nw);

  for (int p = blockIdx.x; p < nl; p += gridDim.x) {
    const int w = __ldg(a.list + p);
    const size_t qo = (size_t)w * nq * d, ko = (size_t)w * nk_tot * d;
    const size_t qp = (size_t)p * nq * d, kp = (size_t)p * nk_tot * d;
    load_rows<T>((const T*)a.q + qo, nq, L.nqp, d, ld, sm.tokq);
    load_rows<T>((const T*)a.k + ko, nk_tot, nk_tot, d, ld, sm.tokk);
    load_rows<T>((const T*)a.g + qo, nq, L.nqp, d, ld, sm.Gs);
    __syncthreads();
    window_backward<T>(a, L, sm, a.key_bias + (size_t)w * nk_tot,
                       (T*)a.dqs + qp, (T*)a.dks + kp, (T*)a.dvs + kp,
                       (T*)a.os + qp);
    // dq/dk: the first nq rows of dQ3 and all of dK3, 16 bytes a thread
    store_rows<T>((T*)a.dq + qo, nq, d, ld, sm.dQ3);
    store_rows<T>((T*)a.dk + ko, nk_tot, d, ld, sm.dK3);
    __syncthreads();
  }
  for (int e = threadIdx.x; e < 4 * d; e += NT)
    a.cpart[(size_t)blockIdx.x * 4 * d + e] = sm.part[e];
}

template <typename T>
int launch_qk_bwd(const QkBwdArgs& a, Layout L, const WArgs& wa, int ncta,
                  float* dw, float* db, cudaStream_t stream) {
  set_mma<T>(a.d, a.nq, L);
  if (a.nw > 0) {
    live_flags_kernel<T><<<(a.nw + NWARP - 1) / NWARP, NT, 0, stream>>>(a);
    if (int st = launch_status()) return st;
  }
  live_list_kernel<<<1, 1024, 0, stream>>>(a.flags, a.nw, a.list);
  if (int st = launch_status()) return st;
  if (ncta > 0) {
    const Plan P(L, a.d, 0, 0, sizeof(T));
    if (P.total > 227 * 1024) return (int)cudaErrorInvalidValue;
    cudaError_t err = cudaFuncSetAttribute(
        attn_qk_bwd_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)P.total);
    if (err != cudaSuccess) return (int)err;
    attn_qk_bwd_kernel<T><<<ncta, NT, P.total, stream>>>(a, L);
    if (int st = launch_status()) return st;
  }
  return launch_wgrad_finalize<T>(wa, a.cpart, ncta, 4, dw, db, nullptr, stream);
}

}  // namespace

// ptrs: query, keys, wq, wk, wv, wp, bq, bk, bv, bp, key_bias, g; the outputs
//       dq, dk; the scratch dqs, dks, dvs, os, wpart, cpart; the f32 outputs
//       dw (4, d, d), db (4, d); wq, wk, wv transposed; the int scratch
//       flags (nw), list (nw + 1)
// dims: nw, nq, nk_tot, d, groups, heads[4], nsplit, ncta
MSSVT_API int mssvt_attention_qk_bwd(const void* const* p, const int* dims,
                                     float scale, int is_bf16,
                                     cudaStream_t stream) {
  QkBwdArgs a{};
  Layout L{};
  a.q = p[0]; a.k = p[1];
  for (int i = 0; i < 4; ++i) { a.w[i] = p[2 + i]; a.b[i] = p[6 + i]; }
  a.key_bias = (const float*)p[10];
  a.g = p[11];
  a.dq = (void*)p[12]; a.dk = (void*)p[13];
  a.dqs = (void*)p[14]; a.dks = (void*)p[15]; a.dvs = (void*)p[16];
  a.os = (void*)p[17];
  a.cpart = (float*)p[19];
  for (int i = 0; i < 3; ++i) a.wt[i] = p[22 + i];
  a.flags = (int*)p[25];
  a.list = (int*)p[26];
  a.nw = dims[0]; a.nq = dims[1]; a.nk_tot = dims[2]; a.d = dims[3];
  a.groups = dims[4];
  a.scale = scale;
  if (a.groups < 1 || a.groups > MAX_GROUPS) return (int)cudaErrorInvalidValue;
  for (int g = 0; g < MAX_GROUPS; ++g) a.heads[g] = g < a.groups ? dims[5 + g] : 0;
  const int err = derive_layout(a.d, a.nq, a.nk_tot, a.groups, a.heads, L);
  if (err) return err;
  const int nsplit = dims[9], ncta = dims[10];
  if (nsplit < 1 || ncta < 0 || (ncta == 0 && a.nw > 0))
    return (int)cudaErrorInvalidValue;
  WArgs wa{};
  const void* xs[4] = {a.q, a.k, a.k, a.os};
  const void* ys[4] = {a.dqs, a.dks, a.dvs, a.g};
  const int nt[4] = {a.nq, a.nk_tot, a.nk_tot, a.nq};
  for (int m = 0; m < 4; ++m) { wa.x[m] = xs[m]; wa.y[m] = ys[m]; wa.ntok[m] = nt[m]; }
  // the inputs lie at the window's index, the written operands at its position
  wa.x_by_win[0] = wa.x_by_win[1] = wa.x_by_win[2] = wa.y_by_win[3] = 1;
  wa.list = a.list;
  wa.count = a.list + a.nw;
  wa.nw = a.nw; wa.d = a.d; wa.nsplit = nsplit;
  wa.wpart = (float*)p[18];
  float* dw = (float*)p[20];
  float* db = (float*)p[21];
  return is_bf16 ? launch_qk_bwd<__nv_bfloat16>(a, L, wa, ncta, dw, db, stream)
                 : launch_qk_bwd<float>(a, L, wa, ncta, dw, db, stream);
}

// dims: nw, nq, nk_tot, d, groups, heads[4] -> out: the per-window kernel's
// shared-memory bytes, its CTAs per SM, its registers
MSSVT_API int mssvt_attention_qk_bwd_plan(const int* dims, int is_bf16, int* out) {
  Layout L{};
  const int nq = dims[1], d = dims[3];
  const int err = derive_layout(d, nq, dims[2], dims[4], dims + 5, L);
  if (err) return err;
  if (is_bf16) {
    set_mma<__nv_bfloat16>(d, nq, L);
    return plan_occupancy(attn_qk_bwd_kernel<__nv_bfloat16>, Plan(L, d, 0, 0, 2).total, out);
  }
  set_mma<float>(d, nq, L);
  return plan_occupancy(attn_qk_bwd_kernel<float>, Plan(L, d, 0, 0, 4).total, out);
}
