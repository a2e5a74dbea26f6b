// K7: backward of the window attention on pre-assembled tokens (K6).
//
// Replaces the TPU kernel _fused_attention_bwd_impl
// (mssvt_tpu/ops/pallas_attention.py, _attn_bwd_kernel -> _bwd_qstk_core /
// _finish_bwd), the backward of the custom VJP _fused_attention. Returns dq
// and dk in the tokens' type and the (4, D, D) weight and (4, D) bias
// cotangents in f32; key_bias gets none. Three launches, K5's design
// (attention_bwd_common.cuh) without the assembly:
//
// 1. attn_qk_bwd_kernel: a fixed grid of CTAs; CTA b walks windows
//    w = b, b + grid, ... in order. Per window it copies the q/k tokens into
//    shared memory, recomputes the forward and runs the chain rule back:
//      dO = round(round(g) Wp^T); per head dA = dO V^T, dV = A^T dO,
//      dS = round(A * (dA - rowsum(dA * A)) * scale), dQ = dS K, dK = dS^T Q;
//      dq = round(dQ) Wq^T, dk = round(dK) Wk^T + round(dV) Wv^T
//    and writes dq/dk. The bias cotangents sum the unrounded f32 dQ/dK/dV
//    (and g) per window; they are added, in window order, to the CTA's own
//    partial in shared memory, written once at the end. For the weight
//    cotangents it writes round(dQ), round(dK), round(dV) and round(O) to
//    scratch; the raw tokens are the inputs themselves and are not written
//    again.
// 2. wgrad_kernel: dW_m = X_m^T Y_m over all tokens (split-K, f32 partials).
// 3. finalize_kernel: sums the partials of (2) and the CTA partials of (1)
//    in a fixed order.
// The TPU kernel accumulates dW/db into one resident block across its
// sequential grid; here CTAs run in no order, so the sums take the fixed
// walk and the two extra passes instead: no float atomics, bit-identical on
// repeat. There is no live-window prefix: every window is computed.
//
// Bound: device memory at the card's peaks (per window q, k and g are read
// once and dq, dk written once; ~2.5x K6's products).
#include "attention_bwd_common.cuh"

namespace {

struct QkBwdArgs {
  const void* q; const void* k;
  const void* w[4];  // q, k, v, out projection (D x D, block diagonal)
  const void* b[4];
  const float* key_bias;
  const void* g;
  void *dq, *dk;
  void *dqs, *dks, *dvs, *os;  // weight-product operands
  float* cpart;                // (grid, 4, d) CTA partials
  int nw, nq, nk_tot, d, groups;
  int heads[MAX_GROUPS];
  float scale;
};

template <typename T>
__global__ void __launch_bounds__(NT) attn_qk_bwd_kernel(QkBwdArgs a, Layout L) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  constexpr int V = 16 / sizeof(T);
  const int d = a.d, nq = a.nq, nk_tot = L.nk_tot;
  const Plan P(L, d, 0, sizeof(T));
  const BwdSmem<T> sm(smem_raw, P, L, d);
  for (int e = threadIdx.x; e < 4 * d; e += NT) sm.part[e] = 0.f;

  for (int w = blockIdx.x; w < a.nw; w += gridDim.x) {
    const size_t qo = (size_t)w * nq * d, ko = (size_t)w * nk_tot * d;
    load_tokens<T>((const T*)a.q + qo, (const T*)a.k + ko, nq, L.nqp, nk_tot, d,
                   sm.tokq);
    __syncthreads();
    window_backward<T>(a, L, sm, (const T*)a.g + qo,
                       a.key_bias + (size_t)w * nk_tot, (T*)a.dqs + qo,
                       (T*)a.dks + ko, (T*)a.dvs + ko, (T*)a.os + qo);
    // dq/dk: the first nq rows of dQ3 and all of dK3, 16 bytes a thread
    const uint4* s4 = (const uint4*)sm.dQ3;
    uint4* g4 = (uint4*)((T*)a.dq + qo);
    for (int e = threadIdx.x; e < nq * d / V; e += NT) g4[e] = s4[e];
    s4 = (const uint4*)sm.dK3;
    g4 = (uint4*)((T*)a.dk + ko);
    for (int e = threadIdx.x; e < nk_tot * d / V; e += NT) g4[e] = s4[e];
    for (int c = threadIdx.x; c < d; c += NT)
      for (int k = 0; k < 4; ++k) sm.part[k * d + c] += sm.cs[k * d + c];
    __syncthreads();
  }
  for (int e = threadIdx.x; e < 4 * d; e += NT)
    a.cpart[(size_t)blockIdx.x * 4 * d + e] = sm.part[e];
}

template <typename T>
int launch_qk_bwd(const QkBwdArgs& a, Layout L, const WArgs& wa, int ncta,
                  float* dw, float* db, cudaStream_t stream) {
  set_mma<T>(a.d, a.nq, L);
  if (ncta > 0) {
    const Plan P(L, a.d, 0, sizeof(T));
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
//       dw (4, d, d), db (4, d)
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
  wa.num_valid = nullptr;  // every window
  wa.nw = a.nw; wa.d = a.d; wa.nsplit = nsplit;
  wa.wpart = (float*)p[18];
  float* dw = (float*)p[20];
  float* db = (float*)p[21];
  return is_bf16 ? launch_qk_bwd<__nv_bfloat16>(a, L, wa, ncta, dw, db, stream)
                 : launch_qk_bwd<float>(a, L, wa, ncta, dw, db, stream);
}
