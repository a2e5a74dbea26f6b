// K6: mixed-scale window attention on pre-assembled query and key tokens.
//
// Replaces the TPU kernel _fused_attention_fwd_impl
// (mssvt_tpu/ops/pallas_attention.py, fused_window_attention ->
// _attn_kernel / _per_head_attn_qstk), the forward of the custom VJP
// _fused_attention. The caller has assembled the raw tokens (query (NW, nq,
// D), keys (NW, nk_tot, D), already in the compute type); one CTA owns one
// window, copies its tokens into shared memory 16 bytes a thread, and runs
// K3's per-window core (attention_common.cuh: block-diagonal q/k/v
// projections, per-head scores over the head group's own key stripe,
// * scale + key_bias, f32 softmax, value product, output projection, with
// the JAX kernel's rounding points). bf16 products run as 16x16x16 WMMA
// tiles, f32 as FMA loops. There is no live-window prefix: every window is
// computed, as in the JAX kernel.
//
// Bound: device memory at the card's peaks. At block 0 of mssvt.yaml a
// window reads 24 KB of tokens and writes 8 KB for ~3.7 MFLOP of
// block-diagonal products (~115 FLOP/B, below the bf16 ridge of ~295).
#include "attention_common.cuh"

namespace {

struct QkArgs {
  const void* q; const void* k;
  const void* w[4];  // q, k, v, out projection (D x D, block diagonal)
  const void* b[4];
  const float* key_bias;
  void* out;
  int nw, nq, nk_tot, d, groups;
  int heads[MAX_GROUPS];
  float scale;
};

template <typename T>
__global__ void __launch_bounds__(NT) attention_qk_kernel(QkArgs a, Layout L) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const int w = blockIdx.x;
  const int d = a.d, nq = a.nq, nk_tot = L.nk_tot;
  const FwdSmem<T> sm(smem_raw, L, d);
  load_tokens<T>((const T*)a.q + (size_t)w * nq * d,
                 (const T*)a.k + (size_t)w * nk_tot * d, nq, L.nqp, nk_tot, d,
                 sm.tokq);
  __syncthreads();
  attention_core<T>(a, L, sm, a.key_bias + (size_t)w * nk_tot,
                    (T*)a.out + (size_t)w * nq * d);
}

template <typename T>
int launch(const QkArgs& a, Layout L, cudaStream_t stream) {
  set_mma<T>(a.d, a.nq, L);
  const size_t smem = FwdPlan(L, a.d, sizeof(T)).total;
  if (smem > 227 * 1024) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      attention_qk_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  attention_qk_kernel<T><<<a.nw, NT, smem, stream>>>(a, L);
  return launch_status();
}

}  // namespace

// ptrs: query, keys, wq, wk, wv, wp, bq, bk, bv, bp, key_bias, out
// dims: nw, nq, nk_tot, d, groups, heads[4]
MSSVT_API int mssvt_attention_qk(const void* const* p, const int* dims,
                                 float scale, int is_bf16, cudaStream_t stream) {
  QkArgs a{};
  Layout L{};
  a.q = p[0]; a.k = p[1];
  for (int i = 0; i < 4; ++i) { a.w[i] = p[2 + i]; a.b[i] = p[6 + i]; }
  a.key_bias = (const float*)p[10];
  a.out = (void*)p[11];
  a.nw = dims[0]; a.nq = dims[1]; a.nk_tot = dims[2]; a.d = dims[3];
  a.groups = dims[4];
  a.scale = scale;
  if (a.groups < 1 || a.groups > MAX_GROUPS) return (int)cudaErrorInvalidValue;
  for (int g = 0; g < MAX_GROUPS; ++g) a.heads[g] = g < a.groups ? dims[5 + g] : 0;
  const int err = derive_layout(a.d, a.nq, a.nk_tot, a.groups, a.heads, L);
  if (err) return err;
  if (a.nw <= 0) return 0;
  return is_bf16 ? launch<__nv_bfloat16>(a, L, stream) : launch<float>(a, L, stream);
}
