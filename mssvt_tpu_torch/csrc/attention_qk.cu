// K6: mixed-scale window attention on pre-assembled query and key tokens.
//
// Replaces the TPU kernel _fused_attention_fwd_impl
// (mssvt_tpu/ops/pallas_attention.py, fused_window_attention ->
// _attn_kernel / _per_head_attn_qstk), the forward of the custom VJP
// _fused_attention. The caller has assembled the raw tokens (query (NW, nq,
// D), keys (NW, nk_tot, D), already in the compute type). The launch gives
// every window a CTA of its own: it copies the tokens into padded rows of
// shared memory 16 bytes a thread and runs the per-window forward of
// attention_common.cuh (block-diagonal q/k/v projections, per-head scores
// over the head group's own key stripe, * scale + key_bias, f32 softmax,
// value product, output projection, with the JAX kernel's rounding points).
// There is no live-window prefix: every window is computed, as in the JAX
// kernel.
//
// Bound: device memory at the card's peaks. At block 0 of mssvt.yaml a
// window reads 24 KB of tokens and writes 8 KB for ~3.7 MFLOP of
// block-diagonal products (~115 FLOP/B, below the bf16 ridge of ~295). What
// holds it in fact is the latency of a window's chain of small phases; the
// design's answers (mma.sync tiles with register epilogues, a warp a strip or
// a (head, 16 queries) unit, three CTAs an SM) are in attention_common.cuh.
#include "attention_common.cuh"

namespace {

struct QkArgs {
  const void* q; const void* k;
  const void* w[4];   // q, k, v, out projection (D x D, block diagonal)
  const void* wt[4];  // the same transposed (mma path)
  const void* b[4];
  const float* key_bias;
  void* out;
  int nw, nq, nk_tot, d, groups;
  int heads[MAX_GROUPS];
  float scale;
};

template <typename T>
__global__ void __launch_bounds__(NT, sizeof(T) == 2 ? FWD_CTAS : 1)
attention_qk_kernel(QkArgs a, Layout L) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const int d = a.d, nq = a.nq, nk_tot = L.nk_tot;
  const FwdPlan P(L, d, 0, sizeof(T));
  const FwdSmem<T> sm(smem_raw, P);
  // One pass: launch_forward's grid is nw. The body stays a grid-stride loop
  // because ptxas fits that form into 78 registers without spills; as
  // straight-line code the same body spilled 56 bytes at 80 registers and ran
  // 6% slower (PERF.md).
  for (int w = blockIdx.x; w < a.nw; w += gridDim.x) {
    load_rows<T>((const T*)a.q + (size_t)w * nq * d, nq, L.nqp, d, sm.ld, sm.tokq);
    load_rows<T>((const T*)a.k + (size_t)w * nk_tot * d, nk_tot, nk_tot, d, sm.ld, sm.tokk);
    __syncthreads();
    window_forward<T>(a, L, sm, a.key_bias + (size_t)w * nk_tot,
                      (T*)a.out + (size_t)w * nq * d);
    __syncthreads();  // the output rows have left tokq
  }
}

template <typename T>
size_t plan_bytes(int d, int nq, Layout& L) {
  set_mma<T>(d, nq, L);
  return FwdPlan(L, d, 0, sizeof(T)).total;
}

// dims: nw, nq, nk_tot, d, groups, heads[4]
int parse_dims(const int* dims, QkArgs& a, Layout& L) {
  a.nw = dims[0]; a.nq = dims[1]; a.nk_tot = dims[2]; a.d = dims[3];
  a.groups = dims[4];
  if (a.groups < 1 || a.groups > MAX_GROUPS) return (int)cudaErrorInvalidValue;
  for (int g = 0; g < MAX_GROUPS; ++g) a.heads[g] = g < a.groups ? dims[5 + g] : 0;
  return derive_layout(a.d, a.nq, a.nk_tot, a.groups, a.heads, L);
}

}  // namespace

// ptrs: query, keys, wq, wk, wv, wp, bq, bk, bv, bp, key_bias, out; wq, wk,
//       wv, wp transposed
// dims: nw, nq, nk_tot, d, groups, heads[4]
MSSVT_API int mssvt_attention_qk(const void* const* p, const int* dims,
                                 float scale, int is_bf16, cudaStream_t stream) {
  QkArgs a{};
  Layout L{};
  a.q = p[0]; a.k = p[1];
  for (int i = 0; i < 4; ++i) { a.w[i] = p[2 + i]; a.b[i] = p[6 + i]; a.wt[i] = p[12 + i]; }
  a.key_bias = (const float*)p[10];
  a.out = (void*)p[11];
  a.scale = scale;
  const int err = parse_dims(dims, a, L);
  if (err) return err;
  if (a.nw <= 0) return 0;
  if (is_bf16)
    return launch_forward(attention_qk_kernel<BF>, a, L, plan_bytes<BF>(a.d, a.nq, L),
                          a.nw, stream);
  return launch_forward(attention_qk_kernel<float>, a, L, plan_bytes<float>(a.d, a.nq, L),
                        a.nw, stream);
}

// dims: nw, nq, nk_tot, d, groups, heads[4] -> out: the kernel's
// shared-memory bytes, its CTAs per SM, its registers
MSSVT_API int mssvt_attention_qk_plan(const int* dims, int is_bf16, int* out) {
  QkArgs a{};
  Layout L{};
  const int err = parse_dims(dims, a, L);
  if (err) return err;
  return is_bf16
      ? plan_occupancy(attention_qk_kernel<BF>, plan_bytes<BF>(a.d, a.nq, L), out)
      : plan_occupancy(attention_qk_kernel<float>, plan_bytes<float>(a.d, a.nq, L), out);
}
