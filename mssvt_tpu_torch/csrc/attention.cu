// K3: mixed-scale window attention with the K/Q assembly fused in.
//
// Replaces the TPU kernel fused_window_attention_assembled
// (mssvt_tpu/ops/pallas_attention.py, _attn_assembled_kernel ->
// _assemble_tokens / _attn_assembled_body / _per_head_attn_qstk), forward
// only. The launch gives every window a CTA of its own, which keeps everything
// between the raw gather products and the output rows in shared memory:
//   1. assemble the q tokens (nq x D) and k tokens (nk1 + nk2 x D): the FPS
//      pick from win1 (zero at masked picks, pad_row at ref-compat pad
//      picks), the k2 rows, plus relu(rel . pos_w + pos_base), each op
//      rounded to the compute type as the JAX kernel's bf16 ops are;
//   2. q/k/v projections with the block-diagonal weights: only the diagonal
//      block of each head group is multiplied, f32 accumulation;
//   3. per head: scores against its own group's key stripe, * scale +
//      key_bias (-100 at pad keys), softmax in f32, weights rounded to the
//      compute type, value product in f32;
//   4. output projection + bias, written in the compute type.
// Windows at or past num_valid (a device scalar) write zeros, 16 bytes a
// thread.
//
// Bound: at the card's peaks, device memory. At block 0 of mssvt.yaml a
// window reads ~22 KB (its win1 and k2 rows dominate) for ~3.7 MFLOP of
// block-diagonal products, ~170 FLOP/B, below the bf16 tensor-core ridge
// (~295). What holds it in fact is the assembly's per-element rounding
// chain (~26 operations an element, more than a window's tensor-core work)
// and the latency of the small dependent phases behind it. The design's
// answers are in attention_common.cuh: the window's planes, picks and masks
// are staged in shared memory once and a thread assembles eight channels
// from 16-byte loads (the function K5, the backward, recomputes the tokens
// with); steps 2-4 are the per-window forward shared with K6 (mma.sync tiles
// with register epilogues, a warp a strip or a (head, 16 queries) unit, three
// CTAs an SM). K3 and K5 run the same code from the planes to O, so
// the backward differentiates exactly the probabilities the forward used.
#include "attention_common.cuh"

namespace {

struct Args : AsmIn {
  const void* wt[4];  // q, k, v, out projection transposed (mma path)
  void* out;
};

template <typename T>
__global__ void __launch_bounds__(NT, sizeof(T) == 2 ? FWD_CTAS : 1)
attention_kernel(Args a, Layout L) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const int d = a.d, nq = a.nq, nk_tot = L.nk_tot;
  const FwdPlan P(L, d, Stage::bytes(nq, a.nk1, nk_tot, d, false), sizeof(T));
  const FwdSmem<T> sm(smem_raw, P);
  const Stage st(sm.stage, nq, a.nk1, nk_tot, d);
  int nv = a.num_valid != nullptr ? __ldg(a.num_valid) : a.nw;
  nv = nv < 0 ? 0 : (nv > a.nw ? a.nw : nv);
  // One pass: launch_forward's grid is nw. The body stays a grid-stride loop
  // because ptxas fits that form into the 80 registers of three CTAs an SM;
  // as straight-line code the same body spilled 28 bytes and ran 3% slower
  // (PERF.md).
  for (int w = blockIdx.x; w < a.nw; w += gridDim.x) {
    T* gout = (T*)a.out + (size_t)w * nq * d;
    if (w >= nv) {
      zero_rows<T>(gout, (size_t)nq * d);
      continue;
    }
    // 1. token assembly; its own barrier (after staging the planes) also
    //    follows a previous window's last reads of the token rows
    assemble_staged<T, false>(a, L, w, st, sm.tokq, sm.tokk, sm.ld);
    __syncthreads();
    // 2.-4. projections, per-head attention, output projection
    window_forward<T>(a, L, sm, a.key_bias + (size_t)w * nk_tot, gout);
  }
}

template <typename T>
size_t plan_bytes(const AsmIn& a, Layout& L) {
  set_mma<T>(a.d, a.nq, L);
  return FwdPlan(L, a.d, Stage::bytes(a.nq, a.nk1, L.nk_tot, a.d, false), sizeof(T)).total;
}

}  // namespace

// ptrs: win1, k2, fps1, kmask, q_ext, q_keep, krel x3, qrel x3, base, posw,
//       wq, wk, wv, wp, bq, bk, bv, bp, key_bias, pad_row, num_valid, out;
//       wq, wk, wv, wp transposed
// dims: nw, n1cap, nk1, nk2, nq, d, groups, q_prefix, heads[4]
MSSVT_API int mssvt_attention(const void* const* p, const int* dims,
                              float scale, int is_bf16, cudaStream_t stream) {
  Args a{};
  Layout L{};
  const int err = parse_inputs(p, dims, scale, a, L);
  if (err) return err;
  a.out = (void*)p[25];
  for (int i = 0; i < 4; ++i) a.wt[i] = p[26 + i];
  if (a.nw <= 0) return 0;
  if (is_bf16)
    return launch_forward(attention_kernel<BF>, a, L, plan_bytes<BF>(a, L), a.nw, stream);
  return launch_forward(attention_kernel<float>, a, L, plan_bytes<float>(a, L), a.nw, stream);
}

// dims: nw, n1cap, nk1, nk2, nq, d, groups, q_prefix, heads[4] -> out: the
// kernel's shared-memory bytes, its CTAs per SM, its registers
MSSVT_API int mssvt_attention_plan(const int* dims, int is_bf16, int* out) {
  Args a{};
  Layout L{};
  const void* none[25] = {};
  const int err = parse_inputs(none, dims, 0.f, a, L);
  if (err) return err;
  return is_bf16 ? plan_occupancy(attention_kernel<BF>, plan_bytes<BF>(a, L), out)
                 : plan_occupancy(attention_kernel<float>, plan_bytes<float>(a, L), out);
}
