// K3: mixed-scale window attention with the K/Q assembly fused in.
//
// Replaces the TPU kernel fused_window_attention_assembled
// (mssvt_tpu/ops/pallas_attention.py, _attn_assembled_kernel ->
// _assemble_tokens / _attn_assembled_body / _per_head_attn_qstk), forward
// only. One CTA owns one window and keeps everything between the raw gather
// products and the output projection in shared memory:
//   1. assemble the q tokens (nq x D) and k tokens (nk1 + nk2 x D): the FPS
//      pick from win1 (zero at masked picks, pad_row at ref-compat pad
//      picks), the k2 rows, plus relu(rel . pos_w + pos_base), each op
//      rounded to the compute type as the JAX kernel's bf16 ops are;
//   2. q/k/v projections with the block-diagonal weights: only the diagonal
//      block of each head group is multiplied (weights read through L1/L2,
//      coalesced across the CTA's channel threads), f32 accumulation;
//   3. per head: scores against its own group's key stripe, * scale +
//      key_bias (-100 at pad keys), softmax in f32, weights rounded to the
//      compute type, value product in f32;
//   4. output projection + bias, written in the compute type.
//
// Bound: at the card's peaks, device memory. At block 0 of mssvt.yaml a
// window reads ~22 KB (its win1 and k2 rows dominate) for ~3.7 MFLOP of
// block-diagonal products, ~170 FLOP/B, below the bf16 tensor-core ridge
// (~295). In bf16 the products (projections, per-head scores and value
// products) run on the tensor cores as 16x16x16 WMMA tiles (mma.sync),
// weights read through L1/L2; the softmax and the assembly stay scalar. The
// f32 path (and any layout whose head width or key stripe is not a multiple
// of 16) runs the same steps as FMA loops on the CUDA cores.
// Windows at or past num_valid (a device scalar) write zeros.
// The token assembly, projections and layout are shared with K5 (its
// backward), and steps 2-4 with K6 (the same attention on pre-assembled
// tokens), through attention_common.cuh.
#include "attention_common.cuh"

namespace {

struct Args : AsmIn {
  void* out;
};

template <typename T>
__global__ void __launch_bounds__(NT) attention_kernel(Args a, Layout L) {
  using E = Elem<T>;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const int w = blockIdx.x;
  const int d = a.d, nq = a.nq;
  T* gout = (T*)a.out + (size_t)w * nq * d;
  const FwdSmem<T> sm(smem_raw, L, d);
  if (a.num_valid != nullptr && w >= __ldg(a.num_valid)) {
    for (int e = threadIdx.x; e < nq * d; e += NT) E::store(gout + e, 0.f);
    return;
  }
  // 1. token assembly (query rows past nq are zero padding)
  assemble<T>(a, L, w, sm.tokq);
  __syncthreads();
  // 2.-4. projections, per-head attention, output projection
  attention_core<T>(a, L, sm, a.key_bias + (size_t)w * L.nk_tot, gout);
}

template <typename T>
int launch(const Args& a, Layout L, cudaStream_t stream) {
  set_mma<T>(a.d, a.nq, L);
  const size_t smem = FwdPlan(L, a.d, sizeof(T)).total;
  if (smem > 227 * 1024) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      attention_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  attention_kernel<T><<<a.nw, NT, smem, stream>>>(a, L);
  return launch_status();
}

}  // namespace

// ptrs: win1, k2, fps1, kmask, q_ext, q_keep, krel x3, qrel x3, base, posw,
//       wq, wk, wv, wp, bq, bk, bv, bp, key_bias, pad_row, num_valid, out
// dims: nw, n1cap, nk1, nk2, nq, d, groups, q_prefix, heads[4]
MSSVT_API int mssvt_attention(const void* const* p, const int* dims,
                              float scale, int is_bf16, cudaStream_t stream) {
  Args a{};
  Layout L{};
  const int err = parse_inputs(p, dims, scale, a, L);
  if (err) return err;
  a.out = (void*)p[25];
  if (a.nw <= 0) return 0;
  return is_bf16 ? launch<__nv_bfloat16>(a, L, stream) : launch<float>(a, L, stream);
}
