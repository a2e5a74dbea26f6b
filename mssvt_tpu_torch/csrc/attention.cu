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
// backward) through attention_common.cuh.
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
  const int nk_tot = L.nk_tot, nk = L.nk, ph = L.ph, H = L.tot_heads;
  const int nqp = L.nqp;
  T* gout = (T*)a.out + (size_t)w * nq * d;
  if (a.num_valid != nullptr && w >= __ldg(a.num_valid)) {
    for (int e = threadIdx.x; e < nq * d; e += NT) E::store(gout + e, 0.f);
    return;
  }
  // shared layout (offsets 128-byte aligned):
  //   region0: q/k tokens (T) | later scores (f32) + softmax weights (bf16)
  //   Qp (later O), Kp, Vp (T); per-warp 16x16 f32 scratch (WMMA path)
  const size_t tok_bytes = (size_t)(nqp + nk_tot) * d * sizeof(T);
  const size_t s_bytes = ((size_t)H * nqp * nk * sizeof(float) + 127) & ~size_t(127);
  const size_t a_bytes = L.use_mma ? (size_t)H * nqp * nk * sizeof(BF) : 0;
  const size_t r0 = ((tok_bytes > s_bytes + a_bytes ? tok_bytes : s_bytes + a_bytes)
                     + 127) & ~size_t(127);
  T* tokq = (T*)smem_raw;
  T* tokk = tokq + nqp * d;
  float* S = (float*)smem_raw;
  BF* A = (BF*)(smem_raw + s_bytes);
  T* Qp = (T*)(smem_raw + r0);
  T* Kp = Qp + nqp * d;
  T* Vp = Kp + nk_tot * d;
  float* scratch = (float*)(Vp + nk_tot * d) + (threadIdx.x >> 5) * 256;

  // 1. token assembly (query rows past nq are zero padding)
  assemble<T>(a, L, w, tokq);
  __syncthreads();

  const float* kb = a.key_bias + (size_t)w * nk_tot;
  if constexpr (std::is_same<T, BF>::value) {
    if (L.use_mma) {
      // 2. projections on the tensor cores
      project_mma(tokq, nqp, (const BF*)a.w[0], (const BF*)a.b[0], Qp, nqp, L, d, a.groups, scratch);
      project_mma(tokk, nk_tot, (const BF*)a.w[1], (const BF*)a.b[1], Kp, nk_tot, L, d, a.groups, scratch);
      project_mma(tokk, nk_tot, (const BF*)a.w[2], (const BF*)a.b[2], Vp, nk_tot, L, d, a.groups, scratch);
      __syncthreads();
      // 3. per-head scores Q_h K_h^T over the head group's key stripe
      const int warp = threadIdx.x >> 5;
      const int tq = nqp / 16, tk = nk / 16;
      for (int t = warp; t < H * tq * tk; t += NWARP) {
        const int h = t / (tq * tk), q0 = ((t / tk) % tq) * 16, k0 = (t % tk) * 16;
        const int key0 = L.head_group[h] * nk + k0;
        wm::fragment<wm::accumulator, 16, 16, 16, float> acc;
        wm::fill_fragment(acc, 0.f);
        for (int c0 = 0; c0 < ph; c0 += 16) {
          wm::fragment<wm::matrix_a, 16, 16, 16, BF, wm::row_major> fa;
          wm::fragment<wm::matrix_b, 16, 16, 16, BF, wm::col_major> fb;
          wm::load_matrix_sync(fa, Qp + q0 * d + h * ph + c0, d);
          wm::load_matrix_sync(fb, Kp + key0 * d + h * ph + c0, d);
          wm::mma_sync(acc, fa, fb, acc);
        }
        wm::store_matrix_sync(S + (h * nqp + q0) * nk + k0, acc, nk, wm::mem_row_major);
      }
      __syncthreads();
      for (int row = threadIdx.x; row < H * nqp; row += NT) {
        float* sr = S + row * nk;
        const float* kbg = kb + L.head_group[row / nqp] * nk;
        float m = -INFINITY;
        for (int j = 0; j < nk; ++j) { sr[j] = sr[j] * a.scale + kbg[j]; m = fmaxf(m, sr[j]); }
        float sum = 0.f;
        for (int j = 0; j < nk; ++j) { const float ex = expf(sr[j] - m); sr[j] = ex; sum += ex; }
        const float inv = 1.f / (sum + 1e-30f);
        for (int j = 0; j < nk; ++j) A[row * nk + j] = __float2bfloat16_rn(sr[j] * inv);
      }
      __syncthreads();
      // value products A_h V_h into O (aliases Qp, dead after the scores)
      BF* O = Qp;
      const int tc = ph / 16;
      for (int t = warp; t < H * tq * tc; t += NWARP) {
        const int h = t / (tq * tc), q0 = ((t / tc) % tq) * 16, c0 = (t % tc) * 16;
        const int key0 = L.head_group[h] * nk;
        wm::fragment<wm::accumulator, 16, 16, 16, float> acc;
        wm::fill_fragment(acc, 0.f);
        for (int k0 = 0; k0 < nk; k0 += 16) {
          wm::fragment<wm::matrix_a, 16, 16, 16, BF, wm::row_major> fa;
          wm::fragment<wm::matrix_b, 16, 16, 16, BF, wm::row_major> fb;
          wm::load_matrix_sync(fa, A + (h * nqp + q0) * nk + k0, nk);
          wm::load_matrix_sync(fb, Vp + (key0 + k0) * d + h * ph + c0, d);
          wm::mma_sync(acc, fa, fb, acc);
        }
        tile_epilogue(acc, scratch, O, d, q0, h * ph + c0, nqp, nullptr);
      }
      __syncthreads();
      // 4. output projection straight to global memory
      project_mma(O, nqp, (const BF*)a.w[3], (const BF*)a.b[3], (BF*)gout, nq, L, d, a.groups, scratch);
      return;
    }
  }

  // FMA path: 2. projections (block-diagonal: group channels only)
  project<T>(tokq, nq, (const T*)a.w[0], (const T*)a.b[0], Qp, L, d, a.groups, nullptr);
  project<T>(tokk, nk_tot, (const T*)a.w[1], (const T*)a.b[1], Kp, L, d, a.groups, nullptr);
  project<T>(tokk, nk_tot, (const T*)a.w[2], (const T*)a.b[2], Vp, L, d, a.groups, nullptr);
  __syncthreads();

  // 3. scores over each head's own key stripe, then row softmax
  for (int e = threadIdx.x; e < H * nq * nk; e += NT) {
    const int h = e / (nq * nk), qi = (e / nk) % nq, kj = e % nk;
    const int key = L.head_group[h] * nk + kj;
    const T* qrow = Qp + qi * d + h * ph;
    const T* krow = Kp + key * d + h * ph;
    float s = 0.f;
    for (int c = 0; c < ph; ++c) s += E::load(qrow + c) * E::load(krow + c);
    S[e] = s * a.scale + kb[key];
  }
  __syncthreads();
  for (int row = threadIdx.x; row < H * nq; row += NT) {
    float* sr = S + row * nk;
    float m = -INFINITY;
    for (int j = 0; j < nk; ++j) m = fmaxf(m, sr[j]);
    float sum = 0.f;
    for (int j = 0; j < nk; ++j) { const float ex = expf(sr[j] - m); sr[j] = ex; sum += ex; }
    const float inv = 1.f / (sum + 1e-30f);
    for (int j = 0; j < nk; ++j) sr[j] = E::round(sr[j] * inv);
  }
  __syncthreads();

  // value product into O (aliases Qp, dead after the scores)
  T* O = Qp;
  for (int e = threadIdx.x; e < nq * d; e += NT) {
    const int qi = e / d, c = e % d, h = c / ph;
    const int g = L.head_group[h];
    const float* ar = S + (h * nq + qi) * nk;
    float acc = 0.f;
    for (int kj = 0; kj < nk; ++kj) acc += ar[kj] * E::load(Vp + (g * nk + kj) * d + c);
    E::store(O + e, acc);
  }
  __syncthreads();

  // 4. output projection straight to global memory
  project<T>(O, nq, (const T*)a.w[3], (const T*)a.b[3], nullptr, L, d, a.groups, gout);
}

template <typename T>
int launch(const Args& a, Layout L, cudaStream_t stream) {
  set_mma<T>(a, L);
  const size_t es = sizeof(T);
  const size_t tok = (size_t)(L.nqp + L.nk_tot) * a.d * es;
  const size_t sc = ((size_t)L.tot_heads * L.nqp * L.nk * sizeof(float) + 127) & ~size_t(127);
  const size_t aw = L.use_mma ? (size_t)L.tot_heads * L.nqp * L.nk * sizeof(BF) : 0;
  const size_t r0 = ((tok > sc + aw ? tok : sc + aw) + 127) & ~size_t(127);
  const size_t smem = r0 + (size_t)(L.nqp + 2 * L.nk_tot) * a.d * es +
                      (L.use_mma ? NWARP * 256 * sizeof(float) : 0);
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
