// Pieces shared by the window-attention kernels: K3, the assembled forward
// (attention.cu), K5, its backward (attention_bwd.cu), K6, the forward on
// pre-assembled tokens (attention_qk.cu), and K7, its backward
// (attention_qk_bwd.cu; the backward's own shared pieces are in
// attention_bwd_common.cuh). Here: the head/group layout, the assembled
// input layout and its host-side parsing, the tensor-core primitives
// (ldmatrix, mma.sync m16n8k16), the 16-byte row copies, the token assembly
// from staged planes with the JAX kernel's bf16 rounding points (K3, K5),
// the block-diagonal projections (strips of mma tiles, or FMA loops), the
// (head, 16 queries) unit from the scores to O that the forwards and the
// backwards' recompute run with the same code, and the per-window
// forward from the tokens in shared memory to the output rows (K3, K6).
//
// What bounds the forwards on an H100: on paper device memory (a window's
// tokens read once, its output rows written once; its products are ~170
// FLOP a byte, below the bf16 ridge); in fact the latency of a chain of
// small dependent phases, since one window's products are far too small to
// fill an SM. The design therefore
//   - runs the bf16 products as mma.sync m16n8k16 tiles whose documented
//     register layout lets bias, rounding and stores happen from the
//     accumulators; rows in shared memory are padded by 16 bytes so ldmatrix
//     reads meet no bank conflict;
//   - gives a warp a 16-column strip of a projection (each weight fragment
//     two 4-byte global loads a k-step, reused over MAXRT row tiles) and a
//     whole (head, 16 queries) unit from the scores through the softmax to O
//     (row maxima and sums by two quad shuffles, round(P) kept in registers
//     as the A fragments of the value product): no score matrix, no
//     probabilities and no scratch in shared memory, three block barriers
//     inside a window;
//   - keeps a window at ~70 KB of shared memory (O over Qp, the staged
//     output over the dead query tokens) and <= 80 registers a thread, so
//     that three CTAs share an SM and one's global loads overlap the
//     others' arithmetic;
//   - moves every token, plane and output byte 16 bytes a thread.
// The f32 path, and bf16 layouts the tiles do not fit, run FMA loops.
#pragma once

#include <type_traits>

#include "common.h"

namespace {

constexpr int NT = 256;  // threads per CTA
constexpr int MAX_GROUPS = 4;
constexpr int RB = 8;    // tokens per thread in the FMA projection loops
constexpr int NWARP = NT / 32;
constexpr int MAXNKT = 4;  // mma path: key stripe of at most 32 keys
constexpr int MAXRT = 4;   // mma projections: row tiles held in registers
constexpr int FWD_CTAS = 3;  // CTAs an SM the bf16 forward kernels are built for
using BF = __nv_bfloat16;

// The assembled inputs of one call (the contract of
// fused_window_attention_assembled).
struct AsmIn {
  const void* win1; const void* k2; const int* fps1; const uint8_t* kmask;
  const void* q_ext; const float* q_keep;
  const float* krel[3]; const float* qrel[3];
  const void* base; const void* posw;
  const void* w[4];  // q, k, v, out projection (D x D, block diagonal)
  const void* b[4];
  const float* key_bias; const void* pad_row; const int* num_valid;
  int nw, n1cap, nk1, nk2, nq, d, groups, q_prefix;
  int heads[MAX_GROUPS];
  float scale;
};

struct Layout {
  int nk_tot, nk, ph, tot_heads;
  int nqp;      // query rows in shared memory (nq, padded to 16 for the tiles)
  int use_mma;  // bf16 with head width and key stripe multiples of 16
  int gstart[MAX_GROUPS + 1];  // channel start of each head group
  int head_group[64];
};

__host__ __device__ inline size_t align128(size_t x) {
  return (x + 127) & ~size_t(127);
}

// Head/group layout of d channels and nk_tot keys over `groups` head groups
// of heads[g] heads each. Returns a cudaError_t.
inline int derive_layout(int d, int nq, int nk_tot, int groups, const int* heads,
                         Layout& L) {
  int tot = 0;
  for (int g = 0; g < MAX_GROUPS; ++g) tot += g < groups ? heads[g] : 0;
  if (groups < 1 || groups > MAX_GROUPS || tot < 1 || tot > 64 || d % tot ||
      d % 32 || d > NT || nk_tot % groups || nq < 1)
    return (int)cudaErrorInvalidValue;
  L.tot_heads = tot;
  L.ph = d / tot;
  L.nk_tot = nk_tot;
  L.nk = nk_tot / groups;
  int h = 0, c = 0;
  for (int g = 0; g < groups; ++g) {
    L.gstart[g] = c;
    for (int j = 0; j < heads[g]; ++j) L.head_group[h++] = g;
    c += heads[g] * L.ph;
  }
  L.gstart[groups] = c;
  return 0;
}

// Fills the inputs from the pointer array (win1, k2, fps1, kmask, q_ext,
// q_keep, krel x3, qrel x3, base, posw, wq, wk, wv, wp, bq, bk, bv, bp,
// key_bias, pad_row, num_valid) and dims (nw, n1cap, nk1, nk2, nq, d, groups,
// q_prefix, heads[4]); derives the layout. Returns a cudaError_t.
inline int parse_inputs(const void* const* p, const int* dims, float scale,
                        AsmIn& a, Layout& L) {
  a.win1 = p[0]; a.k2 = p[1]; a.fps1 = (const int*)p[2];
  a.kmask = (const uint8_t*)p[3]; a.q_ext = p[4]; a.q_keep = (const float*)p[5];
  for (int i = 0; i < 3; ++i) { a.krel[i] = (const float*)p[6 + i]; a.qrel[i] = (const float*)p[9 + i]; }
  a.base = p[12]; a.posw = p[13];
  for (int i = 0; i < 4; ++i) { a.w[i] = p[14 + i]; a.b[i] = p[18 + i]; }
  a.key_bias = (const float*)p[22]; a.pad_row = p[23];
  a.num_valid = (const int*)p[24];
  a.nw = dims[0]; a.n1cap = dims[1]; a.nk1 = dims[2]; a.nk2 = dims[3];
  a.nq = dims[4]; a.d = dims[5]; a.groups = dims[6]; a.q_prefix = dims[7];
  a.scale = scale;
  for (int g = 0; g < MAX_GROUPS; ++g) a.heads[g] = g < a.groups ? dims[8 + g] : 0;
  return derive_layout(a.d, a.nq, a.nk1 + a.nk2, a.groups, a.heads, L);
}

// Tensor cores for bf16 when every tile lies inside one head and one stripe
// of at most 8 * MAXNKT keys; query rows are padded to 16 then.
template <typename T>
inline void set_mma(int d, int nq, Layout& L) {
  L.use_mma = std::is_same<T, BF>::value && d % 16 == 0 && L.ph % 16 == 0 &&
              L.nk % 16 == 0 && L.nk <= 8 * MAXNKT;
  L.nqp = L.use_mma ? (nq + 15) / 16 * 16 : nq;
}

__device__ __forceinline__ int group_of(const Layout& L, int c, int groups) {
  int g = 0;
  while (g + 1 < groups && c >= L.gstart[g + 1]) ++g;
  return g;
}

// Shared memory of one CTA of `kernel`, the CTAs an SM holds of it at that
// size (the occupancy API's answer) and its registers a thread into out[0],
// out[1], out[2].
template <typename K>
int plan_occupancy(K kernel, size_t smem, int* out) {
  out[0] = (int)smem;
  out[1] = out[2] = 0;
  if (smem > 227 * 1024) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  cudaFuncAttributes attr;
  err = cudaFuncGetAttributes(&attr, kernel);
  if (err != cudaSuccess) return (int)err;
  out[2] = attr.numRegs;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(&out[1], kernel, NT, smem);
}

// ---------------------------------------------------------------- primitives
__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}
__device__ __forceinline__ void ldsm4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}
__device__ __forceinline__ void ldsm4t(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}
// D (16x8, f32) += A (16x16, bf16, row) * B (16x8, bf16, col). Thread
// (g = lane / 4, t = lane % 4) holds A rows g, g + 8 (k 2t.., 2t + 8..), B
// column g (k 2t.., 2t + 8..) and D rows g (c[0..1]), g + 8 (c[2..3]) at
// columns 2t, 2t + 1.
__device__ __forceinline__ void mma16816(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
__device__ __forceinline__ uint32_t pack2(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}
// Lane addresses of the four ldmatrix operand forms (tile origin r0/k0/n0):
// A stored [m][k] (ldsm4), A stored [k][m] (ldsm4t), B stored [n][k] over two
// 8-column tiles (ldsm4), B stored [k][n] over two 8-column tiles (ldsm4t).
__device__ __forceinline__ const BF* addr_a(const BF* s, int ld, int r0, int k0, int lane) {
  return s + (size_t)(r0 + (lane & 15)) * ld + k0 + (lane >> 4) * 8;
}
__device__ __forceinline__ const BF* addr_at(const BF* s, int ld, int r0, int k0, int lane) {
  return s + (size_t)(k0 + (lane & 7) + 8 * (lane >> 4)) * ld + r0 + 8 * ((lane >> 3) & 1);
}
__device__ __forceinline__ const BF* addr_b(const BF* s, int ld, int n0, int k0, int lane) {
  return s + (size_t)(n0 + (lane & 7) + 8 * (lane >> 4)) * ld + k0 + 8 * ((lane >> 3) & 1);
}
__device__ __forceinline__ const BF* addr_bt(const BF* s, int ld, int n0, int k0, int lane) {
  return s + (size_t)(k0 + (lane & 15)) * ld + n0 + 8 * (lane >> 4);
}
__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}
__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

// Eight consecutive channels between memory (16-byte accesses) and floats.
template <typename T> struct Vec8;
template <> struct Vec8<BF> {
  static __device__ __forceinline__ void load(const BF* p, float (&v)[8]) {
    const uint4 u = *reinterpret_cast<const uint4*>(p);
    const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w[i]));
      v[2 * i] = f.x;
      v[2 * i + 1] = f.y;
    }
  }
  static __device__ __forceinline__ void store(BF* p, const float (&v)[8]) {
    *reinterpret_cast<uint4*>(p) = make_uint4(pack2(v[0], v[1]), pack2(v[2], v[3]),
                                              pack2(v[4], v[5]), pack2(v[6], v[7]));
  }
};
template <> struct Vec8<float> {
  static __device__ __forceinline__ void load(const float* p, float (&v)[8]) {
    const float4 a = *reinterpret_cast<const float4*>(p);
    const float4 b = *reinterpret_cast<const float4*>(p + 4);
    v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
    v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
  }
  static __device__ __forceinline__ void store(float* p, const float (&v)[8]) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
    *reinterpret_cast<float4*>(p + 4) = make_float4(v[4], v[5], v[6], v[7]);
  }
};

// Row copies between global memory (row stride d) and shared memory (row
// stride ld), 16 bytes a thread; rows in [rows, rows_pad) are zeroed.
template <typename T>
__device__ void load_rows(const T* g, int rows, int rows_pad, int d, int ld, T* s) {
  constexpr int V = 16 / sizeof(T);
  const int cpr = d / V;
  for (int e = threadIdx.x; e < rows_pad * cpr; e += NT) {
    const int r = e / cpr, c = (e % cpr) * V;
    *reinterpret_cast<uint4*>(s + (size_t)r * ld + c) =
        r < rows ? __ldg(reinterpret_cast<const uint4*>(g + (size_t)r * d + c))
                 : make_uint4(0u, 0u, 0u, 0u);
  }
}
template <typename T>
__device__ void store_rows(T* g, int rows, int d, int ld, const T* s) {
  constexpr int V = 16 / sizeof(T);
  const int cpr = d / V;
  for (int e = threadIdx.x; e < rows * cpr; e += NT) {
    const int r = e / cpr, c = (e % cpr) * V;
    *reinterpret_cast<uint4*>(g + (size_t)r * d + c) =
        *reinterpret_cast<const uint4*>(s + (size_t)r * ld + c);
  }
}
template <typename T>
__device__ void zero_rows(T* g, size_t n) {  // n elements, a multiple of 16 bytes
  constexpr int V = 16 / sizeof(T);
  for (size_t e = threadIdx.x; e < n / V; e += NT)
    reinterpret_cast<uint4*>(g)[e] = make_uint4(0u, 0u, 0u, 0u);
}

// ------------------------------------------------------------- the assembly
// Pre-relu position activation rx*w0 + ry*w1 + rz*w2 + base, rounded to the
// compute type after every op as the JAX kernel's bf16 ops are.
template <typename T>
__device__ __forceinline__ float pos_pre(float rx, float ry, float rz, float w0,
                                         float w1, float w2, float bs) {
  using E = Elem<T>;
  float pre = E::round(E::round(rx) * w0);
  pre = E::round(pre + E::round(E::round(ry) * w1));
  pre = E::round(pre + E::round(E::round(rz) * w2));
  return E::round(pre + bs);
}

// A window's staged planes: krel (3, nk_tot), qrel (3, nq), q_keep (nq) in
// f32; fps1 (nk1) in int32; kmask (nk1); with `relu` (K5) one relu bit per
// token and channel (nq + nk_tot rows, d / 8 bytes each).
struct Stage {
  float *krel, *qrel, *qkeep;
  int* fps;
  uint8_t *kmask, *relu;
  __host__ __device__ static size_t bytes(int nq, int nk1, int nk_tot, int d,
                                          bool relu) {
    return (size_t)(3 * nk_tot + 4 * nq + nk1) * 4 +
           (size_t)((nk1 + 15) / 16 * 16) +
           (relu ? (size_t)(nq + nk_tot) * (d / 8) : 0);
  }
  __device__ Stage(unsigned char* p, int nq, int nk1, int nk_tot, int d) {
    krel = (float*)p;
    qrel = krel + 3 * nk_tot;
    qkeep = qrel + 3 * nq;
    fps = (int*)(qkeep + nq);
    kmask = (uint8_t*)(fps + nk1);
    relu = kmask + (nk1 + 15) / 16 * 16;
  }
};

// Assembles window w's tokens into shared memory: nqp query rows at tokq
// (rows past nq zero) and nk_tot key rows at tokk, row stride ld, each
//   q = raw * keep + relu(pos(q_rel)),  raw = win1[:nq] or q_ext
//   k = [pick of win1 (zero if masked/out of range; pad_row if masked and
//        pad_row is given) | k2] + relu(pos(k_rel))
// The window's rel planes, q_keep, picks and masks go to shared memory once;
// a thread keeps its eight channels of pos_w and pos_base in registers and
// walks the token rows with 16-byte loads and stores. With RELU it keeps the
// relu bit of every (token, channel) for K5's way back through the assembly.
// Starts with a block barrier of its own (after staging); the caller
// synchronises before the tokens are read.
template <typename T, bool RELU>
__device__ void assemble_staged(const AsmIn& a, const Layout& L, int w,
                                const Stage& st, T* tokq, T* tokk, int ld) {
  using E = Elem<T>;
  const int d = a.d, nq = a.nq, nk1 = a.nk1, nqp = L.nqp, nk_tot = L.nk_tot;
  const int c8 = d / 8;
  for (int e = threadIdx.x; e < 3 * nk_tot; e += NT)
    st.krel[e] = a.krel[e / nk_tot][(size_t)w * nk_tot + e % nk_tot];
  for (int e = threadIdx.x; e < 3 * nq; e += NT)
    st.qrel[e] = a.qrel[e / nq][(size_t)w * nq + e % nq];
  for (int e = threadIdx.x; e < nq; e += NT) st.qkeep[e] = a.q_keep[(size_t)w * nq + e];
  for (int e = threadIdx.x; e < nk1; e += NT) {
    st.fps[e] = a.fps1[(size_t)w * nk1 + e];
    st.kmask[e] = a.kmask[(size_t)w * nk1 + e];
  }
  __syncthreads();
  const T* win1 = (const T*)a.win1 + (size_t)w * a.n1cap * d;
  const T* k2 = (const T*)a.k2 + (size_t)w * a.nk2 * d;
  const T* posw = (const T*)a.posw;
  const T* base = (const T*)a.base + (size_t)w * d;
  // a thread keeps one chunk of eight channels and walks the token rows
  const int rstep = NT / c8, ch = (threadIdx.x % c8) * 8;
  float w0[8], w1[8], w2[8], bs[8];
  Vec8<T>::load(posw + ch, w0);
  Vec8<T>::load(posw + d + ch, w1);
  Vec8<T>::load(posw + 2 * d + ch, w2);
  Vec8<T>::load(base + ch, bs);
  for (int r = threadIdx.x / c8; r < (threadIdx.x < rstep * c8 ? nqp + nk_tot : 0);
       r += rstep) {
    T* dst = (r < nqp ? tokq + (size_t)r * ld : tokk + (size_t)(r - nqp) * ld) + ch;
    float raw[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
    if (r >= nq && r < nqp) { Vec8<T>::store(dst, raw); continue; }
    float rx, ry, rz;
    int tok;  // row of the relu bits
    const T* src = nullptr;
    float keep = 1.f;
    if (r < nq) {
      tok = r;
      rx = st.qrel[r]; ry = st.qrel[nq + r]; rz = st.qrel[2 * nq + r];
      src = a.q_prefix ? win1 + (size_t)r * d + ch
                       : (const T*)a.q_ext + ((size_t)w * nq + r) * d + ch;
      keep = E::round(st.qkeep[r]);
    } else {
      const int j = r - nqp;
      tok = nq + j;
      rx = st.krel[j]; ry = st.krel[nk_tot + j]; rz = st.krel[2 * nk_tot + j];
      if (j < nk1) {
        const int f = st.fps[j];
        if (st.kmask[j]) {
          if (a.pad_row) src = (const T*)a.pad_row + (size_t)w * d + ch;
        } else if (f >= 0 && f < a.n1cap) {
          src = win1 + (size_t)f * d + ch;
        }
      } else {
        src = k2 + (size_t)(j - nk1) * d + ch;
      }
    }
    if (src) Vec8<T>::load(src, raw);
    uint32_t bits = 0u;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const float pre = pos_pre<T>(rx, ry, rz, w0[i], w1[i], w2[i], bs[i]);
      if (pre > 0.f) bits |= 1u << i;
      const float x = r < nq ? E::round(raw[i] * keep) : raw[i];
      raw[i] = x + fmaxf(pre, 0.f);
    }
    Vec8<T>::store(dst, raw);
    if (RELU) st.relu[(size_t)tok * c8 + ch / 8] = (uint8_t)bits;
  }
}

// ---------------------------------------------------------- the projections
// out[r][c] = round(sum_{i in group(c)} tok[r][i] * W[i][c] + b[c]) for
// r < ntok as FMA loops; tok and out live in shared memory (row stride d).
template <typename T>
__device__ void project(const T* tok, int ntok, const T* __restrict__ W,
                        const T* __restrict__ bvec, T* out, const Layout& L,
                        int d, int groups, T* gout) {
  using E = Elem<T>;
  const int lanes = NT / d;  // token lanes: thread = (lane tl, channel c)
  const int c = threadIdx.x % d, tl = threadIdx.x / d;
  if (tl < lanes) {
    const int g = group_of(L, c, groups);
    const int i0 = L.gstart[g], i1 = L.gstart[g + 1];
    const float bias = E::load(bvec + c);
    for (int r0 = tl * RB; r0 < ntok; r0 += lanes * RB) {
      float acc[RB];
#pragma unroll
      for (int u = 0; u < RB; ++u) acc[u] = 0.f;
      for (int i = i0; i < i1; ++i) {
        const float wv = E::load(W + (size_t)i * d + c);
#pragma unroll
        for (int u = 0; u < RB; ++u)
          if (r0 + u < ntok) acc[u] += E::load(tok + (r0 + u) * d + i) * wv;
      }
#pragma unroll
      for (int u = 0; u < RB; ++u)
        if (r0 + u < ntok) {
          const float v = acc[u] + bias;
          if (gout) E::store(gout + (size_t)(r0 + u) * d + c, v);
          else E::store(out + (r0 + u) * d + c, v);
        }
    }
  }
}

// out[r][c] = round(sum_k A[r][k] Wnk[c][k] (+ sum_k A2[r][k] W2nk[c][k])
//                   + bias[c]) over the channels k of c's head group, for
// rows_pad (a multiple of 16) rows. A, A2 and out are shared (row stride ld);
// Wnk is global, [output channel][contracted channel], row stride d. Each
// warp owns 16-column strips: it reads each weight fragment once per strip
// and MAXRT row tiles, and rounds and stores from its accumulators.
__device__ void project_strips(const BF* A, const BF* Wnk, const BF* A2,
                               const BF* W2nk, const BF* bias, BF* out,
                               int rows_pad, int ld, const Layout& L, int d,
                               int groups) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g_ = lane >> 2, t_ = lane & 3;
  for (int cs = warp; cs < d / 16; cs += NWARP) {
    const int c0 = cs * 16, grp = group_of(L, c0, groups);
    const int k0 = L.gstart[grp], k1 = L.gstart[grp + 1];
    for (int rb = 0; rb < rows_pad; rb += 16 * MAXRT) {
      float acc[MAXRT][2][4];
#pragma unroll
      for (int r = 0; r < MAXRT; ++r)
#pragma unroll
        for (int n = 0; n < 2; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[r][n][e] = 0.f;
      for (int pass = 0; pass < (A2 ? 2 : 1); ++pass) {
        const BF* Ap = pass ? A2 : A;
        const BF* Wp = pass ? W2nk : Wnk;
#pragma unroll 2
        for (int k = k0; k < k1; k += 16) {
          const BF* w0 = Wp + (size_t)(c0 + g_) * d + k + 2 * t_;
          const BF* w1 = w0 + (size_t)8 * d;
          const uint32_t b00 = __ldg((const uint32_t*)w0), b01 = __ldg((const uint32_t*)(w0 + 8));
          const uint32_t b10 = __ldg((const uint32_t*)w1), b11 = __ldg((const uint32_t*)(w1 + 8));
#pragma unroll
          for (int r = 0; r < MAXRT; ++r) {
            if (rb + 16 * r < rows_pad) {
              uint32_t af[4];
              ldsm4(af, addr_a(Ap, ld, rb + 16 * r, k, lane));
              mma16816(acc[r][0], af, b00, b01);
              mma16816(acc[r][1], af, b10, b11);
            }
          }
        }
      }
#pragma unroll
      for (int r = 0; r < MAXRT; ++r) {
        if (rb + 16 * r < rows_pad) {
#pragma unroll
          for (int n = 0; n < 2; ++n) {
            const int c = c0 + 8 * n + 2 * t_;
            const float bl = bias ? __bfloat162float(bias[c]) : 0.f;
            const float bh = bias ? __bfloat162float(bias[c + 1]) : 0.f;
            BF* o = out + (size_t)(rb + 16 * r + g_) * ld + c;
            *(uint32_t*)o = pack2(acc[r][n][0] + bl, acc[r][n][1] + bh);
            *(uint32_t*)(o + (size_t)8 * ld) = pack2(acc[r][n][2] + bl, acc[r][n][3] + bh);
          }
        }
      }
    }
  }
}

// ------------------------------------------- the (head, 16 queries) unit
// One warp, from the projections in shared memory (row stride ld) to O, all
// between registers: rows q0.. of head channels ch0.. against the ph-wide
// key stripe at key0. The forwards and the backwards' recompute run this
// same code, so K3's probabilities and O equal the ones K5 recomputes bit
// for bit (and K6's equal K7's).
//
// p = softmax(Q_h K_h^T * scale + key_bias) over the stripe's nk keys, f32:
// thread (g = lane / 4, t = lane % 4) holds rows g (e 0-1) and g + 8 (e 2-3)
// at keys 8 j + 2 t, + 1. Max-subtracted; the normalisation is the plain
// version's, a division by (sum + 1e-30), not a product with a reciprocal.
__device__ __forceinline__ void unit_softmax(const BF* Qp, const BF* Kp, int ld,
                                             int q0, int ch0, int key0, int nk,
                                             int ph, const float* kb,
                                             float scale, int lane,
                                             float (&p)[MAXNKT][4]) {
  const int t_ = lane & 3;
#pragma unroll
  for (int j = 0; j < MAXNKT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) p[j][e] = 0.f;
  for (int c = 0; c < ph; c += 16) {  // S = Q_h K_h^T
    uint32_t af[4];
    ldsm4(af, addr_a(Qp, ld, q0, ch0 + c, lane));
#pragma unroll
    for (int jp = 0; jp < MAXNKT / 2; ++jp) {
      if (jp * 16 < nk) {
        uint32_t bf[4];
        ldsm4(bf, addr_b(Kp, ld, key0 + jp * 16, ch0 + c, lane));
        mma16816(p[2 * jp], af, bf[0], bf[1]);
        mma16816(p[2 * jp + 1], af, bf[2], bf[3]);
      }
    }
  }
  float m0 = -INFINITY, m1 = -INFINITY;
#pragma unroll
  for (int j = 0; j < MAXNKT; ++j) {
    if (j * 8 < nk) {
      const float k0v = kb[key0 + j * 8 + 2 * t_], k1v = kb[key0 + j * 8 + 2 * t_ + 1];
      p[j][0] = p[j][0] * scale + k0v;
      p[j][1] = p[j][1] * scale + k1v;
      p[j][2] = p[j][2] * scale + k0v;
      p[j][3] = p[j][3] * scale + k1v;
      m0 = fmaxf(m0, fmaxf(p[j][0], p[j][1]));
      m1 = fmaxf(m1, fmaxf(p[j][2], p[j][3]));
    }
  }
  m0 = quad_max(m0);
  m1 = quad_max(m1);
  float s0 = 0.f, s1 = 0.f;
#pragma unroll
  for (int j = 0; j < MAXNKT; ++j) {
    if (j * 8 < nk) {
      p[j][0] = expf(p[j][0] - m0);
      p[j][1] = expf(p[j][1] - m0);
      p[j][2] = expf(p[j][2] - m1);
      p[j][3] = expf(p[j][3] - m1);
      s0 += p[j][0] + p[j][1];
      s1 += p[j][2] + p[j][3];
    }
  }
  const float den0 = quad_sum(s0) + 1e-30f, den1 = quad_sum(s1) + 1e-30f;
#pragma unroll
  for (int j = 0; j < MAXNKT; ++j) {
    if (j * 8 < nk) {
      p[j][0] /= den0; p[j][1] /= den0;
      p[j][2] /= den1; p[j][3] /= den1;
    }
  }
}

// round(p) as the A fragments of a product over the keys.
__device__ __forceinline__ void unit_pack(const float (&p)[MAXNKT][4], int nk,
                                          uint32_t (&pa)[MAXNKT / 2][4]) {
#pragma unroll
  for (int j = 0; j < MAXNKT; ++j) {
    if (j * 8 < nk) {
      pa[j / 2][(j & 1) * 2] = pack2(p[j][0], p[j][1]);
      pa[j / 2][(j & 1) * 2 + 1] = pack2(p[j][2], p[j][3]);
    }
  }
}

// O = round(P) V_h, rounded, into rows q0.. of Os at the head's channels.
__device__ __forceinline__ void unit_value(const uint32_t (&pa)[MAXNKT / 2][4],
                                           const BF* Vp, BF* Os, int ld, int q0,
                                           int ch0, int key0, int nk, int ph,
                                           int lane) {
  const int g_ = lane >> 2, t_ = lane & 3;
  for (int c = 0; c < ph; c += 16) {
    float o[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
#pragma unroll
    for (int jp = 0; jp < MAXNKT / 2; ++jp) {
      if (jp * 16 < nk) {
        uint32_t bf[4];
        ldsm4t(bf, addr_bt(Vp, ld, ch0 + c, key0 + jp * 16, lane));
        mma16816(o[0], pa[jp], bf[0], bf[1]);
        mma16816(o[1], pa[jp], bf[2], bf[3]);
      }
    }
#pragma unroll
    for (int n = 0; n < 2; ++n) {
      BF* op = Os + (size_t)(q0 + g_) * ld + ch0 + c + 8 * n + 2 * t_;
      *(uint32_t*)op = pack2(o[n][0], o[n][1]);
      *(uint32_t*)(op + (size_t)8 * ld) = pack2(o[n][2], o[n][3]);
    }
  }
}

// ------------------------------------------------------ the forward kernels
// Shared-memory plan of the forward kernels (byte offsets, 128-aligned); the
// same code sizes the launch on the host. Token and projection rows have
// stride ld (d + 8 elements on the mma path, d else). stage_bytes are K3's
// staged planes (0 for K6). Regions are reused once dead:
//   tokq: q tokens -> the projected output rows before they go out (mma);
//         with tokk the f32 scores, later probabilities (FMA)
//   qp:   Qp -> O
struct FwdPlan {
  int ld;
  size_t tokq, tokk, qp, kp, vp, stage, total;
  __host__ __device__ FwdPlan(const Layout& L, int d, size_t stage_bytes, size_t es) {
    ld = L.use_mma ? d + 8 : d;
    const size_t qrows = align128((size_t)L.nqp * ld * es);
    const size_t krows = align128((size_t)L.nk_tot * ld * es);
    const size_t scores =
        L.use_mma ? 0 : align128((size_t)L.tot_heads * L.nqp * L.nk * sizeof(float));
    size_t o = 0;
    tokq = o; o += qrows;
    tokk = o; o += krows;
    if (o < scores) o = scores;
    qp = o; o += qrows;
    kp = o; o += krows;
    vp = o; o += krows;
    stage = o; o += align128(stage_bytes);
    total = o;
  }
};

// Pointers into the shared memory of one forward CTA (FwdPlan).
template <typename T>
struct FwdSmem {
  int ld;
  T *tokq, *tokk, *Qp, *Kp, *Vp;
  float* S;
  unsigned char* stage;
  __device__ __forceinline__ FwdSmem(unsigned char* smem_raw, const FwdPlan& P) {
    ld = P.ld;
    tokq = (T*)(smem_raw + P.tokq);
    tokk = (T*)(smem_raw + P.tokk);
    S = (float*)smem_raw;
    Qp = (T*)(smem_raw + P.qp);
    Kp = (T*)(smem_raw + P.kp);
    Vp = (T*)(smem_raw + P.vp);
    stage = smem_raw + P.stage;
  }
};

// One window's forward on the tensor cores (bf16, L.use_mma); a.wt are the
// four projection weights transposed ([output][input] channel), so that every
// weight fragment is two 4-byte global loads.
template <typename A>
__device__ void window_forward_mma(const A& a, const Layout& L,
                                   const FwdSmem<BF>& s, const float* kb,
                                   BF* gout) {
  const int d = a.d, nq = a.nq, groups = a.groups, ld = s.ld;
  const int nk_tot = L.nk_tot, nk = L.nk, ph = L.ph, nqp = L.nqp;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int tq = nqp / 16;
  project_strips(s.tokq, (const BF*)a.wt[0], nullptr, nullptr, (const BF*)a.b[0], s.Qp, nqp, ld, L, d, groups);
  project_strips(s.tokk, (const BF*)a.wt[1], nullptr, nullptr, (const BF*)a.b[1], s.Kp, nk_tot, ld, L, d, groups);
  project_strips(s.tokk, (const BF*)a.wt[2], nullptr, nullptr, (const BF*)a.b[2], s.Vp, nk_tot, ld, L, d, groups);
  __syncthreads();
  // per (head, 16 queries), in one warp: scores, softmax, O. O takes the
  // unit's own tile of Qp, which only this warp reads, and only before.
  for (int u = warp; u < L.tot_heads * tq; u += NWARP) {
    const int h = u / tq, q0 = (u % tq) * 16;
    const int key0 = L.head_group[h] * nk, ch0 = h * ph;
    float p[MAXNKT][4];
    uint32_t pa[MAXNKT / 2][4];
    unit_softmax(s.Qp, s.Kp, ld, q0, ch0, key0, nk, ph, kb, a.scale, lane, p);
    unit_pack(p, nk, pa);
    unit_value(pa, s.Vp, s.Qp, ld, q0, ch0, key0, nk, ph, lane);
  }
  __syncthreads();
  // output projection over the dead query tokens, then out 16 bytes a
  // thread; rows past nq of a padded tile stay behind
  project_strips(s.Qp, (const BF*)a.wt[3], nullptr, nullptr, (const BF*)a.b[3], s.tokq, nqp, ld, L, d, groups);
  __syncthreads();
  store_rows<BF>(gout, nq, d, ld, s.tokq);
}

// The same as FMA loops (f32, or bf16 layouts the tiles do not fit);
// nqp == nq and ld == d. The scores and probabilities live in shared memory
// as f32 (over the dead tokens), one thread a softmax row.
template <typename T, typename A>
__device__ void window_forward_fma(const A& a, const Layout& L,
                                   const FwdSmem<T>& sm, const float* kb,
                                   T* gout) {
  using E = Elem<T>;
  const int d = a.d, nq = a.nq;
  const int nk_tot = L.nk_tot, nk = L.nk, ph = L.ph, H = L.tot_heads;
  float* S = sm.S;
  T* Qp = sm.Qp;
  T* Kp = sm.Kp;
  T* Vp = sm.Vp;
  project<T>(sm.tokq, nq, (const T*)a.w[0], (const T*)a.b[0], Qp, L, d, a.groups, nullptr);
  project<T>(sm.tokk, nk_tot, (const T*)a.w[1], (const T*)a.b[1], Kp, L, d, a.groups, nullptr);
  project<T>(sm.tokk, nk_tot, (const T*)a.w[2], (const T*)a.b[2], Vp, L, d, a.groups, nullptr);
  __syncthreads();

  // scores over each head's own key stripe, then row softmax
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
    const float den = sum + 1e-30f;
    for (int j = 0; j < nk; ++j) sr[j] = E::round(sr[j] / den);
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

  // output projection straight to global memory
  project<T>(O, nq, (const T*)a.w[3], (const T*)a.b[3], nullptr, L, d, a.groups, gout);
}

// The per-window forward from the tokens in shared memory (sm.tokq, sm.tokk,
// as assemble_staged/load_rows leave them; the caller has synchronised) to
// the nq output rows in global memory:
//   q/k/v projections with the block-diagonal weights, f32 accumulation,
//   + bias, rounded to T; per head the scores against its own group's key
//   stripe, * scale + kb, softmax in f32, weights rounded to T, value product
//   in f32, O rounded to T; output projection + bias, written in T.
// `a` supplies w[4], wt[4], b[4], scale, nq, d, groups.
template <typename T, typename A>
__device__ __forceinline__ void window_forward(const A& a, const Layout& L,
                                               const FwdSmem<T>& sm,
                                               const float* kb, T* gout) {
  if constexpr (std::is_same<T, BF>::value) {
    if (L.use_mma) {
      window_forward_mma(a, L, sm, kb, gout);
      return;
    }
  }
  window_forward_fma<T>(a, L, sm, kb, gout);
}

// Launches a forward kernel over nw windows, one CTA a window. (A fixed grid
// of CTAs that walk the windows, the backwards' form, measured 5-7% slower
// for both forwards at block 0 of mssvt.yaml on an H100: PERF.md.)
template <typename K, typename A>
int launch_forward(K kernel, const A& a, const Layout& L, size_t smem, int nw,
                   cudaStream_t stream) {
  if (smem > 227 * 1024) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<nw, NT, smem, stream>>>(a, L);
  return launch_status();
}

}  // namespace
