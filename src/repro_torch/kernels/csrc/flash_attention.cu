// Flash attention (prefill) for Hopper (sm_90a), written by hand.
//
// Replaces: the Pallas TPU kernel repro/kernels/flash_attention.py,
// function flash_attention_pallas (its body _flash_kernel). Same function:
// online-softmax attention of q (B,Hq,S,D) over k/v (B,Hkv,T,D); GQA by
// kv head = q head / G; causal mask kj <= qi; sliding window kj > qi - window;
// logit cap cap*tanh(s/cap); finite NEG_INF masking; l == 0 -> 1 guard;
// fp32 accumulation, output in the input type (fp32 or bf16).
//
// What bounds it on this card: at the serving prefill shapes (B=4, H=32,
// S=T=512, D=96, bf16, causal) the function moves ~50 MB (q, k, v read once,
// o written once) and does ~6.4 GFLOP, so the H100's bound is memory
// (~15 us at 3.35 TB/s; the tensor-core bound is ~6.5 us). In practice this
// first version is bounded by staging K/V through shared memory element by
// element and by the per-tile softmax, well above either bound; TMA, wgmma
// and a pipelined K/V ring come later.
//
// What the design does about it: the TPU grid's innermost kv axis, which
// carried m/l/acc in scratch from step to step, becomes a loop inside one
// block (blocks run in parallel on the card, nothing carries between them).
// kv tiles that are masked for every row of the q tile (above the causal
// diagonal, or before the window) are skipped. Inputs are addressed through
// (batch, head, seq) strides with a unit head-dim stride, so model-layout
// (B,S,H,D) tensors are read in place with no transpose. Two kernels:
//
// - bf16 (the serving path): tensor cores through mma.sync m16n8k16
//   (bf16 in, fp32 accumulate). One block of 4 warps per (q tile of 64
//   rows, q head, batch); each warp owns 16 query rows. Q and each 64-key
//   K and V tile sit in shared memory as bf16, loaded 16 bytes a thread
//   where rows are aligned, with rows padded by 8 elements so a warp's
//   fragment reads (32-bit for Q and K, ldmatrix.trans for V) hit distinct
//   banks. Scores and the output accumulator stay in fp32
//   registers in the mma fragment layout. The TPU kernel multiplies fp32
//   probabilities into V; rounding them to bf16 for the tensor cores (as
//   FlashAttention-2 does) loses 9 bits per probability and doubles the
//   kernel's error against its plain version at the serving shape. So
//   each probability is split into two bf16 parts, hi = bf16(p) and
//   lo = bf16(p - hi), and P.V = hi.V + lo.V takes two mma per tile:
//   about 16 bits of p survive, at one extra mma per P.V product.
// - fp32: the same tiling with fp32 FMA on the CUDA cores, so fp32 inputs
//   keep fp32 products (tensor cores would round them to TF32). 256 threads
//   per 64-row tile; each thread owns a 4x4 register tile of scores and a
//   4 x D/16 tile of the output; K rows padded to an odd stride.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -2.3819763e38f;
constexpr int kBQ = 64;            // query rows per block
constexpr int kBK = 64;            // keys per kv tile
constexpr int kF32Threads = 256;   // fp32 kernel: 16 x 16 threads
constexpr int kMmaThreads = 128;   // bf16 kernel: 4 warps x 16 query rows
constexpr int kPST = kBK + 1;      // fp32 probability tile row stride

struct FlashArgs {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  int B, Hq, Hkv, S, T, D;
  long long q_sb, q_sh, q_ss;
  long long k_sb, k_sh, k_ss;
  long long v_sb, v_sh, v_ss;
  long long o_sb, o_sh, o_ss;
  float scale;
  int causal;
  int window;   // <= 0: no sliding window
  float cap;    // <= 0: no logit cap
  int vec;      // 16-byte aligned rows and D % 8 == 0: 16-byte tile loads
};

// The kv tiles [k_beg, k_end) that hold any valid key for query rows
// [q0, q0 + kBQ). The rest are masked for every row and skipped: the output
// is the same, since the first partly valid tile's alpha = 0 wipes whatever
// a fully masked row accumulated with the finite NEG_INF.
__device__ __forceinline__ void kv_range(const FlashArgs& a, int q0, int* k_beg, int* k_end) {
  int end = a.T;
  if (a.causal) end = min(end, q0 + kBQ);
  int beg = 0;
  if (a.window > 0) beg = max(0, q0 - a.window + 1);
  *k_beg = (beg / kBK) * kBK;
  *k_end = end;
}

// Scaled, capped and masked score of query row qi against key kj.
__device__ __forceinline__ float masked_score(const FlashArgs& a, float dot, int qi, int kj) {
  float x = dot * a.scale;
  if (a.cap > 0.f) x = a.cap * tanhf(x / a.cap);
  bool ok = kj < a.T;
  if (a.causal) ok = ok && kj <= qi;
  if (a.window > 0) ok = ok && kj > qi - a.window;
  return ok ? x : kNegInf;
}

// ---------------------------------------------------------------------------
// bf16: tensor cores (mma.sync m16n8k16, fp32 accumulate)
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint32_t ld_pair(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// The pair (x, y) as hi + lo, each a packed bf16x2: hi = bf16(x, y),
// lo = bf16((x, y) - hi), so hi + lo holds about 16 bits of each value.
__device__ __forceinline__ void split_bf16(float x, float y, uint32_t& hi, uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x, y);
  const float2 hf = __bfloat1622float2(h);
  const __nv_bfloat162 r = __floats2bfloat162_rn(x - hf.x, y - hf.y);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = *reinterpret_cast<const uint32_t*>(&r);
}

// d += a (16x16, row-major) * b (16x8, column-major), fp32 accumulators.
__device__ __forceinline__ void mma_bf16(float (&d)[4], uint32_t a0, uint32_t a1, uint32_t a2,
                                         uint32_t a3, uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// Four 8x8 bf16 matrices, transposed: lanes 8i..8i+7 give the row
// addresses of matrix i, and each lane receives the pair (rows 2t, 2t+1,
// column g) of every matrix: the B fragment of a row-major tile.
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const __nv_bfloat16* p) {
  const unsigned addr = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

template <int NKS>
constexpr size_t mma_smem_bytes() {
  // Qs (BQ x DP+8) + Ks, Vs (BK x DP+8), bf16
  return sizeof(__nv_bfloat16) * size_t(kBQ + 2 * kBK) * (NKS * 16 + 8);
}

// Rows [row0, row0 + 64) of a bf16 matrix (row stride ld elements) into a
// shared tile of row stride ST, zero past n_rows and past column D.
template <int DP, int ST>
__device__ __forceinline__ void load_tile(__nv_bfloat16* dst, const __nv_bfloat16* src,
                                          long long ld, int row0, int n_rows, int D,
                                          bool vec, int tid) {
  static_assert(kBQ == kBK, "one loader serves Q, K and V tiles");
  if (vec) {
    constexpr int CH = DP / 8;   // 16-byte chunks per row
    for (int i = tid; i < kBK * CH; i += kMmaThreads) {
      const int r = i / CH, c = (i % CH) * 8, gr = row0 + r;
      uint4 x = make_uint4(0u, 0u, 0u, 0u);
      if (gr < n_rows && c < D) x = *reinterpret_cast<const uint4*>(src + gr * ld + c);
      *reinterpret_cast<uint4*>(dst + r * ST + c) = x;
    }
  } else {
    const __nv_bfloat16 zero = __float2bfloat16(0.f);
    for (int i = tid; i < kBK * DP; i += kMmaThreads) {
      const int r = i / DP, c = i % DP, gr = row0 + r;
      dst[r * ST + c] = (gr < n_rows && c < D) ? src[gr * ld + c] : zero;
    }
  }
}

// NKS = padded head dim / 16: the k-steps of the Q.K^T product.
//
// Fragment layout of mma.m16n8k16 (lane = 4 g + t): A holds rows g and
// g + 8, columns 2t, 2t+1 (a0, a1) and 2t+8, 2t+9 (a2, a3); B holds k rows
// 2t, 2t+1 (b0) and 2t+8, 2t+9 (b1) of column g; C holds rows g (c0, c1)
// and g + 8 (c2, c3), columns 2t, 2t+1.
template <int NKS>
__global__ void __launch_bounds__(kMmaThreads) flash_fwd_bf16_kernel(const FlashArgs a) {
  constexpr int DP = NKS * 16;    // head dim padded to a multiple of 16
  constexpr int NT = DP / 8;      // output column tiles of 8
  constexpr int QST = DP + 8;     // row stride (elements): conflict-free reads
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem_raw);  // kBQ x QST
  __nv_bfloat16* Ks = Qs + kBQ * QST;                              // kBK x QST
  __nv_bfloat16* Vs = Ks + kBK * QST;                              // kBK x QST

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int q0 = blockIdx.x * kBQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / (a.Hq / a.Hkv);

  const __nv_bfloat16* qp = static_cast<const __nv_bfloat16*>(a.q) + b * a.q_sb + h * a.q_sh;
  const __nv_bfloat16* kp = static_cast<const __nv_bfloat16*>(a.k) + b * a.k_sb + hk * a.k_sh;
  const __nv_bfloat16* vp = static_cast<const __nv_bfloat16*>(a.v) + b * a.v_sb + hk * a.v_sh;
  __nv_bfloat16* op = static_cast<__nv_bfloat16*>(a.o) + b * a.o_sb + h * a.o_sh;

  load_tile<DP, QST>(Qs, qp, a.q_ss, q0, a.S, a.D, a.vec, tid);

  const int row = warp * 16 + g;            // this lane's rows: row, row + 8
  const int qi[2] = {q0 + row, q0 + row + 8};
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
  float o[NT][4];
#pragma unroll
  for (int n = 0; n < NT; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;

  int k_beg, k_end;
  kv_range(a, q0, &k_beg, &k_end);
  for (int k0 = k_beg; k0 < k_end; k0 += kBK) {
    __syncthreads();   // every warp is done with the previous tile
    load_tile<DP, QST>(Ks, kp, a.k_ss, k0, a.T, a.D, a.vec, tid);
    load_tile<DP, QST>(Vs, vp, a.v_ss, k0, a.T, a.D, a.vec, tid);
    __syncthreads();

    // S = Q K^T for this warp's 16 rows x 64 keys (8 tiles of 8 keys)
    float s[8][4];
#pragma unroll
    for (int n = 0; n < 8; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
#pragma unroll
    for (int ks = 0; ks < NKS; ++ks) {
      const __nv_bfloat16* qa = Qs + row * QST + ks * 16 + 2 * t;
      const uint32_t a0 = ld_pair(qa), a1 = ld_pair(qa + 8 * QST);
      const uint32_t a2 = ld_pair(qa + 8), a3 = ld_pair(qa + 8 * QST + 8);
#pragma unroll
      for (int n = 0; n < 8; ++n) {
        const __nv_bfloat16* kb = Ks + (n * 8 + g) * QST + ks * 16 + 2 * t;
        mma_bf16(s[n], a0, a1, a2, a3, ld_pair(kb), ld_pair(kb + 8));
      }
    }

    // online softmax; the 4 lanes of a quad (same g) share rows g and g + 8
    float mx[2] = {kNegInf, kNegInf};
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1, kj = k0 + n * 8 + 2 * t + (e & 1);
        s[n][e] = masked_score(a, s[n][e], qi[r], kj);
        mx[r] = fmaxf(mx[r], s[n][e]);
      }
    float alpha[2], rs[2] = {0.f, 0.f};
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float m_new = fmaxf(m[r], mx[r]);
      alpha[r] = expf(m[r] - m_new);
      m[r] = m_new;
    }
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[n][e] = expf(s[n][e] - m[e >> 1]);
        rs[e >> 1] += s[n][e];
      }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      rs[r] += __shfl_xor_sync(0xffffffffu, rs[r], 1);
      rs[r] += __shfl_xor_sync(0xffffffffu, rs[r], 2);
      l[r] = alpha[r] * l[r] + rs[r];
    }
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      o[n][0] *= alpha[0];
      o[n][1] *= alpha[0];
      o[n][2] *= alpha[1];
      o[n][3] *= alpha[1];
    }

    // O += P V = P_hi V + P_lo V: the score tiles 2kk, 2kk+1 (C layout)
    // are exactly the A fragment of keys [16 kk, 16 kk + 16)
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk) {
      uint32_t h[4], r[4];
      split_bf16(s[2 * kk][0], s[2 * kk][1], h[0], r[0]);
      split_bf16(s[2 * kk][2], s[2 * kk][3], h[1], r[1]);
      split_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1], h[2], r[2]);
      split_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3], h[3], r[3]);
      // lane l addresses key row 16 kk + (l & 15) at columns 8 (n + l / 16)
      const __nv_bfloat16* vrow = Vs + (kk * 16 + (lane & 15)) * QST + (lane >> 4) * 8;
#pragma unroll
      for (int n = 0; n < NT; n += 2) {
        uint32_t vb[4];
        ldmatrix_x4_trans(vb, vrow + n * 8);
        mma_bf16(o[n], r[0], r[1], r[2], r[3], vb[0], vb[1]);
        mma_bf16(o[n], h[0], h[1], h[2], h[3], vb[0], vb[1]);
        mma_bf16(o[n + 1], r[0], r[1], r[2], r[3], vb[2], vb[3]);
        mma_bf16(o[n + 1], h[0], h[1], h[2], h[3], vb[2], vb[3]);
      }
    }
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (qi[r] >= a.S) continue;
    const float denom = l[r] == 0.f ? 1.f : l[r];
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = n * 8 + 2 * t + e;
        if (col < a.D) op[qi[r] * a.o_ss + col] = __float2bfloat16(o[n][2 * r + e] / denom);
      }
  }
}

// ---------------------------------------------------------------------------
// fp32: FMA on the CUDA cores
// ---------------------------------------------------------------------------

template <int NC>
constexpr size_t f32_smem_bytes() {
  // Qs (BQ x DP+1) + Ks (BK x DP+1) + Vs (BK x DP) + Ps (BQ x BK+1), fp32
  return sizeof(float) * (size_t(kBQ) * (NC * 16 + 1) + size_t(kBK) * (NC * 16 + 1) +
                          size_t(kBK) * (NC * 16) + size_t(kBQ) * kPST);
}

// NC = padded head dim / 16: the number of output columns each thread owns.
template <int NC>
__global__ void __launch_bounds__(kF32Threads) flash_fwd_f32_kernel(const FlashArgs a) {
  constexpr int DP = NC * 16;   // head dim padded to a multiple of 16
  constexpr int QST = DP + 1;   // odd row strides: conflict-free column reads
  constexpr int KST = DP + 1;
  extern __shared__ float smem[];
  float* Qs = smem;              // kBQ x QST
  float* Ks = Qs + kBQ * QST;    // kBK x KST
  float* Vs = Ks + kBK * KST;    // kBK x DP
  float* Ps = Vs + kBK * DP;     // kBQ x kPST, probabilities of this tile

  const int tid = threadIdx.x;
  const int tx = tid & 15;       // key / output-column lane within a row group
  const int ty = tid >> 4;       // row group: rows ty + 16 i
  const int q0 = blockIdx.x * kBQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / (a.Hq / a.Hkv);

  const float* qp = static_cast<const float*>(a.q) + b * a.q_sb + h * a.q_sh;
  const float* kp = static_cast<const float*>(a.k) + b * a.k_sb + hk * a.k_sh;
  const float* vp = static_cast<const float*>(a.v) + b * a.v_sb + hk * a.v_sh;
  float* op = static_cast<float*>(a.o) + b * a.o_sb + h * a.o_sh;

  for (int i = tid; i < kBQ * DP; i += kF32Threads) {
    const int r = i / DP, c = i % DP, qi = q0 + r;
    Qs[r * QST + c] = (qi < a.S && c < a.D) ? qp[qi * a.q_ss + c] : 0.f;
  }

  float m[4], l[4], acc[4][NC];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < NC; ++c) acc[i][c] = 0.f;
  }

  int k_beg, k_end;
  kv_range(a, q0, &k_beg, &k_end);
  for (int k0 = k_beg; k0 < k_end; k0 += kBK) {
    __syncthreads();   // every thread is done with the previous tile
    for (int i = tid; i < kBK * DP; i += kF32Threads) {
      const int r = i / DP, c = i % DP, kj = k0 + r;
      const bool in = kj < a.T && c < a.D;
      Ks[r * KST + c] = in ? kp[kj * a.k_ss + c] : 0.f;
      Vs[r * DP + c] = in ? vp[kj * a.v_ss + c] : 0.f;
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < DP; ++d) {
      float qa[4], kb[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qa[i] = Qs[(ty + 16 * i) * QST + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) kb[j] = Ks[(tx + 16 * j) * KST + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(qa[i], kb[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qi = q0 + ty + 16 * i;
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = masked_score(a, s[i][j], qi, k0 + tx + 16 * j);
        mx = fmaxf(mx, s[i][j]);
      }
      // the 16 threads of a row are 16 consecutive lanes of one warp
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      const float alpha = expf(m[i] - m_new);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = expf(s[i][j] - m_new);
        Ps[(ty + 16 * i) * kPST + tx + 16 * j] = p;
        rs += p;
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1) rs += __shfl_xor_sync(0xffffffffu, rs, off);
      l[i] = alpha * l[i] + rs;
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < NC; ++c) acc[i][c] *= alpha;
    }
    __syncthreads();   // the whole probability tile is written

#pragma unroll 4
    for (int kk = 0; kk < kBK; ++kk) {
      float pa[4], vb[NC];
#pragma unroll
      for (int i = 0; i < 4; ++i) pa[i] = Ps[(ty + 16 * i) * kPST + kk];
#pragma unroll
      for (int c = 0; c < NC; ++c) vb[c] = Vs[kk * DP + tx + 16 * c];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < NC; ++c) acc[i][c] = fmaf(pa[i], vb[c], acc[i][c]);
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qi = q0 + ty + 16 * i;
    if (qi >= a.S) continue;
    const float denom = l[i] == 0.f ? 1.f : l[i];
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const int col = tx + 16 * c;
      if (col < a.D) op[qi * a.o_ss + col] = acc[i][c] / denom;
    }
  }
}

// ---------------------------------------------------------------------------
// launch
// ---------------------------------------------------------------------------

template <typename Kernel>
int launch(Kernel kernel, size_t smem, int threads, const FlashArgs& a, cudaStream_t stream) {
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return int(err);
  const dim3 grid((a.S + kBQ - 1) / kBQ, a.Hq, a.B);
  kernel<<<grid, threads, smem, stream>>>(a);
  return int(cudaGetLastError());
}

// The head dim is padded to 16, 32, 64, 96, 128 or 256: N = padded / 16.
int dispatch_bf16(const FlashArgs& a, cudaStream_t st) {
  const int n = (a.D + 15) / 16;
  if (n <= 1) return launch(flash_fwd_bf16_kernel<1>, mma_smem_bytes<1>(), kMmaThreads, a, st);
  if (n <= 2) return launch(flash_fwd_bf16_kernel<2>, mma_smem_bytes<2>(), kMmaThreads, a, st);
  if (n <= 4) return launch(flash_fwd_bf16_kernel<4>, mma_smem_bytes<4>(), kMmaThreads, a, st);
  if (n <= 6) return launch(flash_fwd_bf16_kernel<6>, mma_smem_bytes<6>(), kMmaThreads, a, st);
  if (n <= 8) return launch(flash_fwd_bf16_kernel<8>, mma_smem_bytes<8>(), kMmaThreads, a, st);
  if (n <= 16) return launch(flash_fwd_bf16_kernel<16>, mma_smem_bytes<16>(), kMmaThreads, a, st);
  return int(cudaErrorInvalidValue);
}

int dispatch_f32(const FlashArgs& a, cudaStream_t st) {
  const int n = (a.D + 15) / 16;
  if (n <= 1) return launch(flash_fwd_f32_kernel<1>, f32_smem_bytes<1>(), kF32Threads, a, st);
  if (n <= 2) return launch(flash_fwd_f32_kernel<2>, f32_smem_bytes<2>(), kF32Threads, a, st);
  if (n <= 4) return launch(flash_fwd_f32_kernel<4>, f32_smem_bytes<4>(), kF32Threads, a, st);
  if (n <= 6) return launch(flash_fwd_f32_kernel<6>, f32_smem_bytes<6>(), kF32Threads, a, st);
  if (n <= 8) return launch(flash_fwd_f32_kernel<8>, f32_smem_bytes<8>(), kF32Threads, a, st);
  if (n <= 16) return launch(flash_fwd_f32_kernel<16>, f32_smem_bytes<16>(), kF32Threads, a, st);
  return int(cudaErrorInvalidValue);
}

}  // namespace

// dtype: 0 = fp32, 1 = bf16. Strides are in elements; the head-dim stride
// is 1. Returns cudaGetLastError() after the launch (0 on success).
extern "C" int flash_attention_fwd(
    const void* q, const void* k, const void* v, void* o, int dtype,
    int B, int Hq, int Hkv, int S, int T, int D,
    long long q_sb, long long q_sh, long long q_ss,
    long long k_sb, long long k_sh, long long k_ss,
    long long v_sb, long long v_sh, long long v_ss,
    long long o_sb, long long o_sh, long long o_ss,
    float scale, int causal, int window, float cap, void* stream) {
  const uintptr_t ptrs = reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
                         reinterpret_cast<uintptr_t>(v);
  const long long strides = q_sb | q_sh | q_ss | k_sb | k_sh | k_ss | v_sb | v_sh | v_ss;
  const int vec = ptrs % 16 == 0 && strides % 8 == 0 && D % 8 == 0;
  FlashArgs a{q, k, v, o, B, Hq, Hkv, S, T, D,
              q_sb, q_sh, q_ss, k_sb, k_sh, k_ss, v_sb, v_sh, v_ss, o_sb, o_sh, o_ss,
              scale, causal, window, cap, vec};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return dispatch_f32(a, st);
  if (dtype == 1) return dispatch_bf16(a, st);
  return int(cudaErrorInvalidValue);
}

extern "C" const char* hyperoffload_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
