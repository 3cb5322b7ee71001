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
// (~15 us at 3.35 TB/s; the tensor-core bound is ~6.5 us). The mma.sync
// kernel below stays well above it: each K/V tile is loaded synchronously
// between two barriers, nothing overlaps the loads with the products, and
// mma.sync reaches a fraction of the tensor cores' rate.
//
// What the design does about it: the TPU grid's innermost kv axis, which
// carried m/l/acc in scratch from step to step, becomes a loop inside one
// block (blocks run in parallel on the card, nothing carries between them).
// kv tiles that are masked for every row of the q tile (above the causal
// diagonal, or before the window) are skipped. Inputs are addressed through
// (batch, head, seq) strides with a unit head-dim stride, so model-layout
// (B,S,H,D) tensors are read in place with no transpose. Three kernels, a
// fixed choice by dtype, head dim and alignment that the caller is told
// (pick_instance):
//
// - bf16, D in {64, 96, 112, 128} with 16-byte aligned rows (phi3's and
//   zamba2's prefill): wgmma fed by a TMA ring of K/V tiles from a producer
//   warp; described at flash_fwd_wgmma_kernel.
// - bf16, any other head dim (gemma2's 256) or unaligned rows: tensor
//   cores through mma.sync m16n8k16
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

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <dlfcn.h>
#include <stdint.h>
#include <stdio.h>

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
// bf16, D in {64, 96, 112, 128}, 16-byte aligned rows: wgmma fed by TMA
// ---------------------------------------------------------------------------
//
// One block per (q tile of 64 rows, q head, batch row): one consumer
// warpgroup (warps 0-3) and one producer warp (warp 4). The producer's lane
// 0 loads Q once and then every K/V tile of the block's kv range into a
// ring of kStages stages by TMA (cp.async.bulk.tensor), each stage with a
// "full" mbarrier (TMA bytes arrive) and an "empty" one (the 128 consumer
// threads arrive when their products have read it). The consumers run
// S = Q K^T as wgmma m64n64k16 from shared memory, the online softmax in
// registers (exp2 with log2(e) folded into the scaled scores), then
// O += P V as wgmma m64nDk16 with P from registers: the S accumulator's
// fragment for keys [16 kk, 16 kk + 16) is the A fragment of that k-step,
// and V is read MN-major (transposed) from the row-major tile TMA wrote.
// P keeps the hi/lo bf16 split of the mma.sync kernel (two products per
// k-step). Q/K/V tiles are stored as column blocks ("atoms") of W = 64, 32
// or 16 columns (the widest that divides D) with the matching 128-, 64- or
// 32-byte swizzle, so every product runs at N = D with no padded columns:
// D = 96 is three 32-column atoms, D = 112 seven 16-column atoms. The
// tensor maps are built per call on the host from the (D, H, S, B) strides
// of the model layout; rows past S or T arrive as zeros. q tiles run
// longest first (the causal diagonal's last tile has the most kv tiles).

constexpr int kWgThreads = 160;   // consumer warpgroup + producer warp
constexpr int kStages = 2;        // K/V ring depth
constexpr float kLog2e = 1.4426950408889634f;

__host__ __device__ constexpr int atom_cols(int D) {
  return D % 64 == 0 ? 64 : (D % 32 == 0 ? 32 : 16);
}

template <int D>
constexpr size_t wgmma_smem_bytes() {
  // 1024 bytes of alignment slack, Q + kStages x (K, V) tiles, barriers
  return 1024 + size_t(64) * D * 2 * (1 + 2 * kStages) + 8 * (1 + 2 * kStages);
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}
// Wait until the phase of parity `parity` of the barrier has completed.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  }
}

// One box of the 4-D tensor map into shared memory, completing on `bar`.
__device__ __forceinline__ void tma_load_4d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3, %4, %5}], [%6];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2), "r"(c3), "r"(bar)
      : "memory");
}

// wgmma shared-memory descriptor: start address, leading and stride byte
// offsets (16-byte units) and the swizzle (1 = 128 B, 2 = 64 B, 3 = 32 B).
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo, uint32_t sbo,
                                              uint64_t swizzle) {
  return uint64_t((addr & 0x3FFFF) >> 4) | (uint64_t((lbo >> 4) & 0x3FFF) << 16) |
         (uint64_t((sbo >> 4) & 0x3FFF) << 32) | (swizzle << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// Keep the compiler from moving reads or writes of accumulator registers
// across an asynchronous wgmma.
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

// d (64 x 64, fp32) (+)= A (64 x 16, smem, K-major) * B (64 x 16, smem,
// K-major); scale_d = 0 overwrites d.
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t da, uint64_t db,
                                             int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d));
}

// d (64 x 64, fp32) += A (64 x 16, bf16 registers) * B (16 x 64, smem,
// MN-major)
__device__ __forceinline__ void wgmma_rs(float (&d)[32], uint32_t a0, uint32_t a1, uint32_t a2,
                                         uint32_t a3, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(db), "r"(1));
}

// d (64 x 96, fp32) += A (64 x 16, bf16 registers) * B (16 x 96, smem,
// MN-major)
__device__ __forceinline__ void wgmma_rs(float (&d)[48], uint32_t a0, uint32_t a1, uint32_t a2,
                                         uint32_t a3, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %53, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n96k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47}, "
      "{%48, %49, %50, %51}, %52, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(db), "r"(1));
}

// d (64 x 112, fp32) += A (64 x 16, bf16 registers) * B (16 x 112, smem,
// MN-major)
__device__ __forceinline__ void wgmma_rs(float (&d)[56], uint32_t a0, uint32_t a1, uint32_t a2,
                                         uint32_t a3, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %61, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n112k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55}, "
      "{%56, %57, %58, %59}, %60, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(db), "r"(1));
}

// d (64 x 128, fp32) += A (64 x 16, bf16 registers) * B (16 x 128, smem,
// MN-major)
__device__ __forceinline__ void wgmma_rs(float (&d)[64], uint32_t a0, uint32_t a1, uint32_t a2,
                                         uint32_t a3, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(db), "r"(1));
}


// Where the producer puts each coordinate: the tensor map's dims after the
// unit-stride D are H, S and B sorted by stride; pos_h/pos_s/pos_b give
// each one's place among dims 1..3.
struct MapOrder {
  int pos_h, pos_s, pos_b;
};

template <int D>
__global__ void __launch_bounds__(kWgThreads) flash_fwd_wgmma_kernel(
    const __grid_constant__ CUtensorMap tm_q, const __grid_constant__ CUtensorMap tm_k,
    const __grid_constant__ CUtensorMap tm_v, const MapOrder ord_q, const MapOrder ord_kv,
    const FlashArgs a) {
  constexpr int W = atom_cols(D);
  constexpr uint64_t kSwizzle = W == 64 ? 1 : (W == 32 ? 2 : 3);
  constexpr uint32_t kTile = 64 * D * 2;   // bytes of a 64-row tile
  constexpr uint32_t kAtom = 64 * W * 2;   // bytes of one column block
  constexpr uint32_t kSbo = 8 * W * 2;     // 8 rows of one column block
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t sq = base;
  const uint32_t bar_q = base + kTile * (1 + 2 * kStages);
  const uint32_t bar_full = bar_q + 8, bar_empty = bar_full + 8 * kStages;

  const int tid = threadIdx.x;
  const int h = blockIdx.x, b = blockIdx.y;
  const int q0 = (gridDim.z - 1 - blockIdx.z) * kBQ;   // longest tiles first
  const int hk = h / (a.Hq / a.Hkv);
  int k_beg, k_end;
  kv_range(a, q0, &k_beg, &k_end);
  const int n_tiles = k_end > k_beg ? (k_end - k_beg + kBK - 1) / kBK : 0;

  if (tid == 0) {
    mbar_init(bar_q, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(bar_full + 8 * s, 1);
      mbar_init(bar_empty + 8 * s, 128);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (tid >= 128) {
    // producer: lane 0 of warp 4 issues every load
    if (tid == 128) {
      int cq[4], ck[4];
      cq[1 + ord_q.pos_h] = h;
      cq[1 + ord_q.pos_s] = q0;
      cq[1 + ord_q.pos_b] = b;
      mbar_expect_tx(bar_q, kTile);
#pragma unroll
      for (int c = 0; c < D / W; ++c)
        tma_load_4d(sq + c * kAtom, &tm_q, bar_q, c * W, cq[1], cq[2], cq[3]);
      ck[1 + ord_kv.pos_h] = hk;
      ck[1 + ord_kv.pos_b] = b;
      for (int i = 0; i < n_tiles; ++i) {
        const int s = i % kStages;
        if (i >= kStages) mbar_wait(bar_empty + 8 * s, ((i / kStages) - 1) & 1);
        const uint32_t sk = base + kTile * (1 + 2 * s), sv = sk + kTile;
        ck[1 + ord_kv.pos_s] = k_beg + i * kBK;
        mbar_expect_tx(bar_full + 8 * s, 2 * kTile);
#pragma unroll
        for (int c = 0; c < D / W; ++c) {
          tma_load_4d(sk + c * kAtom, &tm_k, bar_full + 8 * s, c * W, ck[1], ck[2], ck[3]);
          tma_load_4d(sv + c * kAtom, &tm_v, bar_full + 8 * s, c * W, ck[1], ck[2], ck[3]);
        }
      }
    }
    return;
  }

  // consumers: warp w owns query rows 16 w + g and 16 w + g + 8 of the tile
  const int warp = tid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;
  const int qi[2] = {q0 + warp * 16 + g, q0 + warp * 16 + g + 8};
  float o[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};

  mbar_wait(bar_q, 0);
  for (int i = 0; i < n_tiles; ++i) {
    const int s = i % kStages, k0 = k_beg + i * kBK;
    const uint32_t sk = base + kTile * (1 + 2 * s), sv = sk + kTile;
    mbar_wait(bar_full + 8 * s, (i / kStages) & 1);

    // S = Q K^T (64 x 64), k-steps of 16 head-dim columns
    float sc[32];
#pragma unroll
    for (int j = 0; j < 32; ++j) sc[j] = 0.f;
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < D / 16; ++ks) {
      const uint32_t off = (ks * 16 / W) * kAtom + (ks * 16 % W) * 2;
      wgmma_ss_n64(sc, smem_desc(sq + off, 16, kSbo, kSwizzle),
                   smem_desc(sk + off, 16, kSbo, kSwizzle), ks > 0);
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(sc);

    // online softmax in the log2 domain; the 4 lanes of a quad share rows
    float mx[2] = {kNegInf, kNegInf};
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1, kj = k0 + n * 8 + 2 * t + (e & 1);
        const float x = masked_score(a, sc[4 * n + e], qi[r], kj);
        sc[4 * n + e] = x == kNegInf ? kNegInf : x * kLog2e;
        mx[r] = fmaxf(mx[r], sc[4 * n + e]);
      }
    float alpha[2], rs[2] = {0.f, 0.f};
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float m_new = fmaxf(m[r], mx[r]);
      alpha[r] = exp2f(m[r] - m_new);
      m[r] = m_new;
    }
#pragma unroll
    for (int j = 0; j < 32; ++j) {
      sc[j] = exp2f(sc[j] - m[(j >> 1) & 1]);
      rs[(j >> 1) & 1] += sc[j];
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      rs[r] += __shfl_xor_sync(0xffffffffu, rs[r], 1);
      rs[r] += __shfl_xor_sync(0xffffffffu, rs[r], 2);
      l[r] = alpha[r] * l[r] + rs[r];
    }
#pragma unroll
    for (int j = 0; j < D / 2; ++j) o[j] *= alpha[(j >> 1) & 1];

    // O += P V = P_lo V + P_hi V, k-steps of 16 keys; V read MN-major
    uint32_t hi[4][4], lo[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int f = 0; f < 4; ++f)
        split_bf16(sc[8 * kk + 2 * f], sc[8 * kk + 2 * f + 1], hi[kk][f], lo[kk][f]);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const uint64_t dv = smem_desc(sv + kk * 16 * W * 2, kAtom, kSbo, kSwizzle);
      wgmma_rs(o, lo[kk][0], lo[kk][1], lo[kk][2], lo[kk][3], dv);
      wgmma_rs(o, hi[kk][0], hi[kk][1], hi[kk][2], hi[kk][3], dv);
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(o);
    mbar_arrive(bar_empty + 8 * s);
  }

  __nv_bfloat16* op = static_cast<__nv_bfloat16*>(a.o) + b * a.o_sb + h * a.o_sh;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (qi[r] >= a.S) continue;
    const float inv = 1.f / (l[r] == 0.f ? 1.f : l[r]);
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      const __nv_bfloat162 v2 =
          __floats2bfloat162_rn(o[4 * n + 2 * r] * inv, o[4 * n + 2 * r + 1] * inv);
      *reinterpret_cast<__nv_bfloat162*>(op + qi[r] * a.o_ss + n * 8 + 2 * t) = v2;
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

// cuTensorMapEncodeTiled from the libcuda.so.1 the process has loaded (the
// kernel library links only the CUDA runtime).
using EncodeTiledFn = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                   const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                   const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                   CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiledFn encode_tiled() {
  static EncodeTiledFn fn = [] {
    void* h = dlopen("libcuda.so.1", RTLD_NOW | RTLD_NOLOAD);
    if (h == nullptr) h = dlopen("libcuda.so.1", RTLD_NOW);
    return h == nullptr ? nullptr
                        : reinterpret_cast<EncodeTiledFn>(dlsym(h, "cuTensorMapEncodeTiled"));
  }();
  return fn;
}

// Error codes past the CUDA runtime's: a tensor map libcuda refused.
constexpr int kTensorMapError = 100000;

// A 4-D tensor map over a bf16 (B, H, rows, D) view with a unit D stride:
// dim 0 is D, dims 1-3 are H, rows and B sorted by stride. A box is W
// columns of 64 rows, swizzled to match the wgmma descriptors.
int make_map(CUtensorMap* map, MapOrder* ord, const void* ptr, int D, int W, int H, int rows,
             int B, long long sb, long long sh, long long ss) {
  const EncodeTiledFn fn = encode_tiled();
  if (fn == nullptr) return kTensorMapError + 999;
  const long long st[3] = {sh, ss, sb};
  const cuuint64_t ext[3] = {cuuint64_t(H), cuuint64_t(rows), cuuint64_t(B)};
  int idx[3] = {0, 1, 2};
  for (int i = 1; i < 3; ++i)
    for (int j = i; j > 0 && st[idx[j]] < st[idx[j - 1]]; --j) {
      const int tmp = idx[j];
      idx[j] = idx[j - 1];
      idx[j - 1] = tmp;
    }
  cuuint64_t dims[4] = {cuuint64_t(D), 0, 0, 0};
  cuuint64_t strides[3];
  cuuint32_t box[4] = {cuuint32_t(W), 1, 1, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  int pos[3];
  for (int i = 0; i < 3; ++i) {
    dims[1 + i] = ext[idx[i]];
    strides[i] = cuuint64_t(st[idx[i]]) * 2;
    if (idx[i] == 1) box[1 + i] = kBK;
    pos[idx[i]] = i;
  }
  *ord = MapOrder{pos[0], pos[1], pos[2]};
  const CUtensorMapSwizzle swz = W == 64 ? CU_TENSOR_MAP_SWIZZLE_128B
                                 : W == 32 ? CU_TENSOR_MAP_SWIZZLE_64B
                                           : CU_TENSOR_MAP_SWIZZLE_32B;
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), dims,
                        strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE, swz,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : kTensorMapError + int(r);
}

template <int D>
int launch_wgmma(const FlashArgs& a, cudaStream_t stream) {
  constexpr int W = atom_cols(D);
  CUtensorMap tq, tk, tv;
  MapOrder oq, ok, ov;
  int err = make_map(&tq, &oq, a.q, D, W, a.Hq, a.S, a.B, a.q_sb, a.q_sh, a.q_ss);
  if (err == 0) err = make_map(&tk, &ok, a.k, D, W, a.Hkv, a.T, a.B, a.k_sb, a.k_sh, a.k_ss);
  if (err == 0) err = make_map(&tv, &ov, a.v, D, W, a.Hkv, a.T, a.B, a.v_sb, a.v_sh, a.v_ss);
  if (err != 0) return err;
  if (ok.pos_h != ov.pos_h || ok.pos_s != ov.pos_s || ok.pos_b != ov.pos_b)
    return int(cudaErrorInvalidValue);   // k and v must order their strides alike
  const size_t smem = wgmma_smem_bytes<D>();
  cudaError_t e = cudaFuncSetAttribute(flash_fwd_wgmma_kernel<D>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (e != cudaSuccess) return int(e);
  const dim3 grid(a.Hq, a.B, (a.S + kBQ - 1) / kBQ);
  flash_fwd_wgmma_kernel<D><<<grid, kWgThreads, smem, stream>>>(tq, tk, tv, oq, ok, a);
  return int(cudaGetLastError());
}

// The kernel instance a call takes, a fixed choice by dtype, head dim and
// alignment (reported to the caller, never a fallback on error):
// 0 = fp32 FMA, 1 = bf16 mma.sync, 2 = bf16 wgmma + TMA.
int pick_instance(const FlashArgs& a, int dtype) {
  if (dtype == 0) return 0;
  const bool head = a.D == 64 || a.D == 96 || a.D == 112 || a.D == 128;
  const bool out_ok = reinterpret_cast<uintptr_t>(a.o) % 4 == 0 &&
                      (a.o_sb | a.o_sh | a.o_ss) % 2 == 0;
  const bool strides_ok = a.q_sb > 0 && a.q_sh > 0 && a.q_ss > 0 && a.k_sb > 0 && a.k_sh > 0 &&
                          a.k_ss > 0 && a.v_sb > 0 && a.v_sh > 0 && a.v_ss > 0;
  return head && a.vec && out_ok && strides_ok ? 2 : 1;
}

int dispatch_wgmma(const FlashArgs& a, cudaStream_t st) {
  switch (a.D) {
    case 64: return launch_wgmma<64>(a, st);
    case 96: return launch_wgmma<96>(a, st);
    case 112: return launch_wgmma<112>(a, st);
    case 128: return launch_wgmma<128>(a, st);
    default: return int(cudaErrorInvalidValue);
  }
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
// is 1. *instance receives the kernel instance taken (see pick_instance).
// Returns cudaGetLastError() after the launch (0 on success), or
// kTensorMapError + libcuda's CUresult if a TMA descriptor was refused.
extern "C" int flash_attention_fwd(
    const void* q, const void* k, const void* v, void* o, int dtype,
    int B, int Hq, int Hkv, int S, int T, int D,
    long long q_sb, long long q_sh, long long q_ss,
    long long k_sb, long long k_sh, long long k_ss,
    long long v_sb, long long v_sh, long long v_ss,
    long long o_sb, long long o_sh, long long o_ss,
    float scale, int causal, int window, float cap, int* instance, void* stream) {
  const uintptr_t ptrs = reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
                         reinterpret_cast<uintptr_t>(v);
  const long long strides = q_sb | q_sh | q_ss | k_sb | k_sh | k_ss | v_sb | v_sh | v_ss;
  const int vec = ptrs % 16 == 0 && strides % 8 == 0 && D % 8 == 0;
  FlashArgs a{q, k, v, o, B, Hq, Hkv, S, T, D,
              q_sb, q_sh, q_ss, k_sb, k_sh, k_ss, v_sb, v_sh, v_ss, o_sb, o_sh, o_ss,
              scale, causal, window, cap, vec};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype != 0 && dtype != 1) return int(cudaErrorInvalidValue);
  *instance = pick_instance(a, dtype);
  if (*instance == 0) return dispatch_f32(a, st);
  if (*instance == 2) return dispatch_wgmma(a, st);
  return dispatch_bf16(a, st);
}

extern "C" const char* hyperoffload_cuda_error_string(int err) {
  if (err >= kTensorMapError) {
    static thread_local char msg[96];
    snprintf(msg, sizeof msg, "cuTensorMapEncodeTiled failed (CUresult %d%s)",
             err - kTensorMapError,
             err - kTensorMapError == 999 ? ": no cuTensorMapEncodeTiled in libcuda.so.1" : "");
    return msg;
  }
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
