// Split-K decode attention for Hopper (sm_90a): the machinery shared by
// the ring-cache kernel (decode_attention.cu) and the paged kernel
// (paged_attention.cu), written by hand.
//
// One query token per sequence, q (B,Hq,D), over C token rows of K and V.
// A kernel supplies a functor that maps token j to its K and V rows and
// says whether j is valid; everything else lives here. GQA (the G = Hq/Hkv
// query heads of one kv head share every K/V load), logit cap
// cap*tanh(s/cap), finite NEG_INF for invalid rows, l == 0 -> 1 guard, fp32
// accumulation, output in the input type (fp32 or bf16).
//
// What bounds it on this card: decode reads the rows once and does ~4 FLOP
// per K/V element, so memory bounds it (phi3's shapes: ~26 MB, ~8 us at
// 3.35 TB/s). One block per (kv head, row) walking all C rows fills 128 of
// 132 SMs with one long serial loop each.
//
// What the design does about it:
// - The grid is (split, kv head, row). Each block takes a contiguous range
//   of `split` token rows (a multiple of 16, chosen by the wrapper so that
//   the card holds several blocks per SM: phi3's shape gives 9 splits of
//   64, 1152 blocks) and walks it in tiles of at most 64 rows.
// - K and V tiles go to shared memory as 16-byte cp.async copies (8 bf16 or
//   4 fp32 values; neighbouring lanes on neighbouring addresses of a row),
//   double-buffered when a split holds more than one tile, and stay in the
//   input type there: each dot product converts as it multiplies. Rows are
//   padded by 16 bytes so the 16-byte reads of a quarter-warp hit distinct
//   banks. Unaligned inputs take element loads into the same tile.
// - A score is the dot of one row with one pre-scaled fp32 query row, split
//   over up to 8 lanes and summed by warp shuffles; P.V is one output
//   element per thread (or a few threads per element, summed by shuffles,
//   when G*D is small).
// - Each block keeps an online softmax over its tiles and writes its
//   partial (m, l, acc) in fp32 to a scratch buffer. After a
//   __threadfence(), the block takes an atomic ticket for its (row, kv
//   head); the last of the splits to finish merges them: m = max m_i,
//   w_i = exp(m_i - m), out = sum w_i acc_i / sum w_i l_i (l == 0 -> 1),
//   then sets the ticket back to 0 for the next launch. One launch per call:
//   the decode step is host-bound, and a second merge launch would add host
//   time. A split whose rows are all invalid has m_i = NEG_INF and merges
//   with weight exp(NEG_INF - m) = 0 beside a valid split; when every row is
//   invalid all m_i are NEG_INF, every weight is 1, and the output is the
//   mean over all C rows, as the references' uniform softmax gives. Rows
//   past C take no part (every split holds at least one row below C).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -2.3819763e38f;
constexpr float kLog2e = 1.4426950408889634f;
constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxTile = 64;   // rows per shared-memory tile
constexpr size_t kMaxSmem = 232448;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

__device__ __forceinline__ float fexp(float x) { return exp2f(x * kLog2e); }
__device__ __forceinline__ float minus_inf() { return __int_as_float(0xff800000); }

// dot of 16 bytes of a K row (8 bf16 or 4 fp32) with fp32 q values
__device__ __forceinline__ float dot16(const __nv_bfloat16* k, const float* q, float acc) {
  const uint4 raw = *reinterpret_cast<const uint4*>(k);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    acc = fmaf(q[2 * i], f.x, acc);
    acc = fmaf(q[2 * i + 1], f.y, acc);
  }
  return acc;
}
__device__ __forceinline__ float dot16(const float* k, const float* q, float acc) {
  const float4 f = *reinterpret_cast<const float4*>(k);
  acc = fmaf(q[0], f.x, acc);
  acc = fmaf(q[1], f.y, acc);
  acc = fmaf(q[2], f.z, acc);
  return fmaf(q[3], f.w, acc);
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst), "l"(gmem) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

struct SplitArgs {
  const void* q;      // (B, Hq, D): batch stride q_sb, heads contiguous
  void* o;            // (B, Hq, D) contiguous
  float* part;        // (B, Hkv, nsplit, G, D + 2): m, l, acc per split
  int* tickets;       // (B * Hkv), zero between launches
  int B, Hq, Hkv, C, D;   // C: token rows per (row, kv head)
  long long q_sb;
  float scale;
  float cap;          // <= 0: no logit cap
  int split;          // rows per block, a multiple of 16
  int nsplit;         // ceil(C / split)
  int tile;           // min(kMaxTile, split)
  int stages;         // 1 or 2 shared-memory tiles
  int vec;            // 16-byte aligned rows: cp.async tile loads
};

// Elements per row in a shared tile: D plus 16 bytes of padding.
template <typename T>
__host__ __device__ __forceinline__ int kv_row_stride(int D) {
  return D + 16 / int(sizeof(T));
}

template <typename T>
size_t split_smem_bytes(int G, int D, int tile, int stages, int nsplit) {
  return sizeof(T) * size_t(stages) * 2 * tile * kv_row_stride<T>(D) +
         sizeof(float) * (size_t(G) * D * 2 + size_t(G) * tile + 3 * size_t(G) +
                          size_t(G) * nsplit + 1);
}

// Stage rows [j0, j0 + n) of K and V into a shared tile pair; src.rows(j,
// k, v) names row j's K and V (unit head-dim stride).
template <typename T, typename Src>
__device__ __forceinline__ void load_tile(T* ks, T* vs, const Src& src, int j0, int n, int D,
                                          bool vec) {
  const int KST = kv_row_stride<T>(D);
  if (vec) {
    constexpr int E = 16 / sizeof(T);
    const int ch = D / E;
    for (int i = threadIdx.x; i < n * ch; i += kThreads) {
      const int t = i / ch, c = (i % ch) * E;
      const T* kr;
      const T* vr;
      src.rows(j0 + t, kr, vr);
      cp_async16(ks + t * KST + c, kr + c);
      cp_async16(vs + t * KST + c, vr + c);
    }
  } else {
    for (int i = threadIdx.x; i < n * D; i += kThreads) {
      const int t = i / D, c = i % D;
      const T* kr;
      const T* vr;
      src.rows(j0 + t, kr, vr);
      ks[t * KST + c] = kr[c];
      vs[t * KST + c] = vr[c];
    }
  }
  cp_async_commit();
}

// The block (split blockIdx.x, kv head blockIdx.y, row blockIdx.z): its
// rows' online softmax, then its partial and the merge by the last split.
template <typename T, typename Src>
__device__ __forceinline__ void split_decode(const SplitArgs& a, const Src& src) {
  const int G = a.Hq / a.Hkv, D = a.D, tile = a.tile;
  const int KST = kv_row_stride<T>(D);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int split_i = blockIdx.x, hk = blockIdx.y, b = blockIdx.z;

  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* kv_s = reinterpret_cast<T*>(smem_raw);   // stages x (K tile, V tile)
  float* Qs = reinterpret_cast<float*>(kv_s + size_t(a.stages) * 2 * tile * KST);   // G x D
  float* Acc = Qs + G * D;        // G x D
  float* Ss = Acc + G * D;        // G x tile: scores, then probabilities
  float* Mv = Ss + G * tile;      // running max per query row
  float* Lv = Mv + G;             // running sum
  float* Av = Lv + G;             // this tile's rescale
  float* Wm = Av + G;             // merge weights, G x nsplit
  int* last_flag = reinterpret_cast<int*>(Wm + G * a.nsplit);

  const int s0 = split_i * a.split;
  const int s_end = min(a.C, s0 + a.split);
  const int ntiles = (s_end - s0 + tile - 1) / tile;

  load_tile(kv_s, kv_s + tile * KST, src, s0, min(tile, s_end - s0), D, a.vec);

  const T* qp = static_cast<const T*>(a.q) + b * a.q_sb + static_cast<long long>(hk) * G * D;
  for (int i = tid; i < G * D; i += kThreads) {
    Qs[i] = to_f(qp[i]) * a.scale;
    Acc[i] = 0.f;
  }
  for (int g = tid; g < G; g += kThreads) {
    Mv[g] = minus_inf();
    Lv[g] = 0.f;
  }

  // threads per score (a power of 2, at most 8) and per output element
  constexpr int E = 16 / sizeof(T);
  const int nch = a.vec ? D / E : D;
  int tpd = 1;
  while (tpd < 8 && 2 * tpd * G * tile <= kThreads && 2 * tpd <= nch) tpd *= 2;
  int tpo = 1;
  while (tpo < 32 && 2 * tpo * G * D <= kThreads && 2 * tpo <= tile) tpo *= 2;

  for (int kt = 0; kt < ntiles; ++kt) {
    const int j0 = s0 + kt * tile, n = min(tile, s_end - j0);
    const int cur = a.stages == 2 ? (kt & 1) : 0;
    if (a.stages == 2 && kt + 1 < ntiles) {
      const int nxt = (kt + 1) & 1, j1 = j0 + tile;
      load_tile(kv_s + nxt * 2 * tile * KST, kv_s + (nxt * 2 + 1) * tile * KST, src, j1,
                min(tile, s_end - j1), D, a.vec);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const T* ks = kv_s + cur * 2 * tile * KST;
    const T* vs = ks + tile * KST;

    // scores: tpd lanes per (query row, token row), summed by shuffles
    const int per = kThreads / tpd;
    for (int base = 0; base < G * tile; base += per) {
      const int i = base + tid / tpd, part = tid % tpd;
      const int g = i / tile, t = i % tile;
      float sc = 0.f;
      if (i < G * tile && t < n) {
        const float* qr = Qs + g * D;
        const T* kr = ks + t * KST;
        if (a.vec) {
          for (int c = part; c < nch; c += tpd) sc = dot16(kr + c * E, qr + c * E, sc);
        } else {
          for (int c = part; c < D; c += tpd) sc = fmaf(qr[c], to_f(kr[c]), sc);
        }
      }
      for (int o = 1; o < tpd; o <<= 1) sc += __shfl_xor_sync(0xffffffffu, sc, o);
      if (i < G * tile && part == 0) {
        if (a.cap > 0.f) sc = a.cap * tanhf(sc / a.cap);
        Ss[i] = t < n ? (src.valid(j0 + t) ? sc : kNegInf) : minus_inf();
      }
    }
    __syncthreads();

    // online softmax over the tile, one warp per query row
    for (int g = warp; g < G; g += kWarps) {
      float* sr = Ss + g * tile;
      float mx = minus_inf();
      for (int t = lane; t < n; t += 32) mx = fmaxf(mx, sr[t]);
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float m_prev = Mv[g], m_new = fmaxf(m_prev, mx);
      float sum = 0.f;
      for (int t = lane; t < tile; t += 32) {
        const float p = t < n ? fexp(sr[t] - m_new) : 0.f;
        sr[t] = p;
        sum += p;
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
      if (lane == 0) {
        const float alpha = fexp(m_prev - m_new);   // exp(-inf) = 0 on the first tile
        Av[g] = alpha;
        Lv[g] = alpha * Lv[g] + sum;
        Mv[g] = m_new;
      }
    }
    __syncthreads();

    // acc = alpha acc + P V: tpo threads per output element
    const int per_o = kThreads / tpo;
    for (int base = 0; base < G * D; base += per_o) {
      const int i = base + tid / tpo, r = tid % tpo;
      float acc = 0.f;
      if (i < G * D) {
        const int g = i / D, d = i % D;
        const float* pr = Ss + g * tile;
        for (int t = r; t < n; t += tpo) acc = fmaf(pr[t], to_f(vs[t * KST + d]), acc);
      }
      for (int o = 1; o < tpo; o <<= 1) acc += __shfl_xor_sync(0xffffffffu, acc, o);
      if (i < G * D && r == 0) Acc[i] = Acc[i] * Av[i / D] + acc;
    }
    __syncthreads();   // the tile's buffers and Ss are free again
    if (a.stages == 1 && kt + 1 < ntiles) {
      const int j1 = j0 + tile;
      load_tile(kv_s, kv_s + tile * KST, src, j1, min(tile, s_end - j1), D, a.vec);
    }
  }

  const long long row = static_cast<long long>(b) * a.Hkv + hk;
  T* op = static_cast<T*>(a.o) + (static_cast<long long>(b) * a.Hq + hk * G) * D;
  if (a.nsplit == 1) {
    for (int i = tid; i < G * D; i += kThreads) {
      const float l = Lv[i / D];
      op[i] = from_f<T>(Acc[i] / (l == 0.f ? 1.f : l));
    }
    return;
  }

  // partial (m, l, acc) of this split, then the ticket
  const int PST = D + 2;
  float* mine = a.part + (row * a.nsplit + split_i) * G * PST;
  for (int i = tid; i < G * D; i += kThreads) mine[(i / D) * PST + 2 + i % D] = Acc[i];
  for (int g = tid; g < G; g += kThreads) {
    mine[g * PST] = Mv[g];
    mine[g * PST + 1] = Lv[g];
  }
  __threadfence();
  __syncthreads();
  if (tid == 0) *last_flag = atomicAdd(a.tickets + row, 1) == a.nsplit - 1;
  __syncthreads();
  if (!*last_flag) return;

  // the last block of this (row, kv head) merges every split
  __threadfence();
  const float* parts = a.part + row * a.nsplit * G * PST;
  for (int g = warp; g < G; g += kWarps) {
    float m = minus_inf();
    for (int s = lane; s < a.nsplit; s += 32) m = fmaxf(m, __ldcg(parts + (s * G + g) * PST));
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
    float l = 0.f;
    for (int s = lane; s < a.nsplit; s += 32) {
      const float* ps = parts + (s * G + g) * PST;
      const float w = fexp(__ldcg(ps) - m);
      Wm[g * a.nsplit + s] = w;
      l += w * __ldcg(ps + 1);
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) l += __shfl_xor_sync(0xffffffffu, l, o);
    if (lane == 0) Lv[g] = l == 0.f ? 1.f : l;
  }
  __syncthreads();
  for (int i = tid; i < G * D; i += kThreads) {
    const int g = i / D, d = i % D;
    float acc = 0.f;
    for (int s = 0; s < a.nsplit; ++s)
      acc = fmaf(Wm[g * a.nsplit + s], __ldcg(parts + (s * G + g) * PST + 2 + d), acc);
    op[i] = from_f<T>(acc / Lv[g]);
  }
  if (tid == 0) a.tickets[row] = 0;
}

// Tiles per block: min(64, split); two buffers when a split holds more
// than one tile and both leave room for three blocks on an SM.
template <typename T>
void plan(int G, int D, int split, int nsplit, int* tile, int* stages, size_t* smem) {
  *tile = split < kMaxTile ? split : kMaxTile;
  *stages = split > *tile ? 2 : 1;
  *smem = split_smem_bytes<T>(G, D, *tile, *stages, nsplit);
  if (*stages == 2 && *smem > kMaxSmem / 3) {
    *stages = 1;
    *smem = split_smem_bytes<T>(G, D, *tile, 1, nsplit);
  }
}

// Fill the split plan of `s` (C, split, B, Hq, Hkv, D set) and its 16-byte
// copy flag; returns the shared memory of one block.
template <typename T>
size_t plan_args(SplitArgs* s, bool rows_aligned) {
  s->nsplit = (s->C + s->split - 1) / s->split;
  constexpr int E = 16 / sizeof(T);
  s->vec = rows_aligned && reinterpret_cast<uintptr_t>(s->q) % 16 == 0 && s->D % E == 0;
  size_t smem;
  plan<T>(s->Hq / s->Hkv, s->D, s->split, s->nsplit, &s->tile, &s->stages, &smem);
  return smem;
}

// Launch kernel(args) on grid (nsplit, Hkv, B) with `smem` bytes.
template <typename Args, typename Kernel>
int launch_split(Kernel kernel, const Args& args, const SplitArgs& s, size_t smem,
                 cudaStream_t stream) {
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return int(err);
  const dim3 grid(s.nsplit, s.Hkv, s.B);
  kernel<<<grid, kThreads, smem, stream>>>(args);
  return int(cudaGetLastError());
}

// Shared memory of one block for this shape (bytes); dtype 0 = fp32, 1 = bf16.
inline size_t split_smem_for(int dtype, int G, int D, int split, int nsplit) {
  int tile, stages;
  size_t smem = 0;
  if (dtype == 0) plan<float>(G, D, split, nsplit, &tile, &stages, &smem);
  else plan<__nv_bfloat16>(G, D, split, nsplit, &tile, &stages, &smem);
  return smem;
}

}  // namespace
