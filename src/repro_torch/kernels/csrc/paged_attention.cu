// Paged decode attention for Hopper (sm_90a), written by hand: one query
// token per sequence over pool pages named by a page table.
//
// Replaces: the Pallas TPU kernel repro/kernels/paged_attention.py,
// function paged_decode_attention_pallas (its body _paged_decode_kernel).
// One query token per sequence, q (B,Hq,D), attends in one online-softmax
// pass over the pages that page_table (n,) names inside the page buffer
// (P,B,page,Hkv,D), then over the device tail (B,page,Hkv,D) masked at
// tail_len. An empty table with tail_len = 0 returns the mean of v_tail,
// exactly as both JAX versions do. GQA (the G = Hq/Hkv query heads of one
// kv head share every K/V load), logit cap cap*tanh(s/cap), finite NEG_INF
// masking, l == 0 -> 1 guard, fp32 accumulation, output in the input type.
// (The ring-cache decode kernel, which shared this file's segment step
// until it took a split-K design of its own, is csrc/decode_attention.cu.)
//
// What bounds it on this card: decode reads the whole selected K/V once
// and does ~4 FLOP per K/V element it reads, so it is bound by memory: at
// B=4, Hkv=32, D=96 in bf16 over 544 tokens it reads ~27 MB (~8 us at
// 3.35 TB/s).
//
// What the design does about it: the TPU version walks the pages as the
// sequential innermost grid axis, through a scalar-prefetch BlockSpec
// index map retraced for every table length. Here one block of 128 threads
// per (kv head, batch row) loops over the segments itself (blocks run in
// parallel and carry nothing between them): over the pages the device
// int32 table names and then the tail, so one compiled kernel serves every
// table length, scrambled tables and n = 0 alike. Each segment's K and V
// are staged once in shared memory (K rows padded to an odd stride) and
// shared by the G query heads; each thread issues a batch of loads before
// storing any, since few warps are there to hide latency. A quad of lanes
// computes each score, a quarter of the head dim per lane. m/l/alpha per
// query row and the fp32 accumulator live in shared memory, so any
// head_dim and any G fit without templates. With B*Hkv = 128 blocks they
// leave a few SMs idle and each block walks its segments one after
// another; the split-K design of csrc/decode_attention.cu is the next step
// for speed.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr float kNegInf = -2.3819763e38f;
constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kLoadBatch = 8;   // loads in flight per thread and tensor

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// Shared memory of one block, for G query rows, segments of `tile` K/V
// rows and head dim D (fp32): Qs (G x D) + Ks (tile x D+1) + Vs (tile x D)
// + Ss (G x tile) + Acc (G x D) + m/l/alpha (3 x G).
size_t decode_smem_bytes(int G, int tile, int D) {
  return sizeof(float) * (size_t(G) * D + size_t(tile) * (D + 1) + size_t(tile) * D +
                          size_t(G) * tile + size_t(G) * D + 3 * size_t(G));
}

struct Smem {
  float* Qs;   // G x D, pre-scaled
  float* Ks;   // tile x (D + 1)
  float* Vs;   // tile x D
  float* Ss;   // G x tile: scores, then probabilities
  float* Acc;  // G x D
  float* Mv;   // running max per query row
  float* Lv;   // running sum per query row
  float* Av;   // this segment's alpha per query row
};

__device__ __forceinline__ Smem carve(float* sm, int G, int tile, int D) {
  Smem s;
  s.Qs = sm;
  s.Ks = s.Qs + G * D;
  s.Vs = s.Ks + tile * (D + 1);
  s.Ss = s.Vs + tile * D;
  s.Acc = s.Ss + G * tile;
  s.Mv = s.Acc + G * D;
  s.Lv = s.Mv + G;
  s.Av = s.Lv + G;
  return s;
}

// Stage the G pre-scaled query rows (contiguous, G x D from qp) and reset
// the online-softmax state.
template <typename T>
__device__ __forceinline__ void start_rows(const T* qp, float scale, const Smem& s, int G,
                                           int D) {
  for (int i = threadIdx.x; i < G * D; i += kThreads) {
    s.Qs[i] = to_f(qp[i]) * scale;
    s.Acc[i] = 0.f;
  }
  for (int g = threadIdx.x; g < G; g += kThreads) {
    s.Mv[g] = kNegInf;
    s.Lv[g] = 0.f;
  }
}

// One online-softmax step over a segment of `rows` K/V rows (rows <= tile),
// row t at kb/vb + t * tok_stride (unit head-dim stride). Rows for which
// valid(t) is false score the finite NEG_INF, as the reference masks them;
// rows past `rows` (the ragged end of a ring) take no part at all.
template <typename T, typename Valid>
__device__ __forceinline__ void attend_segment(const T* kb, const T* vb, long long tok_stride,
                                               int rows, int tile, Valid valid,
                                               const Smem& s, int G, int D, float cap) {
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, KST = D + 1;
  const int chunk = (D + 3) / 4;   // head-dim elements per lane of a quad
  __syncthreads();   // the previous segment's Ks/Vs/Ss are consumed
  // each thread issues a batch of loads before it stores any: a block has
  // few warps to hide the memory latency with
  for (int i0 = tid; i0 < rows * D; i0 += kThreads * kLoadBatch) {
    float kx[kLoadBatch], vx[kLoadBatch];
#pragma unroll
    for (int u = 0; u < kLoadBatch; ++u) {
      const int i = i0 + u * kThreads;
      if (i < rows * D) {
        const int t = i / D, d = i % D;
        kx[u] = to_f(kb[t * tok_stride + d]);
        vx[u] = to_f(vb[t * tok_stride + d]);
      }
    }
#pragma unroll
    for (int u = 0; u < kLoadBatch; ++u) {
      const int i = i0 + u * kThreads;
      if (i < rows * D) {
        const int t = i / D, d = i % D;
        s.Ks[t * KST + d] = kx[u];
        s.Vs[t * D + d] = vx[u];
      }
    }
  }
  __syncthreads();

  // one score per quad of lanes: each lane sums a contiguous quarter of the
  // head dim (at D = 96 the 32 lanes of a warp then read 32 distinct
  // banks), then the quad adds its partial sums
  for (int base = 0; base < G * tile; base += kThreads / 4) {
    const int i = base + tid / 4, part = tid & 3;
    const int t = i % tile;
    float sc = 0.f;
    if (i < G * tile && t < rows) {
      const float* qr = s.Qs + (i / tile) * D;
      const float* kr = s.Ks + t * KST;
      const int d_end = min(D, (part + 1) * chunk);
      for (int d = part * chunk; d < d_end; ++d) sc = fmaf(qr[d], kr[d], sc);
    }
    sc += __shfl_xor_sync(0xffffffffu, sc, 1);
    sc += __shfl_xor_sync(0xffffffffu, sc, 2);
    if (i < G * tile && part == 0) {
      if (cap > 0.f) sc = cap * tanhf(sc / cap);
      s.Ss[i] = t >= rows ? __int_as_float(0xff800000) : (valid(t) ? sc : kNegInf);  // -inf
    }
  }
  __syncthreads();

  for (int g = warp; g < G; g += kWarps) {
    float* sr = s.Ss + g * tile;
    float mx = kNegInf;
    for (int t = lane; t < tile; t += 32) mx = fmaxf(mx, sr[t]);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
    const float m_prev = s.Mv[g];
    const float m_new = fmaxf(m_prev, mx);
    float sum = 0.f;
    for (int t = lane; t < tile; t += 32) {
      const float p = expf(sr[t] - m_new);
      sr[t] = p;
      sum += p;
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);
    if (lane == 0) {
      const float alpha = expf(m_prev - m_new);
      s.Av[g] = alpha;
      s.Lv[g] = alpha * s.Lv[g] + sum;
      s.Mv[g] = m_new;
    }
  }
  __syncthreads();

  for (int i = tid; i < G * D; i += kThreads) {
    const int g = i / D, d = i % D;
    const float* pr = s.Ss + g * tile;
    float acc = s.Acc[i] * s.Av[g];
    for (int t = 0; t < rows; ++t) acc = fmaf(pr[t], s.Vs[t * D + d], acc);
    s.Acc[i] = acc;
  }
}

// Write the G output rows (contiguous, G x D at op): acc / l, l == 0 -> 1.
template <typename T>
__device__ __forceinline__ void finish_rows(T* op, const Smem& s, int G, int D) {
  __syncthreads();
  for (int i = threadIdx.x; i < G * D; i += kThreads) {
    const float l = s.Lv[i / D];
    op[i] = from_f<T>(s.Acc[i] / (l == 0.f ? 1.f : l));
  }
}

// ---------------------------------------------------------------------------
// paged: pool pages named by a device page table, then the device tail
// ---------------------------------------------------------------------------

struct PagedArgs {
  const void* q;
  const void* k_pages;
  const void* v_pages;
  const int* table;
  int n;          // table length (pages to attend before the tail)
  int P;          // page-buffer slots; table entries are clamped into [0, P)
  const void* k_tail;
  const void* v_tail;
  int tail_len;
  void* o;
  int B, Hq, Hkv, page, D;
  float scale;
  float cap;      // <= 0: no logit cap
};

template <typename T>
__global__ void __launch_bounds__(kThreads) paged_decode_kernel(const PagedArgs a) {
  const int G = a.Hq / a.Hkv, D = a.D, page = a.page;
  extern __shared__ float sm[];
  const Smem s = carve(sm, G, page, D);
  const int hk = blockIdx.x, b = blockIdx.y;
  const long long row_elems = static_cast<long long>(a.Hkv) * D;   // one token
  const long long page_elems = row_elems * page;                   // one (slot, b)
  const long long q_off = (static_cast<long long>(b) * a.Hq + hk * G) * D;
  start_rows(static_cast<const T*>(a.q) + q_off, a.scale, s, G, D);

  for (int seg = 0; seg <= a.n; ++seg) {
    const T* kb;
    const T* vb;
    int n_valid;
    if (seg < a.n) {
      const int slot = min(max(a.table[seg], 0), a.P - 1);
      const long long off = (static_cast<long long>(slot) * a.B + b) * page_elems + hk * D;
      kb = static_cast<const T*>(a.k_pages) + off;
      vb = static_cast<const T*>(a.v_pages) + off;
      n_valid = page;
    } else {
      const long long off = static_cast<long long>(b) * page_elems + hk * D;
      kb = static_cast<const T*>(a.k_tail) + off;
      vb = static_cast<const T*>(a.v_tail) + off;
      n_valid = a.tail_len;
    }
    attend_segment(kb, vb, row_elems, page, page, [n_valid](int t) { return t < n_valid; },
                   s, G, D, a.cap);
  }
  finish_rows(static_cast<T*>(a.o) + q_off, s, G, D);
}

template <typename Args, typename Kernel>
int launch(Kernel kernel, const Args& a, size_t smem, cudaStream_t stream) {
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return int(err);
  const dim3 grid(a.Hkv, a.B);
  kernel<<<grid, kThreads, smem, stream>>>(a);
  return int(cudaGetLastError());
}

}  // namespace

// All tensors contiguous: q (B,Hq,D), pages (P,B,page,Hkv,D), table (n,)
// int32 on the device, tails (B,page,Hkv,D), o (B,Hq,D). dtype: 0 = fp32,
// 1 = bf16. Returns cudaGetLastError() after the launch (0 on success).
extern "C" int paged_decode_attention_fwd(
    const void* q, const void* k_pages, const void* v_pages, const int* table, int n,
    int P, const void* k_tail, const void* v_tail, int tail_len, void* o, int dtype,
    int B, int Hq, int Hkv, int page, int D, float scale, float cap, void* stream) {
  PagedArgs a{q, k_pages, v_pages, table, n, P, k_tail, v_tail, tail_len, o,
              B, Hq, Hkv, page, D, scale, cap};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const size_t smem = decode_smem_bytes(Hq / Hkv, page, D);
  if (dtype == 0) return launch(paged_decode_kernel<float>, a, smem, st);
  if (dtype == 1) return launch(paged_decode_kernel<__nv_bfloat16>, a, smem, st);
  return int(cudaErrorInvalidValue);
}

extern "C" size_t paged_decode_attention_smem_bytes(int G, int page, int D) {
  return decode_smem_bytes(G, page, D);
}
