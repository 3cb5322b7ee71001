// Paged decode attention for Hopper (sm_90a), written by hand.
//
// Replaces: the Pallas TPU kernel repro/kernels/paged_attention.py,
// function paged_decode_attention_pallas (its body _paged_decode_kernel).
// Same function: one query token per sequence, q (B,Hq,D), attends in one
// online-softmax pass over the pages that page_table (n,) names inside the
// page buffer (P,B,page,Hkv,D), then over the device tail (B,page,Hkv,D)
// masked at tail_len. GQA: the G = Hq/Hkv query heads of one kv head share
// every K/V page load. Logit cap cap*tanh(s/cap). Finite NEG_INF masking, so
// an empty table with tail_len = 0 returns the mean of v_tail, exactly as
// both JAX versions do. fp32 accumulation, output in the input type.
//
// What bounds it on this card: decode reads the whole selected K/V once and
// does ~4 FLOP per K/V element it reads, so it is bound by memory: at
// B=4, Hkv=32, D=96, 544 tokens in bf16 that is ~27 MB, ~8 us at 3.35 TB/s.
//
// What the design does about it: the TPU version walks the page table
// through a scalar-prefetch BlockSpec index map and retraces for every
// table length. Here the table is a device int32 array that the block reads
// itself, and each page is addressed by pointer arithmetic, so one compiled
// kernel serves every table length, scrambled tables and n = 0 alike. One
// block of 128 threads per (kv head, batch row) loops over the n pages and
// then the tail (the TPU grid's sequential kv axis becomes this loop; blocks
// run in parallel and carry nothing between them). Each page's K and V are
// staged once in shared memory (K rows padded to an odd stride) and shared
// by the G query heads; each thread issues a batch of loads before storing
// any, since few warps are there to hide latency. A quad of lanes computes
// each score, a quarter of the head dim per lane. m/l/alpha per query row
// and the fp32 accumulator live in shared memory, so any head_dim and any G
// fit without templates. With B*Hkv = 128 blocks it leaves a few SMs idle
// and each block walks its pages one after another; splitting the pages
// across blocks (split-K) is the next step for speed.

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

size_t paged_smem_bytes(int G, int page, int D) {
  // Qs (G x D) + Ks (page x D+1) + Vs (page x D) + Ss (G x page)
  // + Acc (G x D) + m/l/alpha (3 x G), fp32
  return sizeof(float) * (size_t(G) * D + size_t(page) * (D + 1) + size_t(page) * D +
                          size_t(G) * page + size_t(G) * D + 3 * size_t(G));
}

template <typename T>
__global__ void __launch_bounds__(kThreads) paged_decode_kernel(const PagedArgs a) {
  const int G = a.Hq / a.Hkv, D = a.D, page = a.page, KST = D + 1;
  const int chunk = (D + 3) / 4;   // head-dim elements per lane of a quad
  extern __shared__ float sm[];
  float* Qs = sm;                  // G x D, pre-scaled
  float* Ks = Qs + G * D;          // page x KST
  float* Vs = Ks + page * KST;     // page x D
  float* Ss = Vs + page * D;       // G x page: scores, then probabilities
  float* Acc = Ss + G * page;      // G x D
  float* Mv = Acc + G * D;         // running max per query row
  float* Lv = Mv + G;              // running sum per query row
  float* Av = Lv + G;              // this segment's alpha per query row

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int hk = blockIdx.x, b = blockIdx.y;
  const long long row_elems = static_cast<long long>(a.Hkv) * D;   // one token
  const long long page_elems = row_elems * page;                   // one (slot, b)

  const T* qp = static_cast<const T*>(a.q) + (static_cast<long long>(b) * a.Hq + hk * G) * D;
  for (int i = tid; i < G * D; i += kThreads) {
    Qs[i] = to_f(qp[i]) * a.scale;
    Acc[i] = 0.f;
  }
  for (int g = tid; g < G; g += kThreads) {
    Mv[g] = kNegInf;
    Lv[g] = 0.f;
  }

  for (int seg = 0; seg <= a.n; ++seg) {
    const T* kb;
    const T* vb;
    int valid;
    if (seg < a.n) {
      const int slot = min(max(a.table[seg], 0), a.P - 1);
      const long long off = (static_cast<long long>(slot) * a.B + b) * page_elems + hk * D;
      kb = static_cast<const T*>(a.k_pages) + off;
      vb = static_cast<const T*>(a.v_pages) + off;
      valid = page;
    } else {
      const long long off = static_cast<long long>(b) * page_elems + hk * D;
      kb = static_cast<const T*>(a.k_tail) + off;
      vb = static_cast<const T*>(a.v_tail) + off;
      valid = a.tail_len;
    }
    __syncthreads();   // the previous segment's Ks/Vs/Ss are consumed
    // each thread issues a batch of loads before it stores any: a block has
    // few warps to hide the memory latency with
    for (int i0 = tid; i0 < page * D; i0 += kThreads * kLoadBatch) {
      float kx[kLoadBatch], vx[kLoadBatch];
#pragma unroll
      for (int u = 0; u < kLoadBatch; ++u) {
        const int i = i0 + u * kThreads;
        if (i < page * D) {
          const int t = i / D, d = i % D;
          kx[u] = to_f(kb[t * row_elems + d]);
          vx[u] = to_f(vb[t * row_elems + d]);
        }
      }
#pragma unroll
      for (int u = 0; u < kLoadBatch; ++u) {
        const int i = i0 + u * kThreads;
        if (i < page * D) {
          const int t = i / D, d = i % D;
          Ks[t * KST + d] = kx[u];
          Vs[t * D + d] = vx[u];
        }
      }
    }
    __syncthreads();

    // one score per quad of lanes: each lane sums a contiguous quarter of
    // the head dim (at D = 96 the 32 lanes of a warp then read 32 distinct
    // banks), then the quad adds its partial sums
    for (int base = 0; base < G * page; base += kThreads / 4) {
      const int i = base + tid / 4, part = tid & 3;
      float s = 0.f;
      if (i < G * page) {
        const float* qr = Qs + (i / page) * D;
        const float* kr = Ks + (i % page) * KST;
        const int d_end = min(D, (part + 1) * chunk);
        for (int d = part * chunk; d < d_end; ++d) s = fmaf(qr[d], kr[d], s);
      }
      s += __shfl_xor_sync(0xffffffffu, s, 1);
      s += __shfl_xor_sync(0xffffffffu, s, 2);
      if (i < G * page && part == 0) {
        if (a.cap > 0.f) s = a.cap * tanhf(s / a.cap);
        Ss[i] = i % page < valid ? s : kNegInf;
      }
    }
    __syncthreads();

    for (int g = warp; g < G; g += kWarps) {
      float* sr = Ss + g * page;
      float mx = kNegInf;
      for (int t = lane; t < page; t += 32) mx = fmaxf(mx, sr[t]);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_prev = Mv[g];
      const float m_new = fmaxf(m_prev, mx);
      float sum = 0.f;
      for (int t = lane; t < page; t += 32) {
        const float p = expf(sr[t] - m_new);
        sr[t] = p;
        sum += p;
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);
      if (lane == 0) {
        const float alpha = expf(m_prev - m_new);
        Av[g] = alpha;
        Lv[g] = alpha * Lv[g] + sum;
        Mv[g] = m_new;
      }
    }
    __syncthreads();

    for (int i = tid; i < G * D; i += kThreads) {
      const int g = i / D, d = i % D;
      const float* pr = Ss + g * page;
      float acc = Acc[i] * Av[g];
      for (int t = 0; t < page; ++t) acc = fmaf(pr[t], Vs[t * D + d], acc);
      Acc[i] = acc;
    }
  }
  __syncthreads();

  T* op = static_cast<T*>(a.o) + (static_cast<long long>(b) * a.Hq + hk * G) * D;
  for (int i = tid; i < G * D; i += kThreads) {
    const float l = Lv[i / D];
    op[i] = from_f<T>(Acc[i] / (l == 0.f ? 1.f : l));
  }
}

template <typename T>
int launch_paged(const PagedArgs& a, cudaStream_t stream) {
  const size_t smem = paged_smem_bytes(a.Hq / a.Hkv, a.page, a.D);
  cudaError_t err = cudaFuncSetAttribute(
      paged_decode_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return int(err);
  const dim3 grid(a.Hkv, a.B);
  paged_decode_kernel<T><<<grid, kThreads, smem, stream>>>(a);
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
  if (dtype == 0) return launch_paged<float>(a, st);
  if (dtype == 1) return launch_paged<__nv_bfloat16>(a, st);
  return int(cudaErrorInvalidValue);
}

extern "C" size_t paged_decode_attention_smem_bytes(int G, int page, int D) {
  return paged_smem_bytes(G, page, D);
}
