// Paged decode attention for Hopper (sm_90a), written by hand: one query
// token per sequence over pool pages named by a page table, split-K in one
// launch on the machinery of decode_split.cuh (which says what bounds it
// and what the design does), the same as the ring kernel's.
//
// Replaces: the Pallas TPU kernel repro/kernels/paged_attention.py,
// function paged_decode_attention_pallas (its body _paged_decode_kernel).
// One query token per sequence, q (B,Hq,D), attends in one softmax over
// the pages that page_table (n,) names inside the page buffer
// (P,B,page,Hkv,D), then over the device tail (B,page,Hkv,D) masked at
// tail_len. The TPU version walks the pages as the sequential innermost
// grid axis, through a scalar-prefetch BlockSpec index map retraced for
// every table length. Here the (n + 1) * page token rows of a (row, kv
// head) are the n table pages in order and then the tail: token t < n *
// page is row t % page of slot clamp(table[t / page], 0, P - 1) (the
// reference's reads clamp too), token t >= n * page is tail row t - n *
// page, valid iff below tail_len. Each block reads the device int32 table
// itself, so one compiled kernel serves every table length, scrambled or
// repeated tables and n = 0 alike, and a split may straddle pages. Tail
// rows at or past tail_len score the finite NEG_INF: they take part with
// weight 0 beside a valid token, and an empty table with tail_len = 0
// gives the mean of v_tail, exactly as both JAX versions do. At phi3's
// widths (B=4, Hkv=32, D=96, bf16, 16 pages of 32 and 19 tail tokens) it
// reads ~27 MB, ~8 us at 3.35 TB/s; 9 splits of 64 tokens, 1152 blocks.

#include "decode_split.cuh"

namespace {

struct PagedArgs {
  SplitArgs s;        // C = (n + 1) * page
  const void* k_pages;
  const void* v_pages;
  const int* table;
  int n;              // table length (pages to attend before the tail)
  int P;              // page-buffer slots; table entries are clamped into [0, P)
  const void* k_tail;
  const void* v_tail;
  int tail_len;
  int page;
};

// token j of one (row, kv head): a table page's row, or a tail row
template <typename T>
struct PagedRows {
  const T* kp;          // page slot 0 of this (row, kv head)
  const T* vp;
  const T* kt;          // the tail of this (row, kv head)
  const T* vt;
  const int* table;
  long long slot_elems;  // one slot of the page buffer (B pages)
  long long row_elems;   // one token (Hkv x D)
  int P, page, paged, valid_end;   // paged = n * page; valid_end = paged + tail_len
  __device__ __forceinline__ void rows(int j, const T*& kr, const T*& vr) const {
    if (j < paged) {
      const int slot = min(max(table[j / page], 0), P - 1);
      const long long off = slot * slot_elems + (j % page) * row_elems;
      kr = kp + off;
      vr = vp + off;
    } else {
      const long long off = (j - paged) * row_elems;
      kr = kt + off;
      vr = vt + off;
    }
  }
  __device__ __forceinline__ bool valid(int j) const { return j < valid_end; }
};

template <typename T>
__global__ void __launch_bounds__(kThreads) paged_decode_kernel(const PagedArgs a) {
  const int hk = blockIdx.y, b = blockIdx.z;
  const long long row_elems = static_cast<long long>(a.s.Hkv) * a.s.D;
  const long long page_elems = row_elems * a.page;                  // one (slot, b)
  const long long off = b * page_elems + hk * a.s.D;
  const PagedRows<T> src{static_cast<const T*>(a.k_pages) + off,
                         static_cast<const T*>(a.v_pages) + off,
                         static_cast<const T*>(a.k_tail) + off,
                         static_cast<const T*>(a.v_tail) + off,
                         a.table, page_elems * a.s.B, row_elems, a.P, a.page,
                         a.n * a.page, a.n * a.page + a.tail_len};
  split_decode<T>(a.s, src);
}

}  // namespace

// All tensors contiguous: q (B,Hq,D), pages (P,B,page,Hkv,D), table (n,)
// int32 on the device, tails (B,page,Hkv,D), o (B,Hq,D). `split` token rows
// per block (a multiple of 16); part: B*Hkv*ceil((n+1)*page/split)*
// (Hq/Hkv)*(D+2) fp32 scratch (unused with one split); tickets: B*Hkv
// int32, zero before the launch and zero after it (the ring kernel's
// buffer: the two run one after the other on one stream). dtype: 0 = fp32,
// 1 = bf16. Returns cudaGetLastError() after the launch (0 on success).
extern "C" int paged_decode_attention_fwd(
    const void* q, const void* k_pages, const void* v_pages, const int* table, int n,
    int P, const void* k_tail, const void* v_tail, int tail_len, void* o, int dtype,
    int B, int Hq, int Hkv, int page, int D, float scale, float cap, int split, void* part,
    void* tickets, void* stream) {
  if (split <= 0 || split % 16 != 0) return int(cudaErrorInvalidValue);
  const int C = (n + 1) * page;
  const uintptr_t ptrs = reinterpret_cast<uintptr_t>(k_pages) | reinterpret_cast<uintptr_t>(v_pages) |
                         reinterpret_cast<uintptr_t>(k_tail) | reinterpret_cast<uintptr_t>(v_tail);
  // contiguous rows of Hkv x D elements: 16-byte aligned when the bases are
  // and D is a multiple of the 16-byte element count (checked with q)
  const bool rows_aligned = ptrs % 16 == 0;
  PagedArgs a{{q, o, static_cast<float*>(part), static_cast<int*>(tickets), B, Hq, Hkv, C, D,
               static_cast<long long>(Hq) * D, scale, cap, split, 0, 0, 1, 0},
              k_pages, v_pages, table, n, P, k_tail, v_tail, tail_len, page};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    const size_t smem = plan_args<float>(&a.s, rows_aligned);
    return launch_split(paged_decode_kernel<float>, a, a.s, smem, st);
  }
  if (dtype == 1) {
    const size_t smem = plan_args<__nv_bfloat16>(&a.s, rows_aligned);
    return launch_split(paged_decode_kernel<__nv_bfloat16>, a, a.s, smem, st);
  }
  return int(cudaErrorInvalidValue);
}

// Shared memory of one block for this shape (bytes).
extern "C" size_t paged_decode_attention_smem_bytes(int dtype, int G, int D, int split,
                                                    int nsplit) {
  return split_smem_for(dtype, G, D, split, nsplit);
}
