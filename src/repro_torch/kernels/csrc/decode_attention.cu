// Ring-cache decode attention for Hopper (sm_90a), written by hand:
// split-K (flash-decoding) in one launch, on the machinery of
// decode_split.cuh (which says what bounds it and what the design does).
//
// Replaces: the Pallas TPU kernel repro/kernels/paged_attention.py,
// function decode_attention_pallas (its body _decode_kernel). One query
// token per sequence, q (B,Hq,D), over a ring cache of C slots read in the
// model's (B,C,Hkv,D) layout through its strides: slot j holds token
// pos - ((pos - j) mod C) and is valid iff that token is >= 0. The TPU
// wrapper builds that mask beside the kernel; here each block computes it
// per slot from its row's pos, with the floor mod written
// ((pos - j) % C + C) % C, since C++'s % truncates toward zero. pos is
// one host scalar for every row (a uniform batch), or a device int32 (B,)
// array that each block reads at its own row (continuous batching, where
// every row sits at its own position): the grid and the split stay sized
// by C, and a split that holds no valid slot of its row merges with
// weight 0 (decode_split.cuh), so rows at different positions share one
// launch and the host never reads the positions. At phi3's
// decode (B=4, Hkv=32, C=576, D=96, bf16, 521 slots holding a token) it
// reads ~26 MB, ~8 us at 3.35 TB/s; 9 splits of 64 slots, 1152 blocks.

#include "decode_split.cuh"

namespace {

struct RingArgs {
  SplitArgs s;        // C = the ring's slots
  const void* k;      // (B, C, Hkv, D) through strides shared by k and v,
  const void* v;      // with a unit head-dim stride
  long long pos;      // the token index just written (a host scalar) ...
  const int* pos_rows;  // ... or, when not null, one per row on the device
  long long kv_sb, kv_sc, kv_sh;
};

// slot j of one (row, kv head): its K/V rows and its validity at pos
template <typename T>
struct RingRows {
  const T* kb;
  const T* vb;
  long long sc, pos, C;
  __device__ __forceinline__ void rows(int j, const T*& kr, const T*& vr) const {
    const long long g = j * sc;
    kr = kb + g;
    vr = vb + g;
  }
  __device__ __forceinline__ bool valid(int j) const {
    return pos - (((pos - j) % C + C) % C) >= 0;
  }
};

template <typename T>
__global__ void __launch_bounds__(kThreads) ring_decode_kernel(const RingArgs a) {
  const long long off = blockIdx.z * a.kv_sb + blockIdx.y * a.kv_sh;
  const long long pos = a.pos_rows ? static_cast<long long>(a.pos_rows[blockIdx.z]) : a.pos;
  const RingRows<T> src{static_cast<const T*>(a.k) + off, static_cast<const T*>(a.v) + off,
                        a.kv_sc, pos, a.s.C};
  split_decode<T>(a.s, src);
}

}  // namespace

// q (B,Hq,D) with batch stride q_sb and contiguous heads; k/v (B,C,Hkv,D)
// through the element strides they share, with a unit head-dim stride;
// o (B,Hq,D) contiguous; pos_rows null (every row at `pos`) or B int32
// positions on the device; `split` slots per block (a multiple of 16);
// part: B*Hkv*ceil(C/split)*(Hq/Hkv)*(D+2) fp32 scratch (unused with one
// split); tickets: B*Hkv int32, zero before the launch and zero after it.
// dtype: 0 = fp32, 1 = bf16. Returns cudaGetLastError() after the launch.
extern "C" int decode_attention_fwd(
    const void* q, const void* k, const void* v, void* o, int dtype, long long pos,
    const void* pos_rows, int B, int Hq, int Hkv, int C, int D, long long q_sb,
    long long kv_sb, long long kv_sc, long long kv_sh, float scale, float cap,
    int split, void* part, void* tickets, void* stream) {
  if (split <= 0 || split % 16 != 0) return int(cudaErrorInvalidValue);
  const int esize = dtype == 0 ? 4 : 2, E = 16 / esize;
  const bool rows_aligned = (reinterpret_cast<uintptr_t>(k) | reinterpret_cast<uintptr_t>(v)) % 16 == 0 &&
                            (kv_sb | kv_sc | kv_sh) % E == 0;
  RingArgs a{{q, o, static_cast<float*>(part), static_cast<int*>(tickets), B, Hq, Hkv, C, D,
              q_sb, scale, cap, split, 0, 0, 1, 0},
             k, v, pos, static_cast<const int*>(pos_rows), kv_sb, kv_sc, kv_sh};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    const size_t smem = plan_args<float>(&a.s, rows_aligned);
    return launch_split(ring_decode_kernel<float>, a, a.s, smem, st);
  }
  if (dtype == 1) {
    const size_t smem = plan_args<__nv_bfloat16>(&a.s, rows_aligned);
    return launch_split(ring_decode_kernel<__nv_bfloat16>, a, a.s, smem, st);
  }
  return int(cudaErrorInvalidValue);
}

// Shared memory of one block for this shape (bytes).
extern "C" size_t decode_attention_smem_bytes(int dtype, int G, int D, int split, int nsplit) {
  return split_smem_for(dtype, G, D, split, nsplit);
}
