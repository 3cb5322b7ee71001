// Mamba2 SSD chunked scan for Hopper (sm_90a), written by hand.
//
// Replaces: the Pallas TPU kernel repro/kernels/ssd_scan.py, function
// ssd_scan_pallas (its body _ssd_kernel). Same function: for every (batch,
// head) and every chunk of L rows, with acs the inclusive cumsum of a over
// the chunk,
//   intra:  y  = ((C.B^T) o exp(acs_l - acs_s) o [s <= l]) . X
//   inter:  y += exp(acs_l) o (C . state^T)          (state before the chunk)
//   carry:  state <- state exp(acs_last) + X^T . (B o exp(acs_last - acs_s))
// x (B,S,H,P) fp32 pre-scaled by dt, a (B,S,H) fp32 = dt*A, B/C (B,S,H,N) in
// bf16 or fp32; out y (B,S,H,P) fp32 and the final state (B,H,P,N) fp32.
// S % L == 0 (the model pads with zeros, which neither decay nor add).
//
// What bounds it on this card: at zamba2's prefill (B=4, S=512, H=112,
// P=64, N=64, L=256, B/C bf16 with one group broadcast to the heads) the
// function moves ~126 MB (x and a read, B and C read once per group, y and
// the state written): 0.038 ms at 3.35 TB/s. It does ~11.3 GFLOP with the
// upper triangle skipped, 0.17 ms at the 67 TFLOP/s of fp32 FMA outside the
// tensor cores, which is why the first version of this kernel (CUDA-core
// FMA fed from shared memory) sat at 0.79 ms. Here the products run on
// tensor cores: the split products below come to ~13 GFLOP of TF32 work,
// ~0.03 ms at 495 TFLOP/s, so bytes and tensor-core time are close, and
// what is left is the work around the products (the hi/lo splits, exp of
// the decay, shared-memory reads, the steps of the scan) and the latency
// of each mma chain.
//
// Two instances, fixed by the type of B and C:
//
// mma_tf32 (B/C bf16, the model's serving paths). Every product is
// mma.sync m16n8k8 TF32 with fp32 accumulation, kept at fp32 accuracy by
// an error-compensated split: an fp32 operand x becomes hi = tf32(x) and
// lo = tf32(x - hi), both rounded to nearest with ties away from zero (what
// cvt.rna.tf32.f32 gives, done with two integer operations), and a product
// of two fp32 operands sums hi.hi + hi.lo + lo.hi (the dropped lo.lo and
// the rounding of lo are ~2^-22 relative). A bf16 value is exact in TF32
// and needs no split: C.B^T is one pass (bf16 x bf16 products are exact in
// the fp32 accumulator), C.state^T two (C exact, the state kept as hi and
// lo parts), and (S o L).X and the carry X^T.(B o decay) three. One block
// of 8 warps per (P tile, head, batch row) walks the sequence in order and
// keeps the P x N state in shared memory (the TPU grid's sequential chunk
// axis, which carried it in VMEM scratch; blocks run in parallel and carry
// nothing). It walks each chunk of L rows in sub-chunks of 64 rows (the
// last one ragged), each one step of the same scan with its own cumsum:
// the quadratic intra term then covers 64 x 64 triangles instead of
// L x L, and a sub-chunk's B and x (~45 KB at zamba2's shape) are all a
// block stages, so two blocks fit on an SM (~82 KB each; ~71 KB at
// mamba2-370m's) and one block's copies overlap the other's products. Per
// sub-chunk: B and x are copied once with 16-byte cp.async copies (element
// loads where a row is not 16-byte aligned) and x is split into hi and lo
// once; warp w takes output row tile w % 4 and half of the P tile: the
// inter term from the state before the sub-chunk, then for each 16-row
// source block at or below the diagonal the 16 x 16 score tile C.B^T in
// registers (C's rows come straight from device memory into registers),
// its decay exp(acs_l - acs_s) with the upper triangle selected to 0
// (never multiplied by a mask: exp there overflows and inf * 0 is NaN),
// and at once its product with X: the score accumulator is re-fed as the A
// fragment with the k order permuted (slot t holds column 2t, slot t + 4
// column 2t + 1), so it never goes through shared memory. The same warps
// take the 32 16 x 8 tiles of the carry, fewer for the row tiles with more
// source blocks (6, 5, 3, 2), so the eight finish together; then the state
// moves on and the next sub-chunk's copies start. Rows of the tiles are
// padded so that the fragment reads of a warp hit distinct banks. P tile:
// 64 rows when N <= 64 and the 64-row blocks fill every SM once (zamba2:
// 448 blocks), else 32 (mamba2-370m, N=128: 256 blocks instead of 128).
// Both serving shapes take this instance.
//
// fma_f32 (B/C fp32: the fp32 checks and sweeps). This instance keeps the
// first design: CUDA-core fp32 FMA over 64-row sub-tiles of each chunk, a
// 4 x 4 register tile of scores and a 4 x P/16 tile of y per thread.
//
// Both read their inputs through their strides in the model's (B,S,H,.)
// layout with no transpose; B/C may have head stride 0 (one group broadcast
// to every head), so the model never materialises the per-head copies.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kSMs = 132;

struct SsdArgs {
  const float* x;  // (B,S,H,P), unit P stride
  const float* a;  // (B,S,H)
  const void* bm;  // (B,S,H,N), unit N stride
  const void* cm;
  float* y;        // (B,S,H,P) contiguous
  float* state;    // (B,H,P,N) contiguous
  int B, S, H, P, N, L;
  long long x_sb, x_ss, x_sh;
  long long a_sb, a_ss, a_sh;
  long long b_sb, b_ss, b_sh;
  long long c_sb, c_ss, c_sh;
  int vec_b;       // B rows 16-byte aligned: cp.async copies
  int vec_x;       // x rows 16-byte aligned
  int pair_c;      // C rows 4-byte aligned and N even: 32-bit loads of pairs
};

int n_blocks16(int N) { return N <= 16 ? 1 : N <= 32 ? 2 : N <= 64 ? 4 : N <= 128 ? 8 : 0; }

// ===========================================================================
// fma_f32: fp32 B/C
// ===========================================================================

constexpr int kSub = 64;        // chunk rows per sub-tile
constexpr int kSS = kSub + 1;   // score tile row stride

// fp32 words of shared memory: state (PT x NS), C and B sub-tiles
// (kSub x NS each), x sub-tile (kSub x PT), scores (kSub x kSS), cumsum (L)
size_t fma_smem_bytes(int NB, int PT, int L) {
  const size_t NS = NB * 16 + 1;
  return sizeof(float) * (PT * NS + 2 * kSub * NS + size_t(kSub) * PT + kSub * kSS + size_t(L));
}

// P tile: 32 rows when 64-row tiles would leave fewer than two blocks per
// SM, else 64
int fma_p_tile(int B, int H, int P) {
  const long long blocks64 = static_cast<long long>(B) * H * ((P + 63) / 64);
  return (P > 32 && blocks64 >= 2 * kSMs) ? 64 : 32;
}

// rows [r0, r0 + rows) of B or C (row stride rs) into dst (kSub x NS),
// zero past `rows` and past N; optionally each row r scaled by
// exp(a_last - acs[r])
template <int NP>
__device__ __forceinline__ void load_bc(float* dst, const float* src, long long rs, long long r0,
                                        int rows, int N, const float* acs, float a_last) {
  constexpr int NS = NP + 1;
  for (int i = threadIdx.x; i < kSub * NP; i += kThreads) {
    const int r = i / NP, n = i % NP;
    float v = 0.f;
    if (r < rows && n < N) {
      v = src[(r0 + r) * rs + n];
      if (acs != nullptr) v *= expf(a_last - acs[r]);
    }
    dst[r * NS + n] = v;
  }
}

// rows [r0, r0 + rows) of x, columns [0, PT) of this block's P tile (which
// starts at xp), into dst (kSub x PT); zero past `rows` and past `pmax`
template <int PT>
__device__ __forceinline__ void load_x(float* dst, const float* xp, long long rs, long long r0,
                                       int rows, int pmax) {
  for (int i = threadIdx.x; i < kSub * PT; i += kThreads) {
    const int r = i / PT, c = i % PT;
    dst[i] = (r < rows && c < pmax) ? xp[(r0 + r) * rs + c] : 0.f;
  }
}

template <int NB, int PT>
__global__ void __launch_bounds__(kThreads) ssd_fma_kernel(const SsdArgs a) {
  constexpr int NP = NB * 16, NS = NP + 1, PJ = PT / 16;
  extern __shared__ float sm[];
  float* St = sm;                 // PT x NS: the carried state of this P tile
  float* Cs = St + PT * NS;       // kSub x NS
  float* Bs = Cs + kSub * NS;     // kSub x NS
  float* Xs = Bs + kSub * NS;     // kSub x PT
  float* Ss = Xs + kSub * PT;     // kSub x kSS: decayed scores
  float* As = Ss + kSub * kSS;    // L: cumsum of a over the chunk

  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const int p0 = blockIdx.x * PT, h = blockIdx.y, b = blockIdx.z;
  const int L = a.L, N = a.N, pmax = min(PT, a.P - p0);
  const float* xp = a.x + b * a.x_sb + h * a.x_sh + p0;
  const float* ap = a.a + b * a.a_sb + h * a.a_sh;
  const float* bp = static_cast<const float*>(a.bm) + b * a.b_sb + h * a.b_sh;
  const float* cp = static_cast<const float*>(a.cm) + b * a.c_sb + h * a.c_sh;

  for (int i = tid; i < PT * NS; i += kThreads) St[i] = 0.f;

  for (int ch = 0; ch < a.S / L; ++ch) {
    const long long r0 = static_cast<long long>(ch) * L;
    __syncthreads();   // the previous chunk is done with As and St
    // 1. inclusive cumsum of a over the chunk: one warp, a contiguous run
    //    of rows per lane, then a shuffle scan of the lane totals
    if (tid < 32) {
      const int per = (L + 31) / 32, beg = tid * per, end = min(L, beg + per);
      float run = 0.f;
      for (int l = beg; l < end; ++l) {
        run += ap[(r0 + l) * a.a_ss];
        As[l] = run;
      }
      float incl = run;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const float v = __shfl_up_sync(0xffffffffu, incl, off);
        if (tid >= off) incl += v;
      }
      const float excl = incl - run;
      for (int l = beg; l < end; ++l) As[l] += excl;
    }
    __syncthreads();
    const float a_last = As[L - 1];

    // 2. y, one 64-row output sub-tile at a time, from the state before
    //    this chunk
    for (int l0 = 0; l0 < L; l0 += kSub) {
      load_bc<NP>(Cs, cp, a.c_ss, r0 + l0, min(kSub, L - l0), N, nullptr, 0.f);
      __syncthreads();
      float acc[4][PJ];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < PJ; ++j) acc[i][j] = 0.f;
      // inter: exp(acs_l) * (C_l . state_p)
      for (int n = 0; n < NP; ++n) {
        float cv[4], sv[PJ];
#pragma unroll
        for (int i = 0; i < 4; ++i) cv[i] = Cs[(ty + 16 * i) * NS + n];
#pragma unroll
        for (int j = 0; j < PJ; ++j) sv[j] = St[(tx + 16 * j) * NS + n];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < PJ; ++j) acc[i][j] = fmaf(cv[i], sv[j], acc[i][j]);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int l = l0 + ty + 16 * i;
        const float e = l < L ? expf(As[l]) : 0.f;
#pragma unroll
        for (int j = 0; j < PJ; ++j) acc[i][j] *= e;
      }
      // intra: the source sub-tiles at or below the diagonal
      for (int s0 = 0; s0 <= l0; s0 += kSub) {
        const int srows = min(kSub, L - s0);
        __syncthreads();   // the previous source sub-tile is consumed
        load_bc<NP>(Bs, bp, a.b_ss, r0 + s0, srows, N, nullptr, 0.f);
        load_x<PT>(Xs, xp, a.x_ss, r0 + s0, srows, pmax);
        __syncthreads();
        float sc[4][4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) sc[i][j] = 0.f;
        for (int n = 0; n < NP; ++n) {
          float cv[4], bv[4];
#pragma unroll
          for (int i = 0; i < 4; ++i) cv[i] = Cs[(ty + 16 * i) * NS + n];
#pragma unroll
          for (int j = 0; j < 4; ++j) bv[j] = Bs[(tx + 16 * j) * NS + n];
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j) sc[i][j] = fmaf(cv[i], bv[j], sc[i][j]);
        }
        // decay; the upper triangle (and rows past L) select 0: exp there
        // would overflow, and inf * 0 is NaN
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int l = l0 + ty + 16 * i, s = s0 + tx + 16 * j;
            Ss[(ty + 16 * i) * kSS + tx + 16 * j] =
                (s <= l && l < L) ? sc[i][j] * expf(As[l] - As[s]) : 0.f;
          }
        __syncthreads();
        for (int s = 0; s < srows; ++s) {
          float xv[PJ];
#pragma unroll
          for (int j = 0; j < PJ; ++j) xv[j] = Xs[s * PT + tx + 16 * j];
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const float sv = Ss[(ty + 16 * i) * kSS + s];
#pragma unroll
            for (int j = 0; j < PJ; ++j) acc[i][j] = fmaf(sv, xv[j], acc[i][j]);
          }
        }
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int l = l0 + ty + 16 * i;
        if (l >= L) continue;
        float* yr = a.y + ((static_cast<long long>(b) * a.S + r0 + l) * a.H + h) * a.P + p0;
#pragma unroll
        for (int j = 0; j < PJ; ++j)
          if (tx + 16 * j < pmax) yr[tx + 16 * j] = acc[i][j];
      }
      __syncthreads();   // Cs is consumed
    }

    // 3. carry: state = state * exp(a_last) + X^T (B o exp(a_last - acs))
    float sacc[PJ][NB];
#pragma unroll
    for (int i = 0; i < PJ; ++i)
#pragma unroll
      for (int j = 0; j < NB; ++j) sacc[i][j] = 0.f;
    for (int s0 = 0; s0 < L; s0 += kSub) {
      const int srows = min(kSub, L - s0);
      __syncthreads();
      load_bc<NP>(Bs, bp, a.b_ss, r0 + s0, srows, N, As + s0, a_last);
      load_x<PT>(Xs, xp, a.x_ss, r0 + s0, srows, pmax);
      __syncthreads();
      for (int s = 0; s < srows; ++s) {
        float xv[PJ], bv[NB];
#pragma unroll
        for (int i = 0; i < PJ; ++i) xv[i] = Xs[s * PT + ty + 16 * i];
#pragma unroll
        for (int j = 0; j < NB; ++j) bv[j] = Bs[s * NS + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < PJ; ++i)
#pragma unroll
          for (int j = 0; j < NB; ++j) sacc[i][j] = fmaf(xv[i], bv[j], sacc[i][j]);
      }
    }
    // each thread owns these state entries; nobody else reads St until the
    // barrier that opens the next chunk
    const float decay = expf(a_last);
#pragma unroll
    for (int i = 0; i < PJ; ++i)
#pragma unroll
      for (int j = 0; j < NB; ++j) {
        float* st = St + (ty + 16 * i) * NS + tx + 16 * j;
        *st = *st * decay + sacc[i][j];
      }
  }
  __syncthreads();

  // 4. the final state, once
  for (int i = tid; i < PT * NP; i += kThreads) {
    const int p = i / NP, n = i % NP;
    if (p < pmax && n < N)
      a.state[((static_cast<long long>(b) * a.H + h) * a.P + p0 + p) * N + n] = St[p * NS + n];
  }
}


// ===========================================================================
// mma_tf32: bf16 B/C, products on tensor cores
// ===========================================================================

typedef __nv_bfloat16 bf16;

constexpr int kSubRows = 64;   // rows of a sub-chunk: 4 output row tiles of 16
constexpr int kSubTiles = kSubRows / 16;
constexpr int kMaxTiles = 6;     // the most carry tiles a warp takes

// carry tiles (of 32) of a warp whose output row tile is rt: a row tile
// with more source blocks below the diagonal takes fewer
__device__ __forceinline__ int carry_tiles(int rt) {
  return rt == 0 ? 6 : rt == 1 ? 5 : rt == 2 ? 3 : 2;
}

// geometry of one instance: NB blocks of 16 state columns, PT rows of P
template <int NB, int PT>
struct Geo {
  static constexpr int NK = NB * 2;        // k-steps of 8 over N (padded to 16)
  static constexpr int NPAD = NB * 16 + 8; // bf16 per B row: 8 mod 16 -> no bank conflicts
  static constexpr int SS = NB * 16 + 8;   // floats per state row
  static constexpr int XS = PT + 4;        // floats per x row: 4 mod 32
  static constexpr int PQW = PT / 16;      // n-tiles of 8 over P per warp (half the tile)
};

// Bytes of shared memory: B (kSubRows x NPAD bf16), x as TF32 hi and lo parts
// (kSubRows x XS each), the state as hi and lo parts (PT x SS each), and acs,
// the inter and carry decays (kSubRows each).
template <int NB, int PT>
__host__ __device__ __forceinline__ size_t mma_smem_bytes() {
  typedef Geo<NB, PT> G;
  return size_t(kSubRows) * G::NPAD * sizeof(bf16) +
         sizeof(float) * (2 * size_t(kSubRows) * G::XS + 2 * size_t(PT) * G::SS + 3 * kSubRows);
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst), "l"(gmem) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// fp32 -> TF32, round to nearest, ties away from zero (the low 13 bits 0):
// what cvt.rna.tf32.f32 gives for a finite x, in two integer operations
// at full rate (the conversion runs at a fraction of it): half a TF32 ulp
// added to the magnitude bits, then the 13 low bits cleared
__device__ __forceinline__ uint32_t tf32_rna(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}
// x = hi + lo to ~2^-22 relative: hi = tf32(x), lo = tf32(x - hi)
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi, uint32_t& lo) {
  hi = tf32_rna(x);
  lo = tf32_rna(x - __uint_as_float(hi));
}
// the two bf16 of a 32-bit word as TF32 (exact): the one at the lower
// address, then the other
__device__ __forceinline__ uint32_t bf16_first(uint32_t w) { return w << 16; }
__device__ __forceinline__ uint32_t bf16_second(uint32_t w) { return w & 0xffff0000u; }

// columns c and c + 1 of a bf16 row as one packed word, 0 past N; `pair`:
// the row is 4-byte aligned and N even, so one 32-bit load does
__device__ __forceinline__ uint32_t load_pair(const bf16* row, int c, int N, bool pair) {
  if (c >= N) return 0u;
  if (pair) return *reinterpret_cast<const uint32_t*>(row + c);
  const uint32_t lo = __bfloat16_as_ushort(row[c]);
  const uint32_t hi = c + 1 < N ? __bfloat16_as_ushort(row[c + 1]) : 0u;
  return lo | (hi << 16);
}

// d += a . b, m16n8k8, TF32 in, fp32 accumulate. Fragments (g = lane / 4,
// t = lane % 4): a0 (row g, k t), a1 (g + 8, t), a2 (g, t + 4), a3 (g + 8,
// t + 4); b0 (k t, col g), b1 (t + 4, g); d0/d1 (row g, cols 2t, 2t + 1),
// d2/d3 (row g + 8, the same cols).
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// rows [r0, r0 + L) of B (row stride rs) into dst rows [0, L); only the
// first N columns are written (the padding stays 0)
template <int NPAD>
__device__ __forceinline__ void stage_b(bf16* dst, const bf16* src, long long rs, long long r0,
                                        int L, int N, bool vec) {
  if (vec) {
    const int ch = N / 8;
    for (int i = threadIdx.x; i < L * ch; i += kThreads) {
      const int r = i / ch, c = (i % ch) * 8;
      cp_async16(dst + r * NPAD + c, src + (r0 + r) * rs + c);
    }
  } else {
    for (int i = threadIdx.x; i < L * N; i += kThreads) {
      const int r = i / N, c = i % N;
      dst[r * NPAD + c] = src[(r0 + r) * rs + c];
    }
  }
}

// rows [r0, r0 + L) of x, columns [0, pmax) of this block's P tile
template <int XS>
__device__ __forceinline__ void stage_x(float* dst, const float* src, long long rs, long long r0,
                                        int L, int pmax, bool vec) {
  if (vec) {
    const int ch = pmax / 4;
    for (int i = threadIdx.x; i < L * ch; i += kThreads) {
      const int r = i / ch, c = (i % ch) * 4;
      cp_async16(dst + r * XS + c, src + (r0 + r) * rs + c);
    }
  } else {
    for (int i = threadIdx.x; i < L * pmax; i += kThreads) {
      const int r = i / pmax, c = i % pmax;
      dst[r * XS + c] = src[(r0 + r) * rs + c];
    }
  }
}

// this row tile's C rows (l0 + g, l0 + g + 8) from device memory, as
// packed bf16 pairs (columns 8kk + 2t, + 1); rows past L are 0
template <int NK>
__device__ __forceinline__ void load_c_rows(uint32_t (&cw)[NK][2], const bf16* cp, long long rs,
                                            long long r0, int l0, int L, int N, bool pair) {
  const int g = (threadIdx.x & 31) >> 2, t = threadIdx.x & 3;
  const bf16* c0 = cp + (r0 + l0 + g) * rs;
  const bf16* c1 = cp + (r0 + l0 + g + 8) * rs;
#pragma unroll
  for (int kk = 0; kk < NK; ++kk) {
    cw[kk][0] = l0 + g < L ? load_pair(c0, kk * 8 + 2 * t, N, pair) : 0u;
    cw[kk][1] = l0 + g + 8 < L ? load_pair(c1, kk * 8 + 2 * t, N, pair) : 0u;
  }
}

template <int NK>
__device__ __forceinline__ void c_frag(uint32_t (&af)[4], const uint32_t (&cw)[NK][2], int kk) {
  af[0] = bf16_first(cw[kk][0]);
  af[1] = bf16_first(cw[kk][1]);
  af[2] = bf16_second(cw[kk][0]);
  af[3] = bf16_second(cw[kk][1]);
}

// rows [r0, r0 + R) of B and x into the sub-chunk's tiles; rows [R, Rp)
// (the ragged end of a chunk) are set to 0, so that nothing stale meets a
// zero weight
template <int NPAD, int XS>
__device__ __forceinline__ void stage_sub(bf16* Bs, float* Xh, const bf16* bp, long long b_ss,
                                          const float* xp, long long x_ss, long long r0, int R,
                                          int N, int pmax, bool vb, bool vx) {
  stage_b<NPAD>(Bs, bp, b_ss, r0, R, N, vb);
  stage_x<XS>(Xh, xp, x_ss, r0, R, pmax, vx);
  cp_async_commit();
  const int Rp = (R + 15) & ~15;
  for (int i = threadIdx.x; i < (Rp - R) * NPAD; i += kThreads)
    Bs[R * NPAD + i] = __float2bfloat16(0.f);
  for (int i = threadIdx.x; i < (Rp - R) * XS; i += kThreads) Xh[R * XS + i] = 0.f;
}

template <int NB, int PT>
__global__ void __launch_bounds__(kThreads, 2) ssd_mma_kernel(const SsdArgs a) {
  typedef Geo<NB, PT> G;
  constexpr int NK = G::NK, NPAD = G::NPAD, SS = G::SS, XS = G::XS, PQW = G::PQW;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Bs = reinterpret_cast<bf16*>(smem_raw);
  float* Xh = reinterpret_cast<float*>(Bs + kSubRows * NPAD);   // x, then its TF32 hi part
  float* Xl = Xh + kSubRows * XS;                                // x's TF32 lo part
  float* Sh = Xl + kSubRows * XS;   // the state, hi + lo (each PT x SS)
  float* Sl = Sh + PT * SS;
  float* Acs = Sl + PT * SS;    // cumsum of a over the sub-chunk (padding: its last value)
  float* Ea = Acs + kSubRows;       // exp(acs_l), 0 past the sub-chunk's rows
  float* Wd = Ea + kSubRows;        // exp(acs_last - acs_s), 0 past the sub-chunk's rows

  const int L = a.L, N = a.N;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;
  const int p0 = blockIdx.x * PT, h = blockIdx.y, b = blockIdx.z;
  const int pmax = min(PT, a.P - p0);
  const float* xp = a.x + b * a.x_sb + h * a.x_sh + p0;
  const float* ap = a.a + b * a.a_sb + h * a.a_sh;
  const bf16* bp = static_cast<const bf16*>(a.bm) + b * a.b_sb + h * a.b_sh;
  const bf16* cp = static_cast<const bf16*>(a.cm) + b * a.c_sb + h * a.c_sh;
  const bool vb = a.vec_b != 0, vx = a.vec_x != 0, pair_c = a.pair_c != 0;
  const bool y_pairs = a.P % 2 == 0;   // 8-byte aligned pairs of y
  // this warp's share: output row tile rt of the sub-chunk, the half q0..
  // of the P tile's n-tiles, and carry tiles [cfirst, cfirst + ccount)
  const int rt = warp % kSubTiles, q0 = (warp / kSubTiles) * PQW;
  const int n_tiles = (PT / 16) * NK;   // at most 32
  int cfirst = 0;
  for (int w = 0; w < warp; ++w) cfirst += carry_tiles(w % kSubTiles);
  const int cend = min(cfirst + carry_tiles(rt), n_tiles);
  cfirst = min(cfirst, n_tiles);
  const int ccount = cend - cfirst;

  // zero everything once: the padding columns stay 0 (the copies write
  // only columns < N of B and < pmax of x), and the state starts at 0
  {
    uint4* z = reinterpret_cast<uint4*>(smem_raw);
    const int n16 = static_cast<int>(mma_smem_bytes<NB, PT>() / 16);
    for (int i = tid; i < n16; i += kThreads) z[i] = make_uint4(0u, 0u, 0u, 0u);
  }
  __syncthreads();
  // the sub-chunks, in order: kSubRows rows at a time within each chunk of L
  const int per_chunk = (L + kSubRows - 1) / kSubRows, n_sub = (a.S / L) * per_chunk;
  stage_sub<NPAD, XS>(Bs, Xh, bp, a.b_ss, xp, a.x_ss, 0, min(kSubRows, L), N, pmax, vb, vx);

  for (int j = 0; j < n_sub; ++j) {
    const long long r0 = static_cast<long long>(j / per_chunk) * L + (j % per_chunk) * kSubRows;
    const int R = min(kSubRows, L - (j % per_chunk) * kSubRows), nrt = (R + 15) / 16;
    // 1. inclusive cumsum of a over the sub-chunk while the copies land:
    //    one warp, two rows per lane, then a shuffle scan
    if (warp == 0) {
      const int l = 2 * lane;
      const float v0 = l < R ? ap[(r0 + l) * a.a_ss] : 0.f;
      const float v1 = l + 1 < R ? ap[(r0 + l + 1) * a.a_ss] : 0.f;
      const float run = v0 + v1;
      float incl = run;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const float v = __shfl_up_sync(0xffffffffu, incl, off);
        if (lane >= off) incl += v;
      }
      const float excl = incl - run;
      Acs[l] = excl + v0;
      Acs[l + 1] = excl + run;
    }
    cp_async_wait_all();
    __syncthreads();
    // x into TF32 hi and lo parts; the decays within the sub-chunk
    for (int i = tid; i < kSubRows * XS; i += kThreads) {
      uint32_t hi, lo;
      split_tf32(Xh[i], hi, lo);
      Xh[i] = __uint_as_float(hi);
      Xl[i] = __uint_as_float(lo);
    }
    const float a_last = Acs[R - 1];
    for (int l = tid; l < kSubRows; l += kThreads) {
      const bool in = l < R;
      const float c = in ? Acs[l] : a_last;
      Ea[l] = in ? expf(c) : 0.f;
      Wd[l] = in ? expf(a_last - c) : 0.f;
    }
    __syncthreads();
    for (int l = R + tid; l < kSubRows; l += kThreads) Acs[l] = a_last;
    const float decay = expf(a_last);
    __syncthreads();

    // 2. y of row tile rt, this warp's half of P: the inter term from the
    //    state before the sub-chunk, then the source blocks at or below the
    //    diagonal
    if (rt < nrt) {
      const int l0 = rt * 16, lg0 = l0 + g, lg1 = l0 + g + 8;
      uint32_t cw[NK][2];
      load_c_rows<NK>(cw, cp, a.c_ss, r0, l0, R, N, pair_c);
      float acc[PQW][4];
#pragma unroll
      for (int q = 0; q < PQW; ++q) acc[q][0] = acc[q][1] = acc[q][2] = acc[q][3] = 0.f;
      // inter: C . state^T (C exact, the state in two parts); k slot t
      // holds state column 8kk + 2t, slot t + 4 column 8kk + 2t + 1
#pragma unroll
      for (int kk = 0; kk < NK; ++kk) {
        uint32_t af[4];
        c_frag<NK>(af, cw, kk);
#pragma unroll
        for (int q = 0; q < PQW; ++q) {
          const int o = ((q0 + q) * 8 + g) * SS + kk * 8 + 2 * t;
          const float2 hv = *reinterpret_cast<const float2*>(Sh + o);
          const float2 lv = *reinterpret_cast<const float2*>(Sl + o);
          mma_tf32(acc[q], af, __float_as_uint(hv.x), __float_as_uint(hv.y));
          mma_tf32(acc[q], af, __float_as_uint(lv.x), __float_as_uint(lv.y));
        }
      }
      const float e0 = Ea[lg0], e1 = Ea[lg1];
#pragma unroll
      for (int q = 0; q < PQW; ++q) {
        acc[q][0] *= e0;
        acc[q][1] *= e0;
        acc[q][2] *= e1;
        acc[q][3] *= e1;
      }
      const float al0 = Acs[lg0], al1 = Acs[lg1];
      for (int sb = 0; sb <= rt; ++sb) {
        const int s0 = sb * 16;
        float sc[2][4];
#pragma unroll
        for (int jj = 0; jj < 2; ++jj) sc[jj][0] = sc[jj][1] = sc[jj][2] = sc[jj][3] = 0.f;
#pragma unroll
        for (int kk = 0; kk < NK; ++kk) {
          uint32_t af[4];
          c_frag<NK>(af, cw, kk);
#pragma unroll
          for (int jj = 0; jj < 2; ++jj) {
            const uint32_t bw =
                *reinterpret_cast<const uint32_t*>(Bs + (s0 + 8 * jj + g) * NPAD + kk * 8 + 2 * t);
            mma_tf32(sc[jj], af, bf16_first(bw), bf16_second(bw));
          }
        }
        // decay; the upper triangle and rows past R select 0
#pragma unroll
        for (int jj = 0; jj < 2; ++jj) {
          const int sa = s0 + 8 * jj + 2 * t, sb1 = sa + 1;
          const float as0 = Acs[sa], as1 = Acs[sb1];
          sc[jj][0] = (sa <= lg0 && lg0 < R) ? sc[jj][0] * expf(al0 - as0) : 0.f;
          sc[jj][1] = (sb1 <= lg0 && lg0 < R) ? sc[jj][1] * expf(al0 - as1) : 0.f;
          sc[jj][2] = (sa <= lg1 && lg1 < R) ? sc[jj][2] * expf(al1 - as0) : 0.f;
          sc[jj][3] = (sb1 <= lg1 && lg1 < R) ? sc[jj][3] * expf(al1 - as1) : 0.f;
        }
        // y += S . X in three TF32 passes; the score accumulator is the A
        // fragment with k slot t <- source 2t, slot t + 4 <- source 2t + 1
#pragma unroll
        for (int jj = 0; jj < 2; ++jj) {
          uint32_t ah[4], alo[4];
          split_tf32(sc[jj][0], ah[0], alo[0]);
          split_tf32(sc[jj][2], ah[1], alo[1]);
          split_tf32(sc[jj][1], ah[2], alo[2]);
          split_tf32(sc[jj][3], ah[3], alo[3]);
          const int xo = (s0 + 8 * jj + 2 * t) * XS + q0 * 8 + g;
#pragma unroll
          for (int q = 0; q < PQW; ++q) {
            const uint32_t h0 = __float_as_uint(Xh[xo + q * 8]);
            const uint32_t h1 = __float_as_uint(Xh[xo + XS + q * 8]);
            const uint32_t o0 = __float_as_uint(Xl[xo + q * 8]);
            const uint32_t o1 = __float_as_uint(Xl[xo + XS + q * 8]);
            mma_tf32(acc[q], ah, h0, h1);
            mma_tf32(acc[q], ah, o0, o1);
            mma_tf32(acc[q], alo, h0, h1);
          }
        }
      }
      // rows lg0, lg1 of y, columns 8q + 2t, + 1 of this warp's half
#pragma unroll
      for (int rr = 0; rr < 2; ++rr) {
        const int l = rr == 0 ? lg0 : lg1;
        if (l >= R) continue;
        float* yr = a.y + ((static_cast<long long>(b) * a.S + r0 + l) * a.H + h) * a.P + p0;
#pragma unroll
        for (int q = 0; q < PQW; ++q) {
          const int pc = (q0 + q) * 8 + 2 * t;
          const float v0 = acc[q][2 * rr], v1 = acc[q][2 * rr + 1];
          if (y_pairs && pc + 1 < pmax) {
            *reinterpret_cast<float2*>(yr + pc) = make_float2(v0, v1);
          } else {
            if (pc < pmax) yr[pc] = v0;
            if (pc + 1 < pmax) yr[pc + 1] = v1;
          }
        }
      }
    }

    // 3. carry: X^T . (B o exp(acs_last - acs)) over the sub-chunk, in
    //    16 x 8 tiles (rows p, columns n; consecutive tiles share a row
    //    block, whose x fragments they reuse); k slot t <- source 8kk + 2t,
    //    slot t + 4 <- 8kk + 2t + 1, in both operands
    float sacc[kMaxTiles][4];
#pragma unroll
    for (int u = 0; u < kMaxTiles; ++u) sacc[u][0] = sacc[u][1] = sacc[u][2] = sacc[u][3] = 0.f;
    for (int kk = 0; kk < nrt * 2; ++kk) {
      const int sa = kk * 8 + 2 * t;
      const float w0 = Wd[sa], w1 = Wd[sa + 1];
      const float* xh = Xh + sa * XS + g;
      const float* xl = Xl + sa * XS + g;
      const bf16* brow = Bs + sa * NPAD + g;
      int m_prev = -1;
      uint32_t ah[4] = {0u, 0u, 0u, 0u}, alo[4] = {0u, 0u, 0u, 0u};
#pragma unroll
      for (int u = 0; u < kMaxTiles; ++u) {
        if (u >= ccount) continue;
        const int idx = cfirst + u;
        const int m0 = (idx / NK) * 16, n0 = (idx % NK) * 8;
        if (m0 != m_prev) {
          ah[0] = __float_as_uint(xh[m0]);
          ah[1] = __float_as_uint(xh[m0 + 8]);
          ah[2] = __float_as_uint(xh[XS + m0]);
          ah[3] = __float_as_uint(xh[XS + m0 + 8]);
          alo[0] = __float_as_uint(xl[m0]);
          alo[1] = __float_as_uint(xl[m0 + 8]);
          alo[2] = __float_as_uint(xl[XS + m0]);
          alo[3] = __float_as_uint(xl[XS + m0 + 8]);
          m_prev = m0;
        }
        uint32_t bh0, bl0, bh1, bl1;
        split_tf32(__bfloat162float(brow[n0]) * w0, bh0, bl0);
        split_tf32(__bfloat162float(brow[NPAD + n0]) * w1, bh1, bl1);
        mma_tf32(sacc[u], ah, bh0, bh1);
        mma_tf32(sacc[u], ah, bl0, bl1);
        mma_tf32(sacc[u], alo, bh0, bh1);
      }
    }
    __syncthreads();   // every warp is done with the tiles and the state
    if (j + 1 < n_sub) {
      const int jn = j + 1;
      const long long rn = static_cast<long long>(jn / per_chunk) * L + (jn % per_chunk) * kSubRows;
      stage_sub<NPAD, XS>(Bs, Xh, bp, a.b_ss, xp, a.x_ss, rn,
                          min(kSubRows, L - (jn % per_chunk) * kSubRows), N, pmax, vb, vx);
    }
    // state <- state exp(acs_last) + carry, split again: each thread its
    // own entries (the next sub-chunk reads them after its first barrier)
#pragma unroll
    for (int u = 0; u < kMaxTiles; ++u) {
      if (u >= ccount) continue;
      const int idx = cfirst + u;
      const int m0 = (idx / NK) * 16, n0 = (idx % NK) * 8;
#pragma unroll
      for (int rr = 0; rr < 2; ++rr) {
        const int o = (m0 + g + 8 * rr) * SS + n0 + 2 * t;
        float2* hp = reinterpret_cast<float2*>(Sh + o);
        float2* lp = reinterpret_cast<float2*>(Sl + o);
        const float2 hv = *hp, lv = *lp;
        const float v0 = (hv.x + lv.x) * decay + sacc[u][2 * rr];
        const float v1 = (hv.y + lv.y) * decay + sacc[u][2 * rr + 1];
        uint32_t h0, o0, h1, o1;
        split_tf32(v0, h0, o0);
        split_tf32(v1, h1, o1);
        *hp = make_float2(__uint_as_float(h0), __uint_as_float(h1));
        *lp = make_float2(__uint_as_float(o0), __uint_as_float(o1));
      }
    }
  }
  __syncthreads();

  // 4. the final state, once
  for (int i = tid; i < PT * N; i += kThreads) {
    const int p = i / N, n = i % N;
    if (p < pmax)
      a.state[((static_cast<long long>(b) * a.H + h) * a.P + p0 + p) * N + n] =
          Sh[p * SS + n] + Sl[p * SS + n];
  }
}

// P tile of the mma instance: 64 rows when N <= 64 and 64-row blocks fill
// every SM at least once, else 32
int mma_p_tile(int B, int H, int P, int N) {
  const long long blocks64 = static_cast<long long>(B) * H * ((P + 63) / 64);
  return (P > 32 && N <= 64 && blocks64 >= kSMs) ? 64 : 32;
}

size_t mma_smem(int NB, int PT) {
  if (PT == 64) {
    switch (NB) {
      case 1: return mma_smem_bytes<1, 64>();
      case 2: return mma_smem_bytes<2, 64>();
      case 4: return mma_smem_bytes<4, 64>();
      default: return 0;
    }
  }
  switch (NB) {
    case 1: return mma_smem_bytes<1, 32>();
    case 2: return mma_smem_bytes<2, 32>();
    case 4: return mma_smem_bytes<4, 32>();
    case 8: return mma_smem_bytes<8, 32>();
    default: return 0;
  }
}

template <int NB, int PT>
int launch_mma(const SsdArgs& a, cudaStream_t stream) {
  const size_t smem = mma_smem_bytes<NB, PT>();
  cudaError_t err = cudaFuncSetAttribute(ssd_mma_kernel<NB, PT>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return int(err);
  const dim3 grid((a.P + PT - 1) / PT, a.H, a.B);
  ssd_mma_kernel<NB, PT><<<grid, kThreads, smem, stream>>>(a);
  return int(cudaGetLastError());
}

int dispatch_mma(const SsdArgs& a, cudaStream_t st) {
  const int nb = n_blocks16(a.N);
  if (mma_p_tile(a.B, a.H, a.P, a.N) == 64) {
    switch (nb) {
      case 1: return launch_mma<1, 64>(a, st);
      case 2: return launch_mma<2, 64>(a, st);
      case 4: return launch_mma<4, 64>(a, st);
      default: return int(cudaErrorInvalidValue);
    }
  }
  switch (nb) {
    case 1: return launch_mma<1, 32>(a, st);
    case 2: return launch_mma<2, 32>(a, st);
    case 4: return launch_mma<4, 32>(a, st);
    case 8: return launch_mma<8, 32>(a, st);
    default: return int(cudaErrorInvalidValue);
  }
}

// ---------------------------------------------------------------------------
// fma_f32 launch
// ---------------------------------------------------------------------------

template <int NB, int PT>
int launch_fma(const SsdArgs& a, cudaStream_t stream) {
  const size_t smem = fma_smem_bytes(NB, PT, a.L);
  cudaError_t err = cudaFuncSetAttribute(ssd_fma_kernel<NB, PT>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return int(err);
  const dim3 grid((a.P + PT - 1) / PT, a.H, a.B);
  ssd_fma_kernel<NB, PT><<<grid, kThreads, smem, stream>>>(a);
  return int(cudaGetLastError());
}

template <int PT>
int dispatch_fma_n(const SsdArgs& a, cudaStream_t st) {
  switch (n_blocks16(a.N)) {
    case 1: return launch_fma<1, PT>(a, st);
    case 2: return launch_fma<2, PT>(a, st);
    case 4: return launch_fma<4, PT>(a, st);
    case 8: return launch_fma<8, PT>(a, st);
    default: return int(cudaErrorInvalidValue);
  }
}

int dispatch_fma(const SsdArgs& a, cudaStream_t st) {
  return fma_p_tile(a.B, a.H, a.P) == 64 ? dispatch_fma_n<64>(a, st) : dispatch_fma_n<32>(a, st);
}

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

}  // namespace

// x (B,S,H,P) fp32 and B/C (B,S,H,N) with unit last stride, a (B,S,H) fp32,
// all through element strides (B/C may have head stride 0); y (B,S,H,P) and
// state (B,H,P,N) fp32 contiguous. bc_dtype: 0 = fp32 (the fma_f32
// instance), 1 = bf16 (mma_tf32). Needs S % L == 0 and N <= 128. Returns
// cudaGetLastError() after the launch (0 on success).
extern "C" int ssd_scan_fwd(
    const float* x, const float* a, const void* bm, const void* cm, float* y, float* state,
    int bc_dtype, int B, int S, int H, int P, int N, int L,
    long long x_sb, long long x_ss, long long x_sh,
    long long a_sb, long long a_ss, long long a_sh,
    long long b_sb, long long b_ss, long long b_sh,
    long long c_sb, long long c_ss, long long c_sh, void* stream) {
  if (L < 1 || S % L != 0 || n_blocks16(N) == 0) return int(cudaErrorInvalidValue);
  // 16-byte copies: aligned bases, strides and row lengths (bf16: 8
  // elements, fp32: 4)
  const int vec_b = aligned16(bm) && N % 8 == 0 && (b_sb | b_ss | b_sh) % 8 == 0;
  const int vec_x = aligned16(x) && P % 4 == 0 && (x_sb | x_ss | x_sh) % 4 == 0;
  const int pair_c = reinterpret_cast<uintptr_t>(cm) % 4 == 0 && N % 2 == 0 &&
                     (c_sb | c_ss | c_sh) % 2 == 0;
  SsdArgs args{x, a, bm, cm, y, state, B, S, H, P, N, L,
               x_sb, x_ss, x_sh, a_sb, a_ss, a_sh, b_sb, b_ss, b_sh, c_sb, c_ss, c_sh,
               vec_b, vec_x, pair_c};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bc_dtype == 0) return dispatch_fma(args, st);
  if (bc_dtype == 1) return dispatch_mma(args, st);
  return int(cudaErrorInvalidValue);
}

// Dynamic shared memory one block of ssd_scan_fwd takes at these sizes (0
// if N > 128).
extern "C" size_t ssd_scan_smem_bytes(int bc_dtype, int B, int H, int P, int N, int L) {
  const int nb = n_blocks16(N);
  if (nb == 0) return 0;
  if (bc_dtype == 1) return mma_smem(nb, mma_p_tile(B, H, P, N));
  return fma_smem_bytes(nb, fma_p_tile(B, H, P), L);
}
