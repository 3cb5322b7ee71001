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
// fp32 or bf16; out y (B,S,H,P) fp32 and the final state (B,H,P,N) fp32.
// S % L == 0 (the model pads with zeros, which neither decay nor add).
//
// What bounds it on this card: at zamba2's prefill (B=4, S=512, H=112,
// P=64, N=64, L=256, B/C bf16) the function moves ~126 MB (x read, a read,
// B and C read once per group, y and the state written), ~38 us at
// 3.35 TB/s, and does ~10 GFLOP when the upper triangle is skipped. Those
// FLOP run on CUDA-core fp32 FMA (67 TFLOP/s, ~0.15 ms): tensor cores in
// TF32 would miss the 3e-5 tolerance against the fp32 reference. So this
// kernel is bound by fp32 FMA issue and by the shared-memory reads that
// feed it, well above the byte bound.
//
// What the design does about it: the TPU grid's sequential chunk axis,
// which carried the P x N state in VMEM scratch, becomes a loop over the
// chunks inside one block that keeps the state in shared memory (blocks run
// in parallel and carry nothing between them). One block of 256 threads per
// (P tile, head, batch row): state rows p are independent, so a tile of 32
// rows of P (instead of 64) doubles the blocks when B*H alone would not
// fill 132 SMs twice over (mamba2-370m at B=4: 128 -> 256 blocks), at the
// cost of recomputing the L x L score tile. A 256-row chunk does not fit
// in shared memory at once, so it is walked in sub-tiles of 64 rows: for
// each output sub-tile, the inter term from the carried state, then one
// 64 x 64 score tile per source sub-tile at or below it (tiles above the
// diagonal are skipped; on the diagonal the upper triangle is selected to
// 0, never multiplied by a mask, since exp of it overflows); then the state
// update from the whole chunk, after every output row has read the old
// state. Each thread holds a 4 x 4 register tile of scores and a 4 x P/16
// tile of y; rows of B, C and the state are padded to an odd stride so the
// 16 lanes that read 16 rows at once hit 16 banks. Inputs are read through
// their strides in the model's (B,S,H,.) layout with no transpose, and B/C
// may have head stride 0 (one group broadcast to every head), so the model
// never materialises the per-head copies. Accumulation is fp32 FMA.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;   // 16 x 16
constexpr int kSub = 64;        // chunk rows per sub-tile
constexpr int kSS = kSub + 1;   // score tile row stride
constexpr int kSMs = 132;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

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
};

// fp32 words of shared memory: state (PT x NS), C and B sub-tiles
// (kSub x NS each), x sub-tile (kSub x PT), scores (kSub x kSS), cumsum (L)
size_t smem_bytes(int NB, int PT, int L) {
  const size_t NS = NB * 16 + 1;
  return sizeof(float) * (PT * NS + 2 * kSub * NS + size_t(kSub) * PT + kSub * kSS + size_t(L));
}

// P tile: 32 rows when 64-row tiles would leave fewer than two blocks per
// SM, else 64
int p_tile(int B, int H, int P) {
  const long long blocks64 = static_cast<long long>(B) * H * ((P + 63) / 64);
  return (P > 32 && blocks64 >= 2 * kSMs) ? 64 : 32;
}

int n_blocks16(int N) { return N <= 16 ? 1 : N <= 32 ? 2 : N <= 64 ? 4 : N <= 128 ? 8 : 0; }

// rows [r0, r0 + rows) of B or C (row stride rs) into dst (kSub x NS),
// zero past `rows` and past N; optionally each row r scaled by
// exp(a_last - acs[r])
template <typename T, int NP>
__device__ __forceinline__ void load_bc(float* dst, const T* src, long long rs, long long r0,
                                        int rows, int N, const float* acs, float a_last) {
  constexpr int NS = NP + 1;
  for (int i = threadIdx.x; i < kSub * NP; i += kThreads) {
    const int r = i / NP, n = i % NP;
    float v = 0.f;
    if (r < rows && n < N) {
      v = to_f(src[(r0 + r) * rs + n]);
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

template <typename T, int NB, int PT>
__global__ void __launch_bounds__(kThreads) ssd_scan_kernel(const SsdArgs a) {
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
  const T* bp = static_cast<const T*>(a.bm) + b * a.b_sb + h * a.b_sh;
  const T* cp = static_cast<const T*>(a.cm) + b * a.c_sb + h * a.c_sh;

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
      load_bc<T, NP>(Cs, cp, a.c_ss, r0 + l0, min(kSub, L - l0), N, nullptr, 0.f);
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
        load_bc<T, NP>(Bs, bp, a.b_ss, r0 + s0, srows, N, nullptr, 0.f);
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
      load_bc<T, NP>(Bs, bp, a.b_ss, r0 + s0, srows, N, As + s0, a_last);
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

template <typename T, int NB, int PT>
int launch(const SsdArgs& a, cudaStream_t stream) {
  const size_t smem = smem_bytes(NB, PT, a.L);
  cudaError_t err = cudaFuncSetAttribute(ssd_scan_kernel<T, NB, PT>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  if (err != cudaSuccess) return int(err);
  const dim3 grid((a.P + PT - 1) / PT, a.H, a.B);
  ssd_scan_kernel<T, NB, PT><<<grid, kThreads, smem, stream>>>(a);
  return int(cudaGetLastError());
}

template <typename T, int PT>
int dispatch_n(const SsdArgs& a, cudaStream_t st) {
  switch (n_blocks16(a.N)) {
    case 1: return launch<T, 1, PT>(a, st);
    case 2: return launch<T, 2, PT>(a, st);
    case 4: return launch<T, 4, PT>(a, st);
    case 8: return launch<T, 8, PT>(a, st);
    default: return int(cudaErrorInvalidValue);
  }
}

template <typename T>
int dispatch(const SsdArgs& a, cudaStream_t st) {
  return p_tile(a.B, a.H, a.P) == 64 ? dispatch_n<T, 64>(a, st) : dispatch_n<T, 32>(a, st);
}

}  // namespace

// x (B,S,H,P) fp32 and B/C (B,S,H,N) with unit last stride, a (B,S,H) fp32,
// all through element strides (B/C may have head stride 0); y (B,S,H,P) and
// state (B,H,P,N) fp32 contiguous. bc_dtype: 0 = fp32, 1 = bf16. Needs
// S % L == 0 and N <= 128. Returns cudaGetLastError() after the launch (0 on
// success).
extern "C" int ssd_scan_fwd(
    const float* x, const float* a, const void* bm, const void* cm, float* y, float* state,
    int bc_dtype, int B, int S, int H, int P, int N, int L,
    long long x_sb, long long x_ss, long long x_sh,
    long long a_sb, long long a_ss, long long a_sh,
    long long b_sb, long long b_ss, long long b_sh,
    long long c_sb, long long c_ss, long long c_sh, void* stream) {
  if (L < 1 || S % L != 0 || n_blocks16(N) == 0) return int(cudaErrorInvalidValue);
  SsdArgs args{x, a, bm, cm, y, state, B, S, H, P, N, L,
               x_sb, x_ss, x_sh, a_sb, a_ss, a_sh, b_sb, b_ss, b_sh, c_sb, c_ss, c_sh};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bc_dtype == 0) return dispatch<float>(args, st);
  if (bc_dtype == 1) return dispatch<__nv_bfloat16>(args, st);
  return int(cudaErrorInvalidValue);
}

// Dynamic shared memory one block of ssd_scan_fwd takes at these sizes (0
// if N > 128).
extern "C" size_t ssd_scan_smem_bytes(int B, int H, int P, int N, int L) {
  const int nb = n_blocks16(N);
  return nb == 0 ? 0 : smem_bytes(nb, p_tile(B, H, P), L);
}
