// Bidirectional LSTM layer, forward and backward, for Hopper (sm_90a).
//
// Replaces the TPU kernels of nabu_tpu/ops/pallas/blstm.py reached from
// blstm_tm_apply: _tm_fwd -> _fwd_train_kernel2 (per time block
// xw = bf16(bf16(x @ wx) + b), then the serial masked LSTM cell for both
// directions, the backward one walking time descending, writing masked
// h in natural time order and the xw and f32 c residuals) and _tm_bwd ->
// _bwd_train_kernel2 (the serial chain dgates @ wh^T in reverse, then
// dx, dwx, dwh and db as block-batched products).
//
// (a) gemm: C[m, n] = sum_k A(m, k) B(k, n), one launch for both
//     directions (grid.z picks each operand's pointer), A and B each
//     row- or column-major with their own leading dimension, f32
//     accumulation. Four uses:
//     - blstm_proj, xw_d = cast(cast(x @ wx_d) + b_d): the bias is added
//       after the cast to the compute type, as in the TPU kernel;
//     - dx_d = dg_d @ wx_d^T (cast to the compute type; the wrapper sums
//       the directions, as the TPU's XLA side does);
//     - dwx_d = x^T @ dg_d, with db_d = sum over rows of dg_d taken from
//       the same tiles by the blocks of the first output row tile;
//     - dwh_d = hprev_d^T @ dg_d, hprev read from the layer's output one
//       step back along each direction's recurrence (no copy);
//     - the v1 family's backward (blstm_v1.cu): its gates recompute
//       gates_d = f32(xw_d) + hprev_d @ wh_d (f32 out, the addend read in
//       the element type) and its dwh, both over the stored carries.
//     grid.z runs `dirs` (1 or 2) pointer pairs: the unidirectional LSTM
//     (ops/lstm.py) takes one pair for its projection and two halves of K
//     for its dwh (the wrapper adds the halves).
//     Bound on the H100: operations (4x320 at T = 1024, B = 32, D = 640:
//     the projection, dx and dwx are 107 GFLOP each and dwh 54 GFLOP of
//     bf16 against 989 TFLOP/s). Design: a plain tiled GEMM, 64 x 128
//     block tiles staged in shared memory with 16-byte loads (the next K
//     tile waits in registers while the current one is multiplied), 8
//     warps each issuing 2 x 2 WMMA 16x16x16 bf16 fragments (tensor
//     cores, f32 accumulate), row- or column-major fragments as the
//     layout asks. The f32 variant is a SIMT tiled GEMM (4 x 4 outputs a
//     thread), so it checks the arithmetic at full precision without TF32.
//
// (b) blstm_recur: one persistent cooperative launch per layer walks the
//     whole sequence for both directions, as the TPU kernel's sequential
//     grid does. Bound on the H100 by the serial chain, not by bytes or
//     operations: T dependent steps, each a [B, H] x [H, 4H] product plus
//     the cell, and a grid-wide hand-off of h. Design: wh (2 x [320, 1280]
//     bf16, 1.6 MB) cannot sit in one SM, so block g of direction d owns
//     hidden units [g*HS, (g+1)*HS) and keeps their four gate columns of
//     wh, [H, 4*HS], in shared memory for the whole sequence, with c for
//     its units in shared memory (f32). Each step it reads h_{t-1} [B, H]
//     from a per-direction ping-pong buffer in global memory (L2
//     resident, read with ld.global.cg so no stale L1 line is seen, in
//     16-byte loads four deep per thread so the L2 latencies overlap;
//     the step's xw inputs are fetched before that),
//     computes its gates with f32 accumulation, applies the masked cell
//     and writes its slice of h. The blocks of a direction then meet at a
//     barrier: an atomic counter, a release fence before the arrival and
//     an acquire load in the spin. The launch is cooperative, so the
//     runtime refuses it unless every block is co-resident (a spin
//     barrier over blocks that are not would deadlock).
//     The training variant also writes the residuals of the backward: the
//     f32 carry c and the f32 pre-activation gates (x-part + h-part,
//     without the forget bias). Storing the gates replaces the TPU
//     backward's batched recompute hprev @ wh (_bwd_train_kernel2 prep):
//     335 MB a layer at T = 1024, B = 32, H = 320 against a product
//     kernel of 54 GFLOP.
//
// (c) blstm_bwd_recur: the backward's serial chain, one cooperative
//     persistent launch for both directions with the forward's split:
//     block g of a direction owns hidden units [g*HS, (g+1)*HS) and keeps
//     their rows of wh, [HS, 4H] (f32), in shared memory. The fw
//     direction walks time descending, the bw direction ascending. Each
//     step a block reads all of the previous step's dgates [B, 4H] (compute
//     type) from the dg output itself, which doubles as the exchange
//     buffer (each row is written once, then read by every block of its
//     direction: ld.global.cg, 16-byte loads eight deep), forms
//     dh_prev = dgates_prev @ wh^T for its units (f32), runs the masked
//     cell backward of _bwd_train_kernel2's direction() on its 4 x HS gate
//     columns from the stored gates and carries, writes its dgates (cast
//     to the compute type) to dg [T, B, 4H], and meets the other blocks of
//     its direction at a counter barrier as in (b). Per step it exchanges
//     4x the bytes of the forward (80 KB of dgates against 20 KB of h at
//     B = 32, H = 320). The dh and dc carries stay f32.
//
// Element types: __nv_bfloat16 (the training and serving path) and float
// (to check the card tightly). Gates and c are f32; h is carried in the
// element type, as in the TPU kernel.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

#include <type_traits>

namespace {

using bf16 = __nv_bfloat16;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(bf16 v) { return __bfloat162float(v); }

template <typename T>
__device__ __forceinline__ T from_f(float v);
template <>
__device__ __forceinline__ float from_f<float>(float v) { return v; }
template <>
__device__ __forceinline__ bf16 from_f<bf16>(float v) { return __float2bfloat16(v); }

// cast(cast(acc) + b): the bias is added in the compute type
template <typename T>
__device__ __forceinline__ T bias_epilogue(float acc, T b) {
  return from_f<T>(to_f(from_f<T>(acc)) + to_f(b));
}

// loads that bypass L1 (rewritten by other blocks during the launch)
__device__ __forceinline__ float load_cg(const float* p) { return __ldcg(p); }
__device__ __forceinline__ bf16 load_cg(const bf16* p) {
  return __ushort_as_bfloat16(__ldcg(reinterpret_cast<const unsigned short*>(p)));
}

__device__ __forceinline__ unsigned int ld_acquire(const unsigned int* p) {
  unsigned int v;
  asm volatile("ld.acquire.gpu.global.u32 %0, [%1];" : "=r"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ float sigmoid_f(float x) { return 1.f / (1.f + expf(-x)); }

// 16 bytes of T -> floats
__device__ __forceinline__ void unpack16(const uint4& r, float* dst, float) {
  dst[0] = __uint_as_float(r.x);
  dst[1] = __uint_as_float(r.y);
  dst[2] = __uint_as_float(r.z);
  dst[3] = __uint_as_float(r.w);
}
__device__ __forceinline__ void unpack16(const uint4& r, float* dst, bf16) {
  const unsigned int w[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    dst[2 * q] = __uint_as_float(w[q] << 16);  // element 2q: low half
    dst[2 * q + 1] = __uint_as_float(w[q] & 0xffff0000u);
  }
}

// stage rows [R, W] (element type T, written by other blocks) into
// shared memory as f32 rows of stride rp. The loads go through L2
// (ld.cg) and are issued DEPTH at a time per thread so their latencies
// overlap.
template <typename T, int DEPTH>
__device__ __forceinline__ void stage_rows(const T* src_rows, float* dst, int R, int W, int rp) {
  constexpr int EPV = 16 / sizeof(T);  // elements per 16-byte vector
  if (W % EPV == 0) {
    const int nvec = R * W / EPV;
    const uint4* src = reinterpret_cast<const uint4*>(src_rows);
    for (int v0 = threadIdx.x; v0 < nvec; v0 += DEPTH * blockDim.x) {
      uint4 r[DEPTH];
#pragma unroll
      for (int u = 0; u < DEPTH; ++u) {
        const int v = v0 + u * blockDim.x;
        r[u] = v < nvec ? __ldcg(src + v) : make_uint4(0u, 0u, 0u, 0u);
      }
#pragma unroll
      for (int u = 0; u < DEPTH; ++u) {
        const int v = v0 + u * blockDim.x;
        if (v < nvec) {
          const int e = v * EPV;
          const int b = e / W;
          unpack16(r[u], dst + (size_t)b * rp + (e - b * W), T());
        }
      }
    }
  } else {
    for (int i = threadIdx.x; i < R * W; i += blockDim.x) {
      const int b = i / W;
      dst[(size_t)b * rp + (i - b * W)] = to_f(load_cg(src_rows + i));
    }
  }
}

// grid-wide barrier of the G blocks of one direction at step s
__device__ __forceinline__ void direction_barrier(unsigned int* cnt, int s, int G) {
  __syncthreads();
  if (threadIdx.x == 0) {
    __threadfence();
    atomicAdd(cnt, 1u);
    const unsigned int target = (unsigned int)(s + 1) * (unsigned int)G;
    while (ld_acquire(cnt) < target) {
    }
    __threadfence();
  }
  __syncthreads();
}

// ---------------------------------------------------------------------------
// (a) GEMM
// ---------------------------------------------------------------------------

enum Epilogue { EPI_BIAS = 0, EPI_CAST = 1, EPI_F32 = 2, EPI_ADD_F32 = 3 };

// A(m, k) = A_COL ? a[k * lda + m] : a[m * lda + k], likewise B(k, n) =
// B_COL ? b[n * ldb + k] : b[k * ldb + n]; one pointer per direction
template <typename T>
struct GemmArgs {
  const T* a[2];
  const T* b[2];
  int lda, ldb;
  int M, N, K;
  int dirs;        // grid.z: 1 or 2 pointer pairs
  const T* bias;   // [2, N] (EPI_BIAS), or the addend [2, M, N] (EPI_ADD_F32)
  T* out;          // [2, M, N] (EPI_BIAS, EPI_CAST)
  float* outf;     // [2, M, N] (EPI_F32, EPI_ADD_F32)
  float* colsum;   // [2, N]: sum over k of B(k, n) (row-major B), or null
};

template <typename T, int EPI>
__device__ __forceinline__ void epilogue_store(const GemmArgs<T>& g, int dir, int m, int n,
                                               float acc) {
  const size_t i = ((size_t)dir * g.M + m) * g.N + n;
  if constexpr (EPI == EPI_BIAS) {
    g.out[i] = bias_epilogue<T>(acc, g.bias[(size_t)dir * g.N + n]);
  } else if constexpr (EPI == EPI_CAST) {
    g.out[i] = from_f<T>(acc);
  } else if constexpr (EPI == EPI_ADD_F32) {
    g.outf[i] = to_f(g.bias[i]) + acc;
  } else {
    g.outf[i] = acc;
  }
}

constexpr int PM = 64, PN = 128, PK = 32;
constexpr int P_THREADS = 256;  // 8 warps as 2 (M) x 4 (N), 32 x 32 each
constexpr int PAD = 8;          // tile row padding (elements; keeps 16-byte rows)
constexpr int CS = PN + 4;      // f32 output tile stride (multiple of 4)

// a [ROWS][COLS] bf16 tile of a matrix whose rows have stride ld, staged
// as smem rows of COLS + PAD; element (r, c) of the tile is
// g[(r0 + r) * ld + c0 + c], zero outside [R, C)
template <int ROWS, int COLS>
struct Tile {
  static constexpr int LD = COLS + PAD;
  static constexpr int NV = ROWS * COLS / 8 / P_THREADS;  // 16-byte vectors a thread
  static_assert(NV * 8 * P_THREADS == ROWS * COLS, "tile split");
  uint4 r[NV];

  // VEC (C, ld multiples of 8, 16-byte aligned base): a vector that
  // starts inside [R, C) lies inside it
  __device__ __forceinline__ void fetch(const bf16* g, int ld, int r0, int c0, int R, int C) {
#pragma unroll
    for (int u = 0; u < NV; ++u) {
      const int i = threadIdx.x + u * P_THREADS;
      const int row = i / (COLS / 8), col = (i % (COLS / 8)) * 8;
      r[u] = (r0 + row < R && c0 + col < C)
                 ? __ldg(reinterpret_cast<const uint4*>(g + (size_t)(r0 + row) * ld + c0 + col))
                 : make_uint4(0u, 0u, 0u, 0u);
    }
  }
  __device__ __forceinline__ void store(bf16* s) const {
#pragma unroll
    for (int u = 0; u < NV; ++u) {
      const int i = threadIdx.x + u * P_THREADS;
      const int row = i / (COLS / 8), col = (i % (COLS / 8)) * 8;
      *reinterpret_cast<uint4*>(s + row * LD + col) = r[u];
    }
  }
  static __device__ __forceinline__ void load_scalar(const bf16* g, int ld, int r0, int c0, int R,
                                                     int C, bf16* s) {
    const bf16 zero = __float2bfloat16(0.f);
    for (int i = threadIdx.x; i < ROWS * COLS; i += P_THREADS) {
      const int row = i / COLS, col = i % COLS;
      s[row * LD + col] =
          (r0 + row < R && c0 + col < C) ? g[(size_t)(r0 + row) * ld + c0 + col] : zero;
    }
  }
};

template <bool A_COL, bool B_COL, int EPI, bool VEC>
__global__ void __launch_bounds__(P_THREADS) gemm_wmma_bf16(GemmArgs<bf16> g) {
  using namespace nvcuda;
  // A tile: row-major [PM][PK] (rows m) or column-major [PK][PM] (rows k);
  // B tile: row-major [PK][PN] (rows k) or column-major [PN][PK] (rows n)
  using TA = Tile<A_COL ? PK : PM, A_COL ? PM : PK>;
  using TB = Tile<B_COL ? PN : PK, B_COL ? PK : PN>;
  using a_layout = typename std::conditional<A_COL, wmma::col_major, wmma::row_major>::type;
  using b_layout = typename std::conditional<B_COL, wmma::col_major, wmma::row_major>::type;
  constexpr int A_BYTES = (A_COL ? PK : PM) * TA::LD * 2;
  constexpr int B_BYTES = (B_COL ? PN : PK) * TB::LD * 2;
  constexpr int C_BYTES = PM * CS * 4;
  constexpr int SMEM = (A_BYTES + B_BYTES) > C_BYTES ? (A_BYTES + B_BYTES) : C_BYTES;
  __shared__ __align__(128) unsigned char smem[SMEM];
  bf16* a_s = reinterpret_cast<bf16*>(smem);
  bf16* b_s = reinterpret_cast<bf16*>(smem + A_BYTES);
  float* c_s = reinterpret_cast<float*>(smem);  // after the K loop

  const int dir = blockIdx.z;
  const bf16* a = g.a[dir];
  const bf16* b = g.b[dir];
  const int m0 = blockIdx.y * PM;
  const int n0 = blockIdx.x * PN;
  const int warp = threadIdx.x / 32;
  const int wm = warp / 4;  // 0..1
  const int wn = warp % 4;  // 0..3
  const bool sum_cols = g.colsum != nullptr && blockIdx.y == 0 && threadIdx.x < PN;
  float colsum = 0.f;

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.f);

  TA ta;
  TB tb;
  auto fetch = [&](int k0) {
    if constexpr (A_COL) ta.fetch(a, g.lda, k0, m0, g.K, g.M);
    else ta.fetch(a, g.lda, m0, k0, g.M, g.K);
    if constexpr (B_COL) tb.fetch(b, g.ldb, n0, k0, g.N, g.K);
    else tb.fetch(b, g.ldb, k0, n0, g.K, g.N);
  };
  if constexpr (VEC) fetch(0);

  for (int k0 = 0; k0 < g.K; k0 += PK) {
    if constexpr (VEC) {
      ta.store(a_s);
      tb.store(b_s);
    } else {
      if constexpr (A_COL) TA::load_scalar(a, g.lda, k0, m0, g.K, g.M, a_s);
      else TA::load_scalar(a, g.lda, m0, k0, g.M, g.K, a_s);
      if constexpr (B_COL) TB::load_scalar(b, g.ldb, n0, k0, g.N, g.K, b_s);
      else TB::load_scalar(b, g.ldb, k0, n0, g.K, g.N, b_s);
    }
    __syncthreads();
    if constexpr (VEC) {
      if (k0 + PK < g.K) fetch(k0 + PK);
    }
    if constexpr (!B_COL) {
      // column sums of B over this K tile (rows outside K are zero)
      if (sum_cols) {
#pragma unroll 8
        for (int r = 0; r < PK; ++r) colsum += __bfloat162float(b_s[r * TB::LD + threadIdx.x]);
      }
    }
#pragma unroll
    for (int kk = 0; kk < PK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, a_layout> af[2];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, b_layout> bfr[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int m = wm * 32 + i * 16;
        wmma::load_matrix_sync(af[i], A_COL ? a_s + kk * TA::LD + m : a_s + m * TA::LD + kk,
                               TA::LD);
      }
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int n = wn * 32 + j * 16;
        wmma::load_matrix_sync(bfr[j], B_COL ? b_s + n * TB::LD + kk : b_s + kk * TB::LD + n,
                               TB::LD);
      }
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) wmma::mma_sync(acc[i][j], af[i], bfr[j], acc[i][j]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j)
      wmma::store_matrix_sync(c_s + (wm * 32 + i * 16) * CS + wn * 32 + j * 16, acc[i][j], CS,
                              wmma::mem_row_major);
  __syncthreads();
  for (int i = threadIdx.x; i < PM * PN; i += P_THREADS) {
    const int r = i / PN, c = i % PN;
    const int m = m0 + r, n = n0 + c;
    if (m < g.M && n < g.N) epilogue_store<bf16, EPI>(g, dir, m, n, c_s[r * CS + c]);
  }
  if (sum_cols && n0 + (int)threadIdx.x < g.N)
    g.colsum[(size_t)dir * g.N + n0 + threadIdx.x] = colsum;
}

constexpr int SM_ = 64, SN = 64, SK = 16;
constexpr int S_THREADS = 256;  // 16 x 16 threads, 4 x 4 outputs each

// f32: SIMT tiles (no tensor cores, no TF32)
template <bool A_COL, bool B_COL, int EPI>
__global__ void __launch_bounds__(S_THREADS) gemm_simt_f32(GemmArgs<float> g) {
  __shared__ __align__(16) float a_s[SK][SM_ + 4];  // [k][m]
  __shared__ __align__(16) float b_s[SK][SN + 4];   // [k][n]
  const int dir = blockIdx.z;
  const float* a = g.a[dir];
  const float* b = g.b[dir];
  const int m0 = blockIdx.y * SM_;
  const int n0 = blockIdx.x * SN;
  const int tx = threadIdx.x % 16;
  const int ty = threadIdx.x / 16;
  const bool sum_cols = g.colsum != nullptr && blockIdx.y == 0 && threadIdx.x < SN;
  float colsum = 0.f;
  float acc[4][4] = {};

  for (int k0 = 0; k0 < g.K; k0 += SK) {
    // consecutive threads walk the contiguous dimension of each operand
    for (int i = threadIdx.x; i < SM_ * SK; i += S_THREADS) {
      const int r = A_COL ? i % SM_ : i / SK, c = A_COL ? i / SM_ : i % SK;
      const int m = m0 + r, k = k0 + c;
      a_s[c][r] = (m < g.M && k < g.K)
                      ? (A_COL ? a[(size_t)k * g.lda + m] : a[(size_t)m * g.lda + k])
                      : 0.f;
    }
    for (int i = threadIdx.x; i < SK * SN; i += S_THREADS) {
      const int r = B_COL ? i % SK : i / SN, c = B_COL ? i / SK : i % SN;
      const int k = k0 + r, n = n0 + c;
      b_s[r][c] = (k < g.K && n < g.N)
                      ? (B_COL ? b[(size_t)n * g.ldb + k] : b[(size_t)k * g.ldb + n])
                      : 0.f;
    }
    __syncthreads();
    if (sum_cols) {
#pragma unroll
      for (int k = 0; k < SK; ++k) colsum += b_s[k][threadIdx.x];
    }
#pragma unroll
    for (int k = 0; k < SK; ++k) {
      const float4 av4 = *reinterpret_cast<const float4*>(&a_s[k][ty * 4]);
      const float4 bv4 = *reinterpret_cast<const float4*>(&b_s[k][tx * 4]);
      const float av[4] = {av4.x, av4.y, av4.z, av4.w};
      const float bv[4] = {bv4.x, bv4.y, bv4.z, bv4.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int m = m0 + ty * 4 + i;
    if (m >= g.M) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + tx * 4 + j;
      if (n < g.N) epilogue_store<float, EPI>(g, dir, m, n, acc[i][j]);
    }
  }
  if (sum_cols && n0 + (int)threadIdx.x < g.N)
    g.colsum[(size_t)dir * g.N + n0 + threadIdx.x] = colsum;
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15u) == 0; }

template <bool A_COL, bool B_COL, int EPI>
int launch_gemm_bf16(const GemmArgs<bf16>& g, cudaStream_t stream) {
  const dim3 grid((g.N + PN - 1) / PN, (g.M + PM - 1) / PM, g.dirs);
  const bool vec = (A_COL ? g.M : g.K) % 8 == 0 && (B_COL ? g.K : g.N) % 8 == 0 &&
                   g.lda % 8 == 0 && g.ldb % 8 == 0 && aligned16(g.a[0]) && aligned16(g.a[1]) &&
                   aligned16(g.b[0]) && aligned16(g.b[1]);
  if (vec) gemm_wmma_bf16<A_COL, B_COL, EPI, true><<<grid, P_THREADS, 0, stream>>>(g);
  else gemm_wmma_bf16<A_COL, B_COL, EPI, false><<<grid, P_THREADS, 0, stream>>>(g);
  return (int)cudaGetLastError();
}

template <bool A_COL, bool B_COL, int EPI>
int launch_gemm_f32(const GemmArgs<float>& g, cudaStream_t stream) {
  const dim3 grid((g.N + SN - 1) / SN, (g.M + SM_ - 1) / SM_, g.dirs);
  gemm_simt_f32<A_COL, B_COL, EPI><<<grid, S_THREADS, 0, stream>>>(g);
  return (int)cudaGetLastError();
}

// the layouts the layers use: proj (row, row, bias), dx (row, col,
// cast), dwx / dwh (col, row, f32), the v1 gates recompute (row, row, f32
// plus addend)
template <typename T>
int launch_gemm(const GemmArgs<T>& g, int kind, cudaStream_t stream) {
  if (g.M <= 0 || g.N <= 0) return 0;
  if (g.dirs != 1 && g.dirs != 2) return (int)cudaErrorInvalidValue;
  if constexpr (sizeof(T) == 2) {
    switch (kind) {
      case 0: return launch_gemm_bf16<false, false, EPI_BIAS>(g, stream);
      case 1: return launch_gemm_bf16<false, true, EPI_CAST>(g, stream);
      case 2: return launch_gemm_bf16<true, false, EPI_F32>(g, stream);
      case 3: return launch_gemm_bf16<false, false, EPI_ADD_F32>(g, stream);
    }
  } else {
    switch (kind) {
      case 0: return launch_gemm_f32<false, false, EPI_BIAS>(g, stream);
      case 1: return launch_gemm_f32<false, true, EPI_CAST>(g, stream);
      case 2: return launch_gemm_f32<true, false, EPI_F32>(g, stream);
      case 3: return launch_gemm_f32<false, false, EPI_ADD_F32>(g, stream);
    }
  }
  return (int)cudaErrorInvalidValue;
}

// ---------------------------------------------------------------------------
// (b) persistent recurrence (forward)
// ---------------------------------------------------------------------------

constexpr int R_THREADS = 256;

struct RecurLayout {
  int hp;  // padded row stride of the staged h (floats, multiple of 4)
  int kp;  // H rounded up to a multiple of 4 (rows of the staged wh)
  size_t smem_bytes;
};

__host__ __device__ inline RecurLayout recur_layout(int B, int H, int hs) {
  RecurLayout l;
  l.kp = (H + 3) / 4 * 4;
  l.hp = l.kp + 4;
  l.smem_bytes = sizeof(float) * ((size_t)B * l.hp + (size_t)l.kp * hs * 4 + (size_t)B * hs);
  return l;
}

template <typename T, bool STORE>
__global__ void __launch_bounds__(R_THREADS) blstm_recur_kernel(
    const T* __restrict__ xw,        // [2, T, B, 4H]
    const int* __restrict__ lengths, // [B]
    const T* __restrict__ wh,        // [2, H, 4H]
    T* __restrict__ y,               // [T, B, 2H] masked outputs
    T* hbuf,                         // [2 dir][2 slot][B, H] scratch
    unsigned int* counters,          // [2], zero at launch
    float* __restrict__ c_out,       // STORE: [2, T, B, H] f32 carries
    float* __restrict__ g_out,       // STORE: [2, T, B, 4H] f32 pre-activation gates
    int Tn, int B, int H, int hs, int G, float forget_bias) {
  extern __shared__ __align__(16) float smem[];
  const RecurLayout L = recur_layout(B, H, hs);
  float* h_s = smem;                          // [B][hp]
  float* w_s = h_s + (size_t)B * L.hp;        // [kp][hs][4 gates]
  float* c_s = w_s + (size_t)L.kp * hs * 4;   // [B][hs]

  const int dir = blockIdx.x / G;
  const int j0 = (blockIdx.x % G) * hs;
  const size_t H4 = 4 * (size_t)H;

  const T* whd = wh + (size_t)dir * H * H4;
  for (int i = threadIdx.x; i < L.kp * hs * 4; i += blockDim.x) {
    const int gate = i % 4;
    const int jl = (i / 4) % hs;
    const int k = i / (4 * hs);
    const int j = j0 + jl;
    w_s[i] = (k < H && j < H) ? to_f(whd[(size_t)k * H4 + gate * H + j]) : 0.f;
  }
  for (int i = threadIdx.x; i < B * L.hp; i += blockDim.x) h_s[i] = 0.f;
  for (int i = threadIdx.x; i < B * hs; i += blockDim.x) c_s[i] = 0.f;
  __syncthreads();

  const T* xwd = xw + (size_t)dir * Tn * B * H4;
  T* hb = hbuf + (size_t)dir * 2 * B * H;
  unsigned int* cnt = counters + dir;
  const float4* w4 = reinterpret_cast<const float4*>(w_s);
  const int nq = L.kp / 4;

  for (int s = 0; s < Tn; ++s) {
    const int t = dir == 0 ? s : Tn - 1 - s;
    const T* hin = hb + (size_t)(s & 1) * B * H;
    T* hout = hb + (size_t)((s + 1) & 1) * B * H;
    // this thread's first (b, j) gate inputs, fetched ahead so their
    // latency overlaps the staging of h
    float xpre[4] = {0.f, 0.f, 0.f, 0.f};
    const int p0 = threadIdx.x;
    if (p0 < B * hs && j0 + p0 % hs < H) {
      const T* xr = xwd + ((size_t)t * B + p0 / hs) * H4 + j0 + p0 % hs;
#pragma unroll
      for (int g = 0; g < 4; ++g) xpre[g] = to_f(xr[g * H]);
    }
    if (s > 0) stage_rows<T, 4>(hin, h_s, B, H, L.hp);  // h_{-1} = 0 is already staged
    __syncthreads();

    for (int p = threadIdx.x; p < B * hs; p += blockDim.x) {
      const int b = p / hs;
      const int jl = p - b * hs;
      const int j = j0 + jl;
      if (j >= H) continue;
      const float4* hrow = reinterpret_cast<const float4*>(h_s + (size_t)b * L.hp);
      float a0 = 0.f, a1 = 0.f, a2 = 0.f, a3 = 0.f;
      for (int q = 0; q < nq; ++q) {
        const float4 hv = hrow[q];
        const float hk[4] = {hv.x, hv.y, hv.z, hv.w};
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const float4 wv = w4[(size_t)(4 * q + u) * hs + jl];
          a0 = fmaf(hk[u], wv.x, a0);
          a1 = fmaf(hk[u], wv.y, a1);
          a2 = fmaf(hk[u], wv.z, a2);
          a3 = fmaf(hk[u], wv.w, a3);
        }
      }
      float xg[4];
      if (p == p0) {
#pragma unroll
        for (int g = 0; g < 4; ++g) xg[g] = xpre[g];
      } else {
        const T* xr = xwd + ((size_t)t * B + b) * H4 + j;
#pragma unroll
        for (int g = 0; g < 4; ++g) xg[g] = to_f(xr[g * H]);
      }
      const float z0 = xg[0] + a0, z1 = xg[1] + a1, z2 = xg[2] + a2, z3 = xg[3] + a3;
      const float gi = sigmoid_f(z0);
      const float gf = sigmoid_f(z1 + forget_bias);
      const float gg = tanhf(z2);
      const float go = sigmoid_f(z3);
      const float c_new = gf * c_s[p] + gi * gg;
      const T h_new = from_f<T>(go * tanhf(c_new));
      const bool valid = t < __ldg(lengths + b);
      if (valid) c_s[p] = c_new;
      // masked carry: padding frames keep h (the staged value is exact)
      hout[(size_t)b * H + j] = valid ? h_new : from_f<T>(h_s[(size_t)b * L.hp + j]);
      y[((size_t)t * B + b) * 2 * H + (size_t)dir * H + j] = valid ? h_new : from_f<T>(0.f);
      if constexpr (STORE) {
        const size_t row = ((size_t)dir * Tn + t) * B + b;
        c_out[row * H + j] = c_s[p];
        float* gr = g_out + row * H4 + j;
        gr[0] = z0;
        gr[H] = z1;
        gr[2 * (size_t)H] = z2;
        gr[3 * (size_t)H] = z3;
      }
    }

    // hand h over to the other blocks of this direction
    direction_barrier(cnt, s, G);
  }
}

// co-residency check shared by the cooperative launches
template <typename K>
cudaError_t check_coresident(K kernel, int blocks, size_t smem) {
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return err;
  int device = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&device)) != cudaSuccess) return err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device)) != cudaSuccess)
    return err;
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, R_THREADS, smem)) !=
      cudaSuccess)
    return err;
  if (blocks > per_sm * sms) return cudaErrorCooperativeLaunchTooLarge;
  return cudaSuccess;
}

template <typename T, bool STORE>
int launch_recur(const T* xw, const int* lengths, const T* wh, T* y, T* hbuf,
                 unsigned int* counters, float* c_out, float* g_out, int Tn, int B, int H, int hs,
                 float forget_bias, void* stream) {
  if (Tn <= 0 || B <= 0) return 0;
  if (hs <= 0 || H <= 0) return (int)cudaErrorInvalidValue;
  const RecurLayout L = recur_layout(B, H, hs);
  auto kernel = blstm_recur_kernel<T, STORE>;
  int G = (H + hs - 1) / hs;
  cudaError_t err = check_coresident(kernel, 2 * G, L.smem_bytes);
  if (err != cudaSuccess) return (int)err;
  void* args[] = {(void*)&xw, (void*)&lengths, (void*)&wh, (void*)&y, (void*)&hbuf,
                  (void*)&counters, (void*)&c_out, (void*)&g_out, (void*)&Tn, (void*)&B,
                  (void*)&H, (void*)&hs, (void*)&G, (void*)&forget_bias};
  err = cudaLaunchCooperativeKernel((const void*)kernel, dim3(2 * G), dim3(R_THREADS), args,
                                    L.smem_bytes, (cudaStream_t)stream);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// (c) backward chain
// ---------------------------------------------------------------------------

struct ChainLayout {
  int rp;  // row stride (floats) of the staged dgates and the wh rows: 4H + 4
  size_t smem_bytes;
};

__host__ __device__ inline ChainLayout chain_layout(int B, int H, int hs) {
  ChainLayout l;
  l.rp = 4 * H + 4;
  l.smem_bytes = sizeof(float) * ((size_t)(B + hs) * l.rp + 2 * (size_t)B * hs);
  return l;
}

template <typename T>
__global__ void __launch_bounds__(R_THREADS) blstm_bwd_recur_kernel(
    const float* __restrict__ gates,  // [2, T, B, 4H] f32 pre-activations
    const float* __restrict__ cst,    // [2, T, B, H] f32 carries
    const T* __restrict__ gy,         // [T, B, 2H] cotangent of the layer output
    const int* __restrict__ lengths,  // [B]
    const T* __restrict__ wh,         // [2, H, 4H]
    T* dg,                            // [2, T, B, 4H] out; also the exchange
    unsigned int* counters,           // [2], zero at launch
    int Tn, int B, int H, int hs, int G, float forget_bias) {
  extern __shared__ __align__(16) float smem[];
  const ChainLayout L = chain_layout(B, H, hs);
  const int H4 = 4 * H;
  float* dg_s = smem;                          // [B][rp]: previous step's dgates
  float* w_s = dg_s + (size_t)B * L.rp;        // [hs][rp]: wh rows of this block's units
  float* dh_s = w_s + (size_t)hs * L.rp;       // [B][hs] dh passed through masked steps
  float* dc_s = dh_s + (size_t)B * hs;         // [B][hs] dc carry

  const int dir = blockIdx.x / G;
  const int j0 = (blockIdx.x % G) * hs;
  const T* whd = wh + (size_t)dir * H * H4;
  for (int i = threadIdx.x; i < hs * L.rp; i += blockDim.x) {
    const int jl = i / L.rp, k = i % L.rp;
    w_s[i] = (j0 + jl < H && k < H4) ? to_f(whd[(size_t)(j0 + jl) * H4 + k]) : 0.f;
  }
  for (int i = threadIdx.x; i < B * hs; i += blockDim.x) {
    dh_s[i] = 0.f;
    dc_s[i] = 0.f;
  }
  __syncthreads();

  const size_t dstride = (size_t)Tn * B;  // rows of one direction
  const float* gd = gates + (size_t)dir * dstride * H4;
  const float* cd = cst + (size_t)dir * dstride * H;
  T* dgd = dg + (size_t)dir * dstride * H4;
  unsigned int* cnt = counters + dir;
  const int nq = H4 / 4;

  for (int s = 0; s < Tn; ++s) {
    // the fw direction's backward walks time descending, the bw one ascending
    const int t = dir == 0 ? Tn - 1 - s : s;
    const int t_chain = dir == 0 ? t + 1 : t - 1;  // the step processed before
    const int t_fprev = dir == 0 ? t - 1 : t + 1;  // the forward recurrence's previous step
    // the step's inputs of one (b, j): gates i f g o, c_t, c_prev, the
    // output cotangent and the mask
    auto load_inputs = [&](int p, float* v) {
      const int b = p / hs;
      const int j = j0 + p % hs;
      const size_t row = (size_t)t * B + b;
      const float* gr = gd + row * H4 + j;
#pragma unroll
      for (int g = 0; g < 4; ++g) v[g] = gr[g * (size_t)H];
      v[4] = cd[row * H + j];
      v[5] = (t_fprev >= 0 && t_fprev < Tn) ? cd[((size_t)t_fprev * B + b) * H + j] : 0.f;
      v[6] = to_f(gy[row * 2 * H + (size_t)dir * H + j]);
      v[7] = t < __ldg(lengths + b) ? 1.f : 0.f;
    };
    // the first (b, j)'s inputs are fetched ahead so their latency
    // overlaps the staging of the dgates
    float pre[8];
    const int p0 = threadIdx.x;
    if (p0 < B * hs && j0 + p0 % hs < H) load_inputs(p0, pre);
    if (s > 0) stage_rows<T, 8>(dgd + (size_t)t_chain * B * H4, dg_s, B, H4, L.rp);
    __syncthreads();

    for (int p = threadIdx.x; p < B * hs; p += blockDim.x) {
      const int b = p / hs;
      const int jl = p - b * hs;
      const int j = j0 + jl;
      if (j >= H) continue;
      const size_t row = (size_t)t * B + b;
      float v[8];
      if (p == p0) {
#pragma unroll
        for (int q = 0; q < 8; ++q) v[q] = pre[q];
      } else {
        load_inputs(p, v);
      }
      const float zi = v[0], zf = v[1], zg = v[2], zo = v[3];
      const float c_t = v[4], c_prev = v[5], gyv = v[6], mf = v[7];
      // dh_prev = dgates_prev @ wh^T for this unit
      float acc = 0.f;
      if (s > 0) {
        const float4* dr = reinterpret_cast<const float4*>(dg_s + (size_t)b * L.rp);
        const float4* wr = reinterpret_cast<const float4*>(w_s + (size_t)jl * L.rp);
        float a0 = 0.f, a1 = 0.f, a2 = 0.f, a3 = 0.f;
        for (int q = 0; q < nq; ++q) {
          const float4 dv = dr[q];
          const float4 wv = wr[q];
          a0 = fmaf(dv.x, wv.x, a0);
          a1 = fmaf(dv.y, wv.y, a1);
          a2 = fmaf(dv.z, wv.z, a2);
          a3 = fmaf(dv.w, wv.w, a3);
        }
        acc = (a0 + a1) + (a2 + a3);
      }
      const float dh = acc + dh_s[p];
      // the masked cell backward (_bwd_train_kernel2 direction())
      const float gi = sigmoid_f(zi);
      const float gf = sigmoid_f(zf + forget_bias);
      const float gg = tanhf(zg);
      const float go = sigmoid_f(zo);
      const float tanh_c = tanhf(c_t);
      const float dh_total = gyv * mf + dh;
      const bool m = mf > 0.5f;
      const float dh_new = m ? dh_total : 0.f;
      const float dc_new = (m ? dc_s[p] : 0.f) + dh_new * go * (1.f - tanh_c * tanh_c);
      const float dgi = dc_new * gg * gi * (1.f - gi);
      const float dgf = dc_new * c_prev * gf * (1.f - gf);
      const float dgg = dc_new * gi * (1.f - gg * gg);
      const float dgo = dh_new * tanh_c * go * (1.f - go);
      T* out = dgd + row * H4 + j;
      out[0] = from_f<T>(dgi);
      out[H] = from_f<T>(dgf);
      out[2 * (size_t)H] = from_f<T>(dgg);
      out[3 * (size_t)H] = from_f<T>(dgo);
      dh_s[p] = m ? 0.f : dh_total;
      dc_s[p] = dc_new * gf + (m ? 0.f : dc_s[p]);
    }

    // hand this step's dgates over to the other blocks of this direction
    direction_barrier(cnt, s, G);
  }
}

template <typename T>
int launch_bwd_recur(const float* gates, const float* cst, const T* gy, const int* lengths,
                     const T* wh, T* dg, unsigned int* counters, int Tn, int B, int H, int hs,
                     float forget_bias, void* stream) {
  if (Tn <= 0 || B <= 0) return 0;
  if (hs <= 0 || H <= 0) return (int)cudaErrorInvalidValue;
  const ChainLayout L = chain_layout(B, H, hs);
  auto kernel = blstm_bwd_recur_kernel<T>;
  int G = (H + hs - 1) / hs;
  cudaError_t err = check_coresident(kernel, 2 * G, L.smem_bytes);
  if (err != cudaSuccess) return (int)err;
  void* args[] = {(void*)&gates, (void*)&cst, (void*)&gy, (void*)&lengths, (void*)&wh,
                  (void*)&dg, (void*)&counters, (void*)&Tn, (void*)&B, (void*)&H,
                  (void*)&hs, (void*)&G, (void*)&forget_bias};
  err = cudaLaunchCooperativeKernel((const void*)kernel, dim3(2 * G), dim3(R_THREADS), args,
                                    L.smem_bytes, (cudaStream_t)stream);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // namespace

// GEMM: kind 0 = projection (row-major A and B, bias after the cast),
// 1 = A row-major times B column-major (cast to the element type),
// 2 = A column-major times B row-major (f32 out, optional column sums of B),
// 3 = row-major A and B, f32 out plus the addend [2, M, N] passed as bias
extern "C" int nabu_blstm_gemm_bf16(const void* a0, const void* a1, const void* b0,
                                    const void* b1, int lda, int ldb, int M, int N, int K,
                                    int kind, int dirs, const void* bias, void* out,
                                    float* outf, float* colsum, void* stream) {
  GemmArgs<bf16> g{{(const bf16*)a0, (const bf16*)a1}, {(const bf16*)b0, (const bf16*)b1},
                   lda, ldb, M, N, K, dirs, (const bf16*)bias, (bf16*)out, outf, colsum};
  return launch_gemm(g, kind, (cudaStream_t)stream);
}

extern "C" int nabu_blstm_gemm_f32(const void* a0, const void* a1, const void* b0,
                                   const void* b1, int lda, int ldb, int M, int N, int K,
                                   int kind, int dirs, const void* bias, void* out,
                                   float* outf, float* colsum, void* stream) {
  GemmArgs<float> g{{(const float*)a0, (const float*)a1}, {(const float*)b0, (const float*)b1},
                    lda, ldb, M, N, K, dirs, (const float*)bias, (float*)out, outf, colsum};
  return launch_gemm(g, kind, (cudaStream_t)stream);
}

extern "C" int nabu_blstm_recur_bf16(const void* xw, const int* lengths, const void* wh,
                                     void* y, void* hbuf, unsigned int* counters, float* c_out,
                                     float* g_out, int T, int B, int H, int hs,
                                     float forget_bias, void* stream) {
  if (c_out != nullptr)
    return launch_recur<bf16, true>((const bf16*)xw, lengths, (const bf16*)wh, (bf16*)y,
                                    (bf16*)hbuf, counters, c_out, g_out, T, B, H, hs,
                                    forget_bias, stream);
  return launch_recur<bf16, false>((const bf16*)xw, lengths, (const bf16*)wh, (bf16*)y,
                                   (bf16*)hbuf, counters, nullptr, nullptr, T, B, H, hs,
                                   forget_bias, stream);
}

extern "C" int nabu_blstm_recur_f32(const void* xw, const int* lengths, const void* wh,
                                    void* y, void* hbuf, unsigned int* counters, float* c_out,
                                    float* g_out, int T, int B, int H, int hs,
                                    float forget_bias, void* stream) {
  if (c_out != nullptr)
    return launch_recur<float, true>((const float*)xw, lengths, (const float*)wh, (float*)y,
                                     (float*)hbuf, counters, c_out, g_out, T, B, H, hs,
                                     forget_bias, stream);
  return launch_recur<float, false>((const float*)xw, lengths, (const float*)wh, (float*)y,
                                    (float*)hbuf, counters, nullptr, nullptr, T, B, H, hs,
                                    forget_bias, stream);
}

extern "C" int nabu_blstm_bwd_recur_bf16(const float* gates, const float* cst, const void* gy,
                                         const int* lengths, const void* wh, void* dg,
                                         unsigned int* counters, int T, int B, int H, int hs,
                                         float forget_bias, void* stream) {
  return launch_bwd_recur<bf16>(gates, cst, (const bf16*)gy, lengths, (const bf16*)wh,
                                (bf16*)dg, counters, T, B, H, hs, forget_bias, stream);
}

extern "C" int nabu_blstm_bwd_recur_f32(const float* gates, const float* cst, const void* gy,
                                        const int* lengths, const void* wh, void* dg,
                                        unsigned int* counters, int T, int B, int H, int hs,
                                        float forget_bias, void* stream) {
  return launch_bwd_recur<float>(gates, cst, (const float*)gy, lengths, (const float*)wh,
                                 (float*)dg, counters, T, B, H, hs, forget_bias, stream);
}
