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
//     directions (grid.z picks each operand pair), A and B each K- or
//     MN-major with their own leading dimension, f32 accumulation. Uses:
//     - blstm_proj (kind 0), xw_d = cast(cast(x @ wx_d) + b_d): the bias is
//       added after the cast to the compute type, as in the TPU kernel
//       (_tm_fwd's per-block x @ wx, blstm.py:898), and lstm_proj (dirs 1);
//     - dx_d = dg_d @ wx_d^T (kind 1, cast to the compute type; the wrapper
//       sums the directions, as the TPU's XLA side does);
//     - dwx_d = x^T @ dg_d with db_d = the column sums of dg_d, and dwh_d =
//       hprev_d^T @ dg_d, hprev read from the layer's output one step back
//       along each direction's recurrence, no copy (kind 2, f32 out;
//       _tm_bwd's finish, blstm.py:1006);
//     - the v1 backward (_fused_bwd, blstm.py:509): the gates recompute
//       gates_d = f32(xw_d) + hprev_d @ wh_d (kind 3, f32 plus the addend)
//       and its dwh (kind 2), over the stored carries.
//     Bound on the H100: operations for the v2 products. At T = 1024, B =
//     32 (valid tokens counted as PERF.md does) the 4x320 projection, dx
//     and dwx at D = 640 are 107 GFLOP each, 0.109 ms at 989 TFLOP/s bf16,
//     dwh 54 GFLOP; at D = 1280 (the Listener's pyramid) 215 GFLOP, 0.217
//     ms; las_large's pyramid_0 projection, dx and dwx 550 GFLOP at D =
//     2048. Its v1 gates recompute (B = 64, H = 512, T = 1024) is bound by
//     its 1.6 GB of f32 output and bf16 addend (0.52 ms at 3.35 TB/s), its
//     v1 dwh by its 0.68 GB of bf16 inputs (0.20 ms).
//     Design (gemm_wgmma_bf16): a persistent kernel over 128 x 128 output
//     tiles (x direction x K slice), 64-deep K tiles loaded by TMA (one 2-D
//     tensor map per operand and direction, built on the host at each call,
//     128-byte swizzle, zero fill past the ragged M, N and K edges) into a
//     ring of stages in dynamic shared memory with full / empty mbarriers.
//     One producer thread issues the loads and runs ahead across tiles; two
//     consumer warpgroups each multiply a 64-row half with wgmma
//     m64n128k16 (operands read from shared memory in either major through
//     the descriptor's layout and the instruction's transpose bits), one
//     wgmma group kept in flight while the next stage is waited for; 3
//     stages and two blocks an SM, so one block's epilogue overlaps the
//     other's products. bf16 outputs (kinds 0, 1) are cast (and biased)
//     from the accumulator registers into a bf16 staging box in shared
//     memory, 64 columns a pass, and leave by TMA stores; f32 outputs
//     (kinds 2, 3) are stored from the registers, each quad of lanes first
//     trading values so a lane writes 8 contiguous columns. Kind 2 has few output tiles and a long K (T x B): the
//     wrapper cuts K into S slices of whole K tiles when the tiles x dirs
//     fill the card's resident blocks poorly (S a pure function of M, N, K
//     and dirs, decided in Python); each slice writes its f32 partial sums
//     to a workspace [S, dirs, M, N] and gemm_splitk_sum adds them in the
//     order 0 .. S-1, so the result repeats bit for bit. db is summed in
//     the same launch by the blocks of the first row tile, from the B
//     stages already in shared memory (a fixed order over 16 row groups,
//     then colsum_finish over the slices): no second read of dg. Kinds 0,
//     1 and 3 never split: the reduction order of each of their outputs
//     depends on K alone, so a row's bits do not depend on how many rows a
//     call has (streamed == offline). The wrapper picks the kernel by a
//     predicate of the operand layouts alone (16-byte-aligned bases,
//     leading dimensions multiples of 8 elements, which TMA needs), never
//     of M: shapes outside it (H = 9, 12 in the tests) take
//     gemm_wmma_bf16, the earlier tiled kernel (64 x 128 tiles, 8 warps of
//     2 x 2 WMMA 16x16x16 fragments, the next K tile staged through
//     registers, the column sums inside the kernel).
//     The f32 GEMM (gemm_ffma_f32) takes every f32 launch of every layout:
//     the dwh of nabu_tpu/ops/pallas/lstm.py's _bwd (lstm.py:137-139,
//     lstm_bwd_dwh) and the f32 forms of _tm_fwd's, _tm_bwd's and
//     _fused_bwd's products (blstm_proj, lstm_proj, dx, dwx + db, dwh, the
//     v1 gates recompute and dwh). It stays on the FFMA units, no TF32, so
//     the f32 path checks the arithmetic at full precision; bound on the
//     H100 by operations at 67 TFLOP/s (lstm_bwd_dwh at T = 1024, B = 32,
//     H = 320: 26.8 GFLOP, 0.40 ms). Design: 64 x 128 output tiles of 128
//     threads, each thread 8 x 8 accumulators read as two 4-wide halves a
//     side, so one k costs four conflict-free LDS.128 for 64 FFMA; 16-deep
//     K tiles through a 4-stage ring in dynamic shared memory, filled by
//     cp.async (16-byte cp.async.cg for an MN-major operand on a 16-byte
//     base with a leading dimension a multiple of 4, 4-byte cp.async.ca
//     otherwise; a K-major operand -- A of kinds 0, 1, 3, B of kind 1 --
//     is transposed on the way in by its 4-byte copies, so the inner loop
//     reads contiguous m and n whatever the layout), three tiles in flight
//     while one is multiplied; two blocks an SM with up to 255 registers a
//     thread (at 128, as 128 x 128 tiles of 256 threads had it, kinds 0 and
//     3 spilled). 64-row tiles waste nothing at M = 320 (lstm_bwd_dwh's H)
//     and let the K split fill the card in whole waves. Kind 2 splits K as
//     the bf16 kernel does, by ops/blstm.split_k_f32 (its own tile, depth
//     and time a K tile), with the same second pass (gemm_splitk_sum,
//     colsum_finish) and db summed from the B stages in shared memory;
//     kinds 0, 1, 3 never split, so a row's bits do not depend on M.
//
// (b) blstm_recur: one persistent cooperative launch per layer walks the
//     whole sequence for both directions, as the TPU kernel's sequential
//     grid does. Bound on the H100 by the serial chain, not by bytes or
//     operations: T dependent steps, each a [B, H] x [H, 4H] product a
//     direction plus the cell, and a hand-off of h between blocks. Rows of
//     the batch are independent in the walk. Design (the chain's of (c),
//     carried over): block (dir, rg, ug) owns 16 MT rows x U units of one
//     direction (U x MT = 16 x 1, 8 x 2 or 4 x 4, from ops/blstm.walk_plan:
//     the first whose 2 ceil(B / 16 MT) ceil(H / U) blocks are co-resident
//     one an SM; 16 x 1 at B = 32, H = 320, 80 blocks), keeps its units'
//     four gate columns of wh in shared memory for the whole walk and c and
//     h of its cell pairs (one a thread) in registers, and meets only the
//     ceil(H / U) blocks of its (direction, row group), at a counter of
//     their own: a release add after a block barrier to arrive, an acquire
//     load then a block barrier to wait (no further fence). Each step, after
//     that counter shows the previous step published, it pulls only its
//     rows of h_{t-1} from the exchange (ld.cg straight into registers,
//     every load in flight at once) and forms the gates' h-part in f32:
//     - bf16 on tensor cores: the 8 warps split K = H into chunks of 32 (10
//       at H = 320, two a warp), each runs mma.sync m16n8k16 over its
//       chunks for the block's 16 MT rows x 4U columns (wh's columns staged
//       once as B fragments, 40 KB at U = 16, H = 320; h's 16-byte loads
//       are the A fragments) and stores its partial sums; after a block
//       barrier each thread adds its 4 gates' partials in warp order;
//     - f32 on the FMA pipes (no TF32: the 1e-4 check), register-blocked:
//       a half warp owns 4 rows x 4 units' 4 gates (16 columns of wh, [4U,
//       ceil4(H)] f32, 80 KB); its 16 lanes take the quads ks + 16 p of K
//       (5 each at H = 320), so a quad of h feeds 16 columns and a float4
//       of wh 4 rows, and a reduce-scatter of shuffles over the half warp
//       adds the 16 K slices and leaves each lane the 4 gates of its cell.
//     Both sum each output in a fixed order that depends on H alone, so a
//     second launch repeats the bits and a row's sums depend neither on B
//     nor on the form. Then the masked cell on the step's xw (fetched
//     before the barrier: it does not depend on the exchange), the carried
//     h to the exchange, the arrival (whose release waits for those stores
//     alone), then y and (training) the stores of c and the gates. Shared
//     memory at most 16 U ceil4(H) bytes, so the design limit is the
//     card's SMs, as the chain's: B <= 48 at H = 320, 64 at 256, 32 at 512.
//     Where it was hard: the walk's K (H) and outputs (4 gates a unit) are
//     the chain's transposed, whose 64 K slices of 5 quads (K = 4H) do not
//     split H = 320's 80 quads: hence 16 slices a half warp in f32, K
//     chunks a warp in bf16, and a thread map that lands a unit's 4 gates
//     in the thread of its cell. On the fw direction's padding frames the
//     carried h is held but y is 0, and the stored gates there come from
//     the held h, so the exchange is a buffer of its own, [2 directions][2
//     slots][B][ceil8(H)], of the carried h, not y (rows of whole 16-byte
//     loads, the padding zero: H = 9 and 12 in the tests; partial row and
//     unit groups are masked). The slots ping-pong: a block writes slot (s
//     + 1) % 2 at step s only after its counter showed every block of its
//     group arrived s times, and a block arrives at step s - 1 only after
//     its loads of that step's slot, (s - 1) % 2 = (s + 1) % 2, were
//     consumed, so no block overwrites a slot another may still read (no
//     block arrives s + 1 times before all arrived s times). Registers: 154
//     to 233 a thread at one block an SM (the f32 form's 64 sums and 4 x 5
//     quads of h the most), no spills.
//     The training variant also writes the residuals of the backward: the
//     f32 carry c and the f32 pre-activation gates (x-part + h-part,
//     without the forget bias). Storing the gates replaces the TPU
//     backward's batched recompute hprev @ wh (_bwd_train_kernel2 prep):
//     335 MB a layer at T = 1024, B = 32, H = 320 against a product
//     kernel of 54 GFLOP. A third variant, launched only by the step probe,
//     sums each block's clock64 cycles a step by wait, pull, product and
//     cell.
//
// (c) blstm_bwd_recur: the backward's serial chain, one cooperative
//     persistent launch for both directions; the fw direction walks time
//     descending, the bw direction ascending. Bound on the H100 by bytes in
//     the reckoning of (a) (the f32 gates and carries read once, gy and wh
//     read, dg written: 0.63 GB at T = 1024, B = 32, H = 320 in bf16, 0.19
//     ms at 3.35 TB/s), but run by its T dependent steps, each a
//     [B, 4H] x [4H, H] product a direction, the cell and a hand-off
//     between blocks. Rows of the batch are independent in the chain.
//     Design: block (dir, rg, ug) owns 16 MT rows x U units of one
//     direction (U x MT = 8 x 1, 16 x 1, 8 x 2 or 4 x 4, from
//     ops/blstm.chain_plan: the least work a block whose 2 ceil(B / 16 MT)
//     ceil(H / U) blocks are co-resident one an SM), keeps its units' rows
//     of wh, [U, 4H] f32, in shared memory, and meets only the ceil(H / U)
//     blocks of its (direction, row group), at a counter of their own. The
//     rows' sums do not depend on the form. Each step, after
//     that counter shows the previous step published, it pulls only its
//     rows of the previous step's dgates from the dg output, which doubles
//     as the exchange buffer: the dgates as stored in the compute type
//     (bf16: the rounded values, 4 to an 8-byte ld.cg straight into
//     registers, widened there; 16 MT x 4H x 2 bytes = 40 KB MT at H =
//     320), every load of a pass in flight at once. It forms dh_prev =
//     dgates_prev @ wh^T for its units in f32 with register-blocked FFMA (a
//     thread 4 MT rows x U units over a K slice of H / 64 quads of 4
//     values, 5 at H = 320 in both types: a quad feeds U units, a float4
//     of wh 4 rows), adds the 64 K slices by a reduce-scatter of shuffles
//     and the two warps of a row block in warp
//     order (a second launch repeats the bits), runs the masked cell
//     backward of _bwd_train_kernel2's direction() from the stored gates
//     and carries (fetched before the barrier: they do not depend on the
//     exchange), writes its dgates cast to the compute type and arrives at
//     its counter. The dh and dc carries stay f32, in registers. Shared
//     memory 4 (U 4H + 8 x 4 U MT) bytes (82 KB at 16 x 1, H = 320), so the
//     design limit is the card's SMs: B <= 48 at H = 320, 64 at 256, 32 at
//     512.
//
// Element types: __nv_bfloat16 (the training and serving path) and float
// (to check the card tightly). Gates and c are f32; h is carried in the
// element type, as in the TPU kernel.

#include <cuda.h>
#include <mma.h>

#include <algorithm>
#include <type_traits>

#include "serial.cuh"

namespace {

// cast(cast(acc) + b): the bias is added in the compute type
template <typename T>
__device__ __forceinline__ T bias_epilogue(float acc, T b) {
  return from_f<T>(to_f(from_f<T>(acc)) + to_f(b));
}

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

// --- the Hopper GEMM: TMA ring + wgmma ---------------------------------------

constexpr int GM = 128, GN = 128, GK = 64;    // output tile, K tile
constexpr int G_CONSUMERS = 256;              // two warpgroups, 64 rows each
constexpr int G_THREADS = G_CONSUMERS + 32;   // and one producer warp
constexpr int G_TILE = GM * GK * 2;           // bytes of an A (or B) stage, 16 KB
constexpr int G_HALF = G_TILE / 2;            // a 64 x 64 box, 8 KB
// a 3-stage ring and two blocks an SM, so one block's epilogue overlaps the
// other's products
constexpr int G_STAGES = 3;
constexpr int G_BLOCKS = 2;

// Shared memory of a block by epilogue. bf16 outputs (kinds 0, 1) go out
// through a bf16 staging buffer (each warpgroup's 64 x 128 outputs in two
// passes of a 128-byte-swizzled 64 x 64 box) and TMA stores; f32 outputs
// (kinds 2, 3) are stored from the registers.
template <int EPI>
struct WgmmaShape {
  static constexpr bool STAGED = EPI == EPI_BIAS || EPI == EPI_CAST;
  static constexpr int RING = 2 * G_STAGES * G_TILE;
  static constexpr int OUT = STAGED ? 2 * G_HALF : 0;
  // the barriers, then (kind 2) the 16 row groups' column sums to add
  static constexpr int RED = EPI == EPI_F32 ? 16 * GN * 4 : 0;
  static constexpr int NEED = RING + OUT + 2 * G_STAGES * 8 + RED;
  // all a block may have with two an SM (228 KB, 1 KB reserved a block):
  // the room left over aligns the ring to the swizzle's 1024 bytes
  static constexpr int SMEM = 233472 / G_BLOCKS - 1024;
  static_assert(NEED + 16 * 61 <= SMEM, "shared memory");
};

// tensor maps of A, B and (staged kinds) the output per direction, in the
// kernel's parameter space, and the epilogue's operands; outf is the
// split-K workspace [S, dirs, M, N] when splits > 1
struct WgmmaArgs {
  CUtensorMap a[2];
  CUtensorMap b[2];
  CUtensorMap o[2];
  int M, N, K, dirs, splits;
  int staged;        // the output goes out by TMA (kinds 0, 1 with N a multiple of 8)
  const bf16* bias;  // [dirs, N] (EPI_BIAS) or the addend [dirs, M, N] (EPI_ADD_F32)
  bf16* out;         // [dirs, M, N] (EPI_BIAS, EPI_CAST)
  float* outf;       // [splits, dirs, M, N] (EPI_F32), [dirs, M, N] (EPI_ADD_F32)
  float* colsum_ws;  // EPI_F32: [splits, dirs, N] column sums of B over each slice, or null
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(smem_u32(bar)) : "memory");
}

// spin until the phase of the given parity has completed
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
  } while (!done);
}

// one box of a 2-D tensor map into shared memory: c0 the inner (contiguous)
// coordinate, c1 the row; completion counted in bytes on bar
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map, uint64_t* bar, int c0,
                                         int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4}], [%2];" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1)
      : "memory");
}

// one box from shared memory into a 2-D tensor map (TMA clips what lies
// outside the tensor), in the thread's bulk async-group
__device__ __forceinline__ void tma_store(const CUtensorMap* map, const void* src, int c0, int c1) {
  asm volatile("cp.async.bulk.tensor.2d.global.shared::cta.bulk_group [%0, {%2, %3}], [%1];" ::"l"(
                   reinterpret_cast<uint64_t>(map)),
               "r"(smem_u32(src)), "r"(c0), "r"(c1)
               : "memory");
}

// 128 threads of one warpgroup meet (barrier 1 + wg; 0 is __syncthreads)
__device__ __forceinline__ void wg_sync(int wg) {
  asm volatile("bar.sync %0, 128;" ::"r"(1 + wg) : "memory");
}

// wgmma shared-memory descriptor of a 128-byte-swizzled operand: start
// address, leading and stride byte offsets (16-byte units), layout 1 =
// SWIZZLE_128B. K-major: rows of 64 K elements (128 bytes), 8-row groups
// 1024 bytes apart (SBO), LBO unused. MN-major: rows of 64 M (or N)
// elements, one per K, 8-K-row groups 1024 bytes apart (SBO), the next 64
// M (or N) elements 8 KB on (LBO)
__device__ __forceinline__ uint64_t gmma_desc(const void* smem, uint32_t lbo, uint32_t sbo) {
  return (uint64_t)((smem_u32(smem) & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(N) : "memory");
}
// keep the compiler from moving accumulator reads or writes across the
// asynchronous product
__device__ __forceinline__ void fence_acc(float (&d)[64]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d[64 x 128] += A[64 x 16] B[16 x 128], bf16 operands from shared memory,
// f32 accumulators; TA / TB: A / B MN-major (transposed)
template <int TA, int TB>
__device__ __forceinline__ void wgmma_m64n128k16(float (&d)[64], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63},"
      " %64, %65, p, 1, 1, %67, %68;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]),
        "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]),
        "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(1), "n"(TA), "n"(TB));
}

// the register epilogue of 8 adjacent outputs (m, n .. n + 7), n a
// multiple of 8: 16-byte stores when the row holds them all and N is a
// multiple of 8 (then m N + n is too), else one at a time up to N. Kinds 1
// (N = D not a multiple of 8), 2 and 3; kind 0 always leaves by TMA (its
// ldb = N is a multiple of 8 for the wgmma kernel)
template <int EPI>
__device__ __forceinline__ void wgmma_store(const WgmmaArgs& g, int dir, int split, int m, int n,
                                            float (&v)[8]) {
  const bool vec = n + 8 <= g.N && g.N % 8 == 0;
  const int cnt = min(8, g.N - n);
  if constexpr (EPI == EPI_CAST) {
    const size_t i = ((size_t)dir * g.M + m) * g.N + n;
    bf16 r[8];
#pragma unroll
    for (int e = 0; e < 8; ++e) r[e] = from_f<bf16>(v[e]);
    if (vec) {
      uint32_t w[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const __nv_bfloat162 pair = __halves2bfloat162(r[2 * e], r[2 * e + 1]);
        w[e] = *reinterpret_cast<const uint32_t*>(&pair);
      }
      *reinterpret_cast<uint4*>(g.out + i) = make_uint4(w[0], w[1], w[2], w[3]);
    } else {
#pragma unroll
      for (int e = 0; e < 8; ++e)
        if (e < cnt) g.out[i + e] = r[e];
    }
  } else if constexpr (EPI == EPI_F32 || EPI == EPI_ADD_F32) {
    const size_t i = (((size_t)split * g.dirs + dir) * g.M + m) * g.N + n;
    if constexpr (EPI == EPI_ADD_F32) {
      if (vec && (reinterpret_cast<uintptr_t>(g.bias) & 15) == 0) {
        float f[8];
        unpack16(*reinterpret_cast<const uint4*>(g.bias + i), f, bf16());
#pragma unroll
        for (int e = 0; e < 8; ++e) v[e] += f[e];
      } else {
#pragma unroll
        for (int e = 0; e < 8; ++e)
          if (e < cnt) v[e] += to_f(g.bias[i + e]);
      }
    }
    if (vec) {
      *reinterpret_cast<float4*>(g.outf + i) = make_float4(v[0], v[1], v[2], v[3]);
      *reinterpret_cast<float4*>(g.outf + i + 4) = make_float4(v[4], v[5], v[6], v[7]);
    } else {
#pragma unroll
      for (int e = 0; e < 8; ++e)
        if (e < cnt) g.outf[i + e] = v[e];
    }
  }
}

// one output tile of the persistent loop: work item w -> the tile's first
// row and column, direction, K slice and its K tiles [kt0, kt0 + nk)
struct TileWork {
  int m0, n0, dir, split, kt0, nk;
};

__device__ __forceinline__ TileWork tile_work(const WgmmaArgs& g, int w) {
  const int tn = (g.N + GN - 1) / GN, tm = (g.M + GM - 1) / GM;
  TileWork t;
  t.n0 = (w % tn) * GN;
  w /= tn;
  t.m0 = (w % tm) * GM;
  w /= tm;
  t.dir = w % g.dirs;
  t.split = w / g.dirs;
  // this slice's K tiles: the split of ops/blstm.split_bounds
  const int ktiles = (g.K + GK - 1) / GK;
  t.kt0 = (int)((long long)t.split * ktiles / g.splits);
  t.nk = (int)((long long)(t.split + 1) * ktiles / g.splits) - t.kt0;
  return t;
}

// A persistent kernel: block b takes the work items (output tile x
// direction x K slice) b, b + gridDim.x, ..., N tiles fastest (the blocks
// in flight share A's rows). A_MN / B_MN: the operand's M (N) elements
// are contiguous (A(m, k) = a[k lda + m], B(k, n) = b[k ldb + n]), else
// its K elements. The ring's stage and phase run on across tiles, so the
// producer loads the next tile while the consumers store this one.
template <bool A_MN, bool B_MN, int EPI>
__global__ void __launch_bounds__(G_THREADS, G_BLOCKS)
    gemm_wgmma_bf16(const __grid_constant__ WgmmaArgs g) {
  using Shape = WgmmaShape<EPI>;
  extern __shared__ unsigned char g_smem_raw[];
  // the 128-byte swizzle repeats every 1024 bytes: tiles start on it
  const uint32_t pad = (1024 - (smem_u32(g_smem_raw) & 1023)) & 1023;
  if (pad + Shape::NEED > Shape::SMEM) __trap();  // the base is 1024-aligned in practice
  unsigned char* smem = g_smem_raw + pad;
  unsigned char* a_s = smem;                         // [G_STAGES][G_TILE]
  unsigned char* b_s = smem + G_STAGES * G_TILE;     // [G_STAGES][G_TILE]
  unsigned char* out_s = smem + Shape::RING;       // [2 warpgroups][64 x 64 bf16] (staged)
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + Shape::RING + Shape::OUT);
  uint64_t* empty = full + G_STAGES;
  float* col_red = reinterpret_cast<float*>(empty + G_STAGES);  // [16][GN]
  const int work = ((g.N + GN - 1) / GN) * ((g.M + GM - 1) / GM) * g.dirs * g.splits;

  if (threadIdx.x == 0) {
#pragma unroll
    for (int s = 0; s < G_STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], G_CONSUMERS / 32);  // lane 0 of each consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= G_CONSUMERS) {
    // producer: one thread keeps the ring full
    if (threadIdx.x == G_CONSUMERS) {
      int it = 0;
      for (int w = blockIdx.x; w < work; w += gridDim.x) {
        const TileWork tw = tile_work(g, w);
        const CUtensorMap* ma = &g.a[tw.dir];
        const CUtensorMap* mb = &g.b[tw.dir];
        for (int i = 0; i < tw.nk; ++i, ++it) {
          const int s = it % G_STAGES;
          if (it >= G_STAGES) mbar_wait(&empty[s], ((it / G_STAGES) - 1) & 1);
          mbar_expect_tx(&full[s], 2 * G_TILE);
          const int k = (tw.kt0 + i) * GK;
          unsigned char* as = a_s + s * G_TILE;
          unsigned char* bs = b_s + s * G_TILE;
          if constexpr (A_MN) {
            tma_load(as, ma, &full[s], tw.m0, k);
            tma_load(as + G_HALF, ma, &full[s], tw.m0 + 64, k);
          } else {
            tma_load(as, ma, &full[s], k, tw.m0);
          }
          if constexpr (B_MN) {
            tma_load(bs, mb, &full[s], tw.n0, k);
            tma_load(bs + G_HALF, mb, &full[s], tw.n0 + 64, k);
          } else {
            tma_load(bs, mb, &full[s], k, tw.n0);
          }
        }
      }
    }
    return;
  }

  // consumers: warpgroup wg multiplies output rows [64 wg, 64 wg + 64)
  const int wg = threadIdx.x / 128;
  const int t = threadIdx.x % 128;
  const int lane = threadIdx.x % 32;
  const int q = lane % 4;
  int it = 0;
  for (int w = blockIdx.x; w < work; w += gridDim.x) {
    const TileWork tw = tile_work(g, w);
    float acc[64];
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[i] = 0.f;
    // kind 2's db: the blocks of the first row tile also sum B's columns
    // over their slice from the stages in shared memory, thread x taking
    // columns [8 (x % 16), 8 (x % 16) + 8) of rows [4 (x / 16), 4 (x / 16) +
    // 4) of each K tile (zeros past K), in order
    const bool sums = EPI == EPI_F32 && g.colsum_ws != nullptr && tw.m0 == 0;
    float csum[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};

    for (int i = 0; i < tw.nk; ++i, ++it) {
      const int s = it % G_STAGES;
      mbar_wait(&full[s], (it / G_STAGES) & 1);
      // K-major A: rows [64 wg, 64 wg + 64) of the 128-row box; MN-major
      // A: the box of M elements [64 wg, 64 wg + 64)
      const unsigned char* as = a_s + s * G_TILE + wg * G_HALF;
      const unsigned char* bs = b_s + s * G_TILE;
      fence_acc(acc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < GK / 16; ++kk) {
        // 16 K elements on: 32 bytes along a K-major row, 16 rows (2 KB)
        // of an MN-major box
        const uint64_t da = A_MN ? gmma_desc(as + kk * 2048, G_HALF, 1024)
                                 : gmma_desc(as + kk * 32, 16, 1024);
        const uint64_t db = B_MN ? gmma_desc(bs + kk * 2048, G_HALF, 1024)
                                 : gmma_desc(bs + kk * 32, 16, 1024);
        wgmma_m64n128k16<A_MN ? 1 : 0, B_MN ? 1 : 0>(acc, da, db);
      }
      wgmma_commit();
      if (sums) {
        // 16-byte chunk x % 16 of B's MN-major stage: box (x % 16) / 8,
        // chunk (x % 8) of row r, swizzled to (x % 8) ^ (r % 8)
        const int cx = threadIdx.x % 16;
        const unsigned char* box = bs + (cx / 8) * G_HALF;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int r = 4 * (threadIdx.x / 16) + j;
          float f[8];
          unpack16(*reinterpret_cast<const uint4*>(box + r * 128 + (((cx % 8) ^ (r % 8)) << 4)),
                   f, bf16());
#pragma unroll
          for (int e = 0; e < 8; ++e) csum[e] += f[e];
        }
      }
      // the previous stage's products are done: hand its buffers back
      wgmma_wait<1>();
      fence_acc(acc);
      if (i > 0 && lane == 0) mbar_arrive(&empty[(it - 1) % G_STAGES]);
    }
    wgmma_wait<0>();
    fence_acc(acc);
    if (tw.nk > 0 && lane == 0) mbar_arrive(&empty[(it - 1) % G_STAGES]);
    if (sums) {
      // the 16 row groups of each column, added in order (barrier 3: the
      // 256 consumer threads)
#pragma unroll
      for (int e = 0; e < 8; ++e)
        col_red[(threadIdx.x / 16) * GN + 8 * (threadIdx.x % 16) + e] = csum[e];
      asm volatile("bar.sync 3, %0;" ::"n"(G_CONSUMERS) : "memory");
      const int n = tw.n0 + threadIdx.x;
      if (threadIdx.x < GN && n < g.N) {
        float total = 0.f;
#pragma unroll
        for (int r = 0; r < 16; ++r) total += col_red[r * GN + threadIdx.x];
        g.colsum_ws[((size_t)tw.split * g.dirs + tw.dir) * g.N + n] = total;
      }
      asm volatile("bar.sync 3, %0;" ::"n"(G_CONSUMERS) : "memory");
    }

    // accumulator layout of m64nNk16: lane l of warp v of the warpgroup
    // holds, for each 8-column chunk j, rows 16 v + l / 4 (+ 8) and
    // columns 8 j + 2 (l % 4) (+ 1)
    const int r0 = (t / 32) * 16 + lane / 4;  // row within the warpgroup's 64
    if constexpr (Shape::STAGED) {
      if (g.staged) {
        // bf16 results into this warpgroup's staging box, 64 columns a
        // pass, laid out as the output map's 64 x 64 box with the 128-byte
        // swizzle (16-byte chunk c of row r at chunk c ^ (r % 8): no bank
        // conflicts), then a TMA store. A pass first waits until the
        // previous store has read the box.
        unsigned char* buf = out_s + wg * G_HALF;
        const bf16* bias = g.bias + (size_t)tw.dir * g.N;
        const bool bias2 = (reinterpret_cast<uintptr_t>(bias) & 3) == 0;
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          if (tw.n0 + 64 * half >= g.N) break;
          if (t == 0) asm volatile("cp.async.bulk.wait_group.read 0;" ::: "memory");
          wg_sync(wg);
#pragma unroll
          for (int jj = 0; jj < 8; ++jj) {
            const int j = 8 * half + jj;
            // N is a multiple of 8 here: n < N holds for both columns or neither
            const int n = tw.n0 + 8 * j + 2 * q;
            float b0 = 0.f, b1 = 0.f;
            if (EPI == EPI_BIAS && n < g.N) {
              if (bias2) {
                const __nv_bfloat162 bb = *reinterpret_cast<const __nv_bfloat162*>(bias + n);
                b0 = __low2float(bb);
                b1 = __high2float(bb);
              } else {
                b0 = to_f(bias[n]);
                b1 = to_f(bias[n + 1]);
              }
            }
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              const int r = r0 + 8 * h;
              float v0 = acc[4 * j + 2 * h], v1 = acc[4 * j + 2 * h + 1];
              if constexpr (EPI == EPI_BIAS) {
                // cast, then add the bias in the compute type (bias_epilogue)
                v0 = to_f(from_f<bf16>(v0)) + b0;
                v1 = to_f(from_f<bf16>(v1)) + b1;
              }
              const __nv_bfloat162 pair = __floats2bfloat162_rn(v0, v1);
              const uint32_t off = r * 128 + ((jj ^ (r % 8)) << 4) + q * 4;
              asm volatile("st.shared.b32 [%0], %1;" ::"r"(smem_u32(buf + off)),
                           "r"(*reinterpret_cast<const uint32_t*>(&pair))
                           : "memory");
            }
          }
          // the generic-proxy writes, visible to the TMA (async proxy)
          asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
          wg_sync(wg);
          if (t == 0) {
            tma_store(&g.o[tw.dir], buf, tw.n0 + 64 * half, tw.m0 + 64 * wg);
            asm volatile("cp.async.bulk.commit_group;" ::: "memory");
          }
        }
        continue;
      }
    }
    // kind 0 always leaves by TMA (launch_gemm_wgmma checks N)
    if constexpr (EPI != EPI_BIAS) {
      // register epilogue: each group of 4 chunks is transposed within the
      // quad of lanes (4 rounds of shuffles), so lane q stores the 8 columns
      // of chunk 4 G + q of its two rows: 16- or 32-byte stores, a quad
      // covering 64 (bf16) or 128 (f32) contiguous bytes of a row
#pragma unroll
      for (int G = 0; G < GN / 32; ++G) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          float v[8];
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            const int c = (q - r) & 3;  // the chunk this lane sends in round r
            const int p = (q + r) & 3;  // the lane it receives from
            float s0 = acc[16 * G + 2 * h], s1 = acc[16 * G + 2 * h + 1];
#pragma unroll
            for (int k = 1; k < 4; ++k) {
              if (c == k) {
                s0 = acc[16 * G + 4 * k + 2 * h];
                s1 = acc[16 * G + 4 * k + 2 * h + 1];
              }
            }
            const float x0 = __shfl_sync(0xffffffffu, s0, (lane & ~3) | p);
            const float x1 = __shfl_sync(0xffffffffu, s1, (lane & ~3) | p);
#pragma unroll
            for (int k = 0; k < 4; ++k) {
              if (p == k) {
                v[2 * k] = x0;
                v[2 * k + 1] = x1;
              }
            }
          }
          const int m = tw.m0 + wg * 64 + r0 + 8 * h, n = tw.n0 + 8 * (4 * G + q);
          if (m < g.M && n < g.N) wgmma_store<EPI>(g, tw.dir, tw.split, m, n, v);
        }
      }
    }
  }
  // the last stores have left shared memory and landed
  if constexpr (Shape::STAGED) {
    if (g.staged && t == 0) asm volatile("cp.async.bulk.wait_group 0;" ::: "memory");
  }
}

// out[i] = ws[0][i] + ws[1][i] + ... + ws[S-1][i], in that order
__global__ void __launch_bounds__(256) gemm_splitk_sum(const float* __restrict__ ws,
                                                       float* __restrict__ out, size_t count,
                                                       int splits) {
  const size_t stride = (size_t)gridDim.x * blockDim.x;
  for (size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x; i < count; i += stride) {
    float s = ws[i];
    for (int k = 1; k < splits; ++k) s += ws[(size_t)k * count + i];
    out[i] = s;
  }
}

// db: colsum[i] = ws[0][i] + ... + ws[S-1][i] over the slices' column sums
// [S, dirs, N] (gemm_wgmma_bf16's), in that order
__global__ void __launch_bounds__(256) colsum_finish(const float* __restrict__ ws, int splits,
                                                     int count, float* __restrict__ colsum) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= count) return;
  float s = ws[i];
  for (int k = 1; k < splits; ++k) s += ws[(size_t)k * count + i];
  colsum[i] = s;
}

// --- the f32 GEMM: register-blocked FFMA tiles, cp.async ring ----------------

// 64 x 128 output tiles of 128 threads (4 warps of 64 x 32 outputs along
// N), FK-deep K tiles through an F_STAGES-deep ring. A stage holds each
// operand's K tile as [FK][rows + 4] floats, K rows of contiguous M (or N)
// elements; the 4-float pad spreads the transposing 4-byte copies over all
// 32 banks. Two blocks an SM: up to 255 registers a thread, so the 64
// accumulators, the next k's operands and the copies' addresses never
// spill (capped at 128 they did).
constexpr int FM = 64, FN = 128, FK = 16, F_STAGES = 4;
constexpr int F_THREADS = 128, F_BLOCKS = 2;
constexpr int F_A_LD = FM + 4, F_B_LD = FN + 4;
constexpr int F_STAGE = FK * (F_A_LD + F_B_LD);
constexpr int F_SMEM = (F_STAGES * F_STAGE + F_THREADS) * 4;  // the ring, then db's parts
static_assert(FK % 8 == 0, "the transposing copies take K in groups of 8");

struct FfmaArgs {
  const float* a[2];
  const float* b[2];
  int lda, ldb;
  int M, N, K, dirs, splits;
  int a_vec, b_vec;   // the MN-major operand is read in 16-byte copies
  int vec_out;        // N a multiple of 4 and 16-byte-aligned outputs (and addend)
  const float* bias;  // [dirs, N] (EPI_BIAS) or the addend [dirs, M, N] (EPI_ADD_F32)
  float* out;         // [splits, dirs, M, N] (splits > 1 only for EPI_F32)
  float* colsum_ws;   // EPI_F32: [splits, dirs, N] column sums of B over each slice, or null
};

__device__ __forceinline__ void cp_async16(float* dst, const float* src, int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(smem_u32(dst)), "l"(src),
               "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async4(float* dst, const float* src, int bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;" ::"r"(smem_u32(dst)), "l"(src),
               "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N) : "memory");
}

// Issue the copies of one operand's K tile into stage s ([FK][ROWS + 4]
// floats), by THREADS threads: s[r][i] = X(k0 + r, c0 + i), zero outside
// [K) x [C) (the copies' source size 0 or short). MN: X(k, c) = p[k ld +
// c], 16-byte copies of 4 contiguous elements when vec (a 16-byte-aligned
// base, ld a multiple of 4), else 4-byte copies. K-major: X(k, c) = p[c ld
// + k], 4-byte copies transposed on the way in: a warp takes 8 consecutive
// k (one 32-byte sector) of 4 consecutive rows, landing on banks (4 k + c)
// mod 32, all distinct (ROWS + 4 = 4 mod 32).
template <int ROWS, int THREADS, bool MN>
__device__ __forceinline__ void ffma_stage(float* s, const float* p, int ld, int k0, int c0,
                                           int K, int C, bool vec) {
  constexpr int LD = ROWS + 4;
  if constexpr (MN) {
    if (vec) {
#pragma unroll
      for (int u = 0; u < FK * ROWS / 4 / THREADS; ++u) {
        const int i = threadIdx.x + u * THREADS;
        const int r = i / (ROWS / 4), c = (i % (ROWS / 4)) * 4;
        const int k = k0 + r, col = c0 + c;
        const int bytes = k < K ? 4 * max(0, min(4, C - col)) : 0;
        cp_async16(s + r * LD + c, bytes ? p + (size_t)k * ld + col : p, bytes);
      }
      return;
    }
#pragma unroll
    for (int u = 0; u < FK * ROWS / THREADS; ++u) {
      const int i = threadIdx.x + u * THREADS;
      const int r = i / ROWS, c = i % ROWS;
      const bool in = k0 + r < K && c0 + c < C;
      cp_async4(s + r * LD + c, in ? p + (size_t)(k0 + r) * ld + c0 + c : p, in ? 4 : 0);
    }
  } else {
    constexpr int KO = FK / 8;  // groups of 8 k
#pragma unroll
    for (int u = 0; u < FK * ROWS / THREADS; ++u) {
      const int i = threadIdx.x + u * THREADS;
      const int r = (i & 7) + ((i >> 5) % KO) * 8;
      const int c = ((i >> 5) / KO) * 4 + ((i >> 3) & 3);
      const bool in = k0 + r < K && c0 + c < C;
      cp_async4(s + r * LD + c, in ? p + (size_t)(c0 + c) * ld + k0 + r : p, in ? 4 : 0);
    }
  }
}

// One 64 x 128 output tile (x direction x K slice) a block. Thread (warp
// w, lane l) holds the 8 x 8 outputs of rows 4 (l / 4) + {0..3, 32..35} and
// columns 32 w + 4 (l % 4) + {0..3, 16..19}: each k reads
// two float4 of A and two of B (a quarter warp reads 2 and 4 adjacent
// float4: no bank conflict) for 64 FFMA. The K tiles stream through an
// F_STAGES-deep cp.async ring, F_STAGES - 1 tiles in flight while one is
// multiplied, one __syncthreads a tile. Each output's sum runs over its K
// range in order, one FFMA a k, whatever M or the tile.
template <bool A_MN, bool B_MN, int EPI>
__global__ void __launch_bounds__(F_THREADS, F_BLOCKS)
    gemm_ffma_f32(const __grid_constant__ FfmaArgs g) {
  constexpr int NT = F_THREADS;
  extern __shared__ __align__(16) float f_smem[];
  float* red = f_smem + F_STAGES * F_STAGE;  // [NT / FN][FN]
  const int n0 = blockIdx.x * FN, m0 = blockIdx.y * FM;
  const int dir = blockIdx.z % g.dirs, split = blockIdx.z / g.dirs;
  const float* a = g.a[dir];
  const float* b = g.b[dir];
  // this slice's K tiles: the split of ops/blstm.split_bounds
  const int ktiles = (g.K + FK - 1) / FK;
  const int kt0 = (int)((long long)split * ktiles / g.splits);
  const int nk = (int)((long long)(split + 1) * ktiles / g.splits) - kt0;

  auto stage = [&](int slot, int kt) {
    float* st = f_smem + slot * F_STAGE;
    ffma_stage<FM, NT, A_MN>(st, a, g.lda, kt * FK, m0, g.K, g.M, g.a_vec);
    ffma_stage<FN, NT, B_MN>(st + FK * F_A_LD, b, g.ldb, kt * FK, n0, g.K, g.N, g.b_vec);
  };
#pragma unroll
  for (int s = 0; s < F_STAGES - 1; ++s) {
    if (s < nk) stage(s, kt0 + s);
    cp_async_commit();
  }

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int am = (lane / 4) * 4;
  const int bn = warp * 32 + (lane % 4) * 4;
  // kind 2's db: the blocks of the first row tile also sum B's columns
  // over their slice from the stages, thread x taking column x % 128 of
  // the x / 128-th run of FK FN / NT rows of each K tile, in order
  constexpr int CROWS = FK * FN / NT;
  const bool sums = EPI == EPI_F32 && g.colsum_ws != nullptr && blockIdx.y == 0;
  float csum = 0.f;
  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  for (int t = 0; t < nk; ++t) {
    // tile t has landed, and every thread is done with tile t - 1, whose
    // slot the next copies take
    cp_async_wait<F_STAGES - 2>();
    __syncthreads();
    if (t + F_STAGES - 1 < nk) stage((t + F_STAGES - 1) % F_STAGES, kt0 + t + F_STAGES - 1);
    cp_async_commit();
    const float* as = f_smem + (t % F_STAGES) * F_STAGE;
    const float* bs = as + FK * F_A_LD;
    if (sums) {
      const float* col = bs + (threadIdx.x / FN) * CROWS * F_B_LD + threadIdx.x % FN;
#pragma unroll
      for (int r = 0; r < CROWS; ++r) csum += col[r * F_B_LD];
    }
#pragma unroll
    for (int k = 0; k < FK; ++k) {
      const float4 a0 = *reinterpret_cast<const float4*>(as + k * F_A_LD + am);
      const float4 a1 = *reinterpret_cast<const float4*>(as + k * F_A_LD + am + 32);
      const float4 b0 = *reinterpret_cast<const float4*>(bs + k * F_B_LD + bn);
      const float4 b1 = *reinterpret_cast<const float4*>(bs + k * F_B_LD + bn + 16);
      const float av[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
  }
  cp_async_wait<0>();

  if (sums) {
    // the runs of rows of each column, added in order
    red[threadIdx.x] = csum;
    __syncthreads();
    const int n = n0 + threadIdx.x;
    if (threadIdx.x < FN && n < g.N) {
      float total = red[threadIdx.x];
#pragma unroll
      for (int q = 1; q < NT / FN; ++q) total += red[q * FN + threadIdx.x];
      g.colsum_ws[((size_t)split * g.dirs + dir) * g.N + n] = total;
    }
  }

#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int m = m0 + am + (i < 4 ? i : 28 + i);
    if (m >= g.M) continue;
    const size_t row = (((size_t)split * g.dirs + dir) * g.M + m) * g.N;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int n = n0 + bn + 16 * h;
      if (n >= g.N) continue;
      float v[4] = {acc[i][4 * h], acc[i][4 * h + 1], acc[i][4 * h + 2], acc[i][4 * h + 3]};
      const int cnt = min(4, g.N - n);
      if constexpr (EPI == EPI_BIAS) {
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (e < cnt) v[e] += g.bias[(size_t)dir * g.N + n + e];
      } else if constexpr (EPI == EPI_ADD_F32) {
        if (g.vec_out && cnt == 4) {
          const float4 x = *reinterpret_cast<const float4*>(g.bias + row + n);
          v[0] = x.x + v[0];
          v[1] = x.y + v[1];
          v[2] = x.z + v[2];
          v[3] = x.w + v[3];
        } else {
#pragma unroll
          for (int e = 0; e < 4; ++e)
            if (e < cnt) v[e] = g.bias[row + n + e] + v[e];
        }
      }
      if (g.vec_out && cnt == 4) {
        *reinterpret_cast<float4*>(g.out + row + n) = make_float4(v[0], v[1], v[2], v[3]);
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (e < cnt) g.out[row + n + e] = v[e];
      }
    }
  }
}

// cuTensorMapEncodeTiled, looked up through the runtime (no -lcuda)
typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                  const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                  CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// error codes of the wgmma entry beyond cudaError_t: no entry point found,
// and TENSOR_MAP_ERR + the CUresult of a refused encoding
constexpr int NO_ENCODER_ERR = 999;
constexpr int TENSOR_MAP_ERR = 1000;

EncodeTiledFn encode_tiled() {
  static EncodeTiledFn fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                       cudaEnableDefault, &q);
#else
    cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    if (err == cudaSuccess && q == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiledFn>(p);
  }
  return fn;
}

// a bf16 matrix of `rows` rows of `cols` contiguous elements, row stride ld,
// read in boxes of box_cols x box_rows with the 128-byte swizzle; outside
// the matrix TMA fills zeros
int encode_map(CUtensorMap* map, const void* base, int cols, int rows, int ld, int box_cols,
               int box_rows) {
  EncodeTiledFn fn = encode_tiled();
  if (fn == nullptr) return NO_ENCODER_ERR;
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)ld * sizeof(bf16)};
  const cuuint32_t box[2] = {(cuuint32_t)box_cols, (cuuint32_t)box_rows};
  const cuuint32_t elem[2] = {1, 1};
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(base), dims,
                        strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : TENSOR_MAP_ERR + (int)r;
}

// the resident blocks of one kernel on the current device (after its
// shared-memory attributes are set), found once per kernel and device
template <bool A_MN, bool B_MN, int EPI>
int wgmma_resident(int* blocks) {
  auto kernel = gemm_wgmma_bf16<A_MN, B_MN, EPI>;
  static int cached_device = -1, cached_blocks = 0;
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return (int)err;
  if (device != cached_device) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               WgmmaShape<EPI>::SMEM);
    if (err != cudaSuccess) return (int)err;
    // all of the SM's shared memory for the carve-out, so the blocks fit
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
    if (err != cudaSuccess) return (int)err;
    int sms = 0, per_sm = 0;
    if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device)) !=
        cudaSuccess)
      return (int)err;
    if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, G_THREADS,
                                                             WgmmaShape<EPI>::SMEM)) !=
        cudaSuccess)
      return (int)err;
    if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
    cached_blocks = per_sm * sms;
    cached_device = device;
  }
  *blocks = cached_blocks;
  return 0;
}

template <bool A_MN, bool B_MN, int EPI>
int launch_wgmma(const WgmmaArgs& g, cudaStream_t stream) {
  auto kernel = gemm_wgmma_bf16<A_MN, B_MN, EPI>;
  int resident = 0;
  const int err = wgmma_resident<A_MN, B_MN, EPI>(&resident);
  if (err) return err;
  // persistent: the resident blocks, or fewer when there is less work
  const long long work = (long long)((g.N + GN - 1) / GN) * ((g.M + GM - 1) / GM) * g.dirs *
                         g.splits;
  const int grid = (int)std::min<long long>(work, resident);
  kernel<<<grid, G_THREADS, WgmmaShape<EPI>::SMEM, stream>>>(g);
  return (int)cudaGetLastError();
}

// kind 2's second pass: the K slices' sums [splits, dirs, M, N] into outf
// and (colsum_ws not null) their column sums [splits, dirs, N] into
// colsum, each added in the order 0 .. splits - 1
int finish_kind2(int dirs, int M, int N, int splits, const float* splitk_ws, float* outf,
                 const float* colsum_ws, float* colsum, cudaStream_t stream) {
  int err = 0;
  if (splits > 1) {
    const size_t count = (size_t)dirs * M * N;
    const int blocks = (int)std::min<size_t>((count + 255) / 256, 132 * 8);
    gemm_splitk_sum<<<blocks, 256, 0, stream>>>(splitk_ws, outf, count, splits);
    if ((err = (int)cudaGetLastError())) return err;
  }
  if (colsum_ws != nullptr) {
    colsum_finish<<<(dirs * N + 255) / 256, 256, 0, stream>>>(colsum_ws, splits, dirs * N,
                                                              colsum);
    if ((err = (int)cudaGetLastError())) return err;
  }
  return 0;
}

// kind as nabu_blstm_gemm_bf16's; A and B must be 16-byte aligned with
// lda, ldb multiples of 8 (the wrapper's predicate), K >= 1. splits > 1
// (kind 2 only) writes the slices to splitk_ws [splits, dirs, M, N] first;
// colsum (kind 2) takes colsum_ws [splits, dirs, N]
int launch_gemm_wgmma(const void* const* a, const void* const* b, int lda, int ldb, int M, int N,
                      int K, int kind, int dirs, int splits, const void* bias, void* out,
                      float* outf, float* colsum, float* colsum_ws, float* splitk_ws,
                      cudaStream_t stream) {
  if (M <= 0 || N <= 0) return 0;
  if ((dirs != 1 && dirs != 2) || K <= 0 || splits < 1 || (splits > 1 && kind != 2) ||
      kind < 0 || kind > 3 || (kind == 0 && N % 8 != 0))
    return (int)cudaErrorInvalidValue;
  WgmmaArgs g;
  const bool a_mn = kind == 2, b_mn = kind != 1;
  for (int d = 0; d < dirs; ++d) {
    int err = a_mn ? encode_map(&g.a[d], a[d], M, K, lda, 64, 64)
                   : encode_map(&g.a[d], a[d], K, M, lda, 64, GM);
    if (err) return err;
    err = b_mn ? encode_map(&g.b[d], b[d], N, K, ldb, 64, 64)
               : encode_map(&g.b[d], b[d], K, N, ldb, 64, GN);
    if (err) return err;
  }
  // kinds 0 and 1 store through TMA when the output rows are 16-byte
  // multiples: [M, N] bf16 per direction
  g.staged = kind <= 1 && N % 8 == 0;
  for (int d = 0; g.staged && d < dirs; ++d) {
    const int err = encode_map(&g.o[d], (const bf16*)out + (size_t)d * M * N, N, M, N, 64, 64);
    if (err) return err;
  }
  if (dirs == 1) {
    g.a[1] = g.a[0];
    g.b[1] = g.b[0];
    g.o[1] = g.o[0];
  }
  g.M = M;
  g.N = N;
  g.K = K;
  g.dirs = dirs;
  g.splits = splits;
  g.bias = (const bf16*)bias;
  g.out = (bf16*)out;
  g.outf = splits > 1 ? splitk_ws : outf;
  g.colsum_ws = kind == 2 && colsum != nullptr ? colsum_ws : nullptr;
  int err = 0;
  switch (kind) {
    case 0: err = launch_wgmma<false, true, EPI_BIAS>(g, stream); break;
    case 1: err = launch_wgmma<false, false, EPI_CAST>(g, stream); break;
    case 2: err = launch_wgmma<true, true, EPI_F32>(g, stream); break;
    case 3: err = launch_wgmma<false, true, EPI_ADD_F32>(g, stream); break;
  }
  if (err) return err;
  return finish_kind2(dirs, M, N, splits, splitk_ws, outf, g.colsum_ws, colsum, stream);
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

// the layouts the layers use: proj (row, row, bias), dx (row, col,
// cast), dwx / dwh (col, row, f32), the v1 gates recompute (row, row, f32
// plus addend)
int launch_gemm_wmma(const GemmArgs<bf16>& g, int kind, cudaStream_t stream) {
  if (g.M <= 0 || g.N <= 0) return 0;
  if (g.dirs != 1 && g.dirs != 2) return (int)cudaErrorInvalidValue;
  switch (kind) {
    case 0: return launch_gemm_bf16<false, false, EPI_BIAS>(g, stream);
    case 1: return launch_gemm_bf16<false, true, EPI_CAST>(g, stream);
    case 2: return launch_gemm_bf16<true, false, EPI_F32>(g, stream);
    case 3: return launch_gemm_bf16<false, false, EPI_ADD_F32>(g, stream);
  }
  return (int)cudaErrorInvalidValue;
}

template <bool A_MN, bool B_MN, int EPI>
int launch_ffma(const FfmaArgs& g, cudaStream_t stream) {
  auto kernel = gemm_ffma_f32<A_MN, B_MN, EPI>;
  // the ring is dynamic shared memory beyond 48 KB, and the resident
  // blocks need the whole carve-out: set once per kernel and device
  static int configured_device = -1;
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return (int)err;
  if (device != configured_device) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, F_SMEM);
    if (err != cudaSuccess) return (int)err;
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
    if (err != cudaSuccess) return (int)err;
    configured_device = device;
  }
  const dim3 grid((g.N + FN - 1) / FN, (g.M + FM - 1) / FM, g.dirs * g.splits);
  kernel<<<grid, F_THREADS, F_SMEM, stream>>>(g);
  return (int)cudaGetLastError();
}

// the f32 GEMM (gemm_ffma_f32), every layout; kinds as nabu_blstm_gemm_bf16's,
// splits K slices for kind 2 (splitk_ws [splits, dirs, M, N]), colsum_ws
// [splits, dirs, N] for the column sums
int launch_gemm_ffma(const void* const* a, const void* const* b, int lda, int ldb, int M, int N,
                     int K, int kind, int dirs, int splits, const void* bias, void* out,
                     float* outf, float* colsum, float* colsum_ws, float* splitk_ws,
                     cudaStream_t stream) {
  if (M <= 0 || N <= 0) return 0;
  if ((dirs != 1 && dirs != 2) || K < 0 || splits < 1 || (splits > 1 && kind != 2) ||
      kind < 0 || kind > 3)
    return (int)cudaErrorInvalidValue;
  FfmaArgs g;
  for (int d = 0; d < 2; ++d) {
    g.a[d] = (const float*)a[std::min(d, dirs - 1)];
    g.b[d] = (const float*)b[std::min(d, dirs - 1)];
  }
  g.lda = lda;
  g.ldb = ldb;
  g.M = M;
  g.N = N;
  g.K = K;
  g.dirs = dirs;
  g.splits = splits;
  // A is MN-major for kind 2 only, B for every kind but 1
  g.a_vec = kind == 2 && lda % 4 == 0 && aligned16(g.a[0]) && aligned16(g.a[1]);
  g.b_vec = kind != 1 && ldb % 4 == 0 && aligned16(g.b[0]) && aligned16(g.b[1]);
  g.bias = (const float*)bias;
  g.out = kind <= 1 ? (float*)out : splits > 1 ? splitk_ws : outf;
  g.vec_out = N % 4 == 0 && aligned16(g.out) && (kind != 3 || aligned16(bias));
  g.colsum_ws = kind == 2 && colsum != nullptr ? colsum_ws : nullptr;
  int err = 0;
  switch (kind) {
    case 0: err = launch_ffma<false, true, EPI_BIAS>(g, stream); break;
    case 1: err = launch_ffma<false, false, EPI_CAST>(g, stream); break;
    case 2: err = launch_ffma<true, true, EPI_F32>(g, stream); break;
    case 3: err = launch_ffma<false, true, EPI_ADD_F32>(g, stream); break;
  }
  if (err || kind != 2) return err;
  return finish_kind2(dirs, M, N, splits, splitk_ws, outf, g.colsum_ws, colsum, stream);
}

// ---------------------------------------------------------------------------
// the serial kernels, (b) and (c): blocks of 256 threads owning 16 MT rows
// of one direction, launched cooperatively
// ---------------------------------------------------------------------------

constexpr int R_THREADS = 256;
constexpr int CH_ROWS = 16;  // rows of an m-tile; a block owns 16 MT rows

// four consecutive values of an exchanged row as loaded: 8 bytes of bf16,
// 16 of f32; widened to f32 where they are used
template <typename T>
using quad_t = std::conditional_t<sizeof(T) == 2, uint2, float4>;

__device__ __forceinline__ float4 widen(const float4& q) { return q; }
__device__ __forceinline__ float4 widen(const uint2& q) {
  return make_float4(__uint_as_float(q.x << 16), __uint_as_float(q.x & 0xffff0000u),
                     __uint_as_float(q.y << 16), __uint_as_float(q.y & 0xffff0000u));
}

// ---------------------------------------------------------------------------
// (b) persistent recurrence (forward)
// ---------------------------------------------------------------------------

constexpr int W_KS = 16;  // f32: K slices of a walk step's product, the lanes of a half warp
constexpr int W_NQ = 5;   // f32: quads of h a K slice loads a pass (80: H = 320 in one)
constexpr int W_WARPS = R_THREADS / 32;

// the exchange's row stride: H rounded up to whole 16-byte vectors of bf16
__host__ __device__ inline int walk_xp(int H) { return (H + 7) / 8 * 8; }
// bf16: K chunks of 32 (two mma k16 steps), and the warps' partial sums'
// row stride (float2 stores of a fragment free of bank conflicts)
__host__ __device__ inline int walk_chunks(int H) { return (H + 31) / 32; }
__host__ __device__ constexpr int walk_pst(int U) { return 4 * U + 8; }

// shared memory of a walk block of U units and 16 MT rows. f32: the four
// gate columns of wh of its units, [4 U][ceil4(H)]; bf16: the same columns
// as B fragments, [chunk][n-tile][lane] of 16 bytes, then the warps'
// partial sums [8][16 MT][4 U + 8] f32
template <typename T>
__host__ __device__ inline size_t walk_bytes(int H, int U, int MT) {
  if (sizeof(T) == 4) return sizeof(float) * 4 * (size_t)U * ((H + 3) / 4 * 4);
  return (size_t)walk_chunks(H) * (U / 2) * 32 * sizeof(uint4) +
         sizeof(float) * W_WARPS * CH_ROWS * MT * walk_pst(U);
}

// bf16: wh's gate columns of the block's units j0 + [0, U) in the order the
// B fragments read them: uint4 (c, nt, lane) holds column n = 8 nt + lane /
// 4 (unit n / 4, gate n % 4) at k = 32 c + 8 (lane % 4) + [0, 8), zero past
// H. The A fragments take the same 8 k of their rows (the k order inside a
// chunk is a permutation both operands share), so one 16-byte load of h
// serves two k16 steps of one row.
template <int U>
__device__ void stage_walk_wh(const bf16* whd, int j0, int H, unsigned char* smem) {
  constexpr int NT = U / 2;
  unsigned short* w = reinterpret_cast<unsigned short*>(smem);
  const unsigned short* src = reinterpret_cast<const unsigned short*>(whd);
  const int H4 = 4 * H, n_all = walk_chunks(H) * NT * 32 * 8;
  for (int e = threadIdx.x; e < n_all; e += R_THREADS) {
    const int q = e & 7, lane = (e >> 3) & 31, nt = (e >> 8) % NT, c = (e >> 8) / NT;
    const int n = 8 * nt + (lane >> 2), k = 32 * c + 8 * (lane & 3) + q;
    const int u = n >> 2, g = n & 3;
    w[e] = (k < H && j0 + u < H) ? src[(size_t)k * H4 + g * H + j0 + u] : (unsigned short)0;
  }
}

// f32: w_s[(4 u + g) HP + k] = wh[k, g H + j0 + u], HP = ceil4(H), read
// with u fastest
template <int U>
__device__ void stage_walk_wh(const float* whd, int j0, int H, unsigned char* smem) {
  float* w_s = reinterpret_cast<float*>(smem);
  const int HP = (H + 3) / 4 * 4, H4 = 4 * H;
  for (int i = threadIdx.x; i < 4 * U * HP; i += R_THREADS) {
    const int k = i / (4 * U), g = i / U % 4, u = i % U;
    w_s[(4 * u + g) * HP + k] = (k < H && j0 + u < H) ? whd[(size_t)k * H4 + g * H + j0 + u]
                                                      : 0.f;
  }
}

// bf16 step product on tensor cores: z[g] = the h-part of gate g of this
// thread's cell pair (local row pr, unit pu). The warps split K: warp w
// takes chunks [w cpw, (w + 1) cpw) of 32 k, issues every 16-byte load of
// its A fragments (its chunks of the block's 16 MT rows of h_{t-1}) at once
// (ld.cg, straight into registers), runs mma.sync m16n8k16 over them in
// chunk order into f32 accumulators (16 MT rows x 4 U columns) and stores
// its partial sums; after a block barrier the thread adds its 4 gates'
// partials in warp order.
template <int U, int MT, bool PROBE>
__device__ __forceinline__ void walk_product(const bf16* hin, int xp, int row0, int B, int H,
                                             unsigned char* smem, int pr, int pu, float* z,
                                             unsigned long long* spent,
                                             unsigned long long& stamp) {
  constexpr int NT = U / 2, PST = walk_pst(U), MAXC = 8 / MT;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t4 = lane & 3;
  const int nch = walk_chunks(H), cpw = (nch + W_WARPS - 1) / W_WARPS, c0 = warp * cpw;
  uint4 a[MAXC][MT][2];
#pragma unroll
  for (int i = 0; i < MAXC; ++i)
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = row0 + CH_ROWS * mt + 8 * h + g, col = 32 * (c0 + i) + 8 * t4;
        a[i][mt][h] = (i < cpw && c0 + i < nch && r < B && col < xp)
                          ? __ldcg(reinterpret_cast<const uint4*>(hin + (size_t)r * xp + col))
                          : make_uint4(0u, 0u, 0u, 0u);
      }
  if constexpr (PROBE) {
    // the pull ends where its values are first used
    unsigned int bits = 0u;
#pragma unroll
    for (int i = 0; i < MAXC; ++i)
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int h = 0; h < 2; ++h) bits ^= a[i][mt][h].x ^ a[i][mt][h].y ^ a[i][mt][h].z ^
                                            a[i][mt][h].w;
    if (bits == 0x9e3779b9u) spent[0] += 1;  // a use the compiler cannot drop
    __syncthreads();
    probe_stamp<PROBE>(spent, 1, stamp);
  }
  float acc[MT][NT][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[mt][nt][q] = 0.f;
  const uint4* wb = reinterpret_cast<const uint4*>(smem);
#pragma unroll
  for (int i = 0; i < MAXC; ++i) {
    if (i < cpw && c0 + i < nch) {
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const uint4 b = wb[((c0 + i) * NT + nt) * 32 + lane];
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          const uint4 lo = a[i][mt][0], hi = a[i][mt][1];  // rows g, g + 8
          mma_16816(acc[mt][nt], lo.x, hi.x, lo.y, hi.y, b.x, b.y);
          mma_16816(acc[mt][nt], lo.z, hi.z, lo.w, hi.w, b.z, b.w);
        }
      }
    }
  }
  float* part = reinterpret_cast<float*>(smem + (size_t)nch * NT * 32 * sizeof(uint4));
  if (c0 < nch) {
    float* pw = part + (size_t)warp * CH_ROWS * MT * PST;
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        float* p = pw + (size_t)(CH_ROWS * mt + g) * PST + 8 * nt + 2 * t4;
        *reinterpret_cast<float2*>(p) = make_float2(acc[mt][nt][0], acc[mt][nt][1]);
        *reinterpret_cast<float2*>(p + 8 * PST) = make_float2(acc[mt][nt][2], acc[mt][nt][3]);
      }
  }
  __syncthreads();
  const int warps = (nch + cpw - 1) / cpw;  // the warps that hold a chunk
  float4 sum = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int w = 0; w < warps; ++w) {
    const float4 p =
        *reinterpret_cast<const float4*>(part + ((size_t)w * CH_ROWS * MT + pr) * PST + 4 * pu);
    sum.x += p.x;
    sum.y += p.y;
    sum.z += p.z;
    sum.w += p.w;
  }
  z[0] = sum.x;
  z[1] = sum.y;
  z[2] = sum.z;
  z[3] = sum.w;
  if constexpr (PROBE) {
    __syncthreads();
    probe_stamp<PROBE>(spent, 2, stamp);
  }
}

// f32 step product on the FMA pipes (the tight check: no TF32): the half
// warp of tile x = 2 warp + lane / 16 takes rows 4 (x % 4 MT) + [0, 4) and
// units 4 (x / 4 MT) + [0, 4) with their 4 gates (16 columns of wh); lane
// ks = lane % 16 takes the quads ks + 16 p of h_{t-1} (ld.cg straight into
// registers, every load of a pass in flight at once) and sums the tile's 4
// rows x 16 columns over them (a quad of h feeds 16 columns, a float4 of wh
// 4 rows); a reduce-scatter of shuffles over the half warp adds the 16 K
// slices in a fixed order and leaves lane ks the 4 gates of row 4 (x % 4
// MT) + ks / 4, unit 4 (x / 4 MT) + ks % 4, its cell pair.
template <int U, int MT, bool PROBE>
__device__ __forceinline__ void walk_product(const float* hin, int xp, int row0, int B, int H,
                                             unsigned char* smem, int, int, float* z,
                                             unsigned long long* spent,
                                             unsigned long long& stamp) {
  const int HQ = (H + 3) / 4;
  const int lane = threadIdx.x & 31, ks = lane & 15;
  const int x = (threadIdx.x >> 5) * 2 + (lane >> 4);
  const int rt = x % (4 * MT), ut = x / (4 * MT);
  // column 4 uu + g of the tile (unit 4 ut + uu, gate g) at w4[(4 uu + g) HQ + q]
  const float4* w4 = reinterpret_cast<const float4*>(smem) + (size_t)16 * ut * HQ;
  float v[64];  // [16 i + 4 uu + g]: row 4 rt + i, unit 4 ut + uu, gate g
#pragma unroll
  for (int k = 0; k < 64; ++k) v[k] = 0.f;
  for (int q0 = 0; q0 < HQ; q0 += W_KS * W_NQ) {
    float4 hq[4][W_NQ];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = row0 + 4 * rt + i;
      const float4* row = reinterpret_cast<const float4*>(hin + (size_t)r * xp);
#pragma unroll
      for (int p = 0; p < W_NQ; ++p) {
        const int q = q0 + ks + W_KS * p;
        hq[i][p] = (r < B && q < HQ) ? __ldcg(row + q) : make_float4(0.f, 0.f, 0.f, 0.f);
      }
    }
    if constexpr (PROBE) {
      if (q0 == 0) {
        unsigned int bits = 0u;
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int p = 0; p < W_NQ; ++p)
            bits ^= __float_as_uint(hq[i][p].x) ^ __float_as_uint(hq[i][p].y) ^
                    __float_as_uint(hq[i][p].z) ^ __float_as_uint(hq[i][p].w);
        if (bits == 0x9e3779b9u) spent[0] += 1;  // a use the compiler cannot drop
        __syncthreads();
        probe_stamp<PROBE>(spent, 1, stamp);
      }
    }
#pragma unroll
    for (int p = 0; p < W_NQ; ++p) {
      const int q = q0 + ks + W_KS * p;
      if (q < HQ) {
#pragma unroll
        for (int col = 0; col < 16; ++col) {
          const float4 w = w4[(size_t)col * HQ + q];
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            float& a = v[16 * i + col];
            a = fmaf(hq[i][p].x, w.x, a);
            a = fmaf(hq[i][p].y, w.y, a);
            a = fmaf(hq[i][p].z, w.z, a);
            a = fmaf(hq[i][p].w, w.w, a);
          }
        }
      }
    }
  }
  reduce_scatter<64, 8>(v, lane);
#pragma unroll
  for (int g = 0; g < 4; ++g) z[g] = v[g];
  if constexpr (PROBE) {
    __syncthreads();
    probe_stamp<PROBE>(spent, 2, stamp);
  }
}

// Block (dir, rg, ug) owns rows rg 16 MT + [0, 16 MT) and units ug U + [0,
// U) of direction dir (U MT = 16); rows are independent in the walk, so the
// blocks of one (direction, row group) meet at their own counter each step.
// Thread p runs the cell pair (row 4 (x % 4 MT) + ks / 4, unit 4 (x / 4 MT)
// + ks % 4), x = p / 16, ks = p % 16 (where the f32 product's reduce-scatter
// leaves its 4 gates), and keeps its c and h carries in registers. PROBE:
// thread 0 sums the clock64 cycles of each step after the first spent
// waiting, pulling (to the loads' first use), multiplying (to the gates'
// sums) and in the cell (to the next step's start) into probe[block][4],
// with a block barrier after the pull and after the product.
template <typename T, bool STORE, int U, int MT, bool PROBE>
__global__ void __launch_bounds__(R_THREADS, 1) blstm_recur_kernel(
    const T* __restrict__ xw,         // [2, T, B, 4H]
    const int* __restrict__ lengths,  // [B]
    const T* __restrict__ wh,         // [2, H, 4H]
    T* __restrict__ y,                // [T, B, 2H] masked outputs
    T* hx,                            // [2 dir][2 slot][B][walk_xp(H)] carried h, zero at launch
    unsigned int* counters,           // [2, RG], zero at launch
    float* __restrict__ c_out,        // STORE: [2, T, B, H] f32 carries
    float* __restrict__ g_out,        // STORE: [2, T, B, 4H] f32 pre-activation gates
    unsigned long long* probe,        // PROBE: [blocks][4] cycles
    int Tn, int B, int H, int RG, int GU, float forget_bias) {
  constexpr int R = CH_ROWS * MT;
  static_assert(R * U == R_THREADS && U % 4 == 0, "one cell pair a thread, units in fours");
  extern __shared__ __align__(16) float smem_f[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(smem_f);
  const int xp = walk_xp(H), H4 = 4 * H;
  const int dir = blockIdx.x / (RG * GU);
  const int rg = blockIdx.x / GU % RG, ug = blockIdx.x % GU;
  const int j0 = ug * U, row0 = rg * R;
  unsigned int* cnt = counters + dir * RG + rg;
  stage_walk_wh<U>(wh + (size_t)dir * H * H4, j0, H, smem);
  __syncthreads();

  // the cell pair of this thread
  const int ks = threadIdx.x & 15, x = threadIdx.x >> 4;
  const int pr = 4 * (x % (4 * MT)) + (ks >> 2), pu = 4 * (x / (4 * MT)) + (ks & 3);
  const int pb = row0 + pr, pj = j0 + pu;
  const bool live = pb < B && pj < H;
  const int len = live ? __ldg(lengths + pb) : 0;
  const T* xwd = xw + (size_t)dir * Tn * B * H4;
  T* hxd = hx + (size_t)dir * 2 * B * xp;
  float c = 0.f;
  T h = from_f<T>(0.f);
  float xg[4] = {0.f, 0.f, 0.f, 0.f};
  // the cell's input of step s: it does not depend on the walk, so it is
  // fetched before the barrier that precedes step s ends
  auto fetch = [&](int s) {
    if (!live) return;
    const int t = dir == 0 ? s : Tn - 1 - s;
    const T* xr = xwd + ((size_t)t * B + pb) * H4 + pj;
#pragma unroll
    for (int g = 0; g < 4; ++g) xg[g] = to_f(xr[(size_t)g * H]);
  };
  fetch(0);
  unsigned long long spent[4] = {0ull, 0ull, 0ull, 0ull};
  unsigned long long stamp = 0ull;

  for (int s = 0; s < Tn; ++s) {
    const int t = dir == 0 ? s : Tn - 1 - s;
    float zh[4] = {0.f, 0.f, 0.f, 0.f};  // the h-part of the cell pair's gates
    if (s > 0) {
      if constexpr (PROBE) {
        const unsigned long long now = clock64();
        if (s > 1) spent[3] += now - stamp;
        stamp = now;
      }
      // wait until every block of this (direction, row group) has
      // published step s - 1: an acquire load, then the block barrier
      if (threadIdx.x == 0) {
        const unsigned int target = (unsigned int)s * (unsigned int)GU;
        while (ld_acquire(cnt) < target) {
        }
      }
      __syncthreads();
      probe_stamp<PROBE>(spent, 0, stamp);
      walk_product<U, MT, PROBE>(hxd + (size_t)(s & 1) * B * xp, xp, row0, B, H, smem, pr, pu,
                                 zh, spent, stamp);
    }

    // the masked cell (_cell): gates and c in f32, h in the compute type
    const float z0 = xg[0] + zh[0], z1 = xg[1] + zh[1], z2 = xg[2] + zh[2], z3 = xg[3] + zh[3];
    T y_t = from_f<T>(0.f);
    if (live) {
      const float gi = sigmoid_f(z0);
      const float gf = sigmoid_f(z1 + forget_bias);
      const float gg = tanhf(z2);
      const float go = sigmoid_f(z3);
      const float c_new = gf * c + gi * gg;
      const T h_new = from_f<T>(go * tanhf(c_new));
      // masked carry: padding frames keep c and h; y is zero there
      if (t < len) {
        c = c_new;
        h = h_new;
        y_t = h_new;
      }
      if (s + 1 < Tn) hxd[((size_t)((s + 1) & 1) * B + pb) * xp + pj] = h;
    }
    if (s + 1 < Tn) {
      // publish this step's h to the (direction, row group): the block
      // barrier, then a release add, which waits for the exchange's stores
      // alone (the outputs' follow)
      __syncthreads();
      if (threadIdx.x == 0) red_release(cnt);
    }
    if (live) {
      y[((size_t)t * B + pb) * 2 * H + (size_t)dir * H + pj] = y_t;
      if constexpr (STORE) {
        const size_t row = ((size_t)dir * Tn + t) * B + pb;
        c_out[row * H + pj] = c;
        float* gr = g_out + row * H4 + pj;
        gr[0] = z0;
        gr[H] = z1;
        gr[2 * (size_t)H] = z2;
        gr[3 * (size_t)H] = z3;
      }
    }
    // the next step's input, fetched while the other blocks catch up
    if (s + 1 < Tn) fetch(s + 1);
  }
  if constexpr (PROBE) {
    if (threadIdx.x == 0) {
      if (Tn > 1) spent[3] += clock64() - stamp;
#pragma unroll
      for (int k = 0; k < 4; ++k) probe[(size_t)blockIdx.x * 4 + k] = spent[k];
    }
  }
}

template <typename T, bool STORE, bool PROBE, int U, int MT>
int launch_recur_form(const T* xw, const int* lengths, const T* wh, T* y, T* hx,
                      unsigned int* counters, float* c_out, float* g_out,
                      unsigned long long* probe, int Tn, int B, int H, float forget_bias,
                      void* stream) {
  // hx's rows are read in 16-byte loads
  if (reinterpret_cast<uintptr_t>(hx) % 16 != 0) return (int)cudaErrorMisalignedAddress;
  // bf16: a warp's K chunks are held in registers, at most 8 / MT
  if (sizeof(T) == 2 && (walk_chunks(H) + W_WARPS - 1) / W_WARPS > 8 / MT)
    return (int)cudaErrorInvalidValue;
  int RG = (B + CH_ROWS * MT - 1) / (CH_ROWS * MT);
  int GU = (H + U - 1) / U;
  const int blocks = 2 * RG * GU;
  const size_t smem = walk_bytes<T>(H, U, MT);
  auto kernel = blstm_recur_kernel<T, STORE, U, MT, PROBE>;
  cudaError_t err = check_coresident(kernel, blocks, R_THREADS, smem);
  if (err != cudaSuccess) return (int)err;
  void* args[] = {(void*)&xw, (void*)&lengths, (void*)&wh,     (void*)&y,  (void*)&hx,
                  (void*)&counters, (void*)&c_out, (void*)&g_out, (void*)&probe,
                  (void*)&Tn, (void*)&B, (void*)&H, (void*)&RG, (void*)&GU, (void*)&forget_bias};
  err = cudaLaunchCooperativeKernel((const void*)kernel, dim3(blocks), dim3(R_THREADS), args,
                                    smem, (cudaStream_t)stream);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// units U and m-tiles MT a block (ops/blstm.walk_plan: 16 x 1, 8 x 2 or
// 4 x 4); counters hold 2 ceil(B / 16 MT) zeros
template <typename T, bool STORE, bool PROBE>
int launch_recur_forms(const T* xw, const int* lengths, const T* wh, T* y, T* hx,
                       unsigned int* counters, float* c_out, float* g_out,
                       unsigned long long* probe, int Tn, int B, int H, int U, int MT,
                       float forget_bias, void* stream) {
  if (U == 16 && MT == 1)
    return launch_recur_form<T, STORE, PROBE, 16, 1>(xw, lengths, wh, y, hx, counters, c_out,
                                                     g_out, probe, Tn, B, H, forget_bias, stream);
  if (U == 8 && MT == 2)
    return launch_recur_form<T, STORE, PROBE, 8, 2>(xw, lengths, wh, y, hx, counters, c_out,
                                                    g_out, probe, Tn, B, H, forget_bias, stream);
  if (U == 4 && MT == 4)
    return launch_recur_form<T, STORE, PROBE, 4, 4>(xw, lengths, wh, y, hx, counters, c_out,
                                                    g_out, probe, Tn, B, H, forget_bias, stream);
  return (int)cudaErrorInvalidValue;
}

// c_out and g_out null: the inference walk; probe non-null: the training
// walk with its step probe
template <typename T>
int launch_recur(const T* xw, const int* lengths, const T* wh, T* y, T* hx,
                 unsigned int* counters, float* c_out, float* g_out, unsigned long long* probe,
                 int Tn, int B, int H, int U, int MT, float forget_bias, void* stream) {
  if (Tn <= 0 || B <= 0) return 0;
  if (H <= 0) return (int)cudaErrorInvalidValue;
  if (probe != nullptr) {
    if (c_out == nullptr || g_out == nullptr) return (int)cudaErrorInvalidValue;
    return launch_recur_forms<T, true, true>(xw, lengths, wh, y, hx, counters, c_out, g_out,
                                             probe, Tn, B, H, U, MT, forget_bias, stream);
  }
  if (c_out != nullptr)
    return launch_recur_forms<T, true, false>(xw, lengths, wh, y, hx, counters, c_out, g_out,
                                              nullptr, Tn, B, H, U, MT, forget_bias, stream);
  return launch_recur_forms<T, false, false>(xw, lengths, wh, y, hx, counters, nullptr,
                                             nullptr, nullptr, Tn, B, H, U, MT, forget_bias,
                                             stream);
}

// ---------------------------------------------------------------------------
// (c) backward chain
// ---------------------------------------------------------------------------

constexpr int CH_KS = 64;    // K slices of a step product: the threads of a row block
static_assert(CH_ROWS == 4 * R_THREADS / CH_KS, "a row block of 4 rows a warp pair");

// shared memory of a chain block of U units and 16 MT rows: the wh rows of
// its units in f32, [U][4H], and the warps' reduced partial sums [8][4 U MT]
__host__ __device__ inline size_t chain_bytes(int H, int U, int MT) {
  return sizeof(float) * ((size_t)U * 4 * H + (size_t)(R_THREADS / 32) * 4 * U * MT);
}

// Block (dir, rg, ug) owns rows rg 16 MT + [0, 16 MT) and units ug U + [0,
// U) of direction dir; rows are independent in the chain, so the blocks of
// one (direction, row group) meet at their own counter each step. Step
// product: warp w takes rows 4 (w / 2) + [0, 4) of each m-tile and K slice
// ks = 32 (w % 2) + lane, the quads (4 values) ks + 64 p of the previous
// step's dgates rows (ld.cg straight into registers, 8 bytes in bf16, 16 in
// f32, every load of the pass in flight at once; bf16 is widened in
// registers), and sums its 4 MT rows x U units over them (a quad feeds U
// units, a float4 of wh 4 rows); the warp's 32 K slices are added by a
// reduce-scatter of shuffles, the two warps of a row block in warp order.
// Thread p < 16 MT U owns the cell pair (row, unit) = (p / U, p % U) and
// keeps its dh and dc carries in registers.
template <typename T, int U, int MT>
__global__ void __launch_bounds__(R_THREADS, 1) blstm_bwd_recur_kernel(
    const float* __restrict__ gates,  // [2, T, B, 4H] f32 pre-activations
    const float* __restrict__ cst,    // [2, T, B, H] f32 carries
    const T* __restrict__ gy,         // [T, B, 2H] cotangent of the layer output
    const int* __restrict__ lengths,  // [B]
    const T* __restrict__ wh,         // [2, H, 4H]
    T* dg,                            // [2, T, B, 4H] out; also the exchange
    unsigned int* counters,           // [2, RG], zero at launch
    int Tn, int B, int H, int RG, int GU, float forget_bias) {
  constexpr int R = CH_ROWS * MT;
  constexpr int N = 4 * U * MT;      // a thread's product sums
  constexpr int NK = N / 32;         // a lane's sums after the reduce-scatter
  // quads of a row a thread loads a pass (H of them: one pass at H = 320)
  constexpr int NQ = 5;
  static_assert(R * U <= R_THREADS, "one cell pair a thread");
  static_assert(N % 32 == 0 && N <= 64, "the product's sums fit the registers");
  extern __shared__ __align__(16) float smem[];
  const int H4 = 4 * H;
  float* w_s = smem;                     // [U][4H]
  float* part = w_s + (size_t)U * H4;    // [8 warps][N]
  const int dir = blockIdx.x / (RG * GU);
  const int rg = blockIdx.x / GU % RG, ug = blockIdx.x % GU;
  const int j0 = ug * U, row0 = rg * R;
  unsigned int* cnt = counters + dir * RG + rg;
  const T* whd = wh + (size_t)dir * H * H4;
  for (int i = threadIdx.x; i < U * H4; i += R_THREADS) {
    const int u = i / H4, k = i - u * H4;
    w_s[i] = j0 + u < H ? to_f(whd[(size_t)(j0 + u) * H4 + k]) : 0.f;
  }
  __syncthreads();

  const size_t dstride = (size_t)Tn * B;  // rows of one direction
  const float* gd = gates + (size_t)dir * dstride * H4;
  const float* cd = cst + (size_t)dir * dstride * H;
  T* dgd = dg + (size_t)dir * dstride * H4;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int rb = warp >> 1, ks = (warp & 1) * 32 + lane;
  const float4* w4 = reinterpret_cast<const float4*>(w_s);
  // the cell pair of this thread, and where its product's sum lands
  const int p = threadIdx.x, pr = p / U, pu = p % U;
  const int pb = row0 + pr, pj = j0 + pu;
  const bool live = p < R * U && pb < B && pj < H;
  const int len = live ? __ldg(lengths + pb) : 0;
  const int prr = pr % CH_ROWS;
  const int pw = 2 * (prr >> 2);                                // its row block's first warp
  const int pf = ((prr & 3) * U + pu) * MT + pr / CH_ROWS;      // its index in v
  const int pidx = (pf % NK) * 32 + pf / NK;                    // in a warp's partials
  float dh = 0.f, dc = 0.f;
  float zi = 0.f, zf = 0.f, zg = 0.f, zo = 0.f, c_t = 0.f, c_prev = 0.f, gyv = 0.f;
  // the cell's own operands of step s: none depends on the chain, so they
  // are fetched before the barrier that precedes step s ends
  auto fetch = [&](int s) {
    if (!live) return;
    const int t = dir == 0 ? Tn - 1 - s : s;
    const int t_fprev = dir == 0 ? t - 1 : t + 1;  // the forward's previous step
    const size_t row = (size_t)t * B + pb;
    const float* gr = gd + row * H4 + pj;
    zi = __ldg(gr);
    zf = __ldg(gr + H);
    zg = __ldg(gr + 2 * (size_t)H);
    zo = __ldg(gr + 3 * (size_t)H);
    c_t = __ldg(cd + row * H + pj);
    c_prev = (t_fprev >= 0 && t_fprev < Tn) ? __ldg(cd + ((size_t)t_fprev * B + pb) * H + pj)
                                            : 0.f;
    gyv = to_f(gy[row * 2 * H + (size_t)dir * H + pj]);
  };
  fetch(0);

  for (int s = 0; s < Tn; ++s) {
    // the fw direction's backward walks time descending, the bw one ascending
    const int t = dir == 0 ? Tn - 1 - s : s;
    float prod = 0.f;
    if (s > 0) {
      // wait until every block of this (direction, row group) has
      // published step s - 1
      if (threadIdx.x == 0) {
        const unsigned int target = (unsigned int)s * (unsigned int)GU;
        while (ld_acquire(cnt) < target) {
        }
        __threadfence();
      }
      __syncthreads();
      // dh_prev = dgates_prev @ wh^T for the block's rows and units, from
      // the dgates as stored (the compute type), in f32
      const T* prev = dgd + (size_t)(dir == 0 ? t + 1 : t - 1) * B * H4;
      float v[N];  // [(i U + u) MT + m]: row 16 m + 4 rb + i, unit u
#pragma unroll
      for (int k = 0; k < N; ++k) v[k] = 0.f;
#pragma unroll
      for (int m = 0; m < MT; ++m) {
        for (int q0 = 0; q0 < H; q0 += CH_KS * NQ) {
          quad_t<T> x[4][NQ];
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const int r = row0 + CH_ROWS * m + 4 * rb + i;
            const quad_t<T>* row = reinterpret_cast<const quad_t<T>*>(prev + (size_t)r * H4);
#pragma unroll
            for (int pq = 0; pq < NQ; ++pq) {
              const int q = q0 + ks + CH_KS * pq;
              x[i][pq] = (r < B && q < H) ? __ldcg(row + q) : quad_t<T>{};
            }
          }
#pragma unroll
          for (int pq = 0; pq < NQ; ++pq) {
            const int q = q0 + ks + CH_KS * pq;
            if (q < H) {
              float4 xq[4];
#pragma unroll
              for (int i = 0; i < 4; ++i) xq[i] = widen(x[i][pq]);
#pragma unroll
              for (int u = 0; u < U; ++u) {
                const float4 w = w4[(size_t)u * H + q];
#pragma unroll
                for (int i = 0; i < 4; ++i) {
                  float& a = v[(i * U + u) * MT + m];
                  a = fmaf(xq[i].x, w.x, a);
                  a = fmaf(xq[i].y, w.y, a);
                  a = fmaf(xq[i].z, w.z, a);
                  a = fmaf(xq[i].w, w.w, a);
                }
              }
            }
          }
        }
      }
      reduce_scatter<N, 16>(v, lane);
#pragma unroll
      for (int k = 0; k < NK; ++k) part[warp * N + k * 32 + lane] = v[k];
      __syncthreads();
      if (live) prod = part[pw * N + pidx] + part[(pw + 1) * N + pidx];
    }

    if (live) {
      // the masked cell backward (_bwd_train_kernel2 direction())
      const bool m = t < len;
      const float mf = m ? 1.f : 0.f;
      const float gi = sigmoid_f(zi);
      const float gf = sigmoid_f(zf + forget_bias);
      const float gg = tanhf(zg);
      const float go = sigmoid_f(zo);
      const float tanh_c = tanhf(c_t);
      const float dh_total = gyv * mf + (prod + dh);
      const float dh_new = m ? dh_total : 0.f;
      const float dc_new = (m ? dc : 0.f) + dh_new * go * (1.f - tanh_c * tanh_c);
      T* out = dgd + ((size_t)t * B + pb) * H4 + pj;
      out[0] = from_f<T>(dc_new * gg * gi * (1.f - gi));
      out[H] = from_f<T>(dc_new * c_prev * gf * (1.f - gf));
      out[2 * (size_t)H] = from_f<T>(dc_new * gi * (1.f - gg * gg));
      out[3 * (size_t)H] = from_f<T>(dh_new * tanh_c * go * (1.f - go));
      dh = m ? 0.f : dh_total;
      dc = dc_new * gf + (m ? 0.f : dc);
    }

    if (s + 1 < Tn) {
      // publish this step's dgates to the (direction, row group), then
      // fetch the next step's operands while the other blocks catch up
      __syncthreads();
      if (threadIdx.x == 0) {
        __threadfence();
        atomicAdd(cnt, 1u);
      }
      fetch(s + 1);
    }
  }
}

template <typename T, int U, int MT>
int launch_bwd_recur_form(const float* gates, const float* cst, const T* gy, const int* lengths,
                          const T* wh, T* dg, unsigned int* counters, int Tn, int B, int H,
                          float forget_bias, void* stream) {
  // the quads of dg's rows are 8-byte (bf16) or 16-byte (f32) loads
  if (reinterpret_cast<uintptr_t>(dg) % 16 != 0) return (int)cudaErrorMisalignedAddress;
  int RG = (B + CH_ROWS * MT - 1) / (CH_ROWS * MT);
  int GU = (H + U - 1) / U;
  const int blocks = 2 * RG * GU;
  const size_t smem = chain_bytes(H, U, MT);
  auto kernel = blstm_bwd_recur_kernel<T, U, MT>;
  cudaError_t err = check_coresident(kernel, blocks, R_THREADS, smem);
  if (err != cudaSuccess) return (int)err;
  void* args[] = {(void*)&gates, (void*)&cst, (void*)&gy, (void*)&lengths, (void*)&wh,
                  (void*)&dg,    (void*)&counters, (void*)&Tn, (void*)&B, (void*)&H,
                  (void*)&RG,    (void*)&GU,       (void*)&forget_bias};
  err = cudaLaunchCooperativeKernel((const void*)kernel, dim3(blocks), dim3(R_THREADS), args,
                                    smem, (cudaStream_t)stream);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// units U and m-tiles MT a block (ops/blstm.chain_plan: 8 x 1, 16 x 1,
// 8 x 2 or 4 x 4); counters hold 2 ceil(B / 16 MT) zeros
template <typename T>
int launch_bwd_recur(const float* gates, const float* cst, const T* gy, const int* lengths,
                     const T* wh, T* dg, unsigned int* counters, int Tn, int B, int H, int U,
                     int MT, float forget_bias, void* stream) {
  if (Tn <= 0 || B <= 0) return 0;
  if (H <= 0) return (int)cudaErrorInvalidValue;
  if (U == 8 && MT == 1)
    return launch_bwd_recur_form<T, 8, 1>(gates, cst, gy, lengths, wh, dg, counters, Tn, B, H,
                                          forget_bias, stream);
  if (U == 16 && MT == 1)
    return launch_bwd_recur_form<T, 16, 1>(gates, cst, gy, lengths, wh, dg, counters, Tn, B, H,
                                           forget_bias, stream);
  if (U == 8 && MT == 2)
    return launch_bwd_recur_form<T, 8, 2>(gates, cst, gy, lengths, wh, dg, counters, Tn, B, H,
                                          forget_bias, stream);
  if (U == 4 && MT == 4)
    return launch_bwd_recur_form<T, 4, 4>(gates, cst, gy, lengths, wh, dg, counters, Tn, B, H,
                                          forget_bias, stream);
  return (int)cudaErrorInvalidValue;
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
  return launch_gemm_wmma(g, kind, (cudaStream_t)stream);
}

// the Hopper GEMM (gemm_wgmma_bf16) for operands TMA can read; kinds as
// above, splits K slices for kind 2 (splitk_ws [splits, dirs, M, N] f32),
// colsum_ws [splits, dirs, N] f32 for the column sums
extern "C" int nabu_blstm_gemm_wgmma_bf16(const void* a0, const void* a1, const void* b0,
                                          const void* b1, int lda, int ldb, int M, int N, int K,
                                          int kind, int dirs, int splits, const void* bias,
                                          void* out, float* outf, float* colsum,
                                          float* colsum_ws, float* splitk_ws, void* stream) {
  const void* a[2] = {a0, a1};
  const void* b[2] = {b0, b1};
  return launch_gemm_wgmma(a, b, lda, ldb, M, N, K, kind, dirs, splits, bias, out, outf, colsum,
                           colsum_ws, splitk_ws, (cudaStream_t)stream);
}

// the f32 GEMM (gemm_ffma_f32) for every layout; arguments as
// nabu_blstm_gemm_wgmma_bf16's
extern "C" int nabu_blstm_gemm_f32(const void* a0, const void* a1, const void* b0,
                                   const void* b1, int lda, int ldb, int M, int N, int K,
                                   int kind, int dirs, int splits, const void* bias, void* out,
                                   float* outf, float* colsum, float* colsum_ws,
                                   float* splitk_ws, void* stream) {
  const void* a[2] = {a0, a1};
  const void* b[2] = {b0, b1};
  return launch_gemm_ffma(a, b, lda, ldb, M, N, K, kind, dirs, splits, bias, out, outf, colsum,
                          colsum_ws, splitk_ws, (cudaStream_t)stream);
}

// the walk (units U and m-tiles MT a block from ops/blstm.walk_plan): c_out
// and g_out null for inference; probe [blocks][4] for the step probe
extern "C" int nabu_blstm_recur_bf16(const void* xw, const int* lengths, const void* wh,
                                     void* y, void* hx, unsigned int* counters, float* c_out,
                                     float* g_out, unsigned long long* probe, int T, int B,
                                     int H, int units, int mt, float forget_bias,
                                     void* stream) {
  return launch_recur<bf16>((const bf16*)xw, lengths, (const bf16*)wh, (bf16*)y, (bf16*)hx,
                            counters, c_out, g_out, probe, T, B, H, units, mt, forget_bias,
                            stream);
}

extern "C" int nabu_blstm_recur_f32(const void* xw, const int* lengths, const void* wh,
                                    void* y, void* hx, unsigned int* counters, float* c_out,
                                    float* g_out, unsigned long long* probe, int T, int B,
                                    int H, int units, int mt, float forget_bias,
                                    void* stream) {
  return launch_recur<float>((const float*)xw, lengths, (const float*)wh, (float*)y,
                             (float*)hx, counters, c_out, g_out, probe, T, B, H, units, mt,
                             forget_bias, stream);
}

extern "C" int nabu_blstm_bwd_recur_bf16(const float* gates, const float* cst, const void* gy,
                                         const int* lengths, const void* wh, void* dg,
                                         unsigned int* counters, int T, int B, int H, int units,
                                         int mt, float forget_bias, void* stream) {
  return launch_bwd_recur<bf16>(gates, cst, (const bf16*)gy, lengths, (const bf16*)wh,
                                (bf16*)dg, counters, T, B, H, units, mt, forget_bias, stream);
}

extern "C" int nabu_blstm_bwd_recur_f32(const float* gates, const float* cst, const void* gy,
                                        const int* lengths, const void* wh, void* dg,
                                        unsigned int* counters, int T, int B, int H, int units,
                                        int mt, float forget_bias, void* stream) {
  return launch_bwd_recur<float>(gates, cst, (const float*)gy, lengths, (const float*)wh,
                                 (float*)dg, counters, T, B, H, units, mt, forget_bias, stream);
}
