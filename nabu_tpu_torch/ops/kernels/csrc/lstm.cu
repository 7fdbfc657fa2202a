// Unidirectional masked LSTM walk and its backward chain, for Hopper (sm_90a).
//
// Replaces the TPU kernels of nabu_tpu/ops/pallas/lstm.py:
// - lstm_fwd: _fwd (lstm.py:173 -> pallas_call :184, _fwd_kernel :42), the
//   masked walk over precomputed xw = x @ wx + b with wh resident, in f32
//   (lstm_scan_pallas upcasts bf16 xw and wh; here the kernel reads them in
//   their own type and converts on load, which is exact): gates, c and the
//   carried h are f32, the masked output h is written in xw's type. Unlike
//   the TPU kernel it also takes an initial carry (h0, c0) and writes the
//   final one, so a stream can be walked chunk by chunk: the arithmetic of
//   a step depends on nothing but its inputs, so a chunked walk equals one
//   walk bit for bit.
// - lstm_bwd_recur: the serial chain of _bwd (lstm.py:213 -> pallas_call
//   :230, _bwd_kernel :83, the per-step arithmetic of :106-147), walking
//   time descending, dh and dc carried in f32, dxw written in f32 (the
//   TPU's output type).
// The rest of _bwd_kernel, dwh += h_prev^T @ dgates (:137-139), is a
// launch of csrc/blstm.cu's GEMM (ops/lstm.py lstm_bwd_dwh).
//
// Bound on the H100 by the serial chain, not by bytes or operations: T
// dependent steps, each a [B, H] x [H, 4H] product in f32 plus the cell,
// and a hand-off between blocks. Rows of the batch are independent in both
// kernels, so their blocks own row groups and meet only the blocks of
// their own row group, at a counter of their own. Design:
// - lstm_fwd: one cooperative persistent launch. Block (rg, ug) owns 16 MT
//   rows x U units (U x MT = 8 x 1, 16 x 1, 8 x 2 or 16 x 2, from
//   ops/lstm.walk_plan: the first whose ceil(B / 16 MT) ceil(H / U) blocks
//   are co-resident one an SM; 8 x 1 at B = 32, H = 320: 80 blocks of 128
//   threads, the fastest form there), keeps its units' four gate columns
//   of wh in shared memory for the whole walk, and c and h of its cell
//   pairs in registers (one a thread, two in 16 x 2, whose 512 pairs share
//   256 threads). The arrival at the row group's counter is a block
//   barrier then a release add, the wait an acquire load then a block
//   barrier; no further fence. Each step, once the counter shows the
//   previous step published, the block pulls only its rows of the carried
//   f32 h_{t-1} from the exchange (ld.cg straight into registers, every
//   load of a pass in flight at once) and forms the gates' h-part as the
//   reference's f32 function (no TF32, no single rounding of h):
//   - f32 on the FMA pipes, register-blocked: a half warp owns 4 rows x 4
//     units' 4 gates (16 columns of wh, [4U][ceil4(H) + 4] f32), its 16
//     lanes take the quads ks + 16 p of K (5 each at H = 320), so a quad
//     of h feeds 16 columns and a float4 of wh 4 rows, and a
//     reduce-scatter of shuffles over the half warp adds the 16 K slices
//     and leaves each lane the 4 gates of its cell;
//   - bf16 (wh bf16) on tensor cores: each f32 h is split exactly into
//     three bf16 pieces (hi = bf16(h), mid = bf16(h - hi), lo = h - hi -
//     mid, at most 8 significant bits), each multiplied with the exact bf16
//     wh by mma.sync m16n8k16 into f32 accumulators of its own, so every
//     product is exact; 4 K groups of k16 steps (set by H alone), a warp
//     each, add their passes (lo + mid) + hi and store partial sums, which
//     each thread adds over the groups in order for its cell (wh as B
//     fragments, 20 KB at 8 x 1, H = 320; the A fragments straight from
//     16-byte loads of h, one a row a step, split in registers).
//   Both sum each output in an order that depends on H alone: a second
//   launch repeats the bits, and a row's bits depend neither on B, T, the
//   form nor a chunk's start. Then the masked cell on the step's xw
//   (fetched before the wait: it does not depend on the exchange), the
//   carried h to the exchange, the arrival (whose release waits for those
//   stores alone), then y and (training) the stores.
// - The exchange is a buffer of the carried f32 h of its own, [2 slots][B]
//   [ceil4(H)] (rows of whole 16-byte loads, the padding zero), not y: on
//   padding frames y is 0 while the carry is held. Slot 0 holds h0 at
//   launch. The slots ping-pong: a block writes slot (s + 1) % 2 at step s
//   only after its counter showed every block of its group arrived s
//   times, and a block arrives at step s - 1 only after its loads of that
//   step's slot, (s - 1) % 2 = (s + 1) % 2, were consumed, so no block
//   overwrites a slot another may still read. The final (h, c) leave the
//   registers at the end.
// - The training variant stores what the backward needs instead of the
//   TPU's post-step (h, c) and its recompute of h_prev @ wh in the chain
//   (one more H x 4H product per serial step): the f32 pre-activation
//   gates (without the forget bias), the f32 carry c and the f32 carried h
//   (dwh's h_prev). At T = 1024, B = 32, H = 320 that is 168 + 42 + 42 MB
//   a layer. A third variant, launched only by the step probe, sums each
//   block's clock64 cycles a step by wait, pull, product and cell.
// - lstm_bwd_recur: one cooperative persistent launch. Block (rg, ug) owns
//   16 MT rows x 8 units (MT from ops/lstm.chain_plan: the least of 1 or 2
//   that keeps every block co-resident, one an SM), keeps its units' rows
//   of wh, [8, 4H] f32, in shared memory. Each step, after the barrier, it
//   pulls only its rows of the previous step's dgates from the dxw output
//   itself (the exchange buffer; 16 x 4H x 4 = 80 KB at H = 320, every
//   16-byte load of a pass in flight at once, ld.cg straight into
//   registers), forms dh_prev = dgates_prev @ wh^T for its units in f32
//   with the loads register-blocked (each thread 4 rows x 8 units over a K
//   slice: one float4 of dgates feeds 8 units, one of wh 4 rows), adds the
//   K slices by shuffles and the warps in a fixed order, runs the masked
//   cell backward from the stored gates and carries (fetched before the
//   barrier: they do not depend on the exchange), writes its dgates and
//   arrives at its group's counter.
// Where the walk was hard: its reference is f32 on both sides, so the v2
// walk's bf16 product (h carried in bf16) does not carry over; rounding h
// once to bf16, or TF32, would compute another function. Hence FFMA in
// f32 and the exact three-piece split on tensor cores in bf16 (1.63 ->
// 0.69 us of a 2.9 us step at 8 x 1, PERF.md). Widening bf16 xw as it is
// fetched made the warp wait for the load before the barrier: it is held
// as loaded. Registers: 165 to 254 a thread, no spills but 16 x 2 in bf16
// (its 512 pairs: 48 to 80 bytes of stack).
// Shared memory and blocks, the design limits (ops/lstm.py raises beyond
// them): walk at most 16 U (ceil4(H) + 4) bytes at H = 320 (41 KB at 8 x
// 1) with ceil(B / 16 MT) ceil(H / U) blocks on the card's 132 SMs (B <=
// 192 at H = 320, by 16 x 2); chain 4 (8 x 4H + 8 x 32 MT) bytes (42 KB at
// H = 320) with ceil(B / 16 MT) ceil(H / 8) blocks (B <= 96 at H = 320).

#include "serial.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int CH_ROWS = 16;  // rows of an m-tile; a block owns 16 MT rows

// ---------------------------------------------------------------------------
// forward walk
// ---------------------------------------------------------------------------

constexpr int W_KS = 16;  // f32: K slices of a step's product, the lanes of a half warp
constexpr int W_NQ = 5;   // f32: quads of h a K slice loads a pass (80: H = 320 in one)
constexpr int M_KP = 4;   // bf16: K groups of a step's product, a warp each
constexpr int M_NS = 5;   // bf16: k16 steps a warp loads a pass (5: H = 320 in one)

// the exchange's row stride (floats): H rounded up to whole quads
__host__ __device__ inline int walk_xp(int H) { return (H + 3) / 4 * 4; }
// f32: the row stride of the staged wh columns, a quad more, so the
// staging's stores spread over the banks (the product reads whole rows)
__host__ __device__ inline int walk_wp(int H) { return walk_xp(H) + 4; }
// bf16: k16 steps of K, and the K groups' partial sums' row stride (float2
// stores of a fragment free of bank conflicts)
__host__ __device__ inline int walk_steps(int H) { return (H + 15) / 16; }
__host__ __device__ constexpr int walk_pst(int U) { return 4 * U + 8; }

// shared memory of a walk block of U units and 16 MT rows. f32: the four
// gate columns of wh of its units, [4 U][walk_wp(H)] f32; bf16: the same
// columns as mma B fragments, [k16 step][n-tile][lane] of 8 bytes, then
// the K groups' partial sums [4][16 MT][4 U + 8] f32
template <typename T>
__host__ __device__ inline size_t walk_bytes(int H, int U, int MT) {
  if (sizeof(T) == 4) return sizeof(float) * 4 * (size_t)U * walk_wp(H);
  return (size_t)walk_steps(H) * (U / 2) * 32 * sizeof(uint2) +
         sizeof(float) * M_KP * CH_ROWS * MT * walk_pst(U);
}

// a form of U units x 16 MT rows: one cell pair a thread up to 256, two in
// 16 x 2
template <int U, int MT>
struct WalkForm {
  static constexpr int PAIRS = CH_ROWS * MT * U;
  static constexpr int NT = PAIRS < THREADS ? PAIRS : THREADS;  // threads
  static constexpr int P = PAIRS / NT;                          // cell pairs a thread
  static_assert(U % 4 == 0 && NT % 32 == 0 && PAIRS % NT == 0, "tiles of 4 x 4, whole warps");
};

struct WalkArgs {
  const void* xw;        // [T, B, 4H]
  const int* lengths;    // [B]
  const void* wh;        // [H, 4H]
  const float* c0;       // [B, H] initial c, or null (zeros)
  void* y;               // [T, B, H] masked outputs
  float* hx;             // [2 slot][B][walk_xp(H)] carried h; slot 0 = h0 at launch
  float* h_last;         // [B, H] final carried h
  float* c_last;         // [B, H] final c
  unsigned int* counters;  // [RG], zero at launch
  float* g_out;          // STORE: [T, B, 4H] pre-activation gates
  float* c_out;          // STORE: [T, B, H] carried c
  float* h_out;          // STORE: [T, B, H] carried h
  unsigned long long* probe;  // PROBE: [blocks][4] cycles
  int Tn, B, H, RG, GU;
  float forget_bias;
};

// f32: w_s[(4 u + g) WP + k] = wh[k, g H + j0 + u], zero past H
template <int U, int NT>
__device__ void stage_walk_wh(const float* wh, int j0, int H, unsigned char* smem) {
  float* w_s = reinterpret_cast<float*>(smem);
  const int WP = walk_wp(H), H4 = 4 * H;
#pragma unroll 4
  for (int i = threadIdx.x; i < 4 * U * WP; i += NT) {
    const int k = i / (4 * U), g = i / U % 4, u = i % U;
    w_s[(4 * u + g) * WP + k] = (k < H && j0 + u < H) ? wh[(size_t)k * H4 + g * H + j0 + u] : 0.f;
  }
}

// bf16: wh's gate columns of the block's units j0 + [0, U) in the order the
// mma B fragments read them: uint2 (st, nt, lane) holds column n = 8 nt +
// lane / 4 (unit n / 4, gate n % 4) at k = 16 st + 4 (lane % 4) + [0, 4),
// zero past H. The A fragments take the same 4 k of their rows (the k
// order inside a k16 step is a permutation both operands share), so one
// 16-byte load of f32 h serves a row's half of a step.
template <int U, int NT>
__device__ void stage_walk_wh(const bf16* wh, int j0, int H, unsigned char* smem) {
  constexpr int NTN = U / 2;
  unsigned short* w = reinterpret_cast<unsigned short*>(smem);
  const unsigned short* src = reinterpret_cast<const unsigned short*>(wh);
  const int H4 = 4 * H, n_all = walk_steps(H) * 16 * 4 * U;
  // read in wh's order (units fastest, then gates, then k), so a warp's
  // loads fall on a few rows of wh
#pragma unroll 4
  for (int i = threadIdx.x; i < n_all; i += NT) {
    const int u = i % U, g = i / U % 4, k = i / (4 * U);
    const int n = 4 * u + g, st = k >> 4, lane = (n & 7) * 4 + ((k >> 2) & 3);
    w[(((size_t)st * NTN + (n >> 3)) * 32 + lane) * 4 + (k & 3)] =
        (k < H && j0 + u < H) ? src[(size_t)k * H4 + g * H + j0 + u] : (unsigned short)0;
  }
}

__device__ __forceinline__ uint32_t bits2(__nv_bfloat162 v) {
  return *reinterpret_cast<const uint32_t*>(&v);
}

// the f32 pair (a, b) as three bf16 pairs whose sums give it exactly:
// out[0] = bf16(x), out[1] = bf16(x - out[0]), out[2] = x - out[0] - out[1]
// (each residual is exact in f32; the last has at most 8 significant bits)
__device__ __forceinline__ void split3(float a, float b, uint32_t* out) {
  const __nv_bfloat162 hi = __floats2bfloat162_rn(a, b);
  const float ra = a - __low2float(hi), rb = b - __high2float(hi);
  const __nv_bfloat162 mid = __floats2bfloat162_rn(ra, rb);
  const __nv_bfloat162 lo =
      __floats2bfloat162_rn(ra - __low2float(mid), rb - __high2float(mid));
  out[0] = bits2(hi);
  out[1] = bits2(mid);
  out[2] = bits2(lo);
}

// f32 step product on the FMA pipes (no TF32: the 1e-4 check) of tile x
// (rows 4 (x % 4 MT) + [0, 4), units 4 (x / 4 MT) + [0, 4) of the block,
// their 4 gates: 16 columns of wh): lane ks =
// lane % 16 of its half warp takes the quads ks + 16 p of h_{t-1} and sums
// the tile's 4 rows x 16 columns over them; the reduce-scatter over the
// half warp adds the 16 K slices and leaves lane ks the 4 gates of row 4 (x
// % 4 MT) + ks / 4, unit 4 (x / 4 MT) + ks % 4 in z.
template <int MT, bool PROBE>
__device__ __forceinline__ void walk_product(const float* hin, int x, int row0, int B, int H,
                                             const unsigned char* smem, float* z,
                                             unsigned long long* spent,
                                             unsigned long long& stamp) {
  const int xp = walk_xp(H), HQ = xp / 4, WQ = walk_wp(H) / 4;
  const int lane = threadIdx.x & 31, ks = lane & 15;
  const int rt = x % (4 * MT), ut = x / (4 * MT);
  // column 4 uu + g of the tile (unit 4 ut + uu, gate g) at w4[(4 uu + g) WQ + q]
  const float4* w4 = reinterpret_cast<const float4*>(smem) + (size_t)16 * ut * WQ;
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
        // the pull ends where its values are first used
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
          const float4 w = w4[(size_t)col * WQ + q];
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

// bf16 step product on tensor cores, exact in f32: each f32 h is split into
// three bf16 pieces (split3) and each piece multiplied with the bf16 wh by
// mma.sync m16n8k16 into f32 accumulators of its own, so every product is
// exact and only the order of the f32 sums differs from the reference.
// The K steps of 16 split into 4 groups of ceil(steps / 4) by H alone;
// warp w takes group w % 4 and (256 threads) half w / 4 of the block's
// n-tiles, issues every
// 16-byte load of its rows of h_{t-1} at once (ld.cg, straight into
// registers), runs the three passes per step in step order, adds them
// (lo + mid) + hi and stores its partial sums; after a block barrier each
// thread adds its cell pairs' 4 gates over the groups in group order, so a
// row's sums depend neither on B nor on the form.
template <int U, int MT, int NT, int P, bool PROBE>
__device__ __forceinline__ void walk_product_mma(const float* hin, int row0, int B, int H,
                                                 unsigned char* smem, const int* pr,
                                                 const int* pu, float (*z)[4],
                                                 unsigned long long* spent,
                                                 unsigned long long& stamp) {
  constexpr int NTN = U / 2, HALVES = NT / 128, PST = walk_pst(U);
  constexpr int WM = MT, WN = NTN / HALVES;  // a warp's m- and n-tiles
  static_assert(NT % 128 == 0 && WN * HALVES == NTN, "4 K groups x halves of the n-tiles");
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t4 = lane & 3;
  const int kp = warp % M_KP, n0 = warp / M_KP * WN;
  const int xp = walk_xp(H), S = walk_steps(H), spg = (S + M_KP - 1) / M_KP;
  const int s_begin = kp * spg, s_end = min(S, s_begin + spg);
  const uint2* wb = reinterpret_cast<const uint2*>(smem);
  float acc[3][WM][WN][4];  // [piece][m-tile][n-tile][fragment]
#pragma unroll
  for (int c = 0; c < 3; ++c)
#pragma unroll
    for (int m = 0; m < WM; ++m)
#pragma unroll
      for (int n = 0; n < WN; ++n)
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[c][m][n][q] = 0.f;
  for (int s0 = 0; s0 < spg; s0 += M_NS) {
    float4 hq[M_NS][WM][2];  // rows g, g + 8 of each m-tile, k 16 st + 4 t4 + [0, 4)
#pragma unroll
    for (int i = 0; i < M_NS; ++i) {
      const int st = s_begin + s0 + i, k = 16 * st + 4 * t4;
#pragma unroll
      for (int m = 0; m < WM; ++m)
#pragma unroll
        for (int h2 = 0; h2 < 2; ++h2) {
          const int r = row0 + CH_ROWS * m + 8 * h2 + g;
          hq[i][m][h2] = (s0 + i < spg && st < s_end && r < B && k < xp)
                             ? __ldcg(reinterpret_cast<const float4*>(hin + (size_t)r * xp + k))
                             : make_float4(0.f, 0.f, 0.f, 0.f);
        }
    }
    if constexpr (PROBE) {
      if (s0 == 0) {
        // the pull ends where its values are first used
        unsigned int bits = 0u;
#pragma unroll
        for (int i = 0; i < M_NS; ++i)
#pragma unroll
          for (int m = 0; m < WM; ++m)
#pragma unroll
            for (int h2 = 0; h2 < 2; ++h2)
              bits ^= __float_as_uint(hq[i][m][h2].x) ^ __float_as_uint(hq[i][m][h2].y) ^
                      __float_as_uint(hq[i][m][h2].z) ^ __float_as_uint(hq[i][m][h2].w);
        if (bits == 0x9e3779b9u) spent[0] += 1;  // a use the compiler cannot drop
        __syncthreads();
        probe_stamp<PROBE>(spent, 1, stamp);
      }
    }
#pragma unroll
    for (int i = 0; i < M_NS; ++i) {
      const int st = s_begin + s0 + i;
      if (s0 + i < spg && st < s_end) {
        uint32_t a[WM][4][3];  // [m-tile][fragment register][piece]
#pragma unroll
        for (int m = 0; m < WM; ++m) {
          const float4 lo = hq[i][m][0], hi = hq[i][m][1];  // rows g, g + 8
          split3(lo.x, lo.y, a[m][0]);
          split3(hi.x, hi.y, a[m][1]);
          split3(lo.z, lo.w, a[m][2]);
          split3(hi.z, hi.w, a[m][3]);
        }
#pragma unroll
        for (int n = 0; n < WN; ++n) {
          const uint2 b = wb[((size_t)st * NTN + n0 + n) * 32 + lane];
#pragma unroll
          for (int m = 0; m < WM; ++m)
#pragma unroll
            for (int c = 0; c < 3; ++c)
              mma_16816(acc[c][m][n], a[m][0][c], a[m][1][c], a[m][2][c], a[m][3][c], b.x, b.y);
        }
      }
    }
  }
  float* part = reinterpret_cast<float*>(smem + (size_t)S * NTN * 32 * sizeof(uint2));
#pragma unroll
  for (int m = 0; m < WM; ++m)
#pragma unroll
    for (int n = 0; n < WN; ++n) {
      float v[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) v[q] = (acc[2][m][n][q] + acc[1][m][n][q]) + acc[0][m][n][q];
      float* p = part + ((size_t)kp * CH_ROWS * MT + CH_ROWS * m + g) * PST +
                 8 * (n0 + n) + 2 * t4;
      *reinterpret_cast<float2*>(p) = make_float2(v[0], v[1]);
      *reinterpret_cast<float2*>(p + 8 * PST) = make_float2(v[2], v[3]);
    }
  __syncthreads();
#pragma unroll
  for (int k = 0; k < P; ++k) {
    float4 sum = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
    for (int q = 0; q < M_KP; ++q) {
      const float* pq = part + ((size_t)q * CH_ROWS * MT + pr[k]) * PST + 4 * pu[k];
      const float4 p = *reinterpret_cast<const float4*>(pq);
      sum.x += p.x;
      sum.y += p.y;
      sum.z += p.z;
      sum.w += p.w;
    }
    z[k][0] = sum.x;
    z[k][1] = sum.y;
    z[k][2] = sum.z;
    z[k][3] = sum.w;
  }
  if constexpr (PROBE) {
    __syncthreads();
    probe_stamp<PROBE>(spent, 2, stamp);
  }
}

// Block (rg, ug) owns rows rg 16 MT + [0, 16 MT) and units ug U + [0, U).
// Thread p runs the cell pairs of tiles x = p / 16 + (NT / 16) k, k < P, at
// lane ks = p % 16 (where the product's reduce-scatter leaves its 4 gates)
// and keeps their c and h carries in registers. PROBE: thread 0 sums the
// clock64 cycles of each step spent waiting, pulling (to the loads' first
// use), multiplying (to the gates' sums) and in the cell (to the next
// step's start) into probe[block][4], with a block barrier after the pull
// and after the product.
template <typename T, bool STORE, bool PROBE, int U, int MT>
__global__ void __launch_bounds__(WalkForm<U, MT>::NT, 1) lstm_fwd_kernel(WalkArgs a) {
  using F = WalkForm<U, MT>;
  constexpr int P = F::P, NT = F::NT;
  extern __shared__ __align__(16) float smem_f[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(smem_f);
  const T* __restrict__ xw = static_cast<const T*>(a.xw);
  T* __restrict__ y = static_cast<T*>(a.y);
  const int Tn = a.Tn, B = a.B, H = a.H, H4 = 4 * H, xp = walk_xp(H);
  const int rg = blockIdx.x / a.GU, ug = blockIdx.x % a.GU;
  const int j0 = ug * U, row0 = rg * CH_ROWS * MT;
  unsigned int* cnt = a.counters + rg;
  stage_walk_wh<U, NT>(static_cast<const T*>(a.wh), j0, H, smem);

  // the cell pairs of this thread, with their carries
  const int ks = threadIdx.x & 15;
  int px[P], pr[P], pu[P], pb[P], pj[P], len[P];
  bool live[P];
  float c[P], h[P];
  T xg[P][4];  // held as loaded: widening them here would wait for the loads
#pragma unroll
  for (int k = 0; k < P; ++k) {
    px[k] = (threadIdx.x >> 4) + (NT / 16) * k;
    pr[k] = 4 * (px[k] % (4 * MT)) + (ks >> 2);
    pu[k] = 4 * (px[k] / (4 * MT)) + (ks & 3);
    pb[k] = row0 + pr[k];
    pj[k] = j0 + pu[k];
    live[k] = pb[k] < B && pj[k] < H;
#pragma unroll
    for (int g = 0; g < 4; ++g) xg[k][g] = from_f<T>(0.f);
    len[k] = live[k] ? __ldg(a.lengths + pb[k]) : 0;
    c[k] = live[k] && a.c0 != nullptr ? a.c0[(size_t)pb[k] * H + pj[k]] : 0.f;
    h[k] = live[k] ? a.hx[(size_t)pb[k] * xp + pj[k]] : 0.f;
  }
  // the cells' input of step s: it does not depend on the walk, so it is
  // fetched before the wait that precedes step s ends
  auto fetch = [&](int s) {
#pragma unroll
    for (int k = 0; k < P; ++k) {
      if (!live[k]) continue;
      const T* xr = xw + ((size_t)s * B + pb[k]) * H4 + pj[k];
#pragma unroll
      for (int g = 0; g < 4; ++g) xg[k][g] = __ldg(xr + (size_t)g * H);
    }
  };
  fetch(0);
  __syncthreads();
  unsigned long long spent[4] = {0ull, 0ull, 0ull, 0ull};
  unsigned long long stamp = 0ull;

  for (int s = 0; s < Tn; ++s) {
    if constexpr (PROBE) {
      const unsigned long long now = clock64();
      if (s > 0) spent[3] += now - stamp;
      stamp = now;
    }
    if (s > 0) {
      // wait until every block of this row group has published step s - 1:
      // an acquire load, then the block barrier
      if (threadIdx.x == 0) {
        const unsigned int target = (unsigned int)s * (unsigned int)a.GU;
        while (ld_acquire(cnt) < target) {
        }
      }
      __syncthreads();
    }
    probe_stamp<PROBE>(spent, 0, stamp);
    // the h-part of the cell pairs' gates, from h_{t-1} in slot s % 2 (h0
    // at s = 0; a zero h0 gives exact zeros)
    const float* hin = a.hx + (size_t)(s & 1) * B * xp;
    float zh[P][4];
    if constexpr (sizeof(T) == 2) {
      walk_product_mma<U, MT, NT, P, PROBE>(hin, row0, B, H, smem, pr, pu, zh, spent, stamp);
    } else {
#pragma unroll
      for (int k = 0; k < P; ++k)
        walk_product<MT, PROBE>(hin, px[k], row0, B, H, smem, zh[k], spent, stamp);
    }

    // the masked cell (_fwd_kernel): gates, c and the carried h in f32
    float* hout = a.hx + (size_t)((s + 1) & 1) * B * xp;
    float z[P][4], y_t[P];
#pragma unroll
    for (int k = 0; k < P; ++k) {
#pragma unroll
      for (int g = 0; g < 4; ++g) z[k][g] = to_f(xg[k][g]) + zh[k][g];
      y_t[k] = 0.f;
      if (live[k]) {
        const float gi = sigmoid_f(z[k][0]);
        const float gf = sigmoid_f(z[k][1] + a.forget_bias);
        const float gg = tanhf(z[k][2]);
        const float go = sigmoid_f(z[k][3]);
        const float c_new = fmaf(gf, c[k], __fmul_rn(gi, gg));
        const float h_new = __fmul_rn(go, tanhf(c_new));
        // masked carry: padding frames keep (h, c) and output zeros
        if (s < len[k]) {
          c[k] = c_new;
          h[k] = h_new;
          y_t[k] = h_new;
        }
        if (s + 1 < Tn) hout[(size_t)pb[k] * xp + pj[k]] = h[k];
      }
    }
    if (s + 1 < Tn) {
      // publish this step's h to the row group: the block barrier, then a
      // release add, which waits for the exchange's stores alone (the
      // outputs' follow)
      __syncthreads();
      if (threadIdx.x == 0) red_release(cnt);
    }
#pragma unroll
    for (int k = 0; k < P; ++k) {
      if (!live[k]) continue;
      const size_t row = (size_t)s * B + pb[k];
      y[row * H + pj[k]] = from_f<T>(y_t[k]);
      if constexpr (STORE) {
        a.c_out[row * H + pj[k]] = c[k];
        a.h_out[row * H + pj[k]] = h[k];
        float* gr = a.g_out + row * H4 + pj[k];
        gr[0] = z[k][0];
        gr[H] = z[k][1];
        gr[2 * (size_t)H] = z[k][2];
        gr[3 * (size_t)H] = z[k][3];
      }
    }
    // the next step's input, fetched while the other blocks catch up
    if (s + 1 < Tn) fetch(s + 1);
  }
#pragma unroll
  for (int k = 0; k < P; ++k) {
    if (!live[k]) continue;
    a.h_last[(size_t)pb[k] * H + pj[k]] = h[k];
    a.c_last[(size_t)pb[k] * H + pj[k]] = c[k];
  }
  if constexpr (PROBE) {
    if (threadIdx.x == 0) {
      spent[3] += clock64() - stamp;
#pragma unroll
      for (int k = 0; k < 4; ++k) a.probe[(size_t)blockIdx.x * 4 + k] = spent[k];
    }
  }
}

template <typename T, bool STORE, bool PROBE, int U, int MT>
int launch_walk_form(WalkArgs a, void* stream) {
  using F = WalkForm<U, MT>;
  // hx's rows are read in 16-byte loads
  if (reinterpret_cast<uintptr_t>(a.hx) % 16 != 0) return (int)cudaErrorMisalignedAddress;
  a.RG = (a.B + CH_ROWS * MT - 1) / (CH_ROWS * MT);
  a.GU = (a.H + U - 1) / U;
  const int blocks = a.RG * a.GU;
  const size_t smem = walk_bytes<T>(a.H, U, MT);
  auto kernel = lstm_fwd_kernel<T, STORE, PROBE, U, MT>;
  cudaError_t err = check_coresident(kernel, blocks, F::NT, smem);
  if (err != cudaSuccess) return (int)err;
  void* args[] = {(void*)&a};
  err = cudaLaunchCooperativeKernel((const void*)kernel, dim3(blocks), dim3(F::NT), args, smem,
                                    (cudaStream_t)stream);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// units U and m-tiles MT a block (ops/lstm.walk_plan); counters hold
// ceil(B / 16 MT) zeros
template <typename T, bool STORE, bool PROBE>
int launch_walk_forms(const WalkArgs& a, int U, int MT, void* stream) {
  if (U == 8 && MT == 1) return launch_walk_form<T, STORE, PROBE, 8, 1>(a, stream);
  if (U == 16 && MT == 1) return launch_walk_form<T, STORE, PROBE, 16, 1>(a, stream);
  if (U == 8 && MT == 2) return launch_walk_form<T, STORE, PROBE, 8, 2>(a, stream);
  if (U == 16 && MT == 2) return launch_walk_form<T, STORE, PROBE, 16, 2>(a, stream);
  return (int)cudaErrorInvalidValue;
}

// g_out null: the inference walk; probe non-null: the training walk with
// its step probe
template <typename T>
int launch_walk(const WalkArgs& a, int U, int MT, void* stream) {
  if (a.Tn <= 0 || a.B <= 0) return 0;
  if (a.H <= 0) return (int)cudaErrorInvalidValue;
  const bool store = a.g_out != nullptr;
  if (store && (a.c_out == nullptr || a.h_out == nullptr)) return (int)cudaErrorInvalidValue;
  if (a.probe != nullptr) {
    if (!store) return (int)cudaErrorInvalidValue;
    return launch_walk_forms<T, true, true>(a, U, MT, stream);
  }
  if (store) return launch_walk_forms<T, true, false>(a, U, MT, stream);
  return launch_walk_forms<T, false, false>(a, U, MT, stream);
}

// ---------------------------------------------------------------------------
// backward chain
// ---------------------------------------------------------------------------

constexpr int CH_UNITS = 8;   // hidden units a chain block owns
constexpr int CH_KS = 64;     // K slices of a step product: the threads of a row block
constexpr int CH_NQ = 5;      // float4 of a row a thread loads a pass (4H = 1280 at H = 320)
static_assert(CH_ROWS == 4 * THREADS / CH_KS, "a row block of 4 rows a warp pair");

// shared memory of a chain block: wh rows of its units [8][4H] f32 and the
// warps' reduced partial sums [8][32 MT]
__host__ __device__ inline size_t chain_bytes(int H, int MT) {
  return sizeof(float) * ((size_t)CH_UNITS * 4 * H + (size_t)(THREADS / 32) * 32 * MT);
}

// Block (rg, ug) owns rows rg 16 MT + [0, 16 MT) and units ug 8 + [0, 8);
// rows are independent in the chain, so the blocks of one row group meet
// at their own counter each step. Step product: warp w takes rows 4 (w /
// 2) + [0, 4) of each m-tile and K slice ks = 32 (w % 2) + lane, the
// float4 columns ks + 64 p of the previous step's dgates (ld.cg straight
// into registers, every load of the pass in flight at once), and sums its
// 4 MT rows x 8 units over them (one float4 of dgates feeds 8 units, one
// of wh 4 rows); the warp's 32 K slices are added by a reduce-scatter of
// shuffles, the two warps of a row block in warp order. Thread p <
// 128 MT owns the cell pair (row, unit) = (p / 8, p % 8) and keeps its dh
// and dc carries in registers.
template <typename T, int MT>
__global__ void __launch_bounds__(THREADS, 1) lstm_bwd_recur_kernel(
    const float* __restrict__ gates,  // [T, B, 4H] f32 pre-activations
    const float* __restrict__ cst,    // [T, B, H] f32 carries
    const T* __restrict__ gy,         // [T, B, H] cotangent of the output
    const int* __restrict__ lengths,  // [B]
    const T* __restrict__ wh,         // [H, 4H]
    float* dxw,                       // [T, B, 4H] out; also the exchange
    unsigned int* counters,           // [ceil(B / 16 MT)], zero at launch
    int Tn, int B, int H, int GU, float forget_bias) {
  constexpr int R = CH_ROWS * MT;
  constexpr int WARPS = THREADS / 32;
  static_assert(R * CH_UNITS <= THREADS, "one cell pair a thread");
  extern __shared__ __align__(16) float smem[];
  float* w_s = smem;                                  // [8][4H]
  float* part = w_s + (size_t)CH_UNITS * 4 * H;       // [WARPS][32 MT]
  const int H4 = 4 * H;
  const int ug = blockIdx.x % GU, rg = blockIdx.x / GU;
  const int j0 = ug * CH_UNITS, row0 = rg * R;
  unsigned int* cnt = counters + rg;
  for (int i = threadIdx.x; i < CH_UNITS * H4; i += THREADS) {
    const int u = i / H4, k = i - u * H4;
    w_s[i] = j0 + u < H ? to_f(wh[(size_t)(j0 + u) * H4 + k]) : 0.f;
  }
  __syncthreads();

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int rb = warp >> 1, ks = (warp & 1) * 32 + lane;
  const float4* w4 = reinterpret_cast<const float4*>(w_s);
  // the cell pair of this thread
  const int p = threadIdx.x, pr = p / CH_UNITS, pu = p % CH_UNITS;
  const int pb = row0 + pr, pj = j0 + pu;
  const bool live = p < R * CH_UNITS && pb < B && pj < H;
  const int len = live ? __ldg(lengths + pb) : 0;
  const int pm = pr / CH_ROWS, prr = pr % CH_ROWS;  // m-tile, row in it
  const int pw = 2 * (prr >> 2), pl = (prr & 3) * CH_UNITS + pu;  // its warps' slot
  float dh = 0.f, dc = 0.f;
  float zi = 0.f, zf = 0.f, zg = 0.f, zo = 0.f, c_t = 0.f, c_prev = 0.f, gyv = 0.f;
  // the cell's own operands of step s: none depends on the chain, so they
  // are fetched before the barrier that precedes step s ends
  auto fetch = [&](int s) {
    if (!live) return;
    const int t = Tn - 1 - s;
    const size_t row = (size_t)t * B + pb;
    const float* gr = gates + row * H4 + pj;
    zi = __ldg(gr);
    zf = __ldg(gr + H);
    zg = __ldg(gr + 2 * (size_t)H);
    zo = __ldg(gr + 3 * (size_t)H);
    c_t = __ldg(cst + row * H + pj);
    c_prev = t > 0 ? __ldg(cst + ((size_t)(t - 1) * B + pb) * H + pj) : 0.f;
    gyv = to_f(gy[row * H + pj]);
  };
  fetch(0);

  for (int s = 0; s < Tn; ++s) {
    const int t = Tn - 1 - s;
    float prod = 0.f;
    if (s > 0) {
      // wait until every block of this row group has published step s - 1
      if (threadIdx.x == 0) {
        const unsigned int target = (unsigned int)s * (unsigned int)GU;
        while (ld_acquire(cnt) < target) {
        }
        __threadfence();
      }
      __syncthreads();
      // dh_prev = dgates_{t+1} @ wh^T for the block's rows and units
      const float4* prev = reinterpret_cast<const float4*>(dxw + (size_t)(t + 1) * B * H4);
      float v[32 * MT];  // [(i 8 + u) MT + m]: row 16 m + 4 rb + i, unit u
#pragma unroll
      for (int k = 0; k < 32 * MT; ++k) v[k] = 0.f;
#pragma unroll
      for (int m = 0; m < MT; ++m) {
        for (int q0 = 0; q0 < H; q0 += CH_KS * CH_NQ) {
          float4 x[4][CH_NQ];
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const int r = row0 + CH_ROWS * m + 4 * rb + i;
#pragma unroll
            for (int pq = 0; pq < CH_NQ; ++pq) {
              const int q = q0 + ks + CH_KS * pq;
              x[i][pq] = (r < B && q < H) ? __ldcg(prev + (size_t)r * H + q)
                                          : make_float4(0.f, 0.f, 0.f, 0.f);
            }
          }
#pragma unroll
          for (int pq = 0; pq < CH_NQ; ++pq) {
            const int q = q0 + ks + CH_KS * pq;
            if (q < H) {
#pragma unroll
              for (int u = 0; u < CH_UNITS; ++u) {
                const float4 w = w4[(size_t)u * H + q];
#pragma unroll
                for (int i = 0; i < 4; ++i) {
                  float& a = v[(i * CH_UNITS + u) * MT + m];
                  a = fmaf(x[i][pq].x, w.x, a);
                  a = fmaf(x[i][pq].y, w.y, a);
                  a = fmaf(x[i][pq].z, w.z, a);
                  a = fmaf(x[i][pq].w, w.w, a);
                }
              }
            }
          }
        }
      }
      reduce_scatter<32 * MT, 16>(v, lane);
#pragma unroll
      for (int m = 0; m < MT; ++m) part[warp * 32 * MT + m * 32 + lane] = v[m];
      __syncthreads();
      if (live) {
        const float* pp = part + pw * 32 * MT + pm * 32 + pl;
        prod = pp[0] + pp[32 * MT];
      }
    }

    if (live) {
      // the masked cell backward (_bwd_kernel, lstm.py:118-146)
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
      float* out = dxw + ((size_t)t * B + pb) * H4 + pj;
      out[0] = dc_new * gg * gi * (1.f - gi);
      out[H] = dc_new * c_prev * gf * (1.f - gf);
      out[2 * (size_t)H] = dc_new * gi * (1.f - gg * gg);
      out[3 * (size_t)H] = dh_new * tanh_c * go * (1.f - go);
      dh = m ? 0.f : dh_total;
      dc = dc_new * gf + (m ? 0.f : dc);
    }

    if (s + 1 < Tn) {
      // publish this step's dgates to the row group, then fetch the next
      // step's operands while the other blocks catch up
      __syncthreads();
      if (threadIdx.x == 0) {
        __threadfence();
        atomicAdd(cnt, 1u);
      }
      fetch(s + 1);
    }
  }
}

template <typename T, int MT>
int launch_bwd_recur_mt(const float* gates, const float* cst, const T* gy, const int* lengths,
                        const T* wh, float* dxw, unsigned int* counters, int Tn, int B, int H,
                        float forget_bias, void* stream) {
  int GU = (H + CH_UNITS - 1) / CH_UNITS;
  const int blocks = (B + CH_ROWS * MT - 1) / (CH_ROWS * MT) * GU;
  const size_t smem = chain_bytes(H, MT);
  auto kernel = lstm_bwd_recur_kernel<T, MT>;
  cudaError_t err = check_coresident(kernel, blocks, THREADS, smem);
  if (err != cudaSuccess) return (int)err;
  void* args[] = {(void*)&gates, (void*)&cst, (void*)&gy, (void*)&lengths, (void*)&wh,
                  (void*)&dxw,   (void*)&counters, (void*)&Tn, (void*)&B, (void*)&H,
                  (void*)&GU,    (void*)&forget_bias};
  err = cudaLaunchCooperativeKernel((const void*)kernel, dim3(blocks), dim3(THREADS), args, smem,
                                    (cudaStream_t)stream);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// MT: m-tiles of 16 rows a block (ops/lstm.chain_plan); counters hold
// ceil(B / 16) zeros
template <typename T>
int launch_bwd_recur(const float* gates, const float* cst, const T* gy, const int* lengths,
                     const T* wh, float* dxw, unsigned int* counters, int Tn, int B, int H, int MT,
                     float forget_bias, void* stream) {
  if (Tn <= 0 || B <= 0) return 0;
  if (H <= 0) return (int)cudaErrorInvalidValue;
  if (MT == 1)
    return launch_bwd_recur_mt<T, 1>(gates, cst, gy, lengths, wh, dxw, counters, Tn, B, H,
                                     forget_bias, stream);
  if (MT == 2)
    return launch_bwd_recur_mt<T, 2>(gates, cst, gy, lengths, wh, dxw, counters, Tn, B, H,
                                     forget_bias, stream);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// the walk (units U and m-tiles MT a block from ops/lstm.walk_plan): the
// training variant when g_out is given (then c_out and h_out too), with the
// step probe when probe is; c0 may be null (zeros), h0 sits in hx's slot 0
extern "C" int nabu_lstm_fwd_bf16(const void* xw, const int* lengths, const void* wh,
                                  const float* c0, void* y, float* hx, float* h_last,
                                  float* c_last, unsigned int* counters, float* g_out,
                                  float* c_out, float* h_out, unsigned long long* probe, int T,
                                  int B, int H, int units, int mt, float forget_bias,
                                  void* stream) {
  const WalkArgs a{xw,    lengths, wh,    c0,    y, hx, h_last, c_last, counters,
                   g_out, c_out,   h_out, probe, T, B,  H,      0,      0,        forget_bias};
  return launch_walk<bf16>(a, units, mt, stream);
}

extern "C" int nabu_lstm_fwd_f32(const void* xw, const int* lengths, const void* wh,
                                 const float* c0, void* y, float* hx, float* h_last,
                                 float* c_last, unsigned int* counters, float* g_out,
                                 float* c_out, float* h_out, unsigned long long* probe, int T,
                                 int B, int H, int units, int mt, float forget_bias,
                                 void* stream) {
  const WalkArgs a{xw,    lengths, wh,    c0,    y, hx, h_last, c_last, counters,
                   g_out, c_out,   h_out, probe, T, B,  H,      0,      0,        forget_bias};
  return launch_walk<float>(a, units, mt, stream);
}

extern "C" int nabu_lstm_bwd_recur_bf16(const float* gates, const float* cst, const void* gy,
                                        const int* lengths, const void* wh, float* dxw,
                                        unsigned int* counters, int T, int B, int H, int mt,
                                        float forget_bias, void* stream) {
  return launch_bwd_recur<bf16>(gates, cst, (const bf16*)gy, lengths, (const bf16*)wh, dxw,
                                counters, T, B, H, mt, forget_bias, stream);
}

extern "C" int nabu_lstm_bwd_recur_f32(const float* gates, const float* cst, const void* gy,
                                       const int* lengths, const void* wh, float* dxw,
                                       unsigned int* counters, int T, int B, int H, int mt,
                                       float forget_bias, void* stream) {
  return launch_bwd_recur<float>(gates, cst, (const float*)gy, lengths, (const float*)wh, dxw,
                                 counters, T, B, H, mt, forget_bias, stream);
}
