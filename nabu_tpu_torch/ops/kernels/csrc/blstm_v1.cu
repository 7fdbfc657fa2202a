// Bidirectional LSTM layer, v1 kernel family, for Hopper (sm_90a): the
// walks and the backward chain that hold the widths the v2 family of
// blstm.cu cannot (a Listener of 512 units at B = 64).
//
// Replaces the TPU kernels of nabu_tpu/ops/pallas/blstm.py that
// blstm_tm_apply reaches through blstm_apply_fused_v1 when the v2
// backward's VMEM estimate is over budget:
// - row 4, blstm_fused_forward (:123, pallas_call :162, _blstm_kernel
//   :73): both directions' masked walks over a precomputed xw, h in the
//   compute type, f32 c, masked h written only -> blstm_v1_recur;
// - row 5, _fused_fwd (:388, pallas_call :408, _fwd_train_kernel :213):
//   the same walk also storing, per step, the post-mask h (compute type)
//   and c (f32) -> blstm_v1_recur_train;
// - row 6, _fused_bwd (:463, pallas_call :509, _bwd_train_kernel :257):
//   the gates recomputed from the stored carries as one batched product
//   xw + hprev @ wh (prep, :299-314), the serial chain dgates @ wh^T
//   (direction, :316-344), dwh accumulated in f32 (accum_dwh, :358-363).
//   The chain is blstm_v1_bwd_recur here; the recompute and dwh are
//   launches of blstm.cu's GEMM (kinds 3 and 2), under their own names.
//
// (a) blstm_v1_walk: one cooperative persistent launch walks the whole
//     sequence for both directions; the backward direction walks time
//     descending, so no flipped copy of xw exists. Bound on the H100 at
//     las_large's bottom layer (T = 1024, B = 64, H = 512, both
//     directions): h @ wh is 275 GFLOP, 0.28 ms of bf16 tensor rate; the
//     bytes (xw read, h and c stored) ~0.94 GB, 0.28 ms. The pace is set
//     by T dependent steps, each a [B, H] x [H, 4H] product a direction,
//     the cell and a hand-off of h, not by either. Rows of the batch are
//     independent in the walk. Design (the v2 and LSTM walks' of blstm.cu
//     (b) and lstm.cu, carried over): block (dir, rg, ug) owns 16 MT rows
//     x U units of one direction, 512 or 1024 cells, 2 or 4 a thread (U x
//     MT = 32 x 1, 16 x 2, 8 x 4 or 16 x 4, from ops/blstm_v1.walk_plan:
//     the first whose 2 ceil(B / 16 MT) ceil(H / U) blocks are co-resident
//     one an SM with their shared memory in the element type; at B = 64,
//     H = 512 128 blocks, bf16 32 x 1, f32 16 x 2). It keeps its units'
//     four gate columns of wh in shared
//     memory for the whole walk and c and h of its cells in registers, and
//     meets only the ceil(H / U) blocks of its (direction, row group), at
//     a counter of their own: a release add after a block barrier to
//     arrive, an acquire load then a block barrier to wait (no further
//     fence). The step's xw is fetched before the wait and held as loaded
//     (widening it at the load made the LSTM walk's cell wait). After the
//     wait the block pulls only its own rows of h_{t-1} from the exchange
//     (ld.cg straight into registers, every load in flight at once) and
//     forms the gates' h-part in f32:
//     - bf16 on tensor cores: h and wh are exact bf16 values, so one
//       mma.sync m16n8k16 pass with f32 accumulators is the reference's
//       product. The 8 warps split K = H into chunks of 32 (two a warp at
//       H = 512), each runs its chunks for the block's 16 MT rows x 4U
//       columns (wh's columns staged once as B fragments, 128 KB at U =
//       32; h's 16-byte loads are the A fragments), MW m-tiles a pass (64
//       accumulators), and stores its partial sums; after a block barrier
//       each thread adds its cells' 4 gates over the warps in warp order
//       (its cells run units fastest);
//     - f32 on the FMA pipes (no TF32: the 1e-4 check), register-blocked:
//       a half warp owns 4 rows x 4 units' 4 gates a tile (P tiles in
//       turn), its 16 lanes take the quads ks + 16 p of K, and a
//       reduce-scatter of shuffles over the half warp adds the 16 K slices
//       and leaves each lane the 4 gates of its cell.
//     Both sum each output in an order set by H alone: a second launch
//     repeats the bits, every form gives the same bits, and a row alone
//     equals the same row in a batch. Then the masked cell of _cell
//     (:53-70): f32 gates and c, h in the compute type; padding frames
//     hold h and c and output zeros. The carried h goes to the exchange,
//     the block arrives (the release waits for those stores alone), then
//     y and (training) the stores.
//     The exchange is a buffer of its own in both walks, [2 directions][2
//     slots][B][ceil8(H)] of the carried h (rows of whole 16-byte loads,
//     the padding zero: H = 9 and 12 in the tests). The slots ping-pong: a
//     block writes slot (s + 1) % 2 at step s only after its counter showed
//     every block of its group arrived s times, and a block arrives at
//     step s - 1 only after its loads of that step's slot were consumed.
//     The training walk stores the post-mask carries after its arrival as
//     hs [2, T + 1, B, H], with a zero slot at each direction's start (fw
//     slot 0, bw slot T), so row t of direction d's "hprev" is one
//     contiguous [T, B, H] matrix for the backward's two products (lda =
//     H), and c [2, T, B, H] f32. A third build, launched only by the step
//     probe, sums each block's clock64 cycles a step by wait, pull,
//     product and cell.
//     Where it was hard: H = 512 at B = 64 is past the v2 walk's 256
//     cells a block (256 blocks), so a block here holds 2 or 4 cells a
//     thread: the bf16 product runs its m-tiles in passes to stay within
//     the registers beside the A fragments. f32's wh at 32 x 1 takes 4 U H
//     4 bytes = 256 KB, past a block's 227 KB, while bf16's 32 x 1 (16 rows
//     pulled a block, 16 blocks a counter) is its fastest form there, so
//     the plan takes the element type. The cell's time was set by the
//     number of its scattered 2-byte loads and stores, not their latency:
//     f32's cell map spreads a warp over 8 rows, so bf16's cells, free of
//     the reduce-scatter, run units fastest (a warp on 1 to 4 rows). The
//     earlier design (every block all 64 rows x 8 units, h restaged
//     through shared memory in K tiles with two block barriers a tile, an
//     FFMA product, a fenced grid-wide barrier over the direction) ran ~29
//     us a step; this one ~4 (PERF.md, rows 4 and 5).
//
// (b) blstm_v1_bwd_recur: the backward's serial chain, one cooperative
//     persistent launch for both directions. The fw direction walks time
//     descending, the bw direction ascending. Each step computes dh_prev =
//     dgates_prev @ wh^T, then the masked cell backward of
//     _bwd_train_kernel's direction() from the recomputed f32 gates and
//     the stored carries; dh and dc are carried in f32, the dgates are
//     cast to the compute type before they are stored (and so before the
//     chain product reads them, :337-344). The rows of the batch are
//     independent in the chain, so a block owns 16 MT rows x U units
//     (bf16: U = 32, f32: U = 8), keeps wh's rows of its units in shared
//     memory for the whole launch (bf16: 128 KB at H = 512, in the order
//     the B fragments read them), and meets only the ceil(H / U) blocks of
//     its rows at its own counter. MT (1 or 2 in bf16, up to 8 in f32) is
//     the least that keeps every block co-resident: 16 rows x 32 units,
//     128 blocks at las_large's B = 64, H = 512.
//     Bound at that shape: 275 GFLOP of the chain product (0.28 ms of
//     bf16 tensor rate) and ~1.6 GB of gates, carries and dgates, 0.48 ms
//     by bytes; the pace is set by T dependent steps. A step of the earlier
//     design (every block all 64 rows x 8 units) pulled the whole previous
//     dgates [B, 4H] (256 KB) in 8 serial L2 round trips restaged in f32,
//     ran the product on the FMA pipes out of shared memory and read the
//     cell's operands after it: ~60 us. Now, after the barrier, a block
//     pulls its own 16 rows once (64 KB in bf16, every 16-byte load of
//     the step in flight at once, ld.global.cg straight into mma A
//     fragments), the 8 warps split K and run mma.sync m16n8k16 (bf16 in,
//     f32 accumulators), and their partial sums are added in warp order (a
//     launch repeats its bits); the cell's own operands of step s + 1 were
//     fetched before the step-s barrier ended. The f32 instantiation (the
//     tight check, 1e-4: no TF32) runs the same split with an FFMA
//     product from chunks staged per warp.
//
// Limits of the design (ops/blstm_v1.check_design raises before any
// launch beyond them): B <= 128, the batches the forms are sized for; walk
// (ops/blstm_v1.walk_plan): 2 ceil(B / 16 MT) ceil(H / U) blocks of one
// form one an SM on the card's 132 SMs, shared memory (walk_bytes, in the
// element type) within 227 KB, bf16 H <= 512 (the A fragments of 2 K
// chunks a warp); 16 x 4 holds every B <= 128 at H <= 528. Chain
// (ops/blstm_v1.chain_plan): bf16 H <= 512 (the A fragments of 8 K chunks
// a warp), 2 ceil(B / 16 MT) ceil(H / U) blocks of one an SM on the
// card's 132 SMs, shared memory (chain_bytes) within 227 KB. The launches
// are cooperative, so the runtime also refuses them unless every block is
// co-resident (a spin barrier over blocks that are not would deadlock).
//
// Element types: __nv_bfloat16 (the training and serving path) and float
// (to check the card tightly).

#include "serial.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int MROWS = 16;    // rows of an m-tile (mma m16n8k16); a block owns 16 MT rows
constexpr int MAX_B = 128;   // the batches the forms are sized for (16 x 4 holds every H <= 528)

// ---------------------------------------------------------------------------
// (a) the walk (rows 4 and 5)
// ---------------------------------------------------------------------------

constexpr int W_KS = 16;    // f32: K slices of a step's product, the lanes of a half warp
constexpr int W_NQ = 5;     // f32: quads of h a K slice loads a pass
constexpr int W_MAXC = 2;   // bf16: K chunks of 32 a warp holds at most (H <= 512)

// the exchange's row stride: H rounded up to whole 16-byte vectors of bf16
__host__ __device__ inline int walk_xp(int H) { return (H + 7) / 8 * 8; }
// bf16: K chunks of 32 (two mma k16 steps), and the warps' partial sums'
// row stride (float2 stores of a fragment free of bank conflicts)
__host__ __device__ inline int walk_chunks(int H) { return (H + 31) / 32; }
__host__ __device__ constexpr int walk_pst(int U) { return 4 * U + 8; }

// a form of U units x 16 MT rows a block: P cell pairs a thread (2 or 4);
// bf16 forms the product in passes of MW m-tiles (64 f32 accumulators)
template <int U, int MT>
struct WalkForm {
  static constexpr int R = MROWS * MT;
  static constexpr int P = R * U / THREADS;
  static constexpr int MW = MT < 32 / U ? MT : 32 / U;
  static_assert(U % 4 == 0 && P >= 1 && R * U == P * THREADS && MT % MW == 0,
                "tiles of 4 x 4, whole cell pairs a thread, whole passes");
};

// shared memory of a walk block of U units and 16 MT rows. f32: the four
// gate columns of wh of its units, [4 U][ceil4(H)]; bf16: the same columns
// as B fragments, [chunk][n-tile][lane] of 16 bytes, then the warps'
// partial sums [8][16 MT][4 U + 8] f32
template <typename T>
inline size_t walk_bytes(int H, int U, int MT) {
  if (sizeof(T) == 4) return sizeof(float) * 4 * (size_t)U * ((H + 3) / 4 * 4);
  return (size_t)walk_chunks(H) * (U / 2) * 32 * sizeof(uint4) +
         sizeof(float) * WARPS * MROWS * MT * walk_pst(U);
}

// bf16: wh's gate columns of the block's units j0 + [0, U) in the order the
// B fragments read them: uint4 (c, nt, lane) holds column n = 8 nt + lane /
// 4 (unit n / 4, gate n % 4) at k = 32 c + 8 (lane % 4) + [0, 8), zero past
// H. The A fragments take the same 8 k of their rows (the k order inside a
// chunk is a permutation both operands share), so one 16-byte load of h
// serves two k16 steps of one row. Read in wh's order (units fastest), so a
// warp's loads fall on a few rows of wh.
template <int U>
__device__ void stage_walk_wh(const bf16* whd, int j0, int H, unsigned char* smem) {
  constexpr int NT = U / 2;
  unsigned short* w = reinterpret_cast<unsigned short*>(smem);
  const unsigned short* src = reinterpret_cast<const unsigned short*>(whd);
  const int H4 = 4 * H, n_all = walk_chunks(H) * 32 * 4 * U;
  for (int i = threadIdx.x; i < n_all; i += THREADS) {
    const int u = i % U, g = i / U % 4, k = i / (4 * U);
    const int n = 4 * u + g, kk = k & 31, lane = (n & 7) * 4 + (kk >> 3);
    w[((((size_t)(k >> 5) * NT + (n >> 3)) * 32 + lane) << 3) + (kk & 7)] =
        (k < H && j0 + u < H) ? src[(size_t)k * H4 + g * H + j0 + u] : (unsigned short)0;
  }
}

// f32: w_s[(4 u + g) HP + k] = wh[k, g H + j0 + u], HP = ceil4(H), read
// with u fastest
template <int U>
__device__ void stage_walk_wh(const float* whd, int j0, int H, unsigned char* smem) {
  float* w_s = reinterpret_cast<float*>(smem);
  const int HP = (H + 3) / 4 * 4, H4 = 4 * H;
  for (int i = threadIdx.x; i < 4 * U * HP; i += THREADS) {
    const int k = i / (4 * U), g = i / U % 4, u = i % U;
    w_s[(4 * u + g) * HP + k] = (k < H && j0 + u < H) ? whd[(size_t)k * H4 + g * H + j0 + u] : 0.f;
  }
}

// bf16 step product on tensor cores: z[p][g] = the h-part of gate g of the
// thread's cell pair p (local row pr[p], unit pu[p]). h and wh are exact
// bf16 values, so one mma.sync m16n8k16 pass with f32 accumulators forms
// the reference's product. The warps split K by H alone: warp w takes
// chunks [w cpw, (w + 1) cpw) of 32 k and issues every 16-byte load of
// its A fragments (those chunks of the block's 16 MT rows of h_{t-1}) at
// once (ld.cg, straight into registers); then, MW m-tiles a pass, it runs
// mma.sync over them in chunk order into f32 accumulators (16 MW rows x 4U
// columns) and stores its partial sums; after a block barrier each thread
// adds its cell pairs' 4 gates over the warps in warp order.
template <int U, int MT, bool PROBE>
__device__ __forceinline__ void walk_product(const bf16* hin, int xp, int row0, int B, int H,
                                             unsigned char* smem, const int* pr, const int* pu,
                                             float (*z)[4], unsigned long long* spent,
                                             unsigned long long& stamp) {
  using F = WalkForm<U, MT>;
  constexpr int NT = U / 2, PST = walk_pst(U), MW = F::MW, R = F::R;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t4 = lane & 3;
  const int nch = walk_chunks(H), cpw = (nch + WARPS - 1) / WARPS, c0 = warp * cpw;
  uint4 a[W_MAXC][MT][2];
#pragma unroll
  for (int i = 0; i < W_MAXC; ++i)
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = row0 + MROWS * mt + 8 * h + g, col = 32 * (c0 + i) + 8 * t4;
        a[i][mt][h] = (i < cpw && c0 + i < nch && r < B && col < xp)
                          ? __ldcg(reinterpret_cast<const uint4*>(hin + (size_t)r * xp + col))
                          : make_uint4(0u, 0u, 0u, 0u);
      }
  if constexpr (PROBE) {
    // the pull ends where its values are first used
    unsigned int bits = 0u;
#pragma unroll
    for (int i = 0; i < W_MAXC; ++i)
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int h = 0; h < 2; ++h)
          bits ^= a[i][mt][h].x ^ a[i][mt][h].y ^ a[i][mt][h].z ^ a[i][mt][h].w;
    if (bits == 0x9e3779b9u) spent[0] += 1;  // a use the compiler cannot drop
    __syncthreads();
    probe_stamp<PROBE>(spent, 1, stamp);
  }
  const uint4* wb = reinterpret_cast<const uint4*>(smem);
  float* part = reinterpret_cast<float*>(smem + (size_t)nch * NT * 32 * sizeof(uint4));
#pragma unroll
  for (int m0 = 0; m0 < MT; m0 += MW) {
    float acc[MW][NT][4];
#pragma unroll
    for (int m = 0; m < MW; ++m)
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[m][nt][q] = 0.f;
#pragma unroll
    for (int i = 0; i < W_MAXC; ++i) {
      if (i < cpw && c0 + i < nch) {
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
          const uint4 b = wb[((c0 + i) * NT + nt) * 32 + lane];
#pragma unroll
          for (int m = 0; m < MW; ++m) {
            const uint4 lo = a[i][m0 + m][0], hi = a[i][m0 + m][1];  // rows g, g + 8
            mma_16816(acc[m][nt], lo.x, hi.x, lo.y, hi.y, b.x, b.y);
            mma_16816(acc[m][nt], lo.z, hi.z, lo.w, hi.w, b.z, b.w);
          }
        }
      }
    }
    if (c0 < nch) {
      float* pw = part + (size_t)warp * R * PST;
#pragma unroll
      for (int m = 0; m < MW; ++m)
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
          float* p = pw + (size_t)(MROWS * (m0 + m) + g) * PST + 8 * nt + 2 * t4;
          *reinterpret_cast<float2*>(p) = make_float2(acc[m][nt][0], acc[m][nt][1]);
          *reinterpret_cast<float2*>(p + 8 * PST) = make_float2(acc[m][nt][2], acc[m][nt][3]);
        }
    }
  }
  __syncthreads();
  const int warps = (nch + cpw - 1) / cpw;  // the warps that hold a chunk
#pragma unroll
  for (int k = 0; k < F::P; ++k) {
    float4 sum = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int w = 0; w < warps; ++w) {
      const float4 p = *reinterpret_cast<const float4*>(part + ((size_t)w * R + pr[k]) * PST +
                                                        4 * pu[k]);
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

// f32 step product on the FMA pipes (the tight check: no TF32) of tile x
// (rows 4 (x % 4 MT) + [0, 4), units 4 (x / 4 MT) + [0, 4) of the block,
// their 4 gates: 16 columns of wh): lane ks = lane % 16 of its half warp
// takes the quads ks + 16 p of h_{t-1} (ld.cg straight into registers,
// every load of a pass in flight at once) and sums the tile's 4 rows x 16
// columns over them (a quad of h feeds 16 columns, a float4 of wh 4 rows);
// a reduce-scatter of shuffles over the half warp adds the 16 K slices in
// a fixed order and leaves lane ks the 4 gates of row 4 (x % 4 MT) + ks /
// 4, unit 4 (x / 4 MT) + ks % 4 in z.
template <int MT, bool PROBE>
__device__ __forceinline__ void walk_product_f32(const float* hin, int xp, int x, int row0,
                                                 int B, int H, const unsigned char* smem,
                                                 float* z, unsigned long long* spent,
                                                 unsigned long long& stamp) {
  const int HQ = (H + 3) / 4;
  const int lane = threadIdx.x & 31, ks = lane & 15;
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
          const float4 w = w4[(size_t)col * HQ + q];
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            float& acc = v[16 * i + col];
            acc = fmaf(hq[i][p].x, w.x, acc);
            acc = fmaf(hq[i][p].y, w.y, acc);
            acc = fmaf(hq[i][p].z, w.z, acc);
            acc = fmaf(hq[i][p].w, w.w, acc);
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

struct WalkArgs {
  const void* xw;             // [2, T, B, 4H], both directions in natural time
  const int* lengths;         // [B]
  const void* wh;             // [2, H, 4H]
  void* y;                    // [T, B, 2H] masked outputs
  void* hx;                   // exchange: [2 dir][2 slot][B][walk_xp(H)], zero at launch
  void* hs;                   // STORE: [2, T + 1, B, H] post-mask h carries
  float* c_out;               // STORE: [2, T, B, H] post-mask c
  unsigned int* counters;     // [2, RG], zero at launch
  unsigned long long* probe;  // PROBE: [blocks][4] cycles
  int Tn, B, H, RG, GU;
  float forget_bias;
};

// Block (dir, rg, ug) owns rows rg 16 MT + [0, 16 MT) and units ug U + [0,
// U) of direction dir; rows are independent in the walk, so the blocks of
// one (direction, row group) meet at their own counter each step. Thread
// p runs P cell pairs, with their c and h carries in registers: in f32
// those of tiles x = p / 16 + 16 k, k < P, at lane ks = p % 16 (where the
// product's reduce-scatter leaves its 4 gates), row 4 (x % 4 MT) + ks / 4,
// unit 4 (x / 4 MT) + ks % 4; in bf16 (any cell reads its partial sums)
// cell p + 256 k, units fastest, which cuts a warp's scattered 2-byte
// loads of xw and stores of h, y and c to 1 to 4 rows (8 in f32's map).
// PROBE: thread 0 sums the clock64 cycles of each
// step after the first spent waiting, pulling (to the loads' first use),
// multiplying (to the gates' sums) and in the cell (to the next step's
// start) into probe[block][4], with a block barrier after the pull and
// after the product.
template <typename T, bool STORE, bool PROBE, int U, int MT>
__global__ void __launch_bounds__(THREADS, 1) v1_walk_kernel(WalkArgs a) {
  using F = WalkForm<U, MT>;
  constexpr int P = F::P;
  extern __shared__ __align__(16) float smem_f[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(smem_f);
  const T* __restrict__ xw = static_cast<const T*>(a.xw);
  T* __restrict__ y = static_cast<T*>(a.y);
  const int Tn = a.Tn, B = a.B, H = a.H, H4 = 4 * H, xp = walk_xp(H);
  const size_t BH = (size_t)B * H;
  const int dir = blockIdx.x / (a.RG * a.GU);
  const int rg = blockIdx.x / a.GU % a.RG, ug = blockIdx.x % a.GU;
  const int j0 = ug * U, row0 = rg * F::R;
  unsigned int* cnt = a.counters + dir * a.RG + rg;
  stage_walk_wh<U>(static_cast<const T*>(a.wh) + (size_t)dir * H * H4, j0, H, smem);

  // the cell pairs of this thread, with their carries
  const int ks = threadIdx.x & 15;
  int px[P], pr[P], pu[P], pb[P], pj[P], len[P];
  bool live[P];
  float c[P];
  T h[P];
  T xg[P][4];  // held as loaded: widening them here would wait for the loads
#pragma unroll
  for (int k = 0; k < P; ++k) {
    if constexpr (sizeof(T) == 2) {
      // units fastest, so a warp's loads and stores run along 1 to 4 rows
      pr[k] = (threadIdx.x + THREADS * k) / U;
      pu[k] = (threadIdx.x + THREADS * k) % U;
    } else {
      px[k] = (threadIdx.x >> 4) + (THREADS / 16) * k;
      pr[k] = 4 * (px[k] % (4 * MT)) + (ks >> 2);
      pu[k] = 4 * (px[k] / (4 * MT)) + (ks & 3);
    }
    pb[k] = row0 + pr[k];
    pj[k] = j0 + pu[k];
    live[k] = pb[k] < B && pj[k] < H;
    len[k] = live[k] ? __ldg(a.lengths + pb[k]) : 0;
    c[k] = 0.f;
    h[k] = from_f<T>(0.f);
#pragma unroll
    for (int g = 0; g < 4; ++g) xg[k][g] = from_f<T>(0.f);
  }
  const T* xwd = xw + (size_t)dir * Tn * B * H4;
  T* hxd = static_cast<T*>(a.hx) + (size_t)dir * 2 * B * xp;
  T* hsd = STORE ? static_cast<T*>(a.hs) + (size_t)dir * (Tn + 1) * BH : nullptr;
  if constexpr (STORE) {
    // the zero slot each direction starts from (fw slot 0, bw slot T),
    // read by the backward's products
#pragma unroll
    for (int k = 0; k < P; ++k)
      if (live[k])
        hsd[(size_t)(dir == 0 ? 0 : Tn) * BH + (size_t)pb[k] * H + pj[k]] = from_f<T>(0.f);
  }
  // the cells' input of step s: it does not depend on the walk, so it is
  // fetched before the wait that precedes step s ends
  auto fetch = [&](int s) {
    const int t = dir == 0 ? s : Tn - 1 - s;
#pragma unroll
    for (int k = 0; k < P; ++k) {
      if (!live[k]) continue;
      const T* xr = xwd + ((size_t)t * B + pb[k]) * H4 + pj[k];
#pragma unroll
      for (int g = 0; g < 4; ++g) xg[k][g] = __ldg(xr + (size_t)g * H);
    }
  };
  fetch(0);
  __syncthreads();
  unsigned long long spent[4] = {0ull, 0ull, 0ull, 0ull};
  unsigned long long stamp = 0ull;

  for (int s = 0; s < Tn; ++s) {
    const int t = dir == 0 ? s : Tn - 1 - s;
    float zh[P][4];  // the h-part of the cell pairs' gates (h_{-1} = 0)
#pragma unroll
    for (int k = 0; k < P; ++k)
#pragma unroll
      for (int g = 0; g < 4; ++g) zh[k][g] = 0.f;
    if (s > 0) {
      if constexpr (PROBE) {
        const unsigned long long now = clock64();
        if (s > 1) spent[3] += now - stamp;
        stamp = now;
      }
      // wait until every block of this (direction, row group) has
      // published step s - 1: an acquire load, then the block barrier
      if (threadIdx.x == 0) {
        const unsigned int target = (unsigned int)s * (unsigned int)a.GU;
        while (ld_acquire(cnt) < target) {
        }
      }
      __syncthreads();
      probe_stamp<PROBE>(spent, 0, stamp);
      const T* hin = hxd + (size_t)(s & 1) * B * xp;
      if constexpr (sizeof(T) == 2) {
        walk_product<U, MT, PROBE>(hin, xp, row0, B, H, smem, pr, pu, zh, spent, stamp);
      } else {
#pragma unroll
        for (int k = 0; k < P; ++k)
          walk_product_f32<MT, PROBE>(hin, xp, px[k], row0, B, H, smem, zh[k], spent, stamp);
      }
    }

    // the masked cell (_cell): gates and c in f32, h in the compute type
    T* hout = hxd + (size_t)((s + 1) & 1) * B * xp;
    T y_t[P];
#pragma unroll
    for (int k = 0; k < P; ++k) {
      y_t[k] = from_f<T>(0.f);
      if (!live[k]) continue;
      const float gi = sigmoid_f(to_f(xg[k][0]) + zh[k][0]);
      const float gf = sigmoid_f(to_f(xg[k][1]) + zh[k][1] + a.forget_bias);
      const float gg = tanhf(to_f(xg[k][2]) + zh[k][2]);
      const float go = sigmoid_f(to_f(xg[k][3]) + zh[k][3]);
      const float c_new = gf * c[k] + gi * gg;
      const T h_new = from_f<T>(go * tanhf(c_new));
      // masked carry: padding frames keep c and h; y is zero there
      if (t < len[k]) {
        c[k] = c_new;
        h[k] = h_new;
        y_t[k] = h_new;
      }
      if (s + 1 < Tn) hout[(size_t)pb[k] * xp + pj[k]] = h[k];
    }
    if (s + 1 < Tn) {
      // publish this step's h to the (direction, row group): the block
      // barrier, then a release add, which waits for the exchange's stores
      // alone (the outputs' follow)
      __syncthreads();
      if (threadIdx.x == 0) red_release(cnt);
    }
#pragma unroll
    for (int k = 0; k < P; ++k) {
      if (!live[k]) continue;
      y[((size_t)t * B + pb[k]) * 2 * H + (size_t)dir * H + pj[k]] = y_t[k];
      if constexpr (STORE) {
        // fw: slot t + 1 holds the carry leaving step t; bw: slot t
        hsd[(size_t)(dir == 0 ? t + 1 : t) * BH + (size_t)pb[k] * H + pj[k]] = h[k];
        a.c_out[(((size_t)dir * Tn + t) * B + pb[k]) * H + pj[k]] = c[k];
      }
    }
    // the next step's input, fetched while the other blocks catch up
    if (s + 1 < Tn) fetch(s + 1);
  }
  if constexpr (PROBE) {
    if (threadIdx.x == 0) {
      if (Tn > 1) spent[3] += clock64() - stamp;
#pragma unroll
      for (int k = 0; k < 4; ++k) a.probe[(size_t)blockIdx.x * 4 + k] = spent[k];
    }
  }
}

// ---------------------------------------------------------------------------
// (b) the backward chain (row 6)
// ---------------------------------------------------------------------------

constexpr int MAX_CHUNKS = 8;      // bf16: K chunks a warp at most (4H <= 8 x 8 x 32)
constexpr int STAGE_LD = 20;       // f32: row stride of a warp's staged K chunk

// the chain's split of a block by element type: U units, the exchanged
// rows pulled in K chunks of KC columns, the warps' partial sums [R][PST]
template <typename T>
struct Chain;
template <>
struct Chain<bf16> {
  static constexpr int U = 32;       // 4 n-tiles of 8
  static constexpr int KC = 32;      // two k16 steps
  static constexpr int PST = U + 8;  // float2 stores of a fragment free of bank conflicts
  static constexpr int MAX_MT = 2;
  static constexpr int MAX_NCH = WARPS * MAX_CHUNKS;  // the A fragments the warps hold
};
template <>
struct Chain<float> {
  static constexpr int U = 8;
  static constexpr int KC = 16;
  static constexpr int PST = U;
  static constexpr int MAX_MT = 8;
  static constexpr int MAX_NCH = 1 << 20;  // staged chunk by chunk: shared memory bounds H
};

__host__ __device__ inline int chain_chunks(int H, int kc) { return (4 * H + kc - 1) / kc; }
// f32: row stride of wh in shared memory (= 4 mod 32: float4 reads of the
// 8 units free of bank conflicts)
__host__ __device__ inline int chain_wld(int H) {
  return (chain_chunks(H, 16) * 16 + 31) / 32 * 32 + 4;
}
// shared memory of one block, in bytes: wh of the block's units, (f32)
// the warps' staged K chunks, the warps' partial sums
inline size_t chain_bytes(bf16, int MT, int H) {
  return (size_t)chain_chunks(H, Chain<bf16>::KC) * 4 * 32 * sizeof(uint4) +
         sizeof(float) * WARPS * MROWS * MT * Chain<bf16>::PST;
}
inline size_t chain_bytes(float, int MT, int H) {
  const size_t R = (size_t)MROWS * MT;
  return sizeof(float) * ((size_t)Chain<float>::U * chain_wld(H) + WARPS * R * STAGE_LD +
                          WARPS * R * Chain<float>::PST);
}

// 8 consecutive bf16 of an exchanged row from L2, zeros past n; one
// 16-byte load where rows are whole vectors
__device__ __forceinline__ uint4 load8_cg(const bf16* row, int col, int n, bool vec) {
  if (vec) {
    return col < n ? __ldcg(reinterpret_cast<const uint4*>(row + col)) : make_uint4(0, 0, 0, 0);
  }
  const unsigned short* r = reinterpret_cast<const unsigned short*>(row);
  unsigned int w[4];
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const int c = col + 2 * q;
    const unsigned int lo = c < n ? __ldcg(r + c) : 0u;
    const unsigned int hi = c + 1 < n ? __ldcg(r + c + 1) : 0u;
    w[q] = lo | (hi << 16);
  }
  return make_uint4(w[0], w[1], w[2], w[3]);
}

// bf16: wh rows of the block's units j0 + [0, 32) in the order the B
// fragments read them: uint4 (c, nt, lane) holds wh[j0 + 8 nt + lane / 4]
// [32 c + 8 (lane % 4), + 8), zero past H and 4H. The A fragments take
// the same 8 columns of their rows (the k order inside a chunk is a
// permutation both operands share), so one 16-byte load serves two k16
// steps of one row.
__device__ void stage_wh(const bf16* whd, int j0, int H, int nch, unsigned char* smem) {
  unsigned short* w = reinterpret_cast<unsigned short*>(smem);
  const unsigned short* src = reinterpret_cast<const unsigned short*>(whd);
  const int H4 = 4 * H;
  for (int e = threadIdx.x; e < nch * 4 * 32 * 8; e += blockDim.x) {
    const int q = e & 7, lane = (e >> 3) & 31, nt = (e >> 8) & 3, c = e >> 10;
    const int unit = j0 + 8 * nt + (lane >> 2), col = 32 * c + 8 * (lane & 3) + q;
    w[e] = (unit < H && col < H4) ? src[(size_t)unit * H4 + col] : (unsigned short)0;
  }
}

// f32: wh rows of the block's units j0 + [0, 8), [8][chain_wld(H)]
__device__ void stage_wh(const float* whd, int j0, int H, int, unsigned char* smem) {
  float* w = reinterpret_cast<float*>(smem);
  const int H4 = 4 * H, ld = chain_wld(H);
  for (int e = threadIdx.x; e < Chain<float>::U * ld; e += blockDim.x) {
    const int u = e / ld, k = e - u * ld;
    w[e] = (j0 + u < H && k < H4) ? whd[(size_t)(j0 + u) * H4 + k] : 0.f;
  }
}

__device__ __forceinline__ float* chain_part(bf16, unsigned char* smem, int H, int MT) {
  return reinterpret_cast<float*>(smem + (size_t)chain_chunks(H, Chain<bf16>::KC) * 4 * 32 *
                                             sizeof(uint4));
}
__device__ __forceinline__ float* chain_part(float, unsigned char* smem, int H, int MT) {
  return reinterpret_cast<float*>(smem) + (size_t)Chain<float>::U * chain_wld(H) +
         (size_t)WARPS * MROWS * MT * STAGE_LD;
}

// bf16 step product on tensor cores: the block's rows row0 + [0, 16 MT)
// of the previous step's dgates (prev, [B, 4H]) times wh^T of its units.
// The warps split K: warp w takes chunks [w cpw, (w + 1) cpw) of 32
// columns, issues every 16-byte load of its A fragments at once (ld.cg,
// straight into registers), then runs mma.sync m16n8k16 over them in
// chunk order into f32 accumulators, and stores its partial [16 MT, 32]
// sums; the block adds the 8 partials in warp order.
template <int MT>
__device__ __forceinline__ void chain_product(const bf16* prev, int row0, int B, int H,
                                              unsigned char* smem) {
  constexpr int PST = Chain<bf16>::PST;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t4 = lane & 3;
  const int H4 = 4 * H;
  const int nch = chain_chunks(H, Chain<bf16>::KC);
  const int cpw = (nch + WARPS - 1) / WARPS;
  const int c0 = warp * cpw;
  const bool vec = (H4 & 7) == 0;
  uint4 a[MAX_CHUNKS][MT][2];
#pragma unroll
  for (int i = 0; i < MAX_CHUNKS; ++i)
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = row0 + MROWS * mt + 8 * h + g;
        a[i][mt][h] = (i < cpw && c0 + i < nch && r < B)
                          ? load8_cg(prev + (size_t)r * H4, 32 * (c0 + i) + 8 * t4, H4, vec)
                          : make_uint4(0, 0, 0, 0);
      }
  float acc[MT][4][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[mt][nt][q] = 0.f;
  const uint4* whs = reinterpret_cast<const uint4*>(smem);
#pragma unroll
  for (int i = 0; i < MAX_CHUNKS; ++i) {
    if (i < cpw && c0 + i < nch) {
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        const uint4 b = whs[((c0 + i) * 4 + nt) * 32 + lane];
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          const uint4 lo = a[i][mt][0], hi = a[i][mt][1];  // rows g, g + 8
          mma_16816(acc[mt][nt], lo.x, hi.x, lo.y, hi.y, b.x, b.y);
          mma_16816(acc[mt][nt], lo.z, hi.z, lo.w, hi.w, b.z, b.w);
        }
      }
    }
  }
  float* pw = chain_part(bf16(), smem, H, MT) + (size_t)warp * MROWS * MT * PST;
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
      float* p = pw + (size_t)(MROWS * mt + g) * PST + 8 * nt + 2 * t4;
      *reinterpret_cast<float2*>(p) = make_float2(acc[mt][nt][0], acc[mt][nt][1]);
      *reinterpret_cast<float2*>(p + 8 * PST) = make_float2(acc[mt][nt][2], acc[mt][nt][3]);
    }
}

// f32 step product on the FMA pipes (the tight check: no TF32): the warps
// split K as above in chunks of 16 columns; a warp stages a chunk of its
// rows in its own shared rows (the next chunk's loads in flight in
// registers meanwhile), and lane (rg, u) = (lane / 8, lane % 8) sums rows
// rg + 4 i of unit u in k order; then the same partials and warp-order sum.
template <int MT>
__device__ __forceinline__ void chain_product(const float* prev, int row0, int B, int H,
                                              unsigned char* smem) {
  constexpr int R = MROWS * MT;
  constexpr int RL = R / 4;  // rows a lane sums
  constexpr int SL = R / 2;  // staged values a lane loads a chunk
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int rg = lane >> 3, u = lane & 7;
  const int H4 = 4 * H, wld = chain_wld(H);
  const int nch = chain_chunks(H, Chain<float>::KC);
  const int cpw = (nch + WARPS - 1) / WARPS;
  const int c0 = warp * cpw, c1 = min(c0 + cpw, nch);
  const float* whs = reinterpret_cast<const float*>(smem);
  float* st = reinterpret_cast<float*>(smem) + (size_t)Chain<float>::U * wld +
              (size_t)warp * R * STAGE_LD;
  float acc[RL];
#pragma unroll
  for (int i = 0; i < RL; ++i) acc[i] = 0.f;
  float nxt[SL];
  auto fetch = [&](int c) {
#pragma unroll
    for (int i = 0; i < SL; ++i) {
      const int r = row0 + 2 * i + (lane >> 4), col = 16 * c + (lane & 15);
      nxt[i] = (r < B && col < H4) ? __ldcg(prev + (size_t)r * H4 + col) : 0.f;
    }
  };
  if (c0 < c1) fetch(c0);
  for (int c = c0; c < c1; ++c) {
#pragma unroll
    for (int i = 0; i < SL; ++i) st[(2 * i + (lane >> 4)) * STAGE_LD + (lane & 15)] = nxt[i];
    __syncwarp();
    if (c + 1 < c1) fetch(c + 1);
    const float* wr = whs + (size_t)u * wld + 16 * c;
#pragma unroll
    for (int kk = 0; kk < 16; kk += 4) {
      const float4 w = *reinterpret_cast<const float4*>(wr + kk);
#pragma unroll
      for (int i = 0; i < RL; ++i) {
        const float4 x = *reinterpret_cast<const float4*>(st + (rg + 4 * i) * STAGE_LD + kk);
        acc[i] = fmaf(x.x, w.x, acc[i]);
        acc[i] = fmaf(x.y, w.y, acc[i]);
        acc[i] = fmaf(x.z, w.z, acc[i]);
        acc[i] = fmaf(x.w, w.w, acc[i]);
      }
    }
    __syncwarp();  // the chunk is read before the next one is staged
  }
  float* pw = chain_part(float(), smem, H, MT) + (size_t)warp * R * Chain<float>::PST;
#pragma unroll
  for (int i = 0; i < RL; ++i) pw[(rg + 4 * i) * Chain<float>::PST + u] = acc[i];
}

// Block (dir, rg, ug) owns rows rg 16 MT + [0, 16 MT) and units ug U + [0,
// U) of direction dir; rows are independent in the chain, so the blocks of
// one (dir, rg) meet at their own counter each step. A thread owns the
// pairs p = tid + 256 q, (row, unit) = (p / U, p % U), and keeps their dh
// and dc carries in registers.
template <typename T, int MT>
__global__ void __launch_bounds__(THREADS, 1) v1_chain_kernel(
    const float* __restrict__ gates,  // [2, T, B, 4H] recomputed f32 pre-activations
    const float* __restrict__ cst,    // [2, T, B, H] f32 post-mask carries
    const T* __restrict__ gy,         // [T, B, 2H] cotangent of the layer output
    const int* __restrict__ lengths,  // [B]
    const T* __restrict__ wh,         // [2, H, 4H]
    T* dg,                            // [2, T, B, 4H] out; also the exchange
    unsigned int* counters,           // [2, NRG], zero at launch
    int Tn, int B, int H, int NRG, int GU, float forget_bias) {
  using C = Chain<T>;
  constexpr int R = MROWS * MT;
  constexpr int NP = (R * C::U + THREADS - 1) / THREADS;
  extern __shared__ __align__(16) unsigned char chain_smem[];
  unsigned char* smem = chain_smem;
  const int H4 = 4 * H;
  const int ug = blockIdx.x % GU;
  const int rgp = (blockIdx.x / GU) % NRG;
  const int dir = blockIdx.x / (GU * NRG);
  const int j0 = ug * C::U, row0 = rgp * R;
  stage_wh(wh + (size_t)dir * H * H4, j0, H, chain_chunks(H, C::KC), smem);
  __syncthreads();
  const float* part = chain_part(T(), smem, H, MT);

  const size_t dstride = (size_t)Tn * B;  // rows of one direction
  const float* gd = gates + (size_t)dir * dstride * H4;
  const float* cd = cst + (size_t)dir * dstride * H;
  T* dgd = dg + (size_t)dir * dstride * H4;
  unsigned int* cnt = counters + dir * NRG + rgp;

  int pr[NP], pb[NP], pj[NP], len[NP];
  bool live[NP];
  float dh[NP], dc[NP];
  float zi[NP], zf[NP], zg[NP], zo[NP], c_t[NP], c_prev[NP], gyv[NP];
#pragma unroll
  for (int q = 0; q < NP; ++q) {
    const int p = threadIdx.x + THREADS * q;
    pr[q] = p / C::U;
    pb[q] = row0 + pr[q];
    pj[q] = j0 + p % C::U;
    live[q] = p < R * C::U && pb[q] < B && pj[q] < H;
    len[q] = live[q] ? __ldg(lengths + pb[q]) : 0;
    dh[q] = 0.f;
    dc[q] = 0.f;
  }
  // the cell's own operands of step s: none depends on the chain, so they
  // are fetched before the barrier that precedes step s ends
  auto fetch = [&](int s) {
    const int t = dir == 0 ? Tn - 1 - s : s;
    const int t_fprev = dir == 0 ? t - 1 : t + 1;  // the forward recurrence's previous step
#pragma unroll
    for (int q = 0; q < NP; ++q) {
      if (!live[q]) continue;
      const size_t row = (size_t)t * B + pb[q];
      const float* gr = gd + row * H4 + pj[q];
      zi[q] = __ldg(gr);
      zf[q] = __ldg(gr + H);
      zg[q] = __ldg(gr + 2 * (size_t)H);
      zo[q] = __ldg(gr + 3 * (size_t)H);
      c_t[q] = __ldg(cd + row * H + pj[q]);
      c_prev[q] = (t_fprev >= 0 && t_fprev < Tn)
                      ? __ldg(cd + ((size_t)t_fprev * B + pb[q]) * H + pj[q]) : 0.f;
      gyv[q] = to_f(gy[row * 2 * H + (size_t)dir * H + pj[q]]);
    }
  };
  fetch(0);

  for (int s = 0; s < Tn; ++s) {
    // the fw direction's backward walks time descending, the bw one ascending
    const int t = dir == 0 ? Tn - 1 - s : s;
    float prod[NP];
#pragma unroll
    for (int q = 0; q < NP; ++q) prod[q] = 0.f;
    if (s > 0) {
      // wait until every block of this row group has published step s - 1
      if (threadIdx.x == 0) {
        const unsigned int target = (unsigned int)s * (unsigned int)GU;
        while (ld_acquire(cnt) < target) {
        }
        __threadfence();
      }
      __syncthreads();
      const int t_chain = dir == 0 ? t + 1 : t - 1;  // the step processed before
      chain_product<MT>(dgd + (size_t)t_chain * B * H4, row0, B, H, smem);
      __syncthreads();
#pragma unroll
      for (int q = 0; q < NP; ++q) {
        const int p = threadIdx.x + THREADS * q;
        if (p >= R * C::U) continue;
        const float* pp = part + (size_t)pr[q] * C::PST + p % C::U;
#pragma unroll
        for (int w = 0; w < WARPS; ++w) prod[q] += pp[(size_t)w * R * C::PST];
      }
    }

#pragma unroll
    for (int q = 0; q < NP; ++q) {
      if (!live[q]) continue;
      // the masked cell backward (_bwd_train_kernel direction())
      const bool m = t < len[q];
      const float mf = m ? 1.f : 0.f;
      const float gi = sigmoid_f(zi[q]);
      const float gf = sigmoid_f(zf[q] + forget_bias);
      const float gg = tanhf(zg[q]);
      const float go = sigmoid_f(zo[q]);
      const float tanh_c = tanhf(c_t[q]);
      const float dh_total = gyv[q] * mf + (prod[q] + dh[q]);
      const float dh_new = m ? dh_total : 0.f;
      const float dc_new = (m ? dc[q] : 0.f) + dh_new * go * (1.f - tanh_c * tanh_c);
      const float dgi = dc_new * gg * gi * (1.f - gi);
      const float dgf = dc_new * c_prev[q] * gf * (1.f - gf);
      const float dgg = dc_new * gi * (1.f - gg * gg);
      const float dgo = dh_new * tanh_c * go * (1.f - go);
      T* out = dgd + ((size_t)t * B + pb[q]) * H4 + pj[q];
      out[0] = from_f<T>(dgi);
      out[H] = from_f<T>(dgf);
      out[2 * (size_t)H] = from_f<T>(dgg);
      out[3 * (size_t)H] = from_f<T>(dgo);
      dh[q] = m ? 0.f : dh_total;
      dc[q] = dc_new * gf + (m ? 0.f : dc[q]);
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

// ---------------------------------------------------------------------------
// launches
// ---------------------------------------------------------------------------

template <typename T, bool STORE, bool PROBE, int U, int MT>
int launch_walk_form(WalkArgs a, void* stream) {
  using F = WalkForm<U, MT>;
  // hx's rows are read in 16-byte loads
  if (reinterpret_cast<uintptr_t>(a.hx) % 16 != 0) return (int)cudaErrorMisalignedAddress;
  // bf16: a warp's K chunks are held in registers, at most W_MAXC
  if (sizeof(T) == 2 && (walk_chunks(a.H) + WARPS - 1) / WARPS > W_MAXC)
    return (int)cudaErrorInvalidValue;
  a.RG = (a.B + F::R - 1) / F::R;
  a.GU = (a.H + U - 1) / U;
  const int blocks = 2 * a.RG * a.GU;
  const size_t smem = walk_bytes<T>(a.H, U, MT);
  auto kernel = v1_walk_kernel<T, STORE, PROBE, U, MT>;
  cudaError_t err = check_coresident(kernel, blocks, THREADS, smem);
  if (err != cudaSuccess) return (int)err;
  void* args[] = {(void*)&a};
  err = cudaLaunchCooperativeKernel((const void*)kernel, dim3(blocks), dim3(THREADS), args, smem,
                                    (cudaStream_t)stream);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// units U and m-tiles MT a block (ops/blstm_v1.walk_plan: 32 x 1, 16 x 2,
// 8 x 4 or 16 x 4); counters hold 2 ceil(B / 16 MT) zeros
template <typename T, bool STORE, bool PROBE>
int launch_walk_forms(const WalkArgs& a, int U, int MT, void* stream) {
  if (U == 32 && MT == 1) return launch_walk_form<T, STORE, PROBE, 32, 1>(a, stream);
  if (U == 16 && MT == 2) return launch_walk_form<T, STORE, PROBE, 16, 2>(a, stream);
  if (U == 8 && MT == 4) return launch_walk_form<T, STORE, PROBE, 8, 4>(a, stream);
  if (U == 16 && MT == 4) return launch_walk_form<T, STORE, PROBE, 16, 4>(a, stream);
  return (int)cudaErrorInvalidValue;
}

// hs and c_out null: the inference walk (row 4); else the training walk
// (row 5); probe non-null: the training walk with its step probe
template <typename T>
int launch_walk(const WalkArgs& a, int U, int MT, void* stream) {
  if (a.Tn <= 0 || a.B <= 0) return 0;
  if (a.H <= 0 || a.B > MAX_B) return (int)cudaErrorInvalidValue;
  const bool store = a.hs != nullptr;
  if (store != (a.c_out != nullptr)) return (int)cudaErrorInvalidValue;
  if (a.probe != nullptr) {
    if (!store) return (int)cudaErrorInvalidValue;
    return launch_walk_forms<T, true, true>(a, U, MT, stream);
  }
  if (store) return launch_walk_forms<T, true, false>(a, U, MT, stream);
  return launch_walk_forms<T, false, false>(a, U, MT, stream);
}

template <typename T, int MT>
int launch_chain_mt(const float* gates, const float* cst, const T* gy, const int* lengths,
                    const T* wh, T* dg, unsigned int* counters, int Tn, int B, int H,
                    float forget_bias, void* stream) {
  int NRG = (B + MROWS * MT - 1) / (MROWS * MT);
  int GU = (H + Chain<T>::U - 1) / Chain<T>::U;
  const size_t smem = chain_bytes(T(), MT, H);
  auto kernel = v1_chain_kernel<T, MT>;
  cudaError_t err = check_coresident(kernel, 2 * NRG * GU, THREADS, smem);
  if (err != cudaSuccess) return (int)err;
  void* args[] = {(void*)&gates, (void*)&cst, (void*)&gy, (void*)&lengths, (void*)&wh,
                  (void*)&dg, (void*)&counters, (void*)&Tn, (void*)&B, (void*)&H,
                  (void*)&NRG, (void*)&GU, (void*)&forget_bias};
  err = cudaLaunchCooperativeKernel((const void*)kernel, dim3(2 * NRG * GU), dim3(THREADS), args,
                                    smem, (cudaStream_t)stream);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// MT: m-tiles of 16 rows a block (ops/blstm_v1.chain_plan); counters hold
// 2 ceil(B / 16) zeros
template <typename T>
int launch_chain(const float* gates, const float* cst, const T* gy, const int* lengths,
                 const T* wh, T* dg, unsigned int* counters, int Tn, int B, int H, int MT,
                 float forget_bias, void* stream) {
  if (Tn <= 0 || B <= 0) return 0;
  if (B > MAX_B || H <= 0 || MT > Chain<T>::MAX_MT) return (int)cudaErrorInvalidValue;
  if (chain_chunks(H, Chain<T>::KC) > Chain<T>::MAX_NCH) return (int)cudaErrorInvalidValue;
  switch (MT) {
    case 1:
      return launch_chain_mt<T, 1>(gates, cst, gy, lengths, wh, dg, counters, Tn, B, H,
                                   forget_bias, stream);
    case 2:
      return launch_chain_mt<T, 2>(gates, cst, gy, lengths, wh, dg, counters, Tn, B, H,
                                   forget_bias, stream);
  }
  if constexpr (Chain<T>::MAX_MT >= 8) {
    if (MT == 4)
      return launch_chain_mt<T, 4>(gates, cst, gy, lengths, wh, dg, counters, Tn, B, H,
                                   forget_bias, stream);
    if (MT == 8)
      return launch_chain_mt<T, 8>(gates, cst, gy, lengths, wh, dg, counters, Tn, B, H,
                                   forget_bias, stream);
  }
  return (int)cudaErrorInvalidValue;
}

// the walk (units and mt from ops/blstm_v1.walk_plan): hs and c_out null
// for the inference walk (row 4), else the training walk (row 5); probe
// [blocks][4] for the step probe
template <typename T>
int walk_entry(const void* xw, const int* lengths, const void* wh, void* y, void* hx, void* hs,
               float* c_out, unsigned int* counters, unsigned long long* probe, int T_, int B,
               int H, int units, int mt, float forget_bias, void* stream) {
  WalkArgs a{xw, lengths, wh, y, hx, hs, c_out, counters, probe, T_, B, H, 0, 0, forget_bias};
  return launch_walk<T>(a, units, mt, stream);
}

}  // namespace

extern "C" int nabu_blstm_v1_walk_bf16(const void* xw, const int* lengths, const void* wh,
                                       void* y, void* hx, void* hs, float* c_out,
                                       unsigned int* counters, unsigned long long* probe, int T,
                                       int B, int H, int units, int mt, float forget_bias,
                                       void* stream) {
  return walk_entry<bf16>(xw, lengths, wh, y, hx, hs, c_out, counters, probe, T, B, H, units, mt,
                          forget_bias, stream);
}

extern "C" int nabu_blstm_v1_walk_f32(const void* xw, const int* lengths, const void* wh,
                                      void* y, void* hx, void* hs, float* c_out,
                                      unsigned int* counters, unsigned long long* probe, int T,
                                      int B, int H, int units, int mt, float forget_bias,
                                      void* stream) {
  return walk_entry<float>(xw, lengths, wh, y, hx, hs, c_out, counters, probe, T, B, H, units,
                           mt, forget_bias, stream);
}

extern "C" int nabu_blstm_v1_chain_bf16(const float* gates, const float* cst, const void* gy,
                                        const int* lengths, const void* wh, void* dg,
                                        unsigned int* counters, int T, int B, int H, int MT,
                                        float forget_bias, void* stream) {
  return launch_chain<bf16>(gates, cst, (const bf16*)gy, lengths, (const bf16*)wh, (bf16*)dg,
                            counters, T, B, H, MT, forget_bias, stream);
}

extern "C" int nabu_blstm_v1_chain_f32(const float* gates, const float* cst, const void* gy,
                                       const int* lengths, const void* wh, void* dg,
                                       unsigned int* counters, int T, int B, int H, int MT,
                                       float forget_bias, void* stream) {
  return launch_chain<float>(gates, cst, (const float*)gy, lengths, (const float*)wh, (float*)dg,
                             counters, T, B, H, MT, forget_bias, stream);
}
