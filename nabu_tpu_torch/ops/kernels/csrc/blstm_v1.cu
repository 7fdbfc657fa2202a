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
//     descending, so no flipped copy of xw exists. Block g of direction d
//     owns hidden units [8g, 8g + 8) and keeps their four gate columns of
//     wh, [H, 8 x 4] (f32), in shared memory for the whole sequence, with
//     c and its own h carry (f32). Each step it streams h_{t-1} [B, H]
//     from global memory (L2 resident, ld.global.cg, 16-byte loads four
//     deep per thread) in K tiles of 128 columns, so shared memory holds
//     [B, 128] of h and not [B, H]; each thread accumulates the four gates
//     of up to 4 (b, unit) pairs over the tiles in registers. Then the
//     masked cell of _cell (:53-70): f32 gates and c, h in the compute
//     type; padding frames hold the carry and output zeros. The blocks of
//     a direction meet at a counter barrier each step (release fence
//     before the arrival, acquire load in the spin). The inference walk
//     exchanges h through a ping-pong buffer [2, 2, B, H]; the training
//     walk exchanges it through its own store of the post-mask carries,
//     [2, T + 1, B, H] with a zero slot at each direction's start (fw slot
//     0, bw slot T), so row t of direction d's "hprev" is one contiguous
//     [T, B, H] matrix for the backward's two products.
//     Bound on the H100 at las_large's bottom layer (T = 1024, B = 64,
//     H = 512, both directions): h @ wh is 275 GFLOP, 0.28 ms of bf16
//     tensor rate; the bytes (xw read, h and c stored) ~0.94 GB, 0.28 ms.
//     The pace is set by T dependent steps, each a grid-wide hand-off of
//     h, not by either.
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
// launch beyond them): B <= 128 (walk: B x 8 pairs over 256 threads, 4 a
// thread); walk shared memory 4 (4 ceil4(H) 8 + 132 B + 16 B) bytes within
// 227 KB and its 2 ceil(H / 8) blocks co-resident (128 at H = 512); chain
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
constexpr int HS = 8;      // hidden units a block owns
constexpr int PAIRS = 4;   // (b, unit) pairs a thread at most: B <= PAIRS * THREADS / HS
constexpr int RSTEP = THREADS / HS;  // rows between one thread's pairs
constexpr int WKT = 128;   // walk: columns of h in one K tile

// loads that bypass L1 (rewritten by other blocks during the launch)
__device__ __forceinline__ float load_cg(const float* p) { return __ldcg(p); }
__device__ __forceinline__ bf16 load_cg(const bf16* p) {
  return __ushort_as_bfloat16(__ldcg(reinterpret_cast<const unsigned short*>(p)));
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

// Stage the K tile [k0, k0 + kw) of R rows of a row-major matrix of W
// columns (element type T, written by other blocks) into shared memory as
// f32 rows of stride ld, zero-filled up to kw4 = kw rounded up to 4. The
// loads go through L2 (ld.cg), DEPTH 16-byte vectors at a time per thread
// so their latencies overlap, where W is a whole number of vectors (then
// so are k0 and kw, both multiples of 8 or the rest of a row).
template <typename T, int DEPTH>
__device__ __forceinline__ void stage_tile(const T* src, int R, int W, int k0, int kw, int kw4,
                                           float* dst, int ld) {
  constexpr int EPV = 16 / sizeof(T);
  if (W % EPV == 0) {
    const int per_row = kw / EPV;
    const int nvec = R * per_row;
    for (int v0 = threadIdx.x; v0 < nvec; v0 += DEPTH * blockDim.x) {
      uint4 r[DEPTH];
#pragma unroll
      for (int u = 0; u < DEPTH; ++u) {
        const int v = v0 + u * blockDim.x;
        if (v < nvec) {
          const int row = v / per_row;
          const int cv = v - row * per_row;
          r[u] = __ldcg(reinterpret_cast<const uint4*>(src + (size_t)row * W + k0 + cv * EPV));
        }
      }
#pragma unroll
      for (int u = 0; u < DEPTH; ++u) {
        const int v = v0 + u * blockDim.x;
        if (v < nvec) {
          const int row = v / per_row;
          const int cv = v - row * per_row;
          unpack16(r[u], dst + (size_t)row * ld + cv * EPV, T());
        }
      }
    }
    if (kw4 > kw) {
      for (int i = threadIdx.x; i < R * (kw4 - kw); i += blockDim.x) {
        const int row = i / (kw4 - kw);
        dst[(size_t)row * ld + kw + (i - row * (kw4 - kw))] = 0.f;
      }
    }
  } else {
    for (int i = threadIdx.x; i < R * kw4; i += blockDim.x) {
      const int row = i / kw4;
      const int c = i - row * kw4;
      dst[(size_t)row * ld + c] = c < kw ? to_f(load_cg(src + (size_t)row * W + k0 + c)) : 0.f;
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

__host__ __device__ inline int round4(int n) { return (n + 3) / 4 * 4; }

// shared memory of one block, in floats
__host__ __device__ inline size_t walk_floats(int B, int H) {
  return (size_t)round4(H) * HS * 4 + (size_t)B * (WKT + 4) + 2 * (size_t)B * HS;
}

// ---------------------------------------------------------------------------
// (a) the walk (rows 4 and 5)
// ---------------------------------------------------------------------------

template <typename T, bool STORE>
__global__ void __launch_bounds__(THREADS) v1_walk_kernel(
    const T* __restrict__ xw,        // [2, T, B, 4H], both directions in natural time
    const int* __restrict__ lengths, // [B]
    const T* __restrict__ wh,        // [2, H, 4H]
    T* __restrict__ y,               // [T, B, 2H] masked outputs
    T* hx,                           // exchange: [2, 2, B, H] ping-pong, or (STORE)
                                     // the stored carries [2, T + 1, B, H]
    unsigned int* counters,          // [2], zero at launch
    float* __restrict__ c_out,       // STORE: [2, T, B, H] post-mask c
    int Tn, int B, int H, int G, float forget_bias) {
  extern __shared__ __align__(16) float smem[];
  const int kp = round4(H);
  float* w_s = smem;                          // [kp][HS][4 gates]
  float* h_s = w_s + (size_t)kp * HS * 4;     // [B][WKT + 4]: a K tile of h_{t-1}
  float* c_s = h_s + (size_t)B * (WKT + 4);   // [B * HS] c carry
  float* hc_s = c_s + (size_t)B * HS;         // [B * HS] own h carry (exact in f32)
  constexpr int LDH = WKT + 4;

  const int dir = blockIdx.x / G;
  const int j0 = (blockIdx.x % G) * HS;
  const size_t H4 = 4 * (size_t)H;
  const size_t BH = (size_t)B * H;

  const T* whd = wh + (size_t)dir * H * H4;
  for (int i = threadIdx.x; i < kp * HS * 4; i += blockDim.x) {
    const int gate = i % 4;
    const int jl = (i / 4) % HS;
    const int k = i / (4 * HS);
    const int j = j0 + jl;
    w_s[i] = (k < H && j < H) ? to_f(whd[(size_t)k * H4 + gate * H + j]) : 0.f;
  }
  for (int i = threadIdx.x; i < B * HS; i += blockDim.x) {
    c_s[i] = 0.f;
    hc_s[i] = 0.f;
  }
  T* hxd = hx + (size_t)dir * (STORE ? (size_t)(Tn + 1) : 2) * BH;
  if constexpr (STORE) {
    // the zero slot each direction starts from (read by the backward)
    T* zero = hxd + (size_t)(dir == 0 ? 0 : Tn) * BH;
    for (int i = threadIdx.x; i < B * HS; i += blockDim.x) {
      const int j = j0 + i % HS;
      if (j < H) zero[(size_t)(i / HS) * H + j] = from_f<T>(0.f);
    }
  }
  __syncthreads();

  const T* xwd = xw + (size_t)dir * Tn * B * H4;
  unsigned int* cnt = counters + dir;
  // a thread's pairs share one unit (THREADS is a multiple of HS): rows
  // b0, b0 + RSTEP, ... of unit j0 + jl
  const int jl = threadIdx.x % HS;
  const int b0 = threadIdx.x / HS;
  const int j = j0 + jl;
  const float4* w4 = reinterpret_cast<const float4*>(w_s) + jl;

  for (int s = 0; s < Tn; ++s) {
    const int t = dir == 0 ? s : Tn - 1 - s;
    const T* hin;
    T* hout;
    if constexpr (STORE) {
      // fw: slot t holds the carry entering step t, slot t + 1 the one
      // leaving it; bw: slot t + 1 entering, slot t leaving
      hin = hxd + (size_t)(dir == 0 ? t : t + 1) * BH;
      hout = hxd + (size_t)(dir == 0 ? t + 1 : t) * BH;
    } else {
      hin = hxd + (size_t)(s & 1) * BH;
      hout = hxd + (size_t)((s + 1) & 1) * BH;
    }
    float acc[PAIRS][4];
#pragma unroll
    for (int i = 0; i < PAIRS; ++i)
#pragma unroll
      for (int g = 0; g < 4; ++g) acc[i][g] = 0.f;

    if (s > 0) {  // h_{-1} = 0
      for (int k0 = 0; k0 < H; k0 += WKT) {
        const int kw = min(WKT, H - k0);
        const int nq = round4(kw) / 4;
        stage_tile<T, 4>(hin, B, H, k0, kw, round4(kw), h_s, LDH);
        __syncthreads();
        const float4* wk = w4 + (size_t)k0 * HS;
        for (int q = 0; q < nq; ++q) {
          float4 wv[4];
#pragma unroll
          for (int u = 0; u < 4; ++u) wv[u] = wk[(size_t)(4 * q + u) * HS];
#pragma unroll
          for (int i = 0; i < PAIRS; ++i) {
            const int b = b0 + i * RSTEP;
            if (b < B) {
              const float4 hv = reinterpret_cast<const float4*>(h_s + (size_t)b * LDH)[q];
              const float hk[4] = {hv.x, hv.y, hv.z, hv.w};
#pragma unroll
              for (int u = 0; u < 4; ++u) {
                acc[i][0] = fmaf(hk[u], wv[u].x, acc[i][0]);
                acc[i][1] = fmaf(hk[u], wv[u].y, acc[i][1]);
                acc[i][2] = fmaf(hk[u], wv[u].z, acc[i][2]);
                acc[i][3] = fmaf(hk[u], wv[u].w, acc[i][3]);
              }
            }
          }
        }
        __syncthreads();  // the tile is read before the next one lands
      }
    }

#pragma unroll
    for (int i = 0; i < PAIRS; ++i) {
      const int b = b0 + i * RSTEP;
      if (b >= B || j >= H) continue;
      const int p = b * HS + jl;
      const T* xr = xwd + ((size_t)t * B + b) * H4 + j;
      const float z0 = to_f(xr[0]) + acc[i][0];
      const float z1 = to_f(xr[H]) + acc[i][1];
      const float z2 = to_f(xr[2 * (size_t)H]) + acc[i][2];
      const float z3 = to_f(xr[3 * (size_t)H]) + acc[i][3];
      const float gi = sigmoid_f(z0);
      const float gf = sigmoid_f(z1 + forget_bias);
      const float gg = tanhf(z2);
      const float go = sigmoid_f(z3);
      const float c_new = gf * c_s[p] + gi * gg;
      const T h_new = from_f<T>(go * tanhf(c_new));
      const bool valid = t < __ldg(lengths + b);
      if (valid) {
        c_s[p] = c_new;
        hc_s[p] = to_f(h_new);
      }
      // masked carry: padding frames keep h and c
      hout[(size_t)b * H + j] = from_f<T>(hc_s[p]);
      y[((size_t)t * B + b) * 2 * H + (size_t)dir * H + j] = valid ? h_new : from_f<T>(0.f);
      if constexpr (STORE) c_out[(((size_t)dir * Tn + t) * B + b) * H + j] = c_s[p];
    }

    // hand h over to the other blocks of this direction
    direction_barrier(cnt, s, G);
  }
}

// ---------------------------------------------------------------------------
// (b) the backward chain (row 6)
// ---------------------------------------------------------------------------

constexpr int WARPS = THREADS / 32;
constexpr int MROWS = 16;          // rows of an m-tile (mma m16n8k16)
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

bool within_design(int B, int H) { return B > 0 && H > 0 && B * HS <= PAIRS * THREADS; }

template <typename T, bool STORE>
int launch_walk(const T* xw, const int* lengths, const T* wh, T* y, T* hx,
                unsigned int* counters, float* c_out, int Tn, int B, int H, float forget_bias,
                void* stream) {
  if (Tn <= 0 || B <= 0) return 0;
  if (!within_design(B, H)) return (int)cudaErrorInvalidValue;
  const size_t smem = sizeof(float) * walk_floats(B, H);
  auto kernel = v1_walk_kernel<T, STORE>;
  int G = (H + HS - 1) / HS;
  cudaError_t err = check_coresident(kernel, 2 * G, THREADS, smem);
  if (err != cudaSuccess) return (int)err;
  void* args[] = {(void*)&xw, (void*)&lengths, (void*)&wh, (void*)&y, (void*)&hx,
                  (void*)&counters, (void*)&c_out, (void*)&Tn, (void*)&B, (void*)&H,
                  (void*)&G, (void*)&forget_bias};
  err = cudaLaunchCooperativeKernel((const void*)kernel, dim3(2 * G), dim3(THREADS), args, smem,
                                    (cudaStream_t)stream);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
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
  if (B > PAIRS * THREADS / HS || H <= 0 || MT > Chain<T>::MAX_MT) return (int)cudaErrorInvalidValue;
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

}  // namespace

// the walk: c_out null for the inference walk (row 4; hx the [2, 2, B, H]
// ping-pong), else the training walk (row 5; hx the [2, T + 1, B, H] store)
extern "C" int nabu_blstm_v1_walk_bf16(const void* xw, const int* lengths, const void* wh,
                                       void* y, void* hx, unsigned int* counters, float* c_out,
                                       int T, int B, int H, float forget_bias, void* stream) {
  if (c_out != nullptr)
    return launch_walk<bf16, true>((const bf16*)xw, lengths, (const bf16*)wh, (bf16*)y,
                                   (bf16*)hx, counters, c_out, T, B, H, forget_bias, stream);
  return launch_walk<bf16, false>((const bf16*)xw, lengths, (const bf16*)wh, (bf16*)y,
                                  (bf16*)hx, counters, nullptr, T, B, H, forget_bias, stream);
}

extern "C" int nabu_blstm_v1_walk_f32(const void* xw, const int* lengths, const void* wh,
                                      void* y, void* hx, unsigned int* counters, float* c_out,
                                      int T, int B, int H, float forget_bias, void* stream) {
  if (c_out != nullptr)
    return launch_walk<float, true>((const float*)xw, lengths, (const float*)wh, (float*)y,
                                    (float*)hx, counters, c_out, T, B, H, forget_bias, stream);
  return launch_walk<float, false>((const float*)xw, lengths, (const float*)wh, (float*)y,
                                   (float*)hx, counters, nullptr, T, B, H, forget_bias, stream);
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
