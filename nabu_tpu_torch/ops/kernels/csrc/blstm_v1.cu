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
//     persistent launch for both directions with the walk's split: block g
//     of a direction keeps the rows of wh of its 8 units, [8, 4H] (f32).
//     The fw direction walks time descending, the bw direction ascending.
//     Each step every block needs all of the previous step's dgates [B,
//     4H] (256 KB in bf16 at B = 64, H = 512: beyond a block's 227 KB),
//     so it streams them from the dg output itself (the exchange buffer:
//     each row is written once, then read by every block of its direction
//     with ld.global.cg) in K tiles of 256 columns, [B, 256] f32 in shared
//     memory, and accumulates dh_prev = dgates_prev @ wh^T for its (b,
//     unit) pairs in registers. Then the masked cell backward of
//     _bwd_train_kernel's direction() from the recomputed f32 gates and
//     the stored carries; dh and dc are carried in f32, the dgates are cast
//     to the compute type before they are stored (and so before the chain
//     product reads them, :337-344). Bound at the same shape: 275 GFLOP of
//     the chain product and ~1.6 GB of gates, carries and dgates, 0.48 ms
//     by bytes; the pace is again T dependent steps.
//
// Limits of the design (ops/blstm_v1.check_design raises before any
// launch beyond them): B <= 128 (B x 8 pairs over 256 threads, 4 a
// thread); shared memory of a block 4 (4 ceil4(H) 8 + 132 B + 16 B) bytes
// (walk) and 4 (8 (4H + 4) + 260 B + 16 B) bytes (chain) within 227 KB,
// e.g. 103 KB and 136 KB at B = 64, H = 512; and the 2 ceil(H / 8) blocks
// co-resident on the card's 132 SMs (128 at H = 512). The launch is
// cooperative, so the runtime also refuses it unless every block is
// co-resident (a spin barrier over blocks that are not would deadlock).
//
// Element types: __nv_bfloat16 (the training and serving path) and float
// (to check the card tightly).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr int THREADS = 256;
constexpr int HS = 8;      // hidden units a block owns
constexpr int PAIRS = 4;   // (b, unit) pairs a thread at most: B <= PAIRS * THREADS / HS
constexpr int RSTEP = THREADS / HS;  // rows between one thread's pairs
constexpr int WKT = 128;   // walk: columns of h in one K tile
constexpr int CKT = 256;   // chain: columns of dgates in one K tile

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(bf16 v) { return __bfloat162float(v); }

template <typename T>
__device__ __forceinline__ T from_f(float v);
template <>
__device__ __forceinline__ float from_f<float>(float v) { return v; }
template <>
__device__ __forceinline__ bf16 from_f<bf16>(float v) { return __float2bfloat16(v); }

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
__host__ __device__ inline size_t chain_floats(int B, int H) {
  return (size_t)HS * (4 * H + 4) + (size_t)B * (CKT + 4) + 2 * (size_t)B * HS;
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

template <typename T>
__global__ void __launch_bounds__(THREADS) v1_chain_kernel(
    const float* __restrict__ gates,  // [2, T, B, 4H] recomputed f32 pre-activations
    const float* __restrict__ cst,    // [2, T, B, H] f32 post-mask carries
    const T* __restrict__ gy,         // [T, B, 2H] cotangent of the layer output
    const int* __restrict__ lengths,  // [B]
    const T* __restrict__ wh,         // [2, H, 4H]
    T* dg,                            // [2, T, B, 4H] out; also the exchange
    unsigned int* counters,           // [2], zero at launch
    int Tn, int B, int H, int G, float forget_bias) {
  extern __shared__ __align__(16) float smem[];
  const int H4 = 4 * H;
  const int rp = H4 + 4;
  constexpr int LDG = CKT + 4;
  float* w_s = smem;                          // [HS][rp]: wh rows of this block's units
  float* dg_s = w_s + (size_t)HS * rp;        // [B][LDG]: a K tile of the previous dgates
  float* dh_s = dg_s + (size_t)B * LDG;       // [B * HS] dh passed through masked steps
  float* dc_s = dh_s + (size_t)B * HS;        // [B * HS] dc carry

  const int dir = blockIdx.x / G;
  const int j0 = (blockIdx.x % G) * HS;
  const T* whd = wh + (size_t)dir * H * H4;
  for (int i = threadIdx.x; i < HS * rp; i += blockDim.x) {
    const int jl = i / rp, k = i % rp;
    w_s[i] = (j0 + jl < H && k < H4) ? to_f(whd[(size_t)(j0 + jl) * H4 + k]) : 0.f;
  }
  for (int i = threadIdx.x; i < B * HS; i += blockDim.x) {
    dh_s[i] = 0.f;
    dc_s[i] = 0.f;
  }
  __syncthreads();

  const size_t dstride = (size_t)Tn * B;  // rows of one direction
  const float* gd = gates + (size_t)dir * dstride * H4;
  const float* cd = cst + (size_t)dir * dstride * H;
  T* dgd = dg + (size_t)dir * dstride * H4;
  unsigned int* cnt = counters + dir;
  // a thread's pairs share one unit: rows b0, b0 + RSTEP, ... of j0 + jl
  const int jl = threadIdx.x % HS;
  const int b0 = threadIdx.x / HS;
  const int j = j0 + jl;
  const float* wrow = w_s + (size_t)jl * rp;

  for (int s = 0; s < Tn; ++s) {
    // the fw direction's backward walks time descending, the bw one ascending
    const int t = dir == 0 ? Tn - 1 - s : s;
    const int t_chain = dir == 0 ? t + 1 : t - 1;  // the step processed before
    const int t_fprev = dir == 0 ? t - 1 : t + 1;  // the forward recurrence's previous step
    float acc[PAIRS][4];  // four partial sums a pair (the float4 lanes)
#pragma unroll
    for (int i = 0; i < PAIRS; ++i)
#pragma unroll
      for (int u = 0; u < 4; ++u) acc[i][u] = 0.f;

    if (s > 0) {
      const T* prev = dgd + (size_t)t_chain * B * H4;
      for (int k0 = 0; k0 < H4; k0 += CKT) {
        const int kw = min(CKT, H4 - k0);  // a multiple of 4
        stage_tile<T, 8>(prev, B, H4, k0, kw, kw, dg_s, LDG);
        __syncthreads();
        const float4* wr = reinterpret_cast<const float4*>(wrow + k0);
        for (int q = 0; q < kw / 4; ++q) {
          const float4 wv = wr[q];
#pragma unroll
          for (int i = 0; i < PAIRS; ++i) {
            const int b = b0 + i * RSTEP;
            if (b < B) {
              const float4 dv = reinterpret_cast<const float4*>(dg_s + (size_t)b * LDG)[q];
              acc[i][0] = fmaf(dv.x, wv.x, acc[i][0]);
              acc[i][1] = fmaf(dv.y, wv.y, acc[i][1]);
              acc[i][2] = fmaf(dv.z, wv.z, acc[i][2]);
              acc[i][3] = fmaf(dv.w, wv.w, acc[i][3]);
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
      const size_t row = (size_t)t * B + b;
      const float* gr = gd + row * H4 + j;
      const float zi = gr[0], zf = gr[H], zg = gr[2 * (size_t)H], zo = gr[3 * (size_t)H];
      const float c_t = cd[row * H + j];
      const float c_prev =
          (t_fprev >= 0 && t_fprev < Tn) ? cd[((size_t)t_fprev * B + b) * H + j] : 0.f;
      const float gyv = to_f(gy[row * 2 * H + (size_t)dir * H + j]);
      const bool m = t < __ldg(lengths + b);
      const float mf = m ? 1.f : 0.f;
      const float dh = ((acc[i][0] + acc[i][1]) + (acc[i][2] + acc[i][3])) + dh_s[p];
      // the masked cell backward (_bwd_train_kernel direction())
      const float gi = sigmoid_f(zi);
      const float gf = sigmoid_f(zf + forget_bias);
      const float gg = tanhf(zg);
      const float go = sigmoid_f(zo);
      const float tanh_c = tanhf(c_t);
      const float dh_total = gyv * mf + dh;
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

// ---------------------------------------------------------------------------
// launches
// ---------------------------------------------------------------------------

template <typename K>
cudaError_t check_coresident(K kernel, int blocks, size_t smem) {
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return err;
  int device = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&device)) != cudaSuccess) return err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device)) != cudaSuccess)
    return err;
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, THREADS, smem)) !=
      cudaSuccess)
    return err;
  if (blocks > per_sm * sms) return cudaErrorCooperativeLaunchTooLarge;
  return cudaSuccess;
}

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
  cudaError_t err = check_coresident(kernel, 2 * G, smem);
  if (err != cudaSuccess) return (int)err;
  void* args[] = {(void*)&xw, (void*)&lengths, (void*)&wh, (void*)&y, (void*)&hx,
                  (void*)&counters, (void*)&c_out, (void*)&Tn, (void*)&B, (void*)&H,
                  (void*)&G, (void*)&forget_bias};
  err = cudaLaunchCooperativeKernel((const void*)kernel, dim3(2 * G), dim3(THREADS), args, smem,
                                    (cudaStream_t)stream);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

template <typename T>
int launch_chain(const float* gates, const float* cst, const T* gy, const int* lengths,
                 const T* wh, T* dg, unsigned int* counters, int Tn, int B, int H,
                 float forget_bias, void* stream) {
  if (Tn <= 0 || B <= 0) return 0;
  if (!within_design(B, H)) return (int)cudaErrorInvalidValue;
  const size_t smem = sizeof(float) * chain_floats(B, H);
  auto kernel = v1_chain_kernel<T>;
  int G = (H + HS - 1) / HS;
  cudaError_t err = check_coresident(kernel, 2 * G, smem);
  if (err != cudaSuccess) return (int)err;
  void* args[] = {(void*)&gates, (void*)&cst, (void*)&gy, (void*)&lengths, (void*)&wh,
                  (void*)&dg, (void*)&counters, (void*)&Tn, (void*)&B, (void*)&H,
                  (void*)&G, (void*)&forget_bias};
  err = cudaLaunchCooperativeKernel((const void*)kernel, dim3(2 * G), dim3(THREADS), args, smem,
                                    (cudaStream_t)stream);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
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
                                        unsigned int* counters, int T, int B, int H,
                                        float forget_bias, void* stream) {
  return launch_chain<bf16>(gates, cst, (const bf16*)gy, lengths, (const bf16*)wh, (bf16*)dg,
                            counters, T, B, H, forget_bias, stream);
}

extern "C" int nabu_blstm_v1_chain_f32(const float* gates, const float* cst, const void* gy,
                                       const int* lengths, const void* wh, void* dg,
                                       unsigned int* counters, int T, int B, int H,
                                       float forget_bias, void* stream) {
  return launch_chain<float>(gates, cst, (const float*)gy, lengths, (const float*)wh, (float*)dg,
                             counters, T, B, H, forget_bias, stream);
}
