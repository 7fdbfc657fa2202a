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
// and a hand-off between blocks. Design:
// - lstm_fwd: one cooperative persistent launch; block g owns hidden units
//   [g*HS, (g+1)*HS) and keeps their four gate columns of wh, [H, 4*HS]
//   f32, in shared memory for the whole walk, with c for its units. Each
//   step it stages h_{t-1} [B, H] (f32) from a ping-pong buffer in global
//   memory (L2 resident, ld.global.cg, 16-byte loads four deep), computes
//   its gates, applies the masked cell and writes its slice of h; the
//   blocks then meet at a counter barrier (release fence, atomic arrival,
//   acquire spin). Slot 0 of the buffer holds h0 at launch.
// - The training variant stores what the backward needs instead of the
//   TPU's post-step (h, c) and its recompute of h_prev @ wh in the chain
//   (one more H x 4H product per serial step): the f32 pre-activation
//   gates (without the forget bias), the f32 carry c and the f32 carried h
//   (dwh's h_prev). At T = 1024, B = 32, H = 320 that is 168 + 42 + 42 MB
//   a layer.
// - lstm_bwd_recur: one cooperative persistent launch. The rows of the
//   batch are independent in the chain, so block (rg, ug) owns 16 MT rows
//   x 8 units (MT from ops/lstm.chain_plan: the least of 1 or 2 that keeps
//   every block co-resident, one an SM), keeps its units' rows of wh,
//   [8, 4H] f32, in shared memory, and meets only the ceil(H / 8) blocks
//   of its row group, at a counter of its own. Each step, after the
//   barrier, it pulls only its rows of the previous step's dgates from the
//   dxw output itself (the exchange buffer; 16 x 4H x 4 = 80 KB at H =
//   320, every 16-byte load of a pass in flight at once, ld.cg straight
//   into registers), forms dh_prev = dgates_prev @ wh^T for its units in
//   f32 with the loads register-blocked (each thread 4 rows x 8 units over
//   a K slice: one float4 of dgates feeds 8 units, one of wh 4 rows), adds
//   the K slices by shuffles and the warps in a fixed order, runs the
//   masked cell backward from the stored gates and carries (fetched before
//   the barrier: they do not depend on the exchange), writes its dgates
//   and arrives at its group's counter.
// Shared memory, the design limit (ops/lstm.py raises beyond it): forward
// 4 (B (H' + 4) + 4 H' HS + B HS) bytes, H' = H rounded up to 4 (83 KB at
// B = 32, H = 320); chain 4 (8 x 4H + 8 x 32 MT) bytes (42 KB at H = 320)
// with ceil(B / 16 MT) ceil(H / 8) blocks on the card's 132 SMs (B <= 96
// at H = 320).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

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

__device__ __forceinline__ unsigned int ld_acquire(const unsigned int* p) {
  unsigned int v;
  asm volatile("ld.acquire.gpu.global.u32 %0, [%1];" : "=r"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ float sigmoid_f(float x) { return 1.f / (1.f + expf(-x)); }

// stage f32 rows [R, W] (written by other blocks during the launch) into
// shared memory rows of stride rp, through L2 (ld.cg), DEPTH 16-byte loads
// in flight per thread
template <int DEPTH>
__device__ __forceinline__ void stage_rows(const float* src_rows, float* dst, int R, int W, int rp) {
  if (W % 4 == 0) {
    const int nvec = R * W / 4;
    const float4* src = reinterpret_cast<const float4*>(src_rows);
    for (int v0 = threadIdx.x; v0 < nvec; v0 += DEPTH * blockDim.x) {
      float4 r[DEPTH];
#pragma unroll
      for (int u = 0; u < DEPTH; ++u) {
        const int v = v0 + u * blockDim.x;
        r[u] = v < nvec ? __ldcg(src + v) : make_float4(0.f, 0.f, 0.f, 0.f);
      }
#pragma unroll
      for (int u = 0; u < DEPTH; ++u) {
        const int v = v0 + u * blockDim.x;
        if (v < nvec) {
          const int e = v * 4;
          const int b = e / W;
          *reinterpret_cast<float4*>(dst + (size_t)b * rp + (e - b * W)) = r[u];
        }
      }
    }
  } else {
    for (int i = threadIdx.x; i < R * W; i += blockDim.x) {
      const int b = i / W;
      dst[(size_t)b * rp + (i - b * W)] = __ldcg(src_rows + i);
    }
  }
}

// grid-wide barrier of the G blocks at step s
__device__ __forceinline__ void grid_barrier(unsigned int* cnt, int s, int G) {
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

constexpr int THREADS = 256;

// ---------------------------------------------------------------------------
// forward walk
// ---------------------------------------------------------------------------

struct FwdLayout {
  int kp;  // H rounded up to a multiple of 4 (rows of the staged wh)
  int hp;  // row stride of the staged h (floats)
  size_t smem_bytes;
};

__host__ __device__ inline FwdLayout fwd_layout(int B, int H, int hs) {
  FwdLayout l;
  l.kp = (H + 3) / 4 * 4;
  l.hp = l.kp + 4;
  l.smem_bytes = sizeof(float) * ((size_t)B * l.hp + (size_t)l.kp * hs * 4 + (size_t)B * hs);
  return l;
}

template <typename T, bool STORE>
__global__ void __launch_bounds__(THREADS) lstm_fwd_kernel(
    const T* __restrict__ xw,         // [T, B, 4H]
    const int* __restrict__ lengths,  // [B]
    const T* __restrict__ wh,         // [H, 4H]
    const float* __restrict__ c0,     // [B, H] initial c, or null (zeros)
    T* __restrict__ y,                // [T, B, H] masked outputs
    float* hbuf,                      // [2 slot][B, H]; slot 0 = h0 at launch
    float* __restrict__ c_last,       // [B, H] final c
    unsigned int* counter,            // zero at launch
    float* __restrict__ g_out,        // STORE: [T, B, 4H] pre-activation gates
    float* __restrict__ c_out,        // STORE: [T, B, H] carried c
    float* __restrict__ h_out,        // STORE: [T, B, H] carried h
    int Tn, int B, int H, int hs, int G, float forget_bias) {
  extern __shared__ __align__(16) float smem[];
  const FwdLayout L = fwd_layout(B, H, hs);
  float* h_s = smem;                         // [B][hp]
  float* w_s = h_s + (size_t)B * L.hp;       // [kp][hs][4 gates]
  float* c_s = w_s + (size_t)L.kp * hs * 4;  // [B][hs]

  const int j0 = blockIdx.x * hs;
  const size_t H4 = 4 * (size_t)H;
  for (int i = threadIdx.x; i < L.kp * hs * 4; i += blockDim.x) {
    const int gate = i % 4;
    const int jl = (i / 4) % hs;
    const int k = i / (4 * hs);
    const int j = j0 + jl;
    w_s[i] = (k < H && j < H) ? to_f(wh[(size_t)k * H4 + gate * H + j]) : 0.f;
  }
  // the padding columns of h multiply zero rows of w: keep them finite
  for (int i = threadIdx.x; i < B * L.hp; i += blockDim.x) h_s[i] = 0.f;
  for (int p = threadIdx.x; p < B * hs; p += blockDim.x) {
    const int j = j0 + p % hs;
    c_s[p] = (c0 != nullptr && j < H) ? c0[(size_t)(p / hs) * H + j] : 0.f;
  }
  __syncthreads();

  const float4* w4 = reinterpret_cast<const float4*>(w_s);
  const int nq = L.kp / 4;

  for (int t = 0; t < Tn; ++t) {
    const float* hin = hbuf + (size_t)(t & 1) * B * H;
    float* hout = hbuf + (size_t)((t + 1) & 1) * B * H;
    // this thread's first (b, j) gate inputs, fetched ahead so their
    // latency overlaps the staging of h
    float xpre[4] = {0.f, 0.f, 0.f, 0.f};
    const int p0 = threadIdx.x;
    if (p0 < B * hs && j0 + p0 % hs < H) {
      const T* xr = xw + ((size_t)t * B + p0 / hs) * H4 + j0 + p0 % hs;
#pragma unroll
      for (int g = 0; g < 4; ++g) xpre[g] = to_f(xr[g * H]);
    }
    stage_rows<4>(hin, h_s, B, H, L.hp);
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
        const T* xr = xw + ((size_t)t * B + b) * H4 + j;
#pragma unroll
        for (int g = 0; g < 4; ++g) xg[g] = to_f(xr[g * H]);
      }
      const float z0 = xg[0] + a0, z1 = xg[1] + a1, z2 = xg[2] + a2, z3 = xg[3] + a3;
      const float gi = sigmoid_f(z0);
      const float gf = sigmoid_f(z1 + forget_bias);
      const float gg = tanhf(z2);
      const float go = sigmoid_f(z3);
      const float c_new = gf * c_s[p] + gi * gg;
      const float h_new = go * tanhf(c_new);
      const bool valid = t < __ldg(lengths + b);
      // masked carry: padding frames keep (h, c) and output zeros
      const float h_next = valid ? h_new : h_s[(size_t)b * L.hp + j];
      if (valid) c_s[p] = c_new;
      hout[(size_t)b * H + j] = h_next;
      const size_t row = (size_t)t * B + b;
      y[row * H + j] = from_f<T>(valid ? h_new : 0.f);
      if constexpr (STORE) {
        c_out[row * H + j] = c_s[p];
        h_out[row * H + j] = h_next;
        float* gr = g_out + row * H4 + j;
        gr[0] = z0;
        gr[H] = z1;
        gr[2 * (size_t)H] = z2;
        gr[3 * (size_t)H] = z3;
      }
    }

    // hand h over to the other blocks
    grid_barrier(counter, t, G);
  }
  for (int p = threadIdx.x; p < B * hs; p += blockDim.x) {
    const int j = j0 + p % hs;
    if (j < H) c_last[(size_t)(p / hs) * H + j] = c_s[p];
  }
}

// co-residency check of a cooperative launch of `blocks` blocks
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

template <typename T, bool STORE>
int launch_fwd(const T* xw, const int* lengths, const T* wh, const float* c0, T* y, float* hbuf,
               float* c_last, unsigned int* counter, float* g_out, float* c_out, float* h_out,
               int Tn, int B, int H, int hs, float forget_bias, void* stream) {
  if (Tn <= 0 || B <= 0) return 0;
  if (hs <= 0 || H <= 0) return (int)cudaErrorInvalidValue;
  const FwdLayout L = fwd_layout(B, H, hs);
  auto kernel = lstm_fwd_kernel<T, STORE>;
  int G = (H + hs - 1) / hs;
  cudaError_t err = check_coresident(kernel, G, L.smem_bytes);
  if (err != cudaSuccess) return (int)err;
  void* args[] = {(void*)&xw,    (void*)&lengths, (void*)&wh,    (void*)&c0,    (void*)&y,
                  (void*)&hbuf,  (void*)&c_last,  (void*)&counter, (void*)&g_out,
                  (void*)&c_out, (void*)&h_out,   (void*)&Tn,    (void*)&B,     (void*)&H,
                  (void*)&hs,    (void*)&G,       (void*)&forget_bias};
  err = cudaLaunchCooperativeKernel((const void*)kernel, dim3(G), dim3(THREADS), args,
                                    L.smem_bytes, (cudaStream_t)stream);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// backward chain
// ---------------------------------------------------------------------------

constexpr int CH_ROWS = 16;   // rows of an m-tile; a block owns 16 MT rows
constexpr int CH_UNITS = 8;   // hidden units a chain block owns
constexpr int CH_KS = 64;     // K slices of a step product: the threads of a row block
constexpr int CH_NQ = 5;      // float4 of a row a thread loads a pass (4H = 1280 at H = 320)
static_assert(CH_ROWS == 4 * THREADS / CH_KS, "a row block of 4 rows a warp pair");

// shared memory of a chain block: wh rows of its units [8][4H] f32 and the
// warps' reduced partial sums [8][32 MT]
__host__ __device__ inline size_t chain_bytes(int H, int MT) {
  return sizeof(float) * ((size_t)CH_UNITS * 4 * H + (size_t)(THREADS / 32) * 32 * MT);
}

// one round of a warp's reduce-scatter over N values a lane: after the
// round of offset O the lane keeps the half of v selected by lane & O,
// added to its partner's copy; five rounds leave lane l the sums over the
// warp of v[l N / 32 + k], k < N / 32, in a fixed order
template <int N, int O>
__device__ __forceinline__ void reduce_scatter(float* v, int lane) {
  const bool upper = lane & O;
#pragma unroll
  for (int k = 0; k < N / 2; ++k) {
    const float send = upper ? v[k] : v[k + N / 2];
    const float keep = upper ? v[k + N / 2] : v[k];
    v[k] = keep + __shfl_xor_sync(0xffffffffu, send, O);
  }
  if constexpr (O > 1) reduce_scatter<N / 2, O / 2>(v, lane);
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
  cudaError_t err = check_coresident(kernel, blocks, smem);
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

template <typename T>
int launch_fwd_any(const void* xw, const int* lengths, const void* wh, const float* c0, void* y,
                   float* hbuf, float* c_last, unsigned int* counter, float* g_out, float* c_out,
                   float* h_out, int Tn, int B, int H, int hs, float forget_bias, void* stream) {
  if (g_out != nullptr)
    return launch_fwd<T, true>((const T*)xw, lengths, (const T*)wh, c0, (T*)y, hbuf, c_last,
                               counter, g_out, c_out, h_out, Tn, B, H, hs, forget_bias, stream);
  return launch_fwd<T, false>((const T*)xw, lengths, (const T*)wh, c0, (T*)y, hbuf, c_last,
                              counter, nullptr, nullptr, nullptr, Tn, B, H, hs, forget_bias,
                              stream);
}

}  // namespace

// the walk: the training variant when g_out is given (then c_out and
// h_out too); c0 may be null (zeros), h0 sits in hbuf's slot 0
extern "C" int nabu_lstm_fwd_bf16(const void* xw, const int* lengths, const void* wh,
                                  const float* c0, void* y, float* hbuf, float* c_last,
                                  unsigned int* counter, float* g_out, float* c_out,
                                  float* h_out, int T, int B, int H, int hs, float forget_bias,
                                  void* stream) {
  return launch_fwd_any<bf16>(xw, lengths, wh, c0, y, hbuf, c_last, counter, g_out, c_out, h_out,
                              T, B, H, hs, forget_bias, stream);
}

extern "C" int nabu_lstm_fwd_f32(const void* xw, const int* lengths, const void* wh,
                                 const float* c0, void* y, float* hbuf, float* c_last,
                                 unsigned int* counter, float* g_out, float* c_out, float* h_out,
                                 int T, int B, int H, int hs, float forget_bias, void* stream) {
  return launch_fwd_any<float>(xw, lengths, wh, c0, y, hbuf, c_last, counter, g_out, c_out,
                               h_out, T, B, H, hs, forget_bias, stream);
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
