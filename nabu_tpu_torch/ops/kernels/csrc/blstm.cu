// Bidirectional LSTM layer forward for Hopper (sm_90a): two kernels.
//
// Replaces the TPU kernel nabu_tpu/ops/pallas/blstm.py
// (_tm_fwd -> _fwd_train_kernel2, reached from blstm_tm_apply): per
// time block xw = bf16(bf16(x @ wx) + b), then the serial masked LSTM
// cell for both directions (the backward one walking time descending),
// writing masked h in natural time order. The TPU's xw and c residuals
// feed its backward kernel; this inference forward does not write them.
//
// (a) blstm_proj: xw_d = cast(cast(x @ wx_d) + b_d) for d in {fw, bw},
//     [T*B, D] x [D, 4H] with f32 accumulation; the bias is added after
//     the cast to the compute type, as in the TPU kernel.
//     Bound on the H100: operations (4x320 at T = 1024, B = 32, D = 640:
//     107 GFLOP of bf16 against 989 TFLOP/s, ~0.11 ms; its 210 MB take
//     ~63 us). Design: a plain tiled GEMM, 64 x 128 block tiles staged in
//     shared memory with 16-byte loads (the next K tile waits in registers
//     while the current one is multiplied), 8 warps each issuing 2 x 2
//     WMMA 16x16x16 bf16 fragments (tensor cores, f32 accumulate); the
//     epilogue casts, adds the bias and writes both directions from one
//     launch (grid.z).
//     The f32 variant is a SIMT tiled GEMM (4 x 4 outputs a thread), so
//     it checks the arithmetic at full precision without TF32.
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
//
// Element types: __nv_bfloat16 (the serving path) and float (to check
// the card tightly). Gates and c are f32; h is carried in the element
// type, as in the TPU kernel.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

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

// loads that bypass L1 (h is rewritten by other blocks every step)
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

// stage h [B, H] (element type T, written by other blocks) into shared
// memory as f32 rows of stride hp. The loads go through L2 (ld.cg) and
// are issued four at a time per thread so their latencies overlap.
template <typename T>
__device__ __forceinline__ void stage_h(const T* hin, float* h_s, int B, int H, int hp) {
  constexpr int EPV = 16 / sizeof(T);  // elements per 16-byte vector
  if (H % EPV == 0) {
    const int nvec = B * H / EPV;
    const uint4* src = reinterpret_cast<const uint4*>(hin);
    for (int v0 = threadIdx.x; v0 < nvec; v0 += 4 * blockDim.x) {
      uint4 r[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int v = v0 + u * blockDim.x;
        r[u] = v < nvec ? __ldcg(src + v) : make_uint4(0u, 0u, 0u, 0u);
      }
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int v = v0 + u * blockDim.x;
        if (v < nvec) {
          const int e = v * EPV;
          const int b = e / H;
          unpack16(r[u], h_s + (size_t)b * hp + (e - b * H), T());
        }
      }
    }
  } else {
    for (int i = threadIdx.x; i < B * H; i += blockDim.x) {
      const int b = i / H;
      h_s[(size_t)b * hp + (i - b * H)] = to_f(load_cg(hin + i));
    }
  }
}

// ---------------------------------------------------------------------------
// (a) projection, bf16: WMMA tiles
// ---------------------------------------------------------------------------

constexpr int PM = 64, PN = 128, PK = 32;
constexpr int P_THREADS = 256;  // 8 warps as 2 (M) x 4 (N), 32 x 32 each
constexpr int AS = PK + 8;      // padded strides (multiples of 8 elements)
constexpr int BS = PN + 8;
constexpr int CS = PN + 4;      // multiple of 4 floats

template <bool VEC>
__global__ void __launch_bounds__(P_THREADS) proj_wmma_bf16(
    const bf16* __restrict__ x,     // [M, D]
    const bf16* __restrict__ wx,    // [2, D, N]
    const bf16* __restrict__ bias,  // [2, N]
    bf16* __restrict__ xw,          // [2, M, N]
    int M, int D, int N) {
  using namespace nvcuda;
  __shared__ __align__(32) bf16 a_s[PM * AS];
  __shared__ __align__(32) bf16 b_s[PK * BS];
  __shared__ __align__(32) float c_s[PM * CS];

  const int dir = blockIdx.z;
  const bf16* w = wx + (size_t)dir * D * N;
  const int m0 = blockIdx.y * PM;
  const int n0 = blockIdx.x * PN;
  const int warp = threadIdx.x / 32;
  const int wm = warp / 4;  // 0..1
  const int wn = warp % 4;  // 0..3
  const bf16 zero = __float2bfloat16(0.f);

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.f);

  // VEC (D and N multiples of 8): 16-byte loads, one A chunk and two B
  // chunks a thread, with the next K tile held in registers while the
  // tensor cores work on the current one
  static_assert(PM * PK / 8 == P_THREADS && PK * PN / 8 == 2 * P_THREADS, "tile split");
  const uint4 zero4 = make_uint4(0u, 0u, 0u, 0u);
  uint4 ra = zero4, rb[2] = {zero4, zero4};
  const int ar = threadIdx.x / (PK / 8), ac = (threadIdx.x % (PK / 8)) * 8;
  auto fetch = [&](int k0) {
    const int m = m0 + ar, k = k0 + ac;
    ra = (m < M && k < D) ? __ldg(reinterpret_cast<const uint4*>(x + (size_t)m * D + k)) : zero4;
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const int i = threadIdx.x + u * P_THREADS;
      const int kb = k0 + i / (PN / 8), n = n0 + (i % (PN / 8)) * 8;
      rb[u] = (kb < D && n < N) ? __ldg(reinterpret_cast<const uint4*>(w + (size_t)kb * N + n))
                                : zero4;
    }
  };
  if constexpr (VEC) fetch(0);

  for (int k0 = 0; k0 < D; k0 += PK) {
    if constexpr (VEC) {
      *reinterpret_cast<uint4*>(a_s + ar * AS + ac) = ra;
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const int i = threadIdx.x + u * P_THREADS;
        *reinterpret_cast<uint4*>(b_s + (i / (PN / 8)) * BS + (i % (PN / 8)) * 8) = rb[u];
      }
    } else {
      for (int i = threadIdx.x; i < PM * PK; i += P_THREADS) {
        const int r = i / PK, c = i % PK;
        const int m = m0 + r, k = k0 + c;
        a_s[r * AS + c] = (m < M && k < D) ? x[(size_t)m * D + k] : zero;
      }
      for (int i = threadIdx.x; i < PK * PN; i += P_THREADS) {
        const int r = i / PN, c = i % PN;
        const int k = k0 + r, n = n0 + c;
        b_s[r * BS + c] = (k < D && n < N) ? w[(size_t)k * N + n] : zero;
      }
    }
    __syncthreads();
    if constexpr (VEC) {
      if (k0 + PK < D) fetch(k0 + PK);
    }
#pragma unroll
    for (int kk = 0; kk < PK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> af[2];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> bfr[2];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        wmma::load_matrix_sync(af[i], a_s + (wm * 32 + i * 16) * AS + kk, AS);
#pragma unroll
      for (int j = 0; j < 2; ++j)
        wmma::load_matrix_sync(bfr[j], b_s + kk * BS + wn * 32 + j * 16, BS);
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
      wmma::store_matrix_sync(c_s + (wm * 32 + i * 16) * CS + wn * 32 + j * 16,
                              acc[i][j], CS, wmma::mem_row_major);
  __syncthreads();
  const bf16* bd = bias + (size_t)dir * N;
  bf16* out = xw + (size_t)dir * M * N;
  for (int i = threadIdx.x; i < PM * PN; i += P_THREADS) {
    const int r = i / PN, c = i % PN;
    const int m = m0 + r, n = n0 + c;
    if (m < M && n < N) out[(size_t)m * N + n] = bias_epilogue<bf16>(c_s[r * CS + c], bd[n]);
  }
}

// ---------------------------------------------------------------------------
// (a) projection, f32: SIMT tiles (no tensor cores, no TF32)
// ---------------------------------------------------------------------------

constexpr int SM_ = 64, SN = 64, SK = 16;
constexpr int S_THREADS = 256;  // 16 x 16 threads, 4 x 4 outputs each

template <typename T>
__global__ void __launch_bounds__(S_THREADS) proj_simt(
    const T* __restrict__ x, const T* __restrict__ wx, const T* __restrict__ bias,
    T* __restrict__ xw, int M, int D, int N) {
  __shared__ __align__(16) float a_s[SK][SM_ + 4];  // transposed: [k][m]
  __shared__ __align__(16) float b_s[SK][SN + 4];
  const int dir = blockIdx.z;
  const T* w = wx + (size_t)dir * D * N;
  const int m0 = blockIdx.y * SM_;
  const int n0 = blockIdx.x * SN;
  const int tx = threadIdx.x % 16;
  const int ty = threadIdx.x / 16;
  float acc[4][4] = {};

  for (int k0 = 0; k0 < D; k0 += SK) {
    for (int i = threadIdx.x; i < SM_ * SK; i += S_THREADS) {
      const int r = i / SK, c = i % SK;
      const int m = m0 + r, k = k0 + c;
      a_s[c][r] = (m < M && k < D) ? to_f(x[(size_t)m * D + k]) : 0.f;
    }
    for (int i = threadIdx.x; i < SK * SN; i += S_THREADS) {
      const int r = i / SN, c = i % SN;
      const int k = k0 + r, n = n0 + c;
      b_s[r][c] = (k < D && n < N) ? to_f(w[(size_t)k * N + n]) : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < SK; ++k) {
      const float4 a = *reinterpret_cast<const float4*>(&a_s[k][ty * 4]);
      const float4 b = *reinterpret_cast<const float4*>(&b_s[k][tx * 4]);
      const float av[4] = {a.x, a.y, a.z, a.w};
      const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  }
  const T* bd = bias + (size_t)dir * N;
  T* out = xw + (size_t)dir * M * N;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int m = m0 + ty * 4 + i;
    if (m >= M) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + tx * 4 + j;
      if (n < N) out[(size_t)m * N + n] = bias_epilogue<T>(acc[i][j], bd[n]);
    }
  }
}

// ---------------------------------------------------------------------------
// (b) persistent recurrence
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

template <typename T>
__global__ void __launch_bounds__(R_THREADS) blstm_recur_kernel(
    const T* __restrict__ xw,        // [2, T, B, 4H]
    const int* __restrict__ lengths, // [B]
    const T* __restrict__ wh,        // [2, H, 4H]
    T* __restrict__ y,               // [T, B, 2H] masked outputs
    T* hbuf,                         // [2 dir][2 slot][B, H] scratch
    unsigned int* counters,          // [2], zero at launch
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
    if (s > 0) stage_h(hin, h_s, B, H, L.hp);  // h_{-1} = 0 is already staged
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
      const float gi = sigmoid_f(xg[0] + a0);
      const float gf = sigmoid_f(xg[1] + a1 + forget_bias);
      const float gg = tanhf(xg[2] + a2);
      const float go = sigmoid_f(xg[3] + a3);
      const float c_new = gf * c_s[p] + gi * gg;
      const T h_new = from_f<T>(go * tanhf(c_new));
      const bool valid = t < __ldg(lengths + b);
      if (valid) c_s[p] = c_new;
      // masked carry: padding frames keep h (the staged value is exact)
      hout[(size_t)b * H + j] = valid ? h_new : from_f<T>(h_s[(size_t)b * L.hp + j]);
      y[((size_t)t * B + b) * 2 * H + (size_t)dir * H + j] = valid ? h_new : from_f<T>(0.f);
    }

    // hand h over to the other blocks of this direction
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
}

template <typename T>
int launch_recur(const T* xw, const int* lengths, const T* wh, T* y, T* hbuf,
                 unsigned int* counters, int Tn, int B, int H, int hs,
                 float forget_bias, void* stream) {
  if (Tn <= 0 || B <= 0) return 0;
  if (hs <= 0 || H <= 0) return (int)cudaErrorInvalidValue;
  const RecurLayout L = recur_layout(B, H, hs);
  auto kernel = blstm_recur_kernel<T>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)L.smem_bytes);
  if (err != cudaSuccess) return (int)err;
  int G = (H + hs - 1) / hs;
  int device = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&device)) != cudaSuccess) return (int)err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device)) != cudaSuccess)
    return (int)err;
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, R_THREADS,
                                                            L.smem_bytes)) != cudaSuccess)
    return (int)err;
  if (2 * G > per_sm * sms) return (int)cudaErrorCooperativeLaunchTooLarge;
  void* args[] = {(void*)&xw, (void*)&lengths, (void*)&wh, (void*)&y, (void*)&hbuf,
                  (void*)&counters, (void*)&Tn, (void*)&B, (void*)&H, (void*)&hs,
                  (void*)&G, (void*)&forget_bias};
  err = cudaLaunchCooperativeKernel((const void*)kernel, dim3(2 * G), dim3(R_THREADS), args,
                                    L.smem_bytes, (cudaStream_t)stream);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int nabu_blstm_proj_bf16(const void* x, const void* wx, const void* b, void* xw,
                                    int M, int D, int N, void* stream) {
  if (M <= 0) return 0;
  const dim3 grid((N + PN - 1) / PN, (M + PM - 1) / PM, 2);
  if (D % 8 == 0 && N % 8 == 0) {
    proj_wmma_bf16<true><<<grid, P_THREADS, 0, (cudaStream_t)stream>>>(
        (const bf16*)x, (const bf16*)wx, (const bf16*)b, (bf16*)xw, M, D, N);
  } else {
    proj_wmma_bf16<false><<<grid, P_THREADS, 0, (cudaStream_t)stream>>>(
        (const bf16*)x, (const bf16*)wx, (const bf16*)b, (bf16*)xw, M, D, N);
  }
  return (int)cudaGetLastError();
}

extern "C" int nabu_blstm_proj_f32(const void* x, const void* wx, const void* b, void* xw,
                                   int M, int D, int N, void* stream) {
  if (M <= 0) return 0;
  const dim3 grid((N + SN - 1) / SN, (M + SM_ - 1) / SM_, 2);
  proj_simt<float><<<grid, S_THREADS, 0, (cudaStream_t)stream>>>(
      (const float*)x, (const float*)wx, (const float*)b, (float*)xw, M, D, N);
  return (int)cudaGetLastError();
}

extern "C" int nabu_blstm_recur_bf16(const void* xw, const int* lengths, const void* wh,
                                     void* y, void* hbuf, unsigned int* counters, int T,
                                     int B, int H, int hs, float forget_bias, void* stream) {
  return launch_recur<bf16>((const bf16*)xw, lengths, (const bf16*)wh, (bf16*)y, (bf16*)hbuf,
                            counters, T, B, H, hs, forget_bias, stream);
}

extern "C" int nabu_blstm_recur_f32(const void* xw, const int* lengths, const void* wh,
                                    void* y, void* hbuf, unsigned int* counters, int T, int B,
                                    int H, int hs, float forget_bias, void* stream) {
  return launch_recur<float>((const float*)xw, lengths, (const float*)wh, (float*)y,
                             (float*)hbuf, counters, T, B, H, hs, forget_bias, stream);
}
