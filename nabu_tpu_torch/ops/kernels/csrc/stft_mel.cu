// Fused STFT power spectrum + Mel projection + log for Hopper (sm_90a).
//
// Replaces the TPU kernel nabu_tpu/ops/pallas/stft_mel.py
// (stft_mel_pallas -> _stft_mel_kernel): frames [N, W] @ window-folded
// cos|sin [W, 2K], then re^2 + im^2, then @ (mel / nfft) [K, M], then
// log(max(., 1e-30)). The window and 1/nfft are folded into the
// constant operands on the host, as the TPU wrapper does.
//
// What bounds it on the H100: the function's least time is its memory
// traffic. At the serving shape (N = 32 x 1024 frames, W = 400, K = 256,
// M = 40) it moves 58.5 MB, ~17.5 us at 3.35 TB/s; its least work is a
// real FFT of nfft = 512 points per frame plus the sparse mel product,
// ~0.45 GFLOP. This kernel computes the DFT as a product, as the TPU
// kernel and the plain version do: 13.4 GFLOP of f32 FMA, >= 0.2 ms at
// the 67 TFLOP/s non-tensor f32 rate, so its operations bound it. A real
// f32 FFT was built and measured on the H100 (chip_smoke.py): 0.068 ms,
// but 1.1e-3 from the plain version in a near-silent mel band, against
// the 1e-4 tolerance. The plain version's own rounding (its f32 table,
// its sum over W in order) sets such a band, further from the float64
// spectrum than 1e-4 (chip_smoke.py prints both distances), so only the
// same products summed in the same order agree to 1e-4. It stays in f32
// on the FMA pipes, with no TF32: a reduced-precision DFT puts several
// log-units of noise into such bands (the hazard the TPU kernel's notes
// measure for bf16).
//
// What the design does about it: the product as register-blocked FFMA
// tiles, each output summed over the window taps in order, one FFMA a
// tap (the plain version's order). A block owns 64 frames and all 256
// bins, so the power and the mel product stay in the block; thread t
// holds 16 frames x 4 bins, re and im (128 accumulators, one block an
// SM: up to 255 registers, no spill), and each tap reads four float4 of
// frames (a warp's are one broadcast each) and two of the table from
// shared memory for 128 FFMA. The taps stream through a 2-stage cp.async
// ring, 8 taps a stage: the frames transposed by 4-byte copies (banks 4 w
// + r, all distinct), the cos and sin rows by 16-byte copies; the table
// is read from L2 once per 64 frames. The power rows (re^2 + im^2,
// unfused, as the plain version rounds them) then take the ring's shared
// memory, and each filter sums its own bin range only (its first and end
// bins and its weights, mel / nfft, packed on the host: the zero weights
// outside add nothing), in ascending bin order, and writes log(max(.,
// 1e-30)): only [N, M] leaves the chip.

#include <cuda_runtime.h>
#include <stdint.h>

#include "serial.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int TF = 64;                 // frames a block
constexpr int FPT = TF / 4;            // frames a thread
constexpr int KB = 256;                // bins a block (all of them): 64 threads x 4
constexpr int WC = 8;                  // window taps a stage
constexpr int STAGES = 2;
constexpr int F_LD = TF + 4;           // staged frames [WC][F_LD], transposed
constexpr int C_LD = 2 * KB;           // staged table [WC][cos KB | sin KB]
constexpr int STAGE = WC * (C_LD + F_LD);
constexpr int P_LD = KB + 4;           // power rows [TF][P_LD]
constexpr int SMEM_MAIN = TF * P_LD > STAGES * STAGE ? TF * P_LD : STAGES * STAGE;
static_assert(WC % 8 == 0 && WC * TF % THREADS == 0, "the frames' copies take taps by 8");

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}
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

// Issue the copies of taps [w0, w0 + WC) into a stage: the frames' taps
// transposed, 4 bytes each (a warp takes 8 consecutive taps, one sector,
// of 4 frames: banks 4 w + r, all distinct), and the table's rows, cos
// and sin halves each at column 0 and KB, 16 bytes each where K is a
// multiple of 4; zeros past N, W and K.
__device__ __forceinline__ void stage(float* s, const float* frames, const float* cossin,
                                      int n0, int w0, int N, int W, int K, bool vec) {
  float* fs = s;
  float* cs = s + WC * F_LD;
#pragma unroll
  for (int u = 0; u < WC * TF / THREADS; ++u) {
    const int i = threadIdx.x + u * THREADS;
    const int w = (i & 7) + 8 * (i / (8 * TF)), r = (i >> 3) % TF;
    const bool in = n0 + r < N && w0 + w < W;
    cp_async4(fs + w * F_LD + r, in ? frames + (size_t)(n0 + r) * W + w0 + w : frames,
              in ? 4 : 0);
  }
  if (vec) {
#pragma unroll
    for (int u = 0; u < WC * C_LD / 4 / THREADS; ++u) {
      const int i = threadIdx.x + u * THREADS;
      const int w = i / (C_LD / 4), c = (i % (C_LD / 4)) * 4;  // c < KB: cos, else sin
      const int half = c / KB, k = c % KB;
      const int bytes = w0 + w < W ? 4 * max(0, min(4, K - k)) : 0;
      cp_async16(cs + w * C_LD + c,
                 bytes ? cossin + (size_t)(w0 + w) * 2 * K + half * K + k : cossin, bytes);
    }
    return;
  }
#pragma unroll
  for (int u = 0; u < WC * C_LD / THREADS; ++u) {
    const int i = threadIdx.x + u * THREADS;
    const int w = i / C_LD, c = i % C_LD;
    const int half = c / KB, k = c % KB;
    const bool in = w0 + w < W && k < K;
    cp_async4(cs + w * C_LD + c, in ? cossin + (size_t)(w0 + w) * 2 * K + half * K + k : cossin,
              in ? 4 : 0);
  }
}

// the epilogue of both kernels: each filter of the block's power rows
// [TF][P_LD] sums its own bin range in ascending bin order and writes
// log(max(., 1e-30))
__device__ __forceinline__ void mel_log_rows(const float* p_s, const int* rng_s,
                                             const float* wts_s, float* out, int n0, int N,
                                             int M) {
  const int rows = min(TF, N - n0);
  for (int i = threadIdx.x; i < rows * M; i += THREADS) {
    const int r = i / M, m = i - r * M;
    const int lo = rng_s[3 * m], hi = rng_s[3 * m + 1], off = rng_s[3 * m + 2] - lo;
    const float* pr = p_s + r * P_LD;
    float acc = 0.f;
    for (int k = lo; k < hi; ++k) acc = fmaf(pr[k], wts_s[off + k], acc);
    out[(size_t)(n0 + r) * M + m] = logf(fmaxf(acc, 1e-30f));
  }
}

__global__ void __launch_bounds__(THREADS, 1) stft_mel_dft_kernel(
    const float* __restrict__ frames,   // [N, W]
    const float* __restrict__ cossin,   // [W, 2K] window-folded cos | sin
    const int* __restrict__ ranges,     // [M, 3] first bin, end bin, offset in weights
    const float* __restrict__ weights,  // [nnz] mel / nfft over the ranges
    float* __restrict__ out,            // [N, M]
    int N, int W, int K, int M, int nnz) {
  extern __shared__ __align__(16) float smem[];
  float* ring = smem;                                // [STAGES][STAGE], then the power rows
  float* wts_s = smem + SMEM_MAIN;                   // [nnz]
  int* rng_s = reinterpret_cast<int*>(wts_s + nnz);  // [M, 3]
  const int n0 = blockIdx.x * TF;
  const int ntiles = (W + WC - 1) / WC;
  const bool vec = (K & 3) == 0;
  for (int i = threadIdx.x; i < nnz; i += THREADS) wts_s[i] = weights[i];
  for (int i = threadIdx.x; i < 3 * M; i += THREADS) rng_s[i] = ranges[i];
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < ntiles) stage(ring + s * STAGE, frames, cossin, n0, s * WC, N, W, K, vec);
    cp_async_commit();
  }

  // thread t: frames 16 (t / 64) + [0, 16), bins 4 (t % 64) + [0, 4), re and im
  const int fr = FPT * (threadIdx.x / 64), bn = 4 * (threadIdx.x % 64);
  float re[FPT][4], im[FPT][4];
#pragma unroll
  for (int i = 0; i < FPT; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      re[i][j] = 0.f;
      im[i][j] = 0.f;
    }
  for (int t = 0; t < ntiles; ++t) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();
    if (t + STAGES - 1 < ntiles)
      stage(ring + ((t + STAGES - 1) % STAGES) * STAGE, frames, cossin, n0,
            (t + STAGES - 1) * WC, N, W, K, vec);
    cp_async_commit();
    const float* fs = ring + (t % STAGES) * STAGE;
    const float* cs = fs + WC * F_LD;
#pragma unroll
    for (int w = 0; w < WC; ++w) {
      float fv[FPT];
#pragma unroll
      for (int q = 0; q < FPT / 4; ++q) {
        const float4 f = *reinterpret_cast<const float4*>(fs + w * F_LD + fr + 4 * q);
        fv[4 * q] = f.x;
        fv[4 * q + 1] = f.y;
        fv[4 * q + 2] = f.z;
        fv[4 * q + 3] = f.w;
      }
      const float4 c4 = *reinterpret_cast<const float4*>(cs + w * C_LD + bn);
      const float4 s4 = *reinterpret_cast<const float4*>(cs + w * C_LD + KB + bn);
      const float cv[4] = {c4.x, c4.y, c4.z, c4.w};
      const float sv[4] = {s4.x, s4.y, s4.z, s4.w};
#pragma unroll
      for (int i = 0; i < FPT; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          re[i][j] = fmaf(fv[i], cv[j], re[i][j]);
          im[i][j] = fmaf(fv[i], sv[j], im[i][j]);
        }
    }
  }
  cp_async_wait<0>();
  __syncthreads();  // every thread is done with the ring: the power rows take it

  float* p_s = ring;  // [TF][P_LD]
#pragma unroll
  for (int i = 0; i < FPT; ++i) {
    float4 p;
    p.x = __fadd_rn(__fmul_rn(re[i][0], re[i][0]), __fmul_rn(im[i][0], im[i][0]));
    p.y = __fadd_rn(__fmul_rn(re[i][1], re[i][1]), __fmul_rn(im[i][1], im[i][1]));
    p.z = __fadd_rn(__fmul_rn(re[i][2], re[i][2]), __fmul_rn(im[i][2], im[i][2]));
    p.w = __fadd_rn(__fmul_rn(re[i][3], re[i][3]), __fmul_rn(im[i][3], im[i][3]));
    *reinterpret_cast<float4*>(p_s + (fr + i) * P_LD + bn) = p;
  }
  __syncthreads();
  mel_log_rows(p_s, rng_s, wts_s, out, n0, N, M);
}

size_t smem_bytes(int M, int nnz) {
  return sizeof(float) * ((size_t)SMEM_MAIN + nnz + 3 * (size_t)M);
}

// ---------------------------------------------------------------------------
// the bf16 mode: bf16 frames and table, the product on the tensor cores
// ---------------------------------------------------------------------------

constexpr int BWC = 32;                 // window taps a stage: 2 k-steps of 16
constexpr int BSTAGES = 3;
constexpr int BF_LD = BWC + 8;          // staged frames [TF][BF_LD] bf16: 80-byte rows
constexpr int BC_LD = 2 * KB + 8;       // staged table [BWC][cos KB | sin KB] bf16: 1040-byte rows
constexpr int BSTAGE = 2 * (TF * BF_LD + BWC * BC_LD);  // bytes
constexpr int BMAIN = BSTAGES * BSTAGE > 4 * TF * P_LD ? BSTAGES * BSTAGE : 4 * TF * P_LD;
static_assert(BSTAGE % 16 == 0 && (2 * TF * BF_LD) % 16 == 0, "16-byte stage offsets");
static_assert(KB == 32 * (THREADS / 32), "a warp owns 32 bins");

__device__ __forceinline__ void ldsm_x4(uint32_t* r, const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}
__device__ __forceinline__ void ldsm_x4_trans(uint32_t* r, const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}

// Issue the copies of taps [w0, w0 + BWC) into a stage: the frames' rows
// (64 frames x 4 chunks of 8 taps) and the table's rows, cos and sin halves
// at columns 0 and KB; zeros past N, W and K. With vec (W and K multiples
// of 8, 16-byte aligned operands) 16-byte cp.async copies; otherwise 2-byte
// loads and stores (visible after the next block barrier).
__device__ __forceinline__ void stage_bf16(unsigned short* s, const unsigned short* frames,
                                           const unsigned short* cossin, int n0, int w0, int N,
                                           int W, int K, bool vec) {
  unsigned short* fs = s;
  unsigned short* cs = s + TF * BF_LD;
  if (vec) {
    {
      const int r = threadIdx.x / 4, c = 8 * (threadIdx.x % 4);  // 64 x 4 chunks
      const int bytes = n0 + r < N ? 2 * max(0, min(8, W - (w0 + c))) : 0;
      cp_async16(reinterpret_cast<float*>(fs + r * BF_LD + c),
                 reinterpret_cast<const float*>(bytes ? frames + (size_t)(n0 + r) * W + w0 + c
                                                      : frames),
                 bytes);
    }
#pragma unroll
    for (int u = 0; u < BWC * (2 * KB / 8) / THREADS; ++u) {
      const int i = threadIdx.x + u * THREADS;
      const int w = i / (2 * KB / 8), c = 8 * (i % (2 * KB / 8));
      const int half = c / KB, k = c % KB;
      const int bytes = w0 + w < W ? 2 * max(0, min(8, K - k)) : 0;
      cp_async16(reinterpret_cast<float*>(cs + w * BC_LD + c),
                 reinterpret_cast<const float*>(
                     bytes ? cossin + (size_t)(w0 + w) * 2 * K + half * K + k : cossin),
                 bytes);
    }
    return;
  }
  for (int i = threadIdx.x; i < TF * BWC; i += THREADS) {
    const int r = i / BWC, w = i % BWC;
    fs[r * BF_LD + w] =
        n0 + r < N && w0 + w < W ? frames[(size_t)(n0 + r) * W + w0 + w] : (unsigned short)0;
  }
  for (int i = threadIdx.x; i < BWC * 2 * KB; i += THREADS) {
    const int w = i / (2 * KB), c = i % (2 * KB);
    const int half = c / KB, k = c % KB;
    cs[w * BC_LD + c] = w0 + w < W && k < K ? cossin[(size_t)(w0 + w) * 2 * K + half * K + k]
                                            : (unsigned short)0;
  }
}

__global__ void __launch_bounds__(THREADS, 1) stft_mel_dft_bf16_kernel(
    const unsigned short* __restrict__ frames,  // [N, W] bf16
    const unsigned short* __restrict__ cossin,  // [W, 2K] bf16 window-folded cos | sin
    const int* __restrict__ ranges,             // [M, 3] first bin, end bin, offset in weights
    const float* __restrict__ weights,          // [nnz] mel / nfft over the ranges
    float* __restrict__ out,                    // [N, M]
    int N, int W, int K, int M, int nnz, bool vec) {
  extern __shared__ __align__(16) unsigned char bsmem[];
  unsigned short* ring = reinterpret_cast<unsigned short*>(bsmem);  // [BSTAGES] stages
  float* wts_s = reinterpret_cast<float*>(bsmem + BMAIN);            // [nnz]
  int* rng_s = reinterpret_cast<int*>(wts_s + nnz);                  // [M, 3]
  const int n0 = blockIdx.x * TF;
  const int ntiles = (W + BWC - 1) / BWC;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t4 = lane & 3;
  for (int i = threadIdx.x; i < nnz; i += THREADS) wts_s[i] = weights[i];
  for (int i = threadIdx.x; i < 3 * M; i += THREADS) rng_s[i] = ranges[i];
#pragma unroll
  for (int s = 0; s < BSTAGES - 1; ++s) {
    if (s < ntiles)
      stage_bf16(ring + s * (BSTAGE / 2), frames, cossin, n0, s * BWC, N, W, K, vec);
    cp_async_commit();
  }

  // warp w: the 64 frames (4 m-tiles) x its 32 bins (4 n-tiles of cos, 4
  // of sin); acc[m][n] holds the m16n8 fragment of n-tile n (cos n < 4,
  // sin n - 4), so a thread holds re and im of the same (frame, bin)
  float acc[4][8][4];
#pragma unroll
  for (int m = 0; m < 4; ++m)
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[m][n][q] = 0.f;
  for (int t = 0; t < ntiles; ++t) {
    cp_async_wait<BSTAGES - 2>();
    __syncthreads();
    if (t + BSTAGES - 1 < ntiles)
      stage_bf16(ring + ((t + BSTAGES - 1) % BSTAGES) * (BSTAGE / 2), frames, cossin, n0,
                 (t + BSTAGES - 1) * BWC, N, W, K, vec);
    cp_async_commit();
    const unsigned short* fs = ring + (t % BSTAGES) * (BSTAGE / 2);
    const unsigned short* cs = fs + TF * BF_LD;
#pragma unroll
    for (int ks = 0; ks < BWC / 16; ++ks) {
      // A: rows (lane & 15) of each m-tile, taps 16 ks + 8 (lane >> 4);
      // B (transposed on the load): taps 16 ks + (lane & 15), bins 8
      // (lane >> 4) of each pair of n-tiles
      uint32_t a[4][4], b[8][2];
#pragma unroll
      for (int m = 0; m < 4; ++m)
        ldsm_x4(a[m], fs + (16 * m + (lane & 15)) * BF_LD + 16 * ks + 8 * (lane >> 4));
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int p = 0; p < 2; ++p) {
          uint32_t r[4];
          ldsm_x4_trans(r, cs + (16 * ks + (lane & 15)) * BC_LD + h * KB + 32 * warp + 16 * p +
                               8 * (lane >> 4));
          b[4 * h + 2 * p][0] = r[0];
          b[4 * h + 2 * p][1] = r[1];
          b[4 * h + 2 * p + 1][0] = r[2];
          b[4 * h + 2 * p + 1][1] = r[3];
        }
#pragma unroll
      for (int m = 0; m < 4; ++m)
#pragma unroll
        for (int n = 0; n < 8; ++n)
          mma_16816(acc[m][n], a[m][0], a[m][1], a[m][2], a[m][3], b[n][0], b[n][1]);
    }
  }
  cp_async_wait<0>();
  __syncthreads();  // every thread is done with the ring: the power rows take it

  float* p_s = reinterpret_cast<float*>(bsmem);  // [TF][P_LD]
#pragma unroll
  for (int m = 0; m < 4; ++m)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float* re = acc[m][j];
      const float* im = acc[m][4 + j];
      const int bin = 32 * warp + 8 * j + 2 * t4;
#pragma unroll
      for (int h = 0; h < 2; ++h) {  // rows g and g + 8 of the m-tile
        float2 p;
        p.x = __fadd_rn(__fmul_rn(re[2 * h], re[2 * h]), __fmul_rn(im[2 * h], im[2 * h]));
        p.y = __fadd_rn(__fmul_rn(re[2 * h + 1], re[2 * h + 1]),
                        __fmul_rn(im[2 * h + 1], im[2 * h + 1]));
        *reinterpret_cast<float2*>(p_s + (16 * m + 8 * h + g) * P_LD + bin) = p;
      }
    }
  __syncthreads();
  mel_log_rows(p_s, rng_s, wts_s, out, n0, N, M);
}

size_t smem_bytes_bf16(int M, int nnz) {
  return (size_t)BMAIN + sizeof(float) * ((size_t)nnz + 3 * (size_t)M);
}

}  // namespace

// K <= 256 bins (the wrapper, ops/stft_mel.check_design, raises before any
// launch otherwise)
extern "C" int nabu_stft_mel_f32(const float* frames, const float* cossin, const int* ranges,
                                 const float* weights, float* out, int N, int W, int K, int M,
                                 int nnz, void* stream) {
  if (N <= 0) return 0;
  if (W <= 0 || K <= 0 || K > KB || M <= 0 || nnz < 0) return (int)cudaErrorInvalidValue;
  const size_t smem = smem_bytes(M, nnz);
  cudaError_t err = cudaFuncSetAttribute(
      stft_mel_dft_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  stft_mel_dft_kernel<<<(N + TF - 1) / TF, THREADS, smem, (cudaStream_t)stream>>>(
      frames, cossin, ranges, weights, out, N, W, K, M, nnz);
  return (int)cudaGetLastError();
}

// the bf16 mode: frames and the folded table in bf16 (the TPU kernel's
// default dft_dtype), the same limits; 16-byte copies where W and K are
// multiples of 8 and the operands 16-byte aligned
extern "C" int nabu_stft_mel_bf16(const void* frames, const void* cossin, const int* ranges,
                                  const float* weights, float* out, int N, int W, int K, int M,
                                  int nnz, void* stream) {
  if (N <= 0) return 0;
  if (W <= 0 || K <= 0 || K > KB || M <= 0 || nnz < 0) return (int)cudaErrorInvalidValue;
  const bool vec = W % 8 == 0 && K % 8 == 0 && ((uintptr_t)frames & 15) == 0 &&
                   ((uintptr_t)cossin & 15) == 0;
  const size_t smem = smem_bytes_bf16(M, nnz);
  cudaError_t err = cudaFuncSetAttribute(
      stft_mel_dft_bf16_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  stft_mel_dft_bf16_kernel<<<(N + TF - 1) / TF, THREADS, smem, (cudaStream_t)stream>>>(
      (const unsigned short*)frames, (const unsigned short*)cossin, ranges, weights, out, N, W,
      K, M, nnz, vec);
  return (int)cudaGetLastError();
}
