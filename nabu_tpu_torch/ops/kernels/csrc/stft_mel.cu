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
// ~0.45 GFLOP, ~7 us at the 67 TFLOP/s non-tensor f32 rate. This kernel
// computes the DFT as a product, as the TPU kernel does: 13.4 GFLOP of
// f32 FMA, ~0.2 ms at that rate, so its own operations bound it at ~12x
// the function's bound; an FFT formulation is the way down to it. It
// stays in f32 on the FMA pipes, with no TF32: near-silent mel bins
// carry energies so small that a reduced-precision DFT puts several
// log-units of noise into them (the hazard the TPU kernel's notes
// measure for bf16).
//
// What the design does about it: a block owns TILE_N frames and stages
// them once in shared memory, transposed, so that each thread (one DFT
// bin k) reads the TILE_N samples of one time index as float4
// broadcasts and keeps 2 x TILE_N accumulators in registers: 64 FMAs
// for every 8 shared-memory loads and 2 loads of the cos|sin column,
// which the L2 keeps (800 KB). The power rows go to shared memory and
// the block then applies the Mel projection and the log, so only the
// [N, M] log-mel leaves the chip's memory hierarchy.

#include <cuda_runtime.h>

namespace {

constexpr int TILE_N = 32;              // frames per block
constexpr int FS = TILE_N + 4;          // padded row stride of the staged frames
constexpr int THREADS = 256;

__global__ void __launch_bounds__(THREADS) stft_mel_kernel(
    const float* __restrict__ frames,   // [N, W]
    const float* __restrict__ cossin,   // [W, 2K] window-folded cos | sin
    const float* __restrict__ mel,      // [K, M] mel / nfft
    float* __restrict__ out,            // [N, M]
    int N, int W, int K, int M) {
  extern __shared__ __align__(16) float smem[];
  float* f_s = smem;                    // [W][FS] frames, transposed
  float* p_s = smem + (size_t)W * FS;   // [TILE_N][K] power
  const int n0 = blockIdx.x * TILE_N;
  const int rows = min(TILE_N, N - n0);

  // stage the frames (coalesced along w); rows past N are zeros
  for (int i = threadIdx.x; i < TILE_N * W; i += blockDim.x) {
    const int r = i / W;
    const int w = i - r * W;
    f_s[w * FS + r] = (r < rows) ? frames[(size_t)(n0 + r) * W + w] : 0.f;
  }
  __syncthreads();

  const size_t ld = 2 * (size_t)K;
  for (int k = threadIdx.x; k < K; k += blockDim.x) {
    float re[TILE_N], im[TILE_N];
#pragma unroll
    for (int r = 0; r < TILE_N; ++r) {
      re[r] = 0.f;
      im[r] = 0.f;
    }
    const float* cp = cossin + k;
    const float* sp = cossin + K + k;
    for (int w = 0; w < W; ++w) {
      const float c = __ldg(cp + w * ld);
      const float s = __ldg(sp + w * ld);
      const float4* fw = reinterpret_cast<const float4*>(f_s + w * FS);
#pragma unroll
      for (int q = 0; q < TILE_N / 4; ++q) {
        const float4 f = fw[q];
        re[4 * q + 0] = fmaf(f.x, c, re[4 * q + 0]);
        im[4 * q + 0] = fmaf(f.x, s, im[4 * q + 0]);
        re[4 * q + 1] = fmaf(f.y, c, re[4 * q + 1]);
        im[4 * q + 1] = fmaf(f.y, s, im[4 * q + 1]);
        re[4 * q + 2] = fmaf(f.z, c, re[4 * q + 2]);
        im[4 * q + 2] = fmaf(f.z, s, im[4 * q + 2]);
        re[4 * q + 3] = fmaf(f.w, c, re[4 * q + 3]);
        im[4 * q + 3] = fmaf(f.w, s, im[4 * q + 3]);
      }
    }
#pragma unroll
    for (int r = 0; r < TILE_N; ++r) {
      p_s[r * K + k] = re[r] * re[r] + im[r] * im[r];
    }
  }
  __syncthreads();

  for (int i = threadIdx.x; i < rows * M; i += blockDim.x) {
    const int r = i / M;
    const int m = i - r * M;
    const float* pr = p_s + r * K;
    float acc = 0.f;
    for (int k = 0; k < K; ++k) {
      acc = fmaf(pr[k], __ldg(mel + (size_t)k * M + m), acc);
    }
    out[(size_t)(n0 + r) * M + m] = logf(fmaxf(acc, 1e-30f));
  }
}

}  // namespace

extern "C" int nabu_stft_mel_f32(const float* frames, const float* cossin,
                                 const float* mel, float* out, int N, int W,
                                 int K, int M, void* stream) {
  if (N <= 0) return 0;
  const size_t smem = sizeof(float) * ((size_t)W * FS + (size_t)TILE_N * K);
  cudaError_t err = cudaFuncSetAttribute(
      stft_mel_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((N + TILE_N - 1) / TILE_N);
  stft_mel_kernel<<<grid, THREADS, smem, (cudaStream_t)stream>>>(
      frames, cossin, mel, out, N, W, K, M);
  return (int)cudaGetLastError();
}
