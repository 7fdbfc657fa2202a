// Device helpers shared by the serial walks and chains of blstm.cu,
// blstm_v1.cu and lstm.cu: element conversions, the row groups' hand-off
// at a counter (a release add to arrive, an acquire load to wait), the
// warp reduce-scatter, the bf16 mma, the step probe's stamp (also ctc.cu's)
// and the co-residency check of a cooperative launch. ops/kernels/build.py folds
// this header into the hash of every library it builds.

#pragma once

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

// the arrival at a counter: a release add at gpu scope (after a block
// barrier, it orders the block's earlier stores before the count)
__device__ __forceinline__ void red_release(unsigned int* p) {
  asm volatile("red.release.gpu.global.add.u32 [%0], 1;" : : "l"(p) : "memory");
}

__device__ __forceinline__ float sigmoid_f(float x) { return 1.f / (1.f + expf(-x)); }

// one round of a warp's reduce-scatter over N values a lane: after the
// round of offset O the lane keeps the half of v selected by lane & O,
// added to its partner's copy; from O = 16, five rounds leave lane l the
// sums over the warp of v[l N / 32 + k], k < N / 32, in a fixed order;
// from O = 8, four rounds leave lane l the sums over its half warp of
// v[(l % 16) N / 16 + k], k < N / 16
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

__device__ __forceinline__ void mma_16816(float* d, uint32_t a0, uint32_t a1, uint32_t a2,
                                          uint32_t a3, uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// the probe's stamp: the cycles since the last one, added to spent[part]
template <bool PROBE>
__device__ __forceinline__ void probe_stamp(unsigned long long* spent, int part,
                                            unsigned long long& stamp) {
  if constexpr (PROBE) {
    const unsigned long long now = clock64();
    spent[part] += now - stamp;
    stamp = now;
  }
}

// co-residency check of a cooperative launch of `blocks` blocks of
// `threads` threads and `smem` bytes of dynamic shared memory
template <typename K>
cudaError_t check_coresident(K kernel, int blocks, int threads, size_t smem) {
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return err;
  int device = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&device)) != cudaSuccess) return err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device)) != cudaSuccess)
    return err;
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, smem)) !=
      cudaSuccess)
    return err;
  if (blocks > per_sm * sms) return cudaErrorCooperativeLaunchTooLarge;
  return cudaSuccess;
}

}  // namespace
