// K4: aom_quantize_b over a batch of coefficient rows with per-position
// parameter vectors (DC/AC already splatted) — every quantize site of the
// wavefront KEY, the P-frame residual coding and the merge levels.
//
// Replaces aom_av1_lavish_tpu/ops/pallas_kernels.py _quant_kernel (via
// _quant_pallas_fn / quantize_b_vec), whose inline twin
// wavefront._quantize_jnp is what the reference's pipelines run.  It is
// a pure elementwise int32 pass (parameter select, multiply-shift, sign)
// with no reuse across elements, so shared memory and tensor cores buy
// nothing: one thread per coefficient, a grid-stride loop, bound by the
// 12 bytes per coefficient it reads and writes.  The products wrap in
// 32 bits exactly as the reference's int32 math does.
//
// The parameters are one row of n, or a row per frame of a batch whose
// frames each have their own quantizer (the frame-parallel GF group):
// coefficient i takes row i / per_row, where per_row is the coefficients of
// one frame (the whole batch when there is one row).

#include <cstdint>
#include <cuda_runtime.h>

__device__ __forceinline__ int32_t mul_wrap(int32_t a, int32_t b) {
  return (int32_t)((uint32_t)a * (uint32_t)b);
}

__global__ void quantize_b_kernel(int32_t* __restrict__ q,
                                  int32_t* __restrict__ dq,
                                  const int32_t* __restrict__ coeff,
                                  const int32_t* __restrict__ zbin,
                                  const int32_t* __restrict__ rnd,
                                  const int32_t* __restrict__ quant,
                                  const int32_t* __restrict__ qshift,
                                  const int32_t* __restrict__ deq,
                                  long long total, int n, int log_scale,
                                  long long per_row) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       i < total; i += stride) {
    const long long p = i / per_row * n + i % n;
    const int32_t c = coeff[i];
    const int32_t ac = c < 0 ? (int32_t)(0u - (uint32_t)c) : c;
    const int32_t sign = c < 0 ? -1 : 1;
    int32_t tmp = (int32_t)((uint32_t)ac + (uint32_t)rnd[p]);
    tmp = min(max(tmp, -32768), 32767);
    int32_t t = (mul_wrap(tmp, quant[p]) >> 16) + tmp;
    t = mul_wrap(t, qshift[p]) >> (16 - log_scale);
    t = ac >= zbin[p] ? t : 0;
    q[i] = mul_wrap(sign, t);
    dq[i] = mul_wrap(sign, mul_wrap(t, deq[p]) >> log_scale);
  }
}

extern "C" int avl_quantize_b(void* q, void* dq, const void* coeff,
                              const void* zbin, const void* rnd,
                              const void* quant, const void* qshift,
                              const void* deq, long long total, int n,
                              int log_scale, long long per_row,
                              void* stream) {
  if (n <= 0 || per_row <= 0 || per_row % n != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int threads = 256;
  long long blocks = (total + threads - 1) / threads;
  if (blocks > 132 * 32) blocks = 132 * 32;
  if (blocks < 1) blocks = 1;
  quantize_b_kernel<<<(unsigned)blocks, threads, 0, s>>>(
      static_cast<int32_t*>(q), static_cast<int32_t*>(dq),
      static_cast<const int32_t*>(coeff), static_cast<const int32_t*>(zbin),
      static_cast<const int32_t*>(rnd), static_cast<const int32_t*>(quant),
      static_cast<const int32_t*>(qshift), static_cast<const int32_t*>(deq),
      total, n, log_scale, per_row);
  return (int)cudaGetLastError();
}
