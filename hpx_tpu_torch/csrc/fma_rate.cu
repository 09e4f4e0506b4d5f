// The FP32 rate probe for Hopper (sm_90a): a register-resident chain of
// fused multiply-adds whose measured rate is the compute roof that the
// fused stencil (kernel 1, stencil.cu:multistep_fused_kernel) is judged
// against.
//
// Build (hpx_tpu_torch/ops/_build.py does this at first use):
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 --fmad=false \
//        -shared -Xcompiler -fPIC -o libfma_rate.so fma_rate.cu
//
// Replaces bench.py:339, the `kernel` closure of bench_vpu_rate, which
// held a (2^17 / 128, 128) float32 array in VMEM and ran 1024 iterations
// of
//   y_j = u * c_j + c_j,  c_j = f32(c + f32(j * 1e-9)),  j = 0..7
//   u   = ((y0 + y1) + (y2 + y3) + ((y4 + y5) + (y6 + y7))) * f32(0.125*0.9999)
// on the VPU. Here one thread owns one element and keeps it in a
// register for all the iterations; the 8 coefficients and the scale come
// from the host (hpx_tpu_torch/ops/fma_rate.py rounds them as the
// reference does). Each iteration is 8 independent __fmaf_rn, the
// reference's 7 adds in its tree order (__fadd_rn) and one __fmul_rn,
// and the build passes --fmad=false, so the result equals the plain
// PyTorch version (plain_fma_chain) bit for bit: the reference's
// compiled program rounds each y_j once, as an FMA does.
//
// Bound: operations. At n = 2^17 and 1024 iterations the kernel issues
// 2^17 * 1024 * 16 FP32 instructions (8 FMA + 8 other), 2^17 * 1024 * 24
// = 3.2e9 operations: 0.048 ms at the H100 SXM's 67 TFLOP/s, and 0.064
// ms at its issue rate of one FP32 instruction a lane a clock (132 SMs x
// 128 lanes x 1.98 GHz), which is what the 8 non-FMA instructions make
// the real limit. It reads and writes 1 MiB, nothing.
//
// Keeping the FP32 pipes full: each of an SM's 4 schedulers issues one
// warp instruction a clock to its 32 FP32 lanes, and a dependent FP32
// instruction waits about 4 clocks. An iteration is 16 instructions on a
// dependency path of 5 (FMA, three levels of adds, the multiply), about
// 20 clocks, so 2 warps a scheduler (8 warps, 256 threads an SM) already
// cover the latency; the 8 independent FMAs are the instruction-level
// parallelism that lets them, as they kept the VPU's pipelines full on
// the TPU. At n = 2^17 with 256-thread blocks, 512 blocks are resident
// at once (3-4 an SM, 24-32 warps, 6-8 a scheduler).
//
// The entry point takes a plain C interface, launches on the stream it
// is given, and returns cudaGetLastError() so that a refused launch is
// reported to the caller.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

struct Coefs {
  float c[8];
};

__global__ void __launch_bounds__(kThreads)
fma_chain_kernel(const float* __restrict__ u, float* __restrict__ out,
                 Coefs k, float scale, long long n, int steps) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float x = u[i];
  for (int s = 0; s < steps; ++s) {
    const float y0 = __fmaf_rn(x, k.c[0], k.c[0]);
    const float y1 = __fmaf_rn(x, k.c[1], k.c[1]);
    const float y2 = __fmaf_rn(x, k.c[2], k.c[2]);
    const float y3 = __fmaf_rn(x, k.c[3], k.c[3]);
    const float y4 = __fmaf_rn(x, k.c[4], k.c[4]);
    const float y5 = __fmaf_rn(x, k.c[5], k.c[5]);
    const float y6 = __fmaf_rn(x, k.c[6], k.c[6]);
    const float y7 = __fmaf_rn(x, k.c[7], k.c[7]);
    const float s1 = __fadd_rn(__fadd_rn(y0, y1), __fadd_rn(y2, y3));
    const float s2 = __fadd_rn(__fadd_rn(y4, y5), __fadd_rn(y6, y7));
    x = __fmul_rn(__fadd_rn(s1, s2), scale);
  }
  out[i] = x;
}

}  // namespace

extern "C" {

int hpx_fma_chain(const float* u, float* out, const float* coefs,
                  float scale, long long n, int steps, void* stream) {
  if (n <= 0 || steps < 0) return (int)cudaErrorInvalidValue;
  const long long blocks = (n + kThreads - 1) / kThreads;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  Coefs k;
  for (int j = 0; j < 8; ++j) k.c[j] = coefs[j];
  fma_chain_kernel<<<(unsigned)blocks, kThreads, 0, (cudaStream_t)stream>>>(
      u, out, k, scale, n, steps);
  return (int)cudaGetLastError();
}

const char* hpx_fma_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
