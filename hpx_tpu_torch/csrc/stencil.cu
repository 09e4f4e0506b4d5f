// Periodic 3-point heat-equation kernels for Hopper (sm_90a).
//
// Build (hpx_tpu_torch/ops/_build.py does this at first use):
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 --fmad=false \
//        -shared -Xcompiler -fPIC -o libstencil.so stencil.cu
//
// Both kernels must equal their plain PyTorch versions bit for bit
// (hpx_tpu_torch/ops/stencil.py), and those equal the reference's compiled
// programs on the CPU. The reference's XLA code rounds u + coef*d once (it
// contracts the multiply-add into an FMA) and every other operation on its
// own. So the last operation here is an explicit __fmaf_rn, every other one
// a round-to-nearest intrinsic with float literals (`2.0 * u` would promote
// to double), and the build passes --fmad=false so that nvcc contracts
// nothing else.
//
// The entry points take a plain C interface, launch on the stream they
// are given, and return cudaGetLastError() so that a refused launch is
// reported to the caller.

#include <climits>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
// grid cap of the streaming kernel; a grid-stride loop covers larger n
constexpr long long kMaxStreamBlocks = 1LL << 16;

// op order of hpx_tpu.ops.stencil._pallas_blocked_kernel:
// fma(coef, (left + right) - 2u, u)
__device__ __forceinline__ float step_b(float l, float c, float r,
                                        float coef) {
  return __fmaf_rn(coef, __fsub_rn(__fadd_rn(l, r), __fmul_rn(2.0f, c)), c);
}

// op order of hpx_tpu.ops.stencil.heat_step / _pallas_kernel:
// fma(coef, (left - 2u) + right, u)
__device__ __forceinline__ float step_a(float l, float c, float r,
                                        float coef) {
  return __fmaf_rn(coef, __fadd_rn(__fsub_rn(l, __fmul_rn(2.0f, c)), r), c);
}

// Kernel A: one periodic heat step, u -> out.
//
// Replaces hpx_tpu/ops/stencil.py:_pallas_blocked_kernel. Bound: device
// memory, 8 bytes per cell (one read of u, one write of out). The TPU
// kernel streamed (2048, 128) slabs and patched each slab's two seam
// neighbours from SMEM scalars; here each thread reads its neighbours
// straight from global memory (the L1/L2 caches serve the two extra
// reads), with the periodic wrap at i = 0 and i = n-1, so any n >= 1
// works.
__global__ void __launch_bounds__(kThreads)
heat_step_blocked_kernel(const float* __restrict__ u, float* __restrict__ out,
                         float coef, long long n) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    const float l = u[i == 0 ? n - 1 : i - 1];
    const float r = u[i == n - 1 ? 0 : i + 1];
    out[i] = step_b(l, u[i], r, coef);
  }
}

// Kernel B: `steps` periodic heat steps, in -> out, by temporal blocking.
//
// Replaces hpx_tpu/ops/stencil.py:_pallas_kernel, which held the whole
// array in VMEM for all T steps. Bound: at these sizes the FP32 and
// shared-memory instruction rate, not device memory, since each cell is
// read and written once per `steps` steps. A block owns `tile` cells; it
// loads them plus a halo of `steps` cells a side (periodic, modulo n)
// into shared memory, runs the steps there, ping-ponging two buffers
// while the valid region shrinks by one cell a side per step, and writes
// its tile back. Every cell is computed by the same formula from the same
// operands as in the plain loop, so the result does not depend on `tile`
// or `steps` — also when n is smaller than one tile and the halo wraps
// around the whole array.
__global__ void __launch_bounds__(kThreads)
multistep_fused_kernel(const float* __restrict__ in, float* __restrict__ out,
                       float coef, long long n, int tile, int steps) {
  extern __shared__ float smem[];
  const int width = tile + 2 * steps;
  float* a = smem;
  float* b = smem + width;
  const long long start = (long long)blockIdx.x * tile;
  long long base = (start - steps) % n;
  if (base < 0) base += n;
  for (int j = threadIdx.x; j < width; j += blockDim.x) {
    long long g = base + j;
    if (g >= n) g %= n;
    a[j] = in[g];
  }
  __syncthreads();
  for (int s = 1; s <= steps; ++s) {
    for (int j = s + threadIdx.x; j < width - s; j += blockDim.x) {
      b[j] = step_a(a[j - 1], a[j], a[j + 1], coef);
    }
    __syncthreads();
    float* t = a;
    a = b;
    b = t;
  }
  const long long m = n - start < tile ? n - start : tile;
  for (int k = threadIdx.x; k < m; k += blockDim.x) {
    out[start + k] = a[steps + k];
  }
}

}  // namespace

extern "C" {

int hpx_heat_step_blocked(const float* u, float* out, float coef,
                          long long n, void* stream) {
  if (n <= 0) return (int)cudaErrorInvalidValue;
  long long blocks = (n + kThreads - 1) / kThreads;
  if (blocks > kMaxStreamBlocks) blocks = kMaxStreamBlocks;
  heat_step_blocked_kernel<<<(unsigned)blocks, kThreads, 0,
                             (cudaStream_t)stream>>>(u, out, coef, n);
  return (int)cudaGetLastError();
}

int hpx_multistep_fused_pass(const float* in, float* out, float coef,
                             long long n, int tile, int steps, void* stream) {
  if (n <= 0 || tile <= 0 || steps <= 0) return (int)cudaErrorInvalidValue;
  const long long blocks = (n + tile - 1) / tile;
  if (blocks > INT_MAX) return (int)cudaErrorInvalidValue;
  const size_t smem = 2 * (size_t)(tile + 2 * steps) * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        multistep_fused_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  multistep_fused_kernel<<<(unsigned)blocks, kThreads, smem,
                           (cudaStream_t)stream>>>(in, out, coef, n, tile,
                                                   steps);
  return (int)cudaGetLastError();
}

const char* hpx_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
