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
#include <stdint.h>

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

// Kernel 2 (heat_step_blocked): one periodic heat step, u -> out.
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

// Kernel 1 (multistep_fused): `steps` periodic heat steps, in -> out, by
// temporal blocking with the state in registers.
//
// Replaces hpx_tpu/ops/stencil.py:44 (_pallas_kernel), which held the
// whole array in VMEM for all T steps. On Hopper the place for a state
// that stays put between steps is the register file (132 SMs x 256 KB),
// not shared memory. Bound: the FP32 issue rate, 4 FP32 instructions a
// cell update (step_a: FMUL 2u, FSUB, FADD, FFMA) on 128 lanes an SM a
// clock; device memory only for a pass over an array larger than L2 (8
// bytes a cell a pass, and a pass runs up to 256 steps).
//
// Design. A launch is one pass of up to `steps` steps (the host entry
// below launches every pass of a call). A block owns `tile` cells and
// holds a window that starts `halo` cells left of its tile; indices wrap
// modulo n, so any n >= 1 works, also a window that wraps around the
// whole array more than once. Lane l of warp w keeps K window cells
// from w * 31K + lK in registers, in two arrays that take turns a step
// each (no register moves): a warp holds 32K cells, and neighbouring
// warps share one lane's run of K cells. A step takes the neighbouring
// lanes' edge cells by warp shuffles; a warp's two end cells read NaN,
// which reaches one cell further a step. Every E = K / 2 steps the warps
// of a block swap the shared runs' halves through shared memory, one
// barrier for E steps: warp w's lane 0 takes cells [0, E) from warp w - 1
// and its lane 31 cells [E, K) from warp w + 1, both clean since at most
// E steps have passed. So no barrier, no shared-memory access and no
// data-dependent branch is on a cell's path between exchanges. The
// block's own two ends are never refreshed: after `steps` <= halo steps
// the tile is exact, and a halo too short shows as NaN in the output,
// not as an error below one rounding. Every cell is computed by the same
// formula from the same operands as in the plain loop, so the result does
// not depend on the plan. Redundant work: a block computes K (31 * warps
// + 1) cells for its tile, the trapezoid's 2 * halo and the padding, and
// each shared run twice. With n % 4 == 0, halo and tile multiples of 4
// and 16-byte aligned pointers (`vec`), a thread loads and stores 16
// bytes at a time. The passes after the first are launched while the
// one before runs (programmatic dependent launch) and wait for it here.
constexpr int kMaxThreads = 256;   // the launch bound; 3 blocks an SM at K = 32
constexpr int kMaxWarps = kMaxThreads / 32;
constexpr unsigned kFull = 0xffffffffu;

// the runs a warp hands its neighbours at an exchange, by exchange parity
template <int K>
struct FusedRuns {
  float4 lo[2][kMaxWarps][K / 8];   // lane 0's cells [E, K), for warp w - 1
  float4 hi[2][kMaxWarps][K / 8];   // lane 31's cells [0, E), for warp w + 1
};

// y = one step of x; lane 0's left and lane 31's right neighbour are NaN
template <int K>
__device__ __forceinline__ void fused_step(const float (&x)[K], float (&y)[K],
                                           float coef, int lane) {
  const float nan = __int_as_float(0x7fffffff);
  float l = __shfl_up_sync(kFull, x[K - 1], 1);
  float r = __shfl_down_sync(kFull, x[0], 1);
  if (lane == 0) l = nan;
  if (lane == 31) r = nan;
  y[0] = step_a(l, x[0], x[1], coef);
#pragma unroll
  for (int i = 1; i < K - 1; ++i) {
    y[i] = step_a(x[i - 1], x[i], x[i + 1], coef);
  }
  y[K - 1] = step_a(x[K - 2], x[K - 1], r, coef);
}

// the warps of the block refresh each other's shared runs (exchange
// parity p): lane 0 of warp w > 0 takes cells [0, E) from lane 31 of
// warp w - 1, lane 31 of warp w + 1 < warps cells [E, K) from lane 0 of
// warp w + 1
template <int K>
__device__ __forceinline__ void exchange(float (&x)[K], FusedRuns<K>& runs,
                                         int p, int lane, int warp,
                                         int warps) {
  constexpr int E = K / 2;
  if (lane == 0) {
#pragma unroll
    for (int q = 0; q < E / 4; ++q) {
      runs.lo[p][warp][q] = make_float4(x[E + 4 * q], x[E + 4 * q + 1],
                                        x[E + 4 * q + 2], x[E + 4 * q + 3]);
    }
  } else if (lane == 31) {
#pragma unroll
    for (int q = 0; q < E / 4; ++q) {
      runs.hi[p][warp][q] = make_float4(x[4 * q], x[4 * q + 1], x[4 * q + 2],
                                        x[4 * q + 3]);
    }
  }
  __syncthreads();
  if (lane == 0 && warp > 0) {
#pragma unroll
    for (int q = 0; q < E / 4; ++q) {
      const float4 v = runs.hi[p][warp - 1][q];
      x[4 * q] = v.x;
      x[4 * q + 1] = v.y;
      x[4 * q + 2] = v.z;
      x[4 * q + 3] = v.w;
    }
  } else if (lane == 31 && warp + 1 < warps) {
#pragma unroll
    for (int q = 0; q < E / 4; ++q) {
      const float4 v = runs.lo[p][warp + 1][q];
      x[E + 4 * q] = v.x;
      x[E + 4 * q + 1] = v.y;
      x[E + 4 * q + 2] = v.z;
      x[E + 4 * q + 3] = v.w;
    }
  }
}

// the cells of x at tile index j0 + i, i in [lo, hi), that lie in [0, m)
// into dst[j0 + i]
template <int K>
__device__ __forceinline__ void store_tile(const float (&x)[K],
                                           float* __restrict__ dst,
                                           long long j0, long long m, int lo,
                                           int hi, bool vec) {
  if (vec) {
#pragma unroll
    for (int i = 0; i < K; i += 4) {
      const long long j = j0 + i;
      if (i >= lo && i < hi && j >= 0 && j < m) {
        *reinterpret_cast<float4*>(dst + j) =
            make_float4(x[i], x[i + 1], x[i + 2], x[i + 3]);
      }
    }
  } else {
#pragma unroll
    for (int i = 0; i < K; ++i) {
      const long long j = j0 + i;
      if (i >= lo && i < hi && j >= 0 && j < m) dst[j] = x[i];
    }
  }
}

template <int K>
__global__ void __launch_bounds__(kMaxThreads)
multistep_fused_kernel(const float* __restrict__ in, float* __restrict__ out,
                       float coef, long long n, long long tile, int halo,
                       int steps, bool vec) {
  static_assert(K % 8 == 0, "a run's halves are whole float4s");
  constexpr int E = K / 2;
  __shared__ FusedRuns<K> runs;
  // wait until the previous pass has finished and its stores are
  // visible; let the next pass's blocks be scheduled at once
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int warps = blockDim.x >> 5;
  const long long start = (long long)blockIdx.x * tile;
  const long long pos = (long long)K * (31 * warp + lane);   // in the window
  long long g = (start - halo + pos) % n;
  if (g < 0) g += n;
  float a[K], b[K];
  if (vec) {
#pragma unroll
    for (int i = 0; i < K; i += 4) {
      const float4 v = __ldg(reinterpret_cast<const float4*>(in + g));
      a[i] = v.x;
      a[i + 1] = v.y;
      a[i + 2] = v.z;
      a[i + 3] = v.w;
      g += 4;
      if (g == n) g = 0;
    }
  } else {
#pragma unroll
    for (int i = 0; i < K; ++i) {
      a[i] = __ldg(in + g);
      if (++g == n) g = 0;
    }
  }
  int s = 0;
  for (; s + 1 < steps; s += 2) {
    fused_step<K>(a, b, coef, lane);
    fused_step<K>(b, a, coef, lane);
    if ((s + 2) % E == 0 && s + 2 < steps) {
      exchange<K>(a, runs, ((s + 2) / E) & 1, lane, warp, warps);
    }
  }
  // a shared run's half [0, E) belongs to warp w's lane 31, [E, K) to
  // warp w + 1's lane 0; the block's first and last warps own their ends
  const int lo = lane == 0 && warp > 0 ? E : 0;
  const int hi = lane == 31 && warp + 1 < warps ? E : K;
  const long long m = n - start < tile ? n - start : tile;
  if (s < steps) {
    fused_step<K>(a, b, coef, lane);
    store_tile<K>(b, out + start, pos - halo, m, lo, hi, vec);
  } else {
    store_tile<K>(a, out + start, pos - halo, m, lo, hi, vec);
  }
}

using FusedKernel = void (*)(const float*, float*, float, long long,
                             long long, int, int, bool);

FusedKernel fused_kernel(int k) {
  switch (k) {
    case 16: return multistep_fused_kernel<16>;
    case 32: return multistep_fused_kernel<32>;
    default: return nullptr;
  }
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
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

// Every pass of T = `steps` steps of kernel 1, in -> out, on `stream`,
// by the plan of hpx_tpu_torch/ops/stencil.py:multistep_plan: passes of
// `pass_steps` steps (the last takes the rest), cells a thread `k` (16
// or 32), `threads` a block, `tile` cells and a halo of `halo` cells a
// side a block. With more than one pass they take turns between out and
// `scratch` (n floats), so that the last one writes out; `in` is only
// read. The plan is exact when halo >= pass_steps, which the caller
// keeps (a shorter halo gives NaN near the tiles' edges). Returns the
// first error.
int hpx_multistep_fused(const float* in, float* out, float* scratch,
                        float coef, long long n, int steps, int pass_steps,
                        int k, int threads, long long tile, int halo,
                        void* stream) {
  const FusedKernel kernel = fused_kernel(k);
  if (kernel == nullptr || n <= 0 || steps <= 0 || pass_steps <= 0 ||
      halo < 0 || tile <= 0 || threads < 32 || threads > kMaxThreads ||
      threads % 32 != 0 ||
      tile + 2LL * halo > (long long)k * (31 * (threads / 32) + 1))
    return (int)cudaErrorInvalidValue;
  const int passes = (steps + pass_steps - 1) / pass_steps;
  const long long blocks = (n + tile - 1) / tile;
  if (blocks > INT_MAX || (passes > 1 && scratch == nullptr))
    return (int)cudaErrorInvalidValue;
  const bool vec = n % 4 == 0 && halo % 4 == 0 && tile % 4 == 0 &&
                   aligned16(in) && aligned16(out) &&
                   (passes == 1 || aligned16(scratch));
  const float* src = in;
  for (int p = 0; p < passes; ++p) {
    float* dst = (passes - 1 - p) % 2 == 0 ? out : scratch;
    const int s = p + 1 < passes ? pass_steps : steps - p * pass_steps;
    // every pass after the first may be launched while the one before it
    // runs, and waits in the kernel for its end (griddepcontrol.wait)
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3((unsigned)blocks);
    cfg.blockDim = dim3(threads);
    cfg.stream = (cudaStream_t)stream;
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
    attr[0].val.programmaticStreamSerializationAllowed = 1;
    cfg.attrs = attr;
    cfg.numAttrs = p > 0 ? 1 : 0;
    cudaError_t e = cudaLaunchKernelEx(&cfg, kernel, src, dst, coef, n, tile,
                                       halo, s, vec);
    if (e == cudaSuccess) e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
    src = dst;
  }
  return 0;
}

// kernel 1's registers, static shared memory and local (spilled) bytes a
// thread at `k` cells a thread
int hpx_multistep_fused_attrs(int k, int* regs, int* smem, int* local) {
  const FusedKernel kernel = fused_kernel(k);
  if (kernel == nullptr) return (int)cudaErrorInvalidValue;
  cudaFuncAttributes a;
  const cudaError_t e = cudaFuncGetAttributes(&a, kernel);
  if (e != cudaSuccess) return (int)e;
  *regs = a.numRegs;
  *smem = (int)a.sharedSizeBytes;
  *local = (int)a.localSizeBytes;
  return 0;
}

const char* hpx_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
