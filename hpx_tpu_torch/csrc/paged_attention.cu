// Paged decode attention: two hand-written kernels that walk the int32
// block table of a paged KV pool, for Hopper (sm_90a).
//
// Replaces the two Pallas kernels of hpx_tpu/ops/attention_pallas.py:
//   paged_attention_exact   <- _paged_kernel        (:908)
//   paged_attention_online  <- _paged_online_kernel (:972)
// Plain C interface (no PyTorch headers), loaded with ctypes by
// hpx_tpu_torch/ops/attention_cuda.py, which checks shapes, types and
// devices, allocates the output and computes the shared-memory size.
//
// Layouts (all contiguous):
//   q, out   [B, W, nq, hd]          Q = float or bf16
//   k/v pool [num_blocks, bs, nkv, hd] P = float, bf16, int8 or fp8 e4m3
//   k/v scale [num_blocks, nkv] f32  (int8/fp8 pools only)
//   table    [B, maxb] int32 logical -> physical block
//   pos0     [B] int32: window row w attends positions <= pos0 + w
// One CTA per (slot b, kv-head h). Its W*g query rows (row r = w*g + j
// for q head h*g + j, g = nq / nkv) share the K/V of head h. Every
// logical block up to maxb is visited and masked, never skipped, so the
// result does not depend on what the table's trash/pad blocks hold.
//
// What bounds them on this card: decode reads every K/V row of the
// table once (bytes: ~2 * maxb * bs * nkv * hd * sizeof(P) per slot)
// and does 4 FLOPs per (query row, key position, hd element), far below
// the H100's ~295 FLOP/byte ridge, so memory bandwidth bounds both.
// These versions are simple: one 128-thread CTA per (slot, head); the
// table is walked in chunks of `cb` blocks (cb * bs <= 64 rows, cb >= 1),
// each chunk staged into shared memory by 16-byte loads, with CTA-wide
// barriers between phases; no TMA, no wgmma, no split over the
// sequence. The ports keep the reference's
// dtype steps so the kernels stay within a stated tolerance of their
// plain PyTorch versions.
//
// paged_attention_exact keeps the reference's order of operations: the
// full (W*g, S) f32 score row in shared memory, then the softmax as
// jax.nn.softmax runs it (max, exp, sum, divide), then a second table
// walk streaming V for p.V. The reference banked the V rows for the
// whole sequence in VMEM too (512 KB of f32 at hd=128, S=1024), more
// than a CTA's 227 KB, so V is streamed instead: shared memory is
// W*g*S*4 bytes plus a few (W*g or cb*bs) x hd tiles, and the wrapper
// refuses shapes above the cap.
//
// paged_attention_online folds each chunk into a flash (acc, m, l)
// carry kept in shared memory (O(chunk), no sequence extent): f32
// scores, rescale only where the running max moved, masked lanes
// exactly 0, normalization after the last chunk.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cuda_fp8.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr float kNegInf = -1e30f;   // the online carry's "minus infinity"

template <typename T> struct IsQuant { static constexpr bool value = false; };
template <> struct IsQuant<int8_t> { static constexpr bool value = true; };
template <> struct IsQuant<__nv_fp8_e4m3> {
  static constexpr bool value = true;
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float to_f32(int8_t x) {
  return static_cast<float>(x);
}
__device__ __forceinline__ float to_f32(__nv_fp8_e4m3 x) {
  return static_cast<float>(x);
}

// x rounded to the compute type Q and held as float (astype(q.dtype))
template <typename Q> __device__ __forceinline__ float round_to(float x);
template <> __device__ __forceinline__ float round_to<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ float round_to<__nv_bfloat16>(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

template <typename Q> __device__ __forceinline__ Q from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// One pool element as float; quantized pools dequantize as the
// reference does at its VMEM boundary: (float(q) * scale) rounded to
// the compute type.
template <typename P, typename Q>
__device__ __forceinline__ float dequant(P x, float scale) {
  if constexpr (IsQuant<P>::value)
    return round_to<Q>(to_f32(x) * scale);
  else
    return to_f32(x);
}

// Stage logical blocks i0 .. i0+n-1 of one table row, kv-head h, into
// dst [n*bs][hd] as float. Each thread moves 16 bytes a load (4 to 16
// elements) where head_dim and the addresses allow it, so the chunk
// arrives in two or three rounds of loads; elsewhere one element a load.
template <typename P, typename Q>
__device__ void load_blocks(float* dst, const P* __restrict__ pool,
                            const float* __restrict__ scales,
                            const int* __restrict__ trow, int i0, int n,
                            int h, int bs, int nkv, int hd) {
  constexpr int V = 16 / sizeof(P);          // elements per 16 bytes
  const size_t row = (size_t)nkv * hd;
  if (hd % V == 0 && (size_t)pool % 16 == 0 && (size_t)dst % 16 == 0) {
    const int per_row = hd / V, total = n * bs * per_row;
#pragma unroll 4
    for (int v = threadIdx.x; v < total; v += blockDim.x) {
      const int t = v / per_row, dv = v - t * per_row;
      const int blk = t / bs;
      const int bid = trow[i0 + blk];
      const float sc = IsQuant<P>::value ? scales[(size_t)bid * nkv + h]
                                         : 1.f;
      const uint4 raw = *reinterpret_cast<const uint4*>(
          pool + ((size_t)bid * bs * nkv + h) * hd
          + (t - blk * bs) * row + dv * V);
      const P* xs = reinterpret_cast<const P*>(&raw);
      float4* out = reinterpret_cast<float4*>(dst + t * hd + dv * V);
#pragma unroll
      for (int j = 0; j < V / 4; ++j)
        out[j] = make_float4(dequant<P, Q>(xs[4 * j], sc),
                             dequant<P, Q>(xs[4 * j + 1], sc),
                             dequant<P, Q>(xs[4 * j + 2], sc),
                             dequant<P, Q>(xs[4 * j + 3], sc));
    }
    return;
  }
  const int total = n * bs * hd;
#pragma unroll 8
  for (int e = threadIdx.x; e < total; e += blockDim.x) {
    const int t = e / hd, d = e - t * hd;     // chunk row, element
    const int blk = t / bs;
    const int bid = trow[i0 + blk];
    const float sc = IsQuant<P>::value ? scales[(size_t)bid * nkv + h]
                                       : 1.f;
    dst[e] = dequant<P, Q>(
        pool[((size_t)bid * bs * nkv + h) * hd + (t - blk * bs) * row + d],
        sc);
  }
}

// Query rows of (slot b, kv-head h) into qs [R][hd] as float.
template <typename Q>
__device__ void load_queries(float* qs, const Q* q, int b, int h, int W,
                             int nq, int g, int hd) {
  const int R = W * g;
  for (int e = threadIdx.x; e < R * hd; e += blockDim.x) {
    const int r = e / hd, d = e - r * hd;
    const int w = r / g, j = r - w * g;
    qs[e] = to_f32(q[(((size_t)b * W + w) * nq + h * g + j) * hd + d]);
  }
}

// dst[r * ld + t] = dot(qs[r], kt[t]) for every (query row, key row) of
// one staged block, one warp per pair; the raw f32 dot is passed through
// `finish` before it is stored.
template <typename F>
__device__ void block_scores(const float* qs, const float* kt, int R,
                             int bs, int hd, float* dst, int ld, F finish) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int pr = warp; pr < R * bs; pr += kWarps) {
    const int r = pr / bs, t = pr - r * bs;
    float acc = 0.f;
    for (int d = lane; d < hd; d += 32) acc += qs[r * hd + d] * kt[t * hd + d];
    acc = warp_sum(acc);
    if (lane == 0) dst[r * ld + t] = finish(acc);
  }
}

template <typename Q>
__device__ void store_out(Q* out, const float* acc, const float* den, int b,
                          int h, int W, int nq, int g, int hd) {
  const int R = W * g;
  for (int e = threadIdx.x; e < R * hd; e += blockDim.x) {
    const int r = e / hd, d = e - r * hd;
    const int w = r / g, j = r - w * g;
    const float v = den ? acc[e] / den[r] : acc[e];
    out[(((size_t)b * W + w) * nq + h * g + j) * hd + d] = from_f32<Q>(v);
  }
}

// ---------------------------------------------------------------------------
// paged_attention_exact (replaces _paged_kernel)
// shared memory: qs [R][hd] | sc [R][S] | tile [cb*bs][hd] | acc [R][hd]
// ---------------------------------------------------------------------------
template <typename P, typename Q>
__global__ void __launch_bounds__(kThreads)
paged_attention_exact(const Q* __restrict__ q, const P* __restrict__ kp,
                      const P* __restrict__ vp, const float* __restrict__ ks,
                      const float* __restrict__ vs,
                      const int* __restrict__ table,
                      const int* __restrict__ pos0, Q* __restrict__ out,
                      int W, int nq, int nkv, int hd, int bs, int maxb,
                      int cb, float sqrt_hd) {
  extern __shared__ float smem[];
  const int b = blockIdx.x, h = blockIdx.y;
  const int g = nq / nkv, R = W * g, S = maxb * bs;
  float* qs = smem;
  float* sc = qs + R * hd;
  float* tile = sc + (size_t)R * S;
  float* acc = tile + cb * bs * hd;
  const int* trow = table + (size_t)b * maxb;

  load_queries<Q>(qs, q, b, h, W, nq, g, hd);
  for (int e = threadIdx.x; e < R * hd; e += blockDim.x) acc[e] = 0.f;

  // 1. first table walk: the full score row. The dot is rounded to the
  //    compute type, divided by sqrt(hd) there, then held as f32.
  for (int i0 = 0; i0 < maxb; i0 += cb) {
    const int n = min(cb, maxb - i0);
    __syncthreads();                       // tile free for the next chunk
    load_blocks<P, Q>(tile, kp, ks, trow, i0, n, h, bs, nkv, hd);
    __syncthreads();
    block_scores(qs, tile, R, n * bs, hd, sc + i0 * bs, S, [=](float x) {
      return round_to<Q>(round_to<Q>(x) / sqrt_hd);
    });
  }
  __syncthreads();

  // 2. masked softmax over each row: max, exp, sum, divide; p rounded
  //    to the output type as the reference casts it before p.V
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int p0 = pos0[b];
  for (int r = warp; r < R; r += kWarps) {
    float* row = sc + (size_t)r * S;
    const int lim = p0 + r / g;            // live: kpos <= pos0 + w
    float m = -INFINITY;
    for (int k = lane; k < S; k += 32)
      if (k <= lim) m = fmaxf(m, row[k]);
    m = warp_max(m);
    float sum = 0.f;
    for (int k = lane; k < S; k += 32) {
      const float e = k <= lim ? expf(row[k] - m) : 0.f;
      row[k] = e;
      sum += e;
    }
    sum = warp_sum(sum);
    for (int k = lane; k < S; k += 32) row[k] = round_to<Q>(row[k] / sum);
  }

  // 3. second table walk: stream V chunks and accumulate p.V in f32,
  //    key positions in order
  for (int i0 = 0; i0 < maxb; i0 += cb) {
    const int rows = min(cb, maxb - i0) * bs;
    __syncthreads();
    load_blocks<P, Q>(tile, vp, vs, trow, i0, rows / bs, h, bs, nkv, hd);
    __syncthreads();
    for (int e = threadIdx.x; e < R * hd; e += blockDim.x) {
      const int r = e / hd, d = e - r * hd;
      const float* prow = sc + (size_t)r * S + i0 * bs;
      float a = acc[e];
      for (int t = 0; t < rows; ++t) a += prow[t] * tile[t * hd + d];
      acc[e] = a;
    }
  }
  __syncthreads();
  store_out<Q>(out, acc, nullptr, b, h, W, nq, g, hd);
}

// ---------------------------------------------------------------------------
// paged_attention_online (replaces _paged_online_kernel)
// shared memory: qs [R][hd] | kt [cb*bs][hd] | vt [cb*bs][hd]
//                | sc [R][cb*bs] | acc [R][hd] | m [R] | l [R] | corr [R]
// ---------------------------------------------------------------------------
template <typename P, typename Q>
__global__ void __launch_bounds__(kThreads)
paged_attention_online(const Q* __restrict__ q, const P* __restrict__ kp,
                       const P* __restrict__ vp, const float* __restrict__ ks,
                       const float* __restrict__ vs,
                       const int* __restrict__ table,
                       const int* __restrict__ pos0, Q* __restrict__ out,
                       int W, int nq, int nkv, int hd, int bs, int maxb,
                       int cb, float sqrt_hd) {
  extern __shared__ float smem[];
  const int b = blockIdx.x, h = blockIdx.y;
  const int g = nq / nkv, R = W * g, CR = cb * bs;
  float* qs = smem;
  float* kt = qs + R * hd;
  float* vt = kt + CR * hd;
  float* sc = vt + CR * hd;
  float* acc = sc + R * CR;
  float* m = acc + R * hd;
  float* l = m + R;
  float* corr = l + R;
  const int* trow = table + (size_t)b * maxb;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int p0 = pos0[b];

  load_queries<Q>(qs, q, b, h, W, nq, g, hd);
  for (int e = threadIdx.x; e < R * hd; e += blockDim.x) acc[e] = 0.f;
  for (int r = threadIdx.x; r < R; r += blockDim.x) {
    m[r] = kNegInf;
    l[r] = 0.f;
  }

  for (int i0 = 0; i0 < maxb; i0 += cb) {
    const int n = min(cb, maxb - i0), rows = n * bs;
    __syncthreads();
    load_blocks<P, Q>(kt, kp, ks, trow, i0, n, h, bs, nkv, hd);
    load_blocks<P, Q>(vt, vp, vs, trow, i0, n, h, bs, nkv, hd);
    __syncthreads();
    // f32 scores (no rounding to the compute type), scaled
    block_scores(qs, kt, R, rows, hd, sc, CR,
                 [=](float x) { return x / sqrt_hd; });
    __syncthreads();
    // fold the chunk into the running (m, l) of each row
    for (int r = warp; r < R; r += kWarps) {
      float* row = sc + r * CR;
      const int lim = p0 + r / g - i0 * bs;  // live: t <= lim
      float mb = kNegInf;
      for (int t = lane; t < rows; t += 32)
        mb = fmaxf(mb, t <= lim ? row[t] : kNegInf);
      const float m_prev = m[r];
      const float m_new = fmaxf(m_prev, warp_max(mb));
      float psum = 0.f;
      for (int t = lane; t < rows; t += 32) {
        const float p = t <= lim ? expf(row[t] - m_new) : 0.f;
        psum += p;
        row[t] = round_to<Q>(p);           // p.V takes p in the V type
      }
      psum = warp_sum(psum);
      if (lane == 0) {
        // rescale only where the running max moved
        const float c = m_new != m_prev ? expf(m_prev - m_new) : 1.f;
        corr[r] = c;
        l[r] = (c != 1.f ? l[r] * c : l[r]) + psum;
        m[r] = m_new;
      }
    }
    __syncthreads();
    for (int e = threadIdx.x; e < R * hd; e += blockDim.x) {
      const int r = e / hd, d = e - r * hd;
      const float* prow = sc + r * CR;
      float dot = 0.f;
      for (int t = 0; t < rows; ++t) dot += prow[t] * vt[t * hd + d];
      const float c = corr[r];
      acc[e] = (c != 1.f ? acc[e] * c : acc[e]) + dot;
    }
  }
  __syncthreads();
  for (int r = threadIdx.x; r < R; r += blockDim.x)
    if (!(l[r] > 0.f)) l[r] = 1.f;
  __syncthreads();
  store_out<Q>(out, acc, l, b, h, W, nq, g, hd);
}

template <typename K>
cudaError_t prepare(K kernel, int smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              smem);
}

}  // namespace

#define HPX_PAGED_ARGS                                                       \
  const void *q, const void *kp, const void *vp, const float *ks,           \
      const float *vs, const int *table, const int *pos0, void *out, int B, \
      int W, int nq, int nkv, int hd, int bs, int maxb, int cb,             \
      float sqrt_hd, int smem, cudaStream_t stream

#define HPX_PAGED_LAUNCH(KERNEL, P, Q)                                       \
  {                                                                          \
    cudaError_t e = prepare(KERNEL<P, Q>, smem);                             \
    if (e != cudaSuccess) return (int)e;                                     \
    KERNEL<P, Q><<<dim3(B, nkv), kThreads, smem, stream>>>(                  \
        (const Q *)q, (const P *)kp, (const P *)vp, ks, vs, table, pos0,     \
        (Q *)out, W, nq, nkv, hd, bs, maxb, cb, sqrt_hd);                    \
    return (int)cudaGetLastError();                                          \
  }

// one C entry point per (pool type, query/output type) the server uses
#define HPX_PAGED_ENTRY(NAME, P, Q)                                          \
  extern "C" int hpx_paged_exact_##NAME(HPX_PAGED_ARGS)                      \
      HPX_PAGED_LAUNCH(paged_attention_exact, P, Q)                          \
  extern "C" int hpx_paged_online_##NAME(HPX_PAGED_ARGS)                     \
      HPX_PAGED_LAUNCH(paged_attention_online, P, Q)

HPX_PAGED_ENTRY(f32_f32, float, float)
HPX_PAGED_ENTRY(bf16_bf16, __nv_bfloat16, __nv_bfloat16)
HPX_PAGED_ENTRY(i8_f32, int8_t, float)
HPX_PAGED_ENTRY(i8_bf16, int8_t, __nv_bfloat16)
HPX_PAGED_ENTRY(fp8_f32, __nv_fp8_e4m3, float)
HPX_PAGED_ENTRY(fp8_bf16, __nv_fp8_e4m3, __nv_bfloat16)

extern "C" const char *hpx_paged_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
