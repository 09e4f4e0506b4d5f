// Paged decode attention: two hand-written kernels that walk the int32
// block table of a paged KV pool, for Hopper (sm_90a).
//
// Replaces the two Pallas kernels of hpx_tpu/ops/attention_pallas.py:
//   paged_attention_exact   <- _paged_kernel        (:908)
//   paged_attention_online  <- _paged_online_kernel (:972)
// Plain C interface (no PyTorch headers), loaded with ctypes by
// hpx_tpu_torch/ops/attention_cuda.py, which checks shapes, types and
// devices, picks the split P, the ring's stages and the chunk, allocates
// the output and passes the shared-memory size; `paged_layout` below
// owns that size, and every entry point refuses a smaller one.
//
// Layouts (all contiguous):
//   q, out   [B, W, nq, hd]          Q = float or bf16
//   k/v pool [num_blocks, bs, nkv, hd] P = float, bf16, int8 or fp8 e4m3
//   k/v scale [num_blocks, nkv] f32  (int8/fp8 pools only)
//   table    [B, maxb] int32 logical -> physical block
//   pos0     [B] int32: window row w attends positions <= pos0 + w
// The W*g query rows of (slot b, kv-head h) (row r = w*g + j for q head
// h*g + j, g = nq / nkv) share the K/V of head h.
//
// What bounds them on this card: decode reads every live K/V row once
// (bytes: 2 * (pos0 + W) * hd * sizeof(P) per (slot, head): the rows up
// to pos0 + W - 1) and does 4 FLOPs per (query row, key, hd element), far
// below the H100's ~295 FLOP/byte ridge: HBM bytes of the live rows bound
// both. At decode that is a few MB spread over a few dozen (slot, head)
// pairs, so the design is about bytes in flight and about the
// instructions each staged byte costs:
//
// * Split over the key sequence (flash-decoding) inside one launch: the
//   grid is (P, B*nkv) with a thread-block cluster of P <= 8 CTAs per
//   (slot, head). The live blocks [0, nlive) are cut into P contiguous
//   runs of whole blocks, rank p taking [ceil(p*nlive/P),
//   ceil((p+1)*nlive/P)). A rank whose run is empty loads nothing and
//   contributes the neutral partial. The ranks merge through distributed
//   shared memory in rank order (each rank merging every P-th output
//   element): no atomics, one launch per call, the same bits run after
//   run.
// * Dead blocks (first position past pos0 + W - 1) are never loaded: for
//   finite pools that is bit for bit what visiting and masking gives,
//   because masked lanes add exactly 0. A partly live block is loaded
//   and masked per position.
// * Raw pool bytes, pipelined: a ring of S shared-memory stages (a
//   template argument: 3, or 2 where 3 do not fit), each one chunk of cb
//   table blocks (64 rows) of head h in the pool's own type, filled by
//   16-byte cp.async.cg copies S - 1 chunks ahead of the one being
//   computed; dequantized in registers at the point of use. Where a
//   block is longer than a stage can hold, the wrapper's plan walks it
//   in `sub` parts of bs / sub rows (a power of two dividing bs): the
//   kernels then see blocks of bs / sub rows and a table sub times as
//   long, part j of block t being virtual block t * sub + j, whose id is
//   the physical id * sub + j (its rows are the pool's rows (id * sub +
//   j) * bs / sub .. +bs / sub) and whose scale is that of id. A load's
//   block ids and scales are read from the table and the scale arrays
//   into registers an iteration before its copies are issued and stored
//   at that iteration's end, into a ring of S + 1 slots, so shared
//   memory has no extent in the sequence but the exact kernel's scores
//   and no iteration waits on a global read. Where a row is not a whole
//   number of 16-byte pieces, or a pool is not 16-byte aligned, the
//   stage is filled by element loads and its rows padded with zeros to
//   16 bytes (hp elements).
// * Dots shaped for decode on the FP32 units (W*g = 1 on the main path):
//   q.K^T with a lane's share of q[r] in registers and G lanes a key (8
//   16-byte pieces are one shared-memory wavefront; more lanes for rows
//   over 256 elements), reduced in log2(G) shuffles; p.V with each
//   thread owning one 16-byte column piece and one of KG key groups, the
//   groups' f32 partial sums added in order at the end of the run.
//
// paged_attention_exact keeps the reference's dtype steps: the dot is
// rounded to the compute type, divided by sqrt(hd) there, held as f32;
// a masked softmax over the whole row with the row's global max and sum
// (run maxima, then run sums of exp(s - m), exchanged over the cluster);
// p rounded to the compute type; p.V summed in f32, the runs' partial
// sums added in rank order. It differs from the oracle only in the f32
// order of the row sum and of p.V. Its shared memory holds the W*g x
// (longest run) f32 scores, so W*g*S/P is capped; the wrapper raises P
// (up to 8) until the run fits. V's copies start while the cluster
// exchanges the statistics.
//
// paged_attention_online folds its run chunk by chunk (cb blocks from
// the run's start) into an f32 (acc, m, l) carry: rescale only where the
// running max moved, masked lanes exactly 0, p rounded to bf16 for bf16
// pools. The cluster then merges in rank order: m = max m_p,
// l = sum l_p e^(m_p - m), acc = sum acc_p e^(m_p - m), normalized once.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>
#include <stdint.h>

#include <type_traits>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxCluster = 8;      // portable cluster size: P <= 8
constexpr int kMaxSmem = 232448;    // dynamic shared memory a CTA can use
constexpr int kMaxHeadDim = 1024;   // 32 lanes x 32 elements of q a lane
constexpr float kNegInf = -1e30f;   // the online carry's "minus infinity"
// returned by an entry point whose arguments its layout cannot take
constexpr int kErrLayout = 100000;

template <typename T> struct IsQuant { static constexpr bool value = false; };
template <> struct IsQuant<int8_t> { static constexpr bool value = true; };
template <> struct IsQuant<__nv_fp8_e4m3> {
  static constexpr bool value = true;
};

// pool elements in 16 bytes
template <typename P> struct Pack {
  static constexpr int n = 16 / static_cast<int>(sizeof(P));
};

// Key groups of the p.V product: the largest power of two KG with
// KG * R * vpr <= kThreads (vpr: a staged row's 16-byte pieces), at
// least 1.
__host__ __device__ inline int pv_groups(int R, int vpr) {
  int KG = 1;
  while (KG * 2 * R * vpr <= kThreads) KG *= 2;
  return KG;
}

// A CTA's dynamic shared memory, as byte offsets: the ring [stages][cb *
// bs][hp] P | qs [R][hp] | acc [KG][R][hp] | sc [R][run's keys (exact)
// or a chunk's (online)] | statistics [R] x 4 (exact: pmax, gmax, psum,
// tot) or x 3 (online: m, l, corr) | block ids [stages + 1][cb] | their
// scales [stages + 1][cb]. The kernels cut their memory with it and the
// entry points check the passed size against `total`.
struct Layout {
  int hp;     // a staged row's elements: hd padded to 16 bytes
  int KG;     // key groups of p.V
  size_t qs, acc, sc, stat, ids, scl, total;
};

__host__ __device__ inline Layout paged_layout(bool exact, int elem, int R,
                                               int maxb, int bs, int hd,
                                               int cb, int P, int stages) {
  Layout L;
  const int nv = 16 / elem, rows = cb * bs, slots = stages + 1;
  const int per = (maxb + P - 1) / P;         // the longest run, in blocks
  L.hp = (hd + nv - 1) / nv * nv;
  L.KG = pv_groups(R, L.hp / nv);
  L.qs = (size_t)stages * rows * L.hp * elem;
  L.acc = L.qs + sizeof(float) * (size_t)R * L.hp;
  L.sc = L.acc + sizeof(float) * (size_t)L.KG * R * L.hp;
  L.stat = L.sc + sizeof(float) * (size_t)R *
                     (exact ? (size_t)per * bs : (size_t)rows);
  L.ids = L.stat + sizeof(float) * (size_t)R * (exact ? 4 : 3);
  L.scl = L.ids + sizeof(int) * (size_t)slots * cb;
  L.total = L.scl + sizeof(float) * (size_t)slots * cb;
  return L;
}

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
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

// a pool element whose bytes are all 0 (the value 0 in every pool type)
template <typename P> __device__ __forceinline__ P zero_of() {
  P z;
  unsigned char* b = reinterpret_cast<unsigned char*>(&z);
#pragma unroll
  for (int i = 0; i < (int)sizeof(P); ++i) b[i] = 0;
  return z;
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

// -- cp.async: 16-byte copies global -> shared, in commit groups ------------

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most S - 2 groups are pending: the oldest load of a ring
// of S stages has landed
template <int S> __device__ __forceinline__ void cp_async_wait_oldest() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(S - 2) : "memory");
}

// What a CTA walks: live blocks [lo, lo + n) of the table row of slot b,
// kv-head h; rank `rank` of P. `per` is the longest run, in blocks;
// `trow` the slot's table row, of maxb / sub physical blocks; `sub` the
// parts a physical block is walked in (bs and maxb count the parts).
struct Run {
  int b, h, rank, P, p0, lo, n, per, sub;
  const int* trow;
};

__device__ __forceinline__ Run my_run(int rank, const int* __restrict__ pos0,
                                      const int* __restrict__ table, int nkv,
                                      int W, int bs, int maxb, int sub) {
  Run u;
  u.rank = rank;
  u.P = (int)gridDim.x;
  u.b = blockIdx.y / nkv;
  u.h = blockIdx.y - u.b * nkv;
  u.p0 = pos0[u.b];
  const int lim = u.p0 + W - 1;                 // last position any row sees
  const int nlive = lim < 0 ? 0 : min(maxb, lim / bs + 1);
  u.lo = (u.rank * nlive + u.P - 1) / u.P;
  u.n = ((u.rank + 1) * nlive + u.P - 1) / u.P - u.lo;
  u.per = (maxb + u.P - 1) / u.P;
  u.sub = sub;
  u.trow = table + (size_t)u.b * (maxb / sub);
  return u;
}

// the id of run block j (part (lo + j) % sub of table block (lo + j) /
// sub): the physical id where a block is walked whole
__device__ __forceinline__ int block_id(const Run& u, int j) {
  const int v = u.lo + j;
  if (u.sub == 1) return u.trow[v];
  const int t = v / u.sub;
  return u.trow[t] * u.sub + (v - t * u.sub);
}

// A chunk of the run: blocks [c0, c0 + len) of it, staged as len * bs
// consecutive rows.
struct Chunk {
  int c0, len;
};

__device__ __forceinline__ Chunk chunk_of(int c, int n, int cb) {
  return Chunk{c * cb, min(cb, n - c * cb)};
}

// The loads' block ids (block_id), from slot b's table row: load j's in
// slot j % (S + 1) of the ids ring (cb entries a slot). The first S loads' are
// read before the walk (fill_ids: every table read in flight at once);
// afterwards load j's are read into a register at the top of iteration
// j - S and stored at its end (ids_fetch, ids_store), so the read's
// latency hides behind the iteration's work. `chunk(j)` is load j's
// chunk; thread i < cb owns entry i. (A load's scales travel with its
// copies: issue_chunk.)
template <int S, typename CF>
__device__ __forceinline__ void fill_ids(int loads, int cb, int* ids,
                                         const Run& u, CF chunk) {
  const int i = threadIdx.x;
  int bid[S];
#pragma unroll
  for (int j = 0; j < S; ++j)
    if (j < loads && i < chunk(j).len) bid[j] = block_id(u, chunk(j).c0 + i);
#pragma unroll
  for (int j = 0; j < S; ++j)
    if (j < loads && i < chunk(j).len) ids[j * cb + i] = bid[j];  // slot j
}

template <int S, typename CF>
__device__ __forceinline__ void ids_fetch(int k, int loads, const Run& u,
                                          CF chunk, int& r_id) {
  const int i = threadIdx.x, j = k + S;
  if (j < loads && i < chunk(j).len) r_id = block_id(u, chunk(j).c0 + i);
}

template <int S, typename CF>
__device__ __forceinline__ void ids_store(int k, int loads, int cb,
                                          int* ids, CF chunk, int r_id) {
  const int i = threadIdx.x, j = k + S;
  if (j < loads && i < chunk(j).len) ids[(j % (S + 1)) * cb + i] = r_id;
}

// Copy the chunk's rows of kv-head h into `stage` (rows of hp elements),
// its blocks' ids in `ids`, and for quantized pools the blocks' scales of
// head h from `scales` into `scl` (4-byte copies in the same group, so
// they land with the rows; a part's scale is its block's, id / sub).
// vec: hd is a whole number of 16-byte pieces and the pools are 16-byte
// aligned, so the raw pool bytes go by len * bs * hd * sizeof(P) / 16
// cp.async copies over the CTA (where the row's pieces divide the CTA,
// each thread keeps one piece x and steps over the rows without a
// division); otherwise by element loads, the row's padding to hp zeroed.
template <typename P>
__device__ __forceinline__ void issue_chunk(P* stage,
                                            const P* __restrict__ pool,
                                            const float* __restrict__ scales,
                                            float* scl, const int* ids,
                                            Chunk c, int h, int bs, int nkv,
                                            int hd, int hp, bool vec,
                                            int sub) {
  constexpr int NV = Pack<P>::n;
  if constexpr (IsQuant<P>::value) {
    if (threadIdx.x < c.len) {
      const int id = ids[threadIdx.x];
      cp_async4(scl + threadIdx.x,
                scales + (size_t)(sub == 1 ? id : id / sub) * nkv + h);
    }
  }
  const size_t row = (size_t)nkv * hd;
  const int rows = c.len * bs;
  auto at = [&](int blk, int tb) {
    return pool + ((size_t)ids[blk] * bs * nkv + h) * hd + tb * row;
  };
  if (!vec) {
    for (int e = threadIdx.x; e < rows * hp; e += kThreads) {
      const int t = e / hp, d = e - t * hp, blk = t / bs;
      stage[e] = d < hd ? at(blk, t - blk * bs)[d] : zero_of<P>();
    }
    return;
  }
  const int vpr = hd / NV;                       // pieces a row
  if (kThreads % vpr == 0) {
    const int step = kThreads / vpr, x = threadIdx.x % vpr;
    int t = threadIdx.x / vpr, blk = t / bs, tb = t - blk * bs;
    for (; t < rows; t += step) {
      cp_async16(stage + t * hp + x * NV, at(blk, tb) + x * NV);
      for (tb += step; tb >= bs; tb -= bs) ++blk;
    }
    return;
  }
  for (int v = threadIdx.x; v < rows * vpr; v += kThreads) {
    const int t = v / vpr, x = v - t * vpr;      // chunk row, piece
    const int blk = t / bs;
    cp_async16(stage + t * hp + x * NV, at(blk, t - blk * bs) + x * NV);
  }
}

// 16 bytes of pool elements as floats in x, in registers. Quantized pools
// dequantize as the reference does at its VMEM boundary: (float(q) *
// scale) rounded to the compute type Q.
template <typename P, typename Q>
__device__ __forceinline__ void unpack(const uint4& raw, float scale,
                                       float (&x)[Pack<P>::n]) {
  const unsigned w[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    if constexpr (sizeof(P) == 4) {
      x[i] = __uint_as_float(w[i]);
    } else if constexpr (sizeof(P) == 2) {                // bf16: exact
      x[2 * i] = __uint_as_float(w[i] << 16);
      x[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const unsigned char byte = (w[i] >> (8 * j)) & 0xffu;
        float f;
        if constexpr (std::is_same<P, __nv_fp8_e4m3>::value) {
          __nv_fp8_e4m3 e;
          e.__x = byte;
          f = static_cast<float>(e);
        } else {
          f = static_cast<float>(static_cast<int8_t>(byte));
        }
        x[4 * i + j] = round_to<Q>(f * scale);
      }
    }
  }
}

// Elements of q a lane holds for one key's dot: 32, the same for every
// pool type (MAXV 16-byte pieces of Pack<P>::n elements).
template <typename P> struct DotPieces {
  static constexpr int n = 32 / Pack<P>::n;
};

// Lanes a key's dot is spread over: a power of two, at most 8 (eight
// 16-byte pieces are one 128-byte shared-memory wavefront) and at most
// the row's 16-byte pieces, raised (up to 32) until a lane's pieces fit
// its DotPieces registers.
template <typename P>
__device__ __forceinline__ int dot_lanes(int hp) {
  const int vpr = hp / Pack<P>::n;
  int G = 1;
  while (G * 2 <= 8 && G * 2 <= vpr) G *= 2;
  while (G < 32 && (vpr + G - 1) / G > DotPieces<P>::n) G *= 2;
  return G;
}

// store(r, t, dot(qs[r], K[t])) for every query row r and key t < rows of
// the staged chunk: G lanes a key, lane gl holding pieces gl, gl + G, ...
// of q[r] in registers and reading the same 16-byte pieces of the key row
// (G pieces are one shared-memory wavefront), two keys a group at a time
// (their shuffle reductions interleave). `scales`: the chunk's blocks'
// scales. The loop trip count is the same for every lane of a warp.
template <typename P, typename Q, typename F>
__device__ __forceinline__ void chunk_scores(const P* stage,
                                             const float* scales,
                                             const float* qs, int R, int rows,
                                             int bs, int hp, int G, F store) {
  constexpr int NV = Pack<P>::n, MAXV = DotPieces<P>::n;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int per_warp = 32 / G, gl = lane % G, gw = lane / G;
  const int groups = kThreads / G;
  const int vpr = hp / NV;
  for (int r = 0; r < R; ++r) {
    float qv[MAXV][NV];
#pragma unroll
    for (int i = 0; i < MAXV; ++i) {
      if (gl + i * G < vpr) {
        const float4* q4 = reinterpret_cast<const float4*>(
            qs + r * hp + (gl + i * G) * NV);
#pragma unroll
        for (int j = 0; j < NV / 4; ++j) {
          const float4 v = q4[j];
          qv[i][4 * j] = v.x;
          qv[i][4 * j + 1] = v.y;
          qv[i][4 * j + 2] = v.z;
          qv[i][4 * j + 3] = v.w;
        }
      }
    }
    for (int t0 = warp * per_warp; t0 < rows; t0 += 2 * groups) {
      const int t[2] = {t0 + gw, t0 + gw + groups};
      float a[2] = {0.f, 0.f};
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        if (t[u] < rows) {
          const float s = IsQuant<P>::value ? scales[t[u] / bs] : 1.f;
          const uint4* krow =
              reinterpret_cast<const uint4*>(stage + t[u] * hp);
#pragma unroll
          for (int i = 0; i < MAXV; ++i) {
            if (gl + i * G < vpr) {
              float x[NV];
              unpack<P, Q>(krow[gl + i * G], s, x);
#pragma unroll
              for (int j = 0; j < NV; ++j) a[u] += qv[i][j] * x[j];
            }
          }
        }
      }
      for (int o = G / 2; o > 0; o >>= 1) {
        a[0] += __shfl_xor_sync(0xffffffffu, a[0], o);
        a[1] += __shfl_xor_sync(0xffffffffu, a[1], o);
      }
      if (gl == 0) {
        if (t[0] < rows) store(r, t[0], a[0]);
        if (t[1] < rows) store(r, t[1], a[1]);
      }
    }
  }
}

// accp[kg][r][d] = accp[kg][r][d] * corr[r] + sum_t p[r * ld + t] * V[t][d]
// over the staged chunk's keys t = kg, kg + KG, ... in order: each thread
// owns one key group kg and 16-byte column pieces (r, d .. d + NV - 1) of
// it, the same on every call. The KG partial sums are added in kg order
// once the run is done (sum_groups). corr == nullptr: no rescale.
// `scales`: the chunk's blocks' scales.
template <typename P, typename Q>
__device__ __forceinline__ void chunk_pv(const P* stage,
                                         const float* scales,
                                         const float* p, int ld, float* accp,
                                         const float* corr, int R, int rows,
                                         int bs, int hp, int KG) {
  constexpr int NV = Pack<P>::n;
  const int vpr = hp / NV, items = R * vpr, per = kThreads / KG;
  const int kg = threadIdx.x / per;
  for (int it = threadIdx.x - kg * per; it < items; it += per) {
    const int r = it / vpr, c = it - r * vpr;
    const float* pr = p + r * ld;
    float a[NV];
#pragma unroll
    for (int j = 0; j < NV; ++j) a[j] = 0.f;
    for (int t = kg; t < rows; t += KG) {
      const float s = IsQuant<P>::value ? scales[t / bs] : 1.f;
      float x[NV];
      unpack<P, Q>(reinterpret_cast<const uint4*>(stage + t * hp)[c], s, x);
      const float pt = pr[t];
#pragma unroll
      for (int j = 0; j < NV; ++j) a[j] += pt * x[j];
    }
    float* dst = accp + ((size_t)kg * R + r) * hp + c * NV;
    const float cr = corr ? corr[r] : 1.f;
#pragma unroll
    for (int j = 0; j < NV; ++j)
      dst[j] = (cr != 1.f ? dst[j] * cr : dst[j]) + a[j];
  }
}

// accp[0][e] = sum over kg of accp[kg][e], in kg order (after a barrier)
__device__ __forceinline__ void sum_groups(float* accp, int n, int KG) {
  for (int e = threadIdx.x; e < n; e += kThreads) {
    float s = accp[e];
    for (int kg = 1; kg < KG; ++kg) s += accp[(size_t)kg * n + e];
    accp[e] = s;
  }
}

// v[c] = what rank c of the cluster holds at `addr` (the address of the
// same shared variable in this CTA) for c < P, 0 beyond: every read is
// issued before any is used.
__device__ __forceinline__ void from_ranks(cg::cluster_group cluster,
                                           const float* addr, int P,
                                           float (&v)[kMaxCluster]) {
#pragma unroll
  for (int c = 0; c < kMaxCluster; ++c)
    v[c] = c < P ? *cluster.map_shared_rank(addr, c) : 0.f;
}

// Query rows of (slot b, kv-head h) into qs [R][hp] as float, the
// padding beyond hd zeroed.
template <typename Q>
__device__ void load_queries(float* qs, const Q* q, int b, int h, int W,
                             int nq, int g, int hd, int hp) {
  const int R = W * g;
  for (int e = threadIdx.x; e < R * hp; e += kThreads) {
    const int r = e / hp, d = e - r * hp;
    const int w = r / g, j = r - w * g;
    qs[e] = d < hd ? to_f32(q[(((size_t)b * W + w) * nq + h * g + j) * hd + d])
                   : 0.f;
  }
}

// out[b, w, h*g + j, d] for query row r = w*g + j of (slot b, kv-head h)
template <typename Q>
__device__ __forceinline__ void store_out(Q* out, int r, int d, float v,
                                          int b, int h, int W, int nq, int g,
                                          int hd) {
  const int w = r / g, j = r - w * g;
  out[(((size_t)b * W + w) * nq + h * g + j) * hd + d] = from_f32<Q>(v);
}

// ---------------------------------------------------------------------------
// paged_attention_exact (replaces _paged_kernel); shared memory as
// paged_layout(true, ...)
// ---------------------------------------------------------------------------
// at most 96 registers a thread, so that 5 CTAs fit an SM: with up to
// 128 (4 CTAs an SM) the int8 instantiations measured 16 % slower at the
// decode shape on an H100
template <typename P, typename Q, int S>
__global__ void __launch_bounds__(kThreads, 5)
paged_attention_exact(const Q* __restrict__ q, const P* __restrict__ kp,
                      const P* __restrict__ vp, const float* __restrict__ ks,
                      const float* __restrict__ vs,
                      const int* __restrict__ table,
                      const int* __restrict__ pos0, Q* __restrict__ out,
                      int W, int nq, int nkv, int hd, int bs, int maxb,
                      int cb, int sub, float sqrt_hd) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  cg::cluster_group cluster = cg::this_cluster();
  const Run u =
      my_run((int)cluster.block_rank(), pos0, table, nkv, W, bs, maxb, sub);
  const int g = nq / nkv, R = W * g, ld = u.per * bs, n = u.n;
  const Layout L = paged_layout(true, sizeof(P), R, maxb, bs, hd, cb, u.P, S);
  const int hp = L.hp, KG = L.KG, stage_elems = cb * bs * hp;
  constexpr int slots = S + 1;
  const int nch = (n + cb - 1) / cb;     // the run's chunks
  const bool vec = hd % Pack<P>::n == 0 &&
                   ((size_t)kp | (size_t)vp) % 16 == 0;
  P* ring = reinterpret_cast<P*>(smem_raw);
  float* qs = reinterpret_cast<float*>(smem_raw + L.qs);
  float* acc = reinterpret_cast<float*>(smem_raw + L.acc);  // [0]: cluster
  float* sc = reinterpret_cast<float*>(smem_raw + L.sc);
  float* pmax = reinterpret_cast<float*>(smem_raw + L.stat);  // cluster
  float* gmax = pmax + R;
  float* psum = gmax + R;                // read by the cluster
  float* tot = psum + R;
  int* ids = reinterpret_cast<int*>(smem_raw + L.ids);
  float* scl = reinterpret_cast<float*>(smem_raw + L.scl);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  // the load sequence: K chunks 0..nch-1, then V chunks 0..nch-1; load
  // k's ids and scales in slot k % slots (issue_chunk copies the scales)
  auto chunk_k = [&](int k) { return chunk_of(k < nch ? k : k - nch, n, cb); };
  int r_id = 0;
  auto fetch = [&](int k) { ids_fetch<S>(k, 2 * nch, u, chunk_k, r_id); };
  auto store = [&](int k) {
    ids_store<S>(k, 2 * nch, cb, ids, chunk_k, r_id);
  };
  auto issue = [&](int k) {
    if (k < 2 * nch)
      issue_chunk<P>(ring + (size_t)(k % S) * stage_elems,
                     k < nch ? kp : vp, k < nch ? ks : vs,
                     scl + (k % slots) * cb, ids + (k % slots) * cb,
                     chunk_k(k), u.h, bs, nkv, hd, hp, vec, sub);
    cp_async_commit();                   // one group a load, maybe empty
  };

  load_queries<Q>(qs, q, u.b, u.h, W, nq, g, hd, hp);
  for (int e = threadIdx.x; e < KG * R * hp; e += kThreads) acc[e] = 0.f;
  fill_ids<S>(2 * nch, cb, ids, u, chunk_k);
  __syncthreads();
  for (int k = 0; k < S - 1; ++k) issue(k);
  const int G = dot_lanes<P>(hp);

  // 1. the run's scores: the dot rounded to the compute type, divided by
  //    sqrt(hd) there, held as f32
  int k = 0;
  for (; k < nch; ++k) {
    cp_async_wait_oldest<S>();
    __syncthreads();                     // load k landed; k - 1 consumed
    issue(k + S - 1);
    fetch(k);
    const Chunk c = chunk_k(k);
    float* dst = sc + c.c0 * bs;
    chunk_scores<P, Q>(ring + (size_t)(k % S) * stage_elems,
                       scl + (k % slots) * cb, qs, R, c.len * bs, bs, hp, G,
                       [&](int r, int t, float x) {
                         dst[r * ld + t] =
                             round_to<Q>(round_to<Q>(x) / sqrt_hd);
                       });
    store(k);
  }
  __syncthreads();

  // 2. the softmax over the whole row, V's copies already in flight:
  //    run maxima -> global max over the cluster -> run sums of
  //    exp(s - m) -> global sum in rank order -> p in the compute type
  const int keys = n * bs;               // run key j is position lo*bs + j
  for (int r = warp; r < R; r += kWarps) {
    const int lr = u.p0 + r / g - u.lo * bs;   // live: j <= lr
    const float* row = sc + (size_t)r * ld;
    float m = -INFINITY;
    for (int j = lane; j < keys; j += 32)
      if (j <= lr) m = fmaxf(m, row[j]);
    m = warp_max(m);
    if (lane == 0) pmax[r] = m;
  }
  cluster.sync();
  for (int r = threadIdx.x; r < R; r += kThreads) {
    float v[kMaxCluster], m = -INFINITY;
    from_ranks(cluster, pmax + r, u.P, v);
#pragma unroll
    for (int c = 0; c < kMaxCluster; ++c)
      if (c < u.P) m = fmaxf(m, v[c]);
    gmax[r] = m;
  }
  __syncthreads();
  for (int r = warp; r < R; r += kWarps) {
    const int lr = u.p0 + r / g - u.lo * bs;
    float* row = sc + (size_t)r * ld;
    const float m = gmax[r];
    float sum = 0.f;
    for (int j = lane; j < keys; j += 32) {
      const float e = j <= lr ? expf(row[j] - m) : 0.f;
      row[j] = e;
      sum += e;
    }
    sum = warp_sum(sum);
    if (lane == 0) psum[r] = sum;
  }
  cluster.sync();
  for (int r = threadIdx.x; r < R; r += kThreads) {
    float v[kMaxCluster], sum = 0.f;
    from_ranks(cluster, psum + r, u.P, v);
#pragma unroll
    for (int c = 0; c < kMaxCluster; ++c)
      if (c < u.P) sum += v[c];             // rank order
    tot[r] = sum;
  }
  __syncthreads();
  for (int e = threadIdx.x; e < R * keys; e += kThreads) {
    const int r = e / keys, j = e - r * keys;
    float* x = sc + (size_t)r * ld + j;
    *x = round_to<Q>(*x / tot[r]);
  }

  // 3. the run's p.V in f32 (the loop's barrier publishes p)
  for (; k < 2 * nch; ++k) {
    cp_async_wait_oldest<S>();
    __syncthreads();
    issue(k + S - 1);
    fetch(k);
    const Chunk c = chunk_k(k);
    chunk_pv<P, Q>(ring + (size_t)(k % S) * stage_elems,
                   scl + (k % slots) * cb, sc + c.c0 * bs, ld, acc, nullptr,
                   R, c.len * bs, bs, hp, KG);
    store(k);
  }
  __syncthreads();
  sum_groups(acc, R * hp, KG);

  // 4. the partial sums added in rank order over the cluster, each rank
  //    summing and storing every P-th output element
  cluster.sync();
  for (int e = u.rank + u.P * threadIdx.x; e < R * hp; e += u.P * kThreads) {
    const int r = e / hp, d = e - r * hp;
    if (d >= hd) continue;                 // padding
    float v[kMaxCluster], sum = 0.f;
    from_ranks(cluster, acc + e, u.P, v);
#pragma unroll
    for (int c = 0; c < kMaxCluster; ++c)
      if (c < u.P) sum += v[c];
    store_out<Q>(out, r, d, sum, u.b, u.h, W, nq, g, hd);
  }
  cluster.sync();                        // shared memory read: keep it
}

// ---------------------------------------------------------------------------
// paged_attention_online (replaces _paged_online_kernel); shared memory as
// paged_layout(false, ...)
// ---------------------------------------------------------------------------
template <typename P, typename Q, int S>
__global__ void __launch_bounds__(kThreads)
paged_attention_online(const Q* __restrict__ q, const P* __restrict__ kp,
                       const P* __restrict__ vp, const float* __restrict__ ks,
                       const float* __restrict__ vs,
                       const int* __restrict__ table,
                       const int* __restrict__ pos0, Q* __restrict__ out,
                       int W, int nq, int nkv, int hd, int bs, int maxb,
                       int cb, int sub, float sqrt_hd) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  cg::cluster_group cluster = cg::this_cluster();
  const Run u =
      my_run((int)cluster.block_rank(), pos0, table, nkv, W, bs, maxb, sub);
  const int g = nq / nkv, R = W * g, n = u.n, CR = cb * bs;
  const Layout L = paged_layout(false, sizeof(P), R, maxb, bs, hd, cb, u.P,
                                S);
  const int hp = L.hp, KG = L.KG, stage_elems = CR * hp;
  constexpr int slots = S + 1;
  const int nch = (n + cb - 1) / cb;
  const bool vec = hd % Pack<P>::n == 0 &&
                   ((size_t)kp | (size_t)vp) % 16 == 0;
  P* ring = reinterpret_cast<P*>(smem_raw);
  float* qs = reinterpret_cast<float*>(smem_raw + L.qs);
  float* acc = reinterpret_cast<float*>(smem_raw + L.acc);  // [0]: cluster
  float* sc = reinterpret_cast<float*>(smem_raw + L.sc);
  float* m = reinterpret_cast<float*>(smem_raw + L.stat);   // cluster
  float* l = m + R;                      // read by the cluster
  float* corr = l + R;
  int* ids = reinterpret_cast<int*>(smem_raw + L.ids);
  float* scl = reinterpret_cast<float*>(smem_raw + L.scl);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  // the load sequence: chunk c's K (load 2c), then its V (load 2c + 1);
  // load k's ids and scales in slot k % slots (issue_chunk copies the
  // scales)
  auto chunk_k = [&](int k) { return chunk_of(k / 2, n, cb); };
  int r_id = 0;
  auto fetch = [&](int k) { ids_fetch<S>(k, 2 * nch, u, chunk_k, r_id); };
  auto store = [&](int k) {
    ids_store<S>(k, 2 * nch, cb, ids, chunk_k, r_id);
  };
  auto issue = [&](int k) {
    if (k < 2 * nch)
      issue_chunk<P>(ring + (size_t)(k % S) * stage_elems,
                     k % 2 ? vp : kp, k % 2 ? vs : ks,
                     scl + (k % slots) * cb, ids + (k % slots) * cb,
                     chunk_k(k), u.h, bs, nkv, hd, hp, vec, sub);
    cp_async_commit();
  };

  load_queries<Q>(qs, q, u.b, u.h, W, nq, g, hd, hp);
  for (int e = threadIdx.x; e < KG * R * hp; e += kThreads) acc[e] = 0.f;
  for (int r = threadIdx.x; r < R; r += kThreads) {
    m[r] = kNegInf;                      // the neutral partial
    l[r] = 0.f;
  }
  fill_ids<S>(2 * nch, cb, ids, u, chunk_k);
  __syncthreads();
  for (int k = 0; k < S - 1; ++k) issue(k);
  const int G = dot_lanes<P>(hp);

  for (int k = 0; k < 2 * nch; ++k) {
    cp_async_wait_oldest<S>();
    __syncthreads();                     // load k landed; k - 1 consumed
    issue(k + S - 1);
    fetch(k);
    const Chunk c = chunk_k(k);
    const P* st = ring + (size_t)(k % S) * stage_elems;
    const float* cs = scl + (k % slots) * cb;
    if (k % 2 == 0) {
      // f32 scores (no rounding to the compute type), scaled
      chunk_scores<P, Q>(st, cs, qs, R, c.len * bs, bs, hp, G,
                         [&](int r, int t, float x) {
                           sc[r * CR + t] = x / sqrt_hd;
                         });
      __syncthreads();                   // the chunk's scores are in
      // fold the chunk into the running (m, l) of each row
      const int rows = c.len * bs;
      for (int r = warp; r < R; r += kWarps) {
        float* row = sc + r * CR;
        const int lr = u.p0 + r / g - (u.lo + c.c0) * bs;  // live: t <= lr
        float mb = kNegInf;
        for (int t = lane; t < rows; t += 32)
          mb = fmaxf(mb, t <= lr ? row[t] : kNegInf);
        const float m_prev = m[r];
        const float m_new = fmaxf(m_prev, warp_max(mb));
        float psum = 0.f;
        for (int t = lane; t < rows; t += 32) {
          const float p = t <= lr ? expf(row[t] - m_new) : 0.f;
          psum += p;
          row[t] = round_to<Q>(p);       // p.V takes p in the V type
        }
        psum = warp_sum(psum);
        if (lane == 0) {
          // rescale only where the running max moved
          const float cr = m_new != m_prev ? expf(m_prev - m_new) : 1.f;
          corr[r] = cr;
          l[r] = (cr != 1.f ? l[r] * cr : l[r]) + psum;
          m[r] = m_new;
        }
      }
    } else {
      chunk_pv<P, Q>(st, cs, sc, CR, acc, corr, R, c.len * bs, bs, hp, KG);
    }
    store(k);
  }
  __syncthreads();
  sum_groups(acc, R * hp, KG);

  // merge the ranks' carries in rank order, normalize once; each rank
  // merges and stores every P-th output element
  cluster.sync();
  for (int e = u.rank + u.P * threadIdx.x; e < R * hp; e += u.P * kThreads) {
    const int r = e / hp, d = e - r * hp;
    if (d >= hd) continue;                 // padding
    float mv[kMaxCluster], lv[kMaxCluster], av[kMaxCluster];
    from_ranks(cluster, m + r, u.P, mv);
    from_ranks(cluster, l + r, u.P, lv);
    from_ranks(cluster, acc + e, u.P, av);
    float mx = kNegInf;
#pragma unroll
    for (int c = 0; c < kMaxCluster; ++c)
      if (c < u.P) mx = fmaxf(mx, mv[c]);
    float den = 0.f, num = 0.f;
#pragma unroll
    for (int c = 0; c < kMaxCluster; ++c) {
      if (c < u.P) {
        const float f = mv[c] != mx ? expf(mv[c] - mx) : 1.f;
        den += lv[c] * f;
        num += av[c] * f;
      }
    }
    store_out<Q>(out, r, d, num / (den > 0.f ? den : 1.f), u.b, u.h, W, nq,
                 g, hd);
  }
  cluster.sync();                        // shared memory read: keep it
}

// Let Kernel take up to a CTA's 227 KB of dynamic shared memory, once a
// device (the attribute belongs to the current device).
template <auto Kernel>
cudaError_t allow_smem() {
  static bool done[64] = {};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess || (dev < 64 && done[dev])) return e;
  e = cudaFuncSetAttribute(Kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           kMaxSmem);
  if (e == cudaSuccess && dev < 64) done[dev] = true;
  return e;
}

// One clustered launch: grid (P, B*nkv), a cluster of the P ranks of
// each (slot, kv-head).
template <auto Kernel, typename... Args>
int launch(int P, int BH, int smem, cudaStream_t stream, Args... args) {
  cudaError_t e = allow_smem<Kernel>();
  if (e != cudaSuccess) return (int)e;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(P, BH, 1);
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = P;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(&cfg, Kernel, args...);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

// kErrLayout unless the arguments fit the kernels: 1 <= P <= 8, stages 2
// or 3, cb >= 1, hd <= kMaxHeadDim, and `smem` at least the layout's
// size and at most a CTA's (bs and maxb as the kernels see them).
int check_layout(bool exact, int elem, int R, int maxb, int bs, int hd,
                 int cb, int P, int stages, int smem) {
  if (P < 1 || P > kMaxCluster || (stages != 2 && stages != 3) || cb < 1 ||
      hd < 1 || hd > kMaxHeadDim || R < 1 || bs < 1 || maxb < 0)
    return kErrLayout;
  const Layout L = paged_layout(exact, elem, R, maxb, bs, hd, cb, P, stages);
  return (size_t)smem < L.total || smem > kMaxSmem ? kErrLayout : 0;
}

}  // namespace

#define HPX_PAGED_ARGS                                                       \
  const void *q, const void *kp, const void *vp, const float *ks,           \
      const float *vs, const int *table, const int *pos0, void *out, int B, \
      int W, int nq, int nkv, int hd, int bs, int maxb, int cb, int sub,    \
      int splits, int stages, float sqrt_hd, int smem, cudaStream_t stream

#define HPX_PAGED_POINTERS(P, Q)                                             \
  (const Q *)q, (const P *)kp, (const P *)vp, ks, vs, table, pos0, (Q *)out

// one C entry point per (pool type, query/output type) the server uses;
// each instantiates its kernel for a ring of 3 stages and of 2. Blocks
// walked in `sub` parts reach the kernels as blocks of bs / sub rows and
// a table of maxb * sub of them.
#define HPX_PAGED_KERNEL(KIND, EXACT, P, Q)                                 \
  if (sub < 1 || bs % sub) return kErrLayout;                               \
  if (int e = check_layout(EXACT, sizeof(P), W * (nq / nkv), maxb * sub,   \
                           bs / sub, hd, cb, splits, stages, smem))         \
    return e;                                                               \
  return stages == 3                                                        \
             ? launch<paged_attention_##KIND<P, Q, 3>>(                     \
                   splits, B * nkv, smem, stream, HPX_PAGED_POINTERS(P, Q), \
                   W, nq, nkv, hd, bs / sub, maxb * sub, cb, sub, sqrt_hd)  \
             : launch<paged_attention_##KIND<P, Q, 2>>(                     \
                   splits, B * nkv, smem, stream, HPX_PAGED_POINTERS(P, Q), \
                   W, nq, nkv, hd, bs / sub, maxb * sub, cb, sub, sqrt_hd);

#define HPX_PAGED_ENTRY(NAME, P, Q)                                          \
  extern "C" int hpx_paged_exact_##NAME(HPX_PAGED_ARGS) {                    \
    HPX_PAGED_KERNEL(exact, true, P, Q)                                      \
  }                                                                          \
  extern "C" int hpx_paged_online_##NAME(HPX_PAGED_ARGS) {                   \
    HPX_PAGED_KERNEL(online, false, P, Q)                                    \
  }

HPX_PAGED_ENTRY(f32_f32, float, float)
HPX_PAGED_ENTRY(bf16_bf16, __nv_bfloat16, __nv_bfloat16)
HPX_PAGED_ENTRY(i8_f32, int8_t, float)
HPX_PAGED_ENTRY(i8_bf16, int8_t, __nv_bfloat16)
HPX_PAGED_ENTRY(fp8_f32, __nv_fp8_e4m3, float)
HPX_PAGED_ENTRY(fp8_bf16, __nv_fp8_e4m3, __nv_bfloat16)

// Bytes of dynamic shared memory a kernel's layout takes (exact != 0: the
// exact kernel) for R = W*g query rows, elem-byte pool elements and the
// launch's (cb, sub, P, stages); -1 where sub does not divide bs.
extern "C" long long hpx_paged_smem_bytes(int exact, int elem, int R,
                                          int maxb, int bs, int hd, int cb,
                                          int sub, int P, int stages) {
  if (sub < 1 || bs % sub) return -1;
  return (long long)paged_layout(exact != 0, elem, R, maxb * sub, bs / sub,
                                 hd, cb, P, stages)
      .total;
}

extern "C" const char *hpx_paged_error_string(int code) {
  if (code == kErrLayout)
    return "the arguments do not fit the kernel's shared-memory layout";
  return cudaGetErrorString((cudaError_t)code);
}
