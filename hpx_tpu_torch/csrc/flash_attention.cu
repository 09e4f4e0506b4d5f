// Flash attention for training: the forward kernel, the backward kernels
// and the ring's chunk fold, hand-written for Hopper (sm_90a).
//
// Replaces the four Pallas kernels of hpx_tpu/ops/attention_pallas.py:
//   flash_fwd_wgmma  <- _flash_kernel (:112); bf16 operands
//   flash_fwd_tf32x3 <- the same; f32 operands
//   flash_bwd_wgmma  <- _flash_bwd_dq_kernel (:397) and
//                       _flash_bwd_dkv_kernel (:446), in one kernel; bf16
//   flash_bwd_tf32x3 <- the same two, in one kernel; f32 operands
//   the chunk fold   <- _flash_chunk_kernel (:618): each forward kernel's
//                       tile loop with the (acc, m, l) carry read in and
//                       written back unnormalized, in place (template
//                       flag kChunk)
// Plain C interface (no PyTorch headers), loaded with ctypes by
// hpx_tpu_torch/ops/attention_cuda.py, which checks shapes, types,
// devices and alignment and allocates the outputs.
//
// Layouts (all contiguous, T = float or bf16):
//   q, do, o   [BN, sq, H]  T      BN = B * N q rows
//   k, v       [BNkv, sk, H] T     q row bn reads K/V row bn / g, g = BN / BNkv
//   lse, delta [BN, sq] f32        one value a row
//   acc        [BN, sq, H] f32     the chunk fold's carry, with m, l
//   m, l       [BN, sq] f32        (running max and sum), updated in place
//   dq         [BN, sq, H] f32     zeroed by the wrapper; the backward adds
//   dk, dv     [BNkv, sk, H] f32   per K/V row (each GQA group summed)
// Causal: key j is visible to query i iff j <= i + d (d = sk - sq in the
// forward: bottom-right alignment; the ring's offset for a chunk); keys
// j >= sk never are.
//
// What bounds them on this card: at the training shape (B 8, S 1024,
// 8 heads of 64, causal) the forward does ~8.6 GFLOP over the visible
// pairs on ~34 MB, about 250 FLOP/byte, near the H100's bf16 ridge (~295),
// so memory and tensor cores bound it alike (~0.010 ms); at H 64 the
// softmax's exp also runs at the rate of the tensor cores' products (256
// FLOP an exp, against 4096 FLOP and 16 exp a clock an SM), so the exp
// unit is a second bound as high. At B 2, S 4096, 8 heads of 128 it does
// ~69 GFLOP on ~34 MB: operations bound it (~0.070 ms). The backward does
// 2.5x the forward's operations (five products, 10 operations a visible
// pair and head element) and writes dq, dk, dv in f32: bytes bound it at
// the training shape (84 MB, ~0.025 ms), operations at B 2, S 4096
// (172 GFLOP, ~0.174 ms). The chunk fold at the ring's shape (32 rows of
// B.N, 512 x 512, H 64, bf16) moves 14.9 MB, most of it the f32 carry in
// and out, for at most 2.1 GFLOP: bytes bound it (~4.5 us).
//
// The bf16 kernels (flash_fwd_wgmma, flash_bwd_wgmma) are built for that:
// wgmma for every product (the only path to the full bf16 rate), tiles
// of 128 keys brought by TMA, a producer warpgroup keeping a ring of
// stages full while the consumer warpgroups compute, so no warp waits on
// a load it issued; scores stay in registers between the products; only
// tiles that cross the diagonal or an edge are masked; one FFMA and one
// ex2 a score. The forward reads Q once a CTA, and where a 64-row CTA and
// its ring fit twice an SM (H 64), two such CTAs share each SM, so that
// one's prologue and epilogue overlap the other's products. The
// backward keeps K and V of its key tile resident, computes each of the
// five products once, and adds dq by f32 atomics (flash_bwd_wgmma).
// The f32 kernels (flash_fwd_tf32x3, flash_bwd_tf32x3) have the same
// shape on mma.sync: their products run on the tensor cores as 3xTF32,
// each operand split into two TF32 halves and three products summed in
// f32, within the plain versions' 1e-5 (forward) and 1e-4 (backward)
// where one TF32 product alone misses them. The f32 forward and chunk
// fold keep their 64-row q tile's scores and P in registers, take K and
// V tiles of 64 keys by cp.async into a ring of two stages, mask only
// the tiles that cross the diagonal or an edge, and skip causal tiles
// past it.
//
// Numerics follow the reference kernels: scores = f32 dot * scale;
// masked lanes -1e30 and p exactly 0; online softmax in f32; p cast to
// bf16 before p.V (bf16 inputs), p and ds cast before the backward
// products; o = acc / l (0 on a row with no visible key), L = m + log l
// (0 there); p = exp(s - L), ds = p * (dp - delta) * scale; dq, dk, dv
// in f32. Both backward kernels add their dq partials atomically, in no
// fixed order.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

constexpr float kNegInf = -1e30f;

using bf16 = __nv_bfloat16;

// two floats rounded to bf16 (astype(bf16)), lo in the low half
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// reductions over the 4 lanes (t) that share a row of a C fragment
__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}
__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// ---------------------------------------------------------------------------
// flash_fwd_wgmma and, kChunk, its chunk fold: the forward and the chunk
// fold for bf16 operands on Hopper's warpgroup tensor cores, fed by TMA.
//
// A CTA owns kWG * 64 q rows (one consumer warpgroup each: 1, or 2 at H
// 128 where 128-row CTAs fill the SMs; flash_fwd_plan picks) and
// has one producer warpgroup, the last, whose first thread issues every
// load and whose registers go to the consumers (setmaxnreg). The
// producer loads Q once, then K and V tiles of kTileN keys into a ring
// of kStages stages, each with a K-full, a V-full and an empty mbarrier;
// it waits for a stage to be empty before refilling it, so the next
// stages' copies are in flight while the consumers compute. Every tile
// is a 128-byte-swizzled TMA box ([rows][64] bf16, two boxes a row at H
// 128; hopper.cuh). A consumer warpgroup, for each tile:
//   S = Q Kᵀ            wgmma m64n128k16, Q and K from shared memory
//   softmax             f32 in registers: masked only where the tile
//                       crosses the diagonal or the sk edge; the row max
//                       over 4 lanes; p = 2^(x · scale·log2e - m·log2e),
//                       one FFMA and one ex2; the rescale of O and l
//   O += P V            wgmma m64nHk16, P from registers (S's
//                       accumulator repacked as bf16 pairs), V from
//                       shared memory MN-major (the transpose bit: no
//                       transpose pass)
// and it releases the stage (an arrive on its empty barrier) only after
// P V's wgmma.wait_group. A tile wholly past this warpgroup's diagonal is
// released unread (the other warpgroup, whose rows see it, waits for its
// V before releasing, so no barrier phase is refilled early).
// kEarlyRelease (a planted fault for chip_smoke.py's check, never on a
// path) releases the stage once its V has landed, before P V, and then
// reads the V that the producer refilled the stage with.
// ---------------------------------------------------------------------------
constexpr int kTileN = 128;       // keys of a K/V tile
// stages of the K/V ring: 3 fit every plan (two 64-row CTAs an SM at H
// 64, one 128-row CTA at H 128); 2 and 4 measured the same
constexpr int kStages = 3;
constexpr int kMaxSmem = 232448;  // dynamic shared memory a CTA can use
constexpr int kBoxBytes = kTileN * 128;  // a [128][64] bf16 K or V box
constexpr float kLog2e = 1.4426950408889634f;
// returned by an entry point whose plan its layout cannot take, or whose
// tensor maps the driver refuses
constexpr int kErrLayout = 100000;
constexpr int kErrTensorMap = 100001;

// The bf16 forward's shared memory, byte offsets from a 1024-byte aligned
// base: Q (H/64 boxes of [block_m][64]) | kStages x (K boxes, V boxes) |
// mbarriers (Q-full, K-full[kStages], V-full[kStages], empty[kStages]).
// `total` adds the 1024 bytes of room to align the base.
struct FwdLayout {
  int stage, bars, total;
};
__host__ __device__ inline FwdLayout fwd_layout(int h, int block_m) {
  FwdLayout L;
  L.stage = block_m * h * 2;
  L.bars = L.stage + kStages * 2 * kTileN * h * 2;
  L.total = 1024 + L.bars + 8 * (1 + 3 * kStages);
  return L;
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

template <int H, bool kChunk, int kWG, bool kEarlyRelease>
__global__ void __launch_bounds__((kWG + 1) * 128, kWG == 1 ? 2 : 1)
flash_fwd_wgmma(const __grid_constant__ CUtensorMap tq,
                const __grid_constant__ CUtensorMap tk,
                const __grid_constant__ CUtensorMap tv,
                bf16* __restrict__ o, float* __restrict__ lse,
                float* __restrict__ cacc, float* __restrict__ cm,
                float* __restrict__ cl, int sq, int sk, int g, int d,
                int causal, float scale) {
  using namespace hopper;
  constexpr int BM = 64 * kWG;       // q rows of the CTA
  constexpr int KB = H / 64;         // 64-column boxes a row
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* base =
      smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  const FwdLayout L = fwd_layout(H, BM);
  unsigned char* qs = base;
  auto kbox = [&](int s, int j) {
    return base + L.stage + (2 * s * KB + j) * kBoxBytes;
  };
  auto vbox = [&](int s, int j) {
    return base + L.stage + ((2 * s + 1) * KB + j) * kBoxBytes;
  };
  uint64_t* qfull = reinterpret_cast<uint64_t*>(base + L.bars);
  uint64_t* kfull = qfull + 1;
  uint64_t* vfull = kfull + kStages;
  uint64_t* empty = vfull + kStages;

  const int bn = blockIdx.y;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * BM;   // longest rows first
  int nk = (sk + kTileN - 1) / kTileN;
  if (causal) {
    const int last = q0 + BM - 1 + d;
    nk = last < 0 ? 0 : min(nk, last / kTileN + 1);
  }
  if (kChunk && nk == 0) return;            // the whole CTA: carry kept

  if (threadIdx.x == 0) {
    mbar_init(qfull, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(kfull + s, 1);
      mbar_init(vfull + s, 1);
      mbar_init(empty + s, kWG * 128);
    }
    fence_barrier_init();
  }
  __syncthreads();

  // the warpgroup, warp-uniform to the compiler (lane 0's, shuffled):
  // branches on it are no divergent paths around the wgmma instructions
  const int wg = __shfl_sync(0xffffffffu, (int)threadIdx.x / 128, 0);
  if (wg == kWG) {                          // the producer
    regs_dealloc<24>();
    if (threadIdx.x == kWG * 128 && nk > 0) {
      mbar_expect_tx(qfull, BM * H * 2);
#pragma unroll
      for (int j = 0; j < KB; ++j)
        tma_load_3d(qs + j * BM * 128, &tq, qfull, 64 * j, q0, bn);
      const int kv = bn / g;
      int s = 0, ph = 0;
      for (int i = 0; i < nk; ++i) {
        mbar_wait(empty + s, ph ^ 1);
        mbar_expect_tx(kfull + s, kTileN * H * 2);
#pragma unroll
        for (int j = 0; j < KB; ++j)
          tma_load_3d(kbox(s, j), &tk, kfull + s, 64 * j, i * kTileN, kv);
        mbar_expect_tx(vfull + s, kTileN * H * 2);
#pragma unroll
        for (int j = 0; j < KB; ++j)
          tma_load_3d(vbox(s, j), &tv, vfull + s, 64 * j, i * kTileN, kv);
        if (++s == kStages) {
          s = 0;
          ph ^= 1;
        }
      }
    }
    return;
  }

  // a consumer warpgroup: rows qw0 .. qw0 + 63; this thread's rows are
  // row0 and row0 + 8 (the accumulator layout, hopper.cuh)
  regs_alloc<kWG == 2 ? 240 : 232>();
  const int tid = threadIdx.x % 128, warp = tid / 32, lane = tid % 32;
  const int t4 = lane % 4;
  const int qw0 = q0 + wg * 64;
  const int row0 = qw0 + warp * 16 + lane / 4;
  const float sl2 = scale * kLog2e;
  float oacc[H / 2], m[2], l[2];
#pragma unroll
  for (int i = 0; i < H / 2; ++i) oacc[i] = 0.f;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    m[r] = kNegInf;
    l[r] = 0.f;
    const int row = row0 + 8 * r;
    if (kChunk && row < sq) {
      const size_t at = (size_t)bn * sq + row;
      m[r] = cm[at];
      l[r] = cl[at];
#pragma unroll
      for (int j = 0; j < H / 8; ++j) {
        const float2 a = *reinterpret_cast<const float2*>(
            cacc + at * H + 8 * j + 2 * t4);
        oacc[4 * j + 2 * r] = a.x;
        oacc[4 * j + 2 * r + 1] = a.y;
      }
    }
  }

  if (nk > 0) mbar_wait(qfull, 0);
  const uint64_t dq = desc_sw128(qs + wg * 64 * 128, 16, 1024);
  float sacc[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) sacc[i] = 0.f;
  int s = 0, ph = 0;
  for (int i = 0; i < nk; ++i) {
    const int k0 = i * kTileN;
    mbar_wait(kfull + s, ph);
    if (causal && k0 > qw0 + 63 + d) {      // no key of it for these rows
      mbar_arrive(empty + s);
      if (++s == kStages) {
        s = 0;
        ph ^= 1;
      }
      continue;
    }
    // S = Q Kᵀ, H/16 steps of 16 along the head dim
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < H / 16; ++kk) {
      const uint32_t qoff = (kk / 4) * BM * 128 + (kk % 4) * 32;
      wgmma_ss_m64n128(sacc, dq + (qoff >> 4),
                       desc_sw128(kbox(s, kk / 4) + (kk % 4) * 32, 16, 1024),
                       kk > 0);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(sacc);

    // the online softmax of the tile, in f32
    if ((causal && k0 + kTileN - 1 > qw0 + d) || k0 + kTileN > sk) {
#pragma unroll
      for (int e = 0; e < 64; ++e) {
        const int kpos = k0 + 8 * (e >> 2) + 2 * t4 + (e & 1);
        const int qpos = row0 + 8 * ((e >> 1) & 1);
        if (kpos >= sk || (causal && kpos > qpos + d)) sacc[e] = -INFINITY;
      }
    }
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int e = 0; e < 64; ++e)
      mx[(e >> 1) & 1] = fmaxf(mx[(e >> 1) & 1], sacc[e]);
    float corr[2], mb[2], psum[2] = {0.f, 0.f};
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float m_new = fmaxf(m[r], quad_max(mx[r]) * scale);
      corr[r] = expf(m[r] - m_new);         // 1 where m did not move
      mb[r] = m_new * kLog2e;
      m[r] = m_new;
    }
#pragma unroll
    for (int e = 0; e < 64; ++e) {          // masked lanes: 2^-inf = 0
      const float p = ex2(fmaf(sacc[e], sl2, -mb[(e >> 1) & 1]));
      sacc[e] = p;
      psum[(e >> 1) & 1] += p;
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) l[r] = l[r] * corr[r] + quad_sum(psum[r]);
#pragma unroll
    for (int j = 0; j < H / 8; ++j) {
      oacc[4 * j] *= corr[0];
      oacc[4 * j + 1] *= corr[0];
      oacc[4 * j + 2] *= corr[1];
      oacc[4 * j + 3] *= corr[1];
    }
    uint32_t pa[8][4];                      // p cast to bf16 before P V
#pragma unroll
    for (int kk = 0; kk < 8; ++kk)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        pa[kk][e] = pack_bf16(sacc[8 * kk + 2 * e], sacc[8 * kk + 2 * e + 1]);

    // O += P V, 8 steps of 16 keys
    mbar_wait(vfull + s, ph);
    if (kEarlyRelease) {                    // the planted fault: V of tile
      mbar_arrive(empty + s);               // i + kStages where it refills
      if (i + kStages < nk) mbar_wait(vfull + s, ph ^ 1);
    }
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 8; ++kk) {
      const uint64_t dv = desc_sw128(vbox(s, 0) + kk * 16 * 128, kBoxBytes,
                                     1024);
      if constexpr (H == 64)
        wgmma_rs_m64n64_tb(oacc, pa[kk], dv, 1);
      else
        wgmma_rs_m64n128_tb(oacc, pa[kk], dv, 1);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(oacc);
    if (!kEarlyRelease) mbar_arrive(empty + s);
    if (++s == kStages) {
      s = 0;
      ph ^= 1;
    }
  }

  if constexpr (kChunk) {                   // the carry out, unnormalized
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = row0 + 8 * r;
      if (row >= sq) continue;
      const size_t at = (size_t)bn * sq + row;
      if (t4 == 0) {
        cm[at] = m[r];
        cl[at] = l[r];
      }
#pragma unroll
      for (int j = 0; j < H / 8; ++j)
        *reinterpret_cast<float2*>(cacc + at * H + 8 * j + 2 * t4) =
            make_float2(oacc[4 * j + 2 * r], oacc[4 * j + 2 * r + 1]);
    }
  } else {                                  // o = acc / l and L
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = row0 + 8 * r;
      if (row >= sq) continue;
      if (t4 == 0)
        lse[(size_t)bn * sq + row] = l[r] > 0.f ? m[r] + logf(l[r]) : 0.f;
      const float den = l[r] > 0.f ? l[r] : 1.f;
#pragma unroll
      for (int j = 0; j < H / 8; ++j)
        *reinterpret_cast<uint32_t*>(o + ((size_t)bn * sq + row) * H +
                                     8 * j + 2 * t4) =
            pack_bf16(oacc[4 * j + 2 * r] / den,
                      oacc[4 * j + 2 * r + 1] / den);
    }
  }
}

// ---------------------------------------------------------------------------
// flash_bwd_wgmma: the whole bf16 backward, kernels 6 and 7 in one launch
// (dq, and dk, dv per K/V row), on Hopper's warpgroup tensor cores fed by
// TMA, after FlashAttention-3's backward.
//
// A CTA owns one tile of kTileN = 128 keys of one K/V row (grid (B·Nkv,
// key tiles): key tile 0, which the most q tiles see, starts first). It
// loads its K and V tiles once by TMA and keeps them; at GQA it walks
// the g q heads of its group, so dk and dv are summed in registers and
// written once per K/V row. The last warpgroup is the producer: its
// first warp streams the q tiles that see the key tile (64 rows of Q and
// dO by TMA; their rows of L and delta, which TMA cannot take from an
// odd Sq's unaligned rows, by the warp's loads) into a ring of
// kBwdStages stages, each with a full and an empty mbarrier, from the
// first q tile that sees key k0 (the reference's `live` test). Two
// consumer warpgroups take 64 keys each; for every q tile, warpgroup w:
//   Sᵀ = K_w Qᵀ, dPᵀ = V_w dOᵀ   wgmma m64n64k16, both from shared memory
//   Pᵀ, dSᵀ                       f32 in registers: p = 2^(s·scale·log2e
//                                 - L·log2e), one FFMA and one ex2 a
//                                 score; ds = p (dp - delta) scale; the
//                                 mask only on tiles that cross the
//                                 diagonal or an Sq / Sk edge
//   dV += Pᵀ dO, dK += dSᵀ Q      wgmma m64nHk16, A from registers (the
//                                 score accumulators repacked as bf16
//                                 pairs: p and ds cast as the reference
//                                 casts them), B MN-major; dK and dV stay
//                                 in registers across every q tile
//   dSᵀ -> shared memory          bf16, by stmatrix.trans, as dS [64 q]
//                                 [128 keys] in 128-byte-swizzled boxes
//                                 (two buffers, one barrier a tile)
//   dQ += dS K                    wgmma m64n64k16 over the CTA's 128 keys,
//                                 A and B (MN-major) from shared memory:
//                                 at H 128 each warpgroup takes 64
//                                 columns, at H 64 the two take turns;
//                                 the f32 partial goes to shared memory
//                                 (128-byte swizzled) and two TMA bulk
//                                 reduce-adds add it into dq in L2, rows
//                                 past Sq left out (the wrapper zeroes dq)
// and it releases the stage once its products have completed. Each of
// the five products is computed once: 10 operations a visible pair and
// head element.
// Keys >= sk and q rows >= sq arrive as zeros from TMA and are masked. A
// CTA whose keys no q row sees writes zeros to dk and dv.
// ---------------------------------------------------------------------------
constexpr int kBwdM = 64;            // q rows of a Q / dO tile
constexpr int kBwdStages = 2;        // Q / dO stages of the ring
constexpr int kQBox = kBwdM * 128;   // a [64][64] bf16 box (Q, dO, dS)

// The bf16 backward's shared memory, byte offsets from a 1024-byte
// aligned base: K (H/64 boxes of [128][64]) | V | kBwdStages x (Q boxes,
// dO boxes, L [64] f32, delta [64] f32, padded to 1024) | dS (2 buffers x
// 2 boxes of [64 q][64 keys]) | dQ (a warpgroup's f32 [64][64] partial
// each, as 2 boxes of [64][32]) | mbarriers (K/V-full, full[kBwdStages],
// empty[kBwdStages]). `total` adds the 1024 bytes of room to align the
// base.
struct BwdLayout {
  int v, stage, stage_bytes, ds, dq, bars, total;
};
__host__ __device__ inline BwdLayout bwd_layout(int h) {
  BwdLayout L;
  L.v = kTileN * h * 2;
  L.stage = 2 * L.v;
  L.stage_bytes = 2 * kBwdM * h * 2 + 1024;
  L.ds = L.stage + kBwdStages * L.stage_bytes;
  L.dq = L.ds + 4 * kQBox;
  L.bars = L.dq + 2 * kBwdM * 64 * 4;
  L.total = 1024 + L.bars + 8 * (1 + 2 * kBwdStages);
  return L;
}

template <int H>
__global__ void __launch_bounds__(3 * 128, 1)
flash_bwd_wgmma(const __grid_constant__ CUtensorMap tq,
                const __grid_constant__ CUtensorMap tk,
                const __grid_constant__ CUtensorMap tv,
                const __grid_constant__ CUtensorMap tdo,
                const __grid_constant__ CUtensorMap tdq,
                const float* __restrict__ lse,
                const float* __restrict__ delta, float* __restrict__ dk,
                float* __restrict__ dv, int sq, int sk, int g, int d,
                int causal, float scale) {
  using namespace hopper;
  constexpr int KB = H / 64;         // 64-column boxes a row
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* base =
      smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  const BwdLayout L = bwd_layout(H);
  auto kbox = [&](int j) { return base + j * kBoxBytes; };
  auto vbox = [&](int j) { return base + L.v + j * kBoxBytes; };
  auto qbox = [&](int s, int j) {
    return base + L.stage + s * L.stage_bytes + j * kQBox;
  };
  auto dobox = [&](int s, int j) { return qbox(s, KB + j); };
  auto lrow = [&](int s) {
    return reinterpret_cast<float*>(qbox(s, 2 * KB));
  };
  auto drow = [&](int s) { return lrow(s) + kBwdM; };
  auto dsbox = [&](int buf, int w) {
    return base + L.ds + (2 * buf + w) * kQBox;
  };
  auto dqbuf = [&](int w) { return base + L.dq + w * kBwdM * 64 * 4; };
  uint64_t* kvfull = reinterpret_cast<uint64_t*>(base + L.bars);
  uint64_t* full = kvfull + 1;
  uint64_t* empty = full + kBwdStages;

  const int bkv = blockIdx.x;
  const int k0 = blockIdx.y * kTileN;
  // causal: q tile iq sees key k0 iff k0 <= iq*64 + 63 + d
  const int nq = (sq + kBwdM - 1) / kBwdM;
  const int first = k0 - (kBwdM - 1) - d;
  const int iq0 = causal && first > 0 ? (first + kBwdM - 1) / kBwdM : 0;
  const int ntq = iq0 < nq ? nq - iq0 : 0;  // q tiles of each q head
  const int items = g * ntq;                // (q head, q tile) pairs

  if (threadIdx.x == 0) {
    mbar_init(kvfull, 1);
    for (int s = 0; s < kBwdStages; ++s) {
      mbar_init(full + s, 1 + 32);          // TMA's, and the warp's
      mbar_init(empty + s, 2 * 128);
    }
    fence_barrier_init();
  }
  __syncthreads();

  // the warpgroup, warp-uniform to the compiler (lane 0's, shuffled)
  const int wg = __shfl_sync(0xffffffffu, (int)threadIdx.x / 128, 0);
  if (wg == 2) {                            // the producer
    regs_dealloc<24>();
    if (threadIdx.x < 2 * 128 + 32 && items > 0) {   // its first warp
      const int lane = threadIdx.x % 32;
      if (lane == 0) {
        mbar_expect_tx(kvfull, 2 * kTileN * H * 2);
#pragma unroll
        for (int j = 0; j < KB; ++j) {
          tma_load_3d(kbox(j), &tk, kvfull, 64 * j, k0, bkv);
          tma_load_3d(vbox(j), &tv, kvfull, 64 * j, k0, bkv);
        }
      }
      int s = 0, ph = 0;
      for (int i = 0; i < items; ++i) {
        const int bn = bkv * g + i / ntq, q0 = (iq0 + i % ntq) * kBwdM;
        mbar_wait(empty + s, ph ^ 1);
        if (lane == 0) {
          mbar_expect_tx(full + s, 2 * kBwdM * H * 2);
#pragma unroll
          for (int j = 0; j < KB; ++j) {
            tma_load_3d(qbox(s, j), &tq, full + s, 64 * j, q0, bn);
            tma_load_3d(dobox(s, j), &tdo, full + s, 64 * j, q0, bn);
          }
        }
        // L and delta of rows q0 .. q0 + 63, 0 past sq; each lane's
        // arrival releases its stores
        const size_t at = (size_t)bn * sq + q0;
#pragma unroll
        for (int r = lane; r < kBwdM; r += 32) {
          const bool in = q0 + r < sq;
          lrow(s)[r] = in ? lse[at + r] : 0.f;
          drow(s)[r] = in ? delta[at + r] : 0.f;
        }
        mbar_arrive(full + s);
        if (++s == kBwdStages) {
          s = 0;
          ph ^= 1;
        }
      }
    }
    return;
  }

  // a consumer warpgroup: keys kw0 .. kw0 + 63; this thread's keys are
  // key0 and key0 + 8, its q columns 8j + 2t4 + {0, 1} of each tile (the
  // accumulator layout, hopper.cuh)
  regs_alloc<240>();
  const int tid = threadIdx.x % 128, warp = tid / 32, lane = tid % 32;
  const int t4 = lane % 4;
  const int kw0 = k0 + wg * 64;
  const int key0 = kw0 + warp * 16 + lane / 4;
  const float sl2 = scale * kLog2e;
  float dka[H / 2], dva[H / 2], sacc[32], pacc[32], qacc[32];
#pragma unroll
  for (int i = 0; i < H / 2; ++i) dka[i] = dva[i] = 0.f;
#pragma unroll
  for (int i = 0; i < 32; ++i) sacc[i] = pacc[i] = qacc[i] = 0.f;

  if (items > 0) mbar_wait(kvfull, 0);
  // A of Sᵀ and dPᵀ: this warpgroup's 64 rows of K and of V
  const uint64_t ka = desc_sw128(kbox(0) + wg * 64 * 128, 16, 1024);
  const uint64_t va = desc_sw128(vbox(0) + wg * 64 * 128, 16, 1024);
  int s = 0, ph = 0;
  for (int i = 0; i < items; ++i) {
    const int bn = bkv * g + i / ntq, q0 = (iq0 + i % ntq) * kBwdM;
    mbar_wait(full + s, ph);
    // Sᵀ = K_w Qᵀ and dPᵀ = V_w dOᵀ, H/16 steps of 16 along the head dim
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < H / 16; ++kk) {
      const uint32_t off = ((kk / 4) * kBoxBytes + (kk % 4) * 32) >> 4;
      wgmma_ss_m64n64<0>(sacc, ka + off,
                         desc_sw128(qbox(s, kk / 4) + (kk % 4) * 32, 16,
                                    1024),
                         kk > 0);
    }
#pragma unroll
    for (int kk = 0; kk < H / 16; ++kk) {
      const uint32_t off = ((kk / 4) * kBoxBytes + (kk % 4) * 32) >> 4;
      wgmma_ss_m64n64<0>(pacc, va + off,
                         desc_sw128(dobox(s, kk / 4) + (kk % 4) * 32, 16,
                                    1024),
                         kk > 0);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(sacc);
    fence_regs(pacc);

    // Pᵀ and dSᵀ in f32; the mask only where the tile crosses the
    // diagonal or an edge
    const bool edge = (causal && kw0 + 63 > q0 + d) || q0 + kBwdM > sq ||
                      kw0 + 64 > sk;
    const float* lr = lrow(s);
    const float* dr = drow(s);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int c = 8 * j + 2 * t4;
      const float2 lv = *reinterpret_cast<const float2*>(lr + c);
      const float2 dl = *reinterpret_cast<const float2*>(dr + c);
      const float lb[2] = {lv.x * kLog2e, lv.y * kLog2e};
      const float de[2] = {dl.x, dl.y};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float p = ex2(fmaf(sacc[4 * j + e], sl2, -lb[e & 1]));
        if (edge) {
          const int kpos = key0 + 8 * (e >> 1), qpos = q0 + c + (e & 1);
          if (kpos >= sk || qpos >= sq || (causal && kpos > qpos + d))
            p = 0.f;
        }
        sacc[4 * j + e] = p;
        pacc[4 * j + e] = p * (pacc[4 * j + e] - de[e & 1]) * scale;
      }
    }
    uint32_t pa[4][4], da[4][4];            // p and ds cast to bf16
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        pa[kk][e] = pack_bf16(sacc[8 * kk + 2 * e], sacc[8 * kk + 2 * e + 1]);
        da[kk][e] = pack_bf16(pacc[8 * kk + 2 * e], pacc[8 * kk + 2 * e + 1]);
      }

    // dV += Pᵀ dO and dK += dSᵀ Q, 4 steps of 16 q rows
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const uint64_t bdo = desc_sw128(dobox(s, 0) + kk * 16 * 128, kQBox,
                                      1024);
      const uint64_t bq = desc_sw128(qbox(s, 0) + kk * 16 * 128, kQBox,
                                     1024);
      if constexpr (H == 64) {
        wgmma_rs_m64n64_tb(dva, pa[kk], bdo, 1);
        wgmma_rs_m64n64_tb(dka, da[kk], bq, 1);
      } else {
        wgmma_rs_m64n128_tb(dva, pa[kk], bdo, 1);
        wgmma_rs_m64n128_tb(dka, da[kk], bq, 1);
      }
    }
    wgmma_commit();

    // dSᵀ to shared memory as dS [q][key], this warpgroup's box of the
    // tile's buffer: the 8 x 8 blocks (q 8j .., keys 16 warp + 8 hh ..)
    // transposed; register m of da[jj] is block j = 2 jj + m / 2, hh =
    // m % 2, and lane l gives q row 8j + l % 8 of block m = l / 8, whose
    // 16-byte chunk 2 warp + hh lands at chunk ^ (row % 8) (the 128-byte
    // swizzle)
    unsigned char* dsb = dsbox(i & 1, wg);
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) {
      const int m = lane / 8, row = 8 * (2 * jj + m / 2) + lane % 8;
      const int chunk = (2 * warp + m % 2) ^ (lane % 8);
      stsm_x4_t(dsb + row * 128 + chunk * 16, da[jj]);
    }
    fence_proxy_async();
    named_barrier(1, 2 * 128);              // both halves of dS written

    // dQ = dS K over the 128 keys, 8 steps of 16 keys: at H 128 this
    // warpgroup's 64 columns, at H 64 every column on alternate tiles
    const bool mine = H == 128 || (i & 1) == wg;
    const int col = H == 128 ? wg : 0;      // K's box of these columns
    if (mine) {
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 8; ++kk)
        wgmma_ss_m64n64<1>(
            qacc, desc_sw128(dsbox(i & 1, kk / 4) + (kk % 4) * 32, 16, 1024),
            desc_sw128(kbox(col) + kk * 16 * 128, kBoxBytes, 1024), kk > 0);
      wgmma_commit();
    }
    wgmma_wait<0>();
    fence_regs(dka);
    fence_regs(dva);
    mbar_arrive(empty + s);                 // Q, dO, L, delta read
    if (mine) {
      // the f32 partial to this warpgroup's buffer, once the bulk
      // reduce that last read it is done: columns 32b .. 32b + 31 as box
      // b, row r's 16-byte chunk c at c ^ (r % 8) (the 128-byte
      // swizzle; r % 8 = lane / 4)
      fence_regs(qacc);
      unsigned char* qb = dqbuf(wg);
      if (tid == 0) bulk_wait_read<0>();
      named_barrier(2 + wg, 128);
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int row = warp * 16 + lane / 4 + 8 * r;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int c = (8 * j) % 32 + 2 * t4;   // column in box j / 4
          *reinterpret_cast<float2*>(
              qb + (j / 4) * kBwdM * 128 + row * 128 +
              (((c / 4) ^ (lane / 4)) * 16) + (c % 4) * 4) =
              make_float2(qacc[4 * j + 2 * r], qacc[4 * j + 2 * r + 1]);
        }
      }
      fence_proxy_async();
      named_barrier(2 + wg, 128);
      if (tid == 0) {                       // dq += the partial, in L2
        tma_reduce_add_3d(&tdq, qb, 64 * col, q0, bn);
        tma_reduce_add_3d(&tdq, qb + kBwdM * 128, 64 * col + 32, q0, bn);
        bulk_commit();
      }
    }
    if (++s == kBwdStages) {
      s = 0;
      ph ^= 1;
    }
  }

  if (tid == 0) bulk_wait<0>();             // the last reduces done
  // dk and dv of this warpgroup's keys below sk (zeros where no q row
  // saw them)
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int key = key0 + 8 * r;
    if (key >= sk) continue;
    const size_t at = ((size_t)bkv * sk + key) * H + 2 * t4;
#pragma unroll
    for (int j = 0; j < H / 8; ++j) {
      *reinterpret_cast<float2*>(dk + at + 8 * j) =
          make_float2(dka[4 * j + 2 * r], dka[4 * j + 2 * r + 1]);
      *reinterpret_cast<float2*>(dv + at + 8 * j) =
          make_float2(dva[4 * j + 2 * r], dva[4 * j + 2 * r + 1]);
    }
  }
}

// ---------------------------------------------------------------------------
// flash_bwd_tf32x3: the whole f32 backward, kernels 6 and 7 in one launch
// (dq, and dk, dv per K/V row), its five products on the tensor cores in
// 3xTF32 (after CUTLASS's OpMultiplyAddFastF32): each f32 operand x is
// split into two TF32 values, big = rna(x) and small = rna(x - big), and
// a product is big·big + big·small + small·big by mma.sync m16n8k8
// (small·small, below 2^-22 of it, is dropped), summed in f32 (mma3:
// dk and dv, long sums, add each step's three products by the FP32
// units). One TF32 product alone misses the plain version's 1e-4 (the
// planted fault kOne); the three stay well inside it.
//
// What bounds it on this card: 10 f32 operations a visible pair and head
// element, 30 TF32 ones as 3xTF32: at the training shape 21.5 GFLOP of
// f32 work, 64.4 GFLOP on the tensor cores (0.130 ms at 495 TFLOP/s,
// 0.321 ms on the FP32 units at 67).
//
// A CTA owns kT3Keys = 128 keys of one K/V row (grid (B·Nkv, key tiles),
// key tile 0, which the most q tiles see, first): it loads K and V once
// and keeps them in shared memory, and at GQA it walks the g q heads of
// its group, so dk and dv are summed in registers and written once per
// K/V row. Eight warps own 16 keys each. The CTA walks the q tiles of BR
// rows (64 at H 64, 32 at H 128, for shared memory) that see its keys,
// Q, dO, L and delta staged by cp.async in a ring of kT3Stages, the
// next tile's copies in flight while this one is computed. For each q
// tile, warp w:
//   Sᵀ = K_w Qᵀ, dPᵀ = V_w dOᵀ   [16 keys, BR q], K_w and V_w the A
//                                 operand, Q and dO the B operand
//   Pᵀ, dSᵀ                       in registers: p = 2^(s·scale·log2e -
//                                 L·log2e), masked only where the tile
//                                 crosses the diagonal or an edge;
//                                 ds = p (dp - delta) scale
//   dV += Pᵀ dO, dK += dSᵀ Q      A from the score accumulators as they
//                                 are: the k index of a step is taken in
//                                 the order q 2t, 2t + 1 of the
//                                 accumulator layout (lane t holds
//                                 columns 2t, 2t + 1; an A fragment
//                                 wants t, t + 4), and B read in the
//                                 same order
//   dSᵀ -> shared memory          [128 keys][BR q]
// then the CTA's eight warps take a [16 q, 32 h] piece each of
//   dQ = dS K                     over the CTA's 128 keys (steps past the
//                                 diagonal or sk skipped), added into dq
//                                 by f32x2 reduce-adds (the wrapper
//                                 zeroes dq; the order of the adds is not
//                                 fixed, so dq is not bitwise repeatable)
// Each product is computed once: 10 operations a visible pair and head
// element. Every shared-memory tile has rows of H + 4 (dSᵀ: BR + 4)
// floats, so the fragment reads, row across lanes g and column across
// lanes t (or, in the reordered k, row 2t across t), are free of bank
// conflicts. A warp whose keys no row of the q tile sees skips its
// products. Keys >= sk and q rows >= sq arrive as zeros and are masked.
// A CTA whose keys no q row sees writes zeros to dk and dv.
// kDrop (a planted fault for chip_smoke.py's check, never on a path):
// the CTAs of key tile 0 add no dq partial.
// ---------------------------------------------------------------------------
constexpr int kT3Keys = 128;     // keys of a CTA
constexpr int kT3Warps = 8;      // 16 keys each
constexpr int kT3Stages = 2;     // Q / dO stages of the ring

// q rows of a tile of the f32 backward at head dim h
__host__ __device__ constexpr int t3_rows(int h) { return h == 64 ? 64 : 32; }

// The f32 backward's shared memory, byte offsets: K [kT3Keys][h + 4] f32
// | V | kT3Stages x (Q [BR][h + 4], dO [BR][h + 4], L [BR], delta [BR]) |
// dSᵀ [kT3Keys][BR + 4]
struct T3Layout {
  int v, stage, stage_bytes, ds, total;
};
__host__ __device__ inline T3Layout t3_layout(int h) {
  const int br = t3_rows(h);
  T3Layout L;
  L.v = kT3Keys * (h + 4) * 4;
  L.stage = 2 * L.v;
  L.stage_bytes = 2 * br * (h + 4) * 4 + 2 * br * 4;
  L.ds = L.stage + kT3Stages * L.stage_bytes;
  L.total = L.ds + kT3Keys * (br + 4) * 4;
  return L;
}

// cp.async of 16 (4) bytes; zeros where !in (nothing is read then)
__device__ __forceinline__ void cp_async16z(float* dst, const float* src,
                                            bool in) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   hopper::smem_u32(dst)),
               "l"(src), "r"(in ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async4z(float* dst, const float* src,
                                           bool in) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   hopper::smem_u32(dst)),
               "l"(src), "r"(in ? 4 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// x rounded to TF32 to nearest, ties away from zero: the value
// cvt.rna.tf32.f32 gives a finite x, by an integer add into the 13 bits
// TF32 drops and a mask (nvcc expands the cvt into a guarded sequence
// about twice as long)
__device__ __forceinline__ uint32_t rna_tf32(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

// An operand fragment as two TF32 values an element: big = rna(x),
// small = rna(x - big) (x - big is exact)
template <int N>
struct Tf32x2 {
  uint32_t big[N], small[N];
  __device__ __forceinline__ void set(int i, float x) {
    big[i] = rna_tf32(x);
    small[i] = rna_tf32(x - __uint_as_float(big[i]));
  }
};

// d = a b + c, m16n8k8, TF32 operands, f32 accumulators
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2],
                                         const float (&c)[4]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%10, %11, %12, %13};\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]),
        "f"(c[0]), "f"(c[1]), "f"(c[2]), "f"(c[3]));
}

// d += a b in 3xTF32: small·big, big·small and big·big, the small ones
// first. The tensor core rounds its sums toward zero: carried in d over
// a long sum (dk and dv over every q row of a K/V row: 4000 at S 1000,
// GQA 8/2) that bias passed the plain version's 1e-4 on an H100, so
// there (kStep) each step's three products are summed from zero and
// added to d by the FP32 units, which round to nearest; the sums of one
// tile (S, dP over H, dQ over 128 keys) stay in the tensor core. kOne:
// big·big alone.
template <bool kOne>
__device__ __forceinline__ void mma3_onto(float (&d)[4], const Tf32x2<4>& a,
                                          const Tf32x2<2>& b,
                                          const float (&c)[4]) {
  if (kOne) {
    mma_tf32(d, a.big, b.big, c);
    return;
  }
  mma_tf32(d, a.small, b.big, c);
  mma_tf32(d, a.big, b.small, d);
  mma_tf32(d, a.big, b.big, d);
}

template <bool kOne, bool kStep>
__device__ __forceinline__ void mma3(float (&d)[4], const Tf32x2<4>& a,
                                     const Tf32x2<2>& b) {
  if constexpr (kStep) {
    const float zero[4] = {0.f, 0.f, 0.f, 0.f};
    float t[4];
    mma3_onto<kOne>(t, a, b, zero);
#pragma unroll
    for (int e = 0; e < 4; ++e) d[e] += t[e];
  } else {
    mma3_onto<kOne>(d, a, b, d);
  }
}

template <int H, bool kOne, bool kDrop>
__global__ void __launch_bounds__(kT3Warps * 32, 1)
flash_bwd_tf32x3(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, const float* __restrict__ dout,
                 const float* __restrict__ lse,
                 const float* __restrict__ delta, float* __restrict__ dq,
                 float* __restrict__ dk, float* __restrict__ dv, int sq,
                 int sk, int g, int d, int causal, float scale) {
  constexpr int BR = t3_rows(H);
  constexpr int LD = H + 4, LDS = BR + 4;
  constexpr int NQ = BR / 8;         // n steps of Sᵀ; k steps of dV, dK
  constexpr int NH = H / 8;          // k steps of Sᵀ; n steps of dV, dK
  constexpr int MT = BR / 16;        // 16-row pieces of dQ
  constexpr int NT = kT3Warps * 32;
  static_assert(MT * NH / 4 == kT3Warps, "dQ: four 8-column steps a warp");
  extern __shared__ float4 smem4[];
  unsigned char* base = reinterpret_cast<unsigned char*>(smem4);
  const T3Layout L = t3_layout(H);
  float* ks = reinterpret_cast<float*>(base);
  float* vs = reinterpret_cast<float*>(base + L.v);
  auto qs = [&](int s) {
    return reinterpret_cast<float*>(base + L.stage + s * L.stage_bytes);
  };
  auto dos = [&](int s) { return qs(s) + BR * LD; };
  auto lrow = [&](int s) { return qs(s) + 2 * BR * LD; };
  auto drow = [&](int s) { return lrow(s) + BR; };
  float* dss = reinterpret_cast<float*>(base + L.ds);

  const int bkv = blockIdx.x, k0 = blockIdx.y * kT3Keys;
  // causal: q tile iq sees key k0 iff k0 <= iq*BR + BR - 1 + d
  const int nq = (sq + BR - 1) / BR;
  const int first = k0 - (BR - 1) - d;
  const int iq0 = causal && first > 0 ? (first + BR - 1) / BR : 0;
  const int ntq = iq0 < nq ? nq - iq0 : 0;  // q tiles of each q head
  const int items = g * ntq;                // (q head, q tile) pairs
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int gr = lane / 4, t4 = lane % 4;
  constexpr int PER_ROW = H / 4;            // 16-byte chunks a row

  // item i (q head bkv·g + i / ntq, q tile iq0 + i % ntq) into stage s:
  // Q and dO rows q0 .. q0 + BR - 1, L and delta, zeros past sq
  auto load_item = [&](int i, int s) {
    const int bn = bkv * g + i / ntq, q0 = (iq0 + i % ntq) * BR;
    const float* qb = q + (size_t)bn * sq * H;
    const float* db = dout + (size_t)bn * sq * H;
    for (int c = tid; c < BR * PER_ROW; c += NT) {
      const int r = c / PER_ROW, col = (c % PER_ROW) * 4;
      const bool in = q0 + r < sq;
      const size_t at = (size_t)(in ? q0 + r : 0) * H + col;
      cp_async16z(qs(s) + r * LD + col, qb + at, in);
      cp_async16z(dos(s) + r * LD + col, db + at, in);
    }
    if (tid < BR) {
      const bool in = q0 + tid < sq;
      const size_t at = (size_t)bn * sq + (in ? q0 + tid : 0);
      cp_async4z(lrow(s) + tid, lse + at, in);
      cp_async4z(drow(s) + tid, delta + at, in);
    }
  };

  const int kw = warp * 16;                 // this warp's keys, in the tile
  const int key0 = k0 + kw + gr;            // this lane's: key0, key0 + 8
  float dka[NH][4], dva[NH][4];
#pragma unroll
  for (int j = 0; j < NH; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) dka[j][e] = dva[j][e] = 0.f;

  if (items > 0) {                          // K, V and the first item
    const float* kb = k + (size_t)bkv * sk * H;
    const float* vb = v + (size_t)bkv * sk * H;
    for (int c = tid; c < kT3Keys * PER_ROW; c += NT) {
      const int r = c / PER_ROW, col = (c % PER_ROW) * 4;
      const bool in = k0 + r < sk;
      const size_t at = (size_t)(in ? k0 + r : 0) * H + col;
      cp_async16z(ks + r * LD + col, kb + at, in);
      cp_async16z(vs + r * LD + col, vb + at, in);
    }
    load_item(0, 0);
  }
  cp_async_commit();
  const float sl2 = scale * kLog2e;
  const int mt = warp % MT, nh0 = (warp / MT) * 4;  // this warp's dQ piece
  for (int i = 0; i < items; ++i) {
    const int s = i % kT3Stages;
    const int bn = bkv * g + i / ntq, q0 = (iq0 + i % ntq) * BR;
    // the next item into the other stage, whose readers passed the last
    // item's barrier; then wait for this one
    if (i + 1 < items) load_item(i + 1, (i + 1) % kT3Stages);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const float* qt = qs(s);
    const float* dt = dos(s);

    float sacc[NQ][4], pacc[NQ][4];
#pragma unroll
    for (int j = 0; j < NQ; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) sacc[j][e] = pacc[j][e] = 0.f;
    // does any row of the tile see a key of this warp?
    const bool live =
        k0 + kw < sk && (!causal || k0 + kw <= q0 + BR - 1 + d);
    if (live) {
      // Sᵀ = K_w Qᵀ and dPᵀ = V_w dOᵀ, H/8 steps of 8 along the head dim
#pragma unroll
      for (int kk = 0; kk < NH; ++kk) {
        Tf32x2<4> ka, va;
        const int c = 8 * kk + t4;
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int at = (kw + gr + 8 * (e & 1)) * LD + c + 4 * (e >> 1);
          ka.set(e, ks[at]);
          va.set(e, vs[at]);
        }
#pragma unroll
        for (int nt = 0; nt < NQ; ++nt) {
          Tf32x2<2> qb, db;
          const int at = (8 * nt + gr) * LD + c;
          qb.set(0, qt[at]);
          qb.set(1, qt[at + 4]);
          db.set(0, dt[at]);
          db.set(1, dt[at + 4]);
          mma3<kOne, false>(sacc[nt], ka, qb);
          mma3<kOne, false>(pacc[nt], va, db);
        }
      }
      // Pᵀ and dSᵀ in f32; the mask only where the tile crosses the
      // diagonal or an edge
      const bool edge = (causal && k0 + kw + 15 > q0 + d) ||
                        q0 + BR > sq || k0 + kw + 16 > sk;
      const float* lr = lrow(s);
      const float* dr = drow(s);
#pragma unroll
      for (int nt = 0; nt < NQ; ++nt) {
        const int c = 8 * nt + 2 * t4;
        const float lb[2] = {lr[c] * kLog2e, lr[c + 1] * kLog2e};
        const float de[2] = {dr[c], dr[c + 1]};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float p = ex2(fmaf(sacc[nt][e], sl2, -lb[e & 1]));
          if (edge) {
            const int kpos = key0 + 8 * (e >> 1), qpos = q0 + c + (e & 1);
            if (kpos >= sk || qpos >= sq || (causal && kpos > qpos + d))
              p = 0.f;
          }
          sacc[nt][e] = p;
          pacc[nt][e] = p * (pacc[nt][e] - de[e & 1]) * scale;
        }
      }
      // dV += Pᵀ dO and dK += dSᵀ Q, BR/8 steps of 8 q rows taken in the
      // accumulators' order: k index t is q row 2t, t + 4 is 2t + 1
#pragma unroll
      for (int kq = 0; kq < NQ; ++kq) {
        Tf32x2<4> pa, da;
#pragma unroll
        for (int e = 0; e < 4; ++e) {       // a0..a3 <- c0, c2, c1, c3
          const int from = (e & 1) * 2 + (e >> 1);
          pa.set(e, sacc[kq][from]);
          da.set(e, pacc[kq][from]);
        }
        const int r = (8 * kq + 2 * t4) * LD + gr;
#pragma unroll
        for (int nh = 0; nh < NH; ++nh) {
          Tf32x2<2> ob, qb;
          ob.set(0, dt[r + 8 * nh]);
          ob.set(1, dt[r + LD + 8 * nh]);
          qb.set(0, qt[r + 8 * nh]);
          qb.set(1, qt[r + LD + 8 * nh]);
          mma3<kOne, true>(dva[nh], pa, ob);
          mma3<kOne, true>(dka[nh], da, qb);
        }
      }
    }
    // dSᵀ (zeros for a warp no row sees) to shared memory
#pragma unroll
    for (int nt = 0; nt < NQ; ++nt) {
      const int c = 8 * nt + 2 * t4;
      *reinterpret_cast<float2*>(dss + (kw + gr) * LDS + c) =
          make_float2(pacc[nt][0], pacc[nt][1]);
      *reinterpret_cast<float2*>(dss + (kw + gr + 8) * LDS + c) =
          make_float2(pacc[nt][2], pacc[nt][3]);
    }
    __syncthreads();

    // dQ = dS K, this warp's rows 16 mt .. + 15 and columns 8 nh0 .. + 31,
    // 8 keys a step in the reordered k (key 2t, 2t + 1), steps whose keys
    // no row of the tile sees skipped
    int steps = min(kT3Keys, sk - k0);
    if (causal) steps = min(steps, q0 + BR + d - k0);
    steps = steps > 0 ? (steps + 7) / 8 : 0;
    float qacc[4][4];
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) qacc[j][e] = 0.f;
    for (int kk = 0; kk < steps; ++kk) {
      Tf32x2<4> sa;
      const int r = (8 * kk + 2 * t4) * LDS + 16 * mt + gr;
      sa.set(0, dss[r]);
      sa.set(1, dss[r + 8]);
      sa.set(2, dss[r + LDS]);
      sa.set(3, dss[r + LDS + 8]);
      const int rk = (8 * kk + 2 * t4) * LD + 8 * nh0 + gr;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        Tf32x2<2> kb;
        kb.set(0, ks[rk + 8 * j]);
        kb.set(1, ks[rk + LD + 8 * j]);
        mma3<kOne, false>(qacc[j], sa, kb);
      }
    }
    if (!(kDrop && blockIdx.y == 0) && steps > 0) {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int row = q0 + 16 * mt + gr + 8 * r;
        if (row >= sq) continue;
        float* at = dq + ((size_t)bn * sq + row) * H + 8 * nh0 + 2 * t4;
#pragma unroll
        for (int j = 0; j < 4; ++j)
          atomicAdd(reinterpret_cast<float2*>(at + 8 * j),
                    make_float2(qacc[j][2 * r], qacc[j][2 * r + 1]));
      }
    }
  }

  // dk and dv of this warp's keys below sk (zeros where no q row saw them)
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int key = key0 + 8 * r;
    if (key >= sk) continue;
    const size_t at = ((size_t)bkv * sk + key) * H + 2 * t4;
#pragma unroll
    for (int j = 0; j < NH; ++j) {
      *reinterpret_cast<float2*>(dk + at + 8 * j) =
          make_float2(dka[j][2 * r], dka[j][2 * r + 1]);
      *reinterpret_cast<float2*>(dv + at + 8 * j) =
          make_float2(dva[j][2 * r], dva[j][2 * r + 1]);
    }
  }
}

// ---------------------------------------------------------------------------
// flash_fwd_tf32x3 (replaces _flash_kernel) and, kChunk, its chunk fold
// (replaces _flash_chunk_kernel): the f32 forward with both products on
// the tensor cores in 3xTF32, by the fragment code of flash_bwd_tf32x3
// (Tf32x2, mma3; mma.sync m16n8k8).
//
// What bounds it on this card: 4 f32 operations a visible pair and head
// element, 12 TF32 ones as 3xTF32 (two products of three terms each): at
// the training shape 8.6 GFLOP of f32 work, 25.8 GFLOP on the tensor
// cores (0.052 ms at 495 TFLOP/s; 0.128 ms on the FP32 units at 67). The
// chunk fold at the ring's shape (q [32, 512, 64]) moves 21 MB, most of
// it the f32 carry in and out: 0.0064 ms of bytes beside 0.0065 ms of
// operations.
//
// A CTA owns kF3Rows = 64 q rows of one row bn of B·N (grid (q tiles,
// B·N), the longest causal rows first), four warps of 16 rows; at H 64
// two CTAs share an SM (100 KB of shared memory each), at H 128 one. Q
// is split once, into a plane of shared memory that holds each lane's
// A fragment of each k step as two 16-byte words (big, then small). K
// and V come in tiles of kF3Keys = 64 keys (the plain version's
// FLASH_BLOCK) by cp.async into a ring of kF3Stages, rows padded by 4
// floats (the fragment reads, row across lanes g and column across
// lanes t, or in P V's reordered k row 2t across t, are then free of
// bank conflicts), the next tile's copies in flight while this one is
// computed: one barrier a tile. For each key tile, warp w:
//   S = Q_w Kᵀ        [16 q, 64 keys]: Q the A operand from the plane,
//                     K's rows the B operand ("col"), each element split
//                     as it is read; each k step's three products summed
//                     from zero in the tensor core and added to S by the
//                     FP32 units (summed over all of H in the tensor
//                     core, S carried the tensor core's rounding toward
//                     zero into every p of a row, and the chunk fold's l
//                     came near the 1e-5 limit at H 128)
//   softmax           f32 in registers: masked only where the tile
//                     crosses the diagonal or the sk edge; the row max
//                     over 4 lanes; p = 2^(s·scale·log2e - m·log2e), one
//                     FFMA and one ex2 a score; corr = e^(m - m_new)
//   O = O·corr + P V  P the A operand straight from S's accumulators:
//                     the k index of a step is taken in the order key 2t,
//                     2t + 1 of the accumulator layout, and V read in the
//                     same order, so P needs no shuffle and no shared
//                     memory; each 8-column piece of P V is summed over
//                     the tile from zero in the tensor core and added to
//                     the rescaled O by one FFMA (the tensor core rounds
//                     its sums toward zero: over every key that bias
//                     would add up, so O is carried by the FP32 units)
// A warp whose rows see no key of the tile skips it. Keys >= sk and q
// rows >= sq arrive as zeros; keys >= sk are masked, rows >= sq never
// stored. The forward starts from (0, -1e30, 0) and writes o = acc / l
// and L = m + log l (both 0 on a row that sees no key); the chunk fold
// reads the carry (cacc, cm, cl) and writes it back unnormalized, and a
// CTA whose rows see no key of the chunk returns at once, its carry
// untouched.
// kOne (a planted fault for chip_smoke.py's check, never on a path):
// big·big alone (1xTF32). kDrop (the same; the chunk fold): key tile 0
// left out.
// ---------------------------------------------------------------------------
constexpr int kF3Rows = 64;      // q rows of a CTA, 16 a warp
constexpr int kF3Keys = 64;      // keys of a K/V tile
constexpr int kF3Warps = kF3Rows / 16;
constexpr int kF3Stages = 2;     // K/V stages of the ring

// The f32 forward's shared memory, byte offsets: the Q plane (kF3Warps x
// h/8 k steps x {big, small} x 32 lanes x 4 floats) | kF3Stages x (K
// [kF3Keys][h + 4] f32, V [kF3Keys][h + 4] f32)
struct F3Layout {
  int stage, stage_bytes, total;
};
__host__ __device__ inline F3Layout f3_layout(int h) {
  F3Layout L;
  L.stage = kF3Rows * h * 2 * 4;
  L.stage_bytes = 2 * kF3Keys * (h + 4) * 4;
  L.total = L.stage + kF3Stages * L.stage_bytes;
  return L;
}

template <int H, bool kChunk, bool kOne, bool kDrop>
__global__ void __launch_bounds__(kF3Warps * 32, 2)
flash_fwd_tf32x3(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, float* __restrict__ o,
                 float* __restrict__ lse, float* __restrict__ cacc,
                 float* __restrict__ cm, float* __restrict__ cl, int sq,
                 int sk, int g, int d, int causal, float scale) {
  constexpr int LD = H + 4;
  constexpr int NH = H / 8;          // k steps of S; n steps of P V
  constexpr int NT = kF3Warps * 32;
  constexpr int PER_ROW = H / 4;     // 16-byte chunks a row
  extern __shared__ float4 smem4[];
  unsigned char* base = reinterpret_cast<unsigned char*>(smem4);
  const F3Layout L = f3_layout(H);
  float* qp = reinterpret_cast<float*>(base);
  auto ks = [&](int s) {
    return reinterpret_cast<float*>(base + L.stage + s * L.stage_bytes);
  };
  auto vs = [&](int s) { return ks(s) + kF3Keys * LD; };

  const int bn = blockIdx.y;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kF3Rows;  // longest first
  int nk = (sk + kF3Keys - 1) / kF3Keys;
  if (causal) {                             // up to the last row's last key
    const int last = q0 + kF3Rows - 1 + d;
    nk = last < 0 ? 0 : min(nk, last / kF3Keys + 1);
  }
  if (kChunk && nk == 0) return;            // the whole CTA: carry kept

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int gr = lane / 4, t4 = lane % 4;
  const float* kb = k + (size_t)(bn / g) * sk * H;
  const float* vb = v + (size_t)(bn / g) * sk * H;
  // key tile i into stage s: rows k0 .. k0 + 63, zeros past sk
  auto load_kv = [&](int i, int s) {
    const int k0 = i * kF3Keys;
    for (int c = tid; c < kF3Keys * PER_ROW; c += NT) {
      const int r = c / PER_ROW, col = (c % PER_ROW) * 4;
      const bool in = k0 + r < sk;
      const size_t at = (size_t)(in ? k0 + r : 0) * H + col;
      cp_async16z(ks(s) + r * LD + col, kb + at, in);
      cp_async16z(vs(s) + r * LD + col, vb + at, in);
    }
  };
  if (nk > 0) load_kv(0, 0);
  cp_async_commit();

  // Q rows q0 .. q0 + 63 (zeros past sq), split once into the plane:
  // element e of lane (g, t)'s A fragment of k step kk, a_e = Q[16w + g
  // + 8 (e & 1)][8kk + t + 4 (e >> 1)], at word e of its big (small)
  // 16-byte word
  const float* qb = q + (size_t)bn * sq * H;
  for (int c = tid; c < kF3Rows * H; c += NT) {
    const int r = c / H, col = c % H;
    const float x = q0 + r < sq ? qb[(size_t)(q0 + r) * H + col] : 0.f;
    const int e = (r % 16) / 8 + 2 * ((col % 8) / 4);
    float* at = qp + ((r / 16) * NH + col / 8) * 256 +
                ((r % 8) * 4 + col % 4) * 4 + e;
    const uint32_t big = rna_tf32(x);
    at[0] = __uint_as_float(big);
    at[128] = __uint_as_float(rna_tf32(x - __uint_as_float(big)));
  }

  const int qw0 = q0 + 16 * warp;           // this warp's rows
  const int row0 = qw0 + gr;                // this lane's: row0, row0 + 8
  float oacc[NH][4], m[2], l[2];
#pragma unroll
  for (int j = 0; j < NH; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) oacc[j][e] = 0.f;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    m[r] = kNegInf;
    l[r] = 0.f;
    const int row = row0 + 8 * r;
    if (kChunk && row < sq) {
      const size_t at = (size_t)bn * sq + row;
      m[r] = cm[at];
      l[r] = cl[at];
#pragma unroll
      for (int j = 0; j < NH; ++j) {
        const float2 a = *reinterpret_cast<const float2*>(
            cacc + at * H + 8 * j + 2 * t4);
        oacc[j][2 * r] = a.x;
        oacc[j][2 * r + 1] = a.y;
      }
    }
  }

  const float sl2 = scale * kLog2e;
  const float* qw = qp + warp * NH * 256 + lane * 4;
  for (int i = 0; i < nk; ++i) {
    const int s = i % kF3Stages, k0 = i * kF3Keys;
    // tile i landed for every thread, the Q plane written, and every
    // warp done with tile i - 1, whose stage the next copies refill
    cp_async_wait<0>();
    __syncthreads();
    if (i + 1 < nk) load_kv(i + 1, (i + 1) % kF3Stages);
    cp_async_commit();
    // no row of this warp sees a key of the tile (warp-uniform)
    if ((kDrop && i == 0) || (causal && k0 > qw0 + 15 + d)) continue;
    const float* kt = ks(s);
    const float* vt = vs(s);

    // S = Q_w Kᵀ, H/8 steps of 8 along the head dim, each step's sum
    // added in f32
    float sacc[8][4];
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) sacc[nt][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < NH; ++kk) {
      Tf32x2<4> qa;
      const float4 hi = *reinterpret_cast<const float4*>(qw + kk * 256);
      const float4 lo = *reinterpret_cast<const float4*>(qw + kk * 256 + 128);
      qa.big[0] = __float_as_uint(hi.x);
      qa.big[1] = __float_as_uint(hi.y);
      qa.big[2] = __float_as_uint(hi.z);
      qa.big[3] = __float_as_uint(hi.w);
      qa.small[0] = __float_as_uint(lo.x);
      qa.small[1] = __float_as_uint(lo.y);
      qa.small[2] = __float_as_uint(lo.z);
      qa.small[3] = __float_as_uint(lo.w);
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        Tf32x2<2> kf;
        const int at = (8 * nt + gr) * LD + 8 * kk + t4;
        kf.set(0, kt[at]);
        kf.set(1, kt[at + 4]);
        mma3<kOne, true>(sacc[nt], qa, kf);
      }
    }

    // the online softmax of the tile, in f32; score (nt, e) is row row0
    // + 8 (e >> 1), key k0 + 8 nt + 2 t + (e & 1)
    if ((causal && k0 + kF3Keys - 1 > qw0 + d) || k0 + kF3Keys > sk) {
#pragma unroll
      for (int nt = 0; nt < 8; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int kpos = k0 + 8 * nt + 2 * t4 + (e & 1);
          const int qpos = row0 + 8 * (e >> 1);
          if (kpos >= sk || (causal && kpos > qpos + d))
            sacc[nt][e] = -INFINITY;
        }
    }
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        mx[e >> 1] = fmaxf(mx[e >> 1], sacc[nt][e]);
    float corr[2], mb[2], psum[2] = {0.f, 0.f};
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float m_new = fmaxf(m[r], quad_max(mx[r]) * scale);
      corr[r] = expf(m[r] - m_new);         // 1 where m did not move
      mb[r] = m_new * kLog2e;
      m[r] = m_new;
    }
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {         // masked lanes: 2^-inf = 0
        const float p = ex2(fmaf(sacc[nt][e], sl2, -mb[e >> 1]));
        sacc[nt][e] = p;
        psum[e >> 1] += p;
      }
#pragma unroll
    for (int r = 0; r < 2; ++r) l[r] = l[r] * corr[r] + quad_sum(psum[r]);

    // O = O·corr + P V: A of step kk from S's accumulators, a0..a3 <- c0,
    // c2, c1, c3 (k index t is key 2t, t + 4 is 2t + 1); each 8-column
    // piece of P V summed over the tile's 8 steps from zero
    Tf32x2<4> pa[8];
#pragma unroll
    for (int kk = 0; kk < 8; ++kk)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        pa[kk].set(e, sacc[kk][(e & 1) * 2 + (e >> 1)]);
#pragma unroll
    for (int nj = 0; nj < NH; ++nj) {
      float t[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int kk = 0; kk < 8; ++kk) {
        Tf32x2<2> vf;
        const int at = (8 * kk + 2 * t4) * LD + 8 * nj + gr;
        vf.set(0, vt[at]);
        vf.set(1, vt[at + LD]);
        mma3_onto<kOne>(t, pa[kk], vf, t);
      }
#pragma unroll
      for (int e = 0; e < 4; ++e)
        oacc[nj][e] = fmaf(oacc[nj][e], corr[e >> 1], t[e]);
    }
  }

  if constexpr (kChunk) {                   // the carry out, unnormalized
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = row0 + 8 * r;
      if (row >= sq) continue;
      const size_t at = (size_t)bn * sq + row;
      if (t4 == 0) {
        cm[at] = m[r];
        cl[at] = l[r];
      }
#pragma unroll
      for (int j = 0; j < NH; ++j)
        *reinterpret_cast<float2*>(cacc + at * H + 8 * j + 2 * t4) =
            make_float2(oacc[j][2 * r], oacc[j][2 * r + 1]);
    }
  } else {                                  // o = acc / l and L
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = row0 + 8 * r;
      if (row >= sq) continue;
      const size_t at = (size_t)bn * sq + row;
      if (t4 == 0) lse[at] = l[r] > 0.f ? m[r] + logf(l[r]) : 0.f;
      // o = acc / l, divided as the reference divides
      const float den = l[r] > 0.f ? l[r] : 1.f;
#pragma unroll
      for (int j = 0; j < NH; ++j)
        *reinterpret_cast<float2*>(o + at * H + 8 * j + 2 * t4) =
            make_float2(oacc[j][2 * r] / den, oacc[j][2 * r + 1] / den);
    }
  }
}

// Let Kernel take up to a CTA's 227 KB of dynamic shared memory, from
// the largest carveout, once a device and instantiation (the attributes
// belong to the current device).
template <auto Kernel>
cudaError_t allow_smem() {
  static bool done[64] = {};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess || (dev < 64 && done[dev])) return e;
  e = cudaFuncSetAttribute(Kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           kMaxSmem);
  // the most shared memory an SM can give, so that CTAs that fit two an
  // SM get two
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(Kernel,
                             cudaFuncAttributePreferredSharedMemoryCarveout,
                             (int)cudaSharedmemCarveoutMaxShared);
  if (e == cudaSuccess && dev < 64) done[dev] = true;
  return e;
}

template <auto Kernel, typename... Args>
int launch(dim3 grid, int threads, int smem, cudaStream_t stream,
           Args... args) {
  cudaError_t e = allow_smem<Kernel>();
  if (e != cudaSuccess) return (int)e;
  Kernel<<<grid, threads, smem, stream>>>(args...);
  return (int)cudaGetLastError();
}

// kErrLayout unless the bf16 forward's plan fits it: block_m 64, or 128
// at H 128 (the only instantiations), `smem` at least the layout's size
// and at most a CTA's
int check_fwd_plan(int h, int block_m, int smem) {
  if (block_m != 64 && !(block_m == 128 && h == 128)) return kErrLayout;
  return smem < fwd_layout(h, block_m).total || smem > kMaxSmem ? kErrLayout
                                                                 : 0;
}

// The bf16 forward (kChunk: the chunk fold) of the wrapper's plan: grid
// (ceil(sq / block_m), bn), tensor maps of q [bn][sq][H] in boxes of
// block_m rows and of k, v [bnkv][sk][H] in boxes of kTileN rows
template <int H, bool kChunk, bool kEarly = false>
int fwd_wgmma(const void* q, const void* k, const void* v, bf16* o,
              float* lse, float* acc, float* m, float* l, int bn, int bnkv,
              int sq, int sk, int d, int causal, float scale, int block_m,
              int smem, cudaStream_t stream) {
  if (int e = check_fwd_plan(H, block_m, smem)) return e;
  CUtensorMap tq, tk, tv;
  if (!hopper::bf16_map_3d(&tq, q, H, sq, bn, block_m) ||
      !hopper::bf16_map_3d(&tk, k, H, sk, bnkv, kTileN) ||
      !hopper::bf16_map_3d(&tv, v, H, sk, bnkv, kTileN))
    return kErrTensorMap;
  const dim3 grid((sq + block_m - 1) / block_m, bn);
  if constexpr (H == 128) {
    if (block_m == 128)
      return launch<flash_fwd_wgmma<H, kChunk, 2, kEarly>>(
          grid, 3 * 128, smem, stream, tq, tk, tv, o, lse, acc, m, l, sq,
          sk, bn / bnkv, d, causal, scale);
  }
  return launch<flash_fwd_wgmma<H, kChunk, 1, kEarly>>(
      grid, 2 * 128, smem, stream, tq, tk, tv, o, lse, acc, m, l, sq, sk,
      bn / bnkv, d, causal, scale);
}

// The f32 forward (kChunk: the chunk fold) of the wrapper's plan, by
// flash_fwd_tf32x3: grid (ceil(sq / kF3Rows), bn). kErrLayout unless
// block_m is kF3Rows and `smem` at least f3_layout's size and at most a
// CTA's. Nothing to launch where sq or bn is 0.
template <int H, bool kChunk, bool kOne = false, bool kDrop = false>
int fwd_tf32x3(const void* q, const void* k, const void* v, float* o,
               float* lse, float* acc, float* m, float* l, int bn, int bnkv,
               int sq, int sk, int d, int causal, float scale, int block_m,
               int smem, cudaStream_t stream) {
  if (block_m != kF3Rows || smem < f3_layout(H).total || smem > kMaxSmem)
    return kErrLayout;
  if (sq == 0 || bn == 0) return 0;
  return launch<flash_fwd_tf32x3<H, kChunk, kOne, kDrop>>(
      dim3((sq + kF3Rows - 1) / kF3Rows, bn), kF3Warps * 32, smem, stream,
      (const float*)q, (const float*)k, (const float*)v, o, lse, acc, m, l,
      sq, sk, bn / bnkv, d, causal, scale);
}

// f32 operands run flash_fwd_tf32x3, bf16 operands flash_fwd_wgmma, each
// by the wrapper's plan (block_m and smem)
template <int H>
int fwd(bool bf, const void* q, const void* k, const void* v, void* o,
        float* lse, int bn, int bnkv, int sq, int sk, int causal,
        float scale, int block_m, int smem, cudaStream_t stream) {
  float* none = nullptr;
  if (bf)
    return fwd_wgmma<H, false>(q, k, v, (bf16*)o, lse, none, none, none, bn,
                               bnkv, sq, sk, sk - sq, causal, scale, block_m,
                               smem, stream);
  return fwd_tf32x3<H, false>(q, k, v, (float*)o, lse, none, none, none, bn,
                              bnkv, sq, sk, sk - sq, causal, scale, block_m,
                              smem, stream);
}

// the chunk fold: the forward's kernels with the carry in and out
template <int H>
int chunk(bool bf, const void* q, const void* k, const void* v, float* acc,
          float* m, float* l, int bn, int bnkv, int sq, int sk, int d,
          int causal, float scale, int block_m, int smem,
          cudaStream_t stream) {
  if (bf)
    return fwd_wgmma<H, true>(q, k, v, nullptr, nullptr, acc, m, l, bn,
                              bnkv, sq, sk, d, causal, scale, block_m, smem,
                              stream);
  return fwd_tf32x3<H, true>(q, k, v, nullptr, nullptr, acc, m, l, bn, bnkv,
                             sq, sk, d, causal, scale, block_m, smem, stream);
}

// The bf16 backward of the wrapper's plan: grid (bnkv, ceil(sk / kTileN)),
// tensor maps of q, do [bn][sq][H] in boxes of 64 rows, of k, v
// [bnkv][sk][H] in boxes of kTileN rows. kErrLayout unless `smem` is at
// least bwd_layout's size and at most a CTA's and sq and sk are not 0.
// dq must be zero: the kernel adds into it.
template <int H>
int bwd_wgmma(const void* q, const void* k, const void* v, const void* dout,
              const float* delta, const float* lse, float* dq, float* dk,
              float* dv, int bn, int bnkv, int sq, int sk, int d, int causal,
              float scale, int smem, cudaStream_t stream) {
  if (smem < bwd_layout(H).total || smem > kMaxSmem || sq == 0 || sk == 0)
    return kErrLayout;
  CUtensorMap tq, tk, tv, tdo, tdq;
  if (!hopper::f32_map_3d(&tdq, dq, H, sq, bn, kBwdM) ||
      !hopper::bf16_map_3d(&tq, q, H, sq, bn, kBwdM) ||
      !hopper::bf16_map_3d(&tdo, dout, H, sq, bn, kBwdM) ||
      !hopper::bf16_map_3d(&tk, k, H, sk, bnkv, kTileN) ||
      !hopper::bf16_map_3d(&tv, v, H, sk, bnkv, kTileN))
    return kErrTensorMap;
  return launch<flash_bwd_wgmma<H>>(
      dim3(bnkv, (sk + kTileN - 1) / kTileN), 3 * 128, smem, stream, tq, tk,
      tv, tdo, tdq, lse, delta, dk, dv, sq, sk, bn / bnkv, d, causal, scale);
}

// The f32 backward (flash_bwd_tf32x3) of the wrapper's plan: grid (bnkv,
// ceil(sk / kT3Keys)). kErrLayout unless `smem` is at least t3_layout's
// size and at most a CTA's and sq and sk are not 0. dq must be zero: the
// kernel adds into it.
template <int H, bool kOne = false, bool kDrop = false>
int bwd_tf32x3(const float* q, const float* k, const float* v,
               const float* dout, const float* delta, const float* lse,
               float* dq, float* dk, float* dv, int bn, int bnkv, int sq,
               int sk, int d, int causal, float scale, int smem,
               cudaStream_t stream) {
  if (smem < t3_layout(H).total || smem > kMaxSmem || sq == 0 || sk == 0)
    return kErrLayout;
  return launch<flash_bwd_tf32x3<H, kOne, kDrop>>(
      dim3(bnkv, (sk + kT3Keys - 1) / kT3Keys), kT3Warps * 32, smem, stream,
      q, k, v, dout, lse, delta, dq, dk, dv, sq, sk, bn / bnkv, d, causal,
      scale);
}

}  // namespace

// One C entry point per (kernel, operand type); the head dim picks the
// instantiation (the wrapper admits 64 and 128 only).
#define HPX_FLASH_BY_HEAD(CALL_64, CALL_128) \
  if (h == 64) return CALL_64;               \
  if (h == 128) return CALL_128;             \
  return (int)cudaErrorInvalidValue;

#define HPX_FLASH_ENTRY(NAME, BF)                                            \
  extern "C" int hpx_flash_fwd_##NAME(                                       \
      const void* q, const void* k, const void* v, void* o, float* lse,      \
      int bn, int bnkv, int sq, int sk, int h, int causal, float scale,      \
      int block_m, int smem, cudaStream_t stream) {                          \
    HPX_FLASH_BY_HEAD(                                                       \
        fwd<64>(BF, q, k, v, o, lse, bn, bnkv, sq, sk, causal, scale,        \
                block_m, smem, stream),                                      \
        fwd<128>(BF, q, k, v, o, lse, bn, bnkv, sq, sk, causal, scale,       \
                 block_m, smem, stream))                                     \
  }                                                                          \
  extern "C" int hpx_flash_chunk_##NAME(                                     \
      const void* q, const void* k, const void* v, float* acc, float* m,     \
      float* l, int bn, int bnkv, int sq, int sk, int h, int d, int causal,  \
      float scale, int block_m, int smem, cudaStream_t stream) {             \
    HPX_FLASH_BY_HEAD(                                                       \
        chunk<64>(BF, q, k, v, acc, m, l, bn, bnkv, sq, sk, d, causal,       \
                  scale, block_m, smem, stream),                             \
        chunk<128>(BF, q, k, v, acc, m, l, bn, bnkv, sq, sk, d, causal,      \
                   scale, block_m, smem, stream))                            \
  }

HPX_FLASH_ENTRY(f32, false)
HPX_FLASH_ENTRY(bf16, true)

// The f32 backward, kernels 6 and 7 in one launch (flash_bwd_tf32x3) by
// the wrapper's plan (smem): dq [bn][sq][H] f32, zeroed by the caller,
// and dk, dv [bnkv][sk][H] f32 per K/V row. _one_term and _drop_tile are
// planted faults for chip_smoke.py's check, never on a path: the kernel
// with the big·big product alone (1xTF32), and with the dq partials of
// key tile 0 left out.
#define HPX_FLASH_BWD_F32(NAME, ONE, DROP)                                    \
  extern "C" int hpx_flash_bwd_##NAME(                                       \
      const float* q, const float* k, const float* v, const float* dout,     \
      const float* delta, const float* lse, float* dq, float* dk, float* dv, \
      int bn, int bnkv, int sq, int sk, int h, int d, int causal,            \
      float scale, int smem, cudaStream_t stream) {                          \
    HPX_FLASH_BY_HEAD(                                                       \
        (bwd_tf32x3<64, ONE, DROP>(q, k, v, dout, delta, lse, dq, dk, dv,    \
                                   bn, bnkv, sq, sk, d, causal, scale, smem, \
                                   stream)),                                 \
        (bwd_tf32x3<128, ONE, DROP>(q, k, v, dout, delta, lse, dq, dk, dv,   \
                                    bn, bnkv, sq, sk, d, causal, scale,      \
                                    smem, stream)))                          \
  }

HPX_FLASH_BWD_F32(f32, false, false)
HPX_FLASH_BWD_F32(f32_one_term, true, false)
HPX_FLASH_BWD_F32(f32_drop_tile, false, true)

// The f32 forward and chunk fold (flash_fwd_tf32x3) built with a planted
// fault, for chip_smoke.py's check, never on a path; the arguments of
// hpx_flash_fwd_f32 and hpx_flash_chunk_f32: _one_term the big·big
// product alone (1xTF32), _drop_tile the chunk fold with key tile 0 left
// out.
extern "C" int hpx_flash_fwd_f32_one_term(
    const void* q, const void* k, const void* v, void* o, float* lse,
    int bn, int bnkv, int sq, int sk, int h, int causal, float scale,
    int block_m, int smem, cudaStream_t stream) {
  HPX_FLASH_BY_HEAD(
      (fwd_tf32x3<64, false, true>(q, k, v, (float*)o, lse, nullptr, nullptr,
                                   nullptr, bn, bnkv, sq, sk, sk - sq,
                                   causal, scale, block_m, smem, stream)),
      (fwd_tf32x3<128, false, true>(q, k, v, (float*)o, lse, nullptr,
                                    nullptr, nullptr, bn, bnkv, sq, sk,
                                    sk - sq, causal, scale, block_m, smem,
                                    stream)))
}

#define HPX_FLASH_CHUNK_F32(NAME, ONE, DROP)                                  \
  extern "C" int hpx_flash_chunk_##NAME(                                     \
      const void* q, const void* k, const void* v, float* acc, float* m,     \
      float* l, int bn, int bnkv, int sq, int sk, int h, int d, int causal,  \
      float scale, int block_m, int smem, cudaStream_t stream) {             \
    HPX_FLASH_BY_HEAD(                                                       \
        (fwd_tf32x3<64, true, ONE, DROP>(q, k, v, nullptr, nullptr, acc, m,  \
                                         l, bn, bnkv, sq, sk, d, causal,     \
                                         scale, block_m, smem, stream)),     \
        (fwd_tf32x3<128, true, ONE, DROP>(q, k, v, nullptr, nullptr, acc, m, \
                                          l, bn, bnkv, sq, sk, d, causal,    \
                                          scale, block_m, smem, stream)))    \
  }

HPX_FLASH_CHUNK_F32(f32_one_term, true, false)
HPX_FLASH_CHUNK_F32(f32_drop_tile, false, true)

// The bf16 backward, kernels 6 and 7 in one launch (flash_bwd_wgmma) by
// the wrapper's plan (smem): dq [bn][sq][H] f32, zeroed by the caller,
// and dk, dv [bnkv][sk][H] f32 per K/V row.
extern "C" int hpx_flash_bwd_bf16(const void* q, const void* k,
                                  const void* v, const void* dout,
                                  const float* delta, const float* lse,
                                  float* dq, float* dk, float* dv, int bn,
                                  int bnkv, int sq, int sk, int h, int d,
                                  int causal, float scale, int smem,
                                  cudaStream_t stream) {
  HPX_FLASH_BY_HEAD(bwd_wgmma<64>(q, k, v, dout, delta, lse, dq, dk, dv, bn,
                                  bnkv, sq, sk, d, causal, scale, smem,
                                  stream),
                    bwd_wgmma<128>(q, k, v, dout, delta, lse, dq, dk, dv, bn,
                                   bnkv, sq, sk, d, causal, scale, smem,
                                   stream))
}

// The bf16 forward's shared-memory bytes at head dim h for a plan's
// block_m (attention_cuda.flash_fwd_smem_bytes mirrors it).
extern "C" long long hpx_flash_fwd_smem_bytes(int h, int block_m) {
  return fwd_layout(h, block_m).total;
}

// The f32 forward's shared-memory bytes at head dim h
// (attention_cuda.flash_fwd_f32_smem_bytes mirrors it).
extern "C" long long hpx_flash_fwd_f32_smem_bytes(int h) {
  return f3_layout(h).total;
}

// The bf16 backward's shared-memory bytes at head dim h
// (attention_cuda.flash_bwd_smem_bytes mirrors it).
extern "C" long long hpx_flash_bwd_smem_bytes(int h) {
  return bwd_layout(h).total;
}

// The f32 backward's shared-memory bytes at head dim h
// (attention_cuda.flash_bwd_f32_smem_bytes mirrors it).
extern "C" long long hpx_flash_bwd_f32_smem_bytes(int h) {
  return t3_layout(h).total;
}

// A planted fault for chip_smoke.py's check, never on a path: the bf16
// forward of the plan's block_m with each stage released once its V has
// landed, before P V, which then reads what the producer refilled the
// stage with.
extern "C" int hpx_flash_fwd_bf16_early_release(
    const void* q, const void* k, const void* v, void* o, float* lse,
    int bn, int bnkv, int sq, int sk, int h, int causal, float scale,
    int block_m, int smem, cudaStream_t stream) {
  HPX_FLASH_BY_HEAD(
      (fwd_wgmma<64, false, true>(q, k, v, (bf16*)o, lse, nullptr, nullptr,
                                  nullptr, bn, bnkv, sq, sk, sk - sq, causal,
                                  scale, block_m, smem, stream)),
      (fwd_wgmma<128, false, true>(q, k, v, (bf16*)o, lse, nullptr, nullptr,
                                   nullptr, bn, bnkv, sq, sk, sk - sq,
                                   causal, scale, block_m, smem, stream)))
}

extern "C" const char* hpx_flash_error_string(int code) {
  if (code == kErrLayout)
    return "the launch plan does not fit the kernel's shared-memory layout";
  if (code == kErrTensorMap)
    return "the driver refused a TMA tensor map (cuTensorMapEncodeTiled)";
  return cudaGetErrorString((cudaError_t)code);
}
