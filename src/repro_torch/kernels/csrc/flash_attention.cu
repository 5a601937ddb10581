// K1: forward attention with online softmax, written by hand for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/flash_attention.py::_kernel
// (launched by flash_attention_hmajor).  It computes the same function:
//   * q [B,H,Sq,hd], k/v [B,K,Skv,hd] (head-major, contiguous), f32 or bf16;
//     output o [B,H,Sq,hd] in q's type;
//   * GQA by index: q head h reads kv head h / (H/K), no replication;
//   * causal, sliding-window (window <= 0 means global) and kv_valid masks
//     fused, masked scores set to the finite -1e30 (not -inf);
//   * fp32 running max, sum and accumulator; denominator clamped at 1e-30;
//   * the reference's tile-skip rule, evaluated on the reference's own tiles
//     (128 x 128, or the sequence rounded up to 8 when shorter), so that a
//     row with no valid key sees exactly what the reference shows it.
//
// Design.  One thread block per (q tile, head, batch); the loop over kv tiles
// runs inside the block, because CUDA blocks run in no order and cannot carry
// the running max/sum/accumulator from one grid step to the next as the TPU
// grid does.  fma and tc process a reference kv tile in sub-tiles of 64 keys,
// wg whole.  The ragged Sq and Skv edges are masked in the kernel instead of
// padded copies: keys past Skv inside the last reference tile count as
// invalid keys (score -1e30, value 0), exactly as the reference's zero
// padding does.
//
// Bound.  At the serve shape (B=4, Sq=Skv=1024, H=16, K=8, hd=128, causal,
// bf16) the work is ~17.2 GFLOP against ~50 MB of q/k/v/o, so on an H100 the
// bound is the bf16 tensor-core rate: 17.2 GFLOP at 989 TFLOP/s = 17.4 us
// (operations), not memory (~15 us); at the prefill_32k cell (B=1, 32,768
// positions) 4.40 TFLOP, 4.45 ms.  Every shape the port runs is bound by
// operations, so what counts is the share of the tensor cores' rate kept.
//
// Three variants, chosen by the caller (kernels/flash_attention.py::k1_variant):
//
// * fma (variant 0): every f32 call, and bf16 at a head dim that is not a
//   multiple of 16.  Products are fp32 FMA on CUDA cores (IEEE products, no
//   TF32, so f32 inputs agree with the plain version to 2e-5), with q/k/v
//   upcast to f32 in shared memory: ~114 KB a block at hd 128, one 4-warp
//   block per SM, 67 TFLOP/s peak at best.
// * tc (variant 1): bf16 at hd % 16 == 0, hd <= 256; the serve path takes it
//   where wg does not (hd 16, 32, 96, 256).  The FlashAttention-2 shape on
//   tensor cores with warp-level mma.sync m16n8k16 (bf16 operands, fp32
//   sums): a block of 4 warps takes 64 query rows, 16 per warp; Q stays in
//   registers as A fragments (from shared memory at hd 256, where registers
//   run out); K and V stream through a two-stage ring of 64-key tiles in
//   shared memory, copied with 16-byte cp.async while the previous tile is
//   multiplied; rows are padded by 16 bytes so that ldmatrix (K) and
//   ldmatrix.trans (V) hit eight distinct bank groups.  S = Q K^T accumulates
//   in fp32 fragments, scale and masks are applied on the fragments, row max
//   and sum are reduced over each quad of lanes with shuffles, and P is
//   rounded to bf16 in registers and fed straight in as the A operand of P V
//   (the one place where rounding differs from the reference, which keeps P
//   in f32; see tests/test_torch_tc_rounding.py).  Shared memory stays
//   bf16: at hd <= 128 one block takes (64 + 4 x 64) rows x (128 + 8) x 2 B
//   = 87 KB, so two blocks (8 warps) fit on an SM; at hd 256, 169 KB and one
//   block.  Query tiles run longest-first so that the causal tail does not
//   idle the card.
//   mma.sync tops out far below the tensor cores' rate on Hopper.
// * wg (variant 2): bf16 at hd 64 and 128, every full-width serve path and
//   cell.  FlashAttention-3's shape: Hopper's warpgroup MMA (wgmma), the only
//   way to the full tensor-core rate, fed by TMA and warp-specialised.  A
//   block of 3 warpgroups takes 128 query rows: a producer warpgroup whose
//   one thread issues the TMA loads (Q once, K and V through a 3-stage ring
//   of 128-key tiles, 128-byte swizzled, full/empty mbarriers) and two
//   consumer warpgroups of 64 rows that multiply from shared memory.  The
//   tiles are the reference's own 128 x 128, so the online softmax runs over
//   whole reference tiles (the one rounding difference from tc, whose
//   sub-tiles are 64 keys).  What keeps the tensor cores busy: S of tile j
//   and P V of tile j - 1 are issued together and tile j's softmax runs while
//   P V is in flight; the two consumers take turns to issue (ping-pong), so
//   one's softmax runs under the other's products; and the softmax's fp32
//   work, which otherwise limits it, is cut to one fma and one ex2 a score
//   on unmasked tiles, the rescale of O skipped where no row's max moved.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

#include <algorithm>

#include "hopper.cuh"
#include "tc_common.cuh"

namespace {

constexpr int kThreads = 128;     // 4 warps
constexpr int kBlockKV = 64;      // keys per sub-tile
constexpr int kRefTile = 128;     // the reference's block_q / block_kv
constexpr float kMaskValue = -1e30f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store_from_f32(float* p, float x) { *p = x; }
__device__ __forceinline__ void store_from_f32(__nv_bfloat16* p, float x) { *p = __float2bfloat16_rn(x); }

template <int HD, int BQ>
constexpr size_t smem_floats() {
  return (size_t)BQ * HD              // Qs [BQ][HD]
       + (size_t)HD * (kBlockKV + 1)  // Kt [HD][kBlockKV+1] (k transposed, padded)
       + (size_t)kBlockKV * HD        // Vs [kBlockKV][HD]
       + (size_t)BQ * kBlockKV        // Ps [BQ][kBlockKV]
       + 2 * (size_t)BQ;              // Cs, Ls [BQ]
}

// Thread layouts.  Scores: thread (ty = tid/16, tx = tid%16) owns rows
// ty + 8i and columns tx + 16j of the BQ x 64 score tile; the 16 threads of
// a row sit in one half-warp and reduce with shuffles.  Output: warp w and
// lane own rows w + 4i and head-dim columns lane + 32j of the BQ x HD
// accumulator, kept in registers.
template <typename T, int HD, int BQ>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o,
                 int H, int K, int Sq, int Skv, int hd, int causal, int window,
                 int kv_valid, float scale, int bq_ref, int bkv_ref, int n_kv_ref) {
  constexpr int RS = BQ / 8;             // score rows per thread
  constexpr int CS = kBlockKV / 16;      // score columns per thread
  constexpr int RO = BQ / 4;             // output rows per thread
  constexpr int DO = HD / 32;            // output columns per thread
  constexpr int KT = kBlockKV + 1;

  extern __shared__ float smem[];
  float* Qs = smem;
  float* Kt = Qs + BQ * HD;
  float* Vs = Kt + HD * KT;
  float* Ps = Vs + kBlockKV * HD;
  float* Cs = Ps + BQ * kBlockKV;
  float* Ls = Cs + BQ;

  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int lane = tid % 32, warp = tid / 32;
  const int q0 = blockIdx.x * BQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / (H / K);
  const T* qp = q + ((int64_t)b * H + h) * Sq * hd;
  const T* kp = k + ((int64_t)b * K + kvh) * Skv * hd;
  const T* vp = v + ((int64_t)b * K + kvh) * Skv * hd;
  T* op = o + ((int64_t)b * H + h) * Sq * hd;

  for (int i = tid; i < BQ * HD; i += kThreads) {
    const int r = i / HD, d = i % HD;
    float x = 0.f;
    if (q0 + r < Sq && d < hd) x = to_f32(qp[(int64_t)(q0 + r) * hd + d]);
    Qs[i] = x;
  }

  float m_run[RS], l_run[RS];
#pragma unroll
  for (int i = 0; i < RS; ++i) { m_run[i] = kMaskValue; l_run[i] = 0.f; }
  float acc[RO][DO];
#pragma unroll
  for (int i = 0; i < RO; ++i)
#pragma unroll
    for (int j = 0; j < DO; ++j) acc[i][j] = 0.f;

  // the reference q tile that holds this block's rows (BQ divides kRefTile)
  const int q_lo = (q0 / bq_ref) * bq_ref;

  for (int jt = 0; jt < n_kv_ref; ++jt) {
    const int k_lo = jt * bkv_ref;
    // the reference's tile-skip rule, uniform over the block
    bool needed = k_lo < kv_valid;
    if (causal) needed = needed && (k_lo <= q_lo + bq_ref - 1);
    if (window > 0) needed = needed && (q_lo - (k_lo + bkv_ref - 1) < window);
    if (!needed) continue;

    for (int c0 = 0; c0 < bkv_ref; c0 += kBlockKV) {
      const int n = min(kBlockKV, bkv_ref - c0);   // keys of this reference tile
      const int kb = k_lo + c0;
      __syncthreads();                             // last sub-tile's readers are done
      for (int i = tid; i < kBlockKV * HD; i += kThreads) {
        const int j = i / HD, d = i % HD;
        const int pos = kb + j;
        float kx = 0.f, vx = 0.f;
        if (j < n && pos < Skv && d < hd) {
          kx = to_f32(kp[(int64_t)pos * hd + d]);
          vx = to_f32(vp[(int64_t)pos * hd + d]);
        }
        Kt[d * KT + j] = kx;
        Vs[j * HD + d] = vx;
      }
      __syncthreads();

      float s[RS][CS];
#pragma unroll
      for (int i = 0; i < RS; ++i)
#pragma unroll
        for (int j = 0; j < CS; ++j) s[i][j] = 0.f;
      for (int d = 0; d < hd; ++d) {
        float qv[RS], kv[CS];
#pragma unroll
        for (int i = 0; i < RS; ++i) qv[i] = Qs[(ty + 8 * i) * HD + d];
#pragma unroll
        for (int j = 0; j < CS; ++j) kv[j] = Kt[d * KT + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < RS; ++i)
#pragma unroll
          for (int j = 0; j < CS; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
      }

#pragma unroll
      for (int i = 0; i < RS; ++i) {
        const int row = ty + 8 * i;
        const int qpos = q0 + row;
        float mx = -INFINITY;
#pragma unroll
        for (int j = 0; j < CS; ++j) {
          const int c = tx + 16 * j;
          const int kpos = kb + c;
          float x;
          if (c >= n) {
            x = -INFINITY;                         // belongs to no reference tile here
          } else {
            x = s[i][j] * scale;
            bool ok = kpos < kv_valid;
            if (causal) ok = ok && (kpos <= qpos);
            if (window > 0) ok = ok && (qpos - kpos < window);
            if (!ok) x = kMaskValue;
          }
          s[i][j] = x;
          mx = fmaxf(mx, x);
        }
#pragma unroll
        for (int off = 8; off > 0; off >>= 1)
          mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
        const float m_new = fmaxf(m_run[i], mx);
        float sum = 0.f;
#pragma unroll
        for (int j = 0; j < CS; ++j) {
          const float p = expf(s[i][j] - m_new);
          Ps[row * kBlockKV + tx + 16 * j] = p;
          sum += p;
        }
#pragma unroll
        for (int off = 8; off > 0; off >>= 1)
          sum += __shfl_xor_sync(0xffffffffu, sum, off);
        const float corr = expf(m_run[i] - m_new);
        l_run[i] = l_run[i] * corr + sum;
        m_run[i] = m_new;
        if (tx == 0) Cs[row] = corr;
      }
      __syncthreads();

#pragma unroll
      for (int i = 0; i < RO; ++i) {
        const float corr = Cs[warp + 4 * i];
#pragma unroll
        for (int j = 0; j < DO; ++j) acc[i][j] *= corr;
      }
      for (int c = 0; c < n; ++c) {
        float vv[DO];
#pragma unroll
        for (int j = 0; j < DO; ++j) vv[j] = Vs[c * HD + lane + 32 * j];
#pragma unroll
        for (int i = 0; i < RO; ++i) {
          const float p = Ps[(warp + 4 * i) * kBlockKV + c];
#pragma unroll
          for (int j = 0; j < DO; ++j) acc[i][j] = fmaf(p, vv[j], acc[i][j]);
        }
      }
    }
  }

  if (tx == 0) {
#pragma unroll
    for (int i = 0; i < RS; ++i) Ls[ty + 8 * i] = l_run[i];
  }
  __syncthreads();
#pragma unroll
  for (int i = 0; i < RO; ++i) {
    const int row = warp + 4 * i;
    const int qpos = q0 + row;
    if (qpos >= Sq) continue;
    const float l = fmaxf(Ls[row], 1e-30f);
#pragma unroll
    for (int j = 0; j < DO; ++j) {
      const int d = lane + 32 * j;
      if (d < hd) store_from_f32(op + (int64_t)qpos * hd + d, acc[i][j] / l);
    }
  }
}

template <typename T, int HD, int BQ>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, int B,
                   int H, int K, int Sq, int Skv, int hd, int causal, int window,
                   int kv_valid, float scale, cudaStream_t stream) {
  static_assert(kRefTile % BQ == 0, "a block's rows must lie in one reference q tile");
  const int bq_ref = std::min(kRefTile, (Sq + 7) / 8 * 8);
  const int bkv_ref = std::min(kRefTile, (Skv + 7) / 8 * 8);
  const int n_kv_ref = (Skv + bkv_ref - 1) / bkv_ref;
  const size_t smem = smem_floats<HD, BQ>() * sizeof(float);
  auto kernel = flash_fwd_kernel<T, HD, BQ>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((Sq + BQ - 1) / BQ, H, B);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), H, K, Sq, Skv, hd, causal, window, kv_valid, scale,
      bq_ref, bkv_ref, n_kv_ref);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const void* q, const void* k, const void* v, void* o, int B,
                     int H, int K, int Sq, int Skv, int hd, int causal, int window,
                     int kv_valid, float scale, cudaStream_t stream) {
  if (hd <= 32)
    return launch<T, 32, 64>(q, k, v, o, B, H, K, Sq, Skv, hd, causal, window, kv_valid, scale, stream);
  if (hd <= 64)
    return launch<T, 64, 64>(q, k, v, o, B, H, K, Sq, Skv, hd, causal, window, kv_valid, scale, stream);
  if (hd <= 128)
    return launch<T, 128, 64>(q, k, v, o, B, H, K, Sq, Skv, hd, causal, window, kv_valid, scale, stream);
  return launch<T, 256, 32>(q, k, v, o, B, H, K, Sq, Skv, hd, causal, window, kv_valid, scale, stream);
}

// ---- tc: bf16 on tensor cores ------------------------------------------------
using bf16 = __nv_bfloat16;
constexpr int kTcThreads = 128;   // 4 warps x 16 query rows
constexpr int kTcBQ = 64;         // query rows per block (== kBlockKV keys per tile)
constexpr int kTcPad = 8;         // bf16 padding per shared row: rows 16 B apart mod 128 B

template <int HDP>
constexpr size_t tc_smem_bytes() {   // Q tile + two stages of K and V tiles
  return (size_t)(kTcBQ + 4 * kBlockKV) * (HDP + kTcPad) * sizeof(bf16);
}

// HDP: the head dim rounded up to 32, 64, 128 or 256; columns past hd are
// zero-filled in shared memory and their k-steps and n-tiles are skipped.
template <int HDP>
__global__ void __launch_bounds__(kTcThreads, HDP <= 128 ? 2 : 1)
flash_fwd_tc_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                    const bf16* __restrict__ v, bf16* __restrict__ o,
                    int H, int K, int Sq, int Skv, int hd, int causal, int window,
                    int kv_valid, float scale, int bq_ref, int bkv_ref, int n_kv_ref) {
  static_assert(kTcBQ == kBlockKV, "one tile loader serves Q, K and V");
  constexpr int RS = HDP + kTcPad;     // shared row stride, elements
  constexpr int CPR = HDP / 8;         // 16-byte chunks per row
  constexpr int KD = HDP / 16;         // k-steps of Q K^T over the head dim
  constexpr int ND = HDP / 8;          // n-tiles of the output over the head dim
  constexpr bool kQRegs = HDP <= 128;  // Q fragments held in registers

  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Qs = reinterpret_cast<bf16*>(smem_raw);   // [64][RS]
  bf16* Ks = Qs + kTcBQ * RS;                     // [2][64][RS]
  bf16* Vs = Ks + 2 * kBlockKV * RS;              // [2][64][RS]

  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int g = lane / 4, t = lane % 4;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kTcBQ;   // longest causal rows first
  const int h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (H / K);
  const bf16* qp = q + ((int64_t)b * H + h) * Sq * hd;
  const bf16* kp = k + ((int64_t)b * K + kvh) * Skv * hd;
  const bf16* vp = v + ((int64_t)b * K + kvh) * Skv * hd;
  bf16* op = o + ((int64_t)b * H + h) * Sq * hd;

  // The reference kv tiles this block's reference q tile needs.  Each of the
  // three conditions bounds k_lo from one side, so they form one interval.
  const int q_lo = (q0 / bq_ref) * bq_ref;
  int jt_lo = n_kv_ref, jt_hi = -1;
  for (int jt = 0; jt < n_kv_ref; ++jt) {
    const int k_lo = jt * bkv_ref;
    bool needed = k_lo < kv_valid;
    if (causal) needed = needed && (k_lo <= q_lo + bq_ref - 1);
    if (window > 0) needed = needed && (q_lo - (k_lo + bkv_ref - 1) < window);
    if (needed) { jt_lo = min(jt_lo, jt); jt_hi = jt; }
  }
  const int subs = (bkv_ref + kBlockKV - 1) / kBlockKV;   // 64-key sub-tiles per reference tile
  const int n_sub = jt_hi >= jt_lo ? (jt_hi - jt_lo + 1) * subs : 0;
  // sub-tile s: its first key, and n, the keys of it inside its reference tile
  auto sub_tile = [&](int s, int& n) {
    const int c0 = (s % subs) * kBlockKV;
    n = min(kBlockKV, bkv_ref - c0);
    return (jt_lo + s / subs) * bkv_ref + c0;
  };
  // 64 rows from position pos0 on; rows at or past `limit` and columns past
  // hd are zero-filled
  auto load_tile = [&](bf16* dst, const bf16* src, int pos0, int limit) {
    for (int i = tid; i < kTcBQ * CPR; i += kTcThreads) {
      const int r = i / CPR, c = i % CPR;
      const bool ok = pos0 + r < limit && c * 8 < hd;
      tc::cp_async16(dst + r * RS + c * 8, ok ? src + (int64_t)(pos0 + r) * hd + c * 8 : src, ok);
    }
  };

  load_tile(Qs, qp, q0, Sq);
  if (n_sub > 0) {
    int n;
    const int kb = sub_tile(0, n);
    load_tile(Ks, kp, kb, Skv);
    load_tile(Vs, vp, kb, Skv);
  }
  tc::cp_async_commit();

  uint32_t qf[kQRegs ? KD : 1][4];
  float oacc[ND][4];
#pragma unroll
  for (int i = 0; i < ND; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) oacc[i][j] = 0.f;
  // this lane's two rows: g and g + 8 of the warp's 16
  const int row[2] = {q0 + warp * 16 + g, q0 + warp * 16 + g + 8};
  float m_run[2] = {kMaskValue, kMaskValue};
  float l_run[2] = {0.f, 0.f};   // this lane's share; summed over the quad at the end
  const bf16* q_frag = Qs + (warp * 16 + (lane & 15)) * RS + (lane >> 4) * 8;

  for (int s = 0; s < n_sub; ++s) {
    const int stage = s & 1;
    if (s + 1 < n_sub) {     // the next tile's copy overlaps this tile's math
      int n1;
      const int kb1 = sub_tile(s + 1, n1);
      load_tile(Ks + (stage ^ 1) * kBlockKV * RS, kp, kb1, Skv);
      load_tile(Vs + (stage ^ 1) * kBlockKV * RS, vp, kb1, Skv);
      tc::cp_async_commit();
      tc::cp_async_wait<1>();
    } else {
      tc::cp_async_wait<0>();
    }
    __syncthreads();
    if constexpr (kQRegs) {
      if (s == 0) {
#pragma unroll
        for (int kk = 0; kk < KD; ++kk)
          if (kk * 16 < hd) tc::ldmatrix_x4(qf[kk], q_frag + kk * 16);
      }
    }
    const bf16* Kt = Ks + stage * kBlockKV * RS;
    const bf16* Vt = Vs + stage * kBlockKV * RS;
    int n;
    const int kb = sub_tile(s, n);

    // S = Q K^T: 16 rows x 64 keys per warp, 8 n-tiles of 8 keys
    float sc[8][4];
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) sc[i][j] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KD; ++kk) {
      if (kk * 16 >= hd) break;
      uint32_t a[4];
      if constexpr (kQRegs) {
#pragma unroll
        for (int j = 0; j < 4; ++j) a[j] = qf[kk][j];
      } else {
        tc::ldmatrix_x4(a, q_frag + kk * 16);
      }
#pragma unroll
      for (int np = 0; np < 4; ++np) {   // keys np*16 .. np*16+15
        uint32_t bk[4];
        tc::ldmatrix_x4(bk, Kt + (np * 16 + (lane >> 4) * 8 + (lane & 7)) * RS + kk * 16 +
                                ((lane >> 3) & 1) * 8);
        tc::mma_bf16(sc[2 * np], a, bk[0], bk[1]);
        tc::mma_bf16(sc[2 * np + 1], a, bk[2], bk[3]);
      }
    }

    // scale and mask on the fragments; no mask where the whole tile is valid
    const bool full = n == kBlockKV && kb + kBlockKV <= kv_valid &&
                      (!causal || kb + kBlockKV - 1 <= q0) &&
                      (window == 0 || q0 + kTcBQ - 1 - kb < window);
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = sc[nt][e] * scale;
        if (!full) {
          const int c = nt * 8 + 2 * t + (e & 1);
          if (c >= n) {
            x = -INFINITY;                       // belongs to no reference tile here
          } else {
            const int kpos = kb + c, qpos = row[e >> 1];
            bool ok = kpos < kv_valid;
            if (causal) ok = ok && (kpos <= qpos);
            if (window > 0) ok = ok && (qpos - kpos < window);
            if (!ok) x = kMaskValue;
          }
        }
        sc[nt][e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
    float corr[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float m_new = fmaxf(m_run[r], mx[r]);
      corr[r] = __expf(m_run[r] - m_new);
      m_run[r] = m_new;
    }
    // P = exp(S - m) in fp32 for the row sums, rounded to bf16 as the A
    // fragments of P V (k-step kk covers the n-tiles 2kk and 2kk + 1)
    uint32_t pf[4][4];
    float ls[2] = {0.f, 0.f};
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      const float p0 = __expf(sc[nt][0] - m_run[0]), p1 = __expf(sc[nt][1] - m_run[0]);
      const float p2 = __expf(sc[nt][2] - m_run[1]), p3 = __expf(sc[nt][3] - m_run[1]);
      ls[0] += p0 + p1;
      ls[1] += p2 + p3;
      pf[nt / 2][(nt & 1) * 2] = tc::pack_bf16(p0, p1);
      pf[nt / 2][(nt & 1) * 2 + 1] = tc::pack_bf16(p2, p3);
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) l_run[r] = l_run[r] * corr[r] + ls[r];
#pragma unroll
    for (int dn = 0; dn < ND; ++dn) {
      oacc[dn][0] *= corr[0];
      oacc[dn][1] *= corr[0];
      oacc[dn][2] *= corr[1];
      oacc[dn][3] *= corr[1];
    }
    // O += P V: V's B fragments through ldmatrix.trans
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
      for (int dp = 0; dp < ND / 2; ++dp) {   // head-dim columns dp*16 .. dp*16+15
        if (dp * 16 >= hd) break;
        uint32_t bv[4];
        tc::ldmatrix_x4_trans(bv, Vt + (kk * 16 + ((lane >> 3) & 1) * 8 + (lane & 7)) * RS +
                                      dp * 16 + (lane >> 4) * 8);
        tc::mma_bf16(oacc[2 * dp], pf[kk], bv[0], bv[1]);
        tc::mma_bf16(oacc[2 * dp + 1], pf[kk], bv[2], bv[3]);
      }
    }
    __syncthreads();   // every warp is done with this stage before it is refilled
  }
  tc::cp_async_wait<0>();

  float l[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float x = l_run[r];
    x += __shfl_xor_sync(0xffffffffu, x, 1);
    x += __shfl_xor_sync(0xffffffffu, x, 2);
    l[r] = fmaxf(x, 1e-30f);
  }
#pragma unroll
  for (int dn = 0; dn < ND; ++dn) {
    const int d = dn * 8 + 2 * t;
    if (d >= hd) continue;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      if (row[r] >= Sq) continue;
      *reinterpret_cast<__nv_bfloat162*>(op + (int64_t)row[r] * hd + d) =
          __floats2bfloat162_rn(oacc[dn][2 * r] / l[r], oacc[dn][2 * r + 1] / l[r]);
    }
  }
}

template <int HDP>
cudaError_t launch_tc(const void* q, const void* k, const void* v, void* o, int B, int H,
                      int K, int Sq, int Skv, int hd, int causal, int window, int kv_valid,
                      float scale, cudaStream_t stream) {
  static_assert(kRefTile % kTcBQ == 0, "a block's rows must lie in one reference q tile");
  const int bq_ref = std::min(kRefTile, (Sq + 7) / 8 * 8);
  const int bkv_ref = std::min(kRefTile, (Skv + 7) / 8 * 8);
  const int n_kv_ref = (Skv + bkv_ref - 1) / bkv_ref;
  const size_t smem = tc_smem_bytes<HDP>();
  auto kernel = flash_fwd_tc_kernel<HDP>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((Sq + kTcBQ - 1) / kTcBQ, H, B);
  kernel<<<grid, kTcThreads, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<bf16*>(o), H, K, Sq, Skv, hd, causal, window, kv_valid, scale, bq_ref,
      bkv_ref, n_kv_ref);
  return cudaGetLastError();
}

cudaError_t dispatch_tc(const void* q, const void* k, const void* v, void* o, int B, int H,
                        int K, int Sq, int Skv, int hd, int causal, int window, int kv_valid,
                        float scale, cudaStream_t stream) {
  if (hd <= 32)
    return launch_tc<32>(q, k, v, o, B, H, K, Sq, Skv, hd, causal, window, kv_valid, scale, stream);
  if (hd <= 64)
    return launch_tc<64>(q, k, v, o, B, H, K, Sq, Skv, hd, causal, window, kv_valid, scale, stream);
  if (hd <= 128)
    return launch_tc<128>(q, k, v, o, B, H, K, Sq, Skv, hd, causal, window, kv_valid, scale, stream);
  return launch_tc<256>(q, k, v, o, B, H, K, Sq, Skv, hd, causal, window, kv_valid, scale, stream);
}

// ---- wg: bf16 on Hopper's warpgroup MMA, fed by TMA, warp-specialised -----
constexpr int kWgBQ = 128;        // query rows per block: two consumer warpgroups of 64
constexpr int kWgBKV = 128;       // keys per tile, the reference's own tile
constexpr int kWgThreads = 384;   // one producer warpgroup, two consumer warpgroups
constexpr int kWgStages = 3;      // K/V ring depth: a tile is held until the next one's P V
constexpr float kLog2e = 1.4426950408889634f;

// Shared memory of the wg kernel at head dim HD, in bytes from a 1024-aligned
// base: Q [128 rows] then the ring's K and V tiles [128 keys] each, every tile
// as HD / 64 swizzled panels of 128 rows x 128 B; then the barriers.  At hd
// 128 that is 32 + 3 x 64 KB, one block per SM.
template <int HD>
struct WgSmem {
  static constexpr int kPanel = 128 * 128;                // one 64-column panel, bytes
  static constexpr int kTile = (HD / 64) * kPanel;        // Q, K or V tile, bytes
  static constexpr int kQ = 0;
  static constexpr int kK = kQ + kTile;
  static constexpr int kV = kK + kWgStages * kTile;
  static constexpr int kBar = kV + kWgStages * kTile;     // full[stages], empty[stages], q
  static constexpr int kBytes = kBar + (2 * kWgStages + 1) * 8;
  static constexpr int kAlloc = kBytes + 1024;            // slack to align the base
};

// The per-warpgroup state of the online softmax: this thread's two rows
// (g and g + 8 of its warp's 16), their running max in log2 units and their
// running sums (this lane's share, summed over the quad at the end).
struct WgRows {
  int row[2];
  float m[2];
  float l[2];
};

// 2^x by the special-function unit (what __expf uses after its multiply by log2 e)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// S = Q K^T for the warpgroup's 64 rows and the 128 keys of one tile: k-steps
// of 16 over the head dim, both operands K-major in shared memory.
template <int HD>
__device__ __forceinline__ void wg_issue_s(float (&sc)[64], uint32_t sQc, uint32_t sKs) {
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk) {
    const uint32_t off = (kk / 4) * WgSmem<HD>::kPanel + (kk % 4) * 32;
    hopper::wgmma_m64n128_ss(sc, hopper::desc_sw128(sQc + off, 16, 1024),
                             hopper::desc_sw128(sKs + off, 16, 1024), kk > 0);
  }
}

// O += P V: 8 k-steps of 16 keys, P in registers, V MN-major in shared memory.
template <int HD>
__device__ __forceinline__ void wg_issue_pv(float (&oacc)[HD / 2], const uint32_t (&pf)[8][4],
                                            uint32_t sVs) {
#pragma unroll
  for (int kk = 0; kk < kWgBKV / 16; ++kk) {
    const uint64_t dv = hopper::desc_sw128(sVs + kk * 16 * 128, WgSmem<HD>::kPanel, 1024);
    if constexpr (HD == 128)
      hopper::wgmma_m64n128_rs_t(oacc, pf[kk], dv);
    else
      hopper::wgmma_m64n64_rs_t(oacc, pf[kk], dv);
  }
}

// Scale and mask the scores of one tile on the accumulator fragments, in log2
// units (x log2 e, so that 2^x gives exp; the masked score -1e30 becomes
// -1e30 log2 e), update the running max and sum, and leave P = exp(S - m) in
// fp32 in place.  Where every key of the tile is valid for all 64 rows
// (`full`) there is no mask, and the scale is folded into the subtraction of
// the max by one fma (the max itself is the same: rounding is monotone).
// Returns the factor that rescales what was accumulated.
__device__ __forceinline__ void wg_softmax(float (&sc)[64], WgRows& st, float (&corr)[2],
                                           bool full, int kb, int t, int bkv_ref, int kv_valid,
                                           int causal, int window, float scale_log2) {
  float mx[2] = {-INFINITY, -INFINITY};
  if (full) {
#pragma unroll
    for (int i = 0; i < 64; ++i) mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], sc[i]);
#pragma unroll
    for (int r = 0; r < 2; ++r) mx[r] *= scale_log2;
  } else {
#pragma unroll
    for (int nt = 0; nt < 16; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = sc[4 * nt + e] * scale_log2;
        const int col = nt * 8 + 2 * t + (e & 1);
        if (col >= bkv_ref) {
          x = -INFINITY;                         // belongs to no reference tile here
        } else {
          const int kpos = kb + col, qpos = st.row[e >> 1];
          bool ok = kpos < kv_valid;
          if (causal) ok = ok && (kpos <= qpos);
          if (window > 0) ok = ok && (qpos - kpos < window);
          if (!ok) x = kMaskValue * kLog2e;
        }
        sc[4 * nt + e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
    const float m_new = fmaxf(st.m[r], mx[r]);
    corr[r] = ex2(st.m[r] - m_new);
    st.m[r] = m_new;
  }
  float ls[2] = {0.f, 0.f};
  const float mul = full ? scale_log2 : 1.f;
#pragma unroll
  for (int i = 0; i < 64; ++i) {
    const int r = (i >> 1) & 1;
    const float p = ex2(fmaf(sc[i], mul, -st.m[r]));
    sc[i] = p;
    ls[r] += p;
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) st.l[r] = st.l[r] * corr[r] + ls[r];
}

// P rounded to bf16 as the A fragments of P V (k-step kk covers the n-tiles
// 2kk and 2kk + 1 of the score accumulator).
__device__ __forceinline__ void wg_pack_p(uint32_t (&pf)[8][4], const float (&sc)[64]) {
#pragma unroll
  for (int nt = 0; nt < 16; ++nt) {
    pf[nt / 2][(nt & 1) * 2] = tc::pack_bf16(sc[4 * nt], sc[4 * nt + 1]);
    pf[nt / 2][(nt & 1) * 2 + 1] = tc::pack_bf16(sc[4 * nt + 2], sc[4 * nt + 3]);
  }
}

// O *= corr row by row; skipped when no row of the warp changed its max
// (a factor of exactly 1), which is most tiles of a long sequence.
template <int N>
__device__ __forceinline__ void wg_rescale(float (&oacc)[N], const float (&corr)[2]) {
  if (__all_sync(0xffffffffu, corr[0] == 1.f && corr[1] == 1.f)) return;
#pragma unroll
  for (int i = 0; i < N / 4; ++i) {
    oacc[4 * i] *= corr[0];
    oacc[4 * i + 1] *= corr[0];
    oacc[4 * i + 2] *= corr[1];
    oacc[4 * i + 3] *= corr[1];
  }
}

// One block per (128-row q tile, head, batch).  Warpgroup 0 is the producer:
// after giving up registers, one thread issues the TMA loads, Q once and K, V
// through a ring of kWgStages 128-key tiles with a full and an empty mbarrier
// per stage.  Warpgroups 1 and 2 each own 64 query rows: S = Q K^T by wgmma
// m64n128k16 from shared memory (both K-major), the scale and masks on the
// accumulator fragments, the online softmax with quad shuffles, then O += P V
// by wgmma m64n{HD}k16 with P rounded to bf16 in registers as the A operand
// and V read MN-major from shared memory.  The products of a tile overlap the
// softmax (FlashAttention-3's intra-warpgroup pipelining): S of tile j and
// P V of tile j - 1 are issued together, and the softmax of tile j runs while
// P V of tile j - 1 is still on the tensor cores; and the two warpgroups
// take turns to issue their products (named barriers 1 and 2, ping-pong), so
// that one's softmax runs under the other's products.  The kv tiles are the
// reference's own (128 keys, or the sequence rounded up to 8 when shorter:
// keys of the loaded 128 past it take -inf), so its tile-skip rule applies
// to them unchanged.  The tensor maps are 3-D ([batch x heads, S, hd]), so
// the rows past a ragged S are zeros from TMA, never the next head's.
template <int HD>
__global__ void __launch_bounds__(kWgThreads, 1)
flash_fwd_wg_kernel(const __grid_constant__ CUtensorMap tm_q,
                    const __grid_constant__ CUtensorMap tm_k,
                    const __grid_constant__ CUtensorMap tm_v, bf16* __restrict__ o, int H,
                    int K, int Sq, int causal, int window, int kv_valid, float scale,
                    int bq_ref, int bkv_ref, int n_kv_ref) {
  using L = WgSmem<HD>;
  constexpr int kPanels = HD / 64;
  extern __shared__ __align__(1024) unsigned char wg_smem[];
  const uint32_t base = (tc::smem_addr(wg_smem) + 1023) & ~1023u;
  const uint32_t sQ = base + L::kQ, sK = base + L::kK, sV = base + L::kV;
  const uint32_t bar = base + L::kBar;
  const uint32_t q_bar = bar + 16 * kWgStages;
  auto full_bar = [&](int s) { return bar + 8 * s; };
  auto empty_bar = [&](int s) { return bar + 8 * (kWgStages + s); };

  const int tid = threadIdx.x;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kWgBQ;   // longest causal rows first
  const int h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (H / K);

  // The reference kv tiles this block's reference q tile needs: one interval,
  // as in the tc kernel.
  const int q_lo = (q0 / bq_ref) * bq_ref;
  int jt_lo = n_kv_ref, jt_hi = -1;
  for (int jt = 0; jt < n_kv_ref; ++jt) {
    const int k_lo = jt * bkv_ref;
    bool needed = k_lo < kv_valid;
    if (causal) needed = needed && (k_lo <= q_lo + bq_ref - 1);
    if (window > 0) needed = needed && (q_lo - (k_lo + bkv_ref - 1) < window);
    if (needed) { jt_lo = min(jt_lo, jt); jt_hi = jt; }
  }
  const int n_tiles = jt_hi >= jt_lo ? jt_hi - jt_lo + 1 : 0;

  if (tid == 0) {
    for (int s = 0; s < kWgStages; ++s) {
      hopper::mbar_init(full_bar(s), 1);
      hopper::mbar_init(empty_bar(s), 2 * 128);   // every consumer thread releases
    }
    hopper::mbar_init(q_bar, 1);
    hopper::mbar_fence_init();
  }
  __syncthreads();

  if (tid < 128) {
    // ---- producer ----
    hopper::reg_dealloc<40>();
    if (tid == 0) {
      hopper::mbar_expect_tx(q_bar, L::kTile);
#pragma unroll
      for (int p = 0; p < kPanels; ++p)
        hopper::tma_load_3d(sQ + p * L::kPanel, &tm_q, q_bar, p * 64, q0, b * H + h);
      for (int it = 0; it < n_tiles; ++it) {
        const int s = it % kWgStages;
        hopper::mbar_wait(empty_bar(s), ((it / kWgStages) & 1) ^ 1);
        hopper::mbar_expect_tx(full_bar(s), 2 * L::kTile);
        const int kb = (jt_lo + it) * bkv_ref;
#pragma unroll
        for (int p = 0; p < kPanels; ++p) {
          hopper::tma_load_3d(sK + s * L::kTile + p * L::kPanel, &tm_k, full_bar(s), p * 64, kb,
                              b * K + kvh);
          hopper::tma_load_3d(sV + s * L::kTile + p * L::kPanel, &tm_v, full_bar(s), p * 64, kb,
                              b * K + kvh);
        }
      }
    }
  } else {
    // ---- consumers ----
    hopper::reg_alloc<232>();
    const int c = tid / 128 - 1;                 // consumer warpgroup: rows 64c .. 64c + 63
    const int warp = (tid % 128) / 32, lane = tid % 32;
    const int t = lane % 4;
    const int row0 = q0 + 64 * c;                // the warpgroup's first row
    const int r_lo = row0 + 16 * warp + lane / 4;
    WgRows st = {{r_lo, r_lo + 8}, {kMaskValue * kLog2e, kMaskValue * kLog2e}, {0.f, 0.f}};
    const float scale_log2 = scale * kLog2e;
    constexpr int kO = HD / 2;                   // accumulator floats of m64n{HD}
    float oacc[kO];
#pragma unroll
    for (int i = 0; i < kO; ++i) oacc[i] = 0.f;
    float sc[64], corr[2];
    uint32_t pf[8][4];
    const uint32_t sQc = sQ + c * 64 * 128;      // the warpgroup's rows of each Q panel
    // no mask on a tile whose 128 keys are all valid for the warpgroup's 64 rows
    auto is_full = [&](int kb) {
      return bkv_ref == kWgBKV && kb + kWgBKV <= kv_valid &&
             (!causal || kb + kWgBKV - 1 <= row0) && (window == 0 || row0 + 63 - kb < window);
    };

    // Ping-pong: warpgroup c issues its products after bar.sync on barrier
    // 1 + c and hands the turn over by bar.arrive on the other's barrier;
    // both issue n_tiles + 1 times, warpgroup 0 first, and warpgroup 1 does
    // not hand over after its last turn, so no arrival is left over.
    const int n_turns = n_tiles + 1;
    int turn = 0;
    auto take_turn = [&]() { hopper::named_sync(1 + c, 256); };
    auto pass_turn = [&]() {
      if (c == 0 || ++turn < n_turns) hopper::named_arrive(2 - c, 256);
    };

    hopper::mbar_wait(q_bar, 0);
    if (n_tiles > 0) {
      if (c == 1) hopper::named_arrive(1, 256);  // warpgroup 0 takes the first turn
      int kb = jt_lo * bkv_ref;
      hopper::mbar_wait(full_bar(0), 0);
      hopper::fence_regs(sc);
      take_turn();
      hopper::wgmma_fence();
      wg_issue_s<HD>(sc, sQc, sK);
      hopper::wgmma_commit();
      pass_turn();
      hopper::wgmma_wait<0>();
      hopper::fence_regs(sc);
      wg_softmax(sc, st, corr, is_full(kb), kb, t, bkv_ref, kv_valid, causal, window,
                 scale_log2);
      wg_pack_p(pf, sc);
      for (int it = 1; it < n_tiles; ++it) {
        const int s = it % kWgStages, prev = (it - 1) % kWgStages;
        kb = (jt_lo + it) * bkv_ref;
        hopper::mbar_wait(full_bar(s), (it / kWgStages) & 1);
        hopper::fence_regs(sc);
        hopper::fence_regs(oacc);
        hopper::fence_regs(pf);
        take_turn();
        hopper::wgmma_fence();
        wg_issue_s<HD>(sc, sQc, sK + s * L::kTile);      // S of this tile
        hopper::wgmma_commit();
        wg_issue_pv<HD>(oacc, pf, sV + prev * L::kTile);  // P V of the one before
        hopper::wgmma_commit();
        pass_turn();
        hopper::wgmma_wait<1>();
        hopper::fence_regs(sc);
        wg_softmax(sc, st, corr, is_full(kb), kb, t, bkv_ref, kv_valid, causal, window,
                   scale_log2);
        hopper::wgmma_wait<0>();
        hopper::fence_regs(oacc);
        hopper::fence_regs(pf);
        hopper::mbar_arrive(empty_bar(prev));             // this thread is done with it
        wg_pack_p(pf, sc);
        wg_rescale(oacc, corr);
      }
      const int last = (n_tiles - 1) % kWgStages;
      hopper::fence_regs(oacc);
      hopper::fence_regs(pf);
      take_turn();
      hopper::wgmma_fence();
      wg_issue_pv<HD>(oacc, pf, sV + last * L::kTile);
      hopper::wgmma_commit();
      pass_turn();
      hopper::wgmma_wait<0>();
      hopper::fence_regs(oacc);
      hopper::fence_regs(pf);
      hopper::mbar_arrive(empty_bar(last));
    }

    float l[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float x = st.l[r];
      x += __shfl_xor_sync(0xffffffffu, x, 1);
      x += __shfl_xor_sync(0xffffffffu, x, 2);
      l[r] = fmaxf(x, 1e-30f);
    }
    bf16* op = o + ((int64_t)b * H + h) * Sq * HD;
#pragma unroll
    for (int i = 0; i < kO / 4; ++i) {
      const int d = i * 8 + 2 * t;
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        if (st.row[r] >= Sq) continue;
        *reinterpret_cast<__nv_bfloat162*>(op + (int64_t)st.row[r] * HD + d) =
            __floats2bfloat162_rn(oacc[4 * i + 2 * r] / l[r], oacc[4 * i + 2 * r + 1] / l[r]);
      }
    }
  }
}

template <int HD>
cudaError_t launch_wg(const void* q, const void* k, const void* v, void* o, int B, int H, int K,
                      int Sq, int Skv, int causal, int window, int kv_valid, float scale,
                      cudaStream_t stream) {
  const int bq_ref = std::min(kRefTile, (Sq + 7) / 8 * 8);
  const int bkv_ref = std::min(kRefTile, (Skv + 7) / 8 * 8);
  const int n_kv_ref = (Skv + bkv_ref - 1) / bkv_ref;
  CUtensorMap tm_q, tm_k, tm_v;
  if (!hopper::bf16_panel_map(&tm_q, q, B * H, Sq, HD, kWgBQ) ||
      !hopper::bf16_panel_map(&tm_k, k, B * K, Skv, HD, kWgBKV) ||
      !hopper::bf16_panel_map(&tm_v, v, B * K, Skv, HD, kWgBKV))
    return cudaErrorInvalidValue;
  auto kernel = flash_fwd_wg_kernel<HD>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         WgSmem<HD>::kAlloc);
  if (err != cudaSuccess) return err;
  const dim3 grid((Sq + kWgBQ - 1) / kWgBQ, H, B);
  kernel<<<grid, kWgThreads, WgSmem<HD>::kAlloc, stream>>>(
      tm_q, tm_k, tm_v, static_cast<bf16*>(o), H, K, Sq, causal, window, kv_valid, scale,
      bq_ref, bkv_ref, n_kv_ref);
  return cudaGetLastError();
}

// Dynamic shared memory of a launch and the blocks of it that fit on an SM.
template <typename Kernel>
cudaError_t occupancy(Kernel kernel, int threads, size_t smem, int* smem_bytes,
                      int* blocks_per_sm) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  *smem_bytes = (int)smem;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks_per_sm, kernel, threads, smem);
}

template <int HDP>
cudaError_t occupancy_tc(int* smem_bytes, int* blocks_per_sm) {
  return occupancy(flash_fwd_tc_kernel<HDP>, kTcThreads, tc_smem_bytes<HDP>(), smem_bytes,
                   blocks_per_sm);
}

template <int HD>
cudaError_t occupancy_wg(int* smem_bytes, int* blocks_per_sm) {
  return occupancy(flash_fwd_wg_kernel<HD>, kWgThreads, WgSmem<HD>::kAlloc, smem_bytes,
                   blocks_per_sm);
}

template <int HD, int BQ>
cudaError_t occupancy_fma(int* smem_bytes, int* blocks_per_sm) {
  return occupancy(flash_fwd_kernel<float, HD, BQ>, kThreads,
                   smem_floats<HD, BQ>() * sizeof(float), smem_bytes, blocks_per_sm);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  variant: 0 = fma (CUDA cores, any
// dtype), 1 = tc (tensor cores: bfloat16 with hd % 16 == 0 only), 2 = wg
// (wgmma and TMA: bfloat16 at hd 64 or 128 with q, k, v 16-byte aligned
// only); a call a variant does not take gives cudaErrorInvalidValue.
// window <= 0 means global.  kv_valid is clamped to Skv.  Returns a
// cudaError_t (0 on success); launches on `stream` and does not synchronise.
extern "C" int repro_flash_attention_fwd(const void* q, const void* k, const void* v,
                                         void* o, int dtype, int variant, int B, int H,
                                         int K, int Sq, int Skv, int hd, int causal,
                                         int window, int kv_valid, float scale,
                                         void* stream) {
  if (B < 1 || H < 1 || K < 1 || H % K != 0 || Sq < 0 || Skv < 1 || hd < 1 ||
      hd > 256 || B > 65535 || H > 65535 || variant < 0 || variant > 2)
    return (int)cudaErrorInvalidValue;
  if (variant == 1 && (dtype != 1 || hd % 16 != 0)) return (int)cudaErrorInvalidValue;
  if (variant == 2 && (dtype != 1 || (hd != 64 && hd != 128) ||
                       ((uintptr_t)q | (uintptr_t)k | (uintptr_t)v) % 16 != 0))
    return (int)cudaErrorInvalidValue;
  if (Sq == 0) return (int)cudaSuccess;
  kv_valid = std::min(kv_valid, Skv);
  window = window > 0 ? window : 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (variant == 2)
    return (int)(hd == 64 ? launch_wg<64>(q, k, v, o, B, H, K, Sq, Skv, causal, window, kv_valid,
                                          scale, s)
                          : launch_wg<128>(q, k, v, o, B, H, K, Sq, Skv, causal, window,
                                           kv_valid, scale, s));
  if (variant == 1)
    return (int)dispatch_tc(q, k, v, o, B, H, K, Sq, Skv, hd, causal, window, kv_valid, scale, s);
  if (dtype == 0)
    return (int)dispatch<float>(q, k, v, o, B, H, K, Sq, Skv, hd, causal, window, kv_valid, scale, s);
  if (dtype == 1)
    return (int)dispatch<__nv_bfloat16>(q, k, v, o, B, H, K, Sq, Skv, hd, causal, window, kv_valid, scale, s);
  return (int)cudaErrorInvalidValue;
}

// The dynamic shared memory of the kernel that a call of `variant` at head
// dim hd launches (bf16 for tc and wg, f32 for fma), and how many of its
// blocks fit on an SM.  Returns a cudaError_t.
extern "C" int repro_flash_attention_occupancy(int variant, int hd, int* smem_bytes,
                                               int* blocks_per_sm) {
  if (hd < 1 || hd > 256 || variant < 0 || variant > 2) return (int)cudaErrorInvalidValue;
  if (variant == 2) {
    if (hd == 64) return (int)occupancy_wg<64>(smem_bytes, blocks_per_sm);
    if (hd == 128) return (int)occupancy_wg<128>(smem_bytes, blocks_per_sm);
    return (int)cudaErrorInvalidValue;
  }
  if (variant == 1) {
    if (hd <= 32) return (int)occupancy_tc<32>(smem_bytes, blocks_per_sm);
    if (hd <= 64) return (int)occupancy_tc<64>(smem_bytes, blocks_per_sm);
    if (hd <= 128) return (int)occupancy_tc<128>(smem_bytes, blocks_per_sm);
    return (int)occupancy_tc<256>(smem_bytes, blocks_per_sm);
  }
  if (hd <= 32) return (int)occupancy_fma<32, 64>(smem_bytes, blocks_per_sm);
  if (hd <= 64) return (int)occupancy_fma<64, 64>(smem_bytes, blocks_per_sm);
  if (hd <= 128) return (int)occupancy_fma<128, 64>(smem_bytes, blocks_per_sm);
  return (int)occupancy_fma<256, 32>(smem_bytes, blocks_per_sm);
}
