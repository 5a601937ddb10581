// K2: the Mamba-2 SSD chunked scan, written by hand for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/ssd_scan.py::_kernel
// (launched by ssd_scan_hmajor).  It computes the same function:
//   * x [B,H,S,P], dt [B,H,S], A [H] f32, B/C [B,G,S,N] (head-major,
//     contiguous); head h reads B/C group h / (H/G);
//   * per chunk of Q rows, with cum the in-chunk prefix sum of dt*A (fp32)
//     and total its last entry:
//       intra-chunk  y  = ((C B^T) .* exp(cum_i - cum_j) .* dt_j, i >= j) @ x
//       inter-chunk  y += exp(cum_i) * (C @ state^T)
//       state update state = exp(total) * state + x^T @ (B .* exp(total - cum_j) dt_j)
//   * the state starts at h0 (or zeros when h0 is null, the Pallas _init)
//     and is emitted after the last chunk in f32; y is stored in x's type.
//
// Design.  CUDA blocks run in no order and cannot carry the [P, N] state from
// one grid step to the next as the TPU grid does.  fma and tc give one thread
// block per (b, h), which walks every chunk of the sequence in order with the
// fp32 state on chip; wg splits the sequence (below).  The kernels use their
// own chunk length Q = 64: at the model's chunk of 256 the fp32 [Q, Q] tile
// alone would be 256 KiB, more than a block's 227 KB.  The result does not depend
// on the chunk length beyond float rounding.  Rows past S are masked in the
// kernel (x, B, C read as 0, dt = 0, which makes them exact no-ops), not
// padded on the host.  exp(cum_i - cum_j) overflows for i < j, so it is
// evaluated only where i >= j.  Products are fp32 FMA on CUDA cores (no
// TF32), so f32 inputs agree with the plain version to ~1e-6.
//
// Bound.  At the serve shape of mamba2-1.3b (B=4, S=1024, H=64, G=1, P=64,
// N=128; x, B, C in bf16, dt in f32) the scan reads and writes ~78.6 MB
// (x and y 33.6 MB each, the f32 state 8.4 MB) against ~13 GFLOP, so on an
// H100 it is bound by memory bytes: 78.6 MB at 3.35 TB/s = 23.5 us, not by
// operations (13.3 us at the bf16 tensor-core rate).
//
// Three variants, chosen by the caller (kernels/ssd_scan.py::k2_variant):
//
// * fma (variant 0): f32 x (and bf16 at a P or N that is not a multiple of
//   8).  fp32 FMA on CUDA cores over f32 tiles in shared memory (133 KB a
//   block at P <= 64), one 8-warp block per SM, so the 256 blocks of the serve
//   shape take two waves and the second leaves half of the card idle.
// * tc (variant 1): bf16 x, B, C (dt bf16 or f32), P and N <= 128 and
//   multiples of 8 (16-byte rows for cp.async).  The four products of a chunk
//   run on tensor cores with mma.sync and fp32 sums: C B^T [Q x N . N x Q]
//   and x^T (B w) [P x Q . Q x N] on bf16 operands (m16n8k16), att x
//   [Q x Q . Q x P] and C state^T [Q x N . N x P] on tf32 operands
//   (m16n8k8).  C, B and x are bf16 already (exact in tf32); B w is rounded
//   to bf16 as an operand, as mamba_ssm's chunked kernels do; the masked
//   tile att and the state are rounded to tf32.  On bf16 att and state
//   operands the serve shape's y was off by 3.0e-2 before it is stored, more
//   than half of the 5e-2 tolerance; tf32 for those two products cuts that
//   (PERF.md; tests/test_torch_kernels_card.py holds y before its rounding
//   to bf16 within the tolerance).  The sums, the carried state, cum,
//   the decays and w stay fp32 (tests/test_torch_tc_rounding.py models
//   this rounding against the reference).  A warp owns 16 rows of the chunk
//   for the y products, so att goes from the C B^T accumulators to the A
//   operand of att x in registers, and 16 rows of P of the fp32 state, which
//   lives in that warp's accumulators for the whole sequence.  C state^T is
//   computed there as state C^T, with the state as the A operand straight
//   from the accumulators, and handed to the warps that own y's rows through
//   shared memory.  The next chunk's x, B and C are
//   prefetched with 16-byte cp.async into a second buffer while the current
//   one is multiplied (dt into registers of the warp that scans it), so a
//   chunk costs two block barriers.  Tiles are bf16 with rows padded by
//   16 bytes (conflict-free ldmatrix): at P <= 64, 105 KB a block, so two
//   4-warp blocks fit on an SM and the 256 blocks of the serve shape run in
//   one wave on 132 SMs.  A block spends ~8.5 us on a chunk (a serial chain of
//   copies, scans, products and two block barriers), and the mamba2
//   prefill_32k cell gives only 64 blocks for 132 SMs: the pace is the
//   design's, not the tensor cores' or memory's.  The serve paths take wg;
//   tc stays for the other bf16 shapes and as wg's before-time.
// * wg (variant 2, repro_ssd_scan_wg_fwd): bf16 x, B, C with P and N in {64,
//   128}, every full-width path (mamba2 and Jamba).  The sequence split: each
//   (b, h) sequence is cut into nseg segments of whole chunks
//   (kernels/ssd_scan.py::k2_segments fills the card's block slots in one
//   wave), in at most three launches on the stream, with no atomics, so the
//   result is the same bit for bit from run to run: (1) one block per (b, h,
//   segment) but the last runs the state update from zero over its segment
//   and writes its state S_s and decay sum T_s = sum dt a; (2) a pass carries
//   the state across segments, h_in[s + 1] = exp(T_s) h_in[s] + S_s (every
//   factor is exp of a non-positive number, so nothing overflows); (3) one
//   block per (b, h, segment) runs the whole chunk recurrence from h_in[s]
//   and writes y, and the last segment the final state.  With one segment
//   only (3) runs, from h0.  The split costs a second read of x and B in (1)
//   and the scratch states [B, H, nseg - 1, P, N] fp32.  Inside a block:
//   Hopper's TMA loads the chunk tiles (3-D maps over [B H, S, P] and [B G,
//   S, N], so the ragged tail reads zeros) into a ring issued by a producer,
//   and one consumer warpgroup per 64 rows of P runs the four products on
//   wgmma with the chunk's 64 rows as its M (ssd_scan_wg_kernel below).
//   Operand precision: wgmma's tf32 form reads only K-major shared operands
//   with no transpose, so x as TMA lands it ([Q, P], P contiguous) cannot be
//   att x's tf32 operand; wg takes the second route instead: att, the state
//   operand of C state^T and x .* w of the state update enter the products
//   as hi + lo bf16 pairs (two bf16 products each, about 16 significant
//   bits, more than tf32's 11), so its operand rounding is far under that of
//   tc (tests/test_torch_tc_rounding.py::k2_wg_model holds it).
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

#include "hopper.cuh"
#include "tc_common.cuh"

namespace {

constexpr int kThreads = 256;   // 16 x 16 threads
constexpr int kQ = 64;          // the kernel's own chunk length
constexpr int kNM = 128;        // largest d_state taken

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store_from_f32(float* p, float x) { *p = x; }
__device__ __forceinline__ void store_from_f32(__nv_bfloat16* p, float x) { *p = __float2bfloat16_rn(x); }

template <int PM>
constexpr size_t smem_floats() {
  return (size_t)kQ * PM                // xs  [Q][PM]
       + 2 * (size_t)kQ * (kNM + 1)     // Bs, Cs [Q][NM+1]
       + (size_t)PM * (kNM + 1)         // St  [PM][NM+1]  the carried state
       + (size_t)kQ * (kQ + 1)          // At  [Q][Q+1]    the masked intra tile
       + 4 * (size_t)kQ;                // dt, cum, exp(cum), w
}

// Thread layout: ty = tid / 16, tx = tid % 16.  A thread owns rows ty + 16a
// and columns tx + 16b of each tile, so the 16 threads of a half-warp read
// 16 consecutive columns (or, through the +1 row padding, 16 distinct banks)
// and the two halves of a warp share them by broadcast.
template <typename T, typename TD, int PM>
__global__ void __launch_bounds__(kThreads)
ssd_scan_kernel(const T* __restrict__ x, const TD* __restrict__ dt,
                const float* __restrict__ A, const T* __restrict__ Bm,
                const T* __restrict__ Cm, const float* __restrict__ h0,
                T* __restrict__ y, float* __restrict__ state,
                int H, int G, int S, int P, int N) {
  constexpr int NS = kNM + 1;
  constexpr int QS = kQ + 1;
  constexpr int RQ = kQ / 16;     // tile rows (or cols) over Q per thread
  constexpr int RP = PM / 16;     // over P
  constexpr int RN = kNM / 16;    // over N

  extern __shared__ float smem[];
  float* xs = smem;
  float* Bs = xs + kQ * PM;
  float* Cs = Bs + kQ * NS;
  float* St = Cs + kQ * NS;
  float* At = St + PM * NS;
  float* dts = At + kQ * QS;
  float* cum = dts + kQ;
  float* ecum = cum + kQ;
  float* wv = ecum + kQ;

  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int h = blockIdx.x, b = blockIdx.y;
  const int g = h / (H / G);
  const float a = A[h];
  const T* xp = x + ((int64_t)b * H + h) * S * P;
  const TD* dtp = dt + ((int64_t)b * H + h) * S;
  const T* bp = Bm + ((int64_t)b * G + g) * S * N;
  const T* cp = Cm + ((int64_t)b * G + g) * S * N;
  T* yp = y + ((int64_t)b * H + h) * S * P;
  float* sp = state + ((int64_t)b * H + h) * P * N;

  // zero the tiles once: entries past P and N are never loaded and stay 0
  for (int i = tid; i < kQ * PM + 2 * kQ * NS; i += kThreads) smem[i] = 0.f;
  for (int i = tid; i < PM * NS; i += kThreads) {
    const int p = i / NS, n = i % NS;
    float v = 0.f;
    if (h0 != nullptr && p < P && n < N) v = h0[((int64_t)b * H + h) * P * N + p * N + n];
    St[i] = v;
  }

  for (int c0 = 0; c0 < S; c0 += kQ) {
    const int rows = min(kQ, S - c0);
    __syncthreads();                 // the last chunk's readers are done
    for (int i = tid; i < kQ * P; i += kThreads) {
      const int r = i / P, p = i % P;
      xs[r * PM + p] = r < rows ? to_f32(xp[(int64_t)(c0 + r) * P + p]) : 0.f;
    }
    for (int i = tid; i < kQ * N; i += kThreads) {
      const int r = i / N, n = i % N;
      float bv = 0.f, cv = 0.f;
      if (r < rows) {
        bv = to_f32(bp[(int64_t)(c0 + r) * N + n]);
        cv = to_f32(cp[(int64_t)(c0 + r) * N + n]);
      }
      Bs[r * NS + n] = bv;
      Cs[r * NS + n] = cv;
    }
    if (tid < 32) {
      // inclusive prefix sum of dt*a in fp32: two rows per lane, then a
      // shuffle scan over the lanes
      const int r0 = 2 * tid, r1 = r0 + 1;
      const float d0 = r0 < rows ? to_f32(dtp[c0 + r0]) : 0.f;
      const float d1 = r1 < rows ? to_f32(dtp[c0 + r1]) : 0.f;
      const float v0 = d0 * a, v1 = d1 * a;
      const float pair = v0 + v1;
      float incl = pair;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const float up = __shfl_up_sync(0xffffffffu, incl, off);
        if (tid >= off) incl += up;
      }
      const float excl = incl - pair;
      dts[r0] = d0;
      dts[r1] = d1;
      cum[r0] = excl + v0;
      cum[r1] = incl;
    }
    __syncthreads();
    const float total = cum[kQ - 1];
    if (tid < kQ) {
      ecum[tid] = expf(cum[tid]);
      wv[tid] = expf(total - cum[tid]) * dts[tid];
    }

    // ---- intra-chunk tile: At[i][j] = (C_i . B_j) exp(cum_i - cum_j) dt_j, i >= j
    {
      float s[RQ][RQ];
#pragma unroll
      for (int i = 0; i < RQ; ++i)
#pragma unroll
        for (int j = 0; j < RQ; ++j) s[i][j] = 0.f;
      for (int n = 0; n < N; ++n) {
        float cv[RQ], bv[RQ];
#pragma unroll
        for (int i = 0; i < RQ; ++i) cv[i] = Cs[(ty + 16 * i) * NS + n];
#pragma unroll
        for (int j = 0; j < RQ; ++j) bv[j] = Bs[(tx + 16 * j) * NS + n];
#pragma unroll
        for (int i = 0; i < RQ; ++i)
#pragma unroll
          for (int j = 0; j < RQ; ++j) s[i][j] = fmaf(cv[i], bv[j], s[i][j]);
      }
#pragma unroll
      for (int i = 0; i < RQ; ++i) {
        const int qi = ty + 16 * i;
#pragma unroll
        for (int j = 0; j < RQ; ++j) {
          const int qj = tx + 16 * j;
          At[qi * QS + qj] = qi >= qj ? s[i][j] * expf(cum[qi] - cum[qj]) * dts[qj] : 0.f;
        }
      }
    }
    __syncthreads();

    // ---- y = At @ x + exp(cum) * (C @ state^T), from the state before this chunk
    {
      float yi[RQ][RP], ys[RQ][RP];
#pragma unroll
      for (int i = 0; i < RQ; ++i)
#pragma unroll
        for (int j = 0; j < RP; ++j) { yi[i][j] = 0.f; ys[i][j] = 0.f; }
      for (int j = 0; j < kQ; ++j) {
        float av[RQ], xv[RP];
#pragma unroll
        for (int i = 0; i < RQ; ++i) av[i] = At[(ty + 16 * i) * QS + j];
#pragma unroll
        for (int k = 0; k < RP; ++k) xv[k] = xs[j * PM + tx + 16 * k];
#pragma unroll
        for (int i = 0; i < RQ; ++i)
#pragma unroll
          for (int k = 0; k < RP; ++k) yi[i][k] = fmaf(av[i], xv[k], yi[i][k]);
      }
      for (int n = 0; n < N; ++n) {
        float cv[RQ], sv[RP];
#pragma unroll
        for (int i = 0; i < RQ; ++i) cv[i] = Cs[(ty + 16 * i) * NS + n];
#pragma unroll
        for (int k = 0; k < RP; ++k) sv[k] = St[(tx + 16 * k) * NS + n];
#pragma unroll
        for (int i = 0; i < RQ; ++i)
#pragma unroll
          for (int k = 0; k < RP; ++k) ys[i][k] = fmaf(cv[i], sv[k], ys[i][k]);
      }
#pragma unroll
      for (int i = 0; i < RQ; ++i) {
        const int qi = ty + 16 * i;
        if (qi >= rows) continue;
        const float e = ecum[qi];
#pragma unroll
        for (int k = 0; k < RP; ++k) {
          const int p = tx + 16 * k;
          if (p < P) store_from_f32(yp + (int64_t)(c0 + qi) * P + p, yi[i][k] + e * ys[i][k]);
        }
      }
    }
    __syncthreads();                 // every reader of the old state is done

    // ---- state = exp(total) * state + x^T @ (B .* w)
    {
      float u[RP][RN];
#pragma unroll
      for (int i = 0; i < RP; ++i)
#pragma unroll
        for (int j = 0; j < RN; ++j) u[i][j] = 0.f;
      for (int j = 0; j < kQ; ++j) {
        const float w = wv[j];
        float xv[RP], bv[RN];
#pragma unroll
        for (int i = 0; i < RP; ++i) xv[i] = xs[j * PM + ty + 16 * i] * w;
#pragma unroll
        for (int k = 0; k < RN; ++k) bv[k] = Bs[j * NS + tx + 16 * k];
#pragma unroll
        for (int i = 0; i < RP; ++i)
#pragma unroll
          for (int k = 0; k < RN; ++k) u[i][k] = fmaf(xv[i], bv[k], u[i][k]);
      }
      const float et = expf(total);
#pragma unroll
      for (int i = 0; i < RP; ++i)
#pragma unroll
        for (int k = 0; k < RN; ++k) {
          float* s = St + (ty + 16 * i) * NS + tx + 16 * k;
          *s = *s * et + u[i][k];
        }
    }
  }

  __syncthreads();
  for (int i = tid; i < P * N; i += kThreads) {
    const int p = i / N, n = i % N;
    sp[i] = St[p * NS + n];
  }
}

template <typename T, typename TD, int PM>
cudaError_t launch(const void* x, const void* dt, const void* A, const void* Bm,
                   const void* Cm, const void* h0, void* y, void* state, int B,
                   int H, int G, int S, int P, int N, cudaStream_t stream) {
  const size_t smem = smem_floats<PM>() * sizeof(float);
  auto kernel = ssd_scan_kernel<T, TD, PM>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(H, B);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const TD*>(dt),
      static_cast<const float*>(A), static_cast<const T*>(Bm),
      static_cast<const T*>(Cm), static_cast<const float*>(h0),
      static_cast<T*>(y), static_cast<float*>(state), H, G, S, P, N);
  return cudaGetLastError();
}

template <typename T, typename TD>
cudaError_t dispatch(const void* x, const void* dt, const void* A, const void* Bm,
                     const void* Cm, const void* h0, void* y, void* state, int B,
                     int H, int G, int S, int P, int N, cudaStream_t stream) {
  if (P <= 64)
    return launch<T, TD, 64>(x, dt, A, Bm, Cm, h0, y, state, B, H, G, S, P, N, stream);
  return launch<T, TD, 128>(x, dt, A, Bm, Cm, h0, y, state, B, H, G, S, P, N, stream);
}

// ---- tc: bf16 on tensor cores ------------------------------------------------
using bf16 = __nv_bfloat16;
constexpr int kTcPad = 8;               // bf16 padding per shared row: rows 16 B apart mod 128 B
constexpr int kTcNS = kNM + kTcPad;     // row stride of B and C

template <int PM>
constexpr size_t tc_smem_bytes() {
  return ((size_t)2 * kQ * (PM + kTcPad)       // xs [2][Q][PM+8]
          + (size_t)4 * kQ * kTcNS             // Bs, Cs [2][Q][NM+8]
          + (size_t)PM * kTcNS) * sizeof(bf16) // Sb [PM][NM+8], which holds Ts
         + (size_t)2 * 4 * kQ * sizeof(float); // dt, cum, exp(cum), w [2][4][Q]
}

__device__ __forceinline__ uint32_t scale_bf16(uint32_t v, float lo, float hi) {
  const float2 f = tc::unpack_bf16(v);
  return tc::pack_bf16(f.x * lo, f.y * hi);
}

__device__ __forceinline__ void store_pair(bf16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}
__device__ __forceinline__ void store_pair(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}

// PM: P rounded up to 64 or 128.  PM / 16 warps: warp w owns state rows
// 16w .. 16w+15, and chunk rows 16 (w % 4) .. +15 with y columns
// 64 (w / 4) .. +63 (at PM = 128 two warps compute the same C B^T rows).
// TY is y's type: bf16 as x, or float, which stores y before it is rounded
// (used to measure the operand rounding apart from the output rounding).
// att x and C state^T take tf32 operands (m16n8k8); C state^T is computed as
// state C^T from the fp32 state in the accumulators, and passed to the warps
// that own y's rows through shared memory (Ts).
template <typename TD, typename TY, int PM>
__global__ void __launch_bounds__(PM / 16 * 32, PM <= 64 ? 2 : 1)
ssd_scan_tc_kernel(const bf16* __restrict__ x, const TD* __restrict__ dt,
                   const float* __restrict__ A, const bf16* __restrict__ Bm,
                   const bf16* __restrict__ Cm, const float* __restrict__ h0,
                   TY* __restrict__ y, float* __restrict__ state,
                   int H, int G, int S, int P, int N) {
  constexpr int NT = PM / 16 * 32;     // threads
  constexpr int XS = PM + kTcPad;
  constexpr int NS = kTcNS;
  constexpr int NNT = kNM / 8;         // n-tiles of the state over N
  constexpr int TS = PM + 4;           // row stride of Ts, floats (conflict-free stores)
  static_assert(kQ * TS * sizeof(float) <= PM * NS * sizeof(bf16), "Ts fits in Sb");

  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* xs = reinterpret_cast<bf16*>(smem_raw);   // [2][Q][XS]
  bf16* Bs = xs + 2 * kQ * XS;                    // [2][Q][NS]
  bf16* Cs = Bs + 2 * kQ * NS;                    // [2][Q][NS]
  bf16* Sb = Cs + 2 * kQ * NS;                    // [PM][NS]
  float* Ts = reinterpret_cast<float*>(Sb);       // [Q][TS], state C^T
  float* fl = reinterpret_cast<float*>(Sb + PM * NS);   // [2][dt, cum, exp(cum), w][Q]

  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int g = lane / 4, t = lane % 4;
  const int h = blockIdx.x, b = blockIdx.y;
  const int gi = h / (H / G);
  const float a = A[h];
  const bf16* xp = x + ((int64_t)b * H + h) * S * P;
  const TD* dtp = dt + ((int64_t)b * H + h) * S;
  const bf16* bp = Bm + ((int64_t)b * G + gi) * S * N;
  const bf16* cp = Cm + ((int64_t)b * G + gi) * S * N;
  TY* yp = y + ((int64_t)b * H + h) * S * P;
  float* sp = state + ((int64_t)b * H + h) * P * N;
  const int P16 = (P + 15) / 16 * 16, N16 = (N + 15) / 16 * 16;
  const int n_chunks = (S + kQ - 1) / kQ;

  // zero every tile once: columns past P and N are never copied and stay 0
  {
    uint4* z = reinterpret_cast<uint4*>(smem_raw);
    constexpr int n16 = (2 * kQ * XS + 4 * kQ * NS + PM * NS) * (int)sizeof(bf16) / 16;
    for (int i = tid; i < n16; i += NT) z[i] = make_uint4(0u, 0u, 0u, 0u);
  }
  // the fp32 state of this warp's rows, in mma accumulator layout
  const int prow[2] = {warp * 16 + g, warp * 16 + g + 8};
  float st[NNT][4];
#pragma unroll
  for (int nt = 0; nt < NNT; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int p = prow[e >> 1], n = nt * 8 + 2 * t + (e & 1);
      st[nt][e] = (h0 != nullptr && p < P && n < N)
                      ? h0[((int64_t)b * H + h) * P * N + (int64_t)p * N + n] : 0.f;
    }
  __syncthreads();   // the zeros land before the copies below

  // chunk c's x, B and C into buffer `stage`; rows past S are zero-filled
  auto load_chunk = [&](int c, int stage) {
    const int c0 = c * kQ, rows = min(kQ, S - c0);
    bf16* xd = xs + stage * kQ * XS;
    bf16* bd = Bs + stage * kQ * NS;
    bf16* cd = Cs + stage * kQ * NS;
    const int xc = P / 8, nc = N / 8;   // 16-byte chunks per row
    for (int i = tid; i < kQ * xc; i += NT) {
      const int r = i / xc, k = i % xc;
      const bool ok = r < rows;
      tc::cp_async16(xd + r * XS + k * 8, ok ? xp + (int64_t)(c0 + r) * P + k * 8 : xp, ok);
    }
    for (int i = tid; i < kQ * nc; i += NT) {
      const int r = i / nc, k = i % nc;
      const bool ok = r < rows;
      const int64_t off = (int64_t)(c0 + r) * N + k * 8;
      tc::cp_async16(bd + r * NS + k * 8, ok ? bp + off : bp, ok);
      tc::cp_async16(cd + r * NS + k * 8, ok ? cp + off : cp, ok);
    }
  };
  // warp 0 scans dt; it holds rows 2 lane and 2 lane + 1 of the next chunk
  float dn0 = 0.f, dn1 = 0.f;
  auto load_dt = [&](int c) {
    const int r0 = c * kQ + 2 * lane;
    dn0 = r0 < S ? to_f32(dtp[r0]) : 0.f;
    dn1 = r0 + 1 < S ? to_f32(dtp[r0 + 1]) : 0.f;
  };
  if (warp == 0) load_dt(0);
  load_chunk(0, 0);
  tc::cp_async_commit();

  const int rb = warp & 3;              // this warp's 16 chunk rows
  const int p_lo = (warp >> 2) * 64;    // and 64 y columns
  const int i_row[2] = {rb * 16 + g, rb * 16 + g + 8};

  for (int c = 0; c < n_chunks; ++c) {
    const int cur = c & 1, c0 = c * kQ, rows = min(kQ, S - c0);
    float* dts = fl + cur * 4 * kQ;
    float* cum = dts + kQ;
    float* ecum = cum + kQ;
    float* wv = ecum + kQ;
    if (warp == 0) {
      // inclusive prefix sum of dt*a in fp32: two rows per lane, then a
      // shuffle scan over the lanes
      const float d0 = dn0, d1 = dn1;
      if (c + 1 < n_chunks) load_dt(c + 1);
      const int r0 = 2 * lane, r1 = r0 + 1;
      const float v0 = d0 * a, v1 = d1 * a;
      const float pair = v0 + v1;
      float incl = pair;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const float up = __shfl_up_sync(0xffffffffu, incl, off);
        if (lane >= off) incl += up;
      }
      const float cum0 = incl - pair + v0, cum1 = incl;
      const float total = __shfl_sync(0xffffffffu, incl, 31);
      dts[r0] = d0;
      dts[r1] = d1;
      cum[r0] = cum0;
      cum[r1] = cum1;
      ecum[r0] = expf(cum0);
      ecum[r1] = expf(cum1);
      wv[r0] = expf(total - cum0) * d0;
      wv[r1] = expf(total - cum1) * d1;
    }
    tc::cp_async_wait<0>();
    __syncthreads();   // chunk c and its scan are visible; chunk c-1 is done everywhere
    if (c + 1 < n_chunks) {   // the next chunk's copy overlaps this chunk's math
      load_chunk(c + 1, cur ^ 1);
      tc::cp_async_commit();
    }
    const bf16* xt = xs + cur * kQ * XS;
    const bf16* Bt = Bs + cur * kQ * NS;
    const bf16* Ct = Cs + cur * kQ * NS;

    {
      // ---- T = state C^T on tf32 operands: this warp's 16 state rows
      // against every chunk row.  A is the fp32 state in the accumulators,
      // with each k-step's columns permuted as for att below (logical k t <->
      // column 2t, t+4 <-> 2t+1); B is C's bf16 rows through ldmatrix, whose
      // pairs hold columns 2t and 2t+1 (exact as tf32).  T goes to Ts[i][p].
      if (warp * 16 < P16) {
        float ta[8][4];
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) ta[i][j] = 0.f;
#pragma unroll
        for (int kk = 0; kk < kNM / 16; ++kk) {
          if (kk * 16 >= N16) break;
          uint32_t sa[2][4];
#pragma unroll
          for (int hh = 0; hh < 2; ++hh) {
            sa[hh][0] = tc::to_tf32(st[2 * kk + hh][0]);
            sa[hh][1] = tc::to_tf32(st[2 * kk + hh][2]);
            sa[hh][2] = tc::to_tf32(st[2 * kk + hh][1]);
            sa[hh][3] = tc::to_tf32(st[2 * kk + hh][3]);
          }
#pragma unroll
          for (int np = 0; np < 4; ++np) {
            uint32_t bb[4];   // C rows 16 np + (0..7 | 8..15), columns 16 kk + (0..7 | 8..15)
            tc::ldmatrix_x4(bb, Ct + (np * 16 + (lane >> 4) * 8 + (lane & 7)) * NS + kk * 16 +
                                    ((lane >> 3) & 1) * 8);
#pragma unroll
            for (int q = 0; q < 4; ++q) {
              const float2 f = tc::unpack_bf16(bb[q]);
              tc::mma_tf32(ta[2 * np + (q >> 1)], sa[q & 1], __float_as_uint(f.x),
                           __float_as_uint(f.y));
            }
          }
        }
#pragma unroll
        for (int it = 0; it < 8; ++it)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            Ts[(it * 8 + 2 * t + (e & 1)) * TS + prow[e >> 1]] = ta[it][e];
      }
    }

    // ---- C B^T (keys up to this warp's last row)
    float cb[8][4], acc[8][4];
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) { cb[i][j] = 0.f; acc[i][j] = 0.f; }
#pragma unroll
    for (int kk = 0; kk < kNM / 16; ++kk) {
      if (kk * 16 >= N16) break;
      uint32_t ac[4];
      tc::ldmatrix_x4(ac, Ct + (rb * 16 + (lane & 15)) * NS + kk * 16 + (lane >> 4) * 8);
#pragma unroll
      for (int np = 0; np < 4; ++np) {
        if (np > rb) break;
        uint32_t bb[4];
        tc::ldmatrix_x4(bb, Bt + (np * 16 + (lane >> 4) * 8 + (lane & 7)) * NS + kk * 16 +
                                ((lane >> 3) & 1) * 8);
        tc::mma_bf16(cb[2 * np], ac, bb[0], bb[1]);
        tc::mma_bf16(cb[2 * np + 1], ac, bb[2], bb[3]);
      }
    }
    // ---- att = (C B^T) .* exp(cum_i - cum_j) .* dt_j for i >= j, as A
    // fragments; exp is evaluated only where i >= j (it overflows above).
    // af[k-step of 8 keys] in tf32, with the keys of a k-step permuted
    // (logical k t <-> key 2t, k t+4 <-> key 2t+1) so that the C fragment is
    // the A fragment as it stands; the B operand below takes the same
    // permutation.
    uint32_t af[8][4];
    {
      const float ci[2] = {cum[i_row[0]], cum[i_row[1]]};
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        float v[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = i_row[e >> 1], j = nt * 8 + 2 * t + (e & 1);
          v[e] = i >= j ? cb[nt][e] * __expf(ci[e >> 1] - cum[j]) * dts[j] : 0.f;
        }
        af[nt][0] = tc::to_tf32(v[0]);
        af[nt][1] = tc::to_tf32(v[2]);
        af[nt][2] = tc::to_tf32(v[1]);
        af[nt][3] = tc::to_tf32(v[3]);
      }
    }
    // ---- y = exp(cum_i) (C state^T) + att x
    __syncthreads();   // Ts is complete
    {
      const float e0 = ecum[i_row[0]], e1 = ecum[i_row[1]];
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        if (p_lo + nt * 8 >= P16) break;
        const int p = p_lo + nt * 8 + 2 * t;
        const float2 r0 = *reinterpret_cast<const float2*>(Ts + i_row[0] * TS + p);
        const float2 r1 = *reinterpret_cast<const float2*>(Ts + i_row[1] * TS + p);
        acc[nt][0] = r0.x;
        acc[nt][1] = r0.y;
        acc[nt][2] = r1.x;
        acc[nt][3] = r1.y;
        acc[nt][0] *= e0;
        acc[nt][1] *= e0;
        acc[nt][2] *= e1;
        acc[nt][3] *= e1;
      }
    }
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      if (kk > rb) break;
#pragma unroll
      for (int dp = 0; dp < 4; ++dp) {
        if (p_lo + dp * 16 >= P16) break;
        uint32_t bx[4];
        tc::ldmatrix_x4_trans(bx, xt + (kk * 16 + ((lane >> 3) & 1) * 8 + (lane & 7)) * XS +
                                      p_lo + dp * 16 + (lane >> 4) * 8);
        // bx[h] (bx[2 + h]) holds x at keys 8h + 2t and 8h + 2t + 1 of this
        // k-step, y columns g (8 + g): b0 and b1 of the permuted k-step
        // 2 kk + h.  bf16 values are exact as tf32.
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const float2 b_lo = tc::unpack_bf16(bx[hh]), b_hi = tc::unpack_bf16(bx[2 + hh]);
          tc::mma_tf32(acc[2 * dp], af[2 * kk + hh], __float_as_uint(b_lo.x),
                       __float_as_uint(b_lo.y));
          tc::mma_tf32(acc[2 * dp + 1], af[2 * kk + hh], __float_as_uint(b_hi.x),
                       __float_as_uint(b_hi.y));
        }
      }
    }
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      const int p = p_lo + nt * 8 + 2 * t;
      if (p >= P) continue;
#pragma unroll
      for (int r = 0; r < 2; ++r)
        if (i_row[r] < rows)
          store_pair(yp + (int64_t)(c0 + i_row[r]) * P + p, acc[nt][2 * r], acc[nt][2 * r + 1]);
    }

    // ---- state = exp(total) * state + x^T (B .* w), B .* w rounded to bf16
    {
      const float et = expf(cum[kQ - 1]);
#pragma unroll
      for (int nt = 0; nt < NNT; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) st[nt][e] *= et;
    }
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      uint32_t ax[4];   // A[p][j] = x[j][p], through ldmatrix.trans
      tc::ldmatrix_x4_trans(ax, xt + (kk * 16 + (lane >> 4) * 8 + (lane & 7)) * XS +
                                    warp * 16 + ((lane >> 3) & 1) * 8);
      const float w0 = wv[kk * 16 + 2 * t], w1 = wv[kk * 16 + 2 * t + 1];
      const float w2 = wv[kk * 16 + 8 + 2 * t], w3 = wv[kk * 16 + 9 + 2 * t];
#pragma unroll
      for (int np = 0; np < NNT / 2; ++np) {
        if (np * 16 >= N16) break;
        uint32_t bb[4];
        tc::ldmatrix_x4_trans(bb, Bt + (kk * 16 + ((lane >> 3) & 1) * 8 + (lane & 7)) * NS +
                                      np * 16 + (lane >> 4) * 8);
        tc::mma_bf16(st[2 * np], ax, scale_bf16(bb[0], w0, w1), scale_bf16(bb[1], w2, w3));
        tc::mma_bf16(st[2 * np + 1], ax, scale_bf16(bb[2], w0, w1), scale_bf16(bb[3], w2, w3));
      }
    }
  }

#pragma unroll
  for (int nt = 0; nt < NNT; ++nt) {
    const int n = nt * 8 + 2 * t;
    if (n >= N) continue;
#pragma unroll
    for (int r = 0; r < 2; ++r)
      if (prow[r] < P)
        *reinterpret_cast<float2*>(sp + (int64_t)prow[r] * N + n) =
            make_float2(st[nt][2 * r], st[nt][2 * r + 1]);
  }
}

template <typename TD, typename TY, int PM>
cudaError_t launch_tc(const void* x, const void* dt, const void* A, const void* Bm,
                      const void* Cm, const void* h0, void* y, void* state, int B, int H,
                      int G, int S, int P, int N, cudaStream_t stream) {
  const size_t smem = tc_smem_bytes<PM>();
  auto kernel = ssd_scan_tc_kernel<TD, TY, PM>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(H, B);
  kernel<<<grid, PM / 16 * 32, smem, stream>>>(
      static_cast<const bf16*>(x), static_cast<const TD*>(dt), static_cast<const float*>(A),
      static_cast<const bf16*>(Bm), static_cast<const bf16*>(Cm),
      static_cast<const float*>(h0), static_cast<TY*>(y), static_cast<float*>(state), H, G,
      S, P, N);
  return cudaGetLastError();
}

template <typename TD, typename TY>
cudaError_t dispatch_tc(const void* x, const void* dt, const void* A, const void* Bm,
                        const void* Cm, const void* h0, void* y, void* state, int B, int H,
                        int G, int S, int P, int N, cudaStream_t stream) {
  if (P <= 64)
    return launch_tc<TD, TY, 64>(x, dt, A, Bm, Cm, h0, y, state, B, H, G, S, P, N, stream);
  return launch_tc<TD, TY, 128>(x, dt, A, Bm, Cm, h0, y, state, B, H, G, S, P, N, stream);
}

// ---- wg: bf16 on Hopper's warpgroup MMA, fed by TMA, split over the sequence --
constexpr int kWgPanel = kQ * 128;   // one 64-column panel of a 64-row bf16 tile, bytes
// The ring of x and B tiles.  C has one buffer of its own, freed as soon as
// C B^T and C state^T are done: a second would leave no room for two blocks
// a SM at P = 64.
constexpr int kWgStages = 2;

// Shared memory of the wg kernel, in bytes from a 1024-aligned base: the ring
// of x and B tiles, C's tile, each consumer warpgroup's bf16 copy of its state
// rows (hi, then lo) and its y tile on the way out, each consumer warp's dt /
// cum / w table of the chunk, then the barriers full[stages], empty[stages],
// full C, empty C.  Every tile is 64 rows by 64-column panels, 128-byte
// swizzled.  OUT is the outputs kernel; without it, the segment-states kernel
// (no C, no state copy, no y).  At P = 64, N = 128 the outputs kernel takes
// 108 KB (two blocks a SM), the states kernel 52 KB.
template <int PM, int NM, bool OUT>
struct WgLayout {
  static constexpr int kWG = PM / 64;                     // consumer warpgroups
  static constexpr int kConsumers = 128 * kWG;
  // the producer: a warpgroup that gives its registers to the consumers
  // (setmaxnreg) in the outputs kernel, one warp in the states kernel
  static constexpr int kThreads = kConsumers + (OUT ? 128 : 32);
  static constexpr int kX = (PM / 64) * kWgPanel;
  static constexpr int kBC = (NM / 64) * kWgPanel;        // a B or C tile; a state copy
  static constexpr int kStage = kX + kBC;
  static constexpr int kC = kWgStages * kStage;
  static constexpr int kSb = kC + (OUT ? kBC : 0);
  static constexpr int kY = kSb + (OUT ? kWG * 2 * kBC : 0);
  static constexpr int kTab = kY + (OUT ? kWG * kWgPanel : 0);
  static constexpr int kBar = kTab + kConsumers / 32 * 3 * kQ * (int)sizeof(float);
  static constexpr int kBytes = kBar + (2 * kWgStages + 2) * 8;
  static constexpr int kAlloc = kBytes + 1024;            // slack to align the base
  static constexpr int kMinBlocks = PM == 64 ? (OUT ? 2 : 3) : 1;
  // the outputs kernel's registers a thread after setmaxnreg: the launch
  // gives 65536 / (threads x blocks) (128 at P = 64, 168 at P = 128); the
  // producer keeps the least setmaxnreg allows, 24, and the consumers share
  // the rest (fewer spill in the chunk loop)
  static constexpr int kProducerRegs = 24;
  static constexpr int kConsumerRegs = PM == 64 ? 232 : 240;
};

// a, b rounded to bf16 (hi) and what that leaves, rounded again (lo): hi + lo
// holds about 16 significant bits, and a product on both is two bf16 products.
__device__ __forceinline__ void split_bf16(float a, float b, uint32_t& hi, uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  const float2 f = __bfloat1622float2(h);
  const __nv_bfloat162 l = __floats2bfloat162_rn(a - f.x, b - f.y);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = *reinterpret_cast<const uint32_t*>(&l);
}

__device__ __forceinline__ float load_dt(const void* dt, int dt_bf16, int64_t i) {
  return dt_bf16 ? __bfloat162float(static_cast<const bf16*>(dt)[i])
                 : static_cast<const float*>(dt)[i];
}

// One block per (head, segment, batch) over the chunks [c_lo, c_hi) of its
// segment, c_lo = seg * nc / nseg.  The last warp(group) is the producer: one thread
// issues the TMA loads of each chunk's x and B tiles into a two-stage ring
// (full and empty mbarriers) and, in the outputs kernel, C into a buffer of
// its own, released as soon as the products that read it are done.  Each
// consumer warpgroup owns 64 rows of P: its fp32 state rows [64, NM] live in
// wgmma accumulators for the whole segment.  Per chunk, every consumer warp
// scans dt * a with shuffles and keeps dt, cum and w = exp(total - cum) dt in
// a table of its own; then
//   outputs:  CB = C B^T (m64n64, K = N, both K-major) and Y = C state^T
//             from the state copy (m64n64 per warpgroup), issued together;
//             att = CB .* exp(cum_i - cum_j) dt_j on i >= j, in registers,
//             while Y runs; Y = exp(cum_i) Y + att x (A att from registers,
//             x MN-major);
//   both:     state = exp(total) state + (x .* w)^T B (m64nN, K = 64; A from
//             registers through ldmatrix.trans of x, B read MN-major), issued
//             under att x;
//   outputs:  y in bf16 into a swizzled tile that TMA stores, and the new
//             state into the copy (between the same two warpgroup barriers).
// (The state update goes after C B^T and C state^T so that no more than
// 160 accumulator and operand registers are in flight at once: more spills
// them, and ptxas then waits on every product.)
// att, the state copy and x .* w enter the products as hi + lo bf16 pairs
// (split_bf16), so the only roundings are fp32 sums: every product runs on
// bf16 operands at the bf16 rate, with the precision of about 16 bits.  The
// states kernel (OUT false) runs only the state update, from zero, and
// writes the segment's state and its decay sum T = sum of dt * a.
template <int PM, int NM, bool OUT>
__global__ void __launch_bounds__(WgLayout<PM, NM, OUT>::kThreads,
                                  WgLayout<PM, NM, OUT>::kMinBlocks)
ssd_scan_wg_kernel(const __grid_constant__ CUtensorMap tm_x,
                   const __grid_constant__ CUtensorMap tm_b,
                   const __grid_constant__ CUtensorMap tm_c,
                   const __grid_constant__ CUtensorMap tm_y, const void* __restrict__ dt,
                   int dt_bf16, const float* __restrict__ A, const float* __restrict__ h0,
                   float* __restrict__ state,
                   float* __restrict__ seg_state, float* __restrict__ seg_decay, int H, int G,
                   int S, int nseg) {
  using L = WgLayout<PM, NM, OUT>;
  constexpr int kNA = NM / 2;    // accumulator floats of the m64n{NM} state
  extern __shared__ __align__(1024) unsigned char wg_smem[];
  const uint32_t raw = tc::smem_addr(wg_smem);
  const uint32_t base = (raw + 1023) & ~1023u;
  unsigned char* gbase = wg_smem + (base - raw);
  const uint32_t bar = base + L::kBar;
  auto full_xb = [&](int s) { return bar + 8 * s; };
  auto empty_xb = [&](int s) { return bar + 8 * (kWgStages + s); };
  const uint32_t full_c = bar + 16 * kWgStages, empty_c = full_c + 8;

  const int tid = threadIdx.x;
  const int h = blockIdx.x, seg = blockIdx.y, b = blockIdx.z;
  const int gi = h / (H / G);
  const int nc = (S + kQ - 1) / kQ;
  const int c_lo = (int)((int64_t)seg * nc / nseg);
  const int n_it = (int)((int64_t)(seg + 1) * nc / nseg) - c_lo;
  const int64_t bh = (int64_t)b * H + h;

  if (tid == 0) {
    for (int s = 0; s < kWgStages; ++s) {
      hopper::mbar_init(full_xb(s), 1);
      hopper::mbar_init(empty_xb(s), L::kConsumers);   // every consumer thread releases
    }
    hopper::mbar_init(full_c, 1);
    hopper::mbar_init(empty_c, L::kConsumers);
    hopper::mbar_fence_init();
  }
  __syncthreads();

  if (tid >= L::kConsumers) {
    // ---- producer ----
    if constexpr (OUT) hopper::reg_dealloc<L::kProducerRegs>();
    if (tid == L::kConsumers) {
      const int bg = b * G + gi;
      for (int it = 0; it < n_it; ++it) {
        const int s = it % kWgStages, row = (c_lo + it) * kQ;
        const uint32_t sx = base + s * L::kStage;
        hopper::mbar_wait(empty_xb(s), ((it / kWgStages) & 1) ^ 1);
        hopper::mbar_expect_tx(full_xb(s), L::kStage);
#pragma unroll
        for (int p = 0; p < PM / 64; ++p)
          hopper::tma_load_3d(sx + p * kWgPanel, &tm_x, full_xb(s), p * 64, row, (int)bh);
#pragma unroll
        for (int p = 0; p < NM / 64; ++p)
          hopper::tma_load_3d(sx + L::kX + p * kWgPanel, &tm_b, full_xb(s), p * 64, row, bg);
        if constexpr (OUT) {
          hopper::mbar_wait(empty_c, (it & 1) ^ 1);
          hopper::mbar_expect_tx(full_c, L::kBC);
#pragma unroll
          for (int p = 0; p < NM / 64; ++p)
            hopper::tma_load_3d(base + L::kC + p * kWgPanel, &tm_c, full_c, p * 64, row, bg);
        }
      }
    }
    return;
  }

  // ---- consumers ----
  if constexpr (OUT) hopper::reg_alloc<L::kConsumerRegs>();
  const int wg = tid / 128, warp = (tid % 128) / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const int prow = 64 * wg + 16 * warp + g;   // this thread's state rows prow, prow + 8
  const int qrow = 16 * warp + g;             // and chunk rows qrow, qrow + 8
  const float a = A[h];
  float* tdt = reinterpret_cast<float*>(gbase + L::kTab) + (tid / 32) * 3 * kQ;
  float* tcum = tdt + kQ;
  float* tw = tcum + kQ;
  const uint32_t sSb = base + L::kSb + wg * 2 * L::kBC;   // this warpgroup's state copy
  unsigned char* gSb = gbase + L::kSb + wg * 2 * L::kBC;
  const uint32_t sY = base + L::kY + wg * kWgPanel;       // and its y tile on the way out
  unsigned char* gY = gbase + L::kY + wg * kWgPanel;
  const bool y_issuer = tid % 128 == 0;                   // the thread that stores it

  // the fp32 state rows in m64n{NM} accumulator layout: from the segment's
  // incoming state (outputs) or zero (states)
  float st[kNA];
  {
    const float* init = nullptr;
    if constexpr (OUT)
      init = seg > 0 ? seg_state + (bh * (nseg - 1) + seg - 1) * PM * NM
                     : (h0 != nullptr ? h0 + bh * PM * NM : nullptr);
#pragma unroll
    for (int i = 0; i < kNA / 4; ++i)
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const float2 v = init != nullptr
            ? *reinterpret_cast<const float2*>(init + (int64_t)(prow + 8 * r) * NM + 8 * i + 2 * t)
            : make_float2(0.f, 0.f);
        st[4 * i + 2 * r] = v.x;
        st[4 * i + 2 * r + 1] = v.y;
      }
  }
  // the state copy that C state^T reads: [hi, lo][N / 64 panels][64 rows][128 B]
  auto write_state_copy = [&]() {
#pragma unroll
    for (int i = 0; i < kNA / 4; ++i)
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int p = 16 * warp + g + 8 * r;
        const int off = (i / 8) * kWgPanel + p * 128 + (((i % 8) ^ (p & 7)) << 4) + 4 * t;
        uint32_t hi, lo;
        split_bf16(st[4 * i + 2 * r], st[4 * i + 2 * r + 1], hi, lo);
        *reinterpret_cast<uint32_t*>(gSb + off) = hi;
        *reinterpret_cast<uint32_t*>(gSb + L::kBC + off) = lo;
      }
  };

  float dn0 = 0.f, dn1 = 0.f;   // dt of rows 2 lane, 2 lane + 1 of the next chunk
  auto fetch_dt = [&](int c) {
    const int r0 = c * kQ + 2 * lane;
    dn0 = r0 < S ? load_dt(dt, dt_bf16, bh * S + r0) : 0.f;
    dn1 = r0 + 1 < S ? load_dt(dt, dt_bf16, bh * S + r0 + 1) : 0.f;
  };
  fetch_dt(c_lo);
  float seg_total = 0.f;
  if constexpr (OUT) {
    write_state_copy();
    hopper::fence_proxy_async();
    hopper::named_sync(1 + wg, 128);
  }

  for (int it = 0; it < n_it; ++it) {
    const int s = it % kWgStages, row0 = (c_lo + it) * kQ;
    // inclusive prefix sum of dt * a in fp32: two rows a lane, then a
    // shuffle scan over the lanes (every warp, into its own table)
    const float d0 = dn0, d1 = dn1;
    if (it + 1 < n_it) fetch_dt(c_lo + it + 1);
    const float v0 = d0 * a, v1 = d1 * a, pair = v0 + v1;
    float incl = pair;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const float up = __shfl_up_sync(0xffffffffu, incl, off);
      if (lane >= off) incl += up;
    }
    const float cum0 = incl - pair + v0, cum1 = incl;
    const float total = __shfl_sync(0xffffffffu, incl, 31);
    seg_total += total;
    __syncwarp();   // the last chunk's readers of the table are done
    *reinterpret_cast<float2*>(tdt + 2 * lane) = make_float2(d0, d1);
    *reinterpret_cast<float2*>(tcum + 2 * lane) = make_float2(cum0, cum1);
    *reinterpret_cast<float2*>(tw + 2 * lane) =
        make_float2(expf(total - cum0) * d0, expf(total - cum1) * d1);
    __syncwarp();

    const uint32_t sX = base + s * L::kStage + wg * kWgPanel;   // this warpgroup's x columns
    const uint32_t sB = base + s * L::kStage + L::kX;
    const uint32_t sC = base + L::kC;
    hopper::mbar_wait(full_xb(s), (it / kWgStages) & 1);

    float yacc[32];
    uint32_t ah[4][4], al[4][4];   // att as hi + lo A fragments of att x
    if constexpr (OUT) {
      hopper::mbar_wait(full_c, it & 1);
      float cb[32];
      hopper::fence_regs(cb);
      hopper::fence_regs(yacc);
      hopper::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < NM / 16; ++kk) {
        const uint32_t off = (kk / 4) * kWgPanel + (kk % 4) * 32;
        hopper::wgmma_m64n64_ss(cb, hopper::desc_sw128(sC + off, 16, 1024),
                                hopper::desc_sw128(sB + off, 16, 1024), kk > 0);
      }
      hopper::wgmma_commit();
#pragma unroll
      for (int hl = 0; hl < 2; ++hl)
#pragma unroll
        for (int kk = 0; kk < NM / 16; ++kk) {
          const uint32_t off = (kk / 4) * kWgPanel + (kk % 4) * 32;
          hopper::wgmma_m64n64_ss(yacc, hopper::desc_sw128(sC + off, 16, 1024),
                                  hopper::desc_sw128(sSb + hl * L::kBC + off, 16, 1024),
                                  hl > 0 || kk > 0);
        }
      hopper::wgmma_commit();

      // att on the C B^T fragments: row i = qrow (+ 8), key j = 8 nt + 2t (+ 1);
      // above the diagonal cum_i - cum_j > 0 and its exp overflows, so the
      // exponent is clamped at 0 there and the entry masked to 0 by its dt,
      // without a branch (a branch an entry diverges the warp 32 times a chunk)
      hopper::wgmma_wait<1>();
      hopper::fence_regs(cb);
      const float ci0 = tcum[qrow], ci1 = tcum[qrow + 8];
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        const int j = 8 * nt + 2 * t;
        const float2 cj = *reinterpret_cast<const float2*>(tcum + j);
        const float2 dj = *reinterpret_cast<const float2*>(tdt + j);
        // dt_j, or 0 above the diagonal: a select, so every lane computes the same
        const float d00 = qrow >= j ? dj.x : 0.f, d01 = qrow >= j + 1 ? dj.y : 0.f;
        const float d10 = qrow + 8 >= j ? dj.x : 0.f, d11 = qrow + 8 >= j + 1 ? dj.y : 0.f;
        const float e0 = cb[4 * nt] * __expf(fminf(ci0 - cj.x, 0.f)) * d00;
        const float e1 = cb[4 * nt + 1] * __expf(fminf(ci0 - cj.y, 0.f)) * d01;
        const float e2 = cb[4 * nt + 2] * __expf(fminf(ci1 - cj.x, 0.f)) * d10;
        const float e3 = cb[4 * nt + 3] * __expf(fminf(ci1 - cj.y, 0.f)) * d11;
        split_bf16(e0, e1, ah[nt / 2][(nt & 1) * 2], al[nt / 2][(nt & 1) * 2]);
        split_bf16(e2, e3, ah[nt / 2][(nt & 1) * 2 + 1], al[nt / 2][(nt & 1) * 2 + 1]);
      }
      hopper::wgmma_wait<0>();
      hopper::fence_regs(yacc);
      hopper::mbar_arrive(empty_c);   // C is read by nothing more in this chunk
      const float e0 = expf(ci0), e1 = expf(ci1);
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        yacc[4 * i] *= e0;
        yacc[4 * i + 1] *= e0;
        yacc[4 * i + 2] *= e1;
        yacc[4 * i + 3] *= e1;
      }
      hopper::fence_regs(yacc);
      hopper::fence_regs(ah);
      hopper::fence_regs(al);
      hopper::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const uint64_t dx = hopper::desc_sw128(sX + kk * 16 * 128, kWgPanel, 1024);
        hopper::wgmma_m64n64_rs_t(yacc, ah[kk], dx);
        hopper::wgmma_m64n64_rs_t(yacc, al[kk], dx);
      }
      hopper::wgmma_commit();
    }

    // (x .* w)^T as the A operand of the state update, k-step kk = rows
    // 16 kk .. 16 kk + 15 of the chunk: ldmatrix.trans gives x at (p g | g + 8,
    // j 2t, 2t + 1 | + 8, + 9), which w_j scales before the split.  It runs
    // under att x (after C B^T and C state^T, so that fewer accumulators are
    // in flight at once).
    uint32_t xh[4][4], xl[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const int j = 16 * kk + ((lane >> 4) & 1) * 8 + (lane & 7);
      const int ch = 2 * warp + ((lane >> 3) & 1);
      uint32_t r[4];
      hopper::ldsm_x4_trans(r, sX + j * 128 + ((ch ^ (j & 7)) << 4));
      const float2 wa = *reinterpret_cast<const float2*>(tw + 16 * kk + 2 * t);
      const float2 wb = *reinterpret_cast<const float2*>(tw + 16 * kk + 8 + 2 * t);
      float2 f = tc::unpack_bf16(r[0]);
      split_bf16(f.x * wa.x, f.y * wa.y, xh[kk][0], xl[kk][0]);
      f = tc::unpack_bf16(r[1]);
      split_bf16(f.x * wa.x, f.y * wa.y, xh[kk][1], xl[kk][1]);
      f = tc::unpack_bf16(r[2]);
      split_bf16(f.x * wb.x, f.y * wb.y, xh[kk][2], xl[kk][2]);
      f = tc::unpack_bf16(r[3]);
      split_bf16(f.x * wb.x, f.y * wb.y, xh[kk][3], xl[kk][3]);
    }
    {
      const float et = expf(total);
#pragma unroll
      for (int i = 0; i < kNA; ++i) st[i] *= et;
    }
    hopper::fence_regs(st);
    hopper::fence_regs(xh);
    hopper::fence_regs(xl);
    hopper::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const uint64_t db = hopper::desc_sw128(sB + kk * 16 * 128, kWgPanel, 1024);
      if constexpr (NM == 128) {
        hopper::wgmma_m64n128_rs_t(st, xh[kk], db);
        hopper::wgmma_m64n128_rs_t(st, xl[kk], db);
      } else {
        hopper::wgmma_m64n64_rs_t(st, xh[kk], db);
        hopper::wgmma_m64n64_rs_t(st, xl[kk], db);
      }
    }
    hopper::wgmma_commit();
    hopper::wgmma_wait<0>();
    hopper::fence_regs(st);
    hopper::fence_regs(xh);
    hopper::fence_regs(xl);
    hopper::mbar_arrive(empty_xb(s));   // this thread is done with the stage's x and B
    if constexpr (OUT) {
      hopper::fence_regs(yacc);
      hopper::fence_regs(ah);
      hopper::fence_regs(al);
      if (y_issuer) hopper::bulk_wait_read();   // the last chunk's y tile has left
      hopper::named_sync(1 + wg, 128);   // and every warp's products that read the copy are done
      // y in bf16 into the swizzled y tile, which TMA stores (rows past S are
      // not written), and the new state into the copy
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int q = qrow + 8 * r;
          *reinterpret_cast<__nv_bfloat162*>(gY + q * 128 + ((i ^ (q & 7)) << 4) + 4 * t) =
              __floats2bfloat162_rn(yacc[4 * i + 2 * r], yacc[4 * i + 2 * r + 1]);
        }
      write_state_copy();
      hopper::fence_proxy_async();
      hopper::named_sync(1 + wg, 128);
      if (y_issuer) {
        hopper::tma_store_3d(&tm_y, sY, 64 * wg, row0, (int)bh);
        hopper::bulk_commit();
      }
    }
  }
  if constexpr (OUT) {
    if (y_issuer) hopper::bulk_wait();
  }

  float* out;
  if constexpr (OUT) {
    if (seg != nseg - 1) return;
    out = state + bh * PM * NM;
  } else {
    out = seg_state + (bh * (nseg - 1) + seg) * PM * NM;
    if (tid == 0) seg_decay[bh * (nseg - 1) + seg] = seg_total;
  }
#pragma unroll
  for (int i = 0; i < kNA / 4; ++i)
#pragma unroll
    for (int r = 0; r < 2; ++r)
      *reinterpret_cast<float2*>(out + (int64_t)(prow + 8 * r) * NM + 8 * i + 2 * t) =
          make_float2(st[4 * i + 2 * r], st[4 * i + 2 * r + 1]);
}

// The state pass: for each (b, h), h_in[0] = h0 (or 0) and h_in[s + 1] =
// exp(T_s) h_in[s] + S_s, written over S_s; segment s + 1's outputs start
// from it.  One thread per state entry walks the segments in order.
__global__ void ssd_scan_wg_pass(float* __restrict__ seg_state,
                                 const float* __restrict__ seg_decay,
                                 const float* __restrict__ h0, int pn, int nseg) {
  const int64_t bh = blockIdx.x;
  const int e = blockIdx.y * blockDim.x + threadIdx.x;
  if (e >= pn) return;
  float v = h0 != nullptr ? h0[bh * pn + e] : 0.f;
  for (int s = 0; s < nseg - 1; ++s) {
    float* p = seg_state + (bh * (nseg - 1) + s) * pn + e;
    v = expf(seg_decay[bh * (nseg - 1) + s]) * v + *p;
    *p = v;
  }
}

template <int PM, int NM, bool OUT>
cudaError_t launch_wg_kernel(const CUtensorMap& tm_x, const CUtensorMap& tm_b,
                             const CUtensorMap& tm_c, const CUtensorMap& tm_y, const void* dt,
                             int dt_bf16, const void* A, const void* h0, void* state,
                             void* seg_state, void* seg_decay, int B, int H, int G, int S,
                             int nseg, cudaStream_t stream) {
  using L = WgLayout<PM, NM, OUT>;
  auto kernel = ssd_scan_wg_kernel<PM, NM, OUT>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, L::kAlloc);
  if (err != cudaSuccess) return err;
  const dim3 grid(H, OUT ? nseg : nseg - 1, B);
  kernel<<<grid, L::kThreads, L::kAlloc, stream>>>(
      tm_x, tm_b, tm_c, tm_y, dt, dt_bf16, static_cast<const float*>(A),
      static_cast<const float*>(h0), static_cast<float*>(state),
      static_cast<float*>(seg_state), static_cast<float*>(seg_decay), H, G, S, nseg);
  return cudaGetLastError();
}

// At most three launches on `stream`: with nseg > 1 the segment states of
// segments 0 .. nseg - 2, the state pass, then the outputs of every segment
// (with nseg = 1 the outputs alone, from h0).  Each launch's error is checked
// before the next is made.
template <int PM, int NM>
cudaError_t launch_wg(const void* x, const void* dt, int dt_bf16, const void* A, const void* Bm,
                      const void* Cm, const void* h0, void* y, void* state, void* seg_state,
                      void* seg_decay, int B, int H, int G, int S, int nseg,
                      cudaStream_t stream) {
  CUtensorMap tm_x, tm_b, tm_c, tm_y;
  if (!hopper::bf16_panel_map(&tm_x, x, B * H, S, PM, kQ) ||
      !hopper::bf16_panel_map(&tm_b, Bm, B * G, S, NM, kQ) ||
      !hopper::bf16_panel_map(&tm_c, Cm, B * G, S, NM, kQ) ||
      !hopper::bf16_panel_map(&tm_y, y, B * H, S, PM, kQ))
    return cudaErrorInvalidValue;
  cudaError_t err;
  if (nseg > 1) {
    err = launch_wg_kernel<PM, NM, false>(tm_x, tm_b, tm_c, tm_y, dt, dt_bf16, A, h0, state,
                                          seg_state, seg_decay, B, H, G, S, nseg, stream);
    if (err != cudaSuccess) return err;
    const int pn = PM * NM;
    ssd_scan_wg_pass<<<dim3(B * H, (pn + 255) / 256), 256, 0, stream>>>(
        static_cast<float*>(seg_state), static_cast<const float*>(seg_decay),
        static_cast<const float*>(h0), pn, nseg);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  return launch_wg_kernel<PM, NM, true>(tm_x, tm_b, tm_c, tm_y, dt, dt_bf16, A, h0, state,
                                        seg_state, seg_decay, B, H, G, S, nseg, stream);
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

}  // namespace

// x_dtype (x, B, C), y_dtype and dt_dtype: 0 = float32, 1 = bfloat16.
// variant: 0 = fma (CUDA cores, any types, y in x's type), 1 = tc (tensor
// cores: bfloat16 x, B, C with P % 8 == 0 and N % 8 == 0 only; y bfloat16 or
// float32).  Other combinations return cudaErrorInvalidValue.  A, h0 and
// state are float32; h0 may be null (zero initial state).  P <= 128,
// N <= 128, H % G == 0, S >= 1.  Returns a cudaError_t (0 on success);
// launches on `stream` and does not synchronise.
extern "C" int repro_ssd_scan_fwd(const void* x, const void* dt, const void* A,
                                  const void* Bm, const void* Cm, const void* h0,
                                  void* y, void* state, int x_dtype, int y_dtype,
                                  int dt_dtype, int variant, int B, int H, int G, int S,
                                  int P, int N, void* stream) {
  if (B < 1 || H < 1 || G < 1 || H % G != 0 || S < 1 || P < 1 || P > 128 ||
      N < 1 || N > kNM || B > 65535 || (variant != 0 && variant != 1) ||
      (y_dtype != 0 && y_dtype != 1))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (variant == 1) {
    if (x_dtype != 1 || P % 8 != 0 || N % 8 != 0) return (int)cudaErrorInvalidValue;
    if (dt_dtype == 0 && y_dtype == 1)
      return (int)dispatch_tc<float, bf16>(x, dt, A, Bm, Cm, h0, y, state, B, H, G, S, P, N, s);
    if (dt_dtype == 1 && y_dtype == 1)
      return (int)dispatch_tc<bf16, bf16>(x, dt, A, Bm, Cm, h0, y, state, B, H, G, S, P, N, s);
    if (dt_dtype == 0 && y_dtype == 0)
      return (int)dispatch_tc<float, float>(x, dt, A, Bm, Cm, h0, y, state, B, H, G, S, P, N, s);
    if (dt_dtype == 1 && y_dtype == 0)
      return (int)dispatch_tc<bf16, float>(x, dt, A, Bm, Cm, h0, y, state, B, H, G, S, P, N, s);
    return (int)cudaErrorInvalidValue;
  }
  if (y_dtype != x_dtype) return (int)cudaErrorInvalidValue;
  if (x_dtype == 0 && dt_dtype == 0)
    return (int)dispatch<float, float>(x, dt, A, Bm, Cm, h0, y, state, B, H, G, S, P, N, s);
  if (x_dtype == 0 && dt_dtype == 1)
    return (int)dispatch<float, __nv_bfloat16>(x, dt, A, Bm, Cm, h0, y, state, B, H, G, S, P, N, s);
  if (x_dtype == 1 && dt_dtype == 0)
    return (int)dispatch<__nv_bfloat16, float>(x, dt, A, Bm, Cm, h0, y, state, B, H, G, S, P, N, s);
  if (x_dtype == 1 && dt_dtype == 1)
    return (int)dispatch<__nv_bfloat16, __nv_bfloat16>(x, dt, A, Bm, Cm, h0, y, state, B, H, G, S, P, N, s);
  return (int)cudaErrorInvalidValue;
}

// The wg variant: bfloat16 x, B, C and y (16-byte aligned) with P and N in {64,
// 128}; dt float32 (dt_dtype 0) or bfloat16 (1); y bfloat16, state float32;
// h0 may be null.  The sequence is cut into nseg segments of whole 64-row
// chunks (1 <= nseg <= ceil(S / 64)); with nseg > 1, seg_state [B, H, nseg -
// 1, P, N] and seg_decay [B, H, nseg - 1] (float32) are scratch that the call
// overwrites.  Runs one kernel (nseg = 1) or three, in order on `stream`, and
// does not synchronise; returns the first launch's error that is not 0.
extern "C" int repro_ssd_scan_wg_fwd(const void* x, const void* dt, const void* A,
                                     const void* Bm, const void* Cm, const void* h0, void* y,
                                     void* state, void* seg_state, void* seg_decay,
                                     int dt_dtype, int B, int H, int G, int S, int P, int N,
                                     int nseg, void* stream) {
  const int nc = S >= 1 ? (S + kQ - 1) / kQ : 0;
  if (B < 1 || H < 1 || G < 1 || H % G != 0 || S < 1 || B > 65535 ||
      (P != 64 && P != 128) || (N != 64 && N != 128) || (dt_dtype != 0 && dt_dtype != 1) ||
      nseg < 1 || nseg > nc || nseg > 65535 ||
      (nseg > 1 && (seg_state == nullptr || seg_decay == nullptr)) ||
      ((uintptr_t)x | (uintptr_t)Bm | (uintptr_t)Cm | (uintptr_t)y) % 16 != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (P == 64 && N == 128)
    return (int)launch_wg<64, 128>(x, dt, dt_dtype, A, Bm, Cm, h0, y, state, seg_state,
                                   seg_decay, B, H, G, S, nseg, s);
  if (P == 128 && N == 128)
    return (int)launch_wg<128, 128>(x, dt, dt_dtype, A, Bm, Cm, h0, y, state, seg_state,
                                    seg_decay, B, H, G, S, nseg, s);
  if (P == 64)
    return (int)launch_wg<64, 64>(x, dt, dt_dtype, A, Bm, Cm, h0, y, state, seg_state,
                                  seg_decay, B, H, G, S, nseg, s);
  return (int)launch_wg<128, 64>(x, dt, dt_dtype, A, Bm, Cm, h0, y, state, seg_state,
                                 seg_decay, B, H, G, S, nseg, s);
}

// The dynamic shared memory of the kernel that a call of `variant` at head
// dim P launches (bf16 x for tc and wg, f32 for fma; dt f32; for wg the
// outputs kernel at N = 128), and how many of its blocks fit on an SM.
// Returns a cudaError_t.
extern "C" int repro_ssd_scan_occupancy(int variant, int P, int* smem_bytes,
                                        int* blocks_per_sm) {
  if (P < 1 || P > 128 || variant < 0 || variant > 2) return (int)cudaErrorInvalidValue;
  if (variant == 2) {
    if (P == 64)
      return (int)occupancy(ssd_scan_wg_kernel<64, 128, true>, WgLayout<64, 128, true>::kThreads,
                            WgLayout<64, 128, true>::kAlloc, smem_bytes, blocks_per_sm);
    if (P == 128)
      return (int)occupancy(ssd_scan_wg_kernel<128, 128, true>,
                            WgLayout<128, 128, true>::kThreads, WgLayout<128, 128, true>::kAlloc,
                            smem_bytes, blocks_per_sm);
    return (int)cudaErrorInvalidValue;
  }
  if (variant == 1)
    return P <= 64 ? (int)occupancy(ssd_scan_tc_kernel<float, bf16, 64>, 64 / 16 * 32,
                                    tc_smem_bytes<64>(), smem_bytes, blocks_per_sm)
                   : (int)occupancy(ssd_scan_tc_kernel<float, bf16, 128>, 128 / 16 * 32,
                                    tc_smem_bytes<128>(), smem_bytes, blocks_per_sm);
  return P <= 64 ? (int)occupancy(ssd_scan_kernel<float, float, 64>, kThreads,
                                  smem_floats<64>() * sizeof(float), smem_bytes, blocks_per_sm)
                 : (int)occupancy(ssd_scan_kernel<float, float, 128>, kThreads,
                                  smem_floats<128>() * sizeof(float), smem_bytes, blocks_per_sm);
}
