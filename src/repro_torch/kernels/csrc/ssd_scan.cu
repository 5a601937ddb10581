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
// Design.  One thread block per (b, h) walks every chunk of the sequence in
// order, because CUDA blocks run in no order and cannot carry the [P, N]
// state from one grid step to the next as the TPU grid does; the fp32 state
// lives in shared memory for the whole sequence.  The kernel uses its own
// chunk length Q = 64: at the model's chunk of 256 the fp32 [Q, Q] tile alone
// would be 256 KiB, more than a block's 227 KB.  The result does not depend
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
// Two variants, chosen by the caller (kernels/ssd_scan.py::k2_variant):
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
//   (PERF.md; the bf16-operand kernel stays as TF32 = false, which
//   chip_smoke.py measures beside it).  The sums, the carried state, cum,
//   the decays and w stay fp32 (tests/test_torch_tc_rounding.py models
//   this rounding against the reference).  A warp owns 16 rows of the chunk
//   for the y products, so att goes from the C B^T accumulators to the A
//   operand of att x in registers, and 16 rows of P of the fp32 state, which
//   lives in that warp's accumulators for the whole sequence.  C state^T is
//   computed there as state C^T, with the state as the A operand straight
//   from the accumulators, and handed to the warps that own y's rows through
//   shared memory (a bf16 state copy, the B operand of C state^T, in the
//   bf16-operand kernel).  The next chunk's x, B and C are
//   prefetched with 16-byte cp.async into a second buffer while the current
//   one is multiplied (dt into registers of the warp that scans it), so a
//   chunk costs two block barriers.  Tiles are bf16 with rows padded by
//   16 bytes (conflict-free ldmatrix): at P <= 64, 105 KB a block, so two
//   4-warp blocks fit on an SM and the 256 blocks of the serve shape run in
//   one wave on 132 SMs.  If one block per (b, h) still leaves the card
//   latency-bound, the next step is a chunk-parallel split: per-chunk states,
//   a short pass over the states, then per-chunk outputs.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

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
constexpr int kTcNS = kNM + kTcPad;     // row stride of B, C and the state copy

template <int PM>
constexpr size_t tc_smem_bytes() {
  return ((size_t)2 * kQ * (PM + kTcPad)       // xs [2][Q][PM+8]
          + (size_t)4 * kQ * kTcNS             // Bs, Cs [2][Q][NM+8]
          + (size_t)PM * kTcNS) * sizeof(bf16) // Sb [PM][NM+8], bf16 copy of the state
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
// TF32 takes att x and C state^T on tf32 operands (m16n8k8) instead of
// bf16; C state^T is then computed as state C^T from the fp32 state in the
// accumulators, and passed to the warps that own y's rows through the
// shared memory that otherwise holds the bf16 copy of the state.
template <typename TD, typename TY, bool TF32, int PM>
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
  float* Ts = reinterpret_cast<float*>(Sb);       // [Q][TS], state C^T (TF32)
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
  auto store_state_copy = [&]() {
    if constexpr (TF32) return;   // C state^T reads the accumulators instead
#pragma unroll
    for (int nt = 0; nt < NNT; ++nt) {
      if (nt * 8 >= N16) break;
#pragma unroll
      for (int r = 0; r < 2; ++r)
        *reinterpret_cast<uint32_t*>(Sb + prow[r] * NS + nt * 8 + 2 * t) =
            tc::pack_bf16(st[nt][2 * r], st[nt][2 * r + 1]);
    }
  };
  store_state_copy();

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

    if constexpr (TF32) {
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

    // ---- C B^T (keys up to this warp's last row) and, on bf16 operands,
    // C state^T, sharing C
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
#pragma unroll
      for (int np = 0; np < 4; ++np) {
        if (TF32 || p_lo + np * 16 >= P16) break;
        uint32_t bs[4];
        tc::ldmatrix_x4(bs, Sb + (p_lo + np * 16 + (lane >> 4) * 8 + (lane & 7)) * NS +
                                kk * 16 + ((lane >> 3) & 1) * 8);
        tc::mma_bf16(acc[2 * np], ac, bs[0], bs[1]);
        tc::mma_bf16(acc[2 * np + 1], ac, bs[2], bs[3]);
      }
    }
    // ---- att = (C B^T) .* exp(cum_i - cum_j) .* dt_j for i >= j, as A
    // fragments; exp is evaluated only where i >= j (it overflows above).
    // bf16: af[k-step of 16 keys].  tf32: af[k-step of 8 keys], with the keys
    // of a k-step permuted (logical k t <-> key 2t, k t+4 <-> key 2t+1) so
    // that the C fragment is the A fragment as it stands; the B operand below
    // takes the same permutation.
    uint32_t af[TF32 ? 8 : 4][4];
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
        if constexpr (TF32) {
          af[nt][0] = tc::to_tf32(v[0]);
          af[nt][1] = tc::to_tf32(v[2]);
          af[nt][2] = tc::to_tf32(v[1]);
          af[nt][3] = tc::to_tf32(v[3]);
        } else {
          af[nt / 2][(nt & 1) * 2] = tc::pack_bf16(v[0], v[1]);
          af[nt / 2][(nt & 1) * 2 + 1] = tc::pack_bf16(v[2], v[3]);
        }
      }
    }
    // ---- y = exp(cum_i) (C state^T) + att x
    if constexpr (TF32) __syncthreads();   // Ts is complete
    {
      const float e0 = ecum[i_row[0]], e1 = ecum[i_row[1]];
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        if constexpr (TF32) {
          if (p_lo + nt * 8 >= P16) break;
          const int p = p_lo + nt * 8 + 2 * t;
          const float2 r0 = *reinterpret_cast<const float2*>(Ts + i_row[0] * TS + p);
          const float2 r1 = *reinterpret_cast<const float2*>(Ts + i_row[1] * TS + p);
          acc[nt][0] = r0.x;
          acc[nt][1] = r0.y;
          acc[nt][2] = r1.x;
          acc[nt][3] = r1.y;
        }
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
        if constexpr (TF32) {
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
        } else {
          tc::mma_bf16(acc[2 * dp], af[kk], bx[0], bx[1]);
          tc::mma_bf16(acc[2 * dp + 1], af[kk], bx[2], bx[3]);
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
    if constexpr (!TF32) __syncthreads();   // every warp is done reading the state copy

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
    store_state_copy();   // read after the next chunk's first barrier (bf16)
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

template <typename TD, typename TY, bool TF32, int PM>
cudaError_t launch_tc(const void* x, const void* dt, const void* A, const void* Bm,
                      const void* Cm, const void* h0, void* y, void* state, int B, int H,
                      int G, int S, int P, int N, cudaStream_t stream) {
  const size_t smem = tc_smem_bytes<PM>();
  auto kernel = ssd_scan_tc_kernel<TD, TY, TF32, PM>;
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

template <typename TD, typename TY, bool TF32>
cudaError_t dispatch_tc_p(const void* x, const void* dt, const void* A, const void* Bm,
                          const void* Cm, const void* h0, void* y, void* state, int B, int H,
                          int G, int S, int P, int N, cudaStream_t stream) {
  if (P <= 64)
    return launch_tc<TD, TY, TF32, 64>(x, dt, A, Bm, Cm, h0, y, state, B, H, G, S, P, N,
                                           stream);
  return launch_tc<TD, TY, TF32, 128>(x, dt, A, Bm, Cm, h0, y, state, B, H, G, S, P, N,
                                          stream);
}

template <typename TD, typename TY>
cudaError_t dispatch_tc(int tf32, const void* x, const void* dt, const void* A,
                        const void* Bm, const void* Cm, const void* h0, void* y, void* state,
                        int B, int H, int G, int S, int P, int N, cudaStream_t stream) {
  return tf32 ? dispatch_tc_p<TD, TY, true>(x, dt, A, Bm, Cm, h0, y, state, B, H, G, S,
                                                P, N, stream)
                  : dispatch_tc_p<TD, TY, false>(x, dt, A, Bm, Cm, h0, y, state, B, H, G, S,
                                                 P, N, stream);
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
// float32; tf32 = 1 takes att x and C state^T on tf32 operands).  Other
// combinations return cudaErrorInvalidValue.  A, h0 and
// state are float32; h0 may be null (zero initial state).  P <= 128,
// N <= 128, H % G == 0, S >= 1.  Returns a cudaError_t (0 on success);
// launches on `stream` and does not synchronise.
extern "C" int repro_ssd_scan_fwd(const void* x, const void* dt, const void* A,
                                  const void* Bm, const void* Cm, const void* h0,
                                  void* y, void* state, int x_dtype, int y_dtype,
                                  int dt_dtype, int variant, int tf32, int B, int H,
                                  int G, int S, int P, int N, void* stream) {
  if (B < 1 || H < 1 || G < 1 || H % G != 0 || S < 1 || P < 1 || P > 128 ||
      N < 1 || N > kNM || B > 65535 || (variant != 0 && variant != 1) ||
      (y_dtype != 0 && y_dtype != 1) || (tf32 != 0 && tf32 != 1) ||
      (variant == 0 && tf32))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (variant == 1) {
    if (x_dtype != 1 || P % 8 != 0 || N % 8 != 0) return (int)cudaErrorInvalidValue;
    if (dt_dtype == 0 && y_dtype == 1)
      return (int)dispatch_tc<float, bf16>(tf32, x, dt, A, Bm, Cm, h0, y, state, B, H, G, S, P, N, s);
    if (dt_dtype == 1 && y_dtype == 1)
      return (int)dispatch_tc<bf16, bf16>(tf32, x, dt, A, Bm, Cm, h0, y, state, B, H, G, S, P, N, s);
    if (dt_dtype == 0 && y_dtype == 0)
      return (int)dispatch_tc<float, float>(tf32, x, dt, A, Bm, Cm, h0, y, state, B, H, G, S, P, N, s);
    if (dt_dtype == 1 && y_dtype == 0)
      return (int)dispatch_tc<bf16, float>(tf32, x, dt, A, Bm, Cm, h0, y, state, B, H, G, S, P, N, s);
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

// The dynamic shared memory of the kernel that a call of `variant` at head
// dim P launches (bf16 x for tc, f32 for fma; dt f32), and how many of its
// blocks fit on an SM.  Returns a cudaError_t.
extern "C" int repro_ssd_scan_occupancy(int variant, int P, int* smem_bytes,
                                        int* blocks_per_sm) {
  if (P < 1 || P > 128 || (variant != 0 && variant != 1)) return (int)cudaErrorInvalidValue;
  if (variant == 1)
    return P <= 64 ? (int)occupancy(ssd_scan_tc_kernel<float, bf16, false, 64>, 64 / 16 * 32,
                                    tc_smem_bytes<64>(), smem_bytes, blocks_per_sm)
                   : (int)occupancy(ssd_scan_tc_kernel<float, bf16, false, 128>, 128 / 16 * 32,
                                    tc_smem_bytes<128>(), smem_bytes, blocks_per_sm);
  return P <= 64 ? (int)occupancy(ssd_scan_kernel<float, float, 64>, kThreads,
                                  smem_floats<64>() * sizeof(float), smem_bytes, blocks_per_sm)
                 : (int)occupancy(ssd_scan_kernel<float, float, 128>, kThreads,
                                  smem_floats<128>() * sizeof(float), smem_bytes, blocks_per_sm);
}
