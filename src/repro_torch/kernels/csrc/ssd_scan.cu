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
// H100 it is bound by memory bytes (~23.5 us), not by operations.  This first
// version reads each chunk once per (b, h) but multiplies on CUDA cores with
// one 8-warp block per SM, so it sits far above that bound; wgmma, TMA loads
// and bf16 tensor-core products are the work of later changes.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

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

}  // namespace

// x_dtype (x, B, C, y) and dt_dtype: 0 = float32, 1 = bfloat16.  A, h0 and
// state are float32; h0 may be null (zero initial state).  P <= 128,
// N <= 128, H % G == 0, S >= 1.  Returns a cudaError_t (0 on success);
// launches on `stream` and does not synchronise.
extern "C" int repro_ssd_scan_fwd(const void* x, const void* dt, const void* A,
                                  const void* Bm, const void* Cm, const void* h0,
                                  void* y, void* state, int x_dtype, int dt_dtype,
                                  int B, int H, int G, int S, int P, int N,
                                  void* stream) {
  if (B < 1 || H < 1 || G < 1 || H % G != 0 || S < 1 || P < 1 || P > 128 ||
      N < 1 || N > kNM || B > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
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
