// K1: forward attention with online softmax, written by hand for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/flash_attention.py::_kernel
// (launched by flash_attention_hmajor).  It computes the same function:
//   * q [B,H,Sq,hd], k/v [B,K,Skv,hd] (head-major, contiguous), f32 or bf16,
//     upcast to f32; output o [B,H,Sq,hd] in q's type;
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
// grid does.  A reference kv tile is processed in sub-tiles of 64 keys.  The
// ragged Sq and Skv edges are masked in the kernel instead of padded copies:
// keys past Skv inside the last reference tile count as invalid keys (score
// -1e30, value 0), exactly as the reference's zero padding does.
//
// Bound.  At the serve shape (B=4, Sq=Skv=1024, H=16, K=8, hd=128, causal,
// bf16) the work is ~17.2 GFLOP against ~50 MB of q/k/v/o, so on an H100 the
// bound is the bf16 tensor-core rate (~17 us), not memory (~15 us).  This
// first version multiplies in fp32 with FMA on CUDA cores (IEEE products, no
// TF32, so f32 inputs agree with the plain version to 2e-5) and therefore
// sits far above that bound.  wgmma, TMA loads and bf16 tensor-core products
// are the work of later changes.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

#include <algorithm>

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

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  window <= 0 means global.  kv_valid is
// clamped to Skv.  Returns a cudaError_t (0 on success); launches on
// `stream` and does not synchronise.
extern "C" int repro_flash_attention_fwd(const void* q, const void* k, const void* v,
                                         void* o, int dtype, int B, int H, int K,
                                         int Sq, int Skv, int hd, int causal,
                                         int window, int kv_valid, float scale,
                                         void* stream) {
  if (B < 1 || H < 1 || K < 1 || H % K != 0 || Sq < 0 || Skv < 1 || hd < 1 ||
      hd > 256 || B > 65535 || H > 65535)
    return (int)cudaErrorInvalidValue;
  if (Sq == 0) return (int)cudaSuccess;
  kv_valid = std::min(kv_valid, Skv);
  window = window > 0 ? window : 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return (int)dispatch<float>(q, k, v, o, B, H, K, Sq, Skv, hd, causal, window, kv_valid, scale, s);
  if (dtype == 1)
    return (int)dispatch<__nv_bfloat16>(q, k, v, o, B, H, K, Sq, Skv, hd, causal, window, kv_valid, scale, s);
  return (int)cudaErrorInvalidValue;
}
