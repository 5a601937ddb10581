// K3: decode attention split over keys, written by hand for Hopper (sm_90a).
//
// Replaces no TPU kernel.  The JAX package computes decode attention (one
// query row against the KV cache) with jnp einsums, src/repro/models/
// attention.py::attention_dot, and has no Pallas kernel for it.  The port's
// twin of that path casts the whole grown cache to f32 and materialises the
// scores, so on the card a decode step read each bf16 cache element, wrote it
// as f32 and read it again, over every padded position.  K3 was added to read
// the bf16 (or f16) cache once, in place, and only up to the valid length.
// It computes what models/attention.py::_attention_dot computes for Sq = 1:
//   * q [B,1,H,hd], k/v [B,S,K,hd] in the model's layout, read through their
//     strides (the last dim contiguous, rows 16-byte aligned); out [B,1,H,hd]
//     contiguous in q's type;
//   * GQA by index: q head h reads kv head h / G, G = H / K;
//   * keys lo .. hi-1 only: the caller folds the valid length, the causal
//     limit and the sliding window into that range (kernels/
//     decode_attention.py), so nothing past it is read; or, where the
//     position lives on the device (a decode step replayed as a CUDA graph),
//     keys lo .. min(hi, *valid)-1, the grid cut over lo .. hi-1 (the cache's
//     capacity): the splits that lie past the valid length exit at once and
//     the combine skips them;
//   * scores: bf16 q . bf16 k with the products and sums in f32, times the
//     softmax scale in f32; running max, sum and accumulator in f32;
//   * probabilities rounded to the cache's type before P V, as the dot path
//     and K1 round them; P V accumulated in f32; the output rounded to q's
//     type.  The rounded probabilities are split-local (exp(s - running
//     max)), as K1's are tile-local; the sum takes them unrounded, as K1's
//     does.
//
// Bound.  Decode attention does 4 hd flops per (head, key) against 2 hd
// bytes of k and v per (kv head, key): at G = 2 that is 4 flops a byte, far
// below the ~295 at which the tensor cores would limit it.  So the bound is
// the bytes of k and v in lo .. hi-1 over 3.35 TB/s: internlm2-1.8b at
// 4 x 24,577 keys, 8 kv heads of 128, is 403 MB a layer, 120 us.
//
// Design (the split-K of FlashDecoding).  One block of 256 threads per
// (key split, kv head and head chunk, batch row), so that a batch of 4 rows
// and 8 kv heads still fills the card: the wrapper picks the split count from
// B * K and the range's length, as many splits as fill the card's resident
// blocks (2 an SM) once; longer splits measured faster than more of them,
// since each block pays a prologue and a combine.  A key row of hd
// bf16 values is hd / 8 lanes of 16 bytes, neighbouring lanes on neighbouring
// addresses, so a warp reads whole 256-byte rows at hd 128.  The block's
// 256 / (hd / 8) row groups walk the split's keys U at a time; each reads a K
// and a V row once for all the GT query heads of its kv head that the block
// holds (G = 2 for internlm2), reduces each head's score across its lanes
// with shuffles, and keeps a running max, sum and f32 accumulator per head.
// Loads are streamed (L1 not allocated) and issued one step ahead of the
// arithmetic, double-buffered in registers, so up to 2 U rows of k and v a
// thread are in flight (U = 4 at up to 2 heads a block: 64 KB a block).
// The row groups' states are combined through shared memory at the end of
// the block.  With one split the block writes the output; with more, each
// writes its unnormalised accumulator, max and sum, and a second, small
// launch (one block per (batch row, head)) combines the splits.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr float kInitMax = -1e30f;   // finite, so that exp(m_old - m_new) is never nan

__device__ __forceinline__ uint4 ld_stream(const void* p) {
  uint4 r;
  asm("ld.global.nc.L1::no_allocate.v4.u32 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r.x), "=r"(r.y), "=r"(r.z), "=r"(r.w)
      : "l"(p));
  return r;
}

// 8 values of T packed in 16 bytes, as f32
__device__ __forceinline__ void unpack8(const uint4& r, float (&f)[8], __nv_bfloat16) {
  const uint32_t w[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 x = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w[i]));
    f[2 * i] = x.x;
    f[2 * i + 1] = x.y;
  }
}

__device__ __forceinline__ void unpack8(const uint4& r, float (&f)[8], __half) {
  const uint32_t w[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 x = __half22float2(*reinterpret_cast<const __half2*>(&w[i]));
    f[2 * i] = x.x;
    f[2 * i + 1] = x.y;
  }
}

// x rounded to T (to nearest even), as f32
__device__ __forceinline__ float round_to(float x, __nv_bfloat16) {
  return __bfloat162float(__float2bfloat16_rn(x));
}
__device__ __forceinline__ float round_to(float x, __half) {
  return __half2float(__float2half_rn(x));
}

__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16_rn(x); }
__device__ __forceinline__ void store(__half* p, float x) { *p = __float2half_rn(x); }

// The end of the keys a call reads: hi, or the valid length that `valid`
// holds on the device (at least lo, at most hi).
__device__ __forceinline__ int key_end(int lo, int hi, const long long* valid) {
  return valid == nullptr ? hi : (int)max((long long)lo, min((long long)hi, *valid));
}

// Rows that one row group reads a step, and blocks resident per SM: where a
// block holds up to 4 query heads, 4 rows (2 at 4 heads) and 2 blocks in
// 128 registers a thread; at 8 heads, q and the accumulators alone take 128,
// so 1 row and 1 block (kernels/decode_attention.py::BLOCKS_PER_SM).
template <int GT>
__host__ __device__ constexpr int unroll() { return GT <= 2 ? 4 : (GT == 4 ? 2 : 1); }

template <typename T, int HD, int GT>
__global__ void __launch_bounds__(kThreads, GT <= 4 ? 2 : 1)
k3_split_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                T* __restrict__ out, float* __restrict__ part_o, float* __restrict__ part_ml,
                const long long* __restrict__ valid, int H, int G, int lo, int hi,
                int chunk, int splits, long long q_sb, long long q_sh, long long k_sb,
                long long k_ss, long long k_sh, long long v_sb, long long v_ss, long long v_sh,
                float scale) {
  constexpr int L = HD / 8;          // lanes of one key row
  constexpr int R = kThreads / L;    // row groups
  constexpr int U = unroll<GT>();
  __shared__ float sm_m[R][GT], sm_l[R][GT];
  __shared__ float sm_acc[kThreads * 8];

  const int split = blockIdx.x;
  const int n_chunks = (G + GT - 1) / GT;
  const int kvh = blockIdx.y / n_chunks;
  const int g0 = (blockIdx.y % n_chunks) * GT;
  const int b = blockIdx.z;
  const int tid = threadIdx.x, rg = tid / L, ln = tid % L;
  const int end = key_end(lo, hi, valid);
  const int key_lo = lo + split * chunk;
  if (split > 0 && key_lo >= end) return;    // past the valid length: the combine skips it
  const int key_hi = min(end, key_lo + chunk);

  float qf[GT][8];
#pragma unroll
  for (int g = 0; g < GT; ++g) {
    if (g0 + g < G) {
      const T* qp = q + b * q_sb + (long long)(kvh * G + g0 + g) * q_sh + ln * 8;
      unpack8(*reinterpret_cast<const uint4*>(qp), qf[g], T());
    } else {
#pragma unroll
      for (int j = 0; j < 8; ++j) qf[g][j] = 0.f;
    }
  }

  float m[GT], l[GT], acc[GT][8];
#pragma unroll
  for (int g = 0; g < GT; ++g) {
    m[g] = kInitMax;
    l[g] = 0.f;
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[g][j] = 0.f;
  }

  const T* kp = k + b * k_sb + kvh * k_sh + ln * 8;
  const T* vp = v + b * v_sb + kvh * v_sh + ln * 8;
  // step `it`, slot u of row group rg reads key key_lo + (it * U + u) * R + rg
  auto key_of = [&](int it, int u) { return key_lo + (it * U + u) * R + rg; };
  auto load = [&](uint4 (&kr)[U], uint4 (&vr)[U], int it) {
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int key = key_of(it, u);
      if (key < key_hi) {
        kr[u] = ld_stream(kp + key * k_ss);
        vr[u] = ld_stream(vp + key * v_ss);
      } else {
        kr[u] = make_uint4(0u, 0u, 0u, 0u);
        vr[u] = make_uint4(0u, 0u, 0u, 0u);
      }
    }
  };
  auto consume = [&](const uint4 (&kr)[U], const uint4 (&vr)[U], int it) {
    float s[U][GT];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      float kf[8];
      unpack8(kr[u], kf, T());
#pragma unroll
      for (int g = 0; g < GT; ++g) {
        float d = 0.f;
#pragma unroll
        for (int j = 0; j < 8; ++j) d = fmaf(qf[g][j], kf[j], d);
        s[u][g] = d;
      }
    }
#pragma unroll
    for (int u = 0; u < U; ++u)
#pragma unroll
      for (int g = 0; g < GT; ++g)
#pragma unroll
        for (int off = L / 2; off > 0; off >>= 1)
          s[u][g] += __shfl_xor_sync(0xffffffffu, s[u][g], off);
#pragma unroll
    for (int g = 0; g < GT; ++g) {
      float mx = m[g];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        s[u][g] = key_of(it, u) < key_hi ? s[u][g] * scale : -INFINITY;
        mx = fmaxf(mx, s[u][g]);
      }
      const float corr = __expf(m[g] - mx);
      m[g] = mx;
      l[g] *= corr;
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[g][j] *= corr;
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      float vf[8];
      unpack8(vr[u], vf, T());
#pragma unroll
      for (int g = 0; g < GT; ++g) {
        const float p = __expf(s[u][g] - m[g]);     // 0 past key_hi
        l[g] += p;
        const float pr = round_to(p, T());
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[g][j] = fmaf(pr, vf[j], acc[g][j]);
      }
    }
  };

  const int steps = (key_hi - key_lo + U * R - 1) / (U * R);
  uint4 ka[U], va[U], kb[U], vb[U];
  load(ka, va, 0);
  for (int it = 0; it < steps; it += 2) {
    load(kb, vb, it + 1);
    consume(ka, va, it);
    if (it + 1 >= steps) break;
    load(ka, va, it + 2);
    consume(kb, vb, it + 1);
  }

  // combine the row groups: each head's max over the block, then its
  // rescaled accumulators summed over the row groups, one head at a time
  if (ln == 0) {
#pragma unroll
    for (int g = 0; g < GT; ++g) {
      sm_m[rg][g] = m[g];
      sm_l[rg][g] = l[g];
    }
  }
  __syncthreads();
#pragma unroll
  for (int g = 0; g < GT; ++g) {
    float M = kInitMax;
    for (int r = 0; r < R; ++r) M = fmaxf(M, sm_m[r][g]);
    const float f = __expf(m[g] - M);
#pragma unroll
    for (int j = 0; j < 8; ++j) sm_acc[rg * HD + ln * 8 + j] = acc[g][j] * f;
    __syncthreads();
    if (tid < HD && g0 + g < G) {
      float a = 0.f, lsum = 0.f;
      for (int r = 0; r < R; ++r) {
        a += sm_acc[r * HD + tid];
        lsum += sm_l[r][g] * __expf(sm_m[r][g] - M);
      }
      const long long bh = (long long)b * H + kvh * G + g0 + g;
      if (splits == 1) {
        store(out + bh * HD + tid, a / fmaxf(lsum, 1e-30f));
      } else {
        part_o[(bh * splits + split) * HD + tid] = a;
        if (tid == 0) {
          part_ml[(bh * splits + split) * 2] = M;
          part_ml[(bh * splits + split) * 2 + 1] = lsum;
        }
      }
    }
    __syncthreads();
  }
}

// One block of HD threads per (batch row, head): the splits' accumulators
// weighted by exp(m_s - M), over their weighted sums; of the splits only
// those that hold a key below the valid length.
template <typename T, int HD>
__global__ void __launch_bounds__(HD)
k3_combine_kernel(const float* __restrict__ part_o, const float* __restrict__ part_ml,
                  T* __restrict__ out, const long long* __restrict__ valid, int lo, int hi,
                  int chunk, int splits) {
  const long long bh = blockIdx.x;
  const int d = threadIdx.x;
  const float* ml = part_ml + bh * splits * 2;
  const int used = max(1, min(splits, (key_end(lo, hi, valid) - lo + chunk - 1) / chunk));
  float M = kInitMax;
  for (int s = 0; s < used; ++s) M = fmaxf(M, ml[2 * s]);
  float a = 0.f, lsum = 0.f;
  for (int s = 0; s < used; ++s) {
    const float w = __expf(ml[2 * s] - M);
    lsum += w * ml[2 * s + 1];
    a += w * part_o[(bh * splits + s) * HD + d];
  }
  store(out + bh * HD + d, a / fmaxf(lsum, 1e-30f));
}

template <typename T, int HD, int GT>
cudaError_t launch(const void* q, const void* k, const void* v, void* out, float* part_o,
                   float* part_ml, const long long* valid, int B, int H, int K, int lo,
                   int hi, int chunk, int splits, const long long* st, float scale,
                   cudaStream_t s) {
  const int G = H / K;
  const dim3 grid(splits, K * ((G + GT - 1) / GT), B);
  k3_split_kernel<T, HD, GT><<<grid, kThreads, 0, s>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(out), part_o, part_ml, valid, H, G, lo, hi, chunk, splits, st[0], st[1],
      st[2], st[3], st[4], st[5], st[6], st[7], scale);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return err;
  k3_combine_kernel<T, HD><<<B * H, HD, 0, s>>>(part_o, part_ml, static_cast<T*>(out), valid,
                                                lo, hi, chunk, splits);
  return cudaGetLastError();
}

template <typename T, int HD, int GT>
cudaError_t occupancy(int* blocks_per_sm) {
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks_per_sm, k3_split_kernel<T, HD, GT>,
                                                       kThreads, 0);
}

template <typename T, int HD>
cudaError_t by_heads(int gt, const void* q, const void* k, const void* v, void* out,
                     float* part_o, float* part_ml, const long long* valid, int B, int H,
                     int K, int lo, int hi, int chunk, int splits, const long long* st,
                     float scale, cudaStream_t s) {
  switch (gt) {
    case 1: return launch<T, HD, 1>(q, k, v, out, part_o, part_ml, valid, B, H, K, lo, hi, chunk, splits, st, scale, s);
    case 2: return launch<T, HD, 2>(q, k, v, out, part_o, part_ml, valid, B, H, K, lo, hi, chunk, splits, st, scale, s);
    case 4: return launch<T, HD, 4>(q, k, v, out, part_o, part_ml, valid, B, H, K, lo, hi, chunk, splits, st, scale, s);
    case 8: return launch<T, HD, 8>(q, k, v, out, part_o, part_ml, valid, B, H, K, lo, hi, chunk, splits, st, scale, s);
  }
  return cudaErrorInvalidValue;
}

template <typename T>
cudaError_t by_dim(int hd, int gt, const void* q, const void* k, const void* v, void* out,
                   float* part_o, float* part_ml, const long long* valid, int B, int H,
                   int K, int lo, int hi, int chunk, int splits, const long long* st,
                   float scale, cudaStream_t s) {
  switch (hd) {
    case 16: return by_heads<T, 16>(gt, q, k, v, out, part_o, part_ml, valid, B, H, K, lo, hi, chunk, splits, st, scale, s);
    case 32: return by_heads<T, 32>(gt, q, k, v, out, part_o, part_ml, valid, B, H, K, lo, hi, chunk, splits, st, scale, s);
    case 64: return by_heads<T, 64>(gt, q, k, v, out, part_o, part_ml, valid, B, H, K, lo, hi, chunk, splits, st, scale, s);
    case 128: return by_heads<T, 128>(gt, q, k, v, out, part_o, part_ml, valid, B, H, K, lo, hi, chunk, splits, st, scale, s);
    case 256: return by_heads<T, 256>(gt, q, k, v, out, part_o, part_ml, valid, B, H, K, lo, hi, chunk, splits, st, scale, s);
  }
  return cudaErrorInvalidValue;
}

}  // namespace

// q [B,1,H,hd], k/v [B,S,K,hd] by strides (elements): strides = {q batch,
// q head, k batch, k seq, k head, v batch, v seq, v head}; the last dim of
// each contiguous.  out [B,1,H,hd] contiguous.  Keys lo .. hi-1 (0 <= lo <
// hi <= S), cut into `splits` splits of `chunk` keys (the last ragged, none
// empty); with `valid` (a device int64, or null) only the keys below
// min(hi, *valid), the grid still cut over lo .. hi-1.  part_o
// [B,H,splits,hd] and part_ml [B,H,splits,2] f32 scratch, unused when
// splits == 1.  dtype 1 = bf16, 2 = f16.  gt: query heads per
// block (1, 2, 4 or 8).  Launches one kernel (splits == 1) or two on
// `stream`; returns a cudaError_t.
extern "C" int repro_decode_attention(const void* q, const void* k, const void* v, void* out,
                                      void* part_o, void* part_ml, const void* valid,
                                      int dtype, int B, int H, int K, int hd, int gt, int lo,
                                      int hi, int chunk, int splits, const long long* strides,
                                      float scale, void* stream) {
  if (B < 1 || B > 65535 || K < 1 || H < K || H % K != 0 || lo < 0 || hi <= lo ||
      chunk < 1 || splits < 1 || (long long)(splits - 1) * chunk >= (long long)(hi - lo) ||
      (long long)splits * chunk < (long long)(hi - lo) ||
      (long long)K * ((H / K + gt - 1) / gt) > 65535 || splits > 2147483647 / 2)
    return (int)cudaErrorInvalidValue;
  if (((uintptr_t)q | (uintptr_t)k | (uintptr_t)v) % 16 != 0) return (int)cudaErrorInvalidValue;
  for (int i = 0; i < 8; ++i)
    if (strides[i] % 8 != 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* po = static_cast<float*>(part_o);
  float* pml = static_cast<float*>(part_ml);
  const long long* vl = static_cast<const long long*>(valid);
  if (dtype == 1)
    return (int)by_dim<__nv_bfloat16>(hd, gt, q, k, v, out, po, pml, vl, B, H, K, lo, hi,
                                      chunk, splits, strides, scale, s);
  if (dtype == 2)
    return (int)by_dim<__half>(hd, gt, q, k, v, out, po, pml, vl, B, H, K, lo, hi, chunk,
                               splits, strides, scale, s);
  return (int)cudaErrorInvalidValue;
}

// Blocks of the split kernel that fit on an SM at head dim hd with gt query
// heads a block (bf16).  Returns a cudaError_t.
extern "C" int repro_decode_attention_occupancy(int hd, int gt, int* blocks_per_sm) {
  using T = __nv_bfloat16;
#define K3_OCC(HD)                                               \
  if (hd == HD) {                                                \
    if (gt == 1) return (int)occupancy<T, HD, 1>(blocks_per_sm); \
    if (gt == 2) return (int)occupancy<T, HD, 2>(blocks_per_sm); \
    if (gt == 4) return (int)occupancy<T, HD, 4>(blocks_per_sm); \
    if (gt == 8) return (int)occupancy<T, HD, 8>(blocks_per_sm); \
  }
  K3_OCC(16) K3_OCC(32) K3_OCC(64) K3_OCC(128) K3_OCC(256)
#undef K3_OCC
  return (int)cudaErrorInvalidValue;
}
