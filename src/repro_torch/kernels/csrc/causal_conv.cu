// K4: the Mamba-2 prefill's depthwise causal conv and its SiLU, written by
// hand for Hopper (sm_90a).
//
// Replaces no TPU kernel.  The JAX package computes the conv with jnp
// (src/repro/models/ssm.py::causal_conv: a pad, W shifted products and the
// bias) and the SiLU after it, and XLA fuses those passes on the TPU.  The
// port's eager twin (kernels/causal_conv.py::causal_conv_silu_plain) runs
// them as thirteen PyTorch passes over [B, S, C]: the pad, W products and
// W sums in bf16, the bias, then the SiLU through an f32 copy and back,
// 66 bytes of device memory a channel and row where one read and one write
// need 4.  K4 was added to read each input row once and write each output
// row once.  It computes, for each of up to three tensors (x, B and C of a
// Mamba-2 layer, one launch a layer; each with its own weights and width):
//   * y[b, t, c] = silu(bias[c] + sum_i w[i, c] * x[b, t - (W-1) + i, c]),
//     rows before 0 read as zeros; x [B, S, C] and y [B, S, C] contiguous
//     bf16, w [W, C] and bias [C] bf16, W <= 4, C a multiple of 8;
//   * the products and sums in f32 and the SiLU in f32 (x / (1 + e^-x)),
//     rounded once to bf16.  The eager path rounds to bf16 after every
//     product and sum: the same mathematics at a higher precision.
//
// Bound.  W multiply-adds, an add and an exp a channel and row against 4
// bytes: far below the ~295 operations a byte at which the tensor cores
// would limit it, so the bound is the bytes, each input read once and each
// output written once, over 3.35 TB/s.  mamba2-1.3b at 4 x 32,768 rows
// (4,096 + 128 + 128 channels): 2.28 GB a layer, 0.68 ms; granite-4.0-h-
// small (8,192 + 128 + 128): 4.43 GB a layer, 1.32 ms.
//
// Design.  Each thread owns 8 consecutive channels (one 16-byte vector) of
// one tensor over a run of R = 64 consecutive rows of one sequence.  The
// W x 8 weights and the bias sit in f32 registers, and the last W - 1 input
// rows in a sliding window of registers, so each input row is read from
// device memory once, plus W - 1 halo rows at the start of each run (the
// previous run's last rows, mostly from L2).  Consecutive threads take
// consecutive vectors of one row, so a warp reads and writes 512 contiguous
// bytes a row.  The row loop loads the next U = 8 rows before it computes
// the 8 it holds, so that 8 loads a thread are in flight while it computes:
// at ~170 registers, one block of 256 threads an SM and 32 KB in flight an
// SM.  The SiLU divides with the fast reciprocal (~2 ulp of f32, far below
// the bf16 rounding after it).  Indices are 64-bit throughout: granite's x
// is 2 GiB.  The three tensors are one flat range of vectors; a thread
// picks its tensor by comparing its vector index with the tensors' ends.
// Measured on an H100 at the cells' shapes: U = 8 took 80-84% of the bound,
// U = 4 (two blocks an SM) 77%, U = 2 68-75%, U = 16 (spilling) 75%, loads
// issued only after the previous rows were computed 72%; IEEE division
// took U = 4 from 77% to 56%.  R = 32 read within 3 points of R = 64, 16 up
// to 6 and 8 up to 18 points lower (halo rows read again), 128 up to 7
// points lower at 256-row prompts.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxParts = 3;
constexpr int kUnroll = 8;       // rows loaded ahead of the arithmetic
constexpr int kRunRows = 64;     // rows a thread walks

struct Parts {
  const __nv_bfloat16* x[kMaxParts];
  const __nv_bfloat16* w[kMaxParts];
  const __nv_bfloat16* b[kMaxParts];
  __nv_bfloat16* y[kMaxParts];
  long long channels[kMaxParts];
  long long vec_end[kMaxParts];   // vectors of the tensors up to and including this one
};

__device__ __forceinline__ uint4 ld_stream(const void* p) {
  uint4 r;
  asm("ld.global.nc.L1::no_allocate.v4.u32 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r.x), "=r"(r.y), "=r"(r.z), "=r"(r.w)
      : "l"(p));
  return r;
}

__device__ __forceinline__ void unpack8(const uint4& r, float (&f)[8]) {
  const uint32_t w[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 v = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w[i]));
    f[2 * i] = v.x;
    f[2 * i + 1] = v.y;
  }
}

__device__ __forceinline__ uint4 pack8(const float (&f)[8]) {
  uint32_t w[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const __nv_bfloat162 v = __floats2bfloat162_rn(f[2 * i], f[2 * i + 1]);
    w[i] = *reinterpret_cast<const uint32_t*>(&v);
  }
  return make_uint4(w[0], w[1], w[2], w[3]);
}

template <typename T>
__device__ __forceinline__ T pick(int p, T a, T b, T c) {
  return p == 0 ? a : (p == 1 ? b : c);
}

// rows r .. r + kUnroll - 1 of one thread's channels; zeros from row r1 on
__device__ __forceinline__ void load_rows(uint4 (&raw)[kUnroll], const __nv_bfloat16* x,
                                          long long r, long long r1, long long C) {
#pragma unroll
  for (int u = 0; u < kUnroll; ++u)
    raw[u] = r + u < r1 ? ld_stream(x + (r + u) * C) : make_uint4(0, 0, 0, 0);
}

template <int W>
__global__ void __launch_bounds__(kThreads)
causal_conv_silu_kernel(const Parts P, long long S, long long runs, long long n_vec,
                        long long total) {
  const long long idx = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (idx >= total) return;
  const long long v = idx % n_vec;
  const long long rest = idx / n_vec;
  const long long run = rest % runs;
  const long long bb = rest / runs;
  const int p = (v >= P.vec_end[0]) + (v >= P.vec_end[1]);
  const long long C = pick(p, P.channels[0], P.channels[1], P.channels[2]);
  const long long c = (v - pick(p, 0ll, P.vec_end[0], P.vec_end[1])) * 8;
  const __nv_bfloat16* x = pick(p, P.x[0], P.x[1], P.x[2]) + bb * S * C + c;
  const __nv_bfloat16* w = pick(p, P.w[0], P.w[1], P.w[2]) + c;
  const __nv_bfloat16* bias = pick(p, P.b[0], P.b[1], P.b[2]) + c;
  __nv_bfloat16* y = pick(p, P.y[0], P.y[1], P.y[2]) + bb * S * C + c;

  float wf[W][8], bf[8];
#pragma unroll
  for (int i = 0; i < W; ++i) unpack8(__ldg(reinterpret_cast<const uint4*>(w + i * C)), wf[i]);
  unpack8(__ldg(reinterpret_cast<const uint4*>(bias)), bf);

  const long long r0 = run * kRunRows;
  const long long r1 = r0 + kRunRows < S ? r0 + kRunRows : S;
  // win[i] holds row t - (W-1) + i of the row t about to be computed
  float win[W > 1 ? W - 1 : 1][8];
#pragma unroll
  for (int i = 0; i < W - 1; ++i) {
    const long long row = r0 - (W - 1) + i;
    if (row >= 0) {
      unpack8(ld_stream(x + row * C), win[i]);
    } else {
#pragma unroll
      for (int k = 0; k < 8; ++k) win[i][k] = 0.f;
    }
  }
  // the next kUnroll rows are in flight while these are computed
  uint4 next[kUnroll];
  load_rows(next, x, r0, r1, C);
  for (long long r = r0; r < r1; r += kUnroll) {
    uint4 raw[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) raw[u] = next[u];
    if (r + kUnroll < r1) load_rows(next, x, r + kUnroll, r1, C);
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      float cur[8], out[8];
      unpack8(raw[u], cur);
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        float a = bf[k];
#pragma unroll
        for (int i = 0; i < W - 1; ++i) a = fmaf(wf[i][k], win[i][k], a);
        a = fmaf(wf[W - 1][k], cur[k], a);
        out[k] = __fdividef(a, 1.f + __expf(-a));
      }
#pragma unroll
      for (int i = 0; i + 1 < W - 1; ++i)
#pragma unroll
        for (int k = 0; k < 8; ++k) win[i][k] = win[i + 1][k];
      if (W > 1) {
#pragma unroll
        for (int k = 0; k < 8; ++k) win[W > 1 ? W - 2 : 0][k] = cur[k];
      }
      if (r + u < r1) *reinterpret_cast<uint4*>(y + (r + u) * C) = pack8(out);
    }
  }
}

template <int W>
cudaError_t launch(const Parts& P, long long S, long long runs, long long n_vec,
                   long long total, cudaStream_t s) {
  const long long blocks = (total + kThreads - 1) / kThreads;
  causal_conv_silu_kernel<W><<<(unsigned)blocks, kThreads, 0, s>>>(P, S, runs, n_vec, total);
  return cudaGetLastError();
}

}  // namespace

// For each of the n_parts (1 to 3) tensors p: x[p] [B, S, channels[p]] bf16
// in, w[p] [W, channels[p]] and b[p] [channels[p]] bf16, y[p] [B, S,
// channels[p]] bf16 out, all contiguous and 16-byte aligned, channels[p] a
// positive multiple of 8.  1 <= W <= 4.  One launch on `stream`; returns a
// cudaError_t.
extern "C" int repro_causal_conv_silu(const void* const* x, const void* const* w,
                                      const void* const* b, void* const* y,
                                      const int* channels, int n_parts, int B, int S, int W,
                                      void* stream) {
  if (n_parts < 1 || n_parts > kMaxParts || B < 1 || S < 1 || W < 1 || W > 4)
    return (int)cudaErrorInvalidValue;
  Parts P = {};
  long long n_vec = 0;
  for (int p = 0; p < n_parts; ++p) {
    if (channels[p] < 8 || channels[p] % 8 != 0) return (int)cudaErrorInvalidValue;
    if (((uintptr_t)x[p] | (uintptr_t)w[p] | (uintptr_t)b[p] | (uintptr_t)y[p]) % 16 != 0)
      return (int)cudaErrorInvalidValue;
    P.x[p] = static_cast<const __nv_bfloat16*>(x[p]);
    P.w[p] = static_cast<const __nv_bfloat16*>(w[p]);
    P.b[p] = static_cast<const __nv_bfloat16*>(b[p]);
    P.y[p] = static_cast<__nv_bfloat16*>(y[p]);
    P.channels[p] = channels[p];
    n_vec += channels[p] / 8;
    P.vec_end[p] = n_vec;
  }
  for (int p = n_parts; p < kMaxParts; ++p) P.vec_end[p] = n_vec;
  const long long runs = ((long long)S + kRunRows - 1) / kRunRows;
  const long long total = (long long)B * runs * n_vec;
  if ((total + kThreads - 1) / kThreads > 2147483647ll) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (W) {
    case 1: return (int)launch<1>(P, S, runs, n_vec, total, s);
    case 2: return (int)launch<2>(P, S, runs, n_vec, total, s);
    case 3: return (int)launch<3>(P, S, runs, n_vec, total, s);
    case 4: return (int)launch<4>(P, S, runs, n_vec, total, s);
  }
  return (int)cudaErrorInvalidValue;
}
