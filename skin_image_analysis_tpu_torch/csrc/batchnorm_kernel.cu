// Fused BatchNorm for Hopper (sm_90a): the train forward (statistics,
// finalize, apply), its backward (reduction, finalize, apply) and the eval
// forward (apply alone), each with the caller's epilogue: none, a ReLU, or
// the ResNet block's residual add followed by the ReLU.
//
// Replaces no Pallas kernel: the JAX package's Flax BatchNorm ran as XLA
// fusions. It exists because the port's BatchNorm, computed as a chain of
// float32 PyTorch operations (18 kernels a train-mode layer, then the ReLU
// and the residual add, each a pass over device memory, and autograd's
// walk back over saved float32 copies), was the largest device cost of the
// ResNet cells.
//
// The math is the chain's (models/resnet.py BatchNorm, Flax's formula):
// float32 per-channel sums, mean = sum x / count, the fast biased variance
// clamp_min(E[x^2] - mean^2, 0), rstd = rsqrt(var + eps), the running
// averages ra = momentum * ra + (1 - momentum) * batch, and
// y = (x - mean) * (rstd * gamma) + beta computed in float32 in that order
// (the _rn intrinsics keep nvcc from contracting it into FMAs, so every
// step rounds as the chain's separate kernels round) and rounded once to
// the activations' type. The residual epilogue rounds the BatchNorm output
// first, adds the residual in float32 and rounds again, then the ReLU: the
// chain's bf16 add. The backward is the chain's autograd in closed form:
// with g the incoming gradient behind the epilogue's mask and
// xhat = (x - mean) * rstd,
//   dx = a * g + b + k * xhat,  a = rstd * gamma,
//   b = -a * sum g / count,     k = -a * sum(g * xhat) / count
// (k = 0 where the clamp on the variance bit, whose gradient is then 0),
// dgamma = sum(g * xhat), dbeta = sum g; in eval, dx = a * g.
//
// Bound: device-memory bytes; a few flops per element. A train forward
// must read x twice (the statistics, then the apply) and write y once, plus
// the residual's read; the backward reads x and dy twice and writes dx (and
// the residual's gradient); the eval form reads x once and writes y once.
// At ResNet-50's B=256 that is 17 GB plus 2.8 GB of residual reads for the
// forward's 53 layers (about 6 ms at 3.35 TB/s), and 28.5 GB for the
// backward's plus 8.4 GB behind the 16 residual epilogues (the output read
// twice, the residual's gradient written; about 11 ms).
//
// Design for that bound:
//   * One layout, NCHW-contiguous ("planes": the train step's activations,
//     whose NHWC view of the preprocess kernel's planar output permutes
//     back to NCHW; the wrapper in models/resnet.py makes an NHWC input's
//     channels-last stem activation NCHW-contiguous once, at its first
//     BatchNorm, and every layer after it is NCHW). A channel's elements
//     are N planes of H*W contiguous values; one warp owns one channel of
//     a block's 8 and walks a chunk of rows (planes, or plane segments
//     where a small batch leaves too few blocks), so neighbouring warps
//     read neighbouring planes. The plan (ops/kernels/batchnorm_kernel.py,
//     bn_plan) comes from the shape (N, C, H*W) alone: chunks of rows so
//     that the grid is about 1,024 blocks, one wave of 8 per SM.
//   * 16-byte vector loads and stores: a plane's unaligned head and tail
//     (fewer than 8 elements of bf16) take scalar accesses, the rest
//     vectors. A thread issues 4 loads before it uses them (4 rows at
//     once), so small planes (7x7, 14x14) keep as many bytes in flight as
//     large.
//   * No atomics: the reduction passes write per-(channel, chunk) partial
//     sums; the finalize kernel adds them in a fixed order (a warp per
//     channel, then a fixed shuffle tree), so a run repeats bit for bit.
//   * The backward saves nothing of the activations but x (and, behind the
//     residual epilogue, the output, which the next layer holds anyway):
//     it recomputes xhat and the ReLU mask from x with the saved
//     per-channel mean and rstd.
// What is left: the train forward reads x twice and the backward x and dy
// twice (the statistics must be whole before the apply), so they can come
// no closer to the one-read bound than about 2/3 and 3/5 of it.
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;  // channels a block, a warp each
constexpr int kThreads = kWarps * 32;
constexpr int kRows = 4;   // rows a warp walks at once

// Element types: raw storage and the exact conversions to and from float.
struct F32 {
  using raw = uint32_t;
  static __device__ __forceinline__ float get(raw r) {
    return __uint_as_float(r);
  }
  static __device__ __forceinline__ raw put(float v) {
    return __float_as_uint(v);
  }
};
struct BF16 {
  using raw = uint16_t;
  static __device__ __forceinline__ float get(raw r) {
    return __uint_as_float(static_cast<uint32_t>(r) << 16);
  }
  static __device__ __forceinline__ raw put(float v) {
    return __bfloat16_as_ushort(__float2bfloat16_rn(v));
  }
};
struct F16 {
  using raw = uint16_t;
  static __device__ __forceinline__ float get(raw r) {
    return __half2float(__ushort_as_half(r));
  }
  static __device__ __forceinline__ raw put(float v) {
    return __half_as_ushort(__float2half_rn(v));
  }
};

// K elements of T as 32-bit words: one 16-byte vector (K = 16 / size) or
// one element (K = 1). Two 16-bit elements share a word, so a vector of
// bf16 takes 4 registers, not 8.
template <class T, int K>
struct Pack {
  using R = typename T::raw;
  static constexpr int W = (K * sizeof(R) + 3) / 4;
  uint32_t w[W];
  __device__ __forceinline__ void load(const R* p) {
    if constexpr (K == 1) {
      w[0] = __ldg(p);
    } else {
      static_assert(K * sizeof(R) == 16, "a vector is 16 bytes");
      const uint4 u = __ldg(reinterpret_cast<const uint4*>(p));
      w[0] = u.x;
      w[1] = u.y;
      w[2] = u.z;
      w[3] = u.w;
    }
  }
  __device__ __forceinline__ float get(int k) const {
    if constexpr (sizeof(R) == 4) return T::get(w[k]);
    return T::get(static_cast<R>(w[k >> 1] >> ((k & 1) * 16)));
  }
  // element k, v rounded to T; a fresh Pack is filled in order k = 0, 1,
  // ..., an even k starting its word
  __device__ __forceinline__ void set(int k, float v) {
    if constexpr (sizeof(R) == 4) {
      w[k] = T::put(v);
    } else if (k & 1) {
      w[k >> 1] |= static_cast<uint32_t>(T::put(v)) << 16;
    } else {
      w[k >> 1] = T::put(v);
    }
  }
  __device__ __forceinline__ void store(R* p) const {
    if constexpr (K == 1)
      p[0] = static_cast<R>(w[0]);
    else
      *reinterpret_cast<uint4*>(p) = make_uint4(w[0], w[1], w[2], w[3]);
  }
};

// ---- the layout -----------------------------------------------------------

// Planes (NCHW-contiguous): a channel's elements are N planes of HW. A warp
// owns a channel; a row is segment r % segs of image r / segs's plane.
struct PlaneGeo {
  int C, HW, segs, seg_len, rows, rpc, chunks;
};

// Walk rows [r0, r1) of channel c: for each element range, op.load then
// op.use, kRows rows at a time, every lane's loads issued before its uses.
// The rows' unaligned heads and tails form one list of single elements and
// their aligned middles one list of vectors, each spread over the lanes, so
// a small plane (7x7: up to 14 of its 49 elements outside its vectors)
// costs the warp few steps.
template <class Op>
__device__ __forceinline__ void walk_planes(Op& op, const PlaneGeo& g, int c,
                                            int r0, int r1, int lane) {
  constexpr int V = Op::V;
  using Vec = typename Op::template In<V>;
  using One = typename Op::template In<1>;
  for (int r = r0; r < r1; r += kRows) {
    size_t vb[kRows];  // each row's first vector
    int head[kRows], pre[kRows + 1], spre[kRows + 1];
    pre[0] = spre[0] = 0;
#pragma unroll
    for (int u = 0; u < kRows; ++u) {
      int hd = 0, nv = 0, tl = 0;
      size_t base = 0;
      if (r + u < r1) {
        const int n = g.segs == 1 ? r + u : (r + u) / g.segs;
        const int s = r + u - n * g.segs;
        base = (static_cast<size_t>(n) * g.C + c) * g.HW +
               static_cast<size_t>(s) * g.seg_len;
        const int len = min(g.seg_len, g.HW - s * g.seg_len);
        hd = min(len, static_cast<int>((V - base % V) % V));
        nv = (len - hd) / V;
        tl = len - hd - nv * V;
      }
      vb[u] = base + hd;
      head[u] = hd;
      pre[u + 1] = pre[u] + nv;
      spre[u + 1] = spre[u] + hd + tl;
    }
    // the heads and tails: element e of the list is row u's head element
    // e - spre[u], or past its head, its tail element
    const int singles = spre[kRows];
    for (int e0 = lane; e0 < singles; e0 += 64) {
      One in[2];
      size_t at[2];
#pragma unroll
      for (int k = 0; k < 2; ++k) {
        const int e = e0 + 32 * k;
        size_t first = vb[0], tail = vb[0] + static_cast<size_t>(pre[1]) * V;
        int off = e, hd = head[0];
#pragma unroll
        for (int q = 1; q < kRows; ++q) {
          if (e >= spre[q]) {
            first = vb[q];
            tail = vb[q] + static_cast<size_t>(pre[q + 1] - pre[q]) * V;
            off = e - spre[q];
            hd = head[q];
          }
        }
        at[k] = off < hd ? first - hd + off : tail + (off - hd);
        if (e < singles) op.load(in[k], at[k]);
      }
#pragma unroll
      for (int k = 0; k < 2; ++k)
        if (e0 + 32 * k < singles) op.use(in[k], at[k]);
    }
    // the vectors of the kRows rows as one list
    const int total = pre[kRows];
    for (int s0 = lane; s0 < total; s0 += 32 * kRows) {
      Vec in[kRows];
      size_t at[kRows];
#pragma unroll
      for (int k = 0; k < kRows; ++k) {
        const int sl = s0 + 32 * k;
        size_t start = vb[0];
        int off = sl;
#pragma unroll
        for (int q = 1; q < kRows; ++q) {
          if (sl >= pre[q]) {
            start = vb[q];
            off = sl - pre[q];
          }
        }
        at[k] = start + static_cast<size_t>(off) * V;
        if (sl < total) op.load(in[k], at[k]);
      }
#pragma unroll
      for (int k = 0; k < kRows; ++k)
        if (s0 + 32 * k < total) op.use(in[k], at[k]);
    }
  }
}

__device__ __forceinline__ float2 warp_sum(float2 v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    v.x += __shfl_xor_sync(0xffffffffu, v.x, o);
    v.y += __shfl_xor_sync(0xffffffffu, v.y, o);
  }
  return v;
}

// y = (x - mean) * mul + beta, rounded to T: the chain's three kernels.
template <class T>
__device__ __forceinline__ float bn_value(float x, float mean, float mul,
                                          float beta) {
  return T::get(
      T::put(__fadd_rn(__fmul_rn(__fsub_rn(x, mean), mul), beta)));
}

// ---- the passes, as operations on an access of K elements of a channel ---

// Everything a pass reads besides the activations.
struct Params {
  const void* x;
  const void* res;
  const void* dy;
  const void* out;
  void* y;
  void* dx;
  void* dres;
  const float* mean;   // the batch's or the running mean
  const float* scale;  // the apply's rstd * gamma, or (eval) running_var
  const float* rstd;
  const float* gamma;
  const float* beta;
  const float* coef;   // the backward's [a | b | k], [3, C]
  float* rstd_out;     // eval: rsqrt(running_var + eps), or null
  float eps;
  int eval, C;
};

// Train statistics: float32 sum x and sum x^2 of the warp's channel.
template <class T>
struct StatsOp {
  using R = typename T::raw;
  static constexpr int V = 16 / sizeof(R);
  template <int K>
  struct In {
    Pack<T, K> x;
  };
  const R* x;
  float s1 = 0.f, s2 = 0.f;
  __device__ __forceinline__ void init(const Params& p, int) {
    x = static_cast<const R*>(p.x);
  }
  template <int K>
  __device__ __forceinline__ void load(In<K>& in, size_t i) const {
    in.x.load(x + i);
  }
  template <int K>
  __device__ __forceinline__ void use(const In<K>& in, size_t) {
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const float v = in.x.get(k);
      s1 += v;
      s2 = fmaf(v, v, s2);
    }
  }
};

// The apply (train, and the eval form): y with the epilogue.
template <class T, bool RELU, bool RES>
struct ApplyOp {
  using R = typename T::raw;
  static constexpr int V = 16 / sizeof(R);
  template <int K>
  struct In {
    Pack<T, K> x;
    Pack<T, RES ? K : 1> r;
  };
  const R* x;
  const R* res;
  R* y;
  float mean, mul, beta;
  __device__ __forceinline__ void init(const Params& p, int c) {
    x = static_cast<const R*>(p.x);
    res = static_cast<const R*>(p.res);
    y = static_cast<R*>(p.y);
    mean = p.mean[c];
    beta = p.beta[c];
    mul = p.scale[c];
    if (p.eval) {  // scale is the running variance
      const float rs = rsqrtf(__fadd_rn(mul, p.eps));
      if (p.rstd_out != nullptr && blockIdx.y == 0) p.rstd_out[c] = rs;
      mul = __fmul_rn(rs, p.gamma[c]);
    }
  }
  template <int K>
  __device__ __forceinline__ void load(In<K>& in, size_t i) const {
    in.x.load(x + i);
    if constexpr (RES) in.r.load(res + i);
  }
  template <int K>
  __device__ __forceinline__ void use(const In<K>& in, size_t i) const {
    Pack<T, K> o;
#pragma unroll
    for (int k = 0; k < K; ++k) {
      float v = bn_value<T>(in.x.get(k), mean, mul, beta);
      if constexpr (RES) v = T::get(T::put(__fadd_rn(v, in.r.get(k))));
      if constexpr (RELU) v = v < 0.f ? 0.f : v;  // NaN stays NaN
      o.set(k, v);
    }
    o.store(y + i);
  }
};

// The backward's inputs and the gradient behind the epilogue: dy where
// the output was live. The ReLU's mask is PyTorch's threshold_backward
// rule (zero where out <= 0), from the saved output behind the residual,
// else recomputed from x.
template <class T, bool RELU, bool RES>
struct BwdIn {
  using R = typename T::raw;
  static constexpr int V = 16 / sizeof(R);
  template <int K>
  struct In {
    Pack<T, K> x, d;
    Pack<T, RELU && RES ? K : 1> o;
  };
  const R* x;
  const R* dy;
  const R* out;
  float mean, rstd, mul, beta;
  __device__ __forceinline__ void init_in(const Params& p, int c) {
    x = static_cast<const R*>(p.x);
    dy = static_cast<const R*>(p.dy);
    out = static_cast<const R*>(p.out);
    mean = p.mean[c];
    rstd = p.rstd[c];
    mul = __fmul_rn(rstd, p.gamma[c]);
    beta = p.beta[c];
  }
  template <int K>
  __device__ __forceinline__ void load(In<K>& in, size_t i) const {
    in.x.load(x + i);
    in.d.load(dy + i);
    if constexpr (RELU && RES) in.o.load(out + i);
  }
  template <int K>
  __device__ __forceinline__ float grad(const In<K>& in, int k,
                                        float xf) const {
    const float d = in.d.get(k);
    if constexpr (RELU && RES) return in.o.get(k) <= 0.f ? 0.f : d;
    if constexpr (RELU)
      return bn_value<T>(xf, mean, mul, beta) <= 0.f ? 0.f : d;
    return d;
  }
  __device__ __forceinline__ float xhat(float xf) const {
    return __fmul_rn(__fsub_rn(xf, mean), rstd);
  }
};

// The backward's reduction: sum g and sum g * xhat of the warp's channel.
template <class T, bool RELU, bool RES>
struct BwdReduceOp : BwdIn<T, RELU, RES> {
  using Base = BwdIn<T, RELU, RES>;
  template <int K>
  using In = typename Base::template In<K>;
  float s1 = 0.f, s2 = 0.f;
  __device__ __forceinline__ void init(const Params& p, int c) {
    this->init_in(p, c);
  }
  template <int K>
  __device__ __forceinline__ void use(const In<K>& in, size_t) {
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const float xf = in.x.get(k);
      const float gk = this->grad(in, k, xf);
      s1 += gk;
      s2 = fmaf(gk, this->xhat(xf), s2);
    }
  }
};

// The backward's apply: dx = a g + b + k xhat (eval: a g), and the
// residual's gradient g.
template <class T, bool RELU, bool RES>
struct BwdApplyOp : BwdIn<T, RELU, RES> {
  using Base = BwdIn<T, RELU, RES>;
  using R = typename T::raw;
  template <int K>
  using In = typename Base::template In<K>;
  R* dx;
  R* dres;
  float a, b, kx;
  int train;
  __device__ __forceinline__ void init(const Params& p, int c) {
    this->init_in(p, c);
    dx = static_cast<R*>(p.dx);
    dres = static_cast<R*>(p.dres);
    train = !p.eval;
    a = p.coef[c];
    b = p.coef[p.C + c];
    kx = p.coef[2 * p.C + c];
  }
  template <int K>
  __device__ __forceinline__ void use(const In<K>& in, size_t i) const {
    Pack<T, K> o, rg;
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const float xf = in.x.get(k);
      const float gk = this->grad(in, k, xf);
      o.set(k, train ? fmaf(a, gk, fmaf(kx, this->xhat(xf), b))
                     : __fmul_rn(a, gk));
      rg.set(k, gk);
    }
    o.store(dx + i);
    if constexpr (RES) rg.store(dres + i);
  }
};

// ---- the kernels ----------------------------------------------------------

// A reduction pass (statistics, or the backward's sums): each warp's
// channel sums over its chunk to partial[c][chunk].
template <class Op>
__global__ void __launch_bounds__(kThreads)
    plane_reduce_kernel(Params p, PlaneGeo g, float2* __restrict__ partial) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int c = blockIdx.x * kWarps + warp;
  if (c >= g.C) return;
  Op op;
  op.init(p, c);
  const int r0 = blockIdx.y * g.rpc;
  walk_planes(op, g, c, r0, min(r0 + g.rpc, g.rows), lane);
  const float2 s = warp_sum(make_float2(op.s1, op.s2));
  if (lane == 0) partial[static_cast<size_t>(c) * g.chunks + blockIdx.y] = s;
}

// An elementwise pass (the apply, the backward's apply).
template <class Op>
__global__ void __launch_bounds__(kThreads)
    plane_map_kernel(Params p, PlaneGeo g) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int c = blockIdx.x * kWarps + warp;
  if (c >= g.C) return;
  Op op;
  op.init(p, c);
  const int r0 = blockIdx.y * g.rpc;
  walk_planes(op, g, c, r0, min(r0 + g.rpc, g.rows), lane);
}

// The sums of channel c's chunks, in a fixed order, on every lane.
__device__ __forceinline__ float2 chunk_sum(const float2* partial, int c,
                                            int chunks, int lane) {
  float2 s = make_float2(0.f, 0.f);
  for (int j = lane; j < chunks; j += 32) {
    const float2 p = partial[static_cast<size_t>(c) * chunks + j];
    s.x += p.x;
    s.y += p.y;
  }
  return warp_sum(s);
}

// Train finalize (a warp a channel): the statistics, the running averages
// and the apply's factor rstd * gamma.
__global__ void __launch_bounds__(kThreads)
    bn_finalize_kernel(const float2* __restrict__ partial, int C, int chunks,
                       float inv_count, const float* __restrict__ gamma,
                       float* __restrict__ rmean, float* __restrict__ rvar,
                       float* __restrict__ mean, float* __restrict__ rstd,
                       float* __restrict__ varg, float* __restrict__ mul,
                       float eps, float momentum, float alpha) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int c = blockIdx.x * kWarps + warp;
  if (c >= C) return;
  const float2 s = chunk_sum(partial, c, chunks, lane);
  if (lane != 0) return;
  const float m = __fmul_rn(s.x, inv_count);
  const float raw = __fsub_rn(__fmul_rn(s.y, inv_count), __fmul_rn(m, m));
  const float v = raw < 0.f ? 0.f : raw;  // clamp_min: NaN stays NaN
  const float rs = rsqrtf(__fadd_rn(v, eps));
  mean[c] = m;
  rstd[c] = rs;
  varg[c] = raw >= 0.f ? 1.f : 0.f;  // clamp_min's gradient mask
  mul[c] = __fmul_rn(rs, gamma[c]);
  // mul_(momentum) then add_(batch, alpha=1 - momentum): PyTorch's add
  // with alpha is one fused multiply-add
  rmean[c] = fmaf(m, alpha, __fmul_rn(rmean[c], momentum));
  rvar[c] = fmaf(v, alpha, __fmul_rn(rvar[c], momentum));
}

// Backward finalize (a warp a channel): dbeta, dgamma, and the apply's
// factors [a | b | k] ([3, C]); varg null in eval, where b = k = 0.
__global__ void __launch_bounds__(kThreads)
    bn_bwd_finalize_kernel(const float2* __restrict__ partial, int C,
                           int chunks, float inv_count,
                           const float* __restrict__ gamma,
                           const float* __restrict__ rstd,
                           const float* __restrict__ varg,
                           float* __restrict__ dgamma,
                           float* __restrict__ dbeta,
                           float* __restrict__ coef) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int c = blockIdx.x * kWarps + warp;
  if (c >= C) return;
  const float2 s = chunk_sum(partial, c, chunks, lane);
  if (lane != 0) return;
  dbeta[c] = s.x;
  dgamma[c] = s.y;
  const float a = __fmul_rn(rstd[c], gamma[c]);
  coef[c] = a;
  coef[C + c] = varg ? -a * s.x * inv_count : 0.f;
  coef[2 * C + c] = varg ? -a * s.y * inv_count * varg[c] : 0.f;
}

// ---- host side -----------------------------------------------------------

bool aligned(const void* p) {
  return p == nullptr || reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

// A plan (ops/kernels/batchnorm_kernel.py, bn_plan) as 4 ints:
// [segs, seg_len, rows_per_chunk, chunks].
struct Plan {
  PlaneGeo pg;
  dim3 grid;
};

bool make_plan(int n, int c, int hw, const int* a, Plan* out) {
  if (a == nullptr || n < 1 || c < 1 || hw < 1 ||
      static_cast<int64_t>(n) * hw > (1 << 30))
    return false;
  const int segs = a[0], seg_len = a[1], rpc = a[2], chunks = a[3];
  if (segs < 1 || seg_len < 1 || rpc < 1 ||
      static_cast<int64_t>(segs) * seg_len < hw ||
      static_cast<int64_t>(segs - 1) * seg_len >= hw ||
      static_cast<int64_t>(n) * segs > (1 << 30))
    return false;
  const int rows = n * segs;
  if (chunks != (rows + rpc - 1) / rpc || chunks > 65535) return false;
  out->pg = PlaneGeo{c, hw, segs, seg_len, rows, rpc, chunks};
  out->grid = dim3((c + kWarps - 1) / kWarps, chunks);
  return true;
}

dim3 channel_grid(int c) { return dim3((c + kWarps - 1) / kWarps); }

template <template <class> class Op, class T>
cudaError_t launch_reduce(const Plan& pl, const Params& p, float2* partial,
                          cudaStream_t st) {
  plane_reduce_kernel<Op<T>><<<pl.grid, kThreads, 0, st>>>(p, pl.pg,
                                                          partial);
  return cudaGetLastError();
}

template <template <class> class Op, class T>
cudaError_t launch_map(const Plan& pl, const Params& p, cudaStream_t st) {
  plane_map_kernel<Op<T>><<<pl.grid, kThreads, 0, st>>>(p, pl.pg);
  return cudaGetLastError();
}

// The epilogue as template arguments: none, ReLU, residual and ReLU.
template <bool RELU, bool RES>
struct Epi {
  template <class T>
  using Apply = ApplyOp<T, RELU, RES>;
  template <class T>
  using Reduce = BwdReduceOp<T, RELU, RES>;
  template <class T>
  using BwdApply = BwdApplyOp<T, RELU, RES>;
};

template <class T>
cudaError_t launch_apply(int relu, bool res, const Plan& pl, const Params& p,
                         cudaStream_t st) {
  if (relu && res)
    return launch_map<Epi<true, true>::Apply, T>(pl, p, st);
  if (relu) return launch_map<Epi<true, false>::Apply, T>(pl, p, st);
  return launch_map<Epi<false, false>::Apply, T>(pl, p, st);
}

template <class E, class T>
cudaError_t launch_bwd_e(const Plan& pl, const Params& p, float2* partial,
                         const float* varg, float* dgamma, float* dbeta,
                         float* coef, float inv_count, cudaStream_t st) {
  cudaError_t err = launch_reduce<E::template Reduce, T>(pl, p, partial, st);
  if (err != cudaSuccess) return err;
  bn_bwd_finalize_kernel<<<channel_grid(p.C), kThreads, 0, st>>>(
      partial, p.C, pl.pg.chunks, inv_count, p.gamma, p.rstd, varg, dgamma,
      dbeta, coef);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return launch_map<E::template BwdApply, T>(pl, p, st);
}

template <class T>
cudaError_t launch_bwd(int relu, bool res, const Plan& pl, const Params& p,
                       float2* partial, const float* varg, float* dgamma,
                       float* dbeta, float* coef, float inv_count,
                       cudaStream_t st) {
  if (relu && res)
    return launch_bwd_e<Epi<true, true>, T>(pl, p, partial, varg, dgamma,
                                            dbeta, coef, inv_count, st);
  if (relu)
    return launch_bwd_e<Epi<true, false>, T>(pl, p, partial, varg, dgamma,
                                             dbeta, coef, inv_count, st);
  return launch_bwd_e<Epi<false, false>, T>(pl, p, partial, varg, dgamma,
                                            dbeta, coef, inv_count, st);
}

constexpr int kF32 = 0, kBF16 = 1, kF16 = 2;

// Runs launch<T>(...) for the dtype code.
template <class F>
cudaError_t by_dtype(int dtype, F&& f) {
  if (dtype == kF32) return f(F32{});
  if (dtype == kBF16) return f(BF16{});
  return f(F16{});
}

}  // namespace

// Train forward: statistics, finalize, apply (3 launches). x, residual
// (or null) and y [N, C, H, W] of dtype (0 float32, 1 bfloat16, 2
// float16), NCHW-contiguous and 16-byte aligned; gamma, beta, the running
// averages (moved in place) and the outputs mean, rstd, varg (1 where the
// variance's gradient flows, 0 where its clamp bit) and mul (rstd * gamma)
// float32 [C]; partial float32 [C, chunks, 2] scratch. relu: 1 for the
// ReLU epilogue; a residual needs it.
extern "C" int sia_bn_train_forward(
    const void* x, const void* residual, void* y, const void* gamma,
    const void* beta, void* rmean, void* rvar, void* mean, void* rstd,
    void* varg, void* mul, void* partial, int dtype, int relu, int n, int c,
    int hw, const int* plan, float eps, float momentum, float alpha,
    void* stream) {
  Plan pl;
  if (dtype < kF32 || dtype > kF16 || !make_plan(n, c, hw, plan, &pl) ||
      !aligned(x) || !aligned(residual) || !aligned(y) ||
      (residual && !relu))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float2* part = static_cast<float2*>(partial);
  Params p{};
  p.x = x;
  p.res = residual;
  p.y = y;
  p.mean = static_cast<const float*>(mean);
  p.scale = static_cast<const float*>(mul);
  p.gamma = static_cast<const float*>(gamma);
  p.beta = static_cast<const float*>(beta);
  p.eps = eps;
  p.C = c;
  cudaError_t err = by_dtype(dtype, [&](auto t) {
    return launch_reduce<StatsOp, decltype(t)>(pl, p, part, st);
  });
  if (err != cudaSuccess) return static_cast<int>(err);
  const float inv_count =
      1.0f / static_cast<float>(static_cast<int64_t>(n) * hw);
  bn_finalize_kernel<<<channel_grid(c), kThreads, 0, st>>>(
      part, c, pl.pg.chunks, inv_count, p.gamma, static_cast<float*>(rmean),
      static_cast<float*>(rvar), static_cast<float*>(mean),
      static_cast<float*>(rstd), static_cast<float*>(varg),
      static_cast<float*>(mul), eps, momentum, alpha);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  err = by_dtype(dtype, [&](auto t) {
    return launch_apply<decltype(t)>(relu, residual != nullptr, pl, p, st);
  });
  return static_cast<int>(err);
}

// Eval forward: the apply alone with the running statistics (1 launch);
// rstd (or null) float32 [C] gets rsqrt(running_var + eps) for the
// backward.
extern "C" int sia_bn_eval_forward(
    const void* x, const void* residual, void* y, const void* gamma,
    const void* beta, const void* rmean, const void* rvar, void* rstd,
    int dtype, int relu, int n, int c, int hw, const int* plan, float eps,
    void* stream) {
  Plan pl;
  if (dtype < kF32 || dtype > kF16 || !make_plan(n, c, hw, plan, &pl) ||
      !aligned(x) || !aligned(residual) || !aligned(y) ||
      (residual && !relu))
    return static_cast<int>(cudaErrorInvalidValue);
  Params p{};
  p.x = x;
  p.res = residual;
  p.y = y;
  p.mean = static_cast<const float*>(rmean);
  p.scale = static_cast<const float*>(rvar);
  p.gamma = static_cast<const float*>(gamma);
  p.beta = static_cast<const float*>(beta);
  p.rstd_out = static_cast<float*>(rstd);
  p.eps = eps;
  p.eval = 1;
  p.C = c;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return static_cast<int>(by_dtype(dtype, [&](auto t) {
    return launch_apply<decltype(t)>(relu, residual != nullptr, pl, p, st);
  }));
}

// Backward: reduction, finalize, apply (3 launches). dy, x, out (the
// forward's output, read behind the residual epilogue with its ReLU; else
// null) and dx, dres (the residual's gradient, or null) [N, C, H, W],
// NCHW-contiguous; mean, rstd, varg (null: the eval form) [C]; dgamma,
// dbeta float32 [C]; partial [C, chunks, 2] and coef [3, C] float32
// scratch.
extern "C" int sia_bn_backward(
    const void* x, const void* dy, const void* out, const void* mean,
    const void* rstd, const void* varg, const void* gamma, const void* beta,
    void* dx, void* dres, void* dgamma, void* dbeta, void* partial,
    void* coef, int dtype, int relu, int n, int c, int hw, const int* plan,
    void* stream) {
  Plan pl;
  const bool res = dres != nullptr;
  if (dtype < kF32 || dtype > kF16 || !make_plan(n, c, hw, plan, &pl) ||
      !aligned(x) || !aligned(dy) || !aligned(out) || !aligned(dx) ||
      !aligned(dres) || (res && (!relu || out == nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  Params p{};
  p.x = x;
  p.dy = dy;
  p.out = out;
  p.dx = dx;
  p.dres = dres;
  p.mean = static_cast<const float*>(mean);
  p.rstd = static_cast<const float*>(rstd);
  p.gamma = static_cast<const float*>(gamma);
  p.beta = static_cast<const float*>(beta);
  p.coef = static_cast<const float*>(coef);
  p.eval = varg == nullptr;
  p.C = c;
  const float inv_count =
      1.0f / static_cast<float>(static_cast<int64_t>(n) * hw);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return static_cast<int>(by_dtype(dtype, [&](auto t) {
    return launch_bwd<decltype(t)>(
        relu, res, pl, p, static_cast<float2*>(partial),
        static_cast<const float*>(varg), static_cast<float*>(dgamma),
        static_cast<float*>(dbeta), static_cast<float*>(coef), inv_count,
        st);
  }));
}
