// Depthwise 3x3 convolution for Hopper (sm_90a): stride 1, zero padding 1,
// NCHW-contiguous activations. A forward kernel, one backward kernel that
// writes dx and per-block partial sums of dW in the same pass, and a
// finalize kernel that adds the partial sums in a fixed order.
//
// Replaces no Pallas kernel: the JAX package's models/xception.py
// SeparableConv runs its depthwise conv as a Flax nn.Conv with
// feature_group_count, which XLA lowers. It exists because ATen's NCHW
// conv_depthwise2d kernels (forward, input gradient, weight gradient), one
// output element a thread with scalar loads, held 45% of the Xception
// cell's device time at under a tenth of their bound.
//
// The math is models/resnet.py Conv's on the card before this kernel:
// activations in and out at their type (float32, bfloat16 or float16), the
// float32 [C, 1, 3, 3] weight rounded to that type before use, float32
// accumulation, each output rounded once. dx is the correlation of dy with
// the 180-degree rotated rounded weight; dW = sum over (n, h, w) of
// x[h + ky - 1, w + kx - 1] * dy[h, w], accumulated in float32 and written
// in float32 (ATen rounds its dW to the activations' type on its way back
// to the float32 parameter).
//
// Bound: device-memory bytes. 18 flops an output against 4 bytes moved in
// bf16 (forward: x read, y written; backward: x and dy read, dx written),
// far below the card's 295 flops a byte. At Xception's 34 convs at 299²
// (B=256, bf16) a forward moves 15.0 GB, 4.49 ms at 3.35 TB/s; a backward
// 22.6 GB, 6.7 ms.
//
// Design for that bound:
//   * A block owns one channel, so its 9 weights sit in registers and its
//     dW partial sums are one row of 9. It walks a chunk of the channel's
//     units: a unit is a band of output rows of one plane (a whole plane
//     where it fits a stage). A plane is contiguous in NCHW, so a band with
//     its one-row halo above and below is one contiguous span of x (and of
//     dy). The plan (ops/kernels/depthwise_kernel.py, depthwise_plan) comes
//     from the shape alone: bands of rows for large planes (147², 74²),
//     several whole planes a stage for small ones (37², 19², 10²), and
//     enough chunks that the grid fills the card.
//   * Each stage's spans are copied into shared memory with 16-byte
//     cp.async over aligned chunks, at the same offset mod 16 bytes as in
//     device memory, double-buffered so the next stage's copy overlaps this
//     stage's arithmetic. Rows of 147, 74, 37, 19 and 10 elements are not
//     16-byte aligned, so nothing is copied row by row: a span's ragged ends
//     ride in its first and last aligned chunk (the tensor's end is copied
//     with cp.async's zero fill).
//   * A thread computes a group of V outputs (one 16-byte vector: 8 in
//     bf16), aligned in device memory and so in shared memory, and stores
//     them with one vector store. It reads each of the 3 input rows as V + 2
//     elements from 2 or 3 aligned 16-byte shared loads; the offsets of the
//     rows above and below depend on the width mod V alone, so each kernel
//     is compiled for each width mod V and every element is picked from
//     registers at a constant index. The left and right zero padding is a
//     select on the two outer columns' partial sums; a group whose rows
//     reach outside those copied for its unit (the plane's top and bottom
//     padding, the neighbours in the aligned ends, anything stale) selects
//     those elements to 0, so every product is of the unit's own data.
//   * The backward reads x and dy once: dy's three rows give dx, and x's
//     three rows times dy's centre give the 9 dW products, all in the same
//     pass. The block adds its threads' float32 sums in a fixed tree and
//     writes one [chunks, C, 9] row; the finalize kernel adds the chunks in
//     order. No atomics: dW repeats bit for bit from run to run.
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxGroup = 32;  // units a stage, at most
constexpr int kTables = 3;     // unit tables in flight (stages st-1, st, st+1)

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

// Elements a 16-byte vector.
template <class T>
constexpr int kVec = 16 / static_cast<int>(sizeof(typename T::raw));

// Element i of 16-byte vectors held as 32-bit words (i constant after
// unrolling, so the words stay in registers).
template <class T>
__device__ __forceinline__ float word_elem(const uint32_t* wd, int i) {
  if constexpr (sizeof(typename T::raw) == 4) {
    return T::get(wd[i]);
  } else {
    return T::get(static_cast<typename T::raw>(wd[i >> 1] >> ((i & 1) * 16)));
  }
}

// ---- the plan and a stage's units ----------------------------------------

// The launch plan (depthwise_plan): a unit is a band of `rows` output rows
// of one plane, `bands` a plane; a stage holds `group` units, each in a
// shared-memory slot of `slot` elements; a block walks `stages` stages of
// one channel, `chunks` blocks a channel. lmax and kmax bound a unit's
// 16-byte chunks loaded and output groups.
struct Geo {
  int n, c, h, w;
  int rows, bands, group, stages, chunks, slot, lmax, kmax;
};

// One unit of a stage. Shared index = d + (global index - v) for every
// element copied, so shared memory keeps device memory's 16-byte alignment.
struct Unit {
  int64_t v;   // global index of the virtual element (r0 - 1, 0) of the plane
  int64_t ga;  // global index of the first 16-byte chunk copied
  int d;       // shared index of element v
  int r0, rp;  // first output row and output rows; rp 0: an empty slot
  int nl;      // 16-byte chunks copied
  int g0, ng;  // shared index of the first output group; output groups
  int lo, hi;  // the rows copied, as plane-relative elements [lo, hi)
};
static_assert(sizeof(Unit) == 48, "the plan's shared-memory sizes");

// j / d and j % d for 0 <= j < 2^22, through a float reciprocal and one
// correction step.
struct FastDiv {
  int d;
  float inv;
  __device__ explicit FastDiv(int d_) : d(d_), inv(1.0f / d_) {}
  __device__ __forceinline__ int div(int j, int& r) const {
    int q = __float2int_rz(__int2float_rn(j) * inv);
    r = j - q * d;
    if (r < 0) {
      --q;
      r += d;
    } else if (r >= d) {
      ++q;
      r -= d;
    }
    return q;
  }
};

// Fills slot g's unit: unit u of channel c's units (plane u / bands, band
// u % bands), or an empty slot where u is past the block's last.
template <int V>
__device__ void fill_unit(Unit& e, const Geo& geo, int c, int u, int u_end,
                          int g) {
  if (u >= u_end) {
    e.rp = 0;
    return;
  }
  const int W = geo.w, H = geo.h;
  const int plane = u / geo.bands, b = u - plane * geo.bands;
  const int r0 = b * geo.rows, rp = min(geo.rows, H - r0);
  const int64_t p = (static_cast<int64_t>(plane) * geo.c + c) *
                    (static_cast<int64_t>(H) * W);
  const int64_t v = p + static_cast<int64_t>(r0 - 1) * W;
  const int off = static_cast<int>(((v % V) + V) % V);
  const int d = g * geo.slot + 2 * V + off;
  const int lo = max(r0 - 1, 0), hi = min(r0 + rp + 1, H);
  const int64_t mask = ~static_cast<int64_t>(V - 1);
  const int64_t ga = (p + static_cast<int64_t>(lo) * W) & mask;
  const int64_t gb = (p + static_cast<int64_t>(hi) * W + V - 1) & mask;
  const int o = d + W;  // shared index of the first output
  e.v = v;
  e.ga = ga;
  e.d = d;
  e.r0 = r0;
  e.rp = rp;
  e.nl = static_cast<int>((gb - ga) / V);
  e.g0 = o & ~(V - 1);
  e.ng = (((o + rp * W + V - 1) & ~(V - 1)) - e.g0) / V;
  e.lo = lo * W;
  e.hi = hi * W;
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int bytes) {
  const unsigned sh = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(sh),
               "l"(src), "r"(bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void cp_async_wait_one() {
  asm volatile("cp.async.wait_group 1;\n" ::);
}

// Issues the 16-byte copies of a stage's units from src into buf; the last
// chunk of the tensor copies only what lies inside it and zero-fills the
// rest.
template <class T>
__device__ void issue_copies(const typename T::raw* __restrict__ src,
                             typename T::raw* buf, const Unit* tab,
                             const Geo& geo, const FastDiv& lmax,
                             int64_t total) {
  constexpr int V = kVec<T>;
  constexpr int E = sizeof(typename T::raw);
  for (int j = threadIdx.x; j < geo.group * geo.lmax; j += kThreads) {
    int k;
    const int g = lmax.div(j, k);
    const Unit& e = tab[g];
    if (e.rp == 0 || k >= e.nl) continue;
    const int64_t at = e.ga + static_cast<int64_t>(k) * V;
    const int sh = e.d + static_cast<int>(e.ga - e.v) + k * V;
    const int64_t left = total - at;
    cp_async16(buf + sh, src + at, left >= V ? 16 : static_cast<int>(left) * E);
  }
}

// One output group: V outputs starting at shared index s of unit e.
struct Group {
  int s;       // shared index of output 0 (16-byte aligned)
  int q0;      // output 0's index in the unit's span of rp * W outputs
  int pz, pw;  // the first outputs at column 0 and at column W - 1
  int l0;      // plane-relative element index of output 0
  bool edge;   // some element of its rows lies outside those copied
  bool full;   // all V outputs lie in the span
};

template <int V>
__device__ __forceinline__ Group group_at(const Unit& e, int k, int W,
                                          const FastDiv& wdiv) {
  Group gr;
  gr.s = e.g0 + k * V;
  gr.q0 = gr.s - (e.d + W);
  int c0;
  wdiv.div(gr.q0 + V * W, c0);  // column of output 0 (q0 >= -(V - 1))
  gr.pz = c0 == 0 ? 0 : W - c0;
  gr.pw = W - 1 - c0;
  gr.full = gr.q0 >= 0 && gr.q0 + V <= e.rp * W;
  gr.l0 = e.r0 * W + gr.q0;
  gr.edge = gr.l0 - W - 1 < e.lo || gr.l0 + W + V >= e.hi;
  return gr;
}

// Whether output p of the group has a left (right) neighbour in its row.
__device__ __forceinline__ bool has_left(const Group& gr, int p, int W,
                                         int V) {
  if (W >= V) return p != gr.pz;
  return p < gr.pz || (p - gr.pz) % W != 0;
}
__device__ __forceinline__ bool has_right(const Group& gr, int p, int W,
                                          int V) {
  if (W >= V) return p != gr.pw;
  return p < gr.pw || (p - gr.pw) % W != 0;
}

// Row dy (-1, 0, 1) of the group's input: the V + 2 elements from column
// -1 to column V of outputs 0..V-1, elements outside the rows copied for
// the unit set to 0. Their first element's offset within its 16-byte chunk
// is (dy * W - 1) mod V, a constant of the width mod V (WM).
template <class T, int WM, int DY>
__device__ __forceinline__ void load_run(const typename T::raw* buf,
                                         const Group& gr, const Unit& e, int W,
                                         float (&r)[kVec<T> + 2]) {
  constexpr int V = kVec<T>;
  constexpr int A = ((DY * WM - 1) % V + V) % V;
  constexpr int kChunks = (A + V + 2 + V - 1) / V;
  const typename T::raw* at = buf + (gr.s + DY * W - 1 - A);
  uint32_t wd[kChunks * 4];
#pragma unroll
  for (int i = 0; i < kChunks; ++i) {
    const uint4 u = *reinterpret_cast<const uint4*>(at + i * V);
    wd[4 * i] = u.x;
    wd[4 * i + 1] = u.y;
    wd[4 * i + 2] = u.z;
    wd[4 * i + 3] = u.w;
  }
#pragma unroll
  for (int k = 0; k < V + 2; ++k) r[k] = word_elem<T>(wd, A + k);
  if (gr.edge) {
    const int l = gr.l0 + DY * W - 1;
#pragma unroll
    for (int k = 0; k < V + 2; ++k)
      r[k] = (l + k >= e.lo && l + k < e.hi) ? r[k] : 0.0f;
  }
}

// The three columns' partial sums of a 3x3 correlation of the group's rows
// with weights wt (row-major [3][3]); ROT reads them rotated by 180 degrees
// (the input gradient's). Returns each output's sum with the left and right
// padding applied; centre (if given) gets row 0's centre elements.
template <class T, int WM, bool ROT>
__device__ __forceinline__ void correlate(const typename T::raw* buf,
                                          const Group& gr, const Unit& e,
                                          int W, const float (&wt)[9],
                                          float (&out)[kVec<T>],
                                          float* centre) {
  constexpr int V = kVec<T>;
  float a[V], b[V], c[V];
#pragma unroll
  for (int p = 0; p < V; ++p) a[p] = b[p] = c[p] = 0.0f;
  float r[V + 2];
#define SIA_DW_ROW(DY)                                                  \
  {                                                                     \
    load_run<T, WM, DY>(buf, gr, e, W, r);                              \
    constexpr int i = ROT ? 1 - (DY) : (DY) + 1;                        \
    const float w0 = wt[i * 3 + (ROT ? 2 : 0)], w1 = wt[i * 3 + 1],     \
                w2 = wt[i * 3 + (ROT ? 0 : 2)];                         \
    _Pragma("unroll") for (int p = 0; p < V; ++p) {                     \
      a[p] = fmaf(w0, r[p], a[p]);                                      \
      b[p] = fmaf(w1, r[p + 1], b[p]);                                  \
      c[p] = fmaf(w2, r[p + 2], c[p]);                                  \
    }                                                                   \
    if ((DY) == 0 && centre != nullptr) {                               \
      _Pragma("unroll") for (int p = 0; p < V; ++p) centre[p] = r[p + 1]; \
    }                                                                   \
  }
  SIA_DW_ROW(-1)
  SIA_DW_ROW(0)
  SIA_DW_ROW(1)
#undef SIA_DW_ROW
#pragma unroll
  for (int p = 0; p < V; ++p)
    out[p] = b[p] + (has_left(gr, p, W, V) ? a[p] : 0.0f) +
             (has_right(gr, p, W, V) ? c[p] : 0.0f);
}

// Stores the group's outputs in the unit's span: one vector store where all
// V lie in it, else element by element.
template <class T>
__device__ __forceinline__ void store_group(typename T::raw* __restrict__ dst,
                                            const Group& gr, const Unit& e,
                                            int W,
                                            const float (&out)[kVec<T>]) {
  constexpr int V = kVec<T>;
  const int64_t at = e.v + (gr.s - e.d);
  if (gr.full) {
    uint32_t wd[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      if constexpr (V == 4) {
        wd[i] = T::put(out[i]);
      } else {
        wd[i] = static_cast<uint32_t>(T::put(out[2 * i])) |
                (static_cast<uint32_t>(T::put(out[2 * i + 1])) << 16);
      }
    }
    *reinterpret_cast<uint4*>(dst + at) =
        make_uint4(wd[0], wd[1], wd[2], wd[3]);
    return;
  }
  const int span = e.rp * W;
#pragma unroll
  for (int p = 0; p < V; ++p)
    if (gr.q0 + p >= 0 && gr.q0 + p < span) dst[at + p] = T::put(out[p]);
}

// The channel's 9 weights rounded to the activations' type.
template <class T>
__device__ __forceinline__ void load_weights(const float* __restrict__ w,
                                             int c, float (&wt)[9]) {
#pragma unroll
  for (int i = 0; i < 9; ++i) wt[i] = T::get(T::put(__ldg(w + c * 9 + i)));
}

// The stage loop shared by both kernels: for each stage of block (channel
// blockIdx.x, chunk blockIdx.y), the units' spans of each source copied into
// that source's double buffer, then body(table, buffers, output-group slots)
// once they have landed. Sources: 1 (forward) or 2 (backward), their stage
// buffers one after another behind the unit tables.
template <class T, int S, class Body>
__device__ __forceinline__ void walk_stages(
    const Geo& geo, const typename T::raw* const (&src)[S], uint8_t* smem,
    Body&& body) {
  constexpr int V = kVec<T>;
  using R = typename T::raw;
  Unit* tables = reinterpret_cast<Unit*>(smem);
  R* bufs = reinterpret_cast<R*>(smem + kTables * kMaxGroup * sizeof(Unit));
  const int stage = geo.group * geo.slot;
  const int c = blockIdx.x;
  const int per_block = geo.stages * geo.group;
  const int u_begin = blockIdx.y * per_block;
  const int u_end = min(u_begin + per_block, geo.n * geo.bands);
  const int nst = (u_end - u_begin + geo.group - 1) / geo.group;
  const int64_t total = static_cast<int64_t>(geo.n) * geo.c * geo.h * geo.w;
  const FastDiv lmax(geo.lmax);

  auto fill = [&](int st) {
    if (threadIdx.x < geo.group)
      fill_unit<V>(tables[(st % kTables) * kMaxGroup + threadIdx.x], geo, c,
                   u_begin + st * geo.group + threadIdx.x, u_end,
                   threadIdx.x);
  };
  auto issue = [&](int st) {
    const Unit* tab = tables + (st % kTables) * kMaxGroup;
#pragma unroll
    for (int i = 0; i < S; ++i)
      issue_copies<T>(src[i], bufs + (2 * i + (st & 1)) * stage, tab, geo,
                      lmax, total);
    cp_async_commit();
  };

  fill(0);
  __syncthreads();
  issue(0);
  for (int st = 0; st < nst; ++st) {
    if (st + 1 < nst) fill(st + 1);
    // the next table is visible, and every thread is done with the buffers
    // the next stage's copies overwrite
    __syncthreads();
    if (st + 1 < nst)
      issue(st + 1);
    else
      cp_async_commit();  // an empty group keeps the wait below uniform
    cp_async_wait_one();
    __syncthreads();  // every thread's copies of this stage have landed
    const R* cur[S];
#pragma unroll
    for (int i = 0; i < S; ++i) cur[i] = bufs + (2 * i + (st & 1)) * stage;
    // the stage's units fill its first slots: its output groups are the
    // kmax slots of each but the last, and the last one's own
    const Unit* tab = tables + (st % kTables) * kMaxGroup;
    const int used = min(geo.group, u_end - u_begin - st * geo.group);
    body(tab, cur, (used - 1) * geo.kmax + tab[used - 1].ng);
  }
}

// ---- the kernels -----------------------------------------------------------

// Forward: y = the correlation of x with the rounded weights, each output
// rounded once. Grid (C, chunks), kThreads threads, shared memory
// stage_bytes(geo, 1).
template <class T, int WM>
__global__ void __launch_bounds__(kThreads, 4)
    depthwise3x3_fwd_kernel(const typename T::raw* __restrict__ x,
                            const float* __restrict__ w,
                            typename T::raw* __restrict__ y, Geo geo) {
  extern __shared__ __align__(16) uint8_t dsmem[];
  constexpr int V = kVec<T>;
  using R = typename T::raw;
  float wt[9];
  load_weights<T>(w, blockIdx.x, wt);
  const int W = geo.w;
  const FastDiv kdiv(geo.kmax), wdiv(W);
  const R* const src[1] = {x};
  walk_stages<T, 1>(geo, src, dsmem, [&](const Unit* tab,
                                         const R* const (&buf)[1], int slots) {
    for (int j = threadIdx.x; j < slots; j += kThreads) {
      int k;
      const int g = kdiv.div(j, k);
      const Unit& e = tab[g];
      if (e.rp == 0 || k >= e.ng) continue;
      const Group gr = group_at<V>(e, k, W, wdiv);
      float out[V];
      correlate<T, WM, false>(buf[0], gr, e, W, wt, out, nullptr);
      store_group<T>(y, gr, e, W, out);
    }
  });
}

// Backward: dx = the correlation of dy with the rotated weights, and this
// block's float32 sums of the 9 dW products into partial[blockIdx.y][c][9].
// Grid (C, chunks), shared memory stage_bytes(geo, 2).
template <class T, int WM>
__global__ void __launch_bounds__(kThreads, 3)
    depthwise3x3_bwd_kernel(const typename T::raw* __restrict__ x,
                            const typename T::raw* __restrict__ dy,
                            const float* __restrict__ w,
                            typename T::raw* __restrict__ dx,
                            float* __restrict__ partial, Geo geo) {
  extern __shared__ __align__(16) uint8_t dsmem[];
  constexpr int V = kVec<T>;
  using R = typename T::raw;
  float wt[9], acc[9];
  load_weights<T>(w, blockIdx.x, wt);
#pragma unroll
  for (int i = 0; i < 9; ++i) acc[i] = 0.0f;
  const int W = geo.w;
  const FastDiv kdiv(geo.kmax), wdiv(W);
  const R* const src[2] = {x, dy};
  walk_stages<T, 2>(geo, src, dsmem, [&](const Unit* tab,
                                         const R* const (&buf)[2], int slots) {
    for (int j = threadIdx.x; j < slots; j += kThreads) {
      int k;
      const int g = kdiv.div(j, k);
      const Unit& e = tab[g];
      if (e.rp == 0 || k >= e.ng) continue;
      const Group gr = group_at<V>(e, k, W, wdiv);
      float out[V], gc[V];
      correlate<T, WM, true>(buf[1], gr, e, W, wt, out, gc);
      store_group<T>(dx, gr, e, W, out);
      // dy's centre, 0 outside the span and where a neighbour column is
      // padding
      float gl[V], gr_[V];
#pragma unroll
      for (int p = 0; p < V; ++p) {
        if (!gr.full) {
          const int q = gr.q0 + p;
          gc[p] = (q >= 0 && q < e.rp * W) ? gc[p] : 0.0f;
        }
        gl[p] = has_left(gr, p, W, V) ? gc[p] : 0.0f;
        gr_[p] = has_right(gr, p, W, V) ? gc[p] : 0.0f;
      }
      float r[V + 2];
#define SIA_DW_GRAD(DY)                                   \
  {                                                       \
    load_run<T, WM, DY>(buf[0], gr, e, W, r);             \
    constexpr int i = ((DY) + 1) * 3;                     \
    _Pragma("unroll") for (int p = 0; p < V; ++p) {       \
      acc[i] = fmaf(r[p], gl[p], acc[i]);                 \
      acc[i + 1] = fmaf(r[p + 1], gc[p], acc[i + 1]);     \
      acc[i + 2] = fmaf(r[p + 2], gr_[p], acc[i + 2]);    \
    }                                                     \
  }
      SIA_DW_GRAD(-1)
      SIA_DW_GRAD(0)
      SIA_DW_GRAD(1)
#undef SIA_DW_GRAD
    }
  });
  // the block's sums, in a fixed tree over the threads
  __syncthreads();
  float* red = reinterpret_cast<float*>(dsmem);
#pragma unroll
  for (int i = 0; i < 9; ++i) red[i * kThreads + threadIdx.x] = acc[i];
  __syncthreads();
  for (int half = kThreads / 2; half > 0; half >>= 1) {
    if (threadIdx.x < half) {
#pragma unroll
      for (int i = 0; i < 9; ++i)
        red[i * kThreads + threadIdx.x] +=
            red[i * kThreads + threadIdx.x + half];
    }
    __syncthreads();
  }
  if (threadIdx.x < 9)
    partial[(static_cast<int64_t>(blockIdx.y) * geo.c + blockIdx.x) * 9 +
            threadIdx.x] = red[threadIdx.x * kThreads];
}

// dW[c][k] = the sum of partial[j][c][k] over j = 0..chunks-1, in order.
__global__ void depthwise3x3_dw_finalize_kernel(
    const float* __restrict__ partial, float* __restrict__ dw, int c9,
    int chunks) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= c9) return;
  float s = 0.0f;
  for (int j = 0; j < chunks; ++j)
    s += partial[static_cast<int64_t>(j) * c9 + i];
  dw[i] = s;
}

// ---- host side -------------------------------------------------------------

constexpr int kF32 = 0, kBF16 = 1, kF16 = 2;
constexpr size_t kMaxShared = 227 * 1024;

size_t table_bytes() { return kTables * kMaxGroup * sizeof(Unit); }

// Dynamic shared memory of a kernel reading `sources` tensors of `elem`
// bytes: the unit tables, then two stage buffers a source (the backward's
// also hold its block reduction).
size_t stage_bytes(const Geo& g, int sources, int elem) {
  size_t bufs = static_cast<size_t>(2) * sources * g.group * g.slot * elem;
  if (sources == 2)
    bufs = bufs > kThreads * 9 * sizeof(float) ? bufs
                                               : kThreads * 9 * sizeof(float);
  return table_bytes() + bufs;
}

// The plan from its ints, checked against the shape: every output row in
// exactly one band, the slots large enough for a band with its halo and
// the reads around it, the grid and shared memory within the card's.
bool make_geo(int n, int c, int h, int w, const int* plan, int elem,
              Geo* g) {
  const int V = 16 / elem;
  *g = Geo{n, c, h, w, plan[0], plan[1], plan[2], plan[3], plan[4], plan[5],
           plan[6], plan[7]};
  if (n < 1 || c < 1 || h < 1 || w < 1 || g->rows < 1 || g->bands < 1 ||
      g->group < 1 || g->group > kMaxGroup || g->stages < 1 ||
      g->chunks < 1 || g->chunks > 65535)
    return false;
  if (static_cast<int64_t>(g->rows) * (g->bands - 1) >= h ||
      static_cast<int64_t>(g->rows) * g->bands < h)
    return false;
  if (static_cast<int64_t>(g->chunks) * g->stages * g->group <
      static_cast<int64_t>(n) * g->bands)
    return false;
  const int64_t span = static_cast<int64_t>(g->rows + 2) * w;
  if (g->slot % V != 0 || g->slot < span + 6 * V ||
      g->lmax < (span + 3 * V - 3) / V ||
      g->kmax < (static_cast<int64_t>(g->rows) * w + 3 * V - 3) / V)
    return false;
  if (static_cast<int64_t>(g->group) * g->lmax >= (1 << 22) ||
      static_cast<int64_t>(g->group) * g->kmax >= (1 << 22) ||
      static_cast<int64_t>(g->group) * g->slot >= (1 << 22) ||
      static_cast<int64_t>(h) * w >= (1 << 30))
    return false;
  return stage_bytes(*g, 2, elem) <= kMaxShared;
}

bool aligned(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

// Runs f(integral_constant<WM>) for the width mod V.
template <int V, class F>
cudaError_t with_wm(int wm, F&& f) {
  switch (wm) {
    case 0: return f(std::integral_constant<int, 0>{});
    case 1: return f(std::integral_constant<int, 1>{});
    case 2: return f(std::integral_constant<int, 2>{});
    case 3: return f(std::integral_constant<int, 3>{});
  }
  if constexpr (V == 8) {
    switch (wm) {
      case 4: return f(std::integral_constant<int, 4>{});
      case 5: return f(std::integral_constant<int, 5>{});
      case 6: return f(std::integral_constant<int, 6>{});
      case 7: return f(std::integral_constant<int, 7>{});
    }
  }
  return cudaErrorInvalidValue;
}

// Runs f(T{}) for the dtype code.
template <class F>
cudaError_t by_dtype(int dtype, F&& f) {
  if (dtype == kF32) return f(F32{});
  if (dtype == kBF16) return f(BF16{});
  return f(F16{});
}

template <class K>
cudaError_t allow_shared(K kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

template <class T, int WM>
cudaError_t launch_fwd(const void* x, const float* w, void* y, const Geo& g,
                       cudaStream_t st) {
  using R = typename T::raw;
  const size_t smem = stage_bytes(g, 1, sizeof(R));
  auto kernel = depthwise3x3_fwd_kernel<T, WM>;
  cudaError_t err = allow_shared(kernel, smem);
  if (err != cudaSuccess) return err;
  kernel<<<dim3(g.c, g.chunks), kThreads, smem, st>>>(
      static_cast<const R*>(x), w, static_cast<R*>(y), g);
  return cudaGetLastError();
}

template <class T, int WM>
cudaError_t launch_bwd(const void* x, const void* dy, const float* w,
                       void* dx, float* partial, const Geo& g,
                       cudaStream_t st) {
  using R = typename T::raw;
  const size_t smem = stage_bytes(g, 2, sizeof(R));
  auto kernel = depthwise3x3_bwd_kernel<T, WM>;
  cudaError_t err = allow_shared(kernel, smem);
  if (err != cudaSuccess) return err;
  kernel<<<dim3(g.c, g.chunks), kThreads, smem, st>>>(
      static_cast<const R*>(x), static_cast<const R*>(dy), w,
      static_cast<R*>(dx), partial, g);
  return cudaGetLastError();
}

int elem_of(int dtype) { return dtype == kF32 ? 4 : 2; }

}  // namespace

// Forward (1 launch). x and y [N, C, H, W] of dtype (0 float32, 1
// bfloat16, 2 float16), NCHW-contiguous and 16-byte aligned; w float32
// [C, 1, 3, 3]; plan the 8 ints of depthwise_plan (rows, bands, group,
// stages, chunks, slot, lmax, kmax).
extern "C" int sia_depthwise_forward(const void* x, const void* w, void* y,
                                     int dtype, int n, int c, int h,
                                     int wd, const int* plan,
                                     void* stream) {
  Geo g;
  if (dtype < kF32 || dtype > kF16 ||
      !make_geo(n, c, h, wd, plan, elem_of(dtype), &g) || !aligned(x) ||
      !aligned(y))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* wf = static_cast<const float*>(w);
  return static_cast<int>(by_dtype(dtype, [&](auto t) {
    using T = decltype(t);
    return with_wm<kVec<T>>(wd % kVec<T>, [&](auto wm) {
      return launch_fwd<T, decltype(wm)::value>(x, wf, y, g, st);
    });
  }));
}

// Backward (2 launches: the pass over x and dy, then the finalize). dy, x
// and dx like the forward's x; w float32 [C, 1, 3, 3];
// dw float32 [C, 1, 3, 3]; partial float32 [chunks, C, 9] scratch.
extern "C" int sia_depthwise_backward(const void* x, const void* dy,
                                      const void* w, void* dx, void* dw,
                                      void* partial, int dtype, int n, int c,
                                      int h, int wd, const int* plan,
                                      void* stream) {
  Geo g;
  if (dtype < kF32 || dtype > kF16 ||
      !make_geo(n, c, h, wd, plan, elem_of(dtype), &g) || !aligned(x) ||
      !aligned(dy) || !aligned(dx) || dx == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* wf = static_cast<const float*>(w);
  float* part = static_cast<float*>(partial);
  cudaError_t err = by_dtype(dtype, [&](auto t) {
    using T = decltype(t);
    return with_wm<kVec<T>>(wd % kVec<T>, [&](auto wm) {
      return launch_bwd<T, decltype(wm)::value>(x, dy, wf, dx, part, g, st);
    });
  });
  if (err != cudaSuccess) return static_cast<int>(err);
  const int c9 = c * 9;
  depthwise3x3_dw_finalize_kernel<<<(c9 + kThreads - 1) / kThreads, kThreads,
                                    0, st>>>(part, static_cast<float*>(dw),
                                             c9, g.chunks);
  return static_cast<int>(cudaGetLastError());
}
