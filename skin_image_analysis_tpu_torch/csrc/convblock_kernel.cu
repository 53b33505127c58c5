// Fused phase-packed conv0 for Hopper (sm_90a): forward and weight grad.
//
// Replaces the Pallas TPU kernels of the JAX package's
// skin_image_analysis_tpu/ops/pallas/convblock_kernel.py: `_fwd_call`
// (body `_fwd_kernel`) and `_dw_call` (body `_dw_kernel`). The flagship's
// first block, conv 7x7 3->32 SAME + bias + ReLU + 2x2 max-pool, runs as the
// pool-phase-packed stride-2 conv: an 8x8 kernel with 4*32 = 128 output
// channels (packed channel p*32 + co holds pool phase p = 2*di + dj), i.e.
// per image the GEMM Y[128, positions] = Wp[128, 192] @ P[192, positions]
// with P the 8x8x3 patches of x at stride 2, zero padding (3, 4) per axis.
//
// Forward (phase_conv0_fwd_kernel): Y + bias, the max over the four phase
// groups, and the uint8 selector (the first phase equal to the max, or 4
// where the max is <= 0); stores the bf16 pooled value max(m, 0) and the
// selector. Y (the 4x pre-pool output) never reaches device memory.
// Weight grad (phase_conv0_dw_kernel): per image the float32 partial
// dWp[128, 192] = dY4 @ P^T, dY4[p*32 + co] = g[co] * (sel[co] == p). The
// caller sums the partials over images (no atomics: the sum repeats from
// run to run).
//
// Bounds on an H100 SXM (3.35 TB/s, 989 TFLOP/s bf16 dense) at B = 256,
// 224 x 224 (minimal conv FLOPs 2 * B * 224^2 * 32 * 147 = 120.8 G):
//   forward, f32 x: 462.4 MB (x 154.1 + pooled 205.5 + sel 102.8)
//                   -> 0.138 ms, memory bound;
//   forward, bf16 x: 385.4 MB -> 0.115 ms < 120.8 GFLOP -> 0.122 ms,
//                   compute bound;
//   dW: 410.5 MB (x bf16 77.1 + g 205.5 + sel 102.8 + partials 25.2)
//                   -> 0.123 ms, memory bound (only the selected phase of
//                   each live window carries gradient, so the FLOPs the data
//                   need are at most a quarter of the dense 120.8 G). The
//                   kernel computes the masked product densely, 2 * 128 *
//                   192 * 12,544 * 256 = 158 GFLOP -> 0.160 ms at the bf16
//                   peak: that floor, not the bytes, bounds this design.
//
// Design. The TPU kernel builds the 192 patch rows from 48 pre-shifted,
// lane-padded space-to-depth planes in VMEM because Mosaic has no strided
// lane slices; a GPU thread loads the element it needs, so none of that is
// carried over and x is read planar, rounded to bf16 on the way into shared
// memory. Both kernels run the product on the tensor cores (bf16 in,
// float32 accumulation), the forward by wgmma, dW by mma.sync.m16n8k16:
//   * Inside the kernels the contraction index is k' = c*64 + a*8 + b
//     (channel, packed tap row, packed tap column); the global packed
//     weight and the dW partials keep the JAX layout k = (a*8 + b)*3 + c.
//   * Shared memory holds a band of padded x rows, column s = input column
//     + 3, so the two bf16 of taps (b, b+1) for even b are one aligned
//     32-bit word.
//   * Forward: persistent blocks (the Python plan, fwd_plan: tiles of 16
//     pooled rows at 224, one block of two warpgroups an SM), each walking
//     a contiguous range of (image, band) tiles. A block lays the packed
//     weight out once, as the wgmma B operand (K-major, no swizzle). Per
//     tile, the raw x rows (float32 or bf16, as they are in x) land in an
//     aligned stage by 16-byte cp.async issued one tile ahead, so they fly
//     while the previous tile's products run (element loads when x is not
//     16-byte aligned or W is not a multiple of 16 bytes); one pass converts
//     them into the shifted bf16 band, 8 bytes a store.
//   * The forward product is wgmma.m64n128k16 with A = the patches from
//     registers (one 32-bit shared load a tap pair, positions as rows) and
//     B = the resident weight. A warpgroup owns 64 positions x all 128
//     packed channels, so a thread's accumulator columns co, co + 32, co +
//     64, co + 96 are the four phases of one output channel: the max and the
//     selector are taken in registers. The accumulators start at the bias.
//     Each warpgroup keeps a second chunk's products in flight while it
//     runs the first one's epilogue (two sets of 64 accumulators, 219-244
//     registers a thread, no spill).
//   * The forward epilogue has no division: a band's positions are
//     contiguous in each output plane. A warp transposes its 16 positions x
//     32 channels of pooled and selector values through two small shared
//     tiles (stmatrix.trans), then each lane writes one 16-byte (pooled)
//     and one 8-byte (sel) store a channel, 32 bytes of a plane for two
//     lanes (element stores when W/2 % 8 != 0).
//   * What bounds the forward now (an H100 80GB HBM3 at its 1980 MHz
//     clock, B = 256, 224 x 224: 0.44 ms against the 0.138 ms bytes bound
//     and the 0.160 ms of the dense product): not the bytes. Built without
//     its epilogue it takes 0.35 ms, without the per-chunk A loads 0.41,
//     and the band work alone 0.11. So the products run at about half the
//     tensor cores' rate, one dependent chain of 12 wgmma and a wait per
//     64-position chunk on two warpgroups an SM, and the epilogue and the
//     band work add to that on 8 warps that cannot hide their latency.
//   * dW: a cluster of S blocks per image (the Python plan, dw_plan: the
//     most, up to 8, that keep the grid within one block an SM, since one
//     block keeps an SM busy; S = 1 at B = 256, 8 at B = 16 on an H100).
//     Block r takes a contiguous share of the image's bands of 2 pooled
//     rows. Per band, the x rows land in shared memory by
//     16-byte cp.async (input column 0 at shared column 8, so every row is
//     16-byte aligned; bytewise when W % 8 != 0), and g and sel by 16- and
//     8-byte loads that expand them, once per element, into the masked
//     cotangent dY4[p*32 + co][t] = g * (sel == p) (scalar loads when
//     W/2 % 8 != 0). Then every warp reads its A fragments with ldmatrix
//     (no mask work in the MMA loop) and accumulates an 8 m-tile x 3
//     n-tile slice (all 128 packed channels x 24 k', 96 float32 a thread).
//     Copy, wait, compute, with no ring. An SM holds two blocks (256
//     threads at 128 registers with no spill, 100 KB of shared memory: 16
//     warps an SM), yet two resident blocks take as long as their work one
//     after the other: one block already keeps the SM busy.
//   * dW reduction over DSMEM, deterministic: after its bands each block
//     parks its partial (rows padded to 196 floats) in its own shared
//     memory, reusing the staging buffer; after a cluster barrier block r
//     sums packed-channel rows [128r/S, 128(r+1)/S) over the S peers in
//     rank order and stores them in the JAX layout with 16-byte stores; a
//     second cluster barrier keeps every tile alive until it has been read.
//     No atomics: two calls give bit-identical partials.
//   * What bounds dW now: the 8 warps of a block each load the same 128 A
//     rows, and the B operand takes four 16-bit shared loads a register
//     (positions t, t+1 are two input columns apart): about 2 shared
//     wavefronts an MMA, with mma.sync itself below the card's wgmma peak.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace cg = cooperative_groups;

namespace {

using sia::cp_async16;
using sia::cp_async_wait_all;
using sia::kMaxCluster;
using sia::ldmatrix_x4;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kCout = 32;
constexpr int kPC = 4 * kCout;  // 128 packed channels
constexpr int kK = 192;         // contraction depth 8 * 8 * 3
constexpr int kDead = 4;

// The forward kernel's shared memory: the packed weight (the wgmma B
// operand), the bias, each warp's epilogue tiles, the bf16 x band and the
// raw stage. The weight is in the canonical K-major layout without swizzle
// that a wgmma descriptor addresses: core matrices of 8 packed channels x
// 8 k' (128 contiguous bytes, a channel's 8 k' in 16 B); the 16 core
// matrices of one k' chunk follow each other (kWSbo apart), and the next
// 8 k' start kWLbo later.
constexpr int kWSbo = 128;                   // next 8 packed channels
constexpr int kWLbo = kPC / 8 * kWSbo;       // next 8 k' (2048 B)
constexpr int kWBytes = kK / 8 * kWLbo;      // 49,152
constexpr int kEpStride = 24;                // bf16 row (48 B) of a tile
constexpr int kEpBytes = kWarps * 2 * kCout * kEpStride * 2;  // 24,576

__device__ __forceinline__ void mma_bf16(float* d, const uint32_t* a,
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t lds32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// Forward band geometry, shared by the kernel and its launch. A tile is
// (image, band of `rows` pooled rows); its x band holds input rows
// 2*i0 - 3 .. 2*i0 + 2*rows + 2 of each channel. In the bf16 band, shared
// column s holds input column s - 3 (zero outside the image), so taps
// (b, b+1) for even b are one aligned 32-bit word; its row stride is a
// multiple of 8. The raw stage holds the same rows as they are in x
// (float32 or bf16, input column 0 at column 0) at a row stride of
// fwd_raw_stride elements, sized for float32.
__host__ __device__ __forceinline__ int fwd_xrows(int rows) {
  return 2 * rows + 6;
}
__host__ __device__ __forceinline__ int fwd_band_stride(int w) {
  return (w + 6 + 7) / 8 * 8;
}
__host__ __device__ __forceinline__ int fwd_raw_stride(int w) {
  return (w + 7) / 8 * 8;
}
__host__ __device__ __forceinline__ size_t fwd_smem_bytes(int rows, int w) {
  const size_t xrows = 3 * (size_t)fwd_xrows(rows);
  return kWBytes + 4 * (size_t)kPC + kEpBytes +
         xrows * (2 * (size_t)fwd_band_stride(w) + 4 * (size_t)fwd_raw_stride(w));
}

// Issue the copies of one tile's x rows into the raw stage: a warp a row,
// 16-byte cp.async when x_vec (W a multiple of 16 bytes of InT and x
// 16-byte aligned), element loads otherwise. Rows outside the image are
// skipped: fill_band zeroes them.
template <typename InT>
__device__ __forceinline__ void stage_rows(const InT* __restrict__ ximg,
                                           InT* raw, int i0, int xrows, int h,
                                           int w, int wr, int x_vec,
                                           int warp, int lane) {
  constexpr int kVec = 16 / sizeof(InT);
  for (int c = 0; c < 3; ++c) {
    for (int sr = warp; sr < xrows; sr += kWarps) {
      const int y = 2 * i0 - 3 + sr;
      if (y < 0 || y >= h) continue;
      const InT* s = ximg + ((int64_t)c * h + y) * w;
      InT* d = raw + (c * xrows + sr) * wr;
      if (x_vec) {
        for (int j = lane; j < w / kVec; j += 32) {
          cp_async16(d + kVec * j, s + kVec * j);
        }
      } else {
        for (int j = lane; j < w; j += 32) d[j] = s[j];
      }
    }
  }
}

// Four raw elements (input columns 4q .. 4q + 3) of one row as float,
// zero where the column is outside the image.
__device__ __forceinline__ void raw4(const float* row, int q, int w,
                                     float* v) {
  if (q < 0 || 4 * q >= w) {
    v[0] = v[1] = v[2] = v[3] = 0.0f;
    return;
  }
  const float4 f = reinterpret_cast<const float4*>(row)[q];
  v[0] = f.x;
  v[1] = 4 * q + 1 < w ? f.y : 0.0f;
  v[2] = 4 * q + 2 < w ? f.z : 0.0f;
  v[3] = 4 * q + 3 < w ? f.w : 0.0f;
}
__device__ __forceinline__ void raw4(const __nv_bfloat16* row, int q, int w,
                                     float* v) {
  if (q < 0 || 4 * q >= w) {
    v[0] = v[1] = v[2] = v[3] = 0.0f;
    return;
  }
  const uint2 u = reinterpret_cast<const uint2*>(row)[q];
  v[0] = __uint_as_float(u.x << 16);
  v[1] = 4 * q + 1 < w ? __uint_as_float(u.x & 0xffff0000u) : 0.0f;
  v[2] = 4 * q + 2 < w ? __uint_as_float(u.y << 16) : 0.0f;
  v[3] = 4 * q + 3 < w ? __uint_as_float(u.y & 0xffff0000u) : 0.0f;
}

// Convert a landed raw stage into the bf16 band: lane m of a row writes
// band columns 4m .. 4m + 3 (input columns 4m - 3 .. 4m) with one 8-byte
// store, from raw chunks m - 1 and m; rows outside the image are zero.
template <typename InT>
__device__ __forceinline__ void fill_band(const InT* raw, __nv_bfloat16* xs,
                                          int i0, int xrows, int h, int w,
                                          int wr, int rs, int warp,
                                          int lane) {
  for (int c = 0; c < 3; ++c) {
    for (int sr = warp; sr < xrows; sr += kWarps) {
      const int y = 2 * i0 - 3 + sr;
      const bool live = y >= 0 && y < h;
      const InT* s = raw + (c * xrows + sr) * wr;
      uint2* d = reinterpret_cast<uint2*>(xs + (c * xrows + sr) * rs);
      for (int m = lane; m < rs / 4; m += 32) {
        float a[4] = {0.0f, 0.0f, 0.0f, 0.0f}, b[4] = {0.0f, 0.0f, 0.0f, 0.0f};
        if (live) {
          raw4(s, m - 1, w, a);
          raw4(s, m, w, b);
        }
        d[m] = make_uint2(pack_bf16x2(a[1], a[2]), pack_bf16x2(a[3], b[0]));
      }
    }
  }
}

// Byte offset of (packed channel pc, k') in the weight.
__device__ __forceinline__ int w_offset(int pc, int kp) {
  return (kp >> 3) * kWLbo + (pc >> 3) * kWSbo + (pc & 7) * 16 + (kp & 7) * 2;
}

// Shared-memory matrix descriptor of the weight for k-step ks (k' = 16ks
// .. 16ks + 15): start address, leading byte offset (the next 8 k') and
// stride byte offset (the next 8 channels), each in 16-byte units; layout
// 0, no swizzle.
__device__ __forceinline__ uint64_t w_desc(unsigned wbase, int ks) {
  const unsigned addr = wbase + ks * 2 * kWLbo;
  return (uint64_t)((addr >> 4) & 0x3FFF) | ((uint64_t)(kWLbo >> 4) << 16) |
         ((uint64_t)(kWSbo >> 4) << 32);
}

// D[64 x 128] (+)= A[64 x 16] B[16 x 128]: A from registers in the
// mma.sync A layout (warp w of the warpgroup holds rows 16w .. 16w + 15),
// B by descriptor, float32 accumulators in the wgmma D layout.
__device__ __forceinline__ void wgmma_m64n128k16(float* d, const uint32_t* a,
                                                 uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      " %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31,"
      " %32, %33, %34, %35, %36, %37, %38, %39,"
      " %40, %41, %42, %43, %44, %45, %46, %47,"
      " %48, %49, %50, %51, %52, %53, %54, %55,"
      " %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
// Wait for this warpgroup's products; the empty asm keeps every read of
// the accumulators after the wait.
__device__ __forceinline__ void wgmma_wait(float* acc) {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+f"(acc[i])::"memory");
}

// Four 8x8 b16 matrices from registers (the mma.sync C layout) into shared
// memory transposed; lanes 8i .. 8i + 7 give the row addresses of matrix i.
__device__ __forceinline__ void stmatrix_x4_trans(unsigned addr,
                                                  const uint32_t* r) {
  asm volatile(
      "stmatrix.sync.aligned.m8n8.x4.trans.shared.b16 [%0], {%1, %2, %3, %4};\n"
      ::"r"(addr), "r"(r[0]), "r"(r[1]), "r"(r[2]), "r"(r[3])
      : "memory");
}

// Global stores under a predicate, without a branch.
__device__ __forceinline__ void st16_if(void* p, uint4 v, bool pred) {
  asm volatile(
      "{\n.reg .pred q;\nsetp.ne.b32 q, %5, 0;\n"
      "@q st.global.v4.b32 [%0], {%1, %2, %3, %4};\n}\n"
      ::"l"(p), "r"(v.x), "r"(v.y), "r"(v.z), "r"(v.w), "r"((int)pred)
      : "memory");
}
__device__ __forceinline__ void st8_if(void* p, uint2 v, bool pred) {
  asm volatile(
      "{\n.reg .pred q;\nsetp.ne.b32 q, %3, 0;\n"
      "@q st.global.v2.b32 [%0], {%1, %2};\n}\n"
      ::"l"(p), "r"(v.x), "r"(v.y), "r"((int)pred)
      : "memory");
}

// Persistent blocks: the grid is at most blocks-an-SM x SMs, and block g
// takes tiles [g*T/G, (g+1)*T/G) of the T = B * ceil(H/2 / rows) tiles in
// image-major order, so its consecutive bands are mostly of one image and
// their 6 halo rows come from L2. The weight and the bias are staged once
// per block. Per tile: the raw stage (issued while the previous tile's
// products ran) is waited for and converted into the bf16 band, the next
// tile's copies are issued, then each warpgroup walks every other chunk
// of 64 positions. kVecOut: W/2 % 8 == 0 and the outputs aligned, so each
// warp stores 16 positions x 32 channels with 16- and 8-byte stores.
template <typename InT, bool kVecOut>
__global__ void __launch_bounds__(kThreads, 1)
    phase_conv0_fwd_kernel(const InT* __restrict__ x,
                           const __nv_bfloat16* __restrict__ wp,
                           const float* __restrict__ bias4,
                           __nv_bfloat16* __restrict__ pooled,
                           uint8_t* __restrict__ sel, int batch, int h, int w,
                           int rows, int x_vec) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* bs = reinterpret_cast<float*>(smem + kWBytes);
  __nv_bfloat16* ep = reinterpret_cast<__nv_bfloat16*>(bs + kPC);
  __nv_bfloat16* xs = ep + kEpBytes / 2;
  const int rs = fwd_band_stride(w);
  const int wr = fwd_raw_stride(w);
  const int xrows = fwd_xrows(rows);
  const int plane = xrows * rs;
  InT* raw = reinterpret_cast<InT*>(xs + 3 * plane);

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int gid = lane >> 2, tig = lane & 3;
  const int wg = warp >> 2;  // warpgroup: every other 64-position chunk
  const int w4 = warp & 3;   // its 16 positions of the chunk
  const int h2 = h / 2, w2 = w / 2;
  const int64_t hw2 = (int64_t)h2 * w2;
  const int nb = (h2 + rows - 1) / rows;
  const int tiles = batch * nb;
  const int t_lo = (int)((int64_t)blockIdx.x * tiles / gridDim.x);
  const int t_hi = (int)((int64_t)(blockIdx.x + 1) * tiles / gridDim.x);

  // the packed weight, once: JAX order k = (a*8 + b)*3 + c -> k' = c*64 +
  // a*8 + b, one (packed channel, tap) pair of three channels a thread;
  // then made visible to the tensor cores' reads (the async proxy)
  for (int i = tid; i < kPC * 64; i += kThreads) {
    const int pc = i >> 6, ab = i & 63;
    const __nv_bfloat16* s = wp + pc * kK + ab * 3;
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      *reinterpret_cast<__nv_bfloat16*>(smem + w_offset(pc, c * 64 + ab)) = s[c];
    }
  }
  if (tid < kPC) bs[tid] = bias4[tid];
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  const unsigned wbase = static_cast<unsigned>(__cvta_generic_to_shared(smem));

  // this warp's epilogue tiles, pooled then selector: [32 co][16 positions]
  __nv_bfloat16* ptile = ep + warp * 2 * kCout * kEpStride;
  __nv_bfloat16* stile = ptile + kCout * kEpStride;
  const unsigned pt_addr = static_cast<unsigned>(
      __cvta_generic_to_shared(ptile + lane * kEpStride));
  const unsigned st_addr = static_cast<unsigned>(
      __cvta_generic_to_shared(stile + lane * kEpStride));

  if (t_lo < t_hi) {
    const int img = t_lo / nb;
    stage_rows(x + (int64_t)img * 3 * h * w, raw, (t_lo - img * nb) * rows,
               xrows, h, w, wr, x_vec, warp, lane);
  }
  uint32_t af[kK / 16][4];
  float acc0[64], acc1[64];
  for (int tile = t_lo; tile < t_hi; ++tile) {
    const int img = tile / nb;
    const int i0 = (tile - img * nb) * rows;
    cp_async_wait_all();
    __syncthreads();  // the raw stage has landed; the band is consumed
    fill_band(raw, xs, i0, xrows, h, w, wr, rs, warp, lane);
    __syncthreads();  // the band is ready; the raw stage is free
    if (tile + 1 < t_hi) {
      const int nimg = (tile + 1) / nb;
      stage_rows(x + (int64_t)nimg * 3 * h * w, raw,
                 (tile + 1 - nimg * nb) * rows, xrows, h, w, wr, x_vec, warp,
                 lane);
    }

    const int npos = min(rows, h2 - i0) * w2;
    const int nchunks = (npos + 63) / 64;
    // output offset of band position 0 in channel co: obase + co * hw2
    const int64_t obase = (int64_t)img * kCout * hw2 + (int64_t)i0 * w2;
    // kVecOut: lane stores channels co_k = lane/2 + 16k, positions 8*(lane
    // % 2) .. + 7 of its warp's 16
    const int64_t o_lane = obase + (lane >> 1) * hw2 + 16 * w4 + 8 * (lane & 1);

    // chunk q's products into acc: the A fragments (rows = positions t_a,
    // t_a + 8, one 32-bit word of taps (b, b+1) each), the bias as the
    // accumulators' start, then 12 k-steps on the tensor cores
    auto issue = [&](float* acc, int q) {
      const int t_a = q * 64 + 16 * w4 + gid;
      int boff[2];
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int t = min(t_a + 8 * hh, npos - 1);
        const int r = t / w2;
        const int j = t - r * w2;
        boff[hh] = 2 * r * rs + 2 * j + 2 * tig;
      }
      // k' = ks*16 + kk: channel ks/4, tap row 2*(ks%4) (+1 for kk >= 8),
      // tap column kk % 8
#pragma unroll
      for (int ks = 0; ks < kK / 16; ++ks) {
        const __nv_bfloat16* xp = xs + (ks >> 2) * plane + 2 * (ks & 3) * rs;
        af[ks][0] = lds32(xp + boff[0]);
        af[ks][1] = lds32(xp + boff[1]);
        af[ks][2] = lds32(xp + boff[0] + rs);
        af[ks][3] = lds32(xp + boff[1] + rs);
      }
      // accumulator 4*(4p + i) + {0, 1, 2, 3}: packed channel p*32 + 8i +
      // 2*tig + {0, 1}, positions t_a, t_a + 8
#pragma unroll
      for (int p = 0; p < 4; ++p) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float2 b = *reinterpret_cast<const float2*>(
              bs + p * kCout + 8 * i + 2 * tig);
          acc[4 * (4 * p + i) + 0] = b.x;
          acc[4 * (4 * p + i) + 1] = b.y;
          acc[4 * (4 * p + i) + 2] = b.x;
          acc[4 * (4 * p + i) + 3] = b.y;
        }
      }
      wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < kK / 16; ++ks) {
        wgmma_m64n128k16(acc, af[ks], w_desc(wbase, ks));
      }
      wgmma_commit();
    };

    // chunk q's pool, selector and stores from acc: columns co, co + 32,
    // co + 64, co + 96 of a thread are the four phases of channel co
    auto epilogue = [&](const float* acc, int q) {
      const int t_a = q * 64 + 16 * w4 + gid;
      uint32_t pw[2][4], sw[2][4];
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          float v[2];
          uint32_t s2[2];
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            float y[4];
#pragma unroll
            for (int p = 0; p < 4; ++p) y[p] = acc[4 * (4 * p + i) + 2 * hh + e];
            const float m = fmaxf(fmaxf(y[0], y[1]), fmaxf(y[2], y[3]));
            uint32_t s = m == y[0] ? 0 : m == y[1] ? 1 : m == y[2] ? 2 : 3;
            if (!(m > 0.0f)) s = kDead;
            v[e] = fmaxf(m, 0.0f);
            s2[e] = s;
            if (!kVecOut) {
              const int t = t_a + 8 * hh;
              if (t < npos) {
                const int64_t o = obase + (8 * i + 2 * tig + e) * hw2 + t;
                pooled[o] = __float2bfloat16_rn(v[e]);
                sel[o] = static_cast<uint8_t>(s);
              }
            }
          }
          pw[hh][i] = pack_bf16x2(v[0], v[1]);
          sw[hh][i] = s2[0] | (s2[1] << 16);
        }
      }
      if (kVecOut) {
        // transposed into the [co][position] tiles, then 8 positions of a
        // channel a lane: one 16-byte store of pooled, one 8-byte of sel
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          stmatrix_x4_trans(pt_addr + 16 * hh, pw[hh]);
          stmatrix_x4_trans(st_addr + 16 * hh, sw[hh]);
        }
        __syncwarp();
        const bool live = q * 64 + 16 * w4 + 8 * (lane & 1) < npos;
#pragma unroll
        for (int k = 0; k < 2; ++k) {
          const int row = ((lane >> 1) + 16 * k) * kEpStride + 8 * (lane & 1);
          const uint4 pv = *reinterpret_cast<const uint4*>(ptile + row);
          const uint4 sv = *reinterpret_cast<const uint4*>(stile + row);
          const int64_t o = o_lane + 16 * k * hw2 + q * 64;
          st16_if(pooled + o, pv, live);
          st8_if(sel + o,
                 make_uint2(__byte_perm(sv.x, sv.y, 0x6420),
                            __byte_perm(sv.z, sv.w, 0x6420)),
                 live);
        }
        __syncwarp();
      }
    };

    // two chunks an iteration: the second chunk's products run on the
    // tensor cores while the first one's epilogue runs (a second chunk past
    // the band computes on clamped positions and stores nothing). The
    // epilogue's stores are predicated, not branched, so ptxas keeps the
    // products asynchronous (it warns, C7518, where it cannot).
    for (int q = wg; q < nchunks; q += 4) {
      issue(acc0, q);
      wgmma_wait(acc0);
      issue(acc1, q + 2);
      epilogue(acc0, q);
      wgmma_wait(acc1);
      epilogue(acc1, q + 2);
    }
  }
}

// ---- weight grad ----------------------------------------------------------

// Warp tile of the dW kernel: kDwWM m-tiles (16 packed channels each) by
// kDwWN n-tiles (8 k' each) of the [128, 192] partial.
constexpr int kDwWM = 8;
constexpr int kDwWN = 3;
constexpr int kDwWarpsM = kPC / 16 / kDwWM;
constexpr int kDwWarps = kDwWarpsM * (kK / 8 / kDwWN);
constexpr int kDwThreads = 32 * kDwWarps;
constexpr int kDwMinBlocks = kDwThreads <= 256 ? 2 : 1;
constexpr int kDwXOff = 8;        // shared column of input column 0
constexpr int kDwTile = kK + 4;   // float row of the reduction tile

// dW band geometry, shared by the kernel and its launch: a band
// of `rows` pooled rows has tpad positions (a multiple of 16); the x band
// holds 2*rows + 6 input rows of each channel at a row stride of xstride
// bf16 (a multiple of 8, so rows stay 16-byte aligned), input column x at
// shared column x + kDwXOff, zero from kDwXOff - 3 and up to w + 2.
__host__ __device__ __forceinline__ int dw_tpad(int rows, int w) {
  return (rows * (w / 2) + 15) / 16 * 16;
}
__host__ __device__ __forceinline__ int dw_xstride(int w) {
  return (w + kDwXOff + 3 + 7) / 8 * 8;
}
__host__ __device__ __forceinline__ int dw_xrows(int rows) {
  return 2 * rows + 6;
}
// Staging (masked cotangent, x band, position table) and the reduction
// tile reuse one buffer: the larger of the two.
__host__ __device__ __forceinline__ size_t dw_smem_bytes(int rows, int w) {
  const int tpad = dw_tpad(rows, w);
  const size_t staging =
      2 * ((size_t)kPC * (tpad + 8) + 3 * (size_t)dw_xrows(rows) * dw_xstride(w)) +
      4 * (size_t)tpad;
  const size_t tile = 4 * (size_t)kPC * kDwTile;
  return staging > tile ? staging : tile;
}

// Grid (S, B), a cluster of S blocks per image. Block r of image b takes
// bands [r*nb/S, (r+1)*nb/S) of `rows` pooled rows (nb bands in all),
// accumulates its partial of dWp[128, 192] in registers, parks it in its
// own shared memory, and after a cluster barrier sums packed-channel rows
// [128r/S, 128(r+1)/S) over the S blocks in rank order into dwp[b] (JAX
// layout k = (a*8 + b)*3 + c).
__global__ void __launch_bounds__(kDwThreads, kDwMinBlocks)
    phase_conv0_dw_kernel(const __nv_bfloat16* __restrict__ x,
                          const __nv_bfloat16* __restrict__ g,
                          const uint8_t* __restrict__ sel,
                          float* __restrict__ dwp, int h, int w, int rows,
                          int x_vec, int g_vec) {
  extern __shared__ __align__(16) unsigned char smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int n_blocks = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  const int img = blockIdx.y;
  const int h2 = h / 2, w2 = w / 2;
  const int tpad = dw_tpad(rows, w);
  const int dystride = tpad + 8;  // bf16; 16-byte rows, odd in 16 B units
  const int xstride = dw_xstride(w);
  const int xrows = dw_xrows(rows);
  const int xplane = xrows * xstride;
  __nv_bfloat16* dy = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* xs = dy + kPC * dystride;
  int* tab = reinterpret_cast<int*>(xs + 3 * xplane);
  const unsigned short* xsu = reinterpret_cast<const unsigned short*>(xs);

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int gid = lane >> 2, tig = lane & 3;
  const int m0 = (warp % kDwWarpsM) * kDwWM;  // first m-tile
  const int n0 = (warp / kDwWarpsM) * kDwWN;  // first n-tile

  // offset of band position t in the x band (positions past the band's
  // end read rows that exist or were zeroed; their cotangent is 0)
  for (int t = tid; t < tpad; t += kDwThreads) {
    const int tt = min(t, rows * w2 - 1);
    const int r = tt / w2;
    tab[t] = 2 * r * xstride + 2 * (tt - r * w2);
  }
  // the x band's zero columns, never written again
  for (int row = warp; row < 3 * xrows; row += kDwWarps) {
    __nv_bfloat16* d = xs + row * xstride;
    for (int s = lane; s < xstride - w; s += 32) {
      d[s < kDwXOff ? s : s + w] = __float2bfloat16_rn(0.0f);
    }
  }

  int koff[kDwWN];  // B operand: k' = n*8 + gid, tap (a, b = gid), channel c
#pragma unroll
  for (int nt = 0; nt < kDwWN; ++nt) {
    const int kp = (n0 + nt) * 8 + gid;
    koff[nt] = (kp >> 6) * xplane + ((kp >> 3) & 7) * xstride + gid +
               kDwXOff - 3;
  }
  // ldmatrix row address of this lane in m-tile m0 (A operand)
  const unsigned a_base = static_cast<unsigned>(__cvta_generic_to_shared(
      dy + (m0 * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * dystride +
      (lane >> 4) * 8));

  float acc[kDwWM][kDwWN][4];
#pragma unroll
  for (int mt = 0; mt < kDwWM; ++mt)
#pragma unroll
    for (int nt = 0; nt < kDwWN; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0.0f;

  const __nv_bfloat16* ximg = x + (int64_t)img * 3 * h * w;
  const int nb = (h2 + rows - 1) / rows;
  const int b_lo = rank * nb / n_blocks, b_hi = (rank + 1) * nb / n_blocks;
  for (int band = b_lo; band < b_hi; ++band) {
    const int i0 = band * rows;
    const int npos = min(rows, h2 - i0) * w2;
    __syncthreads();  // the previous band is consumed
    // x band: input rows 2*i0 - 3 .. of each channel, 16-byte copies
    for (int row = warp; row < 3 * xrows; row += kDwWarps) {
      const int c = row / xrows;
      const int y = 2 * i0 - 3 + row - c * xrows;
      __nv_bfloat16* d = xs + row * xstride + kDwXOff;
      if (y >= 0 && y < h) {
        const __nv_bfloat16* s = ximg + ((int64_t)c * h + y) * w;
        if (x_vec) {
          for (int j = lane; j < w / 8; j += 32) cp_async16(d + 8 * j, s + 8 * j);
        } else {
          for (int j = lane; j < w; j += 32) d[j] = s[j];
        }
      } else {
        for (int j = lane; j < w; j += 32) d[j] = __float2bfloat16_rn(0.0f);
      }
    }
    // cotangent: dy[p*32 + co][t] = g[co][t] where sel[co][t] == p, else 0;
    // 8 positions a thread, one 16-byte load of g and 8 bytes of sel
    for (int co = warp; co < kCout; co += kDwWarps) {
      const int64_t o = (((int64_t)img * kCout + co) * h2 + i0) * w2;
      for (int t0 = 8 * lane; t0 < tpad; t0 += 8 * 32) {
        uint32_t gw[4], sw[2];
        if (g_vec && t0 + 8 <= npos) {
          const uint4 gv = __ldg(reinterpret_cast<const uint4*>(g + o + t0));
          const uint2 sv = __ldg(reinterpret_cast<const uint2*>(sel + o + t0));
          gw[0] = gv.x; gw[1] = gv.y; gw[2] = gv.z; gw[3] = gv.w;
          sw[0] = sv.x; sw[1] = sv.y;
        } else {
          const unsigned short* gu = reinterpret_cast<const unsigned short*>(g);
#pragma unroll
          for (int k = 0; k < 4; ++k) {
            const int t = t0 + 2 * k;
            const uint32_t lo = t < npos ? gu[o + t] : 0u;
            const uint32_t hi = t + 1 < npos ? gu[o + t + 1] : 0u;
            gw[k] = lo | (hi << 16);
          }
#pragma unroll
          for (int k = 0; k < 2; ++k) {
            uint32_t word = 0;
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int t = t0 + 4 * k + e;
              const uint32_t v = t < npos ? sel[o + t] : (uint32_t)kDead;
              word |= v << (8 * e);
            }
            sw[k] = word;
          }
        }
#pragma unroll
        for (int p = 0; p < 4; ++p) {
          const uint32_t e0 = __vcmpeq4(sw[0], 0x01010101u * p);
          const uint32_t e1 = __vcmpeq4(sw[1], 0x01010101u * p);
          *reinterpret_cast<uint4*>(dy + (p * kCout + co) * dystride + t0) =
              make_uint4(gw[0] & __byte_perm(e0, 0, 0x1100),
                         gw[1] & __byte_perm(e0, 0, 0x3322),
                         gw[2] & __byte_perm(e1, 0, 0x1100),
                         gw[3] & __byte_perm(e1, 0, 0x3322));
        }
      }
    }
    cp_async_wait_all();
    __syncthreads();

    for (int ks = 0; ks < tpad / 16; ++ks) {
      // B operand: rows (positions) t0, t0 + 1 and t0 + 8, t0 + 9
      const int t0 = ks * 16 + 2 * tig;
      const int p0 = tab[t0], p1 = tab[t0 + 1];
      const int p8 = tab[t0 + 8], p9 = tab[t0 + 9];
      uint32_t bf[kDwWN][2];
#pragma unroll
      for (int nt = 0; nt < kDwWN; ++nt) {
        const unsigned short* xp = xsu + koff[nt];
        bf[nt][0] = (uint32_t)xp[p0] | ((uint32_t)xp[p1] << 16);
        bf[nt][1] = (uint32_t)xp[p8] | ((uint32_t)xp[p9] << 16);
      }
#pragma unroll
      for (int mt = 0; mt < kDwWM; ++mt) {
        uint32_t af[4];
        ldmatrix_x4(af, a_base + 2 * (mt * 16 * dystride + ks * 16));
#pragma unroll
        for (int nt = 0; nt < kDwWN; ++nt) {
          mma_bf16(acc[mt][nt], af, bf[nt][0], bf[nt][1]);
        }
      }
    }
  }

  // park the partial in this block's shared memory, in the JAX column
  // order k = (a*8 + b)*3 + c; C fragment rows pc = (m0 + mt)*16 + gid
  // (+8), columns k' = (n0 + nt)*8 + 2*tig (+1)
  __syncthreads();  // every warp is done with the last band
  float* tile = reinterpret_cast<float*>(smem);
#pragma unroll
  for (int mt = 0; mt < kDwWM; ++mt) {
#pragma unroll
    for (int nt = 0; nt < kDwWN; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int pc = (m0 + mt) * 16 + gid + (e >> 1) * 8;
        const int kp = (n0 + nt) * 8 + 2 * tig + (e & 1);
        tile[pc * kDwTile + (kp & 63) * 3 + (kp >> 6)] = acc[mt][nt][e];
      }
    }
  }
  cluster.sync();  // every block's tile is written and visible
  // rows [r0, r1) of the image's partial: the S tiles summed in rank order
  const int r0 = rank * kPC / n_blocks, r1 = (rank + 1) * kPC / n_blocks;
  float4* out = reinterpret_cast<float4*>(dwp + (int64_t)img * kPC * kK);
  for (int i = tid; i < (r1 - r0) * (kK / 4); i += kDwThreads) {
    const int pc = r0 + i / (kK / 4);
    const int c4 = i - (pc - r0) * (kK / 4);
    const int off = pc * (kDwTile / 4) + c4;
    float4 s = reinterpret_cast<const float4*>(cluster.map_shared_rank(tile, 0))[off];
    for (int q = 1; q < n_blocks; ++q) {
      const float4 v =
          reinterpret_cast<const float4*>(cluster.map_shared_rank(tile, q))[off];
      s.x += v.x;
      s.y += v.y;
      s.z += v.z;
      s.w += v.w;
    }
    out[pc * (kK / 4) + c4] = s;
  }
  cluster.sync();  // no block leaves while a peer still reads its tile
}

template <typename InT>
int launch_fwd(const void* x, const void* wp, const void* bias4, void* pooled,
               void* sel, int batch, int h, int w, int rows, int grid,
               cudaStream_t stream) {
  const int smem = static_cast<int>(fwd_smem_bytes(rows, w));
  // 16-byte copies of x rows need W * sizeof(InT) % 16 == 0; 16-byte stores
  // of pooled and 8-byte stores of sel need W/2 % 8 == 0
  const int x_vec = w % (16 / (int)sizeof(InT)) == 0 &&
                    reinterpret_cast<uintptr_t>(x) % 16 == 0;
  const bool out_vec = (w / 2) % 8 == 0 &&
                       reinterpret_cast<uintptr_t>(pooled) % 16 == 0 &&
                       reinterpret_cast<uintptr_t>(sel) % 8 == 0;
  auto kernel = out_vec ? phase_conv0_fwd_kernel<InT, true>
                        : phase_conv0_fwd_kernel<InT, false>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const InT*>(x), static_cast<const __nv_bfloat16*>(wp),
      static_cast<const float*>(bias4), static_cast<__nv_bfloat16*>(pooled),
      static_cast<uint8_t*>(sel), batch, h, w, rows, x_vec);
  return static_cast<int>(cudaGetLastError());
}

// What the build made of the forward kernel's main form (16-byte stores).
template <typename InT>
int fwd_info(int rows, int w, int* out) {
  const int smem = static_cast<int>(fwd_smem_bytes(rows, w));
  auto kernel = phase_conv0_fwd_kernel<InT, true>;
  cudaFuncAttributes a;
  cudaError_t err = cudaFuncGetAttributes(&a, kernel);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  int blocks = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel,
                                                      kThreads, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  out[0] = a.numRegs;
  out[1] = static_cast<int>(a.localSizeBytes);
  out[2] = kThreads;
  out[3] = blocks;
  out[4] = smem;
  return 0;
}

}  // namespace

// Plain C entry points, loaded with ctypes. Pointers are device pointers to
// contiguous NCHW tensors; H and W are even. Each launches on `stream` and
// returns cudaGetLastError() (0 on success); a width whose shared-memory
// band exceeds the card's limit returns the launch's error.

// x [B, 3, H, W] (float32, or bf16 when x_bf16), wp [128, 192] bf16,
// bias4 [128] float32 -> pooled [B, 32, H/2, W/2] bf16, sel [B, 32, H/2,
// W/2] uint8. The plan: tiles of `rows` pooled rows, `grid` persistent
// blocks (at most the number of tiles), fwd_smem_bytes(rows, w) of
// dynamic shared memory a block; cudaErrorInvalidValue for a plan it does
// not take.
extern "C" int sia_phase_conv0_fwd(const void* x, const void* wp,
                                   const void* bias4, void* pooled, void* sel,
                                   int batch, int h, int w, int x_bf16,
                                   int rows, int grid, void* stream) {
  if (rows < 1 || grid < 1 ||
      grid > (int64_t)batch * ((h / 2 + rows - 1) / rows) ||
      fwd_smem_bytes(rows, w) > INT32_MAX) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (x_bf16) {
    return launch_fwd<__nv_bfloat16>(x, wp, bias4, pooled, sel, batch, h, w,
                                     rows, grid, st);
  }
  return launch_fwd<float>(x, wp, bias4, pooled, sel, batch, h, w, rows, grid,
                           st);
}

// What the build made of the forward kernel (float32 x, or bf16 when
// x_bf16) for tiles of `rows` pooled rows of width `w`: out[0] registers a
// thread, out[1] local (spill) bytes a thread, out[2] threads a block,
// out[3] blocks an SM can hold, out[4] the dynamic shared memory a block,
// fwd_smem_bytes(rows, w).
extern "C" int sia_phase_conv0_fwd_info(int rows, int w, int x_bf16,
                                        int* out) {
  if (rows < 1 || fwd_smem_bytes(rows, w) > INT32_MAX) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return x_bf16 ? fwd_info<__nv_bfloat16>(rows, w, out)
                : fwd_info<float>(rows, w, out);
}

// x [B, 3, H, W] bf16, g [B, 32, H/2, W/2] bf16, sel [B, 32, H/2, W/2]
// uint8 -> dwp [B, 128, 192] float32 per-image partials. The plan: a
// cluster of `cluster` blocks per image (1, 2, 4 or 8), bands of `rows`
// pooled rows, dw_smem_bytes(rows, w) of dynamic shared memory a block;
// cudaErrorInvalidValue for a plan it does not take.
extern "C" int sia_phase_conv0_dw(const void* x, const void* g,
                                  const void* sel, void* dwp, int batch,
                                  int h, int w, int cluster, int rows,
                                  void* stream) {
  if (cluster < 1 || cluster > kMaxCluster || kPC % cluster != 0 ||
      rows < 1 || dw_smem_bytes(rows, w) > INT32_MAX) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int smem_bytes = static_cast<int>(dw_smem_bytes(rows, w));
  cudaError_t err = cudaFuncSetAttribute(
      phase_conv0_dw_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem_bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  // 16-byte copies of x rows need W % 8 == 0, of g and sel W/2 % 8 == 0
  const int x_vec = w % 8 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0;
  const int g_vec = (w / 2) % 8 == 0 &&
                    reinterpret_cast<uintptr_t>(g) % 16 == 0 &&
                    reinterpret_cast<uintptr_t>(sel) % 8 == 0;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cluster, batch, 1);
  cfg.blockDim = dim3(kDwThreads, 1, 1);
  cfg.dynamicSmemBytes = smem_bytes;
  cfg.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(
      &cfg, phase_conv0_dw_kernel, static_cast<const __nv_bfloat16*>(x),
      static_cast<const __nv_bfloat16*>(g), static_cast<const uint8_t*>(sel),
      static_cast<float*>(dwp), h, w, rows, x_vec, g_vec);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// What the build made of the dW kernel for bands of `rows` pooled rows of
// width `w`: out[0] registers a thread, out[1] local (spill) bytes a
// thread, out[2] threads a block, out[3] blocks an SM can hold, out[4]
// the dynamic shared memory a block, dw_smem_bytes(rows, w).
extern "C" int sia_phase_conv0_dw_info(int rows, int w, int* out) {
  if (rows < 1 || dw_smem_bytes(rows, w) > INT32_MAX) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int smem_bytes = static_cast<int>(dw_smem_bytes(rows, w));
  cudaFuncAttributes a;
  cudaError_t err = cudaFuncGetAttributes(&a, phase_conv0_dw_kernel);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaFuncSetAttribute(phase_conv0_dw_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem_bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  int blocks = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &blocks, phase_conv0_dw_kernel, kDwThreads, smem_bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  out[0] = a.numRegs;
  out[1] = static_cast<int>(a.localSizeBytes);
  out[2] = kDwThreads;
  out[3] = blocks;
  out[4] = smem_bytes;
  return 0;
}
