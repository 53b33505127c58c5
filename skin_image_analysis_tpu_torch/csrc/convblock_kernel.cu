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
// memory. Both kernels run the product on the tensor cores with
// mma.sync.m16n8k16 (bf16 in, float32 accumulation):
//   * Inside the kernels the contraction index is k' = c*64 + a*8 + b
//     (channel, packed tap row, packed tap column); the global packed
//     weight and the dW partials keep the JAX layout k = (a*8 + b)*3 + c.
//   * Shared memory holds a band of padded x rows, column s = input column
//     + 3, so the two bf16 of taps (b, b+1) for even b are one aligned
//     32-bit word.
//   * A warp owns 16 output channels (co) in all four phases, so every
//     thread ends with the four phase values of its (co, position) pairs in
//     registers and takes the max and the selector there.
//   * Forward: one block per (band of 16 pooled rows, image); the packed
//     weight (48 KB, rows padded to 200 to avoid bank conflicts) and the x
//     band sit in shared memory. Warps: 2 co halves x 4 position groups,
//     each walking 32 positions at a time (4 phases x 4 n-tiles).
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
//   * What bounds it now: the 8 warps of a block each load the same 128 A
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

constexpr int kThreads = 256;
constexpr int kCout = 32;
constexpr int kPC = 4 * kCout;  // 128 packed channels
constexpr int kK = 192;         // contraction depth 8 * 8 * 3
constexpr int kWStride = 200;   // padded shared row of the packed weight
constexpr int kFwdRows = 16;    // pooled rows per forward block
constexpr int kDead = 4;

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

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

// Band geometry: shared row sr holds input row 2 * i0 - 3 + sr, shared
// column s holds input column s - 3, zero outside the image.
__host__ __device__ __forceinline__ int band_row_stride(int w) {
  return w + 6;  // even, since W is even
}
__host__ __device__ __forceinline__ int band_rows(int pooled_rows) {
  return 2 * pooled_rows + 6;
}

template <typename InT>
__device__ void load_band(const InT* __restrict__ x, __nv_bfloat16* xs,
                          int i0, int pooled_rows, int h, int w) {
  const int rs = band_row_stride(w);
  const int rows = band_rows(pooled_rows);
  const int plane = rows * rs;
  for (int idx = threadIdx.x; idx < 3 * plane; idx += blockDim.x) {
    const int c = idx / plane;
    const int rem = idx - c * plane;
    const int sr = rem / rs;
    const int s = rem - sr * rs;
    const int y = 2 * i0 - 3 + sr;
    const int col = s - 3;
    float v = 0.0f;
    if (y >= 0 && y < h && col >= 0 && col < w) {
      v = to_float(x[((int64_t)c * h + y) * w + col]);
    }
    xs[idx] = __float2bfloat16_rn(v);
  }
}

template <typename InT>
__global__ void __launch_bounds__(kThreads, 2)
    phase_conv0_fwd_kernel(const InT* __restrict__ x,
                           const __nv_bfloat16* __restrict__ wp,
                           const float* __restrict__ bias4,
                           __nv_bfloat16* __restrict__ pooled,
                           uint8_t* __restrict__ sel, int h, int w) {
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* ws = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* xs = ws + kPC * kWStride;

  const int img = blockIdx.y;
  const int h2 = h / 2, w2 = w / 2;
  const int i0 = blockIdx.x * kFwdRows;
  const int rows = min(kFwdRows, h2 - i0);
  const int rs = band_row_stride(w);
  const int plane = band_rows(kFwdRows) * rs;

  // packed weight, JAX order k = (a*8 + b)*3 + c -> k' = c*64 + a*8 + b
  for (int idx = threadIdx.x; idx < kPC * kK; idx += blockDim.x) {
    const int pc = idx / kK;
    const int k = idx - pc * kK;
    const int ab = k / 3;
    const int c = k - ab * 3;
    ws[pc * kWStride + c * 64 + ab] = wp[idx];
  }
  load_band(x + (int64_t)img * 3 * h * w, xs, i0, kFwdRows, h, w);
  __syncthreads();

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int gid = lane >> 2, tig = lane & 3;
  const int half = warp & 1;   // output channels half*16 .. half*16 + 15
  const int group = warp >> 1; // position group 0..3
  const int npos = rows * w2;
  const int nchunks = (npos + 31) / 32;

  float bias[4][2];
#pragma unroll
  for (int p = 0; p < 4; ++p) {
    bias[p][0] = bias4[p * kCout + half * 16 + gid];
    bias[p][1] = bias4[p * kCout + half * 16 + gid + 8];
  }

  for (int q = group; q < nchunks; q += 4) {
    float acc[4][4][4];
#pragma unroll
    for (int p = 0; p < 4; ++p)
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[p][nt][e] = 0.0f;

    // B operand: position (column n = gid) of each n-tile
    int boff[4];
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
      const int t = min(q * 32 + nt * 8 + gid, npos - 1);
      const int r = t / w2;
      const int j = t - r * w2;
      boff[nt] = 2 * r * rs + 2 * j + 2 * tig;
    }

#pragma unroll 2
    for (int ks = 0; ks < kK / 16; ++ks) {
      uint32_t af[4][4];
#pragma unroll
      for (int p = 0; p < 4; ++p) {
        const __nv_bfloat16* w0 =
            ws + (p * kCout + half * 16 + gid) * kWStride + ks * 16 + 2 * tig;
        const __nv_bfloat16* w1 = w0 + 8 * kWStride;
        af[p][0] = lds32(w0);
        af[p][1] = lds32(w1);
        af[p][2] = lds32(w0 + 8);
        af[p][3] = lds32(w1 + 8);
      }
      // k' = ks*16 + kk: channel ks/4, tap row 2*(ks%4) (+1 for kk >= 8),
      // tap column kk % 8
      const int koff = (ks >> 2) * plane + 2 * (ks & 3) * rs;
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        const __nv_bfloat16* xp = xs + koff + boff[nt];
        const uint32_t b0 = lds32(xp);
        const uint32_t b1 = lds32(xp + rs);
#pragma unroll
        for (int p = 0; p < 4; ++p) mma_bf16(acc[p][nt], af[p], b0, b1);
      }
    }

    // epilogue: thread holds rows (co) gid, gid + 8 and columns
    // (positions) 2*tig, 2*tig + 1 of each n-tile, in all four phases
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
#pragma unroll
      for (int hi = 0; hi < 2; ++hi) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int t = q * 32 + nt * 8 + 2 * tig + e;
          if (t >= npos) continue;
          float y[4];
#pragma unroll
          for (int p = 0; p < 4; ++p) y[p] = acc[p][nt][hi * 2 + e] + bias[p][hi];
          const float m = fmaxf(fmaxf(y[0], y[1]), fmaxf(y[2], y[3]));
          int s = m == y[0] ? 0 : m == y[1] ? 1 : m == y[2] ? 2 : 3;
          if (!(m > 0.0f)) s = kDead;
          const int r = t / w2;
          const int j = t - r * w2;
          const int co = half * 16 + gid + hi * 8;
          const int64_t o = (((int64_t)img * kCout + co) * h2 + i0 + r) * w2 + j;
          pooled[o] = __float2bfloat16_rn(fmaxf(m, 0.0f));
          sel[o] = static_cast<uint8_t>(s);
        }
      }
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

__device__ __forceinline__ void ldmatrix_x4(uint32_t* r, unsigned addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

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

size_t fwd_smem_bytes(int w) {
  return sizeof(__nv_bfloat16) *
         ((size_t)kPC * kWStride + 3 * (size_t)band_rows(kFwdRows) *
                                       band_row_stride(w));
}

template <typename InT>
int launch_fwd(const void* x, const void* wp, const void* bias4, void* pooled,
               void* sel, int batch, int h, int w, cudaStream_t stream) {
  const size_t smem = fwd_smem_bytes(w);
  cudaError_t err = cudaFuncSetAttribute(
      phase_conv0_fwd_kernel<InT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((h / 2 + kFwdRows - 1) / kFwdRows, batch);
  phase_conv0_fwd_kernel<InT><<<grid, kThreads, smem, stream>>>(
      static_cast<const InT*>(x), static_cast<const __nv_bfloat16*>(wp),
      static_cast<const float*>(bias4), static_cast<__nv_bfloat16*>(pooled),
      static_cast<uint8_t*>(sel), h, w);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C entry points, loaded with ctypes. Pointers are device pointers to
// contiguous NCHW tensors; H and W are even. Each launches on `stream` and
// returns cudaGetLastError() (0 on success); a width whose shared-memory
// band exceeds the card's limit returns the launch's error.

// x [B, 3, H, W] (float32, or bf16 when x_bf16), wp [128, 192] bf16,
// bias4 [128] float32 -> pooled [B, 32, H/2, W/2] bf16, sel [B, 32, H/2,
// W/2] uint8.
extern "C" int sia_phase_conv0_fwd(const void* x, const void* wp,
                                   const void* bias4, void* pooled, void* sel,
                                   int batch, int h, int w, int x_bf16,
                                   void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (x_bf16) {
    return launch_fwd<__nv_bfloat16>(x, wp, bias4, pooled, sel, batch, h, w,
                                     st);
  }
  return launch_fwd<float>(x, wp, bias4, pooled, sel, batch, h, w, st);
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
