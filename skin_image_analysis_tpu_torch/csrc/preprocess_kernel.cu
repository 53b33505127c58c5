// Fused planar-uint8 preprocess for Hopper (sm_90a): one launch, one
// thread-block cluster per image.
//
// Replaces the Pallas TPU kernel `fused_preprocess_planar`
// (skin_image_analysis_tpu/ops/pallas/preprocess_kernel.py, body
// `_kernel_body`). Per image b of the batch: gather arena row rows[b],
// crop a T x T window at (y0, x0), optionally flip it horizontally, apply
// the per-image, per-channel affine scale * u8 + bias, and optionally the
// colour-jitter tail (contrast around the whole-crop mean, Rec.601
// saturation, clip to [0, 1], post affine). Stores float32 or bfloat16,
// either planar [B, C, T, T] or in the 2x2 space-to-depth layout
// [B, 4C, T/2, T/2] with channel index c*4 + 2*dy + dx.
//
// Bound: device-memory bytes. At the train step's shapes (B=256, C=3,
// T=224) the kernel must read the 38.5 MB of cropped uint8 pixels once and
// write 77.1 MB of bf16 (154.1 MB of f32); at the H100 SXM's 3.35 TB/s
// that is 34.5 us (bf16) or 57.5 us (f32). The arithmetic is a few flops
// per byte, far below the card's ridge point.
//
// Design. The TPU kernel holds a whole image in VMEM per grid step, so its
// contrast mean costs no extra pass. A GPU block has at most 227 KB of
// shared memory and the card needs many blocks in flight, so an image is
// split into K row bands, one block each, and the K blocks of an image
// form a cluster:
//   * Load once. Block r copies crop rows [r*R, r*R + R) of every channel
//     into shared memory with 16-byte cp.async, covering the aligned span
//     [x0 & ~15, round_up(x0 + T, 16)) of each row. When a row's base is
//     not 16-byte aligned (S % 16 != 0, or an unaligned arena pointer) the
//     same band is copied with byte loads instead. Nothing else reads
//     device memory but the per-image scalars.
//   * Exact sums over DSMEM (tail only). Each block sums its band's u8
//     values per channel from shared memory into a uint32 (dp4a, warp
//     shuffles, then the block) and writes its C partials into every peer
//     block's shared memory; after a cluster barrier each block adds the K
//     partials. The sum is an exact integer whatever the order of the
//     additions (a band's partial fits 32 bits, since a band fits shared
//     memory; the K partials add up in 64), and its float conversion
//     rounds as the plain version's int64 does (exactly, while
//     T*T*255 < 2^24): the
//     mean is sum_c (scale_c * sum_c / (T*T) + bias_c) / C as before.
//   * Elementwise from shared memory. A thread produces 8 consecutive
//     outputs of one output row for every channel (s2d: reads 2 rows x 16
//     columns and produces 8 outputs in each of the 4C phase planes), so
//     neighbouring threads store neighbouring 16-byte chunks: one 16-byte
//     store per channel for bf16, two for float32. Unaligned 8- and 16-byte
//     reads from shared memory are funnel shifts of aligned words; the flip
//     is a byte reversal (__byte_perm). A row whose output width is not a
//     multiple of 8 takes scalar stores, and its ragged last chunk scalar
//     reads.
//   * Every multiply and add is written with the _rn intrinsics, so the
//     compiler does not contract them into FMAs: the kernel rounds as the
//     plain PyTorch version does, operation for operation. One exception:
//     PyTorch on the card divides by a Python scalar as a multiply by its
//     reciprocal, so the plain version's contrast mean can differ from the
//     kernel's true division in its last bit (float32 outputs within 1e-5,
//     bfloat16 outputs within one ulp).
//   * A row index or crop offset outside the arena stores NaN for the whole
//     image instead of reading out of bounds; all blocks of that cluster
//     decide alike and skip the cluster barriers together.
//   * Byte-to-float conversion is a byte permute into the mantissa of 2^23
//     and a subtraction, both exact and at the full float rate.
// Crops too large for one cluster (the tail above 769 px: a band of 227 KB
// holds at most 74 rows of a 1024 crop, so 1024 needs 16 bands and the
// portable cluster is 8) take a second form, the sums launch: a small
// kernel (crop_sums_kernel, grid K x B) reads each band of the crop from
// device memory and writes its exact uint32 channel sums to a [B, K, 3]
// buffer, and the band kernel then runs without a cluster and adds the K
// partials of its image in rank order instead of exchanging them. The sums
// are integers, so the output is bit-identical to the clustered form's.
// This form reads the crop twice, so it cannot come closer than twice the
// crop's bytes to the function's bound, which counts one read.
// The band plan (K, rows per band R, row pitch, shared-memory bytes, and
// the form) is computed by the Python wrapper
// (ops/kernels/preprocess_kernel.py, band_plan) and passed in: K = 2 with
// the tail, one band per image without it, the fastest of K = 1, 2, 4, 8
// on an H100 (PERF.md), doubled while a band exceeds shared memory. What
// holds the tail at about half its bound there: a block's arithmetic
// (about 50 instructions a pixel) starts only after its whole band has
// landed and the cluster has exchanged its sums, so it overlaps the
// memory traffic only across the two or three blocks resident on an SM.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "hopper.cuh"

namespace cg = cooperative_groups;

namespace {

using sia::cp_async16;
using sia::cp_async_wait_all;
using sia::kMaxCluster;

constexpr int kThreads = 256;

struct Params {
  const uint8_t* arena;
  const int* rows;
  const int* offsets;
  const int* flips;
  const float* scale;
  const float* bias;
  const float* contrast;
  const float* saturation;
  const float* post_scale;
  const float* post_bias;
  unsigned int* sums;  // [B, K, 3] band sums of the sums launch, or null
  void* out;
  int n_rows, channels, size, crop, band_rows, pitch;
};

__device__ __forceinline__ bool in_arena(int row, int y0, int x0, int n_rows,
                                         int size, int crop) {
  return row >= 0 && row < n_rows && y0 >= 0 && y0 <= size - crop &&
         x0 >= 0 && x0 <= size - crop;
}

// Cluster barrier halves (all threads of every block of the cluster).
__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
}

// N bytes (N = 8 or 16) of shared memory from byte offset `off` of the
// 16-byte aligned `base`, as N/4 little-endian words. Reads up to 3 bytes
// past the N (the buffer is padded for that).
template <int N>
__device__ __forceinline__ void lds_bytes(const uint8_t* base, int off,
                                          uint32_t (&o)[N / 4]) {
  const uint32_t* w = reinterpret_cast<const uint32_t*>(base + (off & ~3));
  const unsigned sh = (off & 3) * 8;
  uint32_t x[N / 4 + 1];
#pragma unroll
  for (int i = 0; i <= N / 4; ++i) x[i] = w[i];
#pragma unroll
  for (int i = 0; i < N / 4; ++i) o[i] = __funnelshift_r(x[i], x[i + 1], sh);
}

// The 8*P crop bytes of columns [k0, k0 + 8P) of one band row (shared
// offset `row_off`, crop column 0 at `lead`), in output order: reversed
// when flipped, zero past the crop's width.
template <int P>
__device__ __forceinline__ void gather(const uint8_t* band, int row_off,
                                       int lead, int crop, int k0, bool flip,
                                       uint32_t (&r)[2 * P]) {
  constexpr int W = 8 * P;
  if (k0 + W <= crop) {
    uint32_t v[2 * P];
    lds_bytes<W>(band, row_off + lead + (flip ? crop - W - k0 : k0), v);
#pragma unroll
    for (int i = 0; i < 2 * P; ++i) {
      r[i] = flip ? __byte_perm(v[2 * P - 1 - i], 0, 0x0123) : v[i];
    }
  } else {
#pragma unroll
    for (int i = 0; i < 2 * P; ++i) r[i] = 0;
#pragma unroll
    for (int e = 0; e < W; ++e) {
      const int k = k0 + e;
      if (k < crop) {
        const uint32_t byte = band[row_off + lead + (flip ? crop - 1 - k : k)];
        r[e >> 2] |= byte << (8 * (e & 3));
      }
    }
  }
}

// The 8 bytes of phase dx (the even or odd columns for P = 2).
template <int P>
__device__ __forceinline__ void phase(const uint32_t (&r)[2 * P], int dx,
                                      uint32_t (&e)[2]) {
  if constexpr (P == 1) {
    e[0] = r[0];
    e[1] = r[1];
  } else {
    const unsigned sel = dx ? 0x7531 : 0x6420;
    e[0] = __byte_perm(r[0], r[1], sel);
    e[1] = __byte_perm(r[2], r[3], sel);
  }
}

// Byte i of e as a float: the byte is placed in the mantissa of 2^23
// (one byte permute) and 2^23 subtracted, which is exact; it avoids the
// integer-to-float conversion, which runs at a quarter of the float rate.
__device__ __forceinline__ float byte_at(const uint32_t (&e)[2], int i) {
  const uint32_t bits = __byte_perm(e[i >> 2], 0x4b000000u, 0x7540 + (i & 3));
  return __fsub_rn(__uint_as_float(bits), 8388608.0f);
}

__device__ __forceinline__ uint32_t pack_bf16(float a, float b) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  return *reinterpret_cast<const uint32_t*>(&h);
}

// Store 8 consecutive outputs, or the first n of them one by one.
__device__ __forceinline__ void store8(float* p, const float (&v)[8], int n,
                                       bool vec) {
  if (vec) {
    reinterpret_cast<float4*>(p)[0] = make_float4(v[0], v[1], v[2], v[3]);
    reinterpret_cast<float4*>(p)[1] = make_float4(v[4], v[5], v[6], v[7]);
  } else {
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      if (i < n) p[i] = v[i];
    }
  }
}

__device__ __forceinline__ void store8(__nv_bfloat16* p, const float (&v)[8],
                                       int n, bool vec) {
  if (vec) {
    *reinterpret_cast<uint4*>(p) =
        make_uint4(pack_bf16(v[0], v[1]), pack_bf16(v[2], v[3]),
                   pack_bf16(v[4], v[5]), pack_bf16(v[6], v[7]));
  } else {
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      if (i < n) p[i] = __float2bfloat16_rn(v[i]);
    }
  }
}

// Bytes [lo, hi) of the word holding bytes [col, col + 4), as a mask.
__device__ __forceinline__ uint32_t span_mask(int col, int lo, int hi) {
  const int s = max(lo - col, 0);
  const int e = min(hi - col, 4);
  if (e <= s) return 0u;
  return (0xffffffffu >> (8 * (4 - (e - s)))) << (8 * s);
}

// The sums launch: block r of image b writes the exact uint32 sums of
// band r's crop rows, per channel (3), to p.sums[(b * K + r) * 3 + c].
// An image outside the arena writes zeros (its band blocks store NaN).
__global__ void __launch_bounds__(kThreads)
    crop_sums_kernel(const Params p) {
  __shared__ unsigned int warp_sums[kThreads / 32][3];
  const int b = blockIdx.y;
  const int r = blockIdx.x;
  const int crop = p.crop, size = p.size;
  const int y_lo = r * p.band_rows;
  const int n_band = min(p.band_rows, crop - y_lo);
  const int row = p.rows[b];
  const int y0 = p.offsets[2 * b];
  const int x0 = p.offsets[2 * b + 1];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  unsigned int acc[3] = {0u, 0u, 0u};
  if (in_arena(row, y0, x0, p.n_rows, size, crop)) {
    const int64_t plane = (int64_t)size * size;
    const uint8_t* img =
        p.arena + (int64_t)row * 3 * plane + (int64_t)(y0 + y_lo) * size;
    if (size % 16 == 0 && reinterpret_cast<uintptr_t>(p.arena) % 16 == 0) {
      // 16-byte loads over the aligned span of each row, edges masked
      const int a = x0 & ~15;
      const int n16 = (((x0 + crop + 15) & ~15) - a) >> 4;
      for (int y = warp; y < n_band; y += kThreads / 32) {
        for (int j = lane; j < n16; j += 32) {
          const int col = a + 16 * j;
          uint32_t mask[4];
#pragma unroll
          for (int k = 0; k < 4; ++k) {
            mask[k] = span_mask(col + 4 * k, x0, x0 + crop);
          }
#pragma unroll
          for (int c = 0; c < 3; ++c) {
            const uint4 v = __ldg(reinterpret_cast<const uint4*>(
                img + c * plane + (int64_t)y * size + col));
            acc[c] = __dp4a(v.x & mask[0], 0x01010101u, acc[c]);
            acc[c] = __dp4a(v.y & mask[1], 0x01010101u, acc[c]);
            acc[c] = __dp4a(v.z & mask[2], 0x01010101u, acc[c]);
            acc[c] = __dp4a(v.w & mask[3], 0x01010101u, acc[c]);
          }
        }
      }
    } else {
      for (int y = warp; y < n_band; y += kThreads / 32) {
        for (int k = lane; k < crop; k += 32) {
#pragma unroll
          for (int c = 0; c < 3; ++c) {
            acc[c] += img[c * plane + (int64_t)y * size + x0 + k];
          }
        }
      }
    }
  }
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    for (int o = 16; o > 0; o >>= 1) {
      acc[c] += __shfl_down_sync(0xffffffffu, acc[c], o);
    }
    if (lane == 0) warp_sums[warp][c] = acc[c];
  }
  __syncthreads();
  if (threadIdx.x < 3) {
    unsigned int part = 0;
    for (int w = 0; w < kThreads / 32; ++w) part += warp_sums[w][threadIdx.x];
    p.sums[((int64_t)b * gridDim.x + r) * 3 + threadIdx.x] = part;
  }
}

// P = 1: planar output; P = 2: space-to-depth output. kTail requires
// channels == 3 (checked by the caller) and, unless kSums, a cluster of
// gridDim.x blocks; with kSums the image's band sums come from p.sums.
// Grid: (K bands, B images); block r owns crop rows [r*R, min(r*R + R, T)).
template <typename OutT, bool kTail, int P, bool kSums>
__global__ void __launch_bounds__(kThreads)
    preprocess_cluster_kernel(const Params p) {
  extern __shared__ __align__(16) uint8_t band[];
  __shared__ unsigned int peer_sums[kMaxCluster][3];
  __shared__ unsigned int warp_sums[kThreads / 32][3];

  const int b = blockIdx.y;
  const int r = blockIdx.x;
  const int ch = p.channels, crop = p.crop, size = p.size;
  const int y_lo = r * p.band_rows;
  const int n_band = min(p.band_rows, crop - y_lo);
  const int row = p.rows[b];
  const int y0 = p.offsets[2 * b];
  const int x0 = p.offsets[2 * b + 1];
  const bool flip = p.flips[b] != 0;
  const int lead = x0 & 15;  // shared column of crop column 0

  const int side = crop / P;  // side of one output plane
  const int n_chunks = (side + 7) >> 3;
  const int out_rows = n_band / P;
  const bool vec = (side & 7) == 0;
  const int64_t out_plane = (int64_t)side * side;
  OutT* out_img =
      static_cast<OutT*>(p.out) + (int64_t)b * ch * P * P * out_plane;

  if (!in_arena(row, y0, x0, p.n_rows, size, crop)) {
    // NaN for the whole image. Every block of the image's cluster returns
    // here, so none waits at a cluster barrier for it.
    float nan8[8];
#pragma unroll
    for (int k = 0; k < 8; ++k) nan8[k] = NAN;
    for (int i = threadIdx.x; i < out_rows * n_chunks; i += kThreads) {
      const int ul = i / n_chunks;
      const int v0 = 8 * (i - ul * n_chunks);
      OutT* o = out_img + (int64_t)(y_lo / P + ul) * side + v0;
      for (int q = 0; q < ch * P * P; ++q) {
        store8(o + q * out_plane, nan8, min(8, side - v0), vec);
      }
    }
    return;
  }

  constexpr bool kCluster = kTail && !kSums;
  // this block has started: its peers may write into its shared memory
  if (kCluster) cluster_arrive_relaxed();
  const int64_t plane = (int64_t)size * size;
  const uint8_t* img = p.arena + (int64_t)row * ch * plane;
  if (size % 16 == 0 && reinterpret_cast<uintptr_t>(p.arena) % 16 == 0) {
    const int a = x0 - lead;
    const int n16 = (((x0 + crop + 15) & ~15) - a) >> 4;
    const int per_ch = n_band * n16;
    for (int i = threadIdx.x; i < ch * per_ch; i += kThreads) {
      const int c = i / per_ch;
      const int rem = i - c * per_ch;
      const int y = rem / n16;
      const int j = rem - y * n16;
      cp_async16(band + (c * p.band_rows + y) * p.pitch + 16 * j,
                 img + c * plane + (int64_t)(y0 + y_lo + y) * size + a +
                     16 * j);
    }
    cp_async_wait_all();
  } else {
    const int per_ch = n_band * crop;
    for (int i = threadIdx.x; i < ch * per_ch; i += kThreads) {
      const int c = i / per_ch;
      const int rem = i - c * per_ch;
      const int y = rem / crop;
      const int k = rem - y * crop;
      band[(c * p.band_rows + y) * p.pitch + lead + k] =
          img[c * plane + (int64_t)(y0 + y_lo + y) * size + x0 + k];
    }
  }
  __syncthreads();

  float mean = 0.0f, fc = 1.0f, fs = 1.0f;
  // a band's sum fits 32 bits, the whole crop's may not (above 4104 px)
  unsigned long long total[3] = {0ull, 0ull, 0ull};
  if constexpr (kSums) {
    // the sums launch's partials of this image, in rank order
    const unsigned int* part = p.sums + (int64_t)b * gridDim.x * 3;
    for (int q = 0; q < (int)gridDim.x; ++q) {
#pragma unroll
      for (int c = 0; c < 3; ++c) total[c] += part[q * 3 + c];
    }
  } else if constexpr (kTail) {
    // this band's exact per-channel sums, over the words that hold shared
    // columns [lead, lead + crop), edge bytes masked
    unsigned int acc[3] = {0u, 0u, 0u};
    const int w_lo = lead >> 2;
    const int nw = ((lead + crop + 3) >> 2) - w_lo;
    for (int i = threadIdx.x; i < n_band * nw; i += kThreads) {
      const int y = i / nw;
      const int lo = 4 * (w_lo + i - y * nw);
      unsigned int mask = 0xffffffffu;
      if (lo < lead) mask <<= 8 * (lead - lo);
      if (lo + 4 > lead + crop) {
        mask &= 0xffffffffu >> (8 * (lo + 4 - lead - crop));
      }
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        const uint32_t word = *reinterpret_cast<const uint32_t*>(
            band + (c * p.band_rows + y) * p.pitch + lo);
        acc[c] = __dp4a(word & mask, 0x01010101u, acc[c]);
      }
    }
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      for (int o = 16; o > 0; o >>= 1) {
        acc[c] += __shfl_down_sync(0xffffffffu, acc[c], o);
      }
      if ((threadIdx.x & 31) == 0) warp_sums[threadIdx.x >> 5][c] = acc[c];
    }
    __syncthreads();
    cluster_wait();  // every block of the cluster has started
    if (threadIdx.x < 3) {
      unsigned int part = 0;
      for (int w = 0; w < kThreads / 32; ++w) {
        part += warp_sums[w][threadIdx.x];
      }
      cg::cluster_group cluster = cg::this_cluster();
      for (int q = 0; q < (int)gridDim.x; ++q) {
        cluster.map_shared_rank(&peer_sums[0][0], q)[r * 3 + threadIdx.x] =
            part;
      }
    }
    cluster_arrive();  // release the partials written above
    cluster_wait();    // acquire every peer's
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      for (int q = 0; q < (int)gridDim.x; ++q) total[c] += peer_sums[q][c];
    }
  }
  if (kTail) {
    const float area = (float)(crop * crop);
    float m = 0.0f;
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      const float chan_mean = __fadd_rn(
          __fmul_rn(p.scale[b * 3 + c], __fdiv_rn((float)total[c], area)),
          p.bias[b * 3 + c]);
      m = __fadd_rn(m, chan_mean);
    }
    mean = __fdiv_rn(m, 3.0f);
    fc = p.contrast[b];
    fs = p.saturation[b];
  }

  float sc[3], bi[3], ps[3], pb[3];
  if (kTail) {
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      sc[c] = p.scale[b * 3 + c];
      bi[c] = p.bias[b * 3 + c];
      ps[c] = p.post_scale[b * 3 + c];
      pb[c] = p.post_bias[b * 3 + c];
    }
  }

  for (int i = threadIdx.x; i < out_rows * n_chunks; i += kThreads) {
    const int ul = i / n_chunks;
    const int v0 = 8 * (i - ul * n_chunks);
    const int n = min(8, side - v0);
    OutT* o = out_img + (int64_t)(y_lo / P + ul) * side + v0;
    if (kTail) {
#pragma unroll
      for (int dy = 0; dy < P; ++dy) {
        uint32_t raw[3][2 * P];
#pragma unroll
        for (int c = 0; c < 3; ++c) {
          gather<P>(band, (c * p.band_rows + P * ul + dy) * p.pitch, lead,
                    crop, P * v0, flip, raw[c]);
        }
#pragma unroll
        for (int dx = 0; dx < P; ++dx) {
          uint32_t e[3][2];
#pragma unroll
          for (int c = 0; c < 3; ++c) phase<P>(raw[c], dx, e[c]);
          float res[3][8];
#pragma unroll
          for (int k = 0; k < 8; ++k) {
            float val[3];
#pragma unroll
            for (int c = 0; c < 3; ++c) {
              const float x =
                  __fadd_rn(__fmul_rn(byte_at(e[c], k), sc[c]), bi[c]);
              val[c] = __fadd_rn(__fmul_rn(__fsub_rn(x, mean), fc), mean);
            }
            const float gray =
                __fadd_rn(__fadd_rn(__fmul_rn(0.299f, val[0]),
                                    __fmul_rn(0.587f, val[1])),
                          __fmul_rn(0.114f, val[2]));
#pragma unroll
            for (int c = 0; c < 3; ++c) {
              float x =
                  __fadd_rn(__fmul_rn(__fsub_rn(val[c], gray), fs), gray);
              x = fminf(fmaxf(x, 0.0f), 1.0f);
              res[c][k] = __fadd_rn(__fmul_rn(x, ps[c]), pb[c]);
            }
          }
#pragma unroll
          for (int c = 0; c < 3; ++c) {
            store8(o + (c * P * P + dy * P + dx) * out_plane, res[c], n, vec);
          }
        }
      }
    } else {
      for (int c = 0; c < ch; ++c) {
        const float s = p.scale[b * ch + c];
        const float t = p.bias[b * ch + c];
#pragma unroll
        for (int dy = 0; dy < P; ++dy) {
          uint32_t raw[2 * P];
          gather<P>(band, (c * p.band_rows + P * ul + dy) * p.pitch, lead,
                    crop, P * v0, flip, raw);
#pragma unroll
          for (int dx = 0; dx < P; ++dx) {
            uint32_t e[2];
            phase<P>(raw, dx, e);
            float res[8];
#pragma unroll
            for (int k = 0; k < 8; ++k) {
              res[k] = __fadd_rn(__fmul_rn(byte_at(e, k), s), t);
            }
            store8(o + (c * P * P + dy * P + dx) * out_plane, res, n, vec);
          }
        }
      }
    }
  }
}

template <typename OutT, bool kTail, int P, bool kSums>
cudaError_t launch(const Params& prm, int batch, int blocks, int smem_bytes,
                   cudaStream_t stream) {
  auto kernel = preprocess_cluster_kernel<OutT, kTail, P, kSums>;
  if (smem_bytes > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
    if (err != cudaSuccess) return err;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(blocks, batch, 1);
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = smem_bytes;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = blocks;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = kTail && !kSums ? 1 : 0;  // only the DSMEM sums need it
  return cudaLaunchKernelEx(&cfg, kernel, prm);
}

template <typename OutT>
cudaError_t launch_layout(bool tail, bool s2d, const Params& prm, int batch,
                          int blocks, int smem_bytes, cudaStream_t stream) {
#define SIA_LAUNCH(TAIL, P, SUMS) \
  launch<OutT, TAIL, P, SUMS>(prm, batch, blocks, smem_bytes, stream)
  const bool sums = prm.sums != nullptr;
  if (tail && sums) {
    crop_sums_kernel<<<dim3(blocks, batch), kThreads, 0, stream>>>(prm);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    return s2d ? SIA_LAUNCH(true, 2, true) : SIA_LAUNCH(true, 1, true);
  }
  if (tail && s2d) return SIA_LAUNCH(true, 2, false);
  if (tail) return SIA_LAUNCH(true, 1, false);
  if (s2d) return SIA_LAUNCH(false, 2, false);
  return SIA_LAUNCH(false, 1, false);
#undef SIA_LAUNCH
}

}  // namespace

// Plain C entry point, loaded with ctypes. Pointers are device pointers;
// contrast, saturation, post_scale and post_bias are all null (no tail) or
// all set (tail, channels == 3). The band plan: `blocks` bands of
// `band_rows` crop rows each (the last may be shorter, none empty), one
// block each; with the tail either a cluster of `blocks` (at most 8)
// blocks per image (`sums` null), or, with `sums` an int32 [B, blocks, 3]
// scratch buffer, the sums launch first and the band launch after it;
// `pitch` bytes per shared row (a multiple of 16, at least crop + 15);
// `smem_bytes` of dynamic shared memory per block, at least
// channels * band_rows * pitch + 16. Launches on `stream` and returns
// cudaGetLastError() (0 on success), or cudaErrorInvalidValue for a plan
// or shape the kernel does not take.
extern "C" int sia_fused_preprocess(
    const void* arena, const void* rows, const void* offsets,
    const void* flips, const void* scale, const void* bias,
    const void* contrast, const void* saturation, const void* post_scale,
    const void* post_bias, void* sums, void* out, int n_rows, int batch,
    int channels,
    int size, int crop, int out_bf16, int s2d, int blocks, int band_rows,
    int pitch, int smem_bytes, void* stream) {
  const bool tail = contrast != nullptr;
  const int p = s2d ? 2 : 1;
  if ((tail && (channels != 3 || (blocks > kMaxCluster && !sums))) ||
      (sums && !tail) || blocks < 1 ||
      band_rows % p != 0 || (int64_t)(blocks - 1) * band_rows >= crop ||
      (int64_t)blocks * band_rows < crop || pitch % 16 != 0 ||
      pitch < crop + 15 ||
      (int64_t)smem_bytes < (int64_t)channels * band_rows * pitch + 16) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Params prm;
  prm.arena = static_cast<const uint8_t*>(arena);
  prm.rows = static_cast<const int*>(rows);
  prm.offsets = static_cast<const int*>(offsets);
  prm.flips = static_cast<const int*>(flips);
  prm.scale = static_cast<const float*>(scale);
  prm.bias = static_cast<const float*>(bias);
  prm.contrast = static_cast<const float*>(contrast);
  prm.saturation = static_cast<const float*>(saturation);
  prm.post_scale = static_cast<const float*>(post_scale);
  prm.post_bias = static_cast<const float*>(post_bias);
  prm.sums = static_cast<unsigned int*>(sums);
  prm.out = out;
  prm.n_rows = n_rows;
  prm.channels = channels;
  prm.size = size;
  prm.crop = crop;
  prm.band_rows = band_rows;
  prm.pitch = pitch;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      out_bf16 ? launch_layout<__nv_bfloat16>(tail, s2d != 0, prm, batch,
                                              blocks, smem_bytes, st)
               : launch_layout<float>(tail, s2d != 0, prm, batch, blocks,
                                      smem_bytes, st);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}
