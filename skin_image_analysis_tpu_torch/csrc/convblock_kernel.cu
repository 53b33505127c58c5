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
//                   need are at most a quarter of the dense 120.8 G).
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
//   * dW: one block per image, looping over bands of 4 pooled rows; g and
//     sel of the band are staged in shared memory, the selector masks g
//     once per phase into the A operand, and each warp accumulates a
//     64 x 48 slice of the partial (2 co halves x 4 groups of 48 k').

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kCout = 32;
constexpr int kPC = 4 * kCout;  // 128 packed channels
constexpr int kK = 192;         // contraction depth 8 * 8 * 3
constexpr int kWStride = 200;   // padded shared row of the packed weight
constexpr int kFwdRows = 16;    // pooled rows per forward block
constexpr int kDwRows = 4;      // pooled rows per dW band
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

__global__ void __launch_bounds__(kThreads)
    phase_conv0_dw_kernel(const __nv_bfloat16* __restrict__ x,
                          const __nv_bfloat16* __restrict__ g,
                          const uint8_t* __restrict__ sel,
                          float* __restrict__ dwp, int h, int w) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int img = blockIdx.x;
  const int h2 = h / 2, w2 = w / 2;
  const int rs = band_row_stride(w);
  const int plane = band_rows(kDwRows) * rs;
  const int tpad = (kDwRows * w2 + 15) / 16 * 16;  // positions per band
  const int gstride = tpad + 8;    // bf16 elements: conflict-free rows
  const int sstride = tpad + 16;   // bytes
  __nv_bfloat16* xs = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* gs = xs + 3 * plane;  // 3 * plane is even: 4-byte aligned
  int* tab = reinterpret_cast<int*>(gs + kCout * gstride);
  uint8_t* ss = reinterpret_cast<uint8_t*>(tab + tpad);
  const unsigned short* xsu = reinterpret_cast<const unsigned short*>(xs);

  // offset of band position t in the x band (rows past the band's end
  // read zero rows; those positions carry g = 0)
  for (int t = threadIdx.x; t < tpad; t += blockDim.x) {
    const int tt = min(t, kDwRows * w2 - 1);
    const int r = tt / w2;
    tab[t] = 2 * r * rs + 2 * (tt - r * w2);
  }

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int gid = lane >> 2, tig = lane & 3;
  const int half = warp & 1;    // co half*16 .. half*16 + 15, all phases
  const int group = warp >> 1;  // k' in [group*48, group*48 + 48)
  const int co0 = half * 16 + gid;

  int koff[6];
#pragma unroll
  for (int nt = 0; nt < 6; ++nt) {
    const int kp = group * 48 + nt * 8 + gid;  // column n = gid
    const int c = kp >> 6;
    const int a = (kp >> 3) & 7;
    const int b = kp & 7;
    koff[nt] = c * plane + a * rs + b;
  }

  float acc[4][6][4];
#pragma unroll
  for (int p = 0; p < 4; ++p)
#pragma unroll
    for (int nt = 0; nt < 6; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[p][nt][e] = 0.0f;

  const __nv_bfloat16* ximg = x + (int64_t)img * 3 * h * w;
  for (int i0 = 0; i0 < h2; i0 += kDwRows) {
    const int npos = min(kDwRows, h2 - i0) * w2;
    __syncthreads();  // the previous band is consumed
    load_band(ximg, xs, i0, kDwRows, h, w);
    for (int idx = threadIdx.x; idx < kCout * tpad; idx += blockDim.x) {
      const int co = idx / tpad;
      const int t = idx - co * tpad;
      __nv_bfloat16 gv = __float2bfloat16_rn(0.0f);
      uint8_t sv = kDead;
      if (t < npos) {
        const int64_t o =
            (((int64_t)img * kCout + co) * h2 + i0) * w2 + t;  // rows contiguous
        gv = g[o];
        sv = sel[o];
      }
      gs[co * gstride + t] = gv;
      ss[co * sstride + t] = sv;
    }
    __syncthreads();

    for (int ks = 0; ks < tpad / 16; ++ks) {
      const int t0 = ks * 16 + 2 * tig;
      // A operand (rows co0 / co0 + 8, columns t0, t0 + 1 / + 8, + 9)
      uint32_t graw[4];
      uint32_t sraw[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int co = co0 + (r & 1) * 8;
        const int t = t0 + (r >> 1) * 8;
        graw[r] = lds32(gs + co * gstride + t);
        sraw[r] = *reinterpret_cast<const unsigned short*>(ss + co * sstride + t);
      }
      // B operand: rows (positions) t0, t0 + 1 and t0 + 8, t0 + 9
      const int p0 = tab[t0], p1 = tab[t0 + 1];
      const int p8 = tab[t0 + 8], p9 = tab[t0 + 9];
      uint32_t bf[6][2];
#pragma unroll
      for (int nt = 0; nt < 6; ++nt) {
        const unsigned short* xp = xsu + koff[nt];
        bf[nt][0] = (uint32_t)xp[p0] | ((uint32_t)xp[p1] << 16);
        bf[nt][1] = (uint32_t)xp[p8] | ((uint32_t)xp[p9] << 16);
      }
#pragma unroll
      for (int p = 0; p < 4; ++p) {
        uint32_t af[4];
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const uint32_t lo =
              (sraw[r] & 0xffu) == (uint32_t)p ? (graw[r] & 0xffffu) : 0u;
          const uint32_t hi =
              (sraw[r] >> 8) == (uint32_t)p ? (graw[r] & 0xffff0000u) : 0u;
          af[r] = lo | hi;
        }
#pragma unroll
        for (int nt = 0; nt < 6; ++nt)
          mma_bf16(acc[p][nt], af, bf[nt][0], bf[nt][1]);
      }
    }
  }

  // C fragment: rows pc = p*32 + co0 (+8), columns k' = group*48 + nt*8 +
  // 2*tig (+1); store in the JAX layout k = (a*8 + b)*3 + c
  float* out = dwp + (int64_t)img * kPC * kK;
#pragma unroll
  for (int p = 0; p < 4; ++p) {
#pragma unroll
    for (int nt = 0; nt < 6; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int pc = p * kCout + co0 + (e >> 1) * 8;
        const int kp = group * 48 + nt * 8 + 2 * tig + (e & 1);
        const int c = kp >> 6;
        const int ab = kp & 63;
        out[pc * kK + ab * 3 + c] = acc[p][nt][e];
      }
    }
  }
}

size_t fwd_smem_bytes(int w) {
  return sizeof(__nv_bfloat16) *
         ((size_t)kPC * kWStride + 3 * (size_t)band_rows(kFwdRows) *
                                       band_row_stride(w));
}

size_t dw_smem_bytes(int w) {
  const size_t tpad = ((size_t)kDwRows * (w / 2) + 15) / 16 * 16;
  return sizeof(__nv_bfloat16) *
             (3 * (size_t)band_rows(kDwRows) * band_row_stride(w) +
              kCout * (tpad + 8)) +
         sizeof(int) * tpad + kCout * (tpad + 16);
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
// uint8 -> dwp [B, 128, 192] float32 per-image partials.
extern "C" int sia_phase_conv0_dw(const void* x, const void* g,
                                  const void* sel, void* dwp, int batch,
                                  int h, int w, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const size_t smem = dw_smem_bytes(w);
  cudaError_t err = cudaFuncSetAttribute(
      phase_conv0_dw_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  phase_conv0_dw_kernel<<<batch, kThreads, smem, st>>>(
      static_cast<const __nv_bfloat16*>(x),
      static_cast<const __nv_bfloat16*>(g), static_cast<const uint8_t*>(sel),
      static_cast<float*>(dwp), h, w);
  return static_cast<int>(cudaGetLastError());
}
