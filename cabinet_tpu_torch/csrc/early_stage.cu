// Fused MobileNetV3 stem + block_0 (kernel K4) for Hopper (sm_90a).
//
// Replaces the Pallas kernel cabinet_tpu/ops/early_stage.py:
// _stem_block0_kernel (pallas_call at :230, launched by fused_stem_block0
// :199). With BN folded into the weights, per image:
//   stem = hardswish(conv3x3_s2(x, wstem) + bstem)          3 -> 16
//   dw   = relu(depthwise3x3(stem, wdw) + bdw)               16
//   out  = pointwise(dw, wpw) + bpw + stem                   16 -> 16
// x (B,H,W,3) NHWC, f32 or bf16, read rounded to bf16 as the Pallas wrapper
// packs it; out (B,16,H/2,W/2) planes, f32 or bf16, stored after an f32
// epilogue. H and W are even; any even size works.
//
// What bounds it: per 1024^2 image it reads 6.3 MB of bf16 input and writes
// 16.8 MB of f32 planes (8.4 MB in bf16), against ~0.44 GFLOP of f32 FMAs
// (27+9+16 MACs per channel and pixel): about 7 us of memory traffic and
// 6.5 us of the f32 SIMT rate. So it is bound by bytes (f32 out) or, with
// bf16 out, by operations, and the design keeps every intermediate
// (stem, depthwise) in shared memory or registers: device memory sees the
// input once and the planes once.
//
// Design. The TPU kernel packs the input into parity planes, walks row
// bands with a hand-made double-buffered DMA, and needs W/2 % 128 == 0, all
// to suit Mosaic's layouts. None of that carries over. Here each block of
// 256 threads owns one TH x TW tile of the H/2 x W/2 output grid of one
// image:
//   1. it loads the stride-2 input window of the tile plus a 2-pixel halo
//      ((2*TH+5) x (2*TW+5) x 3) into shared memory, rounded to bf16, with
//      zeros outside the image (the stem conv's zero padding);
//   2. it computes the 16-channel stem plus hardswish on the tile and a
//      1-pixel halo into shared memory in f32, zero at halo positions
//      outside the image (the depthwise conv's zero padding);
//   3. each thread then takes output pixels: the 16 depthwise sums plus
//      relu in registers, the 16x16 pointwise plus bias plus the stem
//      residual, and stores the pixel's 16 channels together with 16-byte
//      stores (a warp writes 32 neighbouring pixels, 1 or 2 KB in a row).
// The planes are kept in channels-last memory: the (B,16,H/2,W/2) tensor
// has the strides of (B,H/2,W/2,16), the layout the rest of the network
// runs in (its NHWC input, permuted, is channels-last; the JAX package
// transposes the planes to NHWC at once). Stored plane by plane, they
// would put every later convolution on cuDNN's NCHW kernels, which made
// the batch-8 forward slower on an H100 (PERF.md).
// The 880 folded weights sit in shared memory; every thread of a warp reads
// the same one at a time (a broadcast). Simple first: no cp.async/TMA.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

typedef __nv_bfloat16 bf16;

namespace {

constexpr int TH = 16, TW = 32;           // output tile (H/2 x W/2 grid)
constexpr int SH = TH + 2, SW = TW + 2;   // stem tile with its 1-pixel halo
constexpr int IH = 2 * SH + 1, IW = 2 * SW + 1;  // input window
constexpr int C = 16;                     // stem and block_0 width
constexpr int THREADS = 256;
constexpr int N_W = C * 27 + C + 9 * C + C + C * C + C;  // 880 weights

constexpr size_t SMEM_BYTES =
    (size_t)(3 * IH * IW + N_W + C * SH * SW) * sizeof(float);

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(bf16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}
// The 16 channels of one pixel, stored together (64 or 32 bytes, 16-byte
// aligned: the wrapper's buffer is, and every pixel starts at 16*C bytes).
__device__ __forceinline__ void store16(float* p, const float* v) {
#pragma unroll
  for (int i = 0; i < C; i += 4)
    *reinterpret_cast<float4*>(p + i) =
        make_float4(v[i], v[i + 1], v[i + 2], v[i + 3]);
}
__device__ __forceinline__ void store16(bf16* p, const float* v) {
#pragma unroll
  for (int i = 0; i < C; i += 8) {
    __nv_bfloat162 h[4];
#pragma unroll
    for (int j = 0; j < 4; ++j)
      h[j] = __floats2bfloat162_rn(v[i + 2 * j], v[i + 2 * j + 1]);
    *reinterpret_cast<uint4*>(p + i) = *reinterpret_cast<const uint4*>(h);
  }
}

template <typename TIn, typename TOut>
__global__ void __launch_bounds__(THREADS)
stem_block0_kernel(const TIn* __restrict__ x, const float* __restrict__ wstem,
                   const float* __restrict__ bstem,
                   const float* __restrict__ wdw,
                   const float* __restrict__ bdw,
                   const float* __restrict__ wpw,
                   const float* __restrict__ bpw, TOut* __restrict__ out,
                   int H, int W) {
  extern __shared__ __align__(16) float smem[];
  float* x_s = smem;                  // (3, IH, IW)
  float* w_s = x_s + 3 * IH * IW;     // wstem | bstem | wdw | bdw | wpw | bpw
  float* stem_s = w_s + N_W;          // (C, SH, SW)
  const float* ws_stem = w_s;
  const float* ws_bstem = ws_stem + C * 27;
  const float* ws_dw = ws_bstem + C;
  const float* ws_bdw = ws_dw + 9 * C;
  const float* ws_pw = ws_bdw + C;
  const float* ws_bpw = ws_pw + C * C;

  const int H2 = H / 2, W2 = W / 2;
  const int b = blockIdx.z;
  const int oy0 = blockIdx.y * TH, ox0 = blockIdx.x * TW;
  const int iy0 = 2 * oy0 - 3, ix0 = 2 * ox0 - 3;  // input window origin

  // Weights.
  for (int i = threadIdx.x; i < N_W; i += THREADS) {
    float w;
    if (i < C * 27) w = wstem[i];
    else if (i < C * 28) w = bstem[i - C * 27];
    else if (i < C * 37) w = wdw[i - C * 28];
    else if (i < C * 38) w = bdw[i - C * 37];
    else if (i < C * 54) w = wpw[i - C * 38];
    else w = bpw[i - C * 54];
    w_s[i] = w;
  }

  // 1. The input window, rounded to bf16, channel-planar; zero outside.
  const TIn* xb = x + (size_t)b * H * W * 3;
  for (int i = threadIdx.x; i < IH * IW * 3; i += THREADS) {
    const int r = i / (IW * 3), e = i % (IW * 3);
    const int col = e / 3, ch = e % 3;
    const int gy = iy0 + r, gx = ix0 + col;
    float v = 0.f;
    if (gy >= 0 && gy < H && gx >= 0 && gx < W)
      v = round_bf16(to_f32(xb[((size_t)gy * W + gx) * 3 + ch]));
    x_s[(ch * IH + r) * IW + col] = v;
  }
  __syncthreads();

  // 2. Stem + hardswish on the tile and its halo; zero outside the image.
  for (int p = threadIdx.x; p < SH * SW; p += THREADS) {
    const int sy = p / SW, sx = p % SW;
    const int gy = oy0 - 1 + sy, gx = ox0 - 1 + sx;
    if (gy < 0 || gy >= H2 || gx < 0 || gx >= W2) {
      for (int co = 0; co < C; ++co) stem_s[(co * SH + sy) * SW + sx] = 0.f;
      continue;
    }
    float xv[27];
#pragma unroll
    for (int ci = 0; ci < 3; ++ci)
#pragma unroll
      for (int i = 0; i < 3; ++i)
#pragma unroll
        for (int j = 0; j < 3; ++j)
          xv[ci * 9 + i * 3 + j] =
              x_s[(ci * IH + 2 * sy + i) * IW + 2 * sx + j];
#pragma unroll 4
    for (int co = 0; co < C; ++co) {
      float acc = xv[0] * ws_stem[co * 27];
#pragma unroll
      for (int t = 1; t < 27; ++t) acc = fmaf(xv[t], ws_stem[co * 27 + t], acc);
      acc += ws_bstem[co];
      acc = acc * fminf(fmaxf(acc + 3.f, 0.f), 6.f) * (1.f / 6.f);
      stem_s[(co * SH + sy) * SW + sx] = acc;
    }
  }
  __syncthreads();

  // 3. Depthwise + relu, pointwise + bias + residual, one pixel at a time.
  TOut* ob = out + (size_t)b * C * H2 * W2;
  for (int p = threadIdx.x; p < TH * TW; p += THREADS) {
    const int ty = p / TW, tx = p % TW;
    const int gy = oy0 + ty, gx = ox0 + tx;
    if (gy >= H2 || gx >= W2) continue;
    float dw[C];
#pragma unroll
    for (int c = 0; c < C; ++c) {
      const float* s = stem_s + (c * SH + ty) * SW + tx;
      float acc = s[0] * ws_dw[c];
#pragma unroll
      for (int t = 1; t < 9; ++t)
        acc = fmaf(s[(t / 3) * SW + t % 3], ws_dw[t * C + c], acc);
      dw[c] = fmaxf(acc + ws_bdw[c], 0.f);
    }
    float res[C];
#pragma unroll
    for (int co = 0; co < C; ++co) {
      float acc = dw[0] * ws_pw[co * C];
#pragma unroll
      for (int ci = 1; ci < C; ++ci) acc = fmaf(dw[ci], ws_pw[co * C + ci], acc);
      acc += ws_bpw[co];
      res[co] = acc + stem_s[(co * SH + ty + 1) * SW + tx + 1];
    }
    store16(ob + ((size_t)gy * W2 + gx) * C, res);
  }
}

template <typename TIn, typename TOut>
int launch(const void* x, const float* const* w, void* out, int B, int H,
           int W, cudaStream_t stream) {
  auto kernel = stem_block0_kernel<TIn, TOut>;
  cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       (int)SMEM_BYTES);
  dim3 grid((W / 2 + TW - 1) / TW, (H / 2 + TH - 1) / TH, B);
  kernel<<<grid, THREADS, SMEM_BYTES, stream>>>(
      (const TIn*)x, w[0], w[1], w[2], w[3], w[4], w[5], (TOut*)out, H, W);
  return (int)cudaGetLastError();
}

}  // namespace

// x (B,H,W,3) NHWC, bf16 if x_bf16 else f32, contiguous; H, W even.
// Folded f32 weights: wstem (16,27) [co, ci*9+i*3+j], bstem (16,),
// wdw (3,3,16), bdw (16,), wpw (16,16) [co, ci], bpw (16,).
// out (B,16,H/2,W/2) in channels-last memory (strides of (B,H/2,W/2,16)),
// bf16 if out_bf16 else f32, 16-byte aligned. Launches on `stream` and
// returns cudaGetLastError().
extern "C" int cabinet_stem_block0(const void* x, const void* wstem,
                                   const void* bstem, const void* wdw,
                                   const void* bdw, const void* wpw,
                                   const void* bpw, void* out, int B, int H,
                                   int W, int x_bf16, int out_bf16,
                                   void* stream) {
  const float* w[6] = {(const float*)wstem, (const float*)bstem,
                       (const float*)wdw, (const float*)bdw,
                       (const float*)wpw, (const float*)bpw};
  cudaStream_t s = (cudaStream_t)stream;
  if (x_bf16)
    return out_bf16 ? launch<bf16, bf16>(x, w, out, B, H, W, s)
                    : launch<bf16, float>(x, w, out, B, H, W, s);
  return out_bf16 ? launch<float, bf16>(x, w, out, B, H, W, s)
                  : launch<float, float>(x, w, out, B, H, W, s);
}
