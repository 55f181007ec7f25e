// Fused decoder tail for Hopper (sm_90a): kernels K2 and K3.
//
// K2 cabinet_ffm_pointwise replaces the Pallas kernel
//   cabinet_tpu/ops/decoder_tail.py:_k1_kernel (pallas_call at :169):
//   feat = relu(fsp W1_sp + fcp W1_cp + b1), the FFM 1x1 ConvBNReLU on
//   concat([fsp 128ch, fcp 256ch]) with the concat removed by splitting the
//   weight and BN folded, plus f32 channel sums of each tile of FFM_TILE
//   pixels.
// K3 cabinet_head_conv3x3 replaces the Pallas kernel
//   cabinet_tpu/ops/decoder_tail.py:_k2_kernel (pallas_call at :210):
//   per pixel, x = feat * bf16(scale) (zero outside the image), a 3x3 conv
//   256->256 with f32 accumulation, + b3, relu, rounded to bf16, then the
//   bias-free 1x1 classifier 256->n_classes, rounded to bf16.
//
// What bounds them, at the main path's S=128 (1024^2 input), per image:
//   K2 does 2*S^2*384*256 = 3.2 GFLOP and moves ~21 MB (153 FLOP/B, under
//   the card's ~295): memory-bound, 0.0064 ms at 3.35 TB/s.
//   K3 does 2*S^2*256*(9*256 + n_classes) ~ 19.4 GFLOP and moves ~10 MB:
//   compute-bound on the tensor cores, 0.0196 ms at 989 TFLOP/s.
//
// Both kernels are implicit GEMMs over pixels of the flattened NHWC image,
// with the same block: 128 pixels x all 256 output channels (one wave of
// 128 blocks on 132 SMs for a 128^2 image), two warpgroups of 64 pixels
// each with one wgmma.m64n256k16 f32 accumulator, and K streaming in steps
// of 64 channels through a ring of 4 stages (A 16 KB + weight chunk 32 KB)
// in 128-byte-swizzled shared memory (hopper.cuh): the A tile K-major, the
// weight chunk N-major as it lies in memory (wgmma transposes it).
//
// K2: K = 128 fsp + 256 fcp channels in 6 steps (the step picks the source,
// so the concat never exists). A needs no gather, so both operands come by
// cp.async, three steps ahead of the tensor cores; rows past the image are
// zero-filled by the copy. The epilogue stays in registers: + b1, relu, the
// bf16 feat staged through the drained ring and written with 16-byte
// stores, and the f32 column sums of each warpgroup's 64 pixels, which are
// exactly one FFM_TILE: summed in the thread, then over the 8 lanes of a
// column by shuffles, then over the 4 warps in shared memory, in a fixed
// order. One row of sums per (image, tile); the SE glue in PyTorch reduces
// the rows in a fixed order: no atomics, so the sums do not depend on block
// order. The lever left: every block streams all of W1 (196 KB) from L2,
// ~25 MB per image; blocks holding W1 resident would remove it.
//
// K3: K = 9 taps x 256 channels in 36 steps. The TPU kernel's row tiles
// with a one-row halo become per-pixel (y, x) neighbour addressing: each of
// the 9 taps of a pixel is read straight from global memory (L2 serves the
// reuse), zeros for taps outside the image, so any H, W works and no tile
// needs a halo. The loads of step s+2 are in flight while the tensor cores
// run step s: W3 by cp.async, A through registers, since it is a per-pixel
// gather, zero outside the image and multiplied by bf16(scale) before the
// product (which rules out a tiled TMA load). The 1x1 classifier runs on
// WMMA fragments from the bf16 relu output kept in shared memory (about 1%
// of the FLOPs); only n_classes columns of the logits are written. The
// lever left: every block streams all of W3 (1.18 MB) from L2, ~151 MB per
// image, which costs about as much as the bound; a thread-block cluster
// could multicast each W3 chunk to its blocks.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

#include "hopper.cuh"

using namespace nvcuda;
typedef __nv_bfloat16 bf16;

namespace {

constexpr int BK = 64;      // channels per K step
constexpr int C = 256;      // FFM / head width
constexpr int C_SP = 128;   // fsp channels
constexpr int C_CP = 256;   // fcp channels
constexpr int THREADS = 256;

typedef wmma::fragment<wmma::accumulator, 16, 16, 16, float> AccFrag;

// ---------------------------------------------------------------------------
// K2: grid (ceil(P / K2_BM), B), 256 threads = warpgroups 0 and 1, which own
// pixels [0, 64) and [64, 128) of the block's tile. Shared (dynamic, from a
// base aligned to 1024 bytes):
//   [0, 192K)            the ring: 4 stages of A 16 KB + W1 chunk 32 KB,
//                        laid out as K3's (below);
//   once the ring is drained, in its place:
//   [0, K2_RED_OFF)      feat, bf16 128 x K2_LDY (rows padded 16 B)
//   [K2_RED_OFF, +8 KB)  f32 column sums of each warp's 16 pixels,
//                        [warpgroup][warp][channel]
// Step s < 2 reads fsp channels 64s.. with w_sp rows 64s..; step s >= 2
// reads fcp channels 64(s-2).. with w_cp rows 64(s-2)...
// ---------------------------------------------------------------------------
constexpr int FFM_TILE_IN_CU = 64;                 // FFM_TILE in decoder_tail.py
constexpr int K2_BM = 128;                         // pixels per block
constexpr int K2_STAGES = 4;
constexpr int K2_STEPS = (C_SP + C_CP) / BK;       // 6
constexpr int K2_A_BYTES = K2_BM * BK * 2;         // 16 KB
constexpr int K2_STAGE_BYTES = K2_A_BYTES + BK * C * 2;  // + 32 KB of W1
constexpr int K2_LDY = C + 8;                      // feat row pitch
constexpr size_t K2_RED_OFF = (size_t)K2_BM * K2_LDY * 2;
constexpr size_t K2_SMEM = (size_t)K2_STAGES * K2_STAGE_BYTES + 1024;  // + align
static_assert(K2_BM == 2 * FFM_TILE_IN_CU,
              "each warpgroup's 64 pixels must be one FFM_TILE of sums");
static_assert(C_SP % BK == 0 && C_CP % BK == 0, "a step reads one source");
static_assert(K2_RED_OFF + 2 * 4 * C * 4 <= (size_t)K2_STAGES * K2_STAGE_BYTES,
              "the epilogue must fit in the drained ring");

__global__ void __launch_bounds__(THREADS, 1)
ffm_pointwise_kernel(const bf16* __restrict__ fsp, const bf16* __restrict__ fcp,
                     const bf16* __restrict__ w_sp, const bf16* __restrict__ w_cp,
                     const float* __restrict__ b1, bf16* __restrict__ feat,
                     float* __restrict__ sums, int P, int n_tiles) {
  extern __shared__ __align__(16) unsigned char k2_smem[];
  unsigned char* smem = k2_smem + ((1024 - (smem_addr(k2_smem) & 1023)) & 1023);

  const int tid = threadIdx.x, wg = tid / 128, lane = tid % 32;
  const int b = blockIdx.y, p0 = blockIdx.x * K2_BM;
  auto stage = [&](int s) { return smem_addr(smem + (s % K2_STAGES) * K2_STAGE_BYTES); };

  // Step s into its stage, all by cp.async: this thread's A chunks are
  // chunk ac of pixels ar + 32j (zero-filled past P), its W1 chunks rows
  // bk + 8j, chunk bn of 32, as K3 copies W3.
  const int ac = tid % 8, ar = tid / 8, bk = tid / 32, bn = tid % 32;
  auto load = [&](int s) {
    const bool sp = s < C_SP / BK;
    const int ld = sp ? C_SP : C_CP, k0 = (sp ? s : s - C_SP / BK) * BK;
    const bf16* src = (sp ? fsp : fcp) + (size_t)b * P * ld + k0 + ac * 8;
    const uint32_t a0 = stage(s);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int r = ar + 32 * j;
      const bool in = p0 + r < P;
      cp_async16_zfill(a0 + r * 128 + ((ac ^ (r & 7)) << 4),
                       src + (size_t)(in ? p0 + r : 0) * ld, in);
    }
    const bf16* w = (sp ? w_sp : w_cp) + ((size_t)k0 + bk) * C + bn * 8;
    const uint32_t dst = a0 + K2_A_BYTES + (bn / 8) * 1024 + bk * 128 +
                         (((bn % 8) ^ bk) << 4);
#pragma unroll
    for (int j = 0; j < 8; ++j) cp_async16(dst + j * 4096, w + (size_t)j * 8 * C);
  };

  float d[128];
#pragma unroll
  for (int i = 0; i < 128; ++i) d[i] = 0.f;
  for (int s = 0; s < K2_STAGES - 1; ++s) {
    load(s);
    cp_async_commit();
  }

  // Steps s+1 and s+2 are in flight while the tensor cores run step s.
  // Step s+3 goes to the stage of step s-1 once both warpgroups have
  // retired it (wgmma_wait<1> after issuing step s, then the barrier).
  for (int s = 0; s < K2_STEPS; ++s) {
    cp_async_wait<K2_STAGES - 2>();
    fence_proxy_async();
    __syncthreads();
    const uint32_t a0 = stage(s);
    fence_acc(d);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk)
      wgmma_m64n256k16(d, gmma_desc(a0 + wg * 8192 + kk * 32, 16, 1024),
                       gmma_desc(a0 + K2_A_BYTES + kk * 8192, 1024, 4096));
    wgmma_commit();
    wgmma_wait<1>();
    fence_acc(d);
    __syncthreads();
    if (s + K2_STAGES - 1 < K2_STEPS) load(s + K2_STAGES - 1);
    cp_async_commit();
  }
  wgmma_wait<0>();
  fence_acc(d);
  __syncthreads();  // the ring is drained: its space is reused below

  // + b1, relu. Accumulator 4j+{0,1} is (row, col+{0,1}) and 4j+{2,3} is
  // (row+8, col+{0,1}), with row = 16*warp + lane/4 in the warpgroup's 64
  // and col = 8j + 2*(lane%4). feat goes to shared memory in bf16; d keeps
  // this thread's sum of its two rows, rows past P left out.
  bf16* y_s = reinterpret_cast<bf16*>(smem);
  float* red = reinterpret_cast<float*>(smem + K2_RED_OFF);
  const int wq = (tid % 128) / 32;
  const int row = wg * 64 + wq * 16 + lane / 4;
  const bool in0 = p0 + row < P, in1 = p0 + row + 8 < P;
#pragma unroll
  for (int j = 0; j < 32; ++j) {
    const int col = 8 * j + 2 * (lane % 4);
    const float2 bias = *reinterpret_cast<const float2*>(b1 + col);
    const float y00 = fmaxf(d[4 * j] + bias.x, 0.f);
    const float y01 = fmaxf(d[4 * j + 1] + bias.y, 0.f);
    const float y10 = fmaxf(d[4 * j + 2] + bias.x, 0.f);
    const float y11 = fmaxf(d[4 * j + 3] + bias.y, 0.f);
    *reinterpret_cast<__nv_bfloat162*>(y_s + row * K2_LDY + col) =
        __floats2bfloat162_rn(y00, y01);
    *reinterpret_cast<__nv_bfloat162*>(y_s + (row + 8) * K2_LDY + col) =
        __floats2bfloat162_rn(y10, y11);
    d[4 * j] = (in0 ? y00 : 0.f) + (in1 ? y10 : 0.f);
    d[4 * j + 1] = (in0 ? y01 : 0.f) + (in1 ? y11 : 0.f);
  }
  // Over the 8 lanes that share a column (lane/4 = 0..7), then lanes 0-3
  // hold the warp's 16-pixel sums of all 256 channels.
#pragma unroll
  for (int j = 0; j < 32; ++j) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      float v = d[4 * j + e];
      v += __shfl_xor_sync(0xffffffffu, v, 4);
      v += __shfl_xor_sync(0xffffffffu, v, 8);
      v += __shfl_xor_sync(0xffffffffu, v, 16);
      d[4 * j + e] = v;
    }
  }
  if (lane < 4) {
#pragma unroll
    for (int j = 0; j < 32; ++j)
      *reinterpret_cast<float2*>(red + (wg * 4 + wq) * C + 8 * j + 2 * lane) =
          make_float2(d[4 * j], d[4 * j + 1]);
  }
  __syncthreads();

  const int rows = min(K2_BM, P - p0);
  bf16* fb = feat + ((size_t)b * P + p0) * C;
  for (int i = tid; i < rows * (C / 8); i += THREADS) {
    const int r = i / (C / 8), c = i % (C / 8);
    *reinterpret_cast<uint4*>(fb + (size_t)r * C + c * 8) =
        *reinterpret_cast<const uint4*>(y_s + r * K2_LDY + c * 8);
  }
  // One row of sums per warpgroup whose first pixel lies in the image;
  // thread tid is channel tid, the 4 warps added in order.
  for (int h = 0; h < 2; ++h) {
    const int tile = blockIdx.x * 2 + h;
    if (tile >= n_tiles) break;
    const float* rs = red + h * 4 * C + tid;
    sums[((size_t)b * n_tiles + tile) * C + tid] = ((rs[0] + rs[C]) + rs[2 * C]) + rs[3 * C];
  }
}

// ---------------------------------------------------------------------------
// K3: grid (ceil(H*W / K3_BM), B), 256 threads = warpgroups 0 and 1, which
// own pixels [0, 64) and [64, 128) of the block's tile. Shared (dynamic,
// from a base aligned to 1024 bytes, the period of the 128-byte swizzle):
//   [0, 192K)          the ring: 4 stages of A 16 KB + W3 chunk 32 KB;
//   once the ring is drained, in its place:
//   [0, K3_WC_OFF)     relu output, bf16 128 x K3_LDY (rows padded 16 B)
//   [K3_WC_OFF, ..)    classifier weight, bf16 C x n_pad
//   [K3_O_OFF, ..)     f32 logits tile, 128 x n_pad
//   [K3_SC_OFF, +512)  the channel scale in bf16, C values
//
// Swizzled layouts (byte offsets inside a stage; chunk = 16 bytes):
//   A (pixel r, channel k of the step's 64), K-major, 128 B per pixel:
//     r*128 + ((k/8 ^ r%8) << 4) + (k%8)*2
//   B (input channel k of the 64, output channel n), N-major in atoms of
//   64 n x 8 k (1 KB), atoms along n first, then along k:
//     (k/8)*4096 + (n/64)*1024 + (k%8)*128 + (((n/8)%8 ^ k%8) << 4) + (n%8)*2
// so the descriptors are: A, stride between 8-pixel groups 1024 B (leading
// offset unused); B, leading offset (next 64 n) 1024 B, stride offset (next
// 8 k) 4096 B. A k16 slice starts 32 B further along A's rows and 8 KB
// further along B.
// ---------------------------------------------------------------------------
constexpr int K3_BM = 128;                         // pixels per block
constexpr int K3_STAGES = 4;
constexpr int K3_STEPS = 9 * C / BK;               // 36 (tap, chunk) steps
constexpr int K3_A_BYTES = K3_BM * BK * 2;         // 16 KB
constexpr int K3_STAGE_BYTES = K3_A_BYTES + BK * C * 2;  // + 32 KB of W3
constexpr int K3_LDY = C + 8;                      // relu output row pitch
constexpr size_t K3_WC_OFF = (size_t)K3_BM * K3_LDY * 2;
constexpr size_t K3_O_OFF = K3_WC_OFF + (size_t)C * 128 * 2;
constexpr size_t K3_SC_OFF = K3_O_OFF + (size_t)K3_BM * 128 * 4;
constexpr size_t K3_SMEM = K3_SC_OFF + C * 2 + 1024;  // + room to align
static_assert((size_t)K3_STAGES * K3_STAGE_BYTES <= K3_SC_OFF,
              "the ring must not reach the scale");


__global__ void __launch_bounds__(THREADS, 1)
head_conv3x3_kernel(const bf16* __restrict__ feat, const float* __restrict__ scale,
                    const bf16* __restrict__ w3, const float* __restrict__ b3,
                    const bf16* __restrict__ wc, bf16* __restrict__ out,
                    int H, int W, int n_cls, int n_pad) {
  extern __shared__ __align__(16) unsigned char k3_smem[];
  unsigned char* smem = k3_smem + ((1024 - (smem_addr(k3_smem) & 1023)) & 1023);
  bf16* sc_s = reinterpret_cast<bf16*>(smem + K3_SC_OFF);

  const int tid = threadIdx.x, wg = tid / 128, lane = tid % 32;
  const int P = H * W;
  const int b = blockIdx.y, p0 = blockIdx.x * K3_BM, rows = min(K3_BM, P - p0);
  const bf16* fb = feat + (size_t)b * P * C;

  for (int i = tid; i < C; i += THREADS)
    sc_s[i] = __float2bfloat16_rn(scale[(size_t)b * C + i]);

  // This thread's share of an A tile: chunk ac of pixels ar + 32j, j < 4,
  // with y = -2 for pixels past the image (no tap reaches it).
  const int ac = tid % 8, ar = tid / 8;
  int py[4], px[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int p = p0 + ar + 32 * j;
    py[j] = p < P ? p / W : -2;
    px[j] = p % W;
  }

  // Step s is tap s/4, input channels 64*(s%4) + [0, 64). Its W3 chunk goes
  // to its ring stage by cp.async (rows bk + 8j, chunk bn of 32 in each).
  // Its A tile is fetched into registers a step before it is scaled and
  // stored, so the L2 round trip of the gather overlaps a whole step.
  const int bk = tid / 32, bn = tid % 32;
  auto stage = [&](int s) { return smem + (s % K3_STAGES) * K3_STAGE_BYTES; };
  auto copy_w3 = [&](int s) {
    const int tap = s / (C / BK), c0 = (s % (C / BK)) * BK;
    const uint32_t dst = smem_addr(stage(s) + K3_A_BYTES) + (bn / 8) * 1024 +
                         bk * 128 + (((bn % 8) ^ bk) << 4);
    const bf16* src = w3 + ((size_t)tap * C + c0 + bk) * C + bn * 8;
#pragma unroll
    for (int j = 0; j < 8; ++j) cp_async16(dst + j * 4096, src + (size_t)j * 8 * C);
  };
  uint4 v[4];
  auto fetch_a = [&](int s) {
    const int tap = s / (C / BK), c0 = (s % (C / BK)) * BK;
    const int di = tap / 3 - 1, dj = tap % 3 - 1;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int yy = py[j] + di, xx = px[j] + dj;
      v[j] = make_uint4(0, 0, 0, 0);
      if (yy >= 0 && yy < H && xx >= 0 && xx < W)
        v[j] = *reinterpret_cast<const uint4*>(fb + ((size_t)yy * W + xx) * C +
                                               c0 + ac * 8);
    }
  };
  auto store_a = [&](int s) {
    const int c0 = (s % (C / BK)) * BK;
    const uint4 sv = *reinterpret_cast<const uint4*>(sc_s + c0 + ac * 8);
    const __nv_bfloat162* s2 = reinterpret_cast<const __nv_bfloat162*>(&sv);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      // feat * scale in bf16: the exact f32 product, rounded once.
      __nv_bfloat162* e = reinterpret_cast<__nv_bfloat162*>(&v[j]);
#pragma unroll
      for (int t = 0; t < 4; ++t) {
        const float2 f = __bfloat1622float2(e[t]), g = __bfloat1622float2(s2[t]);
        e[t] = __floats2bfloat162_rn(f.x * g.x, f.y * g.y);
      }
      const int r = ar + 32 * j;
      *reinterpret_cast<uint4*>(stage(s) + r * 128 + ((ac ^ (r & 7)) << 4)) = v[j];
    }
  };

  float d[128];
#pragma unroll
  for (int i = 0; i < 128; ++i) d[i] = 0.f;
  __syncthreads();  // the scale
  for (int s = 0; s < 2; ++s) {
    copy_w3(s);
    cp_async_commit();
    fetch_a(s);
    store_a(s);
  }
  fetch_a(2);

  // Step s's W3 chunk and A tile were stored two steps earlier. Stage
  // (s+2)%4 last held step s-2, which both warpgroups have retired
  // (wgmma_wait<1> at the end of step s-1, then the barrier).
  for (int s = 0; s < K3_STEPS; ++s) {
    cp_async_wait<1>();
    fence_proxy_async();
    __syncthreads();
    const uint32_t a0 = smem_addr(stage(s));
    fence_acc(d);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk)
      wgmma_m64n256k16(d, gmma_desc(a0 + wg * 8192 + kk * 32, 16, 1024),
                       gmma_desc(a0 + K3_A_BYTES + kk * 8192, 1024, 4096));
    wgmma_commit();
    if (s + 2 < K3_STEPS) {
      copy_w3(s + 2);
      store_a(s + 2);
    }
    cp_async_commit();
    if (s + 3 < K3_STEPS) fetch_a(s + 3);
    wgmma_wait<1>();
    fence_acc(d);
  }
  wgmma_wait<0>();
  fence_acc(d);
  __syncthreads();  // the ring is drained: its space is reused below

  bf16* y_s = reinterpret_cast<bf16*>(smem);
  bf16* wc_s = reinterpret_cast<bf16*>(smem + K3_WC_OFF);
  float* o_s = reinterpret_cast<float*>(smem + K3_O_OFF);
  for (int i = tid; i < C * n_pad / 8; i += THREADS)
    reinterpret_cast<uint4*>(wc_s)[i] = reinterpret_cast<const uint4*>(wc)[i];

  // + b3, relu, bf16. Accumulator 4j+{0,1} is (row, col+{0,1}) and 4j+{2,3}
  // is (row+8, col+{0,1}), with row = 16*warp + lane/4 in the warpgroup's 64
  // and col = 8j + 2*(lane%4).
  const int row = wg * 64 + (tid % 128) / 32 * 16 + lane / 4;
#pragma unroll
  for (int j = 0; j < 32; ++j) {
    const int col = 8 * j + 2 * (lane % 4);
    const float2 bias = *reinterpret_cast<const float2*>(b3 + col);
    *reinterpret_cast<__nv_bfloat162*>(y_s + row * K3_LDY + col) =
        __floats2bfloat162_rn(fmaxf(d[4 * j] + bias.x, 0.f),
                              fmaxf(d[4 * j + 1] + bias.y, 0.f));
    *reinterpret_cast<__nv_bfloat162*>(y_s + (row + 8) * K3_LDY + col) =
        __floats2bfloat162_rn(fmaxf(d[4 * j + 2] + bias.x, 0.f),
                              fmaxf(d[4 * j + 3] + bias.y, 0.f));
  }
  __syncthreads();

  // Classifier: (128 x C) x (C x n_pad), fragments spread over the warps.
  const int warp = tid / 32;
  const int n_frag = (K3_BM / 16) * (n_pad / 16);
  for (int f = warp; f < n_frag; f += THREADS / 32) {
    const int fm = f % (K3_BM / 16), fn = f / (K3_BM / 16);
    AccFrag o;
    wmma::fill_fragment(o, 0.f);
    for (int kk = 0; kk < C; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> bw;
      wmma::load_matrix_sync(a, y_s + fm * 16 * K3_LDY + kk, K3_LDY);
      wmma::load_matrix_sync(bw, wc_s + kk * n_pad + fn * 16, n_pad);
      wmma::mma_sync(o, a, bw, o);
    }
    wmma::store_matrix_sync(o_s + fm * 16 * n_pad + fn * 16, o, n_pad,
                            wmma::mem_row_major);
  }
  __syncthreads();

  bf16* ob = out + ((size_t)b * P + p0) * n_cls;
  for (int i = tid; i < rows * n_cls; i += THREADS)
    ob[i] = __float2bfloat16_rn(o_s[(i / n_cls) * n_pad + i % n_cls]);
}

}  // namespace

// fsp (B,P,128), fcp (B,P,256), w_sp (128,256), w_cp (256,256) bf16;
// b1 (256) f32 -> feat (B,P,256) bf16, sums (B,n_tiles,256) f32 with
// n_tiles = ceil(P / 64). Returns cudaGetLastError() after the launch.
extern "C" int cabinet_ffm_pointwise(const void* fsp, const void* fcp,
                                     const void* w_sp, const void* w_cp,
                                     const void* b1, void* feat, void* sums,
                                     int B, int P, int n_tiles, void* stream) {
  cudaFuncSetAttribute(ffm_pointwise_kernel,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)K2_SMEM);
  const int blocks = (P + K2_BM - 1) / K2_BM;
  ffm_pointwise_kernel<<<dim3(blocks, B), THREADS, K2_SMEM, (cudaStream_t)stream>>>(
      (const bf16*)fsp, (const bf16*)fcp, (const bf16*)w_sp, (const bf16*)w_cp,
      (const float*)b1, (bf16*)feat, (float*)sums, P, n_tiles);
  return (int)cudaGetLastError();
}

// feat (B,H,W,256) bf16, scale (B,256) f32, w3 (9,256,256) bf16 [tap][in][out],
// b3 (256) f32, wc (256,n_pad) bf16 with n_pad % 16 == 0, n_pad <= 128
// -> out (B,H,W,n_cls) bf16. Returns cudaGetLastError() after the launch.
extern "C" int cabinet_head_conv3x3(const void* feat, const void* scale,
                                    const void* w3, const void* b3,
                                    const void* wc, void* out, int B, int H,
                                    int W, int n_cls, int n_pad, void* stream) {
  cudaFuncSetAttribute(head_conv3x3_kernel,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)K3_SMEM);
  const int tiles = (H * W + K3_BM - 1) / K3_BM;
  head_conv3x3_kernel<<<dim3(tiles, B), THREADS, K3_SMEM, (cudaStream_t)stream>>>(
      (const bf16*)feat, (const float*)scale, (const bf16*)w3,
      (const float*)b3, (const bf16*)wc, (bf16*)out, H, W, n_cls, n_pad);
  return (int)cudaGetLastError();
}
