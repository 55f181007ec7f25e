// Fused decoder tail for Hopper (sm_90a): kernels K2 and K3.
//
// K2 cabinet_ffm_pointwise replaces the Pallas kernel
//   cabinet_tpu/ops/decoder_tail.py:_k1_kernel (pallas_call at :169):
//   feat = relu(fsp W1_sp + fcp W1_cp + b1), the FFM 1x1 ConvBNReLU on
//   concat([fsp 128ch, fcp 256ch]) with the concat removed by splitting the
//   weight and BN folded, plus f32 channel sums of each tile of BM pixels.
// K3 cabinet_head_conv3x3 replaces the Pallas kernel
//   cabinet_tpu/ops/decoder_tail.py:_k2_kernel (pallas_call at :210):
//   per pixel, x = feat * bf16(scale) (zero outside the image), a 3x3 conv
//   256->256 with f32 accumulation, + b3, relu, rounded to bf16, then the
//   bias-free 1x1 classifier 256->n_classes, rounded to bf16.
//
// What bounds them, at the main path's S=128 (1024^2 input), per image:
//   K2 does 2*S^2*384*256 = 3.2 GFLOP and moves ~21 MB: memory-bound.
//   K3 does 2*S^2*256*(9*256 + n_classes) ~ 19.4 GFLOP and moves ~10 MB:
//   compute-bound on the tensor cores.
//
// Design. Both kernels are implicit GEMMs over pixels of the flattened
// NHWC image, BM = 64 pixels x all 256 output channels per block, with
// 8 warps in a 2x4 grid each holding 32x64 of f32 accumulators in WMMA
// bf16 16x16x16 fragments. The TPU kernels' row tiles with a one-row halo
// become per-pixel (y, x) neighbour addressing: K3 reads each of the 9 taps
// of its 64 pixels straight from global memory (L2 serves the reuse) and
// writes zeros for taps outside the image, so any H, W works and no tile
// needs a halo. The K dimension streams through shared memory in chunks of
// 64 channels (one stage, no cp.async/TMA, no wgmma: simple first).
// K2 writes one row of 256 sums per (image, tile) and the SE glue in
// PyTorch reduces them in a fixed order: no atomics, so the sums do not
// depend on block order. K3's classifier runs on the tensor cores from the
// bf16 relu output kept in shared memory; only n_classes columns of the
// logits are written.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

using namespace nvcuda;
typedef __nv_bfloat16 bf16;

namespace {

constexpr int BM = 64;      // pixels per block (FFM_TILE in decoder_tail.py)
constexpr int BK = 64;      // channels per K chunk
constexpr int C = 256;      // FFM / head width
constexpr int C_SP = 128;   // fsp channels
constexpr int C_CP = 256;   // fcp channels
constexpr int THREADS = 256;

typedef wmma::fragment<wmma::accumulator, 16, 16, 16, float> AccFrag;

// acc[2][4] (this warp's 32x64 slice of BM x C) += A (BM x BK) B (BK x C).
__device__ void mma_chunk(AccFrag (&acc)[2][4], const bf16* a_s,
                          const bf16* b_s, int wm, int wn) {
  for (int kk = 0; kk < BK; kk += 16) {
    wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a[2];
    for (int i = 0; i < 2; ++i)
      wmma::load_matrix_sync(a[i], a_s + (wm * 32 + i * 16) * BK + kk, BK);
    for (int j = 0; j < 4; ++j) {
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> bw;
      wmma::load_matrix_sync(bw, b_s + kk * C + wn * 64 + j * 16, C);
      for (int i = 0; i < 2; ++i) wmma::mma_sync(acc[i][j], a[i], bw, acc[i][j]);
    }
  }
}

// Copies a contiguous BK x C bf16 weight chunk into shared memory.
__device__ void load_weight_chunk(bf16* b_s, const bf16* w) {
  for (int i = threadIdx.x; i < BK * C / 8; i += THREADS)
    reinterpret_cast<uint4*>(b_s)[i] = reinterpret_cast<const uint4*>(w)[i];
}

__device__ void store_acc(float* c_s, AccFrag (&acc)[2][4], int wm, int wn) {
  for (int i = 0; i < 2; ++i)
    for (int j = 0; j < 4; ++j)
      wmma::store_matrix_sync(c_s + (wm * 32 + i * 16) * C + wn * 64 + j * 16,
                              acc[i][j], C, wmma::mem_row_major);
}

// ---------------------------------------------------------------------------
// K2: grid (n_tiles, B). Shared: A chunk 8 KB + W chunk 32 KB, then the
// 64 KB f32 accumulator tile.
// ---------------------------------------------------------------------------
__global__ void __launch_bounds__(THREADS)
ffm_pointwise_kernel(const bf16* __restrict__ fsp, const bf16* __restrict__ fcp,
                     const bf16* __restrict__ w_sp, const bf16* __restrict__ w_cp,
                     const float* __restrict__ b1, bf16* __restrict__ feat,
                     float* __restrict__ sums, int P, int n_tiles) {
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* a_s = reinterpret_cast<bf16*>(smem);
  bf16* b_s = a_s + BM * BK;
  float* c_s = reinterpret_cast<float*>(smem);

  const int tile = blockIdx.x, b = blockIdx.y;
  const int p0 = tile * BM, rows = min(BM, P - p0);
  const int warp = threadIdx.x / 32, wm = warp / 4, wn = warp % 4;

  AccFrag acc[2][4];
  for (int i = 0; i < 2; ++i)
    for (int j = 0; j < 4; ++j) wmma::fill_fragment(acc[i][j], 0.f);

  for (int k0 = 0; k0 < C_SP + C_CP; k0 += BK) {
    const bool sp = k0 < C_SP;
    const bf16* src = sp ? fsp : fcp;
    const int ld = sp ? C_SP : C_CP, kk = sp ? k0 : k0 - C_SP;
    for (int i = threadIdx.x; i < BM * BK / 8; i += THREADS) {
      const int r = i / (BK / 8), c = (i % (BK / 8)) * 8;
      uint4 val = make_uint4(0, 0, 0, 0);
      if (r < rows)
        val = *reinterpret_cast<const uint4*>(
            src + ((size_t)b * P + p0 + r) * ld + kk + c);
      *reinterpret_cast<uint4*>(a_s + r * BK + c) = val;
    }
    load_weight_chunk(b_s, sp ? w_sp + (size_t)kk * C : w_cp + (size_t)kk * C);
    __syncthreads();
    mma_chunk(acc, a_s, b_s, wm, wn);
    __syncthreads();
  }
  store_acc(c_s, acc, wm, wn);
  __syncthreads();

  // One thread per channel: bias, relu, bf16 store, and the tile's sum of
  // the f32 values in a fixed row order.
  const int c = threadIdx.x;
  const float bias = b1[c];
  float sum = 0.f;
  bf16* out = feat + ((size_t)b * P + p0) * C + c;
  for (int r = 0; r < rows; ++r) {
    const float y = fmaxf(c_s[r * C + c] + bias, 0.f);
    sum += y;
    out[(size_t)r * C] = __float2bfloat16_rn(y);
  }
  sums[((size_t)b * n_tiles + tile) * C + c] = sum;
}

// ---------------------------------------------------------------------------
// K3: grid (ceil(H*W / BM), B). Shared (dynamic):
//   [0, 64K)      A chunk 8 KB + W3 chunk 32 KB; then the f32 conv tile;
//                 then the f32 logits tile (BM x n_pad)
//   [64K, 96K)    relu output, bf16 BM x C
//   [96K, ...)    classifier weight, bf16 C x n_pad
//   then          the channel scale in bf16, C values
// ---------------------------------------------------------------------------
constexpr size_t K3_Y_OFF = 64 * 1024;
constexpr size_t K3_WC_OFF = 96 * 1024;

__global__ void __launch_bounds__(THREADS)
head_conv3x3_kernel(const bf16* __restrict__ feat, const float* __restrict__ scale,
                    const bf16* __restrict__ w3, const float* __restrict__ b3,
                    const bf16* __restrict__ wc, bf16* __restrict__ out,
                    int H, int W, int n_cls, int n_pad) {
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* a_s = reinterpret_cast<bf16*>(smem);
  bf16* b_s = a_s + BM * BK;
  float* c_s = reinterpret_cast<float*>(smem);
  bf16* y_s = reinterpret_cast<bf16*>(smem + K3_Y_OFF);
  bf16* wc_s = reinterpret_cast<bf16*>(smem + K3_WC_OFF);
  bf16* sc_s = wc_s + C * n_pad;

  const int P = H * W;
  const int b = blockIdx.y, p0 = blockIdx.x * BM, rows = min(BM, P - p0);
  const int warp = threadIdx.x / 32, wm = warp / 4, wn = warp % 4;
  const bf16* fb = feat + (size_t)b * P * C;

  for (int i = threadIdx.x; i < C; i += THREADS)
    sc_s[i] = __float2bfloat16_rn(scale[(size_t)b * C + i]);
  for (int i = threadIdx.x; i < C * n_pad / 8; i += THREADS)
    reinterpret_cast<uint4*>(wc_s)[i] = reinterpret_cast<const uint4*>(wc)[i];
  __syncthreads();

  AccFrag acc[2][4];
  for (int i = 0; i < 2; ++i)
    for (int j = 0; j < 4; ++j) wmma::fill_fragment(acc[i][j], 0.f);

  for (int tap = 0; tap < 9; ++tap) {
    const int di = tap / 3 - 1, dj = tap % 3 - 1;
    for (int c0 = 0; c0 < C; c0 += BK) {
      for (int i = threadIdx.x; i < BM * BK / 8; i += THREADS) {
        const int r = i / (BK / 8), c = (i % (BK / 8)) * 8;
        uint4 val = make_uint4(0, 0, 0, 0);
        if (r < rows) {
          const int p = p0 + r, yy = p / W + di, xx = p % W + dj;
          if (yy >= 0 && yy < H && xx >= 0 && xx < W) {
            val = *reinterpret_cast<const uint4*>(
                fb + ((size_t)yy * W + xx) * C + c0 + c);
            bf16* e = reinterpret_cast<bf16*>(&val);
            // feat * scale in bf16: the exact f32 product, rounded once.
            for (int t = 0; t < 8; ++t)
              e[t] = __float2bfloat16_rn(__bfloat162float(e[t]) *
                                         __bfloat162float(sc_s[c0 + c + t]));
          }
        }
        *reinterpret_cast<uint4*>(a_s + r * BK + c) = val;
      }
      load_weight_chunk(b_s, w3 + ((size_t)tap * C + c0) * C);
      __syncthreads();
      mma_chunk(acc, a_s, b_s, wm, wn);
      __syncthreads();
    }
  }
  store_acc(c_s, acc, wm, wn);
  __syncthreads();

  for (int i = threadIdx.x; i < BM * C; i += THREADS)
    y_s[i] = __float2bfloat16_rn(fmaxf(c_s[i] + b3[i % C], 0.f));
  __syncthreads();

  // Classifier: (BM x C) x (C x n_pad), fragments spread over the warps.
  float* o_s = c_s;  // the conv tile is consumed
  const int n_frag = (BM / 16) * (n_pad / 16);
  for (int f = warp; f < n_frag; f += THREADS / 32) {
    const int fm = f % (BM / 16), fn = f / (BM / 16);
    AccFrag o;
    wmma::fill_fragment(o, 0.f);
    for (int kk = 0; kk < C; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> bw;
      wmma::load_matrix_sync(a, y_s + fm * 16 * C + kk, C);
      wmma::load_matrix_sync(bw, wc_s + kk * n_pad + fn * 16, n_pad);
      wmma::mma_sync(o, a, bw, o);
    }
    wmma::store_matrix_sync(o_s + fm * 16 * n_pad + fn * 16, o, n_pad,
                            wmma::mem_row_major);
  }
  __syncthreads();

  bf16* ob = out + ((size_t)b * P + p0) * n_cls;
  for (int i = threadIdx.x; i < rows * n_cls; i += THREADS)
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
  const size_t smem = (size_t)BM * C * sizeof(float);  // >= A + W chunks
  cudaFuncSetAttribute(ffm_pointwise_kernel,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  ffm_pointwise_kernel<<<dim3(n_tiles, B), THREADS, smem, (cudaStream_t)stream>>>(
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
  const size_t smem = K3_WC_OFF + (size_t)C * n_pad * sizeof(bf16) +
                      (size_t)C * sizeof(bf16);
  cudaFuncSetAttribute(head_conv3x3_kernel,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  const int tiles = (H * W + BM - 1) / BM;
  head_conv3x3_kernel<<<dim3(tiles, B), THREADS, smem, (cudaStream_t)stream>>>(
      (const bf16*)feat, (const float*)scale, (const bf16*)w3,
      (const float*)b3, (const bf16*)wc, (bf16*)out, H, W, n_cls, n_pad);
  return (int)cudaGetLastError();
}
