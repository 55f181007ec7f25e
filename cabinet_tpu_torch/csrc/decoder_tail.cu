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
//   compute-bound on the tensor cores, 0.0196 ms at 989 TFLOP/s.
//
// Both kernels are implicit GEMMs over pixels of the flattened NHWC image.
// The TPU kernels' row tiles with a one-row halo become per-pixel (y, x)
// neighbour addressing: K3 reads each of the 9 taps of its pixels straight
// from global memory (L2 serves the reuse) and writes zeros for taps
// outside the image, so any H, W works and no tile needs a halo.
//
// K2: BM = 64 pixels x all 256 output channels per block, 8 warps in a 2x4
// grid each holding 32x64 of f32 accumulators in WMMA bf16 16x16x16
// fragments; K streams through shared memory in chunks of 64 channels (one
// stage). It writes one row of 256 sums per (image, tile) and the SE glue
// in PyTorch reduces them in a fixed order: no atomics, so the sums do not
// depend on block order.
//
// K3: 128 pixels x all 256 output channels per block (one wave of 128
// blocks on 132 SMs for a 128^2 image), two warpgroups of 64 pixels each
// with one wgmma.m64n256k16 accumulator. K = 9 taps x 256 channels runs in
// 36 steps of 64 channels through a ring of 4 stages in 128-byte-swizzled
// shared memory, the layouts wgmma reads from its descriptors without bank
// conflicts: the A tile K-major, the W3 chunk N-major as it lies in memory
// (wgmma transposes it). The loads of step s+2 are in flight while the
// tensor cores run step s: W3 by cp.async, A through registers, since it
// is a per-pixel gather, zero outside the image and multiplied by
// bf16(scale) before the product (which rules out a tiled TMA load). The
// 1x1 classifier runs on WMMA fragments from the bf16 relu output kept in
// shared memory (about 1% of the FLOPs); only n_classes columns of the
// logits are written. The lever left: every block streams all of W3
// (1.18 MB) from L2, ~151 MB per image, which costs about as much as the
// bound; a thread-block cluster could multicast each W3 chunk to its
// blocks.

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

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// wgmma shared-memory matrix descriptor, 128-byte swizzle; byte offsets.
__device__ __forceinline__ uint64_t gmma_desc(uint32_t addr, uint32_t lead,
                                              uint32_t stride) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(lead >> 4) << 16) |
         ((uint64_t)(stride >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst),
               "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keeps the compiler from moving reads or writes of the accumulators across
// the asynchronous wgmma instructions.
__device__ __forceinline__ void fence_acc(float (&d)[128]) {
#pragma unroll
  for (int i = 0; i < 128; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d (64 x 256 f32, this warpgroup's) += A (64 x 16 bf16, K-major) *
// B (16 x 256 bf16, N-major: transposed, the last immediate).
__device__ __forceinline__ void wgmma_m64n256k16(float (&d)[128], uint64_t da,
                                                 uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63,"
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79,"
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95,"
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111,"
      "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127},"
      " %128, %129, p, 1, 1, 0, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "l"(da), "l"(db), "r"(1));
}

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
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
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
  cudaFuncSetAttribute(head_conv3x3_kernel,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)K3_SMEM);
  const int tiles = (H * W + K3_BM - 1) / K3_BM;
  head_conv3x3_kernel<<<dim3(tiles, B), THREADS, K3_SMEM, (cudaStream_t)stream>>>(
      (const bf16*)feat, (const float*)scale, (const bf16*)w3,
      (const float*)b3, (const bf16*)wc, (bf16*)out, H, W, n_cls, n_pad);
  return (int)cudaGetLastError();
}
