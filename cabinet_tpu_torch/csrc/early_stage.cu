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
// What bounds it: per output pixel 27*16 + 9*16 + 16*16 = 832 multiply-adds
// in f32, against 12 bytes of bf16 input and 64 (f32) or 32 (bf16) bytes
// of planes. On (8,1024,1024,3) that is 3.49 GFLOP, 0.052 ms on the f32
// SIMT rate of 67 TFLOP/s, against 0.030 ms (bf16 x, f32 planes) of
// memory traffic at 3.35 TB/s. As f32 FMAs, one FFMA each, instruction
// issue bounds it (~0.07 ms), and the loads that feed the FFMAs (weights,
// inputs, stem values) cost as much again. The design:
//   - The stem (52% of the multiply-adds) runs on the tensor cores: x is
//     bf16 already, and each f32 weight is split into three bf16 parts
//     (w = p0 + p1 + p2 to about 2^-24 of |w|), so mma.sync.m16n8k16 with
//     f32 sums gives the f32 stem to rounding. A warp takes one stem row of
//     a step, 16 pixels (the product's rows) by 32 taps (the 27, zero-
//     padded) by 16 channels per group: 12 mma for 16 pixels instead of
//     6,912 FFMAs. The weights' B fragments are built once per block into
//     shared memory; the bias starts the sums; hardswish in registers.
//   - The depthwise and pointwise stay f32 FFMAs. The 880 folded weights
//     live in a __constant__ block that the launcher fills from the packed
//     device buffer with one device-to-device copy on the launch's stream
//     (a CUDA graph captures it); every loop over them is unrolled, so no
//     shared-memory load comes before an FFMA for its weight. ptxas for
//     sm_90a gives no FFMA a constant-bank operand: it loads the weights
//     two at a time into uniform registers (ULDC.64), which the FFMAs
//     read, whatever the source form (a __constant__ array or a kernel
//     parameter). So each thread takes two neighbouring output pixels, and
//     one ULDC.64 feeds four FFMAs; a pair reads its 4 stem columns as
//     float2s, 96 shared loads for 800 FFMAs. The constant block is shared
//     by every launch of this library: two launches with different weights
//     on concurrent streams would race.
//   - A block of 256 threads owns a strip of 64 output columns and 64 rows
//     (32 where 64 would leave an SM with fewer than two blocks) and walks
//     it down in steps of 8 rows, with the stem in a ring of 10 f32 rows (16
//     channel planes of 66 columns, a stride of 68 against bank conflicts)
//     and the input in a ring of 21 rows of x as they lie in memory. The
//     stem is computed once for each of its rows and for one halo column
//     on each side: 66/64 x 66/64, 6.3% more stem work than outputs (9.6%
//     at 32 rows), against 19.5% for the 16 x 32 tiles this replaces. Each
//     phase runs in one round: 8 warps for the 8 stem rows, 256 threads for
//     the 256 output pairs.
//   - The input rows of the next step are copied into the ring by
//     cp.async, 16 bytes a thread, as the interleaved NHWC rows lie (rows
//     outside the image zero-filled by the copy), while the depthwise and
//     pointwise of this step run; the first 21 rows, while the block
//     builds its B fragments. The stem's A fragments read them there,
//     rounding f32 x to bf16, so no pass de-interleaves them; only the
//     leftmost strip zeroes the 3 window columns left of the image.
//   - Each warp computes one output row of 64 pixels, contiguous in the
//     channels-last planes, stages it in shared memory and stores it with
//     16-byte stores of consecutive chunks: a thread's own two pixels
//     (128 bytes in f32) would touch 32 lines per store instruction.
//   - 78 KB (bf16) or 111 KB (f32 x and planes) of shared memory, raised
//     once per device and instance, and 128 registers a thread: two blocks
//     (512 threads) an SM. A cap of 80 registers for three blocks spilled
//     and ran at less than half the speed.
// The planes are kept in channels-last memory: the (B,16,H/2,W/2) tensor
// has the strides of (B,H/2,W/2,16), the layout the rest of the network
// runs in (its NHWC input, permuted, is channels-last; the JAX package
// transposes the planes to NHWC at once). Stored plane by plane, they
// would put every later convolution on cuDNN's NCHW kernels, which made
// the batch-8 forward slower on an H100 (PERF.md).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

typedef __nv_bfloat16 bf16;

namespace {

constexpr int C = 16;                       // stem and block_0 width
constexpr int TW = 64;                      // output columns a block
constexpr int RH = 32, RH_TALL = 64;        // output rows a block
constexpr int SR = 8;                       // output rows a step
constexpr int SW = TW + 2;                  // stem columns: 1 halo each side
constexpr int IW = 2 * SW + 1;              // input window columns: 133
constexpr int S_ROWS = SR + 2;              // stem ring rows
constexpr int I_ROWS = 2 * SR + 5;          // input ring rows: all of step 0's
constexpr int NEW_ROWS = 2 * SR;            // input rows copied a step
constexpr int EDGE = 9;                     // window columns 0..2 (x 3 channels)
constexpr int SHIFTS = (I_ROWS + 3) / 4 * 4;  // the ring's shifts, 16-byte padded
constexpr int SWP = 68;                     // stem row stride: conflict-free stores
constexpr int OUT_PAIRS = SR * TW / 2;      // output pixel pairs a step: 256
constexpr int THREADS = OUT_PAIRS;          // 8 warps; warp w: stem row w of a step
constexpr int GROUPS = (SW + 15) / 16;      // 16-pixel groups of a stem row: 5
// The stem's K: its 27 taps (ci*9 + i*3 + j) as 14 pairs of bf16 in 2 k16
// steps, taps 27..31 zero; each f32 weight as the sum of 3 bf16 parts.
constexpr int TAPS = 27, KSTEPS = 2, SPLITS = 3;
constexpr int B_REGS = 2 * KSTEPS * SPLITS * 2;  // B-fragment registers a lane: 24
constexpr int N_W = C * 27 + C + 9 * C + C + C * C + C;  // 880 weights

// The folded weights, in the packed order of ops/early_stage.py:
// wstem (16,27) | bstem | wdw (3,3,16) | bdw | wpw (16 out,16 in) | bpw.
__constant__ float c_w[N_W];
constexpr int W_STEM = 0, B_STEM = 432, W_DW = 448, B_DW = 592, W_PW = 608,
              B_PW = 864;
static_assert(B_PW + C == N_W, "packed weight layout");

// An input row of the ring: the 16-byte chunks of x (aligned to its base)
// that cover the row's window of 399 elements (133 pixels x 3 channels).
template <typename TIn>
struct Raw {
  static constexpr int EPC = 16 / sizeof(TIn);               // elements a chunk
  static constexpr int NCH = (3 * IW + EPC - 2) / EPC + 1;     // chunks a row
};

// 16-byte chunks of one output pixel's 16 channels: 4 (f32) or 2 (bf16).
template <typename TOut>
constexpr int CPP = C * sizeof(TOut) / 16;

template <typename TIn, typename TOut>
constexpr size_t smem_bytes() {
  return (size_t)S_ROWS * C * SWP * sizeof(float) +           // stem ring
         (size_t)I_ROWS * Raw<TIn>::NCH * 16 +                 // input ring
         SHIFTS * sizeof(int) +                                // its shifts
         (size_t)B_REGS * 32 * sizeof(uint32_t) +              // stem B fragments
         (size_t)(THREADS / 32) * TW * CPP<TOut> * 16;          // output rows
}

// Two values of x as a bf16 pair, lo in the low half, rounded to bf16.
__device__ __forceinline__ uint32_t bf16x2(bf16 lo, bf16 hi) {
  return (uint32_t)__bfloat16_as_ushort(lo) | (uint32_t)__bfloat16_as_ushort(hi) << 16;
}
__device__ __forceinline__ uint32_t bf16x2(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&h);
}

// The part s (0, 1, 2) of w's split into three bf16: w = p0 + p1 + p2 to
// about 2^-24 of |w|.
__device__ __forceinline__ bf16 weight_part(float w, int s) {
  const bf16 p0 = __float2bfloat16_rn(w);
  const float r1 = w - __bfloat162float(p0);
  const bf16 p1 = __float2bfloat16_rn(r1);
  return s == 0 ? p0 : s == 1 ? p1 : __float2bfloat16_rn(r1 - __bfloat162float(p1));
}

// c (16 x 8 f32) += a (16 x 16 bf16, row-major) * b (16 x 8 bf16, col-major),
// one warp; fragments as PTX lays them out for m16n8k16 (g = lane / 4,
// t = lane % 4): a0 (row g, k 2t..2t+1), a1 (row g+8, same k), a2 (row g,
// k 2t+8..2t+9), a3 (row g+8, same k); b0 (k 2t..2t+1, n g), b1 (k
// 2t+8..2t+9, n g); c0, c1 (row g, n 2t, 2t+1), c2, c3 (row g+8, same n).
__device__ __forceinline__ void mma_16816(float (&c)[4], const uint32_t (&a)[4],
                                          uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// `bytes` (0..16) from src, the rest of the 16 zero-filled; src must be a
// valid, 16-byte aligned address even when bytes is 0.
__device__ __forceinline__ void cp_async16_n(uint32_t dst, const void* src, int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(bytes) : "memory");
}

// A pixel's 16 channels as its CPP 16-byte chunks.
__device__ __forceinline__ void to_chunks(const float* v, uint4 (&out)[4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
    out[i] = make_uint4(__float_as_uint(v[4 * i]), __float_as_uint(v[4 * i + 1]),
                        __float_as_uint(v[4 * i + 2]), __float_as_uint(v[4 * i + 3]));
}
__device__ __forceinline__ void to_chunks(const float* v, uint4 (&out)[2]) {
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    __nv_bfloat162 h[4];
#pragma unroll
    for (int j = 0; j < 4; ++j)
      h[j] = __floats2bfloat162_rn(v[8 * i + 2 * j], v[8 * i + 2 * j + 1]);
    out[i] = *reinterpret_cast<const uint4*>(h);
  }
}

// v * (clamp(v + 3, 0, 6) * (1/6)), the plain version's formula, to the
// bit: (v + 3) * (1/6) saturated to [0, 1] is that clamp times 1/6 (6 *
// fl(1/6) rounds to 1), and the saturation folds into the multiply.
__device__ __forceinline__ float hardswish(float v) {
  return v * __saturatef((v + 3.f) * (1.f / 6.f));
}

// grid (ceil(W/2 / 64), ceil(H/2 / rh), B), 256 threads; rh is RH or RH_TALL.
template <typename TIn, typename TOut>
__global__ void __launch_bounds__(THREADS, 2)
stem_block0_kernel(const TIn* __restrict__ x, const float* __restrict__ wg,
                   TOut* __restrict__ out, int H, int W, int rh) {
  using R = Raw<TIn>;
  extern __shared__ __align__(16) unsigned char smem[];
  float* stem_s = reinterpret_cast<float*>(smem);                   // (10, 16, SWP)
  uint4* in_s = reinterpret_cast<uint4*>(stem_s + S_ROWS * C * SWP);  // (21, NCH)
  int* shift_s = reinterpret_cast<int*>(in_s + I_ROWS * R::NCH);     // (21,)
  uint32_t* b_s = reinterpret_cast<uint32_t*>(shift_s + SHIFTS);     // (24, 32 lanes)
  uint4* o_s = reinterpret_cast<uint4*>(b_s + B_REGS * 32);          // (8 warps, 64 px, CPP)
  TIn* in_e = reinterpret_cast<TIn*>(in_s);
  constexpr int ROW_E = R::NCH * R::EPC;  // elements a ring row

  const int tid = threadIdx.x;
  const int H2 = H / 2, W2 = W / 2;
  const int b = blockIdx.z, x0 = blockIdx.x * TW, y0 = blockIdx.y * rh;
  const int ix0 = 2 * x0 - 3;      // image column of window column 0
  const int iy_base = 2 * y0 - 3;  // image row held in input ring row 0
  const int n_steps = min(rh, H2 - y0 + SR - 1) / SR;
  const long long n_all = (long long)gridDim.z * H * W * 3;  // elements of x

  auto in_slot = [&](int iy) { return (iy - iy_base) % I_ROWS; };
  auto stem_slot = [&](int sy) { return (sy - (y0 - 1)) % S_ROWS; };

  // cp.async the chunks of `rows` image rows from iy0 into their ring rows,
  // and each row's shift (its window's first element within its first
  // chunk). Rows outside the image are zero-filled; so is a chunk's part
  // past the end of x.
  auto stage = [&](int iy0, int rows) {
    for (int u = tid; u < rows * R::NCH; u += THREADS) {
      const int r = u / R::NCH, j = u - r * R::NCH;
      const int iy = iy0 + r, slot = in_slot(iy);
      const long long e0 = ((long long)(b * H + iy) * W + ix0) * 3;
      const long long c0 = (e0 >= 0 ? e0 : e0 - R::EPC + 1) / R::EPC;
      const long long a = (c0 + j) * R::EPC;
      const long long n = iy >= 0 && iy < H && a >= 0
                              ? max(0LL, min(n_all - a, (long long)R::EPC)) : 0;
      cp_async16_n(smem_addr(in_s + slot * R::NCH + j), x + (n > 0 ? a : 0),
                   (int)n * (int)sizeof(TIn));
      if (j == 0) shift_s[slot] = (int)(e0 - c0 * R::EPC);
    }
    cp_async_commit();
  };
  // Once the rows have landed: in the leftmost strip, window columns 0..2
  // (image columns -3..-1) hold the previous row's last pixels; zero them
  // (the stem's zero padding). Elsewhere a window column outside the image
  // feeds only stem pixels outside the stem grid, which are zeroed.
  auto zero_left_edge = [&](int iy0, int rows) {
    if (x0 != 0) return;
    for (int u = tid; u < rows * EDGE; u += THREADS) {
      const int slot = in_slot(iy0 + u / EDGE);
      in_e[slot * ROW_E + shift_s[slot] + u % EDGE] = TIn(0.f);
    }
  };

  // The stem as a product on the tensor cores: for each 16-pixel group of
  // a stem row, (16 pixels x 32 taps) bf16 inputs times (32 taps x 16
  // channels) weights, each weight as 3 bf16 parts, summed in f32. x is
  // bf16 already, so the products are exact. Register r of lane l's B
  // fragments, r = ((n-tile * 2 + k-step) * 3 + part) * 2 + (b0 | b1), at
  // b_s[r * 32 + l], from the weights in device memory (wg, the packed
  // buffer the constant block is copied from).
  stage(iy_base, I_ROWS);  // rows 2y0-3 .. 2y0+17, in flight while the table is built
  for (int u = tid; u < B_REGS * 32; u += THREADS) {
    const int r = u / 32, g = u % 32 / 4, t = u % 4;
    const int hb = r % 2, part = r / 2 % SPLITS, ks = r / (2 * SPLITS) % KSTEPS;
    const int n = 8 * (r / (2 * SPLITS * KSTEPS)) + g;
    const int tap = 16 * ks + 2 * t + 8 * hb;
    const float w0 = tap < TAPS ? wg[W_STEM + n * TAPS + tap] : 0.f;
    const float w1 = tap + 1 < TAPS ? wg[W_STEM + n * TAPS + tap + 1] : 0.f;
    b_s[u] = (uint32_t)__bfloat16_as_ushort(weight_part(w0, part)) |
             (uint32_t)__bfloat16_as_ushort(weight_part(w1, part)) << 16;
  }

  // Stem + hardswish of stem rows [sy0, sy0 + rows), warp w row sy0 + w,
  // all 66 columns and 16 channels into the ring, zero outside the stem
  // grid (the depthwise's zero padding).
  auto stem_rows = [&](int sy0, int rows) {
    const int w = tid / 32, lane = tid % 32, g = lane / 4, t = lane % 4;
    if (w >= rows) return;
    const int sy = sy0 + w;
    float* dst = stem_s + stem_slot(sy) * C * SWP;
    if (sy < 0 || sy >= H2) {
      for (int u = lane; u < C * SWP; u += 32) dst[u] = 0.f;
      return;
    }
    uint32_t bf[B_REGS];
#pragma unroll
    for (int r = 0; r < B_REGS; ++r) bf[r] = b_s[r * 32 + lane];
    // The taps this lane feeds: k = 16ks + 2t + 8hb + e (e = 0, 1), tap k
    // of pixel lc at ap[ks][hb][e] + 6 lc (window column 2lc + j of input
    // row 2sy - 1 + i, channel ci, in the interleaved ring row). Taps past
    // 26 read tap 0: their weights are zero, and x is finite.
    const TIn* ap[KSTEPS][2][2];
#pragma unroll
    for (int ks = 0; ks < KSTEPS; ++ks)
#pragma unroll
      for (int hb = 0; hb < 2; ++hb)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int k = 16 * ks + 2 * t + 8 * hb + e, kk = k < TAPS ? k : 0;
          const int slot = in_slot(2 * sy - 1 + kk % 9 / 3);
          ap[ks][hb][e] = in_e + slot * ROW_E + shift_s[slot] + 3 * (kk % 3) + kk / 9;
        }
    float bias[2][2];
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int e = 0; e < 2; ++e) bias[nt][e] = wg[B_STEM + 8 * nt + 2 * t + e];
    // Two 16-pixel groups at a time: four independent chains of 6 mma.
#pragma unroll
    for (int q0 = 0; q0 < GROUPS; q0 += 2) {
      constexpr int NQ = 2;
      uint32_t a[NQ][KSTEPS][4];
      float c[NQ][2][4];
#pragma unroll
      for (int qq = 0; qq < NQ; ++qq) {
        if (q0 + qq >= GROUPS) continue;
        // Pixels (rows of the product) lc = 16q + g and 16q + g + 8.
        const int lc_a = 16 * (q0 + qq) + g, lc_b = lc_a + 8;
#pragma unroll
        for (int ks = 0; ks < KSTEPS; ++ks)
#pragma unroll
          for (int hb = 0; hb < 2; ++hb)
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              const int lc = 6 * min(h ? lc_b : lc_a, SW - 1);
              a[qq][ks][2 * hb + h] = bf16x2(ap[ks][hb][0][lc], ap[ks][hb][1][lc]);
            }
#pragma unroll
        for (int nt = 0; nt < 2; ++nt) {
          c[qq][nt][0] = c[qq][nt][2] = bias[nt][0];
          c[qq][nt][1] = c[qq][nt][3] = bias[nt][1];
        }
      }
#pragma unroll
      for (int ks = 0; ks < KSTEPS; ++ks)
#pragma unroll
        for (int part = 0; part < SPLITS; ++part)
#pragma unroll
          for (int nt = 0; nt < 2; ++nt)
#pragma unroll
            for (int qq = 0; qq < NQ; ++qq) {
              if (q0 + qq >= GROUPS) continue;
              const int r = ((nt * KSTEPS + ks) * SPLITS + part) * 2;
              mma_16816(c[qq][nt], a[qq][ks], bf[r], bf[r + 1]);
            }
#pragma unroll
      for (int qq = 0; qq < NQ; ++qq)
#pragma unroll
        for (int nt = 0; nt < 2; ++nt) {
          if (q0 + qq >= GROUPS) continue;
          float* ch = dst + (8 * nt + 2 * t) * SWP;
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int lc = 16 * (q0 + qq) + g + 8 * h, sx = x0 - 1 + lc;
            if (lc >= SW) continue;
            const bool in = sx >= 0 && sx < W2;
            ch[lc] = in ? hardswish(c[qq][nt][2 * h]) : 0.f;
            ch[SWP + lc] = in ? hardswish(c[qq][nt][2 * h + 1]) : 0.f;
          }
        }
    }
  };

  // Prologue: once the rows have landed, stem rows y0-1 and y0.
  cp_async_wait<0>();
  __syncthreads();
  zero_left_edge(iy_base, I_ROWS);
  __syncthreads();
  stem_rows(y0 - 1, 2);

  TOut* ob = out + (size_t)b * H2 * W2 * C;
  for (int k = 0; k < n_steps; ++k) {
    const int oy0 = y0 + SR * k;
    // Stem rows oy0+1 .. oy0+8 from input rows 2*oy0+1 .. 2*oy0+17.
    stem_rows(oy0 + 1, SR);
    __syncthreads();
    const bool more = k + 1 < n_steps;
    if (more) stage(2 * oy0 + 2 * SR + 2, NEW_ROWS);

    // Depthwise + relu, pointwise + bias + residual of output pixels
    // (oy, ox) and (oy, ox + 1): stem columns 2p .. 2p+3 of the strip.
    // Warp r takes output row oy0 + r, lane p the pair p.
    const int r = tid / (TW / 2), p = tid - r * (TW / 2);
    const int oy = oy0 + r;
    if (oy < H2) {
      float dw_a[C], dw_b[C], res_a[C], res_b[C];
#pragma unroll
      for (int c = 0; c < C; ++c) {
        float acc_a = c_w[B_DW + c], acc_b = acc_a;
#pragma unroll
        for (int i = 0; i < 3; ++i) {
          const float* s = stem_s + (stem_slot(oy - 1 + i) * C + c) * SWP + 2 * p;
          const float2 s01 = *reinterpret_cast<const float2*>(s);
          const float2 s23 = *reinterpret_cast<const float2*>(s + 2);
          const float v[4] = {s01.x, s01.y, s23.x, s23.y};
#pragma unroll
          for (int j = 0; j < 3; ++j) {
            const float w = c_w[W_DW + (i * 3 + j) * C + c];
            acc_a = fmaf(v[j], w, acc_a);
            acc_b = fmaf(v[j + 1], w, acc_b);
          }
          if (i == 1) {  // the residual and the pointwise bias
            res_a[c] = v[1] + c_w[B_PW + c];
            res_b[c] = v[2] + c_w[B_PW + c];
          }
        }
        dw_a[c] = fmaxf(acc_a, 0.f);
        dw_b[c] = fmaxf(acc_b, 0.f);
      }
#pragma unroll
      for (int co = 0; co < C; ++co)
#pragma unroll
        for (int ci = 0; ci < C; ++ci) {
          const float w = c_w[W_PW + co * C + ci];
          res_a[co] = fmaf(dw_a[ci], w, res_a[co]);
          res_b[co] = fmaf(dw_b[ci], w, res_b[co]);
        }
      // The warp's row of 64 pixels is contiguous in the channels-last
      // planes: stage it in shared memory (lane p's PC chunks at chunk ^
      // (p % PC) of its block, so that neither side has bank conflicts),
      // then store it with 16-byte stores of consecutive chunks across the
      // lanes. Pixels past the image are computed and not stored.
      constexpr int PC = 2 * CPP<TOut>;  // chunks a lane
      uint4* row_s = o_s + r * TW * CPP<TOut>;
      uint4 ch[2][CPP<TOut>];
      to_chunks(res_a, ch[0]);
      to_chunks(res_b, ch[1]);
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int q = 0; q < CPP<TOut>; ++q)
          row_s[p * PC + ((h * CPP<TOut> + q) ^ (p % PC))] = ch[h][q];
      __syncwarp();
      uint4* orow = reinterpret_cast<uint4*>(ob + ((size_t)oy * W2 + x0) * C);
      const int n_chunks = min(TW, W2 - x0) * CPP<TOut>;
#pragma unroll
      for (int l = p; l < TW * CPP<TOut>; l += 32)
        if (l < n_chunks) orow[l] = row_s[l / PC * PC + (l % PC ^ l / PC % PC)];
      __syncwarp();
    }
    if (more) {
      cp_async_wait<0>();
      __syncthreads();  // the rows have landed
      zero_left_edge(2 * oy0 + 2 * SR + 2, NEW_ROWS);
    }
    __syncthreads();
  }
}

constexpr int MAX_DEVICES = 64;

// The current device's SM count, queried once per device.
cudaError_t sm_count(int dev, int& n) {
  static int counts[MAX_DEVICES] = {};
  if (dev < MAX_DEVICES && counts[dev]) {
    n = counts[dev];
    return cudaSuccess;
  }
  const cudaError_t e = cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess && dev < MAX_DEVICES) counts[dev] = n;
  return e;
}

// Raises an instance's dynamic shared-memory limit to its use, once per
// device (the attribute belongs to the device's context).
template <typename TIn, typename TOut>
cudaError_t raise_smem_limit(int dev) {
  static bool done[MAX_DEVICES] = {};
  if (dev < MAX_DEVICES && done[dev]) return cudaSuccess;
  const cudaError_t e = cudaFuncSetAttribute(stem_block0_kernel<TIn, TOut>,
                                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                                             (int)smem_bytes<TIn, TOut>());
  if (e == cudaSuccess && dev < MAX_DEVICES) done[dev] = true;
  return e;
}

template <typename TIn, typename TOut>
int launch(const void* x, const void* w, void* out, int B, int H, int W,
           cudaStream_t stream) {
  int dev = 0, n_sm = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = sm_count(dev, n_sm);
  if (e == cudaSuccess) e = raise_smem_limit<TIn, TOut>(dev);
  if (e == cudaSuccess)
    e = cudaMemcpyToSymbolAsync(c_w, w, N_W * sizeof(float), 0,
                                cudaMemcpyDeviceToDevice, stream);
  if (e != cudaSuccess) return (int)e;
  // Taller strips halve the prologue and the stem's vertical halo, as long
  // as every SM still gets two blocks.
  const int cols = (W / 2 + TW - 1) / TW;
  const int rh = cols * ((H / 2 + RH_TALL - 1) / RH_TALL) * B >= 2 * n_sm ? RH_TALL : RH;
  dim3 grid(cols, (H / 2 + rh - 1) / rh, B);
  stem_block0_kernel<TIn, TOut><<<grid, THREADS, smem_bytes<TIn, TOut>(), stream>>>(
      (const TIn*)x, (const float*)w, (TOut*)out, H, W, rh);
  return (int)cudaGetLastError();
}

}  // namespace

// x (B,H,W,3) NHWC, bf16 if x_bf16 else f32, contiguous, 16-byte aligned;
// H, W even. w: the 880 folded f32 weights packed as
// ops/early_stage.py:pack_stem_block0_weights lays them out (wstem (16,27)
// [co, ci*9+i*3+j], bstem, wdw (3,3,16), bdw, wpw (16,16) [co, ci], bpw).
// out (B,16,H/2,W/2) in channels-last memory (strides of (B,H/2,W/2,16)),
// bf16 if out_bf16 else f32, 16-byte aligned. Copies w to the kernel's
// constant block and launches, both on `stream`; returns the first CUDA
// error.
extern "C" int cabinet_stem_block0(const void* x, const void* w, void* out,
                                   int B, int H, int W, int x_bf16,
                                   int out_bf16, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (x_bf16)
    return out_bf16 ? launch<bf16, bf16>(x, w, out, B, H, W, s)
                    : launch<bf16, float>(x, w, out, B, H, W, s);
  return out_bf16 ? launch<float, bf16>(x, w, out, B, H, W, s)
                  : launch<float, float>(x, w, out, B, H, W, s);
}
