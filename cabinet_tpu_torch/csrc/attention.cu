// Fused global-context attention (kernel K1) for Hopper (sm_90a).
//
// Replaces the Pallas kernel cabinet_tpu/ops/attention.py:_attention_kernel
// (pallas_call at :68, launched by fused_global_attention :44):
//   out[b] = softmax(q[b] k[b]^T * K^-1/2) v[b],  q,k (B,N,K), v (B,N,V).
//
// What bounds it: on the main path (N=1024, K=V=128) it does 2*N*N*(K+V)
// = 0.54 GFLOP per image and moves 1 MB, so the H100's tensor-core rate
// bounds it, at about half a microsecond; at that size the launch, the
// latency of the first loads and the serial loop over key tiles dominate.
//
// The bf16 kernel (attention_kernel). The TPU kernel holds the whole (N,N)
// f32 matrix in VMEM, one batch element per grid step. Here one warpgroup
// (128 threads) owns a tile of 64 queries and walks over the keys in tiles
// of 64 with an online softmax (running max and sum per row, output
// rescaled when the max grows): the (N,N) matrix never exists, N has no cap.
//   - Q is loaded once into 128-byte-swizzled shared memory (hopper.cuh);
//     key and value tiles stream by cp.async through rings of 2 stages,
//     rows past N zero-filled: keys t+2 and values t+1 load while the
//     tensor cores run P V(t) and Q K^T(t+1).
//   - S = Q K^T by wgmma.m64n64k16 from descriptors, both operands K-major.
//     S stays in registers, 32 f32 a thread; a row lives in the 4 lanes of
//     a quad, so its max takes two shuffles. The max, the rescale of O and
//     the row sums (per thread until the end) stay in registers too.
//   - O += P V by the register-A wgmma: the S accumulator's layout is the A
//     operand's, so P goes to the tensor cores from registers. The Pallas
//     body keeps the probabilities P in f32 through this product (the JAX
//     einsum path casts them to bf16 first): P is split into hi = bf16(P)
//     and lo = bf16(P - hi), and both are multiplied by V, which keeps about
//     16 bits of P (relative error ~2^-17) instead of bf16's 8. V is read
//     N-major, transposed by wgmma.
//   - P V of tile t and Q K^T of tile t+1 are issued together, so the
//     tensor cores run them back to back while the next tiles load.
//   - V runs in passes of 128 columns (S recomputed in each), zero-filled
//     past V, which keeps O at 64 f32 a thread. q and k are zero-padded to
//     128 or 256 columns in shared memory, one instance each, so that the
//     Q K^T loop has a compile-time count.
//   - Split keys: at batch 1, N=1024 has 16 query tiles, which would leave
//     most of the 132 SMs idle, so the wrapper (ops/attention.py:key_splits)
//     splits each query tile's key tiles into `splits` contiguous ranges,
//     grid (query tiles, splits, B). Each split writes its unnormalised O,
//     row max and row sum to a workspace, and attention_combine_kernel
//     merges the splits of each row in split order and rounds to bf16:
//     deterministic, no atomics. With one split the kernel writes the
//     output itself and the merge is not launched.
//
// The float32 variant (attention_f32_kernel) computes the same function on
// f32 q, k, v with plain f32 FMAs on the CUDA cores: no tensor cores, so no
// TF32 and no bf16 splitting, as the Pallas body's f32 math and the f32
// eval parity need.
//   What bounds it: 2*N*N*(K+V) = 0.54 GFLOP per image at N=1024, K=V=128
//   on the f32 SIMT rate of 67 TFLOP/s: 0.008 ms an image, 0.064 ms at
//   B=8; its 1.5 MB an image take a tenth of that. So the FMA pipe bounds
//   it, and the design keeps the rest of the work off it:
//   - Register tiling. A block of 256 threads owns 64 queries and walks
//     key tiles of 64 with the online softmax. Each thread holds a 4 x 4
//     micro-tile of S (queries 4ty + i, keys tx + 16j) and a 4 x 8 one of
//     O (value columns 4tx + e and 64 + 4tx + e): in Q K^T, 8 16-byte
//     shared loads (4 d of 4 queries and of 4 keys) feed 64 FMAs; in P V,
//     3 (P of 4 queries for one key, 8 value columns) feed 32.
//   - q and k stay row-major in shared memory, so that cp.async copies
//     them 16 bytes at a time; chunk c of row r sits at chunk c ^ (r % 8),
//     so the 16-byte reads of a quarter-warp fall in distinct banks. P
//     goes through shared memory once a key tile, key-major, in the layout
//     P V reads as float4 (swizzled the same way against store conflicts).
//   - Online softmax in log2 units, exp2f of the scaled score: each row's
//     max and sum stay in registers; the row's 16 threads (half a warp)
//     reduce the max by 4 shuffles and the sum once at the end.
//   - A 2-stage cp.async ring, one stage for keys and one for values, 16
//     bytes a thread, rows past N zero-filled: keys t+1 load while P V(t)
//     runs, values t+1 while Q K^T(t+1) runs. 112 KB of shared memory at
//     K <= 128; the registers (about 160 a thread, for the loads of the
//     next chunk in flight) hold one block on an SM. A cap of 128 for two
//     blocks an SM was slower at B=8, where the 128 blocks fill one wave.
//   - Split keys at small batch, as in the bf16 kernel (key_splits: 8 at
//     B=1, N=1024 on 132 SMs; 1 at B=8), merged in split order by
//     attention_combine_kernel<float>: no atomics, the same bits every run.
//   - V runs in passes of 128 columns (S recomputed in each), zero-filled
//     past V. The shared-memory limit is raised once per device.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "hopper.cuh"

typedef __nv_bfloat16 bf16;

namespace {

constexpr int BQ = 64;            // query rows per block: one warpgroup
constexpr int BKV = 64;           // keys per tile
constexpr int THREADS = 128;
constexpr int VP = 128;           // value columns per pass
constexpr int K_STAGES = 2;       // key tiles t+1 (read), t+2 (loading)
constexpr int V_STAGES = 2;       // value tiles t (read), t+1 (loading)
constexpr int PANEL = BQ * 128;   // 64 rows x 64 bf16, K-major: 8 KB
constexpr float LOG2E = 1.4426950408889634f;

// Q, the key ring (KP panels a tile) and the value ring (64 keys x VP).
size_t smem_bytes(int KP) {
  return (size_t)(1 + K_STAGES) * KP * PANEL + (size_t)V_STAGES * BKV * VP * 2 +
         1024;  // + room to align
}

__device__ __forceinline__ uint32_t bf162_bits(__nv_bfloat162 h) {
  return *reinterpret_cast<uint32_t*>(&h);
}

// grid (ceil(N / BQ), splits, B), 128 threads. q and k columns padded with
// zeros to KP panels of 64 (a zero column adds nothing to q.k), so the
// k16 steps of Q K^T are a compile-time count: with a runtime count ptxas
// serialises the wgmma instructions (note C7520). Value columns
// [c0, c0 + VP) per pass. With splits > 1, ws holds O (splits, B, N, DV)
// f32, then (max, sum) (splits, B, N) as float2, the max in log2 units.
template <int KP>
__global__ void __launch_bounds__(THREADS)
attention_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                 const bf16* __restrict__ v, bf16* __restrict__ out,
                 float* __restrict__ ws, int N, int D, int DV, int splits,
                 float scale_log2) {
  extern __shared__ __align__(16) unsigned char k1_smem[];
  const uint32_t base = smem_addr(k1_smem);
  const uint32_t q_s = base + ((1024 - (base & 1023)) & 1023);
  const uint32_t k_s = q_s + KP * PANEL;
  const uint32_t v_s = k_s + K_STAGES * KP * PANEL;

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32, tq = lane % 4;
  const int q0 = blockIdx.x * BQ, split = blockIdx.y, b = blockIdx.z;
  const int n_tiles = (N + BKV - 1) / BKV;
  const int t0 = split * n_tiles / splits, t1 = (split + 1) * n_tiles / splits;
  const bf16* kb = k + (size_t)b * N * D;
  const bf16* vb = v + (size_t)b * N * DV;
  const int cpr = D / 8;  // 16-byte chunks per row of q and k

  // Rows [r0, r0 + 64) of a (N, D) matrix into K-major swizzled panels,
  // zeros past N and past D.
  auto load_rows = [&](uint32_t dst, const bf16* src, int r0) {
    for (int i = tid; i < BQ * KP * 8; i += THREADS) {
      const int r = i / (KP * 8), c = i % (KP * 8);
      const bool in = r0 + r < N && c < cpr;
      cp_async16_zfill(dst + (c / 8) * PANEL + r * 128 + (((c % 8) ^ (r % 8)) << 4),
                       src + (in ? (size_t)(r0 + r) * D + c * 8 : 0), in);
    }
  };
  // Keys [kv0, kv0 + 64), value columns [c0, c0 + VP), N-major swizzled.
  auto load_v = [&](uint32_t dst, int kv0, int c0) {
    for (int i = tid; i < BKV * VP / 8; i += THREADS) {
      const int r = i / (VP / 8), c = i % (VP / 8);
      const bool in = kv0 + r < N && c0 + c * 8 < DV;
      cp_async16_zfill(dst + (r / 8) * (VP * 16) + (c / 8) * 1024 + (r % 8) * 128 +
                           (((c % 8) ^ (r % 8)) << 4),
                       vb + (in ? (size_t)(kv0 + r) * DV + c0 + c * 8 : 0), in);
    }
  };
  auto k_stage = [&](int t) { return k_s + (t % K_STAGES) * KP * PANEL; };
  auto v_stage = [&](int t) { return v_s + (t % V_STAGES) * (BKV * VP * 2); };

  // This thread's rows of the tile: row and row + 8. Accumulator 4j+{0,1}
  // (of S or O) is (row, 8j + 2tq + {0,1}), 4j+{2,3} is (row + 8, same).
  const int row = warp * 16 + lane / 4;
  load_rows(q_s, q + (size_t)b * N * D, q0);  // committed with the first tiles

  for (int c0 = 0; c0 < DV; c0 += VP) {
    float o[VP / 2], s[32];
#pragma unroll
    for (int i = 0; i < VP / 2; ++i) o[i] = 0.f;
#pragma unroll
    for (int i = 0; i < 32; ++i) s[i] = 0.f;
    float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};

    load_rows(k_stage(t0), kb, t0 * BKV);
    if (t0 + 1 < t1) load_rows(k_stage(t0 + 1), kb, (t0 + 1) * BKV);
    load_v(v_stage(t0), t0 * BKV, c0);
    cp_async_commit();
    cp_async_wait<0>();
    fence_proxy_async();
    __syncthreads();
    fence_acc(s);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4 * KP; ++kk) {
      const uint32_t off = (kk / 4) * PANEL + (kk % 4) * 32;
      wgmma_m64n64k16_ss(s, gmma_desc(q_s + off, 16, 1024),
                         gmma_desc(k_stage(t0) + off, 16, 1024), kk > 0);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_acc(s);

    for (int t = t0; t < t1; ++t) {
      // Online softmax of S(t) in log2 units; keys past N are -inf.
      const int kv0 = t * BKV;
      float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const bool in = kv0 + 8 * j + 2 * tq + (e & 1) < N;
          s[4 * j + e] = in ? s[4 * j + e] * scale_log2 : -INFINITY;
          mx[e / 2] = fmaxf(mx[e / 2], s[4 * j + e]);
        }
      float alpha[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
        mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
        const float m_new = fmaxf(m[h], mx[h]);  // finite: the tile has a key
        alpha[h] = exp2f(m[h] - m_new);
        m[h] = m_new;
        l[h] *= alpha[h];
      }
#pragma unroll
      for (int i = 0; i < VP / 2; ++i) o[i] *= alpha[(i / 2) % 2];
      // P as register A operands of k16 slice kk: register r is row
      // row + 8(r%2), keys 16kk + 8(r/2) + 2tq + {0,1}, i.e. s[8kk+2r+{0,1}].
      uint32_t ph[4][4], pl[4][4];
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const float p0 = exp2f(s[8 * kk + 2 * r] - m[r % 2]);
          const float p1 = exp2f(s[8 * kk + 2 * r + 1] - m[r % 2]);
          l[r % 2] += p0 + p1;
          const __nv_bfloat162 hi = __floats2bfloat162_rn(p0, p1);
          const float2 hf = __bfloat1622float2(hi);
          ph[kk][r] = bf162_bits(hi);
          pl[kk][r] = bf162_bits(__floats2bfloat162_rn(p0 - hf.x, p1 - hf.y));
        }

      // Keys t+1 and values t have landed for every thread, and every
      // thread has retired P V(t-1) and S(t): the stages of keys t and
      // values t-1 take keys t+2 and values t+1. Waiting for all copies
      // here keeps the ring one tile deep.
      cp_async_wait<0>();
      fence_proxy_async();
      __syncthreads();
      if (t + 2 < t1) load_rows(k_stage(t + 2), kb, (t + 2) * BKV);
      if (t + 1 < t1) load_v(v_stage(t + 1), (t + 1) * BKV, c0);
      cp_async_commit();

      fence_acc(o);
      fence_acc(s);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        fence_regs(ph[kk]);
        fence_regs(pl[kk]);
      }
      wgmma_fence();
      const uint32_t vt = v_stage(t);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const uint64_t dv = gmma_desc(vt + kk * VP * 32, 1024, VP * 16);
        wgmma_m64n128k16_rs(o, ph[kk], dv);
        wgmma_m64n128k16_rs(o, pl[kk], dv);
      }
      if (t + 1 < t1) {
#pragma unroll
        for (int kk = 0; kk < 4 * KP; ++kk) {
          const uint32_t off = (kk / 4) * PANEL + (kk % 4) * 32;
          wgmma_m64n64k16_ss(s, gmma_desc(q_s + off, 16, 1024),
                             gmma_desc(k_stage(t + 1) + off, 16, 1024), kk > 0);
        }
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_acc(o);
      fence_acc(s);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        fence_regs(ph[kk]);
        fence_regs(pl[kk]);
      }
    }

#pragma unroll
    for (int h = 0; h < 2; ++h) {
      l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);
      l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = q0 + row + 8 * h;
      if (r >= N) continue;
      if (splits == 1) {
        bf16* orow = out + ((size_t)b * N + r) * DV + c0;
#pragma unroll
        for (int j = 0; j < VP / 8; ++j) {
          const int col = 8 * j + 2 * tq;
          if (c0 + col < DV)
            *reinterpret_cast<__nv_bfloat162*>(orow + col) = __floats2bfloat162_rn(
                o[4 * j + 2 * h] / l[h], o[4 * j + 2 * h + 1] / l[h]);
        }
      } else {
        const size_t at = ((size_t)split * gridDim.z + b) * N + r;
        float* orow = ws + at * DV + c0;
#pragma unroll
        for (int j = 0; j < VP / 8; ++j) {
          const int col = 8 * j + 2 * tq;
          if (c0 + col < DV)
            *reinterpret_cast<float2*>(orow + col) =
                make_float2(o[4 * j + 2 * h], o[4 * j + 2 * h + 1]);
        }
        if (c0 == 0 && tq == 0)
          reinterpret_cast<float2*>(ws + (size_t)splits * gridDim.z * N * DV)[at] =
              make_float2(m[h], l[h]);
      }
    }
    __syncthreads();  // the rings are free before the next pass refills them
  }
}

__device__ __forceinline__ void store_out(bf16* p, float v) { *p = __float2bfloat16_rn(v); }
__device__ __forceinline__ void store_out(float* p, float v) { *p = v; }

// One warp per query row of the B*N: merges its splits,
// out = sum_s 2^(m_s - M) O_s / sum_s 2^(m_s - M) l_s with M = max_s m_s,
// in TOut (bf16: rounded once; f32). Both kernels keep the max in log2
// units. The lanes read the splits' (m, l) in parallel, M and the sum of l
// come from shuffles, and each column adds the splits in split order: the
// same bits every run.
template <typename TOut>
__global__ void __launch_bounds__(256)
attention_combine_kernel(const float* __restrict__ ws, TOut* __restrict__ out,
                         int rows, int DV, int splits) {
  const int row = blockIdx.x * 8 + threadIdx.x / 32, lane = threadIdx.x % 32;
  if (row >= rows) return;
  const float2* ml = reinterpret_cast<const float2*>(ws + (size_t)splits * rows * DV);
  float mx = -INFINITY, l = 0.f;
  for (int s = lane; s < splits; s += 32) mx = fmaxf(mx, ml[(size_t)s * rows + row].x);
  for (int o = 16; o > 0; o >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
  for (int s = lane; s < splits; s += 32) {
    const float2 e = ml[(size_t)s * rows + row];
    l += exp2f(e.x - mx) * e.y;
  }
  for (int o = 16; o > 0; o >>= 1) l += __shfl_xor_sync(0xffffffffu, l, o);
  float acc[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) acc[i] = 0.f;
#pragma unroll 4
  for (int s = 0; s < splits; ++s) {
    const float w = exp2f(ml[(size_t)s * rows + row].x - mx);
    const float* o = ws + ((size_t)s * rows + row) * DV;
#pragma unroll
    for (int i = 0; i < 8; ++i)
      if (lane + 32 * i < DV) acc[i] += w * o[lane + 32 * i];
  }
  TOut* orow = out + (size_t)row * DV;
#pragma unroll
  for (int i = 0; i < 8; ++i)
    if (lane + 32 * i < DV) store_out(orow + lane + 32 * i, acc[i] / l);
}

template <int KP>
int launch_attention(const bf16* q, const bf16* k, const bf16* v, bf16* out,
                     float* ws, int B, int N, int D, int DV, int splits,
                     float scale_log2, cudaStream_t stream) {
  const size_t smem = smem_bytes(KP);
  cudaFuncSetAttribute(attention_kernel<KP>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  const dim3 grid((N + BQ - 1) / BQ, splits, B);
  attention_kernel<KP><<<grid, THREADS, smem, stream>>>(
      q, k, v, out, ws, N, D, DV, splits, scale_log2);
  return (int)cudaGetLastError();
}


// ---------------------------------------------------------------------------
// float32 variant
// ---------------------------------------------------------------------------

constexpr int F_BQ = 64;        // query rows per block
constexpr int F_BKV = 64;       // keys per tile
constexpr int F_THREADS = 256;  // 16 x 16: tx picks keys and columns, ty queries
constexpr int F_VP = 128;       // value columns per pass
constexpr int F_MAX_D = 256;

// Words of a shared row of q or k: D rounded up to 32, so that the chunk
// swizzle c ^ (r % 8) stays inside the row.
__host__ __device__ constexpr int f32_ld(int D) { return (D + 31) / 32 * 32; }

// q (64 rows), the ring's key stage (64 rows), its value stage (64 keys x
// VP) and P (64 keys x 64 queries): 112 KB at D <= 128.
size_t smem_bytes_f32(int D) {
  return (size_t)(2 * F_BQ * f32_ld(D) + F_BKV * F_VP + F_BKV * F_BQ) * sizeof(float);
}

// grid (ceil(N / 64), splits, B), 256 threads. Thread (tx, ty) = (tid % 16,
// tid / 16) owns queries 4ty + i and keys tx + 16j (i, j < 4) of S, and
// queries 4ty + i, value columns 4tx + e and 64 + 4tx + e (e < 4) of the
// pass's O. With splits > 1, ws holds O (splits, B, N, DV) f32, then (max,
// sum) (splits, B, N) as float2, the max in log2 units (the bf16 layout).
__global__ void __launch_bounds__(F_THREADS, 1)  // 1 block an SM: ptxas takes ~160 registers
attention_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, float* __restrict__ out,
                     float* __restrict__ ws, int N, int D, int DV, int splits,
                     float scale_log2) {
  extern __shared__ __align__(16) float fsmem[];
  const int ld4 = f32_ld(D) / 4;  // 16-byte chunks a shared row of q or k
  float4* q_s = reinterpret_cast<float4*>(fsmem);  // (64, ld4), swizzled
  float4* k_s = q_s + F_BQ * ld4;                  // (64, ld4), swizzled
  float4* v_s = k_s + F_BKV * ld4;                 // (64, VP / 4)
  float4* p_s = v_s + F_BKV * F_VP / 4;            // (64 keys, 16), swizzled

  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int q0 = blockIdx.x * F_BQ, split = blockIdx.y, b = blockIdx.z;
  const int n_tiles = (N + F_BKV - 1) / F_BKV;
  const int t0 = split * n_tiles / splits, t1 = (split + 1) * n_tiles / splits;
  const float* kb = k + (size_t)b * N * D;
  const float* vb = v + (size_t)b * N * DV;
  const int cpr = D / 4;  // 16-byte chunks a row of q and k

  // Rows [r0, r0 + 64) of a (N, D) matrix: chunk c of row r to chunk
  // c ^ (r % 8) of shared row r, zeros past N. The thread's (row, chunk)
  // steps by 256 chunks without a division.
  auto load_qk = [&](float4* dst, const float* src, int r0) {
    const int dr = F_THREADS / cpr, dc = F_THREADS % cpr;
    for (int r = tid / cpr, c = tid % cpr; r < 64;) {
      const bool in = r0 + r < N;
      cp_async16_zfill(smem_addr(dst + r * ld4 + (c ^ (r % 8))),
                       src + (in ? (size_t)(r0 + r) * D + 4 * c : 0), in);
      r += dr;
      c += dc;
      if (c >= cpr) {
        c -= cpr;
        ++r;
      }
    }
  };
  // Keys [kv0, kv0 + 64), value columns [c0, c0 + VP); zeros past N and DV.
  auto load_v = [&](int kv0, int c0) {
#pragma unroll
    for (int i = tid; i < F_BKV * F_VP / 4; i += F_THREADS) {
      const int r = i / (F_VP / 4), c = i % (F_VP / 4);
      const bool in = kv0 + r < N && c0 + 4 * c < DV;
      cp_async16_zfill(smem_addr(v_s + i),
                       vb + (in ? (size_t)(kv0 + r) * DV + c0 + 4 * c : 0), in);
    }
  };

  const int sw_q = ty % 2 * 4;  // (4ty + i) % 8 == sw_q + i
  const int sw_k = tx % 8;      // (tx + 16j) % 8 == sw_k

  for (int c0 = 0; c0 < DV; c0 += F_VP) {
    float o[4][8], m[4], l[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      m[i] = -INFINITY;
      l[i] = 0.f;
#pragma unroll
      for (int e = 0; e < 8; ++e) o[i][e] = 0.f;
    }
    if (c0 == 0) load_qk(q_s, q + (size_t)b * N * D, q0);
    load_qk(k_s, kb, t0 * F_BKV);
    cp_async_commit();
    load_v(t0 * F_BKV, c0);
    cp_async_commit();

    for (int t = t0; t < t1; ++t) {
      const int kv0 = t * F_BKV;
      cp_async_wait<1>();  // keys t (and q) have landed; values t may not
      __syncthreads();

      // S = Q K^T: per chunk, 8 16-byte loads feed 64 FMAs.
      float s[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 2
      for (int c = 0; c < cpr; ++c) {
        float4 a[4], kk[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) a[i] = q_s[(4 * ty + i) * ld4 + (c ^ (sw_q + i))];
#pragma unroll
        for (int j = 0; j < 4; ++j) kk[j] = k_s[(tx + 16 * j) * ld4 + (c ^ sw_k)];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            s[i][j] = fmaf(a[i].x, kk[j].x, s[i][j]);
            s[i][j] = fmaf(a[i].y, kk[j].y, s[i][j]);
            s[i][j] = fmaf(a[i].z, kk[j].z, s[i][j]);
            s[i][j] = fmaf(a[i].w, kk[j].w, s[i][j]);
          }
      }
      __syncthreads();  // every thread is done with keys t: keys t+1 load
      if (t + 1 < t1) load_qk(k_s, kb, kv0 + F_BKV);
      cp_async_commit();

      // Online softmax in log2 units; keys past N are -inf. A row's 16
      // threads are the half-warp of one ty: the max by 4 shuffles, the
      // sum per thread until the end.
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        float mx = -INFINITY;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          s[i][j] = kv0 + tx + 16 * j < N ? s[i][j] * scale_log2 : -INFINITY;
          mx = fmaxf(mx, s[i][j]);
        }
#pragma unroll
        for (int off = 8; off > 0; off >>= 1)
          mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
        const float m_new = fmaxf(m[i], mx);  // finite: the tile has a key
        const float alpha = exp2f(m[i] - m_new);
        m[i] = m_new;
        l[i] *= alpha;
#pragma unroll
        for (int e = 0; e < 8; ++e) o[i][e] *= alpha;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          s[i][j] = exp2f(s[i][j] - m_new);
          l[i] += s[i][j];
        }
      }
      // P key-major: key tx + 16j, queries 4ty..4ty+3 in chunk ty ^ (key % 8).
#pragma unroll
      for (int j = 0; j < 4; ++j)
        p_s[(tx + 16 * j) * 16 + (ty ^ sw_k)] =
            make_float4(s[0][j], s[1][j], s[2][j], s[3][j]);
      cp_async_wait<1>();  // values t have landed; keys t+1 may not
      __syncthreads();     // and every thread's P is in place

      // O += P V(t): per key, 3 16-byte loads feed 32 FMAs.
#pragma unroll 4
      for (int c = 0; c < F_BKV; ++c) {
        const float4 p4 = p_s[c * 16 + (ty ^ (c % 8))];
        const float4 va = v_s[c * (F_VP / 4) + tx], vc = v_s[c * (F_VP / 4) + 16 + tx];
        const float p[4] = {p4.x, p4.y, p4.z, p4.w};
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          o[i][0] = fmaf(p[i], va.x, o[i][0]);
          o[i][1] = fmaf(p[i], va.y, o[i][1]);
          o[i][2] = fmaf(p[i], va.z, o[i][2]);
          o[i][3] = fmaf(p[i], va.w, o[i][3]);
          o[i][4] = fmaf(p[i], vc.x, o[i][4]);
          o[i][5] = fmaf(p[i], vc.y, o[i][5]);
          o[i][6] = fmaf(p[i], vc.z, o[i][6]);
          o[i][7] = fmaf(p[i], vc.w, o[i][7]);
        }
      }
      __syncthreads();  // values t and P are no longer read: values t+1 load
      if (t + 1 < t1) load_v(kv0 + F_BKV, c0);
      cp_async_commit();
    }

#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        l[i] += __shfl_xor_sync(0xffffffffu, l[i], off);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = q0 + 4 * ty + i;
      if (r >= N) continue;
      const size_t at = ((size_t)split * gridDim.z + b) * N + r;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int col = c0 + 64 * h + 4 * tx;
        if (col >= DV) continue;
        const float4 oh = make_float4(o[i][4 * h], o[i][4 * h + 1], o[i][4 * h + 2],
                                      o[i][4 * h + 3]);
        if (splits == 1)
          *reinterpret_cast<float4*>(out + ((size_t)b * N + r) * DV + col) =
              make_float4(oh.x / l[i], oh.y / l[i], oh.z / l[i], oh.w / l[i]);
        else
          *reinterpret_cast<float4*>(ws + at * DV + col) = oh;
      }
      if (splits > 1 && c0 == 0 && tx == 0)
        reinterpret_cast<float2*>(ws + (size_t)splits * gridDim.z * N * DV)[at] =
            make_float2(m[i], l[i]);
    }
  }
}

// Raises the f32 kernel's dynamic shared-memory limit to its largest use,
// once per device (the attribute belongs to the device's context), not at
// every launch.
cudaError_t raise_smem_limit_f32() {
  constexpr int MAX_DEVICES = 64;
  static bool done[MAX_DEVICES] = {};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess || (dev < MAX_DEVICES && done[dev])) return e;
  e = cudaFuncSetAttribute(attention_f32_kernel,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)smem_bytes_f32(F_MAX_D));
  if (e == cudaSuccess && dev < MAX_DEVICES) done[dev] = true;
  return e;
}

}  // namespace
// q,k (B,N,D), v and out (B,N,DV): f32, contiguous, 16-byte aligned; D, DV
// multiples of 16 up to 256; 1 <= splits <= ceil(N/64). With splits > 1,
// ws is f32 scratch of splits*B*N*(DV+2) values, and the merge kernel
// writes out. Launches on `stream` and returns the first CUDA error.
extern "C" int cabinet_attention_f32(const void* q, const void* k,
                                     const void* v, void* out, void* ws,
                                     int B, int N, int D, int DV, int splits,
                                     float scale, void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
  const cudaError_t e = raise_smem_limit_f32();
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((N + F_BQ - 1) / F_BQ, splits, B);
  attention_f32_kernel<<<grid, F_THREADS, smem_bytes_f32(D), st>>>(
      (const float*)q, (const float*)k, (const float*)v, (float*)out,
      (float*)ws, N, D, DV, splits, scale * LOG2E);
  const int rc = (int)cudaGetLastError();
  if (rc != 0 || splits == 1) return rc;
  attention_combine_kernel<float><<<(B * N + 7) / 8, 256, 0, st>>>(
      (const float*)ws, (float*)out, B * N, DV, splits);
  return (int)cudaGetLastError();
}

// q,k (B,N,D), v and out (B,N,DV): bf16, contiguous, 16-byte aligned;
// D, DV multiples of 16 up to 256; 1 <= splits <= ceil(N/64). With
// splits > 1, ws is f32 scratch of splits*B*N*(DV+2) values, and a second
// kernel merges the splits into out. Launches on `stream` and returns
// cudaGetLastError().
extern "C" int cabinet_attention(const void* q, const void* k, const void* v,
                                 void* out, void* ws, int B, int N, int D,
                                 int DV, int splits, float scale, void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
  const int rc = (D <= 128 ? launch_attention<2> : launch_attention<4>)(
      (const bf16*)q, (const bf16*)k, (const bf16*)v, (bf16*)out, (float*)ws, B, N,
      D, DV, splits, scale * LOG2E, st);
  if (rc != 0 || splits == 1) return rc;
  attention_combine_kernel<bf16><<<(B * N + 7) / 8, 256, 0, st>>>(
      (const float*)ws, (bf16*)out, B * N, DV, splits);
  return (int)cudaGetLastError();
}
