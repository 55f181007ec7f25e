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
// eval parity need. At N=1024, K=V=128 its 0.54 GFLOP per image bound it on
// the f32 SIMT rate (67 TFLOP/s, ~8 us). One block of 256 threads owns 32
// query rows and walks key tiles of 32 with the same online softmax; each
// thread keeps 4 scores and up to 32 output columns of one row in
// registers, and the 8 threads of a row reduce its max and sum by shuffles.
// Shared rows are padded by one word against bank conflicts.

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

// One warp per query row of the B*N: merges its splits,
// out = sum_s 2^(m_s - M) O_s / sum_s 2^(m_s - M) l_s with M = max_s m_s,
// rounded to bf16. The lanes read the splits' (m, l) in parallel, M and
// the sum of l come from shuffles, and each column adds the splits in
// split order: the same bits every run.
__global__ void __launch_bounds__(256)
attention_combine_kernel(const float* __restrict__ ws, bf16* __restrict__ out,
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
  bf16* orow = out + (size_t)row * DV;
#pragma unroll
  for (int i = 0; i < 8; ++i)
    if (lane + 32 * i < DV) orow[lane + 32 * i] = __float2bfloat16_rn(acc[i] / l);
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

constexpr int F_BQ = 32;      // query rows per block
constexpr int F_BKV = 32;     // key rows per tile
constexpr int F_THREADS = 256;
constexpr int F_LANES = 8;    // threads per query row
constexpr int F_MAX_DV = 256;

size_t smem_bytes_f32(int D, int DV) {
  return (size_t)(F_BQ * (D + 1) + F_BKV * (D + 1) + F_BKV * DV
                  + F_BQ * (F_BKV + 1)) * sizeof(float);
}

// Copies `rows` rows of `width` f32 from a (N, width) matrix starting at row
// r0 into shared rows of stride `ld`; rows past N are zero.
__device__ void load_rows_f32(float* dst, const float* src, int r0, int rows,
                              int N, int width, int ld) {
  for (int i = threadIdx.x; i < rows * width; i += F_THREADS) {
    const int r = i / width, c = i % width;
    dst[r * ld + c] = (r0 + r < N) ? src[(size_t)(r0 + r) * width + c] : 0.f;
  }
}

__global__ void __launch_bounds__(F_THREADS)
attention_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, float* __restrict__ out,
                     int N, int D, int DV, float scale) {
  extern __shared__ __align__(16) float fsmem[];
  const int ldq = D + 1, ldp = F_BKV + 1;
  float* q_s = fsmem;                    // (F_BQ, D + 1)
  float* k_s = q_s + F_BQ * ldq;         // (F_BKV, D + 1)
  float* v_s = k_s + F_BKV * ldq;        // (F_BKV, DV)
  float* p_s = v_s + F_BKV * DV;         // (F_BQ, F_BKV + 1)

  const int b = blockIdx.y, q0 = blockIdx.x * F_BQ;
  const int r = threadIdx.x / F_LANES;   // this thread's query row
  const int g = threadIdx.x % F_LANES;   // its column group
  const int n_out = DV / F_LANES;        // output columns g, g+8, ...
  const float* qb = q + (size_t)b * N * D;
  const float* kb = k + (size_t)b * N * D;
  const float* vb = v + (size_t)b * N * DV;

  load_rows_f32(q_s, qb, q0, F_BQ, N, D, ldq);
  float o[F_MAX_DV / F_LANES];
#pragma unroll
  for (int j = 0; j < F_MAX_DV / F_LANES; ++j) o[j] = 0.f;
  float m = -INFINITY, l = 0.f;  // the row's running max and sum

  for (int kv0 = 0; kv0 < N; kv0 += F_BKV) {
    __syncthreads();  // the previous tile's k_s, v_s, p_s are no longer read
    load_rows_f32(k_s, kb, kv0, F_BKV, N, D, ldq);
    load_rows_f32(v_s, vb, kv0, F_BKV, N, DV, DV);
    __syncthreads();

    // Scores of row r against keys g, g+8, g+16, g+24 of the tile.
    float s[F_BKV / F_LANES];
#pragma unroll
    for (int j = 0; j < F_BKV / F_LANES; ++j) s[j] = 0.f;
    for (int d = 0; d < D; ++d) {
      const float qd = q_s[r * ldq + d];
#pragma unroll
      for (int j = 0; j < F_BKV / F_LANES; ++j)
        s[j] = fmaf(qd, k_s[(g + F_LANES * j) * ldq + d], s[j]);
    }
    float mx = -INFINITY;
#pragma unroll
    for (int j = 0; j < F_BKV / F_LANES; ++j) {
      s[j] = (kv0 + g + F_LANES * j < N) ? s[j] * scale : -INFINITY;
      mx = fmaxf(mx, s[j]);
    }
    for (int off = F_LANES / 2; off > 0; off >>= 1)
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
    const float m_new = fmaxf(m, mx);  // finite: the tile has a key
    const float alpha = expf(m - m_new);
    float ps = 0.f;
#pragma unroll
    for (int j = 0; j < F_BKV / F_LANES; ++j) {
      const float p = expf(s[j] - m_new);
      p_s[r * ldp + g + F_LANES * j] = p;
      ps += p;
    }
    for (int off = F_LANES / 2; off > 0; off >>= 1)
      ps += __shfl_xor_sync(0xffffffffu, ps, off);
    m = m_new;
    l = l * alpha + ps;
    __syncwarp();  // the row's 8 threads share a warp; p_s row r is written

    // O[r, g + 8j] = alpha * O + sum_c P[r, c] V[c, g + 8j].
#pragma unroll
    for (int j = 0; j < F_MAX_DV / F_LANES; ++j) {
      if (j < n_out) {
        const int col = g + F_LANES * j;
        float acc = o[j] * alpha;
        for (int c = 0; c < F_BKV; ++c)
          acc = fmaf(p_s[r * ldp + c], v_s[c * DV + col], acc);
        o[j] = acc;
      }
    }
  }

  if (q0 + r < N) {
    float* orow = out + ((size_t)b * N + q0 + r) * DV;
#pragma unroll
    for (int j = 0; j < F_MAX_DV / F_LANES; ++j)
      if (j < n_out) orow[g + F_LANES * j] = o[j] / l;
  }
}

}  // namespace
// q,k (B,N,D), v and out (B,N,DV): f32, contiguous; D, DV multiples of 16
// up to 256. Launches on `stream` and returns cudaGetLastError().
extern "C" int cabinet_attention_f32(const void* q, const void* k,
                                     const void* v, void* out, int B, int N,
                                     int D, int DV, float scale,
                                     void* stream) {
  const size_t smem = smem_bytes_f32(D, DV);
  cudaFuncSetAttribute(attention_f32_kernel,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  dim3 grid((N + F_BQ - 1) / F_BQ, B);
  attention_f32_kernel<<<grid, F_THREADS, smem, (cudaStream_t)stream>>>(
      (const float*)q, (const float*)k, (const float*)v, (float*)out, N, D,
      DV, scale);
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
  attention_combine_kernel<<<(B * N + 7) / 8, 256, 0, st>>>(
      (const float*)ws, (bf16*)out, B * N, DV, splits);
  return (int)cudaGetLastError();
}
