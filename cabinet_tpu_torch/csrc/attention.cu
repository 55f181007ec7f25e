// Fused global-context attention (kernel K1) for Hopper (sm_90a).
//
// Replaces the Pallas kernel cabinet_tpu/ops/attention.py:_attention_kernel
// (pallas_call at :68, launched by fused_global_attention :44):
//   out[b] = softmax(q[b] k[b]^T * K^-1/2) v[b],  q,k (B,N,K), v (B,N,V) bf16.
//
// What bounds it: on the main path (N=1024, K=V=128) it does 2*N*N*(K+V)
// = 0.54 GFLOP per image and moves 1 MB, so the H100's tensor-core rate
// bounds it, at about half a microsecond; at that size the launch and the
// serial loop over key tiles dominate instead.
//
// Design. The TPU kernel holds the whole (N,N) f32 matrix in VMEM, one batch
// element per grid step. An SM has at most 227 KB of shared memory, so here
// one block of 4 warps owns a tile of 64 query rows (16 per warp) and walks
// over the keys in tiles of 64 with an online softmax (running max and
// sum per row, output rescaled when the max grows); the (N,N) matrix never
// exists and N has no cap. Products run on the tensor cores through WMMA
// bf16 16x16x16 tiles with f32 accumulators:
//   - S = Q K^T: q and k are bf16, so the bf16 MMA with f32 accumulation is
//     the f32 product of the Pallas body up to summation order;
//   - O += P V: the Pallas body keeps the probabilities P in f32 through
//     the value product (the JAX einsum path casts them to bf16 first).
//     P is split into hi = bf16(P) and lo = bf16(P - hi), and both are
//     multiplied by V, which keeps about 16 bits of P (relative error
//     ~2^-17) instead of bf16's 8.
// Softmax and rescaling read and write the tiles in shared memory, one warp
// per row group, in f32 with expf. The output is O / l rounded to bf16.
// Simple first: one stage, no cp.async/TMA, no wgmma.
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
#include <mma.h>
#include <math.h>
#include <stdint.h>

using namespace nvcuda;
typedef __nv_bfloat16 bf16;

namespace {

constexpr int BQ = 64;    // query rows per block
constexpr int BKV = 64;   // key rows per tile
constexpr int WARPS = 4;  // 16 query rows each
constexpr int THREADS = WARPS * 32;

size_t smem_bytes(int D, int DV) {
  return (size_t)(BQ * D + BKV * D + BKV * DV) * sizeof(bf16)  // q, k, v
         + (size_t)BQ * BKV * sizeof(float)                      // scores
         + (size_t)2 * BQ * BKV * sizeof(bf16)                   // P hi, lo
         + (size_t)BQ * DV * sizeof(float)                       // O
         + (size_t)2 * BQ * sizeof(float);                       // m, l
}

// Copies `rows` rows of `width` bf16 (width % 8 == 0) from a (N, width)
// matrix starting at row r0 into shared memory; rows past N are zero.
__device__ void load_rows(bf16* dst, const bf16* src, int r0, int rows,
                          int N, int width) {
  const int vecs = rows * width / 8;
  for (int i = threadIdx.x; i < vecs; i += THREADS) {
    const int r = i / (width / 8), c = (i % (width / 8)) * 8;
    uint4 val = make_uint4(0, 0, 0, 0);
    if (r0 + r < N)
      val = *reinterpret_cast<const uint4*>(src + (size_t)(r0 + r) * width + c);
    *reinterpret_cast<uint4*>(dst + r * width + c) = val;
  }
}

__global__ void __launch_bounds__(THREADS)
attention_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                 const bf16* __restrict__ v, bf16* __restrict__ out,
                 int N, int D, int DV, float scale) {
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* q_s = reinterpret_cast<bf16*>(smem);
  bf16* k_s = q_s + BQ * D;
  bf16* v_s = k_s + BKV * D;
  float* s_s = reinterpret_cast<float*>(v_s + BKV * DV);
  bf16* ph_s = reinterpret_cast<bf16*>(s_s + BQ * BKV);
  bf16* pl_s = ph_s + BQ * BKV;
  float* o_s = reinterpret_cast<float*>(pl_s + BQ * BKV);
  float* m_s = o_s + BQ * DV;
  float* l_s = m_s + BQ;

  const int b = blockIdx.y, q0 = blockIdx.x * BQ;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int r0 = warp * 16;  // this warp's first row in the tile
  const bf16* qb = q + (size_t)b * N * D;
  const bf16* kb = k + (size_t)b * N * D;
  const bf16* vb = v + (size_t)b * N * DV;

  load_rows(q_s, qb, q0, BQ, N, D);
  for (int i = threadIdx.x; i < BQ * DV; i += THREADS) o_s[i] = 0.f;
  for (int i = threadIdx.x; i < BQ; i += THREADS) {
    m_s[i] = -INFINITY;
    l_s[i] = 0.f;
  }

  for (int kv0 = 0; kv0 < N; kv0 += BKV) {
    __syncthreads();  // the previous tile's k_s/v_s are no longer read
    load_rows(k_s, kb, kv0, BKV, N, D);
    load_rows(v_s, vb, kv0, BKV, N, DV);
    __syncthreads();

    // S[r0:r0+16, :] = Q K^T for this warp's rows.
    for (int j = 0; j < BKV / 16; ++j) {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
      wmma::fill_fragment(acc, 0.f);
      for (int kk = 0; kk < D; kk += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> bt;
        wmma::load_matrix_sync(a, q_s + r0 * D + kk, D);
        wmma::load_matrix_sync(bt, k_s + j * 16 * D + kk, D);
        wmma::mma_sync(acc, a, bt, acc);
      }
      wmma::store_matrix_sync(s_s + r0 * BKV + j * 16, acc, BKV,
                              wmma::mem_row_major);
    }
    __syncwarp();

    // Online softmax over this key tile, one row at a time across the warp
    // (lane owns columns lane and lane + 32).
    for (int rr = 0; rr < 16; ++rr) {
      const int r = r0 + rr;
      const float* srow = s_s + r * BKV;
      const float x0 = (kv0 + lane < N) ? srow[lane] * scale : -INFINITY;
      const float x1 = (kv0 + lane + 32 < N) ? srow[lane + 32] * scale : -INFINITY;
      float mx = fmaxf(x0, x1);
      for (int o = 16; o > 0; o >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float m_old = m_s[r];
      const float m_new = fmaxf(m_old, mx);  // finite: the tile has a key
      const float alpha = expf(m_old - m_new);
      const float p0 = expf(x0 - m_new), p1 = expf(x1 - m_new);
      float ps = p0 + p1;
      for (int o = 16; o > 0; o >>= 1)
        ps += __shfl_xor_sync(0xffffffffu, ps, o);
      const bf16 h0 = __float2bfloat16_rn(p0), h1 = __float2bfloat16_rn(p1);
      ph_s[r * BKV + lane] = h0;
      ph_s[r * BKV + lane + 32] = h1;
      pl_s[r * BKV + lane] = __float2bfloat16_rn(p0 - __bfloat162float(h0));
      pl_s[r * BKV + lane + 32] = __float2bfloat16_rn(p1 - __bfloat162float(h1));
      for (int c = lane; c < DV; c += 32) o_s[r * DV + c] *= alpha;
      __syncwarp();  // every lane has read m_s[r], l_s[r]
      if (lane == 0) {
        m_s[r] = m_new;
        l_s[r] = l_s[r] * alpha + ps;
      }
    }
    __syncwarp();

    // O[r0:r0+16, :] += (P_hi + P_lo) V.
    for (int j = 0; j < DV / 16; ++j) {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
      wmma::load_matrix_sync(acc, o_s + r0 * DV + j * 16, DV, wmma::mem_row_major);
      for (int kk = 0; kk < BKV; kk += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> ah, al;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> bv;
        wmma::load_matrix_sync(ah, ph_s + r0 * BKV + kk, BKV);
        wmma::load_matrix_sync(al, pl_s + r0 * BKV + kk, BKV);
        wmma::load_matrix_sync(bv, v_s + kk * DV + j * 16, DV);
        wmma::mma_sync(acc, ah, bv, acc);
        wmma::mma_sync(acc, al, bv, acc);
      }
      wmma::store_matrix_sync(o_s + r0 * DV + j * 16, acc, DV, wmma::mem_row_major);
    }
    __syncwarp();
  }

  for (int rr = 0; rr < 16; ++rr) {
    const int r = r0 + rr;
    if (q0 + r >= N) break;
    const float l = l_s[r];
    bf16* orow = out + ((size_t)b * N + q0 + r) * DV;
    for (int c = lane; c < DV; c += 32)
      orow[c] = __float2bfloat16_rn(o_s[r * DV + c] / l);
  }
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
// D, DV multiples of 16 up to 256. Launches on `stream` and returns
// cudaGetLastError().
extern "C" int cabinet_attention(const void* q, const void* k, const void* v,
                                 void* out, int B, int N, int D, int DV,
                                 float scale, void* stream) {
  const size_t smem = smem_bytes(D, DV);
  cudaFuncSetAttribute(attention_kernel,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  dim3 grid((N + BQ - 1) / BQ, B);
  attention_kernel<<<grid, THREADS, smem, (cudaStream_t)stream>>>(
      (const bf16*)q, (const bf16*)k, (const bf16*)v, (bf16*)out, N, D, DV,
      scale);
  return (int)cudaGetLastError();
}
