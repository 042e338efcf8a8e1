// Flash-attention training kernels for Hopper (sm_90a), non-causal, head_dim 128.
//
// K3 `gf_fa_fwd_lse` replaces goal_force_tpu/ops/flash_attention.py::_fa_kernel_fwd:
//    online-max forward in the natural exp domain. s = (q.k^T) * scale in f32 (the
//    scale is NOT folded into q), p = exp(s - m), l and acc rescaled by
//    alpha = exp(m_prev - m_next), o = acc / l, and lse = m + log(max(l, 1e-30)),
//    written as (B, N, Sq) f32 (the TPU's 128-lane replication is not kept).
// K4 `gf_fa_bwd_dkv` replaces _fa_kernel_dkv: dk, dv. p = exp(s - lse),
//    di = rowsum(o*do), dv += bf16(p)^T do, ds = bf16(p * (do.v^T - di) * scale),
//    dk += ds^T q.
// K5 `gf_fa_bwd_dq` replaces _fa_kernel_dq: dq += bf16(ds) k.
//
// All of them read the packed (B, S, N, 128) tensors in place (row stride N*128), use no
// atomics, and keep every sum in f32. Keys at index >= Skv contribute p = 0; rows past
// Sq are zero-filled and never written.
//
// Bound on the H100: at the training shapes (32,760 queries against 32,760 or 512
// keys) K3 does 4, K4 8 and K5 6 * Sq*Skv*128 flops per (batch, head) on O(S*128)
// bytes, so all three are bound by tensor-core operations, which only wgmma reaches.
// The bf16 K3 is a policy of the forward skeleton (flash_attention_sm90.cuh: a producer
// warp feeds 128-key K/V tiles by TMA into an mbarrier ring, two consumer warpgroups of
// 64 query rows run QK^T and PV by wgmma and take turns at the softmax, so one's
// exponentials overlap the other's products): K1's bf16 tiles and QK^T without the q fold,
// the online max of sm90::OnlineMax on the raw f32 accumulator, and an epilogue that writes
// lse. Its exponential is one MUFU.EX2 per logit: p = ex2.approx(fma(s, c, -m*c)) and
// alpha = ex2.approx((m_prev - m_next)*c) with c = scale*log2 e in f32, which differs from
// exp(s*scale - m*scale) only in the float32 rounding of the argument, as in K4/K5 below;
// expf would cost about 7 more instructions per logit in its range reduction. The bf16 K4
// and K5 run on the Hopper roles of flash_attention_bwd_sm90.cuh (TMA into an mbarrier ring
// fed by a producer warp, every product by wgmma in two consumer warpgroups; K4
// key-stationary with its products transposed, K5 query-stationary), after `fa_bwd_di`, a
// pass that computes di once per call from o and do. The f32 kernels are plain FMA loops
// for exact checks.
//
// C interface (loaded with ctypes): every entry point returns cudaGetLastError()
// after its launch, so a refused launch reaches the caller.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "flash_attention_bwd_sm90.cuh"

namespace {

typedef __nv_bfloat16 bf16;
typedef __nv_bfloat162 bf162;

constexpr int HD = 128;            // head dim
using sm90::MASK_VALUE;
using sm90::quad_sum;

// ---------------------------------------------------------------------------
// K3, bf16, on the forward skeleton.
// ---------------------------------------------------------------------------

// ex2.approx with c = scale*log2 e: the natural exp of s*scale in one MUFU.EX2.
struct NaturalDomain {
  __device__ static float log2_factor(const sm90::Args& a) { return a.qscale; }
  __device__ static float exp2(float x) { return sm90_bwd::ex2(x); }
};

struct K3Policy : sm90::Bf16QK {
  __device__ static int kv_valid(const sm90::Args& a, int) { return a.Skv; }
  __device__ static void prepare_q(const sm90::Args&, unsigned char*, int, int) {}   // no fold

  struct State : sm90::OnlineMax<NaturalDomain> {
    // lse = m*scale + log(max(l, 1e-30)) of rows r0 and r0 + 8, by one lane of the quad
    // (m is the raw max; fl(m*scale) is the max of fl(s*scale), JAX's m).
    __device__ void epilogue(const sm90::Args& a, int b, int h, int r0, int t) {
      if (t != 0) return;
      float* lb = a.lse + ((long long)b * a.N + h) * a.Sq;
      if (r0 < a.Sq) lb[r0] = __fmul_rn(m0, a.scale) + logf(fmaxf(l0, 1e-30f));
      if (r0 + 8 < a.Sq) lb[r0 + 8] = __fmul_rn(m1, a.scale) + logf(fmaxf(l1, 1e-30f));
    }
  };
};

// ---------------------------------------------------------------------------
// The lse*log2 e / di scratch of K4 and K5, once per call: (2, B, N, rows) f32 with rows =
// Sq rounded up to sm90_bwd::SCRATCH_ROWS; [0] = lse*log2(e), [1] = rowsum(f32(o)*f32(do)),
// and +inf / 0 for rows >= Sq, so p = exp2(s' - inf) is exactly 0 there. 8 threads per row
// (16 columns each), 32 rows of one head per block, so the stores are contiguous.
// ---------------------------------------------------------------------------
__global__ void __launch_bounds__(256)
fa_bwd_di(const bf16* __restrict__ o, const bf16* __restrict__ dout, const float* __restrict__ lse,
          float* __restrict__ scratch, int B, int Sq, int N, int rows) {
  const int h = blockIdx.y, b = blockIdx.z;
  const int r = blockIdx.x * 32 + (threadIdx.x >> 3), c = threadIdx.x & 7;
  float d = 0.f;
  if (r < Sq) {
    const long long off = (((long long)b * Sq + r) * N + h) * HD + c * 16;
#pragma unroll
    for (int x = 0; x < 2; ++x) {
      const uint4 a = *reinterpret_cast<const uint4*>(o + off + 8 * x);
      const uint4 e = *reinterpret_cast<const uint4*>(dout + off + 8 * x);
      const bf162* a2 = reinterpret_cast<const bf162*>(&a);
      const bf162* e2 = reinterpret_cast<const bf162*>(&e);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float2 fa = __bfloat1622float2(a2[i]), fe = __bfloat1622float2(e2[i]);
        d = fmaf(fa.x, fe.x, d);
        d = fmaf(fa.y, fe.y, d);
      }
    }
  }
  d += __shfl_xor_sync(0xffffffff, d, 1);
  d += __shfl_xor_sync(0xffffffff, d, 2);
  d += __shfl_xor_sync(0xffffffff, d, 4);
  if (c == 0 && r < rows) {
    const long long bh = (long long)b * N + h;
    scratch[bh * rows + r] = r < Sq ? lse[bh * Sq + r] * sm90_bwd::LOG2E : INFINITY;
    scratch[((long long)B * N + bh) * rows + r] = d;
  }
}

// The scratch, then K4 (dkv) or K5 on the Hopper roles of flash_attention_bwd_sm90.cuh.
int launch_sm90(bool dkv, const void* q, const void* k, const void* v, const void* o,
                const void* dout, const float* lse, float* scratch, void* dk, void* dv, void* dq,
                int B, int Sq, int Skv, int N, float scale, const long long* geom,
                cudaStream_t st) {
  const int rows = (Sq + sm90_bwd::SCRATCH_ROWS - 1) / sm90_bwd::SCRATCH_ROWS *
                   sm90_bwd::SCRATCH_ROWS;
  fa_bwd_di<<<dim3(rows / 32, N, B), 256, 0, st>>>(
      static_cast<const bf16*>(o), static_cast<const bf16*>(dout), lse, scratch, B, Sq, N, rows);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  sm90_bwd::Args a{};
  a.lse2 = scratch;
  a.di = scratch + (long long)B * N * rows;
  a.dk = dk;
  a.dv = dv;
  a.dq = dq;
  a.Sq = Sq;
  a.Skv = Skv;
  a.N = N;
  a.rows = rows;
  a.scale = scale;
  a.scale_log2 = scale * sm90_bwd::LOG2E;
  return sm90_bwd::launch(dkv, q, dout, k, v, a, B, geom, st);
}

// ---------------------------------------------------------------------------
// f32 kernels: 4 lanes per row; lane c of a row owns dims c, c+4, ..., c+124.
// ---------------------------------------------------------------------------
constexpr int FB = 32;    // rows per CTA and keys per tile
constexpr int FQ = 16;    // query rows per tile in the dK/dV kernel

__global__ void __launch_bounds__(128)
fa_fwd_lse_f32(const float* __restrict__ q, const float* __restrict__ k,
               const float* __restrict__ v, float* __restrict__ o, float* __restrict__ lse,
               int Sq, int Skv, int N, float scale) {
  __shared__ float Ks[FB][HD];
  __shared__ float Vs[FB][HD];
  const int h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, row = tid >> 2, c = tid & 3;
  const long long rs = (long long)N * HD;
  const int qi = blockIdx.x * FB + row;
  const float* kb = k + ((long long)b * Skv * N + h) * HD;
  const float* vb = v + ((long long)b * Skv * N + h) * HD;

  float qr[32], acc[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    qr[i] = qi < Sq ? q[((long long)b * Sq + qi) * rs + h * HD + i * 4 + c] : 0.f;
    acc[i] = 0.f;
  }
  float l = 0.f, m = -INFINITY;
  const int n_tiles = (Skv + FB - 1) / FB;
  for (int j = 0; j < n_tiles; ++j) {
    __syncthreads();
    for (int e = tid; e < FB * HD; e += 128) {
      int r = e / HD, col = e % HD, key = j * FB + r;
      Ks[r][col] = key < Skv ? kb[key * rs + col] : 0.f;
      Vs[r][col] = key < Skv ? vb[key * rs + col] : 0.f;
    }
    __syncthreads();
    float s[FB];
    float mx = MASK_VALUE;
#pragma unroll
    for (int r = 0; r < FB; ++r) {
      float d = 0.f;
#pragma unroll
      for (int i = 0; i < 32; ++i) d = fmaf(qr[i], Ks[r][i * 4 + c], d);
      d = quad_sum(d) * scale;
      s[r] = j * FB + r < Skv ? d : MASK_VALUE;
      mx = fmaxf(mx, s[r]);
    }
    const float mn = fmaxf(m, mx), alpha = expf(m - mn);
    m = mn;
    float ps = 0.f;
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[i] *= alpha;
#pragma unroll
    for (int r = 0; r < FB; ++r) {
      float p = expf(s[r] - mn);
      ps += p;
#pragma unroll
      for (int i = 0; i < 32; ++i) acc[i] = fmaf(p, Vs[r][i * 4 + c], acc[i]);
    }
    l = alpha * l + ps;
  }
  if (qi < Sq) {
    const float inv = l == 0.f ? 1.f : 1.f / l;
#pragma unroll
    for (int i = 0; i < 32; ++i) o[((long long)b * Sq + qi) * rs + h * HD + i * 4 + c] = acc[i] * inv;
    if (c == 0) lse[((long long)b * N + h) * Sq + qi] = m + logf(fmaxf(l, 1e-30f));
  }
}

__global__ void __launch_bounds__(128)
fa_bwd_dkv_f32(const float* __restrict__ q, const float* __restrict__ k,
               const float* __restrict__ v, const float* __restrict__ o,
               const float* __restrict__ dout, const float* __restrict__ lse,
               float* __restrict__ dk, float* __restrict__ dv, int Sq, int Skv, int N,
               float scale) {
  __shared__ float Qs[FQ][HD];
  __shared__ float dOs[FQ][HD];
  __shared__ float lse_s[FQ], di_s[FQ];
  const int h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, row = tid >> 2, c = tid & 3;
  const long long rs = (long long)N * HD;
  const int key = blockIdx.x * FB + row;
  const bool kvalid = key < Skv;
  const long long qoff = (long long)b * Sq * rs + h * HD;
  const float* lb = lse + ((long long)b * N + h) * Sq;

  float kr[32], vr[32], dka[32], dva[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    const long long off = ((long long)b * Skv + key) * rs + h * HD + i * 4 + c;
    kr[i] = kvalid ? k[off] : 0.f;
    vr[i] = kvalid ? v[off] : 0.f;
    dka[i] = dva[i] = 0.f;
  }
  const int n_qt = (Sq + FQ - 1) / FQ;
  for (int it = 0; it < n_qt; ++it) {
    const int qbase = it * FQ;
    __syncthreads();
    for (int e = tid; e < FQ * HD; e += 128) {
      int r = e / HD, col = e % HD, qi = qbase + r;
      Qs[r][col] = qi < Sq ? q[qoff + qi * rs + col] : 0.f;
      dOs[r][col] = qi < Sq ? dout[qoff + qi * rs + col] : 0.f;
    }
    {  // di of the tile's 16 rows: 8 threads per row, 16 columns each
      const int r = tid >> 3, c8 = tid & 7, qi = qbase + r;
      float d = 0.f;
      if (qi < Sq) {
#pragma unroll
        for (int x = 0; x < 16; ++x) {
          const long long off = qoff + qi * rs + c8 * 16 + x;
          d = fmaf(o[off], dout[off], d);
        }
      }
      d += __shfl_xor_sync(0xffffffff, d, 1);
      d += __shfl_xor_sync(0xffffffff, d, 2);
      d += __shfl_xor_sync(0xffffffff, d, 4);
      if (c8 == 0) {
        di_s[r] = d;
        lse_s[r] = qi < Sq ? lb[qi] : 0.f;
      }
    }
    __syncthreads();
    for (int r = 0; r < FQ; ++r) {
      float s = 0.f, dp = 0.f;
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        s = fmaf(kr[i], Qs[r][i * 4 + c], s);
        dp = fmaf(vr[i], dOs[r][i * 4 + c], dp);
      }
      s = quad_sum(s);
      dp = quad_sum(dp);
      float p = expf(s * scale - lse_s[r]);
      if (!kvalid || qbase + r >= Sq) p = 0.f;
      const float ds = p * (dp - di_s[r]) * scale;
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        dva[i] = fmaf(p, dOs[r][i * 4 + c], dva[i]);
        dka[i] = fmaf(ds, Qs[r][i * 4 + c], dka[i]);
      }
    }
  }
  if (kvalid) {
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const long long off = ((long long)b * Skv + key) * rs + h * HD + i * 4 + c;
      dk[off] = dka[i];
      dv[off] = dva[i];
    }
  }
}

__global__ void __launch_bounds__(128)
fa_bwd_dq_f32(const float* __restrict__ q, const float* __restrict__ k,
              const float* __restrict__ v, const float* __restrict__ o,
              const float* __restrict__ dout, const float* __restrict__ lse,
              float* __restrict__ dq, int Sq, int Skv, int N, float scale) {
  __shared__ float Ks[FB][HD];
  __shared__ float Vs[FB][HD];
  const int h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, row = tid >> 2, c = tid & 3;
  const long long rs = (long long)N * HD;
  const int qi = blockIdx.x * FB + row;
  const bool qvalid = qi < Sq;
  const float* kb = k + ((long long)b * Skv * N + h) * HD;
  const float* vb = v + ((long long)b * Skv * N + h) * HD;

  float qr[32], dor[32], dqa[32];
  float di = 0.f;
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    const long long off = ((long long)b * Sq + qi) * rs + h * HD + i * 4 + c;
    qr[i] = qvalid ? q[off] : 0.f;
    dor[i] = qvalid ? dout[off] : 0.f;
    di = fmaf(qvalid ? o[off] : 0.f, dor[i], di);
    dqa[i] = 0.f;
  }
  di = quad_sum(di);
  const float lse_r = qvalid ? lse[((long long)b * N + h) * Sq + qi] : 0.f;
  const int n_tiles = (Skv + FB - 1) / FB;
  for (int j = 0; j < n_tiles; ++j) {
    __syncthreads();
    for (int e = tid; e < FB * HD; e += 128) {
      int r = e / HD, col = e % HD, key = j * FB + r;
      Ks[r][col] = key < Skv ? kb[key * rs + col] : 0.f;
      Vs[r][col] = key < Skv ? vb[key * rs + col] : 0.f;
    }
    __syncthreads();
    for (int r = 0; r < FB; ++r) {
      float s = 0.f, dp = 0.f;
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        s = fmaf(qr[i], Ks[r][i * 4 + c], s);
        dp = fmaf(dor[i], Vs[r][i * 4 + c], dp);
      }
      s = quad_sum(s);
      dp = quad_sum(dp);
      float p = expf(s * scale - lse_r);
      if (j * FB + r >= Skv) p = 0.f;
      const float ds = p * (dp - di) * scale;
#pragma unroll
      for (int i = 0; i < 32; ++i) dqa[i] = fmaf(ds, Ks[r][i * 4 + c], dqa[i]);
    }
  }
  if (qvalid) {
#pragma unroll
    for (int i = 0; i < 32; ++i) dq[((long long)b * Sq + qi) * rs + h * HD + i * 4 + c] = dqa[i];
  }
}

}  // namespace

extern "C" {

// K3: q/o (B, Sq, N, 128), k/v (B, Skv, N, 128), contiguous, all bf16 (is_bf16=1) or all
// f32; lse (B, N, Sq) f32. bf16 takes the geometry array of
// ops/flash_attention.py::sm90_geometry (host memory, int64); f32 ignores it.
int gf_fa_fwd_lse(int is_bf16, const void* q, const void* k, const void* v, void* o, float* lse,
                  int B, int Sq, int Skv, int N, float scale, const long long* geom, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_bf16) {
    sm90::Args a{};
    a.o = o;
    a.lse = lse;
    a.Sq = Sq;
    a.Skv = Skv;
    a.N = N;
    a.qscale = scale * sm90_bwd::LOG2E;
    a.scale = scale;
    return sm90::launch<K3Policy>(CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, q, k, v, a, B, geom, st);
  }
  dim3 grid((Sq + FB - 1) / FB, N, B);
  fa_fwd_lse_f32<<<grid, 128, 0, st>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<float*>(o), lse, Sq, Skv, N, scale);
  return static_cast<int>(cudaGetLastError());
}

// K4: dk/dv (B, Skv, N, 128) in k's dtype; o/do like q; lse (B, N, Sq) f32. bf16 takes
// a (2, B, N, Sq rounded up to 128) f32 scratch it fills first, and the geometry array of
// ops/flash_attention.py::sm90_bwd_geometry (host memory, int64); f32 ignores both.
int gf_fa_bwd_dkv(int is_bf16, const void* q, const void* k, const void* v, const void* o,
                  const void* dout, const float* lse, float* scratch, void* dk, void* dv, int B,
                  int Sq, int Skv, int N, float scale, const long long* geom, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return launch_sm90(true, q, k, v, o, dout, lse, scratch, dk, dv, nullptr, B, Sq, Skv, N, scale,
                       geom, st);
  dim3 grid((Skv + FB - 1) / FB, N, B);
  fa_bwd_dkv_f32<<<grid, 128, 0, st>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<const float*>(o), static_cast<const float*>(dout), lse,
      static_cast<float*>(dk), static_cast<float*>(dv), Sq, Skv, N, scale);
  return static_cast<int>(cudaGetLastError());
}

// K5: dq (B, Sq, N, 128) in q's dtype; the same inputs, scratch and geometry as K4.
int gf_fa_bwd_dq(int is_bf16, const void* q, const void* k, const void* v, const void* o,
                 const void* dout, const float* lse, float* scratch, void* dq, int B, int Sq, int Skv,
                 int N, float scale, const long long* geom, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return launch_sm90(false, q, k, v, o, dout, lse, scratch, nullptr, nullptr, dq, B, Sq, Skv, N,
                       scale, geom, st);
  dim3 grid((Sq + FB - 1) / FB, N, B);
  fa_bwd_dq_f32<<<grid, 128, 0, st>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<const float*>(o), static_cast<const float*>(dout), lse,
      static_cast<float*>(dq), Sq, Skv, N, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
