// Flash-attention training kernels for Hopper (sm_90a), non-causal, head_dim 128.
//
// K3 `fa_fwd_lse_*` replaces goal_force_tpu/ops/flash_attention.py::_fa_kernel_fwd:
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
// bytes, so all three are bound by tensor-core operations. The bf16 K4 and K5 run on
// the Hopper roles of flash_attention_bwd_sm90.cuh (TMA into an mbarrier ring fed by a
// producer warp, every product by wgmma in two consumer warpgroups; K4 key-stationary
// with its products transposed, K5 query-stationary), after `fa_bwd_di`, a pass that
// computes di once per call from o and do. K3's bf16 body is still an mma.sync
// m16n8k16 loop (fragments from ldmatrix, tiles double-buffered with cp.async), as K2
// in flash_attention.cu. The f32 kernels are plain FMA loops for exact checks.
//
// The small PTX helpers of K3 are repeated from flash_attention.cu so that K1/K2's
// source, and the library built from it, stay unchanged.
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
constexpr int LDS = HD + 8;        // padded smem row (bf16 elements): conflict-free ldmatrix
constexpr float MASK_VALUE = -0.7f * 3.4028234663852886e38f;

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, bool pred) {
  unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  int n = pred ? 16 : 0;   // src-size 0 zero-fills the 16 bytes
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(gmem), "r"(n));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() { asm volatile("cp.async.wait_group %0;\n" ::"n"(N)); }

__device__ __forceinline__ void ldmatrix_x4(uint32_t* r, const void* p) {
  unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(a));
}
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t* r, const void* p) {
  unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(a));
}
// c += a (16x16, row) * b (16x8, col), bf16 in, f32 accumulate.
__device__ __forceinline__ void mma_bf16(float* c, const uint32_t* a, uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  bf162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// Loads ROWS rows of 128 bf16 starting at global row `row0` (row stride `gstride`
// elements) into smem (row stride LDS); rows >= `valid` are zero-filled. 128 threads.
template <int ROWS>
__device__ __forceinline__ void load_rows(bf16* sm, const bf16* g, int row0, int valid,
                                          long long gstride) {
#pragma unroll
  for (int i = 0; i < ROWS * 16 / 128; ++i) {
    int c = threadIdx.x + i * 128;
    int r = c >> 4, col = (c & 15) * 8;
    bool ok = row0 + r < valid;
    const bf16* src = ok ? g + (long long)(row0 + r) * gstride + col : g;
    cp_async16(sm + r * LDS + col, src, ok);
  }
}

// A fragments (16 rows x 16 cols at k-chunk kk) of the warp's 16 rows starting at `row0`.
__device__ __forceinline__ void load_a(uint32_t* a, const bf16* sm, int row0, int kk, int lane) {
  int row = row0 + (lane & 7) + ((lane >> 3) & 1) * 8;
  int col = kk * 16 + (lane >> 4) * 8;
  ldmatrix_x4(a, sm + row * LDS + col);
}

// s[0..2*NP) += A (16 x 128, fragments from `sa` at rows arow0..+15) . B^T, where B holds
// 16*NP rows of 128 in smem `sb` (the n dimension is B's row index).
template <int NP>
__device__ __forceinline__ void mma_abt(float (*s)[4], const bf16* sa, int arow0, const bf16* sb,
                                        int lane) {
#pragma unroll
  for (int kk = 0; kk < 8; ++kk) {
    uint32_t a[4];
    load_a(a, sa, arow0, kk, lane);
#pragma unroll
    for (int np = 0; np < NP; ++np) {
      uint32_t b4[4];
      int row = np * 16 + (lane & 7) + (lane >> 4) * 8;
      int col = kk * 16 + ((lane >> 3) & 1) * 8;
      ldmatrix_x4(b4, sb + row * LDS + col);
      mma_bf16(s[2 * np], a, b4[0], b4[1]);
      mma_bf16(s[2 * np + 1], a, b4[2], b4[3]);
    }
  }
}

// acc[0..16) (16 x 128) += P (16 x 16*KC, given in accumulator layout as p[2*KC][4],
// rounded to bf16 here) . B, where B holds 16*KC rows of 128 in smem `sb` (the k
// dimension is B's row index; fragments by transposed ldmatrix).
template <int KC>
__device__ __forceinline__ void mma_pb(float (*acc)[4], const float (*p)[4], const bf16* sb,
                                       int lane) {
#pragma unroll
  for (int kk = 0; kk < KC; ++kk) {
    uint32_t pa[4];
    pa[0] = pack_bf16(p[2 * kk][0], p[2 * kk][1]);
    pa[1] = pack_bf16(p[2 * kk][2], p[2 * kk][3]);
    pa[2] = pack_bf16(p[2 * kk + 1][0], p[2 * kk + 1][1]);
    pa[3] = pack_bf16(p[2 * kk + 1][2], p[2 * kk + 1][3]);
#pragma unroll
    for (int dp = 0; dp < 8; ++dp) {
      uint32_t b4[4];
      int row = kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8;
      int col = dp * 16 + (lane >> 4) * 8;
      ldmatrix_x4_trans(b4, sb + row * LDS + col);
      mma_bf16(acc[2 * dp], pa, b4[0], b4[1]);
      mma_bf16(acc[2 * dp + 1], pa, b4[2], b4[3]);
    }
  }
}

// Stores a warp's 16 x 128 f32 accumulator as bf16 rows r0 = row0 + g and r0 + 8.
__device__ __forceinline__ void store_rows(bf16* out, const float (*acc)[4], long long base,
                                           int row0, int valid, long long rs, int g, int t,
                                           float mul0 = 1.f, float mul1 = 1.f) {
  const int r0 = row0 + g, r1 = r0 + 8;
#pragma unroll
  for (int n = 0; n < 16; ++n) {
    const int col = n * 8 + 2 * t;
    if (r0 < valid)
      *reinterpret_cast<bf162*>(out + base + (long long)r0 * rs + col) =
          __floats2bfloat162_rn(acc[n][0] * mul0, acc[n][1] * mul0);
    if (r1 < valid)
      *reinterpret_cast<bf162*>(out + base + (long long)r1 * rs + col) =
          __floats2bfloat162_rn(acc[n][2] * mul1, acc[n][3] * mul1);
  }
}

// ---------------------------------------------------------------------------
// K3, bf16: 4 warps x 16 query rows, 64-key tiles double-buffered.
// ---------------------------------------------------------------------------
constexpr int BQ = 64;
constexpr int BK = 64;

__global__ void __launch_bounds__(128, 2)
fa_fwd_lse_bf16(const bf16* __restrict__ q, const bf16* __restrict__ k,
                const bf16* __restrict__ v, bf16* __restrict__ o, float* __restrict__ lse,
                int Sq, int Skv, int N, float scale) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Qs = reinterpret_cast<bf16*>(smem_raw);
  bf16* Ks = Qs + BQ * LDS;       // 2 stages
  bf16* Vs = Ks + 2 * BK * LDS;   // 2 stages

  const int qt = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const long long rs = (long long)N * HD;
  const long long qbase = ((long long)b * Sq * N + h) * HD;
  const bf16* kb = k + ((long long)b * Skv * N + h) * HD;
  const bf16* vb = v + ((long long)b * Skv * N + h) * HD;
  const int n_tiles = (Skv + BK - 1) / BK;
  const int q0 = qt * BQ;

  load_rows<BQ>(Qs, q + qbase, q0, Sq, rs);
  if (n_tiles > 0) {
    load_rows<BK>(Ks, kb, 0, Skv, rs);
    load_rows<BK>(Vs, vb, 0, Skv, rs);
  }
  cp_async_commit();

  float acc[16][4];
#pragma unroll
  for (int n = 0; n < 16; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
  float l0 = 0.f, l1 = 0.f;                 // partial row sums (rows g, g+8)
  float m0 = -INFINITY, m1 = -INFINITY;     // running row max (natural-log domain)

  for (int j = 0; j < n_tiles; ++j) {
    const int stage = j & 1;
    if (j + 1 < n_tiles) {
      load_rows<BK>(Ks + (stage ^ 1) * BK * LDS, kb, (j + 1) * BK, Skv, rs);
      load_rows<BK>(Vs + (stage ^ 1) * BK * LDS, vb, (j + 1) * BK, Skv, rs);
    }
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const bf16* Kt = Ks + stage * BK * LDS;
    const bf16* Vt = Vs + stage * BK * LDS;

    float s[8][4];
#pragma unroll
    for (int n = 0; n < 8; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
    mma_abt<4>(s, Qs, warp * 16, Kt, lane);

    const int kbase = j * BK;
    const bool straddles = kbase + BK > Skv;
    float mx0 = MASK_VALUE, mx1 = MASK_VALUE;
#pragma unroll
    for (int n = 0; n < 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[n][e] *= scale;
        if (straddles && kbase + n * 8 + 2 * t + (e & 1) >= Skv) s[n][e] = MASK_VALUE;
      }
      mx0 = fmaxf(mx0, fmaxf(s[n][0], s[n][1]));
      mx1 = fmaxf(mx1, fmaxf(s[n][2], s[n][3]));
    }
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffff, mx0, 1));
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffff, mx0, 2));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffff, mx1, 1));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffff, mx1, 2));
    const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
    const float a0 = expf(m0 - mn0), a1 = expf(m1 - mn1);
    m0 = mn0;
    m1 = mn1;
    float ps0 = 0.f, ps1 = 0.f;
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      s[n][0] = expf(s[n][0] - mn0);
      s[n][1] = expf(s[n][1] - mn0);
      s[n][2] = expf(s[n][2] - mn1);
      s[n][3] = expf(s[n][3] - mn1);
      ps0 += s[n][0] + s[n][1];
      ps1 += s[n][2] + s[n][3];
    }
    l0 = a0 * l0 + ps0;
    l1 = a1 * l1 + ps1;
#pragma unroll
    for (int n = 0; n < 16; ++n) {
      acc[n][0] *= a0;
      acc[n][1] *= a0;
      acc[n][2] *= a1;
      acc[n][3] *= a1;
    }
    mma_pb<4>(acc, s, Vt, lane);   // acc += bf16(p) V
    __syncthreads();
  }
  cp_async_wait<0>();

  l0 += __shfl_xor_sync(0xffffffff, l0, 1);
  l0 += __shfl_xor_sync(0xffffffff, l0, 2);
  l1 += __shfl_xor_sync(0xffffffff, l1, 1);
  l1 += __shfl_xor_sync(0xffffffff, l1, 2);
  store_rows(o, acc, qbase, q0 + warp * 16, Sq, rs, g, t, l0 == 0.f ? 1.f : 1.f / l0,
             l1 == 0.f ? 1.f : 1.f / l1);
  if (t == 0) {
    const int r0 = q0 + warp * 16 + g, r1 = r0 + 8;
    float* lb = lse + ((long long)b * N + h) * Sq;
    if (r0 < Sq) lb[r0] = m0 + logf(fmaxf(l0, 1e-30f));
    if (r1 < Sq) lb[r1] = m1 + logf(fmaxf(l1, 1e-30f));
  }
}

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

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffff, x, 1);
  return x + __shfl_xor_sync(0xffffffff, x, 2);
}

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

template <typename K>
int set_smem(K kernel, int bytes) {
  return static_cast<int>(
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes));
}

}  // namespace

extern "C" {

// K3: q/o (B, Sq, N, 128), k/v (B, Skv, N, 128), contiguous, all bf16 (is_bf16=1) or all
// f32; lse (B, N, Sq) f32.
int gf_fa_fwd_lse(int is_bf16, const void* q, const void* k, const void* v, void* o, float* lse,
                  int B, int Sq, int Skv, int N, float scale, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_bf16) {
    const int smem = (BQ + 4 * BK) * LDS * static_cast<int>(sizeof(bf16));
    set_smem(fa_fwd_lse_bf16, smem);
    dim3 grid((Sq + BQ - 1) / BQ, N, B);
    fa_fwd_lse_bf16<<<grid, 128, smem, st>>>(
        static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
        static_cast<bf16*>(o), lse, Sq, Skv, N, scale);
  } else {
    dim3 grid((Sq + FB - 1) / FB, N, B);
    fa_fwd_lse_f32<<<grid, 128, 0, st>>>(
        static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
        static_cast<float*>(o), lse, Sq, Skv, N, scale);
  }
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
