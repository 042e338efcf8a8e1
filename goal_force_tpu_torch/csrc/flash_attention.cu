// Flash-attention forward kernels for Hopper (sm_90a), non-causal, head_dim 128.
//
// K1 `gf_fa_nomax` replaces the TPU kernel goal_force_tpu/ops/flash_attention.py::
//    _fa_kernel_nomax: max-free softmax in the log2 domain, p = exp2(min(s, clamp)),
//    l += sum(p), acc += p.V, o = acc / l.
// K2 `gf_fa_max` replaces goal_force_tpu/ops/flash_attention.py::_fa_kernel: the same
//    with a running row max m, alpha = exp2(m_prev - m_next) rescaling l and acc.
//
// Both read the packed (B, S, N, 128) tensors in place: a CTA owns one
// (q tile, head, batch) and walks the KV tiles of that head up to the batch row's
// kv_len; tiles past kv_len are never loaded, the one that straddles it is masked
// (masked keys add exactly 0), and a row with no valid key writes 0. The softmax scale
// times log2(e) (rounded to q's dtype by the caller) is folded into q in the kernel, and
// the folded q is rounded back to q's dtype. p is cast to V's dtype before the PV
// product; sums are f32; o is written in q's dtype.
//
// Bound on the H100: at the main-path shapes (32,760 queries against 32,760 or 512
// keys) the kernel does 4*Sq*Skv*128 flops per (batch, head) on ~Sq*128*2 bytes of
// q and o, so it is bound by tensor-core operations, not by memory (44.4 ms for the
// serving self shape at 989 TFLOP/s). Only wgmma reaches that rate, so the bf16 K1
// runs on the Hopper skeleton of csrc/flash_attention_sm90.cuh: TMA loads of 128-key K
// and V tiles into an mbarrier ring fed by a producer warp, two consumer warpgroups of
// 64 query rows that run QK^T (wgmma m64n128k16, Q and K in shared memory) and PV
// (P from registers, V MN-major) with the softmax between them. K1's part is the policy
// below: the q fold in shared memory before the first product, and the max-free
// exponent with the straddle mask.
//
// K2 keeps its first design: an FA2-style mma.sync m16n8k16 loop (4 warps, 16 query rows
// each, 64-key tiles double-buffered in shared memory with cp.async, fragments loaded
// with ldmatrix). It runs only where the logit bound is too large for K1. The f32
// kernels are plain FMA loops; they exist for exact checks, not for the main path.
//
// C interface (loaded with ctypes): every entry point returns cudaGetLastError() after
// its launch (or the error that refused it), so a refused launch reaches the caller.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "flash_attention_sm90.cuh"

namespace {

constexpr int HD = 128;            // head dim
constexpr int BQ = 64;             // query rows per CTA (K2, bf16)
constexpr int BK = 64;             // keys per tile (K2, bf16)
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
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// Loads `rows` rows of 128 bf16 starting at global row `row0` (row stride `gstride`
// elements) into smem (row stride LDS); rows >= `valid` are zero-filled.
__device__ __forceinline__ void load_tile(__nv_bfloat16* sm, const __nv_bfloat16* g, int row0,
                                          int valid, long long gstride) {
  // 64 rows x 16 chunks of 16 bytes = 1024 chunks over 128 threads.
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    int c = threadIdx.x + i * 128;
    int r = c >> 4, col = (c & 15) * 8;
    bool ok = row0 + r < valid;
    const __nv_bfloat16* src = ok ? g + (long long)(row0 + r) * gstride + col : g;
    cp_async16(sm + r * LDS + col, src, ok);
  }
}

// K2, bf16: mma.sync m16n8k16, an FA2-style loop (see the note at the top).
__global__ void __launch_bounds__(128, 2)
fa_max_bf16(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
            const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ o,
            const int* __restrict__ kv_len, int Sq, int Skv, int N, float qscale) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* Ks = Qs + BQ * LDS;       // 2 stages
  __nv_bfloat16* Vs = Ks + 2 * BK * LDS;   // 2 stages

  const int qt = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const long long rs = (long long)N * HD;   // row stride of the packed layout
  const __nv_bfloat16* qb = q + ((long long)b * Sq * N + h) * HD;
  const __nv_bfloat16* kb = k + ((long long)b * Skv * N + h) * HD;
  const __nv_bfloat16* vb = v + ((long long)b * Skv * N + h) * HD;
  int kvl = kv_len[b];
  kvl = kvl < 0 ? 0 : (kvl > Skv ? Skv : kvl);
  const int n_tiles = (kvl + BK - 1) / BK;
  const int q0 = qt * BQ;

  // Q tile: load, fold scale*log2e and round to bf16, then keep fragments in registers.
  load_tile(Qs, qb, q0, Sq, rs);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
  for (int i = tid; i < BQ * HD / 2; i += 128) {
    int r = (2 * i) / HD, col = (2 * i) % HD;
    __nv_bfloat162* p2 = reinterpret_cast<__nv_bfloat162*>(Qs + r * LDS + col);
    float2 f = __bfloat1622float2(*p2);
    *p2 = __floats2bfloat162_rn(f.x * qscale, f.y * qscale);
  }
  __syncthreads();
  uint32_t qa[8][4];
#pragma unroll
  for (int kk = 0; kk < 8; ++kk) {
    int row = warp * 16 + (lane & 7) + ((lane >> 3) & 1) * 8;
    int col = kk * 16 + (lane >> 4) * 8;
    ldmatrix_x4(qa[kk], Qs + row * LDS + col);
  }

  float acc[16][4];
#pragma unroll
  for (int n = 0; n < 16; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
  float l0 = 0.f, l1 = 0.f;                 // partial row sums (rows g, g+8)
  float m0 = -INFINITY, m1 = -INFINITY;     // running row max

  if (n_tiles > 0) {
    load_tile(Ks, kb, 0, Skv, rs);
    load_tile(Vs, vb, 0, Skv, rs);
  }
  cp_async_commit();

  for (int j = 0; j < n_tiles; ++j) {
    const int stage = j & 1;
    if (j + 1 < n_tiles) {
      load_tile(Ks + (stage ^ 1) * BK * LDS, kb, (j + 1) * BK, Skv, rs);
      load_tile(Vs + (stage ^ 1) * BK * LDS, vb, (j + 1) * BK, Skv, rs);
    }
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const __nv_bfloat16* Kt = Ks + stage * BK * LDS;
    const __nv_bfloat16* Vt = Vs + stage * BK * LDS;

    // S = Q K^T for this warp's 16 rows x 64 keys (8 n-tiles of 8 keys).
    float s[8][4];
#pragma unroll
    for (int n = 0; n < 8; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < 8; ++kk) {
#pragma unroll
      for (int np = 0; np < 4; ++np) {
        uint32_t bk4[4];
        int key = np * 16 + (lane & 7) + (lane >> 4) * 8;
        int col = kk * 16 + ((lane >> 3) & 1) * 8;
        ldmatrix_x4(bk4, Kt + key * LDS + col);
        mma_bf16(s[2 * np], qa[kk], bk4[0], bk4[1]);
        mma_bf16(s[2 * np + 1], qa[kk], bk4[2], bk4[3]);
      }
    }

    const int kbase = j * BK;
    const bool straddles = kbase + BK > kvl;
    float p[8][4];
    {
      float mx0 = MASK_VALUE, mx1 = MASK_VALUE;
#pragma unroll
      for (int n = 0; n < 8; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          if (straddles && kbase + n * 8 + 2 * t + (e & 1) >= kvl) s[n][e] = MASK_VALUE;
        }
        mx0 = fmaxf(mx0, fmaxf(s[n][0], s[n][1]));
        mx1 = fmaxf(mx1, fmaxf(s[n][2], s[n][3]));
      }
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffff, mx0, 1));
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffff, mx0, 2));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffff, mx1, 1));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffff, mx1, 2));
      const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
      const float a0 = exp2f(m0 - mn0), a1 = exp2f(m1 - mn1);
      m0 = mn0;
      m1 = mn1;
      float ps0 = 0.f, ps1 = 0.f;
#pragma unroll
      for (int n = 0; n < 8; ++n) {
        p[n][0] = exp2f(s[n][0] - mn0);
        p[n][1] = exp2f(s[n][1] - mn0);
        p[n][2] = exp2f(s[n][2] - mn1);
        p[n][3] = exp2f(s[n][3] - mn1);
        ps0 += p[n][0] + p[n][1];
        ps1 += p[n][2] + p[n][3];
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
    }

    // acc += bf16(P) V: P's accumulator layout is the A-fragment layout of the PV mma.
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      uint32_t pa[4];
      pa[0] = pack_bf16(p[2 * kk][0], p[2 * kk][1]);
      pa[1] = pack_bf16(p[2 * kk][2], p[2 * kk][3]);
      pa[2] = pack_bf16(p[2 * kk + 1][0], p[2 * kk + 1][1]);
      pa[3] = pack_bf16(p[2 * kk + 1][2], p[2 * kk + 1][3]);
#pragma unroll
      for (int dp = 0; dp < 8; ++dp) {
        uint32_t bv4[4];
        int key = kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8;
        int col = dp * 16 + (lane >> 4) * 8;
        ldmatrix_x4_trans(bv4, Vt + key * LDS + col);
        mma_bf16(acc[2 * dp], pa, bv4[0], bv4[1]);
        mma_bf16(acc[2 * dp + 1], pa, bv4[2], bv4[3]);
      }
    }
    __syncthreads();
  }
  cp_async_wait<0>();

  l0 += __shfl_xor_sync(0xffffffff, l0, 1);
  l0 += __shfl_xor_sync(0xffffffff, l0, 2);
  l1 += __shfl_xor_sync(0xffffffff, l1, 1);
  l1 += __shfl_xor_sync(0xffffffff, l1, 2);
  const float inv0 = l0 == 0.f ? 1.f : 1.f / l0;
  const float inv1 = l1 == 0.f ? 1.f : 1.f / l1;
  const int r0 = q0 + warp * 16 + g, r1 = r0 + 8;
#pragma unroll
  for (int n = 0; n < 16; ++n) {
    const int col = n * 8 + 2 * t;
    if (r0 < Sq)
      *reinterpret_cast<__nv_bfloat162*>(o + ((long long)b * Sq * N + (long long)r0 * N + h) * HD + col) =
          __floats2bfloat162_rn(acc[n][0] * inv0, acc[n][1] * inv0);
    if (r1 < Sq)
      *reinterpret_cast<__nv_bfloat162*>(o + ((long long)b * Sq * N + (long long)r1 * N + h) * HD + col) =
          __floats2bfloat162_rn(acc[n][2] * inv1, acc[n][3] * inv1);
  }
}

// f32 kernels: 128 threads own 32 query rows, 4 lanes per row; lane c of a row owns
// dims c, c+4, ..., c+124 (interleaved, so the 4 lanes hit 4 different banks).
constexpr int FBQ = 32;
constexpr int FBK = 32;

template <bool NOMAX>
__global__ void __launch_bounds__(128)
fa_fwd_f32(const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
           float* __restrict__ o, const int* __restrict__ kv_len, int Sq, int Skv, int N,
           float qscale, int use_clamp, float clamp) {
  __shared__ float Ks[FBK][HD];
  __shared__ float Vs[FBK][HD];
  const int qt = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, row = tid >> 2, c = tid & 3;
  const long long rs = (long long)N * HD;
  const int qi = qt * FBQ + row;
  int kvl = kv_len[b];
  kvl = kvl < 0 ? 0 : (kvl > Skv ? Skv : kvl);
  const float* kb = k + ((long long)b * Skv * N + h) * HD;
  const float* vb = v + ((long long)b * Skv * N + h) * HD;

  float qr[32], acc[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    qr[i] = qi < Sq ? q[((long long)b * Sq + qi) * rs + h * HD + i * 4 + c] * qscale : 0.f;
    acc[i] = 0.f;
  }
  float l = 0.f, m = -INFINITY;
  const int n_tiles = (kvl + FBK - 1) / FBK;
  for (int j = 0; j < n_tiles; ++j) {
    __syncthreads();
    for (int e = tid; e < FBK * HD; e += 128) {
      int r = e / HD, col = e % HD, key = j * FBK + r;
      Ks[r][col] = key < Skv ? kb[key * rs + col] : 0.f;
      Vs[r][col] = key < Skv ? vb[key * rs + col] : 0.f;
    }
    __syncthreads();
    float s[FBK];
#pragma unroll
    for (int r = 0; r < FBK; ++r) {
      float d = 0.f;
#pragma unroll
      for (int i = 0; i < 32; ++i) d = fmaf(qr[i], Ks[r][i * 4 + c], d);
      d += __shfl_xor_sync(0xffffffff, d, 1);
      d += __shfl_xor_sync(0xffffffff, d, 2);
      s[r] = d;
    }
    const int kbase = j * FBK;
    if (NOMAX) {
#pragma unroll
      for (int r = 0; r < FBK; ++r) {
        float x = use_clamp ? fminf(s[r], clamp) : s[r];
        float p = kbase + r < kvl ? exp2f(x) : 0.f;
        l += p;
#pragma unroll
        for (int i = 0; i < 32; ++i) acc[i] = fmaf(p, Vs[r][i * 4 + c], acc[i]);
      }
    } else {
      float mx = MASK_VALUE;
#pragma unroll
      for (int r = 0; r < FBK; ++r) {
        if (kbase + r >= kvl) s[r] = MASK_VALUE;
        mx = fmaxf(mx, s[r]);
      }
      const float mn = fmaxf(m, mx), alpha = exp2f(m - mn);
      m = mn;
      float ps = 0.f;
#pragma unroll
      for (int i = 0; i < 32; ++i) acc[i] *= alpha;
#pragma unroll
      for (int r = 0; r < FBK; ++r) {
        float p = exp2f(s[r] - mn);
        ps += p;
#pragma unroll
        for (int i = 0; i < 32; ++i) acc[i] = fmaf(p, Vs[r][i * 4 + c], acc[i]);
      }
      l = alpha * l + ps;
    }
  }
  if (qi < Sq) {
    const float inv = l == 0.f ? 1.f : 1.f / l;
#pragma unroll
    for (int i = 0; i < 32; ++i) o[((long long)b * Sq + qi) * rs + h * HD + i * 4 + c] = acc[i] * inv;
  }
}

// K1 on the Hopper skeleton: bf16 q, k, v, o.
struct K1Policy {
  using Acc = float;
  static constexpr uint32_t kQBytes = 2 * sm90::HALF_BYTES;    // 128 rows x 128 bf16
  static constexpr uint32_t kKBytes = 2 * sm90::HALF_BYTES;
  static constexpr uint32_t kExtraBytes = 0;
  static constexpr int kQRowBytes = 2 * sm90::HD, kKRowBytes = 2 * sm90::HD;

  __device__ static int kv_valid(const sm90::Args& a, int b) {
    const int l = a.kv_len[b];
    return l < 0 ? 0 : (l > a.Skv ? a.Skv : l);
  }
  __device__ static void load_q(uint32_t dst, const CUtensorMap* m, uint32_t bar, int row0, int h,
                                int b) {
    sm90::load_bf16_tile(dst, m, bar, row0, h, b);
  }
  __device__ static void load_k(uint32_t dst, const CUtensorMap* m, uint32_t bar, int row0, int h,
                                int b) {
    sm90::load_bf16_tile(dst, m, bar, row0, h, b);
  }
  __device__ static void produce_extra(const sm90::Args&, unsigned char*, int, int, int, int) {}

  // The q fold, in place on this warpgroup's 64 rows of both halves (elementwise, so the
  // swizzle does not matter); the generic-proxy writes are then made visible to wgmma.
  __device__ static void prepare_q(const sm90::Args& a, unsigned char* gq, int cw, int wtid) {
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      uint4* p = reinterpret_cast<uint4*>(gq + hh * sm90::HALF_BYTES + cw * 64 * 128);
#pragma unroll
      for (int i = wtid; i < 512; i += 128) {
        uint4 x = p[i];
        __nv_bfloat162* e = reinterpret_cast<__nv_bfloat162*>(&x);
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const float2 f = __bfloat1622float2(e[c]);
          e[c] = __floats2bfloat162_rn(f.x * a.qscale, f.y * a.qscale);
        }
        p[i] = x;
      }
    }
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    asm volatile("bar.sync %0, 128;\n" ::"r"(1 + cw) : "memory");
  }

  // Issues S = Q K^T for this warpgroup's 64 rows x 128 keys: 8 k-steps of 16 head dims,
  // the first four in the first 64-column half of Q and K, the last four in the second.
  __device__ static void qk_issue(float* sc, uint32_t sQ, uint32_t sK, int cw) {
#pragma unroll
    for (int kk = 0; kk < 8; ++kk) {
      const uint32_t off = (kk >> 2) * sm90::HALF_BYTES + (kk & 3) * 32;
      sm90::wgmma_ss_bf16(sc, sm90::kmajor_desc(sQ + cw * 64 * 128 + off),
                          sm90::kmajor_desc(sK + off), kk > 0);
    }
  }

  struct State {
    float l0, l1;   // partial row sums (rows r0, r0 + 8)
    __device__ void init(const sm90::Args&, int, int, int) { l0 = l1 = 0.f; }

    // p = exp2(min(s, clamp)), 0 for keys at or past `valid`; P packed to bf16 in the
    // A-fragment order of the PV wgmma.
    __device__ void softmax(float* sc, uint32_t* pf, float*, const sm90::Args& a, int kbase,
                            int valid, const float*, int t) {
      const bool straddles = kbase + sm90::BK > valid;
#pragma unroll
      for (int n = 0; n < 16; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float x = sc[4 * n + e];
          if (a.use_clamp) x = fminf(x, a.clamp);
          sc[4 * n + e] = exp2f(x);
        }
      }
      if (straddles) {   // only the tile that straddles `valid` pays for the mask
#pragma unroll
        for (int n = 0; n < 16; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            if (kbase + n * 8 + 2 * t + (e & 1) >= valid) sc[4 * n + e] = 0.f;
      }
#pragma unroll
      for (int n = 0; n < 16; ++n) {
        l0 += sc[4 * n] + sc[4 * n + 1];
        l1 += sc[4 * n + 2] + sc[4 * n + 3];
      }
#pragma unroll
      for (int kk = 0; kk < 8; ++kk) {
        pf[4 * kk + 0] = sm90::pack_bf16(sc[8 * kk + 0], sc[8 * kk + 1]);
        pf[4 * kk + 1] = sm90::pack_bf16(sc[8 * kk + 2], sc[8 * kk + 3]);
        pf[4 * kk + 2] = sm90::pack_bf16(sc[8 * kk + 4], sc[8 * kk + 5]);
        pf[4 * kk + 3] = sm90::pack_bf16(sc[8 * kk + 6], sc[8 * kk + 7]);
      }
    }
    __device__ void inv_l(float& inv0, float& inv1) {
      const float s0 = sm90::quad_sum(l0), s1 = sm90::quad_sum(l1);
      inv0 = s0 == 0.f ? 1.f : 1.f / s0;
      inv1 = s1 == 0.f ? 1.f : 1.f / s1;
    }
  };
};

}  // namespace

extern "C" {

// K1: max-free flash attention. q/o: (B, Sq, N, 128), k/v: (B, Skv, N, 128), contiguous,
// all bf16 (is_bf16=1) or all f32; kv_len: int32 (B,) on the device. bf16 takes the
// geometry array of ops/flash_attention.py::sm90_geometry (host memory, int64); f32
// ignores it.
int gf_fa_nomax(int is_bf16, const void* q, const void* k, const void* v, void* o,
                const int* kv_len, int B, int Sq, int Skv, int N, float qscale, int use_clamp,
                float clamp, const long long* geom, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_bf16) {
    sm90::Args a{};
    a.o = o;
    a.kv_len = kv_len;
    a.Sq = Sq;
    a.Skv = Skv;
    a.N = N;
    a.qscale = qscale;
    a.use_clamp = use_clamp;
    a.clamp = clamp;
    return sm90::launch<K1Policy>(CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, q, k, v, a, B, geom, st);
  }
  dim3 grid((Sq + FBQ - 1) / FBQ, N, B);
  fa_fwd_f32<true><<<grid, 128, 0, st>>>(static_cast<const float*>(q), static_cast<const float*>(k),
                                         static_cast<const float*>(v), static_cast<float*>(o),
                                         kv_len, Sq, Skv, N, qscale, use_clamp, clamp);
  return static_cast<int>(cudaGetLastError());
}

// K2: online-max flash attention, same arguments (no clamp, no geometry).
int gf_fa_max(int is_bf16, const void* q, const void* k, const void* v, void* o,
              const int* kv_len, int B, int Sq, int Skv, int N, float qscale, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_bf16) {
    const int smem = (BQ + 4 * BK) * LDS * static_cast<int>(sizeof(__nv_bfloat16));
    cudaFuncSetAttribute(fa_max_bf16, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    dim3 grid((Sq + BQ - 1) / BQ, N, B);
    fa_max_bf16<<<grid, 128, smem, st>>>(
        static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
        static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o), kv_len, Sq, Skv,
        N, qscale);
  } else {
    dim3 grid((Sq + FBQ - 1) / FBQ, N, B);
    fa_fwd_f32<false><<<grid, 128, 0, st>>>(
        static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
        static_cast<float*>(o), kv_len, Sq, Skv, N, qscale, 0, 0.f);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
