// K6: int8-QK flash attention for Hopper (sm_90a), non-causal, head_dim 128.
//
// Replaces the TPU kernel goal_force_tpu/ops/flash_attention.py::_fa_kernel_int8 (reached
// from flash_attention_int8). q and k arrive as int8 codes, quantized outside the kernel
// (ops/flash_attention.py::quantize_tiles) with one float32 scale per (batch, head, tile
// of bq query rows) and per (batch, head, tile of bk keys). The kernel computes
//   s = float(q_i8 . k_i8) * ((scale * sq[row / bq]) * sk[col / bk])   (JAX's association;
//       the int32 sum is exact in float32, |sum| <= 127^2 * 128 < 2^24),
//   keys >= Skv masked with MASK_VALUE, online max with the natural exp (no log2(e) fold,
//   unlike K1/K2), p rounded to V's dtype, acc += p.V with float32 sums,
//   o = acc * (1 / l), with 1 where l == 0.
// The quantization tiles are part of the function, not this kernel's tiles: bq and bk are
// arguments (1024 and 1024 or 512 on the main path, 300 in the tests), so the q scale is
// looked up per row and the k scale per key column (a 64-entry table per key tile in
// shared memory), never per CTA.
//
// Bound on the H100: at the main-path shapes (32,760 queries against 32,760 or 512 keys,
// 40 heads, batch 2) the kernel does 2*Sq*Skv*128 int8 operations plus as many bf16 FLOP
// per (batch, head) on ~Sq*128*3 bytes of q codes, v and o, so it is bound by tensor-core
// operations: 11.1 ms of int8 at 1979 TOP/s plus 22.2 ms of bf16 at 989 TFLOP/s for the
// self shape. The design is K2's (csrc/flash_attention.cu): 4 warps, 16 query rows each,
// 64-key tiles double-buffered in shared memory with cp.async, the online max in
// registers. QK^T runs as mma.sync m16n8k32 s8.s8 -> s32: Q and K are both lane-major, so
// ldmatrix of their 16-bit view yields the int8 A and B fragments with no transpose (a
// 16x32 int8 fragment has the byte layout of a 16x16 bf16 one), and the s32 accumulator
// has the row/column layout of the f32 m16n8k16 one. PV runs as bf16 m16n8k16. wgmma, TMA
// and warp specialisation are later work. The float32-V kernel is plain dp4a/FMA loops; it
// exists for exact checks, not for the main path.
//
// C interface (loaded with ctypes): the entry point returns cudaGetLastError() after its
// launch, so a refused launch reaches the caller.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int HD = 128;            // head dim (bytes of an int8 row)
constexpr int BQ = 64;             // query rows per CTA (bf16 kernel)
constexpr int BK = 64;             // keys per tile (bf16 kernel)
constexpr int LDQ = HD / 2 + 8;    // int8 smem row in 16-bit units: 128 bytes + 16 of padding
constexpr int LDV = HD + 8;        // bf16 smem row: conflict-free ldmatrix
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
// c += a (16x32, row) * b (32x8, col), int8 in, int32 accumulate.
__device__ __forceinline__ void mma_s8(int* c, const uint32_t* a, uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
// c += a (16x16, row) * b (16x8, col), bf16 in, f32 accumulate.
__device__ __forceinline__ void mma_bf16(float* c, const uint32_t* a, uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
// The softmax's exponential: the natural exp, as the TPU kernel takes it.
__device__ __forceinline__ float softmax_exp(float x) { return expf(x); }

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// 64 rows of 128 int8 codes from global row `row0` (row stride `gstride` bytes) into smem
// (row stride LDQ 16-bit units); rows >= `valid` are zero-filled.
__device__ __forceinline__ void load_i8_tile(uint16_t* sm, const int8_t* g, int row0, int valid,
                                             long long gstride) {
  // 64 rows x 8 chunks of 16 bytes = 512 chunks over 128 threads.
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    int c = threadIdx.x + i * 128;
    int r = c >> 3, col = (c & 7) * 16;
    bool ok = row0 + r < valid;
    const int8_t* src = ok ? g + (long long)(row0 + r) * gstride + col : g;
    cp_async16(reinterpret_cast<char*>(sm + r * LDQ) + col, src, ok);
  }
}

// 64 rows of 128 bf16 (row stride `gstride` elements) into smem (row stride LDV).
__device__ __forceinline__ void load_bf16_tile(__nv_bfloat16* sm, const __nv_bfloat16* g, int row0,
                                               int valid, long long gstride) {
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    int c = threadIdx.x + i * 128;
    int r = c >> 4, col = (c & 15) * 8;
    bool ok = row0 + r < valid;
    const __nv_bfloat16* src = ok ? g + (long long)(row0 + r) * gstride + col : g;
    cp_async16(sm + r * LDV + col, src, ok);
  }
}

// The k scale of each key of tile j (one per key column); keys past Skv get the last
// tile's scale, and are masked anyway.
__device__ __forceinline__ void load_key_scales(float* kc, const float* skb, int key0, int bk,
                                                int Tk, int n) {
  const int i = threadIdx.x;
  if (i < n) kc[i] = skb[min((key0 + i) / bk, Tk - 1)];
}

__global__ void __launch_bounds__(128, 2)
fa_int8_bf16(const int8_t* __restrict__ q, const int8_t* __restrict__ k,
             const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ o,
             const float* __restrict__ sq, const float* __restrict__ sk, int Sq, int Skv, int N,
             int Tq, int Tk, int bq, int bk, float scale) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  uint16_t* Qs = reinterpret_cast<uint16_t*>(smem_raw);                        // BQ x LDQ
  uint16_t* Ks = Qs + BQ * LDQ;                                                 // 2 stages
  __nv_bfloat16* Vs = reinterpret_cast<__nv_bfloat16*>(Ks + 2 * BK * LDQ);      // 2 stages
  float* Kc = reinterpret_cast<float*>(Vs + 2 * BK * LDV);                      // 2 x BK

  const int qt = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const long long rs = (long long)N * HD;   // row stride of the packed layout
  const int8_t* qb = q + ((long long)b * Sq * N + h) * HD;
  const int8_t* kb = k + ((long long)b * Skv * N + h) * HD;
  const __nv_bfloat16* vb = v + ((long long)b * Skv * N + h) * HD;
  const float* sqb = sq + ((long long)b * N + h) * Tq;
  const float* skb = sk + ((long long)b * N + h) * Tk;
  const int n_tiles = (Skv + BK - 1) / BK;
  const int q0 = qt * BQ;
  const int r0 = q0 + warp * 16 + g, r1 = r0 + 8;
  // scale * s_q for this thread's two rows: a tile boundary (a multiple of bq) can fall
  // between rows g and g+8 of one fragment.
  const float qs0 = scale * sqb[min(r0 / bq, Tq - 1)];
  const float qs1 = scale * sqb[min(r1 / bq, Tq - 1)];

  load_i8_tile(Qs, qb, q0, Sq, rs);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
  uint32_t qa[4][4];   // A fragments of the 4 k-steps of 32 lanes
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    int row = warp * 16 + (lane & 7) + ((lane >> 3) & 1) * 8;
    int col = kk * 16 + (lane >> 4) * 8;
    ldmatrix_x4(qa[kk], Qs + row * LDQ + col);
  }

  float acc[16][4];
#pragma unroll
  for (int n = 0; n < 16; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
  float l0 = 0.f, l1 = 0.f;                 // partial row sums (rows g, g+8)
  float m0 = -INFINITY, m1 = -INFINITY;     // running row max

  if (n_tiles > 0) {
    load_i8_tile(Ks, kb, 0, Skv, rs);
    load_bf16_tile(Vs, vb, 0, Skv, rs);
    load_key_scales(Kc, skb, 0, bk, Tk, BK);
  }
  cp_async_commit();

  for (int j = 0; j < n_tiles; ++j) {
    const int stage = j & 1;
    if (j + 1 < n_tiles) {
      load_i8_tile(Ks + (stage ^ 1) * BK * LDQ, kb, (j + 1) * BK, Skv, rs);
      load_bf16_tile(Vs + (stage ^ 1) * BK * LDV, vb, (j + 1) * BK, Skv, rs);
      load_key_scales(Kc + (stage ^ 1) * BK, skb, (j + 1) * BK, bk, Tk, BK);
    }
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const uint16_t* Kt = Ks + stage * BK * LDQ;
    const __nv_bfloat16* Vt = Vs + stage * BK * LDV;
    const float* kc = Kc + stage * BK;

    // S = Q K^T in int32 for this warp's 16 rows x 64 keys (8 n-tiles of 8 keys).
    int si[8][4];
#pragma unroll
    for (int n = 0; n < 8; ++n) si[n][0] = si[n][1] = si[n][2] = si[n][3] = 0;
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
      for (int np = 0; np < 4; ++np) {
        uint32_t bk4[4];
        int key = np * 16 + (lane & 7) + (lane >> 4) * 8;
        int col = kk * 16 + ((lane >> 3) & 1) * 8;
        ldmatrix_x4(bk4, Kt + key * LDQ + col);
        mma_s8(si[2 * np], qa[kk], bk4[0], bk4[1]);
        mma_s8(si[2 * np + 1], qa[kk], bk4[2], bk4[3]);
      }
    }

    // Dequantize per (row, key column), mask keys >= Skv, online max.
    const int kbase = j * BK;
    const bool straddles = kbase + BK > Skv;
    float s[8][4];
    float mx0 = MASK_VALUE, mx1 = MASK_VALUE;
#pragma unroll
    for (int n = 0; n < 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int cl = n * 8 + 2 * t + (e & 1);
        float x = static_cast<float>(si[n][e]) * ((e < 2 ? qs0 : qs1) * kc[cl]);
        if (straddles && kbase + cl >= Skv) x = MASK_VALUE;
        s[n][e] = x;
      }
      mx0 = fmaxf(mx0, fmaxf(s[n][0], s[n][1]));
      mx1 = fmaxf(mx1, fmaxf(s[n][2], s[n][3]));
    }
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffff, mx0, 1));
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffff, mx0, 2));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffff, mx1, 1));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffff, mx1, 2));
    const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
    const float a0 = softmax_exp(m0 - mn0), a1 = softmax_exp(m1 - mn1);
    m0 = mn0;
    m1 = mn1;
    float ps0 = 0.f, ps1 = 0.f;
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      s[n][0] = softmax_exp(s[n][0] - mn0);
      s[n][1] = softmax_exp(s[n][1] - mn0);
      s[n][2] = softmax_exp(s[n][2] - mn1);
      s[n][3] = softmax_exp(s[n][3] - mn1);
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

    // acc += bf16(P) V: P's accumulator layout is the A-fragment layout of the PV mma.
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      uint32_t pa[4];
      pa[0] = pack_bf16(s[2 * kk][0], s[2 * kk][1]);
      pa[1] = pack_bf16(s[2 * kk][2], s[2 * kk][3]);
      pa[2] = pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]);
      pa[3] = pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3]);
#pragma unroll
      for (int dp = 0; dp < 8; ++dp) {
        uint32_t bv4[4];
        int key = kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8;
        int col = dp * 16 + (lane >> 4) * 8;
        ldmatrix_x4_trans(bv4, Vt + key * LDV + col);
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

// float32-V kernel: 128 threads own 32 query rows, 4 lanes per row. For QK^T lane c of a
// row owns the code words c, c+4, ..., c+28 (4 lanes each), summed with dp4a; for PV it
// owns dims c, c+4, ..., c+124.
constexpr int FBQ = 32;
constexpr int FBK = 32;

__global__ void __launch_bounds__(128)
fa_int8_f32(const int8_t* __restrict__ q, const int8_t* __restrict__ k,
            const float* __restrict__ v, float* __restrict__ o, const float* __restrict__ sq,
            const float* __restrict__ sk, int Sq, int Skv, int N, int Tq, int Tk, int bq, int bk,
            float scale) {
  __shared__ int Ks[FBK][HD / 4];
  __shared__ float Vs[FBK][HD];
  __shared__ float Kc[FBK];
  const int qt = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, row = tid >> 2, c = tid & 3;
  const long long rs = (long long)N * HD;
  const int qi = qt * FBQ + row;
  const int8_t* kb = k + ((long long)b * Skv * N + h) * HD;
  const float* vb = v + ((long long)b * Skv * N + h) * HD;
  const float* skb = sk + ((long long)b * N + h) * Tk;
  const float qs = scale * sq[((long long)b * N + h) * Tq + min(qi / bq, Tq - 1)];

  int qw[8];
  const int* qrow = reinterpret_cast<const int*>(q + ((long long)b * Sq + qi) * rs + h * HD);
#pragma unroll
  for (int i = 0; i < 8; ++i) qw[i] = qi < Sq ? qrow[i * 4 + c] : 0;
  float acc[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) acc[i] = 0.f;
  float l = 0.f, m = -INFINITY;
  const int n_tiles = (Skv + FBK - 1) / FBK;
  for (int j = 0; j < n_tiles; ++j) {
    __syncthreads();
    for (int e = tid; e < FBK * HD / 4; e += 128) {
      int r = e / (HD / 4), w = e % (HD / 4), key = j * FBK + r;
      Ks[r][w] = key < Skv ? reinterpret_cast<const int*>(kb + key * rs)[w] : 0;
    }
    for (int e = tid; e < FBK * HD; e += 128) {
      int r = e / HD, col = e % HD, key = j * FBK + r;
      Vs[r][col] = key < Skv ? vb[key * rs + col] : 0.f;
    }
    load_key_scales(Kc, skb, j * FBK, bk, Tk, FBK);
    __syncthreads();
    const int kbase = j * FBK;
    float s[FBK];
    float mx = MASK_VALUE;
#pragma unroll
    for (int r = 0; r < FBK; ++r) {
      int d = 0;
#pragma unroll
      for (int i = 0; i < 8; ++i) d = __dp4a(qw[i], Ks[r][i * 4 + c], d);
      d += __shfl_xor_sync(0xffffffff, d, 1);
      d += __shfl_xor_sync(0xffffffff, d, 2);
      float x = static_cast<float>(d) * (qs * Kc[r]);
      if (kbase + r >= Skv) x = MASK_VALUE;
      s[r] = x;
      mx = fmaxf(mx, x);
    }
    const float mn = fmaxf(m, mx), alpha = softmax_exp(m - mn);
    m = mn;
    float ps = 0.f;
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[i] *= alpha;
#pragma unroll
    for (int r = 0; r < FBK; ++r) {
      float p = softmax_exp(s[r] - mn);
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
  }
}

}  // namespace

extern "C" {

// K6. q/k: int8 codes (B, Sq|Skv, N, 128), contiguous, 16-byte aligned; v/o: (B, Skv|Sq,
// N, 128), all bf16 (is_bf16=1) or all f32; sq: float32 (B, N, Tq) scales of q's tiles of
// bq rows, sk: float32 (B, N, Tk) scales of k's tiles of bk rows; all on the device.
int gf_fa_int8(int is_bf16, const void* q, const void* k, const void* v, void* o, const void* sq,
               const void* sk, int B, int Sq, int Skv, int N, int Tq, int Tk, int bq, int bk,
               float scale, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int8_t* qi = static_cast<const int8_t*>(q);
  const int8_t* ki = static_cast<const int8_t*>(k);
  const float* sqf = static_cast<const float*>(sq);
  const float* skf = static_cast<const float*>(sk);
  if (is_bf16) {
    const int smem = (BQ + 2 * BK) * LDQ * 2 + 2 * BK * LDV * 2 + 2 * BK * 4;
    cudaFuncSetAttribute(fa_int8_bf16, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    dim3 grid((Sq + BQ - 1) / BQ, N, B);
    fa_int8_bf16<<<grid, 128, smem, st>>>(qi, ki, static_cast<const __nv_bfloat16*>(v),
                                          static_cast<__nv_bfloat16*>(o), sqf, skf, Sq, Skv, N,
                                          Tq, Tk, bq, bk, scale);
  } else {
    dim3 grid((Sq + FBQ - 1) / FBQ, N, B);
    fa_int8_f32<<<grid, 128, 0, st>>>(qi, ki, static_cast<const float*>(v),
                                      static_cast<float*>(o), sqf, skf, Sq, Skv, N, Tq, Tk, bq,
                                      bk, scale);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
