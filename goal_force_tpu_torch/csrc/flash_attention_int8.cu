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
// looked up per row and the k scale per key column, never per CTA.
//
// Bound on the H100: at the main-path shapes (32,760 queries against 32,760 or 512 keys,
// 40 heads, batch 2) the kernel does 2*Sq*Skv*128 int8 operations plus as many bf16 FLOP
// per (batch, head) on ~Sq*128*3 bytes of q codes, v and o, so it is bound by tensor-core
// operations: 11.1 ms of int8 at 1979 TOP/s plus 22.2 ms of bf16 at 989 TFLOP/s for the
// self shape. The bf16-V kernel runs on the Hopper skeleton of csrc/flash_attention_sm90.cuh
// (TMA loads into an mbarrier ring fed by a producer warp, two consumer warpgroups of 64
// query rows, PV by wgmma with P from registers). K6's part is the policy below: Q and K
// tiles of 128 int8 codes per row, one 128-byte box each, and QK^T as wgmma
// m64n128k32.s32.s8.s8 (8-bit wgmma takes only K-major operands, which packed q and k
// rows are); the producer warp writes each key tile's 128 k scales into a table beside
// the tile in the ring; the consumers dequantize per (row, key column) and run the
// online softmax with expf. The float32-V kernel is plain dp4a/FMA loops; it exists for
// exact checks, not for the main path.
//
// C interface (loaded with ctypes): the entry point returns cudaGetLastError() after its
// launch (or the error that refused it), so a refused launch reaches the caller.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "flash_attention_sm90.cuh"

namespace {

constexpr int HD = 128;            // head dim (bytes of an int8 row)
using sm90::MASK_VALUE;

// The softmax's exponential: the natural exp, as the TPU kernel takes it.
__device__ __forceinline__ float softmax_exp(float x) { return expf(x); }

// The k scale of each key of tile j (one per key column); keys past Skv get the last
// tile's scale, and are masked anyway.
__device__ __forceinline__ void load_key_scales(float* kc, const float* skb, int key0, int bk,
                                                int Tk, int n) {
  const int i = threadIdx.x;
  if (i < n) kc[i] = skb[min((key0 + i) / bk, Tk - 1)];
}

// K6 on the Hopper skeleton: int8 q and k codes, bf16 v and o.
struct K6Policy {
  using Acc = int;
  static constexpr uint32_t kQBytes = sm90::BQ * HD;       // 128 rows x 128 codes
  static constexpr uint32_t kKBytes = sm90::BK * HD;
  static constexpr uint32_t kExtraBytes = sm90::BK * 4;    // the key tile's k scales
  static constexpr int kQRowBytes = HD, kKRowBytes = HD;

  __device__ static int kv_valid(const sm90::Args& a, int) { return a.Skv; }
  __device__ static void load_q(uint32_t dst, const CUtensorMap* m, uint32_t bar, int row0, int h,
                                int b) {
    sm90::tma_load_4d(dst, m, bar, 0, h, row0, b);
  }
  __device__ static void load_k(uint32_t dst, const CUtensorMap* m, uint32_t bar, int row0, int h,
                                int b) {
    sm90::tma_load_4d(dst, m, bar, 0, h, row0, b);
  }
  // The producer warp's 32 lanes write the k scale of each of the tile's 128 keys.
  __device__ static void produce_extra(const sm90::Args& a, unsigned char* table, int key0, int b,
                                       int h, int lane) {
    float* kc = reinterpret_cast<float*>(table);
    const float* skb = a.sk + ((long long)b * a.N + h) * a.Tk;
#pragma unroll
    for (int i = lane; i < sm90::BK; i += 32) kc[i] = skb[min((key0 + i) / a.bk, a.Tk - 1)];
  }
  __device__ static void prepare_q(const sm90::Args&, unsigned char*, int, int) {}

  // Issues S = Q K^T in int32 for this warpgroup's 64 rows x 128 keys: 4 k-steps of 32
  // codes.
  __device__ static void qk_issue(int* sc, uint32_t sQ, uint32_t sK, int cw) {
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      sm90::wgmma_ss_s8(sc, sm90::kmajor_desc(sQ + cw * 64 * HD + kk * 32),
                        sm90::kmajor_desc(sK + kk * 32), kk > 0);
  }

  struct State {
    float l0, l1, m0, m1;   // partial row sums and running maxima (rows r0, r0 + 8)
    float qs0, qs1;         // scale * s_q of the two rows: a q tile boundary (a multiple of
                            // bq) can fall between them

    __device__ void init(const sm90::Args& a, int b, int h, int r0) {
      const float* sqb = a.sq + ((long long)b * a.N + h) * a.Tq;
      qs0 = a.scale * sqb[min(r0 / a.bq, a.Tq - 1)];
      qs1 = a.scale * sqb[min((r0 + 8) / a.bq, a.Tq - 1)];
      l0 = l1 = 0.f;
      m0 = m1 = -INFINITY;
    }

    // Dequantize per (row, key column), mask keys >= Skv, online max with expf; rescale
    // acc (no PV product is in flight here) and pack bf16(P) for the PV wgmma.
    __device__ void softmax(int* sc, uint32_t* pf, float* acc, const sm90::Args&, int kbase,
                            int valid, const float* kc, int t) {
      const bool straddles = kbase + sm90::BK > valid;
      float s[64];
      float mx0 = MASK_VALUE, mx1 = MASK_VALUE;
#pragma unroll
      for (int n = 0; n < 16; ++n) {
        const float2 ks = *reinterpret_cast<const float2*>(kc + n * 8 + 2 * t);
#pragma unroll
        for (int e = 0; e < 4; ++e)
          s[4 * n + e] = static_cast<float>(sc[4 * n + e]) *
                         ((e < 2 ? qs0 : qs1) * ((e & 1) ? ks.y : ks.x));
      }
      if (straddles) {   // only the tile that straddles Skv pays for the mask
#pragma unroll
        for (int n = 0; n < 16; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            if (kbase + n * 8 + 2 * t + (e & 1) >= valid) s[4 * n + e] = MASK_VALUE;
      }
#pragma unroll
      for (int n = 0; n < 16; ++n) {
        mx0 = fmaxf(mx0, fmaxf(s[4 * n], s[4 * n + 1]));
        mx1 = fmaxf(mx1, fmaxf(s[4 * n + 2], s[4 * n + 3]));
      }
      mx0 = sm90::quad_max(mx0);
      mx1 = sm90::quad_max(mx1);
      const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
      const float a0 = softmax_exp(m0 - mn0), a1 = softmax_exp(m1 - mn1);
      m0 = mn0;
      m1 = mn1;
      float ps0 = 0.f, ps1 = 0.f;
#pragma unroll
      for (int n = 0; n < 16; ++n) {
        s[4 * n] = softmax_exp(s[4 * n] - mn0);
        s[4 * n + 1] = softmax_exp(s[4 * n + 1] - mn0);
        s[4 * n + 2] = softmax_exp(s[4 * n + 2] - mn1);
        s[4 * n + 3] = softmax_exp(s[4 * n + 3] - mn1);
        ps0 += s[4 * n] + s[4 * n + 1];
        ps1 += s[4 * n + 2] + s[4 * n + 3];
      }
      l0 = a0 * l0 + ps0;
      l1 = a1 * l1 + ps1;
      if (__any_sync(0xffffffff, a0 != 1.f || a1 != 1.f)) {   // else acc * 1 == acc
#pragma unroll
        for (int n = 0; n < 16; ++n) {
          acc[4 * n] *= a0;
          acc[4 * n + 1] *= a0;
          acc[4 * n + 2] *= a1;
          acc[4 * n + 3] *= a1;
        }
      }
#pragma unroll
      for (int kk = 0; kk < 8; ++kk) {
        pf[4 * kk + 0] = sm90::pack_bf16(s[8 * kk + 0], s[8 * kk + 1]);
        pf[4 * kk + 1] = sm90::pack_bf16(s[8 * kk + 2], s[8 * kk + 3]);
        pf[4 * kk + 2] = sm90::pack_bf16(s[8 * kk + 4], s[8 * kk + 5]);
        pf[4 * kk + 3] = sm90::pack_bf16(s[8 * kk + 6], s[8 * kk + 7]);
      }
    }
    __device__ void inv_l(float& inv0, float& inv1) {
      const float s0 = sm90::quad_sum(l0), s1 = sm90::quad_sum(l1);
      inv0 = s0 == 0.f ? 1.f : 1.f / s0;
      inv1 = s1 == 0.f ? 1.f : 1.f / s1;
    }
    __device__ void epilogue(const sm90::Args&, int, int, int, int) {}
  };
};

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
// bq rows, sk: float32 (B, N, Tk) scales of k's tiles of bk rows; all on the device. bf16
// takes the geometry array of ops/flash_attention.py::sm90_geometry (host memory, int64);
// f32 ignores it.
int gf_fa_int8(int is_bf16, const void* q, const void* k, const void* v, void* o, const void* sq,
               const void* sk, int B, int Sq, int Skv, int N, int Tq, int Tk, int bq, int bk,
               float scale, const long long* geom, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* sqf = static_cast<const float*>(sq);
  const float* skf = static_cast<const float*>(sk);
  if (is_bf16) {
    sm90::Args a{};
    a.o = o;
    a.sq = sqf;
    a.sk = skf;
    a.Sq = Sq;
    a.Skv = Skv;
    a.N = N;
    a.Tq = Tq;
    a.Tk = Tk;
    a.bq = bq;
    a.bk = bk;
    a.scale = scale;
    return sm90::launch<K6Policy>(CU_TENSOR_MAP_DATA_TYPE_UINT8, q, k, v, a, B, geom, st);
  }
  dim3 grid((Sq + FBQ - 1) / FBQ, N, B);
  fa_int8_f32<<<grid, 128, 0, st>>>(static_cast<const int8_t*>(q), static_cast<const int8_t*>(k),
                                    static_cast<const float*>(v), static_cast<float*>(o), sqf, skf,
                                    Sq, Skv, N, Tq, Tk, bq, bk, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
