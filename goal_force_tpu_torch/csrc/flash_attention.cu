// Flash-attention forward kernels for Hopper (sm_90a), non-causal, head_dim 128.
//
// K1 `gf_fa_nomax` replaces the TPU kernel goal_force_tpu/ops/flash_attention.py::
//    _fa_kernel_nomax: max-free softmax in the log2 domain, p = exp2(min(s, clamp)),
//    l += sum(p), acc += p.V, o = acc / l.
// K2 `gf_fa_max` replaces goal_force_tpu/ops/flash_attention.py::_fa_kernel: the same
//    with a running row max m, p = exp2(s - m) and alpha = exp2(m_prev - m_next)
//    rescaling l and acc.
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
// keys) each kernel does 4*Sq*Skv*128 flops per (batch, head) on ~Sq*128*2 bytes of
// q and o, so it is bound by tensor-core operations, not by memory (44.4 ms for the
// serving self shape at 989 TFLOP/s). Only wgmma reaches that rate, so the bf16 K1 and
// K2 run on the Hopper skeleton of csrc/flash_attention_sm90.cuh: TMA loads of 128-key K
// and V tiles into an mbarrier ring fed by a producer warp, two consumer warpgroups of
// 64 query rows that run QK^T (wgmma m64n128k16, Q and K in shared memory) and PV
// (P from registers, V MN-major) with the softmax between them, the two warpgroups
// taking turns at it so that one's exponentials overlap the other's products. The
// policies below add the q fold in shared memory before the first product and the
// softmax: K1's max-free exponent with the straddle mask, K2's online max
// (sm90::OnlineMax with exp2f, the log2 domain's exponential), whose running max and
// acc rescale add an FMNMX per logit and 64 FMUL per tile where the max moved.
// The f32 kernels are plain FMA loops; they exist for exact checks, not for the main
// path.
//
// C interface (loaded with ctypes): every entry point returns cudaGetLastError() after
// its launch (or the error that refused it), so a refused launch reaches the caller.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "flash_attention_sm90.cuh"

namespace {

constexpr int HD = 128;            // head dim
using sm90::MASK_VALUE;

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
struct K1Policy : sm90::Bf16QK {
  __device__ static int kv_valid(const sm90::Args& a, int b) {
    const int l = a.kv_len[b];
    return l < 0 ? 0 : (l > a.Skv ? a.Skv : l);
  }

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
    __device__ void epilogue(const sm90::Args&, int, int, int, int) {}
  };
};

// exp2f: K2's logits are in the log2 domain already (q carries scale*log2 e).
struct Log2Domain {
  __device__ static float log2_factor(const sm90::Args&) { return 1.f; }
  __device__ static float exp2(float x) { return exp2f(x); }
};

// K2 on the Hopper skeleton: K1's tiles, loads, kv_len and q fold, with the online max.
struct K2Policy : K1Policy {
  using State = sm90::OnlineMax<Log2Domain>;
};

// The Args of K1 and K2.
sm90::Args fwd_args(void* o, const int* kv_len, int Sq, int Skv, int N, float qscale) {
  sm90::Args a{};
  a.o = o;
  a.kv_len = kv_len;
  a.Sq = Sq;
  a.Skv = Skv;
  a.N = N;
  a.qscale = qscale;
  return a;
}

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
    sm90::Args a = fwd_args(o, kv_len, Sq, Skv, N, qscale);
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

// K2: online-max flash attention, the same arguments without the clamp.
int gf_fa_max(int is_bf16, const void* q, const void* k, const void* v, void* o,
              const int* kv_len, int B, int Sq, int Skv, int N, float qscale,
              const long long* geom, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return sm90::launch<K2Policy>(CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, q, k, v,
                                  fwd_args(o, kv_len, Sq, Skv, N, qscale), B, geom, st);
  dim3 grid((Sq + FBQ - 1) / FBQ, N, B);
  fa_fwd_f32<false><<<grid, 128, 0, st>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<float*>(o), kv_len, Sq, Skv, N, qscale, 0, 0.f);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
