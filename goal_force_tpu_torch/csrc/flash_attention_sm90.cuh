// The Hopper (sm_90a) forward skeleton shared by K1 and K2 (csrc/flash_attention.cu), K3
// (csrc/flash_attention_bwd.cu) and K6 (csrc/flash_attention_int8.cu): non-causal flash
// attention over the packed (B, S, N, 128) layout, one CTA per (128 query rows, head,
// batch).
//
// Roles. Warpgroup 0 is the producer: after `setmaxnreg.dec` to 24 registers, its first
// warp loads Q once and then walks the key tiles, issuing TMA copies
// (`cp.async.bulk.tensor.4d`) of each 128-key K and V tile into a ring of STAGES shared
// memory slots; each slot has a "K full", a "V full" and an "empty" mbarrier. Warpgroups 1
// and 2 are the consumers (`setmaxnreg.inc` to 240 registers), 64 query rows each: per
// key tile, S = Q K^T by `wgmma` with both operands in shared memory, the policy's
// softmax on S in registers, then O += P V by `wgmma` with P from registers (the m64nN
// accumulator layout of S is the A-fragment layout of the next wgmma, so P is packed in
// place) and V from shared memory, MN-major (the transpose bit 16-bit types allow). After
// the PV product a consumer warp arrives on the slot's "empty" barrier, which lets the
// producer refill it. 128 + 2 x 128 threads at 24 / 240 registers fill the register file.
// The two consumer warpgroups take turns at the softmax (named barriers 3 and 4, FA3's
// ping-pong), so one warpgroup's exponentials run while the other's products are on the
// tensor cores.
//
// Layouts. The tensor maps (encoded on the host, passed as __grid_constant__ parameters)
// are rank 4 over (128, N, S, B) with the packed layout's byte strides, so TMA zero-fills
// and clips at each batch's own end: a ragged last q or key tile never reads the next
// batch. Every box is at most 128 bytes wide and lands with the 128-byte swizzle: bf16
// rows (256 bytes) as two boxes of 64 columns (two "halves", each 128 rows x 128 bytes),
// int8 rows (128 bytes) as one. The wgmma descriptors follow that layout: K-major
// operands advance 32 bytes per k-step inside a half (stride between 8-row groups 1024
// bytes); V, MN-major, has its two 64-column halves 16 KB apart (leading byte offset) and
// its 8-key groups 1024 bytes apart (stride byte offset).
//
// Zero-filled keys past Skv load as zeros, so their logits are 0, not -inf: the policy
// masks the tile that straddles the end of the valid keys. The number of key tiles is
// computed once, before the roles split, so producer and consumers agree on it (a
// disagreement would leave a barrier phase that never completes). A wait that has not
// completed after ~2^34 cycles traps, so a lost phase is a launch error, not a hang.
//
// The host side only encodes the maps and launches: the tile sizes, grid, map dims,
// strides and boxes, and the shared-memory budget come from the Python wrapper
// (ops/flash_attention.py::sm90_geometry), and are checked here against this file's
// constants. cuTensorMapEncodeTiled comes from libcuda, linked with -lcuda.
//
// A policy P supplies: Acc (the QK^T accumulator type), kQBytes / kKBytes (one Q tile, one
// K tile), kQRowBytes / kKRowBytes (one q or k row), kExtraBytes (per-slot table the
// producer fills, e.g. K6's key scales), kv_valid(args, b), load_q / load_k (TMA issue),
// produce_extra(...), prepare_q(...), qk_issue(...), and a State with init / softmax /
// inv_l / epilogue (after o's normalisation, with the thread's rows r0 and r0 + 8; K3
// writes the logsumexp there). The bf16 policies (K1, K2, K3) take their Q and K tiles,
// loads and QK^T from Bf16QK below, and K2 and K3 their softmax from OnlineMax.
//
// The m64n64 wrappers and fence_regs32 below serve the training backward's roles
// (flash_attention_bwd_sm90.cuh), which reuse this file's PTX wrappers and nothing else.

#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace sm90 {

constexpr int HD = 128;          // head dim
constexpr int BQ = 128;          // query rows per CTA (two consumer warpgroups of 64)
constexpr int BK = 128;          // keys per tile
constexpr int STAGES = 2;        // K/V ring slots
constexpr int THREADS = 384;     // producer warpgroup + two consumer warpgroups
constexpr int HALF_BYTES = 128 * 128;          // one bf16 half tile: 128 rows x 128 bytes
constexpr uint32_t V_BYTES = 2 * HALF_BYTES;   // one V tile (128 keys x 128 bf16)
constexpr long long SMEM_LIMIT = 232448;
constexpr float MASK_VALUE = -0.7f * 3.4028234663852886e38f;   // JAX's masked logit

// ---------------------------------------------------------------------------------------
// PTX wrappers
// ---------------------------------------------------------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}
__device__ __forceinline__ void mbar_arrive_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ uint32_t mbar_try_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n .reg .pred p;\n"
      " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      " selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(done) : "r"(bar), "r"(parity) : "memory");
  return done;
}
// Waits until the barrier's phase with the given parity has completed.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  if (mbar_try_wait(bar, parity)) return;
  const long long t0 = clock64();
  while (!mbar_try_wait(bar, parity)) {
    if (clock64() - t0 > (1ll << 34)) __trap();
  }
}

// 4-d TMA load of one box at coordinates (c0, c1, c2, c3) into shared memory; completion
// is reported to `bar` as transaction bytes.
__device__ __forceinline__ void tma_load_4d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3, %4, %5}], [%6];\n"
      ::"r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2), "r"(c3),
        "r"(bar)
      : "memory");
}

__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// Keeps the compiler from moving accesses of an accumulator register across a wgmma.
__device__ __forceinline__ void fence_regs(float* r) {
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
__device__ __forceinline__ void fence_regs(int* r) {
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+r"(r[i])::"memory");
}
// The same for a 64 x 64 f32 accumulator (32 registers per thread).
__device__ __forceinline__ void fence_regs32(float* r) {
#pragma unroll
  for (int i = 0; i < 32; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

// Shared-memory matrix descriptor, 128-byte swizzle; addresses and offsets in bytes.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16) |
         (static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32) | (1ull << 62);
}
// A K-major operand: rows of 128 bytes, 8-row groups 1024 bytes apart.
__device__ __forceinline__ uint64_t kmajor_desc(uint32_t addr) { return sw128_desc(addr, 16, 1024); }
// V as the MN-major B operand of PV: the 64-column halves HALF_BYTES apart, 8-key groups
// 1024 bytes apart.
__device__ __forceinline__ uint64_t v_desc(uint32_t addr) { return sw128_desc(addr, HALF_BYTES, 1024); }

#define GF_D8(i) "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]), \
                 "+f"(d[i + 4]), "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])
#define GF_I8(i) "+r"(d[i]), "+r"(d[i + 1]), "+r"(d[i + 2]), "+r"(d[i + 3]), \
                 "+r"(d[i + 4]), "+r"(d[i + 5]), "+r"(d[i + 6]), "+r"(d[i + 7])
#define GF_REGS64                                                                          \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "                \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "       \
  "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "       \
  "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}"

// d (64x128 f32) (+)= A (64x16 bf16, smem, K-major) * B (16x128 bf16, smem, K-major).
__device__ __forceinline__ void wgmma_ss_bf16(float* d, uint64_t da, uint64_t db, int accumulate) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " GF_REGS64
      ", %64, %65, p, 1, 1, 0, 0;\n}\n"
      : GF_D8(0), GF_D8(8), GF_D8(16), GF_D8(24), GF_D8(32), GF_D8(40), GF_D8(48), GF_D8(56)
      : "l"(da), "l"(db), "r"(accumulate));
}
#define GF_REGS32                                                                          \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "                \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}"

// d (64x64 f32) += A (64x16 bf16, smem, K-major) * B (16x64 bf16, smem, K-major).
__device__ __forceinline__ void wgmma_ss_bf16_n64(float* d, uint64_t da, uint64_t db) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " GF_REGS32
      ", %32, %33, p, 1, 1, 0, 0;\n}\n"
      : GF_D8(0), GF_D8(8), GF_D8(16), GF_D8(24)
      : "l"(da), "l"(db), "r"(1));
}
// d (64x64 f32) = A * B, as above without the sum: the first k-step of a product, whose
// outputs are written and never read (so the compiler keeps no earlier value of d alive).
#define GF_W8(i) "=f"(d[i]), "=f"(d[i + 1]), "=f"(d[i + 2]), "=f"(d[i + 3]), \
                 "=f"(d[i + 4]), "=f"(d[i + 5]), "=f"(d[i + 6]), "=f"(d[i + 7])
__device__ __forceinline__ void wgmma_ss_bf16_n64_first(float* d, uint64_t da, uint64_t db) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " GF_REGS32
      ", %32, %33, p, 1, 1, 0, 0;\n}\n"
      : GF_W8(0), GF_W8(8), GF_W8(16), GF_W8(24)
      : "l"(da), "l"(db), "r"(0));
}
// d (64x128 f32) += A (64x16 bf16, registers) * B (16x128 bf16, smem, MN-major).
__device__ __forceinline__ void wgmma_rs_bf16(float* d, const uint32_t* a, uint64_t db) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " GF_REGS64
      ", {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : GF_D8(0), GF_D8(8), GF_D8(16), GF_D8(24), GF_D8(32), GF_D8(40), GF_D8(48), GF_D8(56)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}
// d (64x128 s32) (+)= A (64x32 s8, smem, K-major) * B (32x128 s8, smem, K-major).
__device__ __forceinline__ void wgmma_ss_s8(int* d, uint64_t da, uint64_t db, int accumulate) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 " GF_REGS64 ", %64, %65, p;\n}\n"
      : GF_I8(0), GF_I8(8), GF_I8(16), GF_I8(24), GF_I8(32), GF_I8(40), GF_I8(48), GF_I8(56)
      : "l"(da), "l"(db), "r"(accumulate));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// Sum over the 4 lanes that share a row of the accumulator layout.
__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffff, x, 1);
  return x + __shfl_xor_sync(0xffffffff, x, 2);
}
__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffff, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffff, x, 2));
}

// One bf16 tile of 128 rows (two 64-column boxes, HALF_BYTES apart) at row `row0`.
__device__ __forceinline__ void load_bf16_tile(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                               int row0, int h, int b) {
  tma_load_4d(dst, map, bar, 0, h, row0, b);
  tma_load_4d(dst + HALF_BYTES, map, bar, 64, h, row0, b);
}

// ---------------------------------------------------------------------------------------
// The kernel
// ---------------------------------------------------------------------------------------

struct Args {
  void* o;                  // (B, Sq, N, 128) bf16
  const int* kv_len;        // K1, K2: (B,) valid keys per batch row
  const float* sq;          // K6: (B, N, Tq) q tile scales
  const float* sk;          // K6: (B, N, Tk) k tile scales
  float* lse;               // K3: (B, N, Sq) f32 logsumexp
  int Sq, Skv, N, Tq, Tk, bq, bk;
  float qscale;             // K1, K2: scale*log2(e) in q's dtype; K3: in f32
  int use_clamp;            // K1
  float clamp;              // K1
  float scale;              // K3, K6
};

// Dynamic shared memory of one CTA: 1024 bytes of alignment slack, Q, STAGES x (K, V, the
// policy's table), and the 1 + 3 x STAGES mbarriers.
template <class P>
constexpr long long smem_bytes() {
  return 1024 + P::kQBytes + STAGES * (P::kKBytes + V_BYTES + P::kExtraBytes) + 8 * (1 + 3 * STAGES);
}

// Shared-memory addresses of one CTA's Q tile, K/V ring, per-slot tables and barriers.
struct Ring {
  uint32_t sQ, sK, sV, sBar;
  unsigned char* x;              // the per-slot tables, generic address
  __device__ uint32_t q_full() const { return sBar; }
  __device__ uint32_t k_full(int s) const { return sBar + 8u * (1 + s); }
  __device__ uint32_t v_full(int s) const { return sBar + 8u * (1 + STAGES + s); }
  __device__ uint32_t empty(int s) const { return sBar + 8u * (1 + 2 * STAGES + s); }
};

// acc += bf16(P) V for one tile, issued (not waited for): 8 k-steps of 16 keys; P's
// fragment for keys 16kk.. is the accumulator layout of S's columns 16kk..16kk+15.
__device__ __forceinline__ void pv_issue(float* acc, const uint32_t* pf, uint32_t sv) {
  fence_regs(acc);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < 8; ++kk) wgmma_rs_bf16(acc, pf + 4 * kk, v_desc(sv + kk * 2048));
  wgmma_commit();
}

// The softmax turn between the two consumer warpgroups (named barriers 3 and 4, 256
// threads: the 128 that wait and the 128 of the other warpgroup that arrive).
__device__ __forceinline__ void named_sync(int id) {
  asm volatile("bar.sync %0, 256;\n" ::"r"(id) : "memory");
}
__device__ __forceinline__ void named_arrive(int id) {
  asm volatile("bar.arrive %0, 256;\n" ::"r"(id) : "memory");
}

__device__ __forceinline__ void release(const Ring& r, int s, int lane) {
  __syncwarp();
  if (lane == 0) mbar_arrive(r.empty(s));
}

template <class P>
__global__ void __launch_bounds__(THREADS, 1)
fa_sm90_fwd(const __grid_constant__ CUtensorMap tmq, const __grid_constant__ CUtensorMap tmk,
            const __grid_constant__ CUtensorMap tmv, const Args a) {
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;          // the 128-byte swizzle's alignment
  unsigned char* gbase = smem_raw + (base - raw);        // the same bytes, generic address
  const uint32_t sQ = base;
  const uint32_t sK = sQ + P::kQBytes;
  const uint32_t sV = sK + STAGES * P::kKBytes;
  const uint32_t sX = sV + STAGES * V_BYTES;
  const uint32_t sBar = sX + STAGES * P::kExtraBytes;
  const Ring r{sQ, sK, sV, sBar, gbase + (sX - base)};

  const int qt = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x;
  const int valid = P::kv_valid(a, b);                   // keys that count, <= Skv
  const int n_tiles = (valid + BK - 1) / BK;             // read by both roles

  if (tid == 0) {
    mbar_init(r.q_full(), 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(r.k_full(s), 32);     // the producer warp's 32 lanes
      mbar_init(r.v_full(s), 1);
      mbar_init(r.empty(s), 8);       // the 8 consumer warps
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int lane = tid & 31;
  // The warpgroup index, made warp-uniform (a shuffle from lane 0) so that ptxas sees two
  // role regions and gives each the register count its setmaxnreg sets.
  const int wg = __shfl_sync(0xffffffff, tid / 128, 0);
  if (wg == 0) {
    // ---- producer warpgroup: one warp issues, the other three idle with 24 registers ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n" ::: "memory");
    if (tid < 32) {
      if (lane == 0) {
        mbar_arrive_expect_tx(r.q_full(), P::kQBytes);
        P::load_q(sQ, &tmq, r.q_full(), qt * BQ, h, b);
      }
      for (int j = 0; j < n_tiles; ++j) {
        const int s = j % STAGES;
        const uint32_t ph = (j / STAGES) & 1;
        mbar_wait(r.empty(s), ph ^ 1);
        P::produce_extra(a, r.x + s * P::kExtraBytes, j * BK, b, h, lane);
        if (lane == 0) {
          mbar_arrive_expect_tx(r.k_full(s), P::kKBytes);
          P::load_k(sK + s * P::kKBytes, &tmk, r.k_full(s), j * BK, h, b);
          mbar_arrive_expect_tx(r.v_full(s), V_BYTES);
          load_bf16_tile(sV + s * V_BYTES, &tmv, r.v_full(s), j * BK, h, b);
        } else {
          mbar_arrive(r.k_full(s));
        }
      }
    }
  } else {
    // ---- consumer warpgroups: 64 query rows each ----
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n" ::: "memory");
    const int cw = wg - 1;                        // consumer warpgroup 0 or 1
    const int wtid = tid & 127;
    const int warp = wtid >> 5, g = lane >> 2, t = lane & 3;
    const int r0 = qt * BQ + cw * 64 + warp * 16 + g;   // this thread's rows r0, r0 + 8

    mbar_wait(r.q_full(), 0);
    P::prepare_q(a, gbase, cw, wtid);
    typename P::State st;
    st.init(a, b, h, r0);
    float acc[64];
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[i] = 0.f;
    if (cw == 1 && n_tiles > 0) named_arrive(3);            // warpgroup 0 goes first

    for (int j = 0; j < n_tiles; ++j) {
      const int s = j % STAGES;
      const uint32_t ph = (j / STAGES) & 1;
      mbar_wait(r.k_full(s), ph);
      typename P::Acc sc[64];
      fence_regs(sc);
      wgmma_fence();
      P::qk_issue(sc, sQ, sK + s * P::kKBytes, cw);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(sc);
      uint32_t pf[32];
      named_sync(3 + cw);                                   // this warpgroup's softmax turn
      st.softmax(sc, pf, acc, a, j * BK, valid,
                 reinterpret_cast<const float*>(r.x + s * P::kExtraBytes), t);
      if (cw == 0 || j + 1 < n_tiles) named_arrive(4 - cw);  // the other's turn
      mbar_wait(r.v_full(s), ph);
      pv_issue(acc, pf, sV + s * V_BYTES);
      wgmma_wait<0>();
      fence_regs(acc);
      release(r, s, lane);
    }

    float inv0, inv1;
    st.inv_l(inv0, inv1);
    st.epilogue(a, b, h, r0, t);
    __nv_bfloat16* o = static_cast<__nv_bfloat16*>(a.o);
    const long long rs = (long long)a.N * HD;
#pragma unroll
    for (int n = 0; n < 16; ++n) {
      const int col = n * 8 + 2 * t;
      if (r0 < a.Sq)
        *reinterpret_cast<__nv_bfloat162*>(o + ((long long)b * a.Sq + r0) * rs + h * HD + col) =
            __floats2bfloat162_rn(acc[4 * n] * inv0, acc[4 * n + 1] * inv0);
      if (r0 + 8 < a.Sq)
        *reinterpret_cast<__nv_bfloat162*>(o + ((long long)b * a.Sq + r0 + 8) * rs + h * HD + col) =
            __floats2bfloat162_rn(acc[4 * n + 2] * inv1, acc[4 * n + 3] * inv1);
    }
  }
}

// ---------------------------------------------------------------------------------------
// Building blocks of the bf16 policies
// ---------------------------------------------------------------------------------------

// bf16 q and k (K1, K2, K3): Q and K tiles of 128 rows x 128 bf16, each loaded as two
// 64-column boxes, and QK^T by wgmma with both operands in shared memory.
struct Bf16QK {
  using Acc = float;
  static constexpr uint32_t kQBytes = 2 * HALF_BYTES;    // 128 rows x 128 bf16
  static constexpr uint32_t kKBytes = 2 * HALF_BYTES;
  static constexpr uint32_t kExtraBytes = 0;
  static constexpr int kQRowBytes = 2 * HD, kKRowBytes = 2 * HD;

  __device__ static void load_q(uint32_t dst, const CUtensorMap* m, uint32_t bar, int row0, int h,
                                int b) {
    load_bf16_tile(dst, m, bar, row0, h, b);
  }
  __device__ static void load_k(uint32_t dst, const CUtensorMap* m, uint32_t bar, int row0, int h,
                                int b) {
    load_bf16_tile(dst, m, bar, row0, h, b);
  }
  __device__ static void produce_extra(const Args&, unsigned char*, int, int, int, int) {}

  // Issues S = Q K^T for this warpgroup's 64 rows x 128 keys: 8 k-steps of 16 head dims,
  // the first four in the first 64-column half of Q and K, the last four in the second.
  __device__ static void qk_issue(float* sc, uint32_t sQ, uint32_t sK, int cw) {
#pragma unroll
    for (int kk = 0; kk < 8; ++kk) {
      const uint32_t off = (kk >> 2) * HALF_BYTES + (kk & 3) * 32;
      wgmma_ss_bf16(sc, kmajor_desc(sQ + cw * 64 * 128 + off), kmajor_desc(sK + off), kk > 0);
    }
  }
};

// The online-max softmax of K2 and K3 (JAX's _fa_kernel and _fa_kernel_fwd) on one tile of
// f32 logits s in the accumulator layout. E supplies the exponential E::exp2 and the factor
// c = E::log2_factor(args) > 0 that takes a logit to the log2 domain (K2: 1, its q carries
// scale*log2 e; K3: scale*log2 e). The running max m is kept on s as it is; c > 0, so
// fl(m*c) is the max of fl(s*c). Per tile:
//   s = MASK_VALUE for keys at or past `valid` (TMA zero-fills them: their logits load as
//       0, not -inf), only in the tile that straddles `valid`;
//   m_next = max(m, rowmax(s)), alpha = exp2((m - m_next)*c), p = exp2(fma(s, c, -m_next*c));
//   l = alpha*l + rowsum(p), acc *= alpha (no PV product is in flight here; skipped when no
//   alpha of the warp moved), and bf16(p) packed in the A-fragment order of the PV wgmma.
template <class E>
struct OnlineMax {
  float l0, l1, m0, m1;   // partial row sums and running maxima (rows r0, r0 + 8)

  __device__ void init(const Args&, int, int, int) {
    l0 = l1 = 0.f;
    m0 = m1 = -INFINITY;
  }

  __device__ void softmax(float* sc, uint32_t* pf, float* acc, const Args& a, int kbase,
                          int valid, const float*, int t) {
    if (kbase + BK > valid) {   // only the tile that straddles `valid` pays for the mask
#pragma unroll
      for (int n = 0; n < 16; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (kbase + n * 8 + 2 * t + (e & 1) >= valid) sc[4 * n + e] = MASK_VALUE;
    }
    float mx0 = MASK_VALUE, mx1 = MASK_VALUE;
#pragma unroll
    for (int n = 0; n < 16; ++n) {
      mx0 = fmaxf(mx0, fmaxf(sc[4 * n], sc[4 * n + 1]));
      mx1 = fmaxf(mx1, fmaxf(sc[4 * n + 2], sc[4 * n + 3]));
    }
    const float c = E::log2_factor(a);
    const float mn0 = fmaxf(m0, quad_max(mx0)), mn1 = fmaxf(m1, quad_max(mx1));
    const float a0 = E::exp2((m0 - mn0) * c), a1 = E::exp2((m1 - mn1) * c);
    const float b0 = -(mn0 * c), b1 = -(mn1 * c);
    m0 = mn0;
    m1 = mn1;
    float ps0 = 0.f, ps1 = 0.f;
#pragma unroll
    for (int n = 0; n < 16; ++n) {
      sc[4 * n] = E::exp2(fmaf(sc[4 * n], c, b0));
      sc[4 * n + 1] = E::exp2(fmaf(sc[4 * n + 1], c, b0));
      sc[4 * n + 2] = E::exp2(fmaf(sc[4 * n + 2], c, b1));
      sc[4 * n + 3] = E::exp2(fmaf(sc[4 * n + 3], c, b1));
      ps0 += sc[4 * n] + sc[4 * n + 1];
      ps1 += sc[4 * n + 2] + sc[4 * n + 3];
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
      pf[4 * kk + 0] = pack_bf16(sc[8 * kk + 0], sc[8 * kk + 1]);
      pf[4 * kk + 1] = pack_bf16(sc[8 * kk + 2], sc[8 * kk + 3]);
      pf[4 * kk + 2] = pack_bf16(sc[8 * kk + 4], sc[8 * kk + 5]);
      pf[4 * kk + 3] = pack_bf16(sc[8 * kk + 6], sc[8 * kk + 7]);
    }
  }
  // The row sums over the quad (kept in l0, l1 for the epilogue) and o's factors 1/l (1
  // where l == 0: a row without a valid key writes 0).
  __device__ void inv_l(float& inv0, float& inv1) {
    l0 = quad_sum(l0);
    l1 = quad_sum(l1);
    inv0 = l0 == 0.f ? 1.f : 1.f / l0;
    inv1 = l1 == 0.f ? 1.f : 1.f / l1;
  }
  __device__ void epilogue(const Args&, int, int, int, int) {}
};

// ---------------------------------------------------------------------------------------
// Host side: check the geometry, encode the maps, launch
// ---------------------------------------------------------------------------------------

// The geometry array (int64), as ops/flash_attention.py::sm90_geometry lays it out:
//   [0] bq  [1] bk  [2] stages  [3] threads  [4..6] grid x, y, z  [7] shared-memory bytes
//   then for q, k, v (11 each): dims[4] (128, N, S, B), byte strides of dims 1-3, box[4].
// Returns 0 when it matches this file's tiles and the call's shapes.
template <class P>
inline int check_geometry(const long long* g, int B, int Sq, int Skv, int N) {
  const long long qrow = P::kQRowBytes, krow = P::kKRowBytes;
  const long long want[8] = {BQ, BK, STAGES, THREADS, (Sq + BQ - 1) / BQ, N, B,
                             smem_bytes<P>()};
  for (int i = 0; i < 8; ++i)
    if (g[i] != want[i]) return 1;
  const long long rows[3] = {Sq, Skv, Skv}, rowb[3] = {qrow, krow, 2 * HD};
  const long long tile[3] = {BQ, BK, BK};
  for (int m = 0; m < 3; ++m) {
    const long long* d = g + 8 + 11 * m;
    const long long esz = rowb[m] / HD;
    const long long dims[4] = {HD, N, rows[m], B};
    const long long strides[3] = {rowb[m], rowb[m] * N, rowb[m] * N * rows[m]};
    const long long box[4] = {128 / esz, 1, tile[m], 1};
    for (int i = 0; i < 4; ++i)
      if (d[i] != dims[i] || d[7 + i] != box[i]) return 1;
    for (int i = 0; i < 3; ++i)
      if (d[4 + i] != strides[i]) return 1;
  }
  return smem_bytes<P>() <= SMEM_LIMIT ? 0 : 1;
}

inline CUresult encode_map(CUtensorMap* map, CUtensorMapDataType type, const void* ptr,
                           const long long* g) {
  const cuuint64_t dims[4] = {(cuuint64_t)g[0], (cuuint64_t)g[1], (cuuint64_t)g[2], (cuuint64_t)g[3]};
  const cuuint64_t strides[3] = {(cuuint64_t)g[4], (cuuint64_t)g[5], (cuuint64_t)g[6]};
  const cuuint32_t box[4] = {(cuuint32_t)g[7], (cuuint32_t)g[8], (cuuint32_t)g[9], (cuuint32_t)g[10]};
  const cuuint32_t estride[4] = {1, 1, 1, 1};
  return cuTensorMapEncodeTiled(map, type, 4, const_cast<void*>(ptr), dims, strides, box, estride,
                                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
}

// Encodes the three maps and launches; returns a CUDA error code (0 on success), or
// cudaErrorInvalidValue when the geometry or a map is refused.
template <class P>
inline int launch(CUtensorMapDataType qk_type, const void* q, const void* k, const void* v,
                  const Args& a, int B, const long long* g, cudaStream_t st) {
  if (g == nullptr || check_geometry<P>(g, B, a.Sq, a.Skv, a.N) != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap tq, tk, tv;
  if (encode_map(&tq, qk_type, q, g + 8) != CUDA_SUCCESS ||
      encode_map(&tk, qk_type, k, g + 19) != CUDA_SUCCESS ||
      encode_map(&tv, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, v, g + 30) != CUDA_SUCCESS)
    return static_cast<int>(cudaErrorInvalidValue);
  const int smem = static_cast<int>(g[7]);
  cudaError_t e = cudaFuncSetAttribute(fa_sm90_fwd<P>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  fa_sm90_fwd<P><<<dim3((unsigned)g[4], (unsigned)g[5], (unsigned)g[6]), (unsigned)g[3], smem, st>>>(
      tq, tk, tv, a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace sm90
