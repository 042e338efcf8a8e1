// The Hopper (sm_90a) bodies of the training backward's bf16 kernels, K4 (dK, dV) and K5
// (dQ), used by csrc/flash_attention_bwd.cu: non-causal, head_dim 128, over the packed
// (B, S, N, 128) layout. The PTX wrappers (mbarrier, TMA, wgmma, descriptors) come from
// flash_attention_sm90.cuh; the roles, tiles and host checks here are the backward's own.
//
// The function (that of goal_force_tpu/ops/flash_attention.py::_fa_kernel_dkv/_dq):
// p = exp(s*scale - lse), 0 for keys >= Skv and rows >= Sq; di = rowsum(f32(o)*f32(do));
// dv += bf16(p)^T do; ds = bf16(p*(do.v^T - di)*scale); dk += ds^T q; dq += ds k; every
// sum in f32, outputs in bf16, no atomics (each output element is written by one thread
// from one f32 sum, in a fixed order, so the results are deterministic).
//
// p is computed as exp2(s*(scale*log2 e) - lse*log2 e) with ex2.approx.ftz: the same value
// up to the float32 rounding of the argument, far below the bf16 rounding p and ds take
// before their products. A small pass (fa_bwd_di, in flash_attention_bwd.cu) reads o and
// do once per call and writes a float32 scratch of lse*log2 e and di, padded to whole
// SCRATCH_ROWS blocks with +inf and 0 past Sq; K4 and K5 read it instead of o.
//
// Bound: K4 does 8 and K5 6 products of Sq x Skv x 128 per (batch, head) on O(S x 128)
// bytes, so both are bound by the tensor cores; only wgmma reaches their rate.
//
// K5, query-stationary: the forward skeleton's shape and roles. One CTA of 384 threads per
// (128 q rows, head, batch row): warpgroup 0 is the producer (setmaxnreg 24), whose first
// thread loads Q and dO once and then feeds a ring of 64-key K/V tiles by TMA; warpgroups
// 1 and 2 are consumers (setmaxnreg 240) of 64 rows each, which read their rows' lse*log2 e
// and di once. Per key tile a consumer runs S = Q K^T and dP = dO V^T (m64n64, both
// operands K-major in shared memory) as one commit group, dS = P (dP - di) scale in
// registers, then dQ += bf16(dS) K (A from registers, K as the MN-major B operand, as V in
// the forward's PV) as another, and arrives on the slot's "empty" barrier. Zero-filled keys
// past Skv give logit 0 (p = exp(-lse), not 0), so the tile that straddles Skv masks them;
// rows >= Sq are never stored. Registers: dQ 64 + S 32 + dP 32 f32 and 16 packed pairs.
//
// K4, key-stationary, products transposed (FA3's swap AB). One CTA per (128 keys, head,
// batch row); each of two consumer warpgroups owns 64 keys. K and V are loaded once, then
// a ring of slots holds, per 64-row q tile, a Q and a dO tile and the tile's 64 values of
// lse*log2 e and di (a 1-d bulk copy each from the scratch, whose +inf past Sq makes p
// exactly 0 there: the Sq straddle mask). Per q tile a warpgroup runs S^T = K Q^T and
// dP^T = V dO^T (m64n64, K-major) as one commit group, P^T and dS^T in registers, then
// dV += bf16(P^T) dO and dK += bf16(dS^T) Q (A from registers, dO and Q MN-major) as
// another. Keys >= Skv (zero-filled by TMA) are computed and never stored, so they need no
// mask. Each consumer thread holds dK 64 + dV 64 f32, S^T 32 + dP^T 32 f32 while the first
// group runs and 16 + 16 packed bf16 pairs while the second does: about 230 registers.
// ptxas compiles a kernel to the registers its launch bound allows before any setmaxnreg
// (384 threads: 168, three warps on each SM sub-partition), and at 168 it spilled and
// serialized every wgmma of K4 (C7512). So K4 launches 256 threads, the two consumer
// warpgroups at up to 255 registers, and thread 0 of warpgroup 0 is the producer: it
// issues the K/V loads and the first KV_STAGES q tiles, and in each iteration refills the
// slot of the tile before (both warpgroups have released it by then unless warpgroup 1
// lags a whole tile).
//
// Every barrier wait that never completes traps after ~2^34 cycles, so a lost phase is a
// launch error, not a hang; the tile counts are computed once, before the roles split.
//
// Layouts: rank-4 maps over (128, N, S, B) as in the forward, so TMA zero-fills and clips
// at each batch row's end. A bf16 tile of R rows lands as two 64-column halves of R x 128
// bytes (128-byte swizzle). K-major operands step 32 bytes per k-step inside a half; an
// MN-major B operand of R rows has its halves R x 128 bytes apart (leading byte offset)
// and steps 2048 bytes (16 rows) per k-step.
//
// The host side only checks the geometry that ops/flash_attention.py::sm90_bwd_geometry
// computed, encodes the maps and launches.

#pragma once

#include <math.h>

#include "flash_attention_sm90.cuh"

namespace sm90_bwd {

constexpr int HD = 128;          // head dim
constexpr int KV_KEYS = 128;     // K4: keys per CTA (two consumer warpgroups of 64)
constexpr int KV_QROWS = 64;     // K4: q rows per ring slot
constexpr int KV_STAGES = 4;     // K4: ring slots
constexpr int KV_THREADS = 256;  // K4: two consumer warpgroups (thread 0 also produces)
constexpr int Q_ROWS = 128;      // K5: q rows per CTA (two consumer warpgroups of 64)
constexpr int Q_KEYS = 64;       // K5: keys per ring slot
constexpr int Q_STAGES = 4;      // K5: ring slots
constexpr int THREADS = 384;     // K5: producer warpgroup + two consumer warpgroups
constexpr long long SMEM_LIMIT = 232448;
constexpr int SCRATCH_ROWS = 128;  // the lse*log2 e / di scratch rows: Sq rounded up to this
constexpr float LOG2E = 1.4426950408889634f;

// A bf16 tile of `rows` rows: two 64-column halves of rows x 128 bytes.
__host__ __device__ constexpr uint32_t half_bytes(int rows) { return 128u * rows; }
__host__ __device__ constexpr uint32_t tile_bytes(int rows) { return 256u * rows; }

// Dynamic shared memory: 1024 bytes of alignment slack, the two resident tiles, the ring,
// K4's per-slot tables (lse*log2 e and di of 64 rows), and 1 + 2 x stages mbarriers.
constexpr long long dkv_smem_bytes() {
  return 1024 + 2 * tile_bytes(KV_KEYS) + KV_STAGES * (2 * tile_bytes(KV_QROWS) + 8 * KV_QROWS) +
         8 * (1 + 2 * KV_STAGES);
}
constexpr long long dq_smem_bytes() {
  return 1024 + 2 * tile_bytes(Q_ROWS) + Q_STAGES * 2 * tile_bytes(Q_KEYS) + 8 * (1 + 2 * Q_STAGES);
}

struct Args {
  const float* lse2;      // (B, N, rows) f32: lse * log2(e), +inf for rows >= Sq
  const float* di;        // (B, N, rows) f32: rowsum(o*do), 0 for rows >= Sq
  void* dk;               // K4: (B, Skv, N, 128) bf16
  void* dv;               // K4
  void* dq;               // K5: (B, Sq, N, 128) bf16
  int Sq, Skv, N;
  int rows;               // Sq rounded up to SCRATCH_ROWS
  float scale;            // softmax scale
  float scale_log2;       // scale * log2(e)
};

__device__ __forceinline__ float lds(uint32_t addr) {
  float v;
  asm volatile("ld.shared.f32 %0, [%1];\n" : "=f"(v) : "r"(addr));
  return v;
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// A 1-d bulk copy of `bytes` (a multiple of 16, both addresses 16-byte aligned) into shared
// memory; completion is reported to `bar` as transaction bytes.
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src, uint32_t bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
      ::"r"(dst), "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

// One bf16 tile of `rows` rows at row `row0` of head h, batch row b.
__device__ __forceinline__ void load_tile(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                          int rows, int row0, int h, int b) {
  sm90::tma_load_4d(dst, map, bar, 0, h, row0, b);
  sm90::tma_load_4d(dst + half_bytes(rows), map, bar, 64, h, row0, b);
}

// K-major operand of a tile of `rows` rows, k-step kk of 16 head dims.
__device__ __forceinline__ uint64_t kdesc(uint32_t tile, int rows, int kk) {
  return sm90::kmajor_desc(tile + (kk >> 2) * half_bytes(rows) + (kk & 3) * 32);
}
// MN-major B operand of a 64-row tile (rows = the product's k dim), k-step kk of 16 rows.
__device__ __forceinline__ uint64_t mndesc64(uint32_t tile, int kk) {
  return sm90::sw128_desc(tile + kk * 2048, half_bytes(64), 1024);
}

// d (64 x 64) = A (64 rows of tile a, K-major) . B^T, B the 64 rows of tile b (K-major):
// 8 k-steps over the 128 head dims, issued (not committed). The first k-step writes d
// without reading it, so no earlier value of d is kept alive for it.
__device__ __forceinline__ void qk_issue(float* d, uint32_t a, int a_rows, uint32_t b) {
  sm90::wgmma_ss_bf16_n64_first(d, kdesc(a, a_rows, 0), kdesc(b, 64, 0));
#pragma unroll
  for (int kk = 1; kk < 8; ++kk) sm90::wgmma_ss_bf16_n64(d, kdesc(a, a_rows, kk), kdesc(b, 64, kk));
}
// acc (64 x 128) += A (64 x 64 bf16, packed fragments) . B (a 64-row tile, MN-major): 4
// k-steps of 16 rows.
__device__ __forceinline__ void pv_issue(float* acc, const uint32_t* f, uint32_t b) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) sm90::wgmma_rs_bf16(acc, f + 4 * kk, mndesc64(b, kk));
}
// A 64 x 64 f32 accumulator packed to bf16 in the A-fragment order of the next wgmma.
__device__ __forceinline__ void pack_frag(const float* x, uint32_t* f) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    f[4 * kk + 0] = sm90::pack_bf16(x[8 * kk + 0], x[8 * kk + 1]);
    f[4 * kk + 1] = sm90::pack_bf16(x[8 * kk + 2], x[8 * kk + 3]);
    f[4 * kk + 2] = sm90::pack_bf16(x[8 * kk + 4], x[8 * kk + 5]);
    f[4 * kk + 3] = sm90::pack_bf16(x[8 * kk + 6], x[8 * kk + 7]);
  }
}

__device__ __forceinline__ void release(uint32_t empty, int lane) {
  __syncwarp();
  if (lane == 0) sm90::mbar_arrive(empty);
}

// Stores a 64 x 128 f32 accumulator as bf16 rows r0 and r0 + 8 of (., S, N, 128) at batch
// row b, head h; rows >= S are not written.
__device__ __forceinline__ void store_rows(void* out, const float* acc, int b, int S, int N, int h,
                                           int r0, int t) {
  __nv_bfloat16* o = static_cast<__nv_bfloat16*>(out);
  const long long rs = (long long)N * HD;
#pragma unroll
  for (int n = 0; n < 16; ++n) {
    const int col = n * 8 + 2 * t;
    if (r0 < S)
      *reinterpret_cast<__nv_bfloat162*>(o + ((long long)b * S + r0) * rs + h * HD + col) =
          __floats2bfloat162_rn(acc[4 * n], acc[4 * n + 1]);
    if (r0 + 8 < S)
      *reinterpret_cast<__nv_bfloat162*>(o + ((long long)b * S + r0 + 8) * rs + h * HD + col) =
          __floats2bfloat162_rn(acc[4 * n + 2], acc[4 * n + 3]);
  }
}

// ---------------------------------------------------------------------------------------
// K4: dK, dV
// ---------------------------------------------------------------------------------------

__global__ void __launch_bounds__(KV_THREADS, 1)
fa_sm90_bwd_dkv(const __grid_constant__ CUtensorMap tmq, const __grid_constant__ CUtensorMap tmdo,
                const __grid_constant__ CUtensorMap tmk, const __grid_constant__ CUtensorMap tmv,
                const Args a) {
  constexpr uint32_t KT = tile_bytes(KV_KEYS), QT = tile_bytes(KV_QROWS), TAB = 8 * KV_QROWS;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = sm90::smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;          // the 128-byte swizzle's alignment
  const uint32_t sK = base, sV = sK + KT;
  const uint32_t sRing = sV + KT;                        // slot s: Q, then dO
  const uint32_t sTab = sRing + KV_STAGES * 2 * QT;      // slot s: lse*log2 e [64], di [64]
  const uint32_t sBar = sTab + KV_STAGES * TAB;          // kv_full, full[STAGES], empty[STAGES]
  const uint32_t kv_full = sBar;

  const int kt = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, lane = tid & 31;
  const int n_qt = (a.Sq + KV_QROWS - 1) / KV_QROWS;

  if (tid == 0) {
    sm90::mbar_init(kv_full, 1);
    for (int s = 0; s < KV_STAGES; ++s) {
      sm90::mbar_init(sBar + 8u * (1 + s), 1);
      sm90::mbar_init(sBar + 8u * (1 + KV_STAGES + s), 8);       // the 8 consumer warps
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // Thread 0 is the producer: it loads K and V once and the first KV_STAGES q tiles, then,
  // in iteration i of the consumers' loop, refills the slot of tile i - 1 (which both
  // warpgroups have released by then, unless warpgroup 1 lags a whole tile) with tile
  // i - 1 + KV_STAGES.
  const long long off = ((long long)b * a.N + h) * a.rows;
  auto produce = [&](int j) {   // q tile j into its slot: Q, dO, lse*log2 e, di
    const int s = j % KV_STAGES;
    const uint32_t full = sBar + 8u * (1 + s), sq = sRing + s * 2 * QT;
    sm90::mbar_arrive_expect_tx(full, 2 * QT + TAB);
    load_tile(sq, &tmq, full, KV_QROWS, j * KV_QROWS, h, b);
    load_tile(sq + QT, &tmdo, full, KV_QROWS, j * KV_QROWS, h, b);
    bulk_load(sTab + s * TAB, a.lse2 + off + j * KV_QROWS, TAB / 2, full);
    bulk_load(sTab + s * TAB + TAB / 2, a.di + off + j * KV_QROWS, TAB / 2, full);
  };
  if (tid == 0) {
    sm90::mbar_arrive_expect_tx(kv_full, 2 * KT);
    load_tile(sK, &tmk, kv_full, KV_KEYS, kt * KV_KEYS, h, b);
    load_tile(sV, &tmv, kv_full, KV_KEYS, kt * KV_KEYS, h, b);
    for (int j = 0; j < KV_STAGES && j < n_qt; ++j) produce(j);
  }

  // ---- consumers: warpgroups 0 and 1, 64 keys each ----
  const int cw = __shfl_sync(0xffffffff, tid / 128, 0), wtid = tid & 127;
  const int warp = wtid >> 5, g = lane >> 2, t = lane & 3;
  const uint32_t aK = sK + cw * 64 * 128, aV = sV + cw * 64 * 128;   // this warpgroup's keys
  float dk[64], dv[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) dk[i] = dv[i] = 0.f;
  sm90::mbar_wait(kv_full, 0);

  for (int i = 0; i < n_qt; ++i) {
    const int s = i % KV_STAGES;
    sm90::mbar_wait(sBar + 8u * (1 + s), (i / KV_STAGES) & 1);
    const uint32_t sq = sRing + s * 2 * QT, sdo = sq + QT;
    // This thread's column of the slot's table (shared address), made opaque so that the
    // compiler derives the lse / di addresses inside the loop instead of keeping them all
    // in registers across it.
    uint32_t tab = sTab + s * TAB + 8 * t;
    asm volatile("" : "+r"(tab));
    // The same for the warpgroup's K and V addresses and their wgmma descriptors.
    uint32_t k_rows = aK, v_rows = aV;
    asm volatile("" : "+r"(k_rows), "+r"(v_rows));

    // S^T = K Q^T and dP^T = V dO^T, one commit group: 64 keys x 64 q rows each; this
    // thread's q rows are n*8 + 2t + (e & 1) for accumulator element 4n + e.
    float st[32], dpt[32];
    sm90::wgmma_fence();
    qk_issue(st, k_rows, KV_KEYS, sq);
    qk_issue(dpt, v_rows, KV_KEYS, sdo);
    sm90::wgmma_commit();
    sm90::wgmma_wait<0>();
    sm90::fence_regs32(st);
    sm90::fence_regs32(dpt);

    // P^T = exp2(S^T scale log2 e - lse log2 e), dS^T = P^T (dP^T - di) scale.
#pragma unroll
    for (int e = 0; e < 32; ++e) {
      const int c = (e >> 2) * 8 + (e & 1);   // + 2t in `tab`
      st[e] = ex2(fmaf(st[e], a.scale_log2, -lds(tab + 4 * c)));
      dpt[e] = st[e] * (dpt[e] - lds(tab + 4 * (KV_QROWS + c))) * a.scale;
    }
    uint32_t pf[16], df[16];
    pack_frag(st, pf);
    pack_frag(dpt, df);

    // dV += bf16(P^T) dO and dK += bf16(dS^T) Q, one commit group.
    sm90::fence_regs(dv);
    sm90::fence_regs(dk);
    sm90::wgmma_fence();
    pv_issue(dv, pf, sdo);
    pv_issue(dk, df, sq);
    sm90::wgmma_commit();
    sm90::wgmma_wait<0>();
    sm90::fence_regs(dv);
    sm90::fence_regs(dk);
    release(sBar + 8u * (1 + KV_STAGES + s), lane);
    if (tid == 0 && i >= 1 && i - 1 + KV_STAGES < n_qt) {
      const int j = i - 1;
      sm90::mbar_wait(sBar + 8u * (1 + KV_STAGES + j % KV_STAGES), (j / KV_STAGES) & 1);
      produce(j + KV_STAGES);
    }
  }

  const int key0 = kt * KV_KEYS + cw * 64 + warp * 16 + g;   // rows key0, key0 + 8
  store_rows(a.dk, dk, b, a.Skv, a.N, h, key0, t);
  store_rows(a.dv, dv, b, a.Skv, a.N, h, key0, t);
}

// ---------------------------------------------------------------------------------------
// K5: dQ
// ---------------------------------------------------------------------------------------

__global__ void __launch_bounds__(THREADS, 1)
fa_sm90_bwd_dq(const __grid_constant__ CUtensorMap tmq, const __grid_constant__ CUtensorMap tmdo,
               const __grid_constant__ CUtensorMap tmk, const __grid_constant__ CUtensorMap tmv,
               const Args a) {
  constexpr uint32_t QT = tile_bytes(Q_ROWS), KT = tile_bytes(Q_KEYS);
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = sm90::smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  const uint32_t sQ = base, sdO = sQ + QT;
  const uint32_t sRing = sdO + QT;                       // slot s: K, then V
  const uint32_t sBar = sRing + Q_STAGES * 2 * KT;       // q_full, full[STAGES], empty[STAGES]
  const uint32_t q_full = sBar;

  const int qt = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, lane = tid & 31;
  const int n_kt = (a.Skv + Q_KEYS - 1) / Q_KEYS;        // read by both roles

  if (tid == 0) {
    sm90::mbar_init(q_full, 1);
    for (int s = 0; s < Q_STAGES; ++s) {
      sm90::mbar_init(sBar + 8u * (1 + s), 1);
      sm90::mbar_init(sBar + 8u * (1 + Q_STAGES + s), 8);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = __shfl_sync(0xffffffff, tid / 128, 0);
  if (wg == 0) {
    // ---- producer: one thread loads Q and dO once, then the K/V ring ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n" ::: "memory");
    if (tid == 0) {
      sm90::mbar_arrive_expect_tx(q_full, 2 * QT);
      load_tile(sQ, &tmq, q_full, Q_ROWS, qt * Q_ROWS, h, b);
      load_tile(sdO, &tmdo, q_full, Q_ROWS, qt * Q_ROWS, h, b);
      for (int j = 0; j < n_kt; ++j) {
        const int s = j % Q_STAGES;
        const uint32_t full = sBar + 8u * (1 + s);
        sm90::mbar_wait(sBar + 8u * (1 + Q_STAGES + s), ((j / Q_STAGES) & 1) ^ 1);
        sm90::mbar_arrive_expect_tx(full, 2 * KT);
        const uint32_t sk = sRing + s * 2 * KT;
        load_tile(sk, &tmk, full, Q_KEYS, j * Q_KEYS, h, b);
        load_tile(sk + KT, &tmv, full, Q_KEYS, j * Q_KEYS, h, b);
      }
    }
  } else {
    // ---- consumers: 64 q rows each ----
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n" ::: "memory");
    const int cw = wg - 1, wtid = tid & 127;
    const int warp = wtid >> 5, g = lane >> 2, t = lane & 3;
    const int r0 = qt * Q_ROWS + cw * 64 + warp * 16 + g;   // this thread's rows r0, r0 + 8
    const long long off = ((long long)b * a.N + h) * a.rows;   // r0 + 8 < rows
    const float l0 = a.lse2[off + r0], l1 = a.lse2[off + r0 + 8];
    const float d0 = a.di[off + r0], d1 = a.di[off + r0 + 8];
    const uint32_t aQ = sQ + cw * 64 * 128, aO = sdO + cw * 64 * 128;   // this warpgroup's rows
    float dq[64];
#pragma unroll
    for (int i = 0; i < 64; ++i) dq[i] = 0.f;
    sm90::mbar_wait(q_full, 0);

    for (int j = 0; j < n_kt; ++j) {
      const int s = j % Q_STAGES;
      sm90::mbar_wait(sBar + 8u * (1 + s), (j / Q_STAGES) & 1);
      const uint32_t sk = sRing + s * 2 * KT, sv = sk + KT;

      // S = Q K^T and dP = dO V^T: 64 rows x 64 keys; this thread's keys n*8 + 2t + (e & 1).
      float sc[32], dp[32];
      sm90::wgmma_fence();
      qk_issue(sc, aQ, Q_ROWS, sk);
      qk_issue(dp, aO, Q_ROWS, sv);
      sm90::wgmma_commit();
      sm90::wgmma_wait<0>();
      sm90::fence_regs32(sc);
      sm90::fence_regs32(dp);

#pragma unroll
      for (int i = 0; i < 32; ++i) sc[i] = ex2(fmaf(sc[i], a.scale_log2, -(i & 2 ? l1 : l0)));
      const int kbase = j * Q_KEYS;
      if (kbase + Q_KEYS > a.Skv) {   // only the tile that straddles Skv pays for the mask
#pragma unroll
        for (int n = 0; n < 8; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            if (kbase + n * 8 + 2 * t + (e & 1) >= a.Skv) sc[4 * n + e] = 0.f;
      }
#pragma unroll
      for (int i = 0; i < 32; ++i) dp[i] = sc[i] * (dp[i] - (i & 2 ? d1 : d0)) * a.scale;
      uint32_t df[16];
      pack_frag(dp, df);

      // dQ += bf16(dS) K.
      sm90::fence_regs(dq);
      sm90::wgmma_fence();
      pv_issue(dq, df, sk);
      sm90::wgmma_commit();
      sm90::wgmma_wait<0>();
      sm90::fence_regs(dq);
      release(sBar + 8u * (1 + Q_STAGES + s), lane);
    }
    store_rows(a.dq, dq, b, a.Sq, a.N, h, r0, t);
  }
}

// ---------------------------------------------------------------------------------------
// Host side: check the geometry, encode the maps, launch
// ---------------------------------------------------------------------------------------

// The geometry array (int64), as ops/flash_attention.py::sm90_bwd_geometry lays it out:
//   [0] q rows per tile  [1] keys per tile  [2] stages  [3] threads  [4..6] grid x, y, z
//   [7] shared-memory bytes, then for q, do, k, v (11 each): dims[4] (128, N, S, B), byte
//   strides of dims 1-3, box[4]; [52] the rows of the lse*log2 e / di scratch. Returns 0
//   when it matches this file's tiles and the shapes.
inline int check_geometry(bool dkv, const long long* g, int B, int Sq, int Skv, int N) {
  const long long bq = dkv ? KV_QROWS : Q_ROWS, bk = dkv ? KV_KEYS : Q_KEYS;
  const long long smem = dkv ? dkv_smem_bytes() : dq_smem_bytes();
  const long long want[8] = {bq, bk, dkv ? KV_STAGES : Q_STAGES, dkv ? KV_THREADS : THREADS,
                             dkv ? (Skv + bk - 1) / bk : (Sq + bq - 1) / bq, N, B, smem};
  for (int i = 0; i < 8; ++i)
    if (g[i] != want[i]) return 1;
  const long long rows[4] = {Sq, Sq, Skv, Skv}, tile[4] = {bq, bq, bk, bk};
  for (int m = 0; m < 4; ++m) {
    const long long* d = g + 8 + 11 * m;
    const long long dims[4] = {HD, N, rows[m], B};
    const long long strides[3] = {2 * HD, 2 * HD * N, 2 * HD * N * rows[m]};
    const long long box[4] = {64, 1, tile[m], 1};
    for (int i = 0; i < 4; ++i)
      if (d[i] != dims[i] || d[7 + i] != box[i]) return 1;
    for (int i = 0; i < 3; ++i)
      if (d[4 + i] != strides[i]) return 1;
  }
  if (g[52] != (Sq + SCRATCH_ROWS - 1) / SCRATCH_ROWS * SCRATCH_ROWS) return 1;
  return smem <= SMEM_LIMIT ? 0 : 1;
}

// Encodes the four maps (q, do, k, v) and launches K4 (dkv) or K5; returns a CUDA error code
// (0 on success), or cudaErrorInvalidValue when the geometry or a map is refused.
inline int launch(bool dkv, const void* q, const void* dout, const void* k, const void* v,
                  const Args& a, int B, const long long* g, cudaStream_t st) {
  if (g == nullptr || check_geometry(dkv, g, B, a.Sq, a.Skv, a.N) != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap tm[4];
  const void* ptr[4] = {q, dout, k, v};
  for (int m = 0; m < 4; ++m)
    if (sm90::encode_map(&tm[m], CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, ptr[m], g + 8 + 11 * m) !=
        CUDA_SUCCESS)
      return static_cast<int>(cudaErrorInvalidValue);
  const int smem = static_cast<int>(g[7]);
  auto kernel = dkv ? fa_sm90_bwd_dkv : fa_sm90_bwd_dq;
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  kernel<<<dim3((unsigned)g[4], (unsigned)g[5], (unsigned)g[6]), (unsigned)g[3], smem, st>>>(
      tm[0], tm[1], tm[2], tm[3], a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace sm90_bwd
