// Flash attention forward for Hopper (sm_90a), bf16 in and out.
//
// Replaces: cassmantle_tpu/ops/flash_attention.py::_flash_kernel (reached
// through _flash_bhsd, flash_attention, flash_cross_attention and the
// wide-head VAE dispatch). It computes softmax(q k^T * scale) v by online
// softmax with the same arithmetic: fp32 scores, fp32 running max,
// denominator and accumulator; p is rounded to bf16 before p.v; columns at
// or past kv_len get -inf before the softmax (the reference's -1e30
// underflows to the same 0); out = acc / l.
//
// The serving path's three modes (SD1.5-512 and SDXL-1024 with CFG):
//   - self attention over image tokens (SD1.5: B=2, H=8, (S, D) =
//     (4096, 40), (1024, 80), (256, 160), (64, 160); SDXL: B=2, D=64,
//     (S, H) = (4096, 10), (1024, 20));
//   - cross attention over the 77-token CLIP context (kv_len 77);
//   - the wide head of the VAE mid block (B=1, H=1, D=512, S=4096 at
//     SD1.5, 16384 at SDXL).
//
// What bounds it (bf16, H100 SXM: 989 TFLOP/s, 3.35 TB/s; 4*B*H*Sq*Sk*D
// FLOPs, q, k, v, o bytes once each): self attention at level 0 of the
// UNet is 42.9 GFLOP (43 us at the tensor peak), but its 268 M scores
// each need one exponential, and the SM's special-function units issue
// 16 ex2 a clock: about 64 us on 132 SMs at 1.98 GHz. At D = 40 the
// exponent unit, not the tensor cores, is the limit; each score also
// costs a few fp32 instructions (scale, max, sum, convert). Level 2 self
// attention and every cross attention are memory-bound, a few us each.
//
// Two kernels, chosen by the caller (ops/_flash_plan.py) by shape and
// never as a rescue:
//
// flash_wgmma_kernel (D = 40, 64, 80 or 160, the UNets' head dims, with
// 16-byte strides and bases), after FlashAttention-3's structure, on
// hopper.cuh:
// - Warp-specialised block: one producer thread issues TMA for the Q
//   tile once, then keeps K and V tiles in flight through rings of 2-3
//   stages (separate full/empty mbarriers for K and V, so q.k^T starts
//   before V lands); one to three consumer warpgroups own 64 query rows
//   each. setmaxnreg moves registers from the producer (32 or 24) to
//   the consumers (232 with two, 160 with three: only D = 40's and
//   64's accumulators fit 160, and there 192 rows a block share each K/V
//   tile and a third warp on each scheduler hides the softmax's latency).
// - Both products on wgmma: S = Q K^T as m64nBKk16 with Q and K K-major
//   in 128-byte-swizzled tiles (desc_sw128); O += P V as m64nNPk16 with
//   P from registers (the S accumulator converted to bf16 in place: its
//   layout is the A fragment's) and V MN-major (D contiguous, the
//   transpose flag, desc_mn_sw128 with the D boxes LBO apart).
// - Head-dim padding by TMA: q, k, v are 4-D maps (D, H, S, B) over the
//   caller's strides (the fused qkv projection's views need no copy),
//   boxes of 64 columns (128 bytes); TMA zero-fills columns d..63 of the
//   last box and rows past Sq or kv_len. ceil(d/16) k-steps of q.k^T
//   and N = d for p.v (NP = d: one instance per UNet head dim). D = 64
//   is exactly one box (no column past d); D = 80 and 160 take two and
//   three boxes.
// - Softmax that keeps the exponent unit busy: the scale folds into one
//   FFMA per score (s * scale * log2e - m), ex2.approx.ftz (relative
//   error about 2^-22, far below p's bf16 rounding of 2^-9); columns are
//   masked only in a last key tile that kv_len cuts (self attention
//   masks nothing); row maxima and sums keep four partials a row, so
//   that the exponentials issue back to back. Within a warpgroup tile
//   j's q.k^T and tile j-1's p.v are issued together and the softmax of
//   tile j runs while p.v does; the consumer warpgroups take turns
//   issuing, in order (ping-pong on named barriers), so one's softmax
//   overlaps the others' products. The accumulator and A-fragment registers are
//   pinned before each wgmma.fence: anything the compiler schedules into
//   a wgmma stage makes ptxas serialise every wgmma (C7515).
// - A consumer warp releases a K or V stage with one arrival (lane 0),
//   after the warpgroup's wgmma.wait.
// - Epilogue: O / l in fp32, rounded to bf16, rows past Sq and columns
//   past d not stored; strided output.
// What holds it back at D = 40: a TMA box cut by the tensor's edge
// along D (80 of its 128 bytes a row in bounds) moves at about a third
// of the rate of a whole box, and the softmax runs at about twice the
// exponent floor; with three consumers the loads alone take about 0.8
// of the kernel's time and the products without the softmax as much,
// so all three would have to fall together (PERF.md, flash attention).
// cp.async loads by a producer warpgroup and K/V multicast to a pair of
// blocks were each measured slower than this design.
//
// flash_fwd_kernel (mma.sync, the first design): D = 512 (the VAE mid
// block: a 64 x 512 fp32 accumulator does not fit one warpgroup's
// registers), every head dim off the UNet's (no wgmma instance), and
// inputs TMA cannot describe: a stride that is not a multiple of 16
// bytes, a misaligned base, scale <= 0. One
// block owns BQ query rows and walks the key tiles; K/V tiles are
// double-buffered with cp.async; both products on mma.sync m16n8k16 fed
// by ldmatrix; wide heads split D across WD warps per row group, which
// exchange partial scores through shared memory.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

#include "hopper.cuh"

namespace {

typedef __nv_bfloat16 bf16;

constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;

struct Strides {
  long long b, s, h;  // element strides of (batch, seq, head); d is unit
};

// Tile geometry: DP the padded head dim, BQ query rows and BK keys per
// tile, WD warps sharing one 16-row group (each owns DP / WD columns).
template <int DP, int BQ, int BK, int WD>
struct Cfg {
  static constexpr int kThreads = BQ / 16 * WD * 32;
  static constexpr int kDW = DP / WD;      // head-dim columns per warp
  static constexpr int kPitch = DP + 8;    // bf16 row pitch: ldmatrix rows
                                           // land in distinct bank groups
  static constexpr int kSxPitch = BK + 8;  // fp32 partial-score pitch
  static constexpr size_t kQBytes = size_t(BQ) * kPitch * 2;
  static constexpr size_t kKVBytes = size_t(BK) * kPitch * 2;  // one tile
  static constexpr size_t kSxBytes =
      WD > 1 ? size_t(BQ / 16) * WD * 16 * kSxPitch * 4 : 0;
  static constexpr size_t kSmem = kQBytes + 4 * kKVBytes + kSxBytes;
  static_assert(DP % 16 == 0 && kDW % 16 == 0, "pad D to 16 per warp");
  static_assert(BQ % 16 == 0 && BK % 16 == 0, "16-row tiles");
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16-byte global -> shared copy; zero-fills when !valid (src unread).
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void ldsm_x4(uint32_t* r, const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t* r, const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

// c += a (16x16, row) * b (16x8, col); bf16 in, fp32 accumulate.
__device__ __forceinline__ void mma16816(float* c, const uint32_t* a,
                                         uint32_t b0, uint32_t b1) {
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

// Copy `rows` rows of D values (row pitch `stride` elements in global
// memory) into a [rows][DP] tile of pitch `pitch`; rows at or past `valid`
// and columns at or past `d` are zero. vec: 16-byte cp.async (d % 8 == 0,
// 16-byte aligned rows); else plain 2-byte loads and stores.
template <int DP, int NT>
__device__ __forceinline__ void load_tile(bf16* dst, int pitch,
                                          const bf16* src, long long stride,
                                          int rows, int valid, int d,
                                          bool vec) {
  if (vec) {
    constexpr int chunks = DP / 8;
    for (int idx = threadIdx.x; idx < rows * chunks; idx += NT) {
      const int r = idx / chunks;
      const int c = (idx % chunks) * 8;
      const bool ok = r < valid && c < d;
      cp_async16(dst + r * pitch + c, ok ? src + r * stride + c : src, ok);
    }
  } else {
    const bf16 zero = __float2bfloat16(0.0f);
    for (int idx = threadIdx.x; idx < rows * DP; idx += NT) {
      const int r = idx / DP;
      const int c = idx % DP;
      dst[r * pitch + c] = (r < valid && c < d) ? src[r * stride + c] : zero;
    }
  }
}

template <int DP, int BQ, int BK, int WD>
__global__ void __launch_bounds__(Cfg<DP, BQ, BK, WD>::kThreads)
flash_fwd_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                 const bf16* __restrict__ v, bf16* __restrict__ o,
                 int sq, int d, int kv_len, float scale, Strides qst,
                 Strides kst, Strides vst, Strides ost, bool vec) {
  using C = Cfg<DP, BQ, BK, WD>;
  constexpr int NT = C::kThreads;
  constexpr int P = C::kPitch;
  constexpr int DW = C::kDW;
  constexpr int NS = BK / 8;   // score n-tiles per key tile
  constexpr int NO = DW / 8;   // output n-tiles per warp
  constexpr int KQ = DW / 16;  // q.k k-steps per warp

  extern __shared__ __align__(128) unsigned char smem[];
  bf16* qs = reinterpret_cast<bf16*>(smem);
  bf16* ks = reinterpret_cast<bf16*>(smem + C::kQBytes);       // [2][BK][P]
  bf16* vs = reinterpret_cast<bf16*>(smem + C::kQBytes + 2 * C::kKVBytes);
  float* sx = reinterpret_cast<float*>(smem + C::kQBytes + 4 * C::kKVBytes);

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int rg = warp / WD;        // 16-row group
  const int dc = warp % WD;        // head-dim chunk
  const int g = lane >> 2;         // fragment row (and row + 8)
  const int t = lane & 3;          // fragment column pair
  const int q0 = blockIdx.x * BQ;
  const long long h = blockIdx.y;
  const long long b = blockIdx.z;
  const bf16* k_bh = k + b * kst.b + h * kst.h;
  const bf16* v_bh = v + b * vst.b + h * vst.h;
  const int n_tiles = (kv_len + BK - 1) / BK;

  // Copy groups: q, then key tile 0, then one per later tile.
  load_tile<DP, NT>(qs, P, q + b * qst.b + q0 * qst.s + h * qst.h, qst.s, BQ,
                    sq - q0, d, vec);
  cp_async_commit();
  load_tile<DP, NT>(ks, P, k_bh, kst.s, BK, kv_len, d, vec);
  load_tile<DP, NT>(vs, P, v_bh, vst.s, BK, kv_len, d, vec);
  cp_async_commit();
  cp_async_wait<1>();  // q has landed
  __syncthreads();

  // This warp's q fragments stay in registers for the whole key loop.
  uint32_t qf[KQ][4];
#pragma unroll
  for (int kk = 0; kk < KQ; ++kk) {
    ldsm_x4(qf[kk], qs + (rg * 16 + (lane & 15)) * P + dc * DW + kk * 16 +
                        (lane >> 4) * 8);
  }

  float acc[NO][4];
  float s[NS][4];
  float m_run[2] = {kNegInf, kNegInf};  // log2-domain running max
  float l_run[2] = {0.f, 0.f};          // this thread's columns only
#pragma unroll
  for (int n = 0; n < NO; ++n) {
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
  }
  const float sl2 = scale * kLog2e;

  for (int tile = 0; tile < n_tiles; ++tile) {
    const int k0 = tile * BK;
    const int buf = tile & 1;
    if (tile + 1 < n_tiles) {  // prefetch the next tile into the other half
      const int nb = buf ^ 1;
      load_tile<DP, NT>(ks + nb * BK * P, P, k_bh + (k0 + BK) * kst.s, kst.s,
                        BK, kv_len - k0 - BK, d, vec);
      load_tile<DP, NT>(vs + nb * BK * P, P, v_bh + (k0 + BK) * vst.s, vst.s,
                        BK, kv_len - k0 - BK, d, vec);
    }
    cp_async_commit();  // possibly empty: keeps the group count uniform
    cp_async_wait<1>();  // this tile has landed
    __syncthreads();

    // s = q k^T over this warp's head-dim chunk (16 x BK, fp32)
    const bf16* kt = ks + buf * BK * P;
#pragma unroll
    for (int n = 0; n < NS; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = 0.f;
    }
#pragma unroll
    for (int n = 0; n < NS; n += 2) {
#pragma unroll
      for (int kk = 0; kk < KQ; ++kk) {
        uint32_t bk[4];
        ldsm_x4(bk, kt + (n * 8 + (lane & 7) + ((lane >> 4) << 3)) * P +
                        dc * DW + kk * 16 + ((lane >> 3) & 1) * 8);
        mma16816(s[n], qf[kk], bk[0], bk[1]);
        mma16816(s[n + 1], qf[kk], bk[2], bk[3]);
      }
    }
    if (WD > 1) {  // sum the partial scores of the row group's warps
      float* mine = sx + ((rg * WD + dc) * 16) * C::kSxPitch;
#pragma unroll
      for (int n = 0; n < NS; ++n) {
        const int c = n * 8 + 2 * t;
        *reinterpret_cast<float2*>(mine + g * C::kSxPitch + c) =
            make_float2(s[n][0], s[n][1]);
        *reinterpret_cast<float2*>(mine + (g + 8) * C::kSxPitch + c) =
            make_float2(s[n][2], s[n][3]);
      }
      __syncthreads();
#pragma unroll
      for (int n = 0; n < NS; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) s[n][e] = 0.f;
      }
#pragma unroll
      for (int w = 0; w < WD; ++w) {
        const float* part = sx + ((rg * WD + w) * 16) * C::kSxPitch;
#pragma unroll
        for (int n = 0; n < NS; ++n) {
          const int c = n * 8 + 2 * t;
          const float2 lo =
              *reinterpret_cast<const float2*>(part + g * C::kSxPitch + c);
          const float2 hi = *reinterpret_cast<const float2*>(
              part + (g + 8) * C::kSxPitch + c);
          s[n][0] += lo.x;
          s[n][1] += lo.y;
          s[n][2] += hi.x;
          s[n][3] += hi.y;
        }
      }
    }

    // Online softmax in the log2 domain; rows g (e < 2) and g + 8.
    float mx[2] = {m_run[0], m_run[1]};
#pragma unroll
    for (int n = 0; n < NS; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = k0 + n * 8 + 2 * t + (e & 1);
        const float x = col < kv_len ? s[n][e] * sl2 : kNegInf;
        s[n][e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
    }
    float alpha[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
      alpha[i] = exp2f(m_run[i] - mx[i]);
      m_run[i] = mx[i];
      l_run[i] *= alpha[i];
    }
#pragma unroll
    for (int n = 0; n < NS; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = exp2f(s[n][e] - m_run[e >> 1]);
        s[n][e] = p;
        l_run[e >> 1] += p;
      }
    }
#pragma unroll
    for (int n = 0; n < NO; ++n) {
      acc[n][0] *= alpha[0];
      acc[n][1] *= alpha[0];
      acc[n][2] *= alpha[1];
      acc[n][3] *= alpha[1];
    }

    // acc += p v: p (bf16) straight from the score registers
    const bf16* vt = vs + buf * BK * P;
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      uint32_t pa[4];
      pa[0] = pack_bf16(s[2 * kk][0], s[2 * kk][1]);
      pa[1] = pack_bf16(s[2 * kk][2], s[2 * kk][3]);
      pa[2] = pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]);
      pa[3] = pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3]);
#pragma unroll
      for (int n = 0; n < NO; n += 2) {
        uint32_t bv[4];
        ldsm_x4_trans(bv, vt + (kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) *
                                   P + dc * DW + n * 8 + (lane >> 4) * 8);
        mma16816(acc[n], pa, bv[0], bv[1]);
        mma16816(acc[n + 1], pa, bv[2], bv[3]);
      }
    }
    __syncthreads();  // every warp is done with this buffer (and sx)
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l_run[i] += __shfl_xor_sync(0xffffffffu, l_run[i], 1);
    l_run[i] += __shfl_xor_sync(0xffffffffu, l_run[i], 2);
    l_run[i] = 1.f / l_run[i];
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = q0 + rg * 16 + g + 8 * i;
    if (row >= sq) continue;
    bf16* dst = o + b * ost.b + (long long)row * ost.s + h * ost.h;
#pragma unroll
    for (int n = 0; n < NO; ++n) {
      const int c = dc * DW + n * 8 + 2 * t;
      if (c < d) dst[c] = __float2bfloat16(acc[n][2 * i] * l_run[i]);
      if (c + 1 < d) dst[c + 1] = __float2bfloat16(acc[n][2 * i + 1] * l_run[i]);
    }
  }
}

template <int DP, int BQ, int BK, int WD>
cudaError_t launch(const bf16* q, const bf16* k, const bf16* v, bf16* o,
                   int batch, int heads, int sq, int d, int kv_len,
                   float scale, Strides qst, Strides kst, Strides vst,
                   Strides ost, bool vec, cudaStream_t stream) {
  using C = Cfg<DP, BQ, BK, WD>;
  // The shared-memory limit is an attribute of the function on each
  // device: one bit per device ordinal that has it set.
  static std::atomic<unsigned long long> configured{0};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const unsigned long long bit = 1ull << (dev & 63);
  if (dev >= 64 || !(configured.load() & bit)) {
    err = cudaFuncSetAttribute(flash_fwd_kernel<DP, BQ, BK, WD>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)C::kSmem);
    if (err != cudaSuccess) return err;
    if (dev < 64) configured.fetch_or(bit);
  }
  dim3 grid((sq + BQ - 1) / BQ, heads, batch);
  flash_fwd_kernel<DP, BQ, BK, WD><<<grid, C::kThreads, C::kSmem, stream>>>(
      q, k, v, o, sq, d, kv_len, scale, qst, kst, vst, ost, vec);
  return cudaGetLastError();
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
}

}  // namespace

// q (B, Sq, H, D), k and v (B, Sk, H, D), o (B, Sq, H, D): bf16 with unit
// stride on D and the given element strides on B, S, H. Columns at or
// past kv_len (1 <= kv_len <= Sk) are masked. The launch plan comes from
// the caller (ops/_flash_plan.py::flash_plan): np the padded head dim
// (d <= np), bq query rows and bk keys a block, as instantiated below,
// and grid_x = ceil(Sq / bq) query blocks. Returns a cudaError_t.
extern "C" int cassmantle_flash_attention_bf16(
    const void* q, const void* k, const void* v, void* o, int batch,
    int heads, int sq, int d, int kv_len, float scale, long long qb,
    long long qs, long long qh, long long kb, long long ks, long long kh,
    long long vb, long long vs, long long vh, long long ob, long long os,
    long long oh, int np, int bq, int bk, int grid_x, void* stream) {
  if (batch < 1 || heads < 1 || sq < 1 || kv_len < 1 || d < 1 || d > np ||
      batch > 65535 || heads > 65535 || bq < 1 ||
      grid_x != (sq + bq - 1) / bq) {
    return (int)cudaErrorInvalidValue;
  }
  const Strides qst{qb, qs, qh}, kst{kb, ks, kh}, vst{vb, vs, vh},
      ost{ob, os, oh};
  // 16-byte copies need every row start 16-byte aligned; a stride of a
  // dimension of size 1 is never applied.
  const bool b1 = batch == 1, h1 = heads == 1;
  const bool vec = d % 8 == 0 && aligned16(q) && aligned16(k) &&
                   aligned16(v) && (b1 || qb % 8 == 0) && qs % 8 == 0 &&
                   (h1 || qh % 8 == 0) && (b1 || kb % 8 == 0) &&
                   ks % 8 == 0 && (h1 || kh % 8 == 0) &&
                   (b1 || vb % 8 == 0) && vs % 8 == 0 &&
                   (h1 || vh % 8 == 0);
  const bf16* qp = static_cast<const bf16*>(q);
  const bf16* kp = static_cast<const bf16*>(k);
  const bf16* vp = static_cast<const bf16*>(v);
  bf16* op = static_cast<bf16*>(o);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define CASSMANTLE_FLASH_CASE(DP, BQ, BK, WD)                               \
  if (np == DP && bq == BQ && bk == BK) {                                   \
    return (int)launch<DP, BQ, BK, WD>(qp, kp, vp, op, batch, heads, sq, d, \
                                       kv_len, scale, qst, kst, vst, ost,   \
                                       vec, st);                            \
  }
  // (padded head dim, query rows, keys a tile, warps a row group):
  // ops/_flash_plan.py::MMA_SYNC_INSTANCES. The main path's D = 512, and
  // the head dims off the wgmma kernel's (each one held against the
  // plain version).
  CASSMANTLE_FLASH_CASE(32, 64, 64, 1)
  CASSMANTLE_FLASH_CASE(48, 64, 64, 1)
  CASSMANTLE_FLASH_CASE(64, 64, 64, 1)
  CASSMANTLE_FLASH_CASE(80, 64, 64, 1)
  CASSMANTLE_FLASH_CASE(160, 64, 32, 1)
  CASSMANTLE_FLASH_CASE(256, 64, 32, 2)
  CASSMANTLE_FLASH_CASE(512, 32, 32, 4)
#undef CASSMANTLE_FLASH_CASE
  return (int)cudaErrorInvalidValue;
}

// -- the warpgroup kernel ---------------------------------------------------

namespace fa3 {

using namespace hopper;
typedef __nv_bfloat16 bf16;

constexpr int BOX = 64;  // head-dim columns of one TMA box (128 bytes)

// Shared memory of one instance: NP the padded head dim (the p.v
// instruction's N), BK keys a tile, ST ring stages, MC the most consumer
// warpgroups (64 query rows each). Q has one region of 64 MC rows per D
// box; a K or V tile has one region of BK rows per box; every region is
// a whole number of 1024-byte swizzle atoms.
template <int NP, int BK, int ST, int MC>
struct Geo {
  static constexpr int kBoxes = (NP + BOX - 1) / BOX;
  static constexpr int kQBox = 64 * MC * 128;
  static constexpr int kQ = kBoxes * kQBox;
  static constexpr int kKVBox = BK * 128;
  static constexpr int kKV = kBoxes * kKVBox;  // one K or one V tile
  static constexpr int kBars = kQ + 2 * ST * kKV;
  static constexpr int kSmem = 1024 + kBars + (1 + 4 * ST) * 8;
  static constexpr int kSteps = (NP + 15) / 16;  // q.k^T k-steps
  static_assert(kSmem <= 232448, "one SM's shared memory");
  static_assert(BK % 16 == 0 && NP % 8 == 0, "wgmma shapes");
};

struct Args {
  bf16* o;
  long long ob, os, oh;  // output element strides of (batch, seq, head)
  int sq, d, kv_len;
  float sl2;             // scale * log2(e), > 0
};

__device__ __forceinline__ unsigned char* align1024(unsigned char* p) {
  const uint32_t a = smem_u32(p);
  return p + (((a + 1023) & ~1023u) - a);
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack2(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// blockIdx = (query block, head, batch); 128 x (consumers + 1) threads:
// consumer warpgroups first (at most MC), then the producer warpgroup.
template <int NP, int BK, int ST, int MC>
__global__ void __launch_bounds__(128 * (MC + 1), 1)
    flash_wgmma_kernel(const __grid_constant__ CUtensorMap map_q,
                       const __grid_constant__ CUtensorMap map_k,
                       const __grid_constant__ CUtensorMap map_v, Args a) {
  using G = Geo<NP, BK, ST, MC>;
  constexpr int KB = G::kBoxes;
  const float kInf = __int_as_float(0x7f800000);
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align1024(smem_raw);
  unsigned char* qs = smem;
  unsigned char* ks = smem + G::kQ;
  unsigned char* vs = ks + ST * G::kKV;
  uint64_t* qfull = reinterpret_cast<uint64_t*>(smem + G::kBars);
  uint64_t* kfull = qfull + 1;   // [ST] K tile landed
  uint64_t* kempty = kfull + ST;  // [ST] K tile read by every consumer
  uint64_t* vfull = kempty + ST;
  uint64_t* vempty = vfull + ST;

  const int nc = blockDim.x / 128 - 1;  // consumer warpgroups: 1 to MC
  const int q0 = blockIdx.x * 64 * nc;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int n_tiles = (a.kv_len + BK - 1) / BK;

  if (threadIdx.x == 0) {
    bar_init(qfull, 1);
    for (int s = 0; s < ST; ++s) {
      bar_init(&kfull[s], 1);
      bar_init(&vfull[s], 1);
      bar_init(&kempty[s], 4 * nc);  // one arrival a consumer warp
      bar_init(&vempty[s], 4 * nc);
    }
    bar_init_fence();
  }
  __syncthreads();

  if (threadIdx.x >= 128 * nc) {
    // registers at launch, 384 x 168 or 512 x 128, go to the consumers:
    // 128 x 32 + 256 x 232, or 128 x 24 + 384 x 160
    if constexpr (MC == 3) {
      regs_dec<24>();
    } else {
      regs_dec<32>();
    }
    if (threadIdx.x == 128 * nc) {
      bar_expect(qfull, KB * 64 * nc * 128);
      for (int x = 0; x < KB; ++x) {
        tma_load_4d(qs + x * G::kQBox, &map_q, qfull, x * BOX, h, q0, b);
      }
      for (int j = 0; j < n_tiles; ++j) {
        const int s = j % ST;
        const uint32_t parity = (j / ST - 1) & 1;
        if (j >= ST) bar_wait(&kempty[s], parity);
        bar_expect(&kfull[s], G::kKV);
        for (int x = 0; x < KB; ++x) {
          tma_load_4d(ks + s * G::kKV + x * G::kKVBox, &map_k, &kfull[s],
                      x * BOX, h, j * BK, b);
        }
        if (j >= ST) bar_wait(&vempty[s], parity);
        bar_expect(&vfull[s], G::kKV);
        for (int x = 0; x < KB; ++x) {
          tma_load_4d(vs + s * G::kKV + x * G::kKVBox, &map_v, &vfull[s],
                      x * BOX, h, j * BK, b);
        }
      }
    }
    return;
  }

  if constexpr (MC == 3) {
    regs_inc<160>();
  } else {
    regs_inc<232>();
  }
  const int wg = threadIdx.x / 128;
  const int t = threadIdx.x % 128;
  const int lane = t % 32;
  const bool pingpong = nc > 1;
  const int my_bar = 1 + wg;                // named barriers 1 .. nc: whose
  const int other_bar = 1 + (wg + 1) % nc;  // turn it is to issue, in order
  const unsigned char* qw = qs + wg * 64 * 128;

  float o[NP / 2];
  float s[BK / 2];
  uint32_t pa[BK / 16][4];
#pragma unroll
  for (int i = 0; i < NP / 2; ++i) o[i] = 0.f;
  fence_regs(o);
  float m0 = -kInf, m1 = -kInf;  // running max of s * sl2, rows r, r + 8
  float l0 = 0.f, l1 = 0.f;      // this thread's share of the row sums
  float al0 = 0.f, al1 = 0.f;    // the last tile's rescale factors

  // S = Q K^T over ceil(NP / 16) k-steps (columns past d are zero)
  auto issue_s = [&](int st) {
    const unsigned char* kt = ks + st * G::kKV;
#pragma unroll
    for (int kx = 0; kx < G::kSteps; ++kx) {
      const int box = kx / 4;
      const uint32_t off = (kx % 4) * 32;
      mma_ss(s, desc_add(desc_sw128(qw + box * G::kQBox), off),
             desc_add(desc_sw128(kt + box * G::kKVBox), off), kx > 0);
    }
  };
  // O += P V: P from registers, V MN-major, 16 keys a step
  auto issue_pv = [&](int st) {
    const unsigned char* vt = vs + st * G::kKV;
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      mma_rs_mn(o, pa[kk], desc_mn_sw128(vt + kk * 16 * 128, G::kKVBox));
    }
  };
  // Online softmax of tile j in the log2 domain: s becomes p (fp32);
  // al0/al1 take the factors that rescale O and the sums.
  auto softmax = [&](int j) {
    const int lim = a.kv_len - j * BK;
    if (lim < BK) {  // the ragged last tile only
#pragma unroll
      for (int c = 0; c < BK / 8; ++c) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          if (8 * c + 2 * (lane % 4) + (e & 1) >= lim) s[4 * c + e] = -kInf;
        }
      }
    }
    // row maxima and sums with four partials a row: short dependency
    // chains, so that the exponentials issue back to back
    float px[8], ps[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) px[i] = -kInf;
#pragma unroll
    for (int c = 0; c < BK / 8; ++c) {
      px[c % 4] = fmaxf(px[c % 4], fmaxf(s[4 * c], s[4 * c + 1]));
      px[4 + c % 4] = fmaxf(px[4 + c % 4], fmaxf(s[4 * c + 2], s[4 * c + 3]));
    }
    float x0 = fmaxf(fmaxf(px[0], px[1]), fmaxf(px[2], px[3]));
    float x1 = fmaxf(fmaxf(px[4], px[5]), fmaxf(px[6], px[7]));
    x0 = fmaxf(x0, __shfl_xor_sync(0xffffffffu, x0, 1));
    x1 = fmaxf(x1, __shfl_xor_sync(0xffffffffu, x1, 1));
    x0 = fmaxf(x0, __shfl_xor_sync(0xffffffffu, x0, 2));
    x1 = fmaxf(x1, __shfl_xor_sync(0xffffffffu, x1, 2));
    const float n0 = fmaxf(m0, x0 * a.sl2);
    const float n1 = fmaxf(m1, x1 * a.sl2);
    al0 = ex2(m0 - n0);  // 0 on the first tile (m = -inf)
    al1 = ex2(m1 - n1);
    m0 = n0;
    m1 = n1;
#pragma unroll
    for (int i = 0; i < 8; ++i) ps[i] = 0.f;
#pragma unroll
    for (int c = 0; c < BK / 8; ++c) {
      s[4 * c] = ex2(fmaf(s[4 * c], a.sl2, -n0));
      s[4 * c + 1] = ex2(fmaf(s[4 * c + 1], a.sl2, -n0));
      s[4 * c + 2] = ex2(fmaf(s[4 * c + 2], a.sl2, -n1));
      s[4 * c + 3] = ex2(fmaf(s[4 * c + 3], a.sl2, -n1));
      ps[c % 4] += s[4 * c] + s[4 * c + 1];
      ps[4 + c % 4] += s[4 * c + 2] + s[4 * c + 3];
    }
    l0 = fmaf(l0, al0, (ps[0] + ps[1]) + (ps[2] + ps[3]));
    l1 = fmaf(l1, al1, (ps[4] + ps[5]) + (ps[6] + ps[7]));
  };
  auto rescale = [&]() {
#pragma unroll
    for (int c = 0; c < NP / 8; ++c) {
      o[4 * c] *= al0;
      o[4 * c + 1] *= al0;
      o[4 * c + 2] *= al1;
      o[4 * c + 3] *= al1;
    }
  };
  // p to bf16 A fragments: the accumulator's layout is the A operand's
  auto convert = [&]() {
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      pa[kk][0] = pack2(s[8 * kk], s[8 * kk + 1]);
      pa[kk][1] = pack2(s[8 * kk + 2], s[8 * kk + 3]);
      pa[kk][2] = pack2(s[8 * kk + 4], s[8 * kk + 5]);
      pa[kk][3] = pack2(s[8 * kk + 6], s[8 * kk + 7]);
    }
  };

  // Pin what the next products read or write: without it the compiler
  // may place the rescale or the conversion inside a wgmma pipeline stage,
  // and ptxas then serialises every wgmma (C7515).
  // a stage is free once every consumer warp has released it: after
  // wgmma.wait, which the warpgroup passes together, its reads are done
  auto release = [&](uint64_t* bar) {
    if (lane == 0) bar_arrive(bar);
  };
  auto pin = [&]() {
    fence_regs(o);
    fence_regs(s);
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) fence_regs(pa[kk]);
  };

  if (pingpong && wg == nc - 1) named_arrive(1, 256);  // warpgroup 0 first
  bar_wait(qfull, 0);

  // tile 0: q.k^T alone
  bar_wait(&kfull[0], 0);
  pin();
  if (pingpong) named_sync(my_bar, 256);
  wgmma_fence();
  issue_s(0);
  wgmma_commit();
  if (pingpong) named_arrive(other_bar, 256);
  wgmma_wait<0>();
  fence_regs(s);
  release(&kempty[0]);
  softmax(0);
  convert();

  // tile j: q.k_j^T and p_{j-1}.v_{j-1} issued together; softmax j runs
  // while p.v (and the other warpgroup's products) do
  for (int j = 1; j < n_tiles; ++j) {
    const int st = j % ST;
    const int sp = (j - 1) % ST;
    bar_wait(&kfull[st], (j / ST) & 1);
    bar_wait(&vfull[sp], ((j - 1) / ST) & 1);
      rescale();
    pin();
    if (pingpong) named_sync(my_bar, 256);
    wgmma_fence();
    issue_s(st);
    wgmma_commit();
    issue_pv(sp);
    wgmma_commit();
    if (pingpong) named_arrive(other_bar, 256);
    wgmma_wait<1>();
    fence_regs(s);
    release(&kempty[st]);
    softmax(j);
    wgmma_wait<0>();
    fence_regs(o);
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) fence_regs(pa[kk]);
    release(&vempty[sp]);
    convert();
  }

  // the last p.v; the last warpgroup leaves no arrival behind
  const int sl = (n_tiles - 1) % ST;
  bar_wait(&vfull[sl], ((n_tiles - 1) / ST) & 1);
  rescale();
  pin();
  if (pingpong) named_sync(my_bar, 256);
  wgmma_fence();
  issue_pv(sl);
  wgmma_commit();
  if (pingpong && wg != nc - 1) named_arrive(other_bar, 256);
  wgmma_wait<0>();
  fence_regs(o);

  l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
  l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
  const int row = q0 + wg * 64 + (t / 32) * 16 + lane / 4;
  bf16* out = a.o + (long long)b * a.ob + (long long)h * a.oh;
#pragma unroll
  for (int c = 0; c < NP / 8; ++c) {
    const int col = 8 * c + 2 * (lane % 4);  // d % 8 == 0: a whole pair
    if (col >= a.d) continue;
    if (row < a.sq) {
      *reinterpret_cast<__nv_bfloat162*>(out + (long long)row * a.os + col) =
          __floats2bfloat162_rn(o[4 * c] / l0, o[4 * c + 1] / l0);
    }
    if (row + 8 < a.sq) {
      *reinterpret_cast<__nv_bfloat162*>(out + (long long)(row + 8) * a.os +
                                         col) =
          __floats2bfloat162_rn(o[4 * c + 2] / l1, o[4 * c + 3] / l1);
    }
  }
}

// q, k, v as 4-D maps (D, H, S, B) over the caller's element strides;
// dimensions of size 1 take any 16-byte stride (never applied).
inline bool encode_qkv(CUtensorMap* map, const void* base, int d, int heads,
                       int seq, int batch, long long sb, long long ss,
                       long long sh, int box_rows) {
  const uint64_t dims[4] = {(uint64_t)d, (uint64_t)heads, (uint64_t)seq,
                            (uint64_t)batch};
  const uint64_t strides[3] = {heads > 1 ? (uint64_t)sh * 2 : 16,
                               seq > 1 ? (uint64_t)ss * 2 : 16,
                               batch > 1 ? (uint64_t)sb * 2 : 16};
  const uint32_t box[4] = {BOX, 1, (uint32_t)box_rows, 1};
  return encode_map(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, base, dims,
                    strides, box, true);
}

template <int NP, int BK, int ST, int MC>
cudaError_t launch(const CUtensorMap& mq, const CUtensorMap& mk,
                   const CUtensorMap& mv, const Args& a, int nc, int grid_x,
                   int batch, int heads, cudaStream_t stream) {
  using G = Geo<NP, BK, ST, MC>;
  return launch_cluster(flash_wgmma_kernel<NP, BK, ST, MC>,
                        dim3(grid_x, heads, batch), 128 * (nc + 1),
                        G::kSmem, 1, stream, mq, mk, mv, a);
}

}  // namespace fa3

// The warpgroup kernel. q (B, Sq, H, D), k and v (B, Sk, H, D), o (B,
// Sq, H, D): bf16 with unit stride on D, element strides on B, S, H that
// are multiples of 8 (dimensions of size 1 aside), 16-byte-aligned bases,
// d = 40, 64, 80 or 160, scale > 0. The launch plan comes from the
// caller (ops/_flash_plan.py::flash_plan): np the head dim, bk keys a
// tile, stages of the K/V rings (one instantiated triple per np), nc
// consumer warpgroups (64 query rows each; three at np = 40 and 64
// only), the D boxes and q.k^T k-steps of the instance, grid_x =
// ceil(Sq / (64 nc)) query blocks. Returns a cudaError_t.
extern "C" int cassmantle_flash_attention_wgmma(
    const void* q, const void* k, const void* v, void* o, int batch,
    int heads, int sq, int d, int kv_len, float scale, long long qb,
    long long qs, long long qh, long long kb, long long ks, long long kh,
    long long vb, long long vs, long long vh, long long ob, long long os,
    long long oh, int np, int bk, int stages, int nc, int boxes, int ksteps,
    int grid_x, void* stream) {
  if (batch < 1 || heads < 1 || sq < 1 || kv_len < 1 || d != np ||
      batch > 65535 || heads > 65535 || !(scale > 0.f) || nc < 1 ||
      nc > 3 || grid_x != (sq + 64 * nc - 1) / (64 * nc)) {
    return (int)cudaErrorInvalidValue;
  }
  CUtensorMap mq, mk, mv;
  if (!fa3::encode_qkv(&mq, q, d, heads, sq, batch, qb, qs, qh, 64 * nc) ||
      !fa3::encode_qkv(&mk, k, d, heads, kv_len, batch, kb, ks, kh, bk) ||
      !fa3::encode_qkv(&mv, v, d, heads, kv_len, batch, vb, vs, vh, bk)) {
    return (int)cudaErrorInvalidValue;
  }
  const fa3::Args a{static_cast<fa3::bf16*>(o), ob, os, oh, sq, d, kv_len,
                    scale * kLog2e};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define CASSMANTLE_FLASH_WGMMA(NP, BK, ST, MC)                              \
  if (np == NP && bk == BK && stages == ST && nc <= MC &&                 \
      (MC == 2 || nc == 3) && boxes == fa3::Geo<NP, BK, ST, MC>::kBoxes &&  \
      ksteps == fa3::Geo<NP, BK, ST, MC>::kSteps) {                       \
    return (int)fa3::launch<NP, BK, ST, MC>(mq, mk, mv, a, nc, grid_x,    \
                                            batch, heads, st);            \
  }
  // (padded head dim, keys a tile, stages, the most consumer warpgroups):
  // ops/_flash_plan.py::INSTANCES; D = 40 and 64 with three consumers and
  // with two (blocks of 128 or 64 query rows)
  CASSMANTLE_FLASH_WGMMA(40, 128, 3, 3)
  CASSMANTLE_FLASH_WGMMA(40, 128, 3, 2)
  CASSMANTLE_FLASH_WGMMA(64, 128, 3, 3)
  CASSMANTLE_FLASH_WGMMA(64, 128, 3, 2)
  CASSMANTLE_FLASH_WGMMA(80, 128, 2, 2)
  CASSMANTLE_FLASH_WGMMA(160, 64, 3, 2)
#undef CASSMANTLE_FLASH_WGMMA
  return (int)cudaErrorInvalidValue;
}
