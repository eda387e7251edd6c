// Flash attention forward for Hopper (sm_90a), bf16 in and out.
//
// Replaces: cassmantle_tpu/ops/flash_attention.py::_flash_kernel (reached
// through _flash_bhsd, flash_attention, flash_cross_attention and the
// wide-head VAE dispatch). It computes softmax(q k^T * scale) v by online
// softmax with the same arithmetic: fp32 scores, fp32 running max,
// denominator and accumulator; p is rounded to bf16 before p.v; columns at
// or past kv_len get -1e30 before the softmax; out = acc / l.
//
// One kernel serves the three modes of the serving path:
//   - self attention over image tokens (SD1.5-512 with CFG: B=2, H=8,
//     (S, D) = (4096, 40), (1024, 80), (256, 160), (64, 160));
//   - ragged cross attention over the 77-token CLIP context: key tiles
//     past kv_len are never loaded, and the ragged edge of the last tile
//     is masked here, so K/V need no padding in memory;
//   - the wide head of the VAE mid block (B=1, H=1, S=4096, D=512).
//
// What bounds it (bf16, H100 SXM: 989 TFLOP/s, 3.35 TB/s; 4*B*H*Sq*Sk*D
// FLOPs, q, k, v, o bytes once each): self attention at level 0 of the
// UNet (42.9 GFLOP, 21 MB) and the VAE mid block (34.4 GFLOP) are
// compute-bound, about 43 and 35 us; level 2 self attention and every
// cross attention are memory-bound, a few microseconds each.
//
// What the design does about it: the (Sq, Sk) score matrix never reaches
// device memory, and neither scores nor the accumulator touch shared
// memory. One block owns BQ query rows of one (batch, head) and walks the
// key tiles; q, k and v are read once per block straight from the
// caller's strided (B, S, H, D) views (the fused qkv projection's output
// splits without a copy). K/V tiles are double-buffered in shared memory
// with cp.async, so the next tile's load overlaps this tile's math. Both
// products run on the tensor cores with mma.sync m16n8k16 (bf16 x bf16 ->
// fp32) fed by ldmatrix; each warp owns 16 query rows and keeps its
// scores, probabilities (FA2's register reuse: the score accumulator
// becomes the A operand of p.v), running max, denominator and output
// accumulator in registers, so the softmax needs only quad shuffles.
// Head dims pad to a multiple of 16 in shared memory (zero columns add
// nothing to q.k and are never stored). Wide heads split D across WD
// warps per row group, which exchange partial scores through shared
// memory, so D = 512 keeps 64 accumulator registers a thread. Not yet
// used: TMA, wgmma and warp specialisation, the levers left for closing
// the gap to the bound.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

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
// past kv_len (1 <= kv_len <= Sk) are masked. Returns a cudaError_t.
extern "C" int cassmantle_flash_attention_bf16(
    const void* q, const void* k, const void* v, void* o, int batch,
    int heads, int sq, int d, int kv_len, float scale, long long qb,
    long long qs, long long qh, long long kb, long long ks, long long kh,
    long long vb, long long vs, long long vh, long long ob, long long os,
    long long oh, void* stream) {
  if (batch < 1 || heads < 1 || sq < 1 || kv_len < 1 || d < 1 || d > 512 ||
      batch > 65535 || heads > 65535) {
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
  if (d <= DP) {                                                            \
    return (int)launch<DP, BQ, BK, WD>(qp, kp, vp, op, batch, heads, sq, d, \
                                       kv_len, scale, qst, kst, vst, ost,   \
                                       vec, st);                            \
  }
  // Padded widths: the main path's D = 40, 80, 160, 512, plus 32 and 256
  // for other head dims (each one held against the plain version).
  CASSMANTLE_FLASH_CASE(32, 64, 64, 1)
  CASSMANTLE_FLASH_CASE(48, 64, 64, 1)
  CASSMANTLE_FLASH_CASE(80, 64, 64, 1)
  CASSMANTLE_FLASH_CASE(160, 64, 32, 1)
  CASSMANTLE_FLASH_CASE(256, 64, 32, 2)
  CASSMANTLE_FLASH_CASE(512, 32, 32, 4)
#undef CASSMANTLE_FLASH_CASE
  return (int)cudaErrorInvalidValue;
}
