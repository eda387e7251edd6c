// Implicit-GEMM mainloop shared by the port's conv3x3 and int8 kernels
// (fused_conv.cu, int8_gemm.cu), for Hopper (sm_90a).
//
// out (M, N) = A (M, K) . B (N, K)^T with three ways to read A:
//   kMatmulS8   A is an int8 (M, K) matrix;                  B (N, K) int8
//   kConvS8     A is the int8 im2col of an NHWC image, read  B (F, 3, 3, C)
//               in place: K = 9 taps x C channels, a tap     int8 (OHWI)
//               outside the image reads zeros (SAME border)
//   kConvBf16Gn the same over a bf16 image, with the         B (F, 3, 3, C)
//               GroupNorm affine and SiLU applied on the     bf16
//               way in: silu(x * a[n, c] + b[n, c]) in fp32,
//               rounded to bf16; the border stays zero
// The activated (or im2col) tensor never reaches device memory.
//
// One block computes a BM x BN = 128 x 128 tile with 8 warps (4 along M x
// 2 along N, 32 x 64 each) on the tensor cores with mma.sync: m16n8k16
// bf16 -> fp32, or m16n8k32 s8 -> s32, fed by ldmatrix. K advances in
// tiles of 64 bytes (32 bf16 or 64 int8 values of one tap); B, and the
// int8 A, are double buffered in shared memory by cp.async with zero
// fill. Rows of 64 bytes sit at an 80-byte pitch, so the 8 rows that one
// ldmatrix phase reads fall in distinct bank groups.
//
// kConvBf16Gn (gn_conv_kernel) tiles M by whole image rows instead: a
// block owns TH rows of one image (TH x W <= 128 pixels). For each chunk
// of 32 channels it loads the TH + 2 rows around them, with a one-pixel
// halo, activates them once into shared memory (zero outside the image)
// and runs the nine taps against that one tile: ldmatrix takes a row
// address per lane, so each tap reads its shifted pixels in place. The
// activation then costs (TH + 2)(W + 2) / (TH W) of one pass over x per
// chunk, not nine.
//
// Split K: where the (M, N) tiles leave the 132 SMs idle, blockIdx.z
// takes a slice of the K tiles and writes its raw sums to a workspace;
// a second kernel sums the slices in order (int32 exactly; fp32 in a
// fixed order) and applies the epilogue. Epilogues round each step on
// its own (__fmul_rn, __fadd_rn), as the plain versions do:
//   kMatmulS8   acc * row_scale[m * row_stride] * col_scale[n] + bias[n]
//   kConvS8     acc * col_scale[n] + bias[n]
//   kConvBf16Gn acc + bias[n]
// then a cast to bf16 or fp32.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace igemm {

typedef __nv_bfloat16 bf16;

constexpr int BM = 128;
constexpr int BN = 128;
constexpr int BKB = 64;          // K-tile width in bytes
constexpr int PITCH = BKB + 16;  // shared row pitch in bytes
constexpr int THREADS = 256;

enum Mode { kMatmulS8 = 0, kConvS8 = 1, kConvBf16Gn = 2 };

struct Params {
  const void* x;            // A: (M, K) int8 or NHWC image
  const void* w;            // B: (N, K) int8 or (F, 3, 3, C)
  const float* gn_a;        // (batch, C) fp32 GroupNorm affine (kConvBf16Gn)
  const float* gn_b;
  const float* row_scale;   // kMatmulS8: one per row, or one (stride 0)
  long long row_stride;
  const float* col_scale;   // (N,) kMatmulS8, kConvS8
  const float* bias;        // (N,) fp32, or null for zero
  void* out;                // (M, N) bf16 or fp32
  int out_bf16;
  void* ws;                 // (splits, M, N) raw sums when split
  int m, n;
  int k;                    // kMatmulS8: K; conv: C
  int img_h, img_w;         // conv image height and width
  int th;                   // gn_conv_kernel: image rows per block
  int k_tiles;              // K tiles in all
  int tiles_per_split;
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

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::);
}

__device__ __forceinline__ void cp_async_wait_one() {
  asm volatile("cp.async.wait_group 1;\n" ::);
}

__device__ __forceinline__ void ldsm_x4(uint32_t* r, const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

// c += a (16 x 32 bytes of K, row) * b (32 bytes of K x 8, col)
__device__ __forceinline__ void mma(float* c, const uint32_t* a, uint32_t b0,
                                    uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void mma(int* c, const uint32_t* a, uint32_t b0,
                                    uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

template <int MODE>
struct Traits {
  static constexpr int kElem = MODE == kConvBf16Gn ? 2 : 1;  // bytes
  static constexpr int kChunk = 16 / kElem;  // values per 16-byte chunk
  static constexpr int kTile = BKB / kElem;  // values per K tile
  static constexpr bool kConv = MODE != kMatmulS8;
  typedef typename std::conditional<MODE == kConvBf16Gn, float, int>::type Acc;
};

template <int MODE>
__device__ __forceinline__ float epilogue(const Params& p,
                                          typename Traits<MODE>::Acc v,
                                          int row, int col) {
  const float bias = p.bias ? p.bias[col] : 0.f;
  if constexpr (MODE == kMatmulS8) {
    float r = __fmul_rn(__int2float_rn(v), p.row_scale[row * p.row_stride]);
    r = __fmul_rn(r, p.col_scale[col]);
    return __fadd_rn(r, bias);
  } else if constexpr (MODE == kConvS8) {
    return __fadd_rn(__fmul_rn(__int2float_rn(v), p.col_scale[col]), bias);
  } else {
    return __fadd_rn(v, bias);
  }
}

__device__ __forceinline__ void store1(const Params& p, long long idx,
                                       float v) {
  if (p.out_bf16) {
    static_cast<bf16*>(p.out)[idx] = __float2bfloat16_rn(v);
  } else {
    static_cast<float*>(p.out)[idx] = v;
  }
}

// Two neighbouring columns (col even); pair stores when N is even.
template <int MODE>
__device__ __forceinline__ void store_pair(const Params& p, int row, int col,
                                           typename Traits<MODE>::Acc v0,
                                           typename Traits<MODE>::Acc v1) {
  if (row >= p.m || col >= p.n) return;
  const long long idx = (long long)row * p.n + col;
  const float e0 = epilogue<MODE>(p, v0, row, col);
  if (col + 1 >= p.n) {
    store1(p, idx, e0);
    return;
  }
  const float e1 = epilogue<MODE>(p, v1, row, col + 1);
  if (p.n % 2) {
    store1(p, idx, e0);
    store1(p, idx + 1, e1);
  } else if (p.out_bf16) {
    *reinterpret_cast<__nv_bfloat162*>(static_cast<bf16*>(p.out) + idx) =
        __floats2bfloat162_rn(e0, e1);
  } else {
    *reinterpret_cast<float2*>(static_cast<float*>(p.out) + idx) =
        make_float2(e0, e1);
  }
}

// silu(x * a + b) of 8 bf16 values in fp32 (fast exp and divide, a few
// fp32 ulps from the exact function), rounded to bf16.
__device__ __forceinline__ uint4 gn_silu8(uint4 raw, const float* av,
                                          const float* bv) {
  const __nv_bfloat162* xv = reinterpret_cast<const __nv_bfloat162*>(&raw);
  uint4 res;
  __nv_bfloat162* rv = reinterpret_cast<__nv_bfloat162*>(&res);
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const float2 f = __bfloat1622float2(xv[j]);
    float u = __fadd_rn(__fmul_rn(f.x, av[2 * j]), bv[2 * j]);
    float v = __fadd_rn(__fmul_rn(f.y, av[2 * j + 1]), bv[2 * j + 1]);
    u = __fdividef(u, __fadd_rn(1.f, __expf(-u)));
    v = __fdividef(v, __fadd_rn(1.f, __expf(-v)));
    rv[j] = __floats2bfloat162_rn(u, v);
  }
  return res;
}

template <int MODE>
__global__ void __launch_bounds__(THREADS, 2) igemm_kernel(Params p) {
  static_assert(MODE != kConvBf16Gn, "kConvBf16Gn runs gn_conv_kernel");
  using Tr = Traits<MODE>;
  using Acc = typename Tr::Acc;
  __shared__ __align__(128) unsigned char As[2][BM * PITCH];
  __shared__ __align__(128) unsigned char Bs[2][BN * PITCH];

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int wm = warp & 3;   // 32-row slice of the tile
  const int wn = warp >> 2;  // 64-column slice
  const int m0 = blockIdx.x * BM;
  const int n0 = blockIdx.y * BN;
  const int kt0 = blockIdx.z * p.tiles_per_split;
  const int kt1 = min(p.k_tiles, kt0 + p.tiles_per_split);
  const int cc = tid & 3;    // this thread's 16-byte chunk of a K tile row
  const int r0 = tid >> 2;   // ... in rows r0 and r0 + 64
  // K tiles per tap (conv): ceil(C / values per tile)
  const int tpt = Tr::kConv ? (p.k + Tr::kTile - 1) / Tr::kTile : 1;

  const unsigned char* xb = static_cast<const unsigned char*>(p.x);
  const unsigned char* wb = static_cast<const unsigned char*>(p.w);

  // this thread's A rows: output pixel (batch, y, x) or matrix row
  int pn[2], py[2], px[2];
  bool pv[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int m = m0 + r0 + 64 * i;
    pv[i] = m < p.m;
    if (Tr::kConv) {
      const int hw = p.img_h * p.img_w;
      pn[i] = m / hw;
      const int rem = m - pn[i] * hw;
      py[i] = rem / p.img_w;
      px[i] = rem - py[i] * p.img_w;
    } else {
      pn[i] = m;
      py[i] = px[i] = 0;
    }
  }

  // (source, valid, channel) of A row i and B row i in K tile kt
  auto a_src = [&](int i, int kt, bool& ok, int& c) -> const unsigned char* {
    if (Tr::kConv) {
      const int tap = kt / tpt;
      c = (kt - tap * tpt) * Tr::kTile + cc * Tr::kChunk;
      const int yy = py[i] + tap / 3 - 1;
      const int xx = px[i] + tap % 3 - 1;
      ok = pv[i] && c < p.k && yy >= 0 && yy < p.img_h && xx >= 0 &&
           xx < p.img_w;
      const long long pix = ((long long)pn[i] * p.img_h + yy) * p.img_w + xx;
      return ok ? xb + (pix * p.k + c) * Tr::kElem : xb;
    } else {
      c = kt * BKB + cc * 16;
      ok = pv[i] && c < p.k;
      return ok ? xb + (long long)pn[i] * p.k + c : xb;
    }
  };
  auto load_b = [&](int kt, int buf) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int f = n0 + r0 + 64 * i;
      const unsigned char* src = wb;
      bool ok;
      if (Tr::kConv) {
        const int tap = kt / tpt;
        const int c = (kt - tap * tpt) * Tr::kTile + cc * Tr::kChunk;
        ok = f < p.n && c < p.k;
        if (ok) src = wb + (((long long)f * 9 + tap) * p.k + c) * Tr::kElem;
      } else {
        const int c = kt * BKB + cc * 16;
        ok = f < p.n && c < p.k;
        if (ok) src = wb + (long long)f * p.k + c;
      }
      cp_async16(Bs[buf] + (r0 + 64 * i) * PITCH + cc * 16, src, ok);
    }
  };
  auto load_a_async = [&](int kt, int buf) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      bool ok;
      int c;
      const unsigned char* src = a_src(i, kt, ok, c);
      cp_async16(As[buf] + (r0 + 64 * i) * PITCH + cc * 16, src, ok);
    }
  };
  Acc acc[2][8][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0;

  if (kt0 < kt1) {
    load_b(kt0, 0);
    load_a_async(kt0, 0);
    cp_async_commit();
    cp_async_wait_all();
    __syncthreads();
  }
  for (int kt = kt0; kt < kt1; ++kt) {
    const int buf = (kt - kt0) & 1;
    const bool more = kt + 1 < kt1;
    if (more) {
      load_b(kt + 1, buf ^ 1);
      load_a_async(kt + 1, buf ^ 1);
    }
    cp_async_commit();
    const unsigned char* as = As[buf];
    const unsigned char* bs = Bs[buf];
#pragma unroll
    for (int ks = 0; ks < 2; ++ks) {  // 32 bytes of K per mma
      uint32_t af[2][4];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        ldsm_x4(af[i], as + (wm * 32 + i * 16 + (lane & 15)) * PITCH +
                           ks * 32 + (lane >> 4) * 16);
      }
#pragma unroll
      for (int j = 0; j < 8; j += 2) {
        uint32_t bfr[4];
        ldsm_x4(bfr, bs + (wn * 64 + j * 8 + (lane & 7) + ((lane >> 4) << 3)) *
                              PITCH +
                          ks * 32 + ((lane >> 3) & 1) * 16);
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          mma(acc[i][j], af[i], bfr[0], bfr[1]);
          mma(acc[i][j + 1], af[i], bfr[2], bfr[3]);
        }
      }
    }
    cp_async_wait_all();
    __syncthreads();
  }

  const int g = lane >> 2;
  const int t = lane & 3;
  const bool split = gridDim.z > 1;
  Acc* ws = split ? static_cast<Acc*>(p.ws) + (long long)blockIdx.z * p.m * p.n
                  : nullptr;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int hlf = 0; hlf < 2; ++hlf) {
        const int row = m0 + wm * 32 + i * 16 + g + 8 * hlf;
        const int col = n0 + wn * 64 + j * 8 + 2 * t;
        const Acc v0 = acc[i][j][2 * hlf];
        const Acc v1 = acc[i][j][2 * hlf + 1];
        if (!split) {
          store_pair<MODE>(p, row, col, v0, v1);
        } else if (row < p.m && col < p.n) {
          Acc* dst = ws + (long long)row * p.n + col;
          dst[0] = v0;
          if (col + 1 < p.n) dst[1] = v1;
        }
      }
    }
  }
}

// Halo rows of gn_conv_kernel: (TH + 2) x (W + 2) for TH x W <= 128,
// TH <= 64 and W <= 64 is at most 264 (W = 2 or W = 64).
constexpr int kHaloRows = 264;
constexpr int kHaloLoads = (kHaloRows * 4 + THREADS - 1) / THREADS;

// kConvBf16Gn: blockIdx.x = (image, group of p.th rows); K tile kt is
// channel chunk kt / 9 at tap kt % 9, so one halo tile serves nine.
__global__ void __launch_bounds__(THREADS, 2) gn_conv_kernel(Params p) {
  constexpr int MODE = kConvBf16Gn;
  __shared__ __align__(128) unsigned char Hs[kHaloRows * PITCH];
  __shared__ __align__(128) unsigned char Bs[2][BN * PITCH];

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int wm = warp & 3;
  const int wn = warp >> 2;
  const int groups = (p.img_h + p.th - 1) / p.th;
  const int n = blockIdx.x / groups;
  const int y0 = (blockIdx.x - n * groups) * p.th;
  const int n0 = blockIdx.y * BN;
  const int kt0 = blockIdx.z * p.tiles_per_split;
  const int kt1 = min(p.k_tiles, kt0 + p.tiles_per_split);
  const int cc = tid & 3;
  const int r0 = tid >> 2;
  const int hw2 = p.img_w + 2;                     // halo row length
  const int rows = min(p.th, p.img_h - y0);        // image rows of the tile
  const int m_valid = rows * p.img_w;              // valid tile rows
  const int h_rows = (rows + 2) * hw2;             // halo positions

  const bf16* x = static_cast<const bf16*>(p.x);
  const unsigned char* wb = static_cast<const unsigned char*>(p.w);

  // this lane's halo position of its two ldmatrix rows at tap (0, 0);
  // rows past the tile read halo row 0 and are never stored
  int hbase[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = wm * 32 + i * 16 + (lane & 15);
    hbase[i] = r < m_valid ? (r / p.img_w) * hw2 + r % p.img_w : 0;
  }

  auto build_halo = [&](int chunk) {
    const int c = chunk * 32 + cc * 8;
    const bool c_ok = c < p.k;
    float av[8], bv[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      av[j] = c_ok ? p.gn_a[(long long)n * p.k + c + j] : 0.f;
      bv[j] = c_ok ? p.gn_b[(long long)n * p.k + c + j] : 0.f;
    }
    uint4 raw[kHaloLoads];
    bool ok[kHaloLoads];
#pragma unroll
    for (int j = 0; j < kHaloLoads; ++j) {
      const int pos = (tid + j * THREADS) >> 2;
      const int hy = pos / hw2 - 1 + y0;
      const int hx = pos % hw2 - 1;
      ok[j] = pos < h_rows && c_ok && hy >= 0 && hy < p.img_h && hx >= 0 &&
              hx < p.img_w;
      raw[j] = make_uint4(0, 0, 0, 0);
      if (ok[j]) {
        const long long pix = ((long long)n * p.img_h + hy) * p.img_w + hx;
        raw[j] = __ldg(reinterpret_cast<const uint4*>(x + pix * p.k + c));
      }
    }
#pragma unroll
    for (int j = 0; j < kHaloLoads; ++j) {
      const int pos = (tid + j * THREADS) >> 2;
      if (pos < h_rows) {
        *reinterpret_cast<uint4*>(Hs + pos * PITCH + cc * 16) =
            ok[j] ? gn_silu8(raw[j], av, bv) : make_uint4(0, 0, 0, 0);
      }
    }
  };
  auto load_b = [&](int kt, int buf) {
    const int tap = kt % 9;
    const int c = (kt / 9) * 32 + cc * 8;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int f = n0 + r0 + 64 * i;
      const bool ok = f < p.n && c < p.k;
      const unsigned char* src =
          ok ? wb + (((long long)f * 9 + tap) * p.k + c) * 2 : wb;
      cp_async16(Bs[buf] + (r0 + 64 * i) * PITCH + cc * 16, src, ok);
    }
  };

  float acc[2][8][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

  if (kt0 < kt1) {
    load_b(kt0, 0);
    cp_async_commit();
  }
  for (int kt = kt0; kt < kt1; ++kt) {
    const int buf = (kt - kt0) & 1;
    const int tap = kt % 9;
    if (kt == kt0 || tap == 0) build_halo(kt / 9);
    if (kt + 1 < kt1) load_b(kt + 1, buf ^ 1);
    cp_async_commit();
    cp_async_wait_one();  // B of this tile has landed
    __syncthreads();      // ... and the halo stores are visible
    const int off = (tap / 3) * hw2 + tap % 3;
    const unsigned char* bs = Bs[buf];
#pragma unroll
    for (int ks = 0; ks < 2; ++ks) {
      uint32_t af[2][4];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        ldsm_x4(af[i], Hs + (hbase[i] + off) * PITCH + ks * 32 +
                           (lane >> 4) * 16);
      }
#pragma unroll
      for (int j = 0; j < 8; j += 2) {
        uint32_t bfr[4];
        ldsm_x4(bfr, bs + (wn * 64 + j * 8 + (lane & 7) + ((lane >> 4) << 3)) *
                              PITCH +
                          ks * 32 + ((lane >> 3) & 1) * 16);
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          mma(acc[i][j], af[i], bfr[0], bfr[1]);
          mma(acc[i][j + 1], af[i], bfr[2], bfr[3]);
        }
      }
    }
    __syncthreads();  // done with this B buffer and, at a chunk's end,
                      // the halo
  }

  const int g = lane >> 2;
  const int t = lane & 3;
  const bool split = gridDim.z > 1;
  float* ws = split ? static_cast<float*>(p.ws) +
                          (long long)blockIdx.z * p.m * p.n
                    : nullptr;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
#pragma unroll
    for (int hlf = 0; hlf < 2; ++hlf) {
      const int r = wm * 32 + i * 16 + g + 8 * hlf;
      if (r >= m_valid) continue;
      const int row =
          (n * p.img_h + y0 + r / p.img_w) * p.img_w + r % p.img_w;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int col = n0 + wn * 64 + j * 8 + 2 * t;
        const float v0 = acc[i][j][2 * hlf];
        const float v1 = acc[i][j][2 * hlf + 1];
        if (!split) {
          store_pair<MODE>(p, row, col, v0, v1);
        } else if (col < p.n) {
          float* dst = ws + (long long)row * p.n + col;
          dst[0] = v0;
          if (col + 1 < p.n) dst[1] = v1;
        }
      }
    }
  }
}

// Sum the split-K slices in order and apply the epilogue.
template <int MODE>
__global__ void splitk_reduce(Params p, int splits) {
  using Acc = typename Traits<MODE>::Acc;
  const long long total = (long long)p.m * p.n;
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= total) return;
  const Acc* ws = static_cast<const Acc*>(p.ws);
  Acc s = ws[idx];
  for (int sp = 1; sp < splits; ++sp) s += ws[sp * total + idx];
  const int row = static_cast<int>(idx / p.n);
  const int col = static_cast<int>(idx - (long long)row * p.n);
  store1(p, idx, epilogue<MODE>(p, s, row, col));
}

template <int MODE>
cudaError_t run(Params p, int splits, cudaStream_t stream) {
  if (p.m < 1 || p.n < 1 || p.k < 1 || splits < 1 || splits > 65535 ||
      (splits > 1 && p.ws == nullptr)) {
    return cudaErrorInvalidValue;
  }
  p.tiles_per_split = (p.k_tiles + splits - 1) / splits;
  if constexpr (MODE == kConvBf16Gn) {
    // whole image rows per block: TH x W <= 128 pixels, halo in kHaloRows
    if (p.img_w > 64) return cudaErrorInvalidValue;
    p.th = min(min(p.img_h, 64), max(1, BM / p.img_w));
    const int groups = (p.img_h + p.th - 1) / p.th;
    const dim3 grid(p.m / (p.img_h * p.img_w) * groups, (p.n + BN - 1) / BN,
                    splits);
    if (grid.y > 65535 || (p.th + 2) * (p.img_w + 2) > kHaloRows) {
      return cudaErrorInvalidValue;
    }
    gn_conv_kernel<<<grid, THREADS, 0, stream>>>(p);
  } else {
    const dim3 grid((p.m + BM - 1) / BM, (p.n + BN - 1) / BN, splits);
    if (grid.y > 65535) return cudaErrorInvalidValue;
    igemm_kernel<MODE><<<grid, THREADS, 0, stream>>>(p);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return err;
  const long long total = (long long)p.m * p.n;
  const int threads = 256;
  splitk_reduce<MODE><<<(unsigned)((total + threads - 1) / threads), threads,
                        0, stream>>>(p, splits);
  return cudaGetLastError();
}

}  // namespace igemm
