// Implicit-GEMM int8 conv3x3 on mma.sync for Hopper (sm_90a): the W8A8
// conv of int8_gemm.cu (kernel 4).
//
// out (M, F) = A (M, K) . B (F, K)^T with A the int8 im2col of an NHWC
// image, read in place: M = B*H*W pixels, K = 9 taps x C channels, a tap
// outside the image reads zeros (SAME border); B the (F, 3, 3, C) int8
// weight (OHWI). The im2col never reaches device memory.
//
// One block computes a BM x BN = 128 x 128 tile with 8 warps (4 along M x
// 2 along N, 32 x 64 each) on the tensor cores with mma.sync m16n8k32
// s8 -> s32, fed by ldmatrix. K advances in tiles of 64 bytes (64
// channels of one tap); A and B are double buffered in shared memory by
// cp.async with zero fill. Rows of 64 bytes sit at an 80-byte pitch, so
// the 8 rows that one ldmatrix phase reads fall in distinct bank groups.
//
// Split K: where the (M, N) tiles leave the 132 SMs idle, blockIdx.z
// takes a slice of the K tiles and writes its raw int32 sums to a
// workspace; a second kernel sums the slices and applies the epilogue
// acc * col_scale[n] + bias[n], each step rounded on its own (__fmul_rn,
// __fadd_rn) as the plain version does, then a cast to bf16 or fp32.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace igemm {

typedef __nv_bfloat16 bf16;

constexpr int BM = 128;
constexpr int BN = 128;
constexpr int BKB = 64;          // K-tile width in bytes (int8 channels)
constexpr int PITCH = BKB + 16;  // shared row pitch in bytes
constexpr int THREADS = 256;

struct Params {
  const void* x;            // A: NHWC int8 image
  const void* w;            // B: (F, 3, 3, C) int8
  const float* col_scale;   // (F,)
  const float* bias;        // (F,) fp32
  void* out;                // (M, F) bf16 or fp32
  int out_bf16;
  void* ws;                 // (splits, M, F) int32 raw sums when split
  int m, n;
  int k;                    // C
  int img_h, img_w;
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

__device__ __forceinline__ void ldsm_x4(uint32_t* r, const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

// c += a (16 x 32 bytes of K, row) * b (32 bytes of K x 8, col)
__device__ __forceinline__ void mma(int* c, const uint32_t* a, uint32_t b0,
                                    uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ float epilogue(const Params& p, int v, int col) {
  const float bias = p.bias ? p.bias[col] : 0.f;
  return __fadd_rn(__fmul_rn(__int2float_rn(v), p.col_scale[col]), bias);
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
__device__ __forceinline__ void store_pair(const Params& p, int row, int col,
                                           int v0, int v1) {
  if (row >= p.m || col >= p.n) return;
  const long long idx = (long long)row * p.n + col;
  const float e0 = epilogue(p, v0, col);
  if (col + 1 >= p.n) {
    store1(p, idx, e0);
    return;
  }
  const float e1 = epilogue(p, v1, col + 1);
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

__global__ void __launch_bounds__(THREADS, 2) int8_conv_kernel(Params p) {
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
  const int tpt = (p.k + BKB - 1) / BKB;  // K tiles per tap

  const unsigned char* xb = static_cast<const unsigned char*>(p.x);
  const unsigned char* wb = static_cast<const unsigned char*>(p.w);

  // this thread's A rows: output pixel (batch, y, x)
  int pn[2], py[2], px[2];
  bool pv[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int m = m0 + r0 + 64 * i;
    pv[i] = m < p.m;
    const int hw = p.img_h * p.img_w;
    pn[i] = m / hw;
    const int rem = m - pn[i] * hw;
    py[i] = rem / p.img_w;
    px[i] = rem - py[i] * p.img_w;
  }

  auto load_b = [&](int kt, int buf) {
    const int tap = kt / tpt;
    const int c = (kt - tap * tpt) * BKB + cc * 16;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int f = n0 + r0 + 64 * i;
      const bool ok = f < p.n && c < p.k;
      const unsigned char* src =
          ok ? wb + ((long long)f * 9 + tap) * p.k + c : wb;
      cp_async16(Bs[buf] + (r0 + 64 * i) * PITCH + cc * 16, src, ok);
    }
  };
  auto load_a = [&](int kt, int buf) {
    const int tap = kt / tpt;
    const int c = (kt - tap * tpt) * BKB + cc * 16;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int yy = py[i] + tap / 3 - 1;
      const int xx = px[i] + tap % 3 - 1;
      const bool ok = pv[i] && c < p.k && yy >= 0 && yy < p.img_h &&
                      xx >= 0 && xx < p.img_w;
      const long long pix = ((long long)pn[i] * p.img_h + yy) * p.img_w + xx;
      cp_async16(As[buf] + (r0 + 64 * i) * PITCH + cc * 16,
                 ok ? xb + pix * p.k + c : xb, ok);
    }
  };
  int acc[2][8][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0;

  if (kt0 < kt1) {
    load_b(kt0, 0);
    load_a(kt0, 0);
    cp_async_commit();
    cp_async_wait_all();
    __syncthreads();
  }
  for (int kt = kt0; kt < kt1; ++kt) {
    const int buf = (kt - kt0) & 1;
    if (kt + 1 < kt1) {
      load_b(kt + 1, buf ^ 1);
      load_a(kt + 1, buf ^ 1);
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
  int* ws = split ? static_cast<int*>(p.ws) + (long long)blockIdx.z * p.m * p.n
                  : nullptr;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int hlf = 0; hlf < 2; ++hlf) {
        const int row = m0 + wm * 32 + i * 16 + g + 8 * hlf;
        const int col = n0 + wn * 64 + j * 8 + 2 * t;
        const int v0 = acc[i][j][2 * hlf];
        const int v1 = acc[i][j][2 * hlf + 1];
        if (!split) {
          store_pair(p, row, col, v0, v1);
        } else if (row < p.m && col < p.n) {
          int* dst = ws + (long long)row * p.n + col;
          dst[0] = v0;
          if (col + 1 < p.n) dst[1] = v1;
        }
      }
    }
  }
}

// Sum the split-K slices (int32, exact) and apply the epilogue.
__global__ void int8_conv_splitk_reduce(Params p, int splits) {
  const long long total = (long long)p.m * p.n;
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= total) return;
  const int* ws = static_cast<const int*>(p.ws);
  int s = ws[idx];
  for (int sp = 1; sp < splits; ++sp) s += ws[sp * total + idx];
  const int col = static_cast<int>(idx % p.n);
  store1(p, idx, epilogue(p, s, col));
}

inline cudaError_t run_conv(Params p, int splits, cudaStream_t stream) {
  if (p.m < 1 || p.n < 1 || p.k < 1 || splits < 1 || splits > 65535 ||
      (splits > 1 && p.ws == nullptr)) {
    return cudaErrorInvalidValue;
  }
  p.tiles_per_split = (p.k_tiles + splits - 1) / splits;
  const dim3 grid((p.m + BM - 1) / BM, (p.n + BN - 1) / BN, splits);
  if (grid.y > 65535) return cudaErrorInvalidValue;
  int8_conv_kernel<<<grid, THREADS, 0, stream>>>(p);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return err;
  const long long total = (long long)p.m * p.n;
  const int threads = 256;
  int8_conv_splitk_reduce<<<(unsigned)((total + threads - 1) / threads),
                            threads, 0, stream>>>(p, splits);
  return cudaGetLastError();
}

}  // namespace igemm
