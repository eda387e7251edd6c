// Fused GroupNorm affine + SiLU + conv3x3 for Hopper (sm_90a), bf16.
//
// Replaces: cassmantle_tpu/ops/fused_conv.py::_fused_kernel (reached
// through _fused_bhwc and gn_silu_conv3x3). It computes
//     out = conv3x3(silu(x * a + b)) + bias
// over an NHWC bf16 image (stride 1, SAME zero padding of the activated
// tensor), with the per-(batch, channel) fp32 GroupNorm affine a, b: the
// affine and SiLU in fp32 (SiLU through tanh.approx, relative error
// about 2^-11, under a bf16 half-ulp), rounded to bf16, products
// accumulated in fp32, the bias added in fp32 and the sum rounded to
// bf16, as the Pallas kernel does.
// The TPU path's channel padding (pad_to) is not needed: TMA zero-fills
// the channels of the last 64-channel chunk past C (C % 8 == 0).
//
// What bounds it (bf16, H100 SXM: 989 TFLOP/s, 3.35 TB/s; 18*M*C*F FLOPs
// for M = B*H*W pixels; x, the weight and the output once each): the
// SD1.5-512 UNet's 14 shapes carry 0.6 to 1.9 GFLOP on 1.5 to 59 MB, so
// the 64x64 to 16x16 levels are compute-bound (8 to 46 us at the peak)
// and the 8x8 levels, whose 2560 x 1280 weights dominate the bytes, are
// memory-bound (9 and 18 us). The VAE decoder's 28 ResBlock convs (W = 64
// to 512 at SD1.5, to 1024 at SDXL; C and F 128 to 512) carry 19 to 155
// GFLOP each and are all compute-bound (20 to 156 us at the peak).
//
// What the design does about it (on hopper.cuh), one launch per call:
// - The activated tensor never reaches device memory. A block owns a
//   pixel tile of at most 128 pixels and BN output channels (160; 128
//   where 128 divides F and 160 does not, as at the VAE's F = 128, 256
//   and 512, which 160-wide blocks would fill to 80%): TH rows of
//   a TW-column stretch of one image (TW = W up to 64, whole rows; past
//   64, 2 rows of a 64-column stretch, the last stretch ragged), or
//   whole images packed. For each 64-channel chunk, TMA brings the raw
//   (TH + 2) x (TW + 2) halo of x, its box starting one row and one
//   column before the tile and zero outside the tensor, into shared
//   memory; seven builder warps activate it once into one of two halo
//   buffers (positions outside the image are written as zeros, never
//   activated), one chunk ahead of the products. A stretch's halo is
//   (2 + 2)(64 + 2) = 264 positions, the W = 64 tile's, so one shared-
//   memory layout serves every width; each stretch re-reads the two
//   columns it shares with its neighbours (1/32 more x).
//   SiLU takes one MUFU op: silu(u) = h + h tanh(h), h = u / 2, with
//   tanh.approx (the activation would otherwise bound the 64x64 level).
// - Two consumer warpgroups (64 pixels each) gather A with ldmatrix from
//   the activated halo, each lane at its pixel's shifted position for
//   each of the nine taps, and issue wgmma m64nBNk16 with A in
//   registers; the two warpgroups' gathers and products interleave. B,
//   the weight, streams through a 4-stage ring of 128-byte-swizzled TMA
//   tiles over the OHWI weight viewed as (F, 9, C), issued by one
//   producer thread against full/empty mbarriers. setmaxnreg moves
//   registers from the two producer warpgroups (96) to the consumers
//   (160).
// - Where the tiles are too few for the card (the 32x32 and smaller
//   levels), a thread-block cluster of 2 to 8 blocks splits the channel
//   chunks; each block leaves its fp32 partial tile in shared memory and
//   the cluster sums it through distributed shared memory in rank order
//   (the same bits on every launch), adds the bias and stores 8 output
//   channels at a time. No workspace, no second kernel.
// What bounds it now: the 16x16 and 8x8 levels stream each 160 x 128 B
// weight tile as 160 separate 128-byte rows (OHWI puts a tap's channels
// 9 C apart), from memory for every pixel group. Not yet used: TMA
// multicast of the weight across the pixel groups of a cluster, a
// persistent grid, an epilogue through TMA stores.

#include <cuda_bf16.h>

#include "hopper.cuh"

namespace gn {

using namespace hopper;
typedef __nv_bfloat16 bf16;

constexpr int CH = 64;             // channels per chunk (128 bytes)
constexpr int STAGES = 4;          // weight ring depth
constexpr int HALO_POS = 264;      // imgs (TH + 2)(TW + 2) at most
constexpr int HPITCH = 144;        // bytes per activated halo position
constexpr int BUILDERS = 224;      // producer warps 1..7: the halo
constexpr int THREADS = 512;       // 2 consumer + 2 producer warpgroups

// Shared memory of the instance with BN output channels a block (160,
// or 128 where 128 divides F and 160 does not): the weight ring of
// BN x 128-byte tiles, the raw halo, two activated halos, the barriers;
// the fp32 partial tile reuses the ring and halos after the mainloop.
template <int BN>
struct Smem {
  static constexpr int B_TILE = BN * 128;   // one weight tile
  static constexpr int RAW_OFF = STAGES * B_TILE;
  static constexpr int HALO_OFF = RAW_OFF + HALO_POS * 128;
  static constexpr int BAR_OFF = HALO_OFF + 2 * HALO_POS * HPITCH;
  static constexpr int BYTES = 1024 + BAR_OFF + 16 * 8;
  static constexpr int PPITCH = BN + 4;     // floats a partial-tile row
  static_assert(128 * PPITCH * 4 <= BAR_OFF, "partial tile fits");
};

struct Args {
  const float* a;     // (batch, C) GroupNorm affine
  const float* b;
  const float* bias;  // (F,)
  bf16* out;          // (batch, H, W, F)
  int batch, h, w, c, f;
  int th, tw, imgs;   // image rows, columns and images a block
  int chunks;         // ceil(C / 64)
};

__device__ __forceinline__ unsigned char* align1024(unsigned char* p) {
  const uint32_t a = smem_u32(p);
  return p + (((a + 1023) & ~1023u) - a);
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p))
      : "memory");
}

// silu(u) = u / (1 + exp(-u)) = 0.5 u (1 + tanh(u / 2)): one MUFU op.
__device__ __forceinline__ float silu_tanh(float u) {
  const float h = 0.5f * u;
  float t;
  asm("tanh.approx.f32 %0, %1;" : "=f"(t) : "f"(h));
  return __fmaf_rn(h, t, h);
}

// silu(x * a + b) of 8 bf16 values in fp32, rounded to bf16.
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
    u = silu_tanh(u);
    v = silu_tanh(v);
    rv[j] = __floats2bfloat162_rn(u, v);
  }
  return res;
}

// Tile row r (0..127) -> image, row and column in the block's tile;
// false past the tile's valid pixels.
__device__ __forceinline__ bool tile_pixel(const Args& p, int n0, int y0,
                                           int x0, int r, int& img,
                                           int& ry, int& rx) {
  const int per = p.th * p.tw;
  img = r / per;
  const int rr = r - img * per;
  ry = rr / p.tw;
  rx = rr - ry * p.tw;
  return img < p.imgs && n0 + img < p.batch && y0 + ry < p.h &&
         x0 + rx < p.w;
}

// blockIdx.x: pixel group (images n0 .. n0 + imgs - 1, rows y0 .. y0 +
// th - 1, columns x0 .. x0 + tw - 1); blockIdx.y: BN output channels;
// blockIdx.z: this block's share of the channel chunks, its rank in the
// cluster.
template <int BN>
__global__ void __launch_bounds__(THREADS, 1)
    gn_conv_wgmma_kernel(const __grid_constant__ CUtensorMap map_x,
                         const __grid_constant__ CUtensorMap map_w, Args p) {
  constexpr int B_TILE = Smem<BN>::B_TILE;
  constexpr int RAW_OFF = Smem<BN>::RAW_OFF;
  constexpr int HALO_OFF = Smem<BN>::HALO_OFF;
  constexpr int BAR_OFF = Smem<BN>::BAR_OFF;
  constexpr int PPITCH = Smem<BN>::PPITCH;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align1024(smem_raw);
  unsigned char* raw = smem + RAW_OFF;
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + BAR_OFF);
  uint64_t* full = bars;                 // [STAGES] weight tile landed
  uint64_t* empty = bars + STAGES;       // [STAGES] weight tile consumed
  uint64_t* raw_full = bars + 2 * STAGES;
  uint64_t* halo_full = raw_full + 1;    // [2] activated halo ready
  uint64_t* halo_empty = halo_full + 2;  // [2] halo gathered
  float* part = reinterpret_cast<float*>(smem);  // after the mainloop

  const int sx = (p.w + p.tw - 1) / p.tw;  // column stretches a row
  const int gpi = p.imgs > 1 ? 1 : (p.h + p.th - 1) / p.th * sx;
  const int n0 = blockIdx.x / gpi * p.imgs;
  const int gi = blockIdx.x % gpi;
  const int y0 = gi / sx * p.th;
  const int x0 = gi % sx * p.tw;
  const int f0 = blockIdx.y * BN;
  const int slices = gridDim.z;
  const int rank = blockIdx.z;
  const int ch0 = rank * p.chunks / slices;
  const int ch1 = (rank + 1) * p.chunks / slices;
  const int hw2 = p.tw + 2;
  const int npos = p.imgs * (p.th + 2) * hw2;
  const uint32_t raw_bytes = npos * 128;

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      bar_init(&full[s], 1);
      bar_init(&empty[s], 256);
    }
    bar_init(raw_full, 1);
    for (int i = 0; i < 2; ++i) {
      bar_init(&halo_full[i], BUILDERS);
      bar_init(&halo_empty[i], 256);
    }
    bar_init_fence();
  }
  __syncthreads();

  if (threadIdx.x >= 256) {
    regs_dec<96>();  // 2 x 128 x 96 + 2 x 128 x 160 = 512 x 128
    const int pt = threadIdx.x - 256;
    if (pt == 0) {
      // weight tiles: chunk-major, nine taps a chunk
      int it = 0;
      for (int ch = ch0; ch < ch1; ++ch) {
        for (int tap = 0; tap < 9; ++tap, ++it) {
          const int s = it % STAGES;
          if (it >= STAGES) bar_wait(&empty[s], (it / STAGES - 1) & 1);
          bar_expect(&full[s], B_TILE);
          tma_load_3d(smem + s * B_TILE, &map_w, &full[s], ch * CH, tap, f0);
        }
      }
    } else if (pt >= 32) {
      // builders: activate each chunk's halo one chunk ahead
      const int bt = pt - 32;
      const int cc = bt % 8;  // this thread's 8 channels of the chunk
      if (bt == 0 && ch0 < ch1) {
        bar_expect(raw_full, raw_bytes);
        tma_load_4d(raw, &map_x, raw_full, ch0 * CH, x0 - 1, y0 - 1, n0);
      }
      for (int ch = ch0, jl = 0; ch < ch1; ++ch, ++jl) {
        const int hb = jl & 1;
        unsigned char* hs = smem + HALO_OFF + hb * HALO_POS * HPITCH;
        const int c = ch * CH + cc * 8;
        bar_wait(raw_full, jl & 1);
        if (jl >= 2) bar_wait(&halo_empty[hb], (jl / 2 - 1) & 1);
        float av[8], bv[8];
        int cur = -1;
        // this thread's positions bt / 8 + k * BUILDERS / 8, stepped
        // without divisions: halo column hx, row hy of image img
        constexpr int kStep = BUILDERS / 8;
        int pos = bt / 8;
        int hx = pos % hw2;
        int hy = pos / hw2;
        int img = hy / (p.th + 2);
        hy -= img * (p.th + 2);
        for (; pos < npos; pos += kStep) {
          const int n = n0 + img;
          const int y = y0 + hy - 1;
          const int xx = x0 + hx - 1;
          const bool inside = c < p.c && n < p.batch && y >= 0 && y < p.h &&
                              xx >= 0 && xx < p.w;
          uint4 v = make_uint4(0, 0, 0, 0);
          if (inside) {
            if (img != cur) {
              cur = img;
              const float4* a4 =
                  reinterpret_cast<const float4*>(p.a + (long long)n * p.c + c);
              const float4* b4 =
                  reinterpret_cast<const float4*>(p.b + (long long)n * p.c + c);
              const float4 a0 = a4[0], a1 = a4[1], b0 = b4[0], b1 = b4[1];
              av[0] = a0.x; av[1] = a0.y; av[2] = a0.z; av[3] = a0.w;
              av[4] = a1.x; av[5] = a1.y; av[6] = a1.z; av[7] = a1.w;
              bv[0] = b0.x; bv[1] = b0.y; bv[2] = b0.z; bv[3] = b0.w;
              bv[4] = b1.x; bv[5] = b1.y; bv[6] = b1.z; bv[7] = b1.w;
            }
            v = gn_silu8(*reinterpret_cast<const uint4*>(raw + pos * 128 +
                                                         cc * 16),
                         av, bv);
          }
          *reinterpret_cast<uint4*>(hs + pos * HPITCH + cc * 16) = v;
          for (hx += kStep; hx >= hw2; hx -= hw2) {
            if (++hy == p.th + 2) {
              hy = 0;
              ++img;
            }
          }
        }
        named_sync(1, BUILDERS);  // every builder is done with the raw halo
        if (bt == 0 && ch + 1 < ch1) {
          asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
          bar_expect(raw_full, raw_bytes);
          tma_load_4d(raw, &map_x, raw_full, (ch + 1) * CH, x0 - 1, y0 - 1,
                      n0);
        }
        bar_arrive(&halo_full[hb]);
      }
    }
    cluster_sync();
    cluster_sync();
    return;
  }

  // consumers: warpgroup wg takes tile rows 64 wg .. 64 wg + 63
  regs_inc<160>();
  const int wg = threadIdx.x / 128;
  const int t = threadIdx.x % 128;
  const int lane = t % 32;
  int hoff;
  {
    int img, ry, rx;
    const int r = wg * 64 + (t / 32) * 16 + (lane & 15);
    hoff = tile_pixel(p, n0, y0, x0, r, img, ry, rx)
               ? ((img * (p.th + 2) + ry) * hw2 + rx) * HPITCH
               : 0;
    hoff += (lane >> 4) * 16;
  }
  float acc[BN / 2];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;
  fence_regs(acc);
  uint32_t fa[4][4];  // one tap's A: four k16 steps
  int it = 0;
  for (int ch = ch0, jl = 0; ch < ch1; ++ch, ++jl) {
    const int hb = jl & 1;
    const unsigned char* hs = smem + HALO_OFF + hb * HALO_POS * HPITCH + hoff;
    bar_wait(&halo_full[hb], (jl / 2) & 1);
#pragma unroll
    for (int tap = 0; tap < 9; ++tap, ++it) {
      const int s = it % STAGES;
      const unsigned char* ht = hs + ((tap / 3) * hw2 + tap % 3) * HPITCH;
#pragma unroll
      for (int ks = 0; ks < 4; ++ks) ldsm_x4(fa[ks], ht + ks * 32);
      if (tap == 8) bar_arrive(&halo_empty[hb]);
      bar_wait(&full[s], (it / STAGES) & 1);
      const uint64_t db = desc_sw128(smem + s * B_TILE);
      wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < 4; ++ks) {
        mma_rs(acc, fa[ks], desc_add(db, ks * 32));
      }
      wgmma_commit();
      wgmma_wait<0>();  // before fa is gathered again
      bar_arrive(&empty[s]);
    }
  }
  fence_regs(acc);

  named_sync(2, 256);  // every consumer is done with the ring
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = wg * 64 + (t / 32) * 16 + lane / 4 + 8 * h;
      const int col = 8 * j + 2 * (lane % 4);
      *reinterpret_cast<float2*>(&part[row * PPITCH + col]) =
          make_float2(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
    }
  }
  cluster_sync();
  // 8 output channels of one pixel a step, summed over the cluster's
  // blocks in rank order
  constexpr int kUnits = 128 * (BN / 8);
  const int lo = rank * kUnits / slices;
  const int hi = (rank + 1) * kUnits / slices;
  for (int u = lo + threadIdx.x; u < hi; u += 256) {
    const int i = u / (BN / 8);
    const int f = f0 + 8 * (u - i * (BN / 8));
    int img, ry, rx;
    if (f >= p.f || !tile_pixel(p, n0, y0, x0, i, img, ry, rx)) continue;
    const float* src = part + i * PPITCH + (f - f0);
    float sum[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
    for (int q = 0; q < slices; ++q) {
      const uint4 lo4 = ld_cluster_v4(src, q);
      const uint4 hi4 = ld_cluster_v4(src + 4, q);
      sum[0] = __fadd_rn(sum[0], __uint_as_float(lo4.x));
      sum[1] = __fadd_rn(sum[1], __uint_as_float(lo4.y));
      sum[2] = __fadd_rn(sum[2], __uint_as_float(lo4.z));
      sum[3] = __fadd_rn(sum[3], __uint_as_float(lo4.w));
      sum[4] = __fadd_rn(sum[4], __uint_as_float(hi4.x));
      sum[5] = __fadd_rn(sum[5], __uint_as_float(hi4.y));
      sum[6] = __fadd_rn(sum[6], __uint_as_float(hi4.z));
      sum[7] = __fadd_rn(sum[7], __uint_as_float(hi4.w));
    }
    const long long pix =
        ((long long)(n0 + img) * p.h + y0 + ry) * p.w + x0 + rx;
    bf16* dst = p.out + pix * p.f + f;
    if (p.f % 8 == 0) {  // f + 8 <= F, 16-byte aligned
      uint4 o;
      __nv_bfloat162* o2 = reinterpret_cast<__nv_bfloat162*>(&o);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        o2[j] = __floats2bfloat162_rn(__fadd_rn(sum[2 * j], p.bias[f + 2 * j]),
                                      __fadd_rn(sum[2 * j + 1],
                                                p.bias[f + 2 * j + 1]));
      }
      *reinterpret_cast<uint4*>(dst) = o;
    } else {
      for (int j = 0; j < 8 && f + j < p.f; ++j) {
        dst[j] = __float2bfloat16_rn(__fadd_rn(sum[j], p.bias[f + j]));
      }
    }
  }
  cluster_sync();
}

}  // namespace gn

namespace gn {

// The weight's map (its box BN filters deep) and the launch of the BN
// instance.
template <int BN>
int launch(const CUtensorMap& map_x, const void* w, const uint64_t (&wd)[3],
           const uint64_t (&ws)[2], const Args& p, int groups, int slices,
           cudaStream_t stream) {
  CUtensorMap map_w;
  const uint32_t wb[3] = {CH, 1, BN};
  if (!hopper::encode_map(&map_w, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, w, wd,
                          ws, wb, true)) {
    return (int)cudaErrorInvalidValue;
  }
  const dim3 grid(groups, (p.f + BN - 1) / BN, slices);
  return (int)hopper::launch_cluster(gn_conv_wgmma_kernel<BN>, grid, THREADS,
                                     Smem<BN>::BYTES, slices, stream, map_x,
                                     map_w, p);
}

}  // namespace gn

// x (B, H, W, C) bf16 NHWC, a and b (B, C) fp32, w (F, 3, 3, C) bf16,
// bias (F,) fp32, out (B, H, W, F) bf16, all contiguous, x and w 16-byte
// aligned. The launch plan comes from the caller
// (ops/_igemm.py::conv_plan): th image rows of a tw-column stretch, or
// imgs whole images, a block (imgs (th + 2)(tw + 2) <= 264 halo
// positions, th tw imgs <= 128 pixels), bn output channels a block (160
// or 128) and the channel-chunk slices of one cluster (1 to 8). Needs
// C % 8 == 0. Returns a cudaError_t.
extern "C" int cassmantle_gn_silu_conv3x3_bf16(
    const void* x, const void* a, const void* b, const void* w,
    const void* bias, void* out, int batch, int h, int width, int c, int f,
    int th, int tw, int imgs, int bn, int slices, void* stream) {
  const int chunks = (c + gn::CH - 1) / gn::CH;
  if (batch < 1 || h < 1 || width < 1 || c < 8 || c % 8 || f < 1 ||
      th < 1 || tw < 1 || tw > width || imgs < 1 ||
      (imgs > 1 && (th != h || tw != width)) || th * tw * imgs > 128 ||
      imgs * (th + 2) * (tw + 2) > gn::HALO_POS || (bn != 160 && bn != 128) ||
      slices < 1 || slices > 8 || slices > chunks) {
    return (int)cudaErrorInvalidValue;
  }
  CUtensorMap map_x;
  const uint64_t xd[4] = {(uint64_t)c, (uint64_t)width, (uint64_t)h,
                          (uint64_t)batch};
  const uint64_t xs[3] = {(uint64_t)c * 2, (uint64_t)width * c * 2,
                          (uint64_t)h * width * c * 2};
  const uint32_t xb[4] = {gn::CH, (uint32_t)tw + 2, (uint32_t)th + 2,
                          (uint32_t)imgs};
  const uint64_t wd[3] = {(uint64_t)c, 9, (uint64_t)f};
  const uint64_t ws[2] = {(uint64_t)c * 2, (uint64_t)c * 18};
  if (!hopper::encode_map(&map_x, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, x, xd,
                          xs, xb, false)) {
    return (int)cudaErrorInvalidValue;
  }
  gn::Args p{static_cast<const float*>(a), static_cast<const float*>(b),
             static_cast<const float*>(bias), static_cast<gn::bf16*>(out),
             batch, h, width, c, f, th, tw, imgs, chunks};
  const int groups = imgs > 1 ? (batch + imgs - 1) / imgs
                              : batch * ((h + th - 1) / th) *
                                    ((width + tw - 1) / tw);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return bn == 128 ? gn::launch<128>(map_x, w, wd, ws, p, groups, slices, st)
                   : gn::launch<160>(map_x, w, wd, ws, p, groups, slices, st);
}
