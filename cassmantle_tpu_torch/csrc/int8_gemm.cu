// int8 x int8 -> int32 matmul and conv3x3 for Hopper (sm_90a): the W8A8
// serving kernels.
//
// Replaces: cassmantle_tpu/ops/quant_matmul.py::_matmul_kernel (reached
// through _matmul_padded and int8_matmul) and ::_conv_kernel (through
// _conv_padded and int8_conv3x3).
//   int8_matmul   (M, K) x (K, N): acc_int32 * row_scale[m] * col_scale[n]
//                 + bias[n]; a per-tensor activation scale is one row
//                 scale read through a pointer with stride 0, so the
//                 dynamic absmax never leaves the device.
//   int8_conv3x3  NHWC (B, H, W, C) x HWIO (3, 3, C, F), stride 1, SAME
//                 zero padding, nine shifted int8 dots summed in int32:
//                 acc * col_scale[f] + bias[f] (col_scale = activation
//                 scale x weight scale, folded by the caller).
// Each epilogue step rounds on its own in fp32, then casts to bf16 or
// fp32: the results equal the plain versions' bit for bit, since int32
// sums are exact in any order. Ragged M (1 row in GPT-2 decode, 154 for
// the 2 x 77-token cross-attention context), N and K are masked; K and C
// need multiples of 16. The TPU path's padding of M, K and N to (32, 128)
// tiles is not needed.
//
// What bounds it (int8, H100 SXM: 1,979 TOP/s, 3.35 TB/s; 2*M*K*N or
// 18*M*C*F operations; operands and output once each): the UNet's matmuls
// at 8192 or 2048 tokens and its 64x64 and 32x32 convs are
// operation-bound (a few us each at the peak); its 8x8 convs, the
// cross-attention kv projection and every GPT-2 matmul (M = 1 in decode,
// 32 in prefill) are bound by the bytes of the weight.
//
// What the designs do about it.
// int8_matmul (w8 below, on hopper.cuh): one launch per call. TMA brings
// 128-byte K tiles of both operands, 128-byte swizzled, into a 4-stage
// ring of full/empty mbarriers, issued by one producer thread; consumer
// warpgroups run wgmma m64nNk32 s8 -> s32 from shared memory. M > 256:
// x rows on wgmma's 64-row side, two consumer warpgroups (128 x BN
// tiles, BN 160 where it divides N, else 128). M <= 256: the operands
// swap, so the weight streams once, 64 of its rows a block, and the
// tokens become wgmma's N (8, 32, 128 or 160, TMA zero-filling past M).
// Where the tiles fill the card, a persistent grid of one block per SM
// walks them, the producer loading the next tile while the consumers
// apply the epilogue to this one from their registers. Where they are
// too few, a thread-block cluster of up to 8 blocks splits K; each block
// leaves its int32 partial tile in shared memory and the cluster sums it
// through distributed shared memory in rank order (no workspace, no
// second kernel), 8 channels of a token at a time, so that the stores
// are 16-byte and in order also for the swapped tile. Not yet used:
// TMA stores, fusing the activation quantize into the producer.
// int8_conv3x3 (int8_conv_wgmma_kernel below): the same mainloop, ring and
// epilogues, with the im2col never built. The activation is already
// int8, so there is no prologue, and the SAME border comes from TMA: for
// a tile of whole pixel rows (or of a stretch of one row, W > 64 WGS)
// and each tap (dy, dx), the A tile is one 4-D box of the NHWC image at
// (c0, x0 + dx - 1, y0 + dy - 1, n0), zero-filled outside the image. B
// is a 3-D box of the OHWI weight viewed as (C, 9, F). 128-byte boxes
// along C; where the last chunk holds at most 64 channels its units
// issue two 32-channel k-steps, not four (steps past C multiply TMA's
// zeros; the count is a template argument, so that no wgmma sits in a
// branch, which ptxas would serialise). C % 16 == 0 is kept for the
// 16-byte strides TMA needs. One or two consumer warpgroups (64 or
// 128 pixels a tile, 160 filters a tile at every F); too few tiles
// split the 9 x ceil(C / 128) K units over a cluster, summed in
// distributed shared memory in rank order as for the matmul. The
// launch plan (tile, warpgroups, slices) is ops/_igemm.py's.

#include <cuda_bf16.h>

#include <type_traits>

#include "hopper.cuh"

namespace w8 {

using namespace hopper;

constexpr int KT = 128;      // K tile: 128 int8 values, one swizzle row
constexpr int STAGES = 4;    // TMA ring depth
constexpr int CONV_BN = 160;  // the conv's filters a tile (every F)

// The epilogue's operands. The kernel computes a tile of D = P . Q^T
// with P the operand on wgmma's 64-row side and Q on its N side: x and
// the weight, or (SWAP, small M) the weight and x.
struct Args {
  const float* row_scale;    // per token, or one value (row_stride 0)
  long long row_stride;
  const float* col_scale;    // (N,)
  const float* bias;         // (N,)
  void* out;                 // (M, N) bf16 or fp32
  int out_bf16;
  int m, n;
  int k_tiles;
  int pairs;                 // n even, col_scale and bias 8-byte aligned
  int octets;                // n % 8 == 0, both 16-byte aligned
};

template <bool SWAP, int BN, int WGS = SWAP ? 1 : 2>
struct Shape {
  static constexpr int kWgs = WGS;           // consumer warpgroups
  static constexpr int kThreads = 128 * kWgs + 32;  // + one producer warp
  static constexpr int kRowsP = 64 * kWgs;
  static constexpr int kBytesP = kRowsP * KT;
  static constexpr int kBytesQ = (BN * KT + 1023) / 1024 * 1024;
  static constexpr int kStage = kBytesP + kBytesQ;
  static constexpr int kTxBytes = kBytesP + BN * KT;
  // the partial tile, output-major: a row per token, its channels
  // contiguous (pitch + 4 words: 16-byte rows, spread banks)
  static constexpr int kTok = SWAP ? BN : kRowsP;
  static constexpr int kCh = SWAP ? kRowsP : BN;
  static constexpr int kPitch = kCh + 4;
  static constexpr int kPartial = kTok * kPitch * 4;
  static constexpr int kRing =
      STAGES * kStage > kPartial ? STAGES * kStage : kPartial;
  // the unsplit x-side tile's bf16 output, staged for 16-byte stores
  // (pitch BN + 8: the accumulator layout's writes miss each other's
  // banks)
  static constexpr int kStgPitch = BN + 8;
  static constexpr int kStg = SWAP ? 0 : kRowsP * kStgPitch * 2;
  static constexpr int kBars = (kRing + kStg + 7) / 8 * 8;
  static constexpr int kSmem = 1024 + kBars + 2 * STAGES * 8;
};

__device__ __forceinline__ unsigned char* align1024(unsigned char* p) {
  const uint32_t a = smem_u32(p);
  return p + (((a + 1023) & ~1023u) - a);
}

// acc * row_scale * col_scale + bias, each step rounded on its own.
__device__ __forceinline__ float epilogue(int acc, float rs, float cs,
                                          float bias) {
  return __fadd_rn(__fmul_rn(__fmul_rn(__int2float_rn(acc), rs), cs), bias);
}

// The row scale of token `tok`; 1 where there is none (the conv, whose
// activation scale is folded into col_scale): x * 1 is exact, so the
// epilogue is then acc * col_scale + bias, each step rounded.
__device__ __forceinline__ float row_scale(const Args& a, int tok) {
  return a.row_scale != nullptr ? a.row_scale[tok * a.row_stride] : 1.f;
}

__device__ __forceinline__ void store(const Args& a, long long idx,
                                      float v) {
  if (a.out_bf16) {
    static_cast<__nv_bfloat16*>(a.out)[idx] = __float2bfloat16_rn(v);
  } else {
    static_cast<float*>(a.out)[idx] = v;
  }
}

// Two neighbouring outputs at idx (idx even when n is even).
__device__ __forceinline__ void store2(const Args& a, long long idx,
                                       float v0, float v1) {
  if (a.n % 2) {
    store(a, idx, v0);
    store(a, idx + 1, v1);
  } else if (a.out_bf16) {
    *reinterpret_cast<__nv_bfloat162*>(static_cast<__nv_bfloat16*>(a.out) +
                                       idx) = __floats2bfloat162_rn(v0, v1);
  } else {
    *reinterpret_cast<float2*>(static_cast<float*>(a.out) + idx) =
        make_float2(v0, v1);
  }
}

// Straight from the accumulators (one block per tile, no split): a
// thread holds two neighbouring Q rows of each of its two P rows. The
// scales and biases are read once a tile, or once a column pair. Output
// rows (tokens) at or past tok_end are not stored.
template <bool SWAP, int BN, int WGS = SWAP ? 1 : 2>
__device__ __forceinline__ void store_tile(const Args& a, const int* acc,
                                           int p0, int q0, int tok_end,
                                           __nv_bfloat16* stg) {
  const int t = threadIdx.x % 128;
  const int lane = t % 32;
  const int pr0 = p0 + (threadIdx.x / 128) * 64 + (t / 32) * 16 + lane / 4;
  const int p_rows = SWAP ? a.n : tok_end;
  // per P row h: the row scale (tokens) or column scale and bias (the
  // swapped tile's channels)
  float ps[2], pb[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int pr = min(pr0 + 8 * h, p_rows - 1);
    if (SWAP) {
      ps[h] = a.col_scale[pr];
      pb[h] = a.bias[pr];
    } else {
      ps[h] = row_scale(a, pr);
      pb[h] = 0.f;
    }
  }
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
    const int qr = q0 + 8 * j + 2 * (lane % 4);
    if (SWAP) {  // Q rows are tokens: out[qr + e][pr]
      if (qr >= tok_end) continue;
      const bool two = qr + 1 < tok_end;
      const float rs0 = row_scale(a, qr);
      const float rs1 = two ? row_scale(a, qr + 1) : 0.f;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int pr = pr0 + 8 * h;
        if (pr >= a.n) continue;
        store(a, (long long)qr * a.n + pr,
              epilogue(acc[4 * j + 2 * h], rs0, ps[h], pb[h]));
        if (two) {
          store(a, (long long)(qr + 1) * a.n + pr,
                epilogue(acc[4 * j + 2 * h + 1], rs1, ps[h], pb[h]));
        }
      }
    } else if (stg != nullptr) {  // staged: a bf16 pair at (pr, qr)
      const int cq = min(qr, a.n - 2);  // n % 8 == 0: qr < n holds a pair
      const float2 cs = *reinterpret_cast<const float2*>(a.col_scale + cq);
      const float2 bs = *reinterpret_cast<const float2*>(a.bias + cq);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = pr0 - p0 + 8 * h;
        *reinterpret_cast<__nv_bfloat162*>(
            stg + r * Shape<SWAP, BN, WGS>::kStgPitch + qr - q0) =
            __floats2bfloat162_rn(
                epilogue(acc[4 * j + 2 * h], ps[h], cs.x, bs.x),
                epilogue(acc[4 * j + 2 * h + 1], ps[h], cs.y, bs.y));
      }
    } else {     // Q rows are channels: out[pr][qr + e]
      if (qr >= a.n) continue;
      const bool two = qr + 1 < a.n;
      float2 cs, bs;
      if (two && a.pairs) {
        cs = *reinterpret_cast<const float2*>(a.col_scale + qr);
        bs = *reinterpret_cast<const float2*>(a.bias + qr);
      } else {
        cs = make_float2(a.col_scale[qr], two ? a.col_scale[qr + 1] : 0.f);
        bs = make_float2(a.bias[qr], two ? a.bias[qr + 1] : 0.f);
      }
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int pr = pr0 + 8 * h;
        if (pr >= tok_end) continue;
        const long long idx = (long long)pr * a.n + qr;
        const float v0 = epilogue(acc[4 * j + 2 * h], ps[h], cs.x, bs.x);
        if (two) {
          store2(a, idx, v0,
                 epilogue(acc[4 * j + 2 * h + 1], ps[h], cs.y, bs.y));
        } else {
          store(a, idx, v0);
        }
      }
    }
  }
  if (!SWAP && stg != nullptr) {
    using S = Shape<SWAP, BN, WGS>;
    named_sync(1, 128 * S::kWgs);  // the tile is staged
    for (int u = threadIdx.x; u < S::kRowsP * (BN / 8); u += 128 * S::kWgs) {
      const int r = u / (BN / 8);
      const int c = 8 * (u - r * (BN / 8));
      if (p0 + r < tok_end && q0 + c < a.n) {
        *reinterpret_cast<uint4*>(static_cast<__nv_bfloat16*>(a.out) +
                                  (long long)(p0 + r) * a.n + q0 + c) =
            *reinterpret_cast<const uint4*>(stg + r * S::kStgPitch + c);
      }
    }
  }
}

// Split K over a cluster: each block leaves its int32 partial tile in
// shared memory (over the drained ring); after a cluster barrier every
// block sums its share of the tile over the cluster's blocks in rank
// order, 8 channels of a token at a time, and stores it (tokens before
// tok_end).
template <bool SWAP, int BN, int WGS = SWAP ? 1 : 2>
__device__ __forceinline__ void reduce_tile(const Args& a, const int* acc,
                                            int* part, int p0, int q0,
                                            int tok_end, int rank,
                                            int slices) {
  using S = Shape<SWAP, BN, WGS>;
  constexpr int kConsumers = 128 * S::kWgs;
  named_sync(1, kConsumers);  // every consumer is done with the ring
  const int t = threadIdx.x % 128;
  const int lane = t % 32;
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int pr = (threadIdx.x / 128) * 64 + (t / 32) * 16 + lane / 4 +
                       8 * h;
        const int qr = 8 * j + 2 * (lane % 4) + e;
        part[SWAP ? qr * S::kPitch + pr : pr * S::kPitch + qr] =
            acc[4 * j + 2 * h + e];
      }
    }
  }
  cluster_sync();
  constexpr int kUnits = S::kTok * (S::kCh / 8);
  const int tok0 = SWAP ? q0 : p0;
  const int ch0 = SWAP ? p0 : q0;
  const int lo = rank * kUnits / slices;
  const int hi = (rank + 1) * kUnits / slices;
  for (int u = lo + threadIdx.x; u < hi; u += kConsumers) {
    const int r = u / (S::kCh / 8);
    const int c8 = u - r * (S::kCh / 8);
    const int tok = tok0 + r;
    const int ch = ch0 + 8 * c8;
    if (tok >= tok_end || ch >= a.n) continue;
    const int* src = part + r * S::kPitch + 8 * c8;
    int sum[8] = {0, 0, 0, 0, 0, 0, 0, 0};
    for (int q = 0; q < slices; ++q) {
      const uint4 lo4 = ld_cluster_v4(src, q);
      const uint4 hi4 = ld_cluster_v4(src + 4, q);
      sum[0] += lo4.x; sum[1] += lo4.y; sum[2] += lo4.z; sum[3] += lo4.w;
      sum[4] += hi4.x; sum[5] += hi4.y; sum[6] += hi4.z; sum[7] += hi4.w;
    }
    const float rs = row_scale(a, tok);
    float cs[8], bs[8], v[8];
    if (a.octets) {  // ch + 8 <= n, 16-byte aligned
      *reinterpret_cast<float4*>(cs) =
          *reinterpret_cast<const float4*>(a.col_scale + ch);
      *reinterpret_cast<float4*>(cs + 4) =
          *reinterpret_cast<const float4*>(a.col_scale + ch + 4);
      *reinterpret_cast<float4*>(bs) =
          *reinterpret_cast<const float4*>(a.bias + ch);
      *reinterpret_cast<float4*>(bs + 4) =
          *reinterpret_cast<const float4*>(a.bias + ch + 4);
    } else {
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        cs[j] = a.col_scale[min(ch + j, a.n - 1)];
        bs[j] = a.bias[min(ch + j, a.n - 1)];
      }
    }
#pragma unroll
    for (int j = 0; j < 8; ++j) v[j] = epilogue(sum[j], rs, cs[j], bs[j]);
    const long long idx = (long long)tok * a.n + ch;
    if (a.n % 8 == 0) {  // ch + 8 <= n, 16-byte aligned
      if (a.out_bf16) {
        uint4 o;
        __nv_bfloat162* o2 = reinterpret_cast<__nv_bfloat162*>(&o);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          o2[j] = __floats2bfloat162_rn(v[2 * j], v[2 * j + 1]);
        }
        *reinterpret_cast<uint4*>(static_cast<__nv_bfloat16*>(a.out) + idx) =
            o;
      } else {
        float4* dst = reinterpret_cast<float4*>(static_cast<float*>(a.out) +
                                                idx);
        dst[0] = make_float4(v[0], v[1], v[2], v[3]);
        dst[1] = make_float4(v[4], v[5], v[6], v[7]);
      }
    } else {
      for (int j = 0; j < 8 && ch + j < a.n; ++j) store(a, idx + j, v[j]);
    }
  }
  cluster_sync();
}

// Unsplit (gridDim.z == 1): a persistent grid, block x taking tiles x,
// x + gridDim.x, ... (Q tiles fastest), so that the producer loads the
// next tile while the consumers store this one. Split (gridDim.z = the
// cluster's slices): block (x, 0, z) takes tile x, K slice z. Consumer
// warpgroups come first; then one producer warp, whose first thread
// keeps STAGES TMA loads of P and Q in flight.
template <bool SWAP, int BN>
__global__ void __launch_bounds__(Shape<SWAP, BN>::kThreads, 1)
    int8_matmul_wgmma_kernel(const __grid_constant__ CUtensorMap map_p,
                             const __grid_constant__ CUtensorMap map_q,
                             Args a) {
  using S = Shape<SWAP, BN>;
  constexpr int kConsumers = 128 * S::kWgs;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align1024(smem_raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + S::kBars);
  uint64_t* empty = full + STAGES;

  const int q_tiles = ((SWAP ? a.m : a.n) + BN - 1) / BN;
  const int tiles = ((SWAP ? a.n : a.m) + S::kRowsP - 1) / S::kRowsP * q_tiles;
  const int slices = gridDim.z;
  const int rank = blockIdx.z;
  const int kt0 = rank * a.k_tiles / slices;
  const int kt1 = (rank + 1) * a.k_tiles / slices;

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      bar_init(&full[s], 1);
      bar_init(&empty[s], kConsumers);
    }
    bar_init_fence();
  }
  __syncthreads();

  if (threadIdx.x >= kConsumers) {
    if (threadIdx.x == kConsumers) {
      int it = 0;
      for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
        const int p0 = tile / q_tiles * S::kRowsP;
        const int q0 = tile % q_tiles * BN;
        for (int kt = kt0; kt < kt1; ++kt, ++it) {
          const int s = it % STAGES;
          if (it >= STAGES) bar_wait(&empty[s], (it / STAGES - 1) & 1);
          unsigned char* st = smem + s * S::kStage;
          bar_expect(&full[s], S::kTxBytes);
          tma_load_2d(st, &map_p, &full[s], kt * KT, p0);
          tma_load_2d(st + S::kBytesP, &map_q, &full[s], kt * KT, q0);
        }
      }
    }
    if (slices > 1) {
      cluster_sync();
      cluster_sync();
    }
    return;
  }

  const int wg = threadIdx.x / 128;
  int acc[BN / 2];
  int it = 0;
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const int p0 = tile / q_tiles * S::kRowsP;
    const int q0 = tile % q_tiles * BN;
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) acc[i] = 0;
    fence_regs(acc);
    for (int kt = kt0; kt < kt1; ++kt, ++it) {
      const int s = it % STAGES;
      bar_wait(&full[s], (it / STAGES) & 1);
      unsigned char* st = smem + s * S::kStage;
      const uint64_t dp = desc_sw128(st + wg * 64 * KT);
      const uint64_t dq = desc_sw128(st + S::kBytesP);
      wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < KT / 32; ++ks) {
        mma_ss(acc, desc_add(dp, ks * 32), desc_add(dq, ks * 32));
      }
      wgmma_commit();
      wgmma_wait<1>();
      fence_regs(acc);
      if (kt > kt0) bar_arrive(&empty[(it - 1) % STAGES]);
    }
    wgmma_wait<0>();
    fence_regs(acc);
    bar_arrive(&empty[(it - 1) % STAGES]);
    if (slices == 1) {
      // staged where the x-side tile writes bf16 rows of 16-byte pieces;
      // the staging buffer is free once every consumer passes here
      const bool staged = !SWAP && a.out_bf16 && a.octets;
      if (staged) named_sync(1, kConsumers);
      store_tile<SWAP, BN>(a, acc, p0, q0, a.m,
                           staged ? reinterpret_cast<__nv_bfloat16*>(
                                        smem + S::kRing)
                                  : nullptr);
    } else {
      reduce_tile<SWAP, BN>(a, acc, reinterpret_cast<int*>(smem), p0, q0,
                            a.m, rank, slices);
    }
  }
}

template <bool SWAP, int BN>
cudaError_t launch(const void* x, const void* wt, const Args& a, int k,
                   int slices, int blocks, cudaStream_t stream) {
  using S = Shape<SWAP, BN>;
  const void* p = SWAP ? wt : x;
  const void* q = SWAP ? x : wt;
  const int p_rows = SWAP ? a.n : a.m;
  const int q_rows = SWAP ? a.m : a.n;
  CUtensorMap map_p, map_q;
  const uint64_t dims_p[2] = {(uint64_t)k, (uint64_t)p_rows};
  const uint64_t dims_q[2] = {(uint64_t)k, (uint64_t)q_rows};
  const uint64_t strides[1] = {(uint64_t)k};
  const uint32_t box_p[2] = {KT, S::kRowsP};
  const uint32_t box_q[2] = {KT, BN};
  if (!encode_map(&map_p, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, p, dims_p,
                  strides, box_p, true) ||
      !encode_map(&map_q, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, q, dims_q,
                  strides, box_q, true)) {
    return cudaErrorInvalidValue;
  }
  const int tiles = (p_rows + S::kRowsP - 1) / S::kRowsP *
                    ((q_rows + BN - 1) / BN);
  if (blocks < 1 || blocks > tiles || (slices > 1 && blocks != tiles)) {
    return cudaErrorInvalidValue;
  }
  const dim3 grid(blocks, 1, slices);
  return launch_cluster(int8_matmul_wgmma_kernel<SWAP, BN>, grid,
                        S::kThreads, S::kSmem, slices, stream, map_p, map_q,
                        a);
}

// -- int8 conv3x3 -------------------------------------------------------------

// A conv launch's geometry (ops/_igemm.py::int8_conv_plan). A pixel
// tile is `imgs` images x `rows` image rows x `cols` pixels of a row, at
// most 64 WGS pixels, consecutive in NHWC order: either whole rows (cols
// == W; imgs > 1 only with rows == H) or one stretch of a row (rows ==
// imgs == 1).
struct ConvGeo {
  int batch, h, w, c;
  int imgs, rows, cols;
  int gi, gy, gx;  // pixel tiles along the batch, the rows, the columns
  int units;       // K units: 9 taps x ceil(C / 128) channel chunks
};

// K unit u: channel chunk u / 9, tap u % 9 = 3 dy + dx.
// blockIdx as in int8_matmul_wgmma_kernel (x: tile, or the persistent
// grid; z: K slice). The producer loads, for each K unit, the tile's
// pixels shifted by the tap as one 4-D box of the NHWC image (channels,
// W, H, B) at (c0, x0 + dx - 1, y0 + dy - 1, n0): coordinates outside
// the image, negative ones too, are zero-filled, which is the SAME
// border. The weight tile is a 3-D box of the OHWI weight viewed as (C,
// 9, F): 128 channels of one tap for BN = CONV_BN filters (F past a
// multiple of 160 is zero-filled by TMA and not stored).
// TAIL: the 32-channel k-steps issued for the units of the last channel
// chunk (2 where C % 128 is 1..64, else 4; steps past C multiply zeros).
// Full-chunk and tail units run in two loops, each with a fixed count of
// wgmma, so that none sits in a branch (ptxas serialises those).
template <int WGS, int TAIL>
__global__ void __launch_bounds__(Shape<false, CONV_BN, WGS>::kThreads, 1)
    int8_conv_wgmma_kernel(const __grid_constant__ CUtensorMap map_x,
                           const __grid_constant__ CUtensorMap map_w,
                           Args a, ConvGeo g) {
  constexpr int BN = CONV_BN;
  using S = Shape<false, BN, WGS>;
  constexpr int kConsumers = 128 * S::kWgs;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align1024(smem_raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + S::kBars);
  uint64_t* empty = full + STAGES;

  const int q_tiles = (a.n + BN - 1) / BN;
  const int tiles = g.gi * g.gy * g.gx * q_tiles;
  const int slices = gridDim.z;
  const int rank = blockIdx.z;
  const int u0 = rank * g.units / slices;
  const int u1 = (rank + 1) * g.units / slices;
  const int pixels = g.imgs * g.rows * g.cols;

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      bar_init(&full[s], 1);
      bar_init(&empty[s], kConsumers);
    }
    bar_init_fence();
  }
  __syncthreads();

  if (threadIdx.x >= kConsumers) {
    if (threadIdx.x == kConsumers) {
      int it = 0;
      for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
        const int pt = tile / q_tiles;
        const int q0 = tile % q_tiles * BN;
        const int x0 = pt % g.gx * g.cols;
        const int y0 = pt / g.gx % g.gy * g.rows;
        const int n0 = pt / (g.gx * g.gy) * g.imgs;
        for (int u = u0; u < u1; ++u, ++it) {
          const int s = it % STAGES;
          const int tap = u % 9;
          if (it >= STAGES) bar_wait(&empty[s], (it / STAGES - 1) & 1);
          unsigned char* st = smem + s * S::kStage;
          bar_expect(&full[s], pixels * KT + BN * KT);
          tma_load_4d(st, &map_x, &full[s], u / 9 * KT, x0 + tap % 3 - 1,
                      y0 + tap / 3 - 1, n0);
          tma_load_3d(st + S::kBytesP, &map_w, &full[s], u / 9 * KT, tap, q0);
        }
      }
    }
    if (slices > 1) {
      cluster_sync();
      cluster_sync();
    }
    return;
  }

  const int wg = threadIdx.x / 128;
  // units before the tail chunk's (all of them when TAIL == 4)
  const int u_tail = TAIL == KT / 32 ? u1 : max(u0, min(u1, g.units - 9));
  int acc[BN / 2];
  int it = 0;
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const int pt = tile / q_tiles;
    const int q0 = tile % q_tiles * BN;
    const int x0 = pt % g.gx * g.cols;
    const int y0 = pt / g.gx % g.gy * g.rows;
    const int n0 = pt / (g.gx * g.gy) * g.imgs;
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) acc[i] = 0;
    fence_regs(acc);
    // one K unit: NK k-steps of 32 channels on the stage it landed in
    auto unit = [&](int u, auto nk) {
      const int s = it % STAGES;
      bar_wait(&full[s], (it / STAGES) & 1);
      unsigned char* st = smem + s * S::kStage;
      const uint64_t dp = desc_sw128(st + wg * 64 * KT);
      const uint64_t dq = desc_sw128(st + S::kBytesP);
      wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < decltype(nk)::value; ++ks) {
        mma_ss(acc, desc_add(dp, ks * 32), desc_add(dq, ks * 32));
      }
      wgmma_commit();
      wgmma_wait<1>();
      fence_regs(acc);
      if (u > u0) bar_arrive(&empty[(it - 1) % STAGES]);
    };
    for (int u = u0; u < u_tail; ++u, ++it) {
      unit(u, std::integral_constant<int, KT / 32>());
    }
    for (int u = u_tail; u < u1; ++u, ++it) {
      unit(u, std::integral_constant<int, TAIL>());
    }
    wgmma_wait<0>();
    fence_regs(acc);
    bar_arrive(&empty[(it - 1) % STAGES]);
    // the tile's pixels are output rows p0 .. p0 + valid - 1
    const int p0 = ((n0 * g.h) + y0) * g.w + x0;
    const int valid =
        g.imgs > 1 ? min(g.imgs, g.batch - n0) * g.h * g.w
        : g.cols < g.w ? min(g.cols, g.w - x0)
                       : min(g.rows, g.h - y0) * g.w;
    if (slices == 1) {
      const bool staged = a.out_bf16 && a.octets;
      if (staged) named_sync(1, kConsumers);
      store_tile<false, BN, WGS>(
          a, acc, p0, q0, p0 + valid,
          staged ? reinterpret_cast<__nv_bfloat16*>(smem + S::kRing)
                 : nullptr);
    } else {
      reduce_tile<false, BN, WGS>(a, acc, reinterpret_cast<int*>(smem), p0,
                                  q0, p0 + valid, rank, slices);
    }
  }
}

template <int WGS, int TAIL>
cudaError_t launch_conv(const CUtensorMap& mx, const CUtensorMap& mw,
                        const Args& a, const ConvGeo& g, int slices,
                        int blocks, cudaStream_t stream) {
  using S = Shape<false, CONV_BN, WGS>;
  const int tiles = g.gi * g.gy * g.gx * ((a.n + CONV_BN - 1) / CONV_BN);
  if (blocks < 1 || blocks > tiles || (slices > 1 && blocks != tiles) ||
      g.imgs * g.rows * g.cols > S::kRowsP) {
    return cudaErrorInvalidValue;
  }
  return launch_cluster(int8_conv_wgmma_kernel<WGS, TAIL>,
                        dim3(blocks, 1, slices), S::kThreads, S::kSmem,
                        slices, stream, mx, mw, a, g);
}

}  // namespace w8

// x (M, K) int8, wt (N, K) int8, both 16-byte aligned; row_scale fp32
// (one value per row, or one value with row_stride 0), col_scale and bias
// (N,) fp32, out (M, N) bf16 (out_bf16) or fp32. The launch plan comes
// from the caller (ops/_igemm.py::matmul_plan): swap (the weight on
// wgmma's 64-row side), the tile's N width bn, the K slices of one
// cluster (1 to 8) and the blocks along x (every tile when split, else a
// persistent grid of at most one block per SM). Needs K % 16 == 0.
// Returns a cudaError_t.
extern "C" int cassmantle_int8_matmul(const void* x, const void* wt,
                                      const void* row_scale,
                                      long long row_stride,
                                      const void* col_scale,
                                      const void* bias, void* out,
                                      int out_bf16, int m, int k, int n,
                                      int swap, int bn, int slices,
                                      int blocks, void* stream) {
  const int k_tiles = (k + w8::KT - 1) / w8::KT;
  if (m < 1 || n < 1 || k < 16 || k % 16 || slices < 1 || slices > 8 ||
      slices > k_tiles || bias == nullptr) {
    return (int)cudaErrorInvalidValue;
  }
  const uintptr_t sb = reinterpret_cast<uintptr_t>(col_scale) |
                       reinterpret_cast<uintptr_t>(bias);
  w8::Args a{static_cast<const float*>(row_scale), row_stride,
             static_cast<const float*>(col_scale),
             static_cast<const float*>(bias), out, out_bf16, m, n, k_tiles,
             n % 2 == 0 && sb % 8 == 0, n % 8 == 0 && sb % 16 == 0};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int g = blocks;
  if (swap) {
    switch (bn) {
      case 8: return (int)w8::launch<true, 8>(x, wt, a, k, slices, g, s);
      case 32: return (int)w8::launch<true, 32>(x, wt, a, k, slices, g, s);
      case 128: return (int)w8::launch<true, 128>(x, wt, a, k, slices, g, s);
      case 160: return (int)w8::launch<true, 160>(x, wt, a, k, slices, g, s);
    }
  } else {
    switch (bn) {
      case 128: return (int)w8::launch<false, 128>(x, wt, a, k, slices, g, s);
      case 160: return (int)w8::launch<false, 160>(x, wt, a, k, slices, g, s);
    }
  }
  return (int)cudaErrorInvalidValue;
}

// x (B, H, W, C) int8 NHWC, w (F, 3, 3, C) int8 (OHWI), both 16-byte
// aligned; col_scale and bias (F,) fp32, out (B, H, W, F) bf16 (out_bf16)
// or fp32. The launch plan comes from the caller
// (ops/_igemm.py::int8_conv_plan): the consumer warpgroups wgs (64
// pixels each), the pixel tile (imgs images x
// rows rows x cols columns), the K slices of one cluster (1 to 8) and
// the blocks along x. Needs C % 16 == 0. Returns a cudaError_t.
extern "C" int cassmantle_int8_conv3x3(const void* x, const void* w,
                                       const void* col_scale,
                                       const void* bias, void* out,
                                       int out_bf16, int batch, int h,
                                       int width, int c, int f, int wgs,
                                       int imgs, int rows, int cols,
                                       int slices, int blocks, void* stream) {
  const int chunks = (c + w8::KT - 1) / w8::KT;
  if (batch < 1 || h < 1 || width < 1 || c < 16 || c % 16 || f < 1 ||
      imgs < 1 || rows < 1 || cols < 1 || (imgs > 1 && rows != h) ||
      (cols < width && (rows > 1 || imgs > 1)) || cols > width ||
      rows > h || imgs > batch || slices < 1 || slices > 8 ||
      slices > 9 * chunks || bias == nullptr) {
    return (int)cudaErrorInvalidValue;
  }
  CUtensorMap map_x, map_w;
  const uint64_t xd[4] = {(uint64_t)c, (uint64_t)width, (uint64_t)h,
                          (uint64_t)batch};
  const uint64_t xs[3] = {(uint64_t)c, (uint64_t)width * c,
                          (uint64_t)h * width * c};
  const uint32_t xb[4] = {w8::KT, (uint32_t)cols, (uint32_t)rows,
                          (uint32_t)imgs};
  const uint64_t wd[3] = {(uint64_t)c, 9, (uint64_t)f};
  const uint64_t ws[2] = {(uint64_t)c, (uint64_t)c * 9};
  const uint32_t wb[3] = {w8::KT, 1, (uint32_t)w8::CONV_BN};
  if (!hopper::encode_map(&map_x, CU_TENSOR_MAP_DATA_TYPE_UINT8, 4, x, xd,
                          xs, xb, true) ||
      !hopper::encode_map(&map_w, CU_TENSOR_MAP_DATA_TYPE_UINT8, 3, w, wd,
                          ws, wb, true)) {
    return (int)cudaErrorInvalidValue;
  }
  const uintptr_t sb = reinterpret_cast<uintptr_t>(col_scale) |
                       reinterpret_cast<uintptr_t>(bias);
  const int m = batch * h * width;
  w8::Args a{nullptr, 0, static_cast<const float*>(col_scale),
             static_cast<const float*>(bias), out, out_bf16, m, f, 9 * chunks,
             f % 2 == 0 && sb % 8 == 0, f % 8 == 0 && sb % 16 == 0};
  const w8::ConvGeo g{batch, h, width, c, imgs, rows, cols,
                      (batch + imgs - 1) / imgs, (h + rows - 1) / rows,
                      (width + cols - 1) / cols, 9 * chunks};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int tail = c % w8::KT == 0 || c % w8::KT > 64 ? 4 : 2;
#define CASSMANTLE_INT8_CONV(WGS, TAIL)                                      \
  if (wgs == WGS && tail == TAIL) {                                         \
    return (int)w8::launch_conv<WGS, TAIL>(map_x, map_w, a, g, slices,      \
                                           blocks, s);                      \
  }
  CASSMANTLE_INT8_CONV(2, 4)
  CASSMANTLE_INT8_CONV(2, 2)
  CASSMANTLE_INT8_CONV(1, 4)
  CASSMANTLE_INT8_CONV(1, 2)
#undef CASSMANTLE_INT8_CONV
  return (int)cudaErrorInvalidValue;
}
