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
// the 2 x 77-token cross-attention context) and N are masked; K and C
// need multiples of 16 (16-byte loads). The TPU path's padding of M, K
// and N to (32, 128) tiles is not needed.
//
// What bounds it (int8, H100 SXM: 1,979 TOP/s, 3.35 TB/s; 2*M*K*N or
// 18*M*C*F operations; operands and output once each): the UNet's matmuls
// at 8192 or 2048 tokens and its 64x64 and 32x32 convs are
// operation-bound (a few us each at the peak); its 8x8 convs, the
// cross-attention kv projection and every GPT-2 matmul (M = 1 in decode,
// 32 in prefill) are bound by the bytes of the weight.
//
// What the design does about it: an implicit GEMM (igemm.cuh, modes
// kMatmulS8 and kConvS8) on the int8 tensor cores (mma.sync m16n8k32),
// the conv reading its im2col in place from the NHWC image, so that the
// padded image and the im2col never reach device memory; split K where
// the output tiles are too few to fill the card (the 8x8 convs, decode).
// Not yet used: wgmma and TMA (mma.sync reaches about half of the int8
// peak), a small-M tile for decode, and fusing the activation quantize
// into the A-operand prologue.

#include "igemm.cuh"

// x (M, K) int8, wt (N, K) int8, row_scale fp32 (one value per row, or
// one value with row_stride 0), col_scale (N,) fp32, bias (N,) fp32 or
// null, out (M, N) bf16 (out_bf16) or fp32; ws (splits, M, N) int32 when
// splits > 1. Needs K % 16 == 0. Returns a cudaError_t.
extern "C" int cassmantle_int8_matmul(const void* x, const void* wt,
                                      const void* row_scale,
                                      long long row_stride,
                                      const void* col_scale,
                                      const void* bias, void* out, void* ws,
                                      int out_bf16, int m, int k, int n,
                                      int splits, void* stream) {
  if (m < 1 || n < 1 || k < 16 || k % 16) return (int)cudaErrorInvalidValue;
  igemm::Params p{};
  p.x = x;
  p.w = wt;
  p.row_scale = static_cast<const float*>(row_scale);
  p.row_stride = row_stride;
  p.col_scale = static_cast<const float*>(col_scale);
  p.bias = static_cast<const float*>(bias);
  p.out = out;
  p.out_bf16 = out_bf16;
  p.ws = ws;
  p.m = m;
  p.n = n;
  p.k = k;
  p.img_h = p.img_w = 1;
  p.k_tiles = (k + igemm::BKB - 1) / igemm::BKB;
  return (int)igemm::run<igemm::kMatmulS8>(
      p, splits, static_cast<cudaStream_t>(stream));
}

// x (B, H, W, C) int8 NHWC, w (F, 3, 3, C) int8, col_scale and bias (F,)
// fp32, out (B, H, W, F) bf16 (out_bf16) or fp32; ws (splits, B*H*W, F)
// int32 when splits > 1. Needs C % 16 == 0. Returns a cudaError_t.
extern "C" int cassmantle_int8_conv3x3(const void* x, const void* w,
                                       const void* col_scale,
                                       const void* bias, void* out,
                                       int out_bf16, void* ws, int batch,
                                       int h, int width, int c, int f,
                                       int splits, void* stream) {
  if (batch < 1 || h < 1 || width < 1 || c < 16 || c % 16 || f < 1) {
    return (int)cudaErrorInvalidValue;
  }
  igemm::Params p{};
  p.x = x;
  p.w = w;
  p.col_scale = static_cast<const float*>(col_scale);
  p.bias = static_cast<const float*>(bias);
  p.out = out;
  p.out_bf16 = out_bf16;
  p.ws = ws;
  p.m = batch * h * width;
  p.n = f;
  p.k = c;
  p.img_h = h;
  p.img_w = width;
  p.k_tiles = 9 * ((c + igemm::BKB - 1) / igemm::BKB);
  return (int)igemm::run<igemm::kConvS8>(
      p, splits, static_cast<cudaStream_t>(stream));
}
