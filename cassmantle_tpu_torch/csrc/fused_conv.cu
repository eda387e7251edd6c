// Fused GroupNorm affine + SiLU + conv3x3 for Hopper (sm_90a), bf16.
//
// Replaces: cassmantle_tpu/ops/fused_conv.py::_fused_kernel (reached
// through _fused_bhwc and gn_silu_conv3x3). It computes
//     out = conv3x3(silu(x * a + b)) + bias
// over an NHWC bf16 image (stride 1, SAME zero padding of the activated
// tensor), with the per-(batch, channel) fp32 GroupNorm affine a, b: the
// affine and SiLU in fp32, rounded to bf16, products accumulated in fp32,
// the bias added in fp32 and the sum rounded to bf16, as the Pallas
// kernel does. The TPU path's channel padding (pad_to) is not needed
// here: the K tiles of one tap are 32 channels wide and every SD1.5
// channel count (320 ... 2560) is a multiple of 32; other counts (C % 8
// == 0) mask the last tile.
//
// What bounds it (bf16, H100 SXM: 989 TFLOP/s, 3.35 TB/s; 18*M*C*F FLOPs
// for M = B*H*W pixels; x, the weight and the output once each): the
// SD1.5-512 UNet's 14 shapes carry 0.6 to 1.9 GFLOP on 1.5 to 59 MB, so
// the 64x64 and 32x32 levels are compute-bound (about 15 us at the peak)
// and the 8x8 levels, whose 2560 x 1280 weights dominate the bytes, are
// memory-bound (about 18 us).
//
// What the design does about it: the activated tensor, which the
// unfused path writes and reads back in full before each conv, never
// reaches device memory; it is made in the A-operand prologue of an
// implicit GEMM on the tensor cores (igemm.cuh, gn_conv_kernel): a block
// owns whole image rows, activates each 32-channel chunk of them once,
// with a one-pixel halo, into shared memory, and runs the nine taps
// against that tile. The 8x8 and 16x16 levels give few 128 x 128 output
// tiles, so their long K loop (9 x C) splits across blocks (split K) to
// keep the SMs busy. Not yet used: overlapping the halo build with the
// previous chunk's products, deeper pipelining, wgmma and TMA.

#include "igemm.cuh"

// x (B, H, W, C) bf16 NHWC, a and b (B, C) fp32, w (F, 3, 3, C) bf16,
// bias (F,) fp32, out (B, H, W, F) bf16, all contiguous; ws (splits,
// B*H*W, F) fp32 when splits > 1. Needs C % 8 == 0. Returns a
// cudaError_t.
extern "C" int cassmantle_gn_silu_conv3x3_bf16(
    const void* x, const void* a, const void* b, const void* w,
    const void* bias, void* out, void* ws, int batch, int h, int width,
    int c, int f, int splits, void* stream) {
  if (batch < 1 || h < 1 || width < 1 || c < 8 || c % 8 || f < 1) {
    return (int)cudaErrorInvalidValue;
  }
  igemm::Params p{};
  p.x = x;
  p.w = w;
  p.gn_a = static_cast<const float*>(a);
  p.gn_b = static_cast<const float*>(b);
  p.bias = static_cast<const float*>(bias);
  p.out = out;
  p.out_bf16 = 1;
  p.ws = ws;
  p.m = batch * h * width;
  p.n = f;
  p.k = c;
  p.img_h = h;
  p.img_w = width;
  p.k_tiles = 9 * ((c + 31) / 32);
  return (int)igemm::run<igemm::kConvBf16Gn>(
      p, splits, static_cast<cudaStream_t>(stream));
}
