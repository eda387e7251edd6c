"""CassMantle's inference path in PyTorch on an NVIDIA H100.

The port of ``cassmantle_tpu`` (JAX on a TPU) to PyTorch and CUDA. It
serves one game round through :class:`serving.service.InferenceService`:
GPT-2 prompt text, an SD1.5 image (CLIP -> 50-step CFG DDIM -> VAE),
MiniLM guess scoring and the reveal blur. Attention in the UNet and VAE
runs on a hand-written CUDA kernel (``csrc/flash_attention.cu``).
"""
