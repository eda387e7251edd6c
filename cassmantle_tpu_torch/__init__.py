"""CassMantle's inference path in PyTorch on an NVIDIA H100.

The port of ``cassmantle_tpu`` (JAX on a TPU) to PyTorch and CUDA. It
serves the game's rounds through :class:`serving.service.InferenceService`:
prompt text (GPT-2 or Mistral-7B), an image (SD1.5 or SDXL under each of
the reference's sampler presets, and img2img), MiniLM guess scoring and
the reveal blur, behind the reference's serving seam: batching queues,
adaptive admission, a supervisor with breakers, a dispatch watchdog and a
device-loss state, integrity sentinels, device-loss recovery and the
int8 wordlist table. The four TPU kernels run as hand-written CUDA
kernels (``csrc/``), the hot loops as captured CUDA graphs.
"""
