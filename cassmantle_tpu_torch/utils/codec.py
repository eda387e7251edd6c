"""Host-side image codec: uint8 arrays <-> JPEG bytes <-> base64.

A copy of ``cassmantle_tpu/utils/codec.py``. Round images are stored as
JPEG bytes (resume-on-restart through the store); the blur runs on the
device (``ops/blur.py``), so the codec boundary is uint8 HWC arrays.
"""

from __future__ import annotations

import base64
import io

import numpy as np
from PIL import Image


def encode_jpeg(image: np.ndarray, quality: int = 90) -> bytes:
    """uint8 HWC RGB array -> JPEG bytes."""
    arr = np.asarray(image)
    if arr.dtype != np.uint8:
        arr = np.clip(arr, 0, 255).astype(np.uint8)
    buf = io.BytesIO()
    Image.fromarray(arr).save(buf, format="JPEG", quality=quality)
    return buf.getvalue()


def decode_jpeg(data: bytes) -> np.ndarray:
    """JPEG bytes -> uint8 HWC RGB array."""
    return np.asarray(Image.open(io.BytesIO(data)).convert("RGB"))


def image_to_base64(image: np.ndarray, quality: int = 90) -> str:
    return base64.b64encode(encode_jpeg(image, quality)).decode()
