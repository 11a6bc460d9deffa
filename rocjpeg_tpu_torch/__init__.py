"""rocjpeg_tpu_torch — the PyTorch/CUDA port of rocjpeg_tpu.

The batched on-device decode path (wave entropy decode, DC fixup +
dequant + 8x8 IDCT, output epilogue) behind the session API
(``api.Decoder``: ``decode_batched``, ``decode_into``, ``synchronize``)
runs on an NVIDIA Hopper GPU through hand-written CUDA kernels
(``kernels/``), with a plain PyTorch version of every kernel beside it for
CPU tensors. The JAX package ``rocjpeg_tpu`` stays the reference the port
is held against.

The package is self-contained: it imports torch and numpy, and nothing of
jax or of ``rocjpeg_tpu``. It keeps its own copy of the host layer — the
JPEG parser (``core/``), the C++ host library and its bindings
(``csrc/host/``, ``runtime/``), ``status`` and ``types`` — and its own test
encoder and numpy reference decode (``testing/``).
"""

from .status import RocJpegError, Status, get_error_name
from .types import (Backend, ChromaSubsampling, CropRectangle, DecodedImage,
                    DecodeParams, GpuDecodeSpec, ImageInfo, OutputFormat)

__all__ = ["RocJpegError", "Status", "get_error_name", "OutputFormat",
           "DecodeParams", "DecodedImage", "ImageInfo", "GpuDecodeSpec",
           "CropRectangle", "ChromaSubsampling", "Backend"]
