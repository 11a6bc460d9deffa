"""rocjpeg_tpu_torch — the PyTorch/CUDA port of rocjpeg_tpu.

The batched on-device decode path (wave entropy decode, DC fixup +
dequant + 8x8 IDCT, output epilogue) runs on an NVIDIA Hopper GPU through
hand-written CUDA kernels (``kernels/``), with a plain PyTorch version of
every kernel beside it for CPU tensors. The JAX package ``rocjpeg_tpu``
stays the reference the port is held against.

The package is self-contained: it imports torch and numpy, and nothing of
jax or of ``rocjpeg_tpu``. It keeps its own copy of the host layer — the
JPEG parser (``core/``), the C++ host library and its bindings
(``csrc/host/``, ``runtime/``), ``status`` and ``types`` — and its own test
encoder and numpy reference decode (``testing/``).
"""

from .status import RocJpegError, Status
from .types import (ChromaSubsampling, CropRectangle, DecodeParams,
                    OutputFormat)

__all__ = ["RocJpegError", "Status", "OutputFormat", "DecodeParams",
           "CropRectangle", "ChromaSubsampling"]
