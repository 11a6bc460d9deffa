"""rocjpeg_tpu_torch — the PyTorch/CUDA port of rocjpeg_tpu.

The batched on-device decode path (wave entropy decode, DC fixup +
dequant + 8x8 IDCT, output epilogue) runs on an NVIDIA Hopper GPU through
hand-written CUDA kernels (``kernels/``), with a plain PyTorch version of
every kernel beside it for CPU tensors. The JAX package ``rocjpeg_tpu``
stays the reference the port is held against.

The port reuses the reference's jax-free host layer by import: the JPEG
parser (``rocjpeg_tpu.core``), the native C++ host library
(``rocjpeg_tpu.runtime.native``), ``status`` and ``types``. Importing any
``rocjpeg_tpu`` module first runs ``rocjpeg_tpu/__init__.py``, which imports
jax to configure its compile cache unless ``ROCJPEG_TPU_NO_COMPILE_CACHE``
is set. So the first import of ``rocjpeg_tpu`` happens here with that
variable set, and the environment is restored right after: a process that
also uses the JAX package (or a subprocess it spawns) keeps its compile
cache, and this package never pulls in jax.
"""

import os as _os
import sys as _sys


def _import_host_layer() -> None:
    if "rocjpeg_tpu" in _sys.modules:
        return
    key = "ROCJPEG_TPU_NO_COMPILE_CACHE"
    saved = _os.environ.get(key)
    _os.environ[key] = "1"
    try:
        import rocjpeg_tpu  # noqa: F401
    finally:
        if saved is None:
            del _os.environ[key]
        else:
            _os.environ[key] = saved


_import_host_layer()

from rocjpeg_tpu.status import RocJpegError, Status  # noqa: E402
from rocjpeg_tpu.types import (ChromaSubsampling, CropRectangle,  # noqa: E402
                               DecodeParams, OutputFormat)

__all__ = ["RocJpegError", "Status", "OutputFormat", "DecodeParams",
           "CropRectangle", "ChromaSubsampling"]
