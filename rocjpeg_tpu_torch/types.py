"""Public enums and parameter structs, and the GPU decode spec.

The port's own re-expression of the reference C API types
(``api/rocjpeg.h``); member names and integer values equal the JAX
package's ``rocjpeg_tpu.types``:

- :class:`ChromaSubsampling`  ← ``RocJpegChromaSubsampling`` (rocjpeg.h:86-94)
- :class:`OutputFormat`       ← ``RocJpegOutputFormat``      (rocjpeg.h:124-141)
- :class:`CropRectangle` / :class:`DecodeParams` ← ``RocJpegDecodeParams`` (rocjpeg.h:153-166)
- :class:`DecodedImage`       ← ``RocJpegImage``             (rocjpeg.h:104-107)
- :class:`GpuDecodeSpec`      ← the per-arch ``VcnJpegSpec``
"""

from __future__ import annotations

import dataclasses
import enum

MAX_COMPONENT = 4  # ROCJPEG_MAX_COMPONENT (rocjpeg.h:46)


class ChromaSubsampling(enum.IntEnum):
    """Chroma subsampling; values match ``RocJpegChromaSubsampling``
    (rocjpeg.h:86-94)."""

    CSS_444 = 0
    CSS_440 = 1
    CSS_422 = 2
    CSS_420 = 3
    CSS_411 = 4
    CSS_400 = 5
    CSS_UNKNOWN = -1


class OutputFormat(enum.IntEnum):
    """Decode output formats; values match ``RocJpegOutputFormat``
    (rocjpeg.h:124-141).

    - NATIVE: surface-native plane layout per subsampling —
      444→three planes (444P), 440→three planes with half-height chroma (422V),
      422→packed YUYV single channel, 420→Y plane + interleaved UV (NV12),
      400→single Y plane (Y800).  (rocjpeg.h:125-130)
    - YUV_PLANAR: separate Y, U, V planes at their subsampled dimensions.
    - Y: luma only.
    - RGB: packed interleaved RGB in channel 0 (pitch ≥ 3*width).
    - RGB_PLANAR: R, G, B in channels 0..2.
    """

    NATIVE = 0
    YUV_PLANAR = 1
    Y = 2
    RGB = 3
    RGB_PLANAR = 4


@dataclasses.dataclass(frozen=True)
class CropRectangle:
    """Crop ROI; mirrors ``RocJpegDecodeParams.crop_rectangle``
    (rocjpeg.h:155-160). A ROI is *valid* iff 0 < right-left <= width and
    0 < bottom-top <= height (validity rule from src/rocjpeg_decoder.cpp:123-131);
    otherwise the full image is returned."""

    left: int = 0
    top: int = 0
    right: int = 0
    bottom: int = 0

    @property
    def width(self) -> int:
        """Crop width in pixels (``right - left``)."""
        return self.right - self.left

    @property
    def height(self) -> int:
        """Crop height in pixels (``bottom - top``)."""
        return self.bottom - self.top


@dataclasses.dataclass(frozen=True)
class DecodeParams:
    """Decode parameters; mirrors ``RocJpegDecodeParams`` (rocjpeg.h:153-166).
    ``target_dimension`` is declared "(future use)" by the reference and is
    likewise accepted-but-ignored here."""

    output_format: OutputFormat = OutputFormat.NATIVE
    crop_rectangle: CropRectangle = dataclasses.field(default_factory=CropRectangle)
    target_width: int = 0
    target_height: int = 0


@dataclasses.dataclass
class DecodedImage:
    """Decoded output; mirrors ``RocJpegImage`` (rocjpeg.h:104-107).

    ``channel[i]`` holds a 2-D uint8 tensor on the decoder's device. ``pitch[i]`` is
    the row stride in bytes of the returned tensor (== its width in elements;
    unlike the C API the framework allocates outputs, so pitch is always
    tight). Packed formats (YUYV, RGB interleaved) occupy channel 0 with
    pitch 2*W / 3*W respectively, matching the reference layout.
    """

    channel: list  # list[Optional[array]] length MAX_COMPONENT
    pitch: list  # list[int] length MAX_COMPONENT

    @classmethod
    def empty(cls) -> "DecodedImage":
        """A DecodedImage with all channels None and pitches 0 (the caller
        fills channels and pitches)."""
        return cls(channel=[None] * MAX_COMPONENT, pitch=[0] * MAX_COMPONENT)


@dataclasses.dataclass(frozen=True)
class ImageInfo:
    """Result of ``Decoder.get_image_info``; mirrors the out-params of
    ``rocJpegGetImageInfo`` (rocjpeg.h:276-296, src/rocjpeg_decoder.cpp:307-358).

    ``widths``/``heights`` are per-channel arrays of length 4 with the exact
    reference semantics (chroma dims are floor-divided; 400 zeroes chroma)."""

    num_components: int
    subsampling: ChromaSubsampling
    widths: tuple
    heights: tuple


@dataclasses.dataclass(frozen=True)
class GpuDecodeSpec:
    """Per-device decode capability spec (the analog of the reference's
    per-arch ``VcnJpegSpec``): resolution limits and the batch-chunk width
    ``decode_batched`` uses.

    ``num_decode_lanes`` is the batch-chunk width of ``decode_batched``
    (the reference chunks by ``num_jpeg_cores``). 16 is a default, the
    bench's batch, not a measurement: the width that saturates one H100
    has not been measured yet.
    """

    name: str = "cuda"
    num_decode_lanes: int = 16
    min_width: int = 64  # reference min 64x64
    min_height: int = 64
    max_width: int = 16384
    max_height: int = 16384
