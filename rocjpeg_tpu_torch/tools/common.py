"""Shared CLI utilities for the sample tools.

Re-expression of samples/rocjpeg_samples_utils.h: flag parsing (:89-179),
JPEG magic sniffing (IsJPEG, :187-200), recursive directory walk
(GetFilePaths, :213-234), output-file naming (GetOutputFileExt, :413-464)
and raw-plane dumping (SaveImage, :479-628), plus the decoder construction
and the skip rule the three tools share.
"""

from __future__ import annotations

import argparse
import os
from typing import List, Optional

import numpy as np
import torch

from .. import api
from ..status import RocJpegError
from ..types import ChromaSubsampling as CSS
from ..types import CropRectangle, DecodeParams, ImageInfo, OutputFormat
from ..utils import log

FMT_NAMES = {
    "native": OutputFormat.NATIVE,
    "yuv_planar": OutputFormat.YUV_PLANAR,   # reference spelling
    "yuv": OutputFormat.YUV_PLANAR,          # convenience alias
    "y": OutputFormat.Y,
    "rgb": OutputFormat.RGB,
    "rgb_planar": OutputFormat.RGB_PLANAR,
}


def _device_arg(text: str):
    """``-d``: a CUDA device index, or ``cpu``."""
    return "cpu" if text == "cpu" else int(text)


def build_arg_parser(description: str, batched: bool = False,
                     threaded: bool = False) -> argparse.ArgumentParser:
    """Flags mirror the reference samples (samples_utils.h:89-179):
    -i input, -o output, -d device, -be backend, -fmt format, -b batch,
    -t threads, -crop l,t,r,b."""
    ap = argparse.ArgumentParser(description=description)
    ap.add_argument("-i", "--input", required=True,
                    help="input JPEG file or directory")
    ap.add_argument("-o", "--output", default=None,
                    help="output file prefix to save decoded images")
    ap.add_argument("-d", "--device", type=_device_arg, default=0,
                    help="CUDA device id, or 'cpu' to run every kernel's "
                         "plain PyTorch version on the host")
    ap.add_argument("-be", "--backend", type=int, default=0,
                    help="backend: 0=hardware (the CUDA device), 1=hybrid")
    ap.add_argument("-fmt", "--format", default="native",
                    choices=sorted(FMT_NAMES),
                    help="output format")
    ap.add_argument("-crop", "--crop", default=None,
                    help="crop rectangle as left,top,right,bottom")
    if batched or threaded:
        ap.add_argument("-b", "--batch_size", type=int, default=8)
    if threaded:
        ap.add_argument("-t", "--threads", type=int, default=2)
    return ap


def parse_decode_params(args) -> DecodeParams:
    crop = None
    if args.crop:
        l, t, r, b = (int(x) for x in args.crop.split(","))
        crop = CropRectangle(l, t, r, b)
    return DecodeParams(output_format=FMT_NAMES[args.format],
                        crop_rectangle=crop or CropRectangle())


def make_decoder(args) -> Optional[api.Decoder]:
    """The session the flags ask for, or None after printing why it could
    not be opened (no CUDA device without ``-d cpu``, a bad backend)."""
    device = "cpu" if args.device == "cpu" else None
    device_id = 0 if device else args.device
    try:
        return api.Decoder(backend=args.backend, device_id=device_id,
                           device=device)
    except RocJpegError as e:
        log.err(f"cannot open a decoder: {e}")
        return None


def skip_reason(decoder: api.Decoder, info: ImageInfo) -> Optional[str]:
    """The :class:`Stats` counter an image is skipped under, or None to
    decode it (jpegdecode.cpp:100-140)."""
    if info.subsampling == CSS.CSS_411:
        return "skip_411"
    if info.subsampling == CSS.CSS_UNKNOWN:
        return "skip_unknown"
    s = decoder.spec
    if not (s.min_width <= info.widths[0] <= s.max_width
            and s.min_height <= info.heights[0] <= s.max_height):
        return "skip_resolution"
    return None


def is_jpeg(path: str) -> bool:
    """Magic sniff, like IsJPEG (samples_utils.h:187-200)."""
    try:
        with open(path, "rb") as f:
            return f.read(2) == b"\xff\xd8"
    except OSError:
        return False


def get_file_paths(root: str) -> List[str]:
    """File, or recursive dir walk (GetFilePaths, samples_utils.h:213-234)."""
    if os.path.isfile(root):
        return [root]
    out = []
    for dirpath, _dirs, files in os.walk(root):
        for f in sorted(files):
            p = os.path.join(dirpath, f)
            if is_jpeg(p):
                out.append(p)
    return sorted(out)


def output_suffix(fmt: OutputFormat, css: CSS) -> str:
    """Naming descriptor per GetOutputFileExt (samples_utils.h:413-464)."""
    if fmt == OutputFormat.NATIVE:
        return {CSS.CSS_444: "444p", CSS.CSS_440: "422v", CSS.CSS_422: "yuyv",
                CSS.CSS_420: "nv12", CSS.CSS_400: "y800"}.get(css, "native") + ".yuv"
    if fmt == OutputFormat.YUV_PLANAR:
        return "planar.yuv"
    if fmt == OutputFormat.Y:
        return "y.yuv"
    if fmt == OutputFormat.RGB:
        return "packed.rgb"
    return "planar.rgb"


def save_image(prefix: str, src_path: str, image, width: int, height: int,
               fmt: OutputFormat, css: CSS) -> str:
    """Dump decoded channels as raw planes, named
    <prefix><base>_<W>x<H>_<desc> (SaveImage semantics,
    samples_utils.h:479-628: channels concatenated in order, each tight).
    A channel may be a view with a pitch on the device (a crop-only
    channel): it is brought to the host and made contiguous first."""
    base = os.path.splitext(os.path.basename(src_path))[0]
    name = f"{prefix}{base}_{width}x{height}_{output_suffix(fmt, css)}"
    with open(name, "wb") as f:
        for ch in image.channel:
            if ch is None:
                continue
            if isinstance(ch, torch.Tensor):
                ch = ch.cpu().numpy()
            f.write(np.ascontiguousarray(ch).tobytes())
    return name


class Stats:
    """Skip counters + throughput aggregation (jpegdecode.cpp:201-228)."""

    def __init__(self) -> None:
        self.decoded = 0
        self.total_ms = 0.0
        self.mpixels = 0.0
        self.skip_bad = 0
        self.skip_411 = 0
        self.skip_unknown = 0
        self.skip_resolution = 0

    def report(self) -> None:
        print(f"info: total decoded images: {self.decoded}")
        if self.skip_bad:
            print(f"info: skipped bad/corrupt images: {self.skip_bad}")
        if self.skip_411:
            print(f"info: skipped 4:1:1 images: {self.skip_411}")
        if self.skip_unknown:
            print(f"info: skipped unknown-subsampling images: {self.skip_unknown}")
        if self.skip_resolution:
            print(f"info: skipped unsupported-resolution images: {self.skip_resolution}")
        if self.decoded and self.total_ms > 0:
            avg_ms = self.total_ms / self.decoded
            ips = 1000.0 / avg_ms
            print(f"info: average decoding time per image (ms): {avg_ms:.4f}")
            print(f"info: avg images per sec: {ips:.4f}")
            print(f"info: avg decoded data size (Mpixels/sec): "
                  f"{self.mpixels / (self.total_ms / 1000.0):.4f}")
