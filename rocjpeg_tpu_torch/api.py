"""Session API of the port — ``JpegStream`` and ``Decoder``.

Port of ``rocjpeg_tpu/api.py`` (itself the mirror of the rocJPEG C API):
``get_image_info``, ``decode`` and ``decode_batched`` with the same
validation, shape grouping, chunking by the spec's lane budget, choice of
entropy path, fallbacks, deferred error check and per-call records
(``last_paths``, ``last_error_flags``, ``last_failed_indices``). Channels
are per-image views into batched tensors on the decoder's device.

Not ported yet: the in-flight throttle, ``decode_into`` and
``synchronize``.
"""

from __future__ import annotations

import threading
from typing import List, Optional, Sequence

import numpy as np
import torch

from . import pipeline
from .core.bitstream import JpegStreamParams, JpegStreamParser
from .runtime import host_decode
from .status import RocJpegError, Status
from .types import (ChromaSubsampling, DecodedImage, DecodeParams,
                    GpuDecodeSpec, ImageInfo, OutputFormat)

CSS = ChromaSubsampling

# Minimum symbols per virtual-restart lane of a DRI=0 scan (the JAX
# package's default; fewer, longer lanes mean less host bookkeeping).
VIRTUAL_SYMBOLS = 768


def _fallback_statuses(virtual_k):
    """Statuses of pipeline.pack_group that send a group to the host path."""
    if virtual_k:
        return (Status.JPEG_NOT_SUPPORTED, Status.BAD_JPEG)
    return (Status.JPEG_NOT_SUPPORTED,)


class JpegStream:
    """A parsed-JPEG session handle (RocJpegStreamHandle analog)."""

    def __init__(self, data: Optional[bytes] = None):
        self._parser = JpegStreamParser()
        if data is not None:
            self.parse(data)

    def parse(self, data: bytes) -> "JpegStream":
        """rocJpegStreamParse analog; raises RocJpegError(BAD_JPEG) on
        malformed input."""
        self._parser.parse(data)
        return self

    @property
    def params(self) -> JpegStreamParams:
        """Parsed stream parameters (raises if not parsed yet)."""
        return self._parser.params


def _resolve_device(device) -> torch.device:
    if device is None:
        if not torch.cuda.is_available():
            raise RocJpegError(Status.NOT_INITIALIZED,
                               "no CUDA device is available")
        return torch.device("cuda", 0)
    dev = torch.device(device)
    if dev.type == "cpu":
        return dev
    if dev.type != "cuda":
        raise RocJpegError(Status.INVALID_PARAMETER,
                           f"unsupported device {device!r}")
    index = dev.index or 0
    if not torch.cuda.is_available() or index >= torch.cuda.device_count():
        raise RocJpegError(Status.NOT_INITIALIZED,
                           f"CUDA device {index} is not available")
    return torch.device("cuda", index)


class Decoder:
    """A decode session handle (RocJpegHandle analog).

    device: ``None`` means ``cuda:0`` and raises NOT_INITIALIZED when CUDA
    is absent — there is no silent CPU fallback. ``"cpu"`` runs every
    kernel's plain PyTorch version (tests).
    device_entropy: 'on' | 'off' | 'auto' — as in rocjpeg_tpu: 'on' runs
    the entropy decode on the device, 'auto' only with >= 64 lanes in the
    group, 'off' always on the host.
    check_errors: when True, each decode_batched call reads the device
    error flags (one sync) and raises BAD_JPEG for a corrupt scan."""

    def __init__(self, device=None, device_entropy: str = "auto",
                 check_errors: bool = True):
        self._device = _resolve_device(device)
        name = (torch.cuda.get_device_name(self._device)
                if self._device.type == "cuda" else "cpu")
        self._spec = GpuDecodeSpec(name=name)
        if device_entropy not in ("on", "off", "auto"):
            raise RocJpegError(Status.INVALID_PARAMETER,
                               f"bad device_entropy mode {device_entropy!r}")
        self._device_entropy = device_entropy
        self._check_errors = check_errors
        self._tls = threading.local()  # per-thread records of the last call

    @property
    def spec(self) -> GpuDecodeSpec:
        """Decode capability spec (GetCurrentVcnJpegSpec analog)."""
        return self._spec

    @property
    def last_error_flags(self) -> list:
        """Per-lane device error flags of the calling thread's last
        decode_batched call, one tensor per device-entropy chunk."""
        return [err for err, _, _ in getattr(self._tls, "error_lanes", [])]

    @property
    def last_paths(self) -> list:
        """Per-chunk (path, batch_indices) of the calling thread's last
        decode_batched call; path is 'host', 'wave' (real restart lanes)
        or 'wave-virtual' (host index walk + virtual restarts)."""
        return getattr(self._tls, "paths", [])

    def last_failed_indices(self) -> list:
        """Batch indices of images whose scans the device wave flagged as
        corrupt in the calling thread's last decode_batched call (reads
        the device flags: one sync)."""
        bad = set()
        for err, lane_img, idxs in getattr(self._tls, "error_lanes", []):
            flags = err.cpu().numpy()
            if not flags.any():
                continue
            for li in np.unique(lane_img[np.nonzero(flags)[0]]):
                if 0 <= li < len(idxs):
                    bad.add(idxs[li])
        return sorted(bad)

    def get_image_info(self, stream: JpegStream) -> ImageInfo:
        """rocJpegGetImageInfo analog (floor-divided chroma dims, zeroed
        chroma for 4:0:0)."""
        if stream is None:
            raise RocJpegError(Status.INVALID_PARAMETER, "stream is None")
        p = stream.params
        w0, h0 = p.picture_width, p.picture_height
        widths = [w0, 0, 0, 0]
        heights = [h0, 0, 0, 0]
        css = p.chroma_subsampling
        chroma = {CSS.CSS_444: (w0, h0), CSS.CSS_440: (w0, h0 >> 1),
                  CSS.CSS_422: (w0 >> 1, h0), CSS.CSS_420: (w0 >> 1, h0 >> 1),
                  CSS.CSS_411: (w0 >> 2, h0)}.get(css)
        if chroma is not None:
            widths[1] = widths[2] = chroma[0]
            heights[1] = heights[2] = chroma[1]
        return ImageInfo(num_components=p.num_components, subsampling=css,
                         widths=tuple(widths), heights=tuple(heights))

    def _validate(self, p: JpegStreamParams) -> None:
        s = self._spec
        if (p.picture_width < s.min_width or p.picture_height < s.min_height
                or p.picture_width > s.max_width
                or p.picture_height > s.max_height):
            raise RocJpegError(Status.JPEG_NOT_SUPPORTED,
                               "the JPEG image resolution is not supported")
        if p.chroma_subsampling in (CSS.CSS_411, CSS.CSS_UNKNOWN):
            raise RocJpegError(Status.JPEG_NOT_SUPPORTED,
                               "the chroma subsampling is not supported")

    @staticmethod
    def _virtual_k(plist) -> Optional[int]:
        """Virtual-restart symbol budget for an all-DRI=0 group, else None."""
        if not all(p.restart_interval == 0 for p in plist):
            return None
        return VIRTUAL_SYMBOLS

    def _group_device_eligible(self, plist, virtual_k=None) -> bool:
        """Whether the device wave should decode this group."""
        if self._device_entropy == "on":
            return True
        # 'auto': only with enough parallel lanes (restart segments, real
        # or virtual) across the group.
        segs = 0
        for p in plist:
            interleaved = len(p.scan_components) > 1
            nslots = (sum(c.h_sampling_factor * c.v_sampling_factor
                          for c in p.components) if interleaved else 1)
            total = p.num_mcus if interleaved else (
                ((p.picture_width + 7) // 8) * ((p.picture_height + 7) // 8))
            if p.restart_interval > 0:
                segs += -(-total // p.restart_interval)
            elif virtual_k:
                # >= 2 symbols per block (DC + EOB) is the per-MCU floor.
                segs += total * nslots * 2 // virtual_k
            else:
                segs += 1
        return segs >= 64

    def decode(self, stream: JpegStream,
               params: Optional[DecodeParams] = None) -> DecodedImage:
        """rocJpegDecode analog."""
        return self.decode_batched([stream], params)[0]

    def decode_batched(self, streams: Sequence[JpegStream],
                       params: Optional[DecodeParams] = None
                       ) -> List[DecodedImage]:
        """rocJpegDecodeBatched analog: group the batch by shape, chunk
        each group by the spec's lane budget, and decode each chunk as one
        batched device pass."""
        if streams is None or any(s is None for s in streams):
            raise RocJpegError(Status.INVALID_PARAMETER, "null stream handle")
        params = params or DecodeParams()
        fmt = OutputFormat(params.output_format)
        stream_params = [s.params for s in streams]
        for p in stream_params:
            self._validate(p)

        groups = {}
        for idx, p in enumerate(stream_params):
            key = (p.chroma_subsampling, p.picture_width, p.picture_height,
                   tuple(c.h_sampling_factor for c in p.components),
                   tuple(c.v_sampling_factor for c in p.components))
            groups.setdefault(key, []).append(idx)
        chunk_w = max(1, int(self._spec.num_decode_lanes))
        chunks = [idxs[lo:lo + chunk_w] for idxs in groups.values()
                  for lo in range(0, len(idxs), chunk_w)]

        use_dev = self._device_entropy != "off"
        results: List[Optional[DecodedImage]] = [None] * len(streams)
        err_lanes, paths = [], []  # err_lanes: (err, lane_img, idxs)
        for idxs in chunks:
            plist = [stream_params[i] for i in idxs]
            p0 = plist[0]
            crop = params.crop_rectangle
            if crop is not None and not (
                    0 < crop.width <= p0.picture_width
                    and 0 < crop.height <= p0.picture_height):
                crop = None  # invalid ROI: decode the full image
            vk = self._virtual_k(plist) if use_dev else None
            per_image = None
            if use_dev and self._group_device_eligible(plist, vk):
                try:
                    packed = pipeline.pack_group(plist, self._device, crop,
                                                 virtual_k=vk)
                except RocJpegError as exc:
                    # Only the host packer's refusals fall back: past the
                    # table-bank capacity, or a stream the virtual-restart
                    # walk rejected (the host path reports corrupt scans
                    # precisely). A kernel wrapper's refusal propagates.
                    if exc.status not in _fallback_statuses(vk):
                        raise
                else:
                    per_image, err = pipeline.decode_group_device_entropy(
                        packed, plist, fmt, crop)
                    paths.append(("wave-virtual" if vk else "wave", idxs))
                    err_lanes.append((err, packed.lane_img, idxs))
            if per_image is None:
                paths.append(("host", idxs))
                coeffs = host_decode.decode_coefficients_batch(plist)
                per_image = pipeline.decode_group(plist, coeffs, fmt,
                                                  self._device, crop)
            for i, chans in zip(idxs, per_image):
                img = DecodedImage.empty()
                for ci, (arr, pitch) in enumerate(chans):
                    img.channel[ci] = arr
                    img.pitch[ci] = pitch
                results[i] = img

        self._tls.error_lanes = err_lanes
        self._tls.paths = paths
        if self._check_errors and any(bool(e.any()) for e, _, _ in err_lanes):
            raise RocJpegError(
                Status.BAD_JPEG,
                "on-device entropy decode failed (corrupt scan) in batch "
                f"image(s) {self.last_failed_indices()}")
        return results
