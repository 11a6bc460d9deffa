"""Session API of the port — ``JpegStream`` and ``Decoder``.

Port of ``rocjpeg_tpu/api.py`` (itself the mirror of the rocJPEG C API):
``get_image_info``, ``decode``, ``decode_batched``, ``decode_into`` and
``synchronize`` with the same validation, shape grouping, chunking by the
spec's lane budget (and, unlike the JAX package, by K1's 32-bit
addressing: :func:`chunk_group`), choice of entropy path, fallbacks,
in-flight throttle, deferred error check and per-call records (``last_paths``,
``last_error_flags``, ``last_failed_indices``). Channels are per-image
views into batched tensors on the decoder's device; ``decode_into`` writes
caller-allocated buffers instead, on the host or on the device.
"""

from __future__ import annotations

import ctypes
import threading
from typing import List, Optional, Sequence

import numpy as np
import torch

from . import pipeline
from .core.bitstream import JpegStreamParams, JpegStreamParser
from .kernels import wave
from .kernels.epilogue import null_channel
from .ops.tables import GroupGeometry
from .runtime import host_decode
from .status import RocJpegError, Status
from .types import (MAX_COMPONENT, Backend, ChromaSubsampling, DecodedImage,
                    DecodeParams, GpuDecodeSpec, ImageInfo, OutputFormat,
                    spec_for_device)
from .utils.trace import span

CSS = ChromaSubsampling

# Minimum symbols per virtual-restart lane of a DRI=0 scan (the JAX
# package's default; fewer, longer lanes mean less host bookkeeping).
VIRTUAL_SYMBOLS = 768


def _fallback_statuses(virtual_k):
    """Statuses of pipeline.pack_group that send a group to the host path."""
    if virtual_k:
        return (Status.JPEG_NOT_SUPPORTED, Status.BAD_JPEG)
    return (Status.JPEG_NOT_SUPPORTED,)


def write_channel_into(arr, dest, pitch: int) -> None:
    """Copy one decoded channel into a caller's host buffer honouring the
    caller's pitch, as the JAX package's ``write_channel_into`` does.
    ``arr`` is a tensor (brought to the host) or an array; ``dest`` is a
    writable C-contiguous numpy buffer or a raw host pointer integer;
    ``pitch`` is the destination row pitch in bytes. Bytes past each row's
    end stay untouched."""
    if isinstance(arr, torch.Tensor):
        arr = arr.cpu().numpy()
    src = np.ascontiguousarray(arr)
    if src.ndim == 1:
        src = src[None, :]
    h, row_bytes = src.shape[0], src.shape[1] * src.itemsize
    if pitch < row_bytes:
        raise RocJpegError(Status.INVALID_PARAMETER,
                           f"destination pitch {pitch} < row size {row_bytes}")
    if isinstance(dest, (int, np.integer)):
        base = int(dest)
        if pitch == row_bytes:
            ctypes.memmove(base, src.ctypes.data, h * row_bytes)
        else:
            for r in range(h):
                ctypes.memmove(base + r * pitch,
                               src.ctypes.data + r * row_bytes, row_bytes)
    elif isinstance(dest, np.ndarray):
        if not dest.flags.writeable:
            raise RocJpegError(Status.INVALID_PARAMETER,
                               "destination buffer is read-only")
        if not dest.flags.c_contiguous:
            # reshape(-1) of a non-contiguous view copies: the write would
            # land in the copy. Padded layouts are expressed by the pitch.
            raise RocJpegError(Status.INVALID_PARAMETER,
                               "destination buffer must be C-contiguous "
                               "(pass the base buffer and express padding "
                               "via pitch)")
        flat = dest.reshape(-1).view(np.uint8)
        need = (h - 1) * pitch + row_bytes
        if flat.nbytes < need:
            raise RocJpegError(Status.INVALID_PARAMETER,
                               f"destination buffer {flat.nbytes}B < {need}B")
        rows = np.lib.stride_tricks.as_strided(
            flat, shape=(h, row_bytes), strides=(pitch, 1), subok=False)
        rows[:] = src.view(np.uint8).reshape(h, row_bytes)
    else:
        raise RocJpegError(Status.INVALID_PARAMETER, "null destination channel")


def shape_key(p: JpegStreamParams) -> tuple:
    """What a same-shape group shares: subsampling, picture size and
    sampling factors. ``decode_batched`` groups a batch by it."""
    return (p.chroma_subsampling, p.picture_width, p.picture_height,
            tuple(c.h_sampling_factor for c in p.components),
            tuple(c.v_sampling_factor for c in p.components))


def chunk_group(idxs: list, lanes: int, coeffs_per_image: int) -> list:
    """Split one same-shape group's batch indices into chunks of at most
    ``lanes`` images and at most ``kernels.wave.MAX_COEFFS`` coefficients
    (K1 addresses a chunk's coefficients with 32-bit indices). The JAX
    package chunks by count alone; on a card that holds 32 frames of 61
    Mpix at once, count alone would overrun K1's addressing."""
    width = max(1, min(lanes, wave.MAX_COEFFS // max(coeffs_per_image, 1)))
    return [idxs[lo:lo + width] for lo in range(0, len(idxs), width)]


def coefficients_per_image(p: JpegStreamParams) -> int:
    """Coefficients K1 writes for one image of ``p``'s shape group."""
    return GroupGeometry.from_params(p, 1).total_blocks * 64


def failed_indices(error_lanes) -> list:
    """Sorted batch indices of the images with a flagged lane, from the
    (err, lane_img, batch_indices) records of
    :meth:`Decoder._last_error_lanes` (reads the device flags: one sync a
    chunk)."""
    bad = set()
    for err, lane_img, idxs in error_lanes:
        flags = err.cpu().numpy()
        if not flags.any():
            continue
        for li in np.unique(lane_img[np.nonzero(flags)[0]]):
            if 0 <= li < len(idxs):
                bad.add(idxs[li])
    return sorted(bad)


class _DoneToken:
    """In-flight token of a CPU decoder: its chunk is complete when the
    call returns."""

    def synchronize(self) -> None:
        pass


class JpegStream:
    """A parsed-JPEG session handle (RocJpegStreamHandle analog)."""

    def __init__(self, data: Optional[bytes] = None):
        self._parser = JpegStreamParser()
        if data is not None:
            self.parse(data)

    def parse(self, data: bytes) -> "JpegStream":
        """rocJpegStreamParse analog; raises RocJpegError(BAD_JPEG) on
        malformed input."""
        with span("rjt.parse"):
            self._parser.parse(data)
        return self

    @property
    def params(self) -> JpegStreamParams:
        """Parsed stream parameters (raises if not parsed yet)."""
        return self._parser.params


def _resolve_device(device, device_id: int) -> torch.device:
    """The torch device of a session: ``device`` when given (``"cpu"``, a
    ``"cuda[:n]"`` string, a ``torch.device`` or a CUDA index), else
    ``cuda:device_id``. A CUDA device that is absent raises NOT_INITIALIZED
    (the reference's device-count check, decoder.cpp:48-57), anything else
    INVALID_PARAMETER; torch's own errors never escape."""
    if device is None:
        device = device_id
    if isinstance(device, int):
        kind, index = "cuda", device
    else:
        try:
            dev = torch.device(device)
        except (RuntimeError, TypeError, ValueError) as exc:
            raise RocJpegError(Status.INVALID_PARAMETER,
                               f"unsupported device {device!r}") from exc
        kind, index = dev.type, dev.index or 0
    if kind == "cpu":
        return torch.device("cpu")
    if kind != "cuda":
        raise RocJpegError(Status.INVALID_PARAMETER,
                           f"unsupported device {device!r}")
    if not torch.cuda.is_available():
        raise RocJpegError(Status.NOT_INITIALIZED,
                           "no CUDA device is available")
    count = torch.cuda.device_count()
    if not 0 <= index < count:
        raise RocJpegError(Status.NOT_INITIALIZED,
                           f"CUDA device {index} out of range ({count} "
                           "devices)")
    return torch.device("cuda", index)


class Decoder:
    """A decode session handle (RocJpegHandle analog).

    The arguments are the JAX package's, in its order.
    backend: HARDWARE; HYBRID raises NOT_IMPLEMENTED, any other value
    INVALID_PARAMETER (the reference's rocJpegCreate).
    device_id: the CUDA device; one that is absent, or no CUDA at all,
    raises NOT_INITIALIZED — there is no silent CPU fallback.
    device (keyword only): overrides ``device_id``; ``"cpu"`` runs every
    kernel's plain PyTorch version (tests).
    device_entropy: 'on' | 'off' | 'auto' — as in rocjpeg_tpu: 'on' runs
    the entropy decode on the device, 'auto' only with >= 64 lanes in the
    group, 'off' always on the host.
    check_errors: when True, each decode_batched call reads the device
    error flags (one sync) and raises BAD_JPEG for a corrupt scan. A DRI=0
    scan the index walk would refuse (an invalid code, or an end before
    its last MCU) raises BAD_JPEG either way, as the host path it falls
    back to does: on a card, where K0 finds such a scan, a call with DRI=0
    chunks reads K0's one flag a chunk without the error check too (one
    sync).
    spec: the decode capability spec; by default the device's own.

    A Decoder is safe for concurrent use. ``decode_batched`` returns without
    waiting for the device (but for the error reads above) and keeps at most ``_max_inflight`` chunks in
    flight: a slot is reserved before each chunk's dispatch and paired with
    a token, a ``torch.cuda.Event`` recorded on the current stream after
    the chunk's last launch (on a CPU decoder a token that is complete at
    once). What the depth bounds on a CUDA device is how many chunks the
    host may run ahead of the device, so how much queued work a
    ``synchronize`` or a read of a result waits for. It does not bound
    device memory: the results of every chunk are the caller's to keep, and
    the caching allocator hands a freed intermediate to the next chunk in
    stream order whether or not the first has run. The default of 2 is the
    JAX package's (whose reason, a stalling runtime past two queued wave
    programs, does not exist here); ``chip_smoke.py`` prints the time and
    peak memory of a many-chunk call at depth 1, 2 and 4.

    A chunk's host arrays are staged in one buffer of the process's staging
    pool (page-locked on a CUDA device) and uploaded by one copy on the
    current stream of the decoder's device, under that device whatever the
    calling thread's current one is; the buffer goes back to the pool with
    an event recorded after the copy, and no later chunk writes it before
    that event (``ops.staging``). Every ``Decoder`` of the process packs on
    one thread pool."""

    def __init__(self, backend: Backend = Backend.HARDWARE, device_id: int = 0,
                 spec: Optional[GpuDecodeSpec] = None,
                 device_entropy: str = "auto", check_errors: bool = True,
                 *, device=None):
        if backend == Backend.HYBRID:
            raise RocJpegError(Status.NOT_IMPLEMENTED,
                               "HYBRID backend is not implemented")
        if backend != Backend.HARDWARE:
            raise RocJpegError(Status.INVALID_PARAMETER,
                               f"unknown backend {backend!r}")
        self._device = _resolve_device(device, device_id)
        self._spec = spec or spec_for_device(self._device)
        if device_entropy not in ("on", "off", "auto"):
            raise RocJpegError(Status.INVALID_PARAMETER,
                               f"bad device_entropy mode {device_entropy!r}")
        self._device_entropy = device_entropy
        self._check_errors = check_errors
        # The devices the host path's K2 spreads a group's block rows over
        # (pipeline.decode_group); a MeshDecoder row sets its own.
        self._band_devices = (self._device,)
        self._tls = threading.local()  # per-thread records of the last call
        self._lock = threading.Lock()
        self._max_inflight = 2
        self._inflight: list = []  # tokens, oldest first
        # Counts reserved slots, taken before the dispatch, so the bound
        # holds under concurrent callers.
        self._outstanding = 0
        # Signals token registration and slot release to a thread that
        # found every slot reserved but no token registered yet.
        self._slot_cv = threading.Condition(self._lock)

    @property
    def spec(self) -> GpuDecodeSpec:
        """Decode capability spec (GetCurrentVcnJpegSpec analog)."""
        return self._spec

    @property
    def last_error_flags(self) -> list:
        """Per-lane device error flags of the calling thread's last
        decode_batched call, one tensor per device-entropy chunk."""
        return [err for err, _, _ in self._last_error_lanes()]

    @property
    def last_paths(self) -> list:
        """Per-chunk (path, batch_indices) of the calling thread's last
        decode_batched call; path is 'host', 'wave' (real restart lanes)
        or 'wave-virtual' (virtual restarts of DRI=0 scans, found by K0 on
        a card and by the host index walk on the CPU)."""
        return getattr(self._tls, "paths", [])

    def last_failed_indices(self) -> list:
        """Batch indices of images whose scans the device wave flagged as
        corrupt in the calling thread's last decode_batched call (reads
        the device flags: one sync)."""
        return failed_indices(self._last_error_lanes())

    def _last_error_lanes(self) -> list:
        """The calling thread's last decode_batched call's device-entropy
        chunks as (err, lane_img, batch_indices): the per-lane error
        flags, each lane's image within its chunk, and the chunk's batch
        indices."""
        return getattr(self._tls, "error_lanes", [])

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

    def _checked_params(self, streams) -> list:
        """The streams' parameters, every stream checked before anything is
        dispatched: a null handle raises INVALID_PARAMETER, a stream the
        spec does not support JPEG_NOT_SUPPORTED."""
        if streams is None or any(s is None for s in streams):
            raise RocJpegError(Status.INVALID_PARAMETER, "null stream handle")
        stream_params = [s.params for s in streams]
        for p in stream_params:
            self._validate(p)
        return stream_params

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

    def _acquire_slot(self) -> None:
        """Reserve one of the ``_max_inflight`` slots, waiting for the
        oldest outstanding chunk when all are taken. The wait happens
        outside the lock, so other threads keep packing meanwhile."""
        while True:
            with self._lock:
                if self._outstanding < self._max_inflight:
                    self._outstanding += 1
                    return
                tok = self._inflight.pop(0) if self._inflight else None
                if tok is None:
                    # Every slot is reserved by a thread that is still
                    # dispatching: wait for its registration or release.
                    # The timeout guards against a lost notify; the loop
                    # re-checks either way.
                    with span("rjt.throttle"):
                        self._slot_cv.wait(timeout=0.05)
                    continue
            # The popped token owns one reservation; release it even when
            # the wait raises, or the handle would run out of slots.
            try:
                with span("rjt.throttle"):
                    tok.synchronize()
            finally:
                self._release_slot()

    def _register_token(self) -> None:
        """Pair the calling thread's reservation with a token for the work
        queued so far on the current stream."""
        if self._device.type == "cuda":
            tok = torch.cuda.Event()
            tok.record(torch.cuda.current_stream(self._device))
        else:
            tok = _DoneToken()
        with self._lock:
            self._inflight.append(tok)
            self._slot_cv.notify_all()

    def _release_slot(self) -> None:
        with self._lock:
            self._outstanding -= 1
            self._slot_cv.notify_all()

    def synchronize(self) -> None:
        """Wait for every outstanding chunk of this handle and release its
        slot (the ``hipStreamSynchronize`` analog). Idempotent."""
        while True:
            with self._lock:
                tok = self._inflight.pop(0) if self._inflight else None
            if tok is None:
                return
            try:
                tok.synchronize()
            finally:
                self._release_slot()

    def decode(self, stream: JpegStream,
               params: Optional[DecodeParams] = None) -> DecodedImage:
        """rocJpegDecode analog."""
        return self.decode_batched([stream], params)[0]

    def decode_into(self, streams, dests,
                    params: Optional[DecodeParams] = None) -> None:
        """Decode into caller-allocated destination buffers, the
        reference's core output contract (``RocJpegImage``): the caller
        hands per-channel buffers and row pitches, the decoder writes each
        channel honouring the pitch and leaves the bytes past each row's
        end untouched.

        Accepts a single (stream, dest) pair or parallel sequences. Each
        dest is a :class:`~rocjpeg_tpu_torch.types.DecodedImage` (or any
        object with ``channel`` and ``pitch`` lists). ``channel[ci]`` is

        - a writable C-contiguous numpy buffer or a raw host pointer
          integer: the batch is decoded, each channel brought to the host
          and copied row by row (:func:`write_channel_into`); or
        - a contiguous uint8 ``torch.Tensor`` on the decoder's device: the
          channels are written by K3 straight through the caller's pointer
          and pitch, computed and crop-only ones by the same launch (on a
          CPU decoder by a strided copy), chunk by chunk, each chunk's
          destinations checked before its launch. One call takes tensors
          or host buffers, not both.

        ``pitch[ci]`` is the row pitch in bytes. Raises
        RocJpegError(INVALID_PARAMETER) for a length mismatch, a null
        channel 0, a pitch below the row size, a buffer shorter than
        ``(rows - 1) * pitch + row_bytes``, a read-only or non-contiguous
        numpy buffer, or a tensor of another device or dtype. Channels the
        caller did not allocate (None) are skipped, except channel 0."""
        if isinstance(streams, JpegStream):
            streams, dests = [streams], [dests]
        streams, dests = list(streams), list(dests)
        if len(dests) != len(streams):
            raise RocJpegError(Status.INVALID_PARAMETER,
                               "streams/dests length mismatch")
        if any(isinstance(d, torch.Tensor) for dest in dests
               for d in dest.channel):
            self._decode(streams, params, dests)
            return
        images = self.decode_batched(streams, params)
        for img, dest in zip(images, dests):
            for ci in range(MAX_COMPONENT):
                if img.channel[ci] is None:
                    continue
                d = dest.channel[ci] if ci < len(dest.channel) else None
                if null_channel(d):
                    if ci == 0:
                        raise RocJpegError(Status.INVALID_PARAMETER,
                                           "null destination channel 0")
                    continue
                write_channel_into(img.channel[ci], d, int(dest.pitch[ci]))

    def decode_batched(self, streams: Sequence[JpegStream],
                       params: Optional[DecodeParams] = None
                       ) -> List[DecodedImage]:
        """rocJpegDecodeBatched analog: group the batch by shape, chunk
        each group by the spec's lane budget and K1's addressing
        (:func:`chunk_group`), and decode each chunk as one batched device
        pass."""
        return self._decode(streams, params, None)

    def _decode(self, streams, params, dests):
        """decode_batched; with ``dests`` (one tensor destination per
        stream) the channels go there and the returned entries are None."""
        with span("rjt.decode"):
            stream_params = self._checked_params(streams)
            params = params or DecodeParams()
            fmt = OutputFormat(params.output_format)

            groups = {}
            for idx, p in enumerate(stream_params):
                groups.setdefault(shape_key(p), []).append(idx)
            lanes = int(self._spec.num_decode_lanes)
            chunks = [chunk for idxs in groups.values()
                      for chunk in chunk_group(
                          idxs, lanes, coefficients_per_image(
                              stream_params[idxs[0]]))]

            use_dev = self._device_entropy != "off"
            results: List[Optional[DecodedImage]] = [None] * len(streams)
            err_lanes, paths = [], []  # err_lanes: (err, lane_img, idxs)
            synced = []  # (K0's rejected flag, (lane flags, lane_img, idxs))
            for idxs in chunks:
                # Throttle before dispatching each chunk: at most
                # _max_inflight chunks are in flight, on both paths and
                # across threads.
                self._acquire_slot()
                registered = False
                try:
                    per_image = self._decode_chunk(
                        [stream_params[i] for i in idxs], idxs, fmt,
                        params.crop_rectangle, use_dev,
                        None if dests is None else [dests[i] for i in idxs],
                        paths, err_lanes, synced)
                    self._register_token()
                    registered = True
                finally:
                    if not registered:
                        self._release_slot()
                for i, chans in zip(idxs, per_image or ()):
                    img = DecodedImage.empty()
                    for ci, (arr, pitch) in enumerate(chans):
                        img.channel[ci] = arr
                        img.pitch[ci] = pitch
                    results[i] = img

            self._tls.error_lanes = err_lanes
            self._tls.paths = paths
            if self._check_errors and err_lanes:
                with span("rjt.error_check"):
                    bad = any(bool(e.any()) for e, _, _ in err_lanes)
                if bad:
                    raise RocJpegError(
                        Status.BAD_JPEG,
                        "on-device entropy decode failed (corrupt scan) in "
                        f"batch image(s) {self.last_failed_indices()}")
            if synced and not self._check_errors:
                # A DRI=0 scan K0 rejected is one the host walk refuses,
                # which sends its chunk to the host path, which raises:
                # so on a card too, without the error check (with it, the
                # check above has raised).
                with span("rjt.error_check"):
                    flags = torch.cat([f for f, _ in synced]).tolist()
                bad = [lanes for f, (_, lanes) in zip(flags, synced) if f]
                if bad:
                    raise RocJpegError(
                        Status.BAD_JPEG,
                        "corrupt DRI=0 scan in batch image(s) "
                        f"{failed_indices(bad)}")
            return results

    def _decode_chunk(self, plist, idxs, fmt, crop, use_dev, dests, paths,
                      err_lanes, synced):
        """Dispatch one chunk on the device-entropy path or, failing that,
        the host-entropy path; appends to the call's ``paths``,
        ``err_lanes`` and ``synced`` (K0's chunks) records. Returns the
        per-image channel lists, or None when they went into ``dests``."""
        p0 = plist[0]
        if crop is not None and not (
                0 < crop.width <= p0.picture_width
                and 0 < crop.height <= p0.picture_height):
            crop = None  # invalid ROI: decode the full image
        vk = self._virtual_k(plist) if use_dev else None
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
                    packed, plist, fmt, crop, dests)
                paths.append(("wave-virtual" if vk else "wave", idxs))
                err_lanes.append((err, packed.lane_img, idxs))
                if packed.rejected is not None:
                    synced.append((packed.rejected,
                                   (packed.lane_err, packed.lane_img, idxs)))
                return per_image
        paths.append(("host", idxs))
        with span("rjt.host_entropy"):
            coeffs = host_decode.decode_coefficients_batch(plist)
        return pipeline.decode_group(plist, coeffs, fmt, self._device, crop,
                                     dests, self._band_devices)
