"""K3 — the output epilogue: wrapper, plain PyTorch version, launch count.

Takes K2's MCU-padded uint8 sample planes (B, H_pad, W_pad) per component
to the channels of one output format: ROI crop, nearest chroma upsampling,
BT.709 YUV -> RGB and the packed layouts (interleaved RGB, YUYV, the UV
plane of NV12). The CUDA kernel is ``csrc/epilogue.cu``, the port of the XLA
program ``rocjpeg_tpu/ops/postprocess.py`` ``render_output``.

Channels that are plain crops of a plane (Y everywhere, U and V of the
planar formats) are views and cost nothing; the kernel is launched for the
channels that are computed. On CPU tensors :func:`render` runs
:func:`render_reference`; on CUDA tensors it launches the kernel or raises.

With ``dests`` every channel is written into caller-allocated tensors
through the caller's row pitch instead (``Decoder.decode_into``), computed
and crop-only channels alike by the one kernel launch, straight through the
caller's pointers (on CPU tensors by a strided copy of the plain version's
channels). Bytes past each row's end stay untouched.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from ..ops import postprocess
from ..ops.postprocess import CHROMA_FACTORS, resolve_roi
from ..status import RocJpegError, Status
from ..types import ChromaSubsampling, CropRectangle, OutputFormat
from . import build

CSS = ChromaSubsampling

launches = 0  # kernel launches; chip_smoke.py resets and reads it
# How the parts of the last launch loaded their source, 2 bits a part (bits
# 0-1 the computed channels, bits 2 + 2c the copy into channel c): 2 aligned
# 8-byte loads, 1 aligned words shifted (the ROI's left edge is not a
# multiple of 8), 0 bytes (a plane that is not made of whole words).
last_load_levels = None

# Kernel modes of csrc/epilogue.cu (MODE_COPY: a launch of copies only);
# its destination table holds the 3 channels a format can have.
MODE_RGB, MODE_RGB_PLANAR, MODE_YUYV, MODE_UV, MODE_COPY = range(5)
_TABLE_CHANNELS = 3


@dataclasses.dataclass(frozen=True)
class Channel:
    """One output channel of a format: ``plane`` is the index of the plane
    it is a crop of (0 y, 1 u, 2 v), or None when the kernel computes it."""
    plane: Optional[int]
    rows: int
    row_bytes: int
    pitch: int  # the pitch the format reports (not always row_bytes)


def _invalid(msg):
    return RocJpegError(Status.INVALID_PARAMETER, msg)


def channel_plan(css, output_format, eff_w: int, eff_h: int):
    """(kernel mode or None, [Channel, ...]) of one format for an ROI of
    ``eff_w`` x ``eff_h``, with the shapes and pitches of the plain version.

    An ROI thinner than a chroma sample leaves the plain version an empty
    chroma plane and with it an empty RGB channel; packed YUYV of an odd
    width has no plain version at all and is refused."""
    css, fmt = ChromaSubsampling(css), OutputFormat(output_format)
    y = Channel(0, eff_h, eff_w, eff_w)
    if css == CSS.CSS_400:
        if fmt == OutputFormat.RGB:
            return MODE_RGB, [Channel(None, eff_h, 3 * eff_w, 3 * eff_w)]
        return None, [y] * (3 if fmt == OutputFormat.RGB_PLANAR else 1)
    hf, vf = CHROMA_FACTORS[css]
    ch_w, ch_h = eff_w // hf, eff_h // vf
    if fmt == OutputFormat.Y:
        return None, [y]
    if fmt == OutputFormat.YUV_PLANAR:
        return None, [y, Channel(1, ch_h, ch_w, ch_w),
                      Channel(2, ch_h, ch_w, ch_w)]
    if fmt == OutputFormat.NATIVE:
        if css in (CSS.CSS_444, CSS.CSS_440):
            return None, [y, Channel(1, ch_h, ch_w, eff_w),
                          Channel(2, ch_h, ch_w, eff_w)]
        if css == CSS.CSS_422:
            if eff_w % 2:
                raise _invalid(f"packed YUYV needs an even width, not {eff_w}")
            return MODE_YUYV, [Channel(None, eff_h, 2 * eff_w, 2 * eff_w)]
        return MODE_UV, [y, Channel(None, ch_h, 2 * ch_w, eff_w)]
    w = eff_w if ch_w else 0
    h = eff_h if ch_h else 0
    if fmt == OutputFormat.RGB:
        return MODE_RGB, [Channel(None, h, 3 * w, 3 * eff_w)]
    return MODE_RGB_PLANAR, [Channel(None, h, w, eff_w)] * 3


def _check_inputs(css, planes, width, height, crop):
    """Typed refusals of what neither version renders. Returns
    (css, (eff_w, eff_h, left, top))."""
    css = ChromaSubsampling(css)
    if css in (CSS.CSS_411, CSS.CSS_UNKNOWN):
        raise RocJpegError(Status.JPEG_NOT_SUPPORTED,
                           f"chroma subsampling {css.name} is not supported")
    if len(planes) != 3:
        raise _invalid("planes must be (y, u, v)")
    y, u, v = planes
    if css == CSS.CSS_400:
        u = v = None
    elif u is None or v is None:
        raise _invalid(f"{css.name} needs u and v planes")
    for name, t in (("y", y), ("u", u), ("v", v)):
        if t is None:
            continue
        if (not isinstance(t, torch.Tensor) or t.dtype != torch.uint8
                or t.dim() != 3 or not t.is_contiguous()):
            raise _invalid(f"{name} must be a contiguous uint8 "
                           "(batch, H, W) tensor")
        if t.device != y.device or t.shape[0] != y.shape[0]:
            raise _invalid(f"{name} is not on {y.device} with batch "
                           f"{y.shape[0]}")
    if u is not None and u.shape != v.shape:
        raise _invalid("u and v differ in shape")
    eff_w, eff_h, left, top = roi = resolve_roi(width, height, crop)
    # Numpy and torch clip a slice that leaves the plane, and the channel
    # then comes out smaller than its pitch says; a kernel would read
    # past the plane. Neither is an output the format defines.
    if (left < 0 or top < 0 or left + eff_w > y.shape[2]
            or top + eff_h > y.shape[1]):
        raise _invalid(f"ROI {eff_w}x{eff_h}+{left}+{top} leaves the "
                       f"{y.shape[2]}x{y.shape[1]} luma plane")
    if u is not None:
        hf, vf = CHROMA_FACTORS[css]
        if (left // hf + eff_w // hf > u.shape[2]
                or top // vf + eff_h // vf > u.shape[1]):
            raise _invalid("ROI leaves the chroma planes")
    return css, roi


def null_channel(d) -> bool:
    """A destination channel the caller did not allocate: None, or a zero
    pointer (``np.int64(0)`` included)."""
    return d is None or (isinstance(d, (int, np.integer)) and int(d) == 0)


def _dest_channel(dest, ci: int):
    """The caller's buffer for channel ``ci``, or None when not allocated."""
    d = dest.channel[ci] if ci < len(dest.channel) else None
    return None if null_channel(d) else d


def _check_dests(dests, channels, batch: int, device):
    """Caller destinations, one per image: objects with ``channel`` and
    ``pitch`` lists (``DecodedImage``). Channel 0 is required, other
    channels left None are skipped."""
    if len(dests) != batch:
        raise _invalid(f"{len(dests)} destinations for {batch} images")
    for dest in dests:
        for ci, ch in enumerate(channels):
            d = _dest_channel(dest, ci)
            if d is None:
                if ci == 0:
                    raise _invalid("null destination channel 0")
                continue
            if (not isinstance(d, torch.Tensor) or d.dtype != torch.uint8
                    or not d.is_contiguous()):
                raise _invalid(f"destination channel {ci} must be a "
                               "contiguous uint8 tensor")
            if d.device != device:
                raise _invalid(f"destination channel {ci} is on {d.device}, "
                               f"not {device}")
            pitch = int(dest.pitch[ci])
            if pitch < ch.row_bytes:
                raise _invalid(f"destination pitch {pitch} < row size "
                               f"{ch.row_bytes}")
            need = (ch.rows - 1) * pitch + ch.row_bytes if ch.rows else 0
            if d.numel() < need:
                raise _invalid(f"destination buffer {d.numel()}B < {need}B")


def _copy_into(dests, ci: int, ch: Channel, batched):
    """Copy a batched channel row by row into the (rows, row_bytes) window
    of each caller's flat buffer that has one."""
    for dest, img in zip(dests, batched):
        d = _dest_channel(dest, ci)
        if d is not None:
            d.view(-1).as_strided((ch.rows, ch.row_bytes),
                                  (int(dest.pitch[ci]), 1)).copy_(img)


def render(css, planes, width: int, height: int, output_format,
           crop: Optional[CropRectangle] = None, dests=None):
    """Render one same-shape group's planes (y, u, v; u and v None for
    4:0:0) into one output format.

    Without ``dests`` returns the list of (tensor, pitch) channel entries,
    each tensor with the batch axis leading, as :func:`render_reference`
    does. With ``dests`` (one per image, see :func:`_check_dests`) writes
    every channel the caller allocated through its pitch and returns None.
    """
    css, roi = _check_inputs(css, planes, width, height, crop)
    mode, channels = channel_plan(css, output_format, roi[0], roi[1])
    y = planes[0]
    if dests is not None:
        _check_dests(dests, channels, y.shape[0], y.device)
    if y.device.type == "cpu":
        out = render_reference(css, planes, width, height, output_format,
                               crop)
        if dests is None:
            return out
        for ci, (ch, (arr, _pitch)) in enumerate(zip(channels, out)):
            _copy_into(dests, ci, ch, arr)
        return None
    if y.device.type != "cuda":
        raise _invalid(f"unsupported device {y.device}")
    lib = build.library()
    with torch.cuda.device(y.device):
        return _render_kernel(lib, torch.cuda.current_stream().cuda_stream,
                              css, planes, roi, mode, channels, dests)


def _render_kernel(lib, stream, css, planes, roi, mode, channels, dests):
    """The kernel route of :func:`render` on checked inputs, one launch per
    ``rjt_epilogue_table_images`` images. Without destinations the
    crop-only channels are views and only the computed ones are launched
    for; with destinations the same launch copies the crop-only channels
    too (a format of crops only is a launch of copies)."""
    global launches, last_load_levels
    y, u, v = planes
    if css == CSS.CSS_400:
        u = v = None
    eff_w, eff_h, left, top = roi
    batch = y.shape[0]
    hf, vf = CHROMA_FACTORS.get(css, (1, 1))
    ch_w, ch_h, c_left, c_top = eff_w // hf, eff_h // vf, left // hf, top // vf
    crops = (y[:, top:top + eff_h, left:left + eff_w],
             None if u is None else u[:, c_top:c_top + ch_h,
                                      c_left:c_left + ch_w],
             None if v is None else v[:, c_top:c_top + ch_h,
                                      c_left:c_left + ch_w])
    out = []
    # The kernel's destination table, indexed by the format's channel, and
    # for each channel the plane this launch is to copy into it, if any.
    ptrs = np.zeros((batch, _TABLE_CHANNELS), np.int64)
    pitches = np.zeros((batch, _TABLE_CHANNELS), np.int64)
    copy_planes = np.full(_TABLE_CHANNELS, -1, np.int32)
    main_chan = None  # the first computed channel that is not empty
    for ci, ch in enumerate(channels):
        nonempty = bool(ch.rows and ch.row_bytes)
        if dests is not None:
            if not nonempty:
                continue
            for i, dest in enumerate(dests):
                d = _dest_channel(dest, ci)
                if d is not None:
                    ptrs[i, ci] = d.data_ptr()
                    pitches[i, ci] = int(dest.pitch[ci])
            if ch.plane is not None:
                copy_planes[ci] = ch.plane
        elif ch.plane is not None:
            out.append((crops[ch.plane], ch.pitch))
        else:
            t = torch.empty((batch, ch.rows, ch.row_bytes), dtype=torch.uint8,
                            device=y.device)
            out.append((t, ch.pitch))
            ptrs[:, ci] = t.data_ptr() + np.arange(batch) * (ch.rows
                                                             * ch.row_bytes)
            pitches[:, ci] = ch.row_bytes
        if ch.plane is None and nonempty and main_chan is None:
            main_chan = ci
    if main_chan is None:
        mode, main_chan = MODE_COPY, 0
    if mode != MODE_COPY or (copy_planes >= 0).any():
        src = (y.data_ptr(), None if u is None else u.data_ptr(),
               None if v is None else v.data_ptr(), y.shape[1] * y.shape[2],
               0 if u is None else u.shape[1] * u.shape[2], y.shape[2],
               0 if u is None else u.shape[2])
        levels = lib.rjt_epilogue_load_levels(
            mode, *src, left, c_left, hf - 1, copy_planes.ctypes.data)
        step = lib.rjt_epilogue_table_images()
        for lo in range(0, batch, step):
            n = min(step, batch - lo)
            if not ptrs[lo:lo + n].any():
                continue  # no image of this piece wants any channel
            rc = lib.rjt_epilogue(
                mode, *src, top, left, c_top, c_left, eff_h, eff_w, ch_w,
                ch_h, hf - 1, vf - 1, lo, n, main_chan, levels,
                copy_planes.ctypes.data, ptrs[lo:lo + n].ctypes.data,
                pitches[lo:lo + n].ctypes.data, stream)
            build.check(rc, "rjt_epilogue")
            with build.count_lock:
                launches += 1
            last_load_levels = levels
    return out if dests is None else None


def render_reference(css, planes, width: int, height: int, output_format,
                     crop: Optional[CropRectangle] = None):
    """Plain PyTorch version of :func:`render` without destinations
    (ops/postprocess.py with ops/color.py and ops/layout.py), same
    results."""
    return postprocess.render_output(css, planes, width, height,
                                     output_format, crop)
