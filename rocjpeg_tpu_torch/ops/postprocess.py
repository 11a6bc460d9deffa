"""Output-format rendering: decoded sample planes -> the 5 output formats.

Port of ``rocjpeg_tpu/ops/postprocess.py`` ``render_output`` in plain
PyTorch: the plain version of the output epilogue, whose kernel and wrapper
are ``kernels/epilogue.py``. The ROI validity rule (``resolve_roi``) and
the per-CSS chroma factors are the reference's.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..status import RocJpegError, Status
from ..types import ChromaSubsampling, CropRectangle, OutputFormat
from . import color, layout

CSS = ChromaSubsampling

# Per-CSS (h_subsample, v_subsample) of the chroma planes relative to luma.
CHROMA_FACTORS = {
    CSS.CSS_444: (1, 1),
    CSS.CSS_440: (1, 2),
    CSS.CSS_422: (2, 1),
    CSS.CSS_420: (2, 2),
    CSS.CSS_411: (4, 1),
}


def resolve_roi(width: int, height: int, crop: Optional[CropRectangle]):
    """The reference's ROI-validity rule: a crop is valid iff
    0 < right-left <= width and 0 < bottom-top <= height; otherwise the full
    image is decoded. Returns (eff_w, eff_h, left, top)."""
    if crop is not None:
        rw, rh = crop.width, crop.height
        if 0 < rw <= width and 0 < rh <= height:
            return rw, rh, crop.left, crop.top
    return width, height, 0, 0


def render_output(css: ChromaSubsampling, planes, width: int, height: int,
                  output_format: OutputFormat,
                  crop: Optional[CropRectangle] = None):
    """Render MCU-padded (batch, H, W) uint8 planes (y, u, v; u/v None for
    4:0:0) into one output format. Returns a list of (tensor, pitch)
    channel entries, each tensor with the batch axis leading."""
    css = ChromaSubsampling(css)
    if css in (CSS.CSS_411, CSS.CSS_UNKNOWN):
        raise RocJpegError(Status.JPEG_NOT_SUPPORTED,
                           f"chroma subsampling {css.name} is not supported")

    eff_w, eff_h, left, top = resolve_roi(width, height, crop)
    y, u, v = planes
    y_roi = y[..., top:top + eff_h, left:left + eff_w]
    fmt = OutputFormat(output_format)

    if css == CSS.CSS_400:
        return _render_400(y_roi, eff_w, fmt)

    hf, vf = CHROMA_FACTORS[css]
    ch_w = eff_w // hf
    ch_h = eff_h // vf
    c_top = top // vf
    c_left = left // hf
    u_roi = u[..., c_top:c_top + ch_h, c_left:c_left + ch_w]
    v_roi = v[..., c_top:c_top + ch_h, c_left:c_left + ch_w]

    if fmt == OutputFormat.NATIVE:
        if css in (CSS.CSS_444, CSS.CSS_440):
            return [(y_roi, eff_w), (u_roi, eff_w), (v_roi, eff_w)]
        if css == CSS.CSS_422:  # packed YUYV in channel 0
            return [(layout.pack_yuyv(y_roi, u_roi, v_roi), 2 * eff_w)]
        return [(y_roi, eff_w), (layout.interleave_uv(u_roi, v_roi), eff_w)]
    if fmt == OutputFormat.YUV_PLANAR:
        return [(y_roi, eff_w), (u_roi, ch_w), (v_roi, ch_w)]
    if fmt == OutputFormat.Y:
        return [(y_roi, eff_w)]
    if fmt in (OutputFormat.RGB, OutputFormat.RGB_PLANAR):
        u_full = _match_size(layout.upsample_to_luma(u_roi, hf, vf),
                             eff_h, eff_w)
        v_full = _match_size(layout.upsample_to_luma(v_roi, hf, vf),
                             eff_h, eff_w)
        r, g, b = color.yuv_to_rgb(y_roi, u_full, v_full)
        if fmt == OutputFormat.RGB:
            return [(layout.interleave_rgb(r, g, b), 3 * eff_w)]
        return [(r, eff_w), (g, eff_w), (b, eff_w)]
    raise RocJpegError(Status.INVALID_PARAMETER,
                       f"invalid output format {output_format}")


def _render_400(y_roi, eff_w: int, fmt: OutputFormat):
    """4:0:0: NATIVE/YUV_PLANAR/Y return the luma plane only; RGB
    replicates Y."""
    if fmt in (OutputFormat.NATIVE, OutputFormat.YUV_PLANAR, OutputFormat.Y):
        return [(y_roi, eff_w)]
    if fmt == OutputFormat.RGB:
        return [(layout.interleave_rgb(y_roi, y_roi, y_roi), 3 * eff_w)]
    if fmt == OutputFormat.RGB_PLANAR:
        return [(y_roi, eff_w), (y_roi, eff_w), (y_roi, eff_w)]
    raise RocJpegError(Status.INVALID_PARAMETER,
                       f"invalid output format {fmt}")


def _match_size(plane, h: int, w: int):
    """Edge-replicate pad the trailing 2 axes up to (h, w) if short (odd-size
    nearest upsampling), then cut to (h, w). An empty plane (an ROI thinner
    than a chroma sample) has no edge and stays empty."""
    ph, pw = plane.shape[-2], plane.shape[-1]
    if 0 < ph < h:
        pad = plane[..., ph - 1:ph, :].expand(
            plane.shape[:-2] + (h - ph, pw))
        plane = torch.cat([plane, pad], dim=-2)
    if 0 < pw < w:
        pad = plane[..., :, pw - 1:pw].expand(
            plane.shape[:-2] + (plane.shape[-2], w - pw))
        plane = torch.cat([plane, pad], dim=-1)
    return plane[..., :h, :w]
