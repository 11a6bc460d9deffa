"""K2 — the transform: wrapper, plain PyTorch version, launch count.

Takes the wave's flat coefficient tensor (B * total_blocks * 64,) int16 to
per-component uint8 sample planes: for virtual-restart lanes the DC fixup
(each lane's entry predictor added to the DC coefficient of every block it
decoded, with int16 wraparound), then dequantisation, the int32 islow
8x8 IDCT, level shift, clamp and block -> plane. The CUDA kernel is
``csrc/transform.cu``, the port of the XLA program
``rocjpeg_tpu/pipeline.py`` ``_transform_from_flat``.

On a CPU tensor :func:`transform` runs :func:`transform_reference`; on a
CUDA tensor it launches the kernel or raises.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops import idct, layout
from ..status import RocJpegError, Status
from . import build

launches = 0  # kernel launches; chip_smoke.py resets and reads it


def _mcu_steps(geom, c: int):
    """(hs, vs): blocks of component c per MCU, horizontally / vertically
    (the ``_mcu_maps`` rule of rocjpeg_tpu/pipeline.py)."""
    s = geom.comp_of_slot.index(c)
    return geom.col_step[s], geom.row_step[s] // geom.blocks_w[c]


def _check_inputs(coeffs_flat, quant, geom, dc_flat, lane_of_mcu):
    dev = coeffs_flat.device
    B = geom.batch
    if (coeffs_flat.dtype != torch.int16 or not coeffs_flat.is_contiguous()
            or coeffs_flat.shape != (B * geom.total_blocks * 64,)):
        raise RocJpegError(Status.INVALID_PARAMETER,
                           "coeffs_flat must be contiguous int16 "
                           "(batch * total_blocks * 64,)")
    if (quant.dtype != torch.int32 or not quant.is_contiguous()
            or quant.shape != (B, 3, 64) or quant.device != dev):
        raise RocJpegError(Status.INVALID_PARAMETER,
                           "quant must be contiguous int32 (batch, 3, 64)")
    if len(geom.comp_base) > 3:
        raise RocJpegError(Status.JPEG_NOT_SUPPORTED, "more than 3 components")
    if (dc_flat is None) != (lane_of_mcu is None):
        raise RocJpegError(Status.INVALID_PARAMETER,
                           "dc_flat and lane_of_mcu go together")
    if dc_flat is not None:
        for name, t in (("dc_flat", dc_flat), ("lane_of_mcu", lane_of_mcu)):
            if (t.dtype != torch.int32 or not t.is_contiguous()
                    or t.device != dev or t.dim() != 2):
                raise RocJpegError(Status.INVALID_PARAMETER,
                                   f"{name} must be a contiguous 2-D int32 "
                                   f"tensor on {dev}")
        if dc_flat.shape[1] != 3 or lane_of_mcu.shape[0] != B:
            raise RocJpegError(Status.INVALID_PARAMETER,
                               "dc_flat must be (n_lanes, 3) and lane_of_mcu "
                               "(batch, total_mcus)")
        for c, (bh, bw) in enumerate(geom.comp_dims()):
            hs, vs = _mcu_steps(geom, c)
            if ((bh - 1) // vs) * geom.mcus_w + (bw - 1) // hs \
                    >= lane_of_mcu.shape[1]:
                raise RocJpegError(Status.INVALID_PARAMETER,
                                   "lane_of_mcu has fewer MCUs than the "
                                   "geometry")


def transform(coeffs_flat, quant, geom, dc_flat=None, lane_of_mcu=None):
    """Flat coefficients -> per-component sample planes.

    coeffs_flat: (geom.batch * geom.total_blocks * 64,) int16;
    quant: (batch, 3, 64) int32 natural-order quant tables;
    geom: ops.tables.GroupGeometry (its plane layout: comp_base, blocks_w,
    total_blocks; its slot tables and mcus_w for the DC fixup);
    dc_flat: (n_lanes, 3) int32 and lane_of_mcu: (batch, total_mcus) int32,
    both or neither — given, the DC fixup runs.

    Returns a tuple of uint8 planes (batch, bh*8, bw*8), one per component.
    """
    global launches
    _check_inputs(coeffs_flat, quant, geom, dc_flat, lane_of_mcu)
    dev = coeffs_flat.device
    if dev.type == "cpu":
        return transform_reference(coeffs_flat, quant, geom, dc_flat,
                                   lane_of_mcu)
    if dev.type != "cuda":
        raise RocJpegError(Status.INVALID_PARAMETER,
                           f"unsupported device {dev}")
    if coeffs_flat.data_ptr() % 16:
        raise RocJpegError(Status.INVALID_PARAMETER,
                           "coeffs_flat must be 16-byte aligned")
    lib = build.library()
    B = geom.batch
    dims = geom.comp_dims()
    ncomp = len(dims)
    steps = ([_mcu_steps(geom, c) for c in range(ncomp)]
             if dc_flat is not None else [(1, 1)] * ncomp)
    planes = [torch.empty((B, bh * 8, bw * 8), dtype=torch.uint8, device=dev)
              for bh, bw in dims]
    comp_tab = np.ascontiguousarray(
        [geom.comp_base, [d[0] for d in dims], [d[1] for d in dims],
         [s[0] for s in steps], [s[1] for s in steps]], dtype=np.int32)
    out_ptrs = np.asarray([p.data_ptr() for p in planes], dtype=np.int64)
    fix = dc_flat is not None
    with torch.cuda.device(dev):
        rc = lib.rjt_transform(
            coeffs_flat.data_ptr(), quant.data_ptr(),
            dc_flat.data_ptr() if fix else None,
            lane_of_mcu.data_ptr() if fix else None, B, comp_tab.ctypes.data,
            out_ptrs.ctypes.data, ncomp, geom.total_blocks, geom.mcus_w,
            lane_of_mcu.shape[1] if fix else 0,
            dc_flat.shape[0] if fix else 0,
            torch.cuda.current_stream().cuda_stream)
    build.check(rc, "rjt_transform")
    with build.count_lock:
        launches += 1
    return tuple(planes)


def transform_reference(coeffs_flat, quant, geom, dc_flat=None,
                        lane_of_mcu=None):
    """Plain PyTorch version of :func:`transform` (ops/idct.py +
    ops/layout.py), same signature and results."""
    dev = coeffs_flat.device
    B = geom.batch
    per_img = coeffs_flat.reshape(B, geom.total_blocks * 64)
    planes = []
    for c, (bh, bw) in enumerate(geom.comp_dims()):
        base = geom.comp_base[c]
        blocks = per_img[:, base * 64:(base + bh * bw) * 64].reshape(
            B, bh, bw, 64)
        if dc_flat is not None:
            hs, vs = _mcu_steps(geom, c)
            by = torch.arange(bh, device=dev)[:, None]
            bx = torch.arange(bw, device=dev)[None, :]
            mcu = (by // vs) * geom.mcus_w + bx // hs        # (bh, bw)
            lanes = lane_of_mcu[:, mcu].long()               # (B, bh, bw)
            n = dc_flat.shape[0]
            ok = (lanes >= 0) & (lanes < n)  # malformed lane: no fixup
            fix = dc_flat[:, c].long()[lanes.clamp(0, max(n - 1, 0))]
            dc = blocks[..., 0].long() + torch.where(ok, fix, 0)
            blocks = blocks.clone()
            blocks[..., 0] = (((dc + 32768) & 0xFFFF) - 32768).to(torch.int16)
        samples = idct.dequant_idct_8x8(
            blocks.reshape(B, bh, bw, 8, 8),
            quant[:, c].reshape(B, 1, 1, 8, 8))
        planes.append(layout.blocks_to_plane(samples))
    return tuple(planes)
