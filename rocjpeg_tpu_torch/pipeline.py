"""Batched decode of one same-shape group on the device.

Port of ``rocjpeg_tpu/pipeline.py``. The device-entropy path ships each
group's compressed lanes (not coefficient planes) to the device, where K1
(``kernels/wave.py``) decodes them into one flat coefficient tensor, K2
(``kernels/transform.py``) turns that into sample planes, and K3
(``kernels/epilogue.py``) lays out the requested format, into tensors it
allocates or into the caller's destinations. The host-entropy fallback
decodes coefficients on the host and takes the same K2 + K3 route.

Stages of the device-entropy path: :func:`pack_group` (host pack into the
group's staging buffer; virtual restarts add the native index walk; one
upload, ``ops.staging.Stager``), then
:func:`decode_group_device_entropy` (K1, K2, K3). Each stage runs
inside a ``torch.profiler.record_function`` range named ``rjt.<stage>``
(``rjt.walk``, ``rjt.pack``, ``rjt.upload``, ``rjt.wave``,
``rjt.transform``, ``rjt.epilogue``), so a profiler trace of a
``decode_batched`` call splits its time by stage. Nothing here waits for
the device: the per-lane error flags come back as a device tensor and the
caller decides when to read them.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch
from torch.profiler import record_function

from . import convert
from .core.zigzag import dezigzag
from .kernels import epilogue, transform, wave
from .ops import pack, staging
from .ops.tables import DeviceScanTables, GroupGeometry, max_steps_bound
from .status import RocJpegError, Status
from .types import CropRectangle, OutputFormat


def quant_tables(params_list) -> np.ndarray:
    """(B, 3, 64) int32 natural-order quant tables per image and component
    (ones for components a stream does not have)."""
    q = np.ones((len(params_list), 3, 64), np.int32)
    for i, p in enumerate(params_list):
        for ci in range(min(3, p.num_components)):
            qid = p.components[ci].quantiser_table_selector
            q[i, ci] = dezigzag(p.quantiser_tables[qid].astype(np.int32))
    return q


def _roi_mcu_range(p0, crop: Optional[CropRectangle]):
    """MCU index range [lo, hi) covering the crop's MCU rows, or None when
    the crop is absent or spans all rows (restart segments run in scan
    order, so only whole MCU-row bands can be skipped)."""
    if crop is None:
        return None
    if len(p0.scan_components) > 1:
        mcu_h = 8 * max(c.v_sampling_factor for c in p0.components)
        mcus_w = p0.mcus_per_row
        total = p0.num_mcus
    else:
        mcu_h = 8
        mcus_w = (p0.picture_width + 7) // 8
        total = mcus_w * ((p0.picture_height + 7) // 8)
    rows = -(-total // mcus_w)
    r0 = max(0, min(crop.top // mcu_h, rows))
    r1 = max(r0, min(rows, -(-crop.bottom // mcu_h)))
    if r0 == 0 and r1 >= rows:
        return None
    return (r0 * mcus_w, r1 * mcus_w)


def _per_image(p0, planes, output_format, crop, n: int, dests=None):
    """K3, then split the batched channels into per-image views; with
    ``dests`` (one caller destination per image) K3 writes into them and
    None is returned."""
    y = planes[0]
    u, v = (planes[1], planes[2]) if len(planes) >= 3 else (None, None)
    with record_function("rjt.epilogue"):
        chans = epilogue.render(p0.chroma_subsampling, (y, u, v),
                                p0.picture_width, p0.picture_height,
                                output_format, crop, dests)
    if chans is None:
        return None
    return [[(arr[i], pitch) for arr, pitch in chans] for i in range(n)]


@dataclasses.dataclass
class GroupInputs:
    """One group's device inputs to K1 and K2, as the main path builds
    them."""
    geom: GroupGeometry
    packed: convert.DevicePacked
    lentab: torch.Tensor   # (4 * n_banks, 16) int32
    values: torch.Tensor   # (n_banks * 89,) int32
    quant: torch.Tensor    # (B, 3, 64) int32
    max_steps: int
    lane_img: np.ndarray   # (n_lanes,) int32: lane -> image within group


def pack_host(st: staging.Stager, params_list,
              crop: Optional[CropRectangle] = None,
              virtual_k: Optional[int] = None) -> tuple:
    """The host half of :func:`pack_group`, its ``rjt.pack`` range: the
    banked tables, quant tables and lanes of one same-shape group packed
    into ``st``, an unopened ``staging.Stager``, which this opens. Returns
    (geom, packed, max_steps, lane_img) for :func:`upload_group`; raises
    as :func:`pack_group` does."""
    p0 = params_list[0]
    geom = GroupGeometry.from_params(p0, len(params_list))
    mcu_range = _roi_mcu_range(p0, crop)
    with record_function("rjt.pack"):
        tables, bank_of = DeviceScanTables.from_params_banked(params_list)
        small = (("lentab", tables.lentab), ("values", tables.values),
                 ("quant", quant_tables(params_list)))
        for name, a in small:
            st.reserve(name, a.shape, a.dtype)
        if virtual_k:
            packed, _, _ = pack.pack_virtual_segments(
                params_list, geom.total_blocks, virtual_k,
                mcu_range=mcu_range, bank_of=bank_of, stager=st)
        else:
            packed = pack.pack_segments(
                params_list, geom.total_blocks, mcu_range=mcu_range,
                bank_of=bank_of, stager=st)
        for name, a in small:
            st.put(name, a)
        # Read from the buffer before it goes back to the pool.
        max_steps = max_steps_bound(geom, packed)
        lane_img = (packed.img_base // max(geom.total_blocks, 1)).astype(
            np.int32)
    return geom, packed, max_steps, lane_img


def upload_group(st: staging.Stager, geom, packed, max_steps,
                 lane_img) -> GroupInputs:
    """The device half of :func:`pack_group`, its ``rjt.upload`` range:
    ``st``'s one copy to the device and the group's inputs as views of
    it."""
    with record_function("rjt.upload"):
        dev = st.upload()
    dev_packed = convert.DevicePacked(
        n_words=int(packed.n_words), dc_flat=dev.get("dc_flat"),
        lane_of_mcu=dev.get("lane_of_mcu"),
        **{k: dev[k] for k in ("dense", "word_off", "img_base", "mcu_start",
                               "mcu_count", "lane_bank")})
    return GroupInputs(geom=geom, packed=dev_packed, lentab=dev["lentab"],
                       values=dev["values"], quant=dev["quant"],
                       max_steps=max_steps, lane_img=lane_img)


def pack_group(params_list, device, crop: Optional[CropRectangle] = None,
               virtual_k: Optional[int] = None) -> GroupInputs:
    """Pack one same-shape group's lanes on the host (restart segments, or
    virtual ones for DRI=0 scans when ``virtual_k`` is set, the minimum
    symbol count per virtual lane) into one staging buffer with the Huffman
    table banks and quant tables (:func:`pack_host`), and upload it in one
    copy (:func:`upload_group`).

    Raises RocJpegError(JPEG_NOT_SUPPORTED) past 4 Huffman table sets, and
    RocJpegError(BAD_JPEG) from a restart scan missing segments or from
    the virtual-restart walk; the session API sends a group to the host
    path for the first, and for the walk's."""
    with staging.Stager(device) as st:
        return upload_group(st, *pack_host(st, params_list, crop, virtual_k))


def wave_group(g: GroupInputs):
    """K1 on one packed group: (flat int16 coefficients, per-lane error
    flags)."""
    dp = g.packed
    with record_function("rjt.wave"):
        return wave.wave_decode(
            dp.dense, dp.word_off, dp.img_base, dp.mcu_start, dp.mcu_count,
            dp.lane_bank, g.lentab, g.values, g.geom, dp.n_words,
            g.max_steps)


def transform_group(g: GroupInputs, coeffs):
    """K2 on K1's coefficients of one packed group (with the DC fixup of
    virtual lanes): the sample planes."""
    dp = g.packed
    with record_function("rjt.transform"):
        return transform.transform(coeffs, g.quant, g.geom, dp.dc_flat,
                                   dp.lane_of_mcu)


def decode_group_device_entropy(g: GroupInputs, params_list,
                                output_format: OutputFormat,
                                crop: Optional[CropRectangle] = None,
                                dests=None):
    """Decode one same-shape group packed by :func:`pack_group` with the
    entropy decode on the device: K1, K2 (with the DC fixup for virtual
    lanes), K3.

    Returns (per_image [[(channel, pitch), ...], ...], err bool (n_lanes,)
    device tensor); ``g.lane_img`` maps each lane to its image. With
    ``dests`` the channels go into the caller's destinations and per_image
    is None."""
    coeffs, err = wave_group(g)
    planes = transform_group(g, coeffs)
    del coeffs  # its memory is free for K3's outputs
    per_image = _per_image(params_list[0], planes, output_format, crop,
                           len(params_list), dests)
    return per_image, err


def decode_group(params_list, coeff_planes_list,
                 output_format: OutputFormat, device,
                 crop: Optional[CropRectangle] = None, dests=None):
    """Decode one same-shape group from host-decoded coefficient planes
    (per image, per component (bh, bw, 64) int16): one staged upload of the
    planes and quant tables, K2 (no DC fixup), K3. Returns per-image lists
    of (channel, pitch), or None when the channels went into ``dests``."""
    p0 = params_list[0]
    n = len(params_list)
    dims = [c.shape[:2] for c in coeff_planes_list[0]]
    geom = GroupGeometry.from_params(p0, n).with_planes(dims)
    planes = [c for image in coeff_planes_list for c in image]
    quant = quant_tables(params_list)
    with record_function("rjt.upload"), staging.Stager(device) as st:
        st.reserve("coeffs", (sum(c.size for c in planes),), np.int16)
        st.reserve("quant", quant.shape, quant.dtype)
        st.open()
        flat = st.view("coeffs")
        off = 0
        for c in planes:
            if c.dtype != np.int16:
                raise RocJpegError(Status.INVALID_PARAMETER,
                                   f"coefficients must be int16, got {c.dtype}")
            flat[off:off + c.size] = c.reshape(-1)
            off += c.size
        st.put("quant", quant)
        dev = st.upload()
    with record_function("rjt.transform"):
        planes = transform.transform(dev["coeffs"], dev["quant"], geom)
    del dev
    return _per_image(p0, planes, output_format, crop, n, dests)
