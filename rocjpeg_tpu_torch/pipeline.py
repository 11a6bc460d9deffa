"""Batched decode of one same-shape group on the device.

Port of ``rocjpeg_tpu/pipeline.py``. The device-entropy path ships each
group's compressed lanes (not coefficient planes) to the device, where K1
(``kernels/wave.py``) decodes them into one flat coefficient tensor, K2
(``kernels/transform.py``) turns that into sample planes, and K3
(``kernels/epilogue.py``) lays out the requested format, into tensors it
allocates or into the caller's destinations. The host-entropy fallback
decodes coefficients on the host and takes the same K2 + K3 route.

Stages of the device-entropy path: :func:`pack_group` (host pack into the
group's staging buffer, one upload, ``ops.staging.Stager``), then
:func:`decode_group_device_entropy` (K1, K2, K3). A DRI=0 group's lanes
are virtual restarts: on a CUDA device the host only unstuffs the streams
and K0 (``kernels/sync.py``) finds the lanes on the card after the upload
(:func:`pack_group_synced`); on the CPU the native index walk finds them
on the host (``ops.pack.pack_virtual_segments``). Each stage runs inside a
profiler span named ``rjt.<stage>`` (``utils.trace``: ``rjt.walk``,
``rjt.pack``, ``rjt.upload``, ``rjt.wave``, ``rjt.transform``,
``rjt.epilogue``), so a profiler trace of a ``decode_batched`` call splits
its time by stage. Nothing here waits for the device: the per-lane error
flags come back as a device tensor and the caller decides when to read
them.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Optional

import numpy as np
import torch

from . import convert
from .core.zigzag import dezigzag
from .kernels import epilogue, sync, transform, wave
from .ops import pack, staging
from .ops.tables import DeviceScanTables, GroupGeometry, max_steps_bound
from .status import RocJpegError, Status
from .types import CropRectangle, OutputFormat
from .utils.trace import span


def quant_tables(params_list) -> np.ndarray:
    """(B, 3, 64) int32 natural-order quant tables per image and component
    (ones for components a stream does not have); a table of the same
    bytes as one before it is reordered once."""
    q = np.ones((len(params_list), 3, 64), np.int32)
    natural = {}
    for i, p in enumerate(params_list):
        for ci in range(min(3, p.num_components)):
            raw = p.quantiser_tables[p.components[ci].quantiser_table_selector]
            key = (raw.dtype.str, raw.tobytes())
            if key not in natural:
                natural[key] = dezigzag(raw.astype(np.int32))
            q[i, ci] = natural[key]
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
    with span("rjt.epilogue"):
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
    # K0's per-lane error flags (an image whose scan the sync rejects) and
    # its (1,) int32 flag of any such image, or None where the lanes came
    # from the host.
    lane_err: Optional[torch.Tensor] = None
    rejected: Optional[torch.Tensor] = None


def _reserve_tables(st: staging.Stager, params_list):
    """Reserve in ``st`` the group's banked Huffman tables and quant
    tables. Returns (bank_of, ((name, array), ...)): each image's table
    bank, and the arrays to put once ``st`` is open."""
    tables, bank_of = DeviceScanTables.from_params_banked(params_list)
    small = (("lentab", tables.lentab), ("values", tables.values),
             ("quant", quant_tables(params_list)))
    for name, a in small:
        st.reserve(name, a.shape, a.dtype)
    return bank_of, small


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
    with span("rjt.pack"):
        bank_of, small = _reserve_tables(st, params_list)
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
    with span("rjt.upload"):
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
    """Pack one same-shape group's lanes (restart segments, or virtual ones
    for DRI=0 scans when ``virtual_k`` is set) with the Huffman table banks
    and quant tables into one staging buffer and upload it in one copy. On
    a CUDA device a DRI=0 group's lanes are found by K0 on the card
    (:func:`pack_group_synced`); otherwise on the host (:func:`pack_host`,
    ``virtual_k`` the minimum symbol count per virtual lane of the index
    walk, then :func:`upload_group`).

    Raises RocJpegError(JPEG_NOT_SUPPORTED) past 4 Huffman table sets, and
    RocJpegError(BAD_JPEG) from a restart scan missing segments, from the
    virtual-restart walk, or from a DRI=0 scan that does not unstuff; the
    session API sends a group to the host path for the first, and for the
    DRI=0 refusals."""
    if virtual_k and torch.device(device).type == "cuda":
        return pack_group_synced(params_list, device, crop)
    with staging.Stager(device) as st:
        return upload_group(st, *pack_host(st, params_list, crop, virtual_k))


def pack_group_synced(params_list, device,
                      crop: Optional[CropRectangle] = None) -> GroupInputs:
    """A DRI=0 group's inputs with its lanes found by K0: the host stages
    the tables and each unstuffed stream (``ops.pack.stage_clean_streams``,
    in ``rjt.pack``), one copy uploads them (``rjt.upload``), and K0's
    launches (``rjt.walk`` inside a ``rjt.pack``) write the lane arrays,
    ``dc_flat``, ``lane_of_mcu`` and the per-lane error flags on the
    device, a lane every ``ops.pack.SUBSEQ_BITS`` bits of each stream,
    and whether any scan was rejected (``GroupInputs.rejected``: where the
    host walk would have refused the stream; the session API raises
    BAD_JPEG for it whatever its error check). The main path runs it on a CUDA
    device; on the CPU it runs K0's plain version. Raises as
    :func:`pack_group` does for a DRI=0 group."""
    p0 = params_list[0]
    with staging.Stager(device) as st:
        with span("rjt.pack"):
            geom = GroupGeometry.from_params(p0, len(params_list))
            bank_of, small = _reserve_tables(st, params_list)
            plan = pack.stage_clean_streams(params_list, len(geom.flat_off),
                                            bank_of, st)
            for name, a in small:
                st.put(name, a)
        with span("rjt.upload"):
            dev = st.upload()
    with span("rjt.pack"), span("rjt.walk"):
        lanes = sync.sync_lanes(
            dev["clean"], dev["sync_img"], dev["lentab"], dev["values"], geom,
            pack._total_mcus(p0), plan.n_sub, plan.n_pad, plan.n_dense,
            plan.subseq_bits, _roi_mcu_range(p0, crop), plan.period)
    pack.count_device_walk()
    dev_packed = convert.DevicePacked(
        dense=lanes.dense, word_off=lanes.word_off, img_base=lanes.img_base,
        mcu_start=lanes.mcu_start, mcu_count=lanes.mcu_count,
        lane_bank=lanes.lane_bank, n_words=plan.n_words,
        dc_flat=lanes.dc_flat, lane_of_mcu=lanes.lane_of_mcu)
    return GroupInputs(geom=geom, packed=dev_packed, lentab=dev["lentab"],
                       values=dev["values"], quant=dev["quant"],
                       max_steps=plan.max_steps, lane_img=plan.lane_img,
                       lane_err=lanes.lane_err, rejected=lanes.rejected)


def wave_group(g: GroupInputs):
    """K1 on one packed group: (flat int16 coefficients, per-lane error
    flags)."""
    dp = g.packed
    with span("rjt.wave"):
        return wave.wave_decode(
            dp.dense, dp.word_off, dp.img_base, dp.mcu_start, dp.mcu_count,
            dp.lane_bank, g.lentab, g.values, g.geom, dp.n_words,
            g.max_steps)


def transform_group(g: GroupInputs, coeffs):
    """K2 on K1's coefficients of one packed group (with the DC fixup of
    virtual lanes): the sample planes."""
    dp = g.packed
    with span("rjt.transform"):
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
    if g.lane_err is not None:
        err = err | g.lane_err
    planes = transform_group(g, coeffs)
    del coeffs  # its memory is free for K3's outputs
    per_image = _per_image(params_list[0], planes, output_format, crop,
                           len(params_list), dests)
    return per_image, err


def band_plan(dims, space: int) -> list:
    """How a host-entropy group's block rows spread over ``space`` devices:
    per band, the (component, first block row, end block row) it
    transforms. A component whose block-row count ``space`` divides is cut
    into ``space`` contiguous bands (the JAX package's ``P("data",
    "space")`` rule, ``rocjpeg_tpu/dist/sharding.py:44-47``); every other
    component goes whole into band 0. ``dims`` are the per-component
    (blocks_h, blocks_w) of the host planes. Bands left empty (when no
    component is cut) are dropped."""
    plan = [[] for _ in range(max(space, 1))]
    for c, (bh, _bw) in enumerate(dims):
        if space > 1 and bh % space == 0:
            step = bh // space
            for s in range(space):
                plan[s].append((c, s * step, (s + 1) * step))
        else:
            plan[0].append((c, 0, bh))
    return [part for part in plan if part]


def stage_band(device, params_list, coeff_planes_list, part,
               quant: np.ndarray) -> tuple:
    """K2's inputs for one band of a host-entropy group: block rows
    ``[lo, hi)`` of each component ``(c, lo, hi)`` of ``part``, of every
    image's host planes (per image, per component (bh, bw, 64) int16),
    staged to ``device`` in one upload on its current stream with their
    quant tables (``quant``, (B, 3, 64) int32, column c for component c).
    Returns (coefficients, quant tables, geometry) for
    ``kernels.transform.transform``."""
    n = len(params_list)
    image0 = coeff_planes_list[0]
    geom = GroupGeometry.from_params(params_list[0], n).with_planes(
        [(hi - lo, image0[c].shape[1]) for c, lo, hi in part])
    band_quant = np.ones_like(quant)
    band_quant[:, :len(part)] = quant[:, [c for c, _, _ in part]]
    with span("rjt.upload"), staging.Stager(device) as st:
        st.reserve("coeffs", (n * geom.total_blocks * 64,), np.int16)
        st.reserve("quant", band_quant.shape, band_quant.dtype)
        st.open()
        flat = st.view("coeffs")
        off = 0
        for image in coeff_planes_list:
            for c, lo, hi in part:
                if image[c].dtype != np.int16:
                    raise RocJpegError(
                        Status.INVALID_PARAMETER,
                        f"coefficients must be int16, got {image[c].dtype}")
                rows = image[c][lo:hi]
                flat[off:off + rows.size] = rows.reshape(-1)
                off += rows.size
        st.put("quant", band_quant)
        dev = st.upload()
    return dev["coeffs"], dev["quant"], geom


def transform_band(device, params_list, coeff_planes_list, part,
                   quant: np.ndarray):
    """K2 on one band, on ``device`` and its current stream
    (:func:`stage_band`, then the transform with no DC fixup). Returns one
    uint8 plane (B, (hi - lo) * 8, bw * 8) an entry of ``part``; the
    staged inputs are freed on return, before K3 allocates."""
    staged = stage_band(device, params_list, coeff_planes_list, part, quant)
    with span("rjt.transform"):
        return transform.transform(*staged)


def gather_bands(device, dims, plan, band_planes) -> list:
    """The full sample planes on ``device`` from :func:`transform_band`'s
    outputs (``band_planes``, one list a band of ``plan``). A component in
    one band is its plane as it is; a cut one is assembled in a new plane
    by one ``non_blocking`` copy a band. A copy from another card runs on
    that card's current stream, which first waits for ``device``'s (the
    new plane's memory is free there), and ``device``'s current stream
    then waits for it, so later work there (K3) reads the whole plane."""
    home = torch.device(device)
    planes = [None] * len(dims)
    pieces = [[] for _ in dims]
    for part, outs in zip(plan, band_planes):
        for (c, lo, hi), plane in zip(part, outs):
            if hi - lo == dims[c][0]:
                planes[c] = plane
            else:
                pieces[c].append((lo, hi, plane))
    cuda = home.type == "cuda"
    with torch.cuda.device(home) if cuda else contextlib.nullcontext():
        here = torch.cuda.current_stream(home) if cuda else None
        for c, cut in enumerate(pieces):
            if not cut:
                continue
            bh, bw = dims[c]
            full = torch.empty((cut[0][2].shape[0], bh * 8, bw * 8),
                               dtype=torch.uint8, device=home)
            for lo, hi, plane in cut:
                dst = full[:, lo * 8:hi * 8]
                if plane.device == home:
                    dst.copy_(plane, non_blocking=True)
                    continue
                there = torch.cuda.current_stream(plane.device)
                there.wait_stream(here)
                with torch.cuda.device(plane.device):
                    dst.copy_(plane, non_blocking=True)
                here.wait_stream(there)
            planes[c] = full
    return planes


def decode_group(params_list, coeff_planes_list,
                 output_format: OutputFormat, device,
                 crop: Optional[CropRectangle] = None, dests=None,
                 band_devices=()):
    """Decode one same-shape group from host-decoded coefficient planes
    (per image, per component (bh, bw, 64) int16): a staged upload of the
    planes and quant tables, K2 (no DC fixup), K3. Returns per-image lists
    of (channel, pitch), or None when the channels went into ``dests``.

    ``band_devices`` (a ``MeshDecoder`` row's devices, ``device`` first)
    spreads K2 over them by :func:`band_plan`: each band is staged to its
    device and transformed there (:func:`transform_band`), the bands are
    gathered on ``device`` (:func:`gather_bands`), and K3 runs there."""
    devices = list(band_devices) or [device]
    dims = [c.shape[:2] for c in coeff_planes_list[0]]
    plan = band_plan(dims, len(devices))
    quant = quant_tables(params_list)
    band_planes = [transform_band(dev, params_list, coeff_planes_list, part,
                                  quant)
                   for dev, part in zip(devices, plan)]
    planes = gather_bands(device, dims, plan, band_planes)
    del band_planes  # the cut bands' memory is free for K3's outputs
    return _per_image(params_list[0], planes, output_format, crop,
                      len(params_list), dests)
