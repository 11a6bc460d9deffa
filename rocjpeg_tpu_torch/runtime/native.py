"""ctypes binding of the port's native host library (``csrc/host/``).

The library is built by :mod:`.build` and loaded when a function here first
needs it, never at import; a missing g++ or a failed build raises
``build.HostBuildError``. ``ROCJPEG_TPU_TORCH_HOST_LIB`` names another
build to load instead (the ``-fsanitize=address`` one, under
``python -m rocjpeg_tpu_torch.tools.asan``); a path that does not exist
raises, and never falls back to the package's build. :func:`decode_scan`
has the signature and semantics of the Python oracle
``core.entropy.decode_scan`` — same outputs bit-for-bit; errors surface as
RocJpegError(BAD_JPEG).
"""

from __future__ import annotations

import ctypes
import functools
import os
import threading
from typing import List

import numpy as np

from ..core import bitstream as bs
from ..core.bitstream import JpegStreamParams
from ..status import RocJpegError, Status
from ..types import ChromaSubsampling
from . import build

_MAXC = 3
_MAXT = 4


class _RjtScanJob(ctypes.Structure):
    _fields_ = [
        ("scan", ctypes.c_char_p),
        ("scan_len", ctypes.c_long),
        ("restart_interval", ctypes.c_int),
        ("num_components", ctypes.c_int),
        ("interleaved", ctypes.c_int),
        ("mcus_w", ctypes.c_int),
        ("total_mcus", ctypes.c_int),
        ("h_samp", ctypes.c_int * _MAXC),
        ("v_samp", ctypes.c_int * _MAXC),
        ("dc_table", ctypes.c_int * _MAXC),
        ("ac_table", ctypes.c_int * _MAXC),
        ("dc_bits", ctypes.c_void_p * _MAXT),
        ("dc_values", ctypes.c_void_p * _MAXT),
        ("ac_bits", ctypes.c_void_p * _MAXT),
        ("ac_values", ctypes.c_void_p * _MAXT),
        ("out", ctypes.c_void_p * _MAXC),
        ("out_bw", ctypes.c_int * _MAXC),
        ("num_threads", ctypes.c_int),
    ]


_ERROR_NAMES = {
    1: "bad Huffman table", 2: "invalid Huffman code",
    3: "AC index overflow", 4: "scan data exhausted", 5: "missing restart segments",
}

_PARSE_ERRORS = {
    10: "invalid JPEG: missing SOI", 11: "corrupt marker segment: truncated",
    12: "invalid number of JPEG components",
    13: "invalid quantization table id",
    14: "16-bit quantization table is not supported",
    15: "invalid Huffman table", 16: "didn't find any Huffman table",
    17: "didn't find any quantization table",
    18: "didn't find the SOS marker", 19: "invalid sampling factors",
    20: "invalid size for DRI marker",
    21: "component id mismatch between SOS and SOF",
}


class _RjtParsedHeader(ctypes.Structure):
    _fields_ = [
        ("width", ctypes.c_int32), ("height", ctypes.c_int32),
        ("num_components", ctypes.c_int32),
        ("comp_id", ctypes.c_int32 * 4), ("h_samp", ctypes.c_int32 * 4),
        ("v_samp", ctypes.c_int32 * 4), ("quant_sel", ctypes.c_int32 * 4),
        ("qtab", (ctypes.c_uint8 * 64) * 4),
        ("load_qtab", ctypes.c_uint8 * 4),
        ("dc_bits", (ctypes.c_uint8 * 16) * 2),
        ("dc_vals", (ctypes.c_uint8 * 12) * 2),
        ("ac_bits", (ctypes.c_uint8 * 16) * 2),
        ("ac_vals", (ctypes.c_uint8 * 162) * 2),
        ("load_huff", ctypes.c_uint8 * 2),
        ("num_scan_components", ctypes.c_int32),
        ("scan_comp_sel", ctypes.c_int32 * 4),
        ("scan_dc", ctypes.c_int32 * 4), ("scan_ac", ctypes.c_int32 * 4),
        ("restart_interval", ctypes.c_int32),
        ("scan_offset", ctypes.c_int64), ("scan_end", ctypes.c_int64),
        ("subsampling", ctypes.c_int32), ("num_mcus", ctypes.c_int64),
    ]

class _RjtIndexJob(ctypes.Structure):
    _fields_ = [
        ("scan", ctypes.c_char_p),
        ("scan_len", ctypes.c_long),
        ("num_components", ctypes.c_int),
        ("interleaved", ctypes.c_int),
        ("total_mcus", ctypes.c_int),
        ("min_symbols", ctypes.c_int),
        ("h_samp", ctypes.c_int * _MAXC),
        ("v_samp", ctypes.c_int * _MAXC),
        ("dc_table", ctypes.c_int * _MAXC),
        ("ac_table", ctypes.c_int * _MAXC),
        ("dc_bits", ctypes.c_void_p * _MAXT),
        ("dc_values", ctypes.c_void_p * _MAXT),
        ("ac_bits", ctypes.c_void_p * _MAXT),
        ("ac_values", ctypes.c_void_p * _MAXT),
        ("clean", ctypes.c_void_p),
        ("bit_off", ctypes.c_void_p),
        ("dc_out", ctypes.c_void_p),
        ("mcu_idx", ctypes.c_void_p),
        ("sym_count", ctypes.c_void_p),
        ("n_records", ctypes.c_long),
        ("n_found", ctypes.c_long),
    ]


class _RjtGeomJob(ctypes.Structure):
    """Mirrors csrc RjtGeomJob: one image's index-walk record set plus its
    destination lane range, for the native lane-geometry bookkeeping."""
    _fields_ = [
        ("bo", ctypes.c_void_p),
        ("dc", ctypes.c_void_p),
        ("mi", ctypes.c_void_p),
        ("sc", ctypes.c_void_p),
        ("n_rec", ctypes.c_int64),
        ("end_bit", ctypes.c_int64),
        ("end_mcu", ctypes.c_int32),
        ("lane_start", ctypes.c_int32),
        ("img_base", ctypes.c_int32),
        ("bank", ctypes.c_int32),
        ("img_row", ctypes.c_int32),
        ("_pad", ctypes.c_int32),
    ]


_P = ctypes.c_void_p
_L = ctypes.c_long
_JOBS = ctypes.POINTER(ctypes.POINTER(_RjtIndexJob))
_GEOM = ctypes.POINTER(_RjtGeomJob)
# C entry point -> (argtypes, restype).
_SIGNATURES = {
    "rjt_decode_scan": ([ctypes.POINTER(_RjtScanJob)], ctypes.c_int),
    "rjt_parse": ([ctypes.c_char_p, _L, ctypes.POINTER(_RjtParsedHeader)],
                  ctypes.c_int),
    "rjt_seg_lens": ([ctypes.c_char_p, _L, ctypes.POINTER(ctypes.c_int), _L],
                     _L),
    "rjt_seg_offsets": ([ctypes.c_char_p, _L, _P, _P, _L], _L),
    "rjt_pack_dense": ([ctypes.c_char_p, _L, _P, _P, _L], _L),
    "rjt_unstuff": ([ctypes.c_char_p, _L, _P], _L),
    "rjt_index_scan": ([ctypes.POINTER(_RjtIndexJob)], _L),
    "rjt_index_scan2": ([ctypes.POINTER(_RjtIndexJob),
                         ctypes.POINTER(_RjtIndexJob),
                         ctypes.POINTER(_L), ctypes.POINTER(_L)], _L),
    "rjt_index_scan8": ([_JOBS, _L, ctypes.POINTER(_L)], _L),
    "rjt_index_scan16": ([_JOBS, _L, ctypes.POINTER(_L)], _L),
    "rjt_index_scan32": ([_JOBS, _L, ctypes.POINTER(_L)], _L),
    "rjt_index_scan16_available": ([], _L),
    "rjt_pack_bits": ([_P, _L, _P, _P, _P, _P, _L], None),
    "rjt_record_maxes": ([_GEOM, _L, ctypes.POINTER(ctypes.c_int64),
                          ctypes.POINTER(ctypes.c_int64)], None),
    "rjt_lane_geometry": ([_GEOM, _L, _P, _P, _P, _P, _P, _P, _P, _P, _P,
                           ctypes.c_int64], None),
}

_lock = threading.Lock()
_loaded = None

# Names a host library to load in place of the package's own build.
HOST_LIB_ENV = "ROCJPEG_TPU_TORCH_HOST_LIB"


def library_file() -> str:
    """The host library to load: the file ``ROCJPEG_TPU_TORCH_HOST_LIB``
    names when it is set, else the package's build (built first if
    needed)."""
    path = os.environ.get(HOST_LIB_ENV)
    if not path:
        return build.build()
    if not os.path.isfile(path):
        raise build.HostBuildError(
            f"{HOST_LIB_ENV}={path}: no such library file")
    return path


def _lib() -> ctypes.CDLL:
    """The loaded host library, built first if needed."""
    global _loaded
    with _lock:
        if _loaded is None:
            lib = ctypes.CDLL(library_file())
            for name, (argtypes, restype) in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = restype
            _loaded = lib
        return _loaded


def decode_scan(params: JpegStreamParams,
                num_threads: int = 0) -> List[np.ndarray]:
    """Native entropy decode; drop-in for core.entropy.decode_scan.

    num_threads=0 uses all host cores for restart-segmented scans.
    """
    ncomp_scan = len(params.scan_components)
    if ncomp_scan == 0 or not params.components:
        raise RocJpegError(Status.BAD_JPEG, "no scan components")

    job = _RjtScanJob()
    scan = params.slice_data
    job.scan = scan
    job.scan_len = len(scan)
    job.restart_interval = params.restart_interval
    job.num_components = ncomp_scan
    interleaved = ncomp_scan > 1
    job.interleaved = int(interleaved)
    if interleaved:
        job.mcus_w = params.mcus_per_row
        job.total_mcus = params.num_mcus
    else:
        bw = (params.picture_width + 7) // 8
        bh = (params.picture_height + 7) // 8
        job.mcus_w = bw
        job.total_mcus = bw * bh

    outputs = []
    keepalive = []
    for ci in range(len(params.components)):
        fc = params.components[ci]
        out = np.zeros(params.component_block_dims(ci) + (64,), np.int16)
        outputs.append(out)
        if ci < ncomp_scan:
            sc = params.scan_components[ci]
            job.h_samp[ci] = fc.h_sampling_factor
            job.v_samp[ci] = fc.v_sampling_factor
            job.dc_table[ci] = sc.dc_table_selector
            job.ac_table[ci] = sc.ac_table_selector
            job.out[ci] = out.ctypes.data
            job.out_bw[ci] = out.shape[1]

    for tid in range(min(_MAXT, len(params.huffman_tables))):
        if not params.load_huffman_table[tid]:
            continue
        t = params.huffman_tables[tid]
        for arr, field in ((t.num_dc_codes, "dc_bits"), (t.dc_values, "dc_values"),
                           (t.num_ac_codes, "ac_bits"), (t.ac_values, "ac_values")):
            a = np.ascontiguousarray(arr, np.uint8)
            keepalive.append(a)
            getattr(job, field)[tid] = a.ctypes.data

    # Validate selectors point at loaded tables (C side checks pointers).
    for sc in params.scan_components:
        for tid in (sc.dc_table_selector, sc.ac_table_selector):
            if tid >= len(params.huffman_tables) or not params.load_huffman_table[tid]:
                raise RocJpegError(Status.BAD_JPEG, f"huffman table {tid} not loaded")

    job.num_threads = num_threads or (os.cpu_count() or 1)

    rc = _lib().rjt_decode_scan(ctypes.byref(job))
    if rc != 0:
        raise RocJpegError(Status.BAD_JPEG,
                           _ERROR_NAMES.get(rc, f"native decode error {rc}"))
    return outputs



def parse_header(data: bytes):
    """Native JPEG header parse; fills a JpegStreamParams exactly like the
    Python parser (core/bitstream.py). Raises RocJpegError(BAD_JPEG) with
    the Python parser's message strings."""
    hdr = _RjtParsedHeader()
    rc = _lib().rjt_parse(data, len(data), ctypes.byref(hdr))
    if rc != 0:
        raise RocJpegError(Status.BAD_JPEG,
                           _PARSE_ERRORS.get(rc, f"parse error {rc}"))
    p = bs.JpegStreamParams()
    p.picture_width = hdr.width
    p.picture_height = hdr.height
    p.num_components = hdr.num_components
    p.components = [
        bs.FrameComponent(component_id=hdr.comp_id[i],
                          h_sampling_factor=hdr.h_samp[i],
                          v_sampling_factor=hdr.v_samp[i],
                          quantiser_table_selector=hdr.quant_sel[i])
        for i in range(hdr.num_components)
    ]
    # One bulk copy of the struct; numpy views into it by field offset
    # (per-field ctypes->numpy conversion costs ~10us each).
    raw = bytearray(bytes(hdr))
    H = _RjtParsedHeader

    def view(field, count, shape=None):
        a = np.frombuffer(raw, np.uint8, count, getattr(H, field).offset)
        return a.reshape(shape) if shape else a

    p.quantiser_tables = view("qtab", 256, (4, 64))
    p.load_quantiser_table = view("load_qtab", 4)
    dc_bits = view("dc_bits", 32, (2, 16))
    dc_vals = view("dc_vals", 24, (2, 12))
    ac_bits = view("ac_bits", 32, (2, 16))
    ac_vals = view("ac_vals", 324, (2, 162))
    for tid in range(2):
        t = p.huffman_tables[tid]
        t.num_dc_codes = dc_bits[tid]
        t.dc_values = dc_vals[tid]
        t.num_ac_codes = ac_bits[tid]
        t.ac_values = ac_vals[tid]
    p.load_huffman_table = view("load_huff", 2)
    p.scan_components = [
        bs.ScanComponent(component_selector=hdr.scan_comp_sel[i],
                         dc_table_selector=hdr.scan_dc[i],
                         ac_table_selector=hdr.scan_ac[i])
        for i in range(hdr.num_scan_components)
    ]
    p.restart_interval = hdr.restart_interval
    p.num_mcus = int(hdr.num_mcus)
    p.slice_data = data[hdr.scan_offset:hdr.scan_end]
    try:
        p.chroma_subsampling = ChromaSubsampling(hdr.subsampling)
    except ValueError:
        # Unclassifiable sampling patterns parse to UNKNOWN (a value, not an
        # error — reference parser.cpp:432-470 rejects at decode time).
        p.chroma_subsampling = ChromaSubsampling.CSS_UNKNOWN
    return p


def seg_lens(scan: bytes, max_segs: int) -> np.ndarray:
    """Clean (unstuffed) byte length of each restart segment of a scan."""
    out = np.zeros(max_segs, np.int32)
    n = _lib().rjt_seg_lens(scan, len(scan),
                          out.ctypes.data_as(ctypes.POINTER(ctypes.c_int)),
                          max_segs)
    return out[:min(int(n), max_segs)], int(n)


def seg_offsets(scan: bytes, max_segs: int):
    """Clean lengths AND raw byte offsets of each restart segment (the raw
    offset lets a packer start mid-scan — byte stuffing is context-free).
    Returns (lens int32 (n,), raw_off int64 (n,), found)."""
    lens = np.zeros(max_segs, np.int32)
    raw = np.zeros(max_segs, np.int64)
    n = _lib().rjt_seg_offsets(scan, len(scan),
                             ctypes.c_void_p(lens.ctypes.data),
                             ctypes.c_void_p(raw.ctypes.data), max_segs)
    m = min(int(n), max_segs)
    return lens[:m], raw[:m], int(n)



def pack_dense(scan: bytes, dense: np.ndarray, word_off: np.ndarray,
               max_segs: int) -> int:
    """Write a scan's unstuffed segments word-aligned into the dense uint32
    stream at precomputed per-segment word offsets (GIL released). It
    writes each segment's bytes, not whole words: the last word of every
    segment must be zero beforehand (``ops.pack`` zeroes it)."""
    return int(_lib().rjt_pack_dense(
        scan, len(scan), ctypes.c_void_p(dense.ctypes.data),
        ctypes.c_void_p(np.ascontiguousarray(word_off, np.int32).ctypes.data),
        max_segs))


def unstuff(scan: bytes) -> np.ndarray:
    """Remove the byte stuffing (0xFF00 -> 0xFF) of a DRI=0 scan with the
    unstuffer the index walkers run first (csrc rjt_unstuff). Returns the
    clean bytes, a view of a buffer with the walkers' 8 zero bytes of slack
    past them; raises RocJpegError(BAD_JPEG) when a restart marker is
    embedded."""
    out = np.empty(len(scan) + 8, np.uint8)
    return out[:unstuff_into(scan, out)]


def unstuff_into(scan: bytes, out: np.ndarray) -> int:
    """:func:`unstuff` into ``out``, a writable contiguous uint8 array of at
    least ``len(scan) + 8`` bytes (any contents): the clean bytes, then 8
    zero bytes. Returns the clean length (GIL released); raises
    RocJpegError(BAD_JPEG) when a restart marker is embedded."""
    if (out.dtype != np.uint8 or not out.flags.c_contiguous
            or not out.flags.writeable or out.size < len(scan) + 8):
        raise RocJpegError(Status.INVALID_PARAMETER,
                           "unstuff buffer too small or not writable uint8")
    n = int(_lib().rjt_unstuff(scan, len(scan),
                               ctypes.c_void_p(out.ctypes.data)))
    if n < 0:
        raise RocJpegError(Status.BAD_JPEG,
                           "restart marker embedded in DRI=0 scan")
    return n


def unstuff_many(scans, out: np.ndarray, offsets: np.ndarray) -> np.ndarray:
    """:func:`unstuff_into` of every scan of ``scans``: scan i into ``out``
    from byte ``offsets[i]``, which must leave it ``len(scan) + 8`` bytes.
    For small scans: the calls keep the interpreter lock (a handle of the
    library loaded with ``ctypes.PyDLL``), which costs a few microseconds a
    scan where handing the lock back and forth under other busy threads
    could cost milliseconds. Returns the clean lengths (int64); raises
    RocJpegError(BAD_JPEG) when a restart marker is embedded in one."""
    n = len(scans)
    lens = np.fromiter(map(len, scans), np.int64, n)
    offs = np.ascontiguousarray(offsets, np.int64)
    if (out.dtype != np.uint8 or not out.flags.c_contiguous
            or not out.flags.writeable or offs.shape != (n,)
            or (n and (offs.min() < 0
                       or (offs + lens + 8).max() > out.size))):
        raise RocJpegError(Status.INVALID_PARAMETER,
                           "unstuff buffer too small or not writable uint8")
    fn = _held_unstuff()
    base = out.ctypes.data
    clean = np.empty(n, np.int64)
    for i, scan in enumerate(scans):
        c = fn(scan, len(scan), base + int(offs[i]))
        if c < 0:
            raise RocJpegError(Status.BAD_JPEG,
                               "restart marker embedded in DRI=0 scan")
        clean[i] = c
    return clean


_held = None


def _held_unstuff():
    """``rjt_unstuff`` of the loaded host library, called without
    releasing the interpreter lock."""
    global _held
    _lib()  # built and loaded first: it takes the same lock
    with _lock:
        if _held is None:
            fn = ctypes.PyDLL(library_file()).rjt_unstuff
            fn.argtypes, fn.restype = _SIGNATURES["rjt_unstuff"]
            _held = fn
        return _held


def _index_totals(params: JpegStreamParams) -> int:
    """MCUs the walk steps over (blocks for a single-component scan)."""
    if len(params.scan_components) > 1:
        return params.num_mcus
    return (((params.picture_width + 7) // 8)
            * (((params.picture_height + 7) // 8)))


def index_job_capacities(params: JpegStreamParams, min_symbols: int):
    """(clean bytes, records) a buffer set needs for one walk of
    ``params``' scan: the clean stream plus the walkers' 8 bytes of slack,
    and the record-capacity bound."""
    scan = params.slice_data
    # One record per >= min_symbols symbols, each symbol consumes >= 1 bit
    # of scan payload; also at most one per MCU.
    n_rec = (min(_index_totals(params), len(scan) * 8 // max(1, min_symbols))
             + 2)
    return len(scan) + 8, n_rec


def _build_index_job(params: JpegStreamParams, min_symbols: int, bufs=None):
    """Fill an _RjtIndexJob + output buffers for one stream. Returns
    (job, clean, bit_off, dc, mcu_idx, sym_count, keepalive).

    ``bufs``: an optional pooled (clean uint8, bit_off int64, dc int32
    (n, 3), mcu_idx int32, sym_count int32) set with at least
    :func:`index_job_capacities`; its contents may be anything, since the
    native unstuffer zeroes the 8 bytes of slack past the clean stream
    that the walkers' clamped refill reads (``unstuff_scan``). The results
    are views of the set."""
    ncomp_scan = len(params.scan_components)
    interleaved = ncomp_scan > 1
    total = _index_totals(params)
    clean_bytes, n_rec = index_job_capacities(params, min_symbols)
    scan = params.slice_data

    job = _RjtIndexJob()
    job.scan = scan
    job.scan_len = len(scan)
    job.num_components = ncomp_scan
    job.interleaved = int(interleaved)
    job.total_mcus = total
    job.min_symbols = min_symbols
    keepalive = [scan]
    for ci in range(ncomp_scan):
        fc = params.components[ci]
        sc = params.scan_components[ci]
        job.h_samp[ci] = fc.h_sampling_factor
        job.v_samp[ci] = fc.v_sampling_factor
        job.dc_table[ci] = sc.dc_table_selector
        job.ac_table[ci] = sc.ac_table_selector
    for tid in range(min(_MAXT, len(params.huffman_tables))):
        if not params.load_huffman_table[tid]:
            continue
        t = params.huffman_tables[tid]
        for arr, field in ((t.num_dc_codes, "dc_bits"),
                           (t.dc_values, "dc_values"),
                           (t.num_ac_codes, "ac_bits"),
                           (t.ac_values, "ac_values")):
            a = np.ascontiguousarray(arr, np.uint8)
            keepalive.append(a)
            getattr(job, field)[tid] = a.ctypes.data

    if bufs is None:
        bufs = (np.empty(clean_bytes, np.uint8), np.empty(n_rec, np.int64),
                np.empty((n_rec, 3), np.int32), np.empty(n_rec, np.int32),
                np.empty(n_rec, np.int32))
    clean, bit_off, dc, mcu_idx, sym_count = bufs
    if (clean.dtype != np.uint8 or bit_off.dtype != np.int64
            or dc.dtype != np.int32 or mcu_idx.dtype != np.int32
            or sym_count.dtype != np.int32 or dc.shape[1:] != (3,)
            or len(clean) < clean_bytes
            or min(len(bit_off), len(dc), len(mcu_idx),
                   len(sym_count)) < n_rec):
        raise RocJpegError(Status.INVALID_PARAMETER,
                           "index walk buffers too small or of a wrong dtype")
    clean = clean[:clean_bytes]
    job.clean = clean.ctypes.data
    job.bit_off = bit_off.ctypes.data
    job.dc_out = dc.ctypes.data
    job.mcu_idx = mcu_idx.ctypes.data
    job.sym_count = sym_count.ctypes.data
    job.n_records = n_rec
    return job, clean, bit_off, dc, mcu_idx, sym_count, keepalive


def index_scan(params: JpegStreamParams, min_symbols: int, bufs=None):
    """Virtual-restart index pass for a DRI=0 scan (csrc rjt_index_scan):
    walks the Huffman symbol stream recording the clean-stream bit offset,
    MCU index, and DC predictor values at the first MCU boundary after
    every >= ``min_symbols`` decoded symbols (symbol-balanced lanes).

    Returns (clean uint8, bit_off int64 (n,), dc int32 (n, 3),
    mcu_idx int32 (n,), sym_count int32 (n,)). Raises
    RocJpegError(BAD_JPEG) if the walk hits an invalid code — the caller
    falls back to the host decode path, which reports precisely.
    ``bufs``: an optional pooled buffer set (see ``_build_index_job``).
    """
    job, clean, bit_off, dc, mcu_idx, sym_count, _keep = _build_index_job(
        params, min_symbols, bufs)
    rc = int(_lib().rjt_index_scan(ctypes.byref(job)))
    if rc < 0:
        raise RocJpegError(Status.BAD_JPEG,
                           _ERROR_NAMES.get(-rc, f"native index error {-rc}"))
    n = job.n_found
    return clean[:rc], bit_off[:n], dc[:n], mcu_idx[:n], sym_count[:n]


def index_scan2(pa: JpegStreamParams, pb: JpegStreamParams,
                min_symbols: int, bufs_list=None):
    """Dual-stream index pass (csrc rjt_index_scan2): walks two same-shape
    streams symbol-interleaved so the core overlaps their independent
    dependency chains. Returns a list of two
    (clean, bit_off, dc, mcu_idx, sym_count) tuples. ``bufs_list``: an
    optional pooled buffer set a stream."""
    bufs_list = bufs_list or (None, None)
    ja, ca, boa, dca, mia, sca, _ka = _build_index_job(pa, min_symbols,
                                                       bufs_list[0])
    jb, cb, bob, dcb, mib, scb, _kb = _build_index_job(pb, min_symbols,
                                                       bufs_list[1])
    la = ctypes.c_long(0)
    lb = ctypes.c_long(0)
    rc = int(_lib().rjt_index_scan2(ctypes.byref(ja), ctypes.byref(jb),
                                    ctypes.byref(la), ctypes.byref(lb)))
    if rc < 0:
        raise RocJpegError(Status.BAD_JPEG,
                           _ERROR_NAMES.get(-rc, f"native index error {-rc}"))
    na, nb = ja.n_found, jb.n_found
    return [(ca[:la.value], boa[:na], dca[:na], mia[:na], sca[:na]),
            (cb[:lb.value], bob[:nb], dcb[:nb], mib[:nb], scb[:nb])]


def _index_scan_simd(params_list, min_symbols: int, n: int, fn,
                     bufs_list=None):
    """Shared wrapper for the SIMD n-stream index walkers: builds the n
    jobs (on ``bufs_list``'s pooled sets when given), runs the native
    walker, and slices the per-job outputs. Returns None on
    -RJT_BAD_SEGMENTS: the SIMD tier is unavailable, the jobs are not
    uniform (geometry, table assignments and contents), a stream does not
    unstuff, or (AVX-512) a clean buffer lies beyond a 32-bit offset of the
    lowest, as buffers of separate allocations may (``ops.staging``'s walk
    sets share one slab). Callers fall back to the next-narrower walker."""
    built = [_build_index_job(p, min_symbols,
                              bufs_list[i] if bufs_list else None)
             for i, p in enumerate(params_list)]
    jobs = (ctypes.POINTER(_RjtIndexJob) * n)(
        *[ctypes.pointer(b[0]) for b in built])
    clean_lens = (ctypes.c_long * n)()
    rc = int(fn(jobs, n, clean_lens))
    if rc == -5:  # RJT_BAD_SEGMENTS
        return None
    if rc < 0:
        raise RocJpegError(Status.BAD_JPEG,
                           _ERROR_NAMES.get(-rc, f"native index error {-rc}"))
    out = []
    for i, (job, clean, bit_off, dc, mcu_idx, sym_count, _k) in enumerate(built):
        nf = job.n_found
        out.append((clean[:clean_lens[i]], bit_off[:nf], dc[:nf],
                    mcu_idx[:nf], sym_count[:nf]))
    return out


def index_scan8(params_list, min_symbols: int, bufs_list=None):
    """SIMD 8-stream index pass (csrc rjt_index_scan8, AVX2): eight
    same-shape, same-table streams walked in vector lanes. Returns a list of eight
    (clean, bit_off, dc, mcu_idx, sym_count) tuples, or None when the SIMD
    path refuses them (no AVX2, non-uniform jobs, a stream that does not
    unstuff: see ``_index_scan_simd``) — callers fall back to the scalar
    pair walker."""
    if len(params_list) != 8:
        return None
    return _index_scan_simd(params_list, min_symbols, 8,
                            _lib().rjt_index_scan8, bufs_list)


@functools.lru_cache(maxsize=1)
def index_scan16_available() -> bool:
    """Whether the AVX-512 16-stream walker can run on this host (static
    CPU probe; lets callers pick a chunk width once instead of building 16
    jobs per batch only to be rejected)."""
    return bool(_lib().rjt_index_scan16_available())


def index_scan16(params_list, min_symbols: int, bufs_list=None):
    """AVX-512 16-stream index pass (csrc rjt_index_scan16): sixteen
    same-shape, same-table streams walked in vector lanes. Returns a list
    of sixteen (clean, bit_off, dc, mcu_idx, sym_count) tuples, or None
    when the path refuses them (no AVX-512, non-uniform jobs, clean
    buffers spread beyond 32-bit offsets: see ``_index_scan_simd``) —
    callers fall back to the 8-lane walker."""
    if len(params_list) != 16 or not index_scan16_available():
        return None
    return _index_scan_simd(params_list, min_symbols, 16,
                            _lib().rjt_index_scan16, bufs_list)


def index_scan32(params_list, min_symbols: int, bufs_list=None):
    """32-stream index pass (csrc rjt_index_scan32): TWO 16-lane AVX-512
    groups interleaved on one core, overlapping the two groups' gather
    dependency chains in the out-of-order window (faster than two
    separate 16-lane walks). Returns a list of 32
    (clean, bit_off, dc, mcu_idx, sym_count) tuples, or None when the
    path refuses them (as ``index_scan16`` does) — callers fall back to
    two 16-lane walks."""
    if len(params_list) != 32 or not index_scan16_available():
        return None
    return _index_scan_simd(params_list, min_symbols, 32,
                            _lib().rjt_index_scan32, bufs_list)


def pack_bits(clean: np.ndarray, dense: np.ndarray, word_off: np.ndarray,
              bit_start: np.ndarray, bit_end: np.ndarray) -> None:
    """Pack per-lane bit ranges of a clean stream into the dense word stream
    (each lane's first bit lands at bit 31 of its first word; GIL released)."""
    _lib().rjt_pack_bits(
        ctypes.c_void_p(clean.ctypes.data), len(clean),
        ctypes.c_void_p(dense.ctypes.data),
        ctypes.c_void_p(np.ascontiguousarray(word_off, np.int32).ctypes.data),
        ctypes.c_void_p(np.ascontiguousarray(bit_start, np.int64).ctypes.data),
        ctypes.c_void_p(np.ascontiguousarray(bit_end, np.int64).ctypes.data),
        len(word_off))


def _require(a: np.ndarray, dtype) -> None:
    """Raise unless ``a`` is a C-contiguous array of ``dtype`` (the native
    code indexes it by raw pointer)."""
    if a.dtype != dtype or not a.flags.c_contiguous:
        raise RocJpegError(Status.INVALID_PARAMETER,
                           f"expected a contiguous {np.dtype(dtype).name} "
                           f"array, got {a.dtype}")


def build_geom_jobs(meta):
    """Build the ctypes RjtGeomJob array for record_maxes/lane_geometry.

    ``meta``: per image, a tuple (bo int64 (n,), dc int32 (n, 3), mi int32
    (n,), sc int32 (n,), end_bit, end_mcu, lane_start, img_base, bank,
    img_row); arrays must be C-contiguous (slices of the walkers' record
    buffers are). The returned array holds RAW pointers — the caller must
    keep the arrays alive across the native calls."""
    n = len(meta)
    arr = (_RjtGeomJob * n)()
    for k, (bo, dc, mi, sc, eb, em, ls, ib, bank, row) in enumerate(meta):
        _require(bo, np.int64)
        for a in (dc, mi, sc):
            _require(a, np.int32)
        j = arr[k]
        j.bo = bo.ctypes.data
        j.dc = dc.ctypes.data
        j.mi = mi.ctypes.data
        j.sc = sc.ctypes.data
        j.n_rec = len(bo)
        j.end_bit = int(eb)
        j.end_mcu = int(em)
        j.lane_start = int(ls)
        j.img_base = int(ib)
        j.bank = int(bank)
        j.img_row = int(row)
    return arr


def record_maxes(jobs_arr, n: int):
    """Native pass over all kept records: (max lane bit-span, max lane
    symbol count) — the packer's buffer-sizing inputs. GIL released."""
    mb = ctypes.c_int64(0)
    ms = ctypes.c_int64(0)
    _lib().rjt_record_maxes(jobs_arr, n, ctypes.byref(mb), ctypes.byref(ms))
    return int(mb.value), int(ms.value)


def lane_geometry(jobs_arr, n: int, lane_words, bit_starts, bit_ends,
                  img_base, mcu_start, mcu_count, lane_bank, dc_flat,
                  lane_of_mcu, total_mcus: int) -> None:
    """Fill the per-lane geometry arrays + lane_of_mcu gather key from the
    walk records, in native code with the GIL released. Output arrays must be
    pre-zeroed and sized to the padded lane count."""
    for a in (lane_words, bit_starts, bit_ends):
        _require(a, np.int64)
    for a in (img_base, mcu_start, mcu_count, lane_bank, dc_flat,
              lane_of_mcu):
        _require(a, np.int32)
    _lib().rjt_lane_geometry(
        jobs_arr, n,
        ctypes.c_void_p(lane_words.ctypes.data),
        ctypes.c_void_p(bit_starts.ctypes.data),
        ctypes.c_void_p(bit_ends.ctypes.data),
        ctypes.c_void_p(img_base.ctypes.data),
        ctypes.c_void_p(mcu_start.ctypes.data),
        ctypes.c_void_p(mcu_count.ctypes.data),
        ctypes.c_void_p(lane_bank.ctypes.data),
        ctypes.c_void_p(dc_flat.ctypes.data),
        ctypes.c_void_p(lane_of_mcu.ctypes.data),
        ctypes.c_int64(total_mcus))
