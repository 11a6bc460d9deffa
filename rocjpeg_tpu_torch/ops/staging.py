"""Host staging layer of the main path: one packer thread pool, pooled
index-walk buffers, and page-locked staging buffers uploaded in one copy a
group.

Counterpart of the JAX package's ``_pack_pool``, ``_IdxBufPool``,
``_RingPool`` and ``stage_small_args`` (``rocjpeg_tpu/ops/device_entropy.py``),
redesigned for CUDA:

- :func:`pack_pool` is one ``ThreadPoolExecutor`` a process, shared by every
  ``Decoder`` and mesh row (the native packers and walkers release the
  interpreter lock). A job on it never waits on another job of it.
- :class:`IdxBufPool` keeps the index walk's buffer sets (clean streams and
  record arrays) for the next call, keyed by bucketed capacity. A set's
  clean streams lie in one slab, where the AVX-512 walkers can address
  them by 32-bit offsets. The native unstuffer zeroes the 8 bytes past
  each clean stream that the walkers' clamped refill reads, so a dirty set
  decodes as a fresh one.
- :class:`StagingPool` keeps the host buffers a group is staged in. On a
  CUDA device they are page-locked (``cudaHostRegister``, portable across
  the process's cards). A buffer comes back with the event recorded after
  the copy that read it, and is handed out again only once that event has
  completed: an acquire that finds every buffer of its size still being
  copied waits on the oldest one's event. Capacities are bucketed
  (:func:`bucket_fine`, 1/8-geometric steps of 64 KiB), so warm calls of one
  shape allocate nothing. The pool holds at most ``depth`` buffers a size
  and ``max_bytes`` in all (idle buffers are evicted least recently used
  first); a buffer evicted while its copy is in flight is unregistered and
  freed only after its event. On the CPU the same pool hands out plain
  buffers, with the same layout and the same dirty contents.
- :class:`Stager` replaces ``stage_small_args``: every array of a group is
  laid out in one staging buffer at 256-byte offsets, the packers write the
  dense word stream straight into it, and :meth:`Stager.upload` makes one
  ``non_blocking`` copy on the device's current stream, whose tensors are
  views of the copied buffer.

Buffers are dirty when handed out: a writer overwrites or zeroes every byte
a kernel reads (``ops.pack`` lists them). A pinned allocation, a copy or an
event that fails raises ``RocJpegError``; nothing falls back to pageable
memory or to the CPU.
"""

from __future__ import annotations

import concurrent.futures
import os
import threading
from typing import Dict, Optional

import numpy as np
import torch

from ..status import RocJpegError, Status
from ..utils.trace import span

ALIGN = 256  # bytes: the alignment of every staged array in its buffer
_PAGE = 4096
_STAGE_QUANTUM = 1 << 16
_WALK_QUANTUM = 1 << 16
_TORCH_DTYPES = {np.dtype(np.int16): torch.int16,
                 np.dtype(np.int32): torch.int32,
                 np.dtype(np.uint32): torch.int32}  # uint32 travels as bits


def bucket(n: int, quantum: int) -> int:
    """Round n up to a power-of-two multiple of quantum."""
    b = quantum
    while b < n:
        b <<= 1
    return b


def bucket_fine(n: int, quantum: int) -> int:
    """Round n up to a 1/8-geometric bucket (a power of two times 8..15
    eighths of a quantum)."""
    b = quantum
    while b * 2 < n:
        b <<= 1
    if n <= b:
        return b
    step = max(b // 8, quantum)
    return b + -(-(n - b) // step) * step


# --- the packer pool ---------------------------------------------------------

_pack_pool = None
_pack_pool_lock = threading.Lock()


def pack_pool() -> concurrent.futures.ThreadPoolExecutor:
    """The process's packer pool, one thread a core, made at first use."""
    global _pack_pool
    with _pack_pool_lock:
        if _pack_pool is None:
            _pack_pool = concurrent.futures.ThreadPoolExecutor(
                max(1, os.cpu_count() or 1), thread_name_prefix="rjt-pack")
        return _pack_pool


def map_jobs(fn, jobs) -> list:
    """fn over jobs on :func:`pack_pool`, results in order; one job runs
    inline. ``fn`` must not itself wait on the pool."""
    jobs = list(jobs)
    if len(jobs) <= 1:
        return [fn(j) for j in jobs]
    return list(pack_pool().map(fn, jobs))


# --- host memory -------------------------------------------------------------

def _cuda_check(rc, what: str) -> None:
    if int(rc) != 0:
        raise RocJpegError(Status.OUTOF_MEMORY,
                           f"{what} failed (CUDA error {int(rc)})")


def _alloc_host(nbytes: int, pinned: bool) -> np.ndarray:
    """``nbytes`` of host memory, contents undefined. Pinned buffers cover
    whole pages of their own (cudaHostRegister pins pages, and two
    registrations may not share one) and are registered portable, since
    mesh rows on several cards share the pool."""
    if not pinned:
        return np.empty(nbytes, np.uint8)
    size = -(-max(nbytes, 1) // _PAGE) * _PAGE
    raw = np.empty(size + _PAGE, np.uint8)
    lead = -raw.ctypes.data % _PAGE
    buf = raw[lead:lead + size]
    _cuda_check(torch.cuda.cudart().cudaHostRegister(
        buf.ctypes.data, size, 1), f"page-locking {size} bytes")
    return buf[:nbytes]


def _free_host(buf: "_HostBuffer") -> None:
    if buf.pinned:
        _cuda_check(torch.cuda.cudart().cudaHostUnregister(buf.host.ctypes.data),
                    "unregistering a staging buffer")


class _HostBuffer:
    """One pooled host buffer and the event of the last copy from it."""
    __slots__ = ("host", "pinned", "key", "event", "tick")

    def __init__(self, host, pinned, key):
        self.host, self.pinned, self.key = host, pinned, key
        self.event = None
        self.tick = 0

    def ready(self) -> bool:
        if self.event is not None and not self.event.query():
            return False
        self.event = None
        return True


class StagingPool:
    """Staging buffers keyed by (bucketed capacity, pinned), each handed out
    again only after the event it came back with has completed (see the
    module docstring). ``stats()`` counts allocations, event-gated waits,
    evictions and the bytes held."""

    def __init__(self, max_bytes: int = 1 << 30, depth: int = 8):
        self.max_bytes = max_bytes
        self.depth = depth
        self._cv = threading.Condition()
        self._idle: Dict[tuple, list] = {}   # key -> buffers, oldest first
        self._out: Dict[tuple, int] = {}     # key -> buffers handed out
        self._retired: list = []             # evicted, copy in flight
        self._abandoned: list = []           # copy state unknown: kept
        self._held = 0
        self._tick = 0
        self._stats = dict.fromkeys(
            ("allocations", "allocated_bytes", "reuses", "waits",
             "evictions"), 0)

    def stats(self) -> dict:
        with self._cv:
            return dict(self._stats, held_bytes=self._held,
                        idle=sum(map(len, self._idle.values())),
                        retired=len(self._retired))

    def acquire(self, nbytes: int, pinned: bool = False) -> _HostBuffer:
        """A buffer of at least ``nbytes`` whose last copy has completed."""
        key = (bucket_fine(max(int(nbytes), 1), _STAGE_QUANTUM), bool(pinned))
        with self._cv:
            while True:
                self._reap()
                idle = self._idle.setdefault(key, [])
                ready = next((b for b in idle if b.ready()), None)
                if ready is not None:
                    idle.remove(ready)
                    return self._hand_out(ready, "reuses")
                if len(idle) + self._out.get(key, 0) < self.depth:
                    self._out[key] = self._out.get(key, 0) + 1
                    self._held += key[0]
                    self._make_room()
                    pending = None
                    break
                if idle:  # the oldest copy of this size ends first
                    pending = self._hand_out(idle.pop(0), "waits")
                    break
                with span("rjt.stage_wait"):
                    self._cv.wait()  # every buffer of this size is out
        if pending is not None:
            try:
                with span("rjt.stage_wait"):
                    pending.event.synchronize()
            except RuntimeError as exc:
                self.abandon(pending)
                raise RocJpegError(Status.EXECUTION_FAILED,
                                   f"waiting on a staging copy: {exc}") from exc
            pending.event = None
            return pending
        try:
            host = _alloc_host(key[0], pinned)
        except BaseException:
            with self._cv:
                self._out[key] -= 1
                self._held -= key[0]
                self._cv.notify_all()
            raise
        with self._cv:
            self._stats["allocations"] += 1
            self._stats["allocated_bytes"] += key[0]
        return _HostBuffer(host, pinned, key)

    def release(self, buf: _HostBuffer, event=None) -> None:
        """Give ``buf`` back; ``event`` (``query()``, ``synchronize()``) is
        recorded after the last copy that reads it, or None."""
        with self._cv:
            buf.event = event
            self._tick += 1
            buf.tick = self._tick
            self._out[buf.key] -= 1
            self._idle.setdefault(buf.key, []).append(buf)
            self._reap()
            self._make_room()
            self._cv.notify_all()

    def abandon(self, buf: _HostBuffer) -> None:
        """Take ``buf`` out of circulation for good: a copy from it may be in
        flight with no event to tell when it ends."""
        with self._cv:
            self._out[buf.key] -= 1
            self._abandoned.append(buf)
            self._cv.notify_all()

    def _hand_out(self, buf, stat):
        self._out[buf.key] = self._out.get(buf.key, 0) + 1
        self._stats[stat] += 1
        return buf

    def _make_room(self) -> None:
        """Evict idle buffers, least recently released first, while the
        pool holds more than ``max_bytes``."""
        idle = sorted((b for bufs in self._idle.values() for b in bufs),
                      key=lambda b: b.tick)
        for buf in idle:
            if self._held <= self.max_bytes:
                break
            self._idle[buf.key].remove(buf)
            self._evict(buf)

    def _evict(self, buf) -> None:
        self._stats["evictions"] += 1
        if buf.ready():
            self._held -= buf.key[0]
            _free_host(buf)
        else:
            self._retired.append(buf)

    def _reap(self) -> None:
        """Free the evicted buffers whose copies have completed."""
        for buf in [b for b in self._retired if b.ready()]:
            self._retired.remove(buf)
            self._held -= buf.key[0]
            _free_host(buf)


_staging_pool = None
_staging_pool_lock = threading.Lock()


def staging_pool() -> StagingPool:
    """The process's staging pool, shared by every ``Decoder``, mesh row and
    card."""
    global _staging_pool
    with _staging_pool_lock:
        if _staging_pool is None:
            _staging_pool = StagingPool()
        return _staging_pool


# --- the index walk's buffers ------------------------------------------------

SLAB_ALIGN = 64
WALK_SLACK = 8  # zero bytes past a clean stream that the walkers' refill reads
# The AVX-512 walkers address every clean stream of a chunk by a 32-bit
# offset from the lowest one, and refuse a chunk whose streams (their slack
# included) reach further.
SLAB_SPAN_LIMIT = (1 << 32) - 8


def _walk_key(clean_bytes: int, n_rec: int) -> tuple:
    return (bucket(max(clean_bytes, 1), _WALK_QUANTUM),
            bucket(max(n_rec, 1), 256))


def slab_stride(clean_bytes: int) -> int:
    """Bytes from one stream's clean buffer to the next in a walk set's
    slab: the bucketed capacity plus the walkers' slack, rounded up to
    ``SLAB_ALIGN``."""
    cb = _walk_key(clean_bytes, 1)[0]
    return -(-(cb + WALK_SLACK) // SLAB_ALIGN) * SLAB_ALIGN


def slab_fits(n_jobs: int, clean_bytes: int) -> bool:
    """Whether a slab of ``n_jobs`` streams of ``clean_bytes`` keeps every
    stream, its slack included, within ``SLAB_SPAN_LIMIT`` bytes of the
    first one's start."""
    return n_jobs * slab_stride(clean_bytes) <= SLAB_SPAN_LIMIT


class _WalkSet:
    """One chunk's buffers: ``arrays`` (the slab's allocation and the four
    record arrays, a row a stream) and ``streams``, each stream's (clean
    uint8, bit_off int64, dc int32 (n, 3), mcu_idx int32, sym_count int32)
    views of them."""
    __slots__ = ("arrays", "streams")

    def __init__(self, key: tuple, n_jobs: int):
        cb, nr = key
        stride = slab_stride(cb)
        raw = _alloc_host(n_jobs * stride + SLAB_ALIGN, False)
        slab = raw[-raw.ctypes.data % SLAB_ALIGN:]
        records = (
            _alloc_host(n_jobs * nr * 8, False).view(np.int64)
            .reshape(n_jobs, nr),
            _alloc_host(n_jobs * nr * 12, False).view(np.int32)
            .reshape(n_jobs, nr, 3),
            _alloc_host(n_jobs * nr * 4, False).view(np.int32)
            .reshape(n_jobs, nr),
            _alloc_host(n_jobs * nr * 4, False).view(np.int32)
            .reshape(n_jobs, nr))
        self.arrays = (raw, *records)
        self.streams = [(slab[i * stride:i * stride + cb],
                         *(a[i] for a in records)) for i in range(n_jobs)]


class IdxBufPool:
    """Free-list of the index walk's buffer sets, one set a chunk of
    streams, keyed by bucketed (clean bytes, records). A set's clean-stream
    buffers are views into one slab, at a fixed stride
    (:func:`slab_stride`: 64-byte aligned, each stream's slack inside its
    stride), so that the AVX-512 walkers can address them all by 32-bit
    offsets from the first; its record arrays are one allocation a kind.
    Views of a set must not outlive its :meth:`release`."""

    def __init__(self, max_sets: int = 8):
        self._lock = threading.Lock()
        self._free: Dict[tuple, list] = {}
        self._max_sets = max_sets

    def acquire(self, n_jobs: int, clean_bytes: int, n_rec: int):
        """(token, [buffers] * n_jobs) with room for ``clean_bytes`` and
        ``n_rec`` records a stream: the narrowest free set of the key that
        has ``n_jobs`` streams, else a new set of ``n_jobs`` streams, which
        replaces a narrower free one (dropped)."""
        key = _walk_key(clean_bytes, n_rec)
        with self._lock:
            sets = self._free.get(key, [])
            wide = [s for s in sets if len(s.streams) >= n_jobs]
            got = min(wide or sets, key=lambda s: len(s.streams),
                      default=None)
            if got is not None:
                sets.remove(got)
        if got is None or not wide:
            got = _WalkSet(key, n_jobs)
        return (key, got), got.streams[:n_jobs]

    def release(self, token) -> None:
        key, got = token
        with self._lock:
            sets = self._free.setdefault(key, [])
            if len(sets) < self._max_sets:
                sets.append(got)

    def free_sets(self) -> int:
        with self._lock:
            return sum(map(len, self._free.values()))

    def idle_arrays(self) -> list:
        """Every allocation of the free sets (slabs and record arrays)."""
        with self._lock:
            return [a for sets in self._free.values() for s in sets
                    for a in s.arrays]


_walk_pool = None
_walk_pool_lock = threading.Lock()


def walk_buffer_pool() -> IdxBufPool:
    """The process's pool of index-walk buffer sets."""
    global _walk_pool
    with _walk_pool_lock:
        if _walk_pool is None:
            _walk_pool = IdxBufPool()
        return _walk_pool


# --- one group's staging -----------------------------------------------------

class Stager:
    """One group's arrays in one staging buffer, uploaded by one copy.

    :meth:`reserve` lays an array out (int16, int32 or uint32; each at a
    256-byte offset, in call order), :meth:`open` takes a buffer for what
    is reserved plus ``spare`` bytes (a later reservation must fit in
    them), :meth:`view` is the array's numpy view in the buffer,
    :meth:`put` copies an array into its slot and :meth:`upload` copies
    every reserved byte to ``device`` and returns the arrays as tensor
    views. With ``device=None`` the buffer is the stager's own (not
    pooled) and is never uploaded: the packers' host-only results.
    Use as a context manager: leaving it returns a buffer no copy read."""

    def __init__(self, device=None, pool: Optional[StagingPool] = None):
        self.device = None if device is None else torch.device(device)
        self._pool = (None if self.device is None
                      else pool or staging_pool())
        self._slots: Dict[str, tuple] = {}
        self._end = 0
        self._cap = 0
        self._buf: Optional[_HostBuffer] = None
        self._host: Optional[np.ndarray] = None

    def __enter__(self) -> "Stager":
        return self

    def __exit__(self, *exc) -> None:
        self._give_back(None)

    def reserve(self, name: str, shape, dtype) -> Optional[np.ndarray]:
        """Lay out ``name``; returns its view when the buffer is open."""
        dtype = np.dtype(dtype)
        if dtype not in _TORCH_DTYPES:
            raise RocJpegError(Status.INVALID_PARAMETER,
                               f"cannot stage {name} as {dtype}")
        shape = tuple(int(s) for s in np.atleast_1d(shape))
        if name in self._slots or min(shape, default=0) < 0:
            raise RocJpegError(Status.INVALID_PARAMETER,
                               f"bad staging slot {name} {shape}")
        off = -(-self._end // ALIGN) * ALIGN
        end = off + int(np.prod(shape, dtype=np.int64)) * dtype.itemsize
        if self._host is not None and end > self._cap:
            raise RocJpegError(Status.INTERNAL_ERROR,
                               f"staging slot {name} overruns its buffer")
        self._slots[name] = (off, shape, dtype)
        self._end = end
        return self.view(name) if self._host is not None else None

    def open(self, spare: int = 0) -> None:
        """Take the buffer: room for every reserved array plus ``spare``
        bytes at the next 256-byte offset."""
        cap = -(-self._end // ALIGN) * ALIGN + int(spare)
        if self._pool is None:
            self._host = _alloc_host(cap, False)
        else:
            self._buf = self._pool.acquire(
                cap, pinned=self.device.type == "cuda")
            self._host = self._buf.host
        self._cap = cap

    def view(self, name: str) -> np.ndarray:
        off, shape, dtype = self._slots[name]
        n = int(np.prod(shape, dtype=np.int64)) * dtype.itemsize
        return self._host[off:off + n].view(dtype).reshape(shape)

    def put(self, name: str, a: np.ndarray) -> None:
        """Copy ``a`` into the slot reserved for it, which must have its
        dtype and shape."""
        off, shape, dtype = self._slots[name]
        if not isinstance(a, np.ndarray) or a.dtype != dtype \
                or a.shape != shape:
            raise RocJpegError(
                Status.INVALID_PARAMETER,
                f"{name}: expected {dtype} {shape}, got "
                f"{getattr(a, 'dtype', type(a).__name__)} "
                f"{getattr(a, 'shape', '')}")
        self.view(name)[...] = a

    def upload(self) -> Dict[str, torch.Tensor]:
        """Copy the buffer's reserved bytes to the device in one copy and
        return ``{name: tensor}``, views of the copied bytes (uint32 as
        int32). On a CUDA device the copy is ``non_blocking`` from
        page-locked memory on the device's current stream, and the buffer
        goes back to the pool with an event recorded after it."""
        if self._pool is None:
            raise RocJpegError(Status.INTERNAL_ERROR,
                               "a host-only stager has no device")
        host = torch.from_numpy(self._host[:self._end])
        event = None
        try:
            if self.device.type == "cuda":
                with torch.cuda.device(self.device):
                    if not host.is_pinned():
                        raise RocJpegError(
                            Status.INTERNAL_ERROR,
                            "staging buffer is not page-locked")
                    stream = torch.cuda.current_stream(self.device)
                    dev = torch.empty(self._end, dtype=torch.uint8,
                                      device=self.device)
                    dev.copy_(host, non_blocking=True)
                    event = torch.cuda.Event()
                    event.record(stream)
            else:
                dev = host.clone()
        except RuntimeError as exc:
            self._pool.abandon(self._buf)
            self._buf = None
            raise RocJpegError(Status.EXECUTION_FAILED,
                               f"staging upload failed: {exc}") from exc
        self._give_back(event)
        out = {}
        for name, (off, shape, dtype) in self._slots.items():
            n = int(np.prod(shape, dtype=np.int64)) * dtype.itemsize
            out[name] = dev[off:off + n].view(_TORCH_DTYPES[dtype]).view(
                shape)
        return out

    def _give_back(self, event) -> None:
        if self._buf is not None:
            buf, self._buf = self._buf, None
            self._host = None
            self._pool.release(buf, event)
