"""Sharded batched decode over a device mesh.

Counterpart of ``rocjpeg_tpu/dist/sharding.py``. The JAX package decodes a
whole batch as one XLA program sharded over its mesh; here each ``data``
row of the mesh holds one ``api.Decoder`` on the row's first device, and a
call splits each same-shape group into contiguous shards in batch order
(the order of the JAX package's ``P("data")``), one shard a row. Each row
decodes its shards on a thread of its own, through the same K1, K2 and K3
as ``api.Decoder``, and its channels stay on its first device. A chunk on
the host-entropy path spreads K2 over every device of its row, as the JAX
package's ``P("data", "space")`` spreads block rows: each component whose
block-row count the ``space`` axis divides is cut into ``space`` bands,
one a device, and the bands are gathered on the row's first device for K3
(``pipeline.decode_group``). The wave path (K1, K2, K3) runs on the row's
first device: the JAX package's ``shard_map`` maps only ``data``, so its
``space`` devices would repeat the same shard. No batch is padded: eager
launches take any batch size. The rows share the process's packer pool
and staging pool (``ops.staging``); each device's staging copies and
their events run on its caller stream.
"""

from __future__ import annotations

import concurrent.futures
import contextlib
import threading
from typing import List, Optional, Sequence

import numpy as np
import torch

from .. import api
from ..status import RocJpegError, Status
from ..types import DecodedImage, DecodeParams, GpuDecodeSpec
from . import mesh as mesh_lib


class MeshDecoder:
    """Batch decoder sharding each call over the rows of a mesh.

    API-compatible with :class:`rocjpeg_tpu_torch.api.Decoder` for
    ``get_image_info``, ``decode``, ``decode_batched``, ``synchronize``
    and the records of the last call (``last_paths``,
    ``last_error_flags``, ``last_failed_indices``), and with the JAX
    package's ``MeshDecoder`` for ``decode_batched_local``.

    mesh: a :class:`~rocjpeg_tpu_torch.dist.mesh.Mesh`; by default
    ``make_mesh(space=space)`` over every CUDA device.
    device_entropy: each row's ``Decoder`` mode; 'auto' decides per shard
    chunk, as a ``Decoder`` does.
    check_errors: when True, a call reads the device error flags of every
    shard and raises one BAD_JPEG naming the failed images by their index
    in the call's batch. (The JAX package's ``MeshDecoder`` never reads
    them.)

    A call returns without waiting for the devices; ``synchronize`` waits
    for every row. Each worker runs under the first device of its row, and
    on every device of its row under the stream that was the caller's
    current one there when the call began, so the channels, and the bands
    of the host path, are ordered before the caller's later work on those
    streams. ``close`` stops the row threads."""

    def __init__(self, mesh: Optional[mesh_lib.Mesh] = None, space: int = 1,
                 device_entropy: str = "auto", *, check_errors: bool = True):
        self.mesh = mesh or mesh_lib.make_mesh(space=space)
        self._rows = [row[0] for row in self.mesh.devices]
        self._decoders = [api.Decoder(device=dev,
                                      device_entropy=device_entropy,
                                      check_errors=False)
                          for dev in self._rows]
        for dec, row in zip(self._decoders, self.mesh.devices):
            dec._band_devices = row
        self._check_errors = check_errors
        self._tls = threading.local()  # per-thread records of the last call
        self._pool = None
        self._pool_lock = threading.Lock()

    @property
    def spec(self) -> GpuDecodeSpec:
        """The first row's decode spec (the limits every stream is checked
        against)."""
        return self._decoders[0].spec

    def _shards(self) -> list:
        """The calling thread's last call, one (row, caller indices,
        paths, error lanes) record a shard, in shard order."""
        return getattr(self._tls, "shards", [])

    @property
    def last_paths(self) -> list:
        """Per-chunk (path, batch indices) of the calling thread's last
        call, shard by shard; the indices are the call's."""
        return [(path, [idxs[i] for i in local])
                for _, idxs, paths, _ in self._shards()
                for path, local in paths]

    @property
    def last_error_flags(self) -> list:
        """Per-lane device error flags of the calling thread's last call,
        one tensor per device-entropy chunk of each shard, each on its
        shard's device."""
        return [err for _, _, _, lanes in self._shards()
                for err, _, _ in lanes]

    def last_failed_indices(self) -> list:
        """Batch indices (the call's) of images whose scans a shard's wave
        flagged as corrupt in the calling thread's last call (reads the
        device flags)."""
        return sorted(idxs[i] for _, idxs, _, lanes in self._shards()
                      for i in api.failed_indices(lanes))

    def get_image_info(self, stream):
        """rocJpegGetImageInfo analog."""
        return self._decoders[0].get_image_info(stream)

    def decode(self, stream, params: Optional[DecodeParams] = None
               ) -> DecodedImage:
        """rocJpegDecode analog."""
        return self.decode_batched([stream], params)[0]

    def synchronize(self) -> None:
        """Wait for every row's outstanding work."""
        for dec in self._decoders:
            dec.synchronize()

    def close(self) -> None:
        """Stop the row threads (idempotent; a later call starts them
        again)."""
        with self._pool_lock:
            pool, self._pool = self._pool, None
        if pool is not None:
            pool.shutdown()

    def decode_batched(self, streams: Sequence,
                       params: Optional[DecodeParams] = None
                       ) -> List[DecodedImage]:
        """rocJpegDecodeBatched over the mesh: every stream is checked
        before anything is dispatched, each same-shape group is split into
        contiguous shards of ceil(n / rows) images, and each row decodes
        its shards on its own device."""
        plist = self._decoders[0]._checked_params(streams)
        images = self._dispatch(streams, plist, params)
        if self._check_errors and any(bool(e.any())
                                      for e in self.last_error_flags):
            raise RocJpegError(
                Status.BAD_JPEG,
                "on-device entropy decode failed (corrupt scan) in batch "
                f"image(s) {self.last_failed_indices()}")
        return images

    def decode_batched_local(self, streams: Sequence,
                             params: Optional[DecodeParams] = None,
                             global_arrays: bool = False):
        """This process's images of one shape group, decoded over this
        process's mesh; no image crosses processes (the JAX package's
        process-local layout).

        Returns (per_image, pitches, err): each image's channels as host
        numpy arrays, the group's per-channel pitches, and a bool array
        with one error flag an image (the JAX package returns lane flags;
        lanes differ between the packages, images do not). Raises no
        BAD_JPEG: the flags report it. Two shape groups raise
        INVALID_PARAMETER. ``global_arrays=True`` returns the same: the JAX
        package decodes over the global mesh then, but hands each process
        only its own images, gathered from its addressable shards, so no
        image needs to cross processes here either."""
        plist = self._decoders[0]._checked_params(streams)
        if len({api.shape_key(p) for p in plist}) != 1:
            raise RocJpegError(Status.INVALID_PARAMETER,
                               "decode_batched_local takes one shape group")
        images = self._dispatch(streams, plist, params)
        failed = set(self.last_failed_indices())
        per_image = [[np.ascontiguousarray(ch.cpu().numpy())
                      for ch in img.channel if ch is not None]
                     for img in images]
        pitches = [pitch for ch, pitch in zip(images[0].channel,
                                              images[0].pitch)
                   if ch is not None]
        err = np.array([i in failed for i in range(len(images))], bool)
        return per_image, pitches, err

    def _dispatch(self, streams, plist, params) -> List[DecodedImage]:
        """Decode checked streams shard by shard; records the call. Waits
        for every shard before raising the first shard's error, in shard
        order."""
        self._tls.shards = []
        groups = {}
        for idx, p in enumerate(plist):
            groups.setdefault(api.shape_key(p), []).append(idx)
        n_rows = len(self._rows)
        shards = [[] for _ in range(n_rows)]
        for idxs in groups.values():
            per = -(-len(idxs) // n_rows)
            for r in range(n_rows):
                shards[r] += idxs[r * per:(r + 1) * per]
        jobs = [(r, idxs) for r, idxs in enumerate(shards) if idxs]
        callers = {dev: torch.cuda.current_stream(dev)
                   for row in self.mesh.devices for dev in row
                   if dev.type == "cuda"}

        def run(job):
            r, idxs = job
            return self._decode_shard(r, [streams[i] for i in idxs], params,
                                      callers)

        if len(jobs) <= 1:  # one shard runs inline
            outs = [run(job) for job in jobs]
        else:
            futs = [self._executor().submit(run, job) for job in jobs]
            concurrent.futures.wait(futs)
            outs = [f.result() for f in futs]
        results: List[Optional[DecodedImage]] = [None] * len(streams)
        for (row, idxs), (images, paths, lanes) in zip(jobs, outs):
            for i, img in zip(idxs, images):
                results[i] = img
            self._tls.shards.append((row, idxs, paths, lanes))
        return results

    def _decode_shard(self, row: int, streams, params, callers):
        """One row's shard under the row's first device, with ``callers``'
        stream (the caller's, by device) current on every device of the
        row; returns its images and its decoder's records."""
        dec = self._decoders[row]
        with contextlib.ExitStack() as stack:
            for dev in dict.fromkeys(self.mesh.devices[row]):
                if dev in callers:
                    stack.enter_context(torch.cuda.stream(callers[dev]))
            if self._rows[row].type == "cuda":
                stack.enter_context(torch.cuda.device(self._rows[row]))
            images = dec.decode_batched(streams, params)
        return images, dec.last_paths, dec._last_error_lanes()

    def _executor(self) -> concurrent.futures.ThreadPoolExecutor:
        with self._pool_lock:
            if self._pool is None:
                self._pool = concurrent.futures.ThreadPoolExecutor(
                    len(self._rows), thread_name_prefix="rjt-mesh-row")
            return self._pool
