"""Throughput harness — the ``jpegDecodePerf`` sample workload
(samples/jpegDecodePerf/jpegdecodeperf.cpp): ``-t`` pipeline threads x ``-b``
batch size over a corpus, files partitioned across threads (:245-252),
aggregated images/s and Mpixels/s (:260-300).

One decoder handle per thread, as in the reference: the threads overlap
one another's host parse and entropy pack with the device's work, since
the native host library and the kernel launches release the interpreter
lock. Images are skipped by the rule of the other two tools. With
``--mesh`` each thread's handle is a ``dist.sharding.MeshDecoder`` over
every CUDA device (over the host with ``-d cpu``), which shards each
batch across them.

Usage: python -m rocjpeg_tpu_torch.tools.jpegdecodeperf -i <dir> -t 2 -b 32
       [-d <cuda id>|cpu] [--mesh]
"""

from __future__ import annotations

import concurrent.futures
import sys
import threading
import time

from .. import api
from ..dist import mesh, sharding
from ..status import RocJpegError
from ..utils import log
from . import common


def _decode_worker(decoder, paths, params, batch_size, stats, lock):
    local_decoded = 0
    local_mpix = 0.0
    for start in range(0, len(paths), batch_size):
        chunk = paths[start:start + batch_size]
        streams, mpix = [], 0.0
        for path in chunk:
            try:
                with open(path, "rb") as f:
                    stream = api.JpegStream(f.read())
            except (OSError, RocJpegError):
                with lock:
                    stats.skip_bad += 1
                continue
            info = decoder.get_image_info(stream)
            skip = common.skip_reason(decoder, info)
            if skip:
                with lock:
                    setattr(stats, skip, getattr(stats, skip) + 1)
                continue
            streams.append(stream)
            mpix += info.widths[0] * info.heights[0] / 1e6
        if not streams:
            continue
        images = decoder.decode_batched(streams, params)
        decoder.synchronize()
        local_decoded += len(images)
        local_mpix += mpix
    with lock:
        stats.decoded += local_decoded
        stats.mpixels += local_mpix


def _run(decoders, shards, params, batch_size, stats, lock):
    """Each decoder takes its shard on a thread of its own; returns when
    every thread has finished (and synchronized its decoder)."""
    with concurrent.futures.ThreadPoolExecutor(len(decoders)) as pool:
        futs = [pool.submit(_decode_worker, dec, shard, params, batch_size,
                            stats, lock)
                for dec, shard in zip(decoders, shards) if shard]
        for f in futs:
            f.result()


def _make_decoder(args):
    """A thread's handle: the session the flags ask for, or with --mesh a
    MeshDecoder over every CUDA device (the host with -d cpu); None after
    printing why it could not be opened."""
    if not args.mesh:
        return common.make_decoder(args)
    try:
        return sharding.MeshDecoder(mesh.make_mesh(
            devices=["cpu"] if args.device == "cpu" else None))
    except RocJpegError as e:
        log.err(f"cannot open a decoder: {e}")
        return None


def main(argv=None) -> int:
    ap = common.build_arg_parser("JPEG decode throughput harness",
                                 threaded=True)
    ap.add_argument("--mesh", action="store_true",
                    help="shard batches across every CUDA device (the host "
                         "with -d cpu)")
    ap.add_argument("--warmup", type=int, default=1,
                    help="warmup passes before timing")
    args = ap.parse_args(argv)
    params = common.parse_decode_params(args)
    paths = common.get_file_paths(args.input)
    if not paths:
        print(f"error: no JPEG files found under {args.input}")
        return 1
    nthreads = max(1, min(args.threads, 32))  # cap like samples_utils.h:153

    # One decoder handle per thread — the reference's model
    # (jpegdecodeperf.cpp:228-241): a handle's in-flight throttle is
    # per-handle state, so sharing one across threads serializes the
    # pipeline at its depth-2 queue.
    decoders = []
    for _ in range(nthreads):
        dec = _make_decoder(args)
        if dec is None:
            return 1
        decoders.append(dec)
    try:
        return _measure(args, params, paths, nthreads, decoders)
    finally:
        for dec in decoders:
            if args.mesh:
                dec.close()


def _measure(args, params, paths, nthreads, decoders) -> int:
    stats = common.Stats()
    lock = threading.Lock()

    # Partition files across threads (jpegdecodeperf.cpp:245-252).
    shards = [paths[i::nthreads] for i in range(nthreads)]

    # Warm up every shard before the timed region: each may hold shapes
    # the others do not, and the first call of a process builds the
    # native libraries.
    for _ in range(args.warmup):
        _run(decoders, [s[:args.batch_size] for s in shards], params,
             args.batch_size, common.Stats(), lock)

    t0 = time.perf_counter()
    _run(decoders, shards, params, args.batch_size, stats, lock)
    t1 = time.perf_counter()

    elapsed = t1 - t0
    stats.total_ms = elapsed * 1000.0
    print(f"info: threads={nthreads} batch={args.batch_size} "
          f"files={len(paths)} elapsed={elapsed:.3f}s")
    if stats.decoded:
        print(f"info: total decoded images: {stats.decoded}")
        print(f"info: avg images per sec: {stats.decoded / elapsed:.4f}")
        print(f"info: avg decoded data size (Mpixels/sec): "
              f"{stats.mpixels / elapsed:.4f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
