"""The port's multi-process helpers, after ``tests/test_multihost.py``.

Two spawned processes join one gloo group on a free local port through
``dist.multihost.initialize``; each takes its strided share of 8 restart
blobs (``shard_files_for_host``), decodes it with
``MeshDecoder(make_mesh(devices=["cpu"] * 4, space=s)).decode_batched_local``
with ``global_arrays`` False and True, and checks that the two results are
byte-equal and every image byte-equal to the port's numpy oracle
(``core/golden.py``); ``allreduce_metrics`` must give the summed images and
Mpix and the longest process's seconds. One pair of processes decodes at
space 1 under 'auto', one at space 2 under 'off' (K2 in bands over each
row's two devices); a row's one image has too few lanes for the wave, so
both take the host path. The single-process cases need no group. The
workers import nothing of jax.
"""

import os
import socket
import subprocess
import sys

import pytest

from rocjpeg_tpu_torch.dist import multihost

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

WORKER = r"""
import sys
sys.path.insert(0, sys.argv[4])
pid, nproc, coord = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
space, entropy = int(sys.argv[5]), sys.argv[6]
import numpy as np
import torch
import torch.distributed as dist
from rocjpeg_tpu_torch import api
from rocjpeg_tpu_torch.core import golden
from rocjpeg_tpu_torch.dist import mesh, multihost, sharding
from rocjpeg_tpu_torch.testing import encoder
from rocjpeg_tpu_torch.types import DecodeParams, OutputFormat

torch.set_num_threads(1)
multihost.initialize(coord, nproc, pid)
assert dist.get_backend() == "gloo" and dist.get_world_size() == nproc

blobs = [encoder.encode_planes(
    encoder.random_planes("420", 128, 96, seed=s), "420",
    restart_interval=4) for s in range(8)]
local = multihost.shard_files_for_host(list(range(len(blobs))))
assert local == list(range(pid, len(blobs), nproc)), local
local_blobs = [blobs[i] for i in local]

md = sharding.MeshDecoder(mesh.make_mesh(devices=["cpu"] * 4, space=space),
                          device_entropy=entropy)
streams = [api.JpegStream(b) for b in local_blobs]
(per_image, pitches, err), (global_images, global_pitches, global_err) = [
    md.decode_batched_local(streams, DecodeParams(OutputFormat.RGB),
                            global_arrays=g) for g in (False, True)]
assert {p for p, _ in md.last_paths} == {"host"}, md.last_paths
md.close()
assert not err.any() and not global_err.any()
assert global_pitches == pitches
for b, chans, global_chans in zip(local_blobs, per_image, global_images):
    (ref, pitch), = golden.decode(b, OutputFormat.RGB)
    np.testing.assert_array_equal(chans[0], ref)
    assert global_chans[0].shape == ref.shape
    assert global_chans[0].tobytes() == chans[0].tobytes()
    assert pitches == [pitch]

images, mpix, secs = multihost.allreduce_metrics(len(local_blobs), 0.5,
                                                 1.0 + pid)
assert (images, mpix, secs) == (len(blobs), 0.5 * nproc, float(nproc)), (
    images, mpix, secs)
dist.destroy_process_group()
print(f"proc {pid}: {len(local_blobs)} images bit-exact; metrics reduced",
      flush=True)
"""


def _two_processes(tmp_path, space, entropy):
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    script = tmp_path / "worker.py"
    script.write_text(WORKER)
    procs = [subprocess.Popen(
        [sys.executable, str(script), str(pid), "2", f"127.0.0.1:{port}",
         ROOT, str(space), entropy], stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, cwd=ROOT)
        for pid in range(2)]
    outs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=240)
            outs.append(out.decode(errors="replace"))
    except subprocess.TimeoutExpired:
        pytest.fail("a decode process hung")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for pid, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"proc {pid} failed:\n{out[-3000:]}"
        assert "bit-exact; metrics reduced" in out


def test_two_process_decode_and_metrics(tmp_path):
    _two_processes(tmp_path, 1, "auto")


def test_two_process_decode_in_space_bands(tmp_path):
    _two_processes(tmp_path, 2, "off")


def test_single_process_initialize_is_a_no_op():
    import torch.distributed as dist
    for n in (None, 1):
        multihost.initialize("127.0.0.1:1", n, 0)
        assert not dist.is_initialized()


def test_single_process_files_are_not_split():
    paths = [f"f{i}.jpg" for i in range(10)]
    assert multihost.shard_files_for_host(paths) == paths


def test_single_process_metrics_are_returned_unchanged():
    assert multihost.allreduce_metrics(3, 24.5, 0.75) == (3.0, 24.5, 0.75)
