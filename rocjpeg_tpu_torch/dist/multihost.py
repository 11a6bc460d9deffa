"""Multi-process helpers.

Counterpart of ``rocjpeg_tpu/dist/multihost.py`` over ``torch.distributed``.
Each process runs its own input pipeline over its share of the corpus
(the reference's per-thread file split, jpegdecodeperf.cpp:245-252, lifted
to processes), decodes it on its own devices with a
:class:`~rocjpeg_tpu_torch.dist.sharding.MeshDecoder`, and only the
throughput metrics cross processes, in one reduction at the end. Nothing
here starts a process group until :func:`initialize` is called.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import torch
import torch.distributed as dist


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None, *,
               backend: Optional[str] = None) -> None:
    """Join the process group of ``num_processes`` processes as rank
    ``process_id``, rendezvous at ``coordinator_address`` (``host:port``,
    or ``MASTER_ADDR``/``MASTER_PORT`` of the environment when None); a
    no-op for one process. The backend is NCCL where CUDA is available and
    gloo otherwise, unless ``backend`` names one (gloo lets processes that
    share one card reduce their metrics)."""
    if num_processes is None or num_processes <= 1:
        return
    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    init_method = None
    if coordinator_address is not None:
        init_method = (coordinator_address if "://" in coordinator_address
                       else "tcp://" + coordinator_address)
    dist.init_process_group(backend, init_method=init_method,
                            world_size=num_processes, rank=process_id)


def _rank_world():
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def shard_files_for_host(paths: Sequence[str]) -> List[str]:
    """This process's share of ``paths``: every world-size-th file from
    its rank on (strided, as the reference splits files across
    threads)."""
    rank, world = _rank_world()
    return list(paths)[rank::world]


def reduce_device() -> torch.device:
    """Where this process's reductions run: its card under NCCL, the host
    under gloo (gloo reduces CUDA tensors through the host anyway)."""
    if dist.get_backend() == "nccl":
        return torch.device("cuda", dist.get_rank()
                            % torch.cuda.device_count())
    return torch.device("cpu")


def allreduce_metrics(images: float, mpixels: float, seconds: float):
    """(images, Mpix, seconds) over every process: images and Mpix
    summed, seconds the longest process's (wall clock). One process gets
    its own values back."""
    _rank, world = _rank_world()
    if world == 1:
        return float(images), float(mpixels), float(seconds)
    device = reduce_device()
    sums = torch.tensor([images, mpixels], dtype=torch.float64, device=device)
    longest = torch.tensor([seconds], dtype=torch.float64, device=device)
    dist.all_reduce(sums, op=dist.ReduceOp.SUM)
    dist.all_reduce(longest, op=dist.ReduceOp.MAX)
    return float(sums[0]), float(sums[1]), float(longest[0])
