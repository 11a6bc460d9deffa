"""The package's profiler spans: one helper, one namespace.

Every ``torch.profiler`` range the package opens goes through
:func:`span`, under a name of :data:`SPANS`. With no profiler active a
span is one flag check and a shared no-op context; under a profiler it is
a ``torch.profiler.record_function`` range, recorded on the profiler's
clock beside the device trace. A span stays on the thread that makes the
call, so the nesting on that thread gives each span its parent; jobs on
the pack pool (``ops.staging.pack_pool``) open none, their time is inside
the caller's ``rjt.walk`` and ``rjt.pack``. Record the spans of caller
threads with ``torch.profiler.profile`` and
``experimental_config=torch._C._profiler._ExperimentalConfig(
profile_all_threads=True)``.

The spans, each with where it is opened and its parent:

- ``rjt.parse``: ``api.JpegStream.parse``, one stream's header parse;
  the caller's span.
- ``rjt.decode``: ``api.Decoder._decode``, a whole ``decode_batched`` or
  tensor ``decode_into`` call; the caller's span.
- ``rjt.throttle``: ``api.Decoder._acquire_slot``, only while it blocks on
  the oldest chunk's token or on the slot condition; ``rjt.decode``.
- ``rjt.pack``: ``pipeline.pack_host`` and ``pipeline.pack_group_synced``,
  a group's host pack into its staging buffer, and on a card around a
  DRI=0 group's K0 launches; ``rjt.decode``.
- ``rjt.walk``: ``ops.pack.index_walk``, the DRI=0 index walk on the
  host, and on a card K0's launches (``pipeline.pack_group_synced``);
  ``rjt.pack``.
- ``rjt.stage_wait``: ``ops.staging.StagingPool.acquire``, only while it
  blocks on a buffer's copy or for a buffer to come back; ``rjt.pack`` or
  ``rjt.upload``.
- ``rjt.upload``: ``pipeline.upload_group`` and ``pipeline.stage_band``,
  the copy of a staging buffer to the device; ``rjt.decode``.
- ``rjt.wave``: ``pipeline.wave_group``, K1's launch; ``rjt.decode``.
- ``rjt.transform``: ``pipeline.transform_group`` and
  ``pipeline.transform_band``, K2's launch; ``rjt.decode``.
- ``rjt.epilogue``: ``pipeline._per_image``, K3's launch; ``rjt.decode``.
- ``rjt.host_entropy``: ``api.Decoder._decode_chunk``, the host-entropy
  path's coefficient decode; ``rjt.decode``.
- ``rjt.error_check``: ``api.Decoder._decode``, the read of the lane
  error flags under ``check_errors`` (a device wait); ``rjt.decode``.
"""

from __future__ import annotations

import contextlib

from torch.autograd import profiler as _profiler
from torch.profiler import record_function

SPANS = ("rjt.parse", "rjt.decode", "rjt.throttle", "rjt.pack", "rjt.walk",
         "rjt.stage_wait", "rjt.upload", "rjt.wave", "rjt.transform",
         "rjt.epilogue", "rjt.host_entropy", "rjt.error_check")

_OFF = contextlib.nullcontext()


def span(name: str):
    """A ``record_function`` range named ``name`` while a profiler is
    active, else a shared context that does nothing."""
    if not _profiler._is_profiler_enabled:
        return _OFF
    return record_function(name)
