"""Single-image decode CLI — the ``jpegDecode`` sample workload
(samples/jpegDecode/jpegdecode.cpp): loop over a file or directory, parse →
get_image_info → validate/skip → decode (timed) → optional save; print
images/s and Mpixels/s plus skip counters.

Usage: python -m rocjpeg_tpu_torch.tools.jpegdecode -i <file-or-dir>
       [-fmt rgb] [-o prefix] [-d <cuda id>|cpu]
"""

from __future__ import annotations

import sys
import time

from .. import api
from ..status import RocJpegError, Status
from . import common


def main(argv=None) -> int:
    args = common.build_arg_parser(
        "Decode JPEG images on a CUDA device").parse_args(argv)
    params = common.parse_decode_params(args)
    paths = common.get_file_paths(args.input)
    if not paths:
        print(f"error: no JPEG files found under {args.input}")
        return 1

    decoder = common.make_decoder(args)
    if decoder is None:
        return 1
    stats = common.Stats()
    print(f"info: decoding {len(paths)} image(s), format={args.format}, "
          "host entropy backend=native")

    for path in paths:
        try:
            with open(path, "rb") as f:
                stream = api.JpegStream(f.read())
        except (OSError, RocJpegError):
            stats.skip_bad += 1
            continue
        info = decoder.get_image_info(stream)
        skip = common.skip_reason(decoder, info)
        if skip:
            setattr(stats, skip, getattr(stats, skip) + 1)
            continue
        try:
            t0 = time.perf_counter()
            image = decoder.decode(stream, params)
            # The channels are the device's until it finishes: the timed
            # region ends when the decode has, not when it was queued.
            decoder.synchronize()
            t1 = time.perf_counter()
        except RocJpegError as e:
            if e.status == Status.JPEG_NOT_SUPPORTED:
                stats.skip_unknown += 1
                continue
            raise
        stats.decoded += 1
        stats.total_ms += (t1 - t0) * 1000.0
        stats.mpixels += info.widths[0] * info.heights[0] / 1e6
        if args.output:
            name = common.save_image(args.output, path, image, info.widths[0],
                                     info.heights[0], params.output_format,
                                     info.subsampling)
            print(f"info: saved {name}")

    stats.report()
    return 0 if stats.decoded else 1


if __name__ == "__main__":
    sys.exit(main())
