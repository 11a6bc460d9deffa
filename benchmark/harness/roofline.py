"""Bytes each stage of a decode must move, from the streams' shapes.

The counts read each input byte once and write each output byte once,
whatever a given implementation reads again; they are computed from the
JPEG's shapes and scan lengths, never read from the program, so they
stay the same whatever implements a stage:

- entropy decode (K1): the scan's bytes in, 128 bytes (64 int16
  coefficients) a block out;
- transform (K2): 128 bytes a block in, 64 samples a block out;
- epilogue (K3): the planes the format reads in, its output out. RGB
  reads Y, U and V and writes 3 bytes a pixel; NV12 takes Y as it is
  and reads U and V and writes UV;
- the whole decode: the scan's bytes in, the format's output out.

A block is 8x8 samples of one component, as the MCU grid pads it.
"""

from __future__ import annotations

from . import content

# Published peak memory bandwidth of one NVIDIA H100 SXM (80 GB HBM3), at
# its full power limit of 700 W.
PEAK_BYTES_PER_S = {"NVIDIA H100": 3.35e12}


def peak_bytes_per_s(device_name: str):
    for prefix, peak in PEAK_BYTES_PER_S.items():
        if device_name.startswith(prefix):
            return peak
    return None


def blocks(width: int, height: int, subsampling: str = "420") -> int:
    return sum(bh * bw for bh, bw in content.geometry(
        width, height, subsampling)["blocks"])


def chroma(width: int, height: int) -> int:
    """Samples of U and V together, at the output's floor-halved size."""
    return 2 * (width // 2) * (height // 2)


def output_bytes(width: int, height: int, fmt: str) -> int:
    if fmt == "native":
        return width * height + chroma(width, height)
    if fmt == "rgb":
        return 3 * width * height
    raise ValueError(f"unknown output format {fmt!r}")


def epilogue_bytes(width: int, height: int, fmt: str) -> int:
    if fmt == "native":
        return 2 * chroma(width, height)
    if fmt == "rgb":
        return width * height + chroma(width, height) + 3 * width * height
    raise ValueError(f"unknown output format {fmt!r}")


def per_call(batches: list, fmt: str, subsampling: str = "420") -> dict:
    """Bytes a call must move, by stage, averaged over the rotation."""
    tot = dict.fromkeys(("wave", "transform", "epilogue", "decode"), 0.0)
    for b in batches:
        for im, scan in zip(b.images, b.scan_bytes):
            nb = blocks(im.width, im.height, subsampling)
            tot["wave"] += scan + 128 * nb
            tot["transform"] += (128 + 64) * nb
            tot["epilogue"] += epilogue_bytes(im.width, im.height, fmt)
            tot["decode"] += scan + output_bytes(im.width, im.height, fmt)
    return {k: v / len(batches) for k, v in tot.items()}


def share(bytes_moved: float, seconds: float, peak):
    """Percent of the peak bandwidth that moving ``bytes_moved`` in
    ``seconds`` is; None where there is no time or no peak."""
    if not seconds or not peak:
        return None
    return 100.0 * bytes_moved / seconds / peak
