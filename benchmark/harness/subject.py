"""What the window drives: the system under test, or the control in its
place.

:class:`Port` is ``rocjpeg_tpu_torch``'s session API as a user calls it:
``JpegStream`` objects built from the bytes (the parse), one
``Decoder.decode_batched`` call on them, and a wait for the call's work
to complete on the device. :class:`Control` puts the plain reference,
with the lower-precision IDCT, in its place; it is never timed.
"""

from __future__ import annotations

import dataclasses

FORMATS = ("native", "rgb")


@dataclasses.dataclass
class Decoded:
    """One image's output channels (2-D arrays or tensors), as the
    session API's ``DecodedImage.channel`` holds them."""
    channel: list


class Port:
    """rocjpeg_tpu_torch on ``device`` (``cuda:0``; ``cpu`` runs each
    kernel's plain version, for tests)."""

    def __init__(self, device: str, fmt: str):
        import torch
        from rocjpeg_tpu_torch import api
        from rocjpeg_tpu_torch.types import DecodeParams, OutputFormat
        if fmt not in FORMATS:
            raise ValueError(f"unknown output format {fmt!r}")
        self._torch = torch
        self._api = api
        self.cuda = torch.device(device).type == "cuda"
        # Error flags are kept per call and read after the window, so the
        # decoder does not read them itself (one sync a call).
        self.decoder = api.Decoder(device=device, check_errors=False)
        self.params = DecodeParams(output_format={
            "native": OutputFormat.NATIVE, "rgb": OutputFormat.RGB}[fmt])

    def parse(self, batch) -> list:
        return [self._api.JpegStream(d) for d in batch.datas]

    def decode(self, batch, streams) -> tuple:
        """(images, the call's per-chunk device error flags)."""
        images = self.decoder.decode_batched(streams, self.params)
        return images, list(self.decoder.last_error_flags)

    def wait(self) -> None:
        """Block, without spinning a core, until the work queued so far on
        the device's stream is complete."""
        if self.cuda:
            ev = self._torch.cuda.Event(blocking=True)
            ev.record()
            ev.synchronize()

    def flagged(self, flags: list) -> bool:
        return any(bool(f.any()) for f in flags)

    @staticmethod
    def to_host(images: list) -> list:
        """Each image's channels as 2-D numpy arrays."""
        return [[c.cpu().numpy() for c in im.channel if c is not None]
                for im in images]


class Control:
    """The reference in the program's place, with ``idct`` (``ifast``:
    libjpeg's lower-precision integer IDCT)."""

    cuda = False

    def __init__(self, reference, config: dict, seed: int, fmt: str,
                 idct: str = "ifast"):
        self.ref, self.config, self.seed = reference, config, seed
        self.fmt, self.idct = fmt, idct

    def parse(self, batch) -> list:
        return batch.images

    def decode(self, batch, images) -> tuple:
        return [Decoded(self.ref.decode(
            self.config, self.seed, im.batch, im.slot, im.width, im.height,
            self.fmt, self.idct)) for im in images], []

    def wait(self) -> None:
        pass

    def flagged(self, flags: list) -> bool:
        return False

    @staticmethod
    def to_host(images: list) -> list:
        return [list(im.channel) for im in images]
