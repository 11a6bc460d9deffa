"""Huffman table compilation: DHT (bits, values) → flat decode LUTs.

The reference forwards raw DHT tables to the VCN ASIC
(src/rocjpeg_parser.cpp:256-313 fills HuffmanTableBuffer, parser.h:104-114);
the silicon does the symbol decode. This framework decodes in software, so
the tables are compiled once per stream into a 16-bit-window lookup table:

    window = next 16 bits of the scan (MSB-first)
    symbol = sym_lut[window]; code_length = len_lut[window]

One lookup decodes any baseline Huffman code (max length 16). ``len_lut == 0``
marks an invalid prefix (corrupt stream). The pure-Python entropy decoder
(``core/entropy.py``) walks these tables.
"""

from __future__ import annotations

import numpy as np

from ..status import RocJpegError, Status


def build_decode_lut(bits: np.ndarray, values: np.ndarray) -> tuple:
    """Compile canonical Huffman (bits[16], values[n]) into (sym_lut, len_lut),
    each uint8[65536], indexed by the next 16 scan bits.

    Canonical code assignment per ITU-T T.81 Annex C: codes of length L are
    consecutive, starting from (prev_max + 1) << 1.
    """
    sym_lut = np.zeros(1 << 16, np.uint8)
    len_lut = np.zeros(1 << 16, np.uint8)
    code = 0
    k = 0
    for length in range(1, 17):
        n = int(bits[length - 1])
        for _ in range(n):
            if code >= (1 << length):
                raise RocJpegError(Status.BAD_JPEG, "overlong Huffman code")
            # All 16-bit windows whose first `length` bits equal `code`.
            lo = code << (16 - length)
            hi = lo + (1 << (16 - length))
            sym_lut[lo:hi] = values[k]
            len_lut[lo:hi] = length
            code += 1
            k += 1
        code <<= 1
    return sym_lut, len_lut


class CompiledHuffman:
    """Decode LUTs for one table id (DC + AC), built from a parsed
    HuffmanTableSet."""

    __slots__ = ("dc_sym", "dc_len", "ac_sym", "ac_len")

    def __init__(self, table_set) -> None:
        self.dc_sym, self.dc_len = build_decode_lut(
            table_set.num_dc_codes, table_set.dc_values)
        self.ac_sym, self.ac_len = build_decode_lut(
            table_set.num_ac_codes, table_set.ac_values)
