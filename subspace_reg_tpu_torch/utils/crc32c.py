"""CRC-32C (Castagnoli, reflected polynomial 0x82F63B78), table-driven.

It checksums the OCDBT store's manifests and b-tree nodes
(utils/ocdbt.py) and frames the records of TensorBoard event files
(utils/logging.py), which store it masked (``masked``).  Both checksum
kilobytes, not the data files, so Python's speed is enough.
"""

from __future__ import annotations

POLY = 0x82F63B78
MASK_DELTA = 0xA282EAD8


def _table():
    table = []
    for i in range(256):
        c = i
        for _ in range(8):
            c = (c >> 1) ^ POLY if c & 1 else c >> 1
        table.append(c)
    return tuple(table)


TABLE = _table()


def crc32c(data, crc: int = 0) -> int:
    """CRC-32C of ``data`` (bytes-like), continuing from ``crc``."""
    c = crc ^ 0xFFFFFFFF
    t = TABLE
    for b in bytes(data):
        c = t[(c ^ b) & 0xFF] ^ (c >> 8)
    return c ^ 0xFFFFFFFF


def masked(data) -> int:
    """The TFRecord form: the CRC rotated right by 15 bits plus a
    constant."""
    c = crc32c(data)
    return (((c >> 15) | (c << 17)) + MASK_DELTA) & 0xFFFFFFFF
