"""The port's zstd decoder (subspace_reg_tpu_torch/csrc/zstd_decode.cpp via
utils/zstd.py), its raw-block writer and CRC-32C (utils/crc32c.py), held
against the ``zstandard``, ``xxhash`` and ``google_crc32c`` packages on the
CPU (the port never imports them):

* inputs made from a numpy seed (zeros, random f32 weights, text-like
  bytes, repeat-heavy bytes, copies from three distances in turn,
  small-alphabet bytes; sizes 0, 1, 131073 and
  ~2 MiB, several blocks) compressed by ``zstandard`` at levels 1, 3, 19
  and -5, with and without the content checksum and the content size,
  decode to the same bytes; so do a streamed frame of flushed blocks, two
  concatenated frames and a skippable frame among them;
* truncated and bit-flipped frames (with the checksum) raise, a frame that
  needs a dictionary raises naming its ID, a failed build raises; hand-made
  blocks: a Huffman stream both decoders read alike, and one with bits
  left over, treeless literals without a table, a block above 128 KiB and
  a wrong content size, which raise;
* ``compress_raw``'s frames decode in ``zstandard``; a frame whose
  content checksum (XXH64's low 32 bits, by the ``xxhash`` package) is
  wrong raises; CRC-32C equals ``google_crc32c``'s, its check value is
  0xE3069283.
"""

import random

import numpy as np
import pytest
import zstandard

import google_crc32c
import xxhash
from subspace_reg_tpu_torch.utils import crc32c, cuda_build, zstd

LEVELS = (1, 3, 19, -5)


def _repeats(seed: int = 0, n: int = 3000) -> bytes:
    """Short copies of one 64-byte pattern at shifting offsets: the
    optimal parser's repeat offsets (including rep0 - 1) all occur."""
    r = np.random.RandomState(seed)
    base = r.randint(0, 256, 64).astype(np.uint8).tobytes()
    parts = []
    for _ in range(n):
        k = r.randint(0, 4)
        if k == 0:
            parts.append(base[r.randint(0, 32):][:r.randint(4, 30)])
        elif k == 1:
            parts.append(r.randint(0, 256, r.randint(1, 3))
                         .astype(np.uint8).tobytes())
        else:
            parts.append(base[:r.randint(8, 64)])
    return b"".join(parts)


def _three_offsets(seed: int = 0, n: int = 4000) -> bytes:
    """Copies from three distances in turn, a literal between most: the
    encoder keeps all three repeat offsets in use, so a wrong rotation of
    the third shows."""
    r = np.random.RandomState(seed)
    out = bytearray(r.randint(0, 256, 4096).astype(np.uint8).tobytes())
    for _ in range(n):
        start = len(out) - (1000, 2000, 3000)[r.randint(0, 3)]
        out += out[start:start + r.randint(6, 20)]
        if r.rand() < 0.7:
            out.append(r.randint(0, 256))
    return bytes(out)


def _inputs():
    r = np.random.RandomState(0)
    words = np.array(["alpha", "beta", "gamma", "delta", "the", "of", "x"])
    return {
        "empty": b"",
        "one": b"a",
        "zeros_131073": bytes(131073),
        "f32_weights": (0.05 * r.randn(40000)).astype(np.float32).tobytes(),
        "text": " ".join(r.choice(words, 60000)).encode(),
        "repeats": _repeats(),
        "three_offsets": _three_offsets(),
        "small_alphabet": r.randint(0, 4, 50000).astype(np.uint8).tobytes(),
        "f32_2mib": r.randn(1 << 19).astype(np.float32).tobytes(),
    }


INPUTS = _inputs()


@pytest.mark.parametrize("name", sorted(INPUTS))
def test_decoder_equals_zstandard(name):
    data = INPUTS[name]
    levels = LEVELS if len(data) < 1 << 20 else (1, 19)
    for level in levels:
        for checksum in (False, True):
            for content_size in (True, False):
                frame = zstandard.ZstdCompressor(
                    level=level, write_checksum=checksum,
                    write_content_size=content_size).compress(data)
                assert zstd.decompress(frame) == data, (level, checksum,
                                                        content_size)


def test_streamed_concatenated_and_skippable_frames():
    data = INPUTS["text"] + INPUTS["repeats"]
    co = zstandard.ZstdCompressor(level=3).compressobj()
    streamed = b"".join(co.compress(data[i:i + 7000])
                        + co.flush(zstandard.COMPRESSOBJ_FLUSH_BLOCK)
                        for i in range(0, len(data), 7000)) + co.flush()
    assert zstd.decompress(streamed) == data
    a = zstandard.ZstdCompressor(level=1).compress(b"first ")
    b = zstandard.ZstdCompressor(level=19, write_checksum=True).compress(
        INPUTS["f32_weights"])
    skip = (0x184D2A53).to_bytes(4, "little") + (5).to_bytes(4, "little")
    assert zstd.decompress(a + skip + b"12345" + b) == (
        b"first " + INPUTS["f32_weights"])
    assert zstd.decompress(skip + b"12345" + a) == b"first "


def test_corrupt_frames_raise():
    data = INPUTS["f32_weights"][:60000] + INPUTS["text"][:60000]
    rnd = random.Random(0)
    for level in (1, 19):
        frame = zstandard.ZstdCompressor(level=level,
                                         write_checksum=True).compress(data)
        for cut in (0, 3, 5, 9, len(frame) // 2, len(frame) - 1):
            with pytest.raises(zstd.ZstdError):
                zstd.decompress(frame[:cut])
        for _ in range(150):
            bad = bytearray(frame)
            i = rnd.randrange(len(bad))
            bad[i] ^= 1 << rnd.randrange(8)
            with pytest.raises(zstd.ZstdError):
                zstd.decompress(bytes(bad))
    with pytest.raises(zstd.ZstdError, match="not a zstd frame"):
        zstd.decompress(b"\x00" * 16)


def test_dictionary_frames_are_refused_by_id():
    # single segment, 4-byte dictionary ID, 1-byte content size, one raw
    # block of 3 bytes
    frame = ((0xFD2FB528).to_bytes(4, "little") + bytes([0x23])
             + (12345678).to_bytes(4, "little") + bytes([3])
             + ((3 << 3) | 1).to_bytes(3, "little") + b"abc")
    with pytest.raises(zstd.ZstdError, match="dictionary 12345678"):
        zstd.decompress(frame)
    # the same frame with dictionary ID 0 (none) decodes
    frame = frame[:5] + bytes(4) + frame[9:]
    assert zstd.decompress(frame) == b"abc"


def _frame(content_size: int, *blocks: bytes) -> bytes:
    """A frame with a 128 KiB window and a 4-byte content size."""
    return ((0xFD2FB528).to_bytes(4, "little") + bytes([0x80, 7 << 3])
            + content_size.to_bytes(4, "little") + b"".join(blocks))


def _block(kind: int, size: int, body: bytes, last: bool = True) -> bytes:
    return ((size << 3) | (kind << 1) | int(last)).to_bytes(3, "little") \
        + body


def _huffman_block(stream: bytes, regen: int = 8, kind: int = 2) -> bytes:
    """A compressed block: 1-stream Huffman literals (``kind`` 2 with the
    tree "symbols 0 and 1, one bit each" in direct weights, 3 treeless)
    and no sequences."""
    tree = bytes([128, 0x10]) if kind == 2 else b""
    lit = tree + stream
    head = (kind | (regen << 4) | (len(lit) << 14)).to_bytes(3, "little")
    body = head + lit + b"\x00"
    return _block(2, len(body), body)


def test_hand_made_blocks():
    # 8 one-bit symbols 0,1,1,0,1,0,0,1 read from bit 7 down, then the
    # end marker byte: both decoders agree
    good = _frame(8, _huffman_block(bytes([0b01101001, 0x01])))
    want = bytes([0, 1, 1, 0, 1, 0, 0, 1])
    assert zstandard.ZstdDecompressor().decompress(good) == want
    assert zstd.decompress(good) == want
    # a stream with bits left over after its last symbol
    with pytest.raises(zstd.ZstdError, match="does not end"):
        zstd.decompress(_frame(8, _huffman_block(
            bytes([0, 0b01101001, 0x01]))))
    # treeless literals with no earlier table
    with pytest.raises(zstd.ZstdError, match="treeless"):
        zstd.decompress(_frame(8, _huffman_block(
            bytes([0b01101001, 0x01]), kind=3)))
    # a raw block above 128 KiB
    big = bytes(zstd.BLOCK_MAX + 1)
    with pytest.raises(zstd.ZstdError, match="maximum"):
        zstd.decompress(_frame(len(big), _block(0, len(big), big)))
    # content size and blocks that disagree
    with pytest.raises(zstd.ZstdError, match="content size"):
        zstd.decompress(_frame(9, _block(0, 8, bytes(8))))


@pytest.mark.parametrize("size", [0, 1, 131072, 131073, 300000])
def test_compress_raw_reads_in_zstandard(size):
    data = np.random.RandomState(size).randint(
        0, 256, size).astype(np.uint8).tobytes()
    frame = zstd.compress_raw(data)
    assert len(frame) == size + 10 + 3 * max(1, -(-size // zstd.BLOCK_MAX))
    out = zstandard.ZstdDecompressor().decompressobj().decompress(frame)
    assert out == data
    params = zstandard.get_frame_parameters(frame)
    assert params.content_size == size
    assert zstd.decompress(frame) == data


def test_content_checksum_and_crc32c_equal_the_reference_packages():
    assert crc32c.crc32c(b"123456789") == 0xE3069283
    r = np.random.RandomState(7)
    for n in (0, 1, 3, 4, 7, 8, 31, 32, 33, 1000):
        data = r.randint(0, 256, n).astype(np.uint8).tobytes()
        # a raw frame with the checksum flag and XXH64's low 32 bits
        frame = bytearray(zstd.compress_raw(data))
        frame[4] |= 4
        good = bytes(frame) + (xxhash.xxh64_intdigest(data)
                               & 0xFFFFFFFF).to_bytes(4, "little")
        assert zstd.decompress(good) == data, n
        bad = good[:-1] + bytes([good[-1] ^ 0x80])
        with pytest.raises(zstd.ZstdError, match="checksum"):
            zstd.decompress(bad)
        assert crc32c.crc32c(data) == google_crc32c.value(data), n
    # continuing a CRC over a split equals one pass
    assert crc32c.crc32c(b"6789", crc32c.crc32c(b"12345")) == 0xE3069283
    c = google_crc32c.value(b"abc")
    assert crc32c.masked(b"abc") == (((c >> 15) | (c << 17))
                                     + 0xA282EAD8) & 0xFFFFFFFF


def test_failed_build_raises(monkeypatch, tmp_path):
    """Without a working g++ the decoder cannot be built, and decoding
    raises: there is no decoder in Python."""
    monkeypatch.setattr(cuda_build, "BUILD_DIR", tmp_path / "_build")
    monkeypatch.setattr(cuda_build, "_LIBS", {})
    monkeypatch.setattr(zstd, "_lib", None)
    monkeypatch.setattr(cuda_build.shutil, "which", lambda name: None)
    with pytest.raises(RuntimeError, match="g\\+\\+"):
        zstd.decompress(zstd.compress_raw(b"abc"))
    monkeypatch.setattr(cuda_build.shutil, "which",
                        lambda name: "/bin/false")
    with pytest.raises(RuntimeError, match="build failed"):
        zstd.decompress(zstd.compress_raw(b"abc"))
