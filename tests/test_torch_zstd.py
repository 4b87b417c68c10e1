"""The port's zstd decoder (``utils/zstd.py``, numpy and the standard
library) against the ``zstandard`` package, bitwise: compression levels
-5 to 19 on seeded float, integer and text inputs over several 128 KiB
blocks, frames with and without a content size or a checksum, streamed
(windowed) frames, several frames back to back, skippable frames, RLE
blocks, and every literal and sequence mode (recorded as the decoder meets
them). A frame that names a dictionary, or a corrupted one, raises.
"""

import numpy as np
import pytest

from worddiffusion_tpu_torch.utils import zstd

zstandard = pytest.importorskip("zstandard")

LEVELS = [-5, 1, 3, 9, 19]


def _inputs() -> dict:
    rng = np.random.default_rng(0)
    text = " ".join(rng.choice(["the", "of", "and", "handwriting", "diffusion", "word",
                                "image", "writer", "style", "a", "in", "to"], 60_000))
    ints = rng.integers(0, 1000, 70_000).astype(np.int32)
    return {
        # Huffman-heavy: random floats (and their bfloat16 halves)
        "float": rng.standard_normal(70_000).astype(np.float32).tobytes(),
        # sequence-heavy: small integers, words
        "int": ints.tobytes(),
        "text": text.encode(),
        # varied content past one block: literal and sequence tables carried over
        "mixed": b"".join([rng.standard_normal(20_000).astype(np.float32).tobytes(),
                           text.encode()[:150_000], ints[:30_000].tobytes(),
                           bytes(40_000), rng.standard_normal(20_000).astype(np.float16)
                           .tobytes()]),
    }


INPUTS = _inputs()


@pytest.fixture
def modes(monkeypatch):
    """The literal types and sequence table modes the decoder meets."""
    seen = {"literals": set(), "sequences": set()}
    read_literals, seq_table = zstd._read_literals, zstd._seq_table

    def lit(data, pos, st):
        seen["literals"].add(("raw", "rle", "huffman", "treeless")[data[pos] & 3]
                             + ("" if data[pos] & 3 < 2 else
                                "/1" if (data[pos] >> 2) & 3 == 0 else "/4"))
        return read_literals(data, pos, st)

    def table(data, pos, mode, *a):
        seen["sequences"].add(("predefined", "rle", "fse", "repeat")[mode])
        return seq_table(data, pos, mode, *a)

    monkeypatch.setattr(zstd, "_read_literals", lit)
    monkeypatch.setattr(zstd, "_seq_table", table)
    return seen


@pytest.mark.parametrize("level", LEVELS)
@pytest.mark.parametrize("name", sorted(INPUTS))
def test_levels_bitwise(name, level):
    raw = INPUTS[name]
    c = zstandard.ZstdCompressor(level=level).compress(raw)
    assert zstd.decompress(c) == raw


def test_every_mode_is_met(modes):
    """Across the level sweep every literal type (Huffman in 1 and 4
    streams, treeless) and every sequence table mode occurs."""
    for level in LEVELS:
        for raw in INPUTS.values():
            assert zstd.decompress(zstandard.ZstdCompressor(level=level).compress(raw)) == raw
    small = zstandard.ZstdCompressor(level=19).compress(b"abcdefghij" * 3 + b"xyz" * 40)
    assert zstd.decompress(small) == b"abcdefghij" * 3 + b"xyz" * 40
    assert modes["literals"] >= {"raw", "huffman/1", "huffman/4", "treeless/4"}, modes
    assert modes["sequences"] == {"predefined", "rle", "fse", "repeat"}, modes


@pytest.mark.parametrize("content_size", [True, False])
@pytest.mark.parametrize("checksum", [True, False])
def test_frame_flags(content_size, checksum):
    raw = INPUTS["mixed"]
    c = zstandard.ZstdCompressor(level=3, write_content_size=content_size,
                                 write_checksum=checksum).compress(raw)
    fhd = c[4]
    assert bool(fhd >> 6) == content_size and bool(fhd & 4) == checksum
    assert zstd.decompress(c) == raw


def test_streamed_frame_without_content_size():
    """What TensorStore writes for a large zarr chunk: a frame header byte
    0x00 (no content size, not single-segment: a window descriptor)."""
    raw = INPUTS["float"] + INPUTS["int"]
    co = zstandard.ZstdCompressor(level=1).compressobj()
    c = b"".join(co.compress(raw[i:i + 50_000]) for i in range(0, len(raw), 50_000))
    c += co.flush()
    assert c[4] == 0
    assert zstd.decompress(c) == raw


def test_several_and_skippable_frames():
    parts = [INPUTS["text"][:5000], b"", INPUTS["float"][:9000]]
    frames = [zstandard.ZstdCompressor(level=lv).compress(p) for lv, p in zip((1, 9, 19), parts)]
    skip = (0x184D2A53).to_bytes(4, "little") + (7).to_bytes(4, "little") + b"payload"
    assert zstd.decompress(skip + frames[0] + frames[1] + skip + frames[2]) == b"".join(parts)


def test_rle_and_raw_blocks():
    """A run of one byte past a block (RLE blocks) and incompressible bytes
    (raw blocks); the block types are read from the frame."""
    rng = np.random.default_rng(1)
    raw = bytes([7]) * 300_000 + rng.integers(0, 256, 200_000).astype(np.uint8).tobytes()
    c = zstandard.ZstdCompressor(level=3, write_content_size=True).compress(raw)
    fhd = c[4]
    assert fhd >> 6 == 2 and not fhd & 3  # a 4-byte content size, no dictionary
    # magic, the header byte, the window descriptor unless single-segment, the size
    types, pos = set(), 4 + 1 + (0 if fhd & 0x20 else 1) + 4
    while True:
        h = int.from_bytes(c[pos:pos + 3], "little")
        types.add((h >> 1) & 3)
        pos += 3 + (1 if (h >> 1) & 3 == 1 else h >> 3)
        if h & 1:
            break
    assert {0, 1} <= types
    assert zstd.decompress(c) == raw


def test_dictionary_frame_refused():
    samples = [f"word {i} of the writer {i % 7} in style {i % 3}".encode() * 4
               for i in range(400)]
    d = zstandard.train_dictionary(2048, samples)
    c = zstandard.ZstdCompressor(dict_data=d, write_dict_id=True).compress(samples[5])
    with pytest.raises(zstd.ZstdError, match=f"dictionary ID {d.dict_id()}"):
        zstd.decompress(c)


def test_corruption_raises():
    """A flipped bit in a checksummed frame raises, as does a truncated one."""
    raw = INPUTS["text"][:100_000]
    c = bytearray(zstandard.ZstdCompressor(level=3, write_checksum=True).compress(raw))
    rng = np.random.default_rng(2)
    for i in rng.integers(20, len(c) - 8, 12):
        bad = bytearray(c)
        bad[i] ^= 1 << int(rng.integers(0, 8))
        with pytest.raises(zstd.ZstdError):
            zstd.decompress(bytes(bad))
    with pytest.raises(zstd.ZstdError):
        zstd.decompress(bytes(c[:-10]))
    with pytest.raises(zstd.ZstdError, match="not a zstd frame"):
        zstd.decompress(b"\x00" * 16)
