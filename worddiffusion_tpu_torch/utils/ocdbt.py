"""A read-only reader of TensorStore's OCDBT key-value store ("OCDBT
on-disk format" in the TensorStore documentation), the layout orbax writes
a checkpoint's arrays in.

A store is a directory with ``manifest.ocdbt`` and data files under
``d/`` (and, as orbax writes it, ``ocdbt.process_<N>/d/``). The manifest
holds the store's config and its version tree; the newest version names the
root of a b-tree whose leaves map each key to its value, stored inline in
the leaf or as (data file, offset, length). Every manifest and node is a
14-byte header (magic, length, version, compression), a body (zstd-
compressed where the header says so) and the crc32c of what precedes it;
this reader checks each. Value ranges carry no checksum.

``OcdbtStore(path)`` lists the keys (``keys()``) by walking the tree's
nodes and reads only the values asked for (``read(key)``).
"""

from __future__ import annotations

import os

import numpy as np

from . import zstd

MANIFEST_MAGIC = 0x0CDB3A2A
NODE_MAGIC = 0x0CDB20DE
MISSING = (1 << 64) - 1  # the offset and length of an empty tree's root


def _crc32c_table() -> np.ndarray:
    t = np.arange(256, dtype=np.uint32)
    for _ in range(8):
        t = np.where(t & 1, (t >> 1) ^ np.uint32(0x82F63B78), t >> 1)
    return t


_CRC_TABLE = _crc32c_table().tolist()


def crc32c(data) -> int:
    """CRC-32C (Castagnoli) of ``data``, table-driven."""
    c = 0xFFFFFFFF
    t = _CRC_TABLE
    for b in bytes(data):
        c = t[(c ^ b) & 0xFF] ^ (c >> 8)
    return c ^ 0xFFFFFFFF


class OcdbtError(ValueError):
    """A malformed OCDBT file."""


class _Reader:
    """Varints, bytes and little-endian integers from a decoded body."""

    def __init__(self, data: bytes):
        self.data, self.pos = data, 0

    def varint(self) -> int:
        v = shift = 0
        while True:
            b = self.data[self.pos]
            self.pos += 1
            v |= (b & 0x7F) << shift
            if b < 0x80:
                return v
            shift += 7
            if shift > 63:
                raise OcdbtError("varint longer than 64 bits")

    def varints(self, n: int) -> list[int]:
        return [self.varint() for _ in range(n)]

    def take(self, n: int) -> bytes:
        out = self.data[self.pos:self.pos + n]
        if len(out) != n:
            raise OcdbtError("body ends early")
        self.pos += n
        return out

    def uint(self, n: int) -> int:
        return int.from_bytes(self.take(n), "little")


def decode_file(raw: bytes, magic: int, what: str) -> bytes:
    """The body of a manifest or node ``raw``: header and crc32c checked,
    zstd-decoded where the header says so."""
    if len(raw) < 18 or int.from_bytes(raw[:4], "big") != magic:
        raise OcdbtError(f"{what}: no magic {magic:08x}")
    if int.from_bytes(raw[4:12], "little") != len(raw):
        raise OcdbtError(f"{what}: length field {int.from_bytes(raw[4:12], 'little')}, "
                         f"file {len(raw)}")
    if crc32c(raw[:-4]) != int.from_bytes(raw[-4:], "little"):
        raise OcdbtError(f"{what}: crc32c mismatch")
    r = _Reader(raw[:-4])
    r.pos = 12
    version, compression = r.varint(), r.varint()
    if version != 0:
        raise OcdbtError(f"{what}: format version {version}")
    body = raw[r.pos:-4]
    if compression == 1:
        return zstd.decompress(body)
    if compression != 0:
        raise OcdbtError(f"{what}: compression format {compression}")
    return body


def _data_file_table(r: _Reader) -> list[str]:
    """The node's or manifest's data files, as paths relative to the store's
    root (base path + relative path, prefix-compressed against the previous)."""
    n = r.varint()
    if not n:
        return []
    prefix = [0] + r.varints(n - 1)
    suffix = r.varints(n)
    r.varints(n)  # base path lengths: the split point within each path
    paths, prev = [], b""
    for p, s in zip(prefix, suffix):
        prev = prev[:p] + r.take(s)
        paths.append(prev.decode())
    return paths


def _keys(r: _Reader, n: int, interior: bool) -> tuple[list[bytes], list[int]]:
    prefix = [0] + r.varints(n - 1)
    suffix = r.varints(n)
    common = r.varints(n) if interior else [0] * n
    keys, prev = [], b""
    for p, s in zip(prefix, suffix):
        prev = prev[:p] + r.take(s)
        keys.append(prev)
    return keys, common


class OcdbtStore:
    def __init__(self, root: str):
        self.root = root
        path = os.path.join(root, "manifest.ocdbt")
        with open(path, "rb") as f:
            r = _Reader(decode_file(f.read(), MANIFEST_MAGIC, path))
        r.take(16)  # uuid
        kind = r.varint()
        if kind != 0:
            raise OcdbtError(f"{path}: a numbered manifest (kind {kind}); only the single "
                             f"manifest orbax writes is read")
        r.varints(2)  # max inline value bytes, max decoded node bytes
        r.take(1)  # version tree arity log2
        if r.varint() == 1:
            r.take(4)  # zstd level
        files = _data_file_table(r)
        n = r.varint()
        if not n:
            raise OcdbtError(f"{path}: no version")
        gens, heights = r.varints(n), list(r.take(n))
        fids, offsets, lengths = r.varints(n), r.varints(n), r.varints(n)
        # the newest version is the last of the manifest's own entries
        self.generation, self.height = gens[-1], heights[-1]
        self.root_ref = None if offsets[-1] == MISSING else (files[fids[-1]], offsets[-1],
                                                             lengths[-1])
        self._entries: dict[bytes, object] | None = None

    def _read_range(self, rel: str, offset: int, length: int) -> bytes:
        with open(os.path.join(self.root, rel), "rb") as f:
            f.seek(offset)
            out = f.read(length)
        if len(out) != length:
            raise OcdbtError(f"{rel}: {length} bytes at {offset} run past the file")
        return out

    def _walk(self, ref, height: int, prefix: bytes, out: dict) -> None:
        rel, offset, length = ref
        what = f"{rel}@{offset}"
        r = _Reader(decode_file(self._read_range(rel, offset, length), NODE_MAGIC, what))
        if r.take(1)[0] != height:
            raise OcdbtError(f"{what}: node height differs from its reference's")
        files = _data_file_table(r)
        n = r.varint()
        if not n:
            return
        keys, common = _keys(r, n, height > 0)
        if height > 0:
            fids, offsets, lengths = r.varints(n), r.varints(n), r.varints(n)
            for k, c, f, o, ln in zip(keys, common, fids, offsets, lengths):
                self._walk((files[f], o, ln), height - 1, prefix + k[:c], out)
            return
        lengths = r.varints(n)
        kinds = r.varints(n)
        indirect = [i for i, k in enumerate(kinds) if k == 1]
        fids, offsets = r.varints(len(indirect)), r.varints(len(indirect))
        refs = {i: (files[f], o, lengths[i]) for i, f, o in zip(indirect, fids, offsets)}
        for i, k in enumerate(keys):
            if kinds[i] == 0:
                out[prefix + k] = r.take(lengths[i])
            elif kinds[i] == 1:
                out[prefix + k] = refs[i]
            else:
                raise OcdbtError(f"{what}: value kind {kinds[i]}")

    def _index(self) -> dict:
        if self._entries is None:
            self._entries = {}
            if self.root_ref is not None:
                self._walk(self.root_ref, self.height, b"", self._entries)
        return self._entries

    def keys(self) -> list[str]:
        """Every key, in order."""
        return sorted(k.decode() for k in self._index())

    def __contains__(self, key: str) -> bool:
        return key.encode() in self._index()

    def read(self, key: str) -> bytes:
        """The value of ``key`` (``KeyError`` where it is absent)."""
        v = self._index()[key.encode()]
        return v if isinstance(v, bytes) else self._read_range(*v)
