"""TFRecord container + tf.Example wire format, implemented from scratch.

Port of ``clipa_tpu/data/tfrecord.py`` (numpy only). The reference reads
LAION shards as TFDS-materialized TFRecords through tf.data's C++ readers
(clipa_jax/datasets/tfds.py:27-71). This module owns that surface without
TensorFlow:

  * TFRecord framing: ``[len u64][masked crc32c(len) u32][payload]
    [masked crc32c(payload) u32]`` per record.
  * tf.Example protobuf: hand-rolled encoder/decoder for the three feature
    types (bytes_list / float_list / int64_list) — the wire format is stable
    and tiny, a protobuf dependency buys nothing.

CRC32C is table-driven numpy; readers skip verification by default (the hot
path) and writers always emit correct CRCs so TF/TFDS can read our shards.
The native scanner of ``clipa_tpu_torch/native`` (``tfr_scan``, SSE4.2
CRC32C) counts records at IO speed: :func:`count_records`, which
``tools/laion``'s ``count`` uses, as the JAX tool does. The Python reader
stays the pipeline's, as in the JAX package.
"""

from __future__ import annotations

import functools
import os
import struct
from typing import Any, BinaryIO, Iterator

import numpy as np

# ---------------------------------------------------------------------------
# CRC32C (Castagnoli), table-driven, a chunk of bytes at a time
# ---------------------------------------------------------------------------

_CRC_CHUNK = 4096


@functools.lru_cache(maxsize=1)
def _crc_tables() -> tuple[np.ndarray, np.ndarray]:
    """(table, shifted): the byte table of the reflected Castagnoli CRC,
    and shifted[k, b], the register that byte b leaves from register 0
    once k zero bytes follow it (k < _CRC_CHUNK)."""
    poly = 0x82F63B78  # reversed Castagnoli polynomial
    table = np.zeros(256, np.uint32)
    for i in range(256):
        crc = i
        for _ in range(8):
            crc = (crc >> 1) ^ (poly if crc & 1 else 0)
        table[i] = crc
    shifted = np.empty((_CRC_CHUNK, 256), np.uint32)
    shifted[0] = table
    for k in range(1, _CRC_CHUNK):
        prev = shifted[k - 1]
        shifted[k] = table[prev & 0xFF] ^ (prev >> 8)
    return table, shifted


def crc32c(data: bytes) -> int:
    """CRC32C of `data`. The register update is linear over GF(2), so the
    register after a chunk is the XOR of each byte's contribution
    (``shifted`` at its distance from the chunk's end), with the register
    before the chunk XORed into the chunk's first four bytes (for a
    reflected CRC, the same as starting from that register)."""
    table, shifted = _crc_tables()
    buf = np.frombuffer(data, np.uint8)
    crc = 0xFFFFFFFF
    for start in range(0, len(buf), _CRC_CHUNK):
        chunk = buf[start:start + _CRC_CHUNK]
        n = len(chunk)
        if n < 4:
            for b in chunk.tolist():
                crc = int(table[(crc ^ b) & 0xFF]) ^ (crc >> 8)
            continue
        chunk = chunk.copy()
        chunk[:4] ^= np.frombuffer(crc.to_bytes(4, "little"), np.uint8)
        crc = int(np.bitwise_xor.reduce(
            shifted[np.arange(n - 1, -1, -1), chunk]))
    return crc ^ 0xFFFFFFFF


def masked_crc32c(data: bytes) -> int:
    crc = crc32c(data)
    return ((crc >> 15 | crc << 17) + 0xA282EAD8) & 0xFFFFFFFF


# ---------------------------------------------------------------------------
# TFRecord framing
# ---------------------------------------------------------------------------

def read_records(path_or_file, verify: bool = False) -> Iterator[bytes]:
    """Yields raw record payloads from a TFRecord file."""
    f: BinaryIO
    own = isinstance(path_or_file, (str, os.PathLike))
    f = open(path_or_file, "rb") if own else path_or_file
    try:
        while True:
            header = f.read(12)
            if len(header) < 12:
                return
            (length,), (len_crc,) = (struct.unpack("<Q", header[:8]),
                                     struct.unpack("<I", header[8:]))
            if verify and masked_crc32c(header[:8]) != len_crc:
                raise IOError("TFRecord length CRC mismatch")
            payload = f.read(length)
            if len(payload) < length:
                raise IOError("Truncated TFRecord payload")
            (data_crc,) = struct.unpack("<I", f.read(4))
            if verify and masked_crc32c(payload) != data_crc:
                raise IOError("TFRecord data CRC mismatch")
            yield payload
    finally:
        if own:
            f.close()


def count_records(path: str, verify: bool = False) -> int:
    """The number of records of a local TFRecord file, by the native
    scanner (``tfr_scan``); with `verify`, both CRCs of every record are
    checked. Raises IOError on an unreadable or corrupt file, RuntimeError
    or OSError where the native library does not build."""
    from clipa_tpu_torch import native
    n = native.load().tfr_scan(os.fsencode(path), None, None, 0,
                               1 if verify else 0)
    if n == -1:
        raise IOError(f"cannot read TFRecord file {path}")
    if n < 0:
        raise IOError(f"corrupt TFRecord file {path} (a truncated record or, "
                      f"with verify, a CRC mismatch)")
    return int(n)


def write_records(path: str, payloads) -> int:
    """Writes raw payloads as a TFRecord file; returns the record count."""
    n = 0
    with open(path, "wb") as f:
        for payload in payloads:
            header = struct.pack("<Q", len(payload))
            f.write(header)
            f.write(struct.pack("<I", masked_crc32c(header)))
            f.write(payload)
            f.write(struct.pack("<I", masked_crc32c(payload)))
            n += 1
    return n


# ---------------------------------------------------------------------------
# protobuf wire primitives
# ---------------------------------------------------------------------------

def _read_varint(buf: memoryview, pos: int) -> tuple[int, int]:
    result = 0
    shift = 0
    while True:
        b = buf[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result, pos
        shift += 7


def _write_varint(out: bytearray, value: int) -> None:
    while True:
        bits = value & 0x7F
        value >>= 7
        if value:
            out.append(bits | 0x80)
        else:
            out.append(bits)
            return


def _iter_fields(buf: memoryview) -> Iterator[tuple[int, int, Any]]:
    """Yields (field_number, wire_type, value) over a message buffer."""
    pos = 0
    end = len(buf)
    while pos < end:
        tag, pos = _read_varint(buf, pos)
        field, wire = tag >> 3, tag & 7
        if wire == 0:  # varint
            value, pos = _read_varint(buf, pos)
        elif wire == 2:  # length-delimited
            size, pos = _read_varint(buf, pos)
            value = buf[pos:pos + size]
            pos += size
        elif wire == 5:  # 32-bit
            value = bytes(buf[pos:pos + 4])
            pos += 4
        elif wire == 1:  # 64-bit
            value = bytes(buf[pos:pos + 8])
            pos += 8
        else:
            raise ValueError(f"Unsupported wire type {wire}")
        yield field, wire, value


# ---------------------------------------------------------------------------
# tf.Example
# ---------------------------------------------------------------------------

def parse_example(payload: bytes) -> dict:
    """tf.Example bytes -> {name: np.ndarray | list[bytes]}.

    bytes_list -> list of bytes (length-1 lists are unwrapped),
    float_list -> float32 array, int64_list -> int64 array.
    """
    out: dict[str, Any] = {}
    buf = memoryview(payload)
    for field, _, features_buf in _iter_fields(buf):
        if field != 1:  # Example.features
            continue
        for f2, _, entry in _iter_fields(features_buf):
            if f2 != 1:  # Features.feature (map entry)
                continue
            name, feature = None, None
            for f3, _, v in _iter_fields(entry):
                if f3 == 1:
                    name = bytes(v).decode("utf-8")
                elif f3 == 2:
                    feature = v
            if name is None or feature is None:
                continue
            out[name] = _parse_feature(feature)
    return out


def _parse_feature(buf: memoryview):
    for kind, _, lst in _iter_fields(buf):
        if kind == 1:  # BytesList
            values = [bytes(v) for f, _, v in _iter_fields(lst) if f == 1]
            return values[0] if len(values) == 1 else values
        if kind == 2:  # FloatList (packed or repeated)
            floats: list[float] = []
            for f, wire, v in _iter_fields(lst):
                if f != 1:
                    continue
                if wire == 2:  # packed
                    floats.extend(np.frombuffer(bytes(v), "<f4").tolist())
                else:  # fixed32
                    floats.append(struct.unpack("<f", v)[0])
            return np.asarray(floats, np.float32)
        if kind == 3:  # Int64List
            ints: list[int] = []
            for f, wire, v in _iter_fields(lst):
                if f != 1:
                    continue
                if wire == 2:  # packed varints
                    pos = 0
                    mv = memoryview(v)
                    while pos < len(mv):
                        x, pos = _read_varint(mv, pos)
                        ints.append(_zigzag_free_int64(x))
                else:
                    ints.append(_zigzag_free_int64(v))
            return np.asarray(ints, np.int64)
    return None


def _zigzag_free_int64(x: int) -> int:
    """int64 values are plain two's-complement varints (not zigzag)."""
    return x - (1 << 64) if x >= (1 << 63) else x


def build_example(features: dict) -> bytes:
    """{name: bytes | str | float array | int array} -> tf.Example bytes."""
    entries = bytearray()
    for name, value in features.items():
        feature = _build_feature(value)
        entry = bytearray()
        nb = name.encode("utf-8")
        entry += b"\x0a"  # field 1 (key), wire 2
        _write_varint(entry, len(nb))
        entry += nb
        entry += b"\x12"  # field 2 (value: Feature), wire 2
        _write_varint(entry, len(feature))
        entry += feature
        entries += b"\x0a"  # Features.feature map entry, field 1 wire 2
        _write_varint(entries, len(entry))
        entries += entry
    out = bytearray()
    out += b"\x0a"  # Example.features, field 1 wire 2
    _write_varint(out, len(entries))
    out += entries
    return bytes(out)


def _build_feature(value) -> bytes:
    body = bytearray()
    if isinstance(value, (bytes, str)) or (
            isinstance(value, (list, tuple)) and value
            and isinstance(value[0], (bytes, str))):
        values = [value] if isinstance(value, (bytes, str)) else list(value)
        lst = bytearray()
        for v in values:
            vb = v.encode("utf-8") if isinstance(v, str) else v
            lst += b"\x0a"
            _write_varint(lst, len(vb))
            lst += vb
        body += b"\x0a"  # Feature.bytes_list field 1
        _write_varint(body, len(lst))
        body += lst
        return bytes(body)

    arr = np.asarray(value)
    if np.issubdtype(arr.dtype, np.floating):
        packed = arr.astype("<f4").tobytes()
        lst = bytearray(b"\x0a")  # FloatList.value field 1, packed wire 2
        _write_varint(lst, len(packed))
        lst += packed
        body += b"\x12"  # Feature.float_list field 2
        _write_varint(body, len(lst))
        body += lst
        return bytes(body)

    if np.issubdtype(arr.dtype, np.integer):
        packed = bytearray()
        for x in arr.reshape(-1).tolist():
            _write_varint(packed, x & 0xFFFFFFFFFFFFFFFF)
        lst = bytearray(b"\x0a")
        _write_varint(lst, len(packed))
        lst += packed
        body += b"\x1a"  # Feature.int64_list field 3
        _write_varint(body, len(lst))
        body += lst
        return bytes(body)

    raise TypeError(f"Unsupported feature type: {type(value)} / {arr.dtype}")
