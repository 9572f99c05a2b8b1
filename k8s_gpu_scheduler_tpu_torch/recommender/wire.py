"""Hand-written proto3 codec of the two recommender messages (copy of
the JAX package's ``recommender/wire.py``), byte-compatible with
generated stubs of ``recom.proto``:

- ``Request``: field 1 string (tag 0x0A, LEN).
- ``Reply``: field 1 repeated float — packed fixed32 (tag 0x0A, LEN) as
  proto3 emits, though the decoder also accepts unpacked (tag 0x0D);
  field 2 repeated string (tag 0x12, LEN per element).
"""
from __future__ import annotations

import struct
from typing import List, Tuple


def _varint(n: int) -> bytes:
    out = bytearray()
    while True:
        b = n & 0x7F
        n >>= 7
        if n:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _read_varint(buf: bytes, i: int) -> Tuple[int, int]:
    shift = n = 0
    while True:
        if i >= len(buf):
            raise ValueError("truncated varint")
        b = buf[i]
        i += 1
        n |= (b & 0x7F) << shift
        if not b & 0x80:
            return n, i
        shift += 7


def encode_request(index: str) -> bytes:
    data = index.encode()
    return b"\x0a" + _varint(len(data)) + data


def decode_request(buf: bytes) -> str:
    i, index = 0, ""
    while i < len(buf):
        tag, i = _read_varint(buf, i)
        field, wt = tag >> 3, tag & 7
        if field == 1 and wt == 2:
            ln, i = _read_varint(buf, i)
            index = buf[i : i + ln].decode()
            i += ln
        else:
            i = _skip(buf, i, wt)
    return index


def encode_reply(result: List[float], columns: List[str]) -> bytes:
    out = bytearray()
    if result:
        packed = b"".join(struct.pack("<f", v) for v in result)
        out += b"\x0a" + _varint(len(packed)) + packed
    for c in columns:
        data = c.encode()
        out += b"\x12" + _varint(len(data)) + data
    return bytes(out)


def decode_reply(buf: bytes) -> Tuple[List[float], List[str]]:
    result: List[float] = []
    columns: List[str] = []
    i = 0
    while i < len(buf):
        tag, i = _read_varint(buf, i)
        field, wt = tag >> 3, tag & 7
        if field == 1 and wt == 2:  # packed floats
            ln, i = _read_varint(buf, i)
            result.extend(
                struct.unpack_from("<f", buf, i + off)[0] for off in range(0, ln, 4)
            )
            i += ln
        elif field == 1 and wt == 5:  # unpacked float
            result.append(struct.unpack_from("<f", buf, i)[0])
            i += 4
        elif field == 2 and wt == 2:
            ln, i = _read_varint(buf, i)
            columns.append(buf[i : i + ln].decode())
            i += ln
        else:
            i = _skip(buf, i, wt)
    return result, columns


def _skip(buf: bytes, i: int, wire_type: int) -> int:
    if wire_type == 0:
        _, i = _read_varint(buf, i)
        return i
    if wire_type == 1:
        return i + 8
    if wire_type == 2:
        ln, i = _read_varint(buf, i)
        return i + ln
    if wire_type == 5:
        return i + 4
    raise ValueError(f"unsupported wire type {wire_type}")


SERVICE = "recommender.recommender"
METHOD_CONFIGURATIONS = f"/{SERVICE}/ImputeConfigurations"
METHOD_INTERFERENCE = f"/{SERVICE}/ImputeInterference"
