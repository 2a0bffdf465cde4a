"""TensorBoard scalar event writer in pure Python (the port's own copy of the
JAX package's `utils/tb_writer.py`; no TensorBoard package).

The reference's training writes TensorBoard event files through
detectron2's EventStorage. This writer emits the same wire format for
scalars: TFRecord framing (length + masked CRC32C) around hand-encoded
`Event` protobufs with `Summary.Value{tag, simple_value}` payloads, which
`tensorboard --logdir` reads. At the same `wall_time` its records are byte
for byte those of the JAX package's writer.

metrics.json stays the canonical metrics file (engine/trainer.py); this
writer is additive, gated on cfg.TENSORBOARD_ON.

Proto schema (tensorboard/compat/proto/event.proto):
  Event:   1=wall_time(double) 2=step(int64) 3=file_version(string)
           5=summary(Summary)
  Summary: 1=value(repeated Summary.Value)
  Value:   1=tag(string) 2=simple_value(float)
"""
from __future__ import annotations

import os
import socket
import struct
import time
from typing import Dict, Optional

# ---------------------------------------------------------------------------
# crc32c (Castagnoli), table-driven — TFRecord framing checksums.
# ---------------------------------------------------------------------------
_CRC_TABLE = []


def _build_table():
    poly = 0x82F63B78
    for i in range(256):
        crc = i
        for _ in range(8):
            crc = (crc >> 1) ^ (poly if crc & 1 else 0)
        _CRC_TABLE.append(crc)


_build_table()


def _crc32c(data: bytes) -> int:
    crc = 0xFFFFFFFF
    for b in data:
        crc = (crc >> 8) ^ _CRC_TABLE[(crc ^ b) & 0xFF]
    return crc ^ 0xFFFFFFFF


def _masked_crc(data: bytes) -> int:
    crc = _crc32c(data)
    return (((crc >> 15) | (crc << 17)) + 0xA282EAD8) & 0xFFFFFFFF


# ---------------------------------------------------------------------------
# minimal protobuf wire encoding
# ---------------------------------------------------------------------------
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


def _field_varint(num: int, val: int) -> bytes:
    return _varint((num << 3) | 0) + _varint(val)


def _field_bytes(num: int, payload: bytes) -> bytes:
    return _varint((num << 3) | 2) + _varint(len(payload)) + payload


def _field_double(num: int, val: float) -> bytes:
    return _varint((num << 3) | 1) + struct.pack("<d", val)


def _field_float(num: int, val: float) -> bytes:
    return _varint((num << 3) | 5) + struct.pack("<f", val)


def _encode_event(wall_time: float, step: Optional[int] = None,
                  file_version: Optional[str] = None,
                  scalars: Optional[Dict[str, float]] = None) -> bytes:
    msg = _field_double(1, wall_time)
    if step is not None:
        msg += _field_varint(2, step)
    if file_version is not None:
        msg += _field_bytes(3, file_version.encode("utf-8"))
    if scalars:
        summary = b"".join(
            _field_bytes(1, _field_bytes(1, tag.encode("utf-8"))
                         + _field_float(2, float(val)))
            for tag, val in scalars.items())
        msg += _field_bytes(5, summary)
    return msg


class TBScalarWriter:
    """Append-only tfevents scalar writer.

    Usage:
        w = TBScalarWriter(output_dir)
        w.add_scalars({"total_loss": 1.23}, step=100)
        w.close()
    """

    def __init__(self, logdir: str, filename_suffix: str = ""):
        os.makedirs(logdir, exist_ok=True)
        host = socket.gethostname()
        self.path = os.path.join(
            logdir,
            f"events.out.tfevents.{int(time.time())}.{host}{filename_suffix}")
        self._f = open(self.path, "ab")
        # TB requires the first record to declare the file version
        self._write_record(_encode_event(time.time(),
                                         file_version="brain.Event:2"))
        self._f.flush()

    def _write_record(self, payload: bytes) -> None:
        header = struct.pack("<Q", len(payload))
        self._f.write(header)
        self._f.write(struct.pack("<I", _masked_crc(header)))
        self._f.write(payload)
        self._f.write(struct.pack("<I", _masked_crc(payload)))

    def add_scalars(self, scalars: Dict[str, float], step: int,
                    wall_time: Optional[float] = None) -> None:
        clean = {k: float(v) for k, v in scalars.items()
                 if isinstance(v, (int, float)) and v == v}  # drop NaN
        if not clean:
            return
        self._write_record(_encode_event(
            wall_time if wall_time is not None else time.time(),
            step=step, scalars=clean))
        self._f.flush()

    def close(self) -> None:
        if not self._f.closed:
            self._f.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def read_tfevents(path: str):
    """Parse a tfevents file back into [(step, {tag: value}), ...].

    Test/debug helper — validates the TFRecord framing (crcs included) and
    decodes the scalar summaries this writer emits.
    """
    out = []
    with open(path, "rb") as f:
        data = f.read()
    pos = 0
    while pos < len(data):
        (length,) = struct.unpack_from("<Q", data, pos)
        header = data[pos:pos + 8]
        (hcrc,) = struct.unpack_from("<I", data, pos + 8)
        assert hcrc == _masked_crc(header), "header crc mismatch"
        payload = data[pos + 12: pos + 12 + length]
        (pcrc,) = struct.unpack_from("<I", data, pos + 12 + length)
        assert pcrc == _masked_crc(payload), "payload crc mismatch"
        pos += 12 + length + 4
        out.append(_decode_event(payload))
    return out


def _decode_event(buf: bytes):
    step, scalars, version = 0, {}, None
    pos = 0

    def rd_varint(p):
        shift, val = 0, 0
        while True:
            b = buf[p]
            val |= (b & 0x7F) << shift
            p += 1
            if not b & 0x80:
                return val, p
            shift += 7

    while pos < len(buf):
        key, pos = rd_varint(pos)
        num, wt = key >> 3, key & 7
        if wt == 0:
            val, pos = rd_varint(pos)
            if num == 2:
                step = val
        elif wt == 1:
            pos += 8
        elif wt == 5:
            pos += 4
        elif wt == 2:
            ln, pos = rd_varint(pos)
            sub = buf[pos:pos + ln]
            pos += ln
            if num == 3:
                version = sub.decode("utf-8")
            elif num == 5:  # summary
                spos = 0
                while spos < len(sub):
                    skey, spos2 = rd_varint_b(sub, spos)
                    sln, spos2 = rd_varint_b(sub, spos2)
                    vbuf = sub[spos2:spos2 + sln]
                    spos = spos2 + sln
                    if skey >> 3 == 1:
                        tag, val = _decode_value(vbuf)
                        scalars[tag] = val
    return {"step": step, "scalars": scalars, "file_version": version}


def rd_varint_b(buf: bytes, p: int):
    shift, val = 0, 0
    while True:
        b = buf[p]
        val |= (b & 0x7F) << shift
        p += 1
        if not b & 0x80:
            return val, p
        shift += 7


def _decode_value(buf: bytes):
    tag, val = "", float("nan")
    pos = 0
    while pos < len(buf):
        key, pos = rd_varint_b(buf, pos)
        num, wt = key >> 3, key & 7
        if wt == 2:
            ln, pos = rd_varint_b(buf, pos)
            if num == 1:
                tag = buf[pos:pos + ln].decode("utf-8")
            pos += ln
        elif wt == 5:
            if num == 2:
                (val,) = struct.unpack_from("<f", buf, pos)
            pos += 4
        elif wt == 1:
            pos += 8
        elif wt == 0:
            _, pos = rd_varint_b(buf, pos)
    return tag, val
