"""TensorBoard event files written with the standard library and numpy: the
trainers' `--tensorboard` needs no `tensorboard`, `tensorboardX` or
protobuf package.

An event file is a sequence of TFRecords, each a little-endian u64 length,
the masked CRC-32C of those 8 bytes, the data and the masked CRC-32C of the
data. Each record holds one `Event` protobuf, encoded here by hand: the
first carries `file_version` "brain.Event:2", the others a `Summary` of one
`Value` (a scalar, a PNG image or a 16-bit PCM WAV clip) with the wall time
and the step. TensorBoard's own reader takes the files (the tests read them
back through it).
"""

from __future__ import annotations

import io
import os
import socket
import struct
import time
import wave
import zlib
from pathlib import Path
from typing import Optional, Union

import numpy as np


def _crc32c_table():
    table = []
    for i in range(256):
        c = i
        for _ in range(8):
            c = (c >> 1) ^ 0x82F63B78 if c & 1 else c >> 1
        table.append(c)
    return table


_CRC32C_TABLE = _crc32c_table()


def crc32c(data: bytes) -> int:
    """CRC-32C (Castagnoli), table-driven."""
    crc = 0xFFFFFFFF
    table = _CRC32C_TABLE
    for b in data:
        crc = table[(crc ^ b) & 0xFF] ^ (crc >> 8)
    return crc ^ 0xFFFFFFFF


def masked_crc32c(data: bytes) -> int:
    """TFRecord's mask of the CRC-32C."""
    crc = crc32c(data)
    return (((crc >> 15) | (crc << 17)) + 0xA282EAD8) & 0xFFFFFFFF


def tfrecord(data: bytes) -> bytes:
    header = struct.pack("<Q", len(data))
    return (header + struct.pack("<I", masked_crc32c(header)) + data
            + struct.pack("<I", masked_crc32c(data)))


# protobuf wire format: a field's key is (number << 3) | wire type; 0 varint,
# 1 fixed64, 2 length-delimited, 5 fixed32


def _varint(n: int) -> bytes:
    n &= (1 << 64) - 1  # negative int64s take ten bytes
    out = bytearray()
    while True:
        byte, n = n & 0x7F, n >> 7
        if n:
            out.append(byte | 0x80)
        else:
            out.append(byte)
            return bytes(out)


def _int(field: int, n: int) -> bytes:
    return _varint(field << 3) + _varint(int(n))


def _fixed32(field: int, x: float) -> bytes:
    return _varint((field << 3) | 5) + struct.pack("<f", x)


def _fixed64(field: int, x: float) -> bytes:
    return _varint((field << 3) | 1) + struct.pack("<d", x)


def _bytes(field: int, payload: Union[bytes, str]) -> bytes:
    if isinstance(payload, str):
        payload = payload.encode()
    return _varint((field << 3) | 2) + _varint(len(payload)) + payload


def encode_png(image: np.ndarray) -> bytes:
    """An (H, W, 3) uint8 image as an 8-bit RGB PNG."""
    if image.dtype != np.uint8 or image.ndim != 3 or image.shape[2] != 3:
        raise ValueError(f"want an (H, W, 3) uint8 image, got {image.dtype} {image.shape}")
    h, w, _ = image.shape

    def chunk(kind: bytes, data: bytes) -> bytes:
        return (struct.pack(">I", len(data)) + kind + data
                + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))

    rows = np.concatenate([np.zeros((h, 1), np.uint8), image.reshape(h, w * 3)], axis=1)
    return (b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(rows.tobytes(), 6)) + chunk(b"IEND", b""))


def encode_wav(wav: np.ndarray, sample_rate: int) -> bytes:
    """A mono float waveform, clipped to [-1, 1], as a 16-bit PCM WAV
    (scaled by 32767 and truncated, as the JAX package's `tb_add_audio`
    writes it)."""
    pcm = np.clip(np.asarray(wav, np.float32).reshape(-1), -1.0, 1.0)
    buf = io.BytesIO()
    with wave.open(buf, "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(int(sample_rate))
        w.writeframes((pcm * 32767.0).astype("<i2").tobytes())
    return buf.getvalue()


class SummaryWriter:
    """Writes one event file, `events.out.tfevents.<time>.<host>`, in
    `log_dir` (a `.<n>` suffix where that name is taken): the subset of
    tensorboardX's `SummaryWriter` that the trainers call. Each add is
    written and flushed at once."""

    def __init__(self, log_dir: Union[str, Path]):
        self.log_dir = Path(log_dir)
        self.log_dir.mkdir(parents=True, exist_ok=True)
        base = f"events.out.tfevents.{int(time.time()):010d}.{socket.gethostname()}"
        self.path = self.log_dir / base
        n = 0
        while True:
            try:
                self._file = open(self.path, "xb")
                break
            except FileExistsError:
                n += 1
                self.path = self.log_dir / f"{base}.{n}"
        self._write(_fixed64(1, time.time()) + _bytes(3, "brain.Event:2"))

    def _write(self, event: bytes) -> None:
        self._file.write(tfrecord(event))
        self._file.flush()

    def _add(self, tag: str, value: bytes, step: Optional[int]) -> None:
        event = _fixed64(1, time.time())
        if step is not None:
            event += _int(2, step)
        self._write(event + _bytes(5, _bytes(1, _bytes(1, tag) + value)))

    def add_scalar(self, tag: str, value: float, global_step: Optional[int] = None) -> None:
        self._add(tag, _fixed32(2, float(value)), global_step)

    def add_image(self, tag: str, img_tensor: np.ndarray, global_step: Optional[int] = None,
                  dataformats: str = "HWC") -> None:
        """An (H, W, 3) uint8 image; `dataformats` must be "HWC"."""
        if dataformats != "HWC":
            raise ValueError(f"only HWC images are written, not {dataformats}")
        h, w, _ = img_tensor.shape
        image = _int(1, h) + _int(2, w) + _int(3, 3) + _bytes(4, encode_png(img_tensor))
        self._add(tag, _bytes(4, image), global_step)

    def add_audio(self, tag: str, snd_tensor: np.ndarray, global_step: Optional[int] = None,
                  sample_rate: int = 44100) -> None:
        """A mono float waveform in [-1, 1], as `encode_wav` writes it (the
        JAX package's `tb_add_audio`)."""
        n = int(np.asarray(snd_tensor).size)
        audio = (_fixed32(1, float(sample_rate)) + _int(2, 1) + _int(3, n)
                 + _bytes(4, encode_wav(snd_tensor, sample_rate)) + _bytes(5, "audio/wav"))
        self._add(tag, _bytes(6, audio), global_step)

    def close(self) -> None:
        if not self._file.closed:
            self._file.flush()
            os.fsync(self._file.fileno())
            self._file.close()

    def __enter__(self) -> "SummaryWriter":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
