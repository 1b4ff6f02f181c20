"""Host-side audio I/O: WAV read and write, resampling and peak
normalisation, numpy and scipy only. The port's own copy of
`flow2gan_tpu/data/audio_io.py`. PCM 8/16/24/32-bit and float32/64 WAV."""

from __future__ import annotations

import struct
import wave
from pathlib import Path
from typing import Tuple, Union

import numpy as np

Pathlike = Union[str, Path]


def read_wav(path: Pathlike) -> Tuple[np.ndarray, int]:
    """Read a WAV file -> (float32 samples (channels, time) in [-1, 1],
    sample_rate). Mono is (1, time), as torchaudio.load returns it."""
    path = str(path)
    with open(path, "rb") as f:
        header = f.read(12)
        if header[:4] != b"RIFF" or header[8:12] != b"WAVE":
            raise ValueError(f"not a WAV file: {path}")
        # walk the chunks by hand: the wave module cannot read float WAVs
        fmt = data = None
        while fmt is None or data is None:
            head = f.read(8)
            if len(head) < 8:
                break
            cid, size = struct.unpack("<4sI", head)
            if cid == b"fmt ":
                fmt = f.read(size)
            elif cid == b"data":
                data = f.read(size)
            else:
                f.seek(size + (size & 1), 1)
    if fmt is None or data is None:
        raise ValueError(f"malformed WAV file: {path}")

    audio_format, n_channels, sample_rate, _, _, bits = struct.unpack("<HHIIHH", fmt[:16])
    if audio_format == 0xFFFE and len(fmt) >= 40:  # WAVE_FORMAT_EXTENSIBLE
        audio_format = struct.unpack("<H", fmt[24:26])[0]

    if audio_format == 1:  # PCM
        if bits == 16:
            x = np.frombuffer(data, dtype="<i2").astype(np.float32) / 32768.0
        elif bits == 32:
            x = np.frombuffer(data, dtype="<i4").astype(np.float32) / 2147483648.0
        elif bits == 24:
            raw = np.frombuffer(data, dtype=np.uint8).reshape(-1, 3)
            x = (
                raw[:, 0].astype(np.int32)
                | (raw[:, 1].astype(np.int32) << 8)
                | (raw[:, 2].astype(np.int8).astype(np.int32) << 16)
            ).astype(np.float32) / 8388608.0
        elif bits == 8:
            x = (np.frombuffer(data, dtype=np.uint8).astype(np.float32) - 128.0) / 128.0
        else:
            raise ValueError(f"unsupported PCM bit depth {bits}: {path}")
    elif audio_format == 3:  # IEEE float
        if bits == 32:
            x = np.frombuffer(data, dtype="<f4").astype(np.float32)
        elif bits == 64:
            x = np.frombuffer(data, dtype="<f8").astype(np.float32)
        else:
            raise ValueError(f"unsupported float bit depth {bits}: {path}")
    else:
        raise ValueError(f"unsupported WAV format code {audio_format}: {path}")

    x = x.reshape(-1, n_channels).T if n_channels > 1 else x[None, :]
    return np.ascontiguousarray(x), sample_rate


def write_wav(path: Pathlike, audio: np.ndarray, sample_rate: int) -> None:
    """Write float32 (time,) or (channels, time) audio as PCM16 WAV, scaled
    by 32768 and clamped, so read(write(x)) is within half an LSB of x."""
    audio = np.asarray(audio)
    if audio.ndim == 1:
        audio = audio[None, :]
    pcm = np.clip(np.rint(audio * 32768.0), -32768, 32767).astype("<i2").T.reshape(-1)
    with wave.open(str(path), "wb") as w:
        w.setnchannels(audio.shape[0])
        w.setsampwidth(2)
        w.setframerate(sample_rate)
        w.writeframes(pcm.tobytes())


def resample(audio: np.ndarray, orig_sr: int, target_sr: int) -> np.ndarray:
    """Polyphase resampling along the last axis (scipy)."""
    if orig_sr == target_sr:
        return audio
    from math import gcd

    from scipy.signal import resample_poly

    g = gcd(orig_sr, target_sr)
    return resample_poly(audio, target_sr // g, orig_sr // g, axis=-1).astype(np.float32)


def peak_normalize_db(audio: np.ndarray, db: float) -> np.ndarray:
    """Scale so the peak is at `db` dBFS (sox `norm`, the gain augmentation)."""
    peak = np.abs(audio).max()
    if peak <= 0:
        return audio
    return (audio * (10.0 ** (db / 20.0) / peak)).astype(np.float32)
