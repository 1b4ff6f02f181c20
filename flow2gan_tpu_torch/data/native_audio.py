"""ctypes binding of the port's native WAV reader (`native/wav_loader.cpp`),
its own copy of `flow2gan_tpu/data/native_audio.py` as far as the loader
uses it: the crop read.

The library is a host library. It is built with g++ from the source in the
checkout at first use, into `build/native/` at the root of the checkout
(rebuilt when the source is newer), and never committed. Where it cannot be
built or loaded, or with FLOW2GAN_NO_NATIVE=1, `read_crop_mono` returns None
and the loader reads in Python (`audio_io.read_wav`); that is logged once.
`reads` counts the crops read natively, so a run can show that its loader
went through the library.
"""

from __future__ import annotations

import ctypes
import logging
import os
import subprocess
import threading
from pathlib import Path
from typing import Optional

import numpy as np

SOURCE = Path(__file__).resolve().parent / "native" / "wav_loader.cpp"
LIBRARY = Path(__file__).resolve().parents[2] / "build" / "native" / "libwavloader.so"
CXXFLAGS = ("-O3", "-fPIC", "-shared", "-Wall")  # those of native/Makefile

reads = 0
_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_tried = False


def _build() -> None:
    LIBRARY.parent.mkdir(parents=True, exist_ok=True)
    tmp = LIBRARY.with_suffix(f".{os.getpid()}.tmp")
    subprocess.run([os.environ.get("CXX", "g++"), *CXXFLAGS, "-o", str(tmp), str(SOURCE)],
                   check=True, capture_output=True, timeout=120)
    os.replace(tmp, LIBRARY)  # atomic: another process never loads half a file


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _tried
    with _lock:
        if _tried:
            return _lib
        _tried = True
        if os.environ.get("FLOW2GAN_NO_NATIVE") == "1":
            logging.warning("native WAV reader off (FLOW2GAN_NO_NATIVE=1): reading WAVs in Python")
            return None
        try:
            if not LIBRARY.exists() or LIBRARY.stat().st_mtime < SOURCE.stat().st_mtime:
                _build()
            lib = ctypes.CDLL(str(LIBRARY))
        except (OSError, subprocess.SubprocessError) as e:
            logging.warning(f"native WAV reader unavailable ({e}): reading WAVs in Python")
            return None
        lib.wav_decode_crop.argtypes = [ctypes.c_char_p, ctypes.c_longlong, ctypes.c_longlong,
                                        ctypes.POINTER(ctypes.c_float)]
        lib.wav_decode_crop.restype = ctypes.c_longlong
        _lib = lib
        return _lib


def available() -> bool:
    return _load() is not None


def read_crop_mono(path, start: int, count: int) -> Optional[np.ndarray]:
    """`count` frames from frame `start` (fewer at the end of the file),
    mixed to mono float32; None where the library is unavailable or cannot
    read the file, and the caller reads it in Python."""
    global reads
    lib = _load()
    if lib is None:
        return None
    out = np.empty(count, np.float32)
    got = lib.wav_decode_crop(str(path).encode(), start, count,
                              out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)))
    if got < 0:
        return None
    with _lock:  # the loader's threads read concurrently
        reads += 1
    return out[:got]
