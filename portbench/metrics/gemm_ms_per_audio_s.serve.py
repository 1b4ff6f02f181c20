"""GEMM device ms (kernels named as cuBLAS, cuBLASLt or CUTLASS GEMMs) per
second of audio returned in the traced window: the branches' matmuls."""

from portbench.metrics._common import on_device


def read(obs):
    gemm = obs["device_s"].get("gemm")
    return 1e3 * gemm / obs["audio_s"] if on_device(obs) and gemm else None
