"""GEMM device ms per training step, averaged over the ranks."""

from portbench.metrics._common import mean, on_device, ranks


def read(obs):
    return mean(1e3 * o["device_s"]["gemm"] / o["steps"] for o in ranks(obs)
                if on_device(o) and o["device_s"].get("gemm"))
