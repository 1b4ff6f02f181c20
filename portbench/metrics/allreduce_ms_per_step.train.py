"""NCCL kernel device ms per step, their waits for the other ranks
included, the largest over the ranks."""

from portbench import yardstick
from portbench.metrics._common import ranks


def read(obs):
    per = [1e3 * o["device_s"][yardstick.NCCL] / o["steps"] for o in ranks(obs)
           if o.get("device_s", {}).get(yardstick.NCCL)]
    return max(per) if per else None
