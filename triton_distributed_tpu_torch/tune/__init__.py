"""The port's tuning layer: the ring schedule as data (``schedule``)."""

from triton_distributed_tpu_torch.tune.schedule import DEFAULT, RingSchedule

__all__ = ["DEFAULT", "RingSchedule"]
