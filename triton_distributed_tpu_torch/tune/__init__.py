"""The port's tuning layer: the ring and grid schedules as data
(``schedule``)."""

from triton_distributed_tpu_torch.tune.schedule import (
    DEFAULT,
    GRID_DEFAULT,
    GridSchedule,
    RingSchedule,
)

__all__ = ["DEFAULT", "GRID_DEFAULT", "GridSchedule", "RingSchedule"]
