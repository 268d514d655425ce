"""Ring schedules as data: the schedule value only.

Port of :class:`RingSchedule` (``triton_distributed_tpu/tune/schedule.py:
76``) with JAX's fields and defaults. JAX's rings *execute* a schedule
(``kernels/ring.py``); its enumerator, the shmemlint legality oracle, the
persisted winner store and :func:`resolve_schedule` come with the tuning
layer (ROADMAP Queue 1 step 10). Until then an entry that takes
``schedule=`` reads ``None`` as the canonical default and refuses a value
it cannot run (:func:`require_depth_only`).
"""

from __future__ import annotations

from dataclasses import asdict, dataclass

@dataclass(frozen=True)
class RingSchedule:
    """One ring schedule (JAX ``tune/schedule.py:76``).

    ``chunk_order`` 'ring' | 'skip_last'; ``direction`` 'fwd' | 'rev'
    (the order in which a reduce ring adds its hops, and so its
    numerics); ``split8`` the bidirectional all-gather's column split in
    eighths; ``depth`` the reduce ring's buffer depth (2 or 3 slots);
    ``scale_rail`` 'own' | 'payload'; ``dequant`` 'eager' | 'epilogue'."""

    chunk_order: str = "ring"
    direction: str = "fwd"
    split8: int = 4
    depth: int = 2
    scale_rail: str = "own"
    dequant: str = "eager"

    def to_dict(self) -> dict:
        return asdict(self)


#: the canonical default: JAX's rings before schedules existed
DEFAULT = RingSchedule()


def require_depth_only(schedule, what: str) -> int:
    """The ring depth of ``schedule`` (None: the default, 2), or
    ``ValueError``: the port's pull kernels run only the default ring
    order, whose depth (2 or 3 slots) changes no value. Any other field
    (a reversed ``direction`` adds the hops in another order, a
    ``skip_last`` drops one) needs the tuning layer (ROADMAP Queue 1
    step 10)."""
    if schedule is None:
        return DEFAULT.depth
    if not isinstance(schedule, RingSchedule):
        raise ValueError(f"{what}: schedule must be a RingSchedule or "
                         f"None, got {schedule!r}")
    others = {k: v for k, v in schedule.to_dict().items()
              if k != "depth" and v != getattr(DEFAULT, k)}
    if others:
        raise ValueError(
            f"{what}: schedule fields {others} are not ported; only depth "
            "(2 or 3) runs here, the rest comes with the tuning layer "
            "(ROADMAP Queue 1 step 10)")
    if schedule.depth not in (2, 3):
        raise ValueError(f"{what}: schedule depth must be 2 or 3, got "
                         f"{schedule.depth}")
    return schedule.depth
