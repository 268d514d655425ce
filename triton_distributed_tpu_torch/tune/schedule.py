"""Ring and grid schedules as data: the schedule values only.

Port of :class:`RingSchedule` (``triton_distributed_tpu/tune/schedule.py:
76``) and :class:`GridSchedule` (``:144``) with JAX's fields, defaults
and ``kind`` tags. JAX's kernels *execute* a schedule (``kernels/
ring.py``, the GEMM-RS int8-mxu epilogue); its enumerator, the shmemlint
legality oracle, the persisted winner store and :func:`resolve_schedule`
come with the tuning layer (ROADMAP Queue 1 step 10). Until then an
entry that takes ``schedule=`` reads ``None`` as the canonical default
and refuses a value it cannot run (:func:`require_depth_only`,
:func:`require_split_only`, :func:`require_grid_epilogue`,
:func:`require_ship_schedule`).
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

    #: schedule-kind tag (a class attribute, never a field), as in JAX
    kind = "ring"

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


def _only_field(schedule, field: str, what: str):
    """``ValueError`` unless ``schedule`` is a :class:`RingSchedule` whose
    only non-default field is ``field``: the rest needs the tuning layer
    (ROADMAP Queue 1 step 10)."""
    if not isinstance(schedule, RingSchedule):
        raise ValueError(f"{what}: schedule must be a RingSchedule or "
                         f"None, got {schedule!r}")
    others = {k: v for k, v in schedule.to_dict().items()
              if k != field and v != getattr(DEFAULT, k)}
    if others:
        raise ValueError(
            f"{what}: schedule fields {others} are not ported; only {field} "
            "runs here, the rest comes with the tuning layer (ROADMAP "
            "Queue 1 step 10)")


def require_depth_only(schedule, what: str) -> int:
    """The ring depth of ``schedule`` (None: the default, 2), or
    ``ValueError``: the port's pull kernels run only the default ring
    order, whose depth (2 or 3 slots) changes no value. Any other field
    (a reversed ``direction`` adds the hops in another order, a
    ``skip_last`` drops one) needs the tuning layer (ROADMAP Queue 1
    step 10)."""
    if schedule is None:
        return DEFAULT.depth
    _only_field(schedule, "depth", what)
    if schedule.depth not in (2, 3):
        raise ValueError(f"{what}: schedule depth must be 2 or 3, got "
                         f"{schedule.depth}")
    return schedule.depth


def require_split_only(schedule, what: str) -> int | None:
    """The bidirectional all-gather's ``split8`` (None: no schedule, the
    kernel's even ``k // 2``), or ``ValueError``: ``split8`` (1 to 7
    eighths of the columns on the clockwise ring) is the one field it
    runs."""
    if schedule is None:
        return None
    _only_field(schedule, "split8", what)
    if not 1 <= int(schedule.split8) <= 7:
        raise ValueError(f"{what}: split8 must be 1 to 7, got "
                         f"{schedule.split8}")
    return int(schedule.split8)


@dataclass(frozen=True)
class GridSchedule:
    """One grid-kernel schedule (JAX ``tune/schedule.py:144``): the
    schedule of the non-ring families (ragged attention, ``kv_ship``,
    the GEMM-RS int8-mxu epilogue), each varying its own knobs.

    ``epilogue`` 'accumulator' (the int8-mxu GEMM-RS quantizes each
    hop's wire off the f32 accumulator, ``_fused_kernel_mxw``) |
    'readback' (the partial is rounded to the output type and requantized
    by the generic pass, ``_fused_kernel_mxr``); ``demote`` 'auto' (an
    int8-mxu layout the accumulator epilogue cannot take runs the int8
    wire) | 'strict' (it raises). ``block_q``, ``n_bufs``,
    ``pack_rows``, ``tree_pack``, ``prefix_run_len`` (ragged attention)
    are kept for JAX's fields; only their defaults run here
    (:func:`require_grid_epilogue`). ``coalesce`` (pages a tick) and
    ``rail`` 'paired' | 'shared' | 'drop' (the scale plane's rail) are
    the KV ship's (:func:`require_ship_schedule`)."""

    kind = "grid"

    block_q: int = 0
    n_bufs: int = 2
    pack_rows: int = 8
    coalesce: int = 1
    rail: str = "paired"
    epilogue: str = "accumulator"
    demote: str = "auto"
    tree_pack: int = 0
    prefix_run_len: int = 0

    def to_dict(self) -> dict:
        return asdict(self)

    def is_default(self) -> bool:
        return self == GRID_DEFAULT


#: the canonical grid default: JAX's baked-in kernels
GRID_DEFAULT = GridSchedule()


def require_grid_epilogue(schedule, what: str) -> tuple:
    """(epilogue, demote) of a :class:`GridSchedule` (None: the defaults,
    'accumulator' and 'auto'), or ``ValueError``: the int8-mxu GEMM-RS
    runs these two fields; any other non-default field (``block_q``,
    ``n_bufs``, ``pack_rows``, ``coalesce``, ``rail``, ...) needs the
    tuning layer (ROADMAP Queue 1 step 10)."""
    if schedule is None:
        return GRID_DEFAULT.epilogue, GRID_DEFAULT.demote
    if not isinstance(schedule, GridSchedule):
        raise ValueError(f"{what}: schedule must be a GridSchedule or None, "
                         f"got {schedule!r}")
    others = {k: v for k, v in schedule.to_dict().items()
              if k not in ("epilogue", "demote")
              and v != getattr(GRID_DEFAULT, k)}
    if others:
        raise ValueError(
            f"{what}: grid schedule fields {others} are not ported; only "
            "epilogue and demote run here, the rest comes with the tuning "
            "layer (ROADMAP Queue 1 step 10)")
    if schedule.epilogue not in ("accumulator", "readback"):
        raise ValueError(f"{what}: epilogue must be 'accumulator' or "
                         f"'readback', got {schedule.epilogue!r}")
    if schedule.demote not in ("auto", "strict"):
        raise ValueError(f"{what}: demote must be 'auto' or 'strict', got "
                         f"{schedule.demote!r}")
    return schedule.epilogue, schedule.demote


def require_ship_schedule(schedule, what: str) -> int:
    """The KV ship's ``coalesce`` (pages a tick; None: 1), or
    ``ValueError``: the ship runs a :class:`GridSchedule` whose only
    non-default field is ``coalesce`` (JAX ``kernels/kv_ship.py:256-263``;
    the landing table must then give each tick a contiguous run, checked
    by the ship). ``rail`` 'shared' (the scale plane signalling the
    payload's semaphores) and 'drop' (no scale plane) are the analyzer's
    illegal mutants (SL009), and like every other field they need the
    tuning layer (ROADMAP Queue 1 step 10)."""
    if schedule is None:
        return GRID_DEFAULT.coalesce
    if not isinstance(schedule, GridSchedule):
        raise ValueError(f"{what}: schedule must be a GridSchedule or None, "
                         f"got {schedule!r}")
    others = {k: v for k, v in schedule.to_dict().items()
              if k != "coalesce" and v != getattr(GRID_DEFAULT, k)}
    if others:
        raise ValueError(
            f"{what}: grid schedule fields {others} are not ported; only "
            "coalesce runs here, the rest (the scale rail 'shared' / 'drop' "
            "is the analyzer's SL009 mutant) comes with the tuning layer "
            "(ROADMAP Queue 1 step 10)")
    if int(schedule.coalesce) < 1:
        raise ValueError(f"{what}: coalesce must be at least 1, got "
                         f"{schedule.coalesce}")
    return int(schedule.coalesce)
