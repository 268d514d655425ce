"""Training: the wire-quantized gradient rings and the dp×tp×cp step.

Port of ``triton_distributed_tpu/train``:

* :mod:`~triton_distributed_tpu_torch.train.grad_wire` — the error-
  feedback + stochastic-rounding gradient rings (the overlap ops'
  quantized backward duals, ``OverlapContext(bwd_wire_dtype=...)``) and
  the dp gradient all-reduce, on ``tdt_grad_ring`` /
  ``tdt_grad_allgather``;
* :mod:`~triton_distributed_tpu_torch.train.step` — the dp×tp×cp train
  step (ring / Ulysses attention over cp, Megatron TP, the quantized dp
  gradient ring, Adam, gradient accumulation) on a loopback mesh.
"""

from triton_distributed_tpu_torch.train.grad_wire import (
    GRAD_RING_COLLECTIVE_ID,
    derive_seed,
    ef_ag_gemm,
    ef_gemm_rs,
    ef_ring_reduce_scatter,
    grad_allreduce_device,
    grad_allreduce_xla,
    grad_tree_allreduce,
    quantized_allgather,
    resolve_grad_wire,
    ring_wire_bytes,
    tree_slab,
)
from triton_distributed_tpu_torch.train.step import (
    TrainConfig,
    Trainer,
    default_train_mesh,
    init_opt_state,
    init_params,
    make_batch,
    params_from_numpy,
    train_step_reference,
)

__all__ = [
    "GRAD_RING_COLLECTIVE_ID",
    "TrainConfig",
    "Trainer",
    "default_train_mesh",
    "derive_seed",
    "ef_ag_gemm",
    "ef_gemm_rs",
    "ef_ring_reduce_scatter",
    "grad_allreduce_device",
    "grad_allreduce_xla",
    "grad_tree_allreduce",
    "init_opt_state",
    "init_params",
    "make_batch",
    "params_from_numpy",
    "quantized_allgather",
    "resolve_grad_wire",
    "ring_wire_bytes",
    "train_step_reference",
    "tree_slab",
]
