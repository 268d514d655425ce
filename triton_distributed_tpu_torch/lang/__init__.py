"""The port's device language, host side: symmetric tensors (``shmem``)."""

from triton_distributed_tpu_torch.lang.shmem import (
    SymmTensor,
    block_table,
    my_pe,
    n_pes,
    peer_table,
    stacked,
    symm_empty,
)

__all__ = ["SymmTensor", "block_table", "my_pe", "n_pes", "peer_table",
           "stacked", "symm_empty"]
