"""Data parallelism over `torch.distributed`: the process mesh, the
multi-process set-up and the row-sharded aggregates. The JAX package's
`overlap` (XLA's async collectives) has no counterpart; `sharded2d` and
`wide` (the wide-V path) are not ported yet."""
from .mesh import Mesh, all_reduce, barrier, broadcast, make_mesh, row_shard
from .multihost import initialize, local_shard, shutdown, union_vocab
from .sharded import (
    build_vocab_sharded,
    factorized_join_sum_sharded,
    sum_to_triple_grouped_sharded,
    sum_to_triple_sharded,
)

__all__ = ["Mesh", "all_reduce", "barrier", "broadcast", "make_mesh",
           "row_shard", "initialize", "local_shard", "shutdown",
           "union_vocab", "build_vocab_sharded",
           "factorized_join_sum_sharded", "sum_to_triple_grouped_sharded",
           "sum_to_triple_sharded"]
