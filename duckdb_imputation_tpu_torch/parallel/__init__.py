"""Data and model parallelism over `torch.distributed`: the process mesh,
the multi-process set-up, the row-sharded aggregates, the pipelined one
(`overlap`: sigma in column stripes, each stripe's all-reduce issued
asynchronously behind the next stripe's K7 window) and the wide-V path
(`sharded2d`: a data × model process grid, sigma's columns split over
'model'; `wide`: the column-sharded CG solves and `run_mice_wide`)."""
from .mesh import (Mesh, all_reduce, all_reduce_async, barrier, broadcast,
                   make_mesh, row_shard)
from .multihost import initialize, local_shard, shutdown, union_vocab
from .overlap import sum_to_triple_overlapped
from .sharded import (
    build_vocab_sharded,
    factorized_join_sum_sharded,
    sum_to_triple_grouped_sharded,
    sum_to_triple_sharded,
)
from .sharded2d import Mesh2D, make_mesh_2d, sum_to_triple_sharded2d
from .wide import (
    cg_solve_wide,
    lda_predict_wide,
    lda_solve_wide,
    linreg_train_wide,
    mice_cat_step_wide,
    mice_column_step_wide,
    predict_wide,
    run_mice_wide,
    sigma_wide,
)

__all__ = ["Mesh", "all_reduce", "all_reduce_async", "barrier",
           "broadcast", "make_mesh", "row_shard", "initialize",
           "local_shard", "shutdown", "union_vocab", "build_vocab_sharded",
           "factorized_join_sum_sharded", "sum_to_triple_grouped_sharded",
           "sum_to_triple_overlapped", "sum_to_triple_sharded", "Mesh2D",
           "make_mesh_2d", "sum_to_triple_sharded2d", "cg_solve_wide",
           "lda_predict_wide", "lda_solve_wide", "linreg_train_wide",
           "mice_cat_step_wide", "mice_column_step_wide", "predict_wide",
           "run_mice_wide", "sigma_wide"]
