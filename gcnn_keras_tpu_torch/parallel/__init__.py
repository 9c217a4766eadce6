"""Data-parallel training on process groups and the edge-partitioned
models; counterpart of ``gcnn_keras_tpu/parallel``."""
from .mesh import make_mesh, stack_batches, shard_stacked_batch
from .data_parallel import make_dp_train_step, make_dp_eval_step
from .partitioned import (
    prepare_partitioned, build_partitioned_batch,
    make_partitioned_energy_force, make_partitioned_train_step,
    run_partitioned_energy_force, shard_node_array, unshard_node_array,
    single_graph_batch,
)
