"""Parallel layers of the port: meshes and sharding rules (``mesh.py``,
``sharding.py``, with the collectives a sharded forward issues in
``_sharded.py``), the mixture-of-experts layer with expert parallelism
(``moe.py``), ring and Ulysses attention (``ring_attention.py``), the
GPipe pipeline (``pipeline.py``) and the gradient-sync collectives
(``collective.py``: the quantized ring and in-graph reductions) over
``torch.distributed`` groups."""

from ray_tpu_torch.parallel.mesh import (
    AXIS_ORDER, MeshSpec, initialize_distributed, make_mesh, mesh_axis_size,
    single_device_mesh)
from ray_tpu_torch.parallel.moe import moe_dispatch, moe_ffn, top_k_gating
from ray_tpu_torch.parallel.pipeline import pipeline
from ray_tpu_torch.parallel.ring_attention import (
    reference_attention, ring_attention, ring_attention_lockstep,
    ring_backward_step, ring_block_causal, ring_forward_step,
    ulysses_attention)
from ray_tpu_torch.parallel.sharding import (
    P, ShardingConfig, ShardingRules, infer_sharding, shard_pytree)

__all__ = ["AXIS_ORDER", "MeshSpec", "P", "ShardingConfig", "ShardingRules",
           "infer_sharding", "initialize_distributed", "make_mesh",
           "mesh_axis_size", "moe_dispatch", "moe_ffn", "pipeline",
           "reference_attention", "ring_attention",
           "ring_attention_lockstep", "ring_backward_step",
           "ring_block_causal", "ring_forward_step", "shard_pytree",
           "single_device_mesh", "top_k_gating", "ulysses_attention"]
