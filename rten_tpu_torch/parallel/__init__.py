"""Multi-device execution on ``torch.distributed`` (the port of
``rten_tpu/parallel``): meshes of ranks, sharding plans, the rank-local
graph that stands where the JAX package let XLA's GSPMD partition,
sequence-parallel prefill, ring attention and the GPipe forward.

One process a rank, one device a rank: ``init_distributed`` joins the
group, ``make_mesh`` arranges the ranks as ('data', 'model'), and
``shard_model`` / ``shard_constants`` give each rank its graph and weights
(``partition.py`` says what is cut and which collectives run where).
"""

from .distributed import init_distributed, process_info  # noqa: F401
from .mesh import Mesh, MeshConfig, make_mesh  # noqa: F401
from .pipeline import PipelineRunner, plan_pipeline  # noqa: F401
from .sharding import (  # noqa: F401
    GPT2_INPUT_RULES,
    GPT2_SHARDING_RULES,
    MOE_EP_RULES,
    P,
    SP_PREFILL_INPUT_RULES,
    ShardedParams,
    derive_tp_plan,
    fsdp_weight_shardings,
    shard_constants,
    shard_constants_by_plan,
    shard_inputs,
    shard_model,
    sharding_for_name,
    tp_weight_shardings,
)
