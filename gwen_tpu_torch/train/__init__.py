from gwen_tpu_torch.train.checkpoint import Checkpointer
from gwen_tpu_torch.train.optim import Optimizer, make_optimizer, make_schedule
from gwen_tpu_torch.train.remat import (
    remat_policy_for_budget,
    select_save_agg_steps,
)
from gwen_tpu_torch.train.mesh import (
    ProcessMesh,
    initialize_distributed,
    is_main_process,
    make_mesh,
    shard_batch,
)
from gwen_tpu_torch.train.tasks import (
    cnn_loss_fn,
    ensemble_crps_loss_fn,
    gencast_denoising_loss_fn,
    gnn_loss_fn,
    graphcast_loss_fn,
    mesh_graph_loss_fn,
    mesh_loss_fn,
    partitioned_ensemble_crps_loss_fn,
    partitioned_mesh_loss_fn,
    partitioned_rollout_loss_fn,
    rollout_loss_fn,
)
from gwen_tpu_torch.train.trainer import Trainer, TrainState

__all__ = [
    "Checkpointer",
    "Optimizer",
    "ProcessMesh",
    "Trainer",
    "TrainState",
    "cnn_loss_fn",
    "ensemble_crps_loss_fn",
    "gencast_denoising_loss_fn",
    "gnn_loss_fn",
    "graphcast_loss_fn",
    "initialize_distributed",
    "is_main_process",
    "make_mesh",
    "make_optimizer",
    "make_schedule",
    "mesh_graph_loss_fn",
    "mesh_loss_fn",
    "partitioned_ensemble_crps_loss_fn",
    "partitioned_mesh_loss_fn",
    "partitioned_rollout_loss_fn",
    "remat_policy_for_budget",
    "rollout_loss_fn",
    "select_save_agg_steps",
    "shard_batch",
]
