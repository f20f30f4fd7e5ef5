from gwen_tpu_torch.train.checkpoint import Checkpointer
from gwen_tpu_torch.train.optim import Optimizer, make_optimizer, make_schedule
from gwen_tpu_torch.train.remat import (
    remat_policy_for_budget,
    select_save_agg_steps,
)
from gwen_tpu_torch.train.tasks import mesh_graph_loss_fn
from gwen_tpu_torch.train.trainer import Trainer, TrainState

__all__ = [
    "Checkpointer",
    "Optimizer",
    "Trainer",
    "TrainState",
    "make_optimizer",
    "make_schedule",
    "mesh_graph_loss_fn",
    "remat_policy_for_budget",
    "select_save_agg_steps",
]
