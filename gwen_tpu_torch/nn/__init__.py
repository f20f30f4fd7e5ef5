from gwen_tpu_torch.nn.attention import graph_attention_apply, graph_attention_init
from gwen_tpu_torch.nn.convert import params_from_jax, params_to_tree
from gwen_tpu_torch.nn.gencast import GenCast, gencast_from_config, gencast_graphs
from gwen_tpu_torch.nn.gnn import EncodeProcessDecode, GCNStack
from gwen_tpu_torch.nn.graphcast import GraphCast, graphcast_from_config, graphcast_graphs
from gwen_tpu_torch.nn.interaction import interaction_apply, interaction_init
from gwen_tpu_torch.nn.layers import gcn_apply, gcn_init

__all__ = ["EncodeProcessDecode", "GCNStack", "GenCast", "GraphCast", "gcn_apply", "gcn_init",
           "gencast_from_config", "gencast_graphs",
           "graphcast_from_config", "graphcast_graphs",
           "graph_attention_apply", "graph_attention_init",
           "interaction_apply", "interaction_init", "params_from_jax",
           "params_to_tree"]
