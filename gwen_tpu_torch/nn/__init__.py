from gwen_tpu_torch.nn.attention import graph_attention_apply, graph_attention_init
from gwen_tpu_torch.nn.convert import params_from_jax, params_to_tree
from gwen_tpu_torch.nn.gnn import EncodeProcessDecode
from gwen_tpu_torch.nn.layers import gcn_apply, gcn_init

__all__ = ["EncodeProcessDecode", "gcn_apply", "gcn_init",
           "graph_attention_apply", "graph_attention_init", "params_from_jax",
           "params_to_tree"]
