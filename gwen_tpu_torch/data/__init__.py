from gwen_tpu_torch.data.dataset import MeshEnsembleDataset
from gwen_tpu_torch.data.multihost import all_gather_from_hosts, process_slice
from gwen_tpu_torch.data.synthetic import mesh_ensemble_dataset

__all__ = ["MeshEnsembleDataset", "all_gather_from_hosts",
           "mesh_ensemble_dataset", "process_slice"]
