from gwen_tpu_torch.data.dataset import MeshEnsembleDataset
from gwen_tpu_torch.data.synthetic import mesh_ensemble_dataset

__all__ = ["MeshEnsembleDataset", "mesh_ensemble_dataset"]
