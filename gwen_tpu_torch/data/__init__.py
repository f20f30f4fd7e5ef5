from gwen_tpu_torch.data.dataset import (
    MemberGraphDataset,
    MeshEnsembleDataset,
    load_data,
    load_split,
    make_datasets,
)
from gwen_tpu_torch.data.multihost import (
    all_gather_from_hosts,
    load_member_shard,
    process_slice,
)
from gwen_tpu_torch.data.pipeline import prefetch
from gwen_tpu_torch.data.synthetic import mesh_ensemble_dataset

__all__ = ["MemberGraphDataset", "MeshEnsembleDataset", "all_gather_from_hosts",
           "load_data", "load_member_shard", "load_split",
           "make_datasets", "mesh_ensemble_dataset", "prefetch",
           "process_slice"]
