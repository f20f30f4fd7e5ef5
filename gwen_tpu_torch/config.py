"""Typed configuration system: a copy of ``gwen_tpu.config`` (plain
dataclasses), so both packages read the same config files and overrides.

The reference keeps a single flat JSON file (``src/gwen/config.json:2-17``,
loaded by ``loggers_configs.py:62-66`` via pyprojroot) with keys::

    batch_size, coarsen, data_path, data_test, data_train, epochs,
    filename_regex, hidden_feats, lr, mask_threshold, member_split,
    retrain, seed, simplify, zarr_path, zlib_compression_level

and no CLI (the argparse interface described in ``train_gnn.py:26-38``'s
docstring does not exist). Here we provide typed, nested dataclasses with

* JSON round-tripping (``load`` / ``save``),
* compatibility with the reference's flat key set (``from_flat``),
* dotted-path CLI overrides (``apply_overrides``: ``train.lr=3e-4``).
"""

from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any, Mapping, Sequence


@dataclass
class DataConfig:
    """Dataset locations, ingestion and preprocessing knobs."""

    # Raw ICON NetCDF run folders (reference: config.json "data_path").
    data_path: str = "data/straka"
    # Consolidated zarr archive path (reference: "zarr_path" + "data_combined.zarr").
    zarr_path: str = "data/data_combined.zarr"
    # Preprocessed train/test stores (reference: "data_train"/"data_test").
    data_train: str = "data/data_train.zarr"
    data_test: str = "data/data_test.zarr"
    # Regex matching per-member NetCDF files; group(1) = member id
    # (reference: config.json "filename_regex", create_zarr_archive.py:21-23).
    filename_regex: str = r"atmcirc-straka_93_(.+)_DOM01_ML_.*\.nc"
    # Variable of interest (reference hardcodes theta_v, preprocess_data.py:119).
    variable: str = "theta_v"
    # Spatial coarsening factor (reference: "coarsen", utils.py:355-379).
    coarsen: int = 1
    # Train fraction of the time axis (reference: 70/30, preprocess_data.py:26-66).
    train_fraction: float = 0.7
    # Normalization: "mean-std" or "median-mad" (preprocess_data.py:69-111).
    normalization: str = "mean-std"
    # Boundary cells to drop: keep ncells >= this index (preprocess_data.py:124).
    boundary_cells: int = 2632
    # Zarr chunking along time (reference: 32, preprocess_data.py:161-187).
    time_chunk: int = 32
    # Zlib/gzip level for zarr chunks (reference: "zlib_compression_level").
    zlib_compression_level: int = 1
    # Path where normalization scale factors are persisted
    # (reference: data/scaling.txt, preprocess_data.py:103-104).
    scaling_path: str = "data/scaling.json"
    # Stream time steps from the store instead of loading it into host RAM
    # (reference stays lazy via dask, utils.py:478-520): host memory scales
    # with the per-step slab + a small LRU, not the archive size.
    lazy: bool = False


@dataclass
class GraphConfig:
    """Graph construction over ensemble members and/or the spatial mesh."""

    # "complete" (reference: erdos_renyi_graph(p=1), utils.py:176), "erdos-renyi",
    # "icosahedron", "grid".
    kind: str = "complete"
    # Edge probability for erdos-renyi graphs.
    edge_prob: float = 1.0
    # Refinement level for icosahedral meshes.
    refine: int = 3
    # Add self loops with GCN normalization (standard GCN; the reference's
    # GCNConv defaults to add_self_loops=True).
    self_loops: bool = True
    # Aggregation backend: "auto", "dense", "segment", "pallas".
    backend: str = "auto"
    # GraphCast (model.architecture "graphcast"): the latitude-longitude
    # grid, poles included, and the grid2mesh radius as a share of the
    # longest edge of the finest mesh (``refine`` is the multimesh's
    # finest level).
    grid_lat: int = 721
    grid_lon: int = 1440
    g2m_radius: float = 0.6
    # GenCast (model.architecture "gencast"): the transformer attends over
    # each mesh node's neighbours within this many edges of the level-
    # ``refine`` mesh.
    k_hop: int = 16


@dataclass
class GNNModelConfig:
    """Encode-process-decode GCN stack.

    Reference width schedule (models_gnn.py:106-206): channels_in -> h -> h/2 ->
    h/4 -> h/2 -> h -> channels_out with ReLU between layers (conv4/conv5 and
    upconv1/upconv2 exist but are commented out of forward, models_gnn.py:150-151,
    202-203, so the active stack is 6 GCNConv layers).
    """

    hidden_feats: int = 1024  # reference: config.json:9
    # Depth of the down/up stacks actually used in the reference forward.
    down_layers: int = 3
    up_layers: int = 3
    # Optional encode-process-decode variant (mesh-scale models).
    # "gcn-stack" | "encode-process-decode" | "graphcast" | "gencast"
    architecture: str = "gcn-stack"
    latent_size: int = 256
    process_steps: int = 4
    mlp_layers: int = 2
    residual: bool = True
    param_dtype: str = "float32"
    compute_dtype: str = "bfloat16"
    # Processor family for encode-process-decode: "gcn" (normalized
    # adjacency), "interaction" (edge-MLP messages), or "attention"
    # (windowed graph attention over the diag-window layout).
    processor: str = "gcn"
    attn_heads: int = 2
    # Lane-pack attention head pairs in the fused kernels: "auto" (pack
    # when heads is even and latent/heads ≤ 64), "on", or "off".
    attn_pack: str = "auto"
    # GraphCast's inputs and outputs per grid node (its processor layers
    # are ``process_steps``, its latent and hidden width ``latent_size``).
    channels_in: int = 474
    channels_out: int = 227
    # GenCast's feed-forward width (its transformer layers are
    # ``process_steps``, its heads ``attn_heads``).
    ffn_size: int = 2048


@dataclass
class UNetModelConfig:
    """UNet CNN baseline (reference models_cnn.py:86-460)."""

    channels_in: int = 124
    channels_out: int = 1
    hidden: int = 64
    depth: int = 4


@dataclass
class TrainConfig:
    batch_size: int = 21  # reference: models_gnn.py:54 (member-nodes per batch)
    # Reference NeighborLoader semantics: restrict the loss to a random
    # subset of member-nodes per step (0 = off; time-batching is the default
    # TPU-friendly scheme).
    node_batch_size: int = 0
    epochs: int = 1  # reference: config.json:7
    lr: float = 1e-5  # reference base LR, config.json:10 (GNN uses lr*10)
    lr_multiplier: float = 10.0  # train_gnn.py:111
    weight_decay: float = 0.0
    seed: int = 42  # reference: config.json "seed"
    member_split: int = 124  # input members; rest are targets (config.json:12)
    mask_threshold: float = 0.0  # variance mask threshold (train_gnn.py:88-96)
    retrain: bool = True  # config.json "retrain"
    simplify: bool = False  # 1-in/1-out member mode (utils.py:92-100)
    loss: str = "l1-masked"  # "l1-masked" | "crps" | "ensemble-var-reg"
    var_reg_alpha: float = 0.1  # loss_functions.py:95
    # Mesh-task options: rollout-horizon training, CRPS-ensemble training,
    # perturbation amplitude (with optional validation calibration).
    rollout_horizon: int = 1
    crps_members: int = 4
    sigma: float = 0.05
    calibrate_sigma: bool = False
    # Multiplicative ensemble inflation (spread fix for under-dispersive
    # ensembles): fixed factor, or closed-form calibration on a validation
    # ensemble (spread scales linearly; factor = target_ratio / ratio).
    inflation: float = 1.0
    calibrate_inflation: bool = False
    # LR schedule (reference's CyclicLR is disabled with a DDP bug note,
    # train_gnn.py:112-119; these are pure step functions and just work).
    scheduler: str = "none"  # "none" | "cosine" | "cyclic"
    warmup_steps: int = 0
    cycle_steps: int = 2000
    grad_clip: float = 0.0
    # Checkpointing (extension; reference only logs the best epoch to MLflow).
    checkpoint_every: int = 0  # steps; 0 = per-epoch best only
    max_checkpoints: int = 3
    log_every: int = 10
    # Checkpoint (remat) the processor stack: false | true (full per-step
    # recompute) | "save_agg" (checkpoint aggregation outputs; the backward
    # never re-runs the sparse kernel — the right default at L8+) |
    # "save_agg:K" (save aggs for only the first K steps — the middle
    # ground when all-steps save_agg overflows HBM; pick K with
    # gwen_tpu_torch.train.remat.select_save_agg_steps).
    remat: "bool | str" = False


@dataclass
class MeshParallelConfig:
    """Device-mesh axes: data parallelism over ensemble members/batch plus
    edge-partitioned graph parallelism over the spatial mesh (SURVEY §2.3)."""

    data_axis: int = 1  # number of data-parallel shards ("member" axis)
    graph_axis: int = 1  # number of graph partitions ("graph" axis)
    axis_names: tuple[str, str] = ("data", "graph")
    # Run the partitioned (shard_map + halo) path even with graph_axis == 1:
    # exercises the Pallas local kernels inside shard_map on a single chip —
    # exactly the multi-chip compute path, with a degenerate halo exchange.
    force_partition: bool = False
    # Local-aggregation layout per partition: "sliding" (v4 flagship),
    # "dense" (v3 streamed-S), or "ell" (v1 compact).
    partition_layout: str = "sliding"
    # Build the (large) stacked scatter matrices on device from O(edges)
    # tables instead of shipping them over the host->device link.
    device_build: bool = True
    # Single-chip aggregation kernel: "auto" picks the diagonal-window (v6)
    # layout when vertex positions are available (KD-patch ordering;
    # fastest measured at L7-L9), falling back to sliding/packed by S size.
    # Explicit values: "diag" | "diag_packed" (1-bit S01 + rank-1 scales —
    # exact for GCN norm, ~16x less S bandwidth; GCN processor only) |
    # "sliding" | "packed" | "segment".
    kernel: str = "auto"
    # Streamed window width for the diag layout (rounded up to the block
    # multiple; ~2% of edges escape at 384 on KD-ordered icospheres).
    diag_window: int = 384


@dataclass
class RunConfig:
    """Experiment tracking (replaces MLflow usage, loggers_configs.py:69-99)."""

    experiment: str = "GWEN"
    registry_root: str = "runs"
    run_name: str = ""


@dataclass
class GwenConfig:
    data: DataConfig = field(default_factory=DataConfig)
    graph: GraphConfig = field(default_factory=GraphConfig)
    model: GNNModelConfig = field(default_factory=GNNModelConfig)
    unet: UNetModelConfig = field(default_factory=UNetModelConfig)
    train: TrainConfig = field(default_factory=TrainConfig)
    mesh: MeshParallelConfig = field(default_factory=MeshParallelConfig)
    run: RunConfig = field(default_factory=RunConfig)

    # ---------------------------------------------------------------- io
    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    def save(self, path: str | Path) -> None:
        Path(path).write_text(json.dumps(self.to_dict(), indent=2, default=str))

    @classmethod
    def from_dict(cls, d: Mapping[str, Any]) -> "GwenConfig":
        cfg = cls()
        for section_name, section_val in d.items():
            if not hasattr(cfg, section_name):
                raise KeyError(f"Unknown config section: {section_name!r}")
            section = getattr(cfg, section_name)
            if dataclasses.is_dataclass(section) and isinstance(section_val, Mapping):
                names = {f.name for f in dataclasses.fields(section)}
                for k, v in section_val.items():
                    if k not in names:
                        raise KeyError(f"Unknown key {section_name}.{k}")
                    setattr(section, k, _coerce(
                        getattr(section, k), v, _field_allows_str(section, k)
                    ))
            else:
                setattr(cfg, section_name, section_val)
        return cfg

    @classmethod
    def load(cls, path: str | Path) -> "GwenConfig":
        d = json.loads(Path(path).read_text())
        if _looks_flat(d):
            return cls.from_flat(d)
        return cls.from_dict(d)

    # ------------------------------------------------- reference compat
    #: flat reference key -> dotted path in this config
    _FLAT_MAP = {
        "batch_size": "train.batch_size",
        "coarsen": "data.coarsen",
        "data_path": "data.data_path",
        "data_test": "data.data_test",
        "data_train": "data.data_train",
        "epochs": "train.epochs",
        "filename_regex": "data.filename_regex",
        "hidden_feats": "model.hidden_feats",
        "lr": "train.lr",
        "mask_threshold": "train.mask_threshold",
        "member_split": "train.member_split",
        "retrain": "train.retrain",
        "seed": "train.seed",
        "simplify": "train.simplify",
        "zarr_path": "data.zarr_path",
        "zlib_compression_level": "data.zlib_compression_level",
    }

    @classmethod
    def from_flat(cls, flat: Mapping[str, Any]) -> "GwenConfig":
        """Load a reference-style flat config.json (src/gwen/config.json)."""
        cfg = cls()
        for key, value in flat.items():
            path = cls._FLAT_MAP.get(key)
            if path is None:
                raise KeyError(f"Unknown reference config key: {key!r}")
            _set_dotted(cfg, path, value)
        return cfg

    # ----------------------------------------------------- cli overrides
    def apply_overrides(self, overrides: Sequence[str]) -> "GwenConfig":
        """Apply ``section.key=value`` CLI overrides in place."""
        for item in overrides:
            if "=" not in item:
                raise ValueError(f"Override must be key=value, got {item!r}")
            path, raw = item.split("=", 1)
            _set_dotted(self, path.strip(), _parse_literal(raw.strip()))
        return self


def _looks_flat(d: Mapping[str, Any]) -> bool:
    return bool(d) and not any(isinstance(v, Mapping) for v in d.values())


def _parse_literal(raw: str) -> Any:
    try:
        return json.loads(raw)
    except json.JSONDecodeError:
        return raw


def _field_allows_str(obj: Any, name: str) -> bool:
    """True iff the declared dataclass annotation of ``obj.name`` admits
    ``str`` (e.g. the union-typed ``train.remat: bool | str``)."""
    fields = getattr(type(obj), "__dataclass_fields__", None)
    if not fields or name not in fields:
        return True  # not a dataclass field — don't over-restrict
    ann = fields[name].type
    ann = ann if isinstance(ann, str) else str(ann)
    return "str" in ann


def _coerce(current: Any, value: Any, allows_str: bool = False) -> Any:
    """Coerce ``value`` to the type of the existing field value."""
    if isinstance(current, bool):
        if isinstance(value, str):
            if value.lower() in ("1", "true", "yes"):
                return True
            if value.lower() in ("0", "false", "no"):
                return False
            # String-valued modes are legal only on union-annotated fields
            # (e.g. ``train.remat: bool | str = False`` accepts "save_agg");
            # on a plain bool field a stray string (train.retrain=ture) must
            # fail loudly, not become a silently-truthy string.
            if allows_str:
                return value
            raise ValueError(
                f"Expected a boolean, got {value!r} (bool fields accept "
                "true/false/1/0/yes/no)"
            )
        return bool(value)
    if isinstance(current, int) and not isinstance(value, bool):
        return int(value)
    if isinstance(current, float):
        return float(value)
    if isinstance(current, tuple) and isinstance(value, (list, tuple)):
        return tuple(value)
    return value


def _set_dotted(cfg: GwenConfig, path: str, value: Any) -> None:
    parts = path.split(".")
    obj: Any = cfg
    for p in parts[:-1]:
        if not hasattr(obj, p):
            raise KeyError(f"Unknown config path: {path!r}")
        obj = getattr(obj, p)
    leaf = parts[-1]
    if not hasattr(obj, leaf):
        raise KeyError(f"Unknown config path: {path!r}")
    setattr(obj, leaf, _coerce(
        getattr(obj, leaf), value, _field_allows_str(obj, leaf)
    ))


def load_config(path: str | Path | None = None) -> GwenConfig:
    """Load the project config.

    Reference parity: ``load_config()`` (loggers_configs.py:62-66) reads
    ``src/gwen/config.json`` from the repo root. Here: explicit path, or
    ``config.json`` in the CWD if present, else defaults.
    """
    if path is not None:
        return GwenConfig.load(path)
    p = Path("config.json")
    if p.exists():
        return GwenConfig.load(p)
    return GwenConfig()
