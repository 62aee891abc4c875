"""Configuration dataclasses of the PyTorch port.

A copy of the JAX package's `config.py`, so that the two packages read the
same fields with the same defaults. One default differs:
`EvalConfig.round_segments` is 1 here (5 in JAX): segmented rounds give
the monolithic round's masks and exist to hide a slow device-to-host
link, which the card's PCIe link is not; the port runs both.

Object count, frame count and spatial dims are padded to fixed buckets, as
in the JAX package, so that buffers keep their shapes across sequences.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """Model dims (SURVEY.md §3.2)."""

    # Backbone: resnet stage depths. (3, 4, 23, 3) == ResNet-101 (reference
    # backbone); (1, 1, 1, 1) is the tiny variant used by the tests.
    backbone_depths: Tuple[int, ...] = (3, 4, 23, 3)
    backbone_width: int = 64
    output_stride: int = 16          # dilated stage-4, DeepLabV3+ standard
    aspp_channels: int = 256
    # 128 (not DeepLab's 256): the object-folded decoder heads replicate
    # these activations per object.
    decoder_channels: int = 128
    low_level_channels: int = 48     # DeepLabV3+ low-level projection
    embedding_dim: int = 100         # pixel-embedding dim (ref uses ~100-d)
    # Kernel-facing embedding dim: embeddings are zero-padded so the
    # matching kernels see aligned rows (zeros add 0 to every distance).
    embedding_dim_padded: int = 128
    feature_stride: int = 4          # final feature map stride (FEELVOS lineage)
    head_channels: int = 128
    ma_channels: int = 128           # interaction-feature / memory channels
    # backbone/encoder norm and decoder-head norm: "gn" | "bn" | "syncbn"
    # | "ln" | "frozen" (models/layers.make_norm)
    norm: str = "gn"
    head_norm: str = "gn"
    gn_groups: int = 32
    dtype: str = "bfloat16"          # activations; params stay float32

    # Matching (SURVEY.md C3/C4)
    local_window: int = 15           # max displacement at matching resolution
    local_downsample: int = 2        # downsample factor for local matching
    max_objects: int = 8             # padded object bucket, EXCLUDING background
    # Distances >= this are "wrong label" sentinels
    # (ref:networks/IntVOS.py WRONG_LABEL_PADDING_DISTANCE, expected).
    wrong_label_padding_distance: float = 1e8

    def __post_init__(self):
        # The DeepLabV3+ decoder output is architecturally stride-4; every
        # engine sizes its state grids at H/4 x W/4 while scribble
        # downsampling reads this field.
        if self.feature_stride != 4:
            raise ValueError(
                f"feature_stride={self.feature_stride}: the decoder is "
                "architecturally stride-4; this knob documents the "
                "constant, it cannot retune the architecture")


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    """Training hyperparams (SURVEY.md C17/C18), read by
    `engine/train_stage1.py` and `engine/train_stage2.py`."""

    crop_size: Tuple[int, int] = (416, 416)
    batch_size: int = 8
    total_steps: int = 100_000
    base_lr: float = 7e-3
    backbone_lr_scale: float = 0.1
    momentum: float = 0.9
    weight_decay: float = 1e-4
    poly_power: float = 0.9
    bootstrap_ratio: float = 0.25
    bootstrap_warmup_steps: int = 20_000
    seed: int = 0
    remat: bool = True
    remat_chunk: int = 6
    stage2_rounds: int = 3
    stage2_gmap_memory: bool = False
    log_every: int = 50
    checkpoint_every: int = 2000


@dataclasses.dataclass(frozen=True)
class EvalConfig:
    """DAVIS interactive protocol parameters (SURVEY.md §1, C20)."""

    image_size: Tuple[int, int] = (480, 854)   # DAVIS 480p
    # Features are computed on the image padded to a stride-multiple.
    pad_to: int = 16
    max_interactions: int = 8
    scribble_sets: int = 3
    # Per-(sequence x scribble-set) wall-clock budget in seconds, scaled by
    # the sequence's object count (davisinteractive `max_time`).
    max_time: float | None = None
    metric_at_seconds: float = 60.0            # J&F @ 60 s report point
    max_frames: int = 104                      # largest frame bucket
    # Padded frame-axis buckets: a sequence runs in the smallest bucket
    # that fits. Each bucket must divide by the 8-frame encoder chunk (or
    # be < 8).
    frame_buckets: Tuple[int, ...] = (16, 32, 64, 104)
    # "min_fused": per-frame elementwise-min global-map memory (MANet
    # semantics, SURVEY.md C8). "stacked": matching against the annotated
    # pixels of every stored round (max_interactions slots; the live ones
    # are matched), the mode context-parallel eval shards.
    matching_memory: str = "min_fused"
    # Leaky min-fusion: before each round the stored global-map minima
    # relax toward 1.0 by this fraction (d -> 1 - (1 - d)(1 - refresh));
    # 0.0 = reference semantics.
    gmap_refresh: float = 0.0
    # Mask readback stride: probabilities are bilinearly upsampled to
    # image_resolution/mask_stride, argmaxed, and the label map is
    # nearest-expanded on the host. 1 = exact full-resolution argmax.
    mask_stride: int = 1
    # Number of spans the propagation sweep is split into (geometrically
    # growing); each span's packed masks download while the next computes.
    # 1 = the monolithic round. Both give the same masks.
    round_segments: int = 1


@dataclasses.dataclass(frozen=True)
class MeshConfig:
    """Device-mesh layout. The engines take a `parallel.mesh.Mesh` as
    `cp_mesh` (context-parallel serving: `create_mesh(data, context,
    devices)`); no entry point reads these fields yet, and multi-process
    data-parallel training is not ported. The dataclass keeps the JAX
    package's fields."""

    data_axis: str = "data"
    context_axis: str = "context"
    data_parallel: int = 1
    context_parallel: int = 1


@dataclasses.dataclass(frozen=True)
class Config:
    model: ModelConfig = ModelConfig()
    train: TrainConfig = TrainConfig()
    eval: EvalConfig = EvalConfig()
    mesh: MeshConfig = MeshConfig()
    davis_root: str = "/data/DAVIS"
    snapshot_dir: str = "snapshots"


BATCH_STAT_NORMS = ("bn", "syncbn")


def check_params_only(model_cfg: ModelConfig, path: str) -> None:
    """Raise for a model whose norms need batch statistics ('bn',
    'syncbn') on a path that JAX runs with the model's `params` alone (the
    Evaluator, the streaming and batch engines, export, the trainers):
    there Flax's BatchNorm has no `batch_stats` collection to read or
    update, so the JAX path cannot run it and the port refuses it too."""
    bad = {k: v for k, v in (("norm", model_cfg.norm),
                             ("head_norm", model_cfg.head_norm))
           if v in BATCH_STAT_NORMS}
    if bad:
        raise ValueError(
            f"{path} does not run BatchNorm "
            f"({', '.join(f'{k}={v!r}' for k, v in bad.items())}): the JAX "
            f"package's {path} applies the model with its `params` only, "
            f"without the `batch_stats` that BatchNorm's batch statistics "
            f"need; use 'gn', 'ln' or 'frozen'")


def tiny_test_config() -> Config:
    """Small everything — CPU-runnable in tests (BASELINE config 1)."""
    return Config(
        model=ModelConfig(
            backbone_depths=(1, 1, 1, 1),
            backbone_width=16,
            aspp_channels=32,
            decoder_channels=32,
            low_level_channels=8,
            embedding_dim=16,
            embedding_dim_padded=16,
            head_channels=32,
            ma_channels=32,
            gn_groups=4,
            local_window=2,
            local_downsample=1,
            max_objects=2,
            dtype="float32",
        ),
        train=TrainConfig(crop_size=(32, 32), batch_size=2, total_steps=10),
        eval=EvalConfig(image_size=(32, 48), max_frames=4),
    )
