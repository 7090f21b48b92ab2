"""Training and data configuration (the port's own copy of the JAX
package's ``configs/train.py``: ``TrainConfig`` and ``DataConfig``).
Defaults reproduce the reference operating point."""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    # Optimizer
    learning_rate: float = 1e-5
    min_learning_rate: float = 5e-8
    weight_decay: float = 0.1
    adam_beta1: float = 0.9
    adam_beta2: float = 0.999
    adam_epsilon: float = 1e-8
    lr_decay_ratio: float = 1.0
    warmup_steps: int = 100
    warmup_ratio: float = 0.1
    scheduler_type: str = "polynomial"  # polynomial | cosine | linear | constant
    total_steps: int = 2_232_142

    # KD losses
    kd: bool = True
    hybrid_training: bool = True
    noise_offset: float = 0.5
    cfg_dropout: float = 0.1
    feature_loss_weight: float = 0.1

    # Runtime
    text_encoder: str = "chinese_clip"
    batch_size_per_device: int = 10
    # >1: split each step's batch into this many micro-batches and sum their
    # fp32 gradients before the one optimizer update (peak activation
    # memory is one micro-batch's); the batch must divide evenly
    grad_accum_steps: int = 1
    dtype: str = "bfloat16"
    seed: int = 42

    # Checkpointing
    every_n_steps: int = 5000
    save_top_k: int = 3
    output_dir: str = "./checkpoints"
    load_ckpt_path: Optional[str] = None
    load_ckpt_step: Optional[int] = None

    # Parallelism: mesh axes (data, fsdp) over the process group's ranks
    # (parallel/mesh.py). fsdp=1 replicates the frozen UNet; >1 shards the
    # frozen weights (FSDP2) for memory headroom.
    mesh_shape: Tuple[int, int] = (-1, 1)  # -1 = all remaining ranks
    log_every_n_steps: int = 100


@dataclasses.dataclass(frozen=True)
class DataConfig:
    # webdataset-format shard urls, `::`-separated groups with brace ranges
    urls: Tuple[str, ...] = ()
    # decode + preprocess thread-pool width (data/pipeline.py::parallel_map)
    num_workers: int = 2
    batch_size: int = 10
    resolution: int = 512
    center_crop: bool = False
    # True: 9-bucket aspect batching (SDXL); False: fixed square `resolution`
    # (SD1.5)
    bucketing: bool = True
    shuffle_shards: bool = True
    resample_shards: bool = False
    train_split: float = 1.0
    val_split: float = 0.0
    test_split: float = 0.0
    shuffle_buffer: int = 1000
    # quality filters (data/captions.py::passes_quality)
    min_area: int = 640 * 640
    min_aesthetic: float = 6.0
    max_watermark: float = 0.5
