"""Typed configuration (replaces the reference's edit-the-source dicts in
``hyperparameters.py:3-34`` and ``config.py:16-27``).

Defaults reproduce the reference hyperparameters exactly. Configs are plain
dataclasses: constructible from code, kwargs, or a JSON file — no global
mutable state.
"""
from __future__ import annotations

import dataclasses
import json
from typing import Dict, Optional


@dataclasses.dataclass
class ModelConfig:
    # hyperparameters.py:8-14
    node_features: int = 1  # kept for API parity; unused by the live model
    edge_features: int = 2
    hidden_features: int = 256  # 'dim_latent'
    hidden_edge_features: int = 16
    hidden_edge_scores: int = 64
    num_gnn_layers: int = 16
    nb_pos_enc: int = 16
    batch_norm: bool = True  # hyperparameters.py:26


@dataclasses.dataclass
class TrainConfig:
    # hyperparameters.py:5-7,15-25
    seed: int = 0
    lr: float = 1e-3
    num_epochs: int = 100
    patience: int = 2
    decay: float = 0.95  # ReduceLROnPlateau factor
    # Graph-scale regime: number of cluster partitions for minibatch
    # training (METIS-equivalent; train.py:291-293). <=1 means full-graph.
    num_parts_train: int = 500
    num_parts_eval: int = 500
    batch_size_train: int = 50
    batch_size_eval: int = 50
    # Reference draws a fresh METIS part count per graph per epoch in
    # [num_parts-100, num_parts+100) (train.py:291); 0 disables the jitter.
    cluster_jitter: int = 100
    # Validate under the same cluster-minibatch regime as the reference
    # (train.py:428-486). Default False = full-graph validation: forward-only
    # full graphs fit TPU HBM, and full-graph eval metrics are exact rather
    # than averaged over induced subgraphs (a deliberate regime difference,
    # flag-controlled for parity runs).
    cluster_validation: bool = False
    # TPU-specific
    backend: Optional[str] = None  # segment-op backend: None=auto/'xla'/'pallas'
    compute_dtype: str = "float32"  # 'float32' | 'bfloat16'
    remat: str = "layer"  # 'none' | 'layer' | 'group' | 'unroll_group'
    remat_group: int = 4
    # paired wide-row endpoint gathers: 'auto' enables them at scales
    # where they win (PERFORMANCE.md), with remat_group narrowed to fit
    # the doubled gather rows in HBM; also False | True | 'src'
    wide_gathers: object = "auto"
    checkpoint_dir: str = "checkpoints"
    pretrained_dir: str = "pretrained"
    resume: bool = True  # actually wired in, unlike train.py:61-93


@dataclasses.dataclass
class DecodeConfig:
    # hyperparameters.py:19-20
    num_decoding_paths: int = 50
    len_threshold: int = 20
    # Confidence floor on walked edges: seeds are sampled only among
    # edges at or above it, and walks stop when the next edge's sigmoid
    # probability falls below it. 0.0 = reference semantics
    # (inference.py:31-77 extends while ANY unvisited successor exists,
    # seeds ∝ prob over all alive edges). The hard-benchmark post-mortem
    # (docs/FLAGSHIP.md) found 11/17 misassembly breaks were walked at
    # prob<=0.5 — this is the decoder lever that trades contig length
    # for fewer misassemblies.
    min_prob: float = 0.0
    # The SAME confidence-floor lever for the non-learned baseline
    # decoders (overlap_length / overlap_similarity controls,
    # inference.py:280-401): their scores are raw features, so a sigmoid
    # floor saturates (sigmoid(6000) == 1.0) — instead the floor is the
    # q-th quantile of the feature over the graph's real edges, passed to
    # the walkers as a raw-score floor (decode/greedy.get_contigs
    # min_score). 0.0 = reference semantics. Fair-comparison protocol
    # (docs/FLAGSHIP.md): select min_prob AND this quantile on the
    # VALIDATION graph, then report the test graph once.
    baseline_min_quantile: float = 0.0


@dataclasses.dataclass
class DataConfig:
    # pipeline.py:195-199 / graph_dataset.py:96-102
    threads: int = 32
    identity_filter: float = 0.99
    kmer: int = 29
    window: int = 9
    coverage: float = 32.4  # pipeline.py:167-168
    nb_pos_enc: int = 16


@dataclasses.dataclass
class SplitConfig:
    """Train/valid/test chromosome counts (config.py:16-18). '_r' suffix
    selects real data, as in the reference."""

    train: Dict[str, int] = dataclasses.field(default_factory=lambda: {"chr19": 5})
    valid: Dict[str, int] = dataclasses.field(default_factory=lambda: {"chr19": 2})
    test: Dict[str, int] = dataclasses.field(default_factory=lambda: {"chr21": 1})


@dataclasses.dataclass
class Config:
    model: ModelConfig = dataclasses.field(default_factory=ModelConfig)
    train: TrainConfig = dataclasses.field(default_factory=TrainConfig)
    decode: DecodeConfig = dataclasses.field(default_factory=DecodeConfig)
    data: DataConfig = dataclasses.field(default_factory=DataConfig)
    split: SplitConfig = dataclasses.field(default_factory=SplitConfig)

    @classmethod
    def from_json(cls, path: str) -> "Config":
        with open(path) as f:
            raw = json.load(f)
        return cls(
            model=ModelConfig(**raw.get("model", {})),
            train=TrainConfig(**raw.get("train", {})),
            decode=DecodeConfig(**raw.get("decode", {})),
            data=DataConfig(**raw.get("data", {})),
            split=SplitConfig(**raw.get("split", {})),
        )

    def to_json(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(dataclasses.asdict(self), f, indent=2)
