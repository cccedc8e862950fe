"""gnnome_tpu_torch — the PyTorch/CUDA port of gnnome_tpu.

GatedGCN edge scoring of assembly graphs, full-graph training of the model
and greedy contig decoding, with the JAX package's Pallas kernels replaced
by hand-written CUDA kernels for Hopper (``csrc/``). Imports no JAX and nothing of ``gnnome_tpu``; entry
points run on ``cuda`` unless the caller passes ``device="cpu"``.
"""
from gnnome_tpu_torch.config import (
    Config,
    DataConfig,
    DecodeConfig,
    ModelConfig,
    SplitConfig,
    TrainConfig,
)

__version__ = "0.1.0"

__all__ = [
    "Config", "ModelConfig", "TrainConfig", "DecodeConfig", "DataConfig",
    "SplitConfig",
]
