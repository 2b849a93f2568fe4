"""FleetRec on PyTorch + CUDA: the port of ``fleetrec_tpu`` (JAX on a TPU)
to one NVIDIA H100.

Index-mode scoring and serving on one device: config-order ids and dense
features go through the packed-table lookup (the hand-written row-gather
kernel, ``ops/csrc/gather_rows.cu``) and the bias-free MLP tower (the
fused-MLP kernel, ``ops/csrc/fused_mlp.cu``) to [B] scores, served over the
native ingest tier; feature mode serves the tower alone.  ``io.py`` reads
and writes the JAX package's npz checkpoints, and the CLI's ``bench``,
``gatherbench`` (with the grouped gather kernel,
``ops/csrc/gather_grouped.cu``), ``autotune``, ``servebench``,
``netbench`` and ``export`` measure the port on the card.  The package
imports torch and never jax or ``fleetrec_tpu``; its tests hold it equal
to the JAX package.
"""

from . import config, reference
from .config import CONFIGS, MLPSpec, ModelConfig, TableSpec, get_config
from .models import FleetRecModel, init_model

__version__ = "0.1.0"
