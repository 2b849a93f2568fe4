"""FleetRec on PyTorch + CUDA: the port of ``fleetrec_tpu`` (JAX on a TPU)
to one NVIDIA H100.

Index-mode scoring and serving on one device: config-order ids and dense
features go through the packed-table lookup (the hand-written fused lookup
kernel, ``ops/csrc/lookup_fused.cu``), an optional interaction head (DLRM's
pairwise dots with its bottom tower, or DCNv2's cross layers) and the
bias-free MLP tower (the fused-MLP kernel, ``ops/csrc/fused_mlp.cu``) to [B]
scores, served over the native ingest tier; feature mode serves the tower
alone.  ``parallel/`` serves the same forward over a (data, model) mesh of
``torch.distributed`` ranks, one device a rank: tables sharded over the
model axis, one all_reduce a forward (``serve --mesh``); its planner says
on how many cards a config fits (``cli plan``) and ``benchmarks/`` times
the collectives (``cli icibench``).  ``models/biginit.py`` generates pm1
tables on the card, a rank's window at a time, so criteo_terabyte at its
full cardinality is built with no table on the host.  ``models/train.py``
trains a model in place on one device (BCE,
Adagrad; the lookup's backward is a hand-written kernel too).  ``io.py`` reads
and writes the JAX package's npz checkpoints, and sharded checkpoints on
``torch.distributed.checkpoint`` that restore onto any mesh or one device
(``save_sharded`` / ``load_sharded``), and the CLI's ``bench``,
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
