"""Load the JAX package's parameters into the port.

The port packs the same layout as the JAX package, so its buffers are the
JAX buffers byte for byte: converting is a copy with a dtype mapping and no
reshuffle.  The JAX params arrive as numpy arrays (for example
``jax.tree_util.tree_map(np.asarray, params)``); JAX's bfloat16 arrays reach
numpy as ``ml_dtypes.bfloat16``, which ``torch.from_numpy`` refuses, so they
go through a ``uint16`` view.
"""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

from .config import ModelConfig
from .models.embedding import PackedTables, plan_tensors
from .models.fleetrec import FleetRecModel, ModelPlan


def tensor_from_numpy(arr: np.ndarray, device="cpu") -> torch.Tensor:
    """numpy array (float32, int8 or ml_dtypes bfloat16) -> torch tensor on
    ``device``, bit for bit (a copy: JAX's host arrays are read-only)."""
    arr = np.array(arr, order="C")
    if arr.dtype.name == "bfloat16":
        return torch.from_numpy(arr.view(np.uint16)).view(torch.bfloat16).to(device)
    return torch.from_numpy(arr).to(device)


def params_from_jax(cfg: ModelConfig, params_np: Mapping, device="cpu") -> FleetRecModel:
    """The JAX package's ``(model, params)`` for ``cfg`` -> the port's
    FleetRecModel on ``device``.

    params_np: ``{"tables": PackedTables, "mlp": [...]}`` as the JAX
    ``init_model`` returns it, with numpy leaves.  The JAX PackedTables is
    read by its fields (onehot_buffers, take_buffer, onehot_scales,
    take_scales); its class is not imported."""
    plan = ModelPlan.create(cfg)
    lay = plan.layout
    tables = params_np["tables"]
    onehot = [tensor_from_numpy(b, device) for b in tables.onehot_buffers]
    take, oh_scales, take_scales = (tables.take_buffer, tables.onehot_scales,
                                    tables.take_scales)
    if len(onehot) != len(lay.onehot_classes):
        raise ValueError(f"{len(onehot)} class buffers for "
                         f"{len(lay.onehot_classes)} classes")
    for c, b in zip(lay.onehot_classes, onehot):
        if b.numel() != c.num_tables * c.rows_pad * c.dim:
            raise ValueError(f"class buffer {tuple(b.shape)} does not match {c}")
    if (take is None) != (lay.take_phys_total == 0):
        raise ValueError("take buffer presence does not match the layout")
    if take is not None and tuple(take.shape) != (lay.take_phys_total, lay.take_lanes):
        raise ValueError(f"take buffer {tuple(take.shape)} does not match the layout")
    packed = PackedTables(
        layout=lay,
        onehot_buffers=onehot,
        take_buffer=None if take is None else tensor_from_numpy(take, device),
        plan=plan_tensors(lay, device),
        # JAX keeps class scales as [n, 1, 1]; the port as [n]
        onehot_scales=(None if oh_scales is None else
                       [tensor_from_numpy(s, device).reshape(-1) for s in oh_scales]),
        take_scales=(None if take_scales is None else
                     tensor_from_numpy(take_scales, device)),
    )
    mlp = [tensor_from_numpy(w, device) for w in params_np["mlp"]]
    return FleetRecModel(plan, packed, mlp)
