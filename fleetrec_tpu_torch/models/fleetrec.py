"""The end-to-end model, the port of ``fleetrec_tpu/models/fleetrec.py``:
multi-table embedding lookup -> fixed-offset concat -> bias-free MLP ->
[B] scores, on one device.

``ModelPlan`` is the static half (the JAX package's frozen
``FleetRecModel``: layout, index permutation, QR plan).  ``FleetRecModel``
is an ``nn.Module`` that owns the packed tables and the MLP weights as
buffers (inference only) and runs the forward: ``plan_indices``,
``bad_take_rows``, ``lookup_concat`` (the gather kernel, once per tier),
``mlp_apply`` (the fused-MLP kernel) and the NaN poison.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence

import numpy as np
import torch
from torch import nn

from .. import reference as ref
from ..config import ModelConfig, qr_expand
from .embedding import (
    TORCH_DTYPES,
    PackedLayout,
    PackedTables,
    build_layout,
    index_columns,
    lookup_concat,
    pack_tables,
    take_bad_rows,
)
from .mlp import init_mlp_params, mlp_apply


@dataclasses.dataclass(frozen=True)
class ModelPlan:
    """Static model description: the packed layout, the spec->plan index
    column permutation, and the QR expansion (``spec_tables`` are the
    internal specs the layout is built over; ``qr_positions`` tell
    plan_indices how to derive the Q/R columns)."""

    cfg: ModelConfig
    layout: PackedLayout
    index_perm: tuple
    spec_tables: tuple = ()
    qr_positions: tuple = ()

    @classmethod
    def create(cls, cfg: ModelConfig) -> "ModelPlan":
        if cfg.interaction != "none":
            raise NotImplementedError(
                f"interaction={cfg.interaction!r}: the port runs the plain "
                f"concat -> MLP model only (ROADMAP.md queue 1, "
                f"'Interaction heads')")
        internal, qr_positions, sum_pairs = qr_expand(cfg)
        layout = build_layout(
            internal, cfg.feature_dim, cfg.dense_dim,
            onehot_max=cfg.onehot_max, take_lanes=cfg.take_lanes,
            take_stripes=cfg.take_stripes,
            onehot_factor_max=cfg.onehot_factor_max,
            onehot_r2=cfg.onehot_r2,
            sum_pairs=sum_pairs,
        )
        perm = tuple(int(p) for p in index_columns(layout, [t.table_id for t in internal]))
        return cls(cfg=cfg, layout=layout, index_perm=perm,
                   spec_tables=tuple(internal), qr_positions=qr_positions)


class FleetRecModel(nn.Module):
    """Scores [B] from config-order ids [B, num_tables] and dense features
    [B, dense_dim], on the device its buffers live on."""

    def __init__(self, plan: ModelPlan, packed: PackedTables,
                 mlp: Sequence[torch.Tensor]):
        super().__init__()
        self.plan = plan
        self.cfg = plan.cfg
        self.layout = plan.layout
        self._n_onehot = len(packed.onehot_buffers)
        self._n_mlp = len(mlp)
        self._quant = packed.onehot_scales is not None
        for i, b in enumerate(packed.onehot_buffers):
            self.register_buffer(f"onehot_{i}", b)
        self.register_buffer("take", packed.take_buffer)
        if self._quant:
            for i, s in enumerate(packed.onehot_scales):
                self.register_buffer(f"onehot_scale_{i}", s)
        self.register_buffer("take_scales", packed.take_scales)
        for k, v in packed.plan.items():
            self.register_buffer(f"plan_{k}", v)
        for i, w in enumerate(mlp):
            self.register_buffer(f"mlp_{i}", w)
        self.register_buffer("index_perm", torch.as_tensor(
            np.asarray(plan.index_perm, np.int64), device=packed.plan["feature_perm"].device))

    @property
    def device(self) -> torch.device:
        return self.index_perm.device

    @property
    def packed(self) -> PackedTables:
        """The packed tables as a PackedTables over this module's buffers."""
        n = self._n_onehot
        return PackedTables(
            layout=self.layout,
            onehot_buffers=[getattr(self, f"onehot_{i}") for i in range(n)],
            take_buffer=self.take,
            plan={k[5:]: v for k, v in self.named_buffers() if k.startswith("plan_")},
            onehot_scales=([getattr(self, f"onehot_scale_{i}") for i in range(n)]
                           if self._quant else None),
            take_scales=self.take_scales,
        )

    @property
    def mlp_weights(self) -> List[torch.Tensor]:
        return [getattr(self, f"mlp_{i}") for i in range(self._n_mlp)]

    def plan_indices(self, indices: torch.Tensor) -> torch.Tensor:
        """Config-order [B, num_tables] -> plan-order internal matrix: QR
        columns (q = id // rem in place, r = id % rem appended, floored as
        in jnp), then the spec->plan column permutation."""
        if self.plan.qr_positions:
            updated = indices.clone()
            extras = []
            for pos, rem in self.plan.qr_positions:
                col = indices[:, pos : pos + 1]
                extras.append(torch.remainder(col, rem))
                updated[:, pos : pos + 1] = torch.div(col, rem, rounding_mode="floor")
            indices = torch.cat([updated] + extras, dim=1)
        return indices.index_select(1, self.index_perm)

    def bad_take_rows(self, plan_indices: torch.Tensor) -> Optional[torch.Tensor]:
        """[B] bool (or None): rows whose take ids fall outside their
        table's [0, rows) range."""
        lay = self.layout
        if not lay.take_groups:
            return None
        n_oh = lay.n_onehot
        return take_bad_rows(plan_indices[:, n_oh : n_oh + lay.n_take],
                             self.plan_take_lim)

    @staticmethod
    def poison_scores(scores: torch.Tensor, bad: Optional[torch.Tensor]) -> torch.Tensor:
        if bad is None:
            return scores
        return scores.masked_fill(bad, float("nan"))

    def forward(self, indices: torch.Tensor,
                dense: Optional[torch.Tensor] = None) -> torch.Tensor:
        """indices: [B, num_tables] in config table order; dense:
        [B, dense_dim].  Returns scores [B] (float32).

        A take id outside its table's [0, rows) range, negative included,
        poisons its row's score with NaN, as in the JAX package."""
        cfg = self.cfg
        if indices.dim() != 2 or indices.shape[1] != cfg.num_tables:
            raise ValueError(
                f"indices must be [B, {cfg.num_tables}], got {tuple(indices.shape)}")
        if cfg.dense_dim:
            if dense is None or tuple(dense.shape) != (indices.shape[0], cfg.dense_dim):
                raise ValueError(
                    f"dense must be [{indices.shape[0]}, {cfg.dense_dim}], got "
                    f"{None if dense is None else tuple(dense.shape)}")
        indices = self.plan_indices(indices)
        bad = self.bad_take_rows(indices)
        feats = lookup_concat(self.packed, indices, dense)
        x = feats.to(TORCH_DTYPES[cfg.dtype])
        scores = mlp_apply(self.mlp_weights, x, activation=cfg.mlp.activation)
        return self.poison_scores(scores[:, 0], bad)


def init_model(
    cfg: ModelConfig,
    table_scheme: str = "pm1",
    mlp_scheme: str = "ones",
    seed: int = 0,
    tables_np: Optional[Sequence[np.ndarray]] = None,
    mlp_np: Optional[Sequence[np.ndarray]] = None,
    device="cpu",
) -> FleetRecModel:
    """Build the model on ``device``.  Default data is the reference parity
    convention (pm1 tables, all-ones weights), numpy-seeded as in the JAX
    package; pass tables_np/mlp_np to load real parameters."""
    plan = ModelPlan.create(cfg)
    specs = plan.spec_tables or tuple(cfg.tables)
    if tables_np is None:
        # QR configs init over the internal specs (Q + hidden R tables)
        tables_np = [ref.init_table(t, scheme=table_scheme, seed=seed)
                     for t in specs]
    if len(tables_np) != len(specs):
        raise ValueError(f"tables_np has {len(tables_np)} arrays but the model "
                         f"packs {len(specs)} specs")
    dtype = TORCH_DTYPES[cfg.dtype]
    if mlp_np is None:
        mlp = init_mlp_params(cfg.mlp, scheme=mlp_scheme, seed=seed,
                              dtype=dtype, device=device)
    else:
        mlp = [torch.from_numpy(np.asarray(w, np.float32)).to(device=device, dtype=dtype)
               for w in mlp_np]
    packed = pack_tables(tables_np, specs, plan.layout, dtype=cfg.table_dtype,
                         device=device)
    return FleetRecModel(plan, packed, mlp)
