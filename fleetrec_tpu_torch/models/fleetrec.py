"""The end-to-end model, the port of ``fleetrec_tpu/models/fleetrec.py``:
multi-table embedding lookup -> fixed-offset concat -> [interaction] ->
MLP (bias-free unless the model is given biases) -> [B] scores, on one
device.

``ModelPlan`` is the static half (the JAX package's frozen
``FleetRecModel``: layout, index permutation, QR plan).  ``FleetRecModel``
is an ``nn.Module`` that owns the packed tables, the towers' and cross
layers' weights and the lookup descriptors as buffers (``parameters()``
is empty; training reads the weights through ``trainable_tensors``) and
runs the forward: ``lookup`` (the fused lookup kernel: ``plan_indices``,
every tier, ``take_bad_rows`` and the feature layout in one launch), the
head (``mlp_apply``, the fused-MLP kernel; a DCNv2 cross network before it,
or the DLRM ``interaction_head``: bottom tower, pairwise dots, top tower)
and the NaN poison.  ``forward_train`` is the same forward under autograd
for training (``models/train.py``): ``LookupFunction`` (the fused lookup
and its backward kernel) and the ``mlp_train`` matmul chain, over the
tensors ``trainable_tensors`` names.  ``plan_indices``, ``bad_take_rows`` and
``lookup_concat`` (one gather a tier) stay as the ports of the JAX
functions that ``lookup`` computes.  ``lookup_pooled`` / ``forward_pooled``
are the same for multi-hot bags ``[B, num_tables, L]`` (``models/pooled.py``):
one ``lookup_fused_bags`` launch, then the head; ``lookup_ragged`` /
``forward_ragged`` for bags of different sizes ``[B, sum(bag_sizes)]`` (the
wire's layout): one ``lookup_fused_ragged`` launch, then the head.

A cross (DCNv2) config may have a bottom tower on the dense features
(MLPerf's DLRM-DCNv2: ``bottom_mlp`` with ``last_activation``): its output
fills the columns of the feature vector that no table covers
(``ModelConfig.dense_columns``), which the lookup leaves zero, before the
cross layers.  The towers may carry biases (``mlp_bias`` / ``bottom_bias``,
float32 only), which the fused tower adds in its epilogue.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

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
    lookup_tensors,
    pack_tables,
    take_bad_rows,
)
from .interaction import cross_network, dot_interaction, init_cross_params, pair_columns
from .mlp import init_mlp_params, mlp_apply, mlp_train
from ..ops.cross import cross_tail_plain
from ..ops.lookup import LookupFunction, lookup_fused, lookup_fused_bags, lookup_fused_ragged


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
        internal, qr_positions, sum_pairs = qr_expand(cfg)
        if cfg.interaction == "dot":
            # DLRM: the lookup gives the plain [T*D] concat in offset order
            # (the head reads it as [B, T, D]); the dense features feed the
            # bottom tower, not the concat
            feature_dim, dense_dim = cfg.num_tables * cfg.tables[0].dim, 0
        elif cfg.bottom_mlp is not None:
            # DCNv2: the dense features feed the bottom tower, whose output
            # the head writes into the columns no table covers
            feature_dim, dense_dim = cfg.feature_dim, 0
        else:
            feature_dim, dense_dim = cfg.feature_dim, cfg.dense_dim
        layout = build_layout(
            internal, feature_dim, dense_dim,
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
    [B, dense_dim], on the device its buffers live on.  ``bottom``: the
    bottom tower's weights (DLRM, or DCNv2 with one); ``cross``: the DCNv2
    layers, [W, b] or [U, V, b] each (both empty for a config without that
    head).  ``mlp_bias`` / ``bottom_bias``: one ``[out]`` tensor a layer of
    the top / bottom tower, given exactly where the config's ``MLPSpec``
    says ``use_bias`` (float32 towers only), else None."""

    def __init__(self, plan: ModelPlan, packed: PackedTables,
                 mlp: Sequence[torch.Tensor], bottom: Sequence[torch.Tensor] = (),
                 cross: Sequence[Sequence[torch.Tensor]] = (),
                 mlp_bias: Optional[Sequence[torch.Tensor]] = None,
                 bottom_bias: Optional[Sequence[torch.Tensor]] = None):
        super().__init__()
        cfg = plan.cfg
        for name, spec, biases, ws in (("mlp_bias", cfg.mlp, mlp_bias, mlp),
                                       ("bottom_bias", cfg.bottom_mlp, bottom_bias, bottom)):
            use_bias = spec is not None and spec.use_bias
            if (biases is not None) != use_bias:
                raise ValueError(f"{cfg.name}'s tower says use_bias={use_bias}, so {name} "
                                 f"must be {'given' if use_bias else 'None'}")
            if biases is not None and [tuple(b.shape) for b in biases] != [
                    (w.shape[1],) for w in ws]:
                raise ValueError(f"{name} must be one [out] a layer of its tower, got "
                                 f"{[tuple(b.shape) for b in biases]}")
        if (mlp_bias is not None or bottom_bias is not None) and plan.cfg.dtype != "float32":
            raise ValueError(f"tower biases need a float32 config, {plan.cfg.name} computes in "
                             f"{plan.cfg.dtype}")
        self.plan = plan
        self.cfg = plan.cfg
        self.layout = plan.layout
        self._n_onehot = len(packed.onehot_buffers)
        self._n_mlp = len(mlp)
        self._n_bottom = len(bottom)
        self._cross_shape = tuple(len(layer) for layer in cross)
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
        for i, w in enumerate(bottom):
            self.register_buffer(f"bottom_{i}", w)
        for li, layer in enumerate(cross):
            for j, w in enumerate(layer):
                self.register_buffer(f"cross_{li}_{j}", w)
        self._n_mlp_bias = 0 if mlp_bias is None else len(mlp_bias)
        self._n_bottom_bias = 0 if bottom_bias is None else len(bottom_bias)
        for i, b in enumerate(mlp_bias or ()):
            self.register_buffer(f"mlp_bias_{i}", b)
        for i, b in enumerate(bottom_bias or ()):
            self.register_buffer(f"bottom_bias_{i}", b)
        dev = packed.plan["feature_perm"].device
        self.register_buffer("index_perm", torch.as_tensor(
            np.asarray(plan.index_perm, np.int64), device=dev))
        for k, v in lookup_tensors(plan.layout, plan.index_perm, plan.qr_positions,
                                   dev).items():
            self.register_buffer(f"lookup_{k}", v)
        if self.cfg.interaction == "dot":
            # the triangle's flat columns over the bottom vector and the tables
            n_vecs = self.cfg.num_tables + (self.cfg.bottom_mlp is not None)
            self.register_buffer("pair_cols", pair_columns(n_vecs, dev))

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

    @property
    def bottom_weights(self) -> List[torch.Tensor]:
        return [getattr(self, f"bottom_{i}") for i in range(self._n_bottom)]

    @property
    def cross_weights(self) -> List[List[torch.Tensor]]:
        return [[getattr(self, f"cross_{li}_{j}") for j in range(n)]
                for li, n in enumerate(self._cross_shape)]

    @property
    def mlp_biases(self) -> Optional[List[torch.Tensor]]:
        """The top tower's biases, or None for a bias-free tower."""
        n = self._n_mlp_bias
        return [getattr(self, f"mlp_bias_{i}") for i in range(n)] if n else None

    @property
    def bottom_biases(self) -> Optional[List[torch.Tensor]]:
        """The bottom tower's biases, or None for a bias-free tower."""
        n = self._n_bottom_bias
        return [getattr(self, f"bottom_bias_{i}") for i in range(n)] if n else None

    @property
    def has_biases(self) -> bool:
        """Whether a tower has biases: the config's ``use_bias``."""
        bottom = self.cfg.bottom_mlp
        return self.cfg.mlp.use_bias or (bottom is not None and bottom.use_bias)

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
        """NaN into the scores of the rows ``bad`` flags, in place: the
        forward passes its own fresh scores, so this is one kernel and no
        copy."""
        if bad is not None:
            scores.masked_fill_(bad, float("nan"))
        return scores

    def lookup_operands(self) -> dict:
        """``lookup_fused``'s operands after the ids and the dense features,
        from this module's buffers as they are now: the packed buffers
        (classes, then the take buffer), their int8 scales, the descriptors,
        the stripes and the width of the dense tail they read."""
        n = self._n_onehot
        bufs = [getattr(self, f"onehot_{i}") for i in range(n)]
        scales = ([getattr(self, f"onehot_scale_{i}") for i in range(n)]
                  if self._quant else None)
        if self.take is not None:
            bufs.append(self.take)
            if scales is not None:
                scales.append(self.take_scales)
        lay = self.layout
        return dict(bufs=bufs, scales=scales, cols=self.lookup_cols,
                    pos=self.lookup_pos, stripes=lay.take_stripes,
                    stripe_height=lay.stripe_height, dense_dim=lay.dense_dim,
                    with_bad=bool(lay.take_groups))

    def _check_inputs(self, indices: torch.Tensor, dense: Optional[torch.Tensor],
                      dense_dim: int, bags: bool = False) -> None:
        check_inputs(self.cfg, indices, dense, dense_dim, bags)

    def lookup(self, indices: torch.Tensor, dense: Optional[torch.Tensor] = None
               ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        """Config-order ids [B, num_tables] (int32 or int64) and the dense
        tail [B, layout.dense_dim] -> (features [B, layout.feature_dim],
        bad [B] bool or None): ``lookup_concat(packed, plan_indices(indices),
        dense)`` and ``bad_take_rows``, by one ``lookup_fused`` call.  The
        features are in the table storage dtype (float32 for int8 storage).
        A layout with no dense tail (a DLRM layout: its dense features feed
        the bottom tower) does not read ``dense``."""
        self._check_inputs(indices, dense, self.layout.dense_dim)
        return self._lookup(indices, dense)

    def _lookup(self, indices: torch.Tensor, dense: Optional[torch.Tensor]
                ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        return lookup_fused(indices, dense if self.layout.dense_dim else None,
                            **self.lookup_operands())

    def forward(self, indices: torch.Tensor,
                dense: Optional[torch.Tensor] = None) -> torch.Tensor:
        """indices: [B, num_tables] in config table order; dense:
        [B, dense_dim].  Returns scores [B] (float32).

        A take id outside its table's [0, rows) range, negative included,
        poisons its row's score with NaN, as in the JAX package."""
        cfg = self.cfg
        # checks the ids and dense against the config, which covers what
        # lookup would check against the layout
        self._check_inputs(indices, dense, cfg.dense_dim)
        feats, bad = self._lookup(indices, dense)
        return self.poison_scores(self.head(feats, dense), bad)

    def head(self, feats: torch.Tensor, dense: Optional[torch.Tensor]) -> torch.Tensor:
        """Scores [B] (float32) of the lookup's features [B, layout.feature_dim]
        and the dense features: the DLRM ``interaction_head``, or the bottom
        tower (where a cross config has one) into its columns, the cross
        layers and the top tower."""
        cfg = self.cfg
        if cfg.interaction == "dot":
            return interaction_head(cfg, self.pair_cols, feats, dense, self.bottom_weights,
                                    self.mlp_weights, mlp_bias=self.mlp_biases,
                                    bottom_bias=self.bottom_biases)
        x = feats.to(TORCH_DTYPES[cfg.dtype])
        if cfg.bottom_mlp is not None:
            x = place_bottom(cfg, x, mlp_apply(
                self.bottom_weights, dense.to(x.dtype), cfg.bottom_mlp.activation, x.dtype,
                **tower_options(self.bottom_biases, cfg.bottom_mlp.last_activation)))
        if cfg.interaction == "cross":
            x = cross_network(x, self.cross_weights)
        scores = mlp_apply(self.mlp_weights, x, activation=cfg.mlp.activation,
                           **tower_options(self.mlp_biases))
        return scores[:, 0]

    def forward_train(self, indices: torch.Tensor, dense: Optional[torch.Tensor] = None,
                      tensors: Optional[Dict[str, torch.Tensor]] = None) -> torch.Tensor:
        """``forward`` for training, under autograd: the same checks, heads
        and NaN poison (out of place, so a poisoned row's gradient is 0):
        ``head_train(*lookup_train(...))``.  ``tensors``:
        ``trainable_tensors``' names -> the tensors read in their place (the
        Trainer passes leaves that alias the buffers and require grad); None
        reads the buffers.  int8 tables raise, and so do the heads the JAX
        package does not train: tower biases, a bottom tower's last
        activation and a cross head's bottom tower."""
        check_trainable_head(self)
        self._check_inputs(indices, dense, self.cfg.dense_dim)
        t = trainable_tensors(self) if tensors is None else tensors
        feats, bad = self.lookup_train(indices, dense, t)
        return self.head_train(feats, bad, dense, t)

    def lookup_train(self, indices: torch.Tensor, dense: Optional[torch.Tensor],
                     tensors: Dict[str, torch.Tensor]
                     ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        """``lookup`` through ``LookupFunction`` (``lookup_fused``, with
        ``lookup_fused_backward`` as its backward) over the packed buffers of
        ``tensors``; int8 tables raise."""
        ops = self.lookup_operands()
        bufs = [tensors[f"onehot_{i}"] for i in range(self._n_onehot)]
        if self.take is not None:
            bufs.append(tensors["take"])
        return LookupFunction.apply(
            indices, dense if self.layout.dense_dim else None, ops["cols"], ops["pos"],
            ops["stripes"], ops["stripe_height"], ops["dense_dim"], ops["with_bad"], None, *bufs)

    def head_train(self, feats: torch.Tensor, bad: Optional[torch.Tensor],
                   dense: Optional[torch.Tensor], tensors: Dict[str, torch.Tensor]
                   ) -> torch.Tensor:
        """The forward after the lookup, from the weights of ``tensors``:
        the head with ``mlp_train`` towers (a matmul chain, never the
        ``fused_mlp`` kernels), then the NaN poison out of place."""
        cfg = self.cfg
        mlp = [tensors[f"mlp_{i}"] for i in range(self._n_mlp)]
        if cfg.interaction == "dot":
            scores = interaction_head(cfg, self.pair_cols, feats, dense,
                                      [tensors[f"bottom_{i}"] for i in range(self._n_bottom)],
                                      mlp, tower=mlp_train)
        else:
            x = feats.to(TORCH_DTYPES[cfg.dtype])
            if cfg.interaction == "cross":
                x = cross_network(x, [[tensors[f"cross_{li}_{j}"] for j in range(n)]
                                      for li, n in enumerate(self._cross_shape)],
                                  tail=cross_tail_plain)
            scores = mlp_train(mlp, x, activation=cfg.mlp.activation)[:, 0]
        return scores if bad is None else scores.masked_fill(bad, float("nan"))

    def lookup_pooled(self, indices: torch.Tensor, dense: Optional[torch.Tensor] = None,
                      mean: bool = False) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        """Config-order bag ids [B, num_tables, L] (int32 or int64; a
        negative id is padding) and the dense tail -> (pooled features [B,
        layout.feature_dim], bad [B] bool or None):
        ``pooled_lookup_concat(packed, plan_bags(indices), dense, mean)``
        and ``pooled_bad_rows`` (``models/pooled.py``), by one
        ``lookup_fused_bags`` call."""
        self._check_inputs(indices, dense, self.layout.dense_dim, bags=True)
        return lookup_fused_bags(indices, dense if self.layout.dense_dim else None,
                                 mean=mean, **self.lookup_operands())

    def forward_pooled(self, indices: torch.Tensor, dense: Optional[torch.Tensor] = None,
                       mean: bool = False) -> torch.Tensor:
        """indices: [B, num_tables, L] bags in config table order, a
        negative id marking an empty slot; dense: [B, dense_dim].  Each
        table's bag is sum-pooled (``mean``: mean-pooled over its
        non-negative slots; an empty bag gives zeros).  Returns scores [B]
        (float32).

        A non-negative take id ``>=`` its table's rows poisons its row's
        score with NaN; padding never does.  The pooled features go through
        the head (``head``): the tower, or a DCNv2 head with its bottom tower.
        A DLRM dot config raises: the JAX package's pooled forward runs the
        plain tower whatever ``cfg.interaction`` says, which this port does
        not repeat."""
        check_pooled_config(self.cfg)
        feats, bad = self.lookup_pooled(indices, dense, mean)
        return self.poison_scores(self.head(feats, dense), bad)

    def lookup_ragged(self, indices: torch.Tensor, bag_sizes: Sequence[int],
                      dense: Optional[torch.Tensor] = None, mean: bool = False
                      ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        """Ragged bag ids [B, sum(bag_sizes)] (config order, table t's
        ``bag_sizes[t]`` members in one run; a negative id is padding) and
        the dense tail -> ``lookup_pooled``'s (features, bad), by one
        ``lookup_fused_ragged`` call."""
        check_ragged(self.cfg, indices, bag_sizes)
        check_dense(indices.shape[0], dense, self.layout.dense_dim)
        return lookup_fused_ragged(indices, dense if self.layout.dense_dim else None,
                                   bag_sizes=bag_sizes, mean=mean, **self.lookup_operands())

    def forward_ragged(self, indices: torch.Tensor, bag_sizes: Sequence[int],
                       dense: Optional[torch.Tensor] = None, mean: bool = False
                       ) -> torch.Tensor:
        """``forward_pooled`` for bags of different sizes: ids [B,
        sum(bag_sizes)] as ``lookup_ragged`` takes them, dense [B,
        dense_dim].  On bags of one size L it gives ``forward_pooled``'s
        scores on the same ids viewed as [B, T, L], to the bit."""
        check_pooled_config(self.cfg)
        check_dense(indices.shape[0], dense, self.cfg.dense_dim)
        feats, bad = self.lookup_ragged(indices, bag_sizes, dense, mean)
        return self.poison_scores(self.head(feats, dense), bad)


def check_inputs(cfg: ModelConfig, indices: torch.Tensor, dense: Optional[torch.Tensor],
                 dense_dim: int, bags: bool = False) -> None:
    """Raise unless ``indices`` is [B, num_tables] ([B, num_tables, L] for
    bags) and ``dense`` [B, dense_dim] (anything when ``dense_dim`` is 0)."""
    n = cfg.num_tables
    if indices.dim() != 2 + bags or indices.shape[1] != n:
        raise ValueError(f"indices must be [B, {n}{', L' if bags else ''}], got "
                         f"{tuple(indices.shape)}")
    check_dense(indices.shape[0], dense, dense_dim)


def check_dense(B: int, dense: Optional[torch.Tensor], dense_dim: int) -> None:
    """Raise unless ``dense`` is [B, dense_dim] (anything when ``dense_dim``
    is 0)."""
    if dense_dim and (dense is None or tuple(dense.shape) != (B, dense_dim)):
        raise ValueError(
            f"dense must be [{B}, {dense_dim}], got "
            f"{None if dense is None else tuple(dense.shape)}")


def check_pooled_config(cfg: ModelConfig) -> None:
    """Pooled bags feed the plain tower or a DCNv2 cross head."""
    if cfg.interaction not in ("none", "cross"):
        raise ValueError(f"pooled bags are not defined for interaction "
                         f"{cfg.interaction!r} ({cfg.name}): only for 'none' and 'cross'")


def check_trainable_head(model: "FleetRecModel") -> None:
    """Training takes the heads the JAX package trains: raise for tower
    biases, a bottom tower's last activation and a cross head's bottom
    tower (DLRM-DCNv2's, which only the served forward runs)."""
    cfg = model.cfg
    bottom = cfg.bottom_mlp
    if model.has_biases or (bottom is not None and (bottom.last_activation
                                                    or cfg.interaction == "cross")):
        raise ValueError(f"training takes the JAX package's heads; {cfg.name} has tower "
                         f"biases, a bottom tower's last activation or a cross head's bottom "
                         f"tower")


def check_ragged(cfg: ModelConfig, indices: torch.Tensor, bag_sizes: Sequence[int]) -> None:
    """Raise unless ``bag_sizes`` gives every table a bag of 1 or more and
    ``indices`` is [B, sum(bag_sizes)]."""
    if len(bag_sizes) != cfg.num_tables or min(bag_sizes, default=0) < 1:
        raise ValueError(f"bag_sizes must give each of the {cfg.num_tables} tables 1 or more "
                         f"members, got {tuple(bag_sizes)}")
    if indices.dim() != 2 or indices.shape[1] != sum(bag_sizes):
        raise ValueError(f"ragged bags are indices [B, {sum(bag_sizes)}], got "
                         f"{tuple(indices.shape)}")


def place_bottom(cfg: ModelConfig, x: torch.Tensor, bottom: torch.Tensor) -> torch.Tensor:
    """The features ``x`` [B, F] with the bottom tower's output ``bottom``
    [B, W] in its columns (``cfg.dense_columns()``), which the lookup left
    zero: a new tensor (autograd differentiates both)."""
    start, W = cfg.dense_columns()
    parts = [x[:, :start], bottom.to(x.dtype), x[:, start + W:]]
    return torch.cat([p for p in parts if p.shape[1]], dim=1)


def interaction_head(cfg: ModelConfig, pair_cols: torch.Tensor, emb_flat: torch.Tensor,
                     dense: Optional[torch.Tensor], bottom_weights: Sequence[torch.Tensor],
                     top_weights: Sequence[torch.Tensor], tower=mlp_apply,
                     mlp_bias: Optional[Sequence[torch.Tensor]] = None,
                     bottom_bias: Optional[Sequence[torch.Tensor]] = None) -> torch.Tensor:
    """DLRM head: [B, T*D] offset-order embeddings (and the dense features
    through the bottom tower) -> pairwise dot interaction (over the
    triangle's flat columns ``pair_cols``) -> top tower -> scores [B]
    float32.  ``tower``: the function that runs a tower (``mlp_apply``, or
    ``mlp_train`` for training).  The bottom tower applies its activation to
    every layer but the last, and to the last too where
    ``cfg.bottom_mlp.last_activation`` says so (the MLPerf DLRM bottom MLP;
    off by default, as in the JAX package).  ``mlp_bias`` / ``bottom_bias``:
    the towers' biases (``mlp_apply`` only), or None."""
    dtype = TORCH_DTYPES[cfg.dtype]
    B = emb_flat.shape[0]
    vecs = emb_flat.reshape(B, cfg.num_tables, cfg.tables[0].dim).to(dtype)
    bottom = None
    if cfg.bottom_mlp is not None:
        bottom = tower(bottom_weights, dense.to(dtype),
                       activation=cfg.bottom_mlp.activation, out_dtype=dtype,
                       **tower_options(bottom_bias, cfg.bottom_mlp.last_activation))
        vecs = torch.cat([bottom[:, None, :], vecs], dim=1)
    z = dot_interaction(vecs, pair_cols)
    if bottom is not None:
        z = torch.cat([bottom, z], dim=1)
    scores = tower(top_weights, z, activation=cfg.mlp.activation, **tower_options(mlp_bias))
    return scores[:, 0]


def tower_options(biases: Optional[Sequence[torch.Tensor]] = None,
                  last_activation: bool = False) -> dict:
    """The keyword arguments of a tower call that differ from its defaults
    (a bias-free tower without a last activation passes none)."""
    kw = {} if biases is None else {"biases": biases}
    if last_activation:
        kw["last_activation"] = True
    return kw


def trainable_tensors(model: FleetRecModel) -> Dict[str, torch.Tensor]:
    """The tensors training updates, named as the leaves of the JAX
    package's params pytree: ``onehot_<i>`` and ``take`` (the packed
    buffers, ``PackedTables``' leaves), ``mlp_<i>``, ``bottom_<i>`` and
    ``cross_<layer>_<j>``; never an int8 scale or a descriptor.  They are
    the module's buffers themselves, so updating them in place updates the
    model."""
    names = [f"onehot_{i}" for i in range(model._n_onehot)]
    if model.take is not None:
        names.append("take")
    names += [f"mlp_{i}" for i in range(model._n_mlp)]
    names += [f"bottom_{i}" for i in range(model._n_bottom)]
    names += [f"cross_{li}_{j}" for li, n in enumerate(model._cross_shape) for j in range(n)]
    return {n: getattr(model, n) for n in names}


def resolve_device(device) -> torch.device:
    """``device`` as a torch.device.  The port's entry points run on the
    card unless the caller asks for the CPU: a CUDA device that this host
    does not have raises, and nothing falls back to the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {str(device)!r}: this host has no CUDA device (pass "
                           f"device='cpu' to run on the CPU)")
    return dev


def weight_shapes(cfg: ModelConfig) -> dict:
    """The shapes of the weights a model of ``cfg`` holds, as the JAX
    package's params tree holds them: "mlp" and "bottom" an [in, out] a
    layer; "cross" a list a layer, [W [F, F], b [F]] or [U [F, r],
    V [r, F], b [F]] (empty lists for a head the config lacks)."""
    def tower(spec):
        return list(zip(spec.widths[:-1], spec.widths[1:]))

    F, r = cfg.feature_dim, cfg.cross_rank
    layer = [(F, F), (F,)] if r == 0 else [(F, r), (r, F), (F,)]
    return {"mlp": tower(cfg.mlp),
            "bottom": tower(cfg.bottom_mlp) if cfg.bottom_mlp is not None else [],
            "cross": [layer] * cfg.cross_layers if cfg.interaction == "cross" else []}


def init_model(
    cfg: ModelConfig,
    table_scheme: str = "pm1",
    mlp_scheme: str = "ones",
    seed: int = 0,
    tables_np: Optional[Sequence[np.ndarray]] = None,
    mlp_np: Optional[Sequence[np.ndarray]] = None,
    device="cuda",
) -> FleetRecModel:
    """Build the model on ``device`` (the card unless the caller asks for
    the CPU; without a card, "cuda" raises).  Default data is the reference parity
    convention (pm1 tables, all-ones weights, zero cross biases, and zero
    tower biases where the config's ``use_bias`` asks for them),
    numpy-seeded as in the JAX package (the bottom tower in the seed + 1
    namespace, the cross layers in seed + 2); pass tables_np/mlp_np to load
    real tables and top-tower weights."""
    device = resolve_device(device)
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
    bottom = cross = ()
    if cfg.bottom_mlp is not None:
        bottom = init_mlp_params(cfg.bottom_mlp, scheme=mlp_scheme, seed=seed + 1,
                                 dtype=dtype, device=device)
    if cfg.interaction == "cross":
        cross = init_cross_params(cfg.feature_dim, cfg.cross_layers, rank=cfg.cross_rank,
                                  scheme=mlp_scheme, seed=seed, dtype=dtype, device=device)
    biases = {name: [torch.zeros(w.shape[1], dtype=dtype, device=device) for w in ws]
              for name, spec, ws in (("mlp_bias", cfg.mlp, mlp),
                                     ("bottom_bias", cfg.bottom_mlp, bottom))
              if spec is not None and spec.use_bias}
    return FleetRecModel(plan, packed, mlp, bottom, cross, **biases)
