"""The sharded forward and training step, the port of
``fleetrec_tpu/parallel/sharded.py`` (``ShardedFleetRec``).

FleetRec spreads its tables over several FPGAs and joins their partial
results before the MLP.  The JAX package does it on the "model" axis of a
mesh with ``shard_map``: each model shard owns a row range of the unified
take buffer and ``n / M`` tables of each one-hot class, looks up only what
it owns (every other column a zero), and ONE ``psum`` joins the partials.
Here a shard is a rank (``parallel/mesh.py``), and the exchange is one
``dist.all_reduce(SUM)`` over the data row's model group
(``ShardedFleetRec._exchange``):

* the local lookup is one launch of the fused lookup kernel over this
  shard's buffers, with the shard's descriptors
  (``embedding.lookup_tensors(shard=(m, M))``) and the take buffer's row
  window (``ops/lookup.py``): a table or a take row another shard holds
  reads zeros, the dense tail only on shard 0, and the bad-row flags come
  from the ids and the global row limits, the same on every shard;
* what crosses the wire is the ``[B, H1]`` W1-partial product when
  ``_use_w1_fold`` (H1 < the feature width, no interaction head), else the
  ``[B, F]`` features.  The JAX package stages ``A = fold_w1(W1)`` once (the
  feature permutation folded into W1's rows) and multiplies its local
  pre-permutation source vector by it.  The port's kernel already writes
  the features in the ``feature_perm`` order, so ``feats_local @ W1`` is
  the same product (``A``'s rows are sums of W1's rows over the output
  columns that read one source column): a ``torch.matmul`` in float32, as
  JAX's ``preferred_element_type=jnp.float32``, with TF32 off, and no
  staged ``A``;
* after the exchange every rank of the row runs the rest replicated:
  ReLU, the cast to ``cfg.dtype`` and ``W2..Wn`` through ``mlp_apply``
  (the fused-MLP kernel) on the fold path; else the head on the summed
  features (the tower, a DCNv2 cross stack or the DLRM interaction); then
  the NaN poison.

Every output column is one shard's value plus exact zeros from the others
(a QR quotient column and its remainder may sit on two shards: each adds its
part), so on pm1 / parity data the scores are bit-equal to one device's.
``forward_pipelined`` overlaps batch k's exchange with batch k+1's lookup;
``forward_pooled`` is the bag form (``lookup_fused_bags`` with the window).
A rank's shard comes from one of two places:

* ``ShardedFleetRec(model, mesh)``: a whole model built on the host
  (``init_model`` / ``load_npz`` / ``params_from_jax`` with
  ``device="cpu"``), of which each rank copies only its slice to its device
  (``shard_operands``);
* ``ShardedFleetRec.from_packed(plan, packed, mesh, mlp)``: a
  ``PackedTables`` whose take buffer is already this rank's window on its
  device (``models/biginit.py::pack_pm1_sharded`` with the mesh), used as it
  is (``packed_operands(..., window_only=True)``), so no whole model exists
  on the host or on any card: the JAX package's ``shard_params`` whose
  ``device_put`` is a no-op for a buffer already in place.

``train_step`` is one SGD step (``p - lr * g``, ``models/train.py::SGD``)
on the mean BCE of the global batch, the D data rows' batches together, as
the JAX package's GSPMD ``train_step``; int8 tables raise.  The forward runs
under autograd: the window lookup through ``LookupFunction`` (its backward
the window form of ``lookup_fused_backward``, which adds only into this
shard's rows), the W1-partial, the exchange as ``_Exchange`` (forward the
all_reduce, backward the identity: every rank of the row runs the same post
on the same sum, so the cotangent of its partial is the sum's), and the
post with the training towers (``mlp_train``, never ``fused_mlp``).  A row's
loss is its mean BCE over D; the gradients of the replicated weights and of
the shard's tables are summed over the model column's D ranks
(``Mesh.col_group``: a sum over the world would count each M times), and
W1's on the fold path, ``feats_local^T @ dh`` on each rank, over the whole
world (the row's group, then the column's).  The shard and the weights are
updated in place, so the mesh serves its trained weights as it is, and the
loss returned is the global batch's, on every rank.  There is no fold to
refresh: the port stages none.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from ..models.embedding import TORCH_DTYPES, PackedTables, class_tables, lookup_tensors
from ..models.fleetrec import (FleetRecModel, ModelPlan, check_inputs, check_pooled_config,
                               interaction_head)
from ..models.interaction import cross_network, pair_columns
from ..models.mlp import mlp_apply, mlp_train
from ..models.train import SGD, bce_with_logits
from ..ops.cross import cross_tail_plain
from ..ops.lookup import LookupFunction, lookup_fused, lookup_fused_bags, require_float_storage
from .mesh import Mesh


def _slice_rows(t: torch.Tensor, lo: int, n: int, fill: float, device) -> torch.Tensor:
    """Rows [lo, lo + n) of ``t`` copied to ``device``, rows past its end
    filled with ``fill`` (the padding of the sharded axis)."""
    part = t[lo:lo + n]
    if part.shape[0] < n:
        pad = torch.full((n - part.shape[0],) + tuple(t.shape[1:]), fill, dtype=t.dtype)
        part = torch.cat([part.cpu(), pad])
    return part.to(device, copy=True).contiguous()


def shard_operands(model: FleetRecModel, m: int, M: int, device) -> dict:
    """``lookup_fused``'s operands (after the ids and dense) of model shard
    m of M on ``device``, sliced from ``model``'s buffers (the JAX
    package's ``shard_params``): ``packed_operands`` of its plan and packed
    tables."""
    return packed_operands(model.plan, model.packed, m, M, device)


def packed_operands(plan: ModelPlan, packed: PackedTables, m: int, M: int, device,
                    window_only: bool = False) -> dict:
    """``lookup_fused``'s operands of model shard m of M on ``device``:
    class i's tables ``[m * n_loc, (m + 1) * n_loc)`` of ``packed``
    (``n_loc = ceil(n / M)``, past the last table all-zero pad tables of
    int8 scale 1.0), the take buffer's physical rows ``[m * rows_local, (m +
    1) * rows_local)`` (``rows_local = ceil(take_phys_total / M)``, zero
    rows past its end) and its window, its scales whole, and the shard's
    descriptors.  Shard 0 alone reads the dense tail.  ``window_only``:
    ``packed``'s take buffer already holds just those rows
    (``pack_pm1_sharded`` with a mesh) and is used as it is, not copied,
    when it lies on ``device``."""
    quant = packed.onehot_scales is not None
    bufs, scales = [], ([] if quant else None)
    for i, c in enumerate(plan.layout.onehot_classes):
        lo, _ = class_tables(c.num_tables, m, M)
        n_loc = -(-c.num_tables // M)
        bufs.append(_slice_rows(packed.onehot_buffers[i], lo, n_loc, 0, device))
        if quant:
            scales.append(_slice_rows(packed.onehot_scales[i], lo, n_loc, 1.0, device))
    take = packed.take_buffer
    if take is not None:
        rows_local = -(-plan.layout.take_phys_total // M)
        if window_only:
            if take.shape[0] != rows_local:
                raise ValueError(f"the take window of shard {m} of {M} has {rows_local} rows, "
                                 f"the buffer given {take.shape[0]}")
            bufs.append(take.to(device).contiguous())
        else:
            bufs.append(_slice_rows(take, m * rows_local, rows_local, 0, device))
        if quant:
            scales.append(packed.take_scales.to(device, copy=True))
    return _operands(plan, bufs, scales, m, M, device)


def empty_operands(plan: ModelPlan, m: int, M: int, device) -> dict:
    """``packed_operands``' dict of model shard m of M with every buffer
    allocated on ``device`` and holding only padding (tables and rows 0,
    int8 scales 1.0): what ``io.load_sharded`` fills in place, the valid
    rows of each buffer from the checkpoint."""
    lay = plan.layout
    tdtype = TORCH_DTYPES[plan.cfg.table_dtype]
    quant = plan.cfg.table_dtype == "int8"
    bufs, scales = [], ([] if quant else None)
    for c in lay.onehot_classes:
        n_loc = -(-c.num_tables // M)
        shape = (n_loc, c.r1, c.r2 * c.dim) if c.r2 else (n_loc, c.rows_pad, c.dim)
        bufs.append(torch.zeros(shape, dtype=tdtype, device=device))
        if quant:
            scales.append(torch.ones(n_loc, dtype=torch.float32, device=device))
    if lay.take_phys_total:
        bufs.append(torch.zeros((-(-lay.take_phys_total // M), lay.take_lanes), dtype=tdtype,
                                device=device))
        if quant:
            scales.append(torch.ones(lay.n_take, dtype=torch.float32, device=device))
    return _operands(plan, bufs, scales, m, M, device)


def _operands(plan: ModelPlan, bufs, scales, m: int, M: int, device) -> dict:
    """The operands dict of shard m of M over its buffers and scales
    (classes, then the take window): the take window, the shard's
    descriptors, the dense tail on shard 0 alone."""
    lay = plan.layout
    window = None
    if lay.take_phys_total:
        rows_local = -(-lay.take_phys_total // M)
        window = (m * rows_local, rows_local)
    desc = lookup_tensors(lay, plan.index_perm, plan.qr_positions, device, shard=(m, M))
    return dict(bufs=bufs, scales=scales, cols=desc["cols"], pos=desc["pos"],
                stripes=lay.take_stripes, stripe_height=lay.stripe_height,
                dense_dim=lay.dense_dim if m == 0 else 0,
                with_bad=bool(lay.take_groups), window=window)


class _Exchange(torch.autograd.Function):
    """The exchange under autograd: ``_Exchange.apply(part, exchange)``
    runs ``exchange(part)`` (``ShardedFleetRec._exchange``: the all_reduce
    over the data row, in place) and returns the sum; its backward is the
    identity.  Every rank of the row computes the same post and the same
    loss from the sum, so the cotangent of each rank's partial is the sum's;
    all-reducing it too (``torch.distributed.nn.functional.all_reduce``'s
    backward) would make it M times too large."""

    @staticmethod
    def forward(ctx, part, exchange):
        exchange(part)
        ctx.mark_dirty(part)
        return part

    @staticmethod
    def backward(ctx, grad):
        return grad, None


def _all_reduce(t: torch.Tensor, group) -> None:
    """``t`` summed in place over ``group`` (nothing for None)."""
    if group is not None:
        dist.all_reduce(t, op=dist.ReduceOp.SUM, group=group)


class ShardedFleetRec:
    """This rank's shard of a FleetRecModel on a (data, model) mesh, and the
    sharded forwards over it.  Every rank of a data row calls a forward
    with the row's batch (``multihost.host_local_batch_to_global``) and gets
    the row's scores."""

    def __init__(self, model: FleetRecModel, mesh: Mesh):
        if model.has_biases or (model.cfg.interaction == "cross"
                                and model.cfg.bottom_mlp is not None):
            raise ValueError(f"the sharded forward takes bias-free towers and a cross head "
                             f"without a bottom tower; {model.cfg.name} has "
                             f"{'tower biases' if model.has_biases else 'a bottom tower'}")
        self._place(model.plan, mesh)
        self.shard_params(model)

    def _place(self, plan: ModelPlan, mesh: Mesh) -> None:
        self.mesh = mesh
        self.plan = plan
        self.cfg = plan.cfg
        self.layout = plan.layout

    @classmethod
    def from_packed(cls, plan: ModelPlan, packed: PackedTables, mesh: Mesh,
                    mlp: Sequence[torch.Tensor]) -> "ShardedFleetRec":
        """This rank's shard from ``packed`` whose take buffer is already the
        rank's window (``pack_pm1_sharded(cfg, layout, mesh)``), kept as it
        is, and the tower's weights ``mlp`` (copied to the mesh's device): no
        whole model is needed.  A config with an interaction head (a bottom
        MLP, dot or cross) is refused: build it with ``__init__``."""
        cfg = plan.cfg
        if cfg.interaction != "none" or cfg.bottom_mlp is not None:
            raise ValueError(f"from_packed builds the tower-only model; {cfg.name} has the "
                             f"{cfg.interaction!r} interaction head")
        dev = mesh.device
        return cls.from_operands(
            plan, mesh, packed_operands(plan, packed, mesh.m, mesh.model, dev, window_only=True),
            [w.to(dev, copy=True) for w in mlp])

    @classmethod
    def from_operands(cls, plan: ModelPlan, mesh: Mesh, operands: dict,
                      mlp: Sequence[torch.Tensor], bottom: Sequence[torch.Tensor] = (),
                      cross: Sequence[Sequence[torch.Tensor]] = ()) -> "ShardedFleetRec":
        """This rank's shard over ``operands`` (``packed_operands`` or
        ``empty_operands`` of its model shard) and the weights, every tensor
        already on the mesh's device and used as it is, not copied."""
        self = cls.__new__(cls)
        self._place(plan, mesh)
        self.operands = operands
        self._set_weights(mlp, bottom, cross)
        return self

    @property
    def _use_w1_fold(self) -> bool:
        """Exchange the [B, H1] W1-partial product instead of the [B, F]
        features whenever that is fewer bytes.  Interaction heads consume the
        features themselves, so they keep the feature exchange."""
        cfg = self.cfg
        return (cfg.interaction == "none" and len(cfg.mlp.widths) >= 2
                and cfg.mlp.widths[1] < self.layout.feature_dim)

    def shard_params(self, model: FleetRecModel) -> None:
        """Keep this rank's slice of ``model``'s tables (``shard_operands``)
        and a copy of every weight on the mesh's device."""
        dev = self.mesh.device
        self.operands = shard_operands(model, self.mesh.m, self.mesh.model, dev)
        self._set_weights([w.to(dev, copy=True) for w in model.mlp_weights],
                          [w.to(dev, copy=True) for w in model.bottom_weights],
                          [[w.to(dev, copy=True) for w in layer]
                           for layer in model.cross_weights])

    def _set_weights(self, mlp, bottom, cross) -> None:
        """Keep the replicated weights (on the mesh's device) and, for the
        DLRM head, the triangle's flat columns (``pair_columns``)."""
        cfg = self.cfg
        self.mlp, self.bottom = list(mlp), list(bottom)
        self.cross = [list(layer) for layer in cross]
        self.pair_cols = (pair_columns(cfg.num_tables + (cfg.bottom_mlp is not None),
                                       self.mesh.device)
                          if cfg.interaction == "dot" else None)

    # ---- the three parts of a forward -----------------------------------
    def _lookup_dense(self, dense: Optional[torch.Tensor]) -> Optional[torch.Tensor]:
        return dense if self.operands["dense_dim"] else None

    def _partial(self, feats: torch.Tensor, w1: Optional[torch.Tensor] = None
                 ) -> torch.Tensor:
        """The value the exchange sums: the local W1-partial product in
        float32 (fold), else the local features.  ``w1``: the W1 to read in
        place of this rank's (a training leaf)."""
        if not self._use_w1_fold:
            return feats
        dtype = TORCH_DTYPES[self.cfg.dtype]
        w1 = self.mlp[0] if w1 is None else w1
        return torch.matmul(feats.to(dtype).float(), w1.to(dtype).float())

    def _pre(self, indices: torch.Tensor, dense: Optional[torch.Tensor]
             ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        """Everything before the exchange: the local lookup (one
        ``lookup_fused`` launch) and the partial.  Returns (the value to sum,
        the bad-row flags)."""
        feats, bad = lookup_fused(indices, self._lookup_dense(dense), **self.operands)
        return self._partial(feats), bad

    def _exchange(self, part: torch.Tensor, async_op: bool = False):
        """THE exchange: one all_reduce(SUM) of ``part``, in place, over the
        data row's model group; returns its work handle with ``async_op``.
        A mesh with no process group (one rank) has nothing to exchange."""
        if self.mesh.group is None:
            return None
        return dist.all_reduce(part, op=dist.ReduceOp.SUM, group=self.mesh.group,
                               async_op=async_op)

    def _post(self, h: torch.Tensor, dense: Optional[torch.Tensor]) -> torch.Tensor:
        """Everything after the exchange, on the summed [B, H1] partial
        activations (fold) or [B, F] features: [B] float32 scores."""
        cfg = self.cfg
        dtype = TORCH_DTYPES[cfg.dtype]
        if self._use_w1_fold:
            rest = self.mlp[1:]
            if cfg.mlp.activation == "relu" and rest:
                h = torch.clamp_min(h, 0.0)
            h = h.to(dtype)
            if not rest:
                return h[:, 0].float()
            return mlp_apply(rest, h, activation=cfg.mlp.activation)[:, 0]
        if cfg.interaction == "dot":
            return interaction_head(cfg, self.pair_cols, h, dense, self.bottom, self.mlp)
        x = h.to(dtype)
        if cfg.interaction == "cross":
            x = cross_network(x, self.cross)
        return mlp_apply(self.mlp, x, activation=cfg.mlp.activation)[:, 0]

    def _finish(self, part: torch.Tensor, work, bad: Optional[torch.Tensor],
                dense: Optional[torch.Tensor]) -> torch.Tensor:
        """Wait for the exchange of ``part``, run the rest, poison the rows
        with a bad take id."""
        if work is not None:
            work.wait()
        return FleetRecModel.poison_scores(self._post(part, dense), bad)

    # ---- the forwards ---------------------------------------------------
    def forward(self, indices: torch.Tensor, dense: Optional[torch.Tensor] = None
                ) -> torch.Tensor:
        """The data row's config-order ids [B, num_tables] and dense
        [B, dense_dim] (the same on every rank of the row) -> scores [B]
        float32: lookup -> the exchange -> the rest.  A take id outside its
        table's [0, rows) poisons its row's score with NaN, as on one
        device."""
        check_inputs(self.cfg, indices, dense, self.cfg.dense_dim)
        part, bad = self._pre(indices, dense)
        self._exchange(part)
        return self._finish(part, None, bad, dense)

    def forward_pipelined(self, indices: torch.Tensor, dense: Optional[torch.Tensor] = None
                          ) -> torch.Tensor:
        """K batches [K, B, num_tables] (+ dense [K, B, dense_dim]) ->
        scores [K, B].  Batch k's exchange is issued (asynchronously) before
        batch k+1's lookup and waited on before batch k's post, so it
        overlaps the next batch's lookup (the JAX package's double-buffered
        scan).  Each batch's scores are ``forward``'s, bit for bit."""
        if indices.dim() != 3:
            raise ValueError(f"indices must be [K, B, {self.cfg.num_tables}], got "
                             f"{tuple(indices.shape)}")
        K = indices.shape[0]
        scores: List[torch.Tensor] = []
        pending = None
        for k in range(K):
            d = None if dense is None else dense[k]
            check_inputs(self.cfg, indices[k], d, self.cfg.dense_dim)
            part, bad = self._pre(indices[k], d)
            work = self._exchange(part, async_op=True)
            if pending is not None:
                scores.append(self._finish(*pending))
            pending = (part, work, bad, d)
        scores.append(self._finish(*pending))
        return torch.stack(scores)

    def forward_pooled(self, indices: torch.Tensor, dense: Optional[torch.Tensor] = None,
                       mean: bool = False) -> torch.Tensor:
        """Bags [B, num_tables, L] (a negative id is padding) -> scores [B]:
        one ``lookup_fused_bags`` launch over this shard's buffers and window
        (a bag's rows on other shards add nothing here; the mean divides by
        the whole bag's count), the same one exchange and rest.  A config
        with an interaction head raises."""
        check_pooled_config(self.cfg)
        check_inputs(self.cfg, indices, dense, self.cfg.dense_dim, bags=True)
        feats, bad = lookup_fused_bags(indices, self._lookup_dense(dense), mean=mean,
                                       **self.operands)
        part = self._partial(feats)
        self._exchange(part)
        return self._finish(part, None, bad, dense)

    # ---- training -------------------------------------------------------
    def trainable_tensors(self) -> Dict[str, torch.Tensor]:
        """This rank's tensors that training updates, named as
        ``models/fleetrec.py::trainable_tensors`` names the model's: the
        shard's class tables and take rows (``onehot_<i>``, ``take``), then
        the replicated weights (``mlp_<i>``, ``bottom_<i>``,
        ``cross_<layer>_<j>``).  They are the tensors the forwards read, so
        updating them in place updates the shard.  int8 tables raise."""
        bufs = self.operands["bufs"]
        require_float_storage(bufs)
        out = dict(zip(self._table_names(), bufs))
        out.update({f"mlp_{i}": w for i, w in enumerate(self.mlp)})
        out.update({f"bottom_{i}": w for i, w in enumerate(self.bottom)})
        out.update({f"cross_{li}_{j}": w for li, layer in enumerate(self.cross)
                    for j, w in enumerate(layer)})
        return out

    def _table_names(self) -> List[str]:
        names = [f"onehot_{i}" for i in range(len(self.layout.onehot_classes))]
        return names + (["take"] if self.operands["window"] is not None else [])

    def lookup_train(self, indices: torch.Tensor, dense: Optional[torch.Tensor],
                     tensors: Dict[str, torch.Tensor]
                     ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        """The window lookup under autograd (``LookupFunction`` over this
        shard's buffers of ``tensors``, its descriptors and take window)."""
        ops = self.operands
        bufs = [tensors[n] for n in self._table_names()]
        return LookupFunction.apply(indices, self._lookup_dense(dense), ops["cols"],
                                    ops["pos"], ops["stripes"], ops["stripe_height"],
                                    ops["dense_dim"], ops["with_bad"], ops["window"], *bufs)

    def post_train(self, h: torch.Tensor, bad: Optional[torch.Tensor],
                   dense: Optional[torch.Tensor], tensors: Dict[str, torch.Tensor]
                   ) -> torch.Tensor:
        """``_post`` for training, from the weights of ``tensors``: the
        training towers (``mlp_train``: ReLU as ``torch.maximum``, no
        ``fused_mlp``), the heads as ``head_train`` runs them, the NaN poison
        out of place (a poisoned row's gradient is 0)."""
        cfg = self.cfg
        dtype = TORCH_DTYPES[cfg.dtype]
        mlp = [tensors[f"mlp_{i}"] for i in range(len(self.mlp))]
        act = cfg.mlp.activation
        if self._use_w1_fold:
            rest = mlp[1:]
            if act == "relu" and rest:
                h = torch.maximum(h, h.new_zeros(()))
            scores = mlp_train(rest, h.to(dtype), activation=act)[:, 0] if rest else h[:, 0]
        elif cfg.interaction == "dot":
            scores = interaction_head(cfg, self.pair_cols, h, dense,
                                      [tensors[f"bottom_{i}"] for i in range(len(self.bottom))],
                                      mlp, tower=mlp_train)
        else:
            x = h.to(dtype)
            if cfg.interaction == "cross":
                x = cross_network(x, [[tensors[f"cross_{li}_{j}"] for j in range(len(layer))]
                                      for li, layer in enumerate(self.cross)],
                                  tail=cross_tail_plain)
            scores = mlp_train(mlp, x, activation=act)[:, 0]
        return scores if bad is None else scores.masked_fill(bad, float("nan"))

    def forward_train(self, indices: torch.Tensor, dense: Optional[torch.Tensor],
                      tensors: Dict[str, torch.Tensor]) -> torch.Tensor:
        """The data row's scores [B] under autograd, from ``tensors`` (leaves
        that alias ``trainable_tensors``): lookup -> W1-partial -> the
        exchange (``_Exchange``) -> the training post."""
        check_inputs(self.cfg, indices, dense, self.cfg.dense_dim)
        feats, bad = self.lookup_train(indices, dense, tensors)
        part = self._partial(feats, tensors["mlp_0"])
        return self.post_train(_Exchange.apply(part, self._exchange), bad, dense, tensors)

    def row_loss(self, scores: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
        """This data row's share of the global batch's mean BCE: its mean
        over D (the D rows' shares sum to the mean over the D * B rows)."""
        return bce_with_logits(scores, labels) / self.mesh.data

    def gradient_groups(self, name: str) -> list:
        """The process groups the gradient of tensor ``name`` is summed
        over, in order: W1's on the fold path is each rank's own product,
        so the whole world (the row's group, then the column's); every other
        one is the same on every rank of a row, so the model column's."""
        groups = [self.mesh.group] if name == "mlp_0" and self._use_w1_fold else []
        return [g for g in groups + [self.mesh.col_group] if g is not None]

    def train_step(self, indices: torch.Tensor, dense: Optional[torch.Tensor],
                   labels: torch.Tensor, lr: float) -> torch.Tensor:
        """One SGD step on the global batch: every rank of a data row passes
        the row's ids [B, num_tables], dense [B, dense_dim] (or None) and
        labels [B] float32, on its device.  ``forward_train``, ``row_loss``
        and ``torch.autograd.grad``, each gradient summed over its groups,
        then SGD: this rank's shard and weights are updated in place.
        Returns the global batch's loss (0-dim float32, computed before the
        update), the same on every rank."""
        tensors = self.trainable_tensors()
        leaves = {k: v.detach().requires_grad_() for k, v in tensors.items()}
        loss = self.row_loss(self.forward_train(indices, dense, leaves), labels)
        grads = [g.contiguous() for g in torch.autograd.grad(loss, list(leaves.values()))]
        for name, g in zip(tensors, grads):
            for group in self.gradient_groups(name):
                _all_reduce(g, group)
        SGD(lr).update(list(tensors.values()), grads)
        loss = loss.detach().reshape(1)
        _all_reduce(loss, self.mesh.col_group)
        return loss[0]
