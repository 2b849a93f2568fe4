"""The system under test, built from a configuration file: the port's
``ModelConfig`` from the file's sizes and head, its packed tables made on
the device by the port's ``pack_pm1_sharded`` and then overwritten with the
harness's seeded values (``tables.py``) through the layout the port exposes
(``biginit.take_segments``, the class buffers, the int8 scales), and the
head's weights from the seed (``tables.head_weights``).  Nothing here is
read back by the reference.

What the port has no field or argument for is not handed to it, and the
comparison with the reference (which follows the configuration) decides:
the bottom tower's ``last_activation`` reaches ``MLPSpec`` only where the
port's ``MLPSpec`` has that field, and the towers' biases reach
``FleetRecModel`` only where it takes ``mlp_bias`` and ``bottom_bias``.
"""

from __future__ import annotations

import dataclasses
import inspect

import torch

from . import tables as tb


def port_config(name: str, model: dict, serve: dict):
    """The port's ModelConfig of a configuration file's ``model``,
    ``storage`` and ``serve`` blocks (config-order tables, table id =
    column; the head's keys as ``README.md`` lists them)."""
    from fleetrec_tpu_torch.config import MLPSpec, ModelConfig, TableSpec

    bias = bool(model.get("bias"))

    def spec(w, activation, **extra):
        known = {f.name for f in dataclasses.fields(MLPSpec)}
        return MLPSpec(input_dim=w[0], hidden=tuple(w[1:-1]), out_dim=w[-1],
                       activation=activation, use_bias=bias,
                       **{k: v for k, v in extra.items() if k in known})

    bottom = model.get("bottom_mlp")
    interaction = model.get("interaction", "none")
    cfg = ModelConfig(
        name=name,
        tables=tuple(TableSpec(table_id=i, rows=t["rows"], dim=t["dim"],
                               out_offset=t["out_offset"])
                     for i, t in enumerate(model["tables"])),
        mlp=spec(model["mlp"], model.get("activation")),
        dense_dim=model["dense_dim"],
        batch_size=serve["batch"],
        dtype=model["dtype"],
        table_dtype=model["table_dtype"],
        interaction=interaction,
        bottom_mlp=(spec(bottom["widths"], bottom.get("activation"),
                         last_activation=bool(bottom.get("last_activation")))
                    if bottom else None),
        cross_layers=model.get("cross_layers", 0),
        cross_rank=model.get("cross_rank", 0),
        **model["storage"],
    )
    cfg.validate()
    if cfg.qr_rem:
        raise ValueError(f"{name}: the harness serves configs without QR tables")
    if interaction != "dot" and cfg.feature_dim != model["feature_dim"]:
        raise ValueError(f"{name}: the top tower's input {cfg.feature_dim} is not the "
                         f"feature vector's {model['feature_dim']}")
    return cfg


def fill_classes(packed, layout, key: int, storage: str, rows_of: dict) -> None:
    """Every class table's rows (and, for int8, its scale) in place."""
    for i, c in enumerate(layout.onehot_classes):
        buf = packed.onehot_buffers[i].view(c.num_tables, c.rows_pad, c.dim)
        for j, tid in enumerate(c.table_ids):
            r = torch.arange(rows_of[tid], device=buf.device)
            buf[j, :rows_of[tid]] = tb.values(key, torch.tensor(tid, device=buf.device), r,
                                              c.dim, storage)
            if packed.onehot_scales is not None:
                packed.onehot_scales[i][j] = tb.table_scale(key, tid)


def fill_take(buf: torch.Tensor, layout, cfg, key: int, storage: str,
              chunk_rows: int = 1 << 19) -> None:
    """The take buffer in place: for each (table, stripe) segment of
    ``take_segments``, buffer row P holds physical row pr = (P - start) *
    S + k, whose sub-row j is logical row pr * s + j (zero past the
    table's last row)."""
    from fleetrec_tpu_torch.models.biginit import take_segments

    S, n, dev = layout.take_stripes, buf.shape[0], buf.device
    group_of = {tid: g for g in layout.take_groups for tid in g.table_ids}
    rows_of = {t.table_id: t.rows for t in cfg.tables}
    zero = torch.zeros((), dtype=buf.dtype, device=dev)
    for tid, start, span, k in take_segments(layout, cfg):
        s, d = group_of[tid].rows_per_phys, group_of[tid].dim
        t = torch.tensor(tid, device=dev)
        end = min(start + span, n)
        for c0 in range(start, end, chunk_rows):
            c1 = min(c0 + chunk_rows, end)
            pr = torch.arange(c0 - start, c1 - start, device=dev) * S + k
            r = pr[:, None] * s + torch.arange(s, device=dev)
            v = torch.where((r < rows_of[tid])[..., None], tb.values(key, t, r, d, storage), zero)
            buf[c0:c1, :s * d].unflatten(1, (s, d)).copy_(v)


def take_scales(packed, layout, key: int) -> None:
    if packed.take_scales is not None:
        tids = [tid for g in layout.take_groups for tid in g.table_ids]
        packed.take_scales.copy_(torch.tensor([tb.table_scale(key, t) for t in tids],
                                              dtype=torch.float32))


def build_packed(cfg, plan, seed: int, device):
    """The port's PackedTables of ``cfg`` on ``device`` holding the
    harness's values for ``seed``."""
    from fleetrec_tpu_torch.models import pack_pm1_sharded

    lay = plan.layout
    key = tb.seed_key(seed)
    packed = pack_pm1_sharded(cfg, lay, device=device)
    rows_of = {t.table_id: t.rows for t in cfg.tables}
    fill_classes(packed, lay, key, cfg.table_dtype, rows_of)
    if packed.take_buffer is not None:
        fill_take(packed.take_buffer, lay, cfg, key, cfg.table_dtype)
    take_scales(packed, lay, key)
    return packed


def build_model(cfg, model: dict, seed: int, device):
    """A FleetRecModel on ``device`` of the configuration's ``model``
    block: tables and weights from ``seed`` (``tables.head_weights``; the
    cross layers [W, b] or [U, V, b] a layer, the port's format)."""
    from fleetrec_tpu_torch.models import FleetRecModel, ModelPlan

    plan = ModelPlan.create(cfg)
    packed = build_packed(cfg, plan, seed, device)
    w = tb.head_weights(seed, model, device)
    takes = inspect.signature(FleetRecModel).parameters
    biases = {k: w[k] for k in ("mlp_bias", "bottom_bias") if w[k] and k in takes}
    return FleetRecModel(plan, packed, w["mlp"], bottom=w["bottom"], cross=w["cross"], **biases)
