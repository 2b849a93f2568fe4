"""npz checkpoints, the port of ``fleetrec_tpu/io.py``'s npz path.

A checkpoint holds the packed buffers as the JAX package writes them
(``onehot_<i>``, ``take``, ``onehot_scale_<i>`` [n, 1, 1], ``take_scales``,
``mlp_<i>``) and ``config_fingerprint``, the same digest for the same
config, so files cross between the two packages both ways.  Orbax
checkpoints (``save_orbax`` / ``load_orbax``) are JAX-only and not ported.

Two rules the reference lacks:

* ``load_npz`` checks every array's shape against the model's layout and
  raises ``ConfigMismatchError`` naming the array.  The fingerprint alone
  cannot catch every wrong geometry: it leaves out ``onehot_factor_max``
  and ``onehot_r2``, which move tables between tiers and reshape the
  factored classes.  (The fingerprint stays the reference's, so that files
  keep crossing.)
* bfloat16 arrays are written as ``|V2`` (their uint16 bits, what numpy
  makes of JAX's bfloat16) and ``|V2`` arrays are read back through a
  uint16 view.  The JAX package cannot read such files back.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
from typing import Dict, Tuple

import numpy as np
import torch

from .models.embedding import TORCH_DTYPES, PackedTables, _pow2_scale, plan_tensors
from .models.fleetrec import FleetRecModel, ModelPlan


def config_fingerprint(cfg) -> str:
    """Digest of what shapes the packed parameter buffers (table geometry,
    feature layout, MLP widths, dtypes), the JAX package's blob field by
    field, so both packages give the same hex digest."""
    blob = {
        "tables": [
            [t.table_id, t.rows, t.dim, t.out_offset] for t in cfg.tables
        ],
        "mlp": list(cfg.mlp.widths),
        "use_bias": cfg.mlp.use_bias,
        "activation": cfg.mlp.activation,
        "dense_dim": cfg.dense_dim,
        "dtype": cfg.dtype,
        "table_dtype": cfg.table_dtype,
        "take_lanes": cfg.take_lanes,
        "onehot_max": cfg.onehot_max,
        "take_stripes": cfg.take_stripes,
    }
    if cfg.qr_rem:
        blob["qr"] = [cfg.qr_threshold, cfg.qr_rem]
    if cfg.interaction != "none":
        blob["interaction"] = cfg.interaction
        blob["bottom_mlp"] = (
            list(cfg.bottom_mlp.widths) if cfg.bottom_mlp is not None else None
        )
        if cfg.interaction == "cross":
            blob["cross"] = [cfg.cross_layers, cfg.cross_rank]
    data = json.dumps(blob, sort_keys=True, separators=(",", ":")).encode()
    return hashlib.sha256(data).hexdigest()


class ConfigMismatchError(ValueError):
    """A checkpoint does not fit the model it is loaded into."""


def _int8(arr: np.ndarray, scale) -> np.ndarray:
    return np.clip(np.rint(arr / scale), -127, 127).astype(np.int8)


def quantize_tables(model: FleetRecModel) -> FleetRecModel:
    """Float tables -> int8 tables with per-table power-of-two scales, the
    same bytes and scales as the JAX package's ``quantize_tables``: each
    class table over its slice of the class buffer, each take table over
    its own physical rows of the unified buffer.  Returns a new model on
    the same device whose config stores int8 (``table_dtype="int8"``);
    the MLP weights are shared, not copied."""
    packed = model.packed
    if model.cfg.table_dtype == "int8" or packed.onehot_scales is not None:
        raise ValueError("the tables are already int8-quantized")
    layout = model.layout
    dev = model.device

    oh_bufs, oh_scales = [], []
    for buf in packed.onehot_buffers:
        b = buf.float().cpu().numpy()
        scales = np.asarray([_pow2_scale(b[j]) for j in range(b.shape[0])],
                            np.float32)
        oh_bufs.append(torch.from_numpy(
            _int8(b, scales.reshape(-1, *([1] * (b.ndim - 1))))).to(dev))
        oh_scales.append(torch.from_numpy(scales).to(dev))

    take = take_scales = None
    if packed.take_buffer is not None:
        tb = packed.take_buffer.float().cpu().numpy()
        out = np.zeros(tb.shape, np.int8)
        S, H = layout.take_stripes, layout.stripe_height
        # QR configs pack over the internal specs (Q and hidden R tables)
        by_id = {t.table_id: t for t in (model.plan.spec_tables or model.cfg.tables)}
        sc = []
        for g in layout.take_groups:
            s = g.rows_per_phys
            for tid, base in zip(g.table_ids, g.base_phys):
                pr = np.arange(-(-by_id[tid].rows // s))
                rows = ((pr % S) * H + base + pr // S) if S > 1 else (base + pr)
                seg = tb[rows]
                scale = _pow2_scale(seg)
                out[rows] = _int8(seg, scale)
                sc.append(scale)
        take = torch.from_numpy(out).to(dev)
        take_scales = torch.from_numpy(np.asarray(sc, np.float32)).to(dev)

    plan = dataclasses.replace(
        model.plan, cfg=dataclasses.replace(model.cfg, table_dtype="int8"))
    return FleetRecModel(plan, PackedTables(
        layout=layout, onehot_buffers=oh_bufs, take_buffer=take,
        plan=plan_tensors(layout, dev), onehot_scales=oh_scales,
        take_scales=take_scales), model.mlp_weights)


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    """Host copy of a tensor; bfloat16 as ``|V2`` (its uint16 bits)."""
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16).view("V2")
    return t.numpy()


def _to_tensor(arr: np.ndarray, dtype: torch.dtype, device) -> torch.Tensor:
    """An array read from a checkpoint -> ``dtype`` on ``device``; ``|V2``
    arrays are bfloat16 bits."""
    if arr.dtype.kind == "V" and arr.dtype.itemsize == 2:
        t = torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.ascontiguousarray(arr))
    return t.to(device=device, dtype=dtype)


def save_npz(path: str, model: FleetRecModel) -> None:
    """Write ``model``'s packed buffers, scales and MLP weights, with the
    fingerprint of its config, under the JAX package's array names."""
    packed = model.packed
    arrs = {"config_fingerprint": np.frombuffer(
        config_fingerprint(model.cfg).encode(), dtype=np.uint8)}
    for i, b in enumerate(packed.onehot_buffers):
        arrs[f"onehot_{i}"] = _to_numpy(b)
    if packed.take_buffer is not None:
        arrs["take"] = _to_numpy(packed.take_buffer)
    if packed.onehot_scales is not None:
        # the JAX package keeps class scales as [n, 1, 1]
        for i, sc in enumerate(packed.onehot_scales):
            arrs[f"onehot_scale_{i}"] = _to_numpy(sc).reshape(-1, 1, 1)
        if packed.take_scales is not None:
            arrs["take_scales"] = _to_numpy(packed.take_scales)
    for i, w in enumerate(model.mlp_weights):
        arrs[f"mlp_{i}"] = _to_numpy(w)
    np.savez(path, **arrs)


def _expected_arrays(plan: ModelPlan) -> Dict[str, Tuple[int, ...]]:
    """Name -> shape of every array a checkpoint of this model holds."""
    cfg, lay = plan.cfg, plan.layout
    out = {}
    for i, c in enumerate(lay.onehot_classes):
        out[f"onehot_{i}"] = ((c.num_tables, c.r1, c.r2 * c.dim) if c.r2
                              else (c.num_tables, c.rows_pad, c.dim))
    if lay.take_phys_total:
        out["take"] = (lay.take_phys_total, lay.take_lanes)
    if cfg.table_dtype == "int8":
        for i, c in enumerate(lay.onehot_classes):
            out[f"onehot_scale_{i}"] = (c.num_tables, 1, 1)
        if lay.take_groups:
            out["take_scales"] = (lay.n_take,)
    w = cfg.mlp.widths
    for i in range(len(w) - 1):
        out[f"mlp_{i}"] = (w[i], w[i + 1])
    return out


def load_npz(path: str, cfg, device="cpu") -> FleetRecModel:
    """Build the FleetRecModel for ``cfg`` on ``device`` from a save_npz
    file (of either package).  Raises ConfigMismatchError when the stored
    fingerprint is not ``cfg``'s, or an array is missing or has a shape
    other than the layout's."""
    tdtype, mdtype = TORCH_DTYPES[cfg.table_dtype], TORCH_DTYPES[cfg.dtype]
    got = {}
    with np.load(path) as data:
        if "config_fingerprint" in data:
            stored = bytes(data["config_fingerprint"]).decode()
            mine = config_fingerprint(cfg)
            if stored != mine:
                raise ConfigMismatchError(
                    f"checkpoint {path} was saved for a different model "
                    f"geometry (stored fingerprint {stored[:12]}, config "
                    f"'{cfg.name}' is {mine[:12]})")
        plan = ModelPlan.create(cfg)
        want = _expected_arrays(plan)
        for name, shape in want.items():
            if name not in data:
                raise ConfigMismatchError(
                    f"checkpoint {path} has no array {name!r}, which config "
                    f"'{cfg.name}' needs with shape {shape}")
            arr = data[name]
            if arr.shape != shape:
                raise ConfigMismatchError(
                    f"checkpoint {path}: array {name!r} has shape "
                    f"{arr.shape}, the layout of config '{cfg.name}' needs "
                    f"{shape}")
            if name.startswith("mlp_"):
                dtype = mdtype
            elif "scale" in name:
                dtype = torch.float32
            else:
                dtype = tdtype
            got[name] = _to_tensor(arr, dtype, device)
    lay = plan.layout
    n = len(lay.onehot_classes)
    quant = cfg.table_dtype == "int8"
    packed = PackedTables(
        layout=lay,
        onehot_buffers=[got[f"onehot_{i}"] for i in range(n)],
        take_buffer=got.get("take"),
        plan=plan_tensors(lay, device),
        onehot_scales=([got[f"onehot_scale_{i}"].reshape(-1) for i in range(n)]
                       if quant else None),
        take_scales=got.get("take_scales"),
    )
    mlp = [got[f"mlp_{i}"] for i in range(len(cfg.mlp.widths) - 1)]
    return FleetRecModel(plan, packed, mlp)
