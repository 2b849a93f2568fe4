"""Checkpoints, the port of ``fleetrec_tpu/io.py``:

* ``config_fingerprint``, ``quantize_tables``, ``save_npz`` and
  ``load_npz`` port the functions of the same names;
* ``save_sharded`` / ``load_sharded`` port ``save_orbax`` / ``load_orbax``
  on ``torch.distributed.checkpoint`` (DCP), which ships with torch, as
  orbax ships with JAX.

Both formats hold the same arrays, named and shaped by ``_expected_arrays``:
the packed buffers as the JAX package writes them (``onehot_<i>``,
``take``, ``onehot_scale_<i>`` [n, 1, 1], ``take_scales``, ``mlp_<i>``, and
for the interaction heads ``bottom_<i>`` and ``cross_<layer>_<j>``, 2 or 3
arrays a layer by ``cross_rank``), the names ``trainable_tensors`` gives
plus the int8 scales, so a restored model or mesh trains on; and
``config_fingerprint``, the same digest for the same config.  npz files
cross between the two packages both ways; sharded checkpoints do not cross
with orbax's.

A sharded checkpoint is a DCP directory plus the side file
``fleetrec_config.json`` (``{"name", "fingerprint"}``, as ``save_orbax``
writes it).  It holds global arrays only, never a shard's padding (the
zero tables and rows past the real ones, the pad tables' int8 scale 1.0),
so one checkpoint restores onto any (data, model) mesh and onto one device:

* from one device each array is a plain tensor;
* from a mesh each rank writes only the valid rows of its class tables,
  their scales and its take window, as ``DTensor`` s placed ``Shard(0)``
  over the model axis (and ``Replicate()`` over the data axis) of a
  ``DeviceMesh`` over the mesh's own process groups; the replicated weights
  and ``take_scales`` are plain tensors, written once;
* either way, an array of more than ``BLOCK_BYTES`` is stored in row
  blocks of at most that size, since DCP reads a stored piece whole into
  host memory before it copies the rows asked for: a rank's restore then
  holds at most one block more than its window on the host.

``load_sharded`` checks the fingerprint and every array's global shape
and dtype in the checkpoint's metadata before it reads a byte of an
array, then reads each array in place into tensors allocated on the
device: on a mesh each rank reads only its window, into a view of the
valid rows of its buffers (``parallel/sharded.py::empty_operands``, whose
padding stays as ``packed_operands`` makes it), so no whole model exists
on the host or on any card.  No optimizer state is saved: the JAX package
checkpoints parameters only.  ``load_orbax`` re-folds ``w1_fold`` after a
restore; the port stages no fold (``parallel/sharded.py``), so that step
has nothing to port.

Two rules of the npz path the reference lacks:

* ``load_npz`` checks every array's shape against the model's layout and
  raises ``ConfigMismatchError`` naming the array (``load_sharded`` does
  the same).  The fingerprint alone cannot catch every wrong geometry: it
  leaves out ``onehot_factor_max`` and ``onehot_r2``, which move tables
  between tiers and reshape the factored classes.  (The fingerprint stays
  the reference's, so that files keep crossing.)
* bfloat16 arrays are written as ``|V2`` (their uint16 bits, what numpy
  makes of JAX's bfloat16) and ``|V2`` arrays are read back through a
  uint16 view.  The JAX package cannot read such files back.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import os
from typing import Dict, Optional, Tuple, Union

import numpy as np
import torch
import torch.distributed.checkpoint as dcp
from torch.distributed.checkpoint.metadata import MetadataIndex, TensorStorageMetadata
from torch.distributed.checkpoint.planner import TensorWriteData, WriteItem, WriteItemType

from .models.embedding import (TORCH_DTYPES, PackedTables, _pow2_scale, class_tables,
                               plan_tensors)
from .models.fleetrec import FleetRecModel, ModelPlan, resolve_device, weight_shapes
from .parallel.mesh import Mesh
from .parallel.sharded import ShardedFleetRec, empty_operands

# a sharded checkpoint's side file, as save_orbax names it
CONFIG_FILE = "fleetrec_config.json"
# the largest piece of an array a sharded checkpoint stores (see the docstring)
BLOCK_BYTES = 1 << 28


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
    the towers' and cross layers' weights are shared, not copied."""
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
        take_scales=take_scales), model.mlp_weights, model.bottom_weights,
        model.cross_weights, mlp_bias=model.mlp_biases, bottom_bias=model.bottom_biases)


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


def _check_bias_free(model: FleetRecModel) -> None:
    """Checkpoints hold the JAX package's arrays, which have no tower biases."""
    if model.has_biases:
        raise ValueError("checkpoints hold bias-free towers; this model has tower biases")


def save_npz(path: str, model: FleetRecModel) -> None:
    """Write ``model``'s packed buffers, scales and MLP weights, with the
    fingerprint of its config, under the JAX package's array names."""
    _check_bias_free(model)
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
    for i, w in enumerate(model.bottom_weights):
        arrs[f"bottom_{i}"] = _to_numpy(w)
    for li, layer in enumerate(model.cross_weights):
        for j, w in enumerate(layer):
            arrs[f"cross_{li}_{j}"] = _to_numpy(w)
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
    weights = weight_shapes(cfg)
    for tower in ("mlp", "bottom"):
        for i, shape in enumerate(weights[tower]):
            out[f"{tower}_{i}"] = shape
    for li, layer in enumerate(weights["cross"]):
        for j, shape in enumerate(layer):
            out[f"cross_{li}_{j}"] = shape
    return out


def load_npz(path: str, cfg, device="cuda") -> FleetRecModel:
    """Build the FleetRecModel for ``cfg`` on ``device`` (the card unless
    the caller asks for the CPU; without a card, "cuda" raises) from a
    save_npz file (of either package).  Raises ConfigMismatchError when the stored
    fingerprint is not ``cfg``'s, or an array is missing or has a shape
    other than the layout's."""
    device = resolve_device(device)
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
            got[name] = _to_tensor(arr, _array_dtype(name, cfg), device)
    return _model(plan, got, device)


def _array_dtype(name: str, cfg) -> torch.dtype:
    """The dtype the model holds array ``name`` of a checkpoint in."""
    if name.startswith(("mlp_", "bottom_", "cross_")):
        return TORCH_DTYPES[cfg.dtype]
    if "scale" in name:
        return torch.float32
    return TORCH_DTYPES[cfg.table_dtype]


def _model(plan: ModelPlan, got: Dict[str, torch.Tensor], device) -> FleetRecModel:
    """The FleetRecModel over the arrays ``got`` (name -> tensor on
    ``device``, ``_expected_arrays``' names and shapes), used as they are."""
    lay, cfg = plan.layout, plan.cfg
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
    mlp, bottom, cross = _weights(cfg, got)
    return FleetRecModel(plan, packed, mlp, bottom, cross)


def _weights(cfg, got: Dict[str, torch.Tensor]):
    """(mlp, bottom, cross) of ``cfg`` from the arrays ``got`` by name."""
    weights = weight_shapes(cfg)
    mlp, bottom = ([got[f"{tower}_{i}"] for i in range(len(weights[tower]))]
                   for tower in ("mlp", "bottom"))
    cross = [[got[f"cross_{li}_{j}"] for j in range(len(layer))]
             for li, layer in enumerate(weights["cross"])]
    return mlp, bottom, cross


# ---- sharded checkpoints (torch.distributed.checkpoint) ---------------------

def checkpoint_tensors(target: Union[FleetRecModel, ShardedFleetRec]
                       ) -> Dict[str, torch.Tensor]:
    """The arrays a sharded checkpoint holds of ``target``, by name
    (``_expected_arrays``' names), as views of its own tensors: the class
    tables, the take buffer, the int8 scales (a class's as [n, 1, 1]), the
    weights.  A ShardedFleetRec gives its split arrays at the valid rows of
    its shard, without the padding: a class's tables (and scales) ``lo ..
    hi`` of ``class_tables(n, m, M)``, and the same split of the take
    buffer's physical rows."""
    if isinstance(target, ShardedFleetRec):
        ops = target.operands
        weights = (target.mlp, target.bottom, target.cross)
        m, M = target.mesh.m, target.mesh.model
    else:
        _check_bias_free(target)
        ops = target.lookup_operands()
        weights = (target.mlp_weights, target.bottom_weights, target.cross_weights)
        m, M = 0, 1
    plan, bufs, scales = target.plan, ops["bufs"], ops["scales"]
    n = len(plan.layout.onehot_classes)
    out = {f"onehot_{i}": b for i, b in enumerate(bufs[:n])}
    if len(bufs) > n:
        out["take"] = bufs[n]
    if scales is not None:
        out.update({f"onehot_scale_{i}": s.reshape(-1, 1, 1) for i, s in enumerate(scales[:n])})
        if len(scales) > n:
            out["take_scales"] = scales[n]
    mlp, bottom, cross = weights
    out.update({f"mlp_{i}": w for i, w in enumerate(mlp)})
    out.update({f"bottom_{i}": w for i, w in enumerate(bottom)})
    out.update({f"cross_{li}_{j}": w for li, layer in enumerate(cross)
                for j, w in enumerate(layer)})
    for name, t in out.items():
        rows = split_rows(name, plan)
        if rows is not None:
            lo, hi = class_tables(rows, m, M)
            out[name] = t[:hi - lo]
    return out


def split_rows(name: str, plan: ModelPlan) -> Optional[int]:
    """The global rows of array ``name`` that a mesh splits over its model
    axis (a class's tables, or its scales; the take buffer's physical
    rows), None for a replicated array."""
    lay = plan.layout
    if name == "take":
        return lay.take_phys_total
    if name.startswith("onehot_"):
        return lay.onehot_classes[int(name.rsplit("_", 1)[1])].num_tables
    return None


def _is_distributed(mesh: Mesh) -> bool:
    """A mesh of several ranks (a rank's arrays are slices of the global
    ones); a (1, 1) mesh holds them whole."""
    return mesh.data * mesh.model > 1


def _global_arrays(shard: ShardedFleetRec) -> dict:
    """A rank's arrays as DCP saves and loads them on its mesh: each split
    array a ``DTensor`` over its valid rows (a view, so a load fills the
    shard's buffer in place), ``Shard(0)`` over the model axis and
    ``Replicate()`` over the data axis, at its global shape; the replicated
    arrays as they are.  ``DTensor`` splits ``n`` rows over M ranks as the
    port does, ``ceil(n / M)`` a rank (``class_tables``).  The
    ``DeviceMesh`` is made over the mesh's own process groups
    (``from_group``), so no new communicator is made."""
    from torch.distributed.device_mesh import DeviceMesh
    from torch.distributed.tensor import DTensor, Replicate, Shard

    mesh = shard.mesh
    want = _expected_arrays(shard.plan)
    ranks = torch.arange(mesh.data * mesh.model)
    if mesh.data == 1:
        dmesh = DeviceMesh.from_group(mesh.group, mesh.device.type, mesh=ranks,
                                      mesh_dim_names=("model",))
        placements = [Shard(0)]
    else:
        dmesh = DeviceMesh.from_group([mesh.col_group, mesh.group], mesh.device.type,
                                      mesh=ranks.reshape(mesh.data, mesh.model),
                                      mesh_dim_names=("data", "model"))
        placements = [Replicate(), Shard(0)]
    out = {}
    for name, t in checkpoint_tensors(shard).items():
        if split_rows(name, shard.plan) is None:
            out[name] = t
        else:
            shape = torch.Size(want[name])
            out[name] = DTensor.from_local(t, dmesh, placements, run_check=False, shape=shape,
                                           stride=torch.empty(shape, device="meta").stride())
    return out


class _BlockSavePlanner(dcp.DefaultSavePlanner):
    """DCP's default save plan with each tensor piece of more than
    ``BLOCK_BYTES`` split into row blocks of at most that size, each block
    a chunk of the array in the checkpoint's metadata."""

    def create_local_plan(self):
        plan = super().create_local_plan()
        self._blocks = {}
        items = []
        for item in plan.items:
            data = item.tensor_data
            if item.type == WriteItemType.BYTE_IO or not data.chunk.sizes:
                items.append(item)
                continue
            sizes, offsets = data.chunk.sizes, data.chunk.offsets
            row_bytes = data.properties.dtype.itemsize * int(np.prod(sizes[1:], dtype=np.int64))
            step = max(1, BLOCK_BYTES // max(row_bytes, 1))
            if sizes[0] <= step:
                items.append(item)
                continue
            for lo in range(0, sizes[0], step):
                off = torch.Size([offsets[0] + lo, *offsets[1:]])
                size = torch.Size([min(step, sizes[0] - lo), *sizes[1:]])
                block = WriteItem(
                    index=MetadataIndex(item.index.fqn, off), type=WriteItemType.SHARD,
                    tensor_data=TensorWriteData(
                        chunk=dcp.ChunkStorageMetadata(offsets=off, sizes=size),
                        properties=data.properties, size=data.size))
                self._blocks[block.index] = (item.index, lo, size[0])
                items.append(block)
        self.plan = dataclasses.replace(plan, items=items)
        return self.plan

    def resolve_data(self, write_item):
        block = self._blocks.get(write_item.index)
        if block is None:
            return super().resolve_data(write_item)
        index, lo, n = block
        return self.lookup_object(index).narrow(0, lo, n)


def save_sharded(path: str, target: Union[FleetRecModel, ShardedFleetRec]) -> None:
    """Write ``target``'s arrays (``_expected_arrays``' names at their global
    shapes) as a DCP checkpoint in the directory ``path``, with the side
    file ``fleetrec_config.json``.  A ``FleetRecModel`` is one process's
    call; a ``ShardedFleetRec`` on a mesh of several ranks is every rank's
    call (each writes its shard's valid rows, the replicated arrays are
    written once), one built by ``from_packed`` too."""
    cfg = target.cfg
    distributed = isinstance(target, ShardedFleetRec) and _is_distributed(target.mesh)
    if not distributed or target.mesh.rank == 0:
        # before the save: every rank has left dcp.save once the checkpoint
        # is whole, side file included
        os.makedirs(path, exist_ok=True)
        with open(os.path.join(path, CONFIG_FILE), "w") as f:
            json.dump({"name": cfg.name, "fingerprint": config_fingerprint(cfg)}, f)
    arrays = _global_arrays(target) if distributed else checkpoint_tensors(target)
    dcp.save(arrays, storage_writer=dcp.FileSystemWriter(path), planner=_BlockSavePlanner(),
             no_dist=not distributed)


def _check_sharded(path: str, cfg, want: Dict[str, Tuple[int, ...]]) -> None:
    """Raise ConfigMismatchError unless the checkpoint at ``path`` was saved
    for ``cfg`` (its side file's fingerprint, when it has one) and holds
    every array of ``want`` at its shape and in the dtype ``cfg`` keeps it
    in; reads the metadata only."""
    side = os.path.join(path, CONFIG_FILE)
    if os.path.exists(side):
        with open(side) as f:
            stored = json.load(f)["fingerprint"]
        mine = config_fingerprint(cfg)
        if stored != mine:
            raise ConfigMismatchError(
                f"checkpoint {path} was saved for a different model geometry (stored "
                f"fingerprint {stored[:12]}, config '{cfg.name}' is {mine[:12]})")
    meta = dcp.FileSystemReader(path).read_metadata().state_dict_metadata
    for name, shape in want.items():
        md = meta.get(name)
        if not isinstance(md, TensorStorageMetadata):
            raise ConfigMismatchError(
                f"checkpoint {path} has no array {name!r}, which config '{cfg.name}' needs "
                f"with shape {shape}")
        if tuple(md.size) != shape:
            raise ConfigMismatchError(
                f"checkpoint {path}: array {name!r} has shape {tuple(md.size)}, the layout "
                f"of config '{cfg.name}' needs {shape}")
        dtype = _array_dtype(name, cfg)
        if md.properties.dtype != dtype:
            raise ConfigMismatchError(
                f"checkpoint {path}: array {name!r} is {md.properties.dtype}, config "
                f"'{cfg.name}' keeps it in {dtype}")


def load_sharded(path: str, cfg, device="cuda", mesh: Optional[Mesh] = None
                 ) -> Union[FleetRecModel, ShardedFleetRec]:
    """Restore a ``save_sharded`` checkpoint (saved from one device or from
    any mesh) for ``cfg``: a FleetRecModel on ``device`` (the card unless
    the caller asks for the CPU; without a card, "cuda" raises), or with
    ``mesh`` this rank's ShardedFleetRec on the mesh's device (every rank of
    the mesh calls it).  Raises ConfigMismatchError, before reading an
    array, when the stored fingerprint is not ``cfg``'s or an array is
    missing or of another shape or dtype.  Every array is read in place
    into tensors allocated on the device, on a mesh only this rank's
    window of each split array."""
    if mesh is None:
        device = resolve_device(device)
    plan = ModelPlan.create(cfg)
    want = _expected_arrays(plan)
    _check_sharded(path, cfg, want)
    reader = dcp.FileSystemReader(path)
    if mesh is None:
        got = {name: torch.zeros(shape, dtype=_array_dtype(name, cfg), device=device)
               for name, shape in want.items()}
        dcp.load(got, storage_reader=reader, no_dist=True)
        return _model(plan, got, device)
    dev = mesh.device
    weights = {name: torch.zeros(shape, dtype=_array_dtype(name, cfg), device=dev)
               for name, shape in want.items() if name.startswith(("mlp_", "bottom_", "cross_"))}
    shard = ShardedFleetRec.from_operands(plan, mesh, empty_operands(plan, mesh.m, mesh.model, dev),
                                          *_weights(cfg, weights))
    distributed = _is_distributed(mesh)
    dcp.load(_global_arrays(shard) if distributed else checkpoint_tensors(shard),
             storage_reader=reader, no_dist=not distributed)
    return shard
