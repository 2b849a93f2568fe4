"""Placement planner, the port of ``fleetrec_tpu/parallel/planner.py``:
given a ModelConfig, a model-axis size and a per-card memory budget, where
every byte of the port's sharded model lands, whether it fits, and how
evenly the take rows' lookups spread, computed on the host before anything
is built.

It accounts for what the port allocates on a card
(``parallel/sharded.py::packed_operands``):

* the unified take buffer, padded to a multiple of the model axis and split
  into equal row ranges (the layout is the JAX package's byte for byte, so
  take bytes and shard row ranges are the JAX planner's);
* each one-hot / factored class's table axis, padded likewise and split into
  ``ceil(n / M)``-table blocks, at its logical bytes: a class buffer is
  ``[n, rows_pad, dim]`` (factored ``[n, R1, r2 * dim]``, the same bytes) in
  a flat allocation.  The JAX planner pads the minor dim to the TPU's 128
  lanes and the second-minor to its sublane tile (the "128/dim bloat" of a
  plain class); a CUDA allocation has neither;
* the weights, replicated (``mlp_bytes``: the tower's and, for the
  interaction heads, the bottom tower's and the cross layers', where the JAX
  planner counts the top tower only).  ``w1_fold_bytes`` is 0: the port
  stages no W1 fold (the sharded forward multiplies its features by W1
  itself);
* a rough working set of ``max_in_flight`` forwards: the ids, the fused
  lookup's ``[B, F]`` float32 features and the tower's two widest
  activations (the fused lookup gathers no rows into an intermediate).

The layout is the model's (``ModelPlan.create``), so a DLRM config's take
and classes are planned over its dense-free ``[B, T * D]`` lookup, which the
JAX planner cannot build.

The default budget is one H100's memory (``H100_HBM_BYTES``).
``split_table_columns`` / ``split_table_data`` are the JAX package's
column split of a table, unchanged.  ``cli plan`` prints a plan as JSON.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import numpy as np

from ..config import ModelConfig, TableSpec
from ..models.fleetrec import ModelPlan, weight_shapes

# torch.cuda.get_device_properties(0).total_memory of an NVIDIA H100 80GB
# HBM3 (SXM, 700 W power limit): 79.18 GiB
H100_HBM_BYTES = 85_017_493_504

_ITEMSIZE = {"float32": 4, "bfloat16": 2, "float16": 2, "int8": 1}


@dataclasses.dataclass(frozen=True)
class ShardReport:
    """One model shard's slice of the unified take buffer plus its
    partition of the one-hot / factored classes."""

    shard: int
    phys_row_start: int
    phys_row_end: int
    take_bytes: int
    # table ids with at least one physical row on this shard
    tables_touched: Tuple[int, ...]
    # expected fraction of all take lookups this shard serves when every
    # table's ids are uniform over its rows (1/n_model = perfectly flat)
    uniform_load_frac: float
    # one-hot / factored table ids this shard holds, in class order
    # (embedding.class_tables' contiguous split)
    onehot_tables: Tuple[int, ...] = ()


@dataclasses.dataclass(frozen=True)
class PlacementPlan:
    config_name: str
    n_model: int
    table_dtype: str
    # per-card byte accounting
    onehot_bytes: int          # total across shards (table-axis sharded)
    onehot_bytes_per_chip: int  # this card's class partition (pad tables included)
    mlp_bytes: int             # replicated on every card
    w1_fold_bytes: int         # 0: the port stages no W1 fold
    take_bytes_total: int      # across all shards
    take_bytes_per_chip: int   # row-sharded slice
    activation_bytes: int      # rough per-batch working set (B rows in flight)
    per_chip_bytes: int
    hbm_budget_bytes: int
    fits: bool
    # smallest model-axis size at which per-card bytes fit the budget
    # (0 = does not fit at any size: replicated parts alone exceed budget)
    min_model_shards: int
    shards: Tuple[ShardReport, ...]
    notes: Tuple[str, ...]

    def to_json(self) -> dict:
        d = dataclasses.asdict(self)
        d["shards"] = [dataclasses.asdict(s) for s in self.shards]
        return d


def plan(
    cfg: ModelConfig,
    n_model: int,
    hbm_budget_bytes: int = H100_HBM_BYTES,
    batch_size: Optional[int] = None,
    max_in_flight: int = 2,
) -> PlacementPlan:
    """Byte-accurate placement accounting for ``cfg`` on ``n_model`` shards
    (module docstring)."""
    B = batch_size or cfg.batch_size
    mplan = ModelPlan.create(cfg)
    layout, eff_tables = mplan.layout, mplan.spec_tables
    isz = _ITEMSIZE[cfg.table_dtype]

    # a class buffer's logical bytes, plain or factored alike: no lane or
    # sublane padding on the card
    onehot_bytes = 0
    onehot_bytes_per_chip = 0
    for c in layout.onehot_classes:
        per_table = c.rows_pad * c.dim * isz
        onehot_bytes += c.num_tables * per_table
        onehot_bytes_per_chip += -(-c.num_tables // n_model) * per_table
    # every replicated weight: the towers' and the cross layers'
    shapes = weight_shapes(cfg)
    mlp_bytes = _ITEMSIZE[cfg.dtype] * sum(
        int(np.prod(sh)) for sh in shapes["mlp"] + shapes["bottom"]
        + [sh for layer in shapes["cross"] for sh in layer])
    w = cfg.mlp.widths
    w1_fold_bytes = 0

    phys_total = layout.take_phys_total
    phys_pad = -(-phys_total // n_model) * n_model if phys_total else 0
    take_bytes_total = phys_pad * layout.take_lanes * isz
    rows_per_shard = phys_pad // n_model if n_model else 0
    take_bytes_per_chip = rows_per_shard * layout.take_lanes * isz

    # per-table physical ranges in the unified buffer; a striped layout
    # gives each table one range per stripe
    S, H = layout.take_stripes, layout.stripe_height
    ranges: List[Tuple[int, List[Tuple[int, int]], int]] = []  # (tid, [(b, e)], rows)
    by_id = {t.table_id: t for t in eff_tables}
    for g in layout.take_groups:
        s = g.rows_per_phys
        for tid, base in zip(g.table_ids, g.base_phys):
            pr = -(-by_id[tid].rows // s)
            if S > 1:
                span = -(-pr // S)
                rs = [(k * H + base, k * H + base + span) for k in range(S)]
            else:
                rs = [(base, base + pr)]
            ranges.append((tid, rs, pr))

    n_take = layout.n_take
    shards = []
    for s in range(n_model):
        lo, hi = s * rows_per_shard, (s + 1) * rows_per_shard
        touched = []
        load = 0.0
        for tid, rs, pr in ranges:
            ov = sum(max(0, min(e, hi) - max(b, lo)) for b, e in rs)
            if ov:
                touched.append(tid)
                # each take table makes 1/n_take of the lookups; a uniform id
                # lands on this shard w.p. overlap / table rows
                load += (ov / pr) / max(n_take, 1)
        oh_owned: List[int] = []
        for c in layout.onehot_classes:
            n_loc = -(-c.num_tables // n_model)
            oh_owned.extend(c.table_ids[s * n_loc : (s + 1) * n_loc])
        shards.append(
            ShardReport(
                shard=s,
                phys_row_start=lo,
                phys_row_end=hi,
                take_bytes=take_bytes_per_chip,
                tables_touched=tuple(touched),
                uniform_load_frac=round(load, 6),
                onehot_tables=tuple(oh_owned),
            )
        )

    # rough working set of a forward: int64 ids, the fused lookup's float32
    # features, the tower's two widest activations (fp32 sums), x in flight
    act = B * (cfg.num_tables * 8 + (layout.feature_dim + 2 * max(w)) * 4)
    act *= max_in_flight

    replicated = mlp_bytes + w1_fold_bytes + act
    per_chip = replicated + take_bytes_per_chip + onehot_bytes_per_chip
    fits = per_chip <= hbm_budget_bytes
    avail = hbm_budget_bytes - replicated
    if avail <= 0:
        min_shards = 0
    elif take_bytes_total == 0 and onehot_bytes == 0:
        min_shards = 1
    else:
        # (take + class) bytes both divide by the model axis: solve
        # sharded_total / M <= avail (class padding ignored: at most one
        # table's bytes a class)
        sharded_total = phys_total * layout.take_lanes * isz + onehot_bytes
        min_shards = max(1, int(-(-sharded_total // avail)))

    notes = []
    if layout.take_phys_total:
        loads = [sh.uniform_load_frac for sh in shards]
        imb = max(loads) / (sum(loads) / len(loads)) if sum(loads) else 1.0
        if imb > 1.25:
            notes.append(
                f"uniform-traffic lookup load imbalance {imb:.2f}x: set "
                f"take_stripes={n_model} (striped layout balances by "
                "construction); split_table_columns also spreads a hot table"
            )
    if not fits and cfg.table_dtype == "float32":
        notes.append("tables are fp32: bfloat16 halves, int8 quarters, take bytes")
    if not fits and min_shards:
        notes.append(f"fits at n_model >= {min_shards}")

    return PlacementPlan(
        config_name=cfg.name,
        n_model=n_model,
        table_dtype=cfg.table_dtype,
        onehot_bytes=onehot_bytes,
        onehot_bytes_per_chip=onehot_bytes_per_chip,
        mlp_bytes=mlp_bytes,
        w1_fold_bytes=w1_fold_bytes,
        take_bytes_total=take_bytes_total,
        take_bytes_per_chip=take_bytes_per_chip,
        activation_bytes=act,
        per_chip_bytes=per_chip,
        hbm_budget_bytes=hbm_budget_bytes,
        fits=fits,
        min_model_shards=min_shards,
        shards=tuple(shards),
        notes=tuple(notes),
    )


def recommend(cfg: ModelConfig, chips: int, hbm_budget_bytes: int = H100_HBM_BYTES,
              batch_size: Optional[int] = None) -> Tuple[Optional[int], PlacementPlan]:
    """The (data, model) split of ``chips`` cards: the smallest model axis
    dividing ``chips`` whose plan fits (it divides the table bytes; the
    data axis divides the batch).  Returns (model axis or None, its plan or
    the plan of the whole ``chips``-way model axis when none fits)."""
    p = None
    for m in [d for d in range(1, chips + 1) if chips % d == 0]:
        p = plan(cfg, n_model=m, hbm_budget_bytes=hbm_budget_bytes, batch_size=batch_size)
        if p.fits:
            return m, p
    return None, p


def split_table_columns(
    cfg: ModelConfig, table_id: int, parts: int
) -> Tuple[ModelConfig, np.ndarray]:
    """Column-shard one table: dim d -> ``parts`` tables of dim d/parts.

    Returns (new_cfg, index_map) where ``index_map`` expands an index
    matrix in the OLD config's column order to the new one:
    ``new_indices = indices[:, index_map]`` (the split table's row id is
    duplicated into each part's column).  Table data splits with
    ``split_table_data``.  Exact: the parts cover disjoint column ranges
    [k*d/p, (k+1)*d/p) of the same rows at out_offset + k*d/p, so the
    concatenated feature vector is bit-identical.  The parts occupy
    different regions of the packed take buffer, so a hot or giant table's
    lookups spread over more row shards of the mesh."""
    dc = dataclasses
    by_pos = {t.table_id: i for i, t in enumerate(cfg.tables)}
    if table_id not in by_pos:
        raise ValueError(f"no table {table_id} in {cfg.name}")
    t = cfg.tables[by_pos[table_id]]
    if parts < 2 or t.dim % parts:
        raise ValueError(f"parts={parts} must divide dim={t.dim}")
    nd = t.dim // parts
    if nd not in (1, 2, 4, 8, 16, 32, 64, 128):
        raise ValueError(f"split dim {nd} unsupported")

    next_id = max(tt.table_id for tt in cfg.tables) + 1
    new_tables: List[TableSpec] = []
    index_map: List[int] = []
    for i, tt in enumerate(cfg.tables):
        if tt.table_id != table_id:
            new_tables.append(tt)
            index_map.append(i)
            continue
        for k in range(parts):
            new_tables.append(
                dc.replace(
                    tt,
                    table_id=tt.table_id if k == 0 else next_id + k - 1,
                    dim=nd,
                    out_offset=tt.out_offset + k * nd,
                )
            )
            index_map.append(i)
    new_cfg = dc.replace(
        cfg, name=f"{cfg.name}+split{table_id}x{parts}", tables=tuple(new_tables)
    )
    new_cfg.validate()
    return new_cfg, np.asarray(index_map, dtype=np.int64)


def split_table_data(
    tables_np: Sequence[np.ndarray], cfg: ModelConfig, table_id: int, parts: int
) -> List[np.ndarray]:
    """Split the [rows, dim] array of ``table_id`` into ``parts`` column
    slices, in the position order split_table_columns produces."""
    out: List[np.ndarray] = []
    for t, arr in zip(cfg.tables, tables_np):
        if t.table_id != table_id:
            out.append(arr)
            continue
        nd = t.dim // parts
        out.extend(arr[:, k * nd : (k + 1) * nd] for k in range(parts))
    return out
