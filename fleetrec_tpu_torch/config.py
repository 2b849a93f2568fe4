"""Model / table configuration — the port's copy of ``fleetrec_tpu/config.py``.

The port never imports the JAX package (its ``__init__`` imports jax), so
it carries this pure-Python module itself; ``tests/test_torch_config.py``
holds every factory equal to the original, field by field.  The configs'
JSON files are read from the JAX package's directory by path, not copied.

One dataclass tree describes the embedding tables (rows / dim / feature
offset — the VECTOR_START_IDX_* layout of the FPGA reference headers), the
packed-storage tiers, and the MLP tower.  The tier thresholds
(``onehot_max``, ``onehot_factor_max``, ``onehot_r2``, ``take_lanes``) were
tuned for the TPU package; the port keeps them so that its packed buffers
match the JAX package byte for byte, not as tuning for the GPU.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Dict, List, Optional, Tuple

import numpy as np

_CONFIG_DIR = os.path.join(os.path.dirname(__file__), os.pardir,
                           "fleetrec_tpu", "configs")

# Width of a packed take-buffer row (the TPU package's lane width): 128 //
# dim logical rows share one physical row.  Kept for layout equality.
LANES = 128


@dataclasses.dataclass(frozen=True)
class TableSpec:
    """One embedding table (one DATA_SIZE_*/TABLE_SIZE_* pair of the
    reference headers).  ``kind``/``bank`` record the reference's physical
    placement for provenance only."""

    table_id: int
    rows: int
    dim: int
    out_offset: int  # float offset in the concatenated feature vector
    kind: str = "HBM"  # reference memory kind (provenance only)
    bank: int = 0

    def __post_init__(self):
        assert self.dim in (1, 2, 4, 8, 16, 32, 64, 128) and self.dim <= LANES

    @property
    def rows_per_phys(self) -> int:
        return LANES // self.dim

    @property
    def phys_rows(self) -> int:
        return -(-self.rows // self.rows_per_phys)

    @property
    def nbytes(self) -> int:
        return self.rows * self.dim * 4


@dataclasses.dataclass(frozen=True)
class MLPSpec:
    """The dense scoring tower: input -> hidden... -> out, a bias-free
    matmul chain by default (the reference's four cublasLtMatmul calls),
    so the closed-form parity constants hold."""

    input_dim: int
    hidden: Tuple[int, ...]
    out_dim: int = 1
    use_bias: bool = False
    activation: Optional[str] = None  # None = pure matmul chain (reference)

    @property
    def widths(self) -> Tuple[int, ...]:
        return (self.input_dim,) + tuple(self.hidden) + (self.out_dim,)

    @property
    def flops_per_query(self) -> int:
        w = self.widths
        return 2 * sum(a * b for a, b in zip(w[:-1], w[1:]))


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """Full model: multi-table embedding lookup + concat + MLP."""

    name: str
    tables: Tuple[TableSpec, ...]
    mlp: MLPSpec
    # Dense (non-embedding) features appended at the tail of the feature
    # vector — the reference's CPU-node slice.
    dense_dim: int = 0
    batch_size: int = 1024
    dtype: str = "float32"  # compute dtype of the MLP chain
    table_dtype: str = "float32"
    # Tables with at most this many rows form the plain one-hot classes.
    onehot_max: int = 2048
    # Factored classes: tables with onehot_max < rows <= onehot_factor_max
    # are stored [n, R1, r2*dim] (row r at [r // r2, (r % r2)*dim]).
    # 0 = disabled.
    onehot_factor_max: int = 0
    # lo-level width r2 (rounded up per dim class so r2*dim % 128 == 0).
    onehot_r2: int = 64
    # Striped take layout: each table's physical rows round-robin over
    # take_stripes stripes.  1 = contiguous segments.
    take_stripes: int = 1
    # Width of a packed take-buffer row (multiple of 128).
    take_lanes: int = 128
    # Feature-interaction stage: "none" (the reference: concat -> MLP),
    # "dot" (DLRM pairwise dots) or "cross" (DCNv2).  The port's forward
    # runs "none" only so far.
    interaction: str = "none"
    bottom_mlp: Optional[MLPSpec] = None
    cross_layers: int = 0
    cross_rank: int = 0
    # Quotient-remainder compressed embeddings (Shi et al., KDD'20): tables
    # with rows > qr_threshold become Q (ceil(rows/qr_rem) rows, id //
    # qr_rem) + R (qr_rem rows, id % qr_rem) sharing the feature slot.
    # Both > 0 to enable; see qr_expand.
    qr_threshold: int = 0
    qr_rem: int = 0
    # Matmul precision of the JAX package's MLP ("highest" pins fp32
    # operands there).  The port always multiplies in full fp32.
    matmul_precision: Optional[str] = None

    @property
    def num_tables(self) -> int:
        return len(self.tables)

    @property
    def n_interaction_vectors(self) -> int:
        return self.num_tables + (1 if self.bottom_mlp is not None else 0)

    @property
    def feature_dim(self) -> int:
        return self.mlp.input_dim

    @property
    def embedding_dim_total(self) -> int:
        return sum(t.dim for t in self.tables)

    @property
    def table_bytes(self) -> int:
        return sum(t.nbytes for t in self.tables)

    def dims_histogram(self) -> Dict[int, int]:
        h: Dict[int, int] = {}
        for t in self.tables:
            h[t.dim] = h.get(t.dim, 0) + 1
        return h

    def validate(self) -> None:
        # ``dtype`` is the activation/MLP compute dtype: only floats.
        # ``table_dtype`` additionally admits int8 (quantized storage with
        # power-of-two dequant scales, models/embedding.py::pack_tables).
        assert self.dtype in ("float32", "bfloat16"), (
            f"dtype={self.dtype!r} is the activation/MLP compute dtype and "
            f"must be float32 or bfloat16; for quantized table storage use "
            f"table_dtype='int8'"
        )
        assert self.table_dtype in ("float32", "bfloat16", "int8"), (
            f"table_dtype={self.table_dtype!r} not in float32/bfloat16/int8"
        )
        assert (self.qr_threshold > 0) == (self.qr_rem > 0), (
            "qr_threshold and qr_rem enable QR embeddings together"
        )
        if self.qr_rem:
            assert self.qr_rem >= 2
        if self.interaction == "cross":
            assert self.cross_layers >= 1, "cross interaction needs cross_layers >= 1"
            assert 0 <= self.cross_rank < self.feature_dim
        else:
            assert self.cross_layers == 0, "cross_layers requires interaction='cross'"
            assert self.cross_rank == 0, "cross_rank requires interaction='cross'"
        if self.interaction == "dot":
            dims = {t.dim for t in self.tables}
            assert len(dims) == 1, "dot interaction requires one shared dim"
            D = dims.pop()
            offs = sorted(t.out_offset for t in self.tables)
            assert offs == [D * i for i in range(self.num_tables)], (
                "dot interaction requires contiguous D-strided offsets"
            )
            n = self.n_interaction_vectors
            want = n * (n - 1) // 2 + (D if self.bottom_mlp is not None else 0)
            assert self.mlp.input_dim == want, (
                f"top MLP input {self.mlp.input_dim} != {want} "
                f"(= pairs + bottom width)"
            )
            if self.bottom_mlp is not None:
                assert self.bottom_mlp.input_dim == self.dense_dim
                assert self.bottom_mlp.widths[-1] == D
            return
        assert self.interaction in ("none", "cross"), self.interaction
        used = np.zeros(self.feature_dim, dtype=bool)
        for t in self.tables:
            seg = used[t.out_offset : t.out_offset + t.dim]
            assert not seg.any(), f"overlap at table {t.table_id}"
            used[t.out_offset : t.out_offset + t.dim] = True
        if self.dense_dim:
            tail = used[-self.dense_dim :]
            assert not tail.any(), "dense slice overlaps a table"


def qr_expand(cfg: ModelConfig):
    """Expand a QR-enabled config's table list into the INTERNAL specs the
    packed layout is built over.

    Each table with rows > qr_threshold becomes two specs sharing its
    feature slot: Q keeps the table_id/out_offset with ceil(rows/qr_rem)
    rows; R is appended at the end with a fresh id, qr_rem rows and the
    same out_offset (hidden from the feature permutation — its columns are
    summed into Q's, models/embedding.py::apply_qr_sums).

    Returns (internal_tables, qr_positions, sum_pairs) where qr_positions
    = ((config_column, qr_rem), ...) in R-append order and sum_pairs =
    ((q_table_id, r_table_id), ...).  QR off -> (cfg.tables, (), ()).
    """
    if not cfg.qr_rem:
        return tuple(cfg.tables), (), ()
    next_id = max(t.table_id for t in cfg.tables) + 1
    internal: List[TableSpec] = []
    tail: List[TableSpec] = []
    qr_positions: List[Tuple[int, int]] = []
    sum_pairs: List[Tuple[int, int]] = []
    for pos, t in enumerate(cfg.tables):
        if t.rows > cfg.qr_threshold:
            q_rows = -(-t.rows // cfg.qr_rem)
            internal.append(dataclasses.replace(t, rows=q_rows))
            r = TableSpec(table_id=next_id, rows=cfg.qr_rem, dim=t.dim,
                          out_offset=t.out_offset, kind="QR_R", bank=t.bank)
            tail.append(r)
            qr_positions.append((pos, cfg.qr_rem))
            sum_pairs.append((t.table_id, next_id))
            next_id += 1
        else:
            internal.append(t)
    return tuple(internal + tail), tuple(qr_positions), tuple(sum_pairs)


def _tables_from_json(raw: List[dict], offset_shift: int = 0, id_shift: int = 0) -> List[TableSpec]:
    return [
        TableSpec(
            table_id=t["table"] + id_shift,
            rows=t["rows"],
            dim=t["dim"],
            out_offset=t["out_offset"] + offset_shift,
            kind=t["kind"],
            bank=t["bank"],
        )
        for t in raw
    ]


def _load_json(name: str) -> dict:
    with open(os.path.join(_CONFIG_DIR, f"{name}.json")) as f:
        return json.load(f)


def fleetrec_model1(batch_size: int = 1024, dtype: str = "float32",
                    onehot_max: int = 4096, onehot_factor_max: int = 131072,
                    onehot_r2: int = 16) -> ModelConfig:
    """Paper model 1: 47 tables, 352-float feature, MLP 352-1024-512-256-1
    (embedding_krnl constants.hpp: TABLE_NUM=47, INPUT_SIZE=352)."""
    raw = _load_json("fleetrec_model1")
    cfg = ModelConfig(
        name="fleetrec_model1",
        tables=tuple(_tables_from_json(raw["tables"])),
        mlp=MLPSpec(input_dim=raw["feature_dim"], hidden=tuple(raw["mlp_hidden"])),
        batch_size=batch_size,
        dtype=dtype,
        table_dtype=dtype,
        onehot_max=onehot_max,
        onehot_factor_max=onehot_factor_max,
        onehot_r2=onehot_r2,
    )
    cfg.validate()
    return cfg


def fleetrec_model2(batch_size: int = 1024, dtype: str = "float32",
                    onehot_max: int = 4096, onehot_factor_max: int = 131072,
                    onehot_r2: int = 16) -> ModelConfig:
    """Paper model 2: 98 tables, 880-float feature (876 padded to 880),
    MLP 880-1024-512-256-1 (embedding_98_krnl constants.hpp)."""
    raw = _load_json("fleetrec_model2")
    cfg = ModelConfig(
        name="fleetrec_model2",
        tables=tuple(_tables_from_json(raw["tables"])),
        mlp=MLPSpec(input_dim=raw["feature_dim"], hidden=tuple(raw["mlp_hidden"])),
        batch_size=batch_size,
        dtype=dtype,
        table_dtype=dtype,
        onehot_max=onehot_max,
        onehot_factor_max=onehot_factor_max,
        onehot_r2=onehot_r2,
    )
    cfg.validate()
    return cfg


def fleetrec_model3(batch_size: int = 1024, dtype: str = "float32",
                    table_dtype: str = "int8",
                    onehot_max: int = 4096, onehot_factor_max: int = 131072,
                    onehot_r2: int = 16) -> ModelConfig:
    """Paper model 3: 377 tables = 2 x 188 (the two-FPGA shards of
    embedding_377_krnl) + a 64-float dense CPU slice; feature 3968 =
    1952 + 1952 + 64; MLP 3968-2048-512-256-1.  ``table_dtype`` defaults
    to "int8" as in the JAX package (power-of-two dequant is bit-exact on
    the pm1 parity data); activations stay ``dtype``."""
    raw = _load_json("fleetrec_model3_fpga")
    shard0 = _tables_from_json(raw["tables"])
    shard1 = _tables_from_json(raw["tables"], offset_shift=raw["feature_dim"], id_shift=len(shard0))
    feature_dim = 2 * raw["feature_dim"] + 64
    cfg = ModelConfig(
        name="fleetrec_model3",
        tables=tuple(shard0 + shard1),
        mlp=MLPSpec(input_dim=feature_dim, hidden=tuple(raw["mlp_hidden"])),
        dense_dim=64,
        batch_size=batch_size,
        dtype=dtype,
        table_dtype=table_dtype,
        onehot_max=onehot_max,
        onehot_factor_max=onehot_factor_max,
        onehot_r2=onehot_r2,
    )
    cfg.validate()
    return cfg


def tiny_dlrm(batch_size: int = 256, dtype: str = "float32") -> ModelConfig:
    """Tiny DLRM-style config: 8 tables x 1M rows x dim 16, 3-layer MLP."""
    tables = tuple(
        TableSpec(table_id=i, rows=1_000_000, dim=16, out_offset=16 * i) for i in range(8)
    )
    cfg = ModelConfig(
        name="tiny_dlrm",
        tables=tables,
        mlp=MLPSpec(input_dim=128, hidden=(256, 128)),
        batch_size=batch_size,
        dtype=dtype,
        table_dtype=dtype,
    )
    cfg.validate()
    return cfg


def micro_test(batch_size: int = 16, rows: int = 64) -> ModelConfig:
    """Minimal mixed-dim config for unit tests (dims 4/8/16/32)."""
    dims = [4, 4, 8, 8, 8, 16, 32, 4]
    off = 0
    tables = []
    for i, d in enumerate(dims):
        tables.append(TableSpec(table_id=i, rows=rows + 8 * i, dim=d, out_offset=off))
        off += d
    cfg = ModelConfig(
        name="micro_test",
        tables=tuple(tables),
        mlp=MLPSpec(input_dim=off + 8, hidden=(32, 16)),
        dense_dim=8,
        batch_size=batch_size,
    )
    cfg.validate()
    return cfg


def parity_synthetic(input_width: int = 512, batch_size: int = 32) -> ModelConfig:
    """The reference's closed-form parity configuration: all-ones input of
    ``input_width`` through the 1024-512-256-1 chain scores
    width*1024*512*256 (68,719,476,736 for 512; 137,438,953,472 for 1024).
    Dense-only (no tables)."""
    return ModelConfig(
        name=f"parity_{input_width}",
        tables=(),
        mlp=MLPSpec(input_dim=input_width, hidden=(1024, 512, 256)),
        dense_dim=input_width,
        batch_size=batch_size,
    )


def criteo_terabyte(batch_size: int = 1024, dtype: str = "bfloat16",
                    table_dtype: Optional[str] = None,
                    take_stripes: int = 16, onehot_factor_max: int = 24576,
                    onehot_r2: int = 4, qr_threshold: int = 0,
                    qr_rem: int = 0) -> ModelConfig:
    """Criteo-1TB-scale config: 26 categorical tables with the classic
    cardinalities (one held at 1B rows), dim 32, 13 dense features, MLP
    845-1024-1024-512-256-1.  ``dtype`` is the activation dtype;
    ``table_dtype`` (default: dtype) the storage dtype, which also admits
    "int8".  ``qr_threshold``/``qr_rem`` opt into QR embeddings for the
    giant tables (off by default: QR is a compression, not an exact
    lookup)."""
    cardinalities = [
        1_000_000_000, 39_060, 17_295, 7_424, 20_265, 3, 7_122, 1_543, 63,
        130_229_467, 3_067_956, 405_282, 10, 2_209, 11_938, 155, 4, 976,
        14, 292_775_614, 40_790_948, 187_188_510, 590_152, 12_973, 108, 36,
    ]
    dim = 32
    tables = tuple(
        TableSpec(table_id=i, rows=r, dim=dim, out_offset=dim * i)
        for i, r in enumerate(cardinalities)
    )
    cfg = ModelConfig(
        name="criteo_terabyte",
        tables=tables,
        mlp=MLPSpec(input_dim=dim * len(cardinalities) + 13, hidden=(1024, 1024, 512, 256)),
        dense_dim=13,
        batch_size=batch_size,
        dtype=dtype,
        table_dtype=table_dtype if table_dtype is not None else dtype,
        take_stripes=take_stripes,
        onehot_factor_max=onehot_factor_max,
        onehot_r2=onehot_r2,
        qr_threshold=qr_threshold,
        qr_rem=qr_rem,
    )
    cfg.validate()
    return cfg


def micro_dlrm(batch_size: int = 16, rows: int = 64,
               onehot_max: int = 2048) -> ModelConfig:
    """Minimal DLRM dot-interaction config for unit tests: 4 tables x dim 8,
    6 dense features -> bottom 6-16-8, top 18 (= 8 + C(5,2)) -> 16 -> 8 -> 1."""
    D, T = 8, 4
    tables = tuple(
        TableSpec(table_id=i, rows=rows + 8 * i, dim=D, out_offset=D * i)
        for i in range(T)
    )
    pairs = (T + 1) * T // 2
    cfg = ModelConfig(
        name="micro_dlrm",
        tables=tables,
        mlp=MLPSpec(input_dim=D + pairs, hidden=(16, 8)),
        dense_dim=6,
        batch_size=batch_size,
        onehot_max=onehot_max,
        interaction="dot",
        bottom_mlp=MLPSpec(input_dim=6, hidden=(16,), out_dim=D),
        matmul_precision="highest",
    )
    cfg.validate()
    return cfg


def micro_cross(batch_size: int = 16, rows: int = 64, cross_layers: int = 2,
                cross_rank: int = 0) -> ModelConfig:
    """Minimal DCNv2 config for unit tests: the micro_test geometry with a
    stacked cross network between the concat and the top MLP."""
    base = micro_test(batch_size=batch_size, rows=rows)
    cfg = dataclasses.replace(
        base,
        name="micro_cross",
        interaction="cross",
        cross_layers=cross_layers,
        cross_rank=cross_rank,
        matmul_precision="highest",
    )
    cfg.validate()
    return cfg


def dlrm_terabyte(batch_size: int = 1024, dtype: str = "float32",
                  take_stripes: int = 16) -> ModelConfig:
    """MLPerf-style DLRM on the Criteo-1TB cardinalities: 26 tables x dim
    128, 13 dense features, bottom MLP 13-512-256-128, dot interaction (27
    vectors -> 351 pairs), top MLP 479-1024-1024-512-256-1."""
    cardinalities = [
        227_605_432, 39_060, 17_295, 7_424, 20_265, 3, 7_122, 1_543, 63,
        130_229_467, 3_067_956, 405_282, 10, 2_209, 11_938, 155, 4, 976,
        14, 292_775_614, 40_790_948, 187_188_510, 590_152, 12_973, 108, 36,
    ]
    D = 128
    tables = tuple(
        TableSpec(table_id=i, rows=r, dim=D, out_offset=D * i)
        for i, r in enumerate(cardinalities)
    )
    n = len(cardinalities) + 1
    cfg = ModelConfig(
        name="dlrm_terabyte",
        tables=tables,
        mlp=MLPSpec(input_dim=D + n * (n - 1) // 2,
                    hidden=(1024, 1024, 512, 256), activation="relu"),
        dense_dim=13,
        batch_size=batch_size,
        dtype=dtype,
        table_dtype=dtype,
        take_stripes=take_stripes,
        interaction="dot",
        bottom_mlp=MLPSpec(input_dim=13, hidden=(512, 256), out_dim=D,
                           activation="relu"),
    )
    cfg.validate()
    return cfg


CONFIGS = {
    "micro_test": micro_test,
    "micro_dlrm": micro_dlrm,
    "micro_cross": micro_cross,
    "tiny_dlrm": tiny_dlrm,
    "fleetrec_model1": fleetrec_model1,
    "fleetrec_model2": fleetrec_model2,
    "fleetrec_model3": fleetrec_model3,
    "criteo_terabyte": criteo_terabyte,
    "dlrm_terabyte": dlrm_terabyte,
}


def get_config(name: str, **kw) -> ModelConfig:
    return CONFIGS[name](**kw)
