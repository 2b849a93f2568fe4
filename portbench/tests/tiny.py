"""A tiny cell for the CPU tests: six tables over every storage tier (a
plain class, factored classes, take tables), a dense tail and a 3-layer
tower; the same served path as the benchmark's cells at a size the CPU
runs in a second."""

from __future__ import annotations

from portbench.serve import Cell

TABLES = [(100, 8, 0), (3000, 8, 8), (50000, 16, 16), (7, 4, 32), (200000, 32, 36),
          (90000, 16, 68)]


def model(dtype: str = "float32", table_dtype: str = "int8", stripes: int = 1) -> dict:
    return {"tables": [{"rows": r, "dim": d, "out_offset": o} for r, d, o in TABLES],
            "feature_dim": 96, "dense_dim": 8, "mlp": [96, 32, 16, 1], "activation": None,
            "dtype": dtype, "table_dtype": table_dtype,
            "storage": {"onehot_max": 4096, "onehot_factor_max": 60000, "onehot_r2": 16,
                        "take_stripes": stripes, "take_lanes": 128}}


def cell(senders: int = 3, **kw) -> Cell:
    traffic = {"kind": "stream", "pool_batches": 4, "warmup_batches": 4, "end_timeout_ms": 1000}
    serve = {"batch": 32, "senders": senders, "slots": 8, "fuse": 1, "bg_drain": True,
             "warm": True}
    return Cell("tiny", "tiny", 1, model(**kw), serve, {"max_err": 1e-4}, traffic)


def dot_model(last_activation: bool = False) -> dict:
    """A DLRM head over the tiny tables' rows at one dim (8, D-strided
    offsets in config order): a bottom tower 8-16-8 on the dense features,
    its output in the feature vector's tail, the dots over [bottom, six
    tables] and a top tower over [bottom, 21 dots]."""
    m = model()
    m["tables"] = [{"rows": r, "dim": 8, "out_offset": 8 * i} for i, (r, _, _) in enumerate(TABLES)]
    m.update(feature_dim=56, mlp=[29, 16, 1], activation="relu", interaction="dot",
             bottom_mlp={"widths": [8, 16, 8], "activation": "relu",
                         "last_activation": last_activation})
    return m


def cross_model(rank: int = 8) -> dict:
    """A DCNv2 head of two cross layers (low rank at ``rank``) over the
    tiny feature vector and its raw dense tail, then a ReLU top tower."""
    m = model()
    m.update(interaction="cross", cross_layers=2, cross_rank=rank, activation="relu")
    return m


def bag_model(hot=4) -> dict:
    """The tiny tower over bags: ``hot`` ids a table (an int: every table)."""
    m = model()
    for i, t in enumerate(m["tables"]):
        t["hot"] = hot if isinstance(hot, int) else hot[i]
    return m


def cell_of(m: dict, senders: int = 1) -> Cell:
    """The tiny cell with the model block ``m``."""
    c = cell(senders)
    c.model = m
    return c
