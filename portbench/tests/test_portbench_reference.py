"""The plain reference against a direct computation, and the harness's
tables as the program holds them (the port's plain lookup on the CPU reads
the reference's features back exactly)."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from portbench import reference, tables
from portbench.tests import tiny

SEED = 3_000_000_019


def direct_value(key, table, row, col, model):
    """One table value by the formula of tables.py, in Python ints."""
    M32 = 0xFFFFFFFF
    x = (row * 0x9E3779B1 + table * 0x85EBCA77 + key) & M32
    for _ in range(2):
        x = ((x ^ (x >> 16)) * 0x45D9F3B) & M32
    x ^= x >> 16
    q = ((x * tables.COLUMN_MULT[col]) >> 24 & 255) - 128
    if model["table_dtype"] == "int8":
        return q * float(np.float32(tables.table_scale(key, table)))
    return q * 2.0 ** -7


@pytest.mark.parametrize("kw", [{}, {"dtype": "bfloat16", "table_dtype": "bfloat16"}])
def test_reference_against_direct_computation(kw):
    m = tiny.model(**kw)
    key = tables.seed_key(SEED)
    rng = np.random.default_rng(0)
    ids = np.stack([rng.integers(0, t["rows"], 5) for t in m["tables"]], 1)
    dense = rng.random((5, m["dense_dim"]), dtype=np.float32) * 2 - 1
    x = reference.features(m, key, torch.from_numpy(ids), torch.from_numpy(dense))
    want = np.zeros((5, m["feature_dim"]))
    for b in range(5):
        for t, spec in enumerate(m["tables"]):
            for c in range(spec["dim"]):
                want[b, spec["out_offset"] + c] = direct_value(key, t, int(ids[b, t]), c, m)
    dd = torch.from_numpy(dense)
    if m["table_dtype"] == "bfloat16":
        dd = dd.to(torch.bfloat16)
    want[:, -m["dense_dim"]:] = dd.double().numpy()
    assert np.array_equal(x.numpy(), want)
    w = tables.tower_weights(SEED, m["mlp"], tables.STORAGE_DTYPES[m["dtype"]], "cpu")
    h = want
    for i, wi in enumerate(w):
        h = h @ wi.double().numpy()
        if i < len(w) - 1 and m["dtype"] == "bfloat16":
            h = torch.from_numpy(h).to(torch.bfloat16).double().numpy()
    assert np.allclose(reference.tower(m, x, w).numpy(), h[:, 0], rtol=1e-12, atol=0)


@pytest.mark.parametrize("kw", [{}, {"dtype": "bfloat16", "table_dtype": "bfloat16",
                                     "stripes": 4}])
def test_program_tables_hold_the_reference_values(kw):
    from portbench.model import build_model, port_config

    c = tiny.cell(**kw)
    cfg = port_config("tiny", c.model, c.serve)
    model = build_model(cfg, c.model, SEED, torch.device("cpu"))
    rng = np.random.default_rng(1)
    ids = np.stack([rng.integers(0, t["rows"], 64) for t in c.model["tables"]], 1)
    for t, spec in enumerate(c.model["tables"]):  # every table's first and last rows
        ids[0, t], ids[1, t] = 0, spec["rows"] - 1
    dense = rng.random((64, 8), dtype=np.float32)
    with torch.inference_mode():
        feats, _bad = model.lookup(torch.from_numpy(ids.astype(np.int32)),
                                   torch.from_numpy(dense))
    want = reference.features(c.model, tables.seed_key(SEED), torch.from_numpy(ids),
                              torch.from_numpy(dense))
    assert torch.equal(feats.double(), want)


def test_max_err():
    ref = np.array([[1.0, -1.0, 2.0, 0.0]])
    got = ref + np.array([[0.0, 0.0, 0.15, 0.0]])
    assert reference.max_err(got, ref) == pytest.approx(0.15 / np.sqrt(6 / 4))
    got[0, 1] = np.nan
    assert reference.max_err(got, ref) == float("inf")
