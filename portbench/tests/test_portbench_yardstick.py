"""The yardstick's counts: the towers' FLOPs a query from the configuration
files, a lookup's bytes against a direct count, the tower's bound."""

from __future__ import annotations

import json
import os

import numpy as np

from portbench import loader, yardstick


def conf(name):
    return json.load(open(os.path.join(loader.HERE, "configs", name + ".json")))["model"]


def test_flops_per_query():
    assert yardstick.flops_per_query(conf("fleetrec_model3")["mlp"]) == 18_612_736
    assert yardstick.flops_per_query(conf("criteo_terabyte_int8")["mlp"]) == 5_138_944


def test_lookup_bytes_counts_each_distinct_row_once():
    model = {"tables": [{"dim": 8}, {"dim": 32}], "dense_dim": 3, "feature_dim": 43,
             "table_dtype": "int8", "dtype": "float32"}
    ids = np.array([[1, 5], [1, 6], [2, 5], [1, 5]], np.int32)
    rows = (2 * 8 + 2 * 32) * 1          # table 0: {1, 2}; table 1: {5, 6}
    want = ids.size * 4 + rows + 4 * 3 * 4 + 4 * 43 * 4 + 4
    assert yardstick.lookup_bytes(model, ids) == want
    model["table_dtype"] = model["dtype"] = "bfloat16"
    assert yardstick.lookup_bytes(model, ids) == ids.size * 4 + rows * 2 + 4 * 3 * 4 + 4 * 43 * 2 + 4


def test_tower_bound():
    w = [3968, 2048, 512, 256, 1]
    t = yardstick.tower_bound_s(w, "float32", 1024)
    assert t == 1024 * 18_612_736 / 67e12  # FLOP-bound in float32
    assert abs(t - 0.2845e-3) < 1e-6
