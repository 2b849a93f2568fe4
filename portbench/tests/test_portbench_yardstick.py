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


def dlrm_dcnv2():
    """MLPerf's DLRM-DCNv2 (torchrec_dlrm's flags): 26 tables of dim 128
    behind a 13-512-256-128 bottom tower, three cross layers of rank 512
    over the 3,456-wide vector, the top tower 3456-1024-1024-512-256-1."""
    return {"tables": [{"rows": 1000, "dim": 128, "out_offset": 128 * (t + 1)} for t in range(26)],
            "feature_dim": 3456, "dense_dim": 13, "mlp": [3456, 1024, 1024, 512, 256, 1],
            "bottom_mlp": {"widths": [13, 512, 256, 128], "activation": "relu",
                           "last_activation": True},
            "interaction": "cross", "cross_layers": 3, "cross_rank": 512,
            "dtype": "bfloat16", "table_dtype": "bfloat16"}


def test_step_flops_per_query():
    m = dlrm_dcnv2()
    assert yardstick.cross_flops_per_query(m) == 21_233_664
    assert yardstick.flops_per_query(m["bottom_mlp"]["widths"]) == 340_992
    assert yardstick.flops_per_query(m["mlp"]) == 10_486_272
    assert yardstick.step_flops_per_query(m) == 32_060_928
    assert yardstick.step_flops_per_query(conf("criteo_terabyte_int8")) == 5_138_944
    m.update(cross_rank=0)
    assert yardstick.cross_flops_per_query(m) == 3 * 2 * 3456 * 3456
    dot = {"tables": [{"dim": 8}] * 6, "mlp": [29, 16, 1], "interaction": "dot",
           "bottom_mlp": {"widths": [8, 16, 8]}}
    assert yardstick.step_flops_per_query(dot) == 2 * (29 * 16 + 16) + 2 * (8 * 16 + 16 * 8) + 2 * 8 * 21


def test_cross_bound():
    m = dlrm_dcnv2()
    B = 4096
    flops_s = B * 21_233_664 / 989e12
    byts = (3 * (2 * 3456 * 512 + 3456) * 2 + B * 3456 * 2 * 4) / 3.35e12
    assert yardstick.cross_bound_s(m, B) == max(flops_s, byts)
    m["dtype"] = "float32"
    assert yardstick.cross_bound_s(m, B) == B * 21_233_664 / 67e12


def test_lookup_bytes_of_bags_counts_each_distinct_row_once():
    model = {"tables": [{"dim": 8, "hot": 2}, {"dim": 32, "hot": 1}], "dense_dim": 3,
             "feature_dim": 43, "table_dtype": "int8", "dtype": "float32"}
    ids = np.array([[1, 2, 5], [1, 1, 6], [3, 2, 5]], np.int32)
    rows = 3 * 8 + 2 * 32                 # table 0: {1, 2, 3}; table 1: {5, 6}
    assert yardstick.lookup_bytes(model, ids) == ids.size * 4 + rows + 3 * 3 * 4 + 3 * 43 * 4 + 3
    model["bottom_mlp"] = {"widths": [3, 3]}  # dense read by the bottom tower, 40 columns written
    assert yardstick.lookup_bytes(model, ids) == ids.size * 4 + rows + 3 * 40 * 4 + 3
