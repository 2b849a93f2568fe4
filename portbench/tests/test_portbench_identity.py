"""A configuration that states no head reads as it did before the harness
took heads: for the same seed, the criteo cell's configuration (its widths
and rows) and the tiny ones give byte-equal pools, top-tower weights,
reference and control scores, and equal FLOPs and lookup bytes.  The
digests (the first 32 hex digits of SHA-256 over the arrays' bytes) and
the integers were taken from the harness of commit e814cd1 with the same
calls."""

from __future__ import annotations

import hashlib
import json
import os

import numpy as np
import pytest
import torch

from portbench import inputs, loader, reference, tables, yardstick
from portbench.tests import tiny

# name/seed -> ids, dense, top-tower weights, reference scores, control
# scores (digests); lookup bytes of the first three pool entries; FLOPs
PARENT = {
    "criteo/4000000001": ("18085ca8d0d30247de009f2f43d27092", "f3bf3f3e535af7992c5c28b317fda54c",
                          "49e8a15a097ac290ac4808c36ef49631", "54126b3400f8e715d2266a83d375f271",
                          "5ee626bcb7e0011472a74b1082602fa8", [16468192, 16463744, 16464032],
                          5138944),
    "criteo/7": ("058ad2391ddee0fa436e430453bf8f48", "51eff97cee28fbcd2f95595e8acb09c3",
                 "3b0ad445ce9a61f48ba18fd92041f3f9", "8a1d7d24ccbd25e8ebd1b36ff9aaa0f6",
                 "907a0511f975f4a8503c5f1510c1c36a", [16465952, 16468416, 16470496], 5138944),
    "tiny/4000000001": ("43316c97e8f484d5a6f9bf41086b804b", "243c3b84952f336b067443ae1bf9ea87",
                        "407abd7c9f2f44fe492b4cd8005857df", "eedf29a137aee12d799f5f0049f604f9",
                        "b20002a32abea33836dc04e07ab36ea6", [16620, 16676, 16660], 7200),
    "tiny/7": ("22d6429d90f9094d1046a27599015d79", "9d0253d8d759329f20c0dbad74f27e75",
               "0f24685f20e991ffc3ba9534e905545c", "887b629b6c14d56b09a5a54cdbc13849",
               "256dec9201563d0ffe13104c3f1955f2", [16684, 16676, 16660], 7200),
    "tiny_bf16/4000000001": ("43316c97e8f484d5a6f9bf41086b804b", "243c3b84952f336b067443ae1bf9ea87",
                             "3c4ffb40e1424136e08c60269fe22f0f", "b5f408ff5dca1792b949a6e153dbe546",
                             "739b18fe249d41d07758a9ee31d1e6a0", [12984, 13096, 13064], 7200),
    "tiny_bf16/7": ("22d6429d90f9094d1046a27599015d79", "9d0253d8d759329f20c0dbad74f27e75",
                    "a63f0fe007d673ab2bbefa9d81a1d51e", "e758362a6bef6d9c06f3e9c14c2ed6f1",
                    "9955e7876751586b9f6de749a1fe1941", [13112, 13096, 13064], 7200),
}


def _criteo():
    with open(os.path.join(loader.HERE, "configs", "criteo_terabyte_int8.json")) as f:
        return json.load(f)["model"]


# name -> (model, pool batch, pool entries, scored batch, scored entries)
CASES = {"criteo": (_criteo, 4096, 64, 128, 2), "tiny": (tiny.model, 32, 4, 32, 4),
         "tiny_bf16": (lambda: tiny.model("bfloat16", "bfloat16", 4), 32, 4, 32, 4)}


def digest(*arrays) -> str:
    d = hashlib.sha256()
    for a in arrays:
        a = a.numpy() if isinstance(a, torch.Tensor) else a
        d.update(np.ascontiguousarray(a).tobytes())
    return d.hexdigest()[:32]


@pytest.mark.parametrize("case", sorted(PARENT))
def test_same_seed_reads_as_the_parent(case):
    name, seed = case.split("/")
    seed = int(seed)
    make, B, P, b, p = CASES[name]
    m = make()
    ids, dense = inputs.pools(seed, m, B, P)
    w = tables.head_weights(seed, m, "cpu")
    assert not (w["bottom"] or w["cross"] or w["mlp_bias"] or w["bottom_bias"])
    rows = [t["rows"] for t in m["tables"]]
    assert np.array_equal(ids, inputs.id_pool(seed, rows, B, P))
    sid, sdense = inputs.pools(seed, m, b, p)
    key = tables.seed_key(seed)
    got = (digest(ids), digest(dense), digest(*[x.float() for x in w["mlp"]]),
           digest(reference.pool_scores(m, key, sid, sdense, w)),
           digest(reference.pool_scores(m, key, sid, sdense, w, control=True)),
           [int(yardstick.lookup_bytes(m, ids[j])) for j in range(3)],
           yardstick.flops_per_query(m["mlp"]))
    assert got == PARENT[case]
    assert yardstick.step_flops_per_query(m) == yardstick.flops_per_query(m["mlp"])
