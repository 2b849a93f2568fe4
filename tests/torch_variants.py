"""Small model configs shared by the port's tests, built the same way from
either package's config module (``fleetrec_tpu.config`` or
``fleetrec_tpu_torch.config``).  Imports neither package itself, so the
card tests (tests/test_torch_cuda.py), which import no JAX, use it too."""

import dataclasses

# the device the CPU tests pass to the port's entry points (init_model,
# load_npz, params_from_jax, Trainer), which run on the card unless asked
CPU = "cpu"
PAPER = ["fleetrec_model1", "fleetrec_model2", "fleetrec_model3"]
LAYOUT_CASES = ["micro", *PAPER, "tiers", "model1_tiers", "striped", "qr",
                "lanes64", "lanes256", "micro_dlrm"]
# the interaction heads at a test size: DLRM with every table one-hot and
# with both lookup tiers, DCNv2 full rank (2 layers) and rank 4 (1 layer)
HEADS = ["micro_dlrm_onehot", "micro_dlrm", "micro_cross", "micro_cross_r4"]


def cap(cfg, rows):
    """``cfg`` with every table's rows capped at ``rows``."""
    return dataclasses.replace(cfg, tables=tuple(
        dataclasses.replace(t, rows=min(t.rows, rows)) for t in cfg.tables))


def mixed(C, batch_size=16, **kw):
    """micro_test with onehot_max=70: dims 4 / 8 split across the plain
    one-hot classes and the take tier (tests/test_pooled.py's config)."""
    return dataclasses.replace(C.micro_test(batch_size=batch_size), onehot_max=70, **kw)


def variant(name, C):
    """The config ``name`` of LAYOUT_CASES or HEADS (or ``criteo``) from
    the config module ``C``."""
    if name == "micro":
        return C.micro_test(batch_size=24)
    if name in PAPER:
        # fp32 storage, rows capped at 512 as in test_parity.py
        return dataclasses.replace(cap(C.get_config(name, batch_size=16), 512),
                                   table_dtype="float32")
    if name == "tiers":
        # rows straddle all three tiers (plain / factored / take)
        base = C.micro_test(batch_size=32)
        rows = [40, 50, 300, 700, 900, 1400, 3000, 5000]
        return dataclasses.replace(
            base, tables=tuple(dataclasses.replace(t, rows=rows[i])
                               for i, t in enumerate(base.tables)),
            onehot_max=64, onehot_factor_max=1500, onehot_r2=32)
    if name == "model1_tiers":
        # model1 geometry with all three tiers at a test size
        return dataclasses.replace(cap(C.fleetrec_model1(batch_size=16), 20000),
                                   onehot_max=2048, onehot_factor_max=10000)
    if name == "striped":
        return dataclasses.replace(C.micro_test(batch_size=24), onehot_max=70,
                                   take_stripes=4)
    if name == "qr":
        return dataclasses.replace(C.micro_test(batch_size=24), onehot_max=8,
                                   qr_threshold=80, qr_rem=16)
    if name.startswith("lanes"):
        return dataclasses.replace(C.micro_test(batch_size=24), onehot_max=0,
                                   take_lanes=int(name[5:]))
    if name == "micro_dlrm":
        # the dense-free dot layout with both tiers: table 0 (64 rows)
        # one-hot, the others (72..88 rows) striped take tables
        return dataclasses.replace(C.micro_dlrm(batch_size=32, onehot_max=70),
                                   take_stripes=4)
    if name == "micro_dlrm_onehot":
        return C.micro_dlrm(batch_size=32)
    if name == "micro_cross":
        return C.micro_cross(batch_size=32)
    if name == "micro_cross_r4":
        # one layer: two all-ones rank-4 layers pass 2^24, where fp32
        # integer sums stop being exact
        return C.micro_cross(batch_size=32, cross_layers=1, cross_rank=4)
    if name == "narrow":
        # rows 1, 2, 4 and 8 wide: output quads that straddle two tables,
        # which the backward kernel adds column by column
        base = C.micro_test(batch_size=24)
        dims = (1, 2, 1, 4, 8, 2, 1, 1)
        return dataclasses.replace(base, tables=tuple(
            dataclasses.replace(t, dim=d) for t, d in zip(base.tables, dims)))
    if name == "criteo":
        # criteo's geometry (bf16, 16 stripes, 845-wide features, a factored
        # class and a take group) with rows capped at 40000
        return cap(C.criteo_terabyte(batch_size=24), 40000)
    raise KeyError(name)
