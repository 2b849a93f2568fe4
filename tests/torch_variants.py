"""Small model configs shared by the port's tests, built the same way from
either package's config module (``fleetrec_tpu.config`` or
``fleetrec_tpu_torch.config``).  Imports neither package itself, so the
card tests (tests/test_torch_cuda.py), which import no JAX, use it too."""

import dataclasses

PAPER = ["fleetrec_model1", "fleetrec_model2", "fleetrec_model3"]
LAYOUT_CASES = ["micro", *PAPER, "tiers", "model1_tiers", "striped", "qr",
                "lanes64", "lanes256"]


def cap(cfg, rows):
    """``cfg`` with every table's rows capped at ``rows``."""
    return dataclasses.replace(cfg, tables=tuple(
        dataclasses.replace(t, rows=min(t.rows, rows)) for t in cfg.tables))


def variant(name, C):
    """The config ``name`` of LAYOUT_CASES (or ``criteo``) from the config
    module ``C``."""
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
    if name == "criteo":
        # criteo's geometry (bf16, 16 stripes, 845-wide features, a factored
        # class and a take group) with rows capped at 40000
        return cap(C.criteo_terabyte(batch_size=24), 40000)
    raise KeyError(name)
