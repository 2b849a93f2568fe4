"""The port's placement planner (``fleetrec_tpu_torch/parallel/planner.py``)
and ``cli plan``: twins of the 7 tests of tests/test_planner.py and of
tests/test_qr.py:117, tests/test_ops.py:221, tests/test_cli.py:31 and :38.

* take fields and every ``ShardReport`` equal to the JAX planner's (the
  layout is the same bytes) for model1, model2, model3, criteo, QR-criteo
  and factored micro_test at n_model 1, 2, 4, 8 and 16;
* the byte fields equal to the ``nbytes`` of the tensors the port really
  allocates (``init_model`` and ``shard_operands`` on the CPU at capped
  rows): classes at their logical bytes, no W1 fold;
* the fit claims at one H100's memory (``H100_HBM_BYTES``): criteo with
  bfloat16 tables does not fit one card and fits two and four; with int8
  tables it fits one; QR-criteo (bfloat16) fits one;
* the column split exact on one device and, in a gloo world, sharded;
  the striped layout exact, sharded, and flat in the plan.

Tolerances as tests/test_planner.py states them: exact on one device,
rtol / atol 1e-5 for the sharded forwards against the float64 oracle."""

import dataclasses
import json

import numpy as np
import pytest
import torch

from fleetrec_tpu import config as JC
from fleetrec_tpu.parallel import plan as j_plan
from fleetrec_tpu_torch import cli
from fleetrec_tpu_torch import config as C
from fleetrec_tpu_torch import reference as ref
from fleetrec_tpu_torch.models import init_model
from fleetrec_tpu_torch.parallel import (H100_HBM_BYTES, plan, shard_operands,
                                         split_table_columns, split_table_data)
from torch_variants import CPU, cap, variant
from torch_worlds import run_planner_cases, spawn_world

QR = dict(qr_threshold=1_000_000, qr_rem=131072)


def planner_config(M, name):
    """A config of the JAX-equality cases from the config module ``M``."""
    if name == "criteo_qr":
        return M.criteo_terabyte(batch_size=4096, **QR)
    if name == "micro_factored":
        base = M.micro_test(batch_size=8)
        return dataclasses.replace(
            base, tables=tuple(dataclasses.replace(t, rows=1000) for t in base.tables),
            onehot_max=64, onehot_factor_max=2000, onehot_r2=32)
    return M.get_config(name)


JAX_CASES = ["fleetrec_model1", "fleetrec_model2", "fleetrec_model3", "criteo_terabyte",
             "criteo_qr", "micro_factored"]


@pytest.mark.parametrize("n_model", [1, 2, 4, 8, 16])
@pytest.mark.parametrize("name", JAX_CASES)
def test_take_fields_and_shards_equal_jax(name, n_model):
    got = plan(planner_config(C, name), n_model)
    want = j_plan(planner_config(JC, name), n_model)
    for f in ("config_name", "n_model", "table_dtype", "take_bytes_total",
              "take_bytes_per_chip", "mlp_bytes"):
        assert getattr(got, f) == getattr(want, f), f
    assert len(got.shards) == n_model
    assert [dataclasses.asdict(s) for s in got.shards] == [
        dataclasses.asdict(s) for s in want.shards]
    assert got.w1_fold_bytes == 0
    assert got.hbm_budget_bytes == H100_HBM_BYTES


# capped configs whose buffers the port builds here: every tier, stripes,
# int8 and bfloat16 storage, a QR remainder
ALLOC_CASES = {
    "criteo_int8": lambda: dataclasses.replace(
        cap(C.criteo_terabyte(batch_size=16, dtype="float32"), 30000), table_dtype="int8"),
    "criteo_bf16": lambda: cap(C.criteo_terabyte(batch_size=16), 30000),
    "model1_tiers": lambda: dataclasses.replace(cap(C.fleetrec_model1(batch_size=16), 20000),
                                                onehot_max=2048, onehot_factor_max=10000),
    "qr": lambda: dataclasses.replace(C.micro_test(batch_size=24), onehot_max=8,
                                      qr_threshold=80, qr_rem=16),
    # the heads: a dot config's dense-free [B, T * D] layout and its bottom
    # tower, a cross config's layers
    "micro_dlrm": lambda: variant("micro_dlrm", C),
    "micro_cross": lambda: variant("micro_cross", C),
}


@pytest.mark.parametrize("n_model", [1, 2, 4])
@pytest.mark.parametrize("name", list(ALLOC_CASES))
def test_byte_fields_equal_what_the_port_allocates(name, n_model):
    cfg = ALLOC_CASES[name]()
    model = init_model(cfg, device=CPU)
    p = plan(cfg, n_model)
    packed = model.packed
    assert p.onehot_bytes == sum(b.nbytes for b in packed.onehot_buffers)
    assert p.mlp_bytes == sum(w.nbytes for w in model.mlp_weights + model.bottom_weights
                              + [t for layer in model.cross_weights for t in layer])
    if n_model == 1:
        assert p.take_bytes_total == (0 if packed.take_buffer is None
                                      else packed.take_buffer.nbytes)
    n_cls = len(model.layout.onehot_classes)
    for m in range(n_model):
        ops = shard_operands(model, m, n_model, CPU)
        assert p.onehot_bytes_per_chip == sum(b.nbytes for b in ops["bufs"][:n_cls])
        assert p.take_bytes_per_chip == sum(b.nbytes for b in ops["bufs"][n_cls:])
        assert p.take_bytes_per_chip * n_model == p.take_bytes_total
    assert p.per_chip_bytes == (p.mlp_bytes + p.activation_bytes + p.take_bytes_per_chip
                                + p.onehot_bytes_per_chip)


@pytest.mark.parametrize("dtype,fits", [
    ("bfloat16", {1: False, 2: True, 4: True}),
    ("int8", {1: True, 2: True, 4: True}),
])
def test_criteo_fits_at_the_h100_budget(dtype, fits):
    """criteo_terabyte at full cardinality on H100s: 105.9 GB of bfloat16
    take rows need two cards, 53.0 GB of int8 ones fit one."""
    cfg = dataclasses.replace(C.criteo_terabyte(), table_dtype=dtype)
    for n, want in fits.items():
        p = plan(cfg, n)
        assert p.fits is want, (n, p.per_chip_bytes)
        assert p.take_bytes_per_chip * n == p.take_bytes_total
    p1 = plan(cfg, 1)
    assert p1.min_model_shards == (2 if dtype == "bfloat16" else 1)
    assert p1.take_bytes_total == (105_925_582_848 if dtype == "bfloat16" else 52_962_791_424)


@pytest.mark.parametrize("factored,want", [(True, 52_962_791_424), (False, 52_965_332_992)],
                         ids=["factored_on", "factored_off"])
def test_criteo_int8_take_bytes_with_and_without_the_factored_tier(factored, want):
    """criteo int8's take buffer at full cardinality, by the port's planner
    and by JAX's: 52,962,791,424 B with the factored tier (the config's
    default), 52,965,332,992 B with it off (``onehot_factor_max=0``), the
    figure of artifacts/CRITEO_FULL_DRYRUN.json."""
    kw = {} if factored else {"onehot_factor_max": 0}
    cfg_t = C.criteo_terabyte(dtype="float32", table_dtype="int8", **kw)
    cfg_j = JC.criteo_terabyte(dtype="float32", table_dtype="int8", **kw)
    assert plan(cfg_t, 1).take_bytes_total == want
    assert j_plan(cfg_j, 1).take_bytes_total == want


def test_plan_criteo_fits_at_16_and_balances():
    """The twin of test_plan_criteo_fits_at_16_not_at_1: at the H100 budget
    bfloat16 criteo fits 16 cards and not one; load fractions sum to ~1
    and every shard serves traffic."""
    cfg = C.criteo_terabyte()
    p1, p16 = plan(cfg, n_model=1), plan(cfg, n_model=16)
    assert not p1.fits and p16.fits
    assert 1 < p16.min_model_shards <= 16
    assert p16.take_bytes_per_chip * 16 == p16.take_bytes_total
    loads = [s.uniform_load_frac for s in p16.shards]
    assert abs(sum(loads) - 1.0) < 5e-3
    assert min(loads) > 0
    assert any("fits at n_model >= 2" in n for n in p1.notes)


@pytest.mark.parametrize("dtype,shards", [("float32", 6), ("int8", 2)])
def test_dlrm_terabyte_needs_several_cards(dtype, shards):
    """dlrm_terabyte's full 882.8M rows x dim 128: 452 GB in float32 and
    113 GB in int8 do not fit one H100; the plan is over its dense-free
    lookup (3328 columns), as the port's model packs it."""
    cfg = dataclasses.replace(C.dlrm_terabyte(batch_size=4096), table_dtype=dtype)
    p = plan(cfg, 1)
    assert not p.fits and p.min_model_shards == shards
    assert plan(cfg, shards).fits


def test_plan_model1_single_chip():
    cfg = C.fleetrec_model1()
    p = plan(cfg, n_model=1)
    assert p.fits and p.min_model_shards == 1
    large = sum(t.nbytes for t in cfg.tables
                if t.rows > max(cfg.onehot_max, cfg.onehot_factor_max))
    assert p.take_bytes_total >= large
    assert len(p.shards) == 1 and p.shards[0].uniform_load_frac == pytest.approx(1.0)


def test_qr_criteo_fits_single_chip():
    """The twin of tests/test_qr.py:117: QR criteo fits one card; the exact
    config (bfloat16) does not."""
    p = plan(C.criteo_terabyte(batch_size=4096, **QR), n_model=1)
    assert p.fits, (p.per_chip_bytes, p.hbm_budget_bytes)
    assert p.min_model_shards == 1
    assert not plan(C.criteo_terabyte(batch_size=4096), n_model=1).fits


def tier_config(M, tier):
    base = M.micro_test(batch_size=8)
    return dataclasses.replace(
        base, tables=tuple(dataclasses.replace(t, rows=1000) for t in base.tables),
        onehot_max=64 if tier == "factored" else 2048, onehot_factor_max=2000, onehot_r2=32)


@pytest.mark.parametrize("tier", ["factored", "plain"])
def test_class_bytes_have_no_lane_bloat(tier):
    """The twin of tests/test_ops.py:221, as it holds on the card: a class
    costs its logical bytes (rows_pad x dim x itemsize a table), plain and
    factored alike, what the port allocates; the JAX planner pads a plain
    class's dim to the TPU's 128 lanes (micro_test's dims are 4 to 32), a
    CUDA allocation has no such tiling."""
    cfg = tier_config(C, tier)
    model = init_model(cfg, device=CPU)
    classes = model.layout.onehot_classes
    assert classes and all(bool(c.r2) == (tier == "factored") for c in classes)
    p = plan(cfg, n_model=1)
    logical = sum(c.num_tables * c.rows_pad * c.dim * 4 for c in classes)
    assert p.onehot_bytes == logical == sum(b.nbytes for b in model.packed.onehot_buffers)
    jax_bytes = j_plan(tier_config(JC, tier), n_model=1).onehot_bytes
    if tier == "plain":
        assert jax_bytes > p.onehot_bytes
    else:
        assert jax_bytes >= p.onehot_bytes


def test_column_split_exact_single_device():
    cfg = C.micro_test(batch_size=8)
    tid = next(t.table_id for t in cfg.tables if t.dim == 32)
    tables = ref.init_tables(cfg, scheme="rowid")
    ws = ref.init_mlp_weights(cfg, scheme="uniform")
    rng = np.random.default_rng(0)
    idx = np.stack([rng.integers(0, t.rows, 8) for t in cfg.tables], 1).astype(np.int32)
    dense = rng.uniform(-1, 1, (8, cfg.dense_dim)).astype(np.float32)
    golden = ref.forward(cfg, tables, ws, idx, dense)

    new_cfg, imap = split_table_columns(cfg, tid, 4)
    new_tables = split_table_data(tables, cfg, tid, 4)
    assert new_cfg.num_tables == cfg.num_tables + 3
    new_idx = idx[:, imap]
    np.testing.assert_array_equal(ref.forward(new_cfg, new_tables, ws, new_idx, dense), golden)

    with torch.inference_mode():
        want = init_model(cfg, tables_np=tables, mlp_np=ws, device=CPU)(
            torch.from_numpy(idx), torch.from_numpy(dense)).numpy()
        out = init_model(new_cfg, tables_np=new_tables, mlp_np=ws, device=CPU)(
            torch.from_numpy(np.ascontiguousarray(new_idx)), torch.from_numpy(dense)).numpy()
    np.testing.assert_array_equal(out, want)
    np.testing.assert_allclose(out, golden, rtol=1e-5)


def test_striped_layout_exact_single_device():
    cfg0 = C.micro_test(batch_size=16, rows=512)
    cfg = dataclasses.replace(cfg0, take_stripes=4)
    tables = ref.init_tables(cfg0, scheme="uniform")
    ws = ref.init_mlp_weights(cfg0, scheme="uniform")
    rng = np.random.default_rng(2)
    idx = torch.from_numpy(np.stack([rng.integers(0, t.rows, 16) for t in cfg0.tables],
                                    1).astype(np.int32))
    dense = torch.from_numpy(rng.uniform(-1, 1, (16, cfg0.dense_dim)).astype(np.float32))
    with torch.inference_mode():
        want = init_model(cfg0, tables_np=tables, mlp_np=ws, device=CPU)(idx, dense)
        got = init_model(cfg, tables_np=tables, mlp_np=ws, device=CPU)(idx, dense)
    assert torch.equal(got, want)


def test_split_and_striped_sharded_forwards(tmp_path):
    """Row and column sharding together on a (2, 4) gloo world: micro_test's
    dim-32 table split in 2, and the 4-stripe layout, row-sharded over 4
    model ranks; every data row's scores within rtol / atol 1e-5 of the
    unsplit oracle."""
    cfg = C.micro_test(batch_size=16, rows=512)
    tables = ref.init_tables(cfg, scheme="uniform")
    ws = ref.init_mlp_weights(cfg, scheme="uniform")
    rng = np.random.default_rng(1)
    idx = np.stack([rng.integers(0, t.rows, 16) for t in cfg.tables], 1).astype(np.int32)
    dense = rng.uniform(-1, 1, (16, cfg.dense_dim)).astype(np.float32)
    golden = ref.forward(cfg, tables, ws, idx, dense)
    path = tmp_path / "inputs.npz"
    np.savez(path, idx=idx, dense=dense)
    res = spawn_world(8, run_planner_cases, (2, 4, str(path)), tmp_path)
    for name in ("split", "striped"):
        got = np.concatenate([res[0][name], res[4][name]])
        np.testing.assert_allclose(got, golden, rtol=1e-5, atol=1e-5, err_msg=name)


def test_striped_criteo_balances_plan():
    cfg = C.criteo_terabyte()  # take_stripes=16 default
    p = plan(cfg, n_model=16)
    loads = [s.uniform_load_frac for s in p.shards]
    assert max(loads) / (sum(loads) / len(loads)) < 1.05
    n_take_tables = sum(1 for t in cfg.tables
                        if t.rows > max(cfg.onehot_max, cfg.onehot_factor_max))
    assert all(len(s.tables_touched) == n_take_tables for s in p.shards)
    p0 = plan(dataclasses.replace(cfg, take_stripes=1), n_model=16)
    l0 = [s.uniform_load_frac for s in p0.shards]
    assert max(l0) / (sum(l0) / len(l0)) > 2.0
    assert any("imbalance" in n for n in p0.notes)


def test_striped_layout_flat_where_contiguous_is_not():
    """(c) of tests/test_planner.py's striped test, on a layout with take
    tables (micro_test's 512 rows would all be one-hot)."""
    cfg0 = dataclasses.replace(C.micro_test(batch_size=16, rows=512), onehot_max=64)
    flat = [s.uniform_load_frac for s in plan(dataclasses.replace(cfg0, take_stripes=4),
                                              4).shards]
    lumpy = [s.uniform_load_frac for s in plan(cfg0, 4).shards]
    assert max(flat) / (sum(flat) / 4) < max(lumpy) / (sum(lumpy) / 4)


def test_split_rejects_bad_parts():
    cfg = C.micro_test()
    tid = next(t.table_id for t in cfg.tables if t.dim == 8)
    with pytest.raises(ValueError):
        split_table_columns(cfg, tid, 3)
    with pytest.raises(ValueError):
        split_table_columns(cfg, 999, 2)


def run_cli(capsys, *argv):
    cli.main(list(argv))
    return json.loads(capsys.readouterr().out.strip())


def test_cli_plan(capsys):
    r = run_cli(capsys, "plan", "--config", "criteo_terabyte", "--model-axis", "8",
                "--batch", "64")
    assert r["fits"] is True and r["n_model"] == 8
    assert r["take_bytes_per_chip"] * 8 == r["take_bytes_total"]
    assert r["hbm_budget_bytes"] == H100_HBM_BYTES and "shards" not in r
    r = run_cli(capsys, "plan", "--config", "criteo_terabyte", "--model-axis", "2",
                "--shards", "--hbm-gb", "16")
    assert r["hbm_budget_bytes"] == 16 << 30 and not r["fits"] and len(r["shards"]) == 2


@pytest.mark.parametrize("dtype,model_axis", [("bfloat16", 2), ("int8", 1)])
def test_cli_plan_recommend(capsys, dtype, model_axis):
    r = run_cli(capsys, "plan", "--config", "criteo_terabyte", "--recommend", "16",
                "--dtype", dtype, "--batch", "64")
    assert r["chips"] == 16 and r["model_axis"] == model_axis
    assert r["data_axis"] * r["model_axis"] == 16
    assert r["per_chip_bytes"] <= r["hbm_budget_bytes"]
    r = run_cli(capsys, "plan", "--config", "criteo_terabyte", "--recommend", "1",
                "--dtype", dtype)
    if dtype == "bfloat16":  # 105.9 GB of take rows: not on one card
        assert r["recommend"] is None and "min_model_shards=2" in r["reason"]
    else:
        assert r["model_axis"] == 1 and r["per_chip_bytes"] <= r["hbm_budget_bytes"]


def test_cli_plan_touches_no_device(capsys, monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("cli plan touched the device")

    monkeypatch.setattr(torch.cuda, "is_available", refuse)
    monkeypatch.setattr(torch.cuda, "device_count", refuse)
    r = run_cli(capsys, "plan", "--config", "fleetrec_model1", "--model-axis", "1")
    assert r["fits"]
