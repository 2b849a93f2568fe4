"""The port's sharded checkpoints (``fleetrec_tpu_torch/io.py``:
``save_sharded`` / ``load_sharded`` on ``torch.distributed.checkpoint``)
against the JAX package's forward on the same params.

Every model starts from seeded numpy params: the JAX package's
``init_model`` packs them, ``convert.params_from_jax`` hands the same
buffers to the port, and the port's checkpoints carry them on.  The twins of
the orbax tests of tests/test_io_multihost.py (the orbax half of :41-60,
:63, :119 and :139) run in this process; the restores across meshes run in
one gloo world of 4 spawned ranks (tests/torch_worlds.py::run_checkpoints),
which holds a (2, 2) and a (1, 4) mesh: one device -> (2, 2), (2, 2) ->
(2, 2), (2, 2) -> (1, 4) and (1, 4) -> one device (this process), for
micro_test with and without QR, a dot-head config (bottom weights), a cross
config, bfloat16, int8 (class tables only, and every table in the take
tier) and an SGD step on (2, 2) before the save.  The one-device
checkpoints the world starts from are stored in row blocks of at most 2 KiB
(``io.BLOCK_BYTES``), so its restores read pieces that straddle the shards.

Tolerances: every restore holds every array bit for bit, so a restored
model's scores are bit-equal to the scores of the model that was saved on
the same mesh shape.  Against the JAX package's forward: bit-equal on pm1
tables with all-ones weights and integer dense features, else within
tests/test_parity.py:107's rtol 1e-3 / atol 2e-3.  A sharded forward against
one device's: bit-equal on pm1 data, else rtol 2e-6 / atol 1e-6 (the
W1-partial sums add in another order; tests/test_torch_sharded.py).  The
trained (2, 2) mesh against the port's one-device SGD step: rtol 1e-5 /
atol 1e-6 (gradients summed in another order)."""

import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fleetrec_tpu import config as JC
from fleetrec_tpu import reference as jref
from fleetrec_tpu.models import init_model as j_init_model
from fleetrec_tpu_torch import config as TC
from fleetrec_tpu_torch import io as tio
from fleetrec_tpu_torch.convert import params_from_jax
from fleetrec_tpu_torch.models.fleetrec import ModelPlan, trainable_tensors
from fleetrec_tpu_torch.models.train import SGD, Trainer
from torch_variants import CPU
from torch_worlds import case_config, checkpoint_arrays, run_checkpoints, spawn_world

EXACT = "exact"
PARITY = dict(rtol=1e-3, atol=2e-3)
SHARDED = dict(rtol=2e-6, atol=1e-6)
STEP = dict(rtol=1e-5, atol=1e-6)
LR = 0.1
B = 32  # the global batch: 16 rows a data row on (2, 2)
# the row blocks of the one-device checkpoints the world restores
WORLD_BLOCK_BYTES = 2048


def case(name, cfg, tables="uniform", mlp="uniform", check=PARITY, kind="forward", **kw):
    return dict(name=name, cfg=cfg, tables=tables, mlp=mlp, check=check, kind=kind, **kw)


CASES = [
    case("micro", "micro32"),
    case("micro_pm1", "micro32", tables="pm1", mlp="ones", dense="int3", check=EXACT),
    case("qr", "qr"),
    case("qr_pm1", "qr", tables="pm1", mlp="ones", dense="int3", check=EXACT),
    case("dlrm", "micro_dlrm70", tables="pm1", mlp="ones", dense="int3", check=EXACT),
    case("cross", "micro_cross70", tables="pm1", mlp="ones", dense="int3", check=EXACT),
    case("bf16", "micro32", table_dtype="bfloat16", tables="pm1", mlp="ones", dense="int3",
         check=EXACT),
    # JAX's CPU backend has no bfloat16 x bfloat16 product: held to the
    # port's own one-device forward only
    case("bf16_weights", "micro32", dtype="bfloat16", tables="pm1", mlp="ones",
         dense="int3", check=EXACT, jax=False),
    case("int8", "micro_int8", tables="pm1"),
    case("take_int8", "micro_take_int8", tables="pm1", mlp="ones", dense="int3",
         check=EXACT),
    case("train", "micro32", kind="train", lr=LR),
]
BY_NAME = {c["name"]: c for c in CASES}
NAMES = [c["name"] for c in CASES]
FORWARD = [c["name"] for c in CASES if c["kind"] == "forward"]


def config(C, c):
    """A case's config from either package's config module: its ``dtype``
    for the tables and the activations, or its ``table_dtype`` for the
    tables alone."""
    cfg = case_config(C, c["cfg"], c.get("dtype"))
    return dataclasses.replace(cfg, table_dtype=c["table_dtype"]) if "table_dtype" in c else cfg


def jax_model(c):
    """The JAX package's (model, params) of a case, from its seeded numpy
    tables and top-tower weights (the heads' own weights from the package's
    seeds)."""
    cfg = config(JC, c)
    model, _ = j_init_model(cfg)
    tables = [jref.init_table(t, scheme=c["tables"], seed=3)
              for t in (model.spec_tables or cfg.tables)]
    return j_init_model(cfg, tables_np=tables,
                        mlp_np=jref.init_mlp_weights(cfg, scheme=c["mlp"], seed=4),
                        mlp_scheme=c["mlp"])


def port_model(c, params):
    return params_from_jax(config(TC, c), jax.tree_util.tree_map(np.asarray, params),
                           device=CPU)


def make_inputs(c):
    """(ids [B, T] int32, dense [B, dense_dim] or None, labels [B]) of a
    case, from its numpy seed."""
    cfg = config(TC, c)
    rng = np.random.default_rng(c.get("seed", 11))
    idx = np.stack([rng.integers(0, t.rows, B) for t in cfg.tables], 1).astype(np.int32)
    dense = None
    if cfg.dense_dim:
        dense = (rng.integers(0, 3, (B, cfg.dense_dim)) if c.get("dense") == "int3"
                 else rng.uniform(-1, 1, (B, cfg.dense_dim))).astype(np.float32)
    return idx, dense, rng.integers(0, 2, B).astype(np.float32)


def jax_scores(model, params, idx, dense):
    d = None if dense is None else jnp.asarray(dense)
    return np.asarray(jax.jit(model.forward)(params, jnp.asarray(idx), d))


def port_scores(model, idx, dense):
    with torch.inference_mode():
        return model(torch.from_numpy(idx),
                     None if dense is None else torch.from_numpy(dense)).numpy()


def agree(got, want, check, what):
    if want is None:  # no JAX forward for this case
        return
    if check == EXACT:
        np.testing.assert_array_equal(got, want, err_msg=what)
    else:
        np.testing.assert_allclose(got, want, err_msg=what, **check)


def same_arrays(got, want, what):
    assert got.keys() == want.keys(), what
    for k in want:
        assert np.array_equal(got[k], want[k]), f"{what}: array {k} differs"


# ---- twins of the orbax tests (one process) ---------------------------------

def test_sharded_fingerprint_mismatch(tmp_path):
    """Twin of the orbax half of tests/test_io_multihost.py:41-60: a
    checkpoint of another geometry fails fast with ConfigMismatchError."""
    other = case("tiny", "tiny_dlrm")
    other_model = port_model(other, jax_model(other)[1])
    path = str(tmp_path / "other")
    tio.save_sharded(path, other_model)
    with pytest.raises(tio.ConfigMismatchError, match="different model geometry"):
        tio.load_sharded(path, TC.micro_test(batch_size=8), device=CPU)


def test_sharded_roundtrip(tmp_path):
    """Twin of tests/test_io_multihost.py:63: uniform micro_test saved from
    one device and restored onto one device, every array bit-equal, scores
    bit-equal to the saved model's and within PARITY of JAX's forward."""
    c = BY_NAME["micro"]
    jm, jp = jax_model(c)
    model = port_model(c, jp)
    idx, dense, _ = make_inputs(c)
    path = str(tmp_path / "ckpt")
    tio.save_sharded(path, model)
    got = tio.load_sharded(path, model.cfg, device=CPU)
    same_arrays(checkpoint_arrays(got), checkpoint_arrays(model), "restored")
    scores = port_scores(got, idx, dense)
    np.testing.assert_array_equal(scores, port_scores(model, idx, dense))
    agree(scores, jax_scores(jm, jp, idx, dense), PARITY, "against JAX")
    with open(os.path.join(path, tio.CONFIG_FILE)) as f:
        assert json.load(f) == {"name": model.cfg.name,
                                "fingerprint": tio.config_fingerprint(model.cfg)}


@pytest.mark.parametrize("name", ["int8", "take_int8"])
def test_sharded_int8_scales_roundtrip(tmp_path, name):
    """Twin of tests/test_io_multihost.py:119: int8 tables carry their
    dequant scales through the checkpoint (dropping them would restore
    un-dequantized tables)."""
    c = BY_NAME[name]
    jm, jp = jax_model(c)
    model = port_model(c, jp)
    idx, dense, _ = make_inputs(c)
    path = str(tmp_path / "int8")
    tio.save_sharded(path, model)
    got = tio.load_sharded(path, model.cfg, device=CPU)
    assert got.packed.onehot_scales is not None
    assert (got.packed.take_scales is None) == (model.packed.take_scales is None)
    same_arrays(checkpoint_arrays(got), checkpoint_arrays(model), "restored")
    scores = port_scores(got, idx, dense)
    np.testing.assert_array_equal(scores, port_scores(model, idx, dense))
    agree(scores, jax_scores(jm, jp, idx, dense), c["check"], "against JAX")


# ---- the world: (2, 2) and (1, 4) -------------------------------------------

@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """The cases' one-device checkpoints (in small row blocks), the JAX and
    port scores and arrays of each case's model, and the world's results;
    a failed world fails every test that reads it."""
    tmp = tmp_path_factory.mktemp("checkpoint_world")
    cases, inputs, arrays = {}, {}, {}
    saved = tio.BLOCK_BYTES
    tio.BLOCK_BYTES = WORLD_BLOCK_BYTES
    try:
        for c in CASES:
            jm, jp = jax_model(c)
            model = port_model(c, jp)
            idx, dense, labels = make_inputs(c)
            inputs[c["name"]] = (idx, dense, labels)
            cases[c["name"]] = {"jax": jax_scores(jm, jp, idx, dense) if c.get("jax", True)
                                else None,
                                "port": port_scores(model, idx, dense),
                                "arrays": checkpoint_arrays(model), "model": model}
            tio.save_sharded(str(tmp / f"{c['name']}.one"), model)
    finally:
        tio.BLOCK_BYTES = saved
    np.savez(tmp / "inputs.npz", **{f"{n}/{k}": a for n, arrs in inputs.items()
                                    for k, a in zip(("idx", "dense", "labels"), arrs)
                                    if a is not None})
    try:
        res = spawn_world(4, run_checkpoints, (CASES, str(tmp), str(tmp / "inputs.npz")), tmp)
    except AssertionError as e:
        res = e
    return tmp, cases, inputs, res


def results(world):
    tmp, cases, inputs, res = world
    if isinstance(res, AssertionError):
        raise res
    return tmp, cases, inputs, res


def joined(res, name, key, D, M):
    """A key's scores of every data row's ranks, joined along the batch: the
    ranks of a row must agree bit for bit."""
    for d in range(D):
        for m in range(1, M):
            np.testing.assert_array_equal(res[d * M + m][name][key], res[d * M][name][key])
    return np.concatenate([res[d * M][name][key] for d in range(D)])


def gathered(res, name, key, D, M):
    """The global arrays of a mesh's ranks: a split array's valid rows
    joined by model rank, a replicated array as every rank holds it; every
    data row must hold the same shards."""
    plan = ModelPlan.create(config(TC, BY_NAME[name]))
    for d in range(1, D):
        for m in range(M):
            same_arrays(res[d * M + m][name][key], res[m][name][key],
                        f"data row {d}, shard {m}")
    out = {}
    for k in res[0][name][key]:
        parts = [res[m][name][key][k] for m in range(M)]
        if tio.split_rows(k, plan) is None:
            for m, part in enumerate(parts):
                assert np.array_equal(part, parts[0]), f"replicated {k} differs on shard {m}"
            out[k] = parts[0]
        else:
            out[k] = np.concatenate(parts)
    return out


@pytest.mark.parametrize("name", FORWARD)
def test_one_device_checkpoint_restores_onto_2x2(world, name):
    """A one-device save restored onto (2, 2): every shard holds the
    global arrays' rows bit for bit, padding as packed_operands makes it,
    and the sharded scores agree with JAX's forward and with one device's."""
    _, cases, _, res = results(world)
    c, ref = BY_NAME[name], cases[name]
    assert all(r[name]["pads_one_22"] for r in res)
    same_arrays(gathered(res, name, "arrays_22", 2, 2), ref["arrays"], "(2, 2) shards")
    got = joined(res, name, "scores_one_22", 2, 2)
    agree(got, ref["jax"], c["check"], "against JAX")
    agree(got, ref["port"], EXACT if c["check"] == EXACT else SHARDED, "against one device")


@pytest.mark.parametrize("name", NAMES)
def test_sharded_mesh_roundtrip(world, name):
    """Twin of tests/test_io_multihost.py:139: a (2, 2) save restored onto
    (2, 2): the same shards bit for bit and the same scores bit for bit
    (after the SGD step for the trained case)."""
    _, _, _, res = results(world)
    key = "scores_trained_22" if BY_NAME[name]["kind"] == "train" else "scores_one_22"
    np.testing.assert_array_equal(joined(res, name, "scores_22_22", 2, 2),
                                  joined(res, name, key, 2, 2))
    same_arrays(gathered(res, name, "arrays_22_22", 2, 2),
                gathered(res, name, "arrays_22", 2, 2), "restored (2, 2) shards")
    assert all(r[name]["pads_22_22"] for r in res)


@pytest.mark.parametrize("name", NAMES)
def test_2x2_checkpoint_restores_onto_1x4(world, name):
    """A (2, 2) save restored onto (1, 4): every array, gathered over the
    ranks, byte-equal to the (2, 2) mesh's; the scores within SHARDED of the
    (2, 2) mesh's (bit-equal on pm1 data) and agreeing with JAX's."""
    _, cases, _, res = results(world)
    c = BY_NAME[name]
    same_arrays(gathered(res, name, "arrays_22_14", 1, 4),
                gathered(res, name, "arrays_22", 2, 2), "(1, 4) shards")
    assert all(r[name]["pads_22_14"] for r in res)
    got = joined(res, name, "scores_22_14", 1, 4)
    key = "scores_trained_22" if c["kind"] == "train" else "scores_one_22"
    agree(got, joined(res, name, key, 2, 2), EXACT if c["check"] == EXACT else SHARDED,
          "against the (2, 2) mesh")
    if c["kind"] == "forward":
        agree(got, cases[name]["jax"], c["check"], "against JAX")


@pytest.mark.parametrize("name", NAMES)
def test_1x4_checkpoint_restores_onto_one_device(world, name):
    """A (1, 4) save restored onto one device: the global arrays bit for bit
    (the saved model's, or the trained mesh's), scores bit-equal to the
    saved one-device model's (forward cases) and agreeing with JAX's."""
    tmp, cases, inputs, res = results(world)
    c, ref = BY_NAME[name], cases[name]
    model = tio.load_sharded(str(tmp / f"{name}.1x4"), ref["model"].cfg, device=CPU)
    want = ref["arrays"] if c["kind"] == "forward" else gathered(res, name, "arrays_22", 2, 2)
    same_arrays(checkpoint_arrays(model), want, "one device")
    idx, dense, _ = inputs[name]
    got = port_scores(model, idx, dense)
    if c["kind"] == "forward":
        np.testing.assert_array_equal(got, ref["port"])
        agree(got, ref["jax"], c["check"], "against JAX")
    else:
        agree(got, joined(res, name, "scores_22_14", 1, 4), SHARDED, "against (1, 4)")


def test_trained_mesh_checkpoint_equals_one_device_step(world):
    """The (2, 2) mesh's SGD step, through its checkpoint onto one device:
    the loss and every trainable tensor within STEP of the port's
    one-device step (Trainer with SGD) on the same global batch."""
    tmp, cases, inputs, res = results(world)
    model = cases["train"]["model"]
    idx, dense, labels = (torch.from_numpy(a) for a in inputs["train"])
    want_loss = Trainer(model, optimizer=SGD(LR), device=CPU).step(idx, dense, labels).item()
    assert len({r["train"]["loss"] for r in res}) == 1
    np.testing.assert_allclose(res[0]["train"]["loss"], want_loss, rtol=1e-6)
    got = tio.load_sharded(str(tmp / "train.2x2"), model.cfg, device=CPU)
    for k, w in trainable_tensors(model).items():
        torch.testing.assert_close(trainable_tensors(got)[k], w, **STEP, msg=k)


@pytest.mark.parametrize("mesh", ["one", "2x2", "1x4"])
@pytest.mark.parametrize("name", ["micro", "qr", "dlrm", "take_int8"])
def test_checkpoint_holds_global_arrays_only(world, name, mesh):
    """The checkpoint's metadata: exactly the arrays of _expected_arrays at
    their global shapes (no pad rows or tables), each element in exactly
    one stored chunk, whatever mesh wrote it."""
    tmp, cases, _, _ = results(world)
    cfg = cases[name]["model"].cfg
    meta = tio.dcp.FileSystemReader(str(tmp / f"{name}.{mesh}")).read_metadata()
    want = tio._expected_arrays(ModelPlan.create(cfg))
    assert set(meta.state_dict_metadata) == set(want)
    for k, shape in want.items():
        md = meta.state_dict_metadata[k]
        assert tuple(md.size) == shape, k
        cover = np.zeros(shape, np.int64)
        for ch in md.chunks:
            cover[tuple(slice(o, o + s) for o, s in zip(ch.offsets, ch.sizes))] += 1
        assert (cover == 1).all(), k


# ---- direct checks ----------------------------------------------------------

def tiers(C, **kw):
    """micro_test with rows across the plain, factored and take tiers."""
    base = C.micro_test(batch_size=8)
    rows = [40, 50, 300, 700, 900, 1400, 3000, 5000]
    return dataclasses.replace(
        base, tables=tuple(dataclasses.replace(t, rows=rows[i])
                           for i, t in enumerate(base.tables)),
        **{"onehot_max": 64, "onehot_factor_max": 1500, "onehot_r2": 32, **kw})


def test_wrong_shape_raises_naming_the_array(tmp_path):
    """onehot_factor_max and onehot_r2 are outside the fingerprint but move
    tables between tiers: a checkpoint of one layout loaded for the other
    raises ConfigMismatchError naming the array, before any array is read."""
    from fleetrec_tpu_torch.models import init_model

    saved = init_model(tiers(TC), device=CPU)
    other = tiers(TC, onehot_r2=16)
    assert tio.config_fingerprint(other) == tio.config_fingerprint(saved.cfg)
    path = str(tmp_path / "tiers")
    tio.save_sharded(path, saved)
    with pytest.raises(tio.ConfigMismatchError, match=r"array 'onehot_\d+' has shape"):
        tio.load_sharded(path, other, device=CPU)


def test_wrong_fingerprint_raises(tmp_path):
    """A side file whose fingerprint is not the config's fails the load,
    whatever the arrays hold."""
    from fleetrec_tpu_torch.models import init_model

    cfg = TC.micro_test(batch_size=8)
    path = str(tmp_path / "micro")
    tio.save_sharded(path, init_model(cfg, device=CPU))
    with open(os.path.join(path, tio.CONFIG_FILE), "w") as f:
        json.dump({"name": cfg.name, "fingerprint": "0" * 64}, f)
    with pytest.raises(tio.ConfigMismatchError, match="stored fingerprint 000000000000"):
        tio.load_sharded(path, cfg, device=CPU)


def test_row_blocks_restore_bit_for_bit(tmp_path, monkeypatch):
    """An array of more than BLOCK_BYTES is stored in row blocks of at most
    that size (several chunks in the metadata), and restores bit for bit."""
    from fleetrec_tpu_torch.models import init_model

    model = init_model(case_config(TC, "micro_take"), table_scheme="uniform",
                       mlp_scheme="uniform", device=CPU)
    monkeypatch.setattr(tio, "BLOCK_BYTES", 4096)
    path = str(tmp_path / "blocks")
    tio.save_sharded(path, model)
    meta = tio.dcp.FileSystemReader(path).read_metadata().state_dict_metadata
    take = model.take
    row_bytes = take.shape[1] * take.element_size()
    assert len(meta["take"].chunks) == -(-take.shape[0] // (4096 // row_bytes)) > 1
    for ch in meta["take"].chunks:
        assert ch.sizes[0] * row_bytes <= 4096
    same_arrays(checkpoint_arrays(tio.load_sharded(path, model.cfg, device=CPU)),
                checkpoint_arrays(model), "restored")


def test_load_sharded_needs_the_card_unless_asked(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this host has a card")
    from fleetrec_tpu_torch.models import init_model

    cfg = TC.micro_test(batch_size=8)
    path = str(tmp_path / "micro")
    tio.save_sharded(path, init_model(cfg, device=CPU))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tio.load_sharded(path, cfg)
