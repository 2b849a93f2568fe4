"""The port's kernel modules (ops/gather.py, ops/mlp_fused.py, ops/_build.py)
against the JAX package's Pallas kernels, run as the JAX tests run them on
the CPU (interpret mode).  On the CPU the wrappers run their plain PyTorch
versions; the CUDA kernels themselves are compared with those on the card
by the tests marked ``cuda`` (skipped without one) and by chip_smoke.py."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fleetrec_tpu.config import MLPSpec as JMLPSpec
from fleetrec_tpu.models.mlp import init_mlp_params as j_init_mlp
from fleetrec_tpu.models.mlp import mlp_apply as j_mlp_apply
from fleetrec_tpu.ops import fused_mlp as j_fused_mlp
from fleetrec_tpu.ops.gather_pallas import gather_rows as j_gather_rows
from fleetrec_tpu.ops.gather_pallas import gather_rows_grouped as j_gather_rows_grouped
from fleetrec_tpu_torch.config import MLPSpec
from fleetrec_tpu_torch.models.mlp import init_mlp_params, mlp_apply
from fleetrec_tpu_torch.ops import _build
from fleetrec_tpu_torch.ops.gather import (
    SMEM_BYTES,
    gather_rows,
    gather_rows_grouped,
    gather_rows_plain,
    grouped_launch_params,
    grouped_params,
)
from fleetrec_tpu_torch.config import parity_synthetic
from fleetrec_tpu_torch.ops.mlp_fused import (
    PRODUCT,
    ROWDOT,
    TILES,
    fused_mlp,
    fused_mlp_available,
    fused_mlp_plain,
    mlp_plan,
    pad_operands,
)

MODEL1 = (352, 1024, 512, 256, 1)
# the towers of the repo's configs (fleetrec_model1/2/3, criteo_terabyte,
# parity_synthetic(3968)) and a ragged one
TOWERS = {"model1": MODEL1, "model2": (880, 1024, 512, 256, 1),
          "model3": (3968, 2048, 512, 256, 1),
          "criteo": (845, 1024, 1024, 512, 256, 1),
          "parity3968": parity_synthetic(3968).mlp.widths}
RAGGED = (45, 40, 24, 1)
DTYPES = [torch.float32, torch.bfloat16, torch.int8]


# ---- gather ---------------------------------------------------------------

@pytest.mark.parametrize("n", [512, 700])
def test_gather_matches_pallas_gather_rows(n):
    """Twin of test_ops.py::test_pallas_gather_rows_matches_take: the same
    inputs through the Pallas kernel (interpret) and the port, bit-equal."""
    rng = np.random.default_rng(0)
    table = rng.standard_normal((4096, 128)).astype(np.float32)
    idx = rng.integers(0, 4096, n).astype(np.int32)
    want = np.asarray(j_gather_rows(jnp.asarray(table), jnp.asarray(idx),
                                    chunk=256, window=4, interpret=True))
    got = gather_rows(torch.from_numpy(table), torch.from_numpy(idx)).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("idx_dtype", [torch.int32, torch.int64])
def test_gather_out_of_range_ids_give_zero_rows(dtype, idx_dtype):
    rng = np.random.default_rng(1)
    R, L = 50, 8
    table = torch.from_numpy(rng.integers(-100, 100, (R, L)).astype(np.float32)).to(dtype)
    ids = rng.integers(0, R, 20)
    ids[[0, 3, 7]] = (-1, R, -R - 3)
    got = gather_rows(table, torch.from_numpy(ids).to(idx_dtype))
    assert got.dtype == dtype and got.shape == (20, L)
    for i, r in enumerate(ids):
        want = table[r] if 0 <= r < R else torch.zeros(L, dtype=dtype)
        assert torch.equal(got[i], want)


def test_gather_checks_its_inputs():
    t = torch.zeros(4, 8)
    with pytest.raises(ValueError):
        gather_rows(t, torch.zeros(2, 2, dtype=torch.int32))
    with pytest.raises(TypeError):
        gather_rows(t, torch.zeros(2))
    with pytest.raises(TypeError):
        gather_rows(t.double(), torch.zeros(2, dtype=torch.int64))


def test_wrappers_launch_or_raise_never_fall_back():
    """Off the CPU a wrapper launches its kernel or raises: a tensor on a
    device without a kernel (meta) is refused, not computed elsewhere."""
    t = torch.zeros(4, 8, device="meta")
    counts = (gather_rows.launches, fused_mlp.launches)
    with pytest.raises(ValueError, match="no gather kernel"):
        gather_rows(t, torch.zeros(2, dtype=torch.int64, device="meta"))
    with pytest.raises(ValueError, match="no fused_mlp kernel"):
        fused_mlp([torch.zeros(8, 1, device="meta")], t)
    assert (gather_rows.launches, fused_mlp.launches) == counts


# ---- grouped gather --------------------------------------------------------

# (n, chunk, group, window): tests/test_ops.py's clamping cases
GROUPED_CASES = [(512, 256, 8, 4), (700, 256, 8, 4), (256, 256, 16, 64),
                 (96, 64, 5, 2)]


@pytest.mark.parametrize("n,chunk,group,window", GROUPED_CASES)
def test_grouped_matches_pallas_gather_rows_grouped(n, chunk, group, window):
    """Twin of test_ops.py::test_pallas_gather_rows_grouped_matches_take:
    the same inputs through the Pallas kernel (interpret) and the port,
    bit-equal."""
    rng = np.random.default_rng(1)
    table = rng.standard_normal((4096, 128)).astype(np.float32)
    idx = rng.integers(0, 4096, n).astype(np.int32)
    want = np.asarray(j_gather_rows_grouped(
        jnp.asarray(table), jnp.asarray(idx), chunk=chunk, group=group,
        window=window, interpret=True))
    got = gather_rows_grouped(torch.from_numpy(table), torch.from_numpy(idx),
                              chunk=chunk, group=group, window=window)
    np.testing.assert_array_equal(got.numpy(), want)


def _jax_clamp(chunk, group, window):
    """fleetrec_tpu/ops/gather_pallas.py:122-124, as written there."""
    group = max(1, min(group, chunk))
    chunk = (chunk // group) * group
    window = max(1, min(window, chunk // group))
    return chunk, group, window


def _jax_cli_grouped_chunk(chunk, group):
    """fleetrec_tpu/cli.py:491-492, as written there."""
    return (chunk // max(1, min(group, chunk))) * max(1, min(group, chunk))


@pytest.mark.parametrize("chunk", [1, 5, 64, 96, 256, 512, 1024])
def test_grouped_params_is_the_jax_clamp(chunk):
    for group in (1, 3, 5, 8, 16, 300, 2000):
        for window in (1, 2, 4, 8, 64, 500):
            got = grouped_params(chunk, group, window)
            assert got == _jax_clamp(chunk, group, window)
            assert got[0] == _jax_cli_grouped_chunk(chunk, group)


def _smem(chunk, seg):
    """gather_grouped.cu's smem_bytes: 128 barrier slots, ids rounded up
    to 128 bytes, staged rows."""
    return 1024 + -(-8 * chunk // 128) * 128 + chunk * seg


@pytest.mark.parametrize("row_bytes", [1, 3, 12, 16, 32, 128, 512, 4096,
                                       100_000, 232_448, 1_000_000])
def test_grouped_launch_params_fit_shared_memory(row_bytes):
    """The chunk the kernel runs is the JAX clamp's, shrunk to what shared
    memory holds and kept a multiple of the group; the window is clamped
    again; rows wider than shared memory go in slabs, one row a block."""
    for req in [(1024, 8, 4), (512, 8, 8), (256, 16, 64), (64, 5, 2)]:
        chunk, group, window, seg = grouped_launch_params(row_bytes, *req)
        jc, jg, jw = grouped_params(*req)
        assert _smem(chunk, seg) <= SMEM_BYTES
        assert chunk <= jc and group <= jg and window <= jw
        assert chunk % group == 0 and 1 <= window <= chunk // group
        if seg == row_bytes:
            # as many rows as fit: one more group would not
            assert chunk == jc or _smem(chunk + group, row_bytes) > SMEM_BYTES
        else:
            assert _smem(1, row_bytes) > SMEM_BYTES and (chunk, group) == (1, 1)
            assert seg % 16 == 0 or row_bytes % 16


def test_grouped_launch_params_at_gatherbench_defaults():
    # [R, 128] float32 rows of 512 B: 1024-row chunks clamp to 440
    assert grouped_launch_params(512, 512, 8, 8) == (440, 8, 8, 512)
    assert grouped_launch_params(512, 1024, 8, 4) == (440, 8, 4, 512)
    assert grouped_launch_params(64, 1024, 8, 4) == (1024, 8, 4, 64)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("idx_dtype", [torch.int32, torch.int64])
def test_grouped_out_of_range_ids_give_zero_rows(dtype, idx_dtype):
    rng = np.random.default_rng(2)
    R, L = 50, 5
    table = torch.from_numpy(rng.integers(-100, 100, (R, L)).astype(np.float32)).to(dtype)
    ids = rng.integers(0, R, 30)
    ids[[0, 3, 7]] = (-1, R, -R - 3)
    got = gather_rows_grouped(torch.as_tensor(table), torch.from_numpy(ids).to(idx_dtype),
                              chunk=8, group=3, window=2)
    assert got.dtype == dtype and got.shape == (30, L)
    assert torch.equal(got, gather_rows_plain(table, torch.from_numpy(ids)))
    assert not got[[0, 3, 7]].any()


def test_grouped_checks_its_inputs():
    t = torch.zeros(4, 8)
    with pytest.raises(ValueError):
        gather_rows_grouped(t, torch.zeros(2, 2, dtype=torch.int32))
    with pytest.raises(TypeError):
        gather_rows_grouped(t, torch.zeros(2))
    with pytest.raises(ValueError, match="chunk"):
        gather_rows_grouped(t, torch.zeros(2, dtype=torch.int64), chunk=0)
    count = gather_rows_grouped.launches
    with pytest.raises(ValueError, match="no gather kernel"):
        gather_rows_grouped(t.to("meta"), torch.zeros(2, dtype=torch.int64, device="meta"))
    assert gather_rows_grouped.launches == count


# ---- fused MLP ------------------------------------------------------------

def test_fused_mlp_matches_pallas_fused_mlp():
    """Twin of test_ops.py::test_fused_mlp_matches_xla_chain: B=700 (not a
    tile multiple) through the Pallas kernel (interpret) and the port.
    rtol/atol 1e-5: fp32 sums in another order."""
    spec = JMLPSpec(input_dim=352, hidden=(1024, 512, 256))
    ws = j_init_mlp(spec, scheme="uniform", seed=3)
    x = np.random.default_rng(0).uniform(-1, 1, (700, 352)).astype(np.float32)
    want = np.asarray(jax.jit(lambda w, x: j_fused_mlp(w, x))(ws, jnp.asarray(x)))
    got = fused_mlp([torch.from_numpy(np.array(w)) for w in ws],
                    torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_fused_mlp_relu_and_parity_constant():
    """Twin of test_ops.py::test_fused_mlp_relu_and_parity_constant."""
    ws = init_mlp_params(MLPSpec(input_dim=512, hidden=(1024, 512, 256)), "ones")
    x = torch.ones(16, 512)
    out = fused_mlp(ws, x)
    assert out.dtype == torch.float32
    np.testing.assert_array_equal(out[:, 0].numpy(), np.full(16, 68719476736.0, np.float32))
    assert torch.equal(out, fused_mlp(ws, x, activation="relu"))


@pytest.mark.parametrize("activation", [None, "relu"])
def test_mlp_apply_matches_jax_mlp_apply(activation):
    spec_j = JMLPSpec(input_dim=64, hidden=(48, 16), activation=activation)
    spec_t = MLPSpec(input_dim=64, hidden=(48, 16), activation=activation)
    wj = j_init_mlp(spec_j, scheme="uniform", seed=5)
    wt = init_mlp_params(spec_t, scheme="uniform", seed=5)
    for a, b in zip(wj, wt):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())
    x = np.random.default_rng(2).uniform(-1, 1, (33, 64)).astype(np.float32)
    want = np.asarray(j_mlp_apply(wj, jnp.asarray(x), activation=activation))
    got = mlp_apply(wt, torch.from_numpy(x), activation=activation).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_mlp_apply_bf16_matches_jax():
    """bf16 activations: weights cast to bf16, fp32 sums, re-narrowed to
    bf16 between layers, fp32 out.  rtol 2e-2: one bf16 ulp (2^-8) at a
    layer boundary may round the other way when sums run in another
    order."""
    spec = JMLPSpec(input_dim=64, hidden=(48, 16))
    wj = j_init_mlp(spec, scheme="uniform", seed=6, dtype=jnp.bfloat16)
    x = np.random.default_rng(3).uniform(-1, 1, (33, 64)).astype(np.float32)
    want = np.asarray(j_mlp_apply(wj, jnp.asarray(x).astype(jnp.bfloat16)))
    wt = [torch.from_numpy(np.asarray(w, np.float32)).to(torch.bfloat16) for w in wj]
    got = mlp_apply(wt, torch.from_numpy(x).to(torch.bfloat16))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-2,
                               atol=2e-2 * np.abs(want).max())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("name", sorted(TOWERS))
def test_mlp_plan_products_fit_and_the_score_is_a_row_dot(name, dtype):
    """Every layer but the score is a product on one of the kernels' tiles
    (fused_mlp.cu asserts at compile time that each tile's ring of stages
    fits 227 KB), with 16-byte widths; the score is the row-dot."""
    widths = TOWERS[name]
    plan = mlp_plan(widths, dtype, 4096)
    assert fused_mlp_available(widths, dtype)
    assert len(plan.layers) == len(widths) - 1
    for lp, n in zip(plan.layers[:-1], widths[1:-1]):
        assert n >= 8 and lp.kind == PRODUCT
        assert (lp.bm, lp.bn) in TILES
        assert lp.k % (16 // dtype.itemsize) == 0 and lp.n % (16 // dtype.itemsize) == 0
    assert plan.layers[-1].kind == ROWDOT and plan.layers[-1].n == widths[-1] == 1
    # the padded input width: only criteo's 845 is not a 16-byte multiple
    assert plan.k0 == (848 if name == "criteo" else widths[0])
    assert plan.padded[1:-1] == widths[1:-1]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B", [1024, 4096])
def test_mlp_plan_fills_the_card_at_model1(B, dtype):
    """At B=4096 every product layer of model1 gets at least 128 blocks
    (about one per SM of the H100's 132): 64 x 128 where 128 x 128 gives
    fewer.  At B=1024 the tiles shrink to 64 x 64, which layer 3 (N=256)
    fills only half-way."""
    plan = mlp_plan(MODEL1, dtype, B)
    for lp in plan.layers[:-1]:
        blocks = -(-B // lp.bm) * -(-lp.n // lp.bn)
        assert blocks >= (128 if B == 4096 or lp.n > 256 else 64)
    assert plan.layers[-1].kind == ROWDOT  # one warp a row
    want = {4096: [(128, 128), (128, 128), (64, 128)],
            1024: [(64, 128), (64, 64), (64, 64)]}[B]
    assert [(lp.bm, lp.bn) for lp in plan.layers[:-1]] == want


@pytest.mark.parametrize("dtype,B,want", [
    (torch.float32, 4096, 4096 * (1024 + 512) * 4),  # 24 MB
    (torch.bfloat16, 4096, 4096 * (1024 + 512) * 2),
    (torch.float32, 77, 77 * (1024 + 512) * 4),
])
def test_mlp_plan_scratch_is_the_ping_pong(dtype, B, want):
    """Layers 1 and 3 write buffer 0 (1024 and 256 wide), layer 2 buffer 1
    (512 wide): the scratch holds the widest of each."""
    plan = mlp_plan(MODEL1, dtype, B)
    assert plan.scratch_rows == (1024, 512)
    assert plan.scratch_bytes == want
    assert mlp_plan((8, 1), dtype, B).scratch_bytes == 0  # the score alone


def test_mlp_plan_refuses_what_the_kernels_do_not_take():
    with pytest.raises(ValueError, match="layers"):
        mlp_plan((8,) * 10 + (1,), torch.float32, 16)
    with pytest.raises(ValueError, match="width below 1"):
        mlp_plan((8, 0, 1), torch.float32, 16)
    assert not fused_mlp_available((8,) * 10 + (1,), torch.float32)
    assert not fused_mlp_available((8, 0, 1), torch.float32)
    assert not fused_mlp_available(MODEL1, torch.float16)
    assert fused_mlp_available((40000, 1), torch.float32)  # no longer bound by a row tile
    assert mlp_plan((8,) * 8 + (1,), torch.float32, 16).layers[-1].kind == ROWDOT


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("widths", [RAGGED, (845, 64, 30, 12)])
def test_zero_padding_leaves_the_plain_chain_bit_equal(widths, dtype):
    """x and the weights zero-padded to the plan's widths give the very
    same sums: the padded chain, cut back to the real output, is
    bit-equal to the unpadded one.  Values in {-1, 0, 1}, so every sum is
    exact in any order (the CPU's BLAS blocks K = 845 and 848 apart)."""
    rng = np.random.default_rng(11)
    B = 77
    ws = [torch.from_numpy(rng.integers(-1, 2, (a, b)).astype(np.float32)).to(dtype)
          for a, b in zip(widths[:-1], widths[1:])]
    x = torch.from_numpy(rng.integers(-1, 2, (B, widths[0])).astype(np.float32)).to(dtype)
    plan = mlp_plan(widths, dtype, B)
    xp, wp = pad_operands(plan, ws, x)
    assert xp.shape == (B, plan.k0)
    assert [tuple(w.shape) for w in wp] == [(lp.k, lp.n) for lp in plan.layers]
    assert all(w.is_contiguous() and w.dtype == dtype for w in wp)
    for act in (None, "relu"):
        want = fused_mlp_plain(ws, x, act)
        got = fused_mlp_plain(wp, xp, act)[:, :widths[-1]]
        assert torch.equal(got, want)
    if widths == RAGGED:
        assert plan.padded[:3] == (48, 40, 24)


def test_fused_mlp_matches_pallas_fused_mlp_on_ragged_widths():
    """Twin of the padding case: widths 45-40-24-1 (input padded to 48 on
    the card), B=77, through the Pallas kernel (interpret) and the port.
    rtol/atol 1e-5: fp32 sums in another order."""
    spec = JMLPSpec(input_dim=45, hidden=(40, 24))
    ws = j_init_mlp(spec, scheme="uniform", seed=4)
    x = np.random.default_rng(12).uniform(-1, 1, (77, 45)).astype(np.float32)
    for act in (None, "relu"):
        want = np.asarray(jax.jit(lambda w, x: j_fused_mlp(w, x, activation=act))(
            ws, jnp.asarray(x)))
        got = fused_mlp([torch.from_numpy(np.array(w)) for w in ws],
                        torch.from_numpy(x), activation=act).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_mlp_plan_is_made_once_per_widths_dtype_and_batch(dtype):
    """The wrapper asks for the plan at every call: the same widths (as a
    list or a tuple), dtype and batch give the same plan object; another
    batch or dtype another plan.  The kernels take it as 6 ints a layer."""
    plan = mlp_plan(MODEL1, dtype, 4000)
    assert mlp_plan(list(MODEL1), dtype, 4000) is plan
    assert mlp_plan(MODEL1, dtype, 1000) is not plan
    other = torch.bfloat16 if dtype == torch.float32 else torch.float32
    assert mlp_plan(MODEL1, other, 4000) is not plan
    assert len(plan.ints) == 6 * len(plan.layers)
    assert plan.ints[:6] == (PRODUCT, 128, 128, 352, 1024, 1024)
    # B=4000: layer 3 (N=256) on 64 x 64, the first ragged batch of every tile
    assert [(lp.bm, lp.bn) for lp in plan.layers[:-1]] == [(128, 128), (128, 128), (64, 64)]
    assert [(lp.bm, lp.bn) for lp in mlp_plan(MODEL1, dtype, 1000).layers[:1]] == [(64, 128)]


# ---- build ----------------------------------------------------------------

def test_build_shared_keys_by_source_and_raises_on_failure(tmp_path):
    src = tmp_path / "probe.c"
    src.write_text("int fr_probe(void) { return 7; }\n")
    cmd, link = ["gcc", "-O1", "-fPIC"], ["gcc", "-shared"]
    a = _build.build_shared("probe_test", [str(src)], cmd, link)
    assert _build.build_shared("probe_test", [str(src)], cmd, link) == a
    import ctypes
    assert ctypes.CDLL(a).fr_probe() == 7
    src.write_text("int fr_probe(void) { return 8; }\n")
    b = _build.build_shared("probe_test", [str(src)], cmd, link)
    assert b != a and ctypes.CDLL(b).fr_probe() == 8
    src.write_text("int fr_probe(void) { return }\n")
    with pytest.raises(_build.BuildError):
        _build.build_shared("probe_test", [str(src)], cmd, link)


def test_build_shared_compiles_each_source_then_links(tmp_path):
    """Each source compiles to an object (all started together) and the
    objects link into one library; a failing source raises and leaves no
    library behind."""
    a, b = tmp_path / "a.c", tmp_path / "b.c"
    a.write_text("int fr_a(void) { return 1; }\n")
    b.write_text("int fr_b(void) { return 2; }\n")
    cc, link = ["gcc", "-O1", "-fPIC"], ["gcc", "-shared"]
    lib = _build.build_shared("probe_link", [str(a), str(b)], cc, link)
    import ctypes
    so = ctypes.CDLL(lib)
    assert (so.fr_a(), so.fr_b()) == (1, 2)
    assert _build.build_shared("probe_link", [str(a), str(b)], cc, link) == lib
    b.write_text("int fr_b(void) { return }\n")
    with pytest.raises(_build.BuildError, match="b.c"):
        _build.build_shared("probe_link", [str(a), str(b)], cc, link)
