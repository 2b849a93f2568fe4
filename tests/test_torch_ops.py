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
from fleetrec_tpu_torch.ops.mlp_fused import (
    fused_mlp,
    fused_mlp_available,
    fused_mlp_plain,
    tile_rows,
)

MODEL1 = (352, 1024, 512, 256, 1)
DTYPES = [torch.float32, torch.bfloat16, torch.int8]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode "
                    "(chip_smoke.py runs them on the card)")
    return torch.device("cuda:0")


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


@pytest.mark.parametrize("widths,dtype,tile", [
    (MODEL1, torch.float32, 16), (MODEL1, torch.bfloat16, 32),
    ((3968, 2048, 512, 256, 1), torch.float32, 4), ((8, 4, 1), torch.float32, 32),
])
def test_tile_rows_fits_shared_memory(widths, dtype, tile):
    assert tile_rows(widths, dtype) == tile
    assert fused_mlp_available(widths, dtype)


def test_fused_mlp_unavailable_when_a_row_does_not_fit():
    assert tile_rows((40000, 1), torch.float32) == 0
    assert not fused_mlp_available((40000, 1), torch.float32)
    assert not fused_mlp_available((8,) * 10 + (1,), torch.float32)


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


# ---- on the card ------------------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
def test_gather_kernel_matches_plain_on_card(cuda, dtype):
    rng = np.random.default_rng(4)
    for L in (4, 8, 16, 32, 128):
        table = torch.from_numpy(rng.integers(-100, 100, (999, L)).astype(np.float32)).to(cuda, dtype)
        ids = rng.integers(0, 999, 700)
        ids[:3] = (-1, 999, -5)
        idx = torch.from_numpy(ids).to(cuda)
        before = gather_rows.launches
        got = gather_rows(table, idx)
        assert gather_rows.launches == before + 1
        assert torch.equal(got, gather_rows_plain(table, idx))


@pytest.mark.cuda
def test_fused_mlp_kernel_matches_plain_on_card(cuda):
    ws = [w.to(cuda) for w in init_mlp_params(
        MLPSpec(input_dim=352, hidden=(1024, 512, 256)), "uniform", seed=3)]
    x = torch.from_numpy(np.random.default_rng(5).uniform(
        -1, 1, (700, 352)).astype(np.float32)).to(cuda)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.testing.assert_close(fused_mlp(ws, x), fused_mlp_plain(ws, x),
                               rtol=1e-5, atol=1e-5)
    ones = [torch.ones(a, b, device=cuda) for a, b in ((512, 1024), (1024, 512), (512, 256), (256, 1))]
    out = fused_mlp(ones, torch.ones(100, 512, device=cuda))
    assert bool((out == 68719476736.0).all())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
def test_grouped_kernel_matches_plain_on_card(cuda, dtype):
    rng = np.random.default_rng(6)
    for L in (3, 4, 5, 8, 16, 32, 128):
        table = torch.from_numpy(rng.integers(-100, 100, (999, L)).astype(np.float32)).to(cuda, dtype)
        ids = rng.integers(0, 999, 700)
        ids[:3] = (-1, 999, -5)
        idx = torch.from_numpy(ids).to(cuda)
        for chunk, group, window in ((1024, 8, 4), (64, 5, 2)):
            before = gather_rows_grouped.launches
            got = gather_rows_grouped(table, idx, chunk=chunk, group=group, window=window)
            assert gather_rows_grouped.launches == before + 1
            assert torch.equal(got, gather_rows_plain(table, idx))
