"""The port's CUDA kernels against their plain PyTorch versions on the
card.  Every test here is marked ``cuda`` and skips without a CUDA device
(the kernels have no CPU mode; chip_smoke.py runs them on the card too).
The file imports neither JAX nor the JAX package, so it runs where only
PyTorch is installed:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from fleetrec_tpu_torch.config import MLPSpec
from fleetrec_tpu_torch.models.mlp import init_mlp_params
from fleetrec_tpu_torch.ops.gather import gather_rows, gather_rows_grouped, gather_rows_plain
from fleetrec_tpu_torch.ops.mlp_fused import fused_mlp, fused_mlp_plain

MODEL1 = (352, 1024, 512, 256, 1)
RAGGED = (45, 40, 24, 1)
RAGGED_WIDE = (45, 40, 10)
DTYPES = [torch.float32, torch.bfloat16, torch.int8]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode "
                    "(chip_smoke.py runs them on the card)")
    return torch.device("cuda:0")


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
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_fused_mlp_kernel_matches_plain_on_card(cuda, dtype):
    """fp32 rtol/atol 1e-5; bf16 rtol 2e-2 with atol 2e-2 * max|plain|;
    the all-ones closed form exact in both dtypes.  RAGGED_WIDE ends in a
    product (10 wide, padded to 12 / 16) that stores its fp32 output
    column by column."""
    torch.backends.cuda.matmul.allow_tf32 = False
    tol = ({"rtol": 1e-5, "atol": 1e-5} if dtype == torch.float32 else {"rtol": 2e-2})
    rng = np.random.default_rng(5)
    for widths in (MODEL1, RAGGED, RAGGED_WIDE):
        ws = [w.to(cuda, dtype) for w in init_mlp_params(
            MLPSpec(input_dim=widths[0], hidden=widths[1:-1], out_dim=widths[-1]),
            "uniform", seed=3)]
        for B in (1, 77, 700):
            x = torch.from_numpy(rng.uniform(-1, 1, (B, widths[0])).astype(np.float32)).to(cuda, dtype)
            for act in (None, "relu"):
                before = fused_mlp.launches
                got = fused_mlp(ws, x, act)
                assert fused_mlp.launches == before + 1
                want = fused_mlp_plain(ws, x, act)
                atol = tol.get("atol", 2e-2 * want.abs().max().item())
                torch.testing.assert_close(got, want, rtol=tol["rtol"], atol=atol)
    ones = [torch.ones(a, b, device=cuda, dtype=dtype)
            for a, b in ((512, 1024), (1024, 512), (512, 256), (256, 1))]
    out = fused_mlp(ones, torch.ones(100, 512, device=cuda, dtype=dtype))
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
