"""The port's CUDA kernels against their plain PyTorch versions on the
card.  Every test here is marked ``cuda`` and skips without a CUDA device
(the kernels have no CPU mode; chip_smoke.py runs them on the card too).
The file imports neither JAX nor the JAX package, so it runs where only
PyTorch is installed (from the repo's root, which holds chip_smoke.py,
whose gatherbench flags, ragged ids and bad ids the tests share):

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""

import dataclasses

import numpy as np
import pytest
import torch

from chip_smoke import (BACKWARD_TOL, GB_FLAGS, ID_DRAWS, bags_with_bad, bits, draw_ids,
                        ids_with_bad, order_bound, ragged_rings, within)
from fleetrec_tpu_torch import config as TC
from fleetrec_tpu_torch import reference as ref
from fleetrec_tpu_torch.config import MLPSpec
from fleetrec_tpu_torch.models import init_model
from fleetrec_tpu_torch.models.mlp import init_mlp_params
from fleetrec_tpu_torch.ops.gather import gather_rows, gather_rows_grouped, gather_rows_plain
from fleetrec_tpu_torch.ops.lookup import (lookup_fused, lookup_fused_backward,
                                          lookup_fused_backward_plain, lookup_fused_bags,
                                          lookup_fused_bags_plain, lookup_fused_plain)
from fleetrec_tpu_torch.ops.mlp_fused import fused_mlp, fused_mlp_plain
from fleetrec_tpu_torch.parallel import init_distributed, shard_operands
from torch_variants import HEADS, LAYOUT_CASES, variant

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
    """Bit-equal to the plain version on every copy path (L = 3 and 5 take
    the 4-, 2- and 1-byte paths), the kernel's defaults,
    a clamping case, gatherbench's flags and the ragged rings there, and a
    chunk longer than a page of ids."""
    rng = np.random.default_rng(6)
    for L in (3, 4, 5, 8, 16, 32, 128):
        table = torch.from_numpy(rng.integers(-100, 100, (999, L)).astype(np.float32)).to(cuda, dtype)
        ids = rng.integers(0, 999, 700)
        ids[:3] = (-1, 999, -5)
        cases = {"ids": ids, **ragged_rings(999, rng), "pages": rng.integers(-1, 1000, 3000)}
        for what, ids in cases.items():
            idx = torch.from_numpy(ids).to(cuda)
            want = gather_rows_plain(table, idx)
            # the defaults, a clamping case, gatherbench's flags, and a chunk
            # of three pages of ids (1024 + 1024 + 952 rows at N = 3000)
            for kw in ({"chunk": 1024, "group": 8, "window": 4}, {"chunk": 64, "group": 5, "window": 2},
                       GB_FLAGS, {"chunk": 4096, "group": 16, "window": 8}):
                before = gather_rows_grouped.launches
                got = gather_rows_grouped(table, idx, **kw)
                assert gather_rows_grouped.launches == before + 1
                assert torch.equal(got, want), (L, what, kw)


@pytest.mark.cuda
@pytest.mark.parametrize("name", LAYOUT_CASES + ["criteo"])
def test_lookup_kernel_matches_plain_on_card(cuda, name):
    """FleetRecModel.lookup (one lookup_fused launch) bit-equal to
    lookup_fused_plain on the same operands: features and flags, every
    storage dtype (criteo: bf16, 16 stripes, 845 wide), int32 and int64
    ids, bad ids among them; B = 20000 on micro makes blocks walk several
    tiles."""
    rng = np.random.default_rng(9)
    for table_dtype in ("bfloat16",) if name == "criteo" else ("float32", "bfloat16", "int8"):
        cfg = dataclasses.replace(variant(name, TC), table_dtype=table_dtype)
        model = init_model(cfg, table_scheme="uniform", device=cuda)
        ops = model.lookup_operands()
        for B in (cfg.batch_size, 3000, *((20000,) if name == "micro" else ())):
            ids = ids_with_bad(cfg, B, rng)
            # the lookup's dense tail (a DLRM layout has none: its dense
            # features feed the bottom tower)
            dd = model.layout.dense_dim
            dense = (torch.from_numpy(rng.uniform(-1, 1, (B, dd)).astype(np.float32))
                     .to(cuda) if dd else None)
            for idt in (torch.int32, torch.int64):
                idx = torch.from_numpy(ids).to(cuda, idt)
                before = lookup_fused.launches
                got, bad = model.lookup(idx, dense)
                assert lookup_fused.launches == before + 1
                want, want_bad = lookup_fused_plain(idx, dense, **ops)
                torch.cuda.synchronize()
                what = (name, table_dtype, B, idt)
                assert got.dtype == want.dtype and torch.equal(bits(got), bits(want)), what
                assert (bad is None) == (want_bad is None), what
                assert bad is None or torch.equal(bad, want_bad), what


@pytest.mark.cuda
@pytest.mark.parametrize("name", LAYOUT_CASES + ["criteo"])
def test_bag_lookup_kernel_matches_plain_on_card(cuda, name):
    """FleetRecModel.lookup_pooled (one lookup_fused_bags launch) bit-equal
    to lookup_fused_bags_plain on the same operands: features and flags,
    sum and mean pooling, every storage dtype, int32 and int64 ids, L = 1,
    3 and 8 with padding, empty bags, ids below -1 and out-of-range ids
    among them; and L = 1 without negative ids bit-equal to lookup_fused."""
    rng = np.random.default_rng(12)
    for table_dtype in ("bfloat16",) if name == "criteo" else ("float32", "bfloat16", "int8"):
        cfg = dataclasses.replace(variant(name, TC), table_dtype=table_dtype)
        model = init_model(cfg, table_scheme="uniform", device=cuda)
        ops = model.lookup_operands()
        dd = model.layout.dense_dim
        for B, L in ((cfg.batch_size, 3), (3000, 1), (3000, 8)):
            dense = (torch.from_numpy(rng.uniform(-1, 1, (B, dd)).astype(np.float32))
                     .to(cuda) if dd else None)
            ids = bags_with_bad(cfg, B, L, rng)
            for idt, mean in ((torch.int32, False), (torch.int64, True)):
                idx = torch.from_numpy(ids).to(cuda, idt)
                before = lookup_fused_bags.launches
                got, bad = model.lookup_pooled(idx, dense, mean)
                assert lookup_fused_bags.launches == before + 1
                want, want_bad = lookup_fused_bags_plain(idx, dense, mean=mean, **ops)
                torch.cuda.synchronize()
                what = (name, table_dtype, B, L, idt, mean)
                assert got.dtype == want.dtype and torch.equal(bits(got), bits(want)), what
                assert (bad is None) == (want_bad is None), what
                assert bad is None or torch.equal(bad, want_bad), what
        single = torch.from_numpy(ids_with_bad(cfg, 3000, rng)).clamp(min=0).to(cuda)
        one, one_bad = model.lookup(single, dense)
        for mean in (False, True):
            got, bad = model.lookup_pooled(single[:, :, None].contiguous(), dense, mean)
            assert torch.equal(bits(got), bits(one)), (name, table_dtype, mean)
            assert bad is None or torch.equal(bad, one_bad)


@pytest.mark.cuda
@pytest.mark.parametrize("M", [2, 4])
@pytest.mark.parametrize("name", LAYOUT_CASES + ["criteo"])
def test_window_kernels_match_plain_on_card(cuda, name, M):
    """The row-window form of both lookup kernels (model shard m of M:
    parallel/sharded.py::shard_operands' class slices, take window and
    shard descriptors) bit-equal to the plain versions on the same
    operands, features and flags, float32 / bfloat16 / int8 buffers, single
    ids and bags of 4; the M shards' single-id features summed are the
    unsharded kernel's, bit for bit, and every shard flags the rows it
    flags."""
    rng = np.random.default_rng(13)
    for table_dtype in ("bfloat16",) if name == "criteo" else ("float32", "bfloat16", "int8"):
        cfg = dataclasses.replace(variant(name, TC), table_dtype=table_dtype)
        model = init_model(cfg, table_scheme="uniform", device=cuda)
        dd = model.layout.dense_dim
        B = 3000
        dense = (torch.from_numpy(rng.uniform(-1, 1, (B, dd)).astype(np.float32)).to(cuda)
                 if dd else None)
        ids = torch.from_numpy(ids_with_bad(cfg, B, rng)).to(cuda)
        bags = torch.from_numpy(bags_with_bad(cfg, B, 4, rng)).to(cuda)
        whole, whole_bad = model.lookup(ids, dense)
        total = None
        for m in range(M):
            ops = shard_operands(model, m, M, cuda)
            d = dense if ops["dense_dim"] else None
            for kernel, plain, x in ((lookup_fused, lookup_fused_plain, ids),
                                     (lookup_fused_bags, lookup_fused_bags_plain, bags)):
                before = kernel.launches
                got, bad = kernel(x, d, **ops)
                assert kernel.launches == before + 1
                want, want_bad = plain(x, d, **ops)
                torch.cuda.synchronize()
                what = (name, table_dtype, M, m, kernel.__name__)
                assert got.dtype == want.dtype and torch.equal(bits(got), bits(want)), what
                assert (bad is None) == (want_bad is None), what
                assert bad is None or torch.equal(bad, want_bad), what
                if kernel is lookup_fused:
                    assert bad is None or torch.equal(bad, whole_bad), what
                    total = got if total is None else total + got
        assert torch.equal(total, whole), (name, table_dtype, M)


@pytest.mark.cuda
@pytest.mark.parametrize("name", HEADS)
def test_interaction_heads_match_the_oracle_on_card(cuda, name):
    """The micro DLRM and DCNv2 models on the card, pm1 tables and all-ones
    weights, small integer dense values: scores bit-equal to the float64
    oracle, one lookup_fused launch and two fused_mlp calls (DLRM: bottom
    and top tower) or one (DCNv2) a forward."""
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = variant(name, TC)
    rng = np.random.default_rng(10)
    B = cfg.batch_size
    idx = np.stack([rng.integers(0, t.rows, B) for t in cfg.tables], 1).astype(np.int32)
    dense = rng.integers(0, 2, (B, cfg.dense_dim)).astype(np.float32)
    model = init_model(cfg, device=cuda)
    before = (lookup_fused.launches, fused_mlp.launches)
    with torch.inference_mode():
        got = model(torch.from_numpy(idx).to(cuda), torch.from_numpy(dense).to(cuda)).cpu().numpy()
    calls = (lookup_fused.launches - before[0], fused_mlp.launches - before[1])
    assert calls == (1, 2 if cfg.interaction == "dot" else 1)
    heads = ({"bottom_weights": ref.init_bottom_weights(cfg)} if cfg.interaction == "dot"
             else {"cross_weights": ref.init_cross_weights(cfg)})
    want = ref.forward(cfg, ref.init_tables(cfg), ref.init_mlp_weights(cfg), idx, dense, **heads)
    np.testing.assert_array_equal(got, want.astype(np.float32))


def _check_backward_pair(got, want, kind, what, bounds=None):
    """Kernel against plain gradients: bit-equal on integer cotangents
    (every float32 sum an integer below 2^24, exact in any order of the
    adds, then rounded once to the storage dtype by both), within rtol 1e-5
    / atol 1e-4 on uniform ones (float32 sums of a few terms in another
    order), and for bfloat16 within one bfloat16 rounding of those sums
    (rtol 2^-7).  ``bounds``: chip_smoke.order_bound's, added to the
    tolerance for a draw that puts up to B terms on one element."""
    for i, (a, b) in enumerate(zip(got, want)):
        assert a.dtype == b.dtype and a.shape == b.shape, what
        if kind == "integer":
            assert torch.equal(bits(a), bits(b)), what
        elif bounds is not None:
            tol = BACKWARD_TOL[a.dtype]
            assert within(a, b, tol, bounds[i]), what
        elif a.dtype == torch.float32:
            torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-4)
        else:
            torch.testing.assert_close(a.float(), b.float(), rtol=2.0 ** -7, atol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("name", LAYOUT_CASES + ["criteo", "narrow"])
def test_lookup_backward_kernel_matches_plain_on_card(cuda, name):
    """lookup_fused_backward (one launch a call) against
    lookup_fused_backward_plain on the same operands, float32 and bfloat16
    storage, int32 and int64 ids with bad ones (which add nothing), B = the
    config's and 3000, by _check_backward_pair; at B = 3000 also every id 0
    and skewed ids (chip_smoke.draw_ids), and ``out=`` float32 sums that
    already hold integers, which the kernel adds into (bit-equal to the
    plain version's, and to the prior sums plus a zeroed call's)."""
    rng = np.random.default_rng(13)
    for table_dtype in ("bfloat16",) if name == "criteo" else ("float32", "bfloat16"):
        cfg = dataclasses.replace(variant(name, TC), table_dtype=table_dtype)
        model = init_model(cfg, device=cuda)
        ops = model.lookup_operands()
        args = (ops["bufs"], ops["cols"], ops["pos"], ops["stripes"], ops["stripe_height"])
        F = model.layout.feature_dim
        draws = [(B, "uniform", torch.from_numpy(ids_with_bad(cfg, B, rng)))
                 for B in (cfg.batch_size, 3000)]
        draws += [(3000, d, torch.from_numpy(draw_ids(cfg, 3000, rng, d))) for d in ID_DRAWS[1:]]
        for B, draw, ids in draws:
            for idt in (torch.int32, torch.int64):
                idx = ids.to(cuda, idt)
                for kind in ("integer", "uniform"):
                    ct = (rng.integers(-1, 2, (B, F)) if kind == "integer"
                          else rng.uniform(-1, 1, (B, F)))
                    g = torch.from_numpy(ct.astype(np.float32)).to(cuda, ops["bufs"][0].dtype)
                    before = lookup_fused_backward.launches
                    got = lookup_fused_backward(g, idx, *args)
                    assert lookup_fused_backward.launches == before + 1
                    want = lookup_fused_backward_plain(g, idx, *args)
                    bounds = (order_bound(g, idx, *args)
                              if kind == "uniform" and draw != "uniform" else None)
                    torch.cuda.synchronize()
                    _check_backward_pair(got, want, kind, (name, table_dtype, B, draw, idt, kind),
                                         bounds)
                    if kind == "integer" and idt == torch.int32 and B == 3000:
                        prior = [torch.from_numpy(rng.integers(-50, 51, b.numel()).astype(
                            np.float32)).to(cuda) for b in ops["bufs"]]
                        into = lookup_fused_backward(g, idx, *args, out=[p.clone() for p in prior])
                        plain = lookup_fused_backward_plain(g, idx, *args,
                                                            out=[p.clone() for p in prior])
                        zeroed = lookup_fused_backward(g, idx, *args,
                                                       out=[torch.zeros_like(p) for p in prior])
                        torch.cuda.synchronize()
                        for a, b, z, p in zip(into, plain, zeroed, prior):
                            assert torch.equal(bits(a), bits(b)), (name, table_dtype, draw, "out=")
                            assert torch.equal(a, z + p), (name, table_dtype, draw, "out=")


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["micro", "qr", "micro_dlrm", "narrow"])
def test_backward_kernel_one_float_at_a_time_on_card(cuda, name):
    """The backward kernel without its 16-byte loads and reductions, in a
    plan with ``vec=False`` and with ``out=`` sums that start 4 bytes past
    a 16-byte boundary (which the wrapper must take one float at a time),
    against the plain version, every draw: integer cotangents bit-equal,
    uniform ones within _check_backward_pair's tolerances."""
    from fleetrec_tpu_torch.ops import lookup as tlk

    rng = np.random.default_rng(15)
    cfg = dataclasses.replace(variant(name, TC), table_dtype="float32")
    model = init_model(cfg, device=cuda)
    ops = model.lookup_operands()
    args = (ops["bufs"], ops["cols"], ops["pos"], ops["stripes"], ops["stripe_height"])
    B, F = 3000, model.layout.feature_dim
    plan = tlk.backward_plan(ops["cols"], ops["pos"], B, torch.cuda.get_device_properties(
        cuda).multi_processor_count, vec=False)
    for draw in ID_DRAWS:
        idx = torch.from_numpy(draw_ids(cfg, B, rng, draw)).to(cuda)
        for kind in ("integer", "uniform"):
            ct = rng.integers(-1, 2, (B, F)) if kind == "integer" else rng.uniform(-1, 1, (B, F))
            g = torch.from_numpy(ct.astype(np.float32)).to(cuda)
            want = lookup_fused_backward_plain(g, idx, *args)
            bounds = (order_bound(g, idx, *args)
                      if kind == "uniform" and draw != "uniform" else None)
            got = lookup_fused_backward(g, idx, *args, plan=plan)
            off = [torch.zeros(b.numel() + 1, device=cuda)[1:] for b in ops["bufs"]]
            assert all(o.data_ptr() % 16 for o in off)
            lookup_fused_backward(g, idx, *args, out=off)
            torch.cuda.synchronize()
            _check_backward_pair(got, want, kind, (name, draw, kind, "vec=False"), bounds)
            _check_backward_pair([o.view(w.shape) for o, w in zip(off, want)], want, kind,
                                 (name, draw, kind, "unaligned out="), bounds)


@pytest.mark.cuda
@pytest.mark.parametrize("M", [2, 4])
@pytest.mark.parametrize("name", LAYOUT_CASES + ["criteo", "narrow"])
def test_window_backward_kernel_matches_plain_on_card(cuda, name, M):
    """lookup_fused_backward in its row-window form (model shard m of M:
    shard_operands' class slices, take window and descriptors; one launch a
    call) against lookup_fused_backward_plain on the same operands, float32
    and bfloat16: integer cotangents bit-equal, uniform ones within the
    unwindowed test's tolerances; the shards' integer gradients, placed at
    their tables and rows, are the unsharded kernel's bit for bit, the pad
    tables and rows 0.  Every draw of chip_smoke.ID_DRAWS (uniform with bad
    ids, every id 0, skewed)."""
    rng = np.random.default_rng(14)
    for table_dtype in ("bfloat16",) if name == "criteo" else ("float32", "bfloat16"):
        cfg = dataclasses.replace(variant(name, TC), table_dtype=table_dtype)
        model = init_model(cfg, device=cuda)
        ops = model.lookup_operands()
        B, F = 3000, model.layout.feature_dim
        dtype = ops["bufs"][0].dtype
        shards = [shard_operands(model, m, M, cuda) for m in range(M)]
        for draw in ID_DRAWS:
            idx = torch.from_numpy(ids_with_bad(cfg, B, rng) if draw == "uniform"
                                   else draw_ids(cfg, B, rng, draw)).to(cuda)
            cts = {kind: torch.from_numpy(
                (rng.integers(-1, 2, (B, F)) if kind == "integer" else rng.uniform(-1, 1, (B, F)))
                .astype(np.float32)).to(cuda, dtype) for kind in ("integer", "uniform")}
            whole = lookup_fused_backward(cts["integer"], idx, ops["bufs"], ops["cols"],
                                          ops["pos"], ops["stripes"], ops["stripe_height"])
            placed = [[] for _ in whole]
            for m, s in enumerate(shards):
                args = (s["bufs"], s["cols"], s["pos"], s["stripes"], s["stripe_height"])
                for kind, ct in cts.items():
                    before = lookup_fused_backward.launches
                    got = lookup_fused_backward(ct, idx, *args, window=s["window"])
                    assert lookup_fused_backward.launches == before + 1
                    want = lookup_fused_backward_plain(ct, idx, *args, window=s["window"])
                    bounds = (order_bound(ct, idx, *args, window=s["window"])
                              if kind == "uniform" and draw != "uniform" else None)
                    torch.cuda.synchronize()
                    _check_backward_pair(got, want, kind, (name, table_dtype, draw, M, m, kind),
                                         bounds)
                    if kind == "integer":
                        for i, a in enumerate(got):
                            placed[i].append(a)
            for w, parts in zip(whole, placed):
                cat = torch.cat(parts)
                assert torch.equal(bits(cat[:w.shape[0]]), bits(w)), (name, table_dtype, draw, M)
                assert not cat[w.shape[0]:].any(), (name, table_dtype, draw, M)


@pytest.mark.cuda
def test_init_distributed_binds_the_ranks_card(cuda, monkeypatch, tmp_path):
    """init_distributed makes each rank's card (the rank modulo the cards)
    the current CUDA device before it makes the process group (NCCL with one
    rank a card; gloo with two ranks on a one-card host)."""
    import torch.distributed as dist

    n = torch.cuda.device_count()
    world, backend = (n, "nccl") if n >= 2 else (2, "gloo")
    seen = []
    monkeypatch.setattr(dist, "init_process_group",
                        lambda *a, **k: seen.append(torch.cuda.current_device()))
    for var in ("LOCAL_RANK", "LOCAL_WORLD_SIZE"):
        monkeypatch.delenv(var, raising=False)
    prev = torch.cuda.current_device()
    try:
        for rank in range(world):
            init_distributed(f"file://{tmp_path}/rendezvous", world, rank, backend, device="cuda")
    finally:
        torch.cuda.set_device(prev)
    assert seen == [rank % n for rank in range(world)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8"])
@pytest.mark.parametrize("name", ["criteo", "tiers", "qr", "lanes256"])
def test_pm1_generator_matches_pack_tables_on_card(cuda, name, dtype):
    """pack_pm1_sharded on the card (whole, and each window of a (1, 4)
    mesh) writes the bytes pack_tables writes for the pm1 tables, at small
    rows; the window's scores through the sharded lookup of its shard."""
    from fleetrec_tpu_torch.models import pack_pm1_sharded
    from fleetrec_tpu_torch.parallel.mesh import Mesh

    cfg = dataclasses.replace(variant(name, TC), table_dtype=dtype)
    model = init_model(cfg, device=cuda)
    want = model.packed
    got = pack_pm1_sharded(cfg, model.layout, device=cuda, chunk_rows=777)
    assert got.take_buffer.device == cuda
    assert torch.equal(got.take_buffer, want.take_buffer)
    for a, b in zip(got.onehot_buffers + (got.onehot_scales or []),
                    want.onehot_buffers + (want.onehot_scales or [])):
        assert a.shape == b.shape and torch.equal(a, b)
    if want.take_scales is not None:
        assert torch.equal(got.take_scales, want.take_scales)
    for m in range(4):
        win = pack_pm1_sharded(cfg, model.layout, Mesh(1, 4, 0, m, None, cuda), chunk_rows=777)
        assert torch.equal(win.take_buffer, shard_operands(model, m, 4, cuda)["bufs"][-1])


@pytest.mark.cuda
@pytest.mark.parametrize("name,dtype", [("striped", "float32"), ("qr", "bfloat16"),
                                        ("micro_dlrm", "float32"), ("tiers", "int8")])
def test_sharded_checkpoint_roundtrip_on_card(cuda, tmp_path, name, dtype):
    """save_sharded from the card, load_sharded onto the card (its default
    device): every array bit-equal, on the card, and the forward (through
    the kernels) bit-equal to the saved model's."""
    from fleetrec_tpu_torch import io as tio
    from fleetrec_tpu_torch.models.fleetrec import trainable_tensors

    cfg = dataclasses.replace(variant(name, TC), table_dtype=dtype)
    model = init_model(cfg, table_scheme="uniform", mlp_scheme="uniform", device=cuda)
    path = str(tmp_path / "ckpt")
    tio.save_sharded(path, model)
    got = tio.load_sharded(path, cfg)
    assert got.device.type == "cuda"
    for k, t in trainable_tensors(model).items():
        assert torch.equal(trainable_tensors(got)[k], t), k
    if dtype == "int8":
        for a, b in zip(got.packed.onehot_scales, model.packed.onehot_scales):
            assert torch.equal(a, b)
        assert torch.equal(got.take_scales, model.take_scales)
    rng = np.random.default_rng(8)
    ids = torch.from_numpy(np.stack([rng.integers(0, t.rows, 64) for t in cfg.tables], 1)
                           ).to(cuda)
    dense = (torch.from_numpy(rng.uniform(-1, 1, (64, cfg.dense_dim)).astype(np.float32))
             .to(cuda) if cfg.dense_dim else None)
    with torch.inference_mode():
        assert torch.equal(got(ids, dense), model(ids, dense))
