"""The bag kernel's host side (``ops/lookup.py::bags_plan``,
``bag_smem_bytes``, ``bag_buffer_rows``) and a numpy interpreter of its
walk (``ops/csrc/lookup_fused.cu::lookup_bags_kernel``), held to
``lookup_fused_bags_plain`` bit for bit on the CPU.

The interpreter follows the kernel tile by tile: each tile's ids brought
into a ring slot as the kernel does (the 16-byte aligned body of the run
by one bulk copy, the ids at its unaligned ends one by one, nothing read
outside the run), a record a bag (the members that add, as row numbers
in slot order; the count of members, padding aside, for the mean; a take
row outside the window left out), and the pooled sums from the first
member in slot order, in float32, rounded once to the output dtype.  The
kernel itself runs only on the card (``tests/test_torch_cuda.py``,
``chip_smoke.py`` phases 10 and 12)."""

import dataclasses

import numpy as np
import pytest
import torch

from fleetrec_tpu_torch import config as TC
from fleetrec_tpu_torch.models import init_model
from fleetrec_tpu_torch.models.embedding import lookup_tensors
from fleetrec_tpu_torch.models.fleetrec import ModelPlan
from fleetrec_tpu_torch.ops import lookup as tlk
from fleetrec_tpu_torch.parallel import shard_operands
from chip_smoke import bags_with_bad
from torch_variants import CPU, LAYOUT_CASES, variant

F_ = {name: i for i, name in enumerate(tlk.LOOKUP_COL_FIELDS)}
# an H100's SMs: the plans below are the card's
SMS = 132


def _bits(t):
    return t.view({4: torch.int32, 2: torch.int16, 1: torch.int8}[t.element_size()])


@pytest.mark.parametrize("L", [1, 3, 4, 8])
@pytest.mark.parametrize("name", list(TC.CONFIGS))
def test_bags_plan_fits_every_registry_config(name, L):
    """For every registry config, whole and on model shards of 2 and 4,
    int32 and int64 ids, 16-byte chunks and single columns, B = 1024 and
    4096: the default plan's ring and records fit a block's shared memory,
    its blocks an SM fit an SM's, and the grid is within its cap and no
    larger than the tiles."""
    mp = ModelPlan.create(TC.get_config(name))
    lay = mp.layout
    for M in (1, 2, 4):
        d = lookup_tensors(lay, mp.index_perm, mp.qr_positions, CPU,
                           shard=None if M == 1 else (0, M))
        n_plan, F = d["cols"].shape[0], d["pos"].shape[0]
        T = len(mp.index_perm) - len(mp.qr_positions)
        for id_bytes in (4, 8):
            for pos_cols in {1, *(c for c in (4, 8) if F % c == 0)}:
                for B in (1024, 4096):
                    p = tlk.bags_plan(B, T, L, F, n_plan, SMS, id_bytes=id_bytes,
                                      pos_cols=pos_cols)
                    assert p.smem == tlk.bag_smem_bytes(F // pos_cols, n_plan, T, L, p.rows,
                                                        p.stages, id_bytes)
                    assert p.smem <= tlk.SMEM_BYTES
                    if p.rows > 1:
                        assert (p.smem + 1024) * tlk.BAG_BLOCKS_PER_SM <= tlk.SM_SMEM_BYTES
                    assert 1 <= p.grid <= min(tlk.BAG_BLOCKS_PER_SM * SMS, -(-B // p.rows))
                    assert (p.stages, p.slots) == (tlk.BAG_STAGES, tlk.BAG_SLOTS)


def test_bags_plan_overrides_and_limits():
    """Explicit rows, blocks an SM, stages and slots are taken as given;
    out-of-range ones and a single row that does not fit raise."""
    p = tlk.bags_plan(4096, 47, 8, 352, 47, SMS, pos_cols=4, rows=16, blocks_per_sm=1,
                      stages=3, slots=8)
    assert (p.rows, p.grid, p.stages, p.slots) == (16, SMS, 3, 8)
    assert p.smem == tlk.bag_smem_bytes(88, 47, 47, 8, 16, 3, 4)
    assert tlk.bags_plan(10, 47, 8, 352, 47, SMS, rows=4).grid == 3  # a block a tile
    for bad in ({"stages": 1}, {"slots": 6}, {"blocks_per_sm": 0}, {"pos_cols": 3}):
        with pytest.raises(ValueError):
            tlk.bags_plan(4096, 47, 8, 352, 47, SMS, **bad)
    # model3 (376 bags a row, 992 chunks) at L = 64: one row's ids and records
    # do not fit a block
    with pytest.raises(ValueError, match="shared memory"):
        tlk.bags_plan(4096, 376, 64, 3968, 376, SMS, pos_cols=4)


def _toy_descriptors(dim):
    """One class column (buffer 0, row width ``dim``, 10 rows) and one
    output column reading its element 0."""
    row = {"src": 0, "op": 0, "rem": 0, "kind": tlk.KIND_CLASS, "buf": 0, "base": 0,
           "lim": 10, "s": 1, "dim": dim, "scale": 0}
    cols = torch.tensor([[row[f] for f in tlk.LOOKUP_COL_FIELDS]], dtype=torch.int64)
    pos = torch.tensor([[0xFFFF0000 - (1 << 32), 0]], dtype=torch.int32)  # col 0, add -1
    return cols, pos


def test_bag_wrapper_raises_on_2_pow_32_rows():
    """A buffer of 2^32 rows or more (of the width of a plan column that
    reads it) makes lookup_fused_bags raise: the kernel keeps a member's row
    as 4 bytes.  bag_buffer_rows counts them from the descriptors, which it
    reads once and remembers while they live (also under inference mode,
    where tensors keep no version)."""
    cols, pos = _toy_descriptors(dim=2)
    small = torch.zeros(20)
    assert tlk.bag_buffer_rows([small], cols) == 10
    huge = torch.zeros(1).expand(2 * (1 << 32))  # 2^32 rows of 2, no memory
    assert tlk.bag_buffer_rows([huge], cols) == 1 << 32
    ids = torch.zeros((2, 1, 3), dtype=torch.int32)
    with pytest.raises(ValueError, match=r"2\^32"):
        tlk.lookup_fused_bags(ids, None, [huge], None, cols, pos)
    below = torch.zeros(1).expand(2 * (1 << 32) - 2)
    assert tlk.bag_buffer_rows([below], cols) == (1 << 32) - 1
    with torch.inference_mode():
        cols1, pos1 = _toy_descriptors(dim=1)
        assert tlk.bag_buffer_rows([small], cols1) == 20
        got, _ = tlk.lookup_fused_bags(ids, None, [small], None, cols1, pos1)
    assert got.shape == (2, 1)


# ---- a numpy interpreter of the bag kernel --------------------------------------


def fetch_ids(mem, addr0, start, end, slot_bytes, isz):
    """One tile's ids in a ring slot, as fetch_ids brings them: ``mem`` the
    ids' bytes, which start at address ``addr0``; [start, end) the tile's
    run.  Returns the slot and the offset of the tile's first id in it.
    Asserts that the copy reads only the run, writes every byte of it once,
    and that the body is a 16-byte aligned run of whole lines."""
    a_s, a_e = addr0 + start, addr0 + end
    base, lo, hi = a_s & ~15, (a_s + 15) & ~15, a_e & ~15
    assert a_e - base <= slot_bytes
    slot = np.full(slot_bytes, 0xA5, np.uint8)
    seen = np.zeros(slot_bytes, np.int64)
    body = hi > lo
    if body:
        assert lo % 16 == 0 and (hi - lo) % 16 == 0 and (lo - base) % 16 == 0
        slot[lo - base:hi - base] = mem[lo - addr0:hi - addr0]
        seen[lo - base:hi - base] += 1
    ends = [(a_s, lo if body else a_e)] + ([(hi, a_e)] if body else [])
    lanes = 0
    for x0, x1 in ends:
        assert (x1 - x0) % isz == 0
        for at in range(x0, x1, isz):  # one id a lane of warp 0
            slot[at - base:at - base + isz] = mem[at - addr0:at - addr0 + isz]
            seen[at - base:at - base + isz] += 1
            lanes += 1
    assert lanes <= 32
    assert (seen[a_s - base:a_e - base] == 1).all() and seen.sum() == a_e - a_s
    return slot, a_s - base


def compact(bag_ids, cols, stripes, stripe_height, window):
    """Pass 1 for a tile's bags [nr, n_plan, L]: (row numbers [nr, n_plan,
    L] of the members that add, in slot order, then -1; their count;
    members (ids >= 0); flags [nr])."""
    f = {k: cols[:, i][None, :, None] for k, i in F_.items()}
    x = bag_ids.astype(np.int64)
    member = x >= 0
    rem = np.maximum(f["rem"], 1)
    x = np.where(f["op"] == tlk.OP_DIV, x // rem, np.where(f["op"] == tlk.OP_MOD, x % rem, x))
    ok = member & (x < f["lim"])
    take = f["kind"] == tlk.KIND_TAKE
    flags = (member & ~ok & take).any(axis=(1, 2))
    x = np.where(ok, x, 0)
    s = f["s"]
    p, sub = x // s, x % s
    phys = f["base"] + ((p % stripes) * stripe_height + p // stripes if stripes > 1 else p)
    lo, n_rows = window
    phys = phys - lo
    ok &= ~take | ((phys >= 0) & (phys < n_rows))
    flat = np.where(take, phys * s + sub, f["base"] + x)
    order = np.argsort(~ok, axis=2, kind="stable")  # the members that add, in slot order
    lists = np.take_along_axis(np.where(ok, flat, -1), order, axis=2)
    return lists, ok.sum(axis=2), member.sum(axis=2), flags


def pool(lists, n, members, cols, bufs, scales, ks, offs, mean):
    """Pass 2's pooled float32 values [nr, len(ks)] of plan columns ``ks``
    at offsets ``offs``: each bag's members' elements summed from the first
    in slot order, times the float32 1 / count for the mean."""
    buf, dim = cols[ks, F_["buf"]], cols[ks, F_["dim"]]
    scale = (np.ones(len(ks), np.float32) if scales is None else np.asarray(
        [scales[b][i] for b, i in zip(buf, cols[ks, F_["scale"]])], np.float32))
    acc = np.zeros((lists.shape[0], len(ks)), np.float32)
    for j in range(lists.shape[2]):
        live = j < n[:, ks]
        at = np.where(live, lists[:, ks, j], 0) * dim + offs
        v = np.zeros(acc.shape, np.float32)
        for b in np.unique(buf):
            m = buf == b
            v[:, m] = bufs[b][at[:, m]]
        v = v * scale
        acc = np.where(live, v if j == 0 else acc + v, acc)
    if mean:
        cnt = members[:, ks].astype(np.float32)
        acc = acc * np.where(cnt > 0, np.float32(1) / np.maximum(cnt, 1), 0).astype(np.float32)
    return acc


def interpret(ids, dense, ops, mean, rows, addr0):
    """The bag kernel's features and flags, tile by tile, with the ids'
    bytes starting at address ``addr0`` (mod 16)."""
    B, T, L = ids.shape
    isz = ids.dtype.itemsize
    cols = ops["cols"].numpy()
    pos = ops["pos"].numpy().view(np.uint32).astype(np.int64)
    col = ((pos[:, 0] & 0xFFFF) ^ 0x8000) - 0x8000
    add = ((pos[:, 0] >> 16) ^ 0x8000) - 0x8000
    off = pos[:, 1] & tlk.OFF_MASK
    bufs = [b.reshape(-1).float().numpy() if b.dtype == torch.bfloat16
            else b.reshape(-1).numpy() for b in ops["bufs"]]
    scales = None if ops["scales"] is None else [s.numpy() for s in ops["scales"]]
    window = ops.get("window") or (0, 1 << 62)
    mem = np.frombuffer(ids.tobytes(), np.uint8)
    slot_bytes = -(-rows * T * L * isz // 16) * 16 + 32
    feats = np.zeros((B, pos.shape[0]), np.float32)
    flags = np.zeros(B, bool)
    emb, qr, den = col >= 0, (col >= 0) & (add >= 0), col == tlk.POS_DENSE
    for b0 in range(0, B, rows):
        nr = min(rows, B - b0)
        start = b0 * T * L * isz
        slot, at = fetch_ids(mem, addr0, start, start + nr * T * L * isz, slot_bytes, isz)
        tile = slot[at:at + nr * T * L * isz].view(ids.dtype).reshape(nr, T, L)
        rec = compact(tile[:, cols[:, F_["src"]], :], cols, ops["stripes"],
                      ops["stripe_height"], window)
        flags[b0:b0 + nr] = rec[3]
        part = np.zeros((nr, pos.shape[0]), np.float32)
        part[:, emb] = pool(*rec[:3], cols, bufs, scales, col[emb], off[emb], mean)
        part[:, qr] = part[:, qr] + pool(*rec[:3], cols, bufs, scales, add[qr], off[qr], mean)
        if den.any():
            part[:, den] = dense[b0:b0 + nr][:, off[den]]
        feats[b0:b0 + nr] = part
    return torch.from_numpy(feats).to(tlk.lookup_out_dtype(ops["bufs"])), torch.from_numpy(flags)


def _operands(model, shard):
    ops = dict(model.lookup_operands()) if shard is None else shard_operands(
        model, *shard, CPU)
    ops.setdefault("window", None)
    return ops


@pytest.mark.parametrize("table_dtype", ["float32", "bfloat16", "int8"])
@pytest.mark.parametrize("name", LAYOUT_CASES)
def test_interpreted_walk_matches_plain(name, table_dtype):
    """The interpreter's features and flags equal lookup_fused_bags_plain's
    bit for bit on bags_with_bad's ids (padding, empty bags, ids below -1,
    out-of-range ids, a hole before a bag's members): sum and mean, int32
    and int64 ids, L = 3 (tiles whose ids start off a 16-byte line) and 4,
    the ids' bytes at two alignments, and on model shard 1 of 2 (the window
    drops the other shard's take rows)."""
    cfg = dataclasses.replace(variant(name, TC), table_dtype=table_dtype)
    model = init_model(cfg, table_scheme="uniform", device=CPU)
    rng = np.random.default_rng(31)
    B = 19
    dd = model.layout.dense_dim
    dense = rng.uniform(-1, 1, (B, dd)).astype(np.float32) if dd else None
    dense_t = None if dense is None else torch.from_numpy(dense)
    cases = [(None, 3, torch.int32, 0), (None, 4, torch.int64, 8), ((1, 2), 3, torch.int32, 4)]
    for shard, L, idt, addr0 in cases:
        ops = _operands(model, shard)
        ids = torch.from_numpy(bags_with_bad(cfg, B, L, rng)).to(idt)
        d = dense_t if ops["dense_dim"] else None
        for mean in (False, True):
            want, want_bad = tlk.lookup_fused_bags_plain(ids, d, mean=mean, **ops)
            for rows in (1, 3, 8):
                got, bad = interpret(ids.numpy(), dense, ops, mean, rows, addr0)
                what = (name, table_dtype, shard, L, idt, mean, rows)
                assert got.dtype == want.dtype and torch.equal(_bits(got), _bits(want)), what
                if want_bad is not None:
                    assert torch.equal(bad, want_bad), what


@pytest.mark.parametrize("table_dtype", ["float32", "bfloat16"])
def test_first_member_of_negative_zero_keeps_its_sign(table_dtype):
    """A bag whose only member reads -0.0 pools to -0.0 (the sum starts from
    the first member, not from +0), in the plain version and the
    interpreter; a member of -0.0 after one of +0.0 gives +0.0."""
    cfg = dataclasses.replace(variant("micro", TC), table_dtype=table_dtype)
    model = init_model(cfg, table_scheme="uniform", device=CPU)
    ops = _operands(model, None)
    cols = ops["cols"].numpy()
    k = 0  # plan column 0 reads config column src, row base + id
    src, base, dim = (int(cols[k, F_[f]]) for f in ("src", "base", "dim"))
    buf = ops["bufs"][int(cols[k, F_["buf"]])].view(-1)
    buf[(base + 1) * dim:(base + 3) * dim] = 0.0
    buf[(base + 1) * dim:(base + 2) * dim] = -0.0  # row 1 is -0.0, row 2 +0.0
    B, L = 6, 3
    ids = np.full((B, cfg.num_tables, L), -1, np.int32)
    ids[0, src, 0] = 1  # -0.0 alone
    ids[1, src, :2] = (1, 1)  # -0.0 twice
    ids[2, src, 1] = 1  # after a hole
    ids[3, src, :2] = (2, 1)  # +0.0, then -0.0
    ids[4, src, :2] = (1, 2)  # -0.0, then +0.0
    dd = model.layout.dense_dim
    dense = np.zeros((B, dd), np.float32) if dd else None
    pos = ops["pos"].numpy().view(np.uint32)
    outs = [p for p in range(pos.shape[0])
            if ((int(pos[p, 0]) & 0xFFFF) ^ 0x8000) - 0x8000 == k]
    for mean in (False, True):
        want, _ = tlk.lookup_fused_bags_plain(
            torch.from_numpy(ids), None if dense is None else torch.from_numpy(dense),
            mean=mean, **ops)
        got, _ = interpret(ids, dense, ops, mean, 4, 0)
        assert torch.equal(_bits(got), _bits(want)), mean
        sign = torch.signbit(want[:, outs].float())
        assert sign[:3].all() and not sign[3:].any(), (mean, sign)
