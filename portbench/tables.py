"""Seeded table values and tower weights, made on the device.

Every table value is a function of (seed, table id, logical row, column)
alone, so the harness can write whole tables into the program's packed
buffers on the card and the plain reference can compute the few rows a
batch reads, each without the other:

    h = mix32(row * A + table * B + seed_key)          one hash a logical row
    q = ((h * M[column]) >> 24) & 255) - 128           an int8 code in [-128, 127]

int8 storage holds ``q`` with a per-table scale ``table_scale`` (a 7-bit
integer over 2^13, so ``q * scale`` is exact in float32); float storage
holds ``q * 2^-7``, exact in bfloat16 and float32.  Rows differ from each
other and columns within a row differ, so a lookup of a wrong row, a wrong
sub-row or a wrong column reads other values.

The tower's weights come from a ``torch.Generator`` on the device, one
``rand`` a layer, uniform in +-sqrt(3 / fan_in) so that activations of the
bias-free linear chain stay of order one.  The other weights a head may
state (``head_weights``: the bottom tower's, the cross layers' and the
towers' biases) each come from a generator of their own, seeded by the
seed in a namespace of their own, so that adding a head leaves the top
tower's weights as they are.
"""

from __future__ import annotations

from typing import Dict, List, Sequence

import torch

MASK32 = 0xFFFFFFFF
_A = 0x9E3779B1
_B = 0x85EBCA77
_MIX = 0x45D9F3B
FLOAT_STEP = 2.0 ** -7


def splitmix64(x: int) -> int:
    """A 64-bit finalizer on a Python int (any size: taken mod 2^64)."""
    x = (x + 0x9E3779B97F4A7C15) & 0xFFFFFFFFFFFFFFFF
    x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & 0xFFFFFFFFFFFFFFFF
    x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & 0xFFFFFFFFFFFFFFFF
    return x ^ (x >> 31)


def seed_key(seed: int) -> int:
    """The 32-bit key of a run's seed (any whole number >= 0)."""
    return splitmix64(int(seed)) & MASK32


def _column_multipliers() -> List[int]:
    """128 odd multipliers in [2^29, 2^31), fixed for every run."""
    out, x = [], 0x5EED
    while len(out) < 128:
        x = splitmix64(x)
        out.append(((1 << 29) + x % (3 << 29)) | 1)
    return out


COLUMN_MULT = _column_multipliers()


def _mix32(x: torch.Tensor) -> torch.Tensor:
    """A 32-bit avalanche on an int64 tensor of values below 2^32."""
    x = ((x ^ (x >> 16)) * _MIX) & MASK32
    x = ((x ^ (x >> 16)) * _MIX) & MASK32
    return x ^ (x >> 16)


def row_hash(key: int, tables: torch.Tensor, rows: torch.Tensor) -> torch.Tensor:
    """int64 hashes below 2^32 of logical rows ``rows`` of tables
    ``tables`` (int64 tensors that broadcast together)."""
    x = (rows * _A + (tables * _B + key)) & MASK32
    return _mix32(x)


def codes(h: torch.Tensor, dim: int) -> torch.Tensor:
    """int64 codes [..., dim] in [-128, 127] of row hashes ``h``."""
    m = torch.tensor(COLUMN_MULT[:dim], dtype=torch.int64, device=h.device)
    x = h[..., None] * m
    x >>= 24
    x &= 255
    x -= 128
    return x


def table_scale(key: int, table: int) -> float:
    """The int8 dequant scale of ``table``: (64 + n) / 8192, n in [0, 64)."""
    return (64 + splitmix64(key ^ (table * 0x9E37)) % 64) / 8192.0


def values(key: int, tables: torch.Tensor, rows: torch.Tensor, dim: int,
           storage: str) -> torch.Tensor:
    """Logical rows ``rows`` of ``tables`` as the storage holds them, [...,
    dim]: int8 codes (their scale apart), or codes * 2^-7 in ``storage``'s
    float dtype."""
    q = codes(row_hash(key, tables, rows), dim)
    if storage == "int8":
        return q.to(torch.int8)
    return (q.to(torch.float32) * FLOAT_STEP).to(STORAGE_DTYPES[storage])


STORAGE_DTYPES = {"int8": torch.int8, "bfloat16": torch.bfloat16, "float32": torch.float32}


# generator namespaces: the top tower (``tower_weights``), the bottom tower,
# the cross layers and the two towers' biases
_NS_TOWER, _NS_BOTTOM, _NS_CROSS, _NS_BIAS, _NS_BOTTOM_BIAS = 0x70E7, 0xB077, 0xC205, 0xB1A5, 0xB1A6


def _generator(seed: int, namespace: int, dev: torch.device) -> torch.Generator:
    gen = torch.Generator(device=dev)
    gen.manual_seed(splitmix64(int(seed) ^ namespace) & 0x7FFFFFFFFFFFFFFF)
    return gen


def _uniform(gen: torch.Generator, shape, half: float, dtype: torch.dtype,
             dev: torch.device) -> torch.Tensor:
    """Uniform in +-``half``, drawn in float32 and cast to ``dtype``."""
    w = torch.rand(shape, generator=gen, device=dev, dtype=torch.float32)
    return ((w * 2 - 1) * half).to(dtype)


def _tower(seed: int, namespace: int, widths: Sequence[int], dtype: torch.dtype,
           device) -> List[torch.Tensor]:
    dev = torch.device(device)
    gen = _generator(seed, namespace, dev)
    return [_uniform(gen, (a, b), (3.0 / a) ** 0.5, dtype, dev)
            for a, b in zip(widths[:-1], widths[1:])]


def tower_weights(seed: int, widths: Sequence[int], dtype: torch.dtype,
                  device) -> List[torch.Tensor]:
    """Weights [in, out] a layer in ``dtype`` on ``device``, from a
    generator on that device seeded by ``seed``."""
    return _tower(seed, _NS_TOWER, widths, dtype, device)


def bottom_weights(seed: int, widths: Sequence[int], dtype: torch.dtype,
                   device) -> List[torch.Tensor]:
    """The bottom tower's weights [in, out] a layer, as ``tower_weights``
    in a namespace of their own."""
    return _tower(seed, _NS_BOTTOM, widths, dtype, device)


def tower_biases(seed: int, widths: Sequence[int], dtype: torch.dtype, device,
                 bottom: bool = False) -> List[torch.Tensor]:
    """Biases [out] a layer of the top tower (or the bottom tower), uniform
    in +-1 / sqrt(fan_in)."""
    dev = torch.device(device)
    gen = _generator(seed, _NS_BOTTOM_BIAS if bottom else _NS_BIAS, dev)
    return [_uniform(gen, (b,), a ** -0.5, dtype, dev) for a, b in zip(widths[:-1], widths[1:])]


def cross_weights(seed: int, width: int, layers: int, rank: int, dtype: torch.dtype,
                  device) -> List[List[torch.Tensor]]:
    """The cross layers' weights a layer: [W [F, F], b [F]] at full rank
    (``rank`` 0), else [U [F, r], V [r, F], b [F]]; every factor uniform
    in +-sqrt(3 / its input width), so that x_l U V stays of the order of
    x_l, and b in +-1 / sqrt(F)."""
    dev = torch.device(device)
    gen = _generator(seed, _NS_CROSS, dev)
    F, out = width, []
    for _ in range(layers):
        shapes = [(F, F)] if rank == 0 else [(F, rank), (rank, F)]
        mats = [_uniform(gen, s, (3.0 / s[0]) ** 0.5, dtype, dev) for s in shapes]
        out.append(mats + [_uniform(gen, (F,), F ** -0.5, dtype, dev)])
    return out


def head_weights(seed: int, model: dict, device) -> Dict[str, list]:
    """Every weight that a configuration's ``model`` block states, in its
    compute dtype: ``mlp`` (the top tower), ``bottom``, ``cross`` (a list a
    layer), ``mlp_bias`` and ``bottom_bias`` (empty lists for what the
    configuration does not state).  The one source of weights of the
    program, the reference and the control."""
    dtype = STORAGE_DTYPES[model["dtype"]]
    bottom = model.get("bottom_mlp")
    bias = bool(model.get("bias"))
    w = {"mlp": tower_weights(seed, model["mlp"], dtype, device),
         "bottom": bottom_weights(seed, bottom["widths"], dtype, device) if bottom else [],
         "cross": [], "mlp_bias": [], "bottom_bias": []}
    if model.get("interaction", "none") == "cross":
        w["cross"] = cross_weights(seed, model["feature_dim"], model["cross_layers"],
                                   model.get("cross_rank", 0), dtype, device)
    if bias:
        w["mlp_bias"] = tower_biases(seed, model["mlp"], dtype, device)
        if bottom:
            w["bottom_bias"] = tower_biases(seed, bottom["widths"], dtype, device, bottom=True)
    return w
