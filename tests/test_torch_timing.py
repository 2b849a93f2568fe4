"""The port's utils/timing.py on the CPU: DeviceBench runs K steps, its
accumulator is the sum of the step outputs (the JAX scan's carry on the
same inputs), and its result keys are the JAX package's.
The CUDA-graph path runs on the card (``cuda`` marker, chip_smoke.py)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fleetrec_tpu.utils.timing import DeviceBench as JBench
from fleetrec_tpu_torch.utils.timing import DeviceBench


def _inputs(K=5, seed=0):
    rng = np.random.default_rng(seed)
    xs = rng.uniform(-1, 1, (K, 7, 3)).astype(np.float32)
    w = rng.uniform(-1, 1, (3, 2)).astype(np.float32)
    return xs, w


def _jax_keys(method):
    xs, w = _inputs(K=2)
    return set(getattr(JBench(lambda p, x: x @ p, reps=1), method)(
        jnp.asarray(w), jnp.asarray(xs)))


def test_measure_runs_k_steps_and_sums_their_outputs():
    """The accumulator equals the JAX scan's carry on the same inputs;
    rtol 1e-6: float32 sums in another order."""
    xs, w = _inputs()
    calls = []

    def step(p, x):
        calls.append(x.shape)
        return x @ p

    b = DeviceBench(step, reps=2)
    r = b.measure(torch.from_numpy(w), torch.from_numpy(xs))
    assert set(r) == _jax_keys("measure")
    assert r["iters"] == 5 and len(r["reps_ms"]) == 2
    assert len(calls) == 5 * 3 and set(calls) == {(7, 3)}  # warm-up + 2 reps
    assert r["per_iter_ms"] == pytest.approx(min(r["reps_ms"]) / 5)
    assert r["total_s"] == pytest.approx(min(r["reps_ms"]) / 1e3)
    carry = float(JBench(lambda p, x: x @ p)._run(jnp.asarray(w), jnp.asarray(xs)))
    np.testing.assert_allclose(b.total, carry, rtol=1e-6)
    np.testing.assert_allclose(b.total, float((xs.astype(np.float64) @ w).sum()),
                               rtol=1e-6)


def test_measure_takes_a_tuple_with_none_entries():
    """As the JAX pytree: (ids, None) steps get (ids[k], None)."""
    xs, w = _inputs(K=3)
    seen = []

    def step(p, x):
        seen.append(x[1])
        return x[0] @ p

    b = DeviceBench(step, reps=1)
    r = b.measure(torch.from_numpy(w), (torch.from_numpy(xs), None))
    assert r["iters"] == 3 and seen == [None] * 6
    np.testing.assert_allclose(b.total, float((xs.astype(np.float64) @ w).sum()),
                               rtol=1e-6)


def test_measure_corrected_has_the_jax_keys():
    xs, w = _inputs(K=4)
    b = DeviceBench(lambda p, x: x @ p, reps=1)
    r = b.measure_corrected(torch.from_numpy(w), torch.from_numpy(xs))
    assert set(r) == _jax_keys("measure_corrected")
    assert r["iters"] == 4
    # the last run was the 4K one: four times the same steps
    np.testing.assert_allclose(b.total, 4 * float((xs.astype(np.float64) @ w).sum()),
                               rtol=1e-6)
    if not r["degenerate_fallback"]:
        assert r["per_iter_ms"] > 0
        assert r["percall_const_ms"] == pytest.approx(
            r["raw_per_iter_ms"] * 4 - 4 * r["per_iter_ms"], abs=1e-9)


def test_measure_refuses_a_device_without_a_timer():
    xs = torch.zeros(2, 3, device="meta")
    with pytest.raises(ValueError, match="no timer"):
        DeviceBench(lambda p, x: x).measure(None, xs)


@pytest.mark.cuda
def test_measure_on_the_card_replays_one_graph():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (DeviceBench times CUDA-graph replays there)")
    xs, w = _inputs(K=8)
    dev = torch.device("cuda:0")
    b = DeviceBench(lambda p, x: x @ p, reps=3)
    r = b.measure(torch.from_numpy(w).to(dev), torch.from_numpy(xs).to(dev))
    assert r["iters"] == 8 and len(r["reps_ms"]) == 3 and r["per_iter_ms"] > 0
    np.testing.assert_allclose(b.total, float((xs.astype(np.float64) @ w).sum()),
                               rtol=1e-5)
