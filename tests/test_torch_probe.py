"""The port's matmul chain (edgecape_tpu_torch/ops/mm_chain.py) against the
JAX probe's Pallas kernel (scripts/probe_m_fold.py) run in interpret mode
on the CPU, and the probe tool's CPU mode.

Inputs are the probe's own (seeded numpy). Tolerance: both sides compute
fp32 sums of bf16 products and round h and x to bf16 at the same points;
the sums run in another order, so a value can land on the other side of a
bf16 rounding boundary (one ulp, 2^-8 of its size) and be carried through
the later steps. Bound: 2^-6 of the output's largest magnitude, and a mean
error of 0.5% of the mean magnitude."""

import importlib.util
import os

import numpy as np
import pytest
import torch

import torch_threads  # noqa: F401  (caps torch's threads per worker)
from edgecape_tpu_torch.ops import mm_chain as MC
from edgecape_tpu_torch.tools import probe_m_fold as P

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MAX_REL, MEAN_REL = 2.0 ** -6, 5e-3


@pytest.fixture(scope="module")
def jax_probe():
    spec = importlib.util.spec_from_file_location(
        "jax_probe_m_fold", os.path.join(REPO, "scripts", "probe_m_fold.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _jax_out(mod, b, g, n, c, f, reps, fold):
    """The whole output of the JAX kernel in interpret mode, on the
    probe's own inputs."""
    import jax
    import jax.numpy as jnp
    from jax.experimental import pallas as pl

    rep2 = lambda i: (0, 0)  # noqa: E731
    fn = pl.pallas_call(
        mod.make_kernel(g, n, c, f, reps, fold),
        out_shape=jax.ShapeDtypeStruct((b, n, c), jnp.bfloat16),
        grid=(b // g,),
        in_specs=[pl.BlockSpec((g, n, c), lambda i: (i, 0, 0)),
                  pl.BlockSpec((c, f), rep2), pl.BlockSpec((f, c), rep2)],
        out_specs=pl.BlockSpec((g, n, c), lambda i: (i, 0, 0)),
        interpret=True)
    rng = np.random.default_rng(0)
    x = jnp.asarray(rng.normal(size=(b, n, c)), jnp.bfloat16)
    w1 = jnp.asarray(rng.normal(size=(c, f)) * 0.05, jnp.bfloat16)
    w2 = jnp.asarray(rng.normal(size=(f, c)) * 0.05, jnp.bfloat16)
    return np.asarray(fn(x, w1, w2).astype(jnp.float32))


CASE = dict(b=4, g=2, n=8, c=16, f=32, reps=2)


@pytest.mark.parametrize("fold", [False, True])
def test_mm_chain_plain_matches_jax_kernel_interpret(jax_probe, fold):
    ref = _jax_out(jax_probe, fold=fold, **CASE)
    x, w1, w2 = P.inputs(CASE["b"], CASE["n"], CASE["c"], CASE["f"], "cpu")
    out = MC.mm_chain_plain(x, w1, w2, CASE["reps"], CASE["g"], fold)
    assert out.dtype == torch.bfloat16 and tuple(out.shape) == ref.shape
    d = np.abs(out.float().numpy() - ref)
    assert d.max() <= MAX_REL * np.abs(ref).max(), d.max()
    assert d.mean() <= MEAN_REL * np.abs(ref).mean(), d.mean()


def test_inputs_are_the_jax_probes(jax_probe):
    """The tool draws the operands of the JAX script: same generator, same
    order, same bf16 rounding."""
    import jax.numpy as jnp
    rng = np.random.default_rng(0)
    x = jnp.asarray(rng.normal(size=(4, 8, 16)), jnp.bfloat16)
    w1 = jnp.asarray(rng.normal(size=(16, 32)) * 0.05, jnp.bfloat16)
    px, pw1, _ = P.inputs(4, 8, 16, 32, "cpu")
    assert np.array_equal(np.asarray(x.astype(jnp.float32)),
                          px.float().numpy())
    assert np.array_equal(np.asarray(w1.astype(jnp.float32)),
                          pw1.float().numpy())


def test_fold_equals_loop_bit_for_bit(jax_probe):
    x, w1, w2 = P.inputs(6, 10, 16, 32, "cpu")
    loop = MC.mm_chain(x, w1, w2, 3, 3, False)
    fold = MC.mm_chain(x, w1, w2, 3, 3, True)
    assert torch.equal(loop, fold)
    j_loop = _jax_out(jax_probe, 4, 2, 8, 16, 32, 2, False)
    j_fold = _jax_out(jax_probe, 4, 2, 8, 16, 32, 2, True)
    assert np.array_equal(j_loop, j_fold)


def test_wrapper_takes_plain_only_on_cpu_and_counts_no_launch():
    x, w1, w2 = P.inputs(2, 4, 16, 32, "cpu")
    n0 = MC.launches
    out = MC.mm_chain(x, w1, w2, 1, 2, True)
    assert MC.launches == n0
    assert torch.equal(out, MC.mm_chain_plain(x, w1, w2, 1, 2, True))
    # one step by hand
    h = (x.float() @ w1.float()).to(torch.bfloat16)
    ref = (x.float() + h.float() @ w2.float()).to(torch.bfloat16)
    assert torch.equal(out, ref)


@pytest.mark.parametrize("bad", ["group", "w1", "w2", "dim"])
def test_mm_chain_refuses_shapes_that_do_not_fit(bad):
    x, w1, w2 = P.inputs(4, 4, 16, 32, "cpu")
    args = {"group": (x, w1, w2, 1, 3, True),
            "w1": (x, w1[:8], w2, 1, 2, True),
            "w2": (x, w1, w2[:, :8], 1, 2, True),
            "dim": (x[0], w1, w2, 1, 2, True)}[bad]
    with pytest.raises(ValueError):
        MC.mm_chain(*args)


def test_probe_tool_cpu_mode_and_device_rule(capsys):
    res = P.main(["--device", "cpu", "--case", "4,2,8,16,32,2", "--iters",
                  "1", "--runs", "1"])
    out = capsys.readouterr().out
    assert len(res) == 1 and res[0]["bitsame"] and res[0]["finite"]
    assert "bitsame=True" in out and "loop" in out and "fold" in out
    assert res[0]["loop_ms"] > 0 and res[0]["fold_ms"] > 0
    with pytest.raises(SystemExit):
        P.main(["--device", "cpu"])        # the built-in cases need the card
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            P.main([])


def test_probe_cases_are_the_jax_scripts(jax_probe):
    import inspect
    src = inspect.getsource(jax_probe.main)
    for label, b, g, n, c, f, reps in P.CASES:
        assert f'("{label}", {b}, {g}, {n}, {c}, {f}, {reps})' in src
    assert (P.ITERS, P.RUNS) == (jax_probe.ITERS, jax_probe.RUNS)
