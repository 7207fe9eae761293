"""The matmul chain's kernel (edgecape_tpu_torch/csrc/mm_chain.cu) emulated
on the CPU in its own schedule, and its launch plan (ops/kernels.py
mm_chain_plan).

The emulation walks what a block does: the rows of a segment cut into
tiles of 128 (rows past the segment's end zero), per step an fp32 y
accumulated over the 64-wide chunks of F in the kernel's order (chunk 0
first, the same for every tile), h = bf16(x @ w1[:, chunk]) per chunk,
and the tile's x rewritten as bf16(x + y) after the step. It is held
against mm_chain_plain (the same rounding points, sums in another order)
and against the JAX probe kernel in interpret mode, to the bounds of
tests/test_torch_probe.py (2^-6 of the output's largest magnitude, 0.5%
of its mean magnitude on average), and `loop` and `fold` give the same
bits under it: a row's sums do not depend on where its tile was cut. A
block that started at another chunk (as vit_mlp_kernel's blocks do) sums
y in another order, and the two cuts then differ."""

import importlib.util
import os

import numpy as np
import pytest
import torch

import torch_threads  # noqa: F401  (caps torch's threads per worker)
from edgecape_tpu_torch.ops import kernels as K
from edgecape_tpu_torch.ops import mm_chain as MC
from edgecape_tpu_torch.tools import probe_m_fold as P

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MAX_REL, MEAN_REL = 2.0 ** -6, 5e-3
TILE, CHUNK = K.MM_TILE, K.MM_CHUNK


def chain_tiled(x, w1, w2, reps, segs, seg_rows, stagger=False):
    """The kernel's schedule on x [segs * seg_rows, C] bf16; `stagger`:
    block i starts its chunks at chunk i % chunks (what the kernel must
    not do)."""
    c, f = w1.shape
    chunks = f // CHUNK
    w1f, w2f = w1.float(), w2.float()
    per_seg = -(-seg_rows // TILE)
    out = torch.empty_like(x)
    for blk in range(segs * per_seg):
        seg, r0 = divmod(blk, per_seg)
        r0 *= TILE
        valid = min(TILE, seg_rows - r0)
        tile = torch.zeros(TILE, c, dtype=torch.bfloat16)
        base = seg * seg_rows + r0
        tile[:valid] = x[base:base + valid]
        order = [(j + (blk % chunks if stagger else 0)) % chunks
                 for j in range(chunks)]
        for _ in range(reps):
            y = torch.zeros(TILE, c)
            for j in order:
                cols = slice(j * CHUNK, (j + 1) * CHUNK)
                h = (tile.float() @ w1f[:, cols]).to(torch.bfloat16)
                y = y + h.float() @ w2f[cols]
            tile = (tile.float() + y).to(torch.bfloat16)
        out[base:base + valid] = tile[:valid]
    return out


def kernel_emulation(x, w1, w2, reps, group, fold, stagger=False):
    """mm_chain's cut of x [b, n, c] into segments, as the wrapper makes
    it, through chain_tiled."""
    b, n, c = x.shape
    segs, seg_rows = (b // group, group * n) if fold else (b, n)
    return chain_tiled(x.reshape(b * n, c), w1, w2, reps, segs, seg_rows,
                       stagger).reshape(b, n, c)


def _close(out, ref):
    d = (out.float() - ref.float()).abs()
    assert d.max() <= MAX_REL * ref.float().abs().max(), d.max()
    assert d.mean() <= MEAN_REL * ref.float().abs().mean(), d.mean()


# b, group, n, c, f, reps: ragged segments at two widths, more than one
# tile a segment and more than one chunk
CASES = [(4, 2, 70, 128, 192, 2), (3, 3, 104, 256, 128, 3)]


@pytest.mark.parametrize("case", CASES)
def test_emulation_matches_plain_and_cuts_agree(case):
    b, g, n, c, f, reps = case
    x, w1, w2 = P.inputs(b, n, c, f, "cpu")
    loop = kernel_emulation(x, w1, w2, reps, g, False)
    fold = kernel_emulation(x, w1, w2, reps, g, True)
    assert torch.equal(loop, fold)
    _close(fold, MC.mm_chain_plain(x, w1, w2, reps, g, True))
    assert torch.equal(kernel_emulation(x, w1, w2, 0, g, True), x)


def test_a_staggered_start_makes_the_cuts_differ():
    """Blocks that start at their own chunk sum a row's y in an order that
    depends on the block, so `loop` and `fold` no longer agree bit for
    bit (both stay within the plain version's bounds). Eight chunks over
    1056 rows: a reordered fp32 sum moves y by an ulp of fp32, which flips
    a bf16 rounding of x only now and then."""
    b, g, n, c, f, reps = 4, 2, 264, 128, 512, 3
    x, w1, w2 = P.inputs(b, n, c, f, "cpu")
    loop = kernel_emulation(x, w1, w2, reps, g, False, stagger=True)
    fold = kernel_emulation(x, w1, w2, reps, g, True, stagger=True)
    assert not torch.equal(loop, fold)
    _close(fold, MC.mm_chain_plain(x, w1, w2, reps, g, True))


@pytest.fixture(scope="module")
def jax_probe():
    spec = importlib.util.spec_from_file_location(
        "jax_probe_m_fold", os.path.join(REPO, "scripts", "probe_m_fold.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("fold", [False, True])
def test_emulation_matches_jax_kernel_interpret(jax_probe, fold):
    """The JAX probe kernel in interpret mode on the probe's own inputs,
    at a width the kernel takes and with two chunks of F."""
    import jax
    import jax.numpy as jnp
    from jax.experimental import pallas as pl

    b, g, n, c, f, reps = 4, 2, 24, 128, 128, 2
    rep2 = lambda i: (0, 0)  # noqa: E731
    fn = pl.pallas_call(
        jax_probe.make_kernel(g, n, c, f, reps, fold),
        out_shape=jax.ShapeDtypeStruct((b, n, c), jnp.bfloat16),
        grid=(b // g,),
        in_specs=[pl.BlockSpec((g, n, c), lambda i: (i, 0, 0)),
                  pl.BlockSpec((c, f), rep2), pl.BlockSpec((f, c), rep2)],
        out_specs=pl.BlockSpec((g, n, c), lambda i: (i, 0, 0)),
        interpret=True)
    x, w1, w2 = P.inputs(b, n, c, f, "cpu")
    as_jax = lambda t: jnp.asarray(t.float().numpy(), jnp.bfloat16)  # noqa: E731
    ref = np.array(fn(as_jax(x), as_jax(w1), as_jax(w2)).astype(
        jnp.float32))
    _close(kernel_emulation(x, w1, w2, reps, g, fold), torch.from_numpy(ref))


@pytest.mark.parametrize("segs,seg_rows,c,f,tiles,pad,stages", [
    (512, 264, 384, 1536, 1536, 61440, 8),      # backbone, loop
    (256, 528, 384, 1536, 1280, 28672, 8),      # backbone, fold at g 2
    (510, 104, 256, 1024, 510, 12240, 10),      # decoder, loop
    (85, 624, 256, 1024, 425, 1360, 10),        # decoder, fold at g 6
    (6, 70, 128, 64, 6, 348, 12),
])
def test_mm_chain_plan(segs, seg_rows, c, f, tiles, pad, stages):
    plan = K.mm_chain_plan(segs, seg_rows, c, f)
    assert (plan["tiles"], plan["pad_rows"], plan["stages"]) == \
        (tiles, pad, stages)
    assert plan["useful_rows"] + plan["pad_rows"] == tiles * TILE
    assert plan["useful_share"] == segs * seg_rows / (tiles * TILE)
    assert plan["chunks"] == f // CHUNK
    assert plan["slots_per_chunk"] == 2 * c // 128
    # the x tile, the ring and its barriers fit a block
    assert plan["smem_bytes"] <= 232448
    assert plan["smem_bytes"] >= 1024 + (c // 64 + stages) * K.MM_SLOT


def test_mm_chain_plan_useful_rows_of_the_probe_cases():
    """n 264 fills 264 of 3 x 128 rows a segment; the folded rows of two
    images fill 528 of 640."""
    loop = K.mm_chain_plan(512, 264, 384, 1536)
    fold = K.mm_chain_plan(256, 528, 384, 1536)
    assert loop["useful_share"] == 264 / 384
    assert fold["useful_share"] == 528 / 640


@pytest.mark.parametrize("args", [(1, 64, 64, 64), (1, 64, 512, 64),
                                  (1, 64, 256, 96), (1, 64, 256, 0),
                                  (0, 64, 256, 64), (1, 0, 256, 64),
                                  (2 ** 31, 128, 128, 64)])
def test_mm_chain_plan_refuses_what_the_kernel_does_not_take(args):
    with pytest.raises(ValueError):
        K.mm_chain_plan(*args)


def test_cpu_operands_take_the_plain_version_and_count_nothing():
    x, w1, w2 = P.inputs(2, 8, 128, 64, "cpu")
    n0 = MC.launches
    out = MC.mm_chain(x, w1, w2, 1, 1, True)
    assert MC.launches == n0
    assert torch.equal(out, MC.mm_chain_plain(x, w1, w2, 1, 1, True))
    with pytest.raises(ValueError):
        K.mm_chain(x.reshape(16, 128), w1, w2, 1, 2, 8)
