"""The launch plan of the port's attention forward kernels
(ops/kernels.py attention_plan) and of the decoder stack's bias attention
(bias_attention_plan), their ctypes bindings and the bool key mask route,
on the CPU; and the plain versions of flash_mha and
flash_mha_train against the JAX kernels (interpret mode) at the ragged
sizes the card sees.

Tolerances of the parity cases are those of tests/test_torch_fused_ops.py
(flash_mha: outputs are convex mixtures of bf16 values of order 1, so two
bf16 ulps on the largest and 1e-3 on the mean difference) and of
tests/test_torch_train_ops.py (flash_mha_train: atol = rtol = 0.02 forward,
0.05 on the gradients, the JAX package's own bounds for these kernels).
"""

import os
import re

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import torch_threads  # noqa: F401  (caps torch's threads per worker)
from edgecape_tpu.ops import flash_attention as jflash
from edgecape_tpu_torch.ops import flash_attention as tflash
from edgecape_tpu_torch.ops import kernels as K

SMEM_LIMIT = 232448          # bytes of shared memory a block may use
MAX_THREADS = 1024

# every shape the eval and training paths give the kernels:
# name, Nq, Nk, head dim, training forward
PATH_SHAPES = [("vit", 257, 257, 64, False),
               ("joint encoder", 356, 356, 32, False),
               ("decoder self, bias read", 100, 100, 32, False),
               ("decoder cross", 100, 256, 64, False),
               ("skeleton refine", 100, 100, 32, False),
               ("train 356", 356, 356, 32, True),
               ("train 100", 100, 100, 32, True)]


def _covered_rows(plan, nq):
    """Query rows each (block, warp) of the plan takes, as the kernel
    assigns them: tile = block * warps + warp, 16 rows a tile."""
    rows = []
    for y in range(plan["q_split"]):
        for w in range(plan["warps"]):
            tile = y * plan["warps"] + w
            rows.extend(range(tile * 16, min(tile * 16 + 16, nq)))
    return rows


def _covered_keys(plan, nk):
    """Keys each chunk of 16-key tiles takes in a pass over the row."""
    keys = []
    for first in range(0, plan["key_tiles"], plan["chunk_tiles"]):
        for tile in range(first, min(first + plan["chunk_tiles"],
                                     plan["key_tiles"])):
            keys.extend(range(tile * 16, min(tile * 16 + 16, nk)))
    return keys


def _check_plan(plan, nq, nk, d):
    assert plan["smem_bytes"] <= SMEM_LIMIT
    assert 1 <= plan["warps"] * 32 <= MAX_THREADS
    # threads the kernel of this chunk size is compiled for
    assert plan["warps"] <= {8: 8, 2: 12 if d == 32 else 9}[
        plan["chunk_tiles"]]
    assert plan["one_pass"] == (plan["chunk_tiles"] == K.ATT_ROW16)
    kld, nkp = d + 8, plan["key_tiles"] * 16
    need = 4 * nkp * kld + 32 * plan["warps"] * kld + 4 * nkp
    assert plan["smem_bytes"] >= need
    assert nk <= nkp < nk + 16
    if plan["one_pass"]:          # the whole row is one chunk
        assert plan["key_tiles"] <= plan["chunk_tiles"]
    # no block without a tile, every tile in exactly one (block, warp)
    tiles = -(-nq // 16)
    assert (plan["q_split"] - 1) * plan["warps"] < tiles \
        <= plan["q_split"] * plan["warps"]


@pytest.mark.parametrize("shape", PATH_SHAPES, ids=lambda s: s[0])
def test_plan_at_path_shapes(shape):
    _, nq, nk, d, train = shape
    plan = K.attention_plan(nq, nk, d, train=train)
    _check_plan(plan, nq, nk, d)
    assert _covered_rows(plan, nq) == list(range(nq))
    assert _covered_keys(plan, nk) == list(range(nk))
    assert plan["one_pass"] == (nk <= 128)
    # enough warps in flight: a head's tiles go to more than one block
    # wherever it has more tiles than a block takes
    assert plan["q_split"] * plan["warps"] - (-(-nq // 16)) < plan["q_split"]
    # from the shapes alone: the same answer again, whatever came between
    K.attention_plan(nk, nq, d)
    assert K.attention_plan(nq, nk, d, train=train) == plan


@pytest.mark.parametrize("d", [32, 64])
@pytest.mark.parametrize("kind", ["eval", "train", "two passes"])
def test_plan_sweep(kind, d):
    """(Nq, Nk) over 1..512: shared memory and threads within the card's
    limits, every query row and key covered exactly once."""
    kw = {"train": kind == "train"}
    if kind == "two passes":
        kw["chunk_tiles"] = K.ATT_CH16
    nqs = sorted(set(range(1, 513, 5)) | {15, 16, 17, 100, 257, 356, 512})
    for nk in range(1, 513):
        for nq in nqs:
            plan = K.attention_plan(nq, nk, d, **kw)
            _check_plan(plan, nq, nk, d)
            if kind == "two passes":
                assert not plan["one_pass"]
        plan = K.attention_plan(nk, nk, d, **kw)
        assert _covered_rows(plan, nk) == list(range(nk))
        assert _covered_keys(plan, nk) == list(range(nk))


@pytest.mark.parametrize("args,kw", [
    ((100, 100, 129), {}), ((100, 600, 129), {}),
    ((100, 513, 32), {"chunk_tiles": 2}),
    ((100, 0, 32), {}), ((0, 100, 32), {}),
    ((100, 129, 32), {"chunk_tiles": 8}),
    ((100, 100, 32), {"chunk_tiles": 4})])
def test_plan_refuses_unsupported_shapes(args, kw):
    with pytest.raises(ValueError):
        K.attention_plan(*args, **kw)


# ------------------------------------------ the decoder stack's bias attention
def _check_bias_plan(plan, b, n):
    """Shared memory within the card's limit and as the kernel lays it
    out; every query tile of a row in exactly one block; the key row in
    one pass."""
    nkp, ld = plan["key_tiles"] * 16, 8 * 32 + 8
    need = 2 * nkp * ld * 2 + 16 * ld * 2 + 8 * 16 * nkp * 4 + nkp * 4 \
        + K.BA_MLP_BYTES
    assert need <= plan["smem_bytes"] <= SMEM_LIMIT
    assert n <= nkp < n + 16 and plan["key_tiles"] <= K.ATT_ROW16
    tiles = -(-n // 16)
    covered = [t for y in range(plan["q_split"])
               for t in range(y * plan["tiles_per_block"],
                              min((y + 1) * plan["tiles_per_block"], tiles))]
    assert covered == list(range(tiles))
    assert (plan["q_split"] - 1) * plan["tiles_per_block"] < tiles
    assert 1 <= plan["q_split"] <= 65535


# batch rows the stack gives it: the eval chunk (34 x 15), a training-size
# batch, a few rows, one row
@pytest.mark.parametrize("b", [510, 34, 16, 3, 1])
def test_bias_plan_at_path_shape(b):
    plan = K.bias_attention_plan(b, 100, 8, 32)
    _check_bias_plan(plan, b, 100)
    # enough blocks for two rounds of the card's SMs where the rows allow,
    # one block a row (keys and values copied once) where they suffice
    tiles = 7
    if b >= K.BA_MIN_BLOCKS:
        assert plan["q_split"] == 1
    else:
        assert b * plan["q_split"] >= min(K.BA_MIN_BLOCKS, b * tiles) \
            or plan["q_split"] == tiles
    assert K.bias_attention_plan(b, 100, 8, 32) == plan


@pytest.mark.parametrize("bs", [(1, 2, 7, 33, 264), (265, 510, 1000)])
def test_bias_plan_sweep(bs):
    """K over 1..128 and batch sizes on both sides of BA_MIN_BLOCKS."""
    for b in bs:
        for n in range(1, 129):
            _check_bias_plan(K.bias_attention_plan(b, n, 8, 32), b, n)


@pytest.mark.parametrize("args", [(510, 100, 17, 32), (510, 100, 8, 129),
                                  (510, 100, 0, 32), (0, 100, 8, 32),
                                  (510, 0, 8, 32)])
def test_bias_plan_refuses_unsupported_shapes(args):
    """17 heads, head dim 129, no heads, no batch, no keypoints; every
    keypoint count is taken (above 128 by the streaming kernel)."""
    with pytest.raises(ValueError):
        K.bias_attention_plan(*args)


@pytest.mark.parametrize("b,n", [(510, 129), (510, 133), (60, 256),
                                 (1, 300)])
def test_bias_plan_streams_above_128_keys(b, n):
    """Past the resident kernels' 128 keys, 8 heads of 32 take
    bias_attn_long_kernel: 64-key tiles over the row, one 16-query tile an
    item, its shared memory within a block; 128 keys stay resident."""
    plan = K.bias_attention_plan(b, n, 8, 32)
    assert plan["long"] and not plan.get("wide")
    assert plan["key_tile"] == 64 and plan["d_pad"] == 32
    assert plan["key_tiles"] == -(-n // 64)
    assert plan["query_tiles"] == -(-n // 16)
    assert plan["items"] == b * plan["query_tiles"]
    assert plan["scratch_floats"] == 8 * 16 * plan["query_tiles"] * 16
    assert plan["smem_bytes"] <= K.ATT_SMEM_LIMIT
    assert plan["blocks_per_sm"] == 2
    assert "long" not in K.bias_attention_plan(b, 128, 8, 32)


def _c_signature(name):
    """ctypes argument types of an `extern "C" int name(...)` entry point,
    read from the CUDA sources."""
    for src in K.sources():
        with open(src) as f:
            text = f.read()
        m = re.search(r'extern "C" int ' + name + r"\((.*?)\)\s*\{", text,
                      re.S)
        if m:
            break
    else:
        raise AssertionError(f"{name} not found in {K.sources()}")
    types = []
    for param in m.group(1).split(","):
        param = " ".join(param.split())
        if "*" in param:
            types.append(K._P)
        elif param.startswith("long "):
            types.append(K._L)
        elif param.startswith("unsigned "):
            types.append(K._U32)
        elif param.startswith("float "):
            types.append(K._F)
        elif param.startswith("int "):
            types.append(K._I)
        else:
            raise AssertionError(f"{name}: parameter {param!r}")
    return types


@pytest.mark.parametrize("name", sorted(K._SIGNATURES))
def test_bindings_match_the_c_entry_points(name):
    assert os.path.isdir(K.CSRC)
    assert K._SIGNATURES[name] == _c_signature(name)


def test_key_mask_is_passed_as_bytes_not_converted():
    valid = torch.rand(3, 40) > 0.5
    kept, ptr, stride = K._key_mask(valid, 3, 40)
    assert kept is valid and ptr == valid.data_ptr() and stride == 40
    wide = torch.rand(3, 80) > 0.5
    view = wide[:, :40]                      # a row-strided view stays
    kept, ptr, stride = K._key_mask(view, 3, 40)
    assert kept is view and stride == 80
    thin = wide[:, ::2]                      # a strided last dim is copied
    kept, ptr, stride = K._key_mask(thin, 3, 40)
    assert kept.is_contiguous() and torch.equal(kept, thin) and stride == 40
    assert K._key_mask(None, 3, 40) == (None, None, 0)
    for bad in (valid.float(), valid[:2], valid[:, :39]):
        with pytest.raises(ValueError):
            K._key_mask(bad, 3, 40)


def test_cuda_route_refuses_cpu_operands():
    """A kernel entry point never takes a CPU tensor (the wrappers choose
    the plain version for those)."""
    q = torch.zeros(1, 16, 64)
    with pytest.raises(ValueError):
        K.attention(q, q, q, num_heads=2, scale=1.0)
    with pytest.raises(ValueError):
        K.attention_train_fwd(q, q, q, num_heads=2, scale=1.0)
    n0 = dict(K.launches)
    mlp = (torch.zeros(5, 12), torch.zeros(12), torch.zeros(12, 8),
           torch.zeros(8))
    with pytest.raises(ValueError):
        K.bias_attention(torch.zeros(1, 16, 768, dtype=torch.bfloat16), None,
                         torch.zeros(1, 16, 16, 5, dtype=torch.bfloat16), mlp,
                         num_heads=8)
    assert K.launches == n0


# ------------------------------------------- plain versions at ragged sizes
RAGGED = [(100, 100), (257, 257), (356, 356), (100, 256)]


def _operands(rng, b, nq, nk, h, d):
    q = rng.normal(size=(b, nq, h, d)).astype(np.float32)
    k, v = (rng.normal(size=(b, nk, h, d)).astype(np.float32)
            for _ in range(2))
    valid = rng.uniform(size=(b, nk)) > 0.3
    valid[:, 0] = True
    return q, k, v, valid


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("d", [32, 64])
@pytest.mark.parametrize("nq,nk", RAGGED)
def test_flash_mha_plain_matches_jax_kernel_at_ragged_sizes(nq, nk, d,
                                                            masked):
    rng = np.random.default_rng(nq + nk + d)
    b, h = 2, 2
    q, k, v, valid = _operands(rng, b, nq, nk, h, d)
    ref = jflash.flash_mha(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                           jnp.asarray(valid) if masked else None,
                           interpret=True)
    out = tflash.flash_mha(torch.from_numpy(q), torch.from_numpy(k),
                           torch.from_numpy(v),
                           torch.from_numpy(valid) if masked else None)
    assert out.dtype == torch.float32 and out.shape == (b, nq, h, d)
    diff = np.abs(out.numpy() - np.asarray(ref, np.float32))
    assert diff.max() <= 2 ** -7 * 2, diff.max()
    assert diff.mean() <= 1e-3, diff.mean()
    assert tflash.launches == 0


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("n,d,grads", [(100, 32, True), (100, 64, False),
                                       (356, 32, False), (257, 64, False)])
def test_flash_train_plain_matches_jax_kernels_at_ragged_sizes(n, d, grads,
                                                               masked):
    rng = np.random.default_rng(n + d)
    b, h = 1, 2
    q, k, v, valid = _operands(rng, b, n, n, h, d)
    g = rng.normal(size=(b, n, h, d)).astype(np.float32)
    bias = (0.3 * rng.normal(size=(b, h, n, n))).astype(np.float32)
    jvalid = jnp.asarray(valid) if masked else None
    tvalid = torch.from_numpy(valid) if masked else None
    jargs = [jnp.asarray(t) for t in (q, k, v, bias)]
    jout = jflash.flash_mha_train(*jargs[:3], jvalid, jargs[3],
                                  interpret=True)
    leaves = [torch.tensor(t, requires_grad=True) for t in (q, k, v, bias)]
    tout = tflash.flash_mha_train(*leaves[:3], tvalid, leaves[3])
    np.testing.assert_allclose(tout.detach().numpy(), np.asarray(jout),
                               atol=0.02, rtol=0.02)
    assert tflash.launches_fwd == 0
    if not grads:
        return

    def jloss(q, k, v, bias):
        return jnp.sum(jflash.flash_mha_train(q, k, v, jvalid, bias,
                                              interpret=True) * g)

    jgrads = jax.grad(jloss, argnums=(0, 1, 2, 3))(*jargs)
    tgrads = torch.autograd.grad(tout, leaves, torch.from_numpy(g))
    for name, tg, jg in zip(("dq", "dk", "dv", "dbias"), tgrads, jgrads):
        np.testing.assert_allclose(tg.numpy(), np.asarray(jg), atol=0.05,
                                   rtol=0.05, err_msg=name)
