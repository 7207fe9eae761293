"""What the port decides in Python for its two redesigned kernels, on the
CPU: the launch plan of the training attention's backward
(ops/kernels.py attention_bwd_plan), the GEMM's choice between its TMA +
wgmma mainloop and the thread-copy one (gemm_mainloop, tma_operand_ok),
the pinned-buffer staging of host arrays (staging.HostStager) and the
references the GPU benches hold the kernels against.
"""

import numpy as np
import pytest
import torch

import torch_threads  # noqa: F401  (caps torch's threads per worker)
from edgecape_tpu_torch import staging
from edgecape_tpu_torch.ops import kernels as K
from edgecape_tpu_torch.tools import bench_attention, bench_gemm
from edgecape_tpu_torch.train.loop import BATCH_KEYS, batch_to_tensors

SMEM_LIMIT = 232448          # bytes of shared memory a block may use

# the call sites of flash_mha_train in a training step (all self-attention:
# Nq == Nk), then shapes the kernels take beyond them
BWD_PATH_SHAPES = [("joint encoder", 356, 356, 32),
                   ("skeleton refine", 100, 100, 32),
                   ("decoder self, bias", 100, 100, 32),
                   ("cross-like", 100, 256, 64),
                   ("vit-like", 257, 257, 64),
                   ("longest", 512, 512, 64)]


def _tiles_of(split, warps, n):
    """Rows each (block, warp) takes, as the kernels assign them: tile =
    block * warps + warp, 16 rows a tile."""
    rows = []
    for y in range(split):
        for w in range(warps):
            tile = y * warps + w
            rows.extend(range(tile * 16, min(tile * 16 + 16, n)))
    return rows


def _check_bwd_plan(plan, nq, nk, d):
    kld = d + 8
    q_tiles, key_tiles = -(-nq // 16), -(-nk // 16)
    assert (plan["q_tiles"], plan["key_tiles"]) == (q_tiles, key_tiles)
    for split, warps, tiles in (
            (plan["q_split"], plan["q_warps"], q_tiles),
            (plan["k_split"], plan["k_warps"], key_tiles)):
        assert 1 <= warps <= K.BWD_MAX_WARPS
        # no block without a tile, every tile in exactly one (block, warp)
        assert (split - 1) * warps < tiles <= split * warps
    assert plan["one_pass"] == (plan["chunk_tiles"] == K.ATT_ROW16)
    if plan["one_pass"]:
        assert key_tiles <= K.ATT_ROW16
    # what the kernels lay out in shared memory
    assert plan["q_smem_bytes"] >= 4 * key_tiles * 16 * kld \
        + 64 * plan["q_warps"] * kld + 4 * key_tiles * 16
    assert plan["k_smem_bytes"] >= 4 * q_tiles * 16 * kld \
        + 16 * q_tiles * 16 + 64 * plan["k_warps"] * kld
    assert max(plan["q_smem_bytes"], plan["k_smem_bytes"]) <= SMEM_LIMIT


@pytest.mark.parametrize("shape", BWD_PATH_SHAPES, ids=lambda s: s[0])
def test_bwd_plan_at_path_shapes(shape):
    _, nq, nk, d = shape
    plan = K.attention_bwd_plan(nq, nk, d)
    _check_bwd_plan(plan, nq, nk, d)
    assert _tiles_of(plan["q_split"], plan["q_warps"], nq) == list(range(nq))
    assert _tiles_of(plan["k_split"], plan["k_warps"], nk) == list(range(nk))
    assert plan["one_pass"] == (nk <= 128)
    # the sequence is split over the grid wherever it is longer than a block
    if nq > 16 * K.BWD_MAX_WARPS:
        assert plan["q_split"] > 1
    if nk > 16 * K.BWD_MAX_WARPS:
        assert plan["k_split"] > 1
    # from the shapes alone: the same answer again, whatever came between
    K.attention_bwd_plan(nk, nq, d)
    assert K.attention_bwd_plan(nq, nk, d) == plan


@pytest.mark.parametrize("d", [32, 64])
@pytest.mark.parametrize("kind", ["chosen", "two passes"])
def test_bwd_plan_sweep(kind, d):
    """(Nq, Nk) over 1..512: shared memory within the card's limit, at
    most 8 warps a block, every query and key tile covered exactly once."""
    kw = {"chunk_tiles": K.ATT_CH16} if kind == "two passes" else {}
    nqs = sorted(set(range(1, 513, 7)) | {15, 16, 17, 100, 257, 356, 512})
    for nk in range(1, 513, 3):
        for nq in nqs:
            plan = K.attention_bwd_plan(nq, nk, d, **kw)
            _check_bwd_plan(plan, nq, nk, d)
            if kind == "two passes":
                assert not plan["one_pass"]
        plan = K.attention_bwd_plan(nk, nk, d, **kw)
        assert _tiles_of(plan["q_split"], plan["q_warps"], nk) \
            == list(range(nk))
        assert _tiles_of(plan["k_split"], plan["k_warps"], nk) \
            == list(range(nk))


@pytest.mark.parametrize("args,kw", [
    ((100, 100, 129), {}), ((100, 600, 129), {}),
    ((100, 513, 32), {"chunk_tiles": 2}), ((513, 100, 32), {"chunk_tiles": 2}),
    ((100, 0, 32), {}), ((0, 100, 32), {}),
    ((100, 129, 32), {"chunk_tiles": 8}),
    ((100, 100, 32), {"chunk_tiles": 4})])
def test_bwd_plan_refuses_unsupported_shapes(args, kw):
    with pytest.raises(ValueError):
        K.attention_bwd_plan(*args, **kw)


def test_bwd_plan_arguments_follow_the_c_entry_point():
    """The plan's seven numbers in the order ec_attn_train_bwd takes them,
    between the delta scratch pointer and the stream."""
    plan = K.attention_bwd_plan(356, 356, 32)
    args = K._bwd_plan_args(plan)
    assert args == [plan["q_split"], plan["q_warps"], plan["chunk_tiles"],
                    plan["q_smem_bytes"], plan["k_split"], plan["k_warps"],
                    plan["k_smem_bytes"]]
    sig = K._SIGNATURES["ec_attn_train_bwd"]
    assert sig[-8:-1] == K._BWD_PLAN and sig[-1] == K._P
    assert len(sig) == len(K._TRAIN_HEAD) + 10 + len(K._BWD_PLAN) + 1


def test_backward_refuses_cpu_operands():
    q = torch.zeros(1, 16, 64)
    stats = torch.zeros(2, 16, 2)
    with pytest.raises(ValueError):
        K.attention_train_bwd(q, q, q, q, stats, num_heads=2, scale=1.0)


# ------------------------------------------------------ GEMM dispatch
ALIGNED = 1 << 20           # a base address on 16 bytes (and far more)

# the GEMMs of the eval chunk and the training step: name, N, batch,
# A (row stride, batch stride), B (row stride, batch stride), mainloop
PATH_GEMMS = [
    ("vit qkv", 1152, 1, (384, 0), (384, 0), K.GEMM_TMA),
    ("vit proj", 384, 1, (384, 0), (384, 0), K.GEMM_TMA),
    ("vit fc1", 1536, 1, (384, 0), (384, 0), K.GEMM_TMA),
    ("vit fc2", 384, 1, (1536, 0), (1536, 0), K.GEMM_TMA),
    ("encoder qkv", 768, 1, (256, 0), (256, 0), K.GEMM_TMA),
    ("attention output as A (a view of qkv)", 256, 1, (768, 0), (256, 0),
     K.GEMM_TMA),
    ("decoder cross q, a column slice of the weight", 512, 1, (256, 0),
     (512, 0), K.GEMM_TMA),
    ("decoder cross k, batched A, shared B", 512, 510, (256, 256 * 256),
     (512, 0), K.GEMM_TMA),
    ("gcn adjacency, rows of 100 values", 384, 510, (100, 20000),
     (768, 76800), K.GEMM_COPY),
    ("kpt_branch out, 2 columns", 2, 1, (256, 0), (256, 0), K.GEMM_COPY),
]


@pytest.mark.parametrize("case", PATH_GEMMS, ids=lambda c: c[0])
def test_gemm_mainloop_at_path_shapes(case):
    _, n, batch, a, b, want = case
    assert K.gemm_mainloop(n, batch, (ALIGNED,) + a, (ALIGNED,) + b) == want


@pytest.mark.parametrize("ptr,ld,stride,batch,ok", [
    (ALIGNED, 384, 0, 1, True),
    (ALIGNED + 16, 384, 0, 1, True),
    (ALIGNED + 8, 384, 0, 1, False),       # base not on 16 bytes
    (ALIGNED + 2, 384, 0, 1, False),
    (ALIGNED, 100, 0, 1, False),           # rows of 200 bytes
    (ALIGNED, 388, 0, 1, False),
    (ALIGNED, 392, 0, 1, True),            # padded rows on 16 bytes
    (ALIGNED, 0, 0, 1, False),
    (ALIGNED, 256, 0, 510, True),          # shared across the batch
    (ALIGNED, 256, 65536, 510, True),
    (ALIGNED, 256, 25604, 510, False),     # batches not on 16 bytes
    (ALIGNED, 256, 25604, 1, True),        # one batch: its stride is unused
    (ALIGNED, 256, -8, 4, False)])
def test_tma_operand_ok(ptr, ld, stride, batch, ok):
    assert K.tma_operand_ok(ptr, ld, stride, batch) is ok


@pytest.mark.parametrize("n,want", [(1, K.GEMM_COPY), (2, K.GEMM_COPY),
                                    (31, K.GEMM_COPY), (32, K.GEMM_TMA),
                                    (33, K.GEMM_TMA), (4096, K.GEMM_TMA)])
def test_gemm_mainloop_by_output_width(n, want):
    op = (ALIGNED, 256, 0)
    assert K.gemm_mainloop(n, 1, op, op) == want
    assert K.GEMM_TMA_MIN_N == 32


def test_gemm_mainloop_needs_both_operands():
    good, bad = (ALIGNED, 256, 0), (ALIGNED + 2, 256, 0)
    assert K.gemm_mainloop(256, 1, good, good) == K.GEMM_TMA
    assert K.gemm_mainloop(256, 1, bad, good) == K.GEMM_COPY
    assert K.gemm_mainloop(256, 1, good, bad) == K.GEMM_COPY


def test_gemm_views_of_real_tensors():
    """The dispatch on tensors as the fused ops cut them: column slices of
    a fused projection and of a weight keep their base on 16 bytes when
    they start at a multiple of 8 elements."""
    bf = torch.bfloat16
    qkv = torch.zeros(64, 768, dtype=bf)
    w = torch.zeros(512, 512, dtype=bf)

    def op(t):
        return t.data_ptr(), t.stride(-2), 0

    assert K.gemm_mainloop(256, 1, op(qkv[:, 256:512]), op(w[:, 256:])) \
        == K.GEMM_TMA
    assert K.gemm_mainloop(256, 1, op(qkv[:, 4:260]), op(w[:, 256:])) \
        == K.GEMM_COPY
    assert K.gemm_mainloop(256, 1, op(qkv), op(w[:, 3:259])) == K.GEMM_COPY


def test_gemm_refuses_cpu_operands_and_counts_nothing():
    a = torch.zeros(16, 64, dtype=torch.bfloat16)
    before = dict(K.launches)
    with pytest.raises(ValueError):
        K.gemm(a, a, b_nk=True)
    assert K.launches == before
    assert {"gemm_tma_kernel", "gemm_kernel"} <= set(before)


def test_gemm_binding_takes_the_mainloop_before_the_stream():
    sig = K._SIGNATURES["ec_gemm"]
    assert sig[-2:] == [K._I, K._P] and len(sig) == 28


# ------------------------------------------------- pinned-buffer staging
class FakeEvent:
    """An event that is never complete until waited for: the stager must
    then wait before it writes a buffer again."""
    waits = 0

    def __init__(self):
        self.recorded = False

    def record(self):
        self.recorded = True

    def query(self):
        return not self.recorded

    def synchronize(self):
        FakeEvent.waits += 1
        self.recorded = False


def _fake_pinned_stager(**kw):
    made = []

    def alloc(shape, dtype):
        made.append(torch.empty(shape, dtype=dtype))
        return made[-1]

    st = staging.HostStager("cpu", alloc=alloc, new_event=FakeEvent, **kw)
    st.pinned = True         # take the buffered route without a card
    return st, made


@pytest.mark.parametrize("dtype", [np.uint8, np.float32, np.int32])
def test_stager_on_cpu_takes_no_pinned_path(dtype):
    rng = np.random.default_rng(0)
    a = (rng.uniform(0, 255, (40, 224, 224, 3))).astype(dtype)
    st = staging.HostStager("cpu")
    out = st(a, "img_q")
    assert not st.pinned and st.staged == 0 and st.direct == 1
    assert not st._slots and out.device.type == "cpu"
    assert out.dtype == torch.as_tensor(a).dtype
    assert np.array_equal(out.numpy(), a)


@pytest.mark.parametrize("dtype", [np.uint8, np.float32])
def test_staged_values_are_bit_equal_and_buffers_are_not_overwritten_early(
        dtype):
    rng = np.random.default_rng(1)
    arrays = [rng.uniform(0, 255, (24, 224, 224, 3)).astype(dtype)
              for _ in range(5)]
    FakeEvent.waits = 0
    st, made = _fake_pinned_stager()
    outs = [st(a, "img_q") for a in arrays]
    for a, out in zip(arrays, outs):
        assert np.array_equal(out.numpy(), a)       # bit for bit
        assert all(out.data_ptr() != buf.data_ptr() for buf in made)
    # two buffers in turn; the third and later calls each waited for the
    # event behind the buffer they reuse
    assert len(made) == staging.SLOTS == 2
    assert st.staged == 5 and st.direct == 0 and FakeEvent.waits == 3


def test_stager_makes_the_second_buffer_only_when_the_first_is_busy():
    class Done(FakeEvent):
        def query(self):
            return True

    made = []
    st = staging.HostStager(
        "cpu", alloc=lambda s, d: made.append(torch.empty(s, dtype=d))
        or made[-1], new_event=Done)
    st.pinned = True
    a = np.ones((600, 600), np.float32)
    for i in range(4):
        assert np.array_equal(st(a * i, "x").numpy(), a * i)
    assert len(made) == 1 and st.staged == 4


def test_stager_sends_small_arrays_directly_and_keys_buffers_by_shape():
    st, made = _fake_pinned_stager()
    small = np.arange(100, dtype=np.float32)
    assert np.array_equal(st(small, "joints_s").numpy(), small)
    assert st.direct == 1 and not made
    a = np.zeros((600, 600), np.float32)
    b = np.zeros((300, 1200), np.float32)
    st(a, "x"), st(b, "x"), st(a, "y")
    assert len(made) == 3 and st.staged == 3
    assert staging.MIN_STAGED_BYTES == 1 << 20


def test_batch_to_tensors_on_cpu_is_bit_equal_and_unstaged():
    rng = np.random.default_rng(2)
    batch = {k: rng.uniform(size=(4, 3, 5)).astype(np.float32)
             for k in BATCH_KEYS}
    batch["img_q"] = rng.uniform(size=(16, 224, 224, 3)).astype(np.float32)
    st = staging.HostStager("cpu")
    out = batch_to_tensors(batch, torch.device("cpu"), st)
    assert set(out) == set(BATCH_KEYS) and st.staged == 0
    for k in BATCH_KEYS:
        assert np.array_equal(out[k].numpy(), batch[k])
    again = batch_to_tensors(batch, torch.device("cpu"))
    assert all(torch.equal(out[k], again[k]) for k in BATCH_KEYS)


def test_estimator_keeps_a_cpu_stager_unpinned():
    from edgecape_tpu_torch.api import PoseEstimator
    from edgecape_tpu_torch.config import Config, ModelConfig
    from edgecape_tpu_torch.models.convert import init_params
    from edgecape_tpu_torch.models.dinov2 import DinoV2Config
    trunk = DinoV2Config(depth=1, embed_dim=64, num_heads=2)
    cfg = Config(model=ModelConfig(max_kpt=6, image_size=56, heatmap_size=16,
                                   backbone_dim=64, use_flash=False))
    bb, head = init_params(torch.Generator().manual_seed(0), cfg.model,
                           backbone_cfg=trunk)
    est = PoseEstimator(cfg, bb, head, device="cpu", backbone_cfg=trunk)
    assert isinstance(est._stage, staging.HostStager)
    assert not est._stage.pinned and est._stage.device.type == "cpu"
    rng = np.random.default_rng(0)
    adj = np.zeros((2, 6, 6), np.float32)
    adj[:, 0, 1] = adj[:, 1, 0] = 1.0
    support = {"img_s": rng.integers(0, 256, (2, 1, 56, 56, 3), np.uint8),
               "joints_s": rng.uniform(4, 52, (2, 1, 6, 2)).astype(np.float32),
               "vis_s": np.ones((2, 1, 6), np.float32), "binary_adj": adj}
    query = {"img_q": rng.integers(0, 256, (3, 56, 56, 3), np.uint8),
             "group": np.array([0, 1, 1], np.int32)}
    pred, _ = est.forward_cached(support, query)
    assert pred.shape == (3, 6, 2) and bool(torch.isfinite(pred).all())
    assert est._stage.staged == 0 and est._stage.direct == 6


# -------------------------------------------- the benches' own references
@pytest.mark.parametrize("epi", ["bias", "gelu", "relu", "pre", "relu_pre",
                                 "res_ls"])
@pytest.mark.parametrize("b_nk", [True, False])
def test_bench_gemm_reference_is_the_documented_epilogue(epi, b_nk):
    """reference() of tools/bench_gemm.py: y = acc + bias + pre; act;
    y = res + ls * y, in float64 on the bf16 operands."""
    spec = ("small", None if epi not in ("pre", "relu_pre") else 3, 20, 24,
            16, b_nk, epi, torch.float32)
    a, b, kw = bench_gemm.make_case(spec, torch.device("cpu"))
    ref = bench_gemm.reference(a, b, b_nk, kw["bias"], kw["pre"], kw["act"],
                               kw["res"], kw["ls"])
    y = a.double() @ (b.double().transpose(-1, -2) if b_nk else b.double())
    if kw["bias"] is not None:
        y = y + kw["bias"].double()
    if kw["pre"] is not None:
        y = y + kw["pre"].double()
    if kw["act"] == K.ACT_GELU:
        y = 0.5 * y * (1 + torch.erf(y / 2 ** 0.5))
    elif kw["act"] == K.ACT_RELU:
        y = y.clamp_min(0)
    if kw["res"] is not None:
        y = kw["res"].double() + kw["ls"].double() * y
    assert ref.dtype == torch.float64
    torch.testing.assert_close(ref, y, rtol=1e-12, atol=1e-12)
    err, ok = bench_gemm.check(ref.float(), ref)
    assert ok and err < 1e-5
    assert not bench_gemm.check((ref * 1.01 + 0.01).float(), ref)[1]


def test_benches_need_a_card():
    for tool in (bench_gemm, bench_attention):
        with pytest.raises(SystemExit):
            tool.main([])
    with pytest.raises(SystemExit):
        bench_attention.main(["bwd"])
    with pytest.raises(SystemExit):
        bench_attention.main(["sideways"])


def test_bench_shapes_cover_the_path():
    names = [s[0] for s in bench_gemm.SHAPES]
    assert len(names) == len(set(names)) >= 12
    for name, z, m, n, k, b_nk, epi, dtype in bench_gemm.SHAPES:
        assert epi in ("bias", "gelu", "relu", "pre", "relu_pre", "res_ls")
        assert dtype in (torch.float32, torch.bfloat16)
    train = [s for s in bench_attention.SHAPES if s[-1] is not None]
    assert {(s[1], s[2], s[3]) for s in train} == {(16, 356, 356),
                                                   (16, 100, 100)}
