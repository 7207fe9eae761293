"""The port's demo path (edgecape_tpu_torch/cli/demo.py, cli/app.py,
utils/visualization.py, data/pipeline.decode_image) against demo.py,
app.py and cv2 on the CPU.

square_pad_resize has no cv2: a float32 bilinear resize with cv2's
INTER_LINEAR sampling, rounded once, where cv2 sums 11-bit fixed-point
weights, so the two agree to within one intensity level and not bit for
bit. The inference part is held against demo.run_inference's own
forward (the JAX PoseEstimator.forward_batch on the EpisodeBatch the JAX
demo builds) at 56 px in fp32, with the same drawn weights (zero
initialisations redrawn, test_torch_slice._perturb) and request images
that both resizes give bit for bit: 1e-4 on normalised keypoints, 1e-5
on the learned adjacency."""

import json
import sys

import jax
import numpy as np
import pytest
import torch

import demo
import torch_threads  # noqa: F401  (caps torch's threads per worker)
from edgecape_tpu.api import PoseEstimator as JaxEstimator
from edgecape_tpu.config import Config, ModelConfig
from edgecape_tpu_torch.cli import app as tapp
from edgecape_tpu_torch.cli import demo as tdemo
from edgecape_tpu_torch.data.pipeline import decode_image
from edgecape_tpu_torch.models.convert import from_jax_params
from test_app_gradio import _component_map, _make_stub_gradio, _SelectData
from test_torch_slice import _perturb

cv2 = pytest.importorskip("cv2")

SIZE = 56
COORD_TOL, ADJ_TOL = 1e-4, 1e-5


@pytest.mark.parametrize("shape,size", [
    ((37, 53), 56), ((53, 37), 56), ((101, 29), 56), ((17, 23), 56),
    ((640, 480), 256), ((333, 517), 224), ((56, 40), 56), ((9, 9), 128),
])
def test_square_pad_resize_within_one_level_of_cv2(shape, size):
    img = np.random.default_rng(sum(shape)).integers(
        0, 256, shape + (3,), dtype=np.uint8)
    ours, scale = tdemo.square_pad_resize(img, size)
    ref, ref_scale = demo.square_pad_resize(img, size)
    assert ours.dtype == np.uint8 and ours.shape == (size, size, 3)
    assert scale == ref_scale
    d = np.abs(ours.astype(int) - ref.astype(int))
    assert d.max() <= 1, d.max()


@pytest.mark.parametrize("ext", [".png", ".ppm"])
def test_decode_image_matches_cv2(ext):
    img = np.random.default_rng(1).integers(0, 256, (19, 31, 3),
                                            dtype=np.uint8)
    ok, buf = cv2.imencode(ext, img[..., ::-1])
    assert ok
    ref = cv2.cvtColor(cv2.imdecode(buf, cv2.IMREAD_COLOR),
                       cv2.COLOR_BGR2RGB)
    out = decode_image(buf.tobytes())
    assert out.dtype == np.uint8 and np.array_equal(out, ref)
    assert np.array_equal(out, img)


def _pair():
    """Support 112 x 80 in 2 x 2 blocks (halved exactly), query 56 x 40
    (not resized), and an annotation of 9 keypoints with a skeleton."""
    rng = np.random.default_rng(4)
    sup = np.repeat(np.repeat(rng.integers(0, 256, (SIZE, 40, 3),
                                           dtype=np.uint8), 2, 0), 2, 1)
    qry = rng.integers(0, 256, (SIZE, 40, 3), dtype=np.uint8)
    kpts = rng.uniform(4, 76, (9, 2)).round(1)
    ann = {"keypoints": kpts.tolist(),
           "skeleton": [[i, i + 1] for i in range(8)] + [[2, 7]]}
    return sup, qry, ann


@pytest.fixture(scope="module")
def weights():
    """(flax backbone, flax head) of the demo's model at 56 px, drawn by
    the JAX estimator, zero initialisations redrawn."""
    cfg = Config(model=ModelConfig(image_size=SIZE, learn_skeleton=True,
                                   attn_bias=True,
                                   use_bias_attn_module=True))
    est = JaxEstimator(cfg)
    return _perturb(est.backbone_params, est.head_params)


def test_demo_inference_matches_the_jax_demo(weights, monkeypatch):
    import edgecape_tpu.api
    import edgecape_tpu.utils.visualization as jvis

    bb, head = weights
    seen = {}

    def jax_estimator(cfg, **kw):
        est = JaxEstimator(cfg,
                           backbone_params=jax.tree.map(jax.numpy.asarray,
                                                        bb),
                           head_params=jax.tree.map(jax.numpy.asarray,
                                                    head))
        real = est.forward_batch

        def forward_batch(batch):
            seen["batch"] = batch
            return real(batch)
        est.forward_batch = forward_batch
        return est

    monkeypatch.setattr(edgecape_tpu.api, "PoseEstimator", jax_estimator)
    monkeypatch.setattr(jvis, "plot_results",
                        lambda *args: seen.setdefault("plot", args))
    sup, qry, ann = _pair()
    demo.run_inference(sup, qry, ann, size=SIZE)
    _, _, j_joints, _, j_pred, j_skel, j_adj, _ = seen["plot"]

    bb_sd, head_sd = from_jax_params(bb, head)
    est = tdemo.stage3_estimator(SIZE, backbone_state=bb_sd,
                                 head_state=head_sd, device="cpu")
    out = tdemo.infer(est, sup, qry, ann)
    jb, tb = seen["batch"], out["batch"]
    for name in ("img_s", "img_q", "target_s", "weight_s", "binary_adj"):
        np.testing.assert_allclose(getattr(tb, name), getattr(jb, name),
                                   atol=1e-6, rtol=0, err_msg=name)
    np.testing.assert_allclose(out["joints"], j_joints, atol=1e-5, rtol=0)
    assert out["skeleton"] == j_skel
    assert out["pred_px"].shape == (9, 2)
    np.testing.assert_allclose(out["pred_px"] / SIZE, j_pred / SIZE,
                               atol=COORD_TOL, rtol=0)
    np.testing.assert_allclose(out["raw_adj"], j_adj, atol=ADJ_TOL, rtol=0)


def test_demo_cli_writes_its_figures(tmp_path):
    """main on PPM files with an annotation file, random weights, on the
    CPU: the result figure and both debug figures."""
    pytest.importorskip("matplotlib")
    sup, qry, ann = _pair()
    paths = {}
    for name, img in (("support", sup), ("query", qry)):
        ok, buf = cv2.imencode(".ppm", img[..., ::-1])
        paths[name] = tmp_path / f"{name}.ppm"
        paths[name].write_bytes(buf.tobytes())
    (tmp_path / "ann.json").write_text(json.dumps(ann))
    out = tmp_path / "out"
    path = tdemo.main(["--support", str(paths["support"]), "--query",
                       str(paths["query"]), "--annotation",
                       str(tmp_path / "ann.json"), "--size", str(SIZE),
                       "--out", str(out), "--device", "cpu",
                       "--plot-similarity", "--plot-attn"])
    assert path.endswith("result_0.png")
    written = sorted(p.name for p in out.iterdir())
    assert written == ["attn_0.png", "result_0.png", "similarity_0.png"]
    assert all(p.stat().st_size > 1000 for p in out.iterdir())


def test_plot_results_writes_a_file(tmp_path):
    pytest.importorskip("matplotlib")
    from edgecape_tpu_torch.utils.visualization import plot_results
    rng = np.random.default_rng(0)
    img = rng.normal(size=(SIZE, SIZE, 3)).astype(np.float32)
    kpts = rng.uniform(0, SIZE, (5, 2))
    paths = [plot_results(img, img, kpts, np.ones(5), kpts + 1,
                          [[0, 1], [1, 2]], rng.uniform(size=(5, 5)),
                          str(tmp_path)) for _ in range(2)]
    assert [p.rsplit("/", 1)[1] for p in paths] == ["result_0.png",
                                                   "result_1.png"]


@pytest.fixture()
def stub_gradio(monkeypatch):
    registry = {"components": [], "blocks": [], "launched": []}
    monkeypatch.setitem(sys.modules, "gradio", _make_stub_gradio(registry))
    return registry


def test_build_interface_wires_callbacks(stub_gradio, monkeypatch):
    calls = []

    def fake_run_inference(support_img, query_img, annotation, **kwargs):
        calls.append((support_img.shape, query_img.shape, annotation,
                      kwargs))
        return "out.png"

    monkeypatch.setattr(tdemo, "run_inference", fake_run_inference)
    ui = tapp.build_interface(checkpoint="ckpt", size=256, device="cpu")
    assert ui.launched is False
    comps = _component_map(stub_gradio)
    assert {"support", "query", "result", "status"} <= set(comps)
    select_fn = comps["support"].handlers["select"][0]
    img = np.zeros((64, 64, 3), np.uint8)
    for xy in ([4, 5], [10, 12], [30, 31]):
        status = select_fn(img, _SelectData(xy))
    assert status == "3 keypoints"
    edge_btn, reset_btn, run_btn = [c for c in stub_gradio["components"]
                                    if c.kind == "Button"]
    edge_fn = edge_btn.handlers["click"][0]
    assert edge_fn(0, 1) == "1 edges" and edge_fn(1.0, 2.0) == "2 edges"
    infer_fn = run_btn.handlers["click"][0]
    assert infer_fn(img, img + 1) == "out.png"
    (s_shape, q_shape, ann, kwargs), = calls
    assert s_shape == q_shape == (64, 64, 3)
    assert ann == {"keypoints": [[4, 5], [10, 12], [30, 31]],
                   "skeleton": [[0, 1], [1, 2]]}
    assert kwargs == {"checkpoint": "ckpt", "backbone_ckpt": None,
                      "size": 256, "device": "cpu"}
    assert reset_btn.handlers["click"][0]() == "cleared"
    infer_fn(img, img)
    assert calls[-1][2] == {"keypoints": [], "skeleton": []}


def test_app_main_launches_the_gradio_ui(stub_gradio):
    tapp.main(["--device", "cpu"])
    assert len(stub_gradio["launched"]) == 1


def test_entry_points_default_to_the_card():
    from edgecape_tpu_torch.cli import serve as tserve
    assert tdemo.parse_args(["--support", "a", "--query", "b",
                             "--annotation", "c"]).device == "cuda"
    assert tserve.parse_args([]).device == "cuda"
    assert tapp.parse_args([]).device == "cuda"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tapp.main([])
