"""The port's host-side data path (edgecape_tpu_torch/data, ops/affine,
ops/warp, the numpy heatmap renderers, eval/metrics, utils/tb_writer,
config and configs, models/convert.load_backbone) against the JAX
package's, on the CPU.

Both packages read one synthetic MP-100 stand-in written by the port's
generator (PPM images, which cv2 decodes too). Bounds: episode lists,
joints, weights, adjacency, masks and meta are equal; rendered heatmaps to
1e-5 (float rounding of exp); images within the JAX package's own bound
for its C++ warp against cv2.warpAffine's fixed-point bilinear (max 4/255,
median 1/255 of a pixel value), and exactly equal where both sides go
through the C++ core."""

import dataclasses
import glob
import json
import os
import random

import numpy as np
import pytest
import torch

from edgecape_tpu import config as jcfg
from edgecape_tpu.data import compose as jcompose
from edgecape_tpu.data import loader as jloader
from edgecape_tpu.data import mp100 as jmp
from edgecape_tpu.data import synthetic as jsyn
from edgecape_tpu.eval import metrics as jmetrics
from edgecape_tpu.ops import affine as jaffine
from edgecape_tpu.ops import heatmap as jheat
from edgecape_tpu.ops import warp as jwarp
from edgecape_tpu.utils import tb_writer as jtb
from edgecape_tpu_torch import config as tcfg
from edgecape_tpu_torch.data import compose as tcompose
from edgecape_tpu_torch.data import loader as tloader
from edgecape_tpu_torch.data import mp100 as tmp
from edgecape_tpu_torch.data import native as tnative
from edgecape_tpu_torch.data import pipeline as tpipe
from edgecape_tpu_torch.data import synthetic as tsyn
from edgecape_tpu_torch.eval import metrics as tmetrics
from edgecape_tpu_torch.ops import affine as taffine
from edgecape_tpu_torch.ops import heatmap as theat
from edgecape_tpu_torch.ops import warp as twarp
from edgecape_tpu_torch.utils import tb_writer as ttb

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STD255 = np.array([0.229, 0.224, 0.225], np.float32) * 255.0
ARRAYS = ("target_s", "weight_s", "target_q", "weight_q", "joints_q",
          "binary_adj", "rand_mask", "joints_s", "vis_s")


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("synth"))
    tsyn.generate(d, num_classes=5, images_per_class=9, image_size=128,
                  seed=3)
    return d


def _data_kw(root, **kw):
    base = dict(ann_file=os.path.join(root, "annotations",
                                      "mp100_synth.json"),
                img_prefix=os.path.join(root, "images"), num_shots=1,
                num_queries=3, num_episodes=2, image_size=64,
                heatmap_size=16, max_kpt=16)
    base.update(kw)
    return base


def _pair(root, mode, **kw):
    """(port dataset, JAX dataset) built under the same global seeds."""
    out = []
    for mod, cfgmod in ((tmp, tcfg), (jmp, jcfg)):
        random.seed(5)
        np.random.seed(6)
        out.append(mod.MP100Dataset(cfgmod.DataConfig(**_data_kw(root, **kw)),
                                    mode))
    return out


def _px(a, b):
    """Differences of two normalised images in units of a pixel value."""
    return np.abs(a - b) * STD255


def _same_batch(bt, bj, images="native"):
    for f in ARRAYS:
        a, b = getattr(bt, f), getattr(bj, f)
        assert a.shape == b.shape and a.dtype == b.dtype, f
        if f.startswith("target"):
            np.testing.assert_allclose(a, b, atol=1e-5, err_msg=f)
        else:
            assert np.array_equal(a, b), f
    for f in ("img_s", "img_q"):
        d = _px(getattr(bt, f), getattr(bj, f))
        if images == "native":      # the same C++ arithmetic on both sides
            assert d.max() <= 0.02, (f, d.max())
        else:                       # cv2's fixed-point bilinear on one side
            assert d.max() <= 4.0 and np.median(d) <= 1.0, (f, d.max())
    assert set(bt.meta) == set(bj.meta)
    for k in bt.meta:
        a, b = bt.meta[k], bj.meta[k]
        if isinstance(a, np.ndarray):
            assert np.array_equal(a, b), k
        elif k == "pair":
            assert all(np.array_equal(x, y) for x, y in zip(a, b))
        else:
            assert list(a) == list(b), k


# ------------------------------------------------------------- synthetic
def test_synthetic_annotations_equal_the_jax_generators(tmp_path):
    kw = dict(num_classes=4, images_per_class=5, image_size=96, seed=11)
    a = json.load(open(tsyn.generate(str(tmp_path / "t"), **kw)))
    b = json.load(open(jsyn.generate(str(tmp_path / "j"), **kw)))
    assert a["categories"] == b["categories"]
    assert a["annotations"] == b["annotations"]
    for x, y in zip(a["images"], b["images"]):
        assert x["file_name"] == y["file_name"].replace(".png", ".ppm")
        assert {k: v for k, v in x.items() if k != "file_name"} == \
            {k: v for k, v in y.items() if k != "file_name"}
    img = tpipe.load_image(str(tmp_path / "t" / "images" / "img_000000.ppm"))
    assert img.shape == (96, 96, 3) and img.dtype == np.uint8
    assert img.max() >= 100          # the figure is drawn over the texture


def test_load_image_formats(tmp_path):
    import cv2
    rng = np.random.default_rng(0)
    img = rng.integers(0, 256, (20, 31, 3), dtype=np.uint8)
    tsyn.write_ppm(str(tmp_path / "a.ppm"), img)
    np.save(str(tmp_path / "a.npy"), img)
    cv2.imwrite(str(tmp_path / "a.png"), img[..., ::-1])
    for ext in ("ppm", "npy", "png"):
        assert np.array_equal(tpipe.load_image(str(tmp_path / f"a.{ext}")),
                              img), ext
    # a PPM with a comment in its header
    with open(tmp_path / "c.ppm", "wb") as f:
        f.write(b"P6\n# made by hand\n31 20\n255\n" + img.tobytes())
    assert np.array_equal(tpipe.load_image(str(tmp_path / "c.ppm")), img)
    with pytest.raises(FileNotFoundError):
        tpipe.load_image(str(tmp_path / "missing.ppm"))
    with pytest.raises(ValueError):
        np.save(str(tmp_path / "f.npy"), img.astype(np.float32))
        tpipe.load_image(str(tmp_path / "f.npy"))


def test_load_image_names_the_missing_decoder(tmp_path, monkeypatch):
    import sys
    path = tmp_path / "a.jpg"
    path.write_bytes(b"\xff\xd8\xff")
    monkeypatch.setitem(sys.modules, "cv2", None)
    monkeypatch.setitem(sys.modules, "PIL", None)
    with pytest.raises(RuntimeError) as err:
        tpipe.load_image(str(path))
    assert "a.jpg" in str(err.value) and "cv2" in str(err.value) \
        and "PIL" in str(err.value)


# ------------------------------------------------------------ dataset
def test_db_and_seeded_test_episodes_equal(root):
    dt, dj = _pair(root, "test")
    assert dt.cat2obj == dj.cat2obj and len(dt.db) == len(dj.db)
    for a, b in zip(dt.db, dj.db):
        assert set(a) == set(b)
        for k in a:
            if isinstance(a[k], np.ndarray):
                assert np.array_equal(a[k], b[k]) and a[k].dtype == b[k].dtype
            else:
                assert a[k] == b[k], k
    assert np.array_equal(dt.paired_samples, dj.paired_samples)
    assert dt.support_groups() == dj.support_groups()
    assert dt.name2id == dj.name2id and dt.img_prefix == dj.img_prefix


@pytest.mark.parametrize("shots", [1, 2])
def test_train_resampling_equal_under_the_same_global_seeds(root, shots):
    dt, dj = _pair(root, "train", num_shots=shots)
    assert np.array_equal(dt.paired_samples, dj.paired_samples)
    for ds in (dt, dj):
        random.seed(9)
        np.random.seed(10)
        ds.resample_episodes()
    assert np.array_equal(dt.paired_samples, dj.paired_samples)
    assert dt.paired_samples.shape[1] == shots + 1


def test_pin_query_images_and_valid_class_ids(root):
    dt, dj = _pair(root, "test", pin_query_images=["img_000003.ppm",
                                                   "img_000012.ppm"],
                   valid_class_ids=[1, 2])
    assert len(dt) > 0
    assert np.array_equal(dt.paired_samples, dj.paired_samples)


def test_missing_file_semantics(root, tmp_path):
    import shutil
    d = str(tmp_path / "partial")
    shutil.copytree(root, d)
    os.remove(os.path.join(d, "images", "img_000004.ppm"))
    cfg_t = tcfg.DataConfig(**_data_kw(d))
    cfg_j = jcfg.DataConfig(**_data_kw(d))
    with pytest.raises(FileNotFoundError):
        tmp.MP100Dataset(cfg_t, "test")
    for check in ("skip", False):
        a = tmp.MP100Dataset(cfg_t, "test", check_files=check)
        b = jmp.MP100Dataset(cfg_j, "test", check_files=check)
        assert len(a.db) == len(b.db)
        assert np.array_equal(a.paired_samples, b.paired_samples)


@pytest.mark.parametrize("use_udp", [False, True])
def test_collate_native_field_by_field(root, use_udp):
    dt, dj = _pair(root, "test", use_udp=use_udp)
    idx = [0, 4, 7, 11]
    _same_batch(dt.collate_native(idx), dj.collate_native(idx))
    # train mode: augmentation and masks from per-sample generators
    dt, dj = _pair(root, "train", use_udp=use_udp)
    rngs = lambda: [np.random.default_rng(s) for s in (1, 2, 3)]  # noqa: E731
    _same_batch(dt.collate_native([1, 2, 3], rng=rngs(), masking_ratio=0.5),
                dj.collate_native([1, 2, 3], rng=rngs(), masking_ratio=0.5))


@pytest.mark.parametrize("encoding", ["msra", "udp", "unbiased"])
def test_collate_field_by_field(root, encoding):
    kw = {"msra": {}, "udp": {"use_udp": True},
          "unbiased": {"unbiased_encoding": True}}[encoding]
    dt, dj = _pair(root, "train", **kw)
    batches = []
    for ds in (dt, dj):
        np.random.seed(4)           # the legacy path's global rand_mask
        batches.append(ds.collate([0, 5, 9], rng=np.random.default_rng(2),
                                  masking_ratio=0.5))
    bt, bj = batches
    _same_batch(bt, bj, images="cv2")
    assert bt.rand_mask.min() == 0.0


def test_collate_equals_collate_native_in_the_port(root):
    """Both collates of the port warp through the C++ core: the same
    pixels."""
    dt, _ = _pair(root, "test")
    a, b = dt.collate([0, 3]), dt.collate_native([0, 3])
    assert np.array_equal(a.img_q, b.img_q)
    assert np.array_equal(a.img_s, b.img_s)
    np.testing.assert_allclose(a.target_q, b.target_q, atol=1e-5)
    cfg = tcfg.DataConfig(**_data_kw(root, unbiased_encoding=True))
    with pytest.raises(NotImplementedError):
        tmp.MP100Dataset(cfg, "test").collate_native([0])


def test_collate_group_field_by_field(root):
    dt, dj = _pair(root, "test", num_shots=2, num_queries=2)
    groups = dt.support_groups()[:3]
    st, qt, mt = dt.collate_group(groups)
    sj, qj, mj = dj.collate_group(groups)
    assert set(st) == set(sj) and set(qt) == set(qj) and set(mt) == set(mj)
    for a, b in ((st, sj), (qt, qj)):
        for k in a:
            assert a[k].shape == b[k].shape and a[k].dtype == b[k].dtype, k
            if k.startswith("img"):
                d = np.abs(a[k].astype(np.int32) - b[k].astype(np.int32))
                assert d.max() <= 4 and np.median(d) <= 1, (k, d.max())
            else:
                assert np.array_equal(a[k], b[k]), k
    for k in mt:
        assert np.array_equal(np.asarray(mt[k]), np.asarray(mj[k])), k
    # one image, preprocessed alone, gives the group's pixels
    rec = dt.db[groups[0][0][0]]
    one = tpipe.preprocess(rec, dt.cfg, with_target=False, normalize=False)
    assert np.array_equal(one.img, st["img_s"][0, 0])


def test_batches_iterator(root):
    dt, dj = _pair(root, "test")
    bt = list(dt.batches(8, drop_last=False))
    bj = list(dj.batches(8, drop_last=False))
    assert len(bt) == len(bj) == -(-len(dt) // 8)
    _same_batch(bt[-1], bj[-1], images="cv2")


@pytest.mark.parametrize("shard", [None, (1, 2)])
def test_prefetcher_epochs_equal_batch_for_batch(root, shard):
    dt, dj = _pair(root, "train")
    kw = dict(shuffle=True, masking_ratio=0.5, drop_last=True, num_workers=2,
              seed=7, shard=shard)
    lt = tloader.Prefetcher(dt, 4, **kw)
    lj = jloader.Prefetcher(dj, 4, use_native=True, **kw)
    assert lt.use_native and len(lt) == len(lj)
    for _ in range(2):                       # two epochs, other orders
        bts, bjs = list(lt.epoch()), list(lj.epoch())
        assert len(bts) == len(bjs) == len(lt)
        for bt, bj in zip(bts[:3], bjs[:3]):
            assert bt.img_q.shape[0] == (2 if shard else 4)
            _same_batch(bt, bj)
    # a shard is the row slice of the unsharded batch
    if shard:
        full = tloader.Prefetcher(_pair(root, "train")[0], 4,
                                  **{**kw, "shard": None})
        part = tloader.Prefetcher(_pair(root, "train")[0], 4, **kw)
        f0, p0 = next(iter(full.epoch())), next(iter(part.epoch()))
        assert np.array_equal(f0.img_q[2:], p0.img_q)
        assert np.array_equal(f0.rand_mask[2:], p0.rand_mask)


def test_prefetcher_python_collate_for_unbiased_encoding(root):
    dt, _ = _pair(root, "train", unbiased_encoding=True)
    lt = tloader.Prefetcher(dt, 4, num_workers=1, seed=0)
    assert not lt.use_native
    assert next(iter(lt.epoch())).target_q.shape == (4, 16, 16, 16)


def test_prefetcher_hands_a_workers_error_to_the_consumer(root, monkeypatch):
    """A collate that raises in a worker thread (a core that does not
    build, a file that cannot be decoded) ends the epoch with that error:
    the consumer neither waits for ever nor gets a slower path."""
    dt, _ = _pair(root, "train")
    lt = tloader.Prefetcher(dt, 4, num_workers=2, seed=0)

    def broken(*a, **k):
        raise RuntimeError("no C++ compiler found")
    monkeypatch.setattr(dt, "collate_native", broken)
    with pytest.raises(RuntimeError, match="compiler"):
        next(iter(lt.epoch()))


def test_repeat_and_concat_datasets(root):
    dt, dj = _pair(root, "train")
    rt, rj = tcompose.RepeatDataset(dt, 3), jcompose.RepeatDataset(dj, 3)
    assert len(rt) == len(rj) == 3 * len(dt)
    idx = [len(dt) + 1, 2 * len(dt) + 2]
    _same_batch(rt.collate_native(idx), rj.collate_native(idx))
    assert rt.num_shots == 1
    dt2, dj2 = _pair(root, "train")
    ct = tcompose.ConcatDataset([dt, dt2])
    cj = jcompose.ConcatDataset([dj, dj2])
    assert len(ct) == len(cj) == 2 * len(dt)
    idx = [len(dt) + 3, 1, len(dt), 5]
    rngs = lambda: [np.random.default_rng(s) for s in range(4)]  # noqa: E731
    _same_batch(ct.collate_native(idx, rng=rngs(), masking_ratio=0.5),
                cj.collate_native(idx, rng=rngs(), masking_ratio=0.5))
    with pytest.raises(AttributeError):
        ct.paired_samples
    cfg = tcfg.DataConfig(**_data_kw(
        root, extra_ann_files=[_data_kw(root)["ann_file"]], repeat_times=2))
    built = tcompose.build_train_dataset(cfg)
    assert isinstance(built, tcompose.RepeatDataset)
    assert isinstance(built.dataset, tcompose.ConcatDataset)
    assert len(built) == 4 * len(dt)


# -------------------------------------------------------------- native
def test_native_warp_against_cv2_within_its_bound():
    import cv2
    rng = np.random.default_rng(0)
    images, mats, invs = [], [], []
    for i in range(5):
        h, w = int(rng.integers(80, 200)), int(rng.integers(80, 200))
        images.append(rng.integers(0, 256, (h, w, 3), dtype=np.uint8))
        m = taffine.get_affine_transform(
            np.array([w / 2, h / 2], np.float32),
            np.array([w, h], np.float32) / 200.0 * rng.uniform(0.7, 1.3),
            float(rng.uniform(-30, 30)), (64, 64))
        mats.append(m)
        invs.append(twarp.invert_affine(m))
    out = tnative.warp_normalize_batch(images, np.stack(invs), (64, 64),
                                       np.zeros(3, np.float32),
                                       np.ones(3, np.float32))
    u8 = tnative.warp_uint8_batch(images, np.stack(invs), (64, 64))
    assert u8.dtype == np.uint8
    for i in range(5):
        ref = cv2.warpAffine(images[i], mats[i], (64, 64),
                             flags=cv2.INTER_LINEAR).astype(np.float32)
        d = np.abs(out[i] * 255.0 - ref)
        assert d.max() <= 4.0 and np.median(d) <= 1.0, d.max()
        d = np.abs(u8[i].astype(np.float32) - ref)
        assert d.max() <= 4.0 and np.median(d) <= 1.0, d.max()
        # the uint8 entry is the float one rounded to nearest
        assert np.abs(u8[i] - np.rint(out[i] * 255.0)).max() <= 1


def test_native_matches_the_jax_packages_core_and_renderers():
    from edgecape_tpu.data import native as jnative
    rng = np.random.default_rng(1)
    joints = rng.uniform(-10, 80, (3, 7, 2)).astype(np.float32)
    vis = (rng.uniform(size=(3, 7)) > 0.2).astype(np.float32)
    for name, render in (("msra_heatmaps_batch", theat.render_msra_np),
                         ("udp_heatmaps_batch", theat.render_udp_np)):
        for sigma in (1.0, 1.5):
            t, w = getattr(tnative, name)(joints, vis, (16, 16), (64.0, 64.0),
                                          sigma)
            if jnative.available():
                tj, wj = getattr(jnative, name)(joints, vis, (16, 16),
                                                (64.0, 64.0), sigma)
                # the two builds differ in compiler flags: exp to an ulp
                np.testing.assert_allclose(t, tj, atol=1e-6)
                assert np.array_equal(w, wj)
            for i in range(3):
                tn, wn = render(joints[i], vis[i], (16, 16), (64, 64), sigma)
                np.testing.assert_allclose(t[i], tn, atol=1e-5)
                assert np.array_equal(w[i], wn[:, 0])


def test_a_failed_native_build_raises(tmp_path, monkeypatch):
    """No compiler: an error that says so, not a slower path."""
    monkeypatch.setattr(tnative, "_LIB", None)
    monkeypatch.setenv("EDGECAPE_TORCH_BUILD_DIR", str(tmp_path / "none"))
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.delenv("CXX", raising=False)
    with pytest.raises(RuntimeError, match="compiler"):
        tnative.warp_uint8_batch([np.zeros((4, 4, 3), np.uint8)],
                                 np.eye(2, 3, dtype=np.float32)[None], (4, 4))
    # a compiler that fails: the compiler's message is raised
    bad = tmp_path / "g++"
    bad.write_text("#!/bin/sh\necho cannot compile >&2\nexit 1\n")
    bad.chmod(0o755)
    with pytest.raises(RuntimeError, match="cannot compile"):
        tnative.build()


# ------------------------------------------------------- affine, warp
def test_affine_functions_equal():
    rng = np.random.default_rng(2)
    for _ in range(6):
        x, y, w, h = rng.uniform(5, 200, 4)
        ct, st = taffine.xywh2cs(x, y, w, h, image_size=(64, 48))
        cj, sj = jaffine.xywh2cs(x, y, w, h, image_size=(64, 48))
        assert np.array_equal(ct, cj) and np.array_equal(st, sj)
        rot = float(rng.uniform(-40, 40))
        for inv in (False, True):
            assert np.array_equal(
                taffine.get_affine_transform(ct, st, rot, (64, 48), inv=inv),
                jaffine.get_affine_transform(cj, sj, rot, (64, 48), inv=inv))
        mt = taffine.get_warp_matrix_udp(rot, ct, (63.0, 47.0), st * 200.0)
        assert np.array_equal(mt, jaffine.get_warp_matrix_udp(
            rot, cj, (63.0, 47.0), sj * 200.0))
        pts = rng.uniform(0, 200, (9, 2))
        assert np.array_equal(taffine.affine_transform_points(pts, mt),
                              jaffine.affine_transform_points(pts, mt))
        assert np.array_equal(twarp.invert_affine(mt), jwarp.invert_affine(mt))
        for udp in (False, True):
            assert np.array_equal(
                taffine.transform_preds(pts, ct, st, (64, 48), use_udp=udp),
                jaffine.transform_preds(pts, cj, sj, (64, 48), use_udp=udp))
    assert np.array_equal(twarp.IMAGENET_MEAN, jwarp.IMAGENET_MEAN)
    assert np.array_equal(twarp.IMAGENET_STD, jwarp.IMAGENET_STD)


@pytest.mark.parametrize("normalize", [True, False])
def test_warp_affine_batch_matches_jax(normalize):
    rng = np.random.default_rng(3)
    imgs = rng.integers(0, 256, (3, 40, 52, 3), dtype=np.uint8)
    invs = np.stack([twarp.invert_affine(taffine.get_affine_transform(
        np.array([26.0, 20.0], np.float32),
        np.array([0.3, 0.3], np.float32), float(r), (32, 24)))
        for r in (0.0, 17.0, -33.0)]).astype(np.float32)
    ref = np.asarray(jwarp.warp_affine_batch(imgs, invs, (24, 32),
                                             normalize=normalize))
    out = twarp.warp_affine_batch(torch.from_numpy(imgs),
                                  torch.from_numpy(invs), (24, 32),
                                  normalize=normalize).numpy()
    # fp32 on both sides; the products are summed in another order
    np.testing.assert_allclose(out, ref, atol=2e-3 if not normalize else 2e-5)


@pytest.mark.parametrize("name", ["render_msra", "render_udp",
                                  "render_msra_unbiased"])
@pytest.mark.parametrize("sigma", [1.0, 1.5])
def test_host_heatmap_renderers_equal(name, sigma):
    rng = np.random.default_rng(4)
    joints = rng.uniform(-20, 90, (12, 2)).astype(np.float32)
    vis = (rng.uniform(size=12) > 0.2).astype(np.float32)
    t, w = getattr(theat, name + "_np")(joints, vis, (16, 20), (64, 80),
                                        sigma)
    tj, wj = getattr(jheat, name)(joints, vis, (16, 20), (64, 80), sigma)
    assert t.dtype == tj.dtype and np.array_equal(w, wj)
    np.testing.assert_allclose(t, tj, atol=1e-5)


# ------------------------------------------------- metrics, tb writer
def test_eval_metrics_equal():
    rng = np.random.default_rng(5)
    pred = rng.uniform(0, 100, (6, 9, 2)).astype(np.float32)
    gt = pred + rng.normal(size=pred.shape).astype(np.float32) * 8
    mask = rng.uniform(size=(6, 9)) > 0.2
    mask[2] = False
    thr = np.tile(rng.uniform(20, 80, (6, 1)).astype(np.float32), (1, 2))
    a = tmetrics.pck_accuracy(pred, gt, mask, 0.2, thr)
    b = jmetrics.pck_accuracy(pred, gt, mask, 0.2, thr)
    assert np.array_equal(a[0], b[0]) and a[1:] == b[1:]
    assert tmetrics.nme(pred, gt, mask, thr) == jmetrics.nme(pred, gt, mask,
                                                             thr)
    assert tmetrics.auc(pred, gt, mask, 50.0) == jmetrics.auc(pred, gt, mask,
                                                              50.0)
    assert tmetrics.epe(pred, gt, mask) == jmetrics.epe(pred, gt, mask)


def test_compute_metrics_vectorised_oracle_and_pckh(root):
    from edgecape_tpu.eval import runner as jrunner
    from edgecape_tpu_torch.eval import runner as trunner
    dt, dj = _pair(root, "test")
    rng = np.random.default_rng(6)
    records = []
    for i, pair in enumerate(dt.paired_samples):
        gt = dt.db[pair[-1]]["joints_3d"][:, :2]
        kp = np.concatenate([gt + rng.normal(size=gt.shape) * 6,
                             np.ones((len(gt), 1))], axis=1)
        records.append({"keypoints": kp.tolist(), "bbox_id": i})
    names = ("PCK", "NME", "AUC", "EPE")
    got = trunner.compute_metrics(dt, records, names)
    oracle = trunner.compute_metrics_reference(dt, records, names)
    ref = jrunner.compute_metrics(dj, records, names)
    assert list(got) == list(ref) == list(oracle)
    for k in ref:
        assert got[k] == pytest.approx(ref[k], abs=1e-12), k
        assert oracle[k] == pytest.approx(ref[k], abs=1e-6), k
    with pytest.warns(RuntimeWarning):
        assert "PCKh" not in trunner.compute_metrics(dt, records, ("PCKh",))
    for ds in (dt, dj):
        for rec in ds.db:
            rec["head_size"] = 30.0
    a = trunner.compute_metrics(dt, records, ("PCK", "PCKh"))
    b = jrunner.compute_metrics(dj, records, ("PCK", "PCKh"))
    assert list(a) == list(b) and all(
        a[k] == pytest.approx(b[k], abs=1e-12) for k in a)


def test_tensorboard_files_byte_equal(tmp_path, monkeypatch):
    import time
    monkeypatch.setattr(time, "time", lambda: 1700000000.25)
    paths = []
    for mod, name in ((ttb, "t"), (jtb, "j")):
        w = mod.SummaryWriter(str(tmp_path / name))
        for step in range(5):
            w.add_scalar("train/loss", 1.0 / (step + 1), step)
            w.add_scalar("val/PCK", 0.1 * step, step)
        w.close()
        files = glob.glob(str(tmp_path / name / "events.*"))
        assert len(files) == 1
        paths.append(files[0])
    assert os.path.basename(paths[0]) == os.path.basename(paths[1])
    assert open(paths[0], "rb").read() == open(paths[1], "rb").read()
    scalars = ttb.read_scalars(paths[0])
    assert scalars == jtb.read_scalars(paths[1]) and len(scalars) == 10
    assert scalars[0][0] == "train/loss" and scalars[0][2] == 0


# --------------------------------------------------------------- config
def _cfg_dict(cfg):
    return json.loads(json.dumps(dataclasses.asdict(cfg), default=str))


GRID = [f"{part}/{shots}shot_split{split}.py" for part in ("train", "test")
        for shots in (1, 5) for split in range(1, 6)]


@pytest.mark.parametrize("name", GRID)
def test_port_config_equals_its_jax_namesake(name):
    t = tcfg.Config.from_file(os.path.join(REPO, "edgecape_tpu_torch",
                                           "configs", name))
    j = jcfg.Config.from_file(os.path.join(REPO, "configs", name))
    assert isinstance(t, tcfg.Config) and isinstance(j, jcfg.Config)
    assert _cfg_dict(t) == _cfg_dict(j)


def test_synthetic_config_equals_its_jax_namesake(tmp_path, monkeypatch):
    roots = {}
    for key, mod, path in (("t", tcfg, "edgecape_tpu_torch/configs"),
                           ("j", jcfg, "configs")):
        roots[key] = str(tmp_path / key)
        monkeypatch.setenv("SYNTH_ROOT", roots[key])
        roots[key + "cfg"] = mod.Config.from_file(
            os.path.join(REPO, path, "synthetic.py"))
    t, j = _cfg_dict(roots["tcfg"]), _cfg_dict(roots["jcfg"])
    for part in ("train_data", "val_data", "test_data"):
        for key in ("ann_file", "img_prefix"):
            assert os.path.relpath(t[part].pop(key), roots["t"]) == \
                os.path.relpath(j[part].pop(key), roots["j"])
    assert t == j
    assert os.path.exists(roots["tcfg"].test_data.ann_file)
    assert glob.glob(os.path.join(roots["t"], "images", "*.ppm"))


def test_config_defaults_and_stage_configs_equal():
    assert _cfg_dict(tcfg.Config()) == _cfg_dict(jcfg.Config())
    for fn in ("stage2_config", "stage3_config"):
        assert _cfg_dict(getattr(tcfg, fn)(tcfg.Config())) == \
            _cfg_dict(getattr(jcfg, fn)(jcfg.Config()))
    assert _cfg_dict(tcfg.stage2_config(tcfg.Config(), 0.3, 2.0)) == \
        _cfg_dict(jcfg.stage2_config(jcfg.Config(), 0.3, 2.0))
    # replace / asdict keep working on the JAX dataclasses
    j = tcfg.replace(jcfg.Config(), work_dir="x")
    assert isinstance(j, jcfg.Config) and j.work_dir == "x"
    assert tcfg.asdict(jcfg.Config()) == dataclasses.asdict(jcfg.Config())


OVERRIDES = [["model.use_flash=false"], ["model.use_flash=None"],
             ["model.use_flash=true", "train.lr=3"],
             ["train_data.use_udp=True", "model.max_kpt=17"],
             ["work_dir=out/x", "train.lr_step=[1, 2]"],
             ["model.model_freeze=skeleton", "train.grad_clip=0.5"]]


@pytest.mark.parametrize("opts", OVERRIDES, ids=lambda o: ",".join(o))
def test_override_coercion_equals(opts):
    assert _cfg_dict(tcfg.Config().override(opts)) == \
        _cfg_dict(jcfg.Config().override(opts))


@pytest.mark.parametrize("opt,err", [("model.use_flash=maybe", ValueError),
                                     ("train_data.use_udp=1", ValueError),
                                     ("model.max_kpt=abc", ValueError),
                                     ("train.lr=fast", ValueError),
                                     ("model.nope=1", KeyError)])
def test_override_refuses_what_the_jax_config_refuses(opt, err):
    for mod in (tcfg, jcfg):
        with pytest.raises(err):
            mod.Config().override([opt])


def test_config_dump_equals(tmp_path):
    cfg_t = tcfg.stage3_config(tcfg.Config()).override(["train.lr=2e-5"])
    cfg_j = jcfg.stage3_config(jcfg.Config()).override(["train.lr=2e-5"])
    cfg_t.dump(str(tmp_path / "t.json"))
    cfg_j.dump(str(tmp_path / "j.json"))
    assert open(tmp_path / "t.json").read() == open(tmp_path / "j.json").read()


# --------------------------------------------------------- load_backbone
def _hub_state(rng, cfg, grid):
    c, p = cfg.embed_dim, cfg.patch_size
    hidden = int(c * cfg.mlp_ratio)

    def a(*shape):
        return rng.normal(size=shape).astype(np.float32) * 0.1

    sd = {"cls_token": a(1, 1, c), "pos_embed": a(1, grid * grid + 1, c),
          "mask_token": a(1, c),
          "patch_embed.proj.weight": a(c, 3, p, p),
          "patch_embed.proj.bias": a(c), "norm.weight": a(c),
          "norm.bias": a(c)}
    for i in range(cfg.depth):
        b = f"blocks.{i}."
        for name, (o, n) in {"attn.qkv": (3 * c, c), "attn.proj": (c, c),
                             "mlp.fc1": (hidden, c),
                             "mlp.fc2": (c, hidden)}.items():
            sd[b + name + ".weight"], sd[b + name + ".bias"] = a(o, n), a(o)
        for name in ("norm1", "norm2"):
            sd[b + name + ".weight"], sd[b + name + ".bias"] = a(c), a(c)
        sd[b + "ls1.gamma"], sd[b + "ls2.gamma"] = a(c), a(c)
    return sd


@pytest.mark.parametrize("image_size", [70, 42])
def test_load_backbone_from_a_hub_state_dict(tmp_path, image_size):
    import jax
    from edgecape_tpu.models import dinov2 as jdino
    from edgecape_tpu_torch.models import convert, dinov2 as tdino
    kw = dict(depth=2, embed_dim=32, num_heads=2, pretrain_grid=5)
    sd = _hub_state(np.random.default_rng(7), tdino.DinoV2Config(**kw), 5)
    path = str(tmp_path / "hub.pth")
    torch.save({k: torch.from_numpy(v) for k, v in sd.items()}, path)
    got = convert.load_backbone(path, image_size, tdino.DinoV2Config(**kw))
    flax = jdino.convert_torch_state_dict(sd, image_size=image_size,
                                          cfg=jdino.DinoV2Config(**kw))
    want, _ = convert.from_jax_params(jax.tree.map(np.asarray, flax), {})
    assert set(got) == set(want)
    for k in want:
        assert torch.equal(got[k], want[k]), k
    vit = tdino.DinoViT(tdino.DinoV2Config(**kw), image_size)
    vit.load_state_dict(got)                # strict
    # the port's own files: a bare state dict, or one under "backbone"
    for wrap, name in ((lambda s: s, "a.pt"),
                       (lambda s: {"backbone": s}, "b.pt")):
        torch.save(wrap(got), str(tmp_path / name))
        again = convert.load_backbone(str(tmp_path / name), image_size)
        assert all(torch.equal(again[k], got[k]) for k in got)
    assert convert.load_backbone(None, image_size) is None
    torch.save({"x": torch.zeros(1)}, str(tmp_path / "bad.pt"))
    with pytest.raises(ValueError):
        convert.load_backbone(str(tmp_path / "bad.pt"), image_size)
