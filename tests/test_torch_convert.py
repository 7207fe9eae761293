"""The port's reference-checkpoint converters (models/convert.py
convert_head / convert_full, tools/convert_checkpoint.py) against the JAX
package's.

A head of the JAX package's parameter tree at each curriculum stage of
tests/test_convert.py (the shapes of its init_model, seeded random
values) is written out in the reference's state-dict
naming by that test's `_to_reference_sd` (with a full-size random
torch-hub DINOv2 under `encoder_query.*` for convert_full); the port's
converters must give exactly what the JAX converters give, mapped by the
port's `from_jax_params`, and a state dict the port's EdgeCape loads
strictly. Then `tools.convert_checkpoint ref2torch` writes the files that
`cli.test --device cpu` evaluates.
"""

import os

import numpy as np
import pytest
import torch

import jax
from test_convert import _to_reference_sd

from edgecape_tpu.config import ModelConfig as JModelConfig
from edgecape_tpu.models import convert as jconvert
from edgecape_tpu.models.edgecape import init_model
from edgecape_tpu_torch import config as tconfig
from edgecape_tpu_torch.models import convert as tconvert
from edgecape_tpu_torch.models.dinov2 import VIT_S14
from edgecape_tpu_torch.models.edgecape import EdgeCape

STAGES = [dict(),
          dict(learn_skeleton=True, masked_supervision=True),
          dict(learn_skeleton=True, attn_bias=True,
               use_bias_attn_module=True)]
SIZE = 56


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    """Two torch threads while this file runs: the suite runs several
    files at once, and each worker's thread pool would take every core."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _hub_state(rng) -> dict:
    """A torch-hub DINOv2 ViT-S/14 state dict of seeded random values
    (pretraining grid 37 x 37)."""
    c, p, g = VIT_S14.embed_dim, VIT_S14.patch_size, VIT_S14.pretrain_grid
    hidden = 4 * c

    def a(*shape):
        return rng.standard_normal(shape, dtype=np.float32) * 0.02

    sd = {"cls_token": a(1, 1, c), "pos_embed": a(1, 1 + g * g, c),
          "patch_embed.proj.weight": a(c, 3, p, p),
          "patch_embed.proj.bias": a(c), "norm.weight": a(c),
          "norm.bias": a(c)}
    for i in range(VIT_S14.depth):
        b = f"blocks.{i}."
        for name, (o, n) in {"attn.qkv": (3 * c, c), "attn.proj": (c, c),
                             "mlp.fc1": (hidden, c),
                             "mlp.fc2": (c, hidden)}.items():
            sd[b + name + ".weight"], sd[b + name + ".bias"] = a(o, n), a(o)
        for name in ("norm1", "norm2"):
            sd[b + name + ".weight"], sd[b + name + ".bias"] = a(c), a(c)
        sd[b + "ls1.gamma"], sd[b + "ls2.gamma"] = a(c), a(c)
    return sd


@pytest.fixture(scope="module")
def reference():
    """Per stage: (JAX ModelConfig, the port's ModelConfig, the
    reference-named head state dict); and the hub trunk."""
    out = []
    rng = np.random.default_rng(0)
    # init_model's tree of stage 2 is stage 3's without the decoder layers'
    # bias MLPs, and stage 1's that without the skeleton branch
    stage3 = jax.eval_shape(lambda: init_model(
        jax.random.PRNGKey(0), JModelConfig(max_kpt=12, image_size=SIZE,
                                            heatmap_size=16, **STAGES[2]))[1])
    trees = [stage3]
    for drop in ("bias_mlp", "skeleton"):
        trees.insert(0, _without(trees[0], drop))
    for kw, shapes in zip(STAGES, trees):
        jcfg = JModelConfig(max_kpt=12, image_size=SIZE, heatmap_size=16,
                            **kw)
        params = jax.tree.map(lambda a: rng.standard_normal(
            a.shape, dtype=np.float32), shapes)
        sd = _to_reference_sd(params, jcfg)
        tcfg = tconfig.ModelConfig(max_kpt=12, image_size=SIZE,
                                   heatmap_size=16, **kw)
        out.append((jcfg, tcfg, sd))
    return out, _hub_state(np.random.default_rng(5))


def _without(tree, key):
    """tree without the subtrees named `key`, at any depth."""
    return {k: _without(v, key) if isinstance(v, dict) else v
            for k, v in tree.items() if k != key}


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _assert_equal(got: dict, want: dict):
    assert set(got) == set(want), set(got) ^ set(want)
    for k in want:
        assert got[k].dtype == want[k].dtype and torch.equal(got[k],
                                                             want[k]), k


@pytest.mark.parametrize("stage", [0, 1, 2])
def test_convert_head_matches_jax(reference, stage):
    jcfg, tcfg, sd = reference[0][stage]
    got = tconvert.convert_head(sd, tcfg)
    _, want = tconvert.from_jax_params({}, _np_tree(
        jconvert.convert_head(sd, jcfg)))
    _assert_equal(got, want)
    EdgeCape(tcfg).load_state_dict(got)                   # strict


@pytest.mark.parametrize("stage", [0, 1, 2])
def test_convert_full_matches_jax(reference, stage):
    (jcfg, tcfg, sd), hub = reference[0][stage], reference[1]
    full = {"state_dict": {**sd, **{"encoder_query." + k: v
                                    for k, v in hub.items()}}}
    j_head, j_bb = jconvert.convert_full(full, jcfg, image_size=SIZE)
    bb, head = tconvert.convert_full(full, tcfg, image_size=SIZE)
    want_bb, want_head = tconvert.from_jax_params(_np_tree(j_bb),
                                                  _np_tree(j_head))
    _assert_equal(head, want_head)
    _assert_equal(bb, want_bb)
    # no trunk in the checkpoint: no backbone
    assert tconvert.convert_full(sd, tcfg)[0] is None


CONFIG = '''from edgecape_tpu_torch.config import (Config, DataConfig, ModelConfig,
                                       stage3_config)
_data = DataConfig(ann_file={ann!r}, img_prefix={img!r}, num_shots=1,
                   num_queries=3, num_episodes=1, image_size=28,
                   heatmap_size=8, max_kpt=16, sigma=1.0)
config = stage3_config(Config(
    model=ModelConfig(image_size=28, heatmap_size=8, max_kpt=16),
    train_data=_data, val_data=_data, test_data=_data))
'''


def test_ref2torch_files_load_in_cli_test(reference, tmp_path):
    from edgecape_tpu_torch.cli import test as cli_test
    from edgecape_tpu_torch.data import synthetic
    from edgecape_tpu_torch.tools import convert_checkpoint
    from edgecape_tpu_torch.train import checkpoint as ck
    (_, tcfg, sd), hub = reference[0][2], reference[1]
    src = str(tmp_path / "edgecape.pth")
    torch.save({"state_dict": {k: torch.tensor(np.asarray(v)) for k, v in
                               list(sd.items()) + [("encoder_query." + k, v)
                                                   for k, v in hub.items()]},
                "meta": {"epoch": 210}}, src)
    out = str(tmp_path / "out")
    written = convert_checkpoint.main(["ref2torch", src, out, "--stage", "3",
                                       "--image-size", "28"])
    assert sorted(written) == ["backbone", "head"]
    head = ck.load_checkpoint(written["head"])["model"]
    _assert_equal(head, tconvert.convert_head(sd, tcfg))
    root = str(tmp_path / "data")
    ann = synthetic.generate(root, num_classes=2, images_per_class=5,
                             image_size=64, seed=0)
    config = str(tmp_path / "cfg.py")
    with open(config, "w") as f:
        f.write(CONFIG.format(ann=ann, img=os.path.join(root, "images")))
    res = cli_test.main([config, written["head"], "--backbone-ckpt",
                         written["backbone"], "--device", "cpu",
                         "--work-dir", str(tmp_path / "w")])
    assert np.isfinite(res["NME"]) and 0.0 <= res["PCK"] <= 1.0
    log = open(tmp_path / "w" / "testing_log.txt").read()
    assert written["head"] in log
    # the dinov2 mode: the hub trunk alone, as --backbone-ckpt reads it
    hub_src = str(tmp_path / "hub.pth")
    torch.save({k: torch.tensor(v) for k, v in hub.items()}, hub_src)
    again = convert_checkpoint.main(["dinov2", hub_src, str(tmp_path / "h"),
                                     "--image-size", "28"])
    assert sorted(again) == ["backbone"]
    _assert_equal(ck.load_checkpoint(again["backbone"]),
                  ck.load_checkpoint(written["backbone"]))
