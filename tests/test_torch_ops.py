"""The port's numerics ops and host twins against the JAX package.

Inputs are drawn with numpy from a seed and fed to both. Tolerances:
host numpy twins are exact (the same float64/float32 arithmetic); fp32
device ops 1e-5 (absolute, on values of order 1; the two frameworks may
order sums and pick transcendental implementations differently)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import torch_threads  # noqa: F401  (caps torch's threads per worker)
from edgecape_tpu.models import head as jhead
from edgecape_tpu.ops import affine as jaffine
from edgecape_tpu.ops import graph as jgraph
from edgecape_tpu.ops import heatmap as jheatmap
from edgecape_tpu.ops import pos_enc as jpos
from edgecape_tpu.ops import softargmax as jsoft
from edgecape_tpu.ops import warp as jwarp
from edgecape_tpu_torch import api
from edgecape_tpu_torch.models import head as thead
from edgecape_tpu_torch.ops import affine as taffine
from edgecape_tpu_torch.ops import graph as tgraph
from edgecape_tpu_torch.ops import heatmap as theatmap
from edgecape_tpu_torch.ops import pos_enc as tpos
from edgecape_tpu_torch.ops import softargmax as tsoft

FP32_TOL = 1e-5


def _close(t, j, tol=FP32_TOL):
    np.testing.assert_allclose(t.detach().numpy(), np.asarray(j),
                               atol=tol, rtol=0)


def test_pos_enc_matches_jax():
    rng = np.random.default_rng(0)
    _close(tpos.sine_grid(5, 7, 16), jpos.sine_grid(5, 7, 16))
    coords = rng.uniform(-0.1, 1.1, size=(3, 12, 2)).astype(np.float32)
    _close(tpos.sine_coords(torch.from_numpy(coords), 64),
           jpos.sine_coords(jnp.asarray(coords), 64))
    _close(tpos.inverse_sigmoid(torch.from_numpy(coords)),
           jpos.inverse_sigmoid(jnp.asarray(coords)))


def test_graph_ops_match_jax():
    rng = np.random.default_rng(1)
    k = 9
    binary = (rng.uniform(size=(3, k, k)) > 0.6).astype(np.float32)
    binary = np.maximum(binary, binary.transpose(0, 2, 1))
    invalid = rng.uniform(size=(3, k)) > 0.7
    soft = rng.uniform(size=(3, k, k)).astype(np.float32)
    tb, ti, ts = map(torch.from_numpy, (binary, invalid, soft))
    _close(tgraph.normalize_adjacency(tb, ti),
           jgraph.normalize_adjacency(jnp.asarray(binary),
                                      jnp.asarray(invalid)))
    for normalize in (True, False):
        _close(tgraph.soft_normalize_adjacency(ts, ti, normalize=normalize),
               jgraph.soft_normalize_adjacency(
                   jnp.asarray(soft), jnp.asarray(invalid),
                   normalize=normalize))
    _close(tgraph.markov_hop_stack(ts, 4),
           jgraph.markov_hop_stack(jnp.asarray(soft), 4))
    assert tgraph.markov_hop_stack(ts.to(torch.bfloat16), 2).dtype == \
        torch.float32


def test_adjacency_from_edges_twin_is_bit_equal():
    for edges, k in [([[0, 1], [1, 2], [5, 3]], 6), ([], 4),
                     ([[0, 7], [2, 2], [9, 1]], 8)]:
        np.testing.assert_array_equal(tgraph.adjacency_from_edges(edges, k),
                                      jgraph.adjacency_from_edges(edges, k))


def test_softargmax_matches_jax():
    rng = np.random.default_rng(2)
    sim = (rng.normal(size=(2, 5, 6 * 7)) * 3).astype(np.float32)
    _close(tsoft.global_soft_argmax(torch.from_numpy(sim), 6, 7),
           jsoft.global_soft_argmax(jnp.asarray(sim), 6, 7))
    _close(tsoft.local_soft_argmax(torch.from_numpy(sim), 6, 7),
           jsoft.local_soft_argmax(jnp.asarray(sim), 6, 7))
    # argmax on the border: the 3x3 window is clipped
    sim[0, 0, :] = 0.0
    sim[0, 0, 0] = 9.0
    _close(tsoft.local_soft_argmax(torch.from_numpy(sim), 6, 7),
           jsoft.local_soft_argmax(jnp.asarray(sim), 6, 7))


@pytest.mark.parametrize("name", ["msra", "msra_unbiased", "udp"])
@pytest.mark.parametrize("sigma", [1.0, 1.5])
def test_heatmap_render_matches_jax(name, sigma):
    rng = np.random.default_rng(3)
    joints = rng.uniform(-10, 66, size=(2, 1, 7, 2)).astype(np.float32)
    vis = (rng.uniform(size=(2, 1, 7)) > 0.2).astype(np.float32)
    tfn = getattr(theatmap, f"render_{name}")
    jfn = getattr(jheatmap, f"render_{name}_jnp")
    tt, tw = tfn(torch.from_numpy(joints), torch.from_numpy(vis), (16, 16),
                 (56.0, 56.0), sigma)
    jt, jw = jfn(jnp.asarray(joints), jnp.asarray(vis), (16, 16),
                 (56.0, 56.0), sigma)
    _close(tt, jt)
    np.testing.assert_array_equal(tw.numpy(), np.asarray(jw))


def test_imagenet_normalize_matches_jax():
    from edgecape_tpu.api import _maybe_normalize
    np.testing.assert_array_equal(api.IMAGENET_MEAN, jwarp.IMAGENET_MEAN)
    np.testing.assert_array_equal(api.IMAGENET_STD, jwarp.IMAGENET_STD)
    img = np.random.default_rng(4).integers(0, 256, (2, 5, 5, 3),
                                             dtype=np.uint8)
    _close(api.maybe_normalize(torch.from_numpy(img)),
           _maybe_normalize(jnp.asarray(img)), tol=1e-6)
    normalized = torch.ones((1, 2, 2, 3))
    assert api.maybe_normalize(normalized) is normalized


@pytest.mark.parametrize("use_udp", [False, True])
def test_transform_preds_batch_twin_is_bit_equal(use_udp):
    rng = np.random.default_rng(5)
    coords = rng.uniform(0, 56, size=(4, 9, 2)).astype(np.float32)
    centers = rng.uniform(50, 150, size=(4, 2)).astype(np.float32)
    scales = rng.uniform(0.2, 1.5, size=(4, 2)).astype(np.float32)
    np.testing.assert_array_equal(
        taffine.transform_preds_batch(coords, centers, scales, (56, 56),
                                      use_udp=use_udp),
        jaffine.transform_preds_batch(coords, centers, scales, (56, 56),
                                      use_udp=use_udp))


@pytest.mark.parametrize("src,dst", [(16, 64), (4, 16), (2, 8), (3, 7)])
def test_bilinear_matrix_equals_jax_resize(src, dst):
    np.testing.assert_array_equal(thead.bilinear_matrix(src, dst),
                                  np.asarray(jhead._bilinear_matrix(src, dst)))


def test_pool_support_keypoints_matches_jax():
    rng = np.random.default_rng(6)
    feats = rng.normal(size=(2, 1, 4, 4, 8)).astype(np.float32)
    hms = rng.uniform(size=(2, 1, 5, 16, 16)).astype(np.float32)
    _close(thead.pool_support_keypoints(torch.from_numpy(feats),
                                        torch.from_numpy(hms)),
           jhead.pool_support_keypoints(jnp.asarray(feats),
                                        jnp.asarray(hms)))
