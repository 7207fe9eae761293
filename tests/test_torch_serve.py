"""The port's inference server (edgecape_tpu_torch/cli/serve.py) against
serve.py on the CPU, and its HTTP contract.

Both services are built once for the module at 56 px, K = 16, fp32 (the
plain path on both sides): the JAX service draws its weights, whose
zero-initialised parts are redrawn (test_torch_slice._perturb), and the
port's service takes them through convert.from_jax_params. The same PNG and
PPM requests go to both. Request images are chosen so that the two
resizes agree bit for bit (the port's bilinear resize matches cv2's to
within one intensity level, tests/test_torch_demo.py): a square-padded
56-pixel image is not resized, and a 2x2-block image of twice the size is
halved by averaging equal values. Bounds: 1e-4 on normalised keypoints and
1e-5 on edge weights, the eval bounds of ROADMAP.md's North star."""

import base64
import http.client
import json
import threading
from http.server import ThreadingHTTPServer

import jax
import numpy as np
import pytest
import torch

import serve
import torch_threads  # caps torch's threads per worker; waits
from edgecape_tpu_torch.cli import serve as tserve
from edgecape_tpu_torch.models.convert import from_jax_params
from edgecape_tpu_torch.train import checkpoint as tck
from test_torch_slice import _perturb

cv2 = pytest.importorskip("cv2")

SIZE, KPT = 56, 16
COORD_TOL, EDGE_TOL = 1e-4, 1e-5


@pytest.fixture(scope="module")
def services():
    """(JAX service, port service, port head state)."""
    jsvc = serve.PoseService(size=SIZE, max_kpt=KPT)
    bb, head = _perturb(jsvc.est.backbone_params, jsvc.est.head_params)
    jsvc.est.backbone_params = jax.tree.map(jax.numpy.asarray, bb)
    jsvc.est.head_params = jax.tree.map(jax.numpy.asarray, head)
    bb_sd, head_sd = from_jax_params(bb, head)
    tsvc = tserve.PoseService(size=SIZE, max_kpt=KPT, device="cpu",
                              backbone_state=bb_sd, head_state=head_sd)
    return jsvc, tsvc, head_sd


def _image(seed, big=False):
    """(RGB uint8 image, its scale to the model input): 56 x 40, or the
    same with every pixel a 2 x 2 block (112 x 80, scale 0.5)."""
    img = np.random.default_rng(seed).integers(0, 256, (SIZE, 40, 3),
                                               dtype=np.uint8)
    if big:
        return np.repeat(np.repeat(img, 2, axis=0), 2, axis=1), 0.5
    return img, 1.0


def _b64(img, ext=".png"):
    ok, buf = cv2.imencode(ext, img[..., ::-1])     # cv2 writes BGR
    assert ok
    return base64.b64encode(buf.tobytes()).decode()


def _support_payload(shots, seed=0, k=10):
    rng = np.random.default_rng(100 + seed)
    kpts = rng.uniform(2, 38, (k, 2)).round(1)
    imgs = [_b64(_image(seed + i, big=i % 2 == 1)[0], (".png", ".ppm")[i % 2])
            for i in range(shots)]
    return {"images": imgs, "keypoints": kpts.tolist(),
            "skeleton": [[i, i + 1] for i in range(k - 1)] + [[0, k - 1]]}


def _norm_kpts(out, scale):
    """keypoints in original pixels -> normalised model coordinates."""
    return np.asarray(out["keypoints"], np.float64)[:, :2] * scale / SIZE


@pytest.mark.parametrize("shots", [1, 2])
def test_port_service_answers_as_serve(services, shots):
    """/support, /predict (PNG and PPM queries, both sizes) and
    /predict_batch give the JAX service's keypoints and edge weights."""
    jsvc, tsvc, _ = services
    sup = _support_payload(shots, seed=shots)
    jcid, tcid = jsvc.register_support(sup), tsvc.register_support(sup)
    queries = [(_image(20 + i, big=i % 2 == 0), (".ppm", ".png")[i % 2])
               for i in range(3)]
    for (img, scale), ext in queries:
        payload = {"image": _b64(img, ext)}
        jout = jsvc.predict(dict(payload, context_id=jcid))
        tout = tsvc.predict(dict(payload, context_id=tcid))
        assert len(tout["keypoints"]) == 10
        np.testing.assert_allclose(_norm_kpts(tout, scale),
                                   _norm_kpts(jout, scale), atol=COORD_TOL,
                                   rtol=0)
        np.testing.assert_allclose(np.asarray(tout["edge_weights"]),
                                   np.asarray(jout["edge_weights"]),
                                   atol=EDGE_TOL, rtol=0)
    batch = [_b64(img, ext) for (img, _), ext in queries]
    jout = jsvc.predict_batch({"context_id": jcid, "images": batch})
    tout = tsvc.predict_batch({"context_id": tcid, "images": batch})
    assert len(tout["results"]) == 3
    for (_, scale), jr, tr in zip([q for q, _ in queries], jout["results"],
                                  tout["results"]):
        np.testing.assert_allclose(_norm_kpts(tr, scale),
                                   _norm_kpts(jr, scale), atol=COORD_TOL,
                                   rtol=0)
    np.testing.assert_allclose(np.asarray(tout["edge_weights"]),
                               np.asarray(jout["edge_weights"]),
                               atol=EDGE_TOL, rtol=0)


# ------------------------------------------------------------ HTTP
@pytest.fixture(scope="module")
def server(services):
    _, tsvc, _ = services
    tsvc.enable_batching(window_s=0.05)
    httpd = ThreadingHTTPServer(("127.0.0.1", 0), tserve.make_handler(tsvc))
    t = threading.Thread(target=httpd.serve_forever, daemon=True)
    t.start()
    yield httpd.server_address
    httpd.shutdown()
    httpd.server_close()
    tsvc.batcher.stop()
    tsvc.batcher = None


def _post(addr, path, payload):
    conn = http.client.HTTPConnection(*addr, timeout=60)
    conn.request("POST", path, json.dumps(payload),
                 {"Content-Type": "application/json"})
    resp = conn.getresponse()
    return resp.status, json.loads(resp.read())


def _get(addr, path):
    conn = http.client.HTTPConnection(*addr, timeout=30)
    conn.request("GET", path)
    resp = conn.getresponse()
    return resp.status, resp.read()


def test_healthz_index_and_unknown_routes(server):
    status, body = _get(server, "/healthz")
    out = json.loads(body)
    assert status == 200 and out["ok"] is True
    assert {"dispatches", "queries", "max_batch"} <= set(out["stats"])
    status, body = _get(server, "/")
    page = body.decode()
    assert status == 200
    for needle in ("predictBtn", "/support", "/predict", "skeleton"):
        assert needle in page, needle
    assert _get(server, "/nope")[0] == 404
    assert _post(server, "/nope", {})[0] == 404


def test_unknown_context_and_bad_image_are_400(server):
    status, out = _post(server, "/predict",
                        {"context_id": "nope",
                         "image": _b64(_image(2)[0])})
    assert status == 400 and "unknown context_id" in out["error"]
    status, out = _post(server, "/support", {
        "images": [base64.b64encode(b"P6 12").decode()],
        "keypoints": [[1, 2]]})
    assert status == 400 and "PPM" in out["error"]


def test_concurrent_predicts_coalesce_and_match_batch(server, services):
    """Concurrent /predict calls share dispatches and answer as
    /predict_batch does for the same images (no row-position
    dependence)."""
    _, tsvc, _ = services
    status, out = _post(server, "/support", _support_payload(1, seed=5))
    assert status == 200, out
    cid = out["context_id"]
    imgs = [_b64(_image(40 + i)[0]) for i in range(4)]
    status, batch = _post(server, "/predict_batch",
                          {"context_id": cid, "images": imgs})
    assert status == 200, batch
    before = dict(tsvc.stats)
    results = {}

    def hit(i):
        results[i] = _post(server, "/predict",
                           {"context_id": cid, "image": imgs[i]})

    threads = [threading.Thread(target=hit, args=(i,), daemon=True)
               for i in range(4)]
    for t in threads:
        t.start()
    torch_threads.join_threads(threads, "four /predict clients", 60)
    for i in range(4):
        status, pred = results[i]
        assert status == 200, pred
        np.testing.assert_allclose(pred["keypoints"],
                                   batch["results"][i]["keypoints"],
                                   atol=COORD_TOL * SIZE, rtol=0)
    assert tsvc.stats["queries"] - before["queries"] == 4
    assert tsvc.stats["dispatches"] - before["dispatches"] < 4


def test_reload_swaps_the_head_and_drops_contexts(server, services,
                                                  tmp_path):
    """POST /reload: contexts dropped, old ids 400, answers those of a
    service built with the new weights; a checkpoint of another
    structure is a 400 and changes nothing."""
    _, tsvc, head_sd = services
    sup = _support_payload(1, seed=7)
    status, out = _post(server, "/support", sup)
    assert status == 200, out
    old_cid = out["context_id"]
    query = _b64(_image(50)[0])
    status, pred_old = _post(server, "/predict",
                             {"context_id": old_cid, "image": query})
    assert status == 200, pred_old

    g = torch.Generator().manual_seed(3)
    other = {k: v * 1.5 + 0.01 * torch.randn(v.shape, generator=g)
             for k, v in head_sd.items()}
    tck.save_checkpoint(str(tmp_path / "swap"), {"model": other})
    tck.save_checkpoint(str(tmp_path / "orig"), {"model": head_sd})
    gen = tsvc.generation
    status, out = _post(server, "/reload",
                        {"checkpoint": str(tmp_path / "swap")})
    assert status == 200, out
    assert out["ok"] and out["contexts_dropped"] >= 1
    assert tsvc.generation == gen + 1 and not tsvc.contexts
    status, out = _post(server, "/predict",
                        {"context_id": old_cid, "image": query})
    assert status == 400

    status, out = _post(server, "/support", sup)
    assert status == 200, out
    status, pred_new = _post(server, "/predict",
                             {"context_id": out["context_id"],
                              "image": query})
    assert status == 200, pred_new
    assert not np.allclose(pred_new["keypoints"], pred_old["keypoints"],
                           atol=1e-3)
    fresh = tserve.PoseService(size=SIZE, max_kpt=KPT, device="cpu",
                               backbone_state=tsvc.est.backbone.state_dict(),
                               head_state=other)
    ref = fresh.predict({"context_id": fresh.register_support(sup),
                         "image": query})
    np.testing.assert_allclose(pred_new["keypoints"], ref["keypoints"],
                               atol=COORD_TOL * SIZE, rtol=0)

    tck.save_checkpoint(str(tmp_path / "bogus"),
                        {"model": {"x": torch.zeros(3)}})
    head = tsvc.est.head
    status, out = _post(server, "/reload",
                        {"checkpoint": str(tmp_path / "bogus")})
    assert status == 400 and "does not match" in out["error"]
    assert tsvc.est.head is head
    status, out = _post(server, "/reload",
                        {"checkpoint": str(tmp_path / "orig")})
    assert status == 200, out


def test_reload_during_register_support_is_rejected(services):
    """A /reload landing between the support computation and the
    context's insert leaves no stale-generation context behind."""
    _, tsvc, _ = services
    real = tsvc.est.support_context

    def racing(*args, **kw):
        ctx = real(*args, **kw)
        with tsvc.lock:             # a concurrent /reload's commit
            tsvc.generation += 1
            tsvc.contexts.clear()
        return ctx

    tsvc.est.support_context = racing
    try:
        with pytest.raises(RuntimeError, match="reloaded during"):
            tsvc.register_support(_support_payload(1, seed=9, k=2))
        assert len(tsvc.contexts) == 0
    finally:
        del tsvc.est.support_context
    assert tsvc.register_support(_support_payload(1, seed=9, k=2)) in \
        tsvc.contexts
