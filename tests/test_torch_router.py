"""The port's router (edgecape_tpu_torch/cli/router.py) and router.py
through the scenarios of tests/test_router.py, every case run on both
modules: sticky routing, unknown context, failover and rejoin, rolling
reload, the HTTP surface. Replicas are that file's fakes speaking the
server's HTTP contract. The port's copy imports the standard library
alone."""

import ast
import json
import sys
import threading
import urllib.request
from http.server import ThreadingHTTPServer

import pytest

import router as jrouter
import torch_threads  # noqa: F401  (caps torch's threads per worker)
from edgecape_tpu_torch.cli import router as trouter
from test_router import FakeReplica, _post, _Revive


@pytest.fixture(params=[trouter, jrouter], ids=["port", "router.py"])
def mod(request):
    return request.param


@pytest.fixture()
def pool(mod):
    reps = [FakeReplica(), FakeReplica()]
    # probe_interval=0: probing driven explicitly by the tests
    rt = mod.Router([r.url for r in reps], probe_interval=0)
    yield reps, rt
    rt.close()
    for r in reps:
        r.stop()


def test_sticky_routing_across_replicas(pool):
    reps, router = pool
    # two supports land on different replicas (least-loaded placement
    # tie-breaks by pinned-context count)
    cid_a = router.support({"images": []})["context_id"]
    cid_b = router.support({"images": []})["context_id"]
    assert cid_a.split("-")[0] != cid_b.split("-")[0]
    # predicts follow their pin, repeatedly, regardless of call order
    for cid in (cid_a, cid_b, cid_a, cid_b, cid_b):
        out = router.predict("/predict", {"context_id": cid})
        assert out["served_by"] == cid.split("-")[0]


def test_unknown_context_is_lookup_error(pool):
    _, router = pool
    with pytest.raises(LookupError, match="re-register"):
        router.predict("/predict", {"context_id": "nope"})


def test_failover_and_rejoin(pool):
    reps, router = pool
    cid_a = router.support({})["context_id"]
    cid_b = router.support({})["context_id"]
    dead = next(r for r in reps
                if cid_a.startswith(r.name))
    dead_port, dead_name = dead.port, dead.name
    dead.stop()
    # a predict against the dead replica surfaces "context lost" and
    # marks it dead; the other context keeps working
    with pytest.raises(LookupError, match="context lost"):
        router.predict("/predict", {"context_id": cid_a})
    out = router.predict("/predict", {"context_id": cid_b})
    assert out["served_by"] == cid_b.split("-")[0]
    # new supports avoid the dead replica entirely
    for _ in range(3):
        cid = router.support({})["context_id"]
        assert not cid.startswith(dead_name)
    # replica comes back on the same port -> prober readmits it
    rep_obj = next(r for r in router.replicas
                   if r.url.endswith(str(dead_port)))
    assert not rep_obj.alive
    back = _Revive(dead_port)
    try:
        router._probe_one(rep_obj)
        assert rep_obj.alive
    finally:
        back.stop()


def test_rolling_reload_invalidates_and_sequences(pool):
    reps, router = pool
    cids = [router.support({})["context_id"] for _ in range(4)]
    out = router.rolling_reload({"checkpoint": "/tmp/x"})
    assert out["ok"] and out["contexts_dropped"] == 4
    # every live replica reloaded exactly once, and health-checked AFTER
    # its reload (the rolling gate that keeps capacity above zero)
    for r in reps:
        assert r.calls.count("/reload") == 1
        assert "/healthz" in r.calls[r.calls.index("/reload"):]
    # all pins invalidated: predicts now demand re-registration
    for cid in cids:
        with pytest.raises(LookupError, match="re-register"):
            router.predict("/predict", {"context_id": cid})
    # and the pool is still fully live (capacity never hit zero)
    assert all(rep.alive for rep in router.replicas)
    assert router.support({})["context_id"]


def test_http_surface_end_to_end(pool, mod):
    """Drive the router through its OWN HTTP server (the client-facing
    contract: 503 + re-register message on lost contexts)."""
    reps, router = pool
    server = ThreadingHTTPServer(("127.0.0.1", 0), mod.make_handler(router))
    t = threading.Thread(target=server.serve_forever, daemon=True)
    t.start()
    url = f"http://127.0.0.1:{server.server_address[1]}"
    try:
        status, out = _post(url, "/support", {"images": []})
        assert status == 200
        cid = out["context_id"]
        status, out = _post(url, "/predict", {"context_id": cid})
        assert status == 200 and out["served_by"] == cid.split("-")[0]
        status, out = _post(url, "/predict", {"context_id": "ghost"})
        assert status == 503 and "re-register" in out["error"]
        with urllib.request.urlopen(url + "/healthz", timeout=10) as r:
            hz = json.loads(r.read())
        assert hz["ok"] and len(hz["replicas"]) == 2
        assert hz["contexts"] == 1
    finally:
        server.shutdown()
        server.server_close()


def test_the_port_router_imports_the_standard_library_alone():
    tree = ast.parse(open(trouter.__file__).read())
    roots = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            roots |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom):
            assert node.level == 0, "a relative import"
            roots.add(node.module.split(".")[0])
    assert roots <= set(sys.stdlib_module_names) | {"__future__"}, roots


def test_the_port_router_has_the_same_classes_and_methods():
    for name in ("ReplicaHTTPError", "Replica", "Router"):
        ours, theirs = getattr(trouter, name), getattr(jrouter, name)
        assert {k for k in vars(ours) if not k.startswith("__")} == \
            {k for k in vars(theirs) if not k.startswith("__")}, name
