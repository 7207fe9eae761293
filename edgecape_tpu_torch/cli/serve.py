"""Inference server of the port: a persistent estimator with cached
support contexts; counterpart of serve.py, with the same HTTP contract.

One process keeps the estimator's weights on the card; support episodes
are registered once and their device-resident context (pooled keypoint
tokens, learned adjacency, Markov bias) is reused by every later query.

Stdlib-only HTTP (no framework dependency):

  POST /support   {"images": [<b64 png/jpg/ppm>, ...],      # S shots
                   "keypoints": [[x, y], ...],              # on shot 0
                   "skeleton": [[i, j], ...]}
                -> {"context_id": "..."}
  POST /predict   {"context_id": "...", "image": <b64>}
                -> {"keypoints": [[x, y, score], ...],
                    "edge_weights": [[i, j, w], ...]}
  POST /predict_batch {"context_id": "...", "images": [<b64>, ...]}
                -> {"results": [{"keypoints": [...]}, ...],
                    "edge_weights": [[i, j, w], ...]}
  POST /reload    {"checkpoint": "<file>"}  # head-weight hot swap
                -> {"ok": true, "contexts_dropped": N}
  GET  /healthz -> {"ok": true, "contexts": N, "stats": {...}}
  GET  /        -> the click-to-annotate web page

Batching: /predict_batch runs all queries of one episode in one call,
padded to a bucket of 1, 2, 4, 8 or 16 rows by repeating the last image.
Concurrent /predict requests for the same context are coalesced by a
micro-batcher (--batch-window-ms) into one call.

Threads: the HTTP threads decode and resize their images, then every call
into the estimator runs under one device lock (the batcher's worker, the
HTTP threads of /support and /predict_batch, /reload's swap), each in
`torch.no_grad()` and the estimator's precision context, both of which
are per thread. The lock keeps the ops' launch counters and weight caches
single-threaded. /reload builds the new head aside, checks its keys and
shapes against the live one, and swaps it in whole under the lock.

Keypoints are given in original support-image pixels; predictions return
original query-image pixels (the square-pad geometry inverted here).
The model is the stage-3 EdgeCape over DINOv2 ViT-S/14 at --size px
(cli/demo.py stage3_estimator), fp32, on the kernels on the card.

    python -m edgecape_tpu_torch.cli.serve [--checkpoint CKPT] [--port P] \\
        [--device cpu]

Runs on the CUDA device and raises without one; `--device cpu` is the
only way onto the CPU.
"""

from __future__ import annotations

import argparse
import base64
import contextlib
import json
import threading
import time
import uuid
from collections import OrderedDict
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np

# the batch shapes a query call ever takes: padding to the next bucket
# keeps the kernels' launch shapes to len(_BUCKETS) per context geometry
_BUCKETS = (1, 2, 4, 8, 16)


class _MicroBatcher:
    """Coalesces concurrent single-query requests into one device call.

    Requests arriving within `window_s` of each other that target the
    SAME support context are stacked and dispatched together. Each HTTP
    thread blocks on its own event; the worker thread makes the call.
    """

    def __init__(self, service, window_s=0.008, max_batch=_BUCKETS[-1]):
        self.service = service
        self.window_s = window_s
        self.max_batch = max_batch
        self.cv = threading.Condition()
        self.pending = []  # [(cid, img_norm, scale, slot, event)]
        self.stopped = False
        self.thread = threading.Thread(target=self._run, daemon=True)
        self.thread.start()

    def submit(self, cid: str, img_norm: np.ndarray, scale: float) -> dict:
        slot, ev = {}, threading.Event()
        with self.cv:
            self.pending.append((cid, img_norm, scale, slot, ev))
            self.cv.notify()
        if not ev.wait(timeout=600):
            raise TimeoutError("batched dispatch timed out")
        if "error" in slot:
            raise RuntimeError(slot["error"])
        return slot

    def stop(self):
        with self.cv:
            self.stopped = True
            self.cv.notify()
        self.thread.join(timeout=5)

    def _run(self):
        while True:
            with self.cv:
                while not self.pending and not self.stopped:
                    self.cv.wait(0.5)
                if self.stopped and not self.pending:
                    return
            if self.window_s > 0:
                time.sleep(self.window_s)  # let concurrent requests land
            with self.cv:
                head_cid = self.pending[0][0]
                take, rest = [], []
                for item in self.pending:
                    if item[0] == head_cid and len(take) < self.max_batch:
                        take.append(item)
                    else:
                        rest.append(item)
                self.pending = rest
            imgs = np.stack([t[1] for t in take])
            try:
                preds, edges, k_real = self.service._dispatch(head_cid,
                                                              imgs)
            except Exception as e:  # noqa: BLE001 — fan error to callers
                for _, _, _, slot, ev in take:
                    slot["error"] = str(e)
                    ev.set()
                continue
            for row, (_, _, scale, slot, ev) in enumerate(take):
                slot["pred"] = preds[row]
                slot["edges"] = edges
                slot["k_real"] = k_real
                ev.set()


class PoseService:
    """Model state + support-context registry (thread-safe).

    `lock` guards the registry, the statistics and `generation`;
    `device_lock` serialises every call into the estimator. Where a
    thread holds both, it takes `device_lock` first."""

    def __init__(self, checkpoint=None, backbone_ckpt=None, size=224,
                 max_kpt=100, *, device="cuda", backbone_state=None,
                 head_state=None, use_flash=None):
        from .demo import stage3_estimator

        self.size = size
        self.max_kpt = max_kpt
        self.est = stage3_estimator(
            size, max_kpt, checkpoint=checkpoint,
            backbone_ckpt=backbone_ckpt, backbone_state=backbone_state,
            head_state=head_state, use_flash=use_flash, device=device)
        # LRU-capped registry: the interactive UI POSTs /support on
        # every Predict click, so device-resident contexts would grow
        # without bound over a long session otherwise
        self.max_contexts = 32
        self.contexts: "OrderedDict" = OrderedDict()
        self.lock = threading.Lock()
        self.device_lock = threading.Lock()
        # bumped under both locks on every /reload; a support context
        # built against an older generation's head is never inserted
        self.generation = 0
        self.stats = {"dispatches": 0, "queries": 0, "max_batch": 0}
        self.batcher: "_MicroBatcher | None" = None

    def enable_batching(self, window_s=0.008):
        self.batcher = _MicroBatcher(self, window_s=window_s)

    @staticmethod
    def _decode_image(b64: str) -> np.ndarray:
        from ..data.pipeline import decode_image
        return decode_image(base64.b64decode(b64))

    def _prep(self, img: np.ndarray):
        from .demo import normalize, square_pad_resize
        padded, scale = square_pad_resize(img, self.size)
        return normalize(padded), scale

    @contextlib.contextmanager
    def _call(self):
        """The context of a call into the estimator: the device lock, no
        autograd, the estimator's precision (per thread, so every caller
        enters them itself)."""
        import torch
        with self.device_lock, torch.no_grad(), self.est._precision():
            yield

    def register_support(self, payload: dict) -> str:
        kpts = np.asarray(payload["keypoints"], np.float32).reshape(-1, 2)
        skeleton = [[int(i), int(j)]
                    for i, j in payload.get("skeleton", [])]
        k_real = len(kpts)
        K = self.max_kpt
        if k_real > K:
            raise ValueError(f"{k_real} keypoints; the model takes at "
                             f"most {K}")
        imgs, joints, vis = [], [], []
        for b64 in payload["images"]:
            img, scale = self._prep(self._decode_image(b64))
            imgs.append(img)
            j = np.zeros((K, 2), np.float32)
            j[:k_real] = kpts * scale
            joints.append(j)
            v = np.zeros(K, np.float32)
            v[:k_real] = 1.0
            vis.append(v)
        adj = np.zeros((K, K), np.float32)
        for i, j in skeleton:
            if i < K and j < K:
                adj[i, j] = adj[j, i] = 1.0

        t = self.est._stage
        with self._call():
            with self.lock:
                gen = self.generation
            ctx = self.est.support_context(
                t(np.stack(imgs)[None], "img_s"),
                t(np.stack(joints)[None], "joints_s"),
                t(np.stack(vis)[None], "vis_s"), t(adj[None], "binary_adj"))
        cid = uuid.uuid4().hex[:12]
        with self.lock:
            if self.generation != gen:
                # /reload swapped the head while this context was being
                # computed; inserting it would pair stale support
                # features with the new weights at /predict time
                raise RuntimeError(
                    "checkpoint reloaded during support registration; "
                    "re-register the support")
            self.contexts[cid] = (ctx, skeleton, k_real)
            while len(self.contexts) > self.max_contexts:
                self.contexts.popitem(last=False)
        return cid

    def reload_checkpoint(self, payload: dict) -> dict:
        """Hot-swap head weights without restarting the server. Cached
        support contexts were computed with the old weights, so they are
        dropped (clients re-register). The new head is built aside and
        swapped in whole; the kernels' bf16 weight copies
        (ops/kernels.py module_weights) are made anew for its tensors."""
        from ..train import checkpoint as ck

        tree = ck.load_checkpoint(payload["checkpoint"])
        new_state = tree.get("model", tree)
        live = {k: tuple(v.shape)
                for k, v in self.est.head.state_dict().items()}
        new = {k: tuple(getattr(v, "shape", ()))
               for k, v in new_state.items()}
        if new != live:
            diff = sorted(set(new.items()) ^ set(live.items()))[:4]
            raise ValueError(
                f"checkpoint state does not match the serving model's "
                f"head (keys and shapes differ: {diff} ...)")
        heads = self.est.make_heads(new_state)
        with self.device_lock, self.lock:
            self.est.head, self.est.query_head = heads
            self.generation += 1
            dropped = len(self.contexts)
            self.contexts.clear()
            self.stats["reloads"] = self.stats.get("reloads", 0) + 1
        return {"ok": True, "contexts_dropped": dropped}

    def _dispatch(self, cid: str, imgs: np.ndarray):
        """One device call for n same-context queries. imgs [n, H, W, 3]
        normalized. Returns (pred [n, K, 2] in [0,1], edge list, k_real)."""
        import torch

        from ..models.edgecape import SupportContext

        n = imgs.shape[0]
        bucket = next(b for b in _BUCKETS if b >= n)
        if bucket > n:  # edge-repeat pad to the bucket shape
            imgs = np.concatenate(
                [imgs, np.repeat(imgs[-1:], bucket - n, axis=0)])
        est = self.est
        with self._call():
            # looked up under the device lock, which /reload holds while
            # it swaps the head: a context never meets another
            # generation's weights
            with self.lock:
                if cid not in self.contexts:
                    raise KeyError("unknown context_id")
                ctx, skeleton, k_real = self.contexts[cid]
                self.contexts.move_to_end(cid)
            group = torch.zeros(bucket, dtype=torch.long, device=est.device)
            ctx_rows = SupportContext(*(None if a is None else a[group]
                                        for a in ctx))
            pred = est.query_rows(ctx_rows, est._stage(imgs, "img_q"))
            pred = pred[:n].cpu().numpy()
            adj = ctx.raw_adj[0].to(torch.float32).cpu().numpy()
        edges = [[int(i), int(j), float(adj[i, j])] for i, j in skeleton]
        with self.lock:
            self.stats["dispatches"] += 1
            self.stats["queries"] += n
            self.stats["max_batch"] = max(self.stats["max_batch"], n)
        return pred, edges, k_real

    def _row_to_keypoints(self, pred_row, scale, k_real):
        pts = pred_row * self.size / scale  # original query pixels
        return [[float(x), float(y), 1.0] for x, y in pts[:k_real]]

    def predict(self, payload: dict) -> dict:
        cid = payload["context_id"]
        img, scale = self._prep(self._decode_image(payload["image"]))
        if self.batcher is not None:
            slot = self.batcher.submit(cid, img, scale)
            pred_row, edges, k_real = (slot["pred"], slot["edges"],
                                       slot["k_real"])
        else:
            preds, edges, k_real = self._dispatch(cid, img[None])
            pred_row = preds[0]
        return {"keypoints": self._row_to_keypoints(pred_row, scale,
                                                    k_real),
                "edge_weights": edges}

    def predict_batch(self, payload: dict) -> dict:
        """All queries for one episode in a single dispatch (chunked at
        the largest bucket)."""
        cid = payload["context_id"]
        prepped = [self._prep(self._decode_image(b64))
                   for b64 in payload["images"]]
        results, edges = [], []
        for lo in range(0, len(prepped), _BUCKETS[-1]):
            chunk = prepped[lo:lo + _BUCKETS[-1]]
            preds, edges, k_real = self._dispatch(
                cid, np.stack([img for img, _ in chunk]))
            results.extend(
                {"keypoints": self._row_to_keypoints(preds[i], scale,
                                                     k_real)}
                for i, (_, scale) in enumerate(chunk))
        return {"results": results, "edge_weights": edges}


INDEX_HTML = """<!doctype html>
<html><head><meta charset="utf-8"><title>EdgeCape-TPU demo</title><style>
body{font-family:sans-serif;margin:20px;background:#fafafa}
.panes{display:flex;gap:24px;flex-wrap:wrap}
canvas{border:1px solid #999;background:#fff;cursor:crosshair}
#log{white-space:pre-wrap;color:#333;margin-top:12px}
button{margin:4px}
</style></head><body>
<h2>EdgeCape-TPU — interactive one-shot keypoint transfer</h2>
<p>1) Load a <b>support</b> image and click its keypoints. 2) Click pairs
of keypoints to add skeleton edges (toggle mode below). 3) Load a
<b>query</b> image and hit <b>Predict</b>.</p>
<div>
 support <input type="file" id="supFile" accept="image/*">
 query <input type="file" id="qryFile" accept="image/*">
 <button id="modeBtn">mode: keypoints</button>
 <button id="undoBtn">undo</button>
 <button id="predictBtn">Predict</button>
</div>
<div class="panes">
 <div><h4>support</h4><canvas id="sup" width="384" height="384"></canvas></div>
 <div><h4>query + prediction</h4><canvas id="qry" width="384" height="384"></canvas></div>
</div>
<div id="log"></div>
<script>
const S={kps:[],edges:[],mode:'kp',supImg:null,qryImg:null,supB64:null,
         qryB64:null,pick:null,pred:null,edgeW:null};
const sup=document.getElementById('sup'),qry=document.getElementById('qry');
const log=m=>document.getElementById('log').textContent=m;
function fit(img,c){const r=Math.min(c.width/img.width,c.height/img.height);
 return {w:img.width*r,h:img.height*r,r:r};}
function drawSup(){const c=sup.getContext('2d');c.clearRect(0,0,384,384);
 if(!S.supImg)return;const f=fit(S.supImg,sup);
 c.drawImage(S.supImg,0,0,f.w,f.h);
 c.strokeStyle='#0a0';c.lineWidth=2;
 for(const[a,b]of S.edges){c.beginPath();
  c.moveTo(S.kps[a][0]*f.r,S.kps[a][1]*f.r);
  c.lineTo(S.kps[b][0]*f.r,S.kps[b][1]*f.r);c.stroke();}
 S.kps.forEach((p,i)=>{c.fillStyle=S.pick===i?'#fa0':'#d00';
  c.beginPath();c.arc(p[0]*f.r,p[1]*f.r,5,0,7);c.fill();
  c.fillStyle='#fff';c.font='9px sans-serif';
  c.fillText(i,p[0]*f.r-3,p[1]*f.r+3);});}
function drawQry(){const c=qry.getContext('2d');c.clearRect(0,0,384,384);
 if(!S.qryImg)return;const f=fit(S.qryImg,qry);
 c.drawImage(S.qryImg,0,0,f.w,f.h);
 if(!S.pred)return;
 c.strokeStyle='#06f';
 for(const[a,b,w]of(S.edgeW||[])){if(w<=0)continue;
  c.lineWidth=Math.max(1,4*w);c.beginPath();
  c.moveTo(S.pred[a][0]*f.r,S.pred[a][1]*f.r);
  c.lineTo(S.pred[b][0]*f.r,S.pred[b][1]*f.r);c.stroke();}
 S.pred.forEach((p,i)=>{c.fillStyle='#d00';c.beginPath();
  c.arc(p[0]*f.r,p[1]*f.r,5,0,7);c.fill();
  c.fillStyle='#fff';c.font='9px sans-serif';
  c.fillText(i,p[0]*f.r-3,p[1]*f.r+3);});}
function loadFile(input,cb){const fr=new FileReader();
 fr.onload=()=>{const img=new Image();
  img.onload=()=>cb(img,fr.result.split(',')[1]);img.src=fr.result;};
 fr.readAsDataURL(input.files[0]);}
supFile.onchange=()=>loadFile(supFile,(img,b64)=>{S.supImg=img;
 S.supB64=b64;S.kps=[];S.edges=[];drawSup();log('support loaded — click keypoints');});
qryFile.onchange=()=>loadFile(qryFile,(img,b64)=>{S.qryImg=img;
 S.qryB64=b64;S.pred=null;drawQry();log('query loaded');});
sup.onclick=e=>{if(!S.supImg)return;const f=fit(S.supImg,sup);
 const x=e.offsetX/f.r,y=e.offsetY/f.r;
 if(S.mode==='kp'){S.kps.push([x,y]);}
 else{let best=-1,bd=1e9;S.kps.forEach((p,i)=>{const d=(p[0]-x)**2+(p[1]-y)**2;
   if(d<bd){bd=d;best=i;}});
  if(best>=0){if(S.pick===null){S.pick=best;}else{
   if(S.pick!==best)S.edges.push([S.pick,best]);S.pick=null;}}}
 drawSup();};
modeBtn.onclick=()=>{S.mode=S.mode==='kp'?'edge':'kp';S.pick=null;
 modeBtn.textContent='mode: '+(S.mode==='kp'?'keypoints':'edges');};
undoBtn.onclick=()=>{if(S.mode==='kp')S.kps.pop();else S.edges.pop();
 drawSup();};
predictBtn.onclick=async()=>{
 if(!S.supB64||!S.qryB64||!S.kps.length){log('need support+keypoints+query');return;}
 log('registering support...');
 let r=await fetch('/support',{method:'POST',body:JSON.stringify(
  {images:[S.supB64],keypoints:S.kps,skeleton:S.edges})});
 let j=await r.json();if(j.error){log('error: '+j.error);return;}
 log('predicting...');
 r=await fetch('/predict',{method:'POST',body:JSON.stringify(
  {context_id:j.context_id,image:S.qryB64})});
 j=await r.json();if(j.error){log('error: '+j.error);return;}
 S.pred=j.keypoints;S.edgeW=j.edge_weights;drawQry();
 log('done: '+S.pred.length+' keypoints');};
</script></body></html>"""


def make_handler(service: PoseService):
    class Handler(BaseHTTPRequestHandler):
        def _reply(self, code: int, obj: dict):
            body = json.dumps(obj).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path == "/healthz":
                with service.lock:
                    stats = dict(service.stats)
                    n = len(service.contexts)
                self._reply(200, {"ok": True, "contexts": n,
                                  "stats": stats})
            elif self.path in ("/", "/index.html"):
                body = INDEX_HTML.encode()
                self.send_response(200)
                self.send_header("Content-Type",
                                 "text/html; charset=utf-8")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)
            else:
                self._reply(404, {"error": "not found"})

        def do_POST(self):
            try:
                n = int(self.headers.get("Content-Length", 0))
                payload = json.loads(self.rfile.read(n))
                if self.path == "/support":
                    cid = service.register_support(payload)
                    self._reply(200, {"context_id": cid})
                elif self.path == "/predict":
                    self._reply(200, service.predict(payload))
                elif self.path == "/predict_batch":
                    self._reply(200, service.predict_batch(payload))
                elif self.path == "/reload":
                    self._reply(200, service.reload_checkpoint(payload))
                else:
                    self._reply(404, {"error": "not found"})
            except Exception as e:  # noqa: BLE001 — report to client
                self._reply(400, {"error": str(e)})

        def log_message(self, *args):
            pass

    return Handler


def parse_args(argv=None):
    p = argparse.ArgumentParser(
        prog="python -m edgecape_tpu_torch.cli.serve",
        description="EdgeCape inference server (PyTorch + CUDA port)")
    p.add_argument("--checkpoint", default=None,
                   help="checkpoint file of the port's trainer")
    p.add_argument("--backbone-ckpt", default=None,
                   help="torch-hub DINOv2 .pth, or a backbone state dict "
                   "saved by this package")
    p.add_argument("--port", type=int, default=8300)
    p.add_argument("--size", type=int, default=224)
    p.add_argument("--batch-window-ms", type=float, default=8.0,
                   help="micro-batching window for concurrent /predict "
                        "requests; 0 disables coalescing")
    p.add_argument("--device", default="cuda",
                   help="cuda (default; raises without a card) or cpu")
    return p.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    from ..api import resolve_device

    service = PoseService(args.checkpoint, args.backbone_ckpt, args.size,
                          device=resolve_device(args.device))
    if args.batch_window_ms > 0:
        service.enable_batching(window_s=args.batch_window_ms / 1e3)
    server = ThreadingHTTPServer(("0.0.0.0", args.port),
                                 make_handler(service))
    print(f"serving on :{args.port}")
    server.serve_forever()


if __name__ == "__main__":
    main()
