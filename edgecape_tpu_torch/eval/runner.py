"""Episodic evaluation, single process; counterpart of
edgecape_tpu/eval/runner.py:run_eval.

Cached (`cache_supports=True`): episode groups (one support set, its
queries) are evaluated in chunks of a fixed group count. The loop is
depth-2: chunk i is queued on the device before chunk i-1's predictions
are pulled to the host, decoded (inverse crop affine) and turned into
result records, so host decode overlaps device work; the next chunk's
host collation runs on a worker thread. Uncached (the default, as in the
JAX package): one episode per row through `forward_batch` and
`decode_batch`, batch after batch. Metrics follow the reference's
_report_metric (PCK@thresholds, mPCK, NME, AUC, EPE, thresholds
normalised by the query bbox's longer side, visibility = query AND all
supports).

The loops take any dataset with the MP100Dataset interface
(`support_groups`, `collate_group`, `batches`, `paired_samples`, `db`,
`name2id`, `img_prefix`, `cfg.pck_threshold_list`).
"""

from __future__ import annotations

import json
import os
import time
from collections import OrderedDict
from concurrent.futures import ThreadPoolExecutor

import numpy as np

from ..ops.affine import transform_preds_batch


def make_chunks(groups, batch_size: int):
    """Fixed-size chunks of episode groups: (chunk, real group count),
    the last one padded by repeating its last group."""
    nq = max((len(rows) for _, rows in groups), default=0)
    g_per = max(1, min(batch_size // max(nq, 1), len(groups)))
    chunks = []
    for i in range(0, len(groups), g_per):
        chunk = groups[i:i + g_per]
        real = len(chunk)
        chunk = chunk + [chunk[-1]] * (g_per - real)
        chunks.append((chunk, real))
    return chunks


def records_from(preds_img, meta, dataset):
    """Result-json records from decoded predictions + meta."""
    records = []
    for i in range(preds_img.shape[0]):
        path = meta["query_image_file"][i]
        kp = np.concatenate([preds_img[i], np.ones((preds_img.shape[1], 1))],
                            axis=1)
        records.append({
            "keypoints": kp.tolist(),
            "center": list(map(float, meta["query_center"][i])),
            "scale": list(map(float, meta["query_scale"][i])),
            "area": float(np.prod(meta["query_scale"][i] * 200.0)),
            "score": 1.0,
            "image_id": dataset.name2id.get(
                os.path.relpath(path, dataset.img_prefix), -1),
            "bbox_id": meta["bbox_id"][i],
        })
    return records


def run_cached(estimator, chunks, collate, on_chunk):
    """The depth-2 loop. chunks: list of (chunk, real group count);
    collate(chunk) -> (support, query, meta) on the host, run one chunk
    ahead on a worker thread; on_chunk(pred_host, query, meta, real) is
    called with chunk i-1's predictions after chunk i was queued.
    Returns timings (seconds)."""
    timings = {"host_collate_s": 0.0, "device_wait_s": 0.0,
               "dispatch_s": 0.0}

    def timed_collate(chunk):
        t = time.perf_counter()
        out = collate(chunk)
        timings["host_collate_s"] += time.perf_counter() - t
        return out

    def drain(item):
        pred, query, meta, real = item
        t = time.perf_counter()
        pred_host = pred.cpu().numpy()        # waits for the device
        timings["device_wait_s"] += time.perf_counter() - t
        on_chunk(pred_host, query, meta, real)

    with ThreadPoolExecutor(max_workers=1) as pool:
        pending = pool.submit(timed_collate, chunks[0][0]) if chunks \
            else None
        in_flight = None
        for ci, (_, real) in enumerate(chunks):
            support, query, meta = pending.result()
            if ci + 1 < len(chunks):
                pending = pool.submit(timed_collate, chunks[ci + 1][0])
            t = time.perf_counter()
            pred, _ = estimator.forward_cached(support, query)
            timings["dispatch_s"] += time.perf_counter() - t
            prev, in_flight = in_flight, (pred, query, meta, real)
            if prev is not None:
                drain(prev)
        if in_flight is not None:
            drain(in_flight)
    return timings


def run_eval(dataset, estimator, batch_size: int = 32,
             res_folder: str = ".",
             metric_list=("PCK", "NME", "AUC", "EPE"),
             progress: bool = True,
             cache_supports: bool = False) -> OrderedDict:
    """1-process eval over every episode of `dataset`, cached by episode
    group or one episode per row; writes result_keypoints.json and
    returns the metrics."""
    os.makedirs(res_folder, exist_ok=True)
    size = estimator.cfg.model.image_size
    records = []
    n_done = 0
    t0 = time.perf_counter()

    def report(n_total):
        if progress:
            rate = n_done / max(time.perf_counter() - t0, 1e-9)
            print(f"\reval {n_done}/{n_total} ({rate:.1f} img/s)", end="",
                  flush=True)

    timings = {}
    if cache_supports:
        groups = dataset.support_groups()
        n_total = sum(len(rows) for _, rows in groups)

        def on_chunk(pred_host, query, meta, real):
            nonlocal n_done
            n_real = int(np.sum(np.asarray(query["group"]) < real))
            meta = {k: v[:n_real] for k, v in meta.items()}
            preds_img = transform_preds_batch(
                pred_host[:n_real] * size, meta["query_center"],
                meta["query_scale"], (size, size))
            records.extend(records_from(preds_img, meta, dataset))
            n_done += n_real
            report(n_total)

        timings = run_cached(estimator, make_chunks(groups, batch_size),
                             dataset.collate_group, on_chunk)
    else:
        n_total = len(dataset)
        for batch in dataset.batches(batch_size, masking_ratio=0.0):
            pred_norm, _, _ = estimator.forward_batch(batch)
            out = estimator.decode_batch(pred_norm, batch)
            records.extend(records_from(
                out["preds"][:, :, :2],
                {"query_image_file": out["image_paths"],
                 "query_center": out["boxes"][:, 0:2],
                 "query_scale": out["boxes"][:, 2:4],
                 "bbox_id": out["bbox_ids"]}, dataset))
            n_done += len(out["bbox_ids"])
            report(n_total)
    if progress:
        print()
    # dedup by bbox_id like the reference _sort_and_unique_bboxes
    records.sort(key=lambda r: r["bbox_id"])
    uniq, seen = [], set()
    for r in records:
        if r["bbox_id"] not in seen:
            uniq.append(r)
            seen.add(r["bbox_id"])
    with open(os.path.join(res_folder, "result_keypoints.json"), "w") as f:
        json.dump(uniq, f, sort_keys=True, indent=4)
    results = compute_metrics(dataset, uniq, metric_list)
    elapsed = time.perf_counter() - t0
    results["eval_seconds"] = round(elapsed, 3)
    results["images_per_sec"] = round(n_done / max(elapsed, 1e-9), 2)
    for k, v in timings.items():
        results[k.replace("_s", "_seconds")] = round(v, 3)
    return results


def _gather_eval_arrays(dataset, records):
    """preds/gts [R, K, 2], masks [R, K] (query AND all supports),
    thr [R, 2] (bbox longer side)."""
    outputs, gts, masks, thr_bbox = [], [], [], []
    for rec, pair in zip(records, dataset.paired_samples):
        item = dataset.db[pair[-1]]
        outputs.append(np.array(rec["keypoints"])[:, :-1])
        gts.append(np.array(item["joints_3d"])[:, :-1])
        mask_q = np.array(item["joints_3d_visible"])[:, 0] > 0
        mask_s = np.array(dataset.db[pair[0]]["joints_3d_visible"])[:, 0] > 0
        for sid in pair[:-1]:
            mask_s &= np.array(dataset.db[sid]["joints_3d_visible"])[:, 0] > 0
        masks.append(mask_q & mask_s)
        thr = np.max(np.array(item["bbox"])[2:])
        thr_bbox.append(np.array([thr, thr]))
    return (np.stack(outputs).astype(np.float32),
            np.stack(gts).astype(np.float32), np.stack(masks),
            np.stack(thr_bbox).astype(np.float32))


def _distances(preds, gts, masks, thr):
    """Per-axis threshold-normalised distances [R, K], the valid mask
    [R, K] and the per-record valid count (at least 1)."""
    valid = masks & (thr > 0).all(axis=-1)[:, None]
    norm = np.where(thr <= 0, 1e6, thr)
    d = np.linalg.norm((preds - gts) / norm[:, None, :], axis=-1)
    return d, valid, np.maximum(valid.sum(axis=-1), 1)


def pck_accuracy(preds, gts, masks, thr, t: float) -> float:
    """PCK@t: the mean over records of the share of valid keypoints whose
    normalised distance is below t. preds/gts [R, K, 2] pixels; masks
    [R, K] bool; thr [R, 2] normalising box sides."""
    d, valid, safe = _distances(preds, gts, masks, thr)
    return float(np.mean(((d < t) & valid).sum(axis=-1) / safe))


def compute_metrics(dataset, records, metric_list) -> OrderedDict:
    """The reference's _report_metric over decoded records, vectorised
    over the record set (the same arithmetic as
    edgecape_tpu/eval/runner.py:compute_metrics, so both packages report
    the same numbers for the same predictions)."""
    assert len(records) == len(dataset.paired_samples)
    pck_list = list(dataset.cfg.pck_threshold_list)
    preds, gts, masks, thr = _gather_eval_arrays(dataset, records)
    d, valid, safe = _distances(preds, gts, masks, thr)
    info = OrderedDict()
    if "PCK" in metric_list:
        mpck = 0.0
        for t in pck_list:
            v = float(np.mean(((d < t) & valid).sum(axis=-1) / safe))
            info[f"PCK@{t}"] = v
            mpck += v
        info["mPCK"] = mpck / len(pck_list)
        info["PCK"] = info[f"PCK@{0.2}"] if 0.2 in pck_list else \
            info[f"PCK@{pck_list[-1]}"]
    if "NME" in metric_list:
        info["NME"] = float(np.mean(np.where(valid, d, 0.0).sum(axis=-1)
                                    / safe))
    if "AUC" in metric_list:
        steps = np.arange(20, dtype=np.float32) / 20.0
        acc = ((d[None] < steps[:, None, None]) & valid[None]).sum(-1) / safe
        info["AUC"] = float(np.mean(acc))
    if "EPE" in metric_list:
        de = np.where(masks, np.linalg.norm(preds - gts, axis=-1), 0.0)
        info["EPE"] = float(np.mean(de.sum(axis=-1)
                                    / np.maximum(masks.sum(axis=-1), 1)))
    return info


def append_testing_log(work_dir: str, config_name: str, ckpt: str,
                       results: dict) -> None:
    """One line per evaluated checkpoint in work_dir/testing_log.txt."""
    os.makedirs(work_dir, exist_ok=True)
    with open(os.path.join(work_dir, "testing_log.txt"), "a") as f:
        f.write(f"config: {config_name} ckpt: {ckpt} ")
        f.write(" ".join(f"{k}: {v}" for k, v in results.items()))
        f.write("\n")
