"""Serving-path performance benchmark: /recommend latency + searcher
throughput (VERDICT r03 weak-point #4).

Measures, at MIND scale (65k-item corpus, 16-d DSSM embeddings,
``configs/dssm.yaml`` shapes):

1. ``Recommender.recommend`` end-to-end (user-tower encode + top-k +
   history dedup), k=10, 30-item histories:
   - single-user latency p50/p99 (device and host backends)
   - batched throughput (users/s) at batch 256
2. Raw searcher throughput at 65k x 16: device exact matmul+top_k
   (``ops.topk.TopKSearcher``) vs threaded C++ host ANN
   (``native.HostTopKSearcher``) vs the numpy fallback.
3. The HTTP shim: per-request p50/p99 over the JSON API (single user,
   k=10) — what a caller of ``serve http`` actually sees.

Replaces the reference's never-benchmarked faiss primitive
(``/root/reference/src/model/model_utils/TopKSearcher.py:19-83``).

Usage: python scripts/serving_bench.py [--json artifacts/serving_bench_r04.json]
"""

import json
import os
import sys
import time
import urllib.request

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np

N_ITEMS = 65239
SINGLE_REQS = 200
BATCH = 256
BATCH_REQS = 20
HTTP_REQS = 200
K = 10
HIST_LEN = 30

RESULTS = {}


def pctl(xs, p):
    xs = sorted(xs)
    return xs[min(len(xs) - 1, int(len(xs) * p / 100))]


def build_recommender(backend: str):
    import jax

    from news_recsys_tpu.config import load_config
    from news_recsys_tpu.data.packed_dataset import PackedDataset
    from news_recsys_tpu.models.dssm import build_dssm
    from news_recsys_tpu.serving import Recommender

    cfg = load_config(os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "configs", "dssm.yaml"))
    model = build_dssm(cfg)
    rng = np.random.default_rng(0)
    item_ds = PackedDataset({
        "item_id": np.arange(1, N_ITEMS + 1, dtype=np.int32),
        "category": rng.integers(1, 18, N_ITEMS).astype(np.int32),
        "subcategory": rng.integers(1, 270, N_ITEMS).astype(np.int32),
    })
    # init with BOTH towers' features (plain __call__ creates user+item)
    u, _ = user_rows(8)
    batch = {k: jax.numpy.asarray(v[:8]) for k, v in item_ds.arrays.items()}
    batch.update({k: jax.numpy.asarray(v) for k, v in u.items()})
    params = model.init(jax.random.PRNGKey(0), batch)
    return Recommender(cfg, model, params, item_ds, backend=backend), cfg


def user_rows(n, seed=1):
    rng = np.random.default_rng(seed)
    hist = rng.integers(1, N_ITEMS, (n, HIST_LEN)).astype(np.int32)
    return {
        "user_id": rng.integers(1, 94058, n).astype(np.int32),
        "user_click_category": rng.integers(1, 18, n).astype(np.int32),
        "hist": hist,
        "hist_mask": np.ones((n, HIST_LEN), np.float32),
    }, [list(map(int, h)) for h in hist]


def bench_recommend(rec, tag):
    users1, hist1 = user_rows(1)
    rec.recommend(users1, k=K, histories=hist1)  # warm / compile
    lats = []
    for i in range(SINGLE_REQS):
        u, h = user_rows(1, seed=100 + i)
        t0 = time.perf_counter()
        ids, _ = rec.recommend(u, k=K, histories=h)
        lats.append((time.perf_counter() - t0) * 1e3)
        assert len(ids[0]) == K
    RESULTS[f"recommend_single_{tag}"] = {
        "p50_ms": round(pctl(lats, 50), 2), "p99_ms": round(pctl(lats, 99), 2)}

    ub, hb = user_rows(BATCH, seed=7)
    rec.recommend(ub, k=K, histories=hb)
    t0 = time.perf_counter()
    for _ in range(BATCH_REQS):
        rec.recommend(ub, k=K, histories=hb)
    dt = time.perf_counter() - t0
    RESULTS[f"recommend_batch{BATCH}_{tag}"] = {
        "users_per_sec": round(BATCH * BATCH_REQS / dt, 1)}
    print(f"recommend[{tag}]: single p50 {RESULTS[f'recommend_single_{tag}']['p50_ms']} ms "
          f"p99 {RESULTS[f'recommend_single_{tag}']['p99_ms']} ms | "
          f"batch {RESULTS[f'recommend_batch{BATCH}_{tag}']['users_per_sec']} users/s")


def bench_searchers(corpus):
    rng = np.random.default_rng(3)
    queries = rng.standard_normal((4096, corpus.shape[1])).astype(np.float32)
    cases = {}
    from news_recsys_tpu.ops.topk import TopKSearcher
    dev = TopKSearcher(normalize=False)
    dev.update_embedding(corpus)
    cases["device_matmul_topk"] = dev

    from news_recsys_tpu.native import HostTopKSearcher
    host = HostTopKSearcher(normalize=False)
    host.update_embedding(corpus)
    cases["host_" + ("cpp_ann" if host.available else "numpy_fallback")] = host
    if host.available:  # numpy fallback measured explicitly too
        noext = HostTopKSearcher(normalize=False)
        noext._lib = None
        noext.update_embedding(corpus)
        cases["host_numpy_fallback"] = noext

    for tag, s in cases.items():
        s.search(queries[:64], K)  # warm
        t0 = time.perf_counter()
        s.search(queries, K)
        dt = time.perf_counter() - t0
        RESULTS[f"searcher_{tag}"] = {
            "queries_per_sec": round(len(queries) / dt, 1),
            "corpus": f"{corpus.shape[0]}x{corpus.shape[1]}"}
        print(f"searcher[{tag}]: {RESULTS[f'searcher_{tag}']['queries_per_sec']} q/s")


def bench_http(rec):
    import logging
    import threading

    from news_recsys_tpu.serving import make_http_handler

    logging.getLogger("news_recsys_tpu.serving").setLevel(logging.WARNING)
    from http.server import ThreadingHTTPServer

    srv = ThreadingHTTPServer(("127.0.0.1", 0), make_http_handler(rec))
    port = srv.server_address[1]
    th = threading.Thread(target=srv.serve_forever, daemon=True)
    th.start()
    u, h = user_rows(1)
    body = json.dumps({
        "users": {k: v.tolist() for k, v in u.items()},
        "k": K, "histories": h,
    }).encode()

    def once():
        req = urllib.request.Request(
            f"http://127.0.0.1:{port}/recommend", data=body,
            headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=30) as r:
            return json.loads(r.read())

    once()
    lats = []
    for _ in range(HTTP_REQS):
        t0 = time.perf_counter()
        out = once()
        lats.append((time.perf_counter() - t0) * 1e3)
    assert len(out["ids"][0]) == K
    srv.shutdown()
    RESULTS["http_recommend_single"] = {
        "p50_ms": round(pctl(lats, 50), 2), "p99_ms": round(pctl(lats, 99), 2)}
    print(f"http: p50 {RESULTS['http_recommend_single']['p50_ms']} ms "
          f"p99 {RESULTS['http_recommend_single']['p99_ms']} ms")


def main():
    import jax

    platform = jax.devices()[0].platform
    print(f"backend: {platform}")
    rec_dev, _ = build_recommender("device" if platform != "cpu" else "host")
    bench_recommend(rec_dev, "device" if platform != "cpu" else "host")
    if platform != "cpu":
        rec_host, _ = build_recommender("host")
        bench_recommend(rec_host, "host")
        bench_http(rec_dev)
    else:
        bench_http(rec_dev)
    bench_searchers(rec_dev.corpus)

    path = None
    if "--json" in sys.argv:
        path = sys.argv[sys.argv.index("--json") + 1]
    if path:
        with open(path, "w") as f:
            json.dump({
                "what": ("serving-path performance: Recommender.recommend "
                         "(encode+topk+history dedup, k=10, 30-item hist), "
                         "raw 65k x 16 searcher throughput, HTTP shim "
                         "latency; see scripts/serving_bench.py"),
                "backend": platform,
                "results": RESULTS,
            }, f, indent=2)
        print(f"wrote {path}")


if __name__ == "__main__":
    main()
