"""Retrieval serving path: corpus index + top-k recommendation.

The reference ships ``TopKSearcher`` as a standalone faiss serving primitive
(``TopKSearcher.py:7-83``) but never wires it into an end-to-end serving
flow. This module does: load trained DSSM params, encode the item corpus
once, then serve batched user -> top-k-news queries with per-user history
dedup, on either backend:

- ``backend="device"``: exact matmul + ``lax.top_k`` on the accelerator;
- ``backend="host"``: the threaded C++ searcher (no accelerator needed);
- ``backend="auto"``: device when JAX's default device is an accelerator,
  host when it is the CPU.

A trained Recommender persists as a single self-contained **bundle**
directory (:meth:`Recommender.save` / :meth:`Recommender.load`): config +
params + pre-encoded corpus (+ vocab maps when available), so a serving
process starts without the training artifacts or an item re-encode. A
dependency-free HTTP shim (:func:`serve_http`) exposes it as a JSON API.
"""

from __future__ import annotations

import json
import os
import shutil
from functools import partial
from typing import List, Optional, Sequence, Tuple

import jax
import numpy as np

from .config import Config, config_from_dict, config_to_dict
from .data.packed_dataset import Batch, PackedDataset, iterate_batches
from .models.dssm import DSSM, _l2
from .training.checkpoint import load_tree, save_tree
from .utils.logging import get_logger

logger = get_logger("serving")

# the bundle layout: config.json + params.npz + corpus.npz + meta.json
BUNDLE_FORMAT_VERSION = 2
_VOCAB_FILES = ("original_val_2_embedding_idx_dict.json",
                "embedding_idx_2_original_val_dict.json")


def _save_model(path: str, cfg: Config, params) -> None:
    with open(os.path.join(path, "config.json"), "w") as f:
        json.dump(config_to_dict(cfg), f, indent=1)
    save_tree(os.path.join(path, "params.npz"), params)


def _load_model(path: str):
    with open(os.path.join(path, "config.json")) as f:
        cfg = config_from_dict(json.load(f))
    return cfg, load_tree(os.path.join(path, "params.npz"))


def _read_meta(path: str) -> dict:
    with open(os.path.join(path, "meta.json")) as f:
        meta = json.load(f)
    if meta["format_version"] != BUNDLE_FORMAT_VERSION:
        raise ValueError(f"Bundle {path} has format {meta['format_version']}; "
                         f"this version reads format {BUNDLE_FORMAT_VERSION}")
    return meta


class Recommender:
    def __init__(self, cfg: Config, model: DSSM, params, item_ds: Optional[PackedDataset] = None,
                 backend: str = "auto", batch_size: int = 1024,
                 _corpus: Optional[np.ndarray] = None,
                 _item_ids: Optional[np.ndarray] = None):
        self.cfg = cfg
        self.model = model
        self.params = params
        self.batch_size = batch_size
        self._encode_user = jax.jit(partial(model.apply, method=DSSM.user_embedding))
        self._encode_item = jax.jit(partial(model.apply, method=DSSM.item_embedding))

        if _corpus is not None:
            self.corpus = np.asarray(_corpus, np.float32)        # already L2-normed
            self.item_ids = np.asarray(_item_ids, np.int64)
        else:
            if item_ds is None:
                raise ValueError("Recommender needs item_ds (or a saved corpus)")
            corpus = self._encode(item_ds, self._encode_item)
            self.corpus = np.asarray(_l2(jax.numpy.asarray(corpus)))
            self.item_ids = item_ds.arrays["item_id"].astype(np.int64)

        if backend == "auto":
            backend = "device" if jax.devices()[0].platform != "cpu" else "host"
        if backend not in ("device", "host"):
            raise ValueError(f"backend must be auto|device|host, got {backend!r}")
        self.backend = backend
        if backend == "host":
            from .native import HostTopKSearcher
            self.searcher = HostTopKSearcher(normalize=False)
        else:
            from .ops.topk import TopKSearcher
            self.searcher = TopKSearcher(normalize=False)
        self.searcher.update_embedding(self.corpus)
        logger.info(f"Recommender ready: {len(self.item_ids)} items, backend={self.backend}")

    # -- persistence ---------------------------------------------------------

    def save(self, path: str) -> str:
        """Persist as a self-contained bundle directory.

        Layout: ``config.json`` (full round-trippable config),
        ``params.npz`` (tower + embedding params), ``corpus.npz``
        (L2-normalized item embeddings + item ids), ``meta.json``, and
        ``vocab/*.json`` (raw-value <-> embedding-id maps, copied from the
        feature-extraction output when present, for request-side decoding
        via :class:`~news_recsys_tpu.utils.feature_id_mapper.FeatureIdMapper`).
        """
        os.makedirs(path, exist_ok=True)
        _save_model(path, self.cfg, self.params)
        np.savez_compressed(os.path.join(path, "corpus.npz"),
                            corpus=self.corpus, item_ids=self.item_ids)
        fe_dir = os.path.join(self.cfg.paths.out_basedir, "extractored_feature")
        copied = []
        for fname in _VOCAB_FILES:
            src = os.path.join(fe_dir, fname)
            if os.path.exists(src):
                os.makedirs(os.path.join(path, "vocab"), exist_ok=True)
                shutil.copy(src, os.path.join(path, "vocab", fname))
                copied.append(fname)
        with open(os.path.join(path, "meta.json"), "w") as f:
            json.dump({"format_version": BUNDLE_FORMAT_VERSION,
                       "n_items": int(len(self.item_ids)),
                       "dim": int(self.corpus.shape[1]),
                       "vocab_files": copied}, f, indent=2)
        logger.info(f"Bundle saved -> {path}")
        return path

    @classmethod
    def load(cls, path: str, backend: str = "auto", batch_size: int = 1024) -> "Recommender":
        """Restore a bundle saved by :meth:`save`; no item re-encode."""
        from .models.dssm import build_dssm

        _read_meta(path)
        cfg, params = _load_model(path)
        with np.load(os.path.join(path, "corpus.npz")) as z:
            corpus, item_ids = z["corpus"], z["item_ids"]
        model = build_dssm(cfg)
        return cls(cfg, model, params, backend=backend, batch_size=batch_size,
                   _corpus=corpus, _item_ids=item_ids)

    def _encode(self, ds: PackedDataset, fn) -> np.ndarray:
        from .data.packed_dataset import encode_dataset
        return encode_dataset(self.params, ds, fn, self.batch_size)

    def recommend(self, user_batch: Batch, k: int = 10,
                  histories: Optional[Sequence[Sequence[int]]] = None
                  ) -> Tuple[List[List[int]], List[List[float]]]:
        """Top-k news ids per user row (history items excluded)."""
        users = PackedDataset({**user_batch})
        emb = self._encode(users, self._encode_user)
        emb = np.asarray(_l2(jax.numpy.asarray(emb)))
        max_hist = max((len(h) for h in histories), default=0) if histories else 0
        fetch = min(k + max_hist, len(self.item_ids))
        idx, scores = self.searcher.search(emb, fetch)
        rec_ids, rec_scores = [], []
        for row in range(len(emb)):
            hist = set(int(x) for x in histories[row]) if histories else set()
            ids_row, sc_row = [], []
            for j, i in enumerate(idx[row]):
                if i < 0:
                    continue
                item = int(self.item_ids[i])
                if item not in hist:
                    ids_row.append(item)
                    sc_row.append(float(scores[row][j]))
                if len(ids_row) >= k:
                    break
            rec_ids.append(ids_row)
            rec_scores.append(sc_row)
        return rec_ids, rec_scores


class CascadeRecommender:
    """Full recall -> rank cascade: DSSM retrieval narrows the corpus to
    ``fetch`` candidates, a ranking model (e.g. DCN) re-scores the
    (user, candidate) pairs, and the top-k by RANKER score is served.

    This is the production shape named in the build target ("full cascade:
    DSSM recall -> DCN rank"); the reference ships the two stages but never
    composes them. The ranker consumes each candidate's item-side features
    joined from the item corpus (`item_features.npz` from feature
    extraction), so the request needs only user-side features + history.
    """

    def __init__(self, recall: Recommender, ranker_cfg: Config, ranker_model,
                 ranker_params, item_ds: PackedDataset, fetch: int = 100):
        from .config import build_schema

        self.recall = recall
        self.ranker_cfg = ranker_cfg
        self.ranker_model = ranker_model
        self.ranker_params = ranker_params
        self.fetch = fetch
        self._score = jax.jit(ranker_model.apply)

        f = ranker_cfg.features
        self.item_feature_names = tuple(sorted(f.item_feature_names))
        self.user_feature_names = tuple(
            n for n in sorted(set(f.user_feature_names))
            if n not in set(f.item_feature_names))
        # item-id -> corpus row join table for the ranker's item features
        self.item_arrays = {k: np.asarray(v) for k, v in item_ds.arrays.items()}
        ids = self.item_arrays["item_id"].astype(np.int64)
        self._pos = np.zeros(int(ids.max()) + 2, np.int64)
        self._pos[ids] = np.arange(ids.size)

    # -- persistence ---------------------------------------------------------

    def save(self, path: str) -> str:
        """Bundle layout: ``recall/`` (a full :class:`Recommender` bundle) +
        ``ranker/{config.json, params.npz}`` + ``item_features.npz`` +
        ``meta.json``."""
        os.makedirs(path, exist_ok=True)
        self.recall.save(os.path.join(path, "recall"))
        rdir = os.path.join(path, "ranker")
        os.makedirs(rdir, exist_ok=True)
        _save_model(rdir, self.ranker_cfg, self.ranker_params)
        np.savez_compressed(os.path.join(path, "item_features.npz"),
                            **self.item_arrays)
        with open(os.path.join(path, "meta.json"), "w") as f:
            json.dump({"format_version": BUNDLE_FORMAT_VERSION,
                       "kind": "cascade", "fetch": self.fetch,
                       "ranker": self.ranker_cfg.name}, f, indent=2)
        logger.info(f"Cascade bundle saved -> {path}")
        return path

    @classmethod
    def load(cls, path: str, backend: str = "auto",
             fetch: Optional[int] = None) -> "CascadeRecommender":
        from .models.rankers import build_ranker

        meta = _read_meta(path)
        if meta.get("kind") != "cascade":
            raise ValueError(f"{path} is not a cascade bundle")
        recall = Recommender.load(os.path.join(path, "recall"), backend=backend)
        rcfg, rparams = _load_model(os.path.join(path, "ranker"))
        with np.load(os.path.join(path, "item_features.npz")) as z:
            item_ds = PackedDataset({k: z[k] for k in z.files})
        model = build_ranker(rcfg, rcfg.name)
        return cls(recall, rcfg, model, rparams, item_ds,
                   fetch=fetch or int(meta.get("fetch", 100)))

    # -- the cascade ---------------------------------------------------------

    def recommend(self, user_batch: Batch, k: int = 10,
                  histories: Optional[Sequence[Sequence[int]]] = None
                  ) -> Tuple[List[List[int]], List[List[float]]]:
        """Top-k per user row by RANKER score over the recall stage's
        ``fetch`` candidates (history already excluded by recall)."""
        cand_ids, _ = self.recall.recommend(user_batch, k=self.fetch,
                                            histories=histories)
        n_users = len(cand_ids)
        F = self.fetch
        # pad candidate lists to a fixed width; padded slots score -inf
        flat = np.zeros((n_users, F), np.int64)
        valid = np.zeros((n_users, F), bool)
        for r, ids_row in enumerate(cand_ids):
            m = len(ids_row)
            flat[r, :m] = ids_row
            valid[r, :m] = True
        safe = np.where(valid, flat, self.item_arrays["item_id"][0])
        rows = self._pos[safe].reshape(-1)

        batch: Batch = {}
        for name in self.user_feature_names:
            v = np.asarray(user_batch[name])
            batch[name] = np.repeat(v, F, axis=0)
            mask = user_batch.get(f"{name}_mask")
            if mask is not None:
                batch[f"{name}_mask"] = np.repeat(np.asarray(mask), F, axis=0)
        for name in self.item_feature_names:
            batch[name] = self.item_arrays[name][rows]
            m = self.item_arrays.get(f"{name}_mask")
            if m is not None:
                batch[f"{name}_mask"] = m[rows].astype(np.float32)
        batch["label"] = np.zeros((n_users * F, 1), np.float32)

        logits = np.asarray(self._score(self.ranker_params,
                                        jax.device_put(batch)))
        scores = np.where(valid, logits.reshape(n_users, F), -np.inf)
        order = np.argsort(-scores, axis=1)

        rec_ids, rec_scores = [], []
        for r in range(n_users):
            ids_row, sc_row = [], []
            for j in order[r][:k]:
                if not valid[r, j]:
                    break
                ids_row.append(int(flat[r, j]))
                sc_row.append(float(1 / (1 + np.exp(-scores[r, j]))))
            rec_ids.append(ids_row)
            rec_scores.append(sc_row)
        return rec_ids, rec_scores


def build_cascade(recall_bundle: str, ranker_ckpt: str, ranker_config: str,
                  fetch: int = 100, backend: str = "auto") -> CascadeRecommender:
    """Compose a cascade from a saved recall bundle + a trained ranker
    checkpoint (``epoch_*.npz`` or an experiment dir) + its config;
    item features come from the config's extracted item split."""
    from .config import load_config
    from .models.rankers import build_ranker

    recall = Recommender.load(recall_bundle, backend=backend)
    rcfg = load_config(ranker_config)
    from .cli import _resolve_ckpt
    ckpt = _resolve_ckpt(ranker_ckpt)
    model = build_ranker(rcfg, rcfg.name)
    tree = load_tree(ckpt)
    rparams = tree["params"] if "params" in tree and "step" in tree else tree
    item_ds = PackedDataset.open_split(rcfg, "item")
    return CascadeRecommender(recall, rcfg, model, rparams, item_ds, fetch=fetch)


# ---------------------------------------------------------------------------
# HTTP shim — dependency-free JSON API over a loaded Recommender
# ---------------------------------------------------------------------------


def _http_user_specs(rec) -> list:
    """User-side feature specs a request must supply: the recall tower's
    schema, plus (cascade) any ranker user features not already in it."""
    if isinstance(rec, CascadeRecommender):
        specs = list(rec.recall.model.user_schema.specs)
        have = {s.name for s in specs}
        ranker_schema = rec.ranker_model.schema
        for name in rec.user_feature_names:
            if name not in have and name in ranker_schema:
                specs.append(ranker_schema[name])
        return specs
    return list(rec.model.user_schema.specs)


def _user_batch_from_json(rec, users: dict) -> Batch:
    """JSON feature lists -> typed arrays for the user tower schema."""
    specs = _http_user_specs(rec)
    batch: Batch = {}
    n = None
    for spec in specs:
        if spec.name not in users:
            raise ValueError(f"missing user feature '{spec.name}' "
                             f"(required: {[s.name for s in specs]})")
        vals = users[spec.name]
        arr = (np.asarray(vals, np.float32) if spec.kind == "dense"
               else np.asarray(vals, np.int32))
        if n is None:
            n = len(arr)
        elif len(arr) != n:
            raise ValueError(f"feature '{spec.name}' length {len(arr)} != {n}")
        batch[spec.name] = arr
    if n is None:
        raise ValueError("no user features supplied")
    batch["label"] = np.zeros((n, 1), np.float32)
    return batch


def make_http_handler(rec: Recommender):
    """Request handler class bound to ``rec``.

    - ``GET /healthz`` -> ``{"status": "ok", "items": N, "backend": ...}``
    - ``POST /recommend`` with body
      ``{"users": {<feature>: [..], ...}, "k": 10, "histories": [[..], ...]}``
      -> ``{"ids": [[..]], "scores": [[..]]}``
    """
    from http.server import BaseHTTPRequestHandler

    class Handler(BaseHTTPRequestHandler):
        def _reply(self, code: int, obj) -> None:
            body = json.dumps(obj).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path == "/healthz":
                base = rec.recall if isinstance(rec, CascadeRecommender) else rec
                info = {"status": "ok", "items": int(len(base.item_ids)),
                        "backend": base.backend}
                if isinstance(rec, CascadeRecommender):
                    info.update(cascade=True, ranker=rec.ranker_cfg.name,
                                fetch=rec.fetch)
                self._reply(200, info)
            else:
                self._reply(404, {"error": f"unknown path {self.path}"})

        def do_POST(self):
            if self.path != "/recommend":
                self._reply(404, {"error": f"unknown path {self.path}"})
                return
            try:
                length = int(self.headers.get("Content-Length", 0))
                req = json.loads(self.rfile.read(length) or b"{}")
                batch = _user_batch_from_json(rec, req.get("users") or {})
                k = int(req.get("k", 10))
                if k <= 0:
                    raise ValueError(f"k must be positive, got {k}")
                histories = req.get("histories")
                ids, scores = rec.recommend(batch, k=k, histories=histories)
                self._reply(200, {"ids": ids, "scores": scores})
            except (ValueError, KeyError, TypeError, json.JSONDecodeError) as e:
                self._reply(400, {"error": str(e)})

        def log_message(self, fmt, *args):  # route through our logger
            logger.info("http: " + fmt % args)

    return Handler


def serve_http(rec: Recommender, host: str = "127.0.0.1", port: int = 8321):
    """Serve ``rec`` over HTTP until interrupted. Returns the server object
    (callers in tests can run ``serve_forever`` on a thread and shut down)."""
    from http.server import ThreadingHTTPServer

    server = ThreadingHTTPServer((host, port), make_http_handler(rec))
    logger.info(f"Serving on http://{host}:{server.server_address[1]} "
                f"(POST /recommend, GET /healthz)")
    return server
