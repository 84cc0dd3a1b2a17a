"""ctypes bindings for the native C++ components (built on first use).

Two libraries under ``native/``:

- ``ann_topk``: host-side exact inner-product top-k, the faiss-equivalent
  serving primitive (the device path is :mod:`news_recsys_tpu.ops.topk`);
- ``text_parser``: one-pass C++ parser for the reference text feature
  format, replacing the reference's per-row Python parse
  (``data_reader.py:56-113``).

Both compile with the system ``g++`` into ``native/build/`` keyed by a
source hash; all callers must tolerate ``load_*() is None`` (no compiler /
sandboxed FS) and fall back to pure-Python paths.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
from typing import Dict, Optional, Tuple

import numpy as np

from .utils.logging import get_logger

logger = get_logger("native")

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_SRC_DIR = os.path.join(_ROOT, "native")
_BUILD_DIR = os.path.join(_SRC_DIR, "build")

_cache: Dict[str, Optional[ctypes.CDLL]] = {}


def _build_and_load(name: str) -> Optional[ctypes.CDLL]:
    if name in _cache:
        return _cache[name]
    src = os.path.join(_SRC_DIR, f"{name}.cpp")
    lib = None
    try:
        with open(src, "rb") as f:
            digest = hashlib.sha256(f.read()).hexdigest()[:16]
        os.makedirs(_BUILD_DIR, exist_ok=True)
        so_path = os.path.join(_BUILD_DIR, f"lib{name}_{digest}.so")
        if not os.path.exists(so_path):
            cmd = ["g++", "-O3", "-march=native", "-shared", "-fPIC",
                   "-o", so_path, src, "-lpthread"]
            logger.info(f"Building native lib: {' '.join(cmd)}")
            subprocess.run(cmd, check=True, capture_output=True, timeout=300)
        lib = ctypes.CDLL(so_path)
    except Exception as e:  # no compiler, read-only fs, ...
        logger.warning(f"Native lib '{name}' unavailable ({e}); using Python fallback")
        lib = None
    _cache[name] = lib
    return lib


# ---------------------------------------------------------------------------
# ANN top-k
# ---------------------------------------------------------------------------


def load_ann() -> Optional[ctypes.CDLL]:
    lib = _build_and_load("ann_topk")
    if lib is not None and not getattr(lib, "_configured", False):
        lib.ann_topk_ip.argtypes = [
            ctypes.POINTER(ctypes.c_float), ctypes.c_int64, ctypes.c_int64,
            ctypes.POINTER(ctypes.c_float), ctypes.c_int64, ctypes.c_int64,
            ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_float),
            ctypes.c_int32,
        ]
        lib.ann_l2_normalize.argtypes = [
            ctypes.POINTER(ctypes.c_float), ctypes.c_int64, ctypes.c_int64,
        ]
        lib._configured = True
    return lib


class HostTopKSearcher:
    """CPU exact IP top-k over a corpus snapshot (same API as the device
    :class:`~news_recsys_tpu.ops.topk.TopKSearcher`)."""

    def __init__(self, normalize: bool = False, n_threads: int = 0):
        self.normalize = normalize
        self.n_threads = n_threads or (os.cpu_count() or 1)
        self.corpus: Optional[np.ndarray] = None
        self._lib = load_ann()

    @property
    def available(self) -> bool:
        return self._lib is not None

    def update_embedding(self, embeddings) -> None:
        corpus = np.ascontiguousarray(np.asarray(embeddings, dtype=np.float32))
        if self.normalize:
            if self._lib is not None:
                self._lib.ann_l2_normalize(
                    corpus.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
                    corpus.shape[0], corpus.shape[1])
            else:
                norms = np.linalg.norm(corpus, axis=1, keepdims=True)
                corpus = corpus / np.maximum(norms, 1e-12)
        self.corpus = corpus

    def search(self, queries, k: int) -> Tuple[np.ndarray, np.ndarray]:
        if self.corpus is None:
            raise RuntimeError("update_embedding must be called before search")
        q = np.ascontiguousarray(np.asarray(queries, dtype=np.float32))
        if self.normalize:
            norms = np.linalg.norm(q, axis=1, keepdims=True)
            q = np.ascontiguousarray(q / np.maximum(norms, 1e-12))
        n, d = self.corpus.shape
        nq = q.shape[0]
        idx = np.empty((nq, k), dtype=np.int32)
        scores = np.empty((nq, k), dtype=np.float32)
        if self._lib is not None:
            self._lib.ann_topk_ip(
                self.corpus.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), n, d,
                q.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), nq, k,
                idx.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
                scores.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
                self.n_threads)
        else:
            s = q @ self.corpus.T
            part = np.argsort(-s, axis=1)[:, :k]
            idx[:] = part
            scores[:] = np.take_along_axis(s, part, axis=1)
        return idx, scores


# ---------------------------------------------------------------------------
# Text feature parser
# ---------------------------------------------------------------------------


def load_text_parser() -> Optional[ctypes.CDLL]:
    lib = _build_and_load("text_parser")
    if lib is not None and not getattr(lib, "_configured", False):
        lib.tp_count_rows.argtypes = [ctypes.c_char_p]
        lib.tp_count_rows.restype = ctypes.c_int64
        lib.tp_parse.argtypes = [
            ctypes.c_char_p, ctypes.c_char_p,
            ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int32),
            ctypes.c_int32,
            ctypes.POINTER(ctypes.POINTER(ctypes.c_int32)),
            ctypes.POINTER(ctypes.POINTER(ctypes.c_float)),
            ctypes.POINTER(ctypes.c_float), ctypes.c_int32,
        ]
        lib.tp_parse.restype = ctypes.c_int64
        lib._configured = True
    return lib


def parse_text_features_native(path: str, cfg, n_labels: int = 1) -> Optional[Dict[str, np.ndarray]]:
    """Native parse of the reference text format; None if lib unavailable.

    Feature set comes from the config (sparse/dense/array names), like the
    reference DataReader.
    """
    lib = load_text_parser()
    if lib is None:
        return None
    n = lib.tp_count_rows(path.encode())
    if n < 0:
        raise FileNotFoundError(path)

    f = cfg.features
    names, kinds, max_lens = [], [], []
    for name in f.sparse_feature_names:
        names.append(name); kinds.append(0); max_lens.append(0)
    for name in f.dense_feature_names:
        names.append(name); kinds.append(1); max_lens.append(0)
    for name in f.array_feature_names:
        names.append(name); kinds.append(2); max_lens.append(int(f.array_max_length[name]))

    int_bufs, float_bufs = [], []
    out: Dict[str, np.ndarray] = {}
    null_i = ctypes.POINTER(ctypes.c_int32)()
    null_f = ctypes.POINTER(ctypes.c_float)()
    for name, kind, L in zip(names, kinds, max_lens):
        if kind == 0:
            arr = np.zeros(n, dtype=np.int32)
            out[name] = arr
            int_bufs.append(arr.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)))
            float_bufs.append(null_f)
        elif kind == 1:
            arr = np.zeros(n, dtype=np.float32)
            out[name] = arr
            int_bufs.append(null_i)
            float_bufs.append(arr.ctypes.data_as(ctypes.POINTER(ctypes.c_float)))
        else:
            ids = np.zeros((n, L), dtype=np.int32)
            mask = np.zeros((n, L), dtype=np.float32)
            out[name] = ids
            out[f"{name}_mask"] = mask
            int_bufs.append(ids.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)))
            float_bufs.append(mask.ctypes.data_as(ctypes.POINTER(ctypes.c_float)))

    labels = np.zeros((n, n_labels), dtype=np.float32)
    nf = len(names)
    rows = lib.tp_parse(
        path.encode(), "\n".join(names).encode(),
        (ctypes.c_int32 * nf)(*kinds), (ctypes.c_int32 * nf)(*max_lens),
        nf,
        (ctypes.POINTER(ctypes.c_int32) * nf)(*int_bufs),
        (ctypes.POINTER(ctypes.c_float) * nf)(*float_bufs),
        labels.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), n_labels)
    if rows < 0:
        raise ValueError(f"Native parse failed with code {rows} for {path}")
    out["label"] = labels
    if rows != n:
        out = {k: v[:rows] for k, v in out.items()}
    return out
