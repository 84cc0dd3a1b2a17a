"""Exact ANN search: batched matmul + top_k on device.

Device replacement for the reference's faiss ``IndexFlatIP`` wrapper
(``src/model/model_utils/TopKSearcher.py:19-83``) and DSSM's per-user faiss
loop (``DSSM/model.py:186-228``): a ~65k x 16 corpus is small, so exact
inner-product top-k is one (B, D) x (D, N) matmul + ``jax.lax.top_k`` per
query batch — no external index, no host round-trips. The matmul runs at
JAX's default precision, which on a GPU may be TF32.
"""

from __future__ import annotations

from functools import partial
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np


@partial(jax.jit, static_argnames=("k",))
def _search(corpus: jnp.ndarray, queries: jnp.ndarray, k: int):
    scores = jnp.dot(queries, corpus.T, preferred_element_type=jnp.float32)
    top_scores, top_idx = jax.lax.top_k(scores, k)
    return top_idx, top_scores


def l2_normalize(x: jnp.ndarray, axis: int = -1, eps: float = 1e-12) -> jnp.ndarray:
    return x / jnp.maximum(jnp.linalg.norm(x, axis=axis, keepdims=True), eps)


class TopKSearcher:
    """Inner-product (optionally cosine) exact top-k over an embedding corpus.

    API parity with the reference ``TopKSearcher``: ``update_embedding``
    snapshots a corpus; ``search`` returns (indices, scores).
    """

    def __init__(self, normalize: bool = False):
        self.normalize = normalize
        self.corpus: Optional[jnp.ndarray] = None

    def update_embedding(self, embeddings) -> None:
        corpus = jnp.asarray(embeddings, dtype=jnp.float32)
        if self.normalize:
            corpus = l2_normalize(corpus)
        self.corpus = corpus

    def search(self, queries, k: int, batch_size: int = 8192) -> Tuple[np.ndarray, np.ndarray]:
        if self.corpus is None:
            raise RuntimeError("update_embedding must be called before search")
        queries = jnp.asarray(queries, dtype=jnp.float32)
        if self.normalize:
            queries = l2_normalize(queries)
        idx_out, score_out = [], []
        for start in range(0, queries.shape[0], batch_size):
            q = queries[start : start + batch_size]
            idx, scores = _search(self.corpus, q, k)
            idx_out.append(np.asarray(idx))
            score_out.append(np.asarray(scores))
        return np.concatenate(idx_out), np.concatenate(score_out)
