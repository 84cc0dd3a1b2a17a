"""DSSM two-tower retrieval model with in-batch negatives + InfoNCE.

Capability rebuild of the reference's (MovieLens-era, partially stale) DSSM
(``src/model/recall/DSSM/model.py``), re-targeted to MIND:

- user/item towers: 4-layer MLP in->128->128->64->16 with LeakyReLU(0.2)
  (``DSSM/model.py:26-44``);
- in-batch negative sampling: ``negative_sample_rate`` random permutations
  of the item embeddings (``:58-66``) — permutations drawn inside the jitted
  step from the step rng;
- L2-normalized embeddings (``:69-71``); InfoNCE loss (temperature 0.1) with
  per-row masking (``:92-110,121``); triplet loss also provided (``:75-90``);
- retrieval eval: encode the full item corpus, exact matmul+top_k over all
  dev users **batched** (vs the reference's one-faiss-query-per-user loop,
  ``:182-228``), history dedup, HitRate@k / Recall@k.
"""

from __future__ import annotations

from functools import partial
from typing import Dict, Tuple

import jax
import jax.numpy as jnp

from ..config import Config, FeatureSchema, build_schema, table_specs
from .embedding import EmbeddingCollection
from .layers import Model, init_mlp, mlp

TOWER_DIMS = (128, 128, 64, 16)
_tower = partial(mlp, act=partial(jax.nn.leaky_relu, negative_slope=0.2))


class DSSM(Model):
    def __init__(self, tables: Tuple[Tuple[str, Tuple[int, int]], ...],
                 user_schema: FeatureSchema, item_schema: FeatureSchema,
                 emb_init_scale: float = 1.0):
        self.tables = tuple(tables)
        self.user_schema = user_schema
        self.item_schema = item_schema
        self.embedder = EmbeddingCollection(self.tables, init_scale=emb_init_scale)

    def init_params(self, key):
        ke, ku, ki = jax.random.split(key, 3)
        return {"embedder": self.embedder.init(ke),
                "user_fc": init_mlp(ku, self.user_schema.total_dim, TOWER_DIMS),
                "item_fc": init_mlp(ki, self.item_schema.total_dim, TOWER_DIMS)}

    def user_embedding(self, p, batch: Dict[str, jnp.ndarray]) -> jnp.ndarray:
        return _tower(p["user_fc"],
                      self.embedder.embed_batch(p["embedder"], batch, self.user_schema))

    def item_embedding(self, p, batch: Dict[str, jnp.ndarray]) -> jnp.ndarray:
        return _tower(p["item_fc"],
                      self.embedder.embed_batch(p["embedder"], batch, self.item_schema))

    def __call__(self, p, batch: Dict[str, jnp.ndarray]) -> Tuple[jnp.ndarray, jnp.ndarray]:
        return self.user_embedding(p, batch), self.item_embedding(p, batch)

    def towers_from_fields(self, p, user_fields, item_fields) -> Tuple[jnp.ndarray, jnp.ndarray]:
        """Tower outputs from pre-built per-field embedding lists (schema
        order) — the factoring the sparse rowwise-optimizer train step uses
        to differentiate w.r.t. gathered table rows (same contract as
        ``RankerBase.forward_from_fields``)."""
        return (_tower(p["user_fc"], jnp.concatenate(user_fields, axis=1)),
                _tower(p["item_fc"], jnp.concatenate(item_fields, axis=1)))


def build_dssm(cfg: Config) -> DSSM:
    tables = tuple(sorted(table_specs(cfg).items()))
    return DSSM(
        tables,
        build_schema(cfg, sorted(cfg.features.user_feature_names)),
        build_schema(cfg, sorted(cfg.features.item_feature_names)),
        emb_init_scale=cfg.embeddings.init_scale,
    )


def _l2(x, axis=-1):
    return x / jnp.maximum(jnp.linalg.norm(x, axis=axis, keepdims=True), 1e-12)


def sample_in_batch_negatives(rng, item_emb: jnp.ndarray, rate: int,
                              item_ids=None):
    """(B, D) -> (B, rate, D): ``rate`` random in-batch permutations.

    With ``item_ids`` also returns the permuted ids (B, rate) — needed by
    the logQ sampling-bias correction to look up each negative's sampling
    probability."""
    B = item_emb.shape[0]
    keys = jax.random.split(rng, rate)
    perms = jnp.stack([jax.random.permutation(k, B) for k in keys])  # (rate, B)
    neg = jnp.transpose(item_emb[perms], (1, 0, 2))                  # (B, rate, D)
    if item_ids is None:
        return neg
    return neg, jnp.transpose(item_ids[perms], (1, 0))               # (B, rate)


def info_nce_loss(user_emb, pos_item_emb, neg_item_emb, temperature: float = 0.1,
                  mask=None, log_q_pos=None, log_q_neg=None) -> jnp.ndarray:
    """InfoNCE with the positive at index 0 (``DSSM/model.py:92-110``).

    ``log_q_*``: sampling-bias (logQ) correction — each candidate's logit
    gets ``- log q(item)`` where ``q`` is its in-batch sampling probability
    (its empirical train frequency). Without it, popular items appear as
    negatives in proportion to their popularity and the learned score is
    popularity-DISCOUNTED pointwise mutual information; with it the score
    estimates ``log p(item | user)`` so popularity survives into retrieval
    (Yi et al. 2019). The reference's InfoNCE is uncorrected."""
    pos = jnp.sum(user_emb * pos_item_emb, axis=1) / temperature          # (B,)
    neg = jnp.einsum("bd,bnd->bn", user_emb, neg_item_emb) / temperature  # (B, n)
    if log_q_pos is not None:
        pos = pos - log_q_pos
    if log_q_neg is not None:
        neg = neg - log_q_neg
    logits = jnp.concatenate([pos[:, None], neg], axis=1)
    losses = -jax.nn.log_softmax(logits, axis=1)[:, 0]
    if mask is not None:
        losses = losses * mask
    return jnp.mean(losses)


def triplet_loss(user_emb, pos_item_emb, neg_item_emb, margin: float = 1.0,
                 mask=None) -> jnp.ndarray:
    """Reference triplet formulation (``DSSM/model.py:75-90``)."""
    n_neg = neg_item_emb.shape[1]
    pos = jnp.sum(user_emb * pos_item_emb, axis=1) * n_neg
    neg = jnp.sum(jnp.einsum("bd,bnd->bn", user_emb, neg_item_emb), axis=1)
    losses = jax.nn.relu(margin - pos + neg)
    if mask is not None:
        losses = losses * mask
    return jnp.mean(losses)


def dssm_loss_from_embeddings(rng, user_emb, item_emb, batch,
                              negative_sample_rate: int = 3,
                              temperature: float = 0.1, loss_type: str = "infonce",
                              margin: float = 1.0,
                              logq_table=None) -> jnp.ndarray:
    """Loss from raw tower outputs (negatives sampled, L2-normalized here).

    ``logq_table``: (V,) per-item ``log q`` lookup enabling the sampling-
    bias-corrected InfoNCE (``dssm_cfg.logq_correction``)."""
    user_emb = _l2(user_emb)
    item_emb_n = _l2(item_emb)
    # only positive (clicked) rows form training pairs; weight by validity too
    mask = batch["label"][:, 0] * batch.get("_valid", jnp.ones(user_emb.shape[0]))
    if logq_table is not None and loss_type == "infonce":
        ids = batch["item_id"]
        neg, neg_ids = sample_in_batch_negatives(rng, item_emb, negative_sample_rate,
                                                 item_ids=ids)
        return info_nce_loss(user_emb, item_emb_n, _l2(neg), temperature, mask,
                             log_q_pos=logq_table[ids],
                             log_q_neg=logq_table[neg_ids])
    neg = _l2(sample_in_batch_negatives(rng, item_emb, negative_sample_rate))
    if loss_type == "triplet":
        return triplet_loss(user_emb, item_emb_n, neg, margin, mask)
    return info_nce_loss(user_emb, item_emb_n, neg, temperature, mask)


def dssm_train_loss(model: DSSM, params, rng, batch, negative_sample_rate: int = 3,
                    temperature: float = 0.1, loss_type: str = "infonce",
                    margin: float = 1.0, logq_table=None) -> jnp.ndarray:
    user_emb, item_emb = model.apply(params, batch)
    return dssm_loss_from_embeddings(rng, user_emb, item_emb, batch,
                                     negative_sample_rate, temperature,
                                     loss_type, margin, logq_table=logq_table)


def item_log_q(train_ds, vocab: int) -> "np.ndarray":
    """Empirical in-batch sampling probability per item, as a (V,) log-q
    table: negatives are permutations of the batch's items, so q(i) is i's
    frequency among training rows. Unseen items floor at one pseudo-count
    (they never appear as negatives anyway)."""
    import numpy as np
    ids = np.asarray(train_ds.arrays["item_id"])
    # ids at/above vocab would lengthen bincount's output; clip the table
    # back to (V,) so lookups stay in range (corrupt ids don't train anyway)
    counts = np.bincount(ids, minlength=vocab).astype(np.float64)[:vocab]
    counts = np.maximum(counts, 1.0)
    q = counts / counts.sum()
    return np.log(q).astype(np.float32)
