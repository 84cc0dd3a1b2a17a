"""Ranking model zoo: LR, Deep (DNN), Wide&Deep, FM, DCN v1/v2.

Functional parity with the reference's ``src/model/sort/*`` models, written
as plain JAX over the shared :class:`EmbeddingCollection`. Every model
returns **logits** ``(B,)``; sigmoid lives in the loss / inference wrapper
(numerically better than the reference's probability-space BCE,
mathematically identical).

Slicing contracts (explicit here, implicit in the reference):
- FM: per field, column 0 of the embedding is the first-order weight ``w``,
  columns 1..d the latent vector ``v`` (``fm/model.py:48-59``); second order
  via the ½[(Σv)² − Σv²] identity (``fm/model.py:18-26``).
- Wide&Deep: for wide features, column 0 is the wide (linear) part, columns
  1..d the deep part (``widedeep/model.py:53-69``).
- DCN v1 cross: ``x0 · (x_l^T w) + b + x_l`` (``dcn_arch.py:5-30``), with the
  rank-1 structure exploited: ``(x0 x_l^T) w == x0 * (x_l · w)`` — a dot and
  a broadcast instead of a BxDxD outer product (O(BD) memory instead of
  O(BD²)).
- DCN v2: ``x0 * Linear(x_l) + x_l`` (``dcn_arch.py:33-50``).
"""

from __future__ import annotations

import math
from typing import Dict, Sequence, Tuple

import jax
import jax.numpy as jnp

from ..config import Config, FeatureSchema, build_schema, table_specs
from .embedding import EmbeddingCollection
from .layers import Model, init_linear, init_mlp, linear, mlp

DEFAULT_HIDDEN = (128, 128, 128, 64, 1)


def fm_second_order(v: jnp.ndarray) -> jnp.ndarray:
    """(B, F, D) field latent vectors -> (B,) second-order interaction
    ``0.5 * sum_d [(sum_f v_fd)^2 - sum_f v_fd^2]``."""
    sum_v = jnp.sum(v, axis=1)
    return 0.5 * jnp.sum(sum_v * sum_v - jnp.sum(v * v, axis=1), axis=1)


def cross_v1(x0: jnp.ndarray, ws: jnp.ndarray, bs: jnp.ndarray) -> jnp.ndarray:
    """DCN-v1 cross stack: x0 (B, D), ws (NL, D), bs (NL, D) -> (B, D) after
    NL layers of ``x_{l+1} = x0 * (x_l . w_l) + b_l + x_l``."""
    x = x0
    for l in range(ws.shape[0]):
        x = x0 * (x @ ws[l])[:, None] + bs[l] + x
    return x


class RankerBase(Model):
    """Shared plumbing: embedding collection + rank-feature schema.

    Every ranker factors as ``__call__ = forward_from_fields(embed_fields)``;
    the sparse-embedding train step exploits this split to differentiate
    w.r.t. the per-field embeddings instead of the full tables
    (:mod:`news_recsys_tpu.training.sparse_step`).
    """

    def __init__(self, tables: Tuple[Tuple[str, Tuple[int, int]], ...],
                 schema: FeatureSchema, unpooled_arrays: Tuple[str, ...] = (),
                 table_dtype: str = "float32", compute_dtype: str = "float32",
                 emb_init_scale: float = 1.0):
        self.tables = tuple(tables)
        self.schema = schema
        # array features consumed as raw (B, L, D) sequences instead of
        # mean-pooled vectors (their masks travel via the ``masks`` argument)
        self.unpooled_arrays = tuple(unpooled_arrays)
        # mesh.param_dtype / mesh.compute_dtype from the config: large-table
        # storage dtype and tower matmul dtype ("float32" | "bfloat16").
        self.table_dtype = table_dtype
        self.compute_dtype = compute_dtype
        self.embedder = EmbeddingCollection(self.tables, table_dtype, emb_init_scale)

    @property
    def tower_dtype(self):
        return jnp.bfloat16 if self.compute_dtype == "bfloat16" else None

    def init_params(self, key):
        k_emb, k_tower = jax.random.split(key)
        return {"embedder": self.embedder.init(k_emb), **self._init_tower(k_tower)}

    def _init_tower(self, key) -> Dict:
        return {}

    def __call__(self, p, batch: Dict[str, jnp.ndarray]) -> jnp.ndarray:
        fields = self.embedder.embed_fields(p["embedder"], batch, self.schema,
                                            unpooled=set(self.unpooled_arrays))
        return self.forward_from_fields(p, fields, self._collect_masks(batch))

    def _collect_masks(self, batch):
        masks = {}
        for name in self.unpooled_arrays:
            m = batch.get(f"{name}_mask")
            if m is None:
                m = (batch[name] != 0).astype(jnp.float32)
            masks[name] = m
        return masks

    def forward_from_fields(self, p, fields, masks=None) -> jnp.ndarray:
        raise NotImplementedError


class LRRanker(RankerBase):
    """Logistic regression via dim-1 embeddings: logit = Σ features.

    Reference: ``lr/model.py:17-27`` (score_fc = torch.sum over the concat).
    """

    def forward_from_fields(self, p, fields, masks=None):
        return jnp.sum(jnp.concatenate(fields, axis=1), axis=1)


class DeepRanker(RankerBase):
    """Concat embeddings -> MLP [128,128,128,64,1] (``deep/model.py:12-29``)."""

    def __init__(self, *args, hidden: Sequence[int] = DEFAULT_HIDDEN, **kw):
        super().__init__(*args, **kw)
        self.hidden = tuple(hidden)

    def _init_tower(self, key):
        return {"tower": init_mlp(key, self.schema.total_dim, self.hidden)}

    def forward_from_fields(self, p, fields, masks=None):
        return mlp(p["tower"], jnp.concatenate(fields, axis=1), self.tower_dtype)[:, 0]


class WideDeepRanker(RankerBase):
    """Wide (sum of column-0 slices + bias) + Deep MLP (``widedeep/model.py``)."""

    def __init__(self, *args, wide_features: Tuple[str, ...] = (),
                 hidden: Sequence[int] = DEFAULT_HIDDEN, **kw):
        super().__init__(*args, **kw)
        self.wide_features = tuple(wide_features)
        self.hidden = tuple(hidden)

    def _init_tower(self, key):
        n_wide = sum(1 for s in self.schema.specs if s.name in self.wide_features)
        return {"tower": init_mlp(key, self.schema.total_dim - n_wide, self.hidden),
                "bias": jnp.zeros((1,), jnp.float32)}

    def forward_from_fields(self, p, fields, masks=None):
        wide_cols, deep_cols = [], []
        for spec, emb in zip(self.schema.specs, fields):
            if spec.name in self.wide_features:
                wide_cols.append(emb[:, 0:1])
                deep_cols.append(emb[:, 1:])
            else:
                deep_cols.append(emb)
        wide_out = jnp.sum(jnp.concatenate(wide_cols, axis=1), axis=1) + p["bias"][0]
        deep_out = mlp(p["tower"], jnp.concatenate(deep_cols, axis=1),
                       self.tower_dtype)[:, 0]
        return wide_out + deep_out


def _fm_terms(fields):
    if len({e.shape[1] for e in fields}) != 1:
        raise ValueError("FM requires equal embedding dims across fields")
    w = jnp.concatenate([e[:, 0:1] for e in fields], axis=1)      # (B, nf)
    v = jnp.stack([e[:, 1:] for e in fields], axis=1)             # (B, nf, d-1)
    return jnp.sum(w, axis=1) + fm_second_order(v)


class FMRanker(RankerBase):
    """Factorization machine on column-sliced embeddings (``fm/model.py``)."""

    def _init_tower(self, key):
        return {"bias": jnp.zeros((1,), jnp.float32)}

    def forward_from_fields(self, p, fields, masks=None):
        return p["bias"][0] + _fm_terms(fields)


class DeepFMRanker(DeepRanker):
    """DeepFM: FM first+second order PLUS a deep MLP tower over the same
    shared embeddings, summed into one logit (Guo et al. 2017).

    The reference zoo ships FM and Deep separately (``src/model/sort/{fm,deep}``);
    this combines them on the shared-embedding contract: the FM part slices
    column 0 / columns 1.. exactly like :class:`FMRanker`, the deep part
    consumes the full concat like :class:`DeepRanker`.
    """

    def _init_tower(self, key):
        return {**super()._init_tower(key), "bias": jnp.zeros((1,), jnp.float32)}

    def forward_from_fields(self, p, fields, masks=None):
        deep = mlp(p["tower"], jnp.concatenate(fields, axis=1), self.tower_dtype)[:, 0]
        return p["bias"][0] + _fm_terms(fields) + deep


class DCNRanker(DeepRanker):
    """Cross net + MLP over concat[x, cross(x)] (``dcn/model.py:16-29``).

    v1 cross params match the per-layer reference (w_i: (dim, 1), b_i: (dim,),
    ``dcn_arch.py:7-11``); v2 stacks ``Linear(dim)`` layers with ReLU between
    (``dcn_arch.py:69-90``).
    """

    def __init__(self, *args, cross_layers: int = 3, cross_version: int = 1, **kw):
        super().__init__(*args, **kw)
        self.cross_layers = cross_layers
        self.cross_version = cross_version

    def _init_tower(self, key):
        dim = self.schema.total_dim
        k_cross, k_tower = jax.random.split(key)
        keys = jax.random.split(k_cross, self.cross_layers)
        if self.cross_version == 1:
            # xavier_uniform over a (dim, 1) kernel: U(±sqrt(6 / (dim + 1)))
            bound = math.sqrt(6.0 / (dim + 1))
            cross = {}
            for i, k in enumerate(keys):
                cross[f"w_{i}"] = jax.random.uniform(k, (dim, 1), jnp.float32,
                                                     -bound, bound)
                cross[f"b_{i}"] = jnp.zeros((dim,), jnp.float32)
        else:
            cross = {f"Linear_{i}": init_linear(k, dim, dim) for i, k in enumerate(keys)}
        return {"cross": cross, "tower": init_mlp(k_tower, 2 * dim, self.hidden)}

    def _cross(self, p, x0):
        if self.cross_version == 1:
            ws = jnp.stack([p[f"w_{i}"][:, 0] for i in range(self.cross_layers)])
            bs = jnp.stack([p[f"b_{i}"] for i in range(self.cross_layers)])
            return cross_v1(x0, ws, bs)
        x = x0
        for i in range(self.cross_layers):
            x = jax.nn.relu(x0 * linear(p[f"Linear_{i}"], x) + x)
        return x

    def forward_from_fields(self, p, fields, masks=None):
        x = jnp.concatenate(fields, axis=1)
        cross = self._cross(p["cross"], x)
        return mlp(p["tower"], jnp.concatenate([x, cross], axis=1),
                   self.tower_dtype)[:, 0]


# ---------------------------------------------------------------------------
# Registry / constructors
# ---------------------------------------------------------------------------


def build_ranker(cfg: Config, name: str | None = None) -> RankerBase:
    """Construct a ranker by name with config-driven schema and tables."""
    name = name or cfg.name
    tables = tuple(sorted(table_specs(cfg).items()))
    schema = build_schema(cfg)
    dtypes = dict(table_dtype=cfg.mesh.param_dtype,
                  compute_dtype=cfg.mesh.compute_dtype,
                  emb_init_scale=cfg.embeddings.init_scale)
    if name == "lr":
        return LRRanker(tables, schema, **dtypes)
    if name == "deep":
        return DeepRanker(tables, schema, **dtypes)
    if name == "widedeep":
        wd = cfg.extra("wide_and_deep_cfg", {}) or {}
        wide = tuple(wd.get("wide_feature_names", ()))
        matching = [f for f in wide if f in schema]
        if not matching:
            raise ValueError(
                "widedeep requires wide_and_deep_cfg.wide_feature_names with at "
                f"least one feature from the rank schema {schema.names}; got {wide!r}"
            )
        return WideDeepRanker(tables, schema, wide_features=wide, **dtypes)
    if name == "fm":
        return FMRanker(tables, schema, **dtypes)
    if name == "deepfm":
        return DeepFMRanker(tables, schema, **dtypes)
    if name == "dcn":
        dcn = cfg.extra("dcn_cfg", {}) or {}
        return DCNRanker(tables, schema,
                         cross_layers=int(dcn.get("num_layers", 3)),
                         cross_version=int(dcn.get("version", 1)),
                         **dtypes)
    if name == "attention":
        from .seq_ranker import build_attention_ranker
        return build_attention_ranker(cfg)
    raise ValueError(f"Unknown ranker: {name!r}")


RANKER_NAMES = ("lr", "deep", "widedeep", "fm", "deepfm", "dcn", "attention")
