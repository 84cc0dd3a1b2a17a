"""Attention-based sequence ranker over the user's click history.

New model family beyond the reference's zoo: the reference ships
``MultiHeadSelfAttention`` / ``TransformerBlock`` utilities but no model
uses them (``utils.py:20-61``; "generative recommendation" is a stated TODO
in its ``documents/TODO.md:5``). This ranker puts them to work, DIN/SASRec
style:

1. the ``hist`` array feature (padded item-id sequence, table shared with
   ``item_id``) is embedded WITHOUT mean-pooling (it is declared in
   ``unpooled_arrays`` — so it arrives as a raw (B, L, D) field);
2. masked Transformer blocks contextualize the sequence;
3. target-aware attention pools it: weights = softmax over history of
   (h_l . e_target)/sqrt(D), masked to real entries;
4. the pooled history vector joins the usual sorted-name field concat and
   feeds the standard MLP tower.

Because it subclasses :class:`RankerBase` and factors through
``forward_from_fields``, it works with BOTH optimizers — including the
sparse rowwise path (history row gradients flow through the unpooled
field).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from ..config import Config, build_schema, table_specs
from .layers import init_transformer_block, transformer_block
from .rankers import DeepRanker


class AttentionSeqRanker(DeepRanker):
    def __init__(self, *args, hist_feature: str = "hist", num_layers: int = 1,
                 num_heads: int = 2, ff_dim: int = 64, **kw):
        super().__init__(*args, **kw)
        self.hist_feature = hist_feature
        self.num_layers = num_layers
        self.num_heads = num_heads
        self.ff_dim = ff_dim

    def _init_tower(self, key):
        # the schema spec survives table renames (share-aliasing, arena
        # packing); resolving the dim via the raw table name does not
        dim = self.schema[self.hist_feature].dim
        keys = jax.random.split(key, self.num_layers + 1)
        blocks = {f"blocks_{i}": init_transformer_block(k, dim, self.ff_dim)
                  for i, k in enumerate(keys[1:])}
        return {**blocks, **super()._init_tower(keys[0])}

    def forward_from_fields(self, p, fields, masks=None):
        names = list(self.schema.names)
        hist_i = names.index(self.hist_feature)
        target_i = names.index("item_id")

        h = fields[hist_i]                                        # (B, L, D)
        mask = (masks or {}).get(self.hist_feature)
        if mask is None:
            mask = jnp.ones(h.shape[:2], jnp.float32)
        for i in range(self.num_layers):
            h = transformer_block(p[f"blocks_{i}"], h, self.num_heads, mask)

        # target-aware attention pooling
        target = fields[target_i]                                 # (B, D)
        scores = jnp.einsum("bld,bd->bl", h, target) / jnp.sqrt(
            jnp.asarray(h.shape[-1], jnp.float32))
        scores = jnp.where(mask > 0, scores, -1e9)
        alpha = jax.nn.softmax(scores, axis=-1)
        # rows with empty history: all -1e9 -> uniform alpha; zero them out
        alpha = alpha * (mask.sum(axis=1, keepdims=True) > 0)
        seq_vec = jnp.einsum("bl,bld->bd", alpha, h)

        flat = [f for i, f in enumerate(fields) if i != hist_i]
        x = jnp.concatenate(flat + [seq_vec], axis=1)
        return super().forward_from_fields(p, [x])


def build_attention_ranker(cfg: Config) -> AttentionSeqRanker:
    acfg = cfg.extra("attention_cfg", {}) or {}
    hist_feature = acfg.get("hist_feature", "hist")
    tables = tuple(sorted(table_specs(cfg).items()))
    f = cfg.features
    rank_names = sorted(set(f.user_feature_names) | set(f.item_feature_names))
    if hist_feature not in rank_names:
        raise ValueError(
            f"attention ranker needs '{hist_feature}' in user/item feature names")
    if "item_id" not in rank_names:
        raise ValueError("attention ranker needs 'item_id' for target-aware pooling")
    return AttentionSeqRanker(
        tables,
        build_schema(cfg, rank_names),
        unpooled_arrays=(hist_feature,),
        table_dtype=cfg.mesh.param_dtype,
        compute_dtype=cfg.mesh.compute_dtype,
        emb_init_scale=cfg.embeddings.init_scale,
        hist_feature=hist_feature,
        num_layers=int(acfg.get("num_layers", 1)),
        num_heads=int(acfg.get("num_heads", 2)),
        ff_dim=int(acfg.get("ff_dim", 64)),
    )
