"""Embedding engine: shared, shardable tables + the sorted-name concat contract.

Re-design of the reference's embedding machinery
(``base_model.py:141-166`` table construction, ``:262-282`` lookup/pooling,
``:284-308`` sorted-name gather+concat):

- one parameter per *unique* table (share-aliased features reuse a table);
- vocab row-counts are padded up to a multiple of 128 so tables divide
  evenly under row-sharding (``PartitionSpec('model', None)``) for any
  power-of-two mesh axis;
- row 0 is the padding row: lookups multiply by ``(ids != 0)`` which makes
  both the value and the gradient of row 0 exactly zero — the functional
  equivalent of torch ``nn.Embedding(padding_idx=0)``;
- array features are masked-mean pooled with the reference's ``+1e-8``
  denominator (``base_model.py:273-282``);
- the concat order is taken from :class:`~news_recsys_tpu.config.FeatureSchema`
  (sorted feature names) so FM / Wide&Deep column-slicing semantics are a
  schema-level invariant, not an implicit convention.
"""

from __future__ import annotations

from typing import Dict, Tuple

import jax
import jax.numpy as jnp

from ..config import ARRAY, DENSE, SPARSE, FeatureSchema


def offset_ids(spec, ids):
    """Logical feature ids -> physical table rows (arena packing): real ids
    shift by ``spec.id_offset``, padding id 0 stays 0.

    Arena members additionally clamp out-of-range logical ids
    (``>= member_vocab``) to padding: pre-arena, ``jnp.take``'s clip mode and
    per-table bounds kept a corrupt id inside the feature's OWN table; with
    packing it would otherwise silently read/write the NEXT member's rows.
    """
    if spec.member_vocab > 0:
        ok = (ids > 0) & (ids < spec.member_vocab)
        return jnp.where(ok, ids + spec.id_offset, 0)
    return ids

VOCAB_PAD_MULTIPLE = 128

# Tables with vocab below this always stay float32 (and, on the sparse
# optimizer path, use exact dense AdamW): their full-table memory traffic is
# trivial, so low-precision storage buys nothing and costs accuracy.
SMALL_VOCAB_THRESHOLD = 4096


def table_storage_dtype(table_dtype: str, vocab: int):
    """Storage dtype for a table: ``bfloat16`` applies to LARGE tables only.

    bf16 halves the device-memory footprint and gather/scatter traffic of the big id
    tables (user 94k x 32, item 65k x 32 in the reference config) — the
    dominant memory traffic of a recsys step — while small side tables
    (category/subcategory, vocab < SMALL_VOCAB_THRESHOLD) keep full
    precision at negligible cost.
    """
    if table_dtype == "bfloat16" and vocab >= SMALL_VOCAB_THRESHOLD:
        return jnp.bfloat16
    return jnp.float32


def padded_vocab(vocab: int) -> int:
    """Round vocab+1 up to a multiple of 128: divides evenly under
    row-sharding, and guarantees at least one spare row above
    all real ids (the sparse-optimizer scatter sink)."""
    return ((vocab + 1 + VOCAB_PAD_MULTIPLE - 1) // VOCAB_PAD_MULTIPLE) * VOCAB_PAD_MULTIPLE


def embedding_init(key, shape, scale: float = 1.0):
    """N(0, scale) table with a zeroed padding row. ``scale`` 1.0 is the torch
    ``nn.Embedding`` default the reference inherits (``embeddings.init_scale``);
    shallow models that score directly from raw embeddings (LR/FM) need a
    small scale to start un-saturated."""
    table = jax.random.normal(key, shape, jnp.float32) * scale
    return table.at[0].set(0.0)


class EmbeddingCollection:
    """Owns every embedding table's spec; provides init / lookup / pool / concat.

    ``tables``: mapping table-name -> (vocab, dim), typically from
    :func:`news_recsys_tpu.config.table_specs`. The tables themselves are the
    ``embedder`` subtree of a model's params, passed to every method.
    """

    def __init__(self, tables: Tuple[Tuple[str, Tuple[int, int]], ...],
                 table_dtype: str = "float32", init_scale: float = 1.0):
        self.tables = tuple(tables)
        # "float32" | "bfloat16": storage dtype for LARGE tables (see
        # table_storage_dtype); lookups always return float32.
        self.table_dtype = table_dtype
        # N(0, init_scale) table init; 1.0 = torch default (reference parity)
        self.init_scale = init_scale

    def init(self, key) -> Dict[str, jnp.ndarray]:
        keys = jax.random.split(key, max(len(self.tables), 1))
        return {name: embedding_init(k, (padded_vocab(vocab), dim),
                                     self.init_scale).astype(
                    table_storage_dtype(self.table_dtype, vocab))
                for k, (name, (vocab, dim)) in zip(keys, self.tables)}

    # -- single-feature ops -------------------------------------------------

    @staticmethod
    def lookup(table: jnp.ndarray, ids: jnp.ndarray) -> jnp.ndarray:
        """Gather rows; id 0 (padding) yields exact zeros (value and grad).

        With an active explicit-collectives mesh
        (:func:`news_recsys_tpu.parallel.sharded_embedding.set_active_mesh`)
        the gather runs as a shard_map local-lookup + psum over the row
        shards; otherwise GSPMD partitions the plain take.
        """
        from ..parallel.sharded_embedding import active_mesh, sharded_lookup

        ctx = active_mesh()
        if ctx is not None:
            mesh, model_axis, data_axis = ctx
            emb = sharded_lookup(table, ids, mesh, model_axis, data_axis)
        else:
            emb = jnp.take(table, ids, axis=0)
        # bf16-stored tables upcast after the gather: reads move half the
        # bytes, downstream field math stays float32.
        emb = emb.astype(jnp.float32)
        return emb * (ids != 0).astype(emb.dtype)[..., None]

    @staticmethod
    def pool(emb: jnp.ndarray, mask: jnp.ndarray) -> jnp.ndarray:
        """Masked mean over axis 1: (B, L, D), (B, L) -> (B, D)."""
        mask = mask.astype(emb.dtype)[..., None]
        return (emb * mask).sum(axis=1) / (mask.sum(axis=1) + 1e-8)

    # -- batch-level contract ----------------------------------------------

    def embed_fields(self, tables, batch: Dict[str, jnp.ndarray], schema: FeatureSchema,
                     unpooled=()):
        """Per-field embeddings in schema (sorted-name) order: list of (B, d_f).

        Dense features contribute their raw value as one column
        (``base_model.py:262-265``). Array features in ``unpooled`` return
        their raw (B, L, D) sequence instead of the masked mean (sequence
        models pool them themselves).

        Lookups stay one take per feature, also for features that share a
        table.
        """
        parts = []
        for spec in schema.specs:
            val = batch[spec.name]
            if spec.kind != DENSE:
                val = offset_ids(spec, val)
            if spec.kind == DENSE:
                parts.append(val.astype(jnp.float32)[:, None])
            elif spec.kind == SPARSE:
                if val.ndim != 1:
                    raise ValueError(
                        f"Sparse feature '{spec.name}' has {val.ndim}-D input "
                        f"{val.shape}; sequence features must be declared in "
                        "features.array_feature_names (with array_max_length).")
                parts.append(self.lookup(tables[spec.table], val))
            elif spec.kind == ARRAY:
                if spec.name in unpooled:
                    parts.append(self.lookup(tables[spec.table], val))   # (B, L, D)
                    continue
                mask = batch.get(f"{spec.name}_mask")
                if mask is None:
                    mask = (val != 0)
                parts.append(self.pool(self.lookup(tables[spec.table], val), mask))
            else:
                raise ValueError(spec.kind)
        return parts

    def embed_batch(self, tables, batch: Dict[str, jnp.ndarray],
                    schema: FeatureSchema) -> jnp.ndarray:
        """Concat per-feature embeddings in schema (sorted-name) order.

        Returns (B, schema.total_dim) — the reference's
        ``get_embeddings_from_batch`` contract (``base_model.py:284-308``).
        """
        return jnp.concatenate(self.embed_fields(tables, batch, schema), axis=1)

