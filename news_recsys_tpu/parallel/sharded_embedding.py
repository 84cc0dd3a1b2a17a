"""Explicit shard_map embedding lookup over a row-sharded table.

The default path lets XLA GSPMD partition ``jnp.take`` from a
``P('model', None)``-sharded table automatically. This module spells the
collective out (the scaling-book recipe) for predictable performance and as
the building block for multi-host table sharding:

- shard ``s`` of the ``model`` axis owns rows ``[s*V/n, (s+1)*V/n)``;
- each shard looks up only locally owned ids (out-of-range ids clamp and
  mask to zero) — no id exchange needed because every shard sees the full
  (data-sharded) id batch;
- one ``psum`` over the ``model`` axis assembles the result (each row is
  non-zero on exactly one shard);
- the backward pass is autodiff through the same program: the local masked
  gather transposes to a local scatter-add (each shard accumulates exactly
  its own rows' gradients) and the ``psum`` transposes to an identity on
  the already-sharded cotangent — i.e. sparse gradient reduce-scatter falls
  out for free.

Vocab sizes are padded to multiples of 128
(:mod:`news_recsys_tpu.models.embedding`) so rows split evenly.
"""

from __future__ import annotations

from functools import partial
from typing import Optional

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P
from jax import shard_map

# Module-level active mesh for model code that cannot thread a Mesh through
# (model methods take params, not a mesh). Set by the Trainer.
_ACTIVE: Optional[tuple] = None  # (mesh, model_axis, data_axis)


def set_active_mesh(mesh: Optional[Mesh], model_axis: str = "model",
                    data_axis: str = "data") -> None:
    global _ACTIVE
    if mesh is None or model_axis not in mesh.axis_names or mesh.shape[model_axis] <= 1:
        _ACTIVE = None
    else:
        _ACTIVE = (mesh, model_axis, data_axis)


def active_mesh():
    return _ACTIVE


def sharded_lookup(table: jnp.ndarray, ids: jnp.ndarray, mesh: Mesh,
                   model_axis: str = "model", data_axis: str = "data") -> jnp.ndarray:
    """Gather rows of a row-sharded (V, D) table for (data-sharded) ids.

    ids may have any shape; the leading dim is sharded over ``data_axis``.
    Returns ids.shape + (D,), sharded like ids.
    """
    id_spec = P(data_axis) if ids.ndim == 1 else P(data_axis, *([None] * (ids.ndim - 1)))
    out_spec = P(data_axis, *([None] * ids.ndim))

    @partial(
        shard_map,
        mesh=mesh,
        in_specs=(P(model_axis, None), id_spec),
        out_specs=out_spec,
    )
    def f(tbl, ids_local):
        shard = jax.lax.axis_index(model_axis)
        rows_local = tbl.shape[0]
        local = ids_local - shard * rows_local
        ok = (local >= 0) & (local < rows_local)
        emb = jnp.take(tbl, jnp.clip(local, 0, rows_local - 1), axis=0)
        emb = emb * ok.astype(emb.dtype)[..., None]
        return jax.lax.psum(emb, model_axis)

    return f(table, ids)
