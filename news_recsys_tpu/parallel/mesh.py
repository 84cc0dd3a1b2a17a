"""Device mesh + parameter sharding rules.

The reference is strictly single-GPU (every trainer pins one device,
``deep/train.py:42-43``); parallelism is new capability:

- a 2D ``('data', 'model')`` mesh: batches sharded over ``data``
  (data parallelism — gradients all-reduced by XLA), embedding tables
  row-sharded over ``model`` (tensor parallelism for the only memory-heavy
  state: user 94k x 32 / item 65k x 32 tables, ``train_cf_deep.yaml:38-44``);
- dense tower params are replicated; XLA GSPMD inserts the collectives
  (psum for dense grads, gather/psum pairs for row-sharded table lookups)
  from the sharding annotations alone — no hand-written NCCL-style code.

Table vocab sizes are padded to a multiple of 128 rows
(:mod:`news_recsys_tpu.models.embedding`), so row-sharding divides evenly
for any power-of-two ``model`` axis.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..config import MeshConfig


def make_mesh(data: int = -1, model: int = 1, devices=None) -> Mesh:
    devices = list(devices if devices is not None else jax.devices())
    n = len(devices)
    if data == -1:
        assert n % model == 0, f"{n} devices not divisible by model={model}"
        data = n // model
    assert data * model == n, f"mesh {data}x{model} != {n} devices"
    dev_array = np.asarray(devices).reshape(data, model)
    return Mesh(dev_array, axis_names=("data", "model"))


def mesh_from_config(cfg: MeshConfig, devices=None) -> Mesh:
    return make_mesh(data=cfg.data, model=cfg.model, devices=devices)


def _is_embedding_table(path) -> bool:
    keys = [getattr(p, "key", getattr(p, "name", str(p))) for p in path]
    return "embedder" in keys


def param_shardings(params: Any, mesh: Mesh) -> Any:
    """Pytree of NamedShardings: embedding tables row-sharded over 'model'
    (when the axis exists and is >1), everything else replicated."""
    model_parallel = "model" in mesh.axis_names and mesh.shape["model"] > 1

    def spec_for(path, leaf):
        if model_parallel and _is_embedding_table(path) and getattr(leaf, "ndim", 0) == 2:
            return NamedSharding(mesh, P("model", None))
        return NamedSharding(mesh, P())

    return jax.tree_util.tree_map_with_path(spec_for, params)


def batch_sharding(mesh: Mesh) -> NamedSharding:
    """Leading-dim (batch) sharding over the 'data' axis."""
    return NamedSharding(mesh, P("data"))


def replicated(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P())


def shard_batch(batch: Dict[str, np.ndarray], mesh: Optional[Mesh]):
    """Device-put a host batch, sharding every leaf's leading dim over 'data'."""
    if mesh is None:
        return jax.device_put(batch)
    sh = batch_sharding(mesh)
    return jax.device_put(batch, sh)
