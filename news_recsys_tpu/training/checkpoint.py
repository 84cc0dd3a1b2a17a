"""Checkpoint formats: host ``.npz`` trees and sharded Orbax resume.

The reference relies on Lightning's per-epoch weight-only checkpoints with
no mid-epoch resume (``DSSM/train.py:54-60``, ``base_model.py:531-536``).
Here:

- per-epoch checkpoints and serving bundles are ``.npz`` files of the
  flattened state: one array per leaf, keyed by its ``/``-joined path
  (``params/params/embedder/item_id``); bf16 leaves are stored as their
  uint16 bit pattern under a ``::bfloat16`` suffix. Restoring into a template
  is strict: every key, shape and dtype must match;
- mid-epoch resume saves the full train state (params + optimizer moments +
  step) with Orbax, sharded arrays written natively (each host writes its
  shards on multi-host), and restores it **mesh-flexibly**: the target
  shardings come from the restore context, so a checkpoint written on one
  mesh loads onto a different mesh (or a single device). Orbax is imported
  only when this is used.
"""

from __future__ import annotations

import os
from typing import Any, Dict, Optional

import jax
import jax.numpy as jnp
import numpy as np

from ..utils.logging import get_logger

logger = get_logger("checkpoint")

_BF16_SUFFIX = "::bfloat16"


def _key_name(key) -> str:
    for attr in ("key", "name", "idx"):
        if hasattr(key, attr):
            return str(getattr(key, attr))
    raise TypeError(f"unsupported pytree key {key!r}")


def _flat_arrays(tree) -> Dict[str, np.ndarray]:
    out = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(jax.device_get(tree))[0]:
        out["/".join(_key_name(k) for k in path)] = np.asarray(leaf)
    return out


def save_tree(path: str, tree: Any) -> str:
    """Write every array leaf of ``tree`` to one ``.npz`` file at ``path``."""
    arrays = {}
    for name, arr in _flat_arrays(tree).items():
        if arr.dtype == jnp.bfloat16:
            arrays[name + _BF16_SUFFIX] = arr.view(np.uint16)
        else:
            arrays[name] = arr
    with open(path, "wb") as f:
        np.savez(f, **arrays)
    return path


def _read_arrays(path: str) -> Dict[str, np.ndarray]:
    out = {}
    with np.load(path) as z:
        for name in z.files:
            arr = z[name]
            if name.endswith(_BF16_SUFFIX):
                name, arr = name[: -len(_BF16_SUFFIX)], arr.view(jnp.bfloat16)
            out[name] = arr
    return out


def load_tree(path: str) -> Dict[str, Any]:
    """Read a :func:`save_tree` file as nested dicts (sequence positions
    become ``"0"``, ``"1"``, ... keys)."""
    root: Dict[str, Any] = {}
    for name, arr in _read_arrays(path).items():
        node = root
        *parents, leaf = name.split("/")
        for part in parents:
            node = node.setdefault(part, {})
        node[leaf] = arr
    return root


def restore_tree(path: str, like: Any) -> Any:
    """Read a :func:`save_tree` file into the structure of ``like``.

    Strict, like the reference's ``load_model`` (``base_model.py:531-536``):
    a missing or unexpected key, or a leaf whose shape or dtype differs from
    ``like``'s, raises ``ValueError``.
    """
    arrays = _read_arrays(path)
    template = _flat_arrays(like)
    missing = sorted(set(template) - set(arrays))
    extra = sorted(set(arrays) - set(template))
    if missing or extra:
        raise ValueError(f"checkpoint {path} does not match the state: "
                         f"missing {missing[:5]}, unexpected {extra[:5]}")
    for name, want in template.items():
        got = arrays[name]
        if got.shape != want.shape or got.dtype != want.dtype:
            raise ValueError(f"checkpoint {path}: '{name}' is {got.dtype}{got.shape}, "
                             f"the state holds {want.dtype}{want.shape}")
    treedef = jax.tree_util.tree_structure(like)
    return jax.tree_util.tree_unflatten(treedef, [arrays[n] for n in template])


class CheckpointManager:
    """Thin Orbax wrapper: step-indexed directories with retention."""

    def __init__(self, directory: str, max_to_keep: Optional[int] = None):
        try:
            import orbax.checkpoint as ocp
        except ImportError as e:
            raise ImportError(
                "mid-epoch checkpoints and resume (train_hparams.ckpt_every_steps, "
                "fit(resume=True)) need the 'orbax-checkpoint' package") from e
        self._ocp = ocp
        self.directory = os.path.abspath(directory)
        os.makedirs(self.directory, exist_ok=True)
        options = ocp.CheckpointManagerOptions(
            max_to_keep=max_to_keep, create=True, enable_async_checkpointing=False
        )
        self._mgr = ocp.CheckpointManager(self.directory, options=options)

    def save(self, step: int, state: Any) -> None:
        self._mgr.save(step, args=self._ocp.args.StandardSave(state))
        self._mgr.wait_until_finished()

    def restore(self, state_like: Any, step: Optional[int] = None) -> Any:
        """Restore into the structure/shardings of ``state_like``.

        ``state_like`` can be a fully materialized state on the *target*
        mesh (its shardings are reused, enabling cross-mesh restore).
        """
        step = self.latest_step() if step is None else step
        if step is None:
            raise FileNotFoundError(f"No checkpoints under {self.directory}")
        abstract = jax.tree.map(
            lambda x: jax.ShapeDtypeStruct(x.shape, x.dtype, sharding=getattr(x, "sharding", None))
            if hasattr(x, "shape") else x,
            state_like,
        )
        return self._mgr.restore(step, args=self._ocp.args.StandardRestore(abstract))

    def latest_step(self) -> Optional[int]:
        return self._mgr.latest_step()

    def all_steps(self):
        return self._mgr.all_steps()

    def close(self):
        self._mgr.close()
