"""Checkpoint conversion between per-table and arena embedding layouts.

``embeddings.arena_tables`` changes the parameter tree (same-dim large
tables pack into one ``arena_d<D>`` param, :func:`news_recsys_tpu.config
.arena_layout`), so checkpoints written under one layout cannot be loaded
under the other. This module converts saved states row-for-row:

- member ``m`` with logical vocab ``v`` and arena offset ``o`` maps rows
  ``[1, v) -> [o+1, o+v)``; row 0 is the shared padding row;
- every per-table optimizer tensor keyed by a member table converts the
  same way: ``(V, D)`` sparse-adamw moments, ``(V,)`` rowwise-adagrad
  accumulators, and the dense-AdamW moment trees that mirror the params;
- arena rows outside any member's range (the padded tail above the last
  member) are filled from the source table's own padded tail row — those
  rows are never read by a lookup (ids are bounded per member,
  ``models.embedding.offset_ids``) and only ever receive zero-gradient
  spare-slot scatters, so the fill is semantically inert.

Conversion is exact for continued training: touched-row updates are
row-local and the mapping is a bijection on real rows, so a converted
checkpoint predicts bit-identically and trains on exactly as if it had used
the target layout from the start (``tests/test_arena.py``).

The reference has no layout migration to mirror (its checkpoints are plain
state dicts, ``base_model.py:531-536``); this is new surface for the
``arena_tables`` default.
"""

from __future__ import annotations

from typing import Any, Dict

import jax.numpy as jnp
import numpy as np

from ..config import Config, arena_layout, table_specs
from ..models.embedding import padded_vocab
from .checkpoint import load_tree, save_tree


def _member_vocabs(cfg: Config) -> Dict[str, int]:
    emb = cfg.embeddings
    return {m: int(emb.embedding_table_size[m]) for m in arena_layout(cfg)}


def to_arena_dict(cfg: Config, tables: Dict[str, Any]) -> Dict[str, Any]:
    """Pack a {table-name: array} dict's member tables into arena arrays.

    Works for any per-row tensor keyed by table name: params (V, D),
    adamw moments (V, D), adagrad accumulators (V,).
    """
    layout = arena_layout(cfg)
    vocabs = _member_vocabs(cfg)
    specs = table_specs(cfg)
    out = {k: v for k, v in tables.items() if k not in layout}
    members_by_arena: Dict[str, list] = {}
    for m, (aname, off, _) in sorted(layout.items()):
        members_by_arena.setdefault(aname, []).append((m, off))
    for aname, members in members_by_arena.items():
        present = [m for m, _ in members if m in tables]
        if not present:
            continue
        if len(present) != len(members):
            missing = [m for m, _ in members if m not in tables]
            raise ValueError(f"Cannot pack {aname}: missing member tables {missing}")
        avocab = specs[aname][0]
        # pure numpy on host: conversion must not touch the accelerator
        first = np.asarray(tables[members[0][0]])
        arena = np.zeros((padded_vocab(avocab),) + first.shape[1:], first.dtype)
        arena[0] = first[0]                               # shared padding row
        for m, off in members:
            v = vocabs[m]
            arena[off + 1: off + v] = np.asarray(tables[m])[1:v]
        # padded tail above the last member: inert rows (never read); fill
        # with the source's own padded-tail row so e.g. adagrad accumulators
        # keep their init value there
        arena[avocab:] = first[-1]
        out[aname] = arena
    return out


def from_arena_dict(cfg: Config, tables: Dict[str, Any]) -> Dict[str, Any]:
    """Inverse of :func:`to_arena_dict`: split arena arrays back into
    per-table arrays (target = the same config with ``arena_tables`` off)."""
    layout = arena_layout(cfg)
    vocabs = _member_vocabs(cfg)
    arena_names = {aname for aname, _, _ in layout.values()}
    out = {k: v for k, v in tables.items() if k not in arena_names}
    for m, (aname, off, _) in sorted(layout.items()):
        if aname not in tables:
            continue
        arena = np.asarray(tables[aname])
        v = vocabs[m]
        tbl = np.zeros((padded_vocab(v),) + arena.shape[1:], arena.dtype)
        tbl[0] = arena[0]
        tbl[1:v] = arena[off + 1: off + v]
        tbl[v:] = arena[-1]
        out[m] = tbl
    return out


def convert_tree(cfg: Config, tree: Any, to_arena: bool) -> Any:
    """Recursively convert every embedder-shaped dict in a (nested) state
    tree: any dict holding ALL of an arena's member tables (or the arena
    itself, for the reverse direction) as array values is converted in
    place. Covers ``params/embedder``, dense-AdamW moment mirrors, and the
    sparse state's ``emb_mu``/``emb_nu``."""
    layout = arena_layout(cfg)
    if not layout:
        return tree
    members = set(layout)
    arena_names = {aname for aname, _, _ in layout.values()}

    def is_array(x):
        return isinstance(x, (np.ndarray, jnp.ndarray)) or hasattr(x, "shape")

    def walk(node):
        if not isinstance(node, dict):
            return node
        keys = set(node)
        if to_arena and (members & keys) and all(
                is_array(node[m]) for m in members & keys):
            return to_arena_dict(cfg, {k: walk(v) if isinstance(v, dict) else v
                                       for k, v in node.items()})
        if not to_arena and (arena_names & keys) and all(
                is_array(node[a]) for a in arena_names & keys):
            return from_arena_dict(cfg, {k: walk(v) if isinstance(v, dict) else v
                                         for k, v in node.items()})
        return {k: walk(v) for k, v in node.items()}

    return walk(tree)


def convert_checkpoint(cfg: Config, in_path: str, out_path: str,
                       to_arena: bool) -> None:
    """Convert a checkpoint file (``epoch_*.npz`` from
    ``Trainer.save_checkpoint`` / ``DSSMTrainer.save_checkpoint``) between
    layouts. ``cfg`` must be the config WITH ``arena_tables: true`` (it
    defines the arena geometry for both directions)."""
    if not cfg.embeddings.arena_tables:
        import dataclasses
        cfg = dataclasses.replace(
            cfg, embeddings=dataclasses.replace(cfg.embeddings, arena_tables=True))
    save_tree(out_path, convert_tree(cfg, load_tree(in_path), to_arena))
