"""Checkpoint conversion between per-table and arena layouts.

The default flip of ``embeddings.arena_tables`` requires old per-table
checkpoints to migrate: conversion must predict bit-identically and train
on exactly as if the target layout had been used from the start.
"""

import os

import numpy as np
import pytest

from news_recsys_tpu.models.rankers import build_ranker
from news_recsys_tpu.training.arena_convert import convert_checkpoint, convert_tree
from news_recsys_tpu.training.trainer import Trainer

from test_arena import make_cfg, make_ds


def _train(cfg, tmp, epochs=2, name="deep"):
    model = build_ranker(cfg, name)
    ds = make_ds(512, seed=5)
    tr = Trainer(cfg, model, workdir=str(tmp), use_mesh=False)
    state = tr.fit(ds, max_epochs=epochs)
    return tr, state, ds


@pytest.mark.parametrize("optimizer", ["rowwise_adagrad", "sparse_adamw", "adamw"])
def test_convert_roundtrip_predict_parity(tmp_path, optimizer):
    """per-table ckpt -> arena: identical predictions; arena -> per-table
    round trip restores every real row bit-exactly."""
    cfg_off, cfg_on = make_cfg(False, optimizer=optimizer), make_cfg(True, optimizer=optimizer)
    tr_off, state_off, ds = _train(cfg_off, tmp_path / "off")
    ckpt = tr_off.save_checkpoint(state_off, epoch=1)

    conv = str(tmp_path / "conv.npz")
    convert_checkpoint(cfg_on, ckpt, conv, to_arena=True)

    model_on = build_ranker(cfg_on, "deep")
    tr_on = Trainer(cfg_on, model_on, workdir=str(tmp_path / "on"), use_mesh=False)
    state_on = tr_on.init_state(ds.take(np.arange(64)))
    state_on = tr_on.load_checkpoint(state_on, conv)

    np.testing.assert_allclose(tr_on.predict(state_on.params, ds),
                               tr_off.predict(state_off.params, ds),
                               rtol=1e-6, atol=1e-6)

    # round trip back: real rows of every table bit-exact
    back = str(tmp_path / "back.npz")
    convert_checkpoint(cfg_on, conv, back, to_arena=False)
    state_back = tr_off.init_state(ds.take(np.arange(64)))
    state_back = tr_off.load_checkpoint(state_back, back)
    emb_a = state_off.params["params"]["embedder"]
    emb_b = state_back.params["params"]["embedder"]
    from test_arena import VOCABS
    for t in emb_a:
        v = VOCABS[t]
        np.testing.assert_array_equal(np.asarray(emb_a[t])[:v],
                                      np.asarray(emb_b[t])[:v], err_msg=t)


def test_convert_then_continue_training_matches(tmp_path):
    """Converted state continues training EXACTLY as the per-table run —
    row-local updates under a bijective row mapping are layout-invariant."""
    cfg_off, cfg_on = make_cfg(False), make_cfg(True)
    tr_off, state_off, ds = _train(cfg_off, tmp_path / "off", epochs=2)
    ckpt = tr_off.save_checkpoint(state_off, epoch=1)
    conv = str(tmp_path / "conv.npz")
    convert_checkpoint(cfg_on, ckpt, conv, to_arena=True)

    model_on = build_ranker(cfg_on, "deep")
    tr_on = Trainer(cfg_on, model_on, workdir=str(tmp_path / "on"), use_mesh=False)
    state_on = tr_on.init_state(ds.take(np.arange(64)))
    state_on = tr_on.load_checkpoint(state_on, conv)
    tr_on.global_step = tr_off.global_step

    # same epoch number -> same shuffle permutation on both sides
    state_off2, _ = tr_off.train_epoch(state_off, ds, epoch=2)
    state_on2, _ = tr_on.train_epoch(state_on, ds, epoch=2)
    np.testing.assert_allclose(tr_on.predict(state_on2.params, ds),
                               tr_off.predict(state_off2.params, ds),
                               rtol=1e-5, atol=1e-6)


def test_convert_tree_handles_sparse_state_moments():
    """emb_mu/emb_nu dicts ((V,) adagrad accumulators and (V, D) adamw
    moments) convert row-for-row, padding tail keeps its init value."""
    from news_recsys_tpu.models.embedding import padded_vocab
    from news_recsys_tpu.training.sparse_step import ADAGRAD_INIT_ACC
    from test_arena import VOCABS

    cfg_on = make_cfg(True)
    rng = np.random.default_rng(0)
    acc = {t: np.full(padded_vocab(v), ADAGRAD_INIT_ACC, np.float32)
           for t, v in VOCABS.items() if v >= 4096}
    for t in acc:
        acc[t][1:VOCABS[t]] = rng.random(VOCABS[t] - 1)
    out = convert_tree(cfg_on, {"emb_mu": acc}, to_arena=True)["emb_mu"]
    assert set(out) == {"arena_d16"}
    from news_recsys_tpu.config import arena_layout
    layout = arena_layout(cfg_on)
    a = out["arena_d16"]
    for t, (aname, off, avocab) in layout.items():
        v = VOCABS[t]
        np.testing.assert_array_equal(np.asarray(a)[off + 1: off + v], acc[t][1:v])
    # padded tail above the members keeps the accumulator init value
    assert np.allclose(np.asarray(a)[avocab:], ADAGRAD_INIT_ACC)


def test_convert_ckpt_cli(tmp_path):
    """CLI surface: convert-ckpt writes a loadable arena checkpoint."""
    import json

    from news_recsys_tpu.cli import main
    from news_recsys_tpu.config import config_to_dict

    cfg_off, cfg_on = make_cfg(False), make_cfg(True)
    tr_off, state_off, ds = _train(cfg_off, tmp_path / "off", epochs=1)
    ckpt = tr_off.save_checkpoint(state_off, epoch=0)
    cfg_path = str(tmp_path / "cfg.json")
    with open(cfg_path, "w") as f:
        json.dump(config_to_dict(cfg_on), f)
    out = str(tmp_path / "arena.npz")
    main(["convert-ckpt", "-c", cfg_path, "--input", ckpt, "--output", out,
          "--to", "arena"])
    assert os.path.exists(out)
    model_on = build_ranker(cfg_on, "deep")
    tr_on = Trainer(cfg_on, model_on, workdir=str(tmp_path / "on"), use_mesh=False)
    state_on = tr_on.load_checkpoint(tr_on.init_state(ds.take(np.arange(64))), out)
    np.testing.assert_allclose(tr_on.predict(state_on.params, ds),
                               tr_off.predict(state_off.params, ds),
                               rtol=1e-6, atol=1e-6)
