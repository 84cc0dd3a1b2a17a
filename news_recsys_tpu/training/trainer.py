"""Training runtime: jitted train/eval steps, epoch loop, validation engine.

Replaces the reference's PyTorch-Lightning orchestration (per-model
``train.py`` + ``L.Trainer``; ``deep/train.py:38-46``) with a hand-rolled
JAX loop:

- one ``pjit``-compiled train step (donated state) shared by every model:
  sigmoid-BCE on logits + AdamW with the reference's hold->cosine->floor
  schedule stepped per optimizer step (``deep/model.py:57-65``,
  ``lr_schedule.py:16-28``); params/optimizer sharded by
  :func:`news_recsys_tpu.parallel.mesh.param_shardings`, batches sharded
  over the ``data`` axis;
- on-device binned train-AUC accumulator instead of the reference's
  per-step sklearn ``roc_auc_score`` on host (``deep/model.py:49``) — that
  pattern forces a device->host sync every step; the final validation AUC
  remains exact;
- per-epoch validation via the vectorized metric engine
  (:mod:`news_recsys_tpu.training.metrics`) with warm/cold cohorts, writing
  the reference's ``val_log.log`` block format so ``log_analysis`` tooling
  keeps working;
- experiment dirs ``experiments/<name>_<YYYYmmdd-HHMMSS>/`` with ``ckpts/``,
  ``train.log``, ``val_log.log``, ``model_info.log``, ``metrics.jsonl``
  (structured scalar log channel standing in for TensorBoard), mirroring
  the reference layout (``deep/train.py:31-36``, ``base_model.py:181-256``).
"""

from __future__ import annotations

import dataclasses
import json
import os
import time
from dataclasses import dataclass
from functools import partial
from typing import Any, Dict, Optional, Set, Tuple

import jax
import jax.numpy as jnp
import numpy as np
import optax

from ..config import Config
from ..data.packed_dataset import PackedDataset, iterate_batches
from ..parallel.mesh import make_mesh, param_shardings
from ..utils.logging import get_logger
from .checkpoint import restore_tree, save_tree
from .metrics import compute_user_metrics, format_validation_block
from .schedule import hold_cosine_floor

logger = get_logger("trainer")

AUC_BINS = 4096


@dataclass(frozen=True)
class TrainState:
    """Dense-optimizer train state: step, params and the optax state of
    ``tx`` (static: not a pytree leaf, not checkpointed)."""

    step: jnp.ndarray
    params: Any
    opt_state: Any
    tx: optax.GradientTransformation

    @classmethod
    def create(cls, params, tx: optax.GradientTransformation) -> "TrainState":
        return cls(step=jnp.zeros((), jnp.int32), params=params,
                   opt_state=tx.init(params), tx=tx)

    def apply_gradients(self, grads) -> "TrainState":
        updates, opt_state = self.tx.update(grads, self.opt_state, self.params)
        return self.replace(step=self.step + 1,
                            params=optax.apply_updates(self.params, updates),
                            opt_state=opt_state)

    def replace(self, **changes) -> "TrainState":
        return dataclasses.replace(self, **changes)


jax.tree_util.register_dataclass(TrainState, data_fields=["step", "params", "opt_state"],
                                 meta_fields=["tx"])


@dataclass
class AucHist:
    """On-device binned (pos, neg) score histograms for streaming AUC."""

    pos: jnp.ndarray
    neg: jnp.ndarray

    @staticmethod
    def zeros():
        return AucHist(jnp.zeros(AUC_BINS, jnp.float32), jnp.zeros(AUC_BINS, jnp.float32))


jax.tree_util.register_dataclass(AucHist, data_fields=["pos", "neg"], meta_fields=[])


def binned_auc_update(hist: AucHist, probs, labels, weights) -> AucHist:
    bins = jnp.clip((probs * AUC_BINS).astype(jnp.int32), 0, AUC_BINS - 1)
    pos_w = weights * labels
    neg_w = weights * (1.0 - labels)
    # histogram as a one-hot matmul (2, B) @ (B, BINS) instead of a
    # (B,)-indexed scatter-add with duplicate bins. Only the large B x BINS
    # one-hot is bf16 — its entries are 0/1 so the f32-accumulated product is
    # exact at half the memory traffic; the (2, B) weight operand stays f32
    # (mixed-dtype dot_general) so non-binary sample weights keep full
    # precision too.
    onehot = (bins[:, None] == jnp.arange(AUC_BINS)[None, :]).astype(jnp.bfloat16)
    upd = jax.lax.dot_general(
        jnp.stack([pos_w, neg_w]), onehot, (((1,), (0,)), ((), ())),
        preferred_element_type=jnp.float32)
    return AucHist(pos=hist.pos + upd[0], neg=hist.neg + upd[1])


def binned_auc_value(hist: AucHist) -> jnp.ndarray:
    """AUC estimate: P(score_pos > score_neg) + 0.5 P(equal bin)."""
    cum_neg = jnp.cumsum(hist.neg) - hist.neg  # negatives strictly below bin
    wins = jnp.sum(hist.pos * (cum_neg + 0.5 * hist.neg))
    total = jnp.sum(hist.pos) * jnp.sum(hist.neg)
    return jnp.where(total > 0, wins / total, 0.0)


def make_optimizer(cfg: Config) -> optax.GradientTransformation:
    hp = cfg.train_hparams
    sched = hold_cosine_floor(hp.lr, hp.min_lr, hp.lr_milestones)
    return optax.adamw(sched, b1=hp.b1, b2=hp.b2, weight_decay=hp.weight_decay)


def loss_fn(model, params, batch) -> Tuple[jnp.ndarray, Dict[str, jnp.ndarray]]:
    logits = model.apply(params, batch)
    labels = batch["label"][:, 0]
    weights = batch.get("_valid", jnp.ones_like(labels))
    per_ex = optax.sigmoid_binary_cross_entropy(logits, labels)
    denom = jnp.maximum(weights.sum(), 1.0)
    loss = (per_ex * weights).sum() / denom
    return loss, {"logits": logits, "labels": labels, "weights": weights}


def make_train_step(model, mesh):
    def step(state: TrainState, hist: AucHist, batch):
        (loss, aux), grads = jax.value_and_grad(
            partial(loss_fn, model), has_aux=True
        )(state.params, batch)
        state = state.apply_gradients(grads=grads)
        probs = jax.nn.sigmoid(aux["logits"])
        hist = binned_auc_update(hist, probs, aux["labels"], aux["weights"])
        return state, hist, loss

    return jax.jit(step, donate_argnums=(0, 1))


def make_eval_step(model):
    def step(params, batch):
        logits = model.apply(params, batch)
        return jax.nn.sigmoid(logits)

    return jax.jit(step)


def make_chunked_train_fn(model, layout_key, batch_size: int):
    """One dispatch per CHUNK of train steps: the whole packed dataset lives
    in device memory; each scan iteration gathers its batch rows on device.
    Removes both the per-step host->device transfer and the per-step
    dispatch."""
    from ..data.packed_dataset import unpack_batch

    def run(state: TrainState, hist: AucHist, int_mat, float_mat, idx_chunk):
        ones = jnp.ones(batch_size, jnp.float32)

        def body(carry, idx):
            state, hist = carry
            im = jnp.take(int_mat, idx, axis=0)
            fm = jnp.take(float_mat, idx, axis=0)
            batch = unpack_batch(im, fm, ones, layout_key)
            (loss, aux), grads = jax.value_and_grad(
                partial(loss_fn, model), has_aux=True
            )(state.params, batch)
            state = state.apply_gradients(grads=grads)
            probs = jax.nn.sigmoid(aux["logits"])
            hist = binned_auc_update(hist, probs, aux["labels"], aux["weights"])
            return (state, hist), loss

        (state, hist), losses = jax.lax.scan(body, (state, hist), idx_chunk)
        return state, hist, losses[-1]

    return jax.jit(run, donate_argnums=(0, 1))


def make_chunked_eval_fn(model, layout_key, batch_size: int):
    from ..data.packed_dataset import unpack_batch

    def run(params, int_mat, float_mat, idx_chunk):
        ones = jnp.ones(batch_size, jnp.float32)

        def body(_, idx):
            im = jnp.take(int_mat, idx, axis=0)
            fm = jnp.take(float_mat, idx, axis=0)
            batch = unpack_batch(im, fm, ones, layout_key)
            return None, jax.nn.sigmoid(model.apply(params, batch))

        _, scores = jax.lax.scan(body, None, idx_chunk)
        return scores.reshape(-1)

    return jax.jit(run)


class Trainer:
    """Epoch-driven trainer with the reference's experiment-dir contract."""

    def __init__(self, cfg: Config, model, workdir: Optional[str] = None,
                 mesh=None, use_mesh: bool = True, profile_steps: int = 0):
        self.profile_steps = profile_steps
        self.cfg = cfg
        self.model = model
        self.mesh = mesh if mesh is not None else (
            make_mesh(cfg.mesh.data, cfg.mesh.model) if use_mesh and len(jax.devices()) > 1 else None
        )
        if cfg.mesh.explicit_collectives:
            from ..parallel.sharded_embedding import set_active_mesh
            set_active_mesh(self.mesh)
        # Multi-host: every process runs the same SPMD program; only process
        # 0 writes logs/host checkpoints (Orbax sharded saves stay
        # collective). The experiment-dir timestamp is agreed via broadcast
        # so all processes share one Orbax directory.
        self.is_main = jax.process_index() == 0
        ts = time.strftime("%Y%m%d-%H%M%S")
        if workdir is None and jax.process_count() > 1:
            from ..parallel.distributed import broadcast_str
            ts = broadcast_str(ts)
        self.log_dir = workdir or os.path.join("experiments", f"{cfg.name}_{ts}")
        self.ckpt_dir = os.path.join(self.log_dir, "ckpts")
        os.makedirs(self.ckpt_dir, exist_ok=True)
        self.val_log_path = os.path.join(self.log_dir, "val_log.log")
        self.train_log_path = os.path.join(self.log_dir, "train.log")
        self.metrics_path = os.path.join(self.log_dir, "metrics.jsonl")
        if self.is_main:
            open(self.val_log_path, "a").close()

        self.train_step = make_train_step(model, self.mesh)
        self.eval_step = make_eval_step(model)
        self.global_step = 0
        self.chunk_steps = cfg.train_hparams.chunk_steps
        self.device_resident_bytes = cfg.train_hparams.device_resident_bytes

    # -- setup ---------------------------------------------------------------

    @property
    def sparse_embeddings(self) -> bool:
        return self.cfg.train_hparams.embedding_optimizer in (
            "sparse_adamw", "rowwise_adagrad")

    def init_state(self, sample_batch: Dict[str, np.ndarray], seed: Optional[int] = None):
        seed = self.cfg.train_hparams.seed if seed is None else seed
        params = self.model.init(jax.random.PRNGKey(seed), jax.device_put(sample_batch))
        if self.sparse_embeddings:
            from .sparse_step import (init_sparse_state, make_dense_tx,
                                      sparse_state_shardings)
            state = init_sparse_state(params, self.cfg, make_dense_tx(self.cfg),
                                      self.model.tables)
            if self.mesh is not None:
                state = jax.device_put(state, sparse_state_shardings(state, self.mesh))
            self._write_model_info(state)
            return state
        tx = make_optimizer(self.cfg)
        state = TrainState.create(params=params, tx=tx)
        if self.mesh is not None:
            # shard params; optimizer moments mirror their param's sharding
            state = jax.device_put(state, param_shardings_for_state(state, self.mesh))
        self._write_model_info(state)
        return state

    def _write_model_info(self, state: TrainState) -> None:
        """Param summary table (the reference dumps Lightning's ModelSummary,
        ``base_model.py:214-218``)."""
        lines = ["  | Name | Shape | Params"]
        total = 0
        flat = jax.tree_util.tree_flatten_with_path(state.params)[0]
        for path, leaf in flat:
            n = int(np.prod(leaf.shape)) if hasattr(leaf, "shape") else 1
            total += n
            name = "/".join(str(getattr(p, "key", p)) for p in path)
            lines.append(f"  | {name} | {tuple(leaf.shape)} | {n:,}")
        lines.append(f"  Total params: {total:,}")
        if self.is_main:
            with open(os.path.join(self.log_dir, "model_info.log"), "w") as f:
                f.write("\n".join(lines) + "\n")

    def _log_scalars(self, step: int, **scalars) -> None:
        if not self.is_main:
            return
        with open(self.metrics_path, "a") as f:
            f.write(json.dumps({"step": step, **scalars}) + "\n")
        if not hasattr(self, "_tb"):
            from ..utils.tensorboard import SummaryWriter
            self._tb = SummaryWriter(self.log_dir)
        for key, val in scalars.items():
            if isinstance(val, (int, float)) and val == val:
                self._tb.add_scalar(key, float(val), step)
        self._tb.flush()

    # -- training ------------------------------------------------------------

    # Runtime thresholds come from config (train_hparams.chunk_steps /
    # .device_resident_bytes), set as instance attrs in __init__. A chunk of
    # steps runs as one dispatch, so its fixed dispatch cost is shared by
    # chunk_steps steps. Mid-epoch checkpoint cadence (ckpt_every_steps)
    # caps the effective chunk so boundaries stay exact.

    def _packer(self, ds: PackedDataset):
        from ..data.packed_dataset import BatchPacker
        if not hasattr(ds, "_packer_cache"):
            ds._packer_cache = BatchPacker(ds)
        return ds._packer_cache

    def _device_matrices(self, packer):
        """Upload the packed dataset to the device once (cached on the packer).

        Under a mesh the matrices are replicated; batches become sharded
        over 'data' because the per-chunk index arrays are sharded on their
        batch dimension and GSPMD propagates that through the gather."""
        cache_key = id(self.mesh)
        if getattr(packer, "_dev_mats_key", None) != cache_key:
            packer._dev_mats_key = cache_key
            if self.mesh is not None:
                from jax.sharding import NamedSharding, PartitionSpec as P
                rep = NamedSharding(self.mesh, P())
                packer._dev_mats = (jax.device_put(packer.int_mat, rep),
                                    jax.device_put(packer.float_mat, rep))
            else:
                packer._dev_mats = (jax.device_put(packer.int_mat),
                                    jax.device_put(packer.float_mat))
        return packer._dev_mats

    def _put_idx(self, idx_chunk):
        if self.mesh is not None:
            from jax.sharding import NamedSharding, PartitionSpec as P
            return jax.device_put(idx_chunk, NamedSharding(self.mesh, P(None, "data")))
        return jax.device_put(idx_chunk)

    def _put_replicated(self, x):
        if self.mesh is not None:
            from jax.sharding import NamedSharding, PartitionSpec as P
            return jax.device_put(x, NamedSharding(self.mesh, P()))
        return jax.device_put(x)

    def _chunk_len(self, nb: int, pos: int, cap: Optional[int] = None) -> int:
        """Next dispatch's step count: chunk_steps (optionally capped at
        ``cap``, e.g. the slab path's HBM budget), capped at the epoch end
        and at the next ckpt_every_steps boundary (so mid-epoch checkpoints
        land exactly on multiples of the cadence)."""
        c = min(cap or self.chunk_steps, self.chunk_steps, nb - pos)
        every = self.cfg.train_hparams.ckpt_every_steps
        if every > 0:
            done = self.global_step - getattr(self, "_last_step_ckpt", 0)
            c = min(c, max(every - done, 1))
        return c

    def _slab_chunk_cap(self, packer, bs: int) -> int:
        """Max steps per slab so one host-gathered slab (c*bs rows) stays
        within the device_resident_bytes budget that forced slab streaming
        in the first place."""
        row_bytes = (packer.int_mat.nbytes + packer.float_mat.nbytes) / max(packer.n, 1)
        return max(1, int(self.device_resident_bytes // max(1.0, row_bytes * bs)))

    def _use_device_resident(self, packer) -> bool:
        if packer.int_mat.nbytes + packer.float_mat.nbytes > self.device_resident_bytes:
            return False
        if self.mesh is not None and self.cfg.dataset.batch_size % self.mesh.shape["data"] != 0:
            return False
        return True

    def _chunked_step(self, layout_key, batch_size):
        if not hasattr(self, "_chunked_steps"):
            self._chunked_steps = {}
        key = (layout_key, batch_size)
        if key not in self._chunked_steps:
            if self.sparse_embeddings:
                from .sparse_step import make_sparse_chunk_fn
                self._chunked_steps[key] = make_sparse_chunk_fn(
                    self.model, layout_key, batch_size, self.cfg, mesh=self.mesh)
            else:
                self._chunked_steps[key] = make_chunked_train_fn(self.model, layout_key, batch_size)
        return self._chunked_steps[key]

    def _chunked_eval_fn(self, layout_key, batch_size):
        if not hasattr(self, "_chunked_evals"):
            self._chunked_evals = {}
        key = (layout_key, batch_size)
        if key not in self._chunked_evals:
            self._chunked_evals[key] = make_chunked_eval_fn(self.model, layout_key, batch_size)
        return self._chunked_evals[key]

    # Epoch-loop carry hooks. The chunked run fn has signature
    # (state, carry, int_mat, float_mat, idx_chunk) -> (state, carry, loss);
    # the ranking trainer carries the on-device AUC histogram, the DSSM
    # trainer a PRNG key (negatives are derived per-step from it).
    def _epoch_carry(self, epoch: int):
        return AucHist.zeros()

    def _carry_metrics(self, carry) -> Dict[str, float]:
        return {"train_auc": float(binned_auc_value(carry))}

    def epoch_order(self, n: int, epoch: int) -> np.ndarray:
        """The row order of ``epoch``: batch i is rows [i*B, (i+1)*B) of it."""
        return np.random.default_rng(
            np.random.SeedSequence([self.cfg.dataset.shuffle_seed, epoch])).permutation(n)

    def train_epoch(self, state: TrainState, ds: PackedDataset, epoch: int,
                    skip_steps: int = 0) -> Tuple[TrainState, Dict[str, float]]:
        """One epoch; ``skip_steps`` fast-forwards past the first N batches of
        this epoch's permutation (mid-epoch resume: those steps were already
        trained before the restart)."""
        hp = self.cfg.train_hparams
        hist = self._epoch_carry(epoch)
        loss_sum, n_steps = 0.0, 0
        t0 = time.perf_counter()
        n_examples = 0
        last_loss = None
        profiling = self.profile_steps > 0 and epoch == 0
        if profiling:
            jax.profiler.start_trace(os.path.join(self.log_dir, "profile"))
        packer = self._packer(ds)
        bs = self.cfg.dataset.batch_size
        if self._use_device_resident(packer):
            # Device-resident path: dataset on the device, chunk_steps steps per
            # dispatch via lax.scan; same permutation as the streaming path.
            int_dev, float_dev = self._device_matrices(packer)
            order = self.epoch_order(packer.n, epoch)
            nb_full = packer.n // bs
            start = min(skip_steps, nb_full)
            nb = min(nb_full - start, hp.max_step - self.global_step)
            idx_all = order[start * bs : (start + nb) * bs].reshape(nb, bs).astype(np.int32)
            run = self._chunked_step(packer.layout_key(), bs)
            # ONE idx upload per epoch; per-chunk views are device-side
            # slices (each distinct (pos, c) compiles a trivial slice once).
            idx_dev = self._put_idx(idx_all) if nb > 0 else None
            pos = 0
            while pos < nb:
                c = self._chunk_len(nb, pos)
                state, hist, last_loss = run(state, hist, int_dev, float_dev,
                                             idx_dev[pos : pos + c])
                pos += c
                self.global_step += c
                n_steps += c
                n_examples += c * bs
                self._maybe_step_checkpoint(state)
            loss_sum = float(last_loss) if last_loss is not None else 0.0
        else:
            # Slab-streamed path for datasets too large for the device: the host
            # gathers a contiguous chunk_steps*bs-row slab per dispatch and
            # the SAME chunked scan fn runs over it with identity indices —
            # one upload per chunk of steps instead of one per step. The
            # chunk is capped so a slab never exceeds the device budget.
            order = self.epoch_order(packer.n, epoch)
            nb_full = packer.n // bs
            start = min(skip_steps, nb_full)
            nb = min(nb_full - start, hp.max_step - self.global_step)
            run = self._chunked_step(packer.layout_key(), bs)
            slab_cap = self._slab_chunk_cap(packer, bs)
            pos = 0
            while pos < nb:
                c = self._chunk_len(nb, pos, cap=slab_cap)
                slab_rows = order[(start + pos) * bs : (start + pos + c) * bs]
                im = packer.int_mat[slab_rows]
                fm = packer.float_mat[slab_rows]
                idx = np.arange(c * bs, dtype=np.int32).reshape(c, bs)
                state, hist, last_loss = run(
                    state, hist, self._put_replicated(im), self._put_replicated(fm),
                    self._put_idx(idx))
                pos += c
                self.global_step += c
                n_steps += c
                n_examples += c * bs
                self._maybe_step_checkpoint(state)
            loss_sum = float(jax.device_get(last_loss)) if last_loss is not None else 0.0
        if profiling:
            jax.profiler.stop_trace()
        loss_val = float(jax.device_get(last_loss)) if last_loss is not None else float("nan")
        dt = time.perf_counter() - t0
        metrics = {
            "train_loss": loss_val,
            **self._carry_metrics(hist),
            "examples_per_sec": n_examples / max(dt, 1e-9),
            "steps": n_steps,
        }
        self._log_scalars(self.global_step, epoch=epoch, **metrics)
        if self.is_main:
            with open(self.train_log_path, "a") as f:
                f.write(f"Epoch {epoch} Training Metrics:\n")
                for k, v in metrics.items():
                    f.write(f"  {k}: {v:.4f}\n")
                f.write("-" * 20 + "\n")
        extra = (f" auc~{metrics['train_auc']:.4f}" if "train_auc" in metrics else "")
        logger.info(
            f"epoch {epoch}: steps={n_steps} loss={metrics['train_loss']:.4f}"
            f"{extra} ex/s={metrics['examples_per_sec']:.0f}"
        )
        return state, metrics

    # -- validation ----------------------------------------------------------

    def _fetch(self, x) -> np.ndarray:
        """Host-fetch an eval output; multihost-safe (all-gathers cross-host
        shards so every process sees the full array)."""
        if jax.process_count() > 1:
            from ..parallel.distributed import fetch_to_host
            return fetch_to_host(x, self.mesh)
        return np.asarray(x)

    def predict(self, params, ds: PackedDataset, batch_size: Optional[int] = None):
        """Scores for every row of ``ds`` in order (packed fast path)."""
        bs = batch_size or self.cfg.dataset.eval_batch_size or self.cfg.dataset.batch_size
        packer = self._packer(ds)
        if self._use_device_resident(packer):
            int_dev, float_dev = self._device_matrices(packer)
            nb = (packer.n + bs - 1) // bs
            idx = np.arange(nb * bs, dtype=np.int32)
            idx[packer.n :] = packer.n - 1                     # tail padding
            run = self._chunked_eval_fn(packer.layout_key(), bs)
            idx_dev = self._put_idx(idx.reshape(nb, bs))       # ONE upload
            scores = []
            pos = 0
            while pos < nb:
                c = min(self.chunk_steps, nb - pos)
                scores.append(self._fetch(run(params, int_dev, float_dev,
                                              idx_dev[pos : pos + c])))
                pos += c
            return np.concatenate(scores)[: packer.n]
        # slab-streamed eval for datasets too large for the device
        nb = (packer.n + bs - 1) // bs
        pad_idx = np.arange(nb * bs, dtype=np.int64)
        pad_idx[packer.n :] = packer.n - 1
        run = self._chunked_eval_fn(packer.layout_key(), bs)
        slab_cap = self._slab_chunk_cap(packer, bs)
        scores = []
        pos = 0
        while pos < nb:
            c = min(self.chunk_steps, slab_cap, nb - pos)
            slab_rows = pad_idx[pos * bs : (pos + c) * bs]
            im = packer.int_mat[slab_rows]
            fm = packer.float_mat[slab_rows]
            idx = np.arange(c * bs, dtype=np.int32).reshape(c, bs)
            scores.append(self._fetch(run(params, self._put_replicated(im),
                                          self._put_replicated(fm), self._put_idx(idx))))
            pos += c
        return np.concatenate(scores)[: packer.n]

    def validate(self, state: TrainState, ds: PackedDataset, epoch: int,
                 warm_user_set: Optional[Set[int]] = None) -> Dict[str, Dict[str, float]]:
        scores = self.predict(state.params, ds)
        uids = ds.arrays["user_id"]
        labels = ds.arrays["label"][:, 0]
        if len(ds) >= self.cfg.train_hparams.device_metrics_min_rows:
            # The device engine runs whether or not training used a mesh —
            # the (N,) metric inputs are tiny next to the model state, so
            # they compute on one chip (default jit placement) even when the
            # train step was sharded. Parity-tested under a 4x2 mesh.
            from .metrics_device import compute_user_metrics_device
            results = compute_user_metrics_device(uids, scores, labels, warm_user_set)
        else:
            results = compute_user_metrics(uids, scores, labels, warm_user_set)
        block = format_validation_block(results, epoch)
        if self.is_main:
            print(block)
            with open(self.val_log_path, "a") as f:
                f.write(block)
        self._log_scalars(self.global_step, epoch=epoch,
                          val_auc=results["Overall"]["AUC"],
                          val_gauc=results["Overall"]["GAUC"],
                          val_ndcg10=results["Overall"]["NDCG@10"])
        return results

    # -- checkpointing -------------------------------------------------------

    def checkpoint_manager(self):
        """Orbax manager for sharded, mesh-flexible checkpoints."""
        if getattr(self, "_ckpt_mgr", None) is None:
            from .checkpoint import CheckpointManager
            self._ckpt_mgr = CheckpointManager(os.path.join(self.ckpt_dir, "orbax"))
        return self._ckpt_mgr

    def _maybe_step_checkpoint(self, state) -> None:
        """Mid-epoch periodic checkpointing (train_hparams.ckpt_every_steps).

        Combined with ``fit(resume=True)`` this gives mid-epoch resume — the
        reference has none (SURVEY §5.4); the step count in the state keeps
        the lr schedule exact across restarts.
        """
        every = self.cfg.train_hparams.ckpt_every_steps
        if every > 0 and not hasattr(self, "_last_step_ckpt"):
            self._last_step_ckpt = 0
        if every > 0 and self.global_step - self._last_step_ckpt >= every:
            self.save_checkpoint_sharded(state, self.global_step)
            self._last_step_ckpt = self.global_step

    @staticmethod
    def _state_fields(state) -> Tuple[str, ...]:
        if hasattr(state, "opt_state"):
            return ("params", "opt_state", "step")
        # SparseTrainState
        return ("params", "dense_opt", "emb_mu", "emb_nu", "step")

    def save_checkpoint_sharded(self, state, step: int) -> None:
        fields = self._state_fields(state)
        self.checkpoint_manager().save(step, {f: getattr(state, f) for f in fields})

    def restore_latest(self, state) -> Tuple[TrainState, bool]:
        """Restore the newest sharded checkpoint into ``state``'s shardings;
        returns (state, restored?). Works for dense and sparse states."""
        mgr = self.checkpoint_manager()
        if mgr.latest_step() is None:
            return state, False
        fields = self._state_fields(state)
        restored = mgr.restore({f: getattr(state, f) for f in fields})
        state = state.replace(**restored)
        self.global_step = int(np.asarray(state.step))
        self._reset_step_ckpt_origin()
        logger.info(f"Restored checkpoint at step {self.global_step}")
        return state, True

    def _reset_step_ckpt_origin(self) -> None:
        """Re-anchor the mid-epoch checkpoint cadence after a restore: later
        checkpoints must land on ckpt_every_steps multiples counted from 0,
        not from the (default-0) pre-restore counter — otherwise the first
        post-resume chunk is forced to 1 step (fresh scan shape = full
        recompile) and an immediately-redundant checkpoint is written."""
        every = self.cfg.train_hparams.ckpt_every_steps
        self._last_step_ckpt = ((self.global_step // every) * every
                                if every > 0 else self.global_step)

    def save_checkpoint(self, state, epoch: int) -> str:
        path = os.path.join(self.ckpt_dir, f"epoch_{epoch:03d}.npz")
        if jax.process_count() > 1:
            from ..parallel.distributed import fetch_pytree_to_host
            host_state = fetch_pytree_to_host(state, self.mesh)
            if not self.is_main:
                return path
        else:
            host_state = jax.device_get(state)
        return save_tree(path, host_state)

    def load_checkpoint(self, state, path: str):
        """Strict restore (reference ``load_model``, ``base_model.py:531-536``)."""
        if not os.path.exists(path):
            raise FileNotFoundError(f"Checkpoint not found: {path}")
        state = restore_tree(path, jax.device_get(state))
        self.global_step = int(np.asarray(state.step))
        self._reset_step_ckpt_origin()
        if self.mesh is not None and isinstance(state, TrainState):
            state = jax.device_put(state, param_shardings_for_state(state, self.mesh))
        return state

    # -- fit -----------------------------------------------------------------

    def fit(self, train_ds: PackedDataset, dev_ds: Optional[PackedDataset] = None,
            warm_user_set: Optional[Set[int]] = None, state: Optional[TrainState] = None,
            max_epochs: Optional[int] = None, resume: bool = False) -> TrainState:
        hp = self.cfg.train_hparams
        max_epochs = max_epochs if max_epochs is not None else hp.max_epoch
        if state is None:
            sample = next(iterate_batches(train_ds, self.cfg.dataset.batch_size, shuffle=False))
            state = self.init_state(sample)
        start_epoch, skip = 0, 0
        if resume:
            state, restored = self.restore_latest(state)
            if restored:
                # map the restored global step back onto (epoch, intra-epoch
                # offset) so the resumed run continues the SAME data order —
                # no rows replayed, none skipped. The divmod is exact even
                # across max_step-truncated sessions: train_epoch's cap
                # (``min(nb_full - start, max_step - global_step)``) can only
                # shorten the FINAL epoch of a session (fit breaks as soon as
                # global_step reaches max_step), so every epoch before the
                # current one contributed exactly steps_per_epoch steps and
                # ``global_step == epoch * steps_per_epoch + offset`` always
                # holds (multi-session regression:
                # tests/test_checkpoint.py::test_resume_across_truncated_epochs).
                steps_per_epoch = max(1, len(train_ds) // self.cfg.dataset.batch_size)
                start_epoch = self.global_step // steps_per_epoch
                skip = self.global_step % steps_per_epoch
                logger.info(f"Resuming at step {self.global_step} "
                            f"(epoch {start_epoch}, offset {skip} batches)")
        for epoch in range(start_epoch, max_epochs):
            if self.global_step >= hp.max_step:
                # e.g. resumed from a checkpoint already at max_step: training
                # a 0-step epoch would re-validate and re-checkpoint the same
                # state under the next epoch number.
                logger.info(f"Already at max_step={hp.max_step}; nothing to train.")
                break
            state, _ = self.train_epoch(state, train_ds, epoch,
                                        skip_steps=skip if epoch == start_epoch else 0)
            if dev_ds is not None and (epoch + 1) % hp.val_freq == 0:
                self.validate(state, dev_ds, epoch, warm_user_set)
            self.save_checkpoint(state, epoch)
            if self.global_step >= hp.max_step:
                logger.info(f"Reached max_step={hp.max_step}; stopping.")
                break
        return state


def param_shardings_for_state(state: TrainState, mesh):
    """Shardings pytree matching a TrainState: params + mirrored opt state."""
    p_sh = param_shardings(state.params, mesh)
    from jax.sharding import NamedSharding, PartitionSpec as P

    rep = NamedSharding(mesh, P())

    # Build: params -> p_sh; opt_state/step -> replicated except Adam moments,
    # which mirror their param's sharding. optax.adamw state: (ScaleByAdamState(mu, nu), ...)
    def match_like_params(opt_state):
        def map_state(s):
            if isinstance(s, (optax.ScaleByAdamState,)):
                return s._replace(
                    count=rep,
                    mu=jax.tree.map(lambda _, sh: sh, s.mu, p_sh),
                    nu=jax.tree.map(lambda _, sh: sh, s.nu, p_sh),
                )
            return jax.tree.map(lambda _: rep, s)
        if isinstance(opt_state, tuple):
            return tuple(map_state(s) for s in opt_state)
        return map_state(opt_state)

    return state.replace(
        params=p_sh,
        opt_state=match_like_params(state.opt_state),
        step=rep,
    )
