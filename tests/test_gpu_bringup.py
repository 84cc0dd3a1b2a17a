"""What running on a GPU needs from the code: chip_smoke refuses other
devices, the compile cache follows JAX_COMPILATION_CACHE_DIR, the exact
duplicate-id sum asks for HIGHEST precision, the main path needs none of
flax/orbax/yaml/pandas/msgpack, and chip_smoke's phases run at small size."""

import os
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _env(**extra):
    env = {k: v for k, v in os.environ.items() if k != "XLA_FLAGS"}
    env.update(JAX_PLATFORMS="cpu", PYTHONPATH=ROOT, **extra)
    return env


def test_chip_smoke_refuses_cpu(tmp_path):
    proc = subprocess.run([sys.executable, os.path.join(ROOT, "chip_smoke.py")],
                          capture_output=True, text=True, timeout=300,
                          cwd=str(tmp_path), env=_env())
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout
    assert "needs a GPU" in proc.stderr


def test_compile_cache_follows_env(monkeypatch):
    from news_recsys_tpu.utils.compile_cache import enable_compile_cache

    before = jax.config.jax_compilation_cache_dir
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", "/somewhere/else")
    assert enable_compile_cache() is None
    assert jax.config.jax_compilation_cache_dir == before


def test_compile_cache_defaults_to_checkout(monkeypatch):
    from news_recsys_tpu.utils.compile_cache import enable_compile_cache

    before = jax.config.jax_compilation_cache_dir
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    try:
        path = enable_compile_cache()
        assert path == os.path.join(ROOT, ".jax_cache")
        assert jax.config.jax_compilation_cache_dir == path
    finally:
        jax.config.update("jax_compilation_cache_dir", before)


def _dots(jaxpr):
    for eqn in jaxpr.eqns:
        if eqn.primitive.name == "dot_general":
            yield eqn
        for sub in jax.core.jaxprs_in_params(eqn.params):
            yield from _dots(sub)


def test_dedup_matmul_asks_for_highest_precision():
    from news_recsys_tpu.training.sparse_step import _dedup_rows_matmul

    ids = jnp.asarray([3, 1, 3, 0, 7], jnp.int32)
    grads = jnp.ones((5, 4), jnp.float32)
    jaxpr = jax.make_jaxpr(lambda i, g: _dedup_rows_matmul(i, g, 99))(ids, grads).jaxpr
    dots = list(_dots(jaxpr))
    assert len(dots) == 1
    prec = dots[0].params["precision"]
    assert prec == (jax.lax.Precision.HIGHEST, jax.lax.Precision.HIGHEST), prec


_BLOCKED = ("flax", "orbax", "yaml", "pandas", "msgpack")

_NO_OPTIONAL_PACKAGES = textwrap.dedent("""
    import sys

    BLOCKED = {blocked!r}

    class Block:
        def find_spec(self, name, path=None, target=None):
            if name.split(".")[0] in BLOCKED:
                raise ModuleNotFoundError(f"No module named {{name!r}} (blocked)")
            return None

    sys.meta_path.insert(0, Block())

    import tempfile

    import jax
    import numpy as np

    import news_recsys_tpu.cli  # noqa: F401  (the CLI module imports)
    from news_recsys_tpu.config import load_config
    from news_recsys_tpu.data.packed_dataset import PackedDataset
    from news_recsys_tpu.models.dssm import build_dssm
    from news_recsys_tpu.models.rankers import build_ranker
    from news_recsys_tpu.serving import Recommender
    from news_recsys_tpu.training.retrieval import DSSMTrainer
    from news_recsys_tpu.training.trainer import Trainer
    from news_recsys_tpu.zoo import mind_config

    rng = np.random.default_rng(0)
    n = 64
    arrays = {{"user_id": rng.integers(1, 94058, n).astype(np.int32),
              "item_id": rng.integers(1, 65239, n).astype(np.int32),
              "category": rng.integers(1, 18, n).astype(np.int32),
              "subcategory": rng.integers(1, 270, n).astype(np.int32),
              "user_click_category": rng.integers(1, 18, n).astype(np.int32),
              "label": (rng.random(n) < 0.5).astype(np.float32).reshape(-1, 1)}}
    ds = PackedDataset(arrays)
    with tempfile.TemporaryDirectory() as tmp:
        cfg = mind_config("dcn", batch_size=32, embedding_optimizer="rowwise_adagrad")
        tr = Trainer(cfg, build_ranker(cfg, "dcn"), workdir=tmp, use_mesh=False)
        state = tr.fit(ds, max_epochs=1)
        assert int(state.step) == 2
        tr.load_checkpoint(state, tr.ckpt_dir + "/epoch_000.npz")

        cfg = mind_config("dssm", batch_size=32)
        model = build_dssm(cfg)
        dtr = DSSMTrainer(cfg, model, workdir=tmp + "/d", use_mesh=False)
        dstate = dtr.fit(ds, max_epochs=1)
        items = PackedDataset({{k: arrays[k] for k in
                               ("item_id", "category", "subcategory", "label")}})
        rec = Recommender(cfg, model, dstate.params, items, backend="auto")
        assert rec.backend == "host"
        ids, _ = rec.recommend({{k: arrays[k][:4] for k in
                                ("user_id", "user_click_category", "label")}}, k=3)
        assert len(ids) == 4 and all(len(r) == 3 for r in ids)
        rec.save(tmp + "/bundle")
        Recommender.load(tmp + "/bundle")

        with open(tmp + "/c.yaml", "w") as f:
            f.write("name: x\\n")
        try:
            load_config(tmp + "/c.yaml")
        except ImportError as e:
            assert "PyYAML" in str(e), e
        else:
            raise AssertionError("a YAML config loaded without PyYAML")
    print("NO_OPTIONAL_PACKAGES_OK")
""")


def test_main_path_without_optional_packages(tmp_path):
    script = tmp_path / "run.py"
    script.write_text(_NO_OPTIONAL_PACKAGES.format(blocked=_BLOCKED))
    proc = subprocess.run([sys.executable, str(script)], capture_output=True, text=True,
                          timeout=600, cwd=str(tmp_path), env=_env())
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "NO_OPTIONAL_PACKAGES_OK" in proc.stdout


def test_chip_smoke_parity_phases_small():
    """Phase 5's references and tolerances, and phase 6's timing loops, at
    small shapes on the CPU (the card runs them at full width)."""
    sys.path.insert(0, ROOT)
    import chip_smoke

    worst = chip_smoke.phase_op_parity(scale=0.02)
    assert set(worst) == {"lookup_pool", "fm_2nd_order", "dcn_cross",
                          "transformer_block", "scatter_rows"}
    times = chip_smoke.phase_op_timing(scale=0.02, iters=2, runs=1)
    assert len(times) == 8 and all(t > 0 for t in times.values())


def test_chip_smoke_four_cards_on_virtual_devices():
    """--four-cards' mesh paths (2x2, 4x1, explicit collectives, DSSM) match
    one device, on four of the test run's virtual CPU devices."""
    sys.path.insert(0, ROOT)
    import chip_smoke

    chip_smoke.four_cards(n=4, steps_per_epoch=1, epochs=2)


@pytest.mark.gpu
def test_dedup_sum_exact_on_gpu(gpu_device):
    """On the card, the duplicate-id sum equals the float64 sum to float32
    rounding even with default matmul precision in force."""
    from news_recsys_tpu.training.sparse_step import _dedup_rows_matmul

    rng = np.random.default_rng(0)
    ids = rng.integers(1, 50, 4096).astype(np.int32)
    grads = (rng.standard_normal((4096, 32)) * 1e-3).astype(np.float32)
    with jax.default_matmul_precision("default"):
        rows, g, active = jax.device_get(jax.jit(
            lambda i, x: _dedup_rows_matmul(i, x, 99))(jax.device_put(ids, gpu_device),
                                                       jax.device_put(grads, gpu_device)))
    want = {int(i): grads[ids == i].astype(np.float64).sum(0) for i in np.unique(ids)}
    for r, row_g, a in zip(rows, g, active):
        if a:
            np.testing.assert_allclose(row_g, want[int(r)], rtol=1e-5, atol=1e-8)
