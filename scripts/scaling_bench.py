"""Scaling-efficiency benchmark: DCN e2e training throughput vs device count.

Measures the same workload as ``bench.py`` (full Trainer epoch, synthetic
MIND-scale data) over a data-parallel mesh of 1..N devices and reports
examples/s, examples/s/chip, and scaling efficiency vs the single-device
run.

Single-host sweep over local devices (real chips, or a virtual CPU mesh):

    python scripts/scaling_bench.py --sweep
    JAX_PLATFORMS=cpu XLA_FLAGS=--xla_force_host_platform_device_count=8 \
        python scripts/scaling_bench.py --sweep --rows 65536

Multi-host (run ONE copy per host; prints on process 0):

    python scripts/scaling_bench.py --coordinator host0:1234 \
        --num-processes 2 --process-id $ID

Output: one JSON line per measured device count.
"""

import argparse
import json
import sys
import tempfile
import time

sys.path.insert(0, ".")


def measure(n_devices: int, rows: int, batch_per_chip: int, optimizer: str,
            model_name: str, multihost: bool):
    import jax
    import numpy as np

    from news_recsys_tpu.data.packed_dataset import PackedDataset
    from news_recsys_tpu.models.rankers import build_ranker
    from news_recsys_tpu.parallel.mesh import make_mesh
    from news_recsys_tpu.training.trainer import Trainer
    from news_recsys_tpu.zoo import MIND_FEATURES, MIND_TABLE_SIZE, mind_config

    devices = jax.devices() if multihost else jax.devices()[:n_devices]
    n = len(devices)
    global_batch = batch_per_chip * n
    # identical synthetic data on every host (seeded) so replicated
    # device_put is consistent across processes
    rng = np.random.default_rng(0)
    arrays = {
        name: rng.integers(1, MIND_TABLE_SIZE[name], rows).astype(np.int32)
        for name in MIND_FEATURES
    }
    arrays["label"] = (rng.random(rows) < 0.1).astype(np.float32).reshape(-1, 1)
    ds = PackedDataset(arrays)

    cfg = mind_config(model_name, batch_size=global_batch,
                      embedding_optimizer=optimizer, mesh_data=n)
    model = build_ranker(cfg, model_name)
    mesh = make_mesh(data=n, model=1, devices=devices) if n > 1 else None
    with tempfile.TemporaryDirectory() as tmp:
        tr = Trainer(cfg, model, workdir=tmp, mesh=mesh, use_mesh=n > 1)
        state = tr.fit(ds, max_epochs=1)          # epoch 0: compile + warmup
        t0 = time.perf_counter()
        state, m = tr.train_epoch(state, ds, epoch=1)
        dt = time.perf_counter() - t0
    exs = m["steps"] * global_batch / dt
    return {"devices": n, "global_batch": global_batch, "steps": m["steps"],
            "examples_per_sec": round(exs, 1),
            "examples_per_sec_per_chip": round(exs / n, 1)}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--rows", type=int, default=512 * 256)
    ap.add_argument("--batch-per-chip", type=int, default=512)
    ap.add_argument("--model", default="dcn")
    ap.add_argument("--optimizer", default="rowwise_adagrad")
    ap.add_argument("--sweep", action="store_true",
                    help="single-host: measure 1,2,4,...,all local devices")
    ap.add_argument("--devices", type=int, default=0,
                    help="single-host: use this many local devices (0 = all)")
    ap.add_argument("--coordinator", default=None,
                    help="multi-host coordinator address host:port")
    ap.add_argument("--num-processes", type=int, default=None)
    ap.add_argument("--process-id", type=int, default=None)
    args = ap.parse_args()

    multihost = args.coordinator is not None or (
        args.num_processes is not None and args.num_processes > 1)
    if multihost:
        # MUST precede any other jax call
        from news_recsys_tpu.parallel.distributed import initialize_distributed
        initialize_distributed(args.coordinator, args.num_processes, args.process_id)

    import jax

    if multihost:
        res = measure(jax.device_count(), args.rows, args.batch_per_chip,
                      args.optimizer, args.model, multihost=True)
        res["processes"] = jax.process_count()
        if jax.process_index() == 0:
            print(json.dumps(res))
        return

    local = len(jax.devices())
    if args.sweep:
        counts = []
        c = 1
        while c <= local:
            counts.append(c)
            c *= 2
        if counts[-1] != local:
            counts.append(local)
    else:
        counts = [args.devices or local]

    base = None
    for n in counts:
        res = measure(n, args.rows, args.batch_per_chip, args.optimizer,
                      args.model, multihost=False)
        if base is None:
            base = res["examples_per_sec_per_chip"]
        res["scaling_efficiency"] = round(
            res["examples_per_sec_per_chip"] / base, 3) if base else 0.0
        print(json.dumps(res))


if __name__ == "__main__":
    main()
