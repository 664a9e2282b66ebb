"""Multi-process launch harness for the sharded ops.

Without --coordinator the script runs in ONE process over every local
device (e.g. the four GPUs of one host). With --coordinator it runs as one
of several processes on the CPU backend, one device each — the multi-process
simulation; every process names the coordinator, the count and its id:

  # terminal 1..N (N processes x 1 device):
  python scripts/launch_multihost.py --coordinator localhost:9876 \
      --num-processes 2 --process-id 0 &
  python scripts/launch_multihost.py --coordinator localhost:9876 \
      --num-processes 2 --process-id 1 &

Runs a sharded FIR + north-star chain step over the global mesh and reports
per-host timings — the ">= 85% scaling" check from BASELINE.json.
"""

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--coordinator", default=None)
    ap.add_argument("--num-processes", type=int, default=None)
    ap.add_argument("--process-id", type=int, default=None)
    ap.add_argument("--channels", type=int, default=16)
    ap.add_argument("--seconds", type=float, default=10.0)
    ap.add_argument("--per-device-samples", type=int, default=None,
                    help="weak scaling: per-device signal length (overrides "
                         "--seconds; total n = n_devices * this)")
    ap.add_argument("--json-out", default=None,
                    help="process 0 writes {n_processes, n_devices, "
                         "fir_msps, chain_msps} JSON here")
    ap.add_argument("--chain-mode", choices=["staged", "fused"],
                    default="staged",
                    help="apply_sharded halo strategy. 'staged' (default "
                         "here) keeps the gloo sweep comparable to earlier "
                         "rounds AND is the honest efficiency test: the "
                         "fused path's gather-heavy local body runs ~2.7x "
                         "slower on 1-core CPU XLA, which would deflate "
                         "the comm/compute ratio ('fused' halves the "
                         "collective rounds)")
    ap.add_argument("--local-only", action="store_true",
                    help="no distributed init: run the same per-device work "
                         "on a private 1-device mesh (the no-communication "
                         "baseline for isolating collective overhead from "
                         "host resource contention in CPU simulations)")
    args = ap.parse_args()

    import jax

    if args.local_only:
        jax.config.update("jax_platforms", "cpu")
    elif args.coordinator:
        # CPU simulation needs one device per process
        jax.config.update("jax_platforms", "cpu")
        jax.distributed.initialize(args.coordinator, args.num_processes,
                                   args.process_id)

    import numpy as np
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P
    from vv_dsp_tpu.parallel import mesh as pmesh, fir_apply_sharded
    from vv_dsp_tpu.ops import fir
    from vv_dsp_tpu.models import NorthStarChain

    n_dev = len(jax.devices())
    mesh = pmesh.make_mesh(1, n_dev)
    if jax.process_index() == 0:
        print(f"{jax.process_count()} processes, {n_dev} devices, "
              f"mesh {dict(mesh.shape)}")

    if args.per_device_samples is not None:
        per = args.per_device_samples - args.per_device_samples % (512 * 3)
        n = n_dev * per
    else:
        n = int(48000 * args.seconds)
        n -= n % (n_dev * 512 * 3)
    # each process materializes only its addressable shard
    global_shape = (args.channels, n)
    sharding = NamedSharding(mesh, P("channel", "block"))
    rng = np.random.default_rng(jax.process_index())

    def make_local(idx):
        shape = tuple(len(range(*s.indices(dim)))
                      for s, dim in zip(idx, global_shape))
        return jnp.asarray(rng.standard_normal(shape), dtype=jnp.float32)

    x = jax.make_array_from_callback(global_shape, sharding, make_local)

    def timed(step_fn, iters=5, trials=3):
        """Best-of-trials mean step time — single-trial timing on this
        shared 4-core box measured +-40% run-to-run."""
        step_fn(x).block_until_ready()  # compile + gloo warmup
        best = float("inf")
        for _ in range(trials):
            t0 = time.perf_counter()
            out = None
            for _ in range(iters):
                out = step_fn(x)
            out.block_until_ready()
            best = min(best, (time.perf_counter() - t0) / iters)
        return best

    h = fir.design_lowpass(1024, 0.45)
    step = jax.jit(lambda v: fir_apply_sharded(h, v, mesh))
    dt = timed(step)
    fir_msps = args.channels * n / dt / 1e6
    if jax.process_index() == 0:
        print(f"sharded 1024-tap FIR: {dt*1e3:.2f} ms/step, "
              f"{fir_msps:.0f} Msps ({fir_msps / n_dev:.0f} Msps/device)")

    if os.environ.get("VV_SCALING_STAGES"):
        # per-stage timings (diagnosing which stage limits weak scaling)
        from vv_dsp_tpu.parallel import (resample_poly_sharded,
                                         stft_process_sharded)

        stages = {
            "fir": jax.jit(lambda v: fir_apply_sharded(h, v, mesh)),
            "resample": jax.jit(
                lambda v: resample_poly_sharded(v, 4, 3, mesh)),
            "stft": jax.jit(
                lambda v: stft_process_sharded(v, 2048, 512, mesh)),
        }
        for name, fn in stages.items():
            fn(x).block_until_ready()
            t0 = time.perf_counter()
            for _ in range(3):
                r = fn(x)
            r.block_until_ready()
            dt = (time.perf_counter() - t0) / 3
            if jax.process_index() == 0:
                print(f"  stage {name}: {dt*1e3:.1f} ms")

    chain = NorthStarChain()
    cstep = jax.jit(lambda v: chain.apply_sharded(
        v, mesh, fuse_halos=(args.chain_mode == "fused")))
    dt = timed(cstep, iters=3)
    chain_msps = args.channels * n / dt / 1e6
    if jax.process_index() == 0:
        print(f"sharded north-star chain: {dt*1e3:.2f} ms/step -> "
              f"{chain_msps:.0f} Msps input-rate")
        if args.json_out:
            import json

            with open(args.json_out, "w") as f:
                json.dump({"n_processes": jax.process_count(),
                           "n_devices": n_dev, "samples": n,
                           "channels": args.channels,
                           "fir_msps": fir_msps,
                           "chain_msps": chain_msps}, f)


if __name__ == "__main__":
    main()
