"""Bench: polyphase resample paths (gather-einsum vs strided conv vs
multistage)."""
import sys, os; sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import numpy as np, jax, jax.numpy as jnp
from vv_dsp_tpu.ops import resample as R
from vv_dsp_tpu.utils.profiling import chain_benchmark

rng = np.random.default_rng(0)
C, N = 16, 480_000
x = jnp.asarray(rng.standard_normal((C, N)), dtype=jnp.float32)

def bench(name, fn):
    def step(v, acc):
        # full-output consumption: a sliced result lets XLA skip work
        return jnp.sum(fn(v + acc * 1e-30)).astype(jnp.float32) * 1e-30
    try:
        r = chain_benchmark(name, step, x, n_samples=C * N, iters=8)
        print(f"{name:>28}: {r.elapsed_ms:8.2f} ms  {r.samples_per_sec/1e6:8.0f} Msps", flush=True)
    except Exception as e:
        print(f"{name:>28}: FAILED {type(e).__name__} {str(e)[:100]}", flush=True)

ratios = [(4,3), (160,147), (2,1), (1,2)]
if len(sys.argv) > 1:
    ratios = [tuple(int(v) for v in s.split("/")) for s in sys.argv[1].split(",")]
for up, down in ratios:
    bench(f"mxu {up}/{down}", lambda v, u=up, d=down: R.resample_poly_mxu(v, u, d))
    bench(f"gather {up}/{down}", lambda v, u=up, d=down: R.resample_poly(v, u, d))
    if (up, down) == (160, 147):
        bench("multistage 160/147", lambda v: R.resample_multistage(v, 160, 147))

if "--frames" in sys.argv:
    for up, down in [(160,147), (147,160)]:
        h = R._resample_poly_filter(up, down)
        n_out = -(-N * up // down)
        bench(f"frames-mm {up}/{down}", lambda v, u=up, d=down, hh=h, no=n_out:
              R._upfirdn_frames_matmul(hh, v, u, d, (len(hh)-1)//2, no))
