"""telr_jax DP benchmark on one NVIDIA GPU.

Times the device wavefront the GPU runs (kernels/wave_align.py GPU_IMPL:
the CUDA DP and its traceback walk) on device-resident inputs: 64 pairs
of a 2048-base query against a 3072-base target with chain-anchor guides,
band width 2048, EXTEND mode.  Reports DP cells per second, counting
(lq + lt) anti-diagonal steps x W band cells per pair.

Prints the device and the card's name and power limit first and one JSON
line last.  Without a GPU it exits non-zero.  Pipeline-level metrics are
not measured here.
"""

import json
import subprocess
import sys
import time

import numpy as np


def main():
    from telr_jax.utils.runtime import init_compile_cache
    import jax
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        sys.exit(f"bench.py needs an NVIDIA GPU; JAX found {dev.platform!r}")
    init_compile_cache()
    from telr_jax.kernels import dp
    from telr_jax.kernels import wave_align as wa

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    print(f"device: {dev.device_kind} x{len(jax.devices())}; "
          f"nvidia-smi: {smi.stdout.strip()}", file=sys.stderr)

    B, LQ, LT, W = 64, 2048, 3072, 2048
    rng = np.random.default_rng(0)
    pairs = []
    for _ in range(B):
        t = rng.integers(0, 4, LT).astype(np.int8)
        q = t[:LQ].copy()
        idx = rng.integers(0, LQ, 200)
        q[idx] = rng.integers(0, 4, 200)
        pairs.append((q, t))
    aq = np.arange(256, LQ - 256, 512, dtype=np.int64)
    guides = [(aq, aq) for _ in range(B)]
    batch = wa.prepare_wavefront_batch(pairs, W, guides, light=True)
    args = [jax.device_put(a)
            for a in (batch.meta, batch.qw, batch.tw, batch.scal)]
    params = dp.DPParams().tuple()

    def run():
        return wa.fused_step(*args, width=W, mode=dp.EXTEND,
                             params_tuple=params, impl=wa.GPU_IMPL)

    t0 = time.perf_counter()
    jax.block_until_ready(run())
    print(f"compile+first: {time.perf_counter() - t0:.2f} s",
          file=sys.stderr)
    iters, trials = 16, 5
    dts = []
    for _ in range(trials):
        t0 = time.perf_counter()
        jax.block_until_ready([run() for _ in range(iters)])
        dts.append((time.perf_counter() - t0) / iters)
    cells = B * (LQ + LT) * W
    rates = [cells / d / 1e9 for d in dts]
    print("trials: " + ", ".join(f"{r:.2f}" for r in rates) + " Gcells/s",
          file=sys.stderr)
    print(json.dumps({
        "metric": "wavefront DP + walk throughput",
        "value": round(float(np.median(rates)), 3),
        "unit": "Gcells/s",
        "trials_gcells_s": [round(r, 3) for r in rates],
        "device": {"platform": dev.platform, "kind": dev.device_kind,
                   "count": len(jax.devices())},
    }))


if __name__ == "__main__":
    main()
