"""Microbench of the gather/scatter/compare primitives the projection
kernels are built from, on the real chip — calibrates the cost model that
decides which formulation (serialized gather/scatter vs vectorised
one-hot compare vs scatter-delta) each kernel stage should use.

Usage: python tools/bench_prims.py [iters]
Prints one line per primitive: ns/element and ms/iter at the probed shape.
"""

import sys
import time

sys.path.insert(0, ".")

from panvc3_tpu.utils import enable_compile_cache  # noqa: E402


def main() -> None:
    iters = int(sys.argv[1]) if len(sys.argv) > 1 else 50
    enable_compile_cache()

    import jax
    import jax.numpy as jnp
    import numpy as np
    from functools import partial

    rng = np.random.default_rng(7)
    B, W, R = 8192, 32, 128
    TAB = 1 << 20

    tab = jax.device_put(rng.integers(0, 1000, TAB).astype(np.int32))
    idx = jax.device_put(rng.integers(0, TAB, (B, W)).astype(np.int32))
    sidx = jax.device_put(rng.integers(0, R, (B, W)).astype(np.int32))
    vals = jax.device_put(rng.integers(0, 1000, (B, W)).astype(np.int32))
    a = jax.device_put(rng.integers(0, R // 2, (B, 8)).astype(np.int32))
    bb = jax.device_put((np.asarray(a) + 4).astype(np.int32))

    bidx = jnp.arange(B, dtype=jnp.int32)[:, None]

    def mk(fn):
        @partial(jax.jit, static_argnames=("n",))
        def loop(x, n):
            def body(i, acc):
                return acc + fn(x, i)
            return jax.lax.fori_loop(0, n, body, jnp.int32(0))
        return loop

    cases = {
        # one (B, W) gather from a 1M-entry table
        f"gather {B}x{W}": (
            mk(lambda x, i: jnp.sum(tab[jnp.minimum(x + i % 3, TAB - 1)])),
            idx, B * W,
        ),
        # one (B, W) -> (B, R) two-dim scatter-add
        f"scatter2d {B}x{W}": (
            mk(lambda x, i: jnp.sum(
                jnp.zeros((B, R), jnp.int32)
                .at[bidx, jnp.minimum(x + i % 3, R - 1)].add(vals)
            )),
            sidx, B * W,
        ),
        # flat 1-D scatter of B*W elements into a pool (indices spread by a
        # large odd multiplier — small-range indices would measure collision
        # serialization instead of a representative scatter)
        f"scatter1d {B * W}": (
            mk(lambda x, i: jnp.sum(
                jnp.zeros(B * W, jnp.int32)
                .at[
                    ((jnp.arange(B * W, dtype=jnp.int32) + x.reshape(-1) + i)
                     * 48271 % (B * W))
                ].add(vals.reshape(-1))
            )),
            sidx, B * W,
        ),
        # one-hot interval paint (B, 8, R) compare + any-reduce
        f"onehot {B}x8x{R}": (
            mk(lambda x, i: jnp.sum(
                jnp.any(
                    (jnp.minimum(x + i % 3, R)[:, :, None]
                     <= jnp.arange(R, dtype=jnp.int32)[None, None, :])
                    & (jnp.arange(R, dtype=jnp.int32)[None, None, :]
                       <= bb[:, :, None]),
                    axis=1,
                ).astype(jnp.int32)
            )),
            a, B * 8 * R,
        ),
        # (B, R) cumsum along lanes
        f"cumsum {B}x{R}": (
            mk(lambda x, i: jnp.sum(
                jnp.cumsum(
                    jnp.zeros((B, R), jnp.int32)
                    .at[bidx, jnp.minimum(x[:, :1] + i % 3, R - 1)].add(1),
                    axis=1,
                )
            )),
            sidx, B * R,
        ),
    }

    for name, (loop, arg, elems) in cases.items():
        jax.block_until_ready(loop(arg, iters))
        best = float("inf")
        for _ in range(3):
            t0 = time.perf_counter()
            jax.block_until_ready(loop(arg, iters))
            best = min(best, time.perf_counter() - t0)
        per = best / iters
        print(
            f"[prims] {name}: {per * 1e3:.3f} ms/iter"
            f"  {per / elems * 1e9:.3f} ns/elem",
            flush=True,
        )


if __name__ == "__main__":
    main()
