"""Time the on-device chain + runs-summary stages in isolation on the
live chip (serialized dependency chain, scalar fetch at end)."""
import sys
import time

sys.path.insert(0, "/root/repo")

import numpy as np  # noqa: E402

from ntlink_jax.jax_setup import configure  # noqa: E402

configure()
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from ntlink_jax.parallel.mesh import (  # noqa: E402
    chain_anchors_device,
    summarize_runs_device,
)

B, S, NC = 1024, 512, 16
rng = np.random.default_rng(0)
found_np = rng.random((B, S)) < 0.3
cid_np = rng.integers(0, NC, (B, S)).astype(np.int32)
cpos_np = rng.integers(0, 250_000, (B, S)).astype(np.int32)
rlens_np = np.full(B, 15_000, np.int32)
clen_np = np.full(NC, 250_000, np.int32)
rposw_np = rng.integers(0, 15_000, (B, S)).astype(np.int32)


@jax.jit
def chain_only(found, cid, cpos, rlens, clen, seed):
    f = found ^ (cid == (seed & 0x7))  # perturb so dispatches are distinct
    keep, ov = chain_anchors_device(f, cid, cpos, rlens, clen, 1000, 32)
    return keep.sum() + ov.sum()


@jax.jit
def chain_runs(found, cid, cpos, rposw, rlens, clen, seed):
    f = found ^ (cid == (seed & 0x7))
    keep, ov = chain_anchors_device(f, cid, cpos, rlens, clen, 1000, 32)
    outs = summarize_runs_device(keep, cid, cpos, rposw)
    return sum(o.sum() for o in outs[1:]) + outs[0].sum()


def timeit(fn, args, iters=16):
    carry = jnp.int32(0)
    _ = np.asarray(fn(*args, carry))
    t0 = time.perf_counter()
    for _ in range(iters):
        carry = fn(*args, carry).astype(jnp.int32)
    np.asarray(carry)
    return (time.perf_counter() - t0) / iters


a = (jnp.asarray(found_np), jnp.asarray(cid_np), jnp.asarray(cpos_np),
     jnp.asarray(rlens_np), jnp.asarray(clen_np))
ar = (jnp.asarray(found_np), jnp.asarray(cid_np), jnp.asarray(cpos_np),
      jnp.asarray(rposw_np), jnp.asarray(rlens_np), jnp.asarray(clen_np))
print(f"chain_only : {timeit(chain_only, a)*1e3:.1f} ms / {B}x{S}")
print(f"chain+runs : {timeit(chain_runs, ar)*1e3:.1f} ms / {B}x{S}")
