"""Sub-stage timing of chain_anchors_device + summarize_runs_device."""
import sys
import time

sys.path.insert(0, "/root/repo")

import numpy as np  # noqa: E402

from ntlink_jax.jax_setup import configure  # noqa: E402

configure()
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from ntlink_jax.parallel.mesh import RUN_LANES  # noqa: E402

B, S, NC = 1024, 512, 16
Z, K = 1000, 32
rng = np.random.default_rng(0)
found_np = rng.random((B, S)) < 0.3
cid_np = rng.integers(0, NC, (B, S)).astype(np.int32)
cpos_np = rng.integers(0, 250_000, (B, S)).astype(np.int32)
rlens_np = np.full(B, 15_000, np.int32)
clen_np = np.full(NC, 250_000, np.int32)


def phase_fn(upto):
    @jax.jit
    def f(found, cid, cpos, rlens, clen, seed):
        found = found ^ (cid == (seed & 0x7))
        B_, S_ = found.shape
        NC_ = int(clen.shape[0])
        rows = jnp.arange(B_, dtype=jnp.int32)[:, None]
        lane = jnp.arange(S_, dtype=jnp.int32)[None, :]
        cidc = jnp.clip(cid, 0, NC_ - 1)
        kept0 = found & (clen[cidc] >= Z)
        if upto == "z":
            return kept0.sum()
        tcid = jnp.where(kept0, cidc, NC_)
        amin = jnp.full((B_, NC_ + 1), jnp.int32(0x7FFFFFFF)).at[
            rows, tcid
        ].min(cpos, mode="drop")
        amax = jnp.full((B_, NC_ + 1), jnp.int32(-1)).at[rows, tcid].max(
            cpos, mode="drop"
        )
        acnt = jnp.zeros((B_, NC_ + 1), jnp.int32).at[rows, tcid].add(
            1, mode="drop"
        )
        noisy = (acnt >= 2) & ((amax - amin) > (rlens[:, None] + K))
        kept1 = kept0 & ~jnp.take_along_axis(noisy, tcid, axis=1)
        if upto == "noisy":
            return kept1.sum()
        pk = jnp.where(kept1, (lane << 13) | cidc, jnp.int32(-1))
        cm = jax.lax.cummax(pk, axis=1)
        prev = jnp.concatenate(
            [jnp.full((B_, 1), -1, jnp.int32), cm[:, :-1]], axis=1
        )
        prev_cid = jnp.where(prev >= 0, prev & 0x1FFF, -1).astype(jnp.int32)
        runstart = kept1 & (prev_cid != cidc)
        run_id = jnp.cumsum(runstart.astype(jnp.int32), axis=1) - 1
        overflow = run_id[:, -1] + 1 > RUN_LANES
        rid = jnp.where(
            kept1, jnp.minimum(run_id, RUN_LANES - 1), RUN_LANES
        )
        if upto == "group":
            return rid.sum() + overflow.sum()
        run_cid = jnp.full((B_, RUN_LANES + 1), -1, jnp.int32).at[
            rows, jnp.where(runstart, rid, RUN_LANES)
        ].set(cidc, mode="drop")[:, :RUN_LANES]
        rvalid = run_cid >= 0
        if upto == "runcid":
            return rvalid.sum()
        r = jnp.arange(RUN_LANES, dtype=jnp.int32)
        same = (
            rvalid[:, :, None]
            & rvalid[:, None, :]
            & (run_cid[:, :, None] == run_cid[:, None, :])
        )
        has_earlier = (
            same & (r[None, :, None] > r[None, None, :])
        ).any(axis=2)
        is_first = rvalid & ~has_earlier
        last_occ = jnp.max(jnp.where(same, r[None, None, :], -1), axis=2)
        f_ = jnp.where(is_first, last_occ, -1)
        pmax = jax.lax.cummax(f_, axis=1)
        pmax_excl = jnp.concatenate(
            [jnp.full((B_, 1), -1, f_.dtype), pmax[:, :-1]], axis=1
        )
        between = rvalid & (pmax_excl > r[None, :])
        doomed = (same & between[:, None, :]).any(axis=2)
        keep_run = rvalid & ~doomed
        keep = kept1 & jnp.take_along_axis(
            jnp.concatenate(
                [keep_run, jnp.zeros((B_, 1), jnp.bool_)], axis=1
            ),
            rid,
            axis=1,
        )
        return (keep & ~overflow[:, None]).sum()

    return f


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
for upto in ("z", "noisy", "group", "runcid", "full"):
    print(f"{upto:7s}: {timeit(phase_fn(upto), a)*1e3:.1f} ms", flush=True)
