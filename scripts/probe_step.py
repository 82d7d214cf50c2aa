"""Loop-differenced on-hardware timing of the fused mapping step:
anchors payload vs on-device-chain vs runs-only payload. Dispatch cost
cancels (N dispatches, one block at the end; per-step = (tN - t1)/(N-1)).
"""
import sys
import time

sys.path.insert(0, "/root/repo")

import numpy as np  # noqa: E402

import bench  # noqa: E402
from ntlink_jax.jax_setup import configure  # noqa: E402

configure()
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from ntlink_jax.device_map import DeviceMapper, _single_device_step  # noqa: E402
from ntlink_jax.parallel.mesh import pack_codes  # noqa: E402


def time_step(dm, packed, lengths, iters=12):
    step = dm._step_for(packed.shape[1] * 4)
    # distinct inputs per dispatch
    dps = []
    for i in range(iters):
        p = packed.copy()
        p[:, 0] = i  # perturb one column
        dps.append(jnp.asarray(p))
    dl = jnp.asarray(lengths)
    out = step(dps[0], dl, dm.didx)
    _ = np.asarray(out["n_anchors"])  # force warm compile + execute
    # serialize: each iteration's input depends on the previous output so
    # the chain cannot be deduped, reordered, or lazily skipped; one
    # scalar fetch at the end forces the whole chain
    t0 = time.perf_counter()
    carry = jnp.uint8(0)
    for dp in dps:
        dp = dp.at[0, 0].set(carry)
        out = step(dp, dl, dm.didx)
        carry = (out["n_anchors"] & 0xFF).astype(jnp.uint8)
    n = np.asarray(carry)
    t1 = time.perf_counter()
    assert n is not None
    return (t1 - t0) / iters


def main():
    contigs, reads, contig_lengths, index = bench.build_workload()
    clen = np.zeros(len(index.contig_names), np.int32)
    for i, nme in enumerate(index.contig_names):
        clen[i] = contig_lengths[nme]
    B, L = 1024, 16384
    from ntlink_jax.ops import nthash_np

    codes = np.zeros((B, L), np.uint8)
    for r, (_, seq) in enumerate(reads[:B]):
        c = nthash_np.encode(seq)[:L]
        codes[r, : len(c)] = c
    packed = pack_codes(codes)
    lengths = np.full(B, L, np.int32)

    for label, kw in (
        ("anchors          ", dict()),
        ("anchors+devchain ", dict(prechain=(clen, bench.Z))),
        ("runs-only        ", dict(prechain=(clen, bench.Z), runs_only=True)),
    ):
        dm = DeviceMapper(
            index, bench.K, bench.W, batch_bases=16_000_000,
            with_hashes=False, **kw,
        )
        dt = time_step(dm, packed, lengths)
        print(f"{label}: {dt*1e3:.1f} ms / {B}x{L} batch "
              f"({B/dt:.0f} reads/s ceiling)", flush=True)


if __name__ == "__main__":
    main()
