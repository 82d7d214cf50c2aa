"""Multi-host orchestration.

Scaling model (see DESIGN.md and the scaling recipe in README):

- every host runs the same pipeline binary; `maybe_init_distributed()`
  connects them into one process group when the standard env vars are
  present (JAX_COORDINATOR / NTLINK_COORDINATOR, NTLINK_NUM_PROCESSES,
  NTLINK_PROCESS_ID). Setting NTLINK_GROUP_DIR instead selects a
  shared-directory transport (NFS-style deployments / tests) that needs no
  coordinator service,
- one rank per host: each rank drives every local accelerator of its host
  on the `data` mesh axis, so two ranks on one host would both claim the
  same cards (a JAX process reserves most of each card's memory). Ranks
  check this at start-up and fail when two share an accelerator host,
- the contig index is built once per host (the build is deterministic, so
  every host builds the same replicated table from the same target FASTA),
- read files are partitioned across hosts round-robin (`shard_read_files`);
  within a host, batches shard across its local devices on the `data` mesh
  axis,
- each host's pair tally is all-gathered and merged after mapping
  (`all_gather_tallies`): the tally is a per-pair list of gap estimates +
  anchor counts, which merges associatively; medians are taken after the
  merge, exactly as the reference computes them over the global dict,
- per-host verbose/PAF artifact parts (one per read file) are exchanged and
  concatenated in global read-file order (`merge_file_parts`), so every
  host ends up with the reference's canonical single files
  (ntlink_pair.py:382-388) and gap_fill / rounds / checkpoints work
  unchanged at n_processes > 1.

The result is bit-identical to a single-host run: per-file artifact parts
re-interleave into exactly the single-host byte order, and the tally merge
follows the same global order.
"""
from __future__ import annotations

import os
import pickle
import time
from typing import Dict, List, Optional, Tuple

from ..pairs import PairEvidence, PairKey, PairTally


class Transport:
    """Collective byte exchange over the process group."""

    process_id = 0
    n_processes = 1

    def allgather(self, blob: bytes) -> List[bytes]:
        raise NotImplementedError


class LocalTransport(Transport):
    def allgather(self, blob: bytes) -> List[bytes]:
        return [blob]


class JaxTransport(Transport):
    """Rides jax.distributed's coordination service."""

    def __init__(self, process_id: int, n_processes: int):
        self.process_id = process_id
        self.n_processes = n_processes

    def allgather(self, blob: bytes) -> List[bytes]:
        import numpy as np
        from jax.experimental import multihost_utils

        lengths = multihost_utils.process_allgather(
            np.array([len(blob)], dtype=np.int64)
        )
        lengths = lengths.reshape(-1)
        max_len = max(int(lengths.max()), 1)
        padded = np.frombuffer(blob.ljust(max_len, b"\0"), dtype=np.uint8)
        gathered = multihost_utils.process_allgather(padded)
        return [
            gathered[i, : int(lengths[i])].tobytes()
            for i in range(gathered.shape[0])
        ]


def _read_pointer(path: str) -> Optional[str]:
    try:
        with open(path) as fh:
            return fh.read().strip() or None
    except FileNotFoundError:
        return None


def _glob_joins(run_dir: str, rank: int) -> List[str]:
    """Join files for `rank`, excluding in-flight `.tmp.<pid>` writes."""
    import glob

    return [
        p
        for p in glob.glob(os.path.join(run_dir, f"join.{rank}.*"))
        if len(os.path.basename(p).split(".")) == 3
    ]


class DirTransport(Transport):
    """Shared-directory collective (NFS deployments, multi-process tests).

    Each call writes `<attempt-dir>/<seq>.<rank>` atomically (tmp + rename)
    and waits for all ranks' files; a per-instance sequence number keeps
    successive collectives from colliding (all ranks issue collectives in
    the same program order).

    Collectives live in a per-attempt namespace, established by an explicit
    join handshake (never by file mtimes, which race on quick reruns):

    - rank 0 mints a fresh `attempt-<nonce>` directory and publishes the
      nonce via an atomically-replaced CURRENT pointer, then waits for a
      `join.<rank>.<token>` file from every peer inside that directory and
      acknowledges each with `ack.<rank>.<token>`,
    - every other rank polls CURRENT, writes its join (with a fresh random
      token) into whichever attempt is currently published, and only adopts
      an attempt once it sees the ack matching its own token. A stale
      CURRENT from an earlier run can never be adopted: its dead rank 0
      will never ack the fresh token, and the rank keeps following CURRENT
      until the live rank 0 publishes and acks.

    Because every attempt handshakes a brand-new namespace, back-to-back
    reruns over the same group directory (with or without NTLINK_RUN_ID,
    which merely scopes the namespace under `run-<id>`) can never consume a
    previous attempt's blobs. Old attempt directories are inert litter;
    callers may delete the group dir between runs. Consumed blobs are
    garbage-collected one collective later (when this rank completes
    collective `seq`, every rank has completed `seq-1` — see allgather)."""

    def __init__(self, path: str, process_id: int, n_processes: int,
                 timeout: float = 300.0):
        import uuid

        self.process_id = process_id
        self.n_processes = n_processes
        self.timeout = timeout
        self._seq = 0
        run_id = os.environ.get("NTLINK_RUN_ID")
        base = os.path.join(path, f"run-{run_id}") if run_id else path
        os.makedirs(base, exist_ok=True)
        current = os.path.join(base, "CURRENT")
        deadline = time.time() + timeout
        if process_id == 0:
            nonce = uuid.uuid4().hex[:12]
            self.dir = os.path.join(base, f"attempt-{nonce}")
            os.makedirs(self.dir)
            self._publish(current, nonce)
            pending = set(range(1, n_processes))
            while pending:
                for rank in sorted(pending):
                    for join in _glob_joins(self.dir, rank):
                        token = join.rsplit(".", 1)[1]
                        self._publish(
                            os.path.join(self.dir, f"ack.{rank}.{token}"),
                            "",
                        )
                        pending.discard(rank)
                if not pending:
                    break
                if time.time() > deadline:
                    raise TimeoutError(
                        f"rank 0: ranks {sorted(pending)} never joined "
                        f"attempt {nonce} in {base} (all ranks must be "
                        f"launched for every attempt; each attempt "
                        f"handshakes a fresh namespace, so reuse of the "
                        f"group dir is safe)"
                    )
                time.sleep(0.02)
        else:
            token = uuid.uuid4().hex[:12]
            joined: set = set()
            while True:
                nonce = _read_pointer(current)
                if nonce:
                    d = os.path.join(base, f"attempt-{nonce}")
                    if os.path.isdir(d):
                        if nonce not in joined:
                            self._publish(
                                os.path.join(
                                    d, f"join.{process_id}.{token}"
                                ),
                                "",
                            )
                            joined.add(nonce)
                        if os.path.exists(
                            os.path.join(d, f"ack.{process_id}.{token}")
                        ):
                            self.dir = d
                            break
                if time.time() > deadline:
                    raise TimeoutError(
                        f"rank {process_id}: rank 0 never acknowledged the "
                        f"join in {base} (is rank 0 up and launched for "
                        f"this attempt?)"
                    )
                time.sleep(0.02)

    @staticmethod
    def _publish(path: str, content: str) -> None:
        tmp = f"{path}.tmp.{os.getpid()}"
        with open(tmp, "w") as fh:
            fh.write(content)
        os.replace(tmp, path)

    def allgather(self, blob: bytes) -> List[bytes]:
        seq = self._seq
        self._seq += 1
        mine = os.path.join(self.dir, f"{seq}.{self.process_id}")
        tmp = mine + ".tmp"
        with open(tmp, "wb") as fh:
            fh.write(blob)
        os.replace(tmp, mine)
        parts = []
        deadline = time.time() + self.timeout
        for rank in range(self.n_processes):
            path = os.path.join(self.dir, f"{seq}.{rank}")
            while not os.path.exists(path):
                if time.time() > deadline:
                    raise TimeoutError(
                        f"rank {rank} never produced {path} (every attempt "
                        f"over a group dir handshakes its own namespace; a "
                        f"missing blob means that rank died or was never "
                        f"launched — relaunch all ranks together)"
                    )
                time.sleep(0.02)
            with open(path, "rb") as fh:
                parts.append(fh.read())
        # GC: completing collective `seq` proves every rank finished
        # `seq-1` (each read all ranks' seq files, which are written only
        # after their writers finished seq-1), so this rank's seq-1 blob can
        # no longer be read by anyone.
        if seq > 0:
            try:
                os.unlink(os.path.join(self.dir, f"{seq - 1}.{self.process_id}"))
            except FileNotFoundError:
                pass
        return parts


_TRANSPORT: Optional[Transport] = None


def get_transport() -> Transport:
    global _TRANSPORT
    if _TRANSPORT is None:
        maybe_init_distributed()
    return _TRANSPORT


def maybe_init_distributed() -> Tuple[int, int]:
    """Initialize the process group from env; returns (pid, n_processes).

    No-op single-process when unconfigured. NTLINK_GROUP_DIR selects the
    shared-directory transport; otherwise a coordinator address selects
    jax.distributed.
    """
    global _TRANSPORT
    if _TRANSPORT is not None:
        return _TRANSPORT.process_id, _TRANSPORT.n_processes
    n = int(os.environ.get("NTLINK_NUM_PROCESSES", "0") or 0)
    pid = int(os.environ.get("NTLINK_PROCESS_ID", "0") or 0)
    group_dir = os.environ.get("NTLINK_GROUP_DIR")
    coord = os.environ.get("NTLINK_COORDINATOR") or os.environ.get(
        "JAX_COORDINATOR"
    )
    if group_dir and n > 1:
        _TRANSPORT = DirTransport(group_dir, pid, n)
        _check_one_rank_per_host(_TRANSPORT)
        return pid, n
    if coord and n > 1:
        import jax

        jax.distributed.initialize(
            coordinator_address=coord, num_processes=n, process_id=pid
        )
        _TRANSPORT = JaxTransport(pid, n)
        _check_one_rank_per_host(_TRANSPORT)
        return pid, n
    _TRANSPORT = LocalTransport()
    return 0, 1


def _check_one_rank_per_host(transport: Transport) -> None:
    """Fail when two ranks share an accelerator host: each rank maps on
    every local device, so both would claim the same cards. Ranks on the
    CPU backend (tests, CPU-only hosts) share nothing and may co-locate."""
    import socket

    import jax

    if jax.default_backend() == "cpu":
        return
    hosts = [b.decode() for b in transport.allgather(socket.gethostname().encode())]
    shared = sorted({h for h in hosts if hosts.count(h) > 1})
    if shared:
        raise RuntimeError(
            f"ranks share accelerator host(s) {shared}: run one rank per "
            f"host (each rank drives all of its host's devices)"
        )


def shard_read_files(files: List[str], process_id: int, n_processes: int) -> List[str]:
    """Round-robin partition of read files across hosts."""
    return [f for i, f in enumerate(files) if i % n_processes == process_id]


def serialize_tally(tally: PairTally) -> bytes:
    payload = [
        (
            (p.source, p.source_ori, p.target, p.target_ori),
            ev.gap_estimates,
            ev.anchor,
        )
        for p, ev in tally.pairs.items()
    ]
    return pickle.dumps(payload)


def merge_tallies(
    base: PairTally, serialized_parts: List[bytes]
) -> PairTally:
    """Merge per-host tallies into `base` (order: parts in the given order).

    Gap-estimate lists concatenate; anchors add. The merged per-pair
    insertion order is the first sighting across parts in order, which keeps
    pairs.tsv deterministic for a fixed file partition.
    """
    for blob in serialized_parts:
        for (s, so, t, to), gaps, anchor in pickle.loads(blob):
            key = PairKey(s, so, t, to)
            ev = base.pairs.get(key)
            if ev is None:
                ev = base.pairs[key] = PairEvidence()
            ev.gap_estimates.extend(gaps)
            ev.anchor += anchor
    return base


def all_gather_tallies(tally: PairTally) -> PairTally:
    """All-gather the per-host tallies over the process group."""
    transport = get_transport()
    if transport.n_processes == 1:
        return tally
    parts = transport.allgather(serialize_tally(tally))
    merged = PairTally(tally.contig_lengths, tally.k, tally.f_cap)
    return merge_tallies(merged, parts)


def all_gather_file_tallies(
    per_file: Dict[int, PairTally], template: PairTally
) -> PairTally:
    """All-gather per-read-file tallies and merge them in global file order.

    Merging file-by-file (not host-by-host) reproduces the single-host
    insertion and gap-list order exactly, so pairs.tsv / DOT / medians are
    byte-identical to an unsharded run.
    """
    transport = get_transport()
    payload = {fi: serialize_tally(t) for fi, t in per_file.items()}
    if transport.n_processes > 1:
        merged_blobs: Dict[int, bytes] = {}
        for blob in transport.allgather(pickle.dumps(payload)):
            merged_blobs.update(pickle.loads(blob))
    else:
        merged_blobs = payload
    merged = PairTally(template.contig_lengths, template.k, template.f_cap)
    return merge_tallies(
        merged, [merged_blobs[fi] for fi in sorted(merged_blobs)]
    )


def merge_file_parts(final_path: str, my_parts: Dict[int, str]) -> None:
    """Exchange per-read-file artifact parts and write the canonical file.

    `my_parts` maps global read-file index -> local part path for the files
    this host mapped. All hosts receive every part and concatenate them in
    file-index order, reproducing the single-host byte order exactly
    (reference contract: one verbose file, ntlink_pair.py:382-388). Each
    host writes the result atomically to its local filesystem (identical
    content everywhere, so shared-FS double writes are benign); local part
    files are removed.

    Production note: parts travel over the group transport — for huge
    verbose checkpoints across hosts prefer a shared filesystem
    (NTLINK_GROUP_DIR), where the exchange is just renames.
    """
    transport = get_transport()
    payload = {}
    for idx, path in my_parts.items():
        with open(path, "rb") as fh:
            payload[idx] = fh.read()
    if transport.n_processes > 1:
        gathered = transport.allgather(pickle.dumps(payload))
        merged: Dict[int, bytes] = {}
        for blob in gathered:
            merged.update(pickle.loads(blob))
    else:
        merged = payload
    tmp = final_path + ".tmp"
    with open(tmp, "wb") as fh:
        for idx in sorted(merged):
            fh.write(merged[idx])
    os.replace(tmp, final_path)
    for path in my_parts.values():
        if os.path.exists(path):
            os.unlink(path)
