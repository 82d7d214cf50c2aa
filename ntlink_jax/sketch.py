"""High-level minimizer sketching (indexlr-equivalent).

Produces per-sequence `Minimizers` (see ops.nthash_np) through a pluggable
backend and renders the reference toolchain's sketch TSV dialects
(reference ntLink:198-199, 221-225, 243-244):

- contigs:  ``name\\thash:pos:strand ...``
- reads:    ``name\\tlen\\thash:pos:strand ...``  (``with_len=True``)
- overlap:  ``name\\thash:pos ...``               (``with_strand=False``)
"""
from __future__ import annotations

from typing import Iterable, Iterator, Tuple

from .ops import nthash_np
from .ops.nthash_np import Minimizers
from .seqio import stream_fastx


def get_backend(name: str = "auto", threads: int = 1):
    """Resolve a sketching backend by name
    ("numpy", "jax", "hybrid", "auto")."""
    if name == "numpy":
        return None
    try:
        from .ops import sketch_jax  # noqa: PLC0415
    except ImportError:
        if name != "auto":
            # an explicitly pinned backend must not silently run as
            # something else — `auto` degrades only without JAX installed
            raise
        return None
    dev = sketch_jax.JaxSketcher()
    if name == "hybrid" or (name == "auto" and threads > 1):
        from .native import sketch_module

        if sketch_module() is not None:
            # device + native C thread pool concurrently (bit-exact
            # merge): never loses to either path alone, so it is also the
            # `auto` choice whenever the C sketcher is built and the
            # config grants host threads
            return HybridSketcher(dev, threads=max(1, threads))
        if name == "hybrid":
            raise RuntimeError(
                "backend=hybrid requires the native C sketch module "
                "(ntlink_jax.native.sketch) — build it or use "
                "backend=jax/auto"
            )
    return dev


def sketch_sequences(
    named_seqs: Iterable[Tuple[str, str]],
    k: int,
    w: int,
    backend=None,
    threads: int = 1,
) -> Iterator[Tuple[str, int, Minimizers]]:
    """Yield (name, seq_len, Minimizers) per input sequence.

    `threads` > 1 (host backend only) runs the native C rolling sketcher
    over a thread pool — it releases the GIL, so this is real CPU
    parallelism (the stand-in for btllib indexlr's `-t`, ntLink:199).
    Output order is preserved."""
    if backend is None:
        import numpy as np

        from .native import sketch_module

        def to_codes(seq):
            # payloads may arrive pre-encoded (HybridSketcher paths)
            return seq if isinstance(seq, np.ndarray) else nthash_np.encode(seq)

        sm = sketch_module()
        if sm is not None:
            # native rolling sketcher (bit-exact vs nthash_np; ~6x the
            # vectorized NumPy hasher at assembly scale)

            def decode(res, n):
                _, hb, pb, fb = res
                return n, Minimizers(
                    np.frombuffer(hb, np.uint64),
                    np.frombuffer(pb, np.int64),
                    np.frombuffer(fb, np.uint8).astype(bool),
                )

            if threads > 1:
                from collections import deque
                from concurrent.futures import ThreadPoolExecutor

                def job(item):
                    name, seq = item
                    return name, decode(
                        sm.sketch(to_codes(seq), k, w), len(seq)
                    )

                with ThreadPoolExecutor(max_workers=threads) as pool:
                    # bounded in-flight window (2x threads): keeps every
                    # core fed without materializing the whole input (a
                    # genome's worth of sequence) in memory; FIFO pops
                    # preserve input order
                    inflight = deque()
                    for item in named_seqs:
                        inflight.append(pool.submit(job, item))
                        if len(inflight) >= 2 * threads:
                            name, (n, mins) = inflight.popleft().result()
                            yield name, n, mins
                    while inflight:
                        name, (n, mins) = inflight.popleft().result()
                        yield name, n, mins
                return
            for name, seq in named_seqs:
                n, mins = decode(sm.sketch(to_codes(seq), k, w), len(seq))
                yield name, n, mins
            return
        for name, seq in named_seqs:
            yield name, len(seq), nthash_np.sketch_codes(to_codes(seq), k, w)
    else:
        yield from backend.sketch_stream(named_seqs, k, w)


class _DeviceSketchPath:
    """Adapt a device sketch backend to the HybridStream path interface."""

    def __init__(self, backend, k: int, w: int):
        self.backend, self.k, self.w = backend, k, w

    def map_stream_raw(self, named_codes):
        yield from self.backend.sketch_stream(named_codes, self.k, self.w)


class _HostSketchPath:
    """Threaded native-C sketch path (HybridStream interface)."""

    def __init__(self, k: int, w: int, threads: int):
        self.k, self.w, self.threads = k, w, threads

    def map_stream_raw(self, named_codes):
        def to_seq(codes):
            import numpy as np

            if isinstance(codes, np.ndarray):
                return codes
            return nthash_np.encode(codes)

        yield from sketch_sequences(
            ((name, to_seq(c)) for name, c in named_codes),
            self.k,
            self.w,
            threads=self.threads,
        )


class HybridSketcher:
    """CPU+device sketching: JaxSketcher and the native C thread pool run
    concurrently over one sequence stream (same HybridStream scheduler as
    `backend=hybrid` mapping; both paths are bit-exact, so the adaptive
    split can only change speed, never bytes). This is what a multi-Mb
    draft sketch wants on hosts where the device link is the bottleneck:
    the chip takes what the wire can feed, host cores sketch the rest."""

    def __init__(self, device_backend=None, threads: int = 4,
                 host_frac: float = -1.0, block_items: int = 64,
                 block_bases: int = 16_000_000):
        from .ops.sketch_jax import JaxSketcher

        self.device_backend = device_backend or JaxSketcher()
        self.threads = max(1, threads)
        self.host_frac = host_frac
        # assignment quanta: a block is ~one device bucket of bases; the
        # item-count quantum keeps many-small-sequence streams splitting
        self.block_items = block_items
        self.block_bases = block_bases
        self.host_seqs = 0
        self.device_seqs = 0

    def sketch_stream(self, named_seqs, k: int, w: int):
        from .hybrid_map import HybridStream

        sched = HybridStream(
            _DeviceSketchPath(self.device_backend, k, w),
            _HostSketchPath(k, w, self.threads),
            host_frac=self.host_frac,
        )
        sched.BLOCK_READS = self.block_items
        sched.BLOCK_BASES = self.block_bases
        try:
            yield from sched.stream(named_seqs)
        finally:
            self.host_seqs = sched.host_reads
            self.device_seqs = sched.device_reads


def format_minimizers_bytes(mins: Minimizers, with_strand: bool = True) -> bytes:
    """Render the indexlr TSV body ("hash:pos[:strand] ..."); native C
    renderer when available (~30x at assembly scale), Python fallback."""
    from .native import fastx_module

    native = fastx_module()
    if native is not None and hasattr(native, "render_minimizers"):
        import numpy as np

        return native.render_minimizers(
            np.ascontiguousarray(mins.hashes),
            np.ascontiguousarray(mins.positions.astype(np.int64)),
            np.ascontiguousarray(mins.forward).view(np.uint8)
            if with_strand
            else None,
            len(mins.hashes),
        )
    return format_minimizers(mins, with_strand=with_strand).encode()


def format_minimizers(mins: Minimizers, with_strand: bool = True) -> str:
    if with_strand:
        return " ".join(
            f"{h}:{p}:{'+' if f else '-'}"
            for h, p, f in zip(mins.hashes, mins.positions, mins.forward)
        )
    return " ".join(f"{h}:{p}" for h, p in zip(mins.hashes, mins.positions))


def write_sketch_tsv(
    out_fh,
    named_seqs: Iterable[Tuple[str, str]],
    k: int,
    w: int,
    with_strand: bool = True,
    with_len: bool = False,
    backend=None,
    threads: int = 1,
) -> None:
    """Stream sequences through the sketcher, writing indexlr-style TSV
    (binary file handle)."""
    for name, seq_len, mins in sketch_sequences(
        named_seqs, k, w, backend=backend, threads=threads
    ):
        body = format_minimizers_bytes(mins, with_strand=with_strand)
        if with_len:
            out_fh.write(f"{name}\t{seq_len}\t".encode() + body + b"\n")
        else:
            out_fh.write(f"{name}\t".encode() + body + b"\n")


def sketch_fasta_to_tsv(
    fasta_path: str,
    out_path: str,
    k: int,
    w: int,
    with_strand: bool = True,
    with_len: bool = False,
    backend=None,
    threads: int = 1,
) -> None:
    # crash-safe artifact write (tmp + atomic rename): a killed run must
    # not leave a truncated TSV that a later run's mtime-freshness check
    # would silently reuse as a complete sketch
    import os

    tmp = f"{out_path}.tmp{os.getpid()}"
    try:
        with open(tmp, "wb") as out_fh:
            write_sketch_tsv(
                out_fh,
                ((rec.name, rec.seq) for rec in stream_fastx(fasta_path)),
                k,
                w,
                with_strand=with_strand,
                with_len=with_len,
                backend=backend,
                threads=threads,
            )
        os.replace(tmp, out_path)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
