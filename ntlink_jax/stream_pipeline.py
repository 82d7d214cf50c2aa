"""Shared three-thread scaffolding for the batched device streams.

Both hot loops (device_map.DeviceMapper.map_stream_raw and
ops.sketch_jax.JaxSketcher.sketch_stream) decouple the same three stall
classes of the host<->device path:

  producer (caller's thread): read / encode / pack / consume results
  feeder:   every device call — H2D puts, step dispatch, prefix-slice
            dispatch, async D2H starts
  drainer:  the blocking device->host transfer waits (jax releases the
            GIL there)

FIFO queues (bounded depth -> backpressure) preserve batch order end to
end. Worker exceptions are captured and re-raised on the producer thread
at the next `join_all()`. Shutdown is bounded: a stuck worker cannot hang
the producer's generator-close path — the sentinel put and the thread
joins all time out, leaking only daemon threads the process does not wait
on.
"""
from __future__ import annotations

import queue
import threading
from typing import Callable, List

import numpy as np


class DevicePipeline:
    """Feeder/drainer thread pair around caller-supplied batch handlers.

    `dispatch(*ent)` runs on the feeder thread; it should end by calling
    `submit_drain(ent2)` to forward the in-flight batch. `drain(*ent2)`
    runs on the drainer thread.
    """

    def __init__(
        self,
        dispatch: Callable[..., None],
        drain: Callable[..., None],
        depth: int = 2,
        name: str = "ntlink",
    ) -> None:
        self._dispatch = dispatch
        self._drain = drain
        self._feed_q: "queue.Queue" = queue.Queue(maxsize=depth)
        self._work_q: "queue.Queue" = queue.Queue(maxsize=depth)
        self.errors: List[BaseException] = []
        self._threads: List[threading.Thread] = []
        self._name = name

    # -- worker loops -----------------------------------------------------

    def _run_loop(self, q: "queue.Queue", fn) -> None:
        while True:
            ent = q.get()
            try:
                if ent is not None and not self.errors:
                    fn(*ent)
            except BaseException as exc:  # surfaced at next join_all()
                self.errors.append(exc)
            finally:
                q.task_done()
            if ent is None:
                return

    def _ensure_started(self) -> None:
        if self._threads:
            return
        for q, fn, suffix in (
            (self._work_q, self._drain, "drain"),
            (self._feed_q, self._dispatch, "feed"),
        ):
            t = threading.Thread(
                target=self._run_loop,
                args=(q, fn),
                daemon=True,
                name=f"{self._name}-{suffix}",
            )
            t.start()
            self._threads.append(t)

    # -- producer API -----------------------------------------------------

    def submit(self, ent: tuple) -> None:
        """Producer -> feeder (blocks on backpressure at queue depth)."""
        self._ensure_started()
        self._feed_q.put(ent)

    def submit_drain(self, ent: tuple) -> None:
        """Feeder -> drainer (called from inside `dispatch`)."""
        self._work_q.put(ent)

    def join_all(self) -> None:
        """Wait for every submitted batch to drain; re-raise worker errors."""
        self._feed_q.join()
        self._work_q.join()
        if self.errors:
            raise self.errors[0]

    def close(self, timeout: float = 60.0) -> None:
        """Bounded shutdown (see module docstring)."""
        if not self._threads:
            return
        for q in (self._feed_q, self._work_q):
            try:
                q.put(None, timeout=timeout)
            except queue.Full:
                pass
        for t in self._threads:
            t.join(timeout=timeout)


def next_pow2(n: int) -> int:
    """Next power of two >= n (>=1). Pow2 widths keep the device-slice
    executable cache tiny: every distinct width is a fresh compile, so a
    handful of reusable shapes beats byte-tight trims."""
    n = max(1, n)
    p = 1
    while p < n:
        p <<= 1
    return p


def next_q4(n: int) -> int:
    """Smallest m << e >= n with m in {4..7}: quarter-pow2 quantization.

    Transfer-cap widths use this instead of next_pow2 — at most 4 distinct
    widths per octave (executable-cache still bounded) but the worst-case
    overshoot drops from 2.0x to 1.25x, which is D2H bytes saved on every
    batch of the run."""
    n = max(1, n)
    if n <= 4:
        return n
    e = n.bit_length() - 3
    for m in (4, 5, 6, 7):
        if (m << e) >= n:
            return m << e
    return 8 << e


def start_flat_stream(out, caps: dict, key, stats: dict = None):
    """Dispatch-side half of the adaptive capped-transfer protocol shared by
    the mapping and sketch streams.

    Starts both D2H copies immediately (async): the `meta` tensor and an
    adaptively capped prefix of the compacted `flat` tensor stream to the
    host while it packs the next batch — steady state pays zero
    synchronous round trips per batch. The cap starts at half the slot
    budget and tightens to the observed volume (see finish_flat_stream).
    Returns the sliced prefix to hand to the drainer.
    """
    width = int(out["flat"].shape[1])
    cap = min(width, caps.get(key, width // 2))
    sliced = out["flat"][:, :cap]
    # optional half-width read-position stream (uint16 rpos+strand for
    # pads <= 16384): capped by the same lane count, half the bytes of
    # an int32 plane on the dominant D2H direction
    r16 = out.get("r16")
    sliced16 = r16[:cap] if r16 is not None else None
    if stats is not None:  # bytes that WILL move (copies just started)
        stats["d2h"] = (
            stats.get("d2h", 0) + out["meta"].nbytes + sliced.nbytes
            + (sliced16.nbytes if sliced16 is not None else 0)
        )
    out["meta"].copy_to_host_async()
    sliced.copy_to_host_async()
    if sliced16 is not None:
        sliced16.copy_to_host_async()
    return (sliced, sliced16)


def finish_flat_stream(out, sliced, count, B: int, n_filled: int,
                       caps: dict, key, stats: dict = None,
                       floor: int = 4096):
    """Drain-side half of the capped-transfer protocol.

    Computes per-row offsets from `count`, adapts the next dispatch's cap
    (1.3x headroom over this batch's volume scaled to a full batch — warmup
    batches are mostly padding; undershoot costs one corrective round trip,
    and quarter-pow2 widths cluster tightly so totals rarely cross the
    cap), and fetches the flat payload — from the already-streaming prefix
    when the cap held, else via one corrective round trip.

    Returns (offs, total, flat, r16) with flat/r16 None when the batch
    is empty (r16 also None when the step has no uint16 rpos stream).
    """
    offs = np.zeros(B + 1, np.int64)
    np.cumsum(count, out=offs[1:])
    total = int(offs[-1])
    sliced, sliced16 = sliced
    width = int(out["flat"].shape[1])
    scaled = total * B // max(1, n_filled)
    caps[key] = max(
        caps.get(key, 0),
        min(width, next_q4(max(13 * scaled // 10, floor))),
    )
    flat = None
    r16 = None
    if total:
        import time as _time

        tw = _time.perf_counter()
        if total <= int(sliced.shape[1]):
            flat = np.asarray(sliced)  # already streaming
            if sliced16 is not None:
                r16 = np.asarray(sliced16)
        else:  # cap undershot this batch: one corrective round trip
            w2 = min(width, next_q4(total))
            flat = np.asarray(out["flat"][:, :w2])
            if out.get("r16") is not None:
                r16 = np.asarray(out["r16"][:w2])
            if stats is not None:
                stats["d2h"] = (
                    stats.get("d2h", 0) + flat.nbytes
                    + (r16.nbytes if r16 is not None else 0)
                )
        if stats is not None:  # seconds actually blocked on this wait
            stats["d2h_s"] = (
                stats.get("d2h_s", 0.0) + _time.perf_counter() - tw
            )
    return offs, total, flat, r16


def start_fused_stream(out, caps: dict, key, B: int, stats: dict = None):
    """Dispatch half of the one-object transfer protocol shared by the
    mapping payloads (anchors and runs modes): the step packed its
    per-read meta into ROW 0 of the flat tensor, so the whole batch
    drains as ONE D2H object (plus the optional uint16 rpos stream), and
    each separate transfer has a fixed latency. The cap never cuts into
    the meta (>= 2B lanes)."""
    width = int(out["flat"].shape[1])
    cap = min(width, max(caps.get(key, width // 2), 2 * B))
    sliced = out["flat"][:, :cap]
    r16 = out.get("r16")
    sliced16 = r16[:cap] if r16 is not None else None
    if stats is not None:
        stats["d2h"] = (
            stats.get("d2h", 0) + sliced.nbytes
            + (sliced16.nbytes if sliced16 is not None else 0)
        )
    sliced.copy_to_host_async()
    if sliced16 is not None:
        sliced16.copy_to_host_async()
    return (sliced, sliced16)


def finish_fused_stream(out, sliced_pair, B: int, n_filled: int, caps: dict,
                        key, stats: dict = None, floor: int = 4096):
    """Drain half: ONE wait yields meta row + payload planes (+ the r16
    stream when present). Returns (count, n_mins, offs, total, planes,
    r16) with planes/r16 None when empty/absent. Cap adaptation: 1.3x
    headroom over this batch's volume, quarter-pow2 widths, `floor`
    lanes minimum (runs volumes are ~10x smaller than anchors')."""
    import time as _time

    sliced, sliced16 = sliced_pair
    width = int(out["flat"].shape[1])
    tw = _time.perf_counter()
    arr = np.asarray(sliced)
    if stats is not None:
        stats["d2h_s"] = stats.get("d2h_s", 0.0) + _time.perf_counter() - tw
    count, n_mins = arr[0, :B], arr[0, B : 2 * B]
    offs = np.zeros(B + 1, np.int64)
    np.cumsum(count, out=offs[1:])
    total = int(offs[-1])
    scaled = total * B // max(1, n_filled)
    caps[key] = max(
        caps.get(key, 0),
        min(width, next_q4(max(13 * scaled // 10, floor))),
    )
    planes = None
    r16 = None
    if total:
        tw = _time.perf_counter()
        if total <= int(arr.shape[1]):
            planes = arr[1:]
            if sliced16 is not None:
                r16 = np.asarray(sliced16)
        else:  # cap undershot: one corrective round trip
            w2 = min(width, next_q4(total))
            full = np.asarray(out["flat"][:, :w2])
            planes = full[1:]
            if out.get("r16") is not None:
                r16 = np.asarray(out["r16"][:w2])
            if stats is not None:
                stats["d2h"] = (
                    stats.get("d2h", 0) + full.nbytes
                    + (r16.nbytes if r16 is not None else 0)
                )
        if stats is not None:
            stats["d2h_s"] = (
                stats.get("d2h_s", 0.0) + _time.perf_counter() - tw
            )
    return count, n_mins, offs, total, planes, r16


def split_n_rows(row_codes: List[np.ndarray], B: int, pad: int):
    """For a batch of N-containing rows: return (clean_rows, packed_nmask).

    2-bit packing cannot carry N — clean the non-ACGT codes to 0 and build
    the (B, pad//8) little-bit-order non-ACGT mask that re-materializes
    them on device (2.25 bits/base wire total).
    """
    bad = np.zeros((B, pad), dtype=bool)
    clean = []
    for row, c in enumerate(row_codes):
        b = c > 3
        bad[row, : len(c)] = b
        clean.append(np.where(b, 0, c).astype(np.uint8))
    return clean, np.packbits(bad, axis=1, bitorder="little")
