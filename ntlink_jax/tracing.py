"""Per-stage tracing: wall time, CPU time, peak RSS, device profile hooks.

The reference tracks per-stage time/RSS externally via GNU `time -v` when
`v=1` (reference ntLink:100-110); here tracing is in-process: every pipeline
stage runs under a `stage()` span, and the collected spans are printed and
written to `<prefix>.trace.json`, beside counters of where the work ran
(`count()`: reads mapped on the device vs the exact host fallback, rows
sketched on the device vs the host). Setting `NTLINK_JAX_PROFILE=<dir>` (or
`jax_profile_dir` on the tracer) additionally captures a JAX device profile
(TensorBoard format) around traced stages.
"""
from __future__ import annotations

import contextlib
import json
import os
import resource
import sys
import time
from dataclasses import dataclass
from typing import Dict, List, Optional


@dataclass
class Span:
    name: str
    wall_s: float
    cpu_s: float
    max_rss_kb: int


class Tracer:
    """Collects stage spans and counters; no-op when disabled."""

    def __init__(self, enabled: bool = False, jax_profile_dir: Optional[str] = None):
        self.enabled = enabled
        self.spans: List[Span] = []
        self.counters: Dict[str, int] = {}
        self.jax_profile_dir = jax_profile_dir or os.environ.get(
            "NTLINK_JAX_PROFILE"
        )

    @contextlib.contextmanager
    def stage(self, name: str):
        if not self.enabled:
            yield
            return
        profiling = False
        if self.jax_profile_dir:
            try:
                import jax

                jax.profiler.start_trace(
                    os.path.join(self.jax_profile_dir, name)
                )
                profiling = True
            except Exception:
                pass
        t0 = time.time()
        c0 = time.process_time()
        try:
            yield
        finally:
            if profiling:
                try:
                    import jax

                    jax.profiler.stop_trace()
                except Exception:
                    pass
            rss = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss
            self.spans.append(
                Span(name, time.time() - t0, time.process_time() - c0, rss)
            )

    def count(self, name: str, n: int) -> None:
        """Add `n` to counter `name` (summed over the run)."""
        if self.enabled:
            self.counters[name] = self.counters.get(name, 0) + int(n)

    def report(self, out=None) -> None:
        if not self.enabled or not self.spans:
            return
        out = out or sys.stdout
        total = sum(s.wall_s for s in self.spans)
        print("\nStage trace:", file=out)
        for s in self.spans:
            print(
                f"  {s.name:<24} wall {s.wall_s:8.2f}s  cpu {s.cpu_s:8.2f}s  "
                f"peak-rss {s.max_rss_kb/1024:8.1f} MB",
                file=out,
            )
        print(f"  {'TOTAL':<24} wall {total:8.2f}s", file=out)
        for name in sorted(self.counters):
            print(f"  {name:<32} {self.counters[name]}", file=out)

    def write_json(self, path: str) -> None:
        if not self.enabled:
            return
        with open(path, "w") as fh:
            json.dump(
                {
                    "spans": [s.__dict__ for s in self.spans],
                    "counters": self.counters,
                },
                fh, indent=1,
            )


#: process-wide tracer; pipeline stages use this unless given another
GLOBAL = Tracer(enabled=False)


def enable(jax_profile_dir: Optional[str] = None) -> Tracer:
    GLOBAL.enabled = True
    if jax_profile_dir:
        GLOBAL.jax_profile_dir = jax_profile_dir
    return GLOBAL
