"""Observability: periodic status output, timing, memory logging, and the
compile-cache setting shared by the tools.

Counterpart of the reference's status threads and counters
(/root/reference/project-alignments/project_alignments.cc:446-526,
 recalculate-mapq/main.cc:1198-1225, libbio log_memory_usage)."""

from __future__ import annotations

import os
import resource
import sys
import time


def log_time(msg: str, file=sys.stderr) -> None:
    """Timestamped stderr line (libbio lb::log_time convention)."""
    ts = time.strftime("%Y-%m-%d %H:%M:%S", time.localtime())
    print(f"[{ts}] {msg}", file=file, flush=True)


def format_duration(seconds: float) -> str:
    s = int(seconds)
    h, s = divmod(s, 3600)
    m, s = divmod(s, 60)
    if h:
        return f"{h} h {m} min {s} s"
    if m:
        return f"{m} min {s} s"
    return f"{s} s"


class StatusReporter:
    """Interval-based progress reporting from the record loop.

    The reference uses a timer thread; here the hot loop calls ``tick()``
    (cheap clock check) and the report fires when the interval has elapsed.
    ``interval_minutes=0`` disables reporting, like the reference's
    ``--status-output-interval=0``.
    """

    def __init__(self, interval_minutes: int, what: str = "records"):
        self.interval = interval_minutes * 60.0
        self.what = what
        self.start = time.monotonic()
        self.last = self.start
        self.extra_cb = None

    def tick(self, n_processed: int) -> None:
        if not self.interval:
            return
        now = time.monotonic()
        if now - self.last < self.interval:
            return
        self.last = now
        elapsed = now - self.start
        msg = f"Time spent processing: {format_duration(elapsed)}; processed {n_processed} {self.what}"
        if n_processed:
            usecs = elapsed * 1e6 / n_processed
            msg += f" (in {usecs:.2f} µs / record)"
        if self.extra_cb is not None:
            msg += self.extra_cb()
        log_time(msg + ".")

    def final(self, n_processed: int) -> None:
        elapsed = time.monotonic() - self.start
        msg = f"Done; processed {n_processed} {self.what} in {format_duration(elapsed)}"
        if n_processed and elapsed > 0:
            msg += f" ({n_processed / elapsed:.0f} {self.what}/s)"
        log_time(msg + ".")


def on_accelerator(backend: str | None = None) -> bool:
    """The capability check behind every backend-dependent choice: True
    when JAX's default backend (or ``backend``) is an accelerator rather
    than the CPU."""
    if backend is None:
        import jax

        backend = jax.default_backend()
    return backend != "cpu"


#: The checkout's own cache directory (listed in .gitignore).
CHECKOUT_CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), ".jax_cache"
)


def enable_compile_cache(backend: str | None = None) -> str | None:
    """Persistent XLA compilation cache for device runs; returns the
    directory in use, or None when there is none.

    - ``JAX_COMPILATION_CACHE_DIR`` set: JAX reads it itself, and nothing
      is set here;
    - otherwise, on an accelerator, ``<checkout>/.jax_cache``;
    - on the CPU backend no cache (compiles are cheap, and tests should
      write no cache files).

    ``backend`` defaults to JAX's default backend."""
    env_dir = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env_dir:
        return env_dir
    if not on_accelerator(backend):
        return None
    import jax

    jax.config.update("jax_compilation_cache_dir", CHECKOUT_CACHE_DIR)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)
    return CHECKOUT_CACHE_DIR


def log_peak_memory(file=sys.stderr) -> int:
    """Log and return peak RSS in bytes (the role of libbio's
    log_memory_usage)."""
    kb = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss
    print(f"Peak RSS: {kb / 1024:.1f} MiB", file=file, flush=True)
    return kb * 1024
