"""Profiling hooks (the reference has none; SURVEY.md section 5 calls for
jax.profiler traces as the device observability layer).

Set ``KMERTOOLS_PROFILE=/path/to/dir`` to capture a jax.profiler trace
around any CLI workload run (viewable in TensorBoard / Perfetto), or use
`maybe_trace` directly around library calls. No-ops when unset, when jax
is unavailable, or when a trace is already active.
"""

from __future__ import annotations

import contextlib
import os


@contextlib.contextmanager
def maybe_trace(label: str = "kmertools"):
    """Context manager: jax.profiler trace if KMERTOOLS_PROFILE is set."""
    target = os.environ.get("KMERTOOLS_PROFILE")
    if not target:
        yield
        return
    try:
        import jax
    except Exception:  # pragma: no cover
        yield
        return
    logdir = os.path.join(target, label)
    os.makedirs(logdir, exist_ok=True)
    # Guard only trace ENTRY (an active outer trace / unsupported backend
    # must not break the workload); body exceptions propagate unmasked —
    # a second yield in an except-clause would raise "generator didn't
    # stop after throw()" and mask the workload's own error.
    stack = contextlib.ExitStack()
    try:
        stack.enter_context(jax.profiler.trace(logdir))
    except Exception:
        pass
    with stack:
        yield


def annotate(name: str):
    """Named sub-span inside a trace (TraceAnnotation no-op fallback)."""
    try:
        import jax

        return jax.profiler.TraceAnnotation(name)
    except Exception:  # pragma: no cover
        return contextlib.nullcontext()
