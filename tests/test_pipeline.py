"""Regression tests for host-pipeline failure paths (ADVICE r1)."""

import pytest

from kmertools_jax.workloads.common import run_pipelined


def test_consumer_error_propagates_not_deadlocks():
    """A raising consume() must surface the error; before the fix the
    worker died and the bounded queue deadlocked the producer."""

    def batches():
        for i in range(64):
            yield i

    def dispatch(b):
        return (b,)

    def consume(b, r):
        raise RuntimeError("boom")

    with pytest.raises(RuntimeError, match="boom"):
        run_pipelined(batches(), dispatch, consume)


def test_producer_error_propagates():
    def batches():
        yield 1
        raise ValueError("producer died")

    with pytest.raises(ValueError, match="producer died"):
        run_pipelined(batches(), lambda b: (b,), lambda b, r: None)


def test_pipeline_processes_all_batches_in_order():
    seen = []
    run_pipelined(
        iter(range(100)), lambda b: (b * 2,), lambda b, r: seen.append((b, r))
    )
    assert seen == [(i, i * 2) for i in range(100)]


def test_maybe_trace_propagates_body_exception(tmp_path, monkeypatch):
    """With KMERTOOLS_PROFILE set, a body exception must propagate as
    itself — not be masked by 'generator didn't stop after throw()'."""
    from kmertools_jax.utils.profiling import maybe_trace

    monkeypatch.setenv("KMERTOOLS_PROFILE", str(tmp_path))
    with pytest.raises(ValueError, match="inner"):
        with maybe_trace("t"):
            raise ValueError("inner")
    # and nested usage (outer trace already active) still propagates
    with pytest.raises(ValueError, match="nested"):
        with maybe_trace("outer"):
            with maybe_trace("inner"):
                raise ValueError("nested")
