"""Shared retry policy: capped exponential backoff + jitter under an
overall deadline (reference: the gRPC channel's reconnect backoff the
C++ RPC stack leans on — operators/distributed/grpc/grpc_client.cc
retries through the completion queue with FLAGS_rpc_deadline bounding
the total wait). Port of ``paddle_tpu/resilience/retrying.py``, whole:
every transient-failure loop routes through ``retry_call`` so backoff
behaviour is one tested policy, not N hand-rolled sleep loops. In the
port its users are the checkpoint background writer (checkpoint.py)
and the pserver client's connect (distributed/ps.py); the supervised
launcher comes with ROADMAP item 11.

Determinism: jitter comes from a ``random.Random(seed)`` stream owned
by the ``Backoff`` instance, so a seeded schedule replays exactly (the
JAX package's ``Backoff`` gives the same delays for the same seed) —
the property the fault-injection tests assert bounds on.
"""

import random
import time

__all__ = ["Backoff", "DeadlineExceeded", "RetriesExhausted", "retry_call"]


class DeadlineExceeded(OSError):
    """The overall deadline expired before an attempt succeeded; chains
    the last attempt's error as ``__cause__``."""


class RetriesExhausted(OSError):
    """The attempt budget ran out; chains the last attempt's error."""


class Backoff:
    """Capped exponential backoff with bounded jitter.

    Attempt ``k`` (0-based) sleeps ``d * (1 - jitter * u)`` where
    ``d = min(cap, base * factor**k)`` and ``u`` is uniform in [0, 1) —
    i.e. every delay lands in ``(d * (1 - jitter), d]``. Jittering
    DOWN from the deterministic envelope keeps the worst-case total
    wait computable while still de-synchronizing a gang of restarting
    workers (the thundering-herd property exponential backoff exists
    for).
    """

    def __init__(self, base=0.05, factor=2.0, cap=5.0, jitter=0.5,
                 seed=None):
        if not 0.0 <= jitter <= 1.0:
            raise ValueError("jitter must be in [0, 1], got %r" % jitter)
        self.base = float(base)
        self.factor = float(factor)
        self.cap = float(cap)
        self.jitter = float(jitter)
        self._rng = random.Random(seed)

    def envelope(self, attempt):
        """The deterministic (jitter-free) delay for ``attempt``."""
        return min(self.cap, self.base * self.factor ** attempt)

    def delay(self, attempt):
        """The jittered delay for ``attempt`` (consumes the rng)."""
        d = self.envelope(attempt)
        if not self.jitter:
            return d
        return d * (1.0 - self.jitter * self._rng.random())


def retry_call(fn, *args, retry_on=(OSError,), attempts=None,
               deadline=None, backoff=None, on_retry=None,
               sleep=time.sleep, clock=time.monotonic, **kwargs):
    """Call ``fn(*args, **kwargs)`` until it succeeds.

    ``retry_on``    exception types that trigger a retry; anything else
                    propagates immediately.
    ``attempts``    total call budget (None = unbounded, deadline-only).
    ``deadline``    overall wall-clock budget in seconds measured from
                    entry (None = unbounded). The pre-retry sleep is
                    clipped to the remaining budget, and a retry whose
                    budget is exhausted raises ``DeadlineExceeded``
                    chaining the last error.
    ``backoff``     a ``Backoff`` (default: Backoff()).
    ``on_retry``    callback ``(exc, attempt, delay)`` invoked before
                    each sleep — the observability hook.
    """
    if attempts is None and deadline is None:
        raise ValueError("retry_call needs attempts and/or deadline — an "
                         "unbounded retry loop is a hang, not a policy")
    backoff = backoff if backoff is not None else Backoff()
    start = clock()
    attempt = 0
    while True:
        try:
            return fn(*args, **kwargs)
        except retry_on as e:  # noqa: PERF203 - the whole point
            attempt += 1
            if attempts is not None and attempt >= attempts:
                raise RetriesExhausted(
                    "giving up after %d attempt(s): %s" % (attempt, e)
                ) from e
            delay = backoff.delay(attempt - 1)
            if deadline is not None:
                remaining = deadline - (clock() - start)
                if remaining <= 0:
                    raise DeadlineExceeded(
                        "deadline (%.1fs) exceeded after %d attempt(s): %s"
                        % (deadline, attempt, e)) from e
                delay = min(delay, remaining)
            if on_retry is not None:
                on_retry(e, attempt, delay)
            sleep(delay)
