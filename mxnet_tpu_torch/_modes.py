"""How many of the dispatch's special modes are on, in any thread.

A deferred-compute capture, an abstract evaluation, a bulking scope (or
bulking on by default) and ``engine.naive_engine`` each change what
``ops.registry`` does with an op. Each adds one here while it is on, so
that the registry, while the count is 0, takes the path it takes with none
of them and asks none of them anything: one check an op.
"""

import threading

#: the modes on now, over every thread
on = [0]
_lock = threading.Lock()


def add(n):
    """Count ``n`` more modes on (negative: off)."""
    with _lock:
        on[0] += n
