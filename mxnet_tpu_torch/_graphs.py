"""One call captured as a CUDA graph and replayed: the port's counterpart
of a compiled program.

The JAX package compiles a step once (``jax.jit``) and then calls the
executable; here the step's Python body runs once eagerly to warm up,
then once under ``torch.cuda.graph`` to record its kernels, and every
later call replays the record with no Python in between. What a graph
reads and writes is fixed at capture: its inputs are static buffers that
the caller fills in place before each replay, and its outputs are the
tensors the body returned at capture, which each replay overwrites.

The kernel wrappers count a launch when their Python runs, which under
a graph happens at capture and never at replay. :class:`StepGraph` takes
back what its capture counted and adds it on each replay, so that
``ops.kernels.launch_counts()`` and ``path_counts()`` count what the
card ran.

The warm-up runs on the stream the graph is captured on: the split
kernels keep their counters per stream (``ops/kernels/_build.counters``),
and a counter set cannot be made inside a capture.
"""

import torch

from .ops import kernels

__all__ = ['StepGraph', 'captures_generators']


def captures_generators():
    """True when this torch lets a ``torch.Generator`` register with a
    graph, so that a captured body can draw random numbers that differ on
    each replay."""
    return hasattr(torch.cuda.CUDAGraph, 'register_generator_state')


def _diff(after, before):
    return {k: after[k] - before.get(k, 0) for k in after
            if after[k] != before.get(k, 0)}


class StepGraph:
    """``body()`` captured once on ``device`` and replayed.

    ``body`` takes no arguments: it reads the static input buffers the
    caller owns and returns the tensors it computes (any nesting of
    tuples, lists and dicts). :meth:`capture` runs it once eagerly on a
    side stream (those launches are real and counted), then captures it
    on that stream into a graph with a private memory pool, and returns
    its outputs; :meth:`replay` runs the graph on the current stream and
    returns the same output tensors, overwritten. A failed capture
    raises: nothing falls back to eager calls. ``generators`` are
    ``torch.Generator``s the body draws from, registered with the graph
    (see :func:`captures_generators`).

    ``captures`` counts captures; ``launches`` and ``paths`` are what one
    replay launches, by kernel and by kernel and design."""

    def __init__(self, body, device, generators=()):
        self.body = body
        self.device = torch.device(device)
        if self.device.type != 'cuda':
            raise ValueError(f'a CUDA graph needs a CUDA device, got '
                             f'{self.device}')
        self.generators = tuple(generators)
        self.stream = torch.cuda.Stream(self.device)
        self.graph = None
        self.outputs = None
        self.warmup_outputs = None
        self.captures = 0
        self.launches = {}
        self.paths = {}

    def capture(self, keep_warmup=False):
        """Warm up, capture, and return the captured outputs (not yet
        computed: the first :meth:`replay` computes them). With
        ``keep_warmup`` the warm-up's own outputs, which are computed,
        stay in ``warmup_outputs`` for the caller to take, so that a
        first call can be answered without replaying."""
        cur = torch.cuda.current_stream(self.device)
        self.stream.wait_stream(cur)
        with torch.cuda.stream(self.stream):
            warm = self.body()
        cur.wait_stream(self.stream)
        if keep_warmup:
            self.warmup_outputs = warm
        graph = torch.cuda.CUDAGraph()
        for gen in self.generators:
            graph.register_generator_state(gen)
        counts, paths = kernels.launch_counts(), kernels.path_counts()
        # thread_local: another thread's allocations during the capture
        # (a server's caller) do not invalidate it
        with torch.cuda.graph(graph, stream=self.stream,
                              capture_error_mode='thread_local'):
            outputs = self.body()
        launches = _diff(kernels.launch_counts(), counts)
        by_path = {k: _diff(d, paths[k])
                   for k, d in kernels.path_counts().items()}
        by_path = {k: d for k, d in by_path.items() if d}
        kernels.add_launch_counts(launches, by_path, times=-1)
        self.graph, self.outputs = graph, outputs
        self.launches, self.paths = launches, by_path
        self.captures += 1
        return outputs

    def replay(self, times=1):
        """Replay the graph ``times`` times back to back; returns the
        outputs of the last."""
        for _ in range(times):
            self.graph.replay()
        kernels.add_launch_counts(self.launches, self.paths, times=times)
        return self.outputs

    def release(self):
        """Drop the graph and its outputs, so that its memory pool goes
        back to the allocator."""
        self.graph = self.outputs = None
