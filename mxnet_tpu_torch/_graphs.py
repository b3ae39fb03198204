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
back what its capture counted on its stream and adds it on each replay,
so that ``ops.kernels.launch_counts()`` and ``path_counts()`` count what
the card ran, whatever another thread launches meanwhile on its own
stream.

The warm-up runs on the stream the graph is captured on: the split
kernels keep their counters per stream (``ops/kernels/_build.counters``),
and a counter set cannot be made inside a capture.

:class:`GraphedCall` is a differentiable call as two such graphs, a
forward and a backward that share one memory pool, replayed as one node
of the autograd graph: a hybridized block's recorded call, the
counterpart of the JAX package's ``_CachedOp`` node whose backward is its
program's VJP. It is written here rather than taken from
``torch.cuda.make_graphed_callables``, whose extra warm-up iterations
would move BatchNorm's running statistics again and which expects
``nn.Module`` parameters.

:func:`emulated` makes :func:`step_graph` and :class:`GraphedCall` run
their bodies again on every replay instead of capturing them, on any
device: the bookkeeping around graphs (static buffers, warm-ups that run
once, replays that overwrite their outputs) can then be tested on the
CPU. Nothing else turns it on.
"""

import contextlib
import threading
import weakref

import torch

from . import _modes
from .base import MXNetError
from .ops import kernels
from .ops.kernels import _build

__all__ = ['StepGraph', 'GraphedCall', 'captures_generators', 'step_graph',
           'can_capture', 'emulated', 'uncaptured', 'is_uncaptured']

_emulate = [False]

#: the captures' cudaStreamCaptureMode. Relaxed: an API call that CUDA
#: counts as potentially unsafe, made while the capture runs, does not
#: invalidate it, whether another thread makes it (a server's caller, the
#: autograd engine's device thread) or a library on this one (a ResNet-50
#: predict capture in thread-local mode failed inside cuDNN in two of
#: three full runs of chip_smoke.py on an H100). A sync on the capturing
#: stream still fails the capture.
_MODE = 'relaxed'


@contextlib.contextmanager
def emulated():
    """Inside the block, graphs on any device are emulated: a capture runs
    its warm-up only, and a replay runs the body again and copies what it
    returns into the first outputs (see the module docstring)."""
    _emulate.append(True)
    try:
        yield
    finally:
        _emulate.pop()


#: threads inside :func:`uncaptured` (``engine.naive_engine``), and how
#: many of them there are (0: the dispatch checks nothing)
_naive = threading.local()
_naive_threads = [0]
_naive_lock = threading.Lock()


@contextlib.contextmanager
def uncaptured():
    """Inside the block this thread captures and replays no graph: a
    hybridized block's calls run eagerly (``engine.naive_engine``)."""
    depth = getattr(_naive, 'depth', 0)
    _naive.depth = depth + 1
    if not depth:
        with _naive_lock:
            _naive_threads[0] += 1
        _modes.add(1)
    try:
        yield
    finally:
        _naive.depth = depth
        if not depth:
            with _naive_lock:
                _naive_threads[0] -= 1
            _modes.add(-1)


def is_uncaptured():
    """True inside :func:`uncaptured` in this thread."""
    return _naive_threads[0] > 0 and getattr(_naive, 'depth', 0) > 0


def can_capture(device):
    """True where calls on ``device`` are captured: a CUDA device, or any
    inside :func:`emulated`; never inside :func:`uncaptured`."""
    return device is not None and (torch.device(device).type == 'cuda'
                                   or _emulate[-1]) and not is_uncaptured()


def step_graph(body, device, generators=()):
    """A :class:`StepGraph` of ``body`` on ``device``, or its emulation
    inside :func:`emulated`."""
    if _emulate[-1]:
        return _EmulatedStepGraph(body, device, generators)
    return StepGraph(body, device, generators)


def _copy_into(dst, src):
    with torch.no_grad():
        for d, s in zip(dst, src):
            d.copy_(s)


class _Drawn:
    """Which of ``generators`` the block drew from: ``drawn`` after it
    exits. A graph registers only those, so that each of its replays
    draws anew."""

    def __init__(self, generators):
        self.generators = generators

    def __enter__(self):
        self.before = [g.get_state() for g in self.generators]
        return self

    def __exit__(self, *exc):
        self.drawn = [g for g, st in zip(self.generators, self.before)
                      if not torch.equal(st, g.get_state())]


def captures_generators():
    """True when this torch lets a ``torch.Generator`` register with a
    graph, so that a captured body can draw random numbers that differ on
    each replay."""
    return hasattr(torch.cuda.CUDAGraph, 'register_generator_state')


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
    ``torch.Generator``s the body may draw from; those its warm-up drew
    from are registered with the graph (see :func:`captures_generators`).

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
        with torch.cuda.stream(self.stream), _Drawn(self.generators) as d:
            warm = self.body()
        cur.wait_stream(self.stream)
        if keep_warmup:
            self.warmup_outputs = warm
        graph = torch.cuda.CUDAGraph()
        for gen in d.drawn:
            graph.register_generator_state(gen)
        with _Counted(self.stream) as c, torch.cuda.graph(
                graph, stream=self.stream, capture_error_mode=_MODE):
            outputs = self.body()
        self.graph, self.outputs = graph, outputs
        self.launches, self.paths, self.plain = c.launches, c.by_path, c.plain
        self.captures += 1
        return outputs

    def replay(self, times=1):
        """Replay the graph ``times`` times back to back; returns the
        outputs of the last."""
        for _ in range(times):
            self.graph.replay()
        kernels.add_launch_counts(self.launches, self.paths, times=times,
                                  plain=self.plain)
        return self.outputs

    def release(self):
        """Drop the graph and its outputs, so that its memory pool goes
        back to the allocator."""
        self.graph = self.outputs = None


class _EmulatedStepGraph:
    """:class:`StepGraph`'s interface without a graph (:func:`emulated`):
    the capture runs the warm-up, whose outputs' copies (a list of
    tensors, or None) become the outputs; a replay runs the body and
    copies its results into them."""

    def __init__(self, body, device, generators=()):
        self.body = body
        self.graph = self.outputs = self.warmup_outputs = None
        self.captures = 0

    def capture(self, keep_warmup=False):
        warm = self.body()
        if keep_warmup:
            self.warmup_outputs = warm
        self.outputs = None if warm is None else [
            t.detach().clone() for t in warm]
        self.graph = True
        self.captures += 1
        return self.outputs

    def replay(self, times=1):
        for _ in range(times):
            _copy_into(self.outputs or (), self.body() or ())
        return self.outputs

    def release(self):
        self.graph = self.outputs = None


class _Counted:
    """Kernel launches on ``stream`` between ``__enter__`` and
    ``__exit__`` (a capture, which runs nothing), taken back from the
    counters: a replay adds them. Only that stream's are: a launch another
    thread makes meanwhile on a stream of its own (a ``dist_async`` server
    applying a push) ran, and stays counted (``_build.tally``)."""

    def __init__(self, stream):
        self._tally = _build.tally(stream)

    def __enter__(self):
        self._counted = self._tally.__enter__()
        return self

    def __exit__(self, *exc):
        self._tally.__exit__(*exc)
        names = {fn: name for name, fn in kernels.KERNELS.items()}
        self.launches, self.by_path, self.plain = {}, {}, {}
        for (fn, path, plain), n in self._counted.items():
            name = names[fn]
            if plain:
                self.plain[name] = self.plain.get(name, 0) + n
                continue
            self.launches[name] = self.launches.get(name, 0) + n
            if path is not None:
                d = self.by_path.setdefault(name, {})
                d[path] = d.get(path, 0) + n
        kernels.add_launch_counts(self.launches, self.by_path, times=-1,
                                  plain=self.plain)


class GraphedCall:
    """A differentiable call ``fn(inputs, values) -> [outputs]`` captured
    as a forward and a backward CUDA graph that share one memory pool, and
    replayed as one autograd node (see the module docstring).

    ``params`` are the leaf tensors ``fn`` reads besides its inputs (a
    block's parameters); ``fn`` reads them itself when ``values`` is None,
    and ``values`` in their place otherwise. The captures run on aliases
    of them (``detach()``: the same memory, new leaves), so that autograd
    nodes of an earlier graph that is still alive, made on another stream,
    play no part in the capture. Those that require grad, and the inputs
    that require grad at capture, get gradients: the backward graph reads
    static grad-output buffers and writes static input and parameter
    grads, which the node hands to autograd for the parameters
    themselves. Those of ``generators`` that the first call drew from are
    registered with the forward graph, so that stochastic ops draw anew on
    every replay. With ``remat`` the forward graph keeps no activation:
    the backward graph runs ``fn`` again, with ``recompute`` (a context
    manager taking a generator and its state) around it, and draws the
    forward's numbers again: it draws from a clone of each such
    generator's state (``clone_state``, registered with the backward
    graph), whose seed and offset are set before each backward replay to
    those the forward replay drew at (a reseed between the two is seen);
    emulated, the recomputation runs from the generator's state before the
    forward.

    :meth:`first_call` is a key's first call: it runs ``fn`` eagerly on
    the caller's inputs (the real answer, returned with its own autograd
    graph), then the backward once on zeros on the capture's stream (a
    throwaway warm-up: nothing is accumulated), then captures both graphs;
    nothing runs twice. :meth:`__call__` replays. A replayed call whose
    backward has not run yet holds the graphs' activations: while it is
    alive, :meth:`busy` is true, and the caller runs the next call
    another way. Asked for a backward that can be differentiated again
    (``create_graph=True``), the node runs ``fn`` once more eagerly under
    autograd on the call's own inputs and parameters, as an unhybridized
    block computes, and returns that graph's gradients instead of the
    backward graph's; a call that draws random numbers raises there, since
    an eager run would draw other numbers than the replay did.

    ``captures`` counts graphs captured (two)."""

    def __init__(self, fn, params, device, generators=(), remat=False,
                 recompute=None):
        self.fn = fn
        self.leaves = list(params)
        self.params = [p for p in self.leaves if p.requires_grad]
        self.aliases = [p.detach().requires_grad_(p.requires_grad)
                        for p in self.leaves]
        self.alias_targets = [a for a in self.aliases if a.requires_grad]
        self.device = torch.device(device)
        self.generators = tuple(generators)
        self.remat = remat
        self.recompute = recompute or contextlib.nullcontext
        self.emulated = _emulate[-1]
        if not self.emulated:
            if self.device.type != 'cuda':
                raise ValueError(f'a CUDA graph needs a CUDA device, got '
                                 f'{self.device}')
            self.stream = torch.cuda.Stream(self.device)
        self.captures = 0
        self.generation = 0
        self._pending = None
        self.fwd = self.bwd = None
        self.fwd_counts = self.bwd_counts = None
        self.recompute_states = []  # (generator, its clone for the remat)
        self.fwd_draws = []         # their (seed, offset) at the last forward

    # ----------------------------------------------------------- capture
    def _run_fn(self, inputs, grad, values=None):
        with torch.set_grad_enabled(grad):
            return list(self.fn(inputs, values))

    def _grads(self, outs, targets, gouts, retain=False):
        diff = [o for o in outs if o.requires_grad]
        if not diff or not targets:
            return [None] * len(targets)
        return list(torch.autograd.grad(diff, targets, gouts,
                                        retain_graph=retain,
                                        allow_unused=True))

    def first_call(self, inputs):
        """Warm up on ``inputs`` (the real answer, returned), capture."""
        self.in_grad = [x.requires_grad for x in inputs]
        if self.emulated:
            from . import _rng
            with _Drawn(self.generators
                        or (_rng.generator(self.device),)) as drew:
                warm = self._first_emulated(inputs)
            self.draws = bool(drew.drawn)
            return warm
        cur = torch.cuda.current_stream(self.device)
        s = self.stream
        s.wait_stream(cur)
        with torch.cuda.stream(s):
            with _Drawn(self.generators) as drew:
                warm = self._run_fn(inputs, True)
            self.draws = bool(drew.drawn)
            targets = [x for x, g in zip(inputs, self.in_grad) if g]
            with _Counted(s):       # throwaway: its launches do not count
                self._grads(warm, targets + self.params,
                            [torch.zeros_like(o) for o in warm
                             if o.requires_grad], retain=True)
            self.static_in = [x.detach().clone().requires_grad_(g)
                              for x, g in zip(inputs, self.in_grad)]
            pool = torch.cuda.graph_pool_handle()
            fwd = torch.cuda.CUDAGraph()
            for gen in drew.drawn:
                fwd.register_generator_state(gen)
            with _Counted(s) as c:
                with torch.cuda.graph(fwd, pool=pool, stream=s,
                                      capture_error_mode=_MODE):
                    outs = self._run_fn(self.static_in, not self.remat,
                                        self.aliases)
            self.fwd_counts = (c.launches, c.by_path)
            self._set_outputs(outs)
            bwd = torch.cuda.CUDAGraph()
            if self.remat:
                for gen in drew.drawn:
                    clone = gen.clone_state()
                    bwd.register_generator_state(clone)
                    self.recompute_states.append((gen, clone))
            with _Counted(s) as c:
                with torch.cuda.graph(bwd, pool=pool, stream=s,
                                      capture_error_mode=_MODE):
                    self.static_grads = self._backward_body()
            self.bwd_counts = (c.launches, c.by_path)
        cur.wait_stream(s)
        for t in warm:
            t.record_stream(cur)
        self.fwd, self.bwd = fwd, bwd
        self.captures += 2
        return warm

    def _set_outputs(self, outs):
        self.static_out = outs
        self.out_grad = [o.requires_grad or (self.remat and (
            o.is_floating_point() or o.is_complex())) for o in outs]
        self.static_gout = [torch.zeros_like(o) for o, g in
                            zip(outs, self.out_grad) if g]

    def _backward_body(self):
        targets = [x for x, g in zip(self.static_in, self.in_grad) if g]
        if self.remat:
            with self._recompute_draws():
                outs = self._run_fn(self.static_in, True, self.aliases)
        else:
            outs = self.static_out
        diff = [o for o, g in zip(outs, self.out_grad) if g]
        keep = [o.requires_grad for o in diff]
        return self._grads([o for o, k in zip(diff, keep) if k],
                           targets + self.alias_targets,
                           [b for b, k in zip(self.static_gout, keep) if k])

    @contextlib.contextmanager
    def _recompute_draws(self):
        """The remat recomputation's context: in a capture, each generator
        the forward drew from draws from its clone; emulated, from the
        state it had before the forward (``recompute(gen, state)``)."""
        if self.emulated:
            gen, state = getattr(self, '_emulated_draw', (None, None))
            with self.recompute(gen, state):
                yield
            return
        saved = [(g, g.graphsafe_get_state())
                 for g, _ in self.recompute_states]
        for g, clone in self.recompute_states:
            g.graphsafe_set_state(clone)
        try:
            with self.recompute():
                yield
        finally:
            for g, st in saved:
                g.graphsafe_set_state(st)

    def _first_emulated(self, inputs):
        warm = self._run_fn(inputs, True)
        self.static_in = [x.detach().clone().requires_grad_(g)
                          for x, g in zip(inputs, self.in_grad)]
        self._set_outputs([o.detach().clone().requires_grad_(o.requires_grad)
                           for o in warm])
        self.static_grads = [None] * (sum(self.in_grad) + len(self.params))
        self.fwd = self.bwd = True
        self.captures += 2
        return warm

    # ------------------------------------------------------------ replay
    def busy(self):
        """True while a replayed call waits for its backward."""
        return self._pending is not None and self._pending() is not None

    def __call__(self, inputs):
        """Replay on ``inputs``; the outputs are copies (a later replay
        overwrites the graph's own) and one autograd node."""
        tensors = list(inputs) + self.params
        return _Replay.apply(self, len(inputs), *tensors)

    def _replay_forward(self, inputs):
        with torch.no_grad():
            for buf, x in zip(self.static_in, inputs):
                buf.copy_(x)
        if self.emulated:
            if self.remat:
                from . import _rng
                gen = _rng.generator(self.device)
                self._emulated_draw = (gen, gen.get_state())
            outs = self._run_fn(self.static_in, not self.remat,
                                self.aliases)
            self._emulated_outs = outs
            _copy_into(self.static_out, outs)
        else:
            self.fwd_draws = [(g.initial_seed(), g.get_offset())
                              for g, _ in self.recompute_states]
            self.fwd.replay()
            kernels.add_launch_counts(*self.fwd_counts, times=1)
        self.generation += 1

    def _replay_backward(self, gouts):
        with torch.no_grad():
            k = 0
            for g, need in zip(gouts, self.out_grad):
                if not need:
                    continue
                buf = self.static_gout[k]
                k += 1
                if g is None:
                    buf.zero_()
                else:
                    buf.copy_(g)
        if self.emulated:
            saved = self.static_out
            if not self.remat:
                self.static_out = self._emulated_outs
            try:
                grads = self._backward_body()
            finally:
                self.static_out = saved
            for j, g in enumerate(grads):
                if g is None:
                    continue
                if self.static_grads[j] is None:
                    self.static_grads[j] = torch.zeros_like(g)
                with torch.no_grad():
                    self.static_grads[j].copy_(g)
        else:
            for (_, clone), (seed, off) in zip(self.recompute_states,
                                               self.fwd_draws):
                clone.manual_seed(seed)     # the forward's numbers again
                clone.set_offset(off)
            self.bwd.replay()
            kernels.add_launch_counts(*self.bwd_counts, times=1)
        return self.static_grads

    def _graphed_grads(self, generation, gouts):
        """The node's gradients from the backward graph, for the replay of
        ``generation``."""
        if generation != self.generation:
            raise MXNetError(
                'this recorded call\'s activations were overwritten by a '
                'later call of the same hybridized block and input shapes, '
                'replayed after its first backward; run backward before '
                'the next call, or call hybridize(False)')
        self._pending = None
        # aliases autograd may take over as a leaf's .grad without a copy:
        # the parameters' hooks copy them into the grad buffers before the
        # next replay overwrites them
        return [None if g is None else g.detach()
                for g in self._replay_backward(gouts)]

    def _differentiable_grads(self, inputs, gouts):
        """The gradients of the inputs that require grad and of the
        parameters for ``gouts``, as a graph that can be differentiated
        again: ``fn`` run eagerly under autograd on ``inputs`` (the
        recomputation context writes no running statistic), then
        ``torch.autograd.grad(..., create_graph=True)``."""
        if self.draws:
            raise MXNetError(
                'create_graph=True through a hybridized block\'s recorded '
                'call that draws random numbers (Dropout): an eager '
                'recomputation would draw other numbers than the replay '
                'did; call hybridize(False) for higher-order gradients')
        with self.recompute():
            outs = self._run_fn(list(inputs), True)
        targets = [x for x, g in zip(inputs, self.in_grad) if g] \
            + self.params
        pairs = [(o, g) for o, g in zip(outs, gouts)
                 if g is not None and o.requires_grad]
        if not pairs or not targets:
            return [None] * len(targets)
        return list(torch.autograd.grad(
            [o for o, _ in pairs], targets, [g for _, g in pairs],
            create_graph=True, allow_unused=True))


class _Replay(torch.autograd.Function):
    """One replayed :class:`GraphedCall` as an autograd node."""

    @staticmethod
    def forward(ctx, call, n_in, *tensors):
        ctx.set_materialize_grads(False)
        # the inputs, for a create_graph backward (the parameters are the
        # call's own)
        ctx.save_for_backward(*tensors[:n_in])
        call._replay_forward(tensors[:n_in])
        ctx.call, ctx.n_in, ctx.generation = call, n_in, call.generation
        outs = tuple(o.detach().clone() for o in call.static_out)
        ctx.mark_non_differentiable(*[o for o, g in zip(outs, call.out_grad)
                                      if not g])
        call._pending = weakref.ref(ctx)
        return outs

    @staticmethod
    def backward(ctx, *gouts):
        call = ctx.call
        if torch.is_grad_enabled():         # create_graph=True
            call._pending = None
            grads = call._differentiable_grads(ctx.saved_tensors, gouts)
        else:
            grads = call._graphed_grads(ctx.generation, gouts)
        out = [None] * (len(ctx.needs_input_grad) - 2)
        n_in = ctx.n_in
        k = 0
        for j in range(n_in):
            if call.in_grad[j]:
                out[j] = grads[k]
                k += 1
        for j in range(len(call.params)):
            out[n_in + j] = grads[k + j]
        return (None, None) + tuple(out)
