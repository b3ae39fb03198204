"""Control flow: ``npx.foreach``, ``npx.while_loop``, ``npx.cond`` (also
``mx.nd.contrib``).

Counterpart of ``mxnet_tpu/ops/control_flow.py`` (reference
``src/operator/control_flow.cc:1096-1262``). The JAX package traces the
bodies into ``lax.scan``/``lax.while_loop``/``lax.cond``; here the bodies
run as the Python they are, their ops recorded by ``torch.autograd`` like
any others, so a gradient flows through every step that ran.

* ``foreach`` runs its body once a slice of the leading axis: a loop of
  fixed length, which a hybridized block captures into its CUDA graph.
* ``while_loop`` keeps the reference's padding contract: the step outputs
  are stacked to ``max_iterations`` rows, zeros past the exit. The exit
  is decided on the host after each step, so ``func`` never runs past it:
  a body that would give NaN there leaves no NaN in the gradient, where a
  fixed-length loop masked with ``where`` would.
* ``cond`` picks its branch on the host and runs only that branch.

Deciding on the host means waiting for the card, which a CUDA graph
cannot do: inside a hybridized block's capture these two raise
``HostStopError``, and the block then runs its calls eagerly and counts
them in ``eager_call_count`` (``gluon/block.py``).
"""

from .registry import HostStopError, get_op, invoke

__all__ = ['foreach', 'while_loop', 'cond']


def _nd():
    from ..ndarray.ndarray import NDArray
    return NDArray


def _leaves(x):
    """``x`` (an NDArray or a list or tuple of them) as a list, and
    whether it was one array."""
    if isinstance(x, _nd()):
        return [x], True
    return list(x), False


def _stack(steps, axis=0):
    return invoke(get_op('stack'), (steps,), {'axis': axis})


def _host_check(what):
    from ..gluon.block import capturing
    if capturing():
        raise HostStopError(f'npx.{what} decides on the host, which a CUDA '
                            f'graph capture cannot; the block runs eagerly')


def _truth(x):
    return bool(x.asnumpy().reshape(())) if isinstance(x, _nd()) \
        else bool(x)


def foreach(body, data, init_states, name='foreach'):
    """Run ``body(data_slice, states) -> (outputs, new_states)`` over the
    leading axis of ``data`` (an NDArray or a list of them); returns the
    outputs stacked on axis 0 and the final states."""
    xs, one = _leaves(data)
    states = init_states
    steps = []
    for i in range(xs[0].shape[0]):
        x = xs[0][i] if one else [d[i] for d in xs]
        out, states = body(x, states)
        steps.append(out)
    outs, single = _leaves(steps[0])
    stacked = [_stack([_leaves(s)[0][j] for s in steps])
               for j in range(len(outs))]
    return (stacked[0] if single else stacked), states


def while_loop(cond, func, loop_vars, max_iterations, name='while_loop'):
    """Run ``func(*loop_vars) -> (step_outputs, new_loop_vars)`` while
    ``cond(*loop_vars)`` holds, at most ``max_iterations`` times; returns
    the step outputs stacked to ``max_iterations`` rows (zeros past the
    exit) and the final loop vars."""
    from ..autograd import pause
    vars_, one = _leaves(loop_vars)
    steps = []
    for _ in range(max_iterations):
        _host_check('while_loop')
        if not _truth(cond(*vars_)):
            break
        out, new = func(*vars_)
        steps.append(out)
        vars_, _ = _leaves(new)
    if steps:
        first, single = _leaves(steps[0])
    else:       # the shapes only: func's outputs at the first vars
        with pause():
            first, single = _leaves(func(*vars_)[0])
    stacked = []
    for j, proto in enumerate(first):
        rows = [_leaves(s)[0][j] for s in steps]
        pad = max_iterations - len(rows)
        zeros = invoke(get_op('zeros_like'), (invoke(
            get_op('broadcast_to'), (proto.detach(),),
            {'shape': (pad,) + tuple(proto.shape)}),), {}) if pad else None
        if not rows:
            stacked.append(zeros)
        elif pad:
            stacked.append(invoke(get_op('concatenate'),
                                  ([_stack(rows), zeros],), {'axis': 0}))
        else:
            stacked.append(_stack(rows))
    final = vars_[0] if one else type(loop_vars)(vars_)
    return (stacked[0] if single else stacked), final


def cond(pred, then_func, else_func, inputs=(), name='cond'):
    """``then_func(*inputs)`` if ``pred`` (a boolean scalar, or a callable
    over ``inputs``) holds, else ``else_func(*inputs)``."""
    inputs = list(inputs) if isinstance(inputs, (list, tuple)) \
        else [inputs]
    if callable(pred):
        pred = pred(*inputs)
    _host_check('cond')
    return (then_func if _truth(pred) else else_func)(*inputs)
