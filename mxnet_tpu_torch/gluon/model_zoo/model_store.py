"""Pretrained weights for the vision zoo (counterpart of
``mxnet_tpu/gluon/model_zoo/model_store.py``).

Not ported yet: the local weight store and its checkpoint importers are
ROADMAP A11. Every zoo factory calls :func:`apply_pretrained`, which
passes a net built with ``pretrained=False`` through and raises for any
other value.
"""

__all__ = ['apply_pretrained']


def apply_pretrained(net, pretrained, name, ctx=None, root=None):
    """``net`` itself when ``pretrained`` is falsy; pretrained weights
    raise ``NotImplementedError``."""
    if not pretrained:
        return net
    raise NotImplementedError(
        f'{name}(pretrained={pretrained!r}): the model store is not ported '
        f'yet (ROADMAP A11); build the net with pretrained=False and load '
        f'weights with load_parameters or load_dict')
