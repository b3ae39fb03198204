"""Gluon of the PyTorch port: the model zoo's Llama family
(:mod:`.model_zoo.llama`) as ``torch.nn.Module``s, the losses of
:mod:`.loss` and the single-device :class:`Trainer`."""

from . import loss
from .trainer import Trainer

__all__ = ['loss', 'Trainer']
