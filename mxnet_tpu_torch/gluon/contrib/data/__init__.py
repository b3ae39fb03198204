"""Contrib datasets and samplers (reference
python/mxnet/gluon/contrib/data/__init__.py). ``contrib.data.vision``'s
bounding-box transforms wait with the image transforms (ROADMAP A11)."""

from .sampler import IntervalSampler
from . import text
