"""The op ledger of the port: what of the reference's registry is not
ported yet, by ROADMAP label.

Every name in the JAX package's op registry (its ``ops.registry.
list_ops()``, aliases included) is either registered here
(:mod:`.registry`) or listed in :data:`PENDING` under the ROADMAP item
that will port it; ``tests/test_torch_ledger.py`` holds the two lists
against the JAX registry, so an unported op stays visible and a name is
never both. The labels are queue A's in ROADMAP.md (A3 rest, the op
families not ported with NDArray, and A4 rest, the replayable creation
ops of deferred compute, are done and have no entry left):

* ``A11``: the fused RNN, CTC loss, detection, image and probability ops.
"""

__all__ = ['PENDING', 'pending', 'LABELS', 'PendingOpError']


class PendingOpError(NotImplementedError, AttributeError):
    """An op of the reference that the port has not ported yet. It is an
    ``AttributeError`` too, so ``hasattr(mx.np, name)`` is False for it."""

PENDING = {
    'A11': (
        # ops/nn.py: fused RNN and CTC loss (gluon/rnn)
        'RNN', 'rnn', 'CTCLoss', 'ctc_loss',
        # ops/contrib.py: detection (the yolo/rcnn/ssd zoo)
        'Proposal', 'proposal', 'bipartite_matching', 'box_decode',
        'box_encode', 'box_iou', 'box_nms', 'multibox_detection',
        'multibox_prior', 'multibox_target', 'onnx_nms', 'roi_align',
        'roi_pooling',
        # ops/legacy_ops.py: image ops (image/)
        'image_crop', 'image_normalize', 'image_random_crop',
        'image_random_resized_crop', 'image_to_tensor',
        # gluon/probability
        '_prob_gamma_rsample',
    ),
}

#: the ROADMAP labels the pending ops wait on
LABELS = tuple(PENDING)


def pending():
    """``{op name: ROADMAP label}`` for every op not ported yet."""
    return {name: label for label, names in PENDING.items()
            for name in names}
