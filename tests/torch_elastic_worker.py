"""Kill/resume parity worker for the port's ``mx.train.ElasticTrainer``
(the counterpart of ``tests/nightly/elastic_train_worker.py``).

Three modes, run by ``tests/test_torch_elastic.py`` on the CPU:

* ``straight``: train ``--steps`` steps without a stop; dump the final
  weights, Adam slots and the update count to ``--out``;
* ``crash``: train with ``MXNET_CKPT_ASYNC=1``, saving after every step
  (steps are numbered from 1), and die by SIGKILL inside the daemon's save
  of step ``--kill-at`` (at ``ckpt.staged``, before the commit): the
  checkpoint of step ``--kill-at - 1`` is the newest committed one;
* ``resume``: rebuild the same program, restore the newest checkpoint
  (parameters, optimizer slots and counters, lr schedule, random streams,
  the iterator's position) and train the remaining steps; dump as
  ``straight``.

``straight`` and ``crash`` + ``resume`` must dump bit-equal arrays: the
net has Dropout (it draws every step), the loader shuffles, the optimizer
is Adam with a FactorScheduler.
"""

import argparse
import os
import signal
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), '..'))

import numpy as onp  # noqa: E402
import torch  # noqa: E402

import mxnet_tpu_torch as mx  # noqa: E402
from mxnet_tpu_torch import (autograd, gluon, lr_scheduler,  # noqa: E402
                             parallel)
from mxnet_tpu_torch.gluon import nn  # noqa: E402
from mxnet_tpu_torch.parallel import checkpoint  # noqa: E402
from mxnet_tpu_torch.train import ElasticTrainer  # noqa: E402


def build(ckpt_dir):
    mx.random.seed(11)
    net = nn.HybridSequential()
    net.add(nn.Dense(16, in_units=4, activation='relu'))
    net.add(nn.Dropout(0.5))
    net.add(nn.Dense(2))
    net.initialize(ctx=mx.cpu())
    rng = onp.random.default_rng(0)
    X = rng.standard_normal((32, 4)).astype('float32')
    Y = rng.standard_normal((32, 2)).astype('float32')
    loader = gluon.data.DataLoader(gluon.data.ArrayDataset(X, Y),
                                   batch_size=8, shuffle=True)
    it = loader.resumable(shuffle_seed=5)
    sched = lr_scheduler.FactorScheduler(step=2, factor=0.7,
                                            base_lr=0.01)
    trainer = gluon.Trainer(net.collect_params(), 'adam',
                            {'learning_rate': 0.01, 'lr_scheduler': sched})
    mgr = parallel.SharedCheckpointManager(ckpt_dir, max_to_keep=2)
    et = ElasticTrainer(dict(net.collect_params()), trainer, mgr,
                        data_iter=it, name='parity')
    return net, trainer, it, et


def train_step(net, trainer, it):
    x, y = next(it)
    with autograd.record():
        loss = ((net(x) - y) ** 2).mean()
    loss.backward()
    trainer.step(1)


def dump(path, net, trainer):
    arrs = {k: v.data().asnumpy() for k, v in net.collect_params().items()}
    for i, st in trainer._states.items():
        for j, t in enumerate(st if isinstance(st, tuple) else (st,)):
            if torch.is_tensor(t):
                arrs[f'slot{i}_{j}'] = t.numpy()
    arrs['num_update'] = onp.array(trainer._optimizer.num_update)
    onp.savez(path, **arrs)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument('--mode', choices=('straight', 'crash', 'resume'),
                    required=True)
    ap.add_argument('--ckpt-dir', required=True)
    ap.add_argument('--out', required=True)
    ap.add_argument('--steps', type=int, default=6)
    ap.add_argument('--kill-at', type=int, default=3)
    args = ap.parse_args()

    with mx.cpu():
        net, trainer, it, et = build(args.ckpt_dir)
        if args.mode == 'straight':
            for _ in range(args.steps):
                train_step(net, trainer, it)
            dump(args.out, net, trainer)
            return

        if args.mode == 'crash':
            def hook(point):
                if point == 'ckpt.staged' and \
                        os.path.isdir(os.path.join(
                            args.ckpt_dir, f'.staging-{args.kill_at}')):
                    os.kill(os.getpid(), signal.SIGKILL)
            checkpoint.install_crash_hook(hook)
            for step in range(1, args.kill_at + 1):
                train_step(net, trainer, it)
                # durable before the next step: no save is coalesced away
                et.save(step, block=True)
            raise AssertionError('the save of the last step did not kill')

        start = et.restore()
        assert start == args.kill_at - 1, start
        for _ in range(start + 1, args.steps + 1):
            train_step(net, trainer, it)
        dump(args.out, net, trainer)


if __name__ == '__main__':
    main()
