"""The entry ``multi_seed``: ``dbw_torch.train.multi_seed.MultiSeedTrainer``
on one rank with the traffic's ``seeds``, stepped by the public
``MultiSeedRunner.step`` on the views of ``train_loader.iter_indices()``,
gathered as ``MultiSeedTrainer._train_step`` gathers them, one generator
per slot from ``step_seed``. The protocol's interval work is left out:
its entry points are private."""

from __future__ import annotations

import torch

from benchmark.harness import Loop as Base
from benchmark.harness import pad_ids


class Loop(Base):
    """The 5-seed protocol's batched step on one rank."""

    stacked = True

    def __init__(self, cfg, run_dir, traffic, spans, device):
        super().__init__(traffic, spans, device)
        from dbw_torch.train.multi_seed import MultiSeedTrainer

        self.mt = MultiSeedTrainer(cfg, run_dir, seeds=traffic["seeds"], device=device,
                                   world_size=1)
        self.model, self.params, self.optimizer = self.mt.model, self.mt.params, self.mt.optimizer
        self.loader = self.mt.train_loader
        self.seeds = list(self.mt.seeds)
        self.n_valid = self.mt.n_valid
        self.batch_size = self.mt.batch_size
        self.ctr = 0
        self.phase = None
        self.loss_log = []

    def begin_epoch(self, epoch):
        from dbw_torch.train.scheduler import set_lrs

        self.phase = self.mt.model.phase_for_epoch(epoch - 1, training=True)
        set_lrs(self.optimizer, self.mt.scheduler.lrs(epoch - 1))

    def one_step(self, epoch, batch, ids):
        from dbw_torch.train.trainer import gather_views, step_seed

        idx, _ = pad_ids(ids, self.batch_size)
        with self.spans("bench.step"):
            imgs, R, T = gather_views(self.mt.dataset, idx, self.device)
            gens = [torch.Generator(device=self.device).manual_seed(step_seed(s, self.ctr))
                    for s in self.seeds]
            self.ctr += 1
            losses = self.mt.runner.step(self.params, self.phase, imgs, R, T, gens)
        self.loss_log.append(losses)
        self.step_ids.append(ids)
        self.steps += 1
        self.work += self.n_valid
        return losses.detach()

    def unit(self):
        epoch, batch, ids = next(self.batches)
        self.one_step(epoch, batch, ids)
        return 1

    def failed_steps(self):
        if not self.loss_log:
            return 0
        bad = ~torch.isfinite(torch.stack(self.loss_log)[:, :self.n_valid])
        return int(bad.any(dim=1).sum())

    def close(self):
        self.mt._host.close()
