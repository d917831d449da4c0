"""The entry ``trainer``: ``dbw_torch.train.trainer.Trainer`` as users run
it. Its public ``run_scanned_batches`` (``run_single_batch_train`` with
``steps_per_call`` 1) over groups of batches from
``train_loader.iter_indices()``, with ``cur_epoch`` set per pass as
``Trainer._run`` sets it, a ragged group's batches one by one, and the
interval actions on the config's schedule (``log_train_metrics``; then
``run_val_and_log``, ``log_visualizations`` and ``save``): the schedule of
``Trainer._run``, copied here. ``--seed`` (modulo 2**32) is the scene's
training seed."""

from __future__ import annotations

import numpy as np

from benchmark.harness import Loop as Base


class Loop(Base):
    """The single-scene Trainer and its interval work."""

    @classmethod
    def configure(cls, cfg, traffic, seed):
        # the Trainer seeds numpy's legacy generator, which takes 32 bits
        cfg["training"]["seed"] = int(seed) % 2**32

    def __init__(self, cfg, run_dir, traffic, spans, device):
        super().__init__(traffic, spans, device)
        from dbw_torch.train.trainer import Trainer

        self.tr = Trainer(cfg, run_dir, device=device, seed=cfg["training"]["seed"])
        self.model, self.params, self.optimizer = self.tr.model, self.tr.params, self.tr.optimizer
        self.loader = self.tr.train_loader
        self.seeds = [self.tr.seed]
        self.S = self.tr.steps_per_call
        self.n_batches = self.tr.n_batches
        self.pending = []
        self.cur_iter = None

    def begin_epoch(self, epoch):
        self.tr.cur_epoch = epoch

    def end_epoch(self, epoch):
        self.tr.step(epoch + 1)

    def one_step(self, epoch, batch, ids):
        """One step through the window's own call; -> its (1,) total loss."""
        if self.cur_iter is None:
            self.cur_iter = (epoch - 1) * self.n_batches + batch
        with self.spans("bench.step"):
            if self.S > 1:
                self.tr.run_scanned_batches([ids])
            else:
                self.tr.run_single_batch_train(ids)
        self._count([ids])
        self.cur_iter += 1
        return self.tr._loss_buffer[-1][0][-1:].detach()

    def _count(self, group):
        for ids in group:
            self.step_ids.append(ids)
            self.steps += 1
            self.work += 1

    def quiet_steps(self):
        """The steps before the next interval action."""
        return -self.cur_iter % self.tr.train_stat_interval

    def warm_intervals(self):
        """The interval actions once, in set-up (``Trainer._run`` renders
        the viz streams before its first step), then the host worker
        joined."""
        it, epoch = self.cur_iter - 1, self.tr.cur_epoch
        with self.spans("bench.warm"):
            self.tr.log_visualizations(it)
            self.tr.log_train_metrics(it, epoch, it)
            self.tr.run_val_and_log(it, epoch, it)
            self.tr.save(epoch=epoch, batch=it)
            self.tr._host.join()

    def unit(self):
        """The next group of steps and the intervals it crosses (a ragged
        group at an epoch's end one batch a call). -> steps done."""
        while True:
            epoch, batch, ids = next(self.batches)
            self.pending.append((batch, ids))
            if len(self.pending) == self.S or batch == self.n_batches:
                break
        group, self.pending = self.pending, []
        ids_list = [ids for _, ids in group]
        with self.spans("bench.step"):
            if len(group) == self.S and self.S > 1:
                self.tr.run_scanned_batches(ids_list)
            else:
                for ids in ids_list:
                    self.tr.run_single_batch_train(ids)
        self._count(ids_list)
        self._intervals(group, epoch)
        return len(group)

    def _intervals(self, group, epoch):
        do_log = do_val = False
        for _ in group:
            do_log |= self.cur_iter % self.tr.train_stat_interval == 0
            do_val |= self.cur_iter % self.tr.val_stat_interval == 0
            self.cur_iter += 1
        it, last_batch = self.cur_iter - 1, group[-1][0]
        if do_log:
            with self.spans("bench.interval.log"):
                self.tr.log_train_metrics(it, epoch, last_batch)
        if do_val:
            with self.spans("bench.interval.val"):
                self.tr.run_val_and_log(it, epoch, last_batch)
            with self.spans("bench.interval.viz"):
                self.tr.log_visualizations(it)
            with self.spans("bench.interval.save"):
                self.tr.save(epoch=epoch, batch=last_batch)

    def finish(self):
        """The end of the window: the host worker's queue drained."""
        with self.spans("bench.join"):
            self.tr._host.join()

    def failed_steps(self):
        """Steps whose logged mean total loss is not finite (the Trainer
        keeps per-step losses only until its log interval)."""
        vals = np.asarray(self.tr.train_metrics.read_log().get("loss_total", []), float)
        return 0 if np.isfinite(vals).all() else self.steps

    def close(self):
        self.tr._host.close()
