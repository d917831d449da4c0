"""Multi-scene trainer (PyTorch port of dbw_tpu/train/multi_scene.py): N
scenes of one model config, S seeds each, trained together, on one card
or on a mesh of ranks.

    python3 scripts/torch_multi_scene_pipeline.py -t TAG \\
        -c dtu/scan24.yml dtu/scan37.yml [--n-seeds S] [--cpu]
    torchrun --nproc-per-node 4 scripts/torch_multi_scene_pipeline.py ... [--n-data 2]

Every scene shares the model config and the training config but for
``training.seed``, and the scenes' train loaders have one batch count and
image size. Scene i's seeds are its config seed plus 0..S-1. The
parameters are stacked leaves (n_scene, S, ...) under one torch Adam; each
step runs every (scene, seed) slot through ``parallel/scenes.py``
``scene_backward``: batched by default, one step of n_scene * S slots,
each scene's views with its own views and intrinsics (the JAX trainer's
nested vmap), or under ``DBW_SEED_EXEC=map`` the scenes one after the
other with the camera swap and each scene's seeds one after the other. Slot (i, j) draws from a generator
seeded by ``step_seed(scene_seeds[i][j], step counter)``, so it is the port
Trainer's run of scene i's config with that seed. The JAX package pads the
shorter scenes' view stacks to one device array by repeating their last
view; here each scene's batch is gathered from its own dataset, which the
padded views never reach. Each scene counts its real views itself.

Each scene's run directory gets ``train_metrics.tsv``, ``val_metrics.tsv``
(``seed{s}/val_metrics.tsv`` with several seeds), its best seed's
``model.pkl`` (and ``seed{s}/model.pkl`` with several seeds) and
``evaluate``'s artifacts. The stacked ``multi_scene_model.pkl`` (the JAX
layout, the step counter ``step_ctr`` in place of JAX's ``key``, as in
``multi_seed.py``) is written in the first run directory at every val
interval and resumes exactly.

Under torchrun, when the scenes divide the ranks, the trainer takes the
JAX package's (scene, seed, data) mesh (``parallel/scenes.py``): the ranks
of a scene factor into the smallest seed axis that fits the seeds and a
data axis that divides the batch (or the given ``n_data``), the seeds are
padded to the seed axis, and each rank trains its scene's slots through
``MultiSceneRunner``. Losses, opacities and the checkpoint state are
gathered across the scenes and seed columns; rank 0 alone writes the run
directories and runs the final evaluation. When the scenes do not divide
the ranks, the JAX package's single-device branch, with its warning: rank
0 trains every scene on its card and the other ranks do nothing.
"""

from __future__ import annotations

import time
from pathlib import Path

import numpy as np
import torch

from ..data import create_train_val_test_loader
from ..eval.metrics import Metrics
from ..models import create_model
from ..parallel.mesh import world
from ..parallel.scenes import MultiSceneRunner, camera_state, make_scene_mesh, use_camera
from ..parallel.seeds import pad_seeds, slot, stack_params, stacked_leaves, train_step
from ..utils.device import DEFAULT_DEVICE, resolve_device
from ..utils.logger import print_log, print_warning
from ..utils.misc import path_mkdir
from . import checkpoint as ck
from .multi_seed import (evaluate_slots, gathered_snapshot, jax_key, protocol_epoch,
                         shared_lpips, slot_snapshot)
from .optimizer import create_optimizer
from .scheduler import base_lrs, create_scheduler, set_lrs
from .trainer import _HostWorker, _pad_ids, gather_views, step_seed

MULTI_SCENE_CKPT = "multi_scene_model.pkl"


def scene_layout(per_scene, n_seeds, batch_size, n_data=None):
    """The JAX trainer's (data axis, seed axis) of the ranks of one scene:
    the given ``n_data``, or the smallest seed axis that fits the seeds
    whose leftover data axis divides the batch (else all-seed)."""
    nd = n_data
    if nd is None:
        nd = 1
        for cand_seed in sorted(d for d in range(1, per_scene + 1) if per_scene % d == 0):
            if cand_seed >= n_seeds:
                cand_data = per_scene // cand_seed
                if batch_size % cand_data == 0:
                    nd = cand_data
                    break
    if per_scene % nd:
        raise ValueError(f"n_data={nd} does not divide {per_scene} devices/scene")
    return nd, per_scene // nd


def _require_equal(items, pick, what):
    vals = [pick(c) for c in items]
    if any(v != vals[0] for v in vals[1:]):
        raise ValueError(f"multi-scene training requires identical {what} across "
                         f"scenes; got {vals}")
    return vals[0]


class MultiSceneTrainer:
    """Trains N scenes x S seeds together; with S > 1 each scene's best seed
    is selected by the lowest train loss.

    cfgs: one merged config dict per scene; run_dirs: one run directory per
    scene."""

    def __init__(self, cfgs, run_dirs, n_seeds=1, n_data=None, resume=False,
                 device=DEFAULT_DEVICE, world_size=None):
        assert len(cfgs) == len(run_dirs) and len(cfgs) >= 1
        self.device = resolve_device(device)
        if self.device.type == "cuda":
            torch.backends.cuda.matmul.allow_tf32 = False
            torch.backends.cudnn.allow_tf32 = False
        self.cfgs = cfgs
        self.n_scene = len(cfgs)
        _require_equal(cfgs, lambda c: c["model"], "model config")
        _require_equal(cfgs, lambda c: {k: v for k, v in c["training"].items()
                                        if k != "seed"},
                       "training config (except seed)")
        tcfg = cfgs[0]["training"]
        self.batch_size = tcfg.get("batch_size", 4)
        self.n_epoches = tcfg["n_epoches"]
        self.steps_per_call = int(tcfg.get("steps_per_call", 1))
        self.train_stat_interval = tcfg.get("train_stat_interval", 0)
        self.val_stat_interval = tcfg.get("val_stat_interval", 0)
        self.scene_seeds = [[c["training"].get("seed", 4321) + k for k in range(n_seeds)]
                            for c in cfgs]
        self.S = self.n_valid = n_seeds
        rank, n_dev = world()
        if world_size is not None:
            n_dev = int(world_size)
            rank = rank if n_dev > 1 else 0
        self.mesh = None
        self.rank0 = rank == 0
        if n_dev > 1 and n_dev % self.n_scene == 0:
            nd, seed_ax = scene_layout(n_dev // self.n_scene, n_seeds, self.batch_size, n_data)
            self.S = -(-n_seeds // seed_ax) * seed_ax
            self.scene_seeds = [pad_seeds(s, self.S)[0] for s in self.scene_seeds]
            self.mesh = make_scene_mesh(self.n_scene, seed_ax, nd, world_size=n_dev)
            self._say(f"[multi-scene] mesh (scene={self.n_scene}, seed={seed_ax}, "
                      f"data={nd}): {n_seeds} seeds in {self.S} slots per scene")
        else:
            self._say(f"[multi-scene] single-device program: {self.n_scene} scenes x "
                      f"{n_seeds} seeds")
            if n_dev > 1 and self.rank0:
                print_warning(
                    f"[multi-scene] {self.n_scene} scenes do not divide the {n_dev} "
                    "available devices: falling back to a single-device program holding "
                    "all scenes' state on rank 0's card; the other ranks idle. Pick a "
                    "scene count that divides the device count (or run groups of scenes "
                    "separately).")
        # the single-device branch runs on rank 0 alone
        self.idle = self.mesh is None and not self.rank0
        self.run_dirs = [path_mkdir(d) if self.rank0 else Path(d) for d in run_dirs]
        if self.idle:
            return
        # this rank's scenes and seed slots (all of them on one rank)
        self.scenes = (range(self.n_scene) if self.mesh is None else
                       range(self.mesh.coords["scene"], self.mesh.coords["scene"] + 1))
        self.slots = self.mesh.slot_slice(self.S) if self.mesh else slice(0, self.S)

        ckpt = None
        if resume:
            path = self.run_dirs[0] / MULTI_SCENE_CKPT
            if not path.exists():
                raise FileNotFoundError(f"resume requested but {path} does not exist")
            ckpt = ck.read_pickle(path)
            self._say(f"[multi-scene] resuming from {path}: epoch={ckpt['epoch']}, "
                      f"batch={ckpt['batch']}")

        self.loaders = [create_train_val_test_loader(c, device=self.device) for c in cfgs]
        self.datasets = [ld[0].dataset for ld in self.loaders]
        self.n_batches = _require_equal([ld[0] for ld in self.loaders], len,
                                        "train batch count")
        _require_equal(self.datasets, lambda d: d.img_size, "image size")
        self.model = create_model(cfgs[0], self.datasets[0].img_size, self.device)
        self.model.set_camera(self.datasets[0].K[0])
        self.cameras = [camera_state(self.model, d.K[0]) for d in self.datasets]

        self.params = stacked_leaves([
            stack_params([self.model.init_params(seed=s)
                          for s in self.scene_seeds[i][self.slots]])
            for i in self.scenes])
        self.optimizer = create_optimizer(cfgs[0], self.params)
        self.scheduler = create_scheduler(cfgs[0], base_lrs(self.optimizer))
        self.runner = self._gather = None
        if self.mesh:
            self.runner = MultiSceneRunner(self.model, self.optimizer, self.mesh,
                                           self.cameras[self.scenes[0]])
            self._gather = self._gather_slots
        self.dead = np.zeros((self.n_scene, self.S), bool)
        self.epoch_start, self.batch_start = 1, 1
        self.loss_sums = np.zeros((self.n_scene, self.S))
        # per-scene real-view counts: the scenes' view totals may differ
        # (only their batch counts must match), so their ragged tails do
        self.n_seen = np.zeros(self.n_scene, np.int64)
        if ckpt is not None:
            self._restore(ckpt)
        self._step_ctr = (self.epoch_start - 1) * self.n_batches + self.batch_start - 1
        if ckpt is not None and int(ckpt.get("step_ctr", self._step_ctr)) != self._step_ctr:
            raise ValueError(f"checkpoint step_ctr {ckpt['step_ctr']} does not match "
                             f"its cursor ({self._step_ctr} steps)")
        for ld in self.loaders:
            ld[0].set_epoch(self.epoch_start - 1)
        self._host = _HostWorker()
        # ((n_local_scenes, S_local) device tensor, (n_scene,) n_real) per step
        self._loss_buffer = []

        append = self.epoch_start > 1 or self.batch_start > 1
        resume_iter = (self.epoch_start - 1) * self.n_batches + self.batch_start - 1
        # rank 0 alone writes the run directories
        log = (lambda d: d / "train_metrics.tsv") if self.rank0 else (lambda d: None)
        self.train_metrics = [
            Metrics(*[f"loss_s{s}" for s in self.scene_seeds[i][: self.n_valid]],
                    log_file=log(self.run_dirs[i]), append=append,
                    truncate_iter=resume_iter)
            for i in range(self.n_scene)]
        alpha_names = [f"alpha{k}" for k in range(self.model.n_blocks)]
        self.val_metrics = []
        for i in range(self.n_scene):
            per_seed = []
            for s in self.scene_seeds[i][: self.n_valid]:
                d = (self.run_dirs[i] if self.n_valid == 1 or not self.rank0
                     else path_mkdir(self.run_dirs[i] / f"seed{s}"))
                per_seed.append(Metrics(
                    *alpha_names, log_file=d / "val_metrics.tsv" if self.rank0 else None,
                    append=append, truncate_iter=resume_iter))
            self.val_metrics.append(per_seed)

    def _say(self, msg):
        """Log on rank 0 only."""
        if self.rank0:
            print_log(msg)

    def _gather_slots(self, t):
        """(1, S_local, ...) of this rank -> (n_scene, S, ...) of every
        scene and seed column."""
        return self.mesh.gather(t.reshape((-1,) + t.shape[2:])).reshape(
            (self.n_scene, self.S) + t.shape[2:])

    # ------------------------------------------------------------------
    # checkpoint / resume
    # ------------------------------------------------------------------

    def save(self, epoch, batch):
        """``multi_scene_model.pkl`` in the first run directory: a detached
        copy now, the pickle on the host worker. On a mesh the slots are
        gathered from every rank and rank 0 writes."""
        snap = gathered_snapshot(ck.snapshot(self.params, self.optimizer), self._gather)
        if not self.rank0:
            return
        meta = {
            "epoch": epoch, "batch": batch,
            "scene_seeds": [list(s) for s in self.scene_seeds], "n_valid": self.n_valid,
            "step_ctr": self._step_ctr,
            "key": jax_key(max(max(s) for s in self.scene_seeds) + 1),
            "dead": self.dead.copy(), "loss_sums": self.loss_sums.copy(),
            "n_seen": self.n_seen.copy(),
        }
        lead = (self.n_scene, self.S)

        def _write():
            params, opt_state = ck.stacked_to_jax(snap, lead)
            ck.write_pickle(self.run_dirs[0] / MULTI_SCENE_CKPT,
                            dict(meta, params=params, opt_state=opt_state))

        self._host.submit(_write, fatal=True)

    def _restore(self, ckpt):
        if [list(s) for s in ckpt["scene_seeds"]] != [list(s) for s in self.scene_seeds]:
            raise ValueError("resume on a different topology: checkpoint seeds "
                             f"{ckpt['scene_seeds']} != current {self.scene_seeds}")
        ck.restore_stacked(ckpt["params"], ckpt["opt_state"], self.params, self.optimizer,
                           (slice(self.scenes.start, self.scenes.stop), self.slots))
        self.dead = np.asarray(ckpt["dead"], bool).copy()
        self.loss_sums = np.asarray(ckpt["loss_sums"], np.float64).copy()
        self.n_seen = np.broadcast_to(np.asarray(ckpt["n_seen"], np.int64),
                                      (self.n_scene,)).copy()
        if ckpt["batch"] >= self.n_batches:
            self.epoch_start, self.batch_start = ckpt["epoch"] + 1, 1
        else:
            self.epoch_start, self.batch_start = ckpt["epoch"], ckpt["batch"] + 1

    # ------------------------------------------------------------------
    # interval actions
    # ------------------------------------------------------------------

    def _val_and_log(self, it, epoch, batch):
        alphas = self.model.get_opacities(self.params)
        if self.mesh:
            alphas = self._gather_slots(alphas)
        alphas = alphas.cpu().numpy()
        alive = (alphas > 0.01).sum(axis=2) > 0
        for i in range(self.n_scene):
            for j in range(self.n_valid):
                if not alive[i, j] and not self.dead[i, j]:
                    self.dead[i, j] = True
                    self._say(f"[multi-scene] scene {i} seed {self.scene_seeds[i][j]} "
                              f"has no more blocks at epoch {epoch}, excluded from "
                              "selection")
                self.val_metrics[i][j].update({f"alpha{k}": float(a)
                                               for k, a in enumerate(alphas[i, j])})
                self.val_metrics[i][j].log_and_reset(it=it, epoch=epoch, batch=batch)
        if self.dead[:, : self.n_valid].all():
            raise RuntimeError("No more blocks....")

    # ------------------------------------------------------------------
    # training
    # ------------------------------------------------------------------

    def _train_step(self, ids_sc):
        """One Adam step of every (scene, seed) slot: scene i on its views
        ``ids_sc[i]`` with its camera (on a mesh: this rank's slots of its
        scene on its shard of the views, through ``MultiSceneRunner``)."""
        views, gens = [], []
        for i in self.scenes:
            idx = _pad_ids(ids_sc[i], self.batch_size)[0]
            if self.mesh:
                idx = idx[self.mesh.data_slice(self.batch_size)]
            views.append(gather_views(self.datasets[i], idx, self.device))
            gens += [torch.Generator(device=self.device).manual_seed(step_seed(s, self._step_ctr))
                     for s in self.scene_seeds[i][self.slots]]
        self._step_ctr += 1
        if self.runner:
            rows = self.runner.step(self.params, self.phase, *views[0], gens)
        else:
            rows = train_step(self.model, self.optimizer, self.params, self.phase, views, gens,
                              cameras=self.cameras)["total"]
        n_reals = [_pad_ids(ids, self.batch_size)[1] for ids in ids_sc]
        self._loss_buffer.append((rows, np.array(n_reals, np.int64)))

    def _run_group(self, group):
        """A group of (batch, per-scene view ids), one step after the other."""
        for _, ids_sc in group:
            self._train_step(ids_sc)

    def run(self):
        """-> (the stacked parameters of every slot, each scene's best seed
        slot, the (n_scene, n_seeds) final losses); None on an idle rank."""
        if self.idle:
            return None
        return self._host.run(self._run)

    def _run(self):
        t0 = time.time()
        for epoch in range(self.epoch_start, self.n_epoches + 1):
            self.phase = self.model.phase_for_epoch(epoch - 1, training=True)
            set_lrs(self.optimizer, self.scheduler.lrs(epoch - 1))
            if epoch != self.epoch_start or self.batch_start == 1:
                self._drain_losses()
                self.loss_sums[:] = 0.0
                self.n_seen[:] = 0
            protocol_epoch(self, epoch, zip(*[ld[0].iter_indices() for ld in self.loaders]))
            if epoch % max(self.n_epoches // 10, 1) == 0 or epoch == 1:
                self._drain_losses()
                means = self.loss_sums / np.maximum(self.n_seen, 1)[:, None]
                self._say(f"[multi-scene] epoch {epoch}/{self.n_epoches} "
                          f"losses={np.round(means[:, : self.n_valid], 5).tolist()}"
                          f" ({time.time() - t0:.1f}s)")

        self._drain_losses()
        final_losses = self.loss_sums / np.maximum(self.n_seen, 1)[:, None]
        masked = np.where((np.arange(self.S)[None, :] < self.n_valid) & ~self.dead,
                          final_losses, np.inf)
        self.best = masked.argmin(axis=1)  # each scene's best seed slot
        self.save(self.n_epoches, self.n_batches)
        snap = gathered_snapshot(ck.snapshot(self.params, self.optimizer), self._gather)
        # every slot's parameters, for the final evaluation
        self.final_params = snap[0] if self.mesh else self.params
        if not self.rank0:
            return self.final_params, self.best, final_losses[:, : self.n_valid]
        for i in range(self.n_scene):
            scene_snap = slot_snapshot(snap, i)
            kw = self.cfgs[i].get("model", {})
            if self.n_valid > 1:
                for j, s in enumerate(self.scene_seeds[i][: self.n_valid]):
                    ck.write_snapshot(self.run_dirs[i] / f"seed{s}" / "model.pkl",
                                      slot_snapshot(scene_snap, j), self.n_epoches,
                                      self.n_batches, model_kwargs=kw)
            b = int(self.best[i])
            ck.write_snapshot(self.run_dirs[i] / "model.pkl", slot_snapshot(scene_snap, b),
                              self.n_epoches, self.n_batches, model_kwargs=kw)
            self._say(f"[multi-scene] scene {i} ({self.datasets[i].tag}): "
                      f"losses={final_losses[i, : self.n_valid].round(5).tolist()}"
                      f" -> seed {self.scene_seeds[i][b]}")
        self._host.join()  # the protocol checkpoint on disk before returning
        return self.final_params, self.best, final_losses[:, : self.n_valid]

    def _log_train(self, it, epoch, batch):
        for m in self.train_metrics:
            m.log_and_reset(it=it, epoch=epoch, batch=batch)

    def _drain_losses(self):
        """Pull the buffered (n_scene, S) losses in one transfer into the
        per-scene, per-seed running sums."""
        if not self._loss_buffer:
            return
        buf, self._loss_buffer = self._loss_buffer, []
        rows = torch.stack([v for v, _ in buf])
        if self.mesh:  # (steps, 1, S_local) -> (steps, n_scene, S) of every rank
            rows = self._gather_slots(rows.permute(1, 2, 0).contiguous()).permute(2, 0, 1)
        rows = rows.cpu().numpy()
        for row, (_, n_real) in zip(rows, buf):
            self.loss_sums += row * n_real[:, None]
            self.n_seen += n_real
            for i in range(self.n_scene):
                self.train_metrics[i].update({
                    f"loss_s{s}": float(row[i, j])
                    for j, s in enumerate(self.scene_seeds[i][: self.n_valid])},
                    N=int(n_real[i]))

    # ------------------------------------------------------------------
    # final evaluation
    # ------------------------------------------------------------------

    def evaluate(self, quali=True, quali_kwargs=None):
        """Each scene's best seed evaluated into its run directory, with the
        scene's camera; one LPIPS for all. -> [scores per scene]. On a mesh
        rank 0 evaluates every scene; the other ranks return []."""
        if self.idle or not self.rank0:
            return []
        assert hasattr(self, "best"), "evaluate() requires a finished run()"
        lpips = shared_lpips(self.model)
        results = []
        for i in range(self.n_scene):
            with use_camera(self.model, self.cameras[i]):
                p = slot(slot(self.final_params, i), int(self.best[i]))
                label = self.datasets[i].tag or f"scene{i}"
                results += evaluate_slots(
                    self.model, self.cfgs[i], self.loaders[i][2], self.datasets[i],
                    [(p, self.run_dirs[i], quali, label)], quali_kwargs, lpips)
        return results
