"""Multi-seed protocol (PyTorch port of dbw_tpu/train/multi_seed.py; the
reference's multi_pipeline.sh: several seeded runs of one scene, then
selection of the lowest train loss), on one card or on a mesh of ranks.

    python3 scripts/torch_multi_pipeline.py -t TAG -c synthetic/dtu_shaped.yml \\
        --seeds 11 22 33 44 55 [--cpu]
    torchrun --nproc-per-node 4 scripts/torch_multi_pipeline.py ... [--n-data 2]
        [--n-spatial 2]

The S seeds' parameters are stacked leaves (S, ...) under one torch Adam
with the texture group, and each step runs the seeds on the same views
through ``parallel/seeds.py``'s executor: by default batched, one forward
and backward of all S slots with one launch of each kernel
(``DBW_SEED_EXEC=map``: one slot after the other). Slot s draws from a generator
seeded by ``step_seed(seed_s, step counter)``, as the port Trainer does,
and both take their batches from a loader seeded 0: slot s of a protocol
run is the port Trainer's run with ``training.seed = seed_s``.

The loop keeps the JAX protocol's schedule: groups of ``steps_per_call``
batches (a ragged tail at the end of an epoch) whose steps run one after
the other, the log, val and save actions at the groups' boundaries, the
per-epoch LRs and curriculum phase, and the per-seed running train loss
weighted by each batch's real views. A val interval logs each seed's
opacities, marks a seed whose blocks are all below 0.01 dead (left out of
selection; every seed dead raises ``RuntimeError("No more blocks....")``),
renders the current best live seed on the viz views and writes
``multi_model.pkl``.

The run directory is the JAX protocol's: ``train_metrics.tsv``
(``loss_s{seed}``), ``seed{s}/val_metrics.tsv``, ``reconstructions_best/``,
``multi_model.pkl``, and at the end ``seed{s}/model.pkl``, the best seed's
``model.pkl`` and ``seed_selection.tsv``; ``evaluate`` adds each seed's
``final_scores.tsv`` and the best seed's full evaluation.

``multi_model.pkl`` has the JAX layout (params as a SceneParams of (S, ...)
arrays, opt_state as optax's ScaleByAdamState with an (S,) count, the
cursor and the bookkeeping), so each package resumes the other's file. The
port's random state is its step counter ``step_ctr``, in place of JAX's
``key``: ``jax.random`` cannot be replayed (ROADMAP.md §3, standing). The
file also holds a ``key``, the one a fresh JAX protocol starts from, so
that the JAX package can resume it (its draws from there on are its own);
a JAX-written file resumes here with the counter of its cursor.

Under torchrun (a process group of several ranks, ``parallel/mesh.py``)
the protocol takes the JAX package's mesh path: its validation and layout
(``seed_layout``: an explicit ``n_data`` or ``n_spatial``, or the seed axis
first with the leftover ranks on the data axis), the seeds padded to a
multiple of the seed axis, each rank holding its seed column's slots and
stepping them through ``MultiSeedRunner`` on its view shard and band. The
per-slot losses, opacities and checkpoint state are gathered across the
seed columns, so every rank keeps the whole run's bookkeeping; rank 0
alone writes the run directory (the TSVs, the evolution stream,
``multi_model.pkl`` in the JAX layout, ``seed{s}/model.pkl``,
``seed_selection.tsv``) and runs the final evaluation. Each rank resumes
its own slots from ``multi_model.pkl``, so a file written on N ranks
resumes on one, and the other way round, when the padded seed slots agree
(the JAX package's rule). One rank is a mesh of one (seed=1, data=1):
its collectives do nothing, so the step is ``train_step``'s without a
mesh bit for bit;
``n_data`` or ``n_spatial`` above 1 raise there, as on one JAX device.

Left out, as TPU machinery: the AOT cache, the device packer, the
device-resident dataset and the scanned multi-step.
"""

from __future__ import annotations

import time
from pathlib import Path

import numpy as np
import torch

from ..data import create_train_val_test_loader
from ..eval.metrics import Metrics
from ..models import create_model
from ..parallel.mesh import factor_devices, make_mesh, world
from ..parallel.seeds import MultiSeedRunner, pad_seeds, select_best_seed, slot, stacked_leaves
from ..render.trajectory import to_u8
from ..utils.device import DEFAULT_DEVICE, resolve_device
from ..utils.image import ImageLogger
from ..utils.logger import print_log
from ..utils.misc import path_mkdir, use_seed
from . import checkpoint as ck
from .optimizer import create_optimizer
from .scheduler import base_lrs, create_scheduler, set_lrs
from .trainer import _HostWorker, _pad_ids, epoch_groups, gather_views, step_seed

MULTI_CKPT = "multi_model.pkl"


def jax_key(seed):
    """The raw uint32 pair of ``jax.random.PRNGKey(seed)`` (threefry),
    0 <= seed < 2**32."""
    return np.array([0, seed], np.uint32)


def slot_snapshot(snap, i):
    """Slot i of a ``checkpoint.snapshot`` of stacked leaves."""
    copy, states, rule = snap
    return ({k: v[i] for k, v in copy.items()},
            {k: {f: (v[i] if torch.is_tensor(v) and v.ndim else v)
                 for f, v in st.items()} for k, st in states.items()}, rule)


def seed_layout(n_dev, n_seeds, batch_size, n_data=None, n_spatial=None):
    """The JAX protocol's validation of the mesh axes and its layout on
    ``n_dev`` ranks -> (seed axis, data axis, sp axis, seed slots); on one
    rank (1, 1, 1, n_seeds). An explicit axis is validated loudly (no fall-back);
    without ``n_data`` the seed axis comes first (``factor_devices``) and
    the leftover ranks become the data axis, or more seed slots when the
    batch does not divide over them."""
    if n_data is not None and n_data < 1:
        raise ValueError(f"n_data must be >= 1, got {n_data}")
    if n_spatial is not None and int(n_spatial) < 1:
        raise ValueError(f"n_spatial must be >= 1, got {n_spatial}")
    if n_data is not None and n_data > 1 and n_dev == 1:
        raise ValueError(f"n_data={n_data} requested but only {n_dev} device present")
    n_sp = int(n_spatial) if n_spatial else 1
    if n_sp > 1 and n_dev == 1:
        raise ValueError(f"n_spatial={n_sp} requested but only {n_dev} device present")
    if n_sp > 1:
        if n_dev % n_sp:
            raise ValueError(f"n_spatial={n_sp} does not divide {n_dev} devices")
        n_dev = n_dev // n_sp
        if n_data is None and n_seeds > n_dev:
            raise ValueError(
                f"n_spatial={n_sp} leaves {n_dev} device group(s) for {n_seeds} seeds "
                "\u2014 reduce seeds or n_spatial")
    if n_data is not None:
        if n_dev % n_data:
            raise ValueError(f"n_data={n_data} does not divide {n_dev} devices")
        if batch_size % n_data:
            raise ValueError(
                f"batch_size={batch_size} is not divisible by n_data={n_data} (each "
                f"data-axis device takes B/n_data views)")
        seed_ax = n_dev // n_data
    else:
        seed_ax, n_data = factor_devices(n_dev, n_seeds=n_seeds)
        if batch_size % n_data != 0:
            seed_ax, n_data = n_dev, 1
    slots = -(-n_seeds // seed_ax) * seed_ax
    return seed_ax, n_data, n_sp, slots


def protocol_epoch(t, epoch, batches):
    """One epoch of a protocol trainer ``t`` (this module's, or
    ``MultiSceneTrainer``) on the one schedule (``epoch_groups``): each
    group's steps (``t._run_group``); at a log interval the drained losses
    logged (``t._log_train``); at a val interval the drained losses, the
    selection state (``t._val_and_log``) and a save."""
    for group, it, do_log, do_val in epoch_groups(t, epoch, batches):
        t._run_group(group)
        last_batch = group[-1][0]
        if do_log or do_val:
            t._drain_losses()  # the selection state must be current
        if do_log:
            t._log_train(it, epoch, last_batch)
        if do_val:
            t._val_and_log(it, epoch, last_batch)
            t.save(epoch, last_batch)


def gathered_snapshot(snap, gather=None):
    """A ``checkpoint.snapshot`` of this rank's slots -> the snapshot of
    every slot, each stacked tensor passed through ``gather`` (a mesh's
    gather over its seed columns; none on the multi-scene trainer's single
    device)."""
    if gather is None:
        return snap
    copy, states, rule = snap
    return ({k: gather(v) for k, v in copy.items()},
            {k: {f: (gather(v) if torch.is_tensor(v) and v.ndim else v)
                 for f, v in st.items()} for k, st in states.items()}, rule)


class MultiSeedTrainer:
    """Trains S seeds of one scene together; selects the lowest train
    loss. ``world_size``: the ranks of the run, by default those of the
    process group (one without torch.distributed); 1 runs this process
    alone."""

    def __init__(self, cfg, run_dir, seeds=None, resume=False, n_data=None,
                 n_spatial=None, device=DEFAULT_DEVICE, world_size=None):
        self.device = resolve_device(device)
        if self.device.type == "cuda":
            # TF32 off, as in the port Trainer
            torch.backends.cuda.matmul.allow_tf32 = False
            torch.backends.cudnn.allow_tf32 = False
        self.cfg = cfg
        ckpt = None
        if resume:
            path = Path(run_dir) / MULTI_CKPT
            if not path.exists():
                raise FileNotFoundError(f"resume requested but {path} does not exist")
            ckpt = ck.read_pickle(path)
            seeds = ckpt["orig_seeds"]
            print_log(f"[multi-seed] resuming from {path}: epoch={ckpt['epoch']}, "
                      f"batch={ckpt['batch']}, seeds={seeds}")
        self.orig_seeds = [int(s) for s in seeds]
        self.seeds = list(self.orig_seeds)
        self.n_valid = len(self.seeds)
        tcfg = cfg["training"]
        self.batch_size = tcfg.get("batch_size", 4)
        n_dev = world()[1] if world_size is None else int(world_size)
        seed_ax, n_data, n_sp, slots = seed_layout(n_dev, self.n_valid, self.batch_size,
                                                   n_data, n_spatial)
        self.seeds, self.n_valid = pad_seeds(self.seeds, slots)
        self.mesh = make_mesh(seed_ax, n_data, world_size=n_dev, n_spatial=n_sp)
        self.rank0 = self.mesh.rank == 0
        self._say(f"[multi-seed] mesh (seed={seed_ax}, data={n_data}"
                  + (f", sp={n_sp}" if n_sp > 1 else "")
                  + f"): {self.n_valid} seeds in {slots} slots "
                  f"({slots - self.n_valid} padded)")
        S = len(self.seeds)
        # this rank's seed slots (all of them on one rank)
        self.slots = self.mesh.slot_slice(S)
        self.run_dir = path_mkdir(run_dir) if self.rank0 else Path(run_dir)
        self.train_loader, self.val_loader, self.test_loader = (
            create_train_val_test_loader(cfg, device=self.device))
        self.dataset = self.train_loader.dataset
        self.model = create_model(cfg, self.dataset.img_size, self.device)
        self.model.set_camera(self.dataset.K[0])
        self.n_epoches = tcfg["n_epoches"]
        self.n_batches = len(self.train_loader)
        self.steps_per_call = int(tcfg.get("steps_per_call", 1))
        self.train_stat_interval = tcfg.get("train_stat_interval", 0)
        self.val_stat_interval = tcfg.get("val_stat_interval", 0)

        self.params = stacked_leaves([self.model.init_params(seed=s)
                                      for s in self.seeds[self.slots]])
        self.optimizer = create_optimizer(cfg, self.params)
        self.scheduler = create_scheduler(cfg, base_lrs(self.optimizer))
        self.runner = MultiSeedRunner(self.model, self.optimizer, self.mesh)
        self.dead = np.zeros(S, bool)
        self.epoch_start, self.batch_start = 1, 1
        self.loss_sums, self.n_seen = np.zeros(S), 0
        if ckpt is not None:
            self._restore(ckpt)
        # the global step counter the per-step generators are seeded by
        self._step_ctr = (self.epoch_start - 1) * self.n_batches + self.batch_start - 1
        if ckpt is not None and int(ckpt.get("step_ctr", self._step_ctr)) != self._step_ctr:
            raise ValueError(f"checkpoint step_ctr {ckpt['step_ctr']} does not match "
                             f"its cursor ({self._step_ctr} steps)")
        # replay the uninterrupted batch order after a resume
        self.train_loader.set_epoch(self.epoch_start - 1)

        append = self.epoch_start > 1 or self.batch_start > 1
        resume_iter = (self.epoch_start - 1) * self.n_batches + self.batch_start - 1
        # rank 0 alone writes the run directory
        log = (lambda *parts: self.run_dir.joinpath(*parts)) if self.rank0 else (
            lambda *parts: None)
        self.train_metrics = Metrics(
            *[f"loss_s{s}" for s in self.orig_seeds],
            log_file=log("train_metrics.tsv"), append=append, truncate_iter=resume_iter)
        alpha_names = [f"alpha{k}" for k in range(self.model.n_blocks)]
        if self.rank0:
            for s in self.orig_seeds:
                path_mkdir(self.run_dir / f"seed{s}")
        self.val_metrics = [
            Metrics(*alpha_names, log_file=log(f"seed{s}", "val_metrics.tsv"),
                    append=append, truncate_iter=resume_iter)
            for s in self.orig_seeds]

        # the evolution stream of the current best seed on the viz views
        self.viz = bool(tcfg.get("multi_seed_viz", True))
        if self.viz:
            with use_seed(12345):
                src = self.val_loader if len(self.val_loader) > 0 else self.train_loader
                samples, _ = next(iter(src))
            self.viz_samples = {k: v[:4] for k, v in samples.items()}
            self.rec_logger = (ImageLogger(self.run_dir / "reconstructions_best",
                                           self.viz_samples) if self.rank0 else None)
            self._viz_R = torch.from_numpy(self.viz_samples["R"]).to(self.device)
            self._viz_T = torch.from_numpy(self.viz_samples["T"]).to(self.device)
        self._host = _HostWorker()
        self._loss_buffer = []  # ((S_local,) device tensor, n_real) per step

    def _say(self, msg):
        """Log on rank 0 only."""
        if self.rank0:
            print_log(msg)

    # ------------------------------------------------------------------
    # checkpoint / resume
    # ------------------------------------------------------------------

    def save(self, epoch, batch):
        """``multi_model.pkl``: every slot's parameters and Adam state, the
        cursor and the bookkeeping; a detached copy now, the pickle on the
        host worker. On a mesh the slots are gathered from every seed
        column and rank 0 writes."""
        snap = gathered_snapshot(ck.snapshot(self.params, self.optimizer), self.mesh.gather)
        if not self.rank0:
            return
        meta = {
            "epoch": epoch, "batch": batch,
            "orig_seeds": list(self.orig_seeds), "seeds": list(self.seeds),
            "n_valid": self.n_valid, "step_ctr": self._step_ctr,
            "key": jax_key(max(self.seeds) + 1), "dead": self.dead.copy(),
            "loss_sums": self.loss_sums.copy(), "n_seen": self.n_seen,
            "model_kwargs": self.cfg.get("model", {}),
        }
        lead = (len(self.seeds),)

        def _write():
            params, opt_state = ck.stacked_to_jax(snap, lead)
            ck.write_pickle(self.run_dir / MULTI_CKPT,
                            dict(meta, params=params, opt_state=opt_state))

        self._host.submit(_write, fatal=True)

    def _restore(self, ckpt):
        if [int(s) for s in ckpt["seeds"]] != self.seeds:
            raise ValueError("resume on a different device topology: checkpoint seed "
                             f"slots {list(ckpt['seeds'])} != current {self.seeds}")
        ck.restore_stacked(ckpt["params"], ckpt["opt_state"], self.params, self.optimizer,
                           self.slots)
        self.dead = np.asarray(ckpt["dead"], bool).copy()
        self.loss_sums = np.asarray(ckpt["loss_sums"], np.float64).copy()
        self.n_seen = int(ckpt["n_seen"])
        if ckpt["batch"] >= self.n_batches:
            self.epoch_start, self.batch_start = ckpt["epoch"] + 1, 1
        else:
            self.epoch_start, self.batch_start = ckpt["epoch"], ckpt["batch"] + 1

    # ------------------------------------------------------------------
    # interval actions
    # ------------------------------------------------------------------

    def _masked_losses(self, losses):
        """Padded and dead slots get inf: they are never selected."""
        live = (np.arange(len(self.seeds)) < self.n_valid) & ~self.dead
        return np.where(live, losses, np.inf)

    def _val_and_log(self, it, epoch, batch):
        """Per-seed opacity streams and the dead-seed rule (the reference
        Trainer's per run)."""
        alphas = self.mesh.gather(self.model.get_opacities(self.params))
        alphas = alphas.cpu().numpy()
        alive = (alphas > 0.01).sum(axis=1) > 0
        for i in range(self.n_valid):
            if not alive[i] and not self.dead[i]:
                self.dead[i] = True
                self._say(f"[multi-seed] seed {self.seeds[i]} has no more blocks at "
                          f"epoch {epoch}, excluded from selection")
            self.val_metrics[i].update({f"alpha{k}": float(a)
                                        for k, a in enumerate(alphas[i])})
            self.val_metrics[i].log_and_reset(it=it, epoch=epoch, batch=batch)
        if self.dead[: self.n_valid].all():
            raise RuntimeError("No more blocks....")
        if self.viz:
            self._log_best_recon(it, epoch)

    @torch.no_grad()
    def _log_best_recon(self, it, epoch):
        """The current best (lowest running loss) live seed's render of the
        viz views (``model.predict`` in the eval phase, as the JAX
        protocol); the encoding runs on the host worker. On a mesh the
        slots are gathered and rank 0 renders."""
        best = int(np.argmin(self._masked_losses(self.loss_sums)))
        params = {k: self.mesh.gather(v) for k, v in self.params.items()}
        if not self.rank0:
            return
        phase = self.model.phase_for_epoch(epoch - 1, training=False)
        rec = self.model.predict(slot(params, best), phase, self._viz_R,
                                 self._viz_T)[0]
        rec = to_u8(rec).cpu().numpy()
        self._host.submit(lambda: self.rec_logger.save(rec, it))

    def _log_train(self, it, epoch, batch):
        self._say(f"[multi-seed] epoch {epoch}/{self.n_epoches} "
                  f"batch {batch}/{self.n_batches} "
                  f"train_metrics: {self.train_metrics}"[:1000])
        self.train_metrics.log_and_reset(it=it, epoch=epoch, batch=batch)

    # ------------------------------------------------------------------
    # training
    # ------------------------------------------------------------------

    def _train_step(self, ids):
        """One Adam step of every seed on the views ``ids`` (on a mesh: of
        this rank's seeds on its shard of the views)."""
        idx, n_real = _pad_ids(ids, self.batch_size)
        idx = idx[self.mesh.data_slice(self.batch_size)]
        imgs, R, T = gather_views(self.dataset, idx, self.device)
        gens = [torch.Generator(device=self.device).manual_seed(
            step_seed(s, self._step_ctr)) for s in self.seeds[self.slots]]
        self._step_ctr += 1
        losses = self.runner.step(self.params, self.phase, imgs, R, T, gens)
        # no sync here: the losses stay on the device until an interval
        self._loss_buffer.append((losses, n_real))

    def _run_group(self, group):
        """A group of (batch, view ids), one step after the other."""
        for _, ids in group:
            self._train_step(ids)

    def run(self):
        return self._host.run(self._run)

    def _run(self):
        t0 = time.time()
        for epoch in range(self.epoch_start, self.n_epoches + 1):
            self.phase = self.model.phase_for_epoch(epoch - 1, training=True)
            set_lrs(self.optimizer, self.scheduler.lrs(epoch - 1))
            if epoch != self.epoch_start or self.batch_start == 1:
                # buffered losses belong to the previous epoch's accounting
                self._drain_losses()
                self.loss_sums[:] = 0.0
                self.n_seen = 0
            protocol_epoch(self, epoch, self.train_loader.iter_indices())
            if epoch % max(self.n_epoches // 10, 1) == 0 or epoch == 1:
                self._drain_losses()
                means = self.loss_sums / max(self.n_seen, 1)
                self._say(f"[multi-seed] epoch {epoch}/{self.n_epoches} "
                          f"losses={np.round(means, 5).tolist()} "
                          f"({time.time() - t0:.1f}s)")

        self._drain_losses()
        final_losses = self.loss_sums / max(self.n_seen, 1)
        self.save(self.n_epoches, self.n_batches)
        snap = gathered_snapshot(ck.snapshot(self.params, self.optimizer), self.mesh.gather)
        # every slot's parameters, for the selection and the final evaluation
        self.final_params = snap[0]
        best_params, best = select_best_seed(self.final_params,
                                             self._masked_losses(final_losses))
        self.best = best
        self._say(f"[multi-seed] final per-seed loss="
                  f"{final_losses[: self.n_valid].round(5).tolist()}"
                  f" -> auto-selected seed {self.seeds[best]} (min train loss)")
        if not self.rank0:
            return best_params, self.seeds[best], final_losses[: self.n_valid]
        kw = self.cfg.get("model", {})
        for i, s in enumerate(self.seeds[: self.n_valid]):
            ck.write_snapshot(self.run_dir / f"seed{s}" / "model.pkl",
                              slot_snapshot(snap, i), self.n_epoches, self.n_batches,
                              model_kwargs=kw)
        ck.write_snapshot(self.run_dir / "model.pkl", slot_snapshot(snap, best),
                          self.n_epoches, self.n_batches, model_kwargs=kw)
        write_seed_selection(self.run_dir / "seed_selection.tsv",
                             self.seeds[: self.n_valid], final_losses, self.dead, best)
        self._host.join()  # the checkpoint and viz frames on disk before the video
        if self.viz:
            try:
                self.rec_logger.save_video()
            except Exception as e:  # the video is cosmetic
                print_log(f"[multi-seed] evolution video failed: {e}")
        return best_params, self.seeds[best], final_losses[: self.n_valid]

    def _drain_losses(self):
        """Pull the buffered per-step losses in one transfer into the
        per-seed running sums, each step weighted by its batch's real views
        (a ragged tail's pad views repeat its last view)."""
        if not self._loss_buffer:
            return
        buf, self._loss_buffer = self._loss_buffer, []
        # every seed column's slots
        rows = self.mesh.gather(torch.stack([v for v, _ in buf]).T.contiguous()).T
        rows = rows.cpu().numpy()
        for row, (_, n_real) in zip(rows, buf):
            self.loss_sums[:] = self.loss_sums + row * n_real
            self.n_seen += n_real
            self.train_metrics.update({f"loss_s{s}": float(row[j])
                                       for j, s in enumerate(self.orig_seeds)}, N=n_real)

    # ------------------------------------------------------------------
    # final evaluation
    # ------------------------------------------------------------------

    def evaluate(self, per_seed_full=False, quali_kwargs=None):
        """``final_scores.tsv`` for every seed in ``seed{s}/`` (the full
        evaluation with ``per_seed_full``), and the best seed's full
        evaluation in the run directory; one LPIPS for all. On a mesh rank 0
        evaluates every slot and the other ranks return None."""
        assert hasattr(self, "best"), "evaluate() requires a finished run()"
        if not self.rank0:
            return None
        seeds = self.seeds[: self.n_valid]
        params = self.final_params
        scores = evaluate_slots(
            self.model, self.cfg, self.test_loader, self.dataset,
            [(slot(params, i), self.run_dir / f"seed{s}", per_seed_full, f"seed{s}")
             for i, s in enumerate(seeds)]
            + [(slot(params, self.best), self.run_dir, True,
                f"best=seed{self.seeds[self.best]}")],
            quali_kwargs, shared_lpips(self.model))
        return dict(zip(seeds + ["best"], scores))


def shared_lpips(model):
    """One ``LPIPSLoss`` on the model's VGG16 features, for every slot's
    evaluation."""
    from ..losses.vgg import LPIPSLoss

    return LPIPSLoss(vgg=model.perceptual_loss.vgg if model.perceptual_loss else None,
                     device=model.device)


def evaluate_slots(model, cfg, test_loader, dataset, jobs, quali_kwargs, lpips):
    """``evaluate_run`` for each (params, run_dir, quali, label) of
    ``jobs``; a DTU scan read from a configured ``dataset.root`` is scored
    against that root. -> [scores per job]."""
    from ..eval.full import evaluate_run

    root = cfg["dataset"].get("root")
    kw = {"dtu_dir": root} if root else {}
    return [evaluate_run(model, params, test_loader, dataset, run_dir, quali=quali,
                         lpips=lpips, label=label, quali_kwargs=quali_kwargs, **kw)
            for params, run_dir, quali, label in jobs]


def write_seed_selection(path, seeds, final_losses, dead, best):
    """``seed_selection.tsv``, the JAX protocol's format."""
    with open(path, "w") as f:
        f.write("seed\tfinal_train_loss\tdead\tselected\n")
        for i, s in enumerate(seeds):
            f.write(f"{s}\t{final_losses[i]:.6f}\t{int(dead[i])}\t{int(i == best)}\n")
