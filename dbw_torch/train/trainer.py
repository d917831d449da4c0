"""Single-scene training loop (PyTorch port of dbw_tpu/train/trainer.py,
reference src/trainer.py).

    python -m dbw_torch.train.trainer -t <tag> -c synthetic/dtu_shaped.yml [--cpu]

trains one scene on the card (``--cpu``: on the CPU) and writes the run
directory ``runs/<dataset>/<tag>``: the config, ``training.log``,
``train_metrics.tsv`` and ``val_metrics.tsv``, ``model.pkl`` (the JAX
package's layout), the viz streams (``reconstructions``,
``reconstructions_hard``, ``reconstructions_syn``, ``txt_blocks``), and
the final evaluation (``final_scores.tsv``, ``quali_eval/``, and for a DTU
scan ``dtu_scores.tsv``).

The loop keeps the JAX Trainer's schedule (``epoch_groups``, which the
protocol trainers share): with ``steps_per_call`` S the
batches are taken in groups of S (a ragged tail at the end of an epoch) and
the interval actions (log, val, viz, save) fire at the groups'
boundaries, so the metric rows fall on the JAX Trainer's iterations. The S
steps of a group run one after the other. A ragged last batch repeats its
last view, as there. Per-step randomness (opacity noise, overlap points)
comes from a ``torch.Generator`` seeded by (training.seed, global step), so
a resumed run replays the uninterrupted one exactly. The step's losses stay
on the device until the log interval; checkpoint writing and image
encoding run on one background thread.
"""

from __future__ import annotations

import argparse
import queue
import threading
import time
from dataclasses import replace
from pathlib import Path

import numpy as np
import torch

from ..data import create_train_val_test_loader
from ..eval.metrics import Metrics
from ..models import create_model
from ..parallel.seeds import train_step
from ..render.trajectory import to_u8
from ..utils import profiling
from ..utils.colors import fancy_colormap
from ..utils.config import dump_yaml, load_yaml
from ..utils.device import DEFAULT_DEVICE, resolve_device
from ..utils.image import ImageLogger
from ..utils.logger import create_logger, print_log, print_warning
from ..utils.misc import path_exists, path_mkdir, use_seed
from ..utils.path import CONFIGS_PATH, RUNS_PATH
from ..utils.visualizer import Visualizer
from . import checkpoint as ck
from .optimizer import create_optimizer
from .scheduler import base_lrs, create_scheduler, set_lrs

LOG_FMT = "Epoch [{}/{}], Iter [{}/{}], {}".format
N_VIZ_SAMPLES = 4
LIGHT_MEMORY_RESULTS = True


class _HostWorker:
    """One background thread for host-side interval work (checkpoint
    writes, image encoding, dashboard writes), first in first out, so that
    artifacts land in order. A failed checkpoint write stops the run at the
    next submit or join; a failed cosmetic task only warns."""

    def __init__(self):
        self._q = queue.Queue()
        self._fatal = None
        self._t = threading.Thread(target=self._loop, daemon=True)
        self._t.start()

    def _loop(self):
        while True:
            item = self._q.get()
            if item is None:
                self._q.task_done()
                break
            fn, fatal = item
            try:
                fn()
            except Exception as e:
                if fatal and self._fatal is None:
                    self._fatal = e
                print_warning(f"host worker task failed: {e!r}")
            finally:
                self._q.task_done()

    def submit(self, fn, fatal=False):
        self._check_fatal()
        self._q.put((fn, fatal))

    def join(self, raise_fatal=True):
        self._q.join()
        if raise_fatal:  # False on exception paths: do not mask the cause
            self._check_fatal()

    def close(self):
        """Drain the queue and stop the thread."""
        self._q.put(None)
        self._t.join()

    def run(self, fn):
        """``fn()``, then the thread stopped. If ``fn`` fails, the tasks it
        submitted still run first: a checkpoint saved right before the
        failure lands on disk, and it is what a resume reads."""
        try:
            return fn()
        except BaseException:
            self.join(raise_fatal=False)
            raise
        finally:
            self.close()

    def _check_fatal(self):
        if self._fatal is not None:
            e, self._fatal = self._fatal, None
            raise RuntimeError(
                "checkpoint write failed earlier (see the warning above); the "
                "run has no usable saved state past that point") from e


def step_seed(seed, counter, stream=0):
    """The seed of the generator of one step (stream 0) from the training
    seed and the global step counter."""
    return int(np.random.SeedSequence([int(seed), stream, int(counter)])
               .generate_state(1, np.uint64)[0] >> np.uint64(1))


def _pad_ids(ids, batch_size):
    """Pad a ragged last batch's view ids to the batch size with its last
    view. -> (ids, number of real views)."""
    ids = np.asarray(ids, np.int64)
    n = len(ids)
    if n < batch_size:
        ids = np.concatenate([ids, np.repeat(ids[-1:], batch_size - n)])
    return ids, n


def epoch_groups(t, epoch, batches):
    """One epoch of the JAX trainers' schedule, shared by the port's three
    trainers: ``batches`` (one per batch of the epoch) from the resume's
    ``t.batch_start`` on in ``t.epoch_start``, in groups of
    ``t.steps_per_call`` with a ragged tail at the epoch's end. Yields
    (group, it, do_log, do_val): the group's [(batch, batch's item)], the
    iteration of its last batch, and whether one of its iterations
    ((epoch - 1) * t.n_batches + batch) falls on a multiple of
    ``t.train_stat_interval`` (log) or of ``t.val_stat_interval`` (val);
    an interval of 0 falls on none."""
    start = t.batch_start if epoch == t.epoch_start else 1
    size = max(int(t.steps_per_call), 1)

    def crossed(group):
        its = [(epoch - 1) * t.n_batches + b for b, _ in group]
        hit = lambda every: bool(every) and any(i % every == 0 for i in its)
        return group, its[-1], hit(t.train_stat_interval), hit(t.val_stat_interval)

    group = []
    for batch, item in enumerate(batches, start=1):
        if batch < start:
            continue
        group.append((batch, item))
        if len(group) == size:
            yield crossed(group)
            group = []
    if group:
        yield crossed(group)


def gather_views(dataset, idx, device):
    """The views ``idx`` of a dataset as (imgs, R, T) tensors on ``device``
    (the leaf ``dbw.gather``, which counts the bytes copied to a card)."""
    with profiling.span("dbw.gather"):
        host = [a[idx] for a in (dataset.imgs, dataset.R, dataset.T)]
        if torch.device(device).type != "cpu":
            profiling.count("h2d_bytes", sum(a.nbytes for a in host))
        return tuple(torch.from_numpy(a).to(device, non_blocking=True) for a in host)


class Trainer:
    """Optimize one scene from a config dict into ``run_dir``."""

    @use_seed()
    def __init__(self, cfg, run_dir, device=DEFAULT_DEVICE):
        self.device = resolve_device(device)
        if self.device.type == "cuda":
            # TF32 off, the parity setting of the port's checks (whether
            # TF32 keeps the scores is an open question)
            torch.backends.cuda.matmul.allow_tf32 = False
            torch.backends.cudnn.allow_tf32 = False
        self.run_dir = path_mkdir(run_dir)
        self.cfg = cfg
        tcfg = cfg["training"]
        if tcfg.get("debug_nans"):
            torch.autograd.set_detect_anomaly(True)
        self.train_loader, self.val_loader, self.test_loader = (
            create_train_val_test_loader(cfg, device=self.device))
        self.dataset = self.train_loader.dataset
        self.model = create_model(cfg, self.dataset.img_size, self.device)
        self.model.set_camera(self.dataset.K[0])

        self.batch_size = tcfg.get("batch_size", 4)
        self.steps_per_call = int(tcfg.get("steps_per_call", 1))
        self.n_epoches = tcfg.get("n_epoches", 1)
        self.n_batches = len(self.train_loader)
        self.epoch_start, self.batch_start = 1, 1
        self.seed = tcfg.get("seed", 4321)

        self.params = self.model.init_params(seed=self.seed)
        self.optimizer = create_optimizer(cfg, self.params)
        self.scheduler = create_scheduler(cfg, base_lrs(self.optimizer))
        self.load_from(cfg)
        self.cur_lr = self.scheduler.lrs(self.epoch_start - 1)["main"]
        print_log(f"Training state: epoch={self.epoch_start}, "
                  f"batch={self.batch_start}, lr={self.cur_lr}")

        # the global step counter the per-step generators are seeded by
        self._step_ctr = (self.epoch_start - 1) * self.n_batches + self.batch_start - 1
        self._loss_keys = [n[len("loss_"):] for n in self.model.loss_names]
        self._epoch_consts_cache = None
        self._host = _HostWorker()
        self._loss_buffer = []  # ((L,) device tensor, n_real) per step
        self._window_t0 = time.time()
        self._window_imgs = 0

        # metric streams: append whenever any progress exists; rows past
        # the checkpoint's iteration are orphans of the interrupted run
        append = self.epoch_start > 1 or self.batch_start > 1
        resume_iter = (self.epoch_start - 1) * self.n_batches + self.batch_start - 1
        self.train_stat_interval = tcfg["train_stat_interval"]
        self.val_stat_interval = tcfg["val_stat_interval"]
        self.save_epoches = tcfg.get("save_epoches", [])
        # final-eval knobs forwarded to qualitative_eval
        self.eval_kwargs = dict(tcfg.get("eval", {}))
        self.train_metrics = Metrics(
            "time/img", *self.model.loss_names,
            log_file=self.run_dir / "train_metrics.tsv", append=append,
            truncate_iter=resume_iter)
        self.val_metrics = Metrics(
            *[f"alpha{k}" for k in range(self.model.n_blocks)],
            log_file=self.run_dir / "val_metrics.tsv", append=append,
            truncate_iter=resume_iter)

        # the viz streams' samples: the first val batch
        with use_seed(12345):
            src = self.val_loader if len(self.val_loader) > 0 else self.train_loader
            samples, _ = next(iter(src))
        self.viz_samples = {k: v[:N_VIZ_SAMPLES] for k, v in samples.items()}
        self._viz_R = torch.from_numpy(self.viz_samples["R"]).to(self.device)
        self._viz_T = torch.from_numpy(self.viz_samples["T"]).to(self.device)
        self._viz_gt_u8 = (np.clip(self.viz_samples["imgs"], 0, 1) * 255 + 0.5).astype(np.uint8)
        out_ext = "jpg" if LIGHT_MEMORY_RESULTS else "png"
        self.rec_logger = ImageLogger(self.run_dir / "reconstructions",
                                      self.viz_samples, out_ext=out_ext)
        self.rec2_logger = ImageLogger(self.run_dir / "reconstructions_hard",
                                       self.viz_samples, out_ext=out_ext)
        self.rec3_logger = ImageLogger(self.run_dir / "reconstructions_syn",
                                       self.viz_samples, out_ext="png")
        self.txt_logger = ImageLogger(self.run_dir / "txt_blocks", out_ext=out_ext)
        viz_on = tcfg.get("visualizer_port") if self.with_training else None
        self.visualizer = Visualizer(viz_on, self.run_dir)

    # ------------------------------------------------------------------

    @property
    def with_training(self):
        return self.epoch_start <= self.n_epoches

    def load_from(self, cfg):
        """``pretrained``: the weights only; ``resume``: the parameters, the
        Adam state and the epoch/batch cursor."""
        pretrained = cfg["training"].get("pretrained")
        resume = cfg["training"].get("resume")
        if pretrained is not None and resume is not None:
            raise ValueError("training: give pretrained or resume, not both")
        tag = pretrained or resume
        if tag is None:
            return
        path = Path(tag)
        if not path.exists():
            path = path_exists(RUNS_PATH / self.dataset.name / tag / "model.pkl")
        state = ck.load_checkpoint(path)
        ck.restore(state, self.params)
        if resume is not None:
            if state["batch"] == self.n_batches:
                self.epoch_start, self.batch_start = state["epoch"] + 1, 1
            else:
                self.epoch_start, self.batch_start = state["epoch"], state["batch"] + 1
            if state.get("optimizer_state") is None:
                print_warning("resume: the checkpoint has no optimizer state, "
                              "reinitializing")
            else:
                ck.restore(state, self.params, self.optimizer)
            # replay the uninterrupted run's batch order: the shuffle stream
            # is keyed by (seed, epoch)
            self.train_loader.set_epoch(self.epoch_start - 1)
        print_log(f"Checkpoint {tag} loaded")

    # ------------------------------------------------------------------

    def _epoch_consts(self):
        """The current epoch's curriculum phase and LRs; the LRs are written
        into the optimizer when the epoch changes. -> (phase, {group: lr})."""
        e = self.cur_epoch
        if self._epoch_consts_cache is None or self._epoch_consts_cache[0] != e:
            phase = self.model.phase_for_epoch(e - 1, training=True)
            lrs = self.scheduler.lrs(e - 1)
            set_lrs(self.optimizer, lrs)
            self._epoch_consts_cache = (e, phase, lrs)
        return self._epoch_consts_cache[1], self._epoch_consts_cache[2]

    def _train_step(self, ids):
        """One Adam step on the views ``ids`` (the span ``dbw.step``)."""
        with profiling.step():
            idx, n_real = _pad_ids(ids, self.batch_size)
            phase, _ = self._epoch_consts()
            imgs, R, T = gather_views(self.dataset, idx, self.device)
            gen = torch.Generator(device=self.device).manual_seed(
                step_seed(self.seed, self._step_ctr))
            self._step_ctr += 1
            losses = train_step(self.model, self.optimizer, self.params, phase,
                                (imgs, R, T), gen)
            # no sync here: the losses stay on the device until the log interval
            with profiling.span("dbw.loss.other"):
                self._loss_buffer.append(
                    (torch.stack([losses[k] for k in self._loss_keys]), n_real))
            self._window_imgs += n_real

    def run_single_batch_train(self, ids):
        self.run_scanned_batches([ids])

    def run_scanned_batches(self, ids_list):
        """A full group of steps_per_call batches, one step after the other
        (the interval actions fire after the group)."""
        for ids in ids_list:
            self._train_step(ids)

    def _run_group(self, group):
        """A group of (batch, view ids): a full group of steps_per_call > 1
        through ``run_scanned_batches``, else batch by batch, as the JAX
        Trainer calls its scanned and single steps."""
        ids_list = [ids for _, ids in group]
        if len(ids_list) == self.steps_per_call > 1:
            self.run_scanned_batches(ids_list)
        else:
            for ids in ids_list:
                self.run_single_batch_train(ids)

    def _drain_losses(self):
        """Pull the window's losses in one transfer and feed the meters.
        time/img is the window's wall-clock per real view, interval work
        included."""
        if not self._loss_buffer:
            return
        buf, self._loss_buffer = self._loss_buffer, []
        rows = torch.stack([v for v, _ in buf]).cpu().numpy()
        dt_img = (time.time() - self._window_t0) / max(self._window_imgs, 1)
        for vec, (_, n_real) in zip(rows, buf):
            self.train_metrics.update(
                {"time/img": dt_img,
                 **{f"loss_{k}": float(v) for k, v in zip(self._loss_keys, vec)}},
                N=n_real)
        self._window_t0 = time.time()
        self._window_imgs = 0

    # ------------------------------------------------------------------

    @use_seed()
    def run(self):
        self._host.run(self._run)

    def _run(self):
        self.cur_epoch = self.epoch_start
        self.log_visualizations((self.epoch_start - 1) * self.n_batches + self.batch_start)
        for epoch in range(self.epoch_start, self.n_epoches + 1):
            self.cur_epoch = epoch
            for group, it, do_log, do_val in epoch_groups(self, epoch,
                                                          self.train_loader.iter_indices()):
                self._run_group(group)
                last_batch = group[-1][0]
                if do_log:
                    self.log_train_metrics(it, epoch, last_batch)
                if do_val:
                    self.run_val_and_log(it, epoch, last_batch)
                    self.log_visualizations(it)
                    self.save(epoch=epoch, batch=last_batch)
            if epoch != self.n_epoches:
                self.step(epoch + 1)
            if epoch in self.save_epoches:
                self.save(epoch=epoch, batch=self.n_batches, checkpoint=True)

        if self.with_training:
            N, B = self.n_epoches, self.n_batches
        else:  # an eval-only resume of a finished run keeps its cursor
            N, B = self.epoch_start - 1, self.n_batches
        self._drain_losses()
        self.save(epoch=N, batch=B)
        self.save_metric_plots()
        self.evaluate()
        self._host.join()
        print_log("Training over")

    def step(self, epoch):
        lr = self.scheduler.lrs(epoch - 1)["main"]
        if lr != self.cur_lr:
            self.cur_lr = lr
            print_log(LOG_FMT(epoch, self.n_epoches, 1, self.n_batches,
                              f"LR update: lr={lr}"))

    def run_val_and_log(self, it, epoch, batch):
        opacities = self.model.get_opacities(self.params).cpu().numpy()
        if (opacities > 0.01).sum() == 0:
            raise RuntimeError("No more blocks....")
        self.val_metrics.update({f"alpha{k}": float(a) for k, a in enumerate(opacities)})
        print_log(LOG_FMT(epoch, self.n_epoches, batch, self.n_batches,
                          f"val_metrics: {self.val_metrics}")[:1000])
        colors = (fancy_colormap(np.linspace(0, 1, len(opacities) + 1)[1:])
                  * 255).astype(np.uint8)
        values = self.val_metrics.get_named_values()
        self._host.submit(lambda: self.visualizer.upload_lineplot(
            it, values, title="opacities", colors=colors))
        self.val_metrics.log_and_reset(it=it, epoch=epoch, batch=batch)

    def log_train_metrics(self, it, epoch, batch):
        self._drain_losses()
        print_log(LOG_FMT(epoch, self.n_epoches, batch, self.n_batches,
                          f"train_metrics: {self.train_metrics}")[:1000])
        values = self.train_metrics.get_named_values(lambda s: "loss" in s)
        self._host.submit(lambda: self.visualizer.upload_lineplot(
            it, values, title="train_losses"))
        self.train_metrics.log_and_reset(it=it, epoch=epoch, batch=batch)

    # ------------------------------------------------------------------

    @torch.no_grad()
    def viz_images(self):
        """The four viz streams of the viz samples, uint8 on the host: the
        soft reconstruction with the blocks' wireframe, the hard-filtered
        reconstruction, the synthetic-color render and the texture grid."""
        model, params = self.model, self.params
        epoch = getattr(self, "cur_epoch", self.epoch_start) - 1
        phase = model.phase_for_epoch(epoch, training=False)
        R, T = self._viz_R, self._viz_T
        rec = model.predict(params, phase, R, T)[0]
        scene, _, _ = model.build_scene(params, phase)
        rec = model.renderer_viz.draw_edges(rec, scene, R, T,
                                            model.get_scene_face_colors(params))
        rec2 = model.predict(params, replace(phase, filter_transparent=True), R, T)[0]
        rec3 = model.predict_synthetic(params, phase, R, T)
        txt = model.get_arranged_block_txt(params)
        return [to_u8(x).cpu().numpy() for x in (rec, rec2, rec3, txt)]

    def log_visualizations(self, cur_iter):
        """Render the viz streams; their encoding and writing run on the
        host worker."""
        rec, rec2, rec3, txt = self.viz_images()
        gt = self._viz_gt_u8

        def _host():
            for r, logger, title in ((rec, self.rec_logger, "recons"),
                                     (rec2, self.rec2_logger, "recons_hard"),
                                     (rec3, self.rec3_logger, "recons_syn")):
                logger.save(r, cur_iter)
                self.visualizer.upload_images(
                    np.stack([gt, r], 1).reshape(-1, *gt.shape[1:]), title, 2)
            self.txt_logger.save(txt[None], cur_iter)
            self.visualizer.upload_images(txt[None], "textures", 1, max_size=256)

        self._host.submit(_host)

    # ------------------------------------------------------------------

    def save(self, epoch, batch, checkpoint=False):
        """Checkpoint ``model.pkl`` (``model_<epoch>.pkl`` with
        ``checkpoint``): a detached copy of the parameters and the Adam
        state, written by the host worker."""
        name = f"model_{epoch}.pkl" if checkpoint else "model.pkl"
        path = self.run_dir / name
        snap = ck.snapshot(self.params, self.optimizer)
        model_kwargs = self.cfg.get("model", {})

        def _write():
            ck.write_snapshot(path, snap, epoch, batch, model_kwargs=model_kwargs)
            print_log(f"Model saved at {path}")

        self._host.submit(_write, fatal=True)

    def save_metric_plots(self):
        """Loss and opacity plots (without matplotlib: none, as in the JAX
        package), the final viz frames and the viz streams' videos."""
        from ..utils.plot import plot_lines

        log = self.train_metrics.read_log()
        if not len(log.get("iteration", ())):
            print_log("No metrics or plots to save")
            return
        fig = plot_lines(log, [c for c in log if "loss" in c], title="Loss")
        if fig is not None:
            fig.savefig(self.run_dir / "loss.pdf")
        vlog = self.val_metrics.read_log()
        alpha_names = [c for c in vlog if "alpha" in c]
        if alpha_names:
            colors = fancy_colormap(np.linspace(0, 1, len(alpha_names) + 1)[1:])
            fig = plot_lines(vlog, alpha_names, title="Opacity", colors=colors)
            if fig is not None:
                fig.savefig(self.run_dir / "opacity.pdf")
        self.log_visualizations(None)
        self._host.join()  # every frame on disk before the videos
        for logger in (self.rec_logger, self.rec2_logger, self.rec3_logger,
                       self.txt_logger):
            logger.save_video(rmtree=LIGHT_MEMORY_RESULTS)
        print_log("Metrics and plots saved")

    def evaluate(self):
        """The final evaluation; a DTU scan read from a configured
        ``dataset.root`` is scored against that root's ObsMask and STL
        points (else against ``datasets/DTU``)."""
        from ..eval.full import evaluate_run

        root = self.cfg["dataset"].get("root")
        kw = {"dtu_dir": root} if root else {}
        evaluate_run(self.model, self.params, self.test_loader, self.dataset,
                     self.run_dir, quali_kwargs=self.eval_kwargs or None, **kw)
        print_log("Evaluation over")


def main(argv=None):
    parser = argparse.ArgumentParser(
        description="Optimize a Differentiable Blocks World scene from a YML config")
    parser.add_argument("-t", "--tag", type=str, required=True)
    parser.add_argument("-c", "--config", type=str, required=True)
    parser.add_argument("-d", "--default", type=str, default=None)
    parser.add_argument("--cpu", action="store_true",
                        help="run on the CPU (default: the CUDA card)")
    args = parser.parse_args(argv)
    device = resolve_device("cpu" if args.cpu else DEFAULT_DEVICE)
    default_path = CONFIGS_PATH / args.default if args.default else None
    cfg = load_yaml(CONFIGS_PATH / args.config, default_path)
    seed = cfg["training"].get("seed", 4321)
    run_dir = path_mkdir(RUNS_PATH / cfg["dataset"]["name"] / args.tag)
    create_logger(run_dir)
    dump_yaml(cfg, run_dir / Path(args.config).name)
    print_log(f"Trainer init: config_file={args.config}, run_dir={run_dir}, "
              f"device={device}")
    trainer = Trainer(cfg, run_dir, device=device, seed=seed)
    trainer.run(seed=seed)


if __name__ == "__main__":
    main()
