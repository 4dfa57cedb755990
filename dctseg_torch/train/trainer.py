"""Training loop: the train step with gradient accumulation, train-time
metrics, checkpoints, resume and preemption (the JAX package's
``dctseg/train/trainer.py``), on one device or one process per GPU.

Several processes (``parallel/``) form a (data, space) mesh.  The model is
wrapped in ``DistributedDataParallel`` over all of them; each data shard
loads its own rows (``shard = rank // space``), the space ranks of a shard
the same rows, whose D axis they share (``parallel/spatial.py``).  The
loss runs over the global batch, as the JAX step's does over its sharded
batch: its batch sums are all-reduced over the data group
(``losses.batch_group``), so every rank holds the same loss, and DDP's
average over all ranks gives each parameter the global batch's gradient
(the scale rule is in ``parallel/spatial.py``).  The stop is agreed: a MAX
all-reduce of each rank's stop flag at the top of every step.  The primary
rank saves; every rank meets it at a barrier after each save.  A rank's
dropout generator is seeded with ``seed + data index``: the space ranks of
a shard draw the same masks.

bf16 training is the model's ``compute_dtype='bfloat16'``: parameters stay
float32 and are cast at each call, as flax's ``dtype=bf16`` does; there is
no autocast and no GradScaler (bf16 has float32's exponent range).

Spans (``utils/profiling.py`` ``span``, recorded only while a profiler
runs): ``train_step`` is the root ``dctseg.trainer.step``; its children
are ``trainer.forward`` (the model and the loss) and ``trainer.backward``
once per micro-batch, and ``trainer.optimizer`` twice
(``zero_grad`` first; the learning rate and ``optimizer.step`` last).  The
root's own time is the rest: the labels' widening, the argmax and the
metrics.  The step loop's wait for its next device batch is
``trainer.batch_wait`` (``Trainer._device_batches``): one a batch, and one
at the epoch's end, the wait that finds no batch.
"""

from __future__ import annotations

import contextlib
import logging
import os
import queue
import signal
import threading
import time
from typing import Callable, Dict, Optional

import torch
import torch.distributed as dist

from dctseg_torch import losses
from dctseg_torch.config import Config
from dctseg_torch.data.brats import BraTSDataset
from dctseg_torch.data.pipeline import PrefetchLoader
from dctseg_torch.device import resolve_device
from dctseg_torch.losses import CRITERIA, total_loss
from dctseg_torch.models.clswiseformer import ClsWiseFormer, build_model
from dctseg_torch.parallel import distributed, spatial
from dctseg_torch.parallel.mesh import Mesh, data_size, make_mesh
from dctseg_torch.train.checkpoint import Checkpointer, should_save
from dctseg_torch.train.optim import make_optimizer, make_schedule, set_lr
from dctseg_torch.utils.logging_utils import LOGGER
from dctseg_torch.utils.profiling import span

logger = logging.getLogger(LOGGER)

_JOIN_TIMEOUT_S = 30.0


def _dice_sums(o: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    o, t = o.float(), t.float()
    return torch.stack([(o * t).sum(), o.sum(), t.sum()])


def train_metrics(comp: Dict[str, torch.Tensor], pred: torch.Tensor,
                  target: torch.Tensor, num_classes: int, group=None,
                  eps: float = 1e-8) -> Dict[str, torch.Tensor]:
    """The loss components plus the reference's train-time checks, on the
    device: predicted voxels per class and the WT/TC/ET Dice of the argmax
    against the target, over the rows of every rank of ``group`` (the data
    group; None: these rows)."""
    m = {k: v.detach() for k, v in comp.items()}
    counts = torch.stack([(pred == c).sum() for c in range(num_classes)])
    sums = torch.stack([
        _dice_sums(pred > 0, target > 0),
        _dice_sums((pred == 1) | (pred == 3), (target == 1) | (target == 3)),
        _dice_sums(pred == 3, target == 3)])
    if group is not None:
        counts = spatial.all_reduce(counts, group)
        sums = spatial.all_reduce(sums, group)
    m["pred_counts"] = counts
    dice = (2 * sums[:, 0] + eps) / (sums[:, 1] + sums[:, 2] + eps)
    m["dice_wt"], m["dice_tc"], m["dice_et"] = dice
    return m


def train_step(model: torch.nn.Module, optimizer: torch.optim.Optimizer,
               lr: float, x: torch.Tensor, target: torch.Tensor,
               edge: torch.Tensor, criterion: Callable = CRITERIA[
                   "softmax_dice"], grad_accum: int = 1,
               generator: Optional[torch.Generator] = None,
               mesh: Optional[Mesh] = None) -> Dict[str, torch.Tensor]:
    """One optimizer step at learning rate ``lr``; returns the metrics as
    device tensors (not waited for).

    ``grad_accum`` splits the batch into micro-batches run one after the
    other, micro-batch j taking rows r with r % grad_accum == j; their
    gradients and loss components are averaged before the one update.
    Labels arrive as uint8 and are widened here, on the device.

    ``model`` is a ClsWiseFormer, or one wrapped in
    ``DistributedDataParallel`` over the processes of ``mesh``: each rank
    then passes its rows (the whole samples; the model runs its slab of D
    on a space axis), the loss runs over the global batch, and DDP
    averages the gradients, once per step (``no_sync`` on all micro-batches
    but the last)."""
    ga = grad_accum
    if x.shape[0] % ga:
        raise ValueError(f"batch {x.shape[0]} not divisible by grad_accum "
                         f"{ga}")
    module = getattr(model, "module", model)
    shard = spatial.space_shard(mesh)
    group = None if mesh is None else mesh.data_group
    with span("trainer.step"):
        target, edge = target.long(), edge.long()
        with span("trainer.optimizer"):
            optimizer.zero_grad(set_to_none=True)
        comps, pred = [], torch.empty(target.shape, dtype=torch.long,
                                      device=target.device)
        for j in range(ga):
            sync = (model.no_sync() if j < ga - 1
                    and hasattr(model, "no_sync")
                    else contextlib.nullcontext())
            with sync, spatial.sharded(shard), losses.batch_group(group):
                with span("trainer.forward"):
                    outs = model(x[j::ga], train=True, generator=generator)
                    comp = total_loss(outs, target[j::ga], edge[j::ga],
                                      criterion)
                with span("trainer.backward"):
                    (comp["loss"] / ga if ga > 1 else comp["loss"]).backward()
            comps.append({k: v.detach() for k, v in comp.items()})
            pred[j::ga] = outs[0].detach().argmax(dim=-1)
            del outs, comp
        with span("trainer.optimizer"):
            set_lr(optimizer, lr)
            optimizer.step()
        comp = {k: sum(c[k] for c in comps) / ga for k in comps[0]}
        return train_metrics(comp, pred, target, module.cfg.num_classes,
                             group)


class Trainer:
    """The training driver (the reference's main_worker) on one device,
    the GPU unless ``device`` says otherwise; in a process group, on this
    process's device and the (data, space) ``mesh`` (default: one made from
    ``cfg.train.num_devices`` and ``spatial_shards``)."""

    def __init__(self, cfg: Config, dataset: Optional[BraTSDataset] = None,
                 device=None, mesh: Optional[Mesh] = None):
        if cfg.model.fused_norms:
            raise ValueError(
                "ModelConfig.fused_norms is an inference-only execution "
                "strategy (the norm kernel has no backward); train with the "
                "plain norms")
        # rounding has a zero gradient: a quantized step would stop learning
        # through every quantized conv
        if cfg.model.quantize != "none":
            raise ValueError(
                "ModelConfig.quantize is an inference-only execution "
                "strategy; train in float/bf16 and quantize at eval")
        if cfg.train.batch_size % cfg.train.grad_accum:
            raise ValueError(f"batch {cfg.train.batch_size} not divisible by "
                             f"grad_accum {cfg.train.grad_accum}")
        if cfg.train.criterion not in CRITERIA:
            raise ValueError(f"unknown criterion {cfg.train.criterion!r}")
        self.cfg = cfg
        self.device = resolve_device(device)
        self.mesh = mesh if mesh is not None else make_mesh(
            cfg.train.num_devices, cfg.train.spatial_shards)
        # the batch scales with the data shards; the space ranks of a
        # shard share its samples' D axis
        self.num_devices = data_size(self.mesh)
        self.global_batch = cfg.train.batch_size * self.num_devices
        self.dataset = dataset if dataset is not None else BraTSDataset(
            list_file=(cfg.data.root
                       and os.path.join(cfg.data.root, cfg.data.train_file)),
            root=cfg.data.root, mode="train",
            drop_modal=cfg.data.drop_modal, cfg=cfg.data)
        self.loader = PrefetchLoader(
            self.dataset, batch_size=cfg.train.batch_size,
            shard=self.mesh.data_index, num_shards=self.mesh.data,
            shuffle=True, num_workers=cfg.data.num_workers,
            prefetch=cfg.data.prefetch, seed=cfg.train.seed)
        self.steps_per_epoch = max(1, len(self.loader))
        self.schedule = make_schedule(cfg.train, self.steps_per_epoch)
        self.criterion = CRITERIA[cfg.train.criterion]
        self.ckpt = Checkpointer(cfg.train.checkpoint_dir)
        self.model: Optional[ClsWiseFormer] = None
        # the model, or its DistributedDataParallel over the mesh
        self.net: Optional[torch.nn.Module] = None
        self.optimizer: Optional[torch.optim.Adam] = None
        self.step = 0
        self.generator = torch.Generator(device=self.device).manual_seed(
            cfg.train.seed + self.mesh.data_index)
        self._preempt = threading.Event()
        self.preempted = False  # set by fit() after an early exit

    # ---- state init / resume ----

    def init_state(self) -> None:
        """Fresh parameters from the seed, a fresh optimizer, step 0."""
        self.model = build_model(
            self.cfg.model, device=self.device,
            generator=torch.Generator().manual_seed(self.cfg.train.seed))
        self.optimizer = make_optimizer(self.model.parameters(),
                                        self.cfg.train)
        self.net = self.model
        if dist.is_initialized():
            # in a process group (even of one), DDP over all of it
            from torch.nn.parallel import DistributedDataParallel
            self.net = DistributedDataParallel(
                self.model, device_ids=([self.device.index]
                                        if self.device.type == "cuda"
                                        else None),
                broadcast_buffers=False)
        self.step = 0

    def resume(self, epoch: Optional[int] = None, restore_opt: bool = False,
               from_dir: Optional[str] = None) -> int:
        """Restore a checkpoint; returns the epoch to continue from.

        By default the parameters only, as the reference does: the optimizer
        stays fresh, but the LR schedule and the step are seeded at
        ``start_epoch * steps_per_epoch``.  ``restore_opt`` restores the
        optimizer state and step too, and re-runs an epoch whose save was
        partial.  ``from_dir`` reads another directory than the one this
        trainer saves to."""
        if self.optimizer is None:
            self.init_state()
        src = self.ckpt
        if from_dir and os.path.abspath(from_dir) != self.ckpt.directory:
            src = Checkpointer(from_dir)
        epoch = epoch if epoch is not None else src.latest_epoch()
        if epoch is None:
            logger.info("re-training!!!")
            return self.cfg.train.start_epoch
        if restore_opt:
            sd, od, meta = src.restore_full(epoch)
            self.model.load_state_dict(sd, strict=True)
            self.optimizer.load_state_dict(od)
            self.step = meta["step"]
            logger.info("restored full state from epoch %s", epoch)
            return meta["epoch"] + (0 if meta["partial"] else 1)
        self.model.load_state_dict(src.restore_params(epoch), strict=True)
        start = self.cfg.train.start_epoch
        self.step = start * self.steps_per_epoch
        logger.info("restored params from epoch %s (dir=%s), LR seeded at "
                    "epoch %d", epoch, src.directory, start)
        return start

    def save(self, epoch: int, partial: bool = False) -> Optional[str]:
        """The primary rank writes the epoch's file (its path; None on the
        other ranks), then every rank meets at a barrier."""
        path = None
        if distributed.is_primary():
            path = self.ckpt.save(epoch, self.model.state_dict(),
                                  self.optimizer.state_dict(), self.step,
                                  partial=partial)
        distributed.barrier("dctseg:checkpoint_saved")
        return path

    # ---- preemption ----

    def request_stop(self) -> None:
        """Stop after the in-flight step; fit() then saves a full checkpoint
        (parameters, optimizer state, step) and returns.  Thread- and
        signal-safe."""
        self._preempt.set()

    def _should_stop(self) -> bool:
        """The stop decision at the top of each step, agreed by all ranks:
        a MAX all-reduce of the local flags, so that every rank breaks at
        the same step (a rank that broke alone would leave the others in
        a gradient all-reduce).  A rank whose own request never came is
        pulled along through request_stop, so that fit() saves on all."""
        local = self._preempt.is_set()
        if distributed.world_size() <= 1:
            return local
        flag = torch.tensor([int(local)], device=self.device)
        dist.all_reduce(flag, op=dist.ReduceOp.MAX)
        anyrank = bool(flag.item())
        if anyrank and not local:
            self.request_stop()
        return anyrank

    @contextlib.contextmanager
    def _signal_guard(self):
        """Route SIGTERM/SIGINT to request_stop during fit().  The previous
        handler comes back on the first signal (a second one kills) and on
        exit.  Installed only from the main thread."""
        if (not self.cfg.train.preempt_save
                or threading.current_thread() is not threading.main_thread()):
            yield
            return
        prev = {}

        def handler(sig, frame):
            self.request_stop()
            signal.signal(sig, prev[sig])
            logger.info("signal %s: will checkpoint and exit after the "
                        "in-flight step (again to force-kill)", sig)

        for sig in (signal.SIGTERM, signal.SIGINT):
            prev[sig] = signal.signal(sig, handler)
        try:
            yield
        finally:
            for sig, h in prev.items():
                if signal.getsignal(sig) is handler:
                    signal.signal(sig, h)

    # ---- batches ----

    def _place(self, batch, stream=None):
        """(x, target, edge) of a loader batch on the device.  On the GPU
        the copies run on ``stream`` from pinned memory and an event marks
        their end."""
        parts = (batch.x, torch.from_numpy(batch.target),
                 torch.from_numpy(batch.edge))
        if self.device.type != "cuda":
            return tuple(p.to(self.device) for p in parts), None
        with torch.cuda.stream(stream):
            out = tuple(p.pin_memory().to(self.device, non_blocking=True)
                        for p in parts)
            done = torch.cuda.Event()
            done.record()
        return out, done

    def _device_batches(self):
        """Iterate device-resident (x, target, edge).  With
        ``device_prefetch > 0`` a feeder thread stages the next batches'
        host-to-device copies on a side stream while the current step runs;
        the queue bounds them to ``device_prefetch`` batches ahead."""
        depth = self.cfg.train.device_prefetch
        end = object()
        if depth <= 0:
            batches = iter(self.loader)
            stream = (torch.cuda.current_stream()
                      if self.device.type == "cuda" else None)
            while True:
                with span("trainer.batch_wait"):
                    batch = next(batches, end)
                    if batch is end:
                        return
                    tensors = self._place(batch, stream)[0]
                yield tensors
        side = (torch.cuda.Stream(device=self.device)
                if self.device.type == "cuda" else None)
        # the feeder thread copies on this device (the current one where
        # the device carries no index)
        index = (None if side is None else self.device.index
                 if self.device.index is not None
                 else torch.cuda.current_device())
        q: "queue.Queue" = queue.Queue(maxsize=depth)
        stop = threading.Event()   # the consumer has gone

        def put(item) -> bool:
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    pass
            return False

        def feeder():
            try:
                if side is not None:
                    torch.cuda.set_device(index)
                for batch in self.loader:
                    if not put(self._place(batch, side)):
                        return
                put(end)
            except BaseException as e:  # re-raised in the train loop
                put(e)

        t = threading.Thread(target=feeder, daemon=True,
                             name="dctseg-batch-feeder")
        t.start()
        try:
            while True:
                with span("trainer.batch_wait"):
                    item = q.get()
                    if item is end:
                        break
                    if isinstance(item, BaseException):
                        raise item
                    tensors, done = item
                    if done is not None:
                        cur = torch.cuda.current_stream()
                        cur.wait_event(done)
                        for a in tensors:
                            a.record_stream(cur)
                yield tensors
        finally:
            stop.set()
            t.join(timeout=_JOIN_TIMEOUT_S)
            if t.is_alive():
                logger.warning("batch feeder did not stop within %.0f s",
                               _JOIN_TIMEOUT_S)

    # ---- the loop ----

    def train_step(self, x, target, edge) -> Dict[str, torch.Tensor]:
        metrics = train_step(self.net, self.optimizer,
                             self.schedule(self.step), x, target, edge,
                             self.criterion, self.cfg.train.grad_accum,
                             self.generator, self.mesh)
        self.step += 1
        return metrics

    def train_epoch(self, epoch: int) -> Dict[str, float]:
        self.loader.set_epoch(epoch)
        last = {}
        pending = None          # (iter, device metrics) of the previous step

        def log(i, metrics):
            m = {k: v.tolist() for k, v in metrics.items()}
            logger.info(
                "Epoch: %d_Iter:%d  loss: %.5f || end_loss: %.5f || "
                "s_loss:%.4f || edge_loss:%.4f || mid_s_loss:%.4f || "
                "mid_edge_loss:%.4f ||", epoch, i, m["loss"], m["end_loss"],
                m["s_loss"], m["edge_loss"], m["mid_s_loss"],
                m["mid_edge_loss"])
            logger.info("epoch:%d, DICE= WT:%.4f,TC:%.4f,ET:%.4f  counts=%s",
                        epoch, m["dice_wt"], m["dice_tc"], m["dice_et"],
                        m["pred_counts"])
            return m

        for i, (x, tgt, edg) in enumerate(self._device_batches()):
            if self._should_stop():
                break
            metrics = self.train_step(x, tgt, edg)
            # log one step late: step i+1 is queued on the device before
            # the host waits for step i's metrics
            if pending is not None:
                last = log(*pending)
            pending = ((i, metrics) if i % self.cfg.train.log_every == 0
                       else None)
        if pending is not None:
            last = log(*pending)
        return last

    def fit(self, eval_fn: Optional[Callable] = None) -> Dict[str, float]:
        """The whole training loop.  ``eval_fn(trainer, epoch)`` runs at
        every checkpoint save."""
        with self._signal_guard():
            return self._fit(eval_fn)

    def _fit(self, eval_fn: Optional[Callable]) -> Dict[str, float]:
        cfg = self.cfg.train
        start = cfg.start_epoch
        if self.optimizer is None:
            if cfg.resume:
                start = self.resume(from_dir=cfg.resume,
                                    restore_opt=cfg.restore_opt)
            else:
                self.init_state()
        t0 = time.time()
        last = {}
        for epoch in range(start, cfg.end_epoch):
            te = time.time()
            # an epoch stopped before its first step keeps the last metrics
            last = self.train_epoch(epoch) or last
            logger.info("epoch %d done in %.1fs", epoch, time.time() - te)
            if self._preempt.is_set():
                # a stop after the epoch's last step interrupted nothing:
                # partial only when steps remain
                partial = self.step < (epoch + 1) * self.steps_per_epoch
                self.save(epoch, partial=partial)
                self.preempted = True
                logger.info("preempted: full state saved at epoch %d step "
                            "%d (%s); resume with restore_opt", epoch,
                            self.step,
                            "mid-epoch" if partial else "epoch complete")
                return last
            if should_save(epoch, cfg.save_freq, cfg.end_epoch):
                self.save(epoch)
                if eval_fn is not None:
                    eval_fn(self, epoch)
        self.save(cfg.end_epoch)
        logger.info("The total training time is %.2f hours",
                    (time.time() - t0) / 3600)
        return last
