"""One rank of the port's multi-process CPU tests
(``tests/test_torch_parallel*.py``): it joins a gloo group through a
FileStore, runs the jobs its case names on the tiny models, and writes what
the parent compares to ``<out>/rank<r>.pt``.  It imports no JAX (the JAX oracle runs in the
parent); the parent starts a case's ranks with :func:`start_case`, computes
its JAX oracles while they run, and collects them with :func:`finish_case`.

    python tests/torch_dist_worker.py CASE RANK OUT

:data:`CASES` gives each case's world size, space axis and jobs.  The
inputs and weights come from ``<out>/inputs.pt`` (the parent writes them,
:func:`start_case`); the store is ``<out>/store``.
"""

import os
import sys

import torch

torch.set_num_threads(1)

REPO = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
sys.path.insert(0, REPO)

from dctseg_torch.config import (Config, DataConfig,  # noqa: E402
                                 TrainConfig, tiny_model_config)
from dctseg_torch.infer.engine import Predictor  # noqa: E402
from dctseg_torch.models.clswiseformer import build_model  # noqa: E402
from dctseg_torch.ops import quant  # noqa: E402
from dctseg_torch.parallel import distributed, mesh, spatial  # noqa: E402
from dctseg_torch.train import optim  # noqa: E402
from dctseg_torch.train.trainer import Trainer, train_step  # noqa: E402

# the tiny training model (img_dim 16, s2d at both resolutions, plain
# norms: the train driver's configuration)
TRAIN_MODEL = dict(img_dim=16, top_num=2, s2d_fullres=True,
                   s2d_halfres=True, fused_norms=False,
                   use_pallas_attention=False)


def train_config(ckpt: str, samples: int, **train_kw) -> Config:
    kw = dict(end_epoch=1, save_freq=1000, lr=1e-3, checkpoint_dir=ckpt)
    kw.update(train_kw)
    return Config(
        model=tiny_model_config(**TRAIN_MODEL),
        data=DataConfig(synthetic_num_samples=samples,
                        input_shape=(24, 24, 20), pad_depth=20,
                        crop_size=(16, 16, 16), num_workers=1),
        train=TrainConfig(**kw))


def job_mesh(m, inp):
    """This rank's place on the mesh and its groups' members."""
    import torch.distributed as dist

    def members(g):
        return None if g is None else dist.get_process_group_ranks(g)
    return {"shape": m.shape, "data_index": m.data_index,
            "space_index": m.space_index, "data_group": members(m.data_group),
            "space_group": members(m.space_group), "group": members(m.group)}


def job_halo(m, inp):
    """A 3^3 conv of strides 1 and 2 on D slabs (and its gradients),
    against the same conv on the whole tensor (computed in the parent)."""
    shard = spatial.space_shard(m)
    out = {}
    for stride in (1, 2):
        x = inp["halo_x"].clone().requires_grad_()
        w = inp["halo_w"].clone().requires_grad_()
        with spatial.sharded(shard):
            y = spatial.conv3d(spatial.split(x, shard), w, None, stride,
                               (1, 1))
        y = spatial.gather(y, shard)
        (y * inp[f"halo_r{stride}"]).sum().backward()
        # each rank holds S times its slab's share of dW (the scale rule of
        # parallel/spatial.py); the group's mean is the whole gradient
        dw = spatial.all_reduce(w.grad, shard.group) / shard.size
        out[stride] = {"y": y.detach(), "dx": x.grad, "dw": dw}
    return out


def part_of(m, rank: int, shape) -> tuple:
    """The (rows, planes) of a (B, D, ...) tensor that ``rank`` of ``m``'s
    shape holds."""
    r = mesh.Mesh(m.data, m.space, rank)
    d = shape[1] // m.space
    return (mesh.batch_rows(r, shape[0]),
            slice(r.space_index * d, (r.space_index + 1) * d))


def job_scale(m, inp):
    """Each rank quantizes its rows and slab of one seeded tensor with the
    mesh's scale: by K7's amax route, and by per-sample slots as a fused
    norm reports them, each MAX-reduced over every rank, then from_amax
    (the plain versions here); f32 and bf16, and with a NaN planted in
    rank 1's part."""
    x = inp["scale_x"]
    rows, planes = part_of(m, m.rank, x.shape)
    nan_rows, nan_planes = part_of(m, 1, x.shape)
    out = {}
    for dt in (torch.float32, torch.bfloat16):
        for plant in ("randn", "nan"):
            whole = x.to(dt, copy=True)
            if plant == "nan":
                whole[nan_rows.start, nan_planes.start, 1, 2, 3] = float("nan")
            part = whole[rows, planes].contiguous()
            slots = part.reshape(part.shape[0], -1).float().abs().amax(dim=1)
            with spatial.sharded(spatial.space_shard(m)), \
                    spatial.scaled(m.group):
                out[str(dt), plant] = {
                    "amax_route": quant.quantize_input(part),
                    "slots": quant.quantize_input(part, slots)}
    return out


# the int8 convs of a D slab: (kernel, stride, padding), as the model
# runs them (the s2d down route: a 2^3 kernel, padding (1, 0))
INT8_CONVS = {"conv3_s1": (3, 1, 1), "conv3_s2": (3, 2, 1), "pw": (1, 1, 0),
              "s2d_down": (2, 1, (1, 0))}


def job_int8_conv(m, inp):
    """The int8 convs of INT8_CONVS on this rank's D slab of one tensor,
    quantized with the whole tensor's scale: the int8 halo exchanged, then
    K6's plain version; the slabs' outputs gathered."""
    shard = spatial.space_shard(m)
    x = inp["conv_x"]
    xq, stats = quant.quantize_absmax_plain(x)
    _, planes = part_of(m, m.rank, x.shape)
    out = {}
    for name, (k, stride, padding) in INT8_CONVS.items():
        wq, sw = quant.prepare_weight(inp[f"conv_w{k}"])
        with spatial.sharded(shard), spatial.scaled(m.group):
            y = quant.conv3d_int8_prepared(
                x[:, planes].contiguous(), wq, sw, stride, padding,
                inp["conv_b"], quantized=(xq[:, planes].contiguous(), stats))
            out[name] = spatial.gather(y, shard)
    return out


def _forward(m, inp, x_key, engines, **cfg):
    """The tiny model (fused norms, the attention kernel's plain version)
    under ``cfg`` through Predictor(mesh): each of ``engines`` on
    ``inp[x_key]``; and under int8 the K6 calls and every K7 call's stats
    of the first engine."""
    model = build_model(tiny_model_config(fused_norms=True,
                                          use_pallas_attention=True, **cfg),
                        device="cpu")
    model.load_state_dict(inp["fwd_weights"], strict=True)
    p = Predictor(model, device="cpu", mesh=m)
    stats, convs = [], []
    conv_orig, input_orig = quant.int8_conv3d, quant.quantize_input

    def conv(*a, **kw):
        convs.append(1)
        return conv_orig(*a, **kw)

    def quantize(*a, **kw):
        xq, s = input_orig(*a, **kw)
        stats.append(s)
        return xq, s
    quant.int8_conv3d, quant.quantize_input = conv, quantize
    try:
        res = {engines[0]: getattr(p, engines[0])(inp[x_key])}
    finally:
        quant.int8_conv3d, quant.quantize_input = conv_orig, input_orig
    for e in engines[1:]:
        res[e] = getattr(p, e)(inp["fwd_x1"])
    if convs:
        res.update(convs=len(convs), stats=torch.stack(stats))
    return res


def job_forward(m, inp):
    """Predictor(mesh) seg_probs on a B=8 batch and tta_probs on one
    volume, the tiny direct model, float and under the int8 and int8_all
    specs (the int8 K6 calls and every K7 call's stats recorded)."""
    engines = ("seg_probs", "tta_probs")
    res = {"float": _forward(m, inp, "fwd_x8", engines)}
    for spec in ("int8", "int8_all"):
        res[spec] = _forward(m, inp, "fwd_x8", engines, quantize=spec)
    return res


def job_forward_s2d(m, inp):
    """Predictor(mesh) seg_probs of the tiny s2d model under int8."""
    return _forward(m, inp, "s2d_x", ("seg_probs",), quantize="int8",
                    s2d_fullres=True, s2d_halfres=True)


def job_grads(m, inp):
    """One train step of the tiny training model in DDP over the mesh,
    each data shard on its rows of the global batch: the loss, and every
    gradient after DDP's average."""
    model = build_model(tiny_model_config(**TRAIN_MODEL), device="cpu")
    model.load_state_dict(inp["train_weights"], strict=True)
    from torch.nn.parallel import DistributedDataParallel
    net = DistributedDataParallel(model, broadcast_buffers=False)
    tcfg = TrainConfig(lr=1e-3, end_epoch=10)
    opt = optim.make_optimizer(model.parameters(), tcfg)
    rows = slice(m.data_index, m.data_index + 1)
    metrics = train_step(net, opt, 1e-3, inp["train_x"][rows],
                         inp["train_target"][rows], inp["train_edge"][rows],
                         mesh=m)
    return {"loss": metrics["loss"].item(),
            "grads": {n: p.grad.clone()
                      for n, p in model.named_parameters()}}


def job_epoch(m, inp):
    """One Trainer epoch (global batch 2, one step) over the mesh: the
    logged metrics, for the JAX Trainer on the same mesh shape."""
    cfg = train_config(os.path.join(inp["dir"], "epoch_ckpt"), samples=2)
    tr = Trainer(cfg, device="cpu", mesh=m)
    tr.init_state()
    tr.model.load_state_dict(inp["train_weights"], strict=True)
    return {"global_batch": tr.global_batch, "steps": tr.steps_per_epoch,
            "metrics": tr.train_epoch(0)}


def job_stop(m, inp):
    """Rank 1 alone asks to stop after its first step: every rank stops
    at the same step, the primary saves a partial checkpoint, and a full
    resume from it on every rank finishes the run."""
    ckpt = os.path.join(inp["dir"], "stop_ckpt")
    tr = Trainer(train_config(ckpt, samples=4, end_epoch=2), device="cpu",
                 mesh=m)
    step = tr.train_step

    def train_step_then_ask(*args):
        out = step(*args)
        if m.rank == 1:
            tr.request_stop()
        return out
    tr.train_step = train_step_then_ask
    tr.fit()
    stopped = {"step": tr.step, "preempted": tr.preempted,
               "files": sorted(os.listdir(ckpt))}
    tr2 = Trainer(train_config(ckpt, samples=4, end_epoch=2, resume=ckpt,
                               restore_opt=True), device="cpu", mesh=m)
    tr2.fit()
    return {"stopped": stopped, "resumed_step": tr2.step,
            "params": {k: v.clone() for k, v in
                       tr2.model.state_dict().items()}}


JOBS = {"mesh": job_mesh, "halo": job_halo, "forward": job_forward,
        "scale": job_scale, "int8_conv": job_int8_conv,
        "forward_s2d": job_forward_s2d, "grads": job_grads,
        "epoch": job_epoch, "stop": job_stop}
# case: (world, spatial, jobs)
CASES = {"fwd_data2_space2": (4, 2, ("mesh", "halo", "scale", "int8_conv",
                                     "forward", "forward_s2d")),
         "fwd_space4": (4, 4, ("mesh", "halo", "scale", "int8_conv",
                               "forward")),
         "train_data2_space2": (4, 2, ("grads", "epoch")),
         "train_data2": (2, 1, ("mesh", "grads", "stop"))}


# ---- the parent's side ----

def child_env() -> dict:
    """The environment of a worker or driver process: no JAX or torchrun
    settings, one OpenMP thread, the repo on the path."""
    env = {k: v for k, v in os.environ.items()
           if k not in ("XLA_FLAGS", "JAX_PLATFORMS", "MASTER_ADDR",
                        "MASTER_PORT", "RANK", "WORLD_SIZE", "LOCAL_RANK")}
    env.update(OMP_NUM_THREADS="1", PYTHONPATH=REPO)
    return env


def wait(procs, timeout: float = 600):
    """(return codes, output logs) of processes started with their output
    piped."""
    logs = [p.communicate(timeout=timeout)[0].decode() for p in procs]
    return [p.returncode for p in procs], logs


def start_case(case: str, inputs: dict, out: str) -> list:
    """Start ``case``'s ranks on ``inputs``, each writing its output to
    ``<out>/rank<r>.log``; their processes, for :func:`finish_case`."""
    import subprocess
    torch.save(inputs, os.path.join(out, "inputs.pt"))
    procs = []
    for r in range(CASES[case][0]):
        with open(os.path.join(out, f"rank{r}.log"), "wb") as log:
            procs.append(subprocess.Popen(
                [sys.executable, os.path.abspath(__file__), case, str(r),
                 out], cwd=REPO, env=child_env(), stdout=log,
                stderr=subprocess.STDOUT))
    return procs


def finish_case(procs: list, out: str, timeout: float = 600) -> list:
    """Wait for the ranks :func:`start_case` started in ``out``; their
    results, in rank order."""
    for r, p in enumerate(procs):
        rc = p.wait(timeout=timeout)
        with open(os.path.join(out, f"rank{r}.log")) as log:
            assert rc == 0, log.read()[-4000:]
    return [torch.load(os.path.join(out, f"rank{r}.pt"), weights_only=False)
            for r in range(len(procs))]


def main():
    case, rank, out = sys.argv[1], int(sys.argv[2]), sys.argv[3]
    world, space, jobs = CASES[case]
    distributed.initialize(f"file://{os.path.join(out, 'store')}", world,
                           rank, device="cpu")
    m = mesh.make_mesh(world, spatial=space)
    inp = torch.load(os.path.join(out, "inputs.pt"), weights_only=False)
    inp["dir"] = out
    res = {name: JOBS[name](m, inp) for name in jobs}
    torch.save(res, os.path.join(out, f"rank{rank}.pt"))
    distributed.shutdown()


if __name__ == "__main__":
    main()
