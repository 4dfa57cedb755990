"""Inference engines: batched forward, flip TTA, sliding-window tiling,
multi-checkpoint ensembling (the JAX package's ``dctseg/infer/engine.py``).

  * The 8 flip variants of flip TTA and the 8 crops of sliding-window tiling
    each go through the model as ONE B=8 forward; the ``*_batch`` engines
    put V volumes through one B=8V forward.
  * The decoder's output is already a softmax; flip TTA softmaxes it again
    before averaging (the reference's double softmax), kept for parity.
  * Reference stitching quirk: the high-depth crops start at slice 27 but
    are stitched from ``[..., 96:123]`` into ``[..., 128:155]`` -- a 5-slice
    misalignment.  ``stitch_mode='reference'`` reproduces it; ``'aligned'``
    uses the correct ``101:128`` window.

Volumes are NDHWC.  Every engine runs under ``torch.inference_mode()``.

Fused dispatch (``Predictor(fuse_dispatch=True)``, the JAX engine's
``dctseg/infer/engine.py:55-66``): ``tiled_probs`` and ``tta_probs`` of one
volume run the crop (or flip) construction and the B=8 forward as ONE
captured CUDA graph, the counterpart of the JAX engine's one compiled
program, replayed per volume; stitch and unflip-mean stay outside it, as
the JAX engine stages them.  The first call for each input shape and dtype
warms up on a side stream and captures there; later calls copy the volume
into the graph's static input and replay.  Every graph owns its kernels'
workspaces (``ops/_build.py`` ``owned_workspaces``), and the engine's
graphs share one memory pool.  A failed capture raises.  On the CPU the
same stage runs eagerly.  The kernels' launch counters count in Python
(``ops/_build.py`` ``COUNTED``), and count what reaches the card: a graph's
warm-up counts as the eager call it is; its capture, which launches
nothing, keeps what it counted in ``_Captured.launches`` and takes it back;
every replay adds it again.

The volume's way to the card (``Predictor._input``, counted by route in
``Predictor.input_routes``): a contiguous host tensor or array that is not
pinned is read once into pinned memory from torch's caching host allocator
(``Tensor.pin_memory``: one ``copy_`` on the intra-op threads) and sent
from there by one asynchronous copy on the current stream (``staged``).
``_input`` returns once the volume is read, so the caller may overwrite it
at once; the crops wait for the copy in stream order, and the allocator
hands the pinned block out again only after the stream has passed the
copy.  A pinned tensor is one asynchronous copy (``pinned``): as with any
such copy, the caller leaves it unchanged until the stream has passed the
copy.  A tensor already on the device is returned as is (``device``); the
rest, non-contiguous host tensors and every input of a CPU Predictor, take
``Tensor.to`` as it is (``host``).  The bytes on the card are the input's,
bit for bit, whatever the route.

Measured conv algorithms (``measured_convs``): every forward of the model
(``Predictor.model_probs``, which every engine, the fused stage's warm-up
and capture and a mesh's slab forwards go through) runs with
``torch.backends.cudnn.benchmark`` on, so cuDNN times the first
``BENCHMARK_LIMIT`` candidate algorithms of each conv shape at its first
call and keeps the fastest, in place of its heuristic's first choice, with
the allocator's cache kept through the search.  The caller's
``benchmark``, ``benchmark_limit`` and cache switch are restored after the
call; every other cuDNN flag keeps the caller's value.  The search falls
on the first forward of each input shape (the volumes' warm-up in a
service; the eager warm-up before a capture, so a capture finds every plan
cached): 1.5–3 s for a full-width model's B=8 forward on an H100, nothing
after.  PyTorch caches one plan per conv shape and thread without regard
to the flag: a shape already run on the thread under the heuristic keeps
the heuristic's plan, and a thread new to a shape searches again and may
pick another algorithm (so the server runs every program on one thread).
Off cuDNN the flag does nothing.  ``Trainer`` does not autotune: an
algorithm with a larger workspace could raise the training step's peak
memory, and its step is paced by the host.

Spans (``utils/profiling.py`` ``span``, recorded only while a profiler
runs): each ``tiled_probs`` call is a root ``dctseg.engine.tiled_probs``
whose children are ``engine.input`` (the volume to the device),
``engine.forward`` (one ``_stage``: the crops and the B=8 forward, staged,
or the graph's copy-in and replay) and ``engine.stitch``
(``stitch_volume``).

Several GPUs (``Predictor(mesh=...)``, the JAX engine's mesh): every rank
of a ``parallel.mesh`` holds the same input; a forward's batch (the 8
crops or flips) splits over the ``data`` axis where it divides, each
sample's D axis over ``space`` (``parallel/spatial.py``), and the
probabilities are gathered back, so every rank returns the whole result.
Under ``quantize`` each int8 conv takes one activation scale over the
whole batch and volume, as GSPMD gives the JAX engine: the absmax slots
are MAX-reduced over every rank of the mesh (``parallel/spatial.py``
``scaled``); under ``microbatch`` each chunk takes its own, as JAX's
per-chunk forward does.  ``fuse_dispatch`` and ``fold_params`` are off
under a mesh, as in the JAX engine.
"""

from __future__ import annotations

import contextlib
from typing import Callable, List, NamedTuple, Optional, Sequence

import numpy as np
import torch

from dctseg_torch.device import resolve_device
from dctseg_torch.models import layers
from dctseg_torch.ops import _build
from dctseg_torch.parallel import spatial
from dctseg_torch.parallel.mesh import batch_rows
from dctseg_torch.utils.profiling import span

FLIP_COMBOS: List[tuple] = [
    (), (1,), (2,), (3,), (1, 2), (1, 3), (2, 3), (1, 2, 3),
]  # spatial axes of NDHWC, in the reference's order

# (H, W, D) windows of the 128^3 crops of a (240, 240, >=155) volume
CROPS = [
    (slice(0, 128), slice(0, 128), slice(0, 128)),
    (slice(0, 128), slice(112, 240), slice(0, 128)),
    (slice(112, 240), slice(0, 128), slice(0, 128)),
    (slice(112, 240), slice(112, 240), slice(0, 128)),
    (slice(0, 128), slice(0, 128), slice(27, 155)),
    (slice(0, 128), slice(112, 240), slice(27, 155)),
    (slice(112, 240), slice(0, 128), slice(27, 155)),
    (slice(112, 240), slice(112, 240), slice(27, 155)),
]

INPUT_ROUTES = ("staged", "pinned", "device", "host")   # of ``_input``


# The candidates cuDNN times a conv shape, in its heuristic's order.  On an
# H100 at both serving models' B=8 bf16 convs, PyTorch's default of 10 and
# 4 found the same conv time a forward (Swin UNETR 53.3 and 53.7 ms against
# the heuristic's 90.6; ClsWiseFormer about 65 ms either way), 2 and 1 lost
# the gain (85.1 and 90.9 ms), and the first forward's search took 4.0 s
# at 10, 2.2 s at 4 and 1.7 s at 1 for Swin UNETR's 25 shapes.
BENCHMARK_LIMIT = 4
# PyTorch empties its allocator's cache after each shape's search, so the
# forward allocates its activations anew after every new shape.  Kept, the
# first Swin UNETR volume took 3.3 s in place of 7.4 s (1.5 s under the
# heuristic), ClsWiseFormer's 3.0 s in place of 4.8 s (2.0 s).  The switch
# is private to PyTorch's CUDA builds: where it is missing, nothing is set.
_SEARCH_EMPTIES_CACHE = (
    getattr(torch._C, "_cuda_get_conv_benchmark_empty_cache", None),
    getattr(torch._C, "_cudnn_set_conv_benchmark_empty_cache", None))


@contextlib.contextmanager
def measured_convs():
    """cuDNN picks each conv's algorithm by timing its first
    ``BENCHMARK_LIMIT`` candidates, keeping the allocator's cache (module
    docstring); the caller's ``benchmark``, ``benchmark_limit`` and cache
    setting are restored on the way out, the other cuDNN flags are not
    touched."""
    cudnn = torch.backends.cudnn
    get_empties, set_empties = _SEARCH_EMPTIES_CACHE
    kept = cudnn.benchmark, cudnn.benchmark_limit
    empties = get_empties() if get_empties and set_empties else None
    cudnn.benchmark, cudnn.benchmark_limit = True, BENCHMARK_LIMIT
    if empties is not None:
        set_empties(False)
    try:
        yield
    finally:
        cudnn.benchmark, cudnn.benchmark_limit = kept
        if empties is not None:
            set_empties(empties)


class _Captured(NamedTuple):
    """One fused stage captured as a CUDA graph: its static input and
    output, the kernel workspaces it owns, and the launches a replay runs
    (``ops/_build.py`` ``launches_since`` over the capture)."""
    graph: torch.cuda.CUDAGraph
    static_in: torch.Tensor
    static_out: torch.Tensor
    workspaces: dict
    launches: dict


class Predictor:
    """Inference over one model.  ``device`` defaults to the GPU (raises if
    there is none; pass ``device='cpu'`` for the CPU).  ``microbatch`` caps
    the per-call forward batch of the 8-variant engines.

    ``fuse_dispatch`` runs the crop or flip construction of a one-volume
    ``tiled_probs`` or ``tta_probs`` and its B=8 forward as one CUDA graph
    (module docstring); off by default, and off under ``microbatch``, as in
    the JAX engine.  With ``fold_params`` the graphs read the folded
    tensors, and ``update_params`` copies the new values into them (and
    into the parameters, which ``load_state_dict`` does in place), so a
    graph never answers with the old weights.

    ``fold_params`` (the JAX engine's ``dctseg/infer/engine.py:68-99``)
    computes the per-call weight work once: the convs' casts to the compute
    dtype, the s2d weight transforms and, under ``quantize``, the int8
    weights and scales in K6's layout (``models/layers.py`` ``fold``).
    ``update_params`` computes them again.  The JAX engine folds them into
    a recompiled executable, whose op order differs, so its folded results
    are only rounding-close; here the folded forward runs the same ops in
    the same order on tensors the unfolded one would compute, so the two
    agree bit for bit.

    ``mesh`` (a ``parallel.mesh.Mesh``) runs each forward over the ranks of
    a process group (module docstring); every rank calls the same engines
    on the same input, float or int8.

    Every forward runs on cuDNN's measured algorithms (``measured_convs``):
    the first forward of an input shape on a thread times each conv's
    candidates (1.5–3 s at B=8 on an H100), so ``seg_probs`` over volumes
    of changing shape pays one search a new shape; the caller's cuDNN flags
    are as they were after every call.  ``conv_autotune`` counts the
    forwards (``model_probs`` calls; a graph's replay is not one) by input
    shape: the first of each shape is its search.  ``Trainer`` does not
    autotune, for its step's peak memory (module docstring)."""

    def __init__(self, model: torch.nn.Module, device=None,
                 microbatch: Optional[int] = None,
                 fold_params: bool = False, fuse_dispatch: bool = False,
                 mesh=None):
        self.device = resolve_device(device)
        self.model = model.to(self.device).eval()
        self.microbatch = microbatch
        self.mesh = mesh
        self.fold_params = fold_params and mesh is None
        self._folded = layers.fold(self.model) if self.fold_params else None
        self.fuse_dispatch = (fuse_dispatch and microbatch is None
                              and mesh is None)
        self._graphs: dict = {}   # (stage, shape, dtype) -> _Captured
        self._pool = None         # the graphs' shared memory pool
        self.input_routes = dict.fromkeys(INPUT_ROUTES, 0)
        self.conv_autotune: dict = {}   # forward input shape -> forwards

    def _input(self, x) -> torch.Tensor:
        """``x`` (a tensor or an array) on ``self.device``, by the route
        its place and layout pick (module docstring)."""
        if isinstance(x, np.ndarray):
            x = torch.from_numpy(x)
        if self.device.type == "cpu" or (x.device.type == "cpu"
                                         and not x.is_contiguous()):
            route = "host"
        elif x.device.type != "cpu":
            route = "device"
        else:
            route = "pinned" if x.is_pinned() else "staged"
        self.input_routes[route] += 1
        if route == "staged":
            x = x.pin_memory()
        return x.to(self.device, non_blocking=route != "host")

    def model_probs(self, xs: torch.Tensor) -> torch.Tensor:
        """The model's decoder softmax on one batch, on the folded weights
        where ``fold_params`` is on; under a mesh this rank's rows and slab,
        gathered back, the int8 scales taken over the mesh; on cuDNN's
        measured algorithms (``measured_convs``)."""
        shape = tuple(xs.shape)
        self.conv_autotune[shape] = self.conv_autotune.get(shape, 0) + 1
        if self.mesh is None:
            with measured_convs(), layers.folded(self._folded):
                return self.model(xs)[0]
        rows = batch_rows(self.mesh, xs.shape[0])
        with measured_convs(), \
                spatial.sharded(spatial.space_shard(self.mesh)), \
                spatial.scaled(self.mesh.group):
            y = self.model(xs[rows])[0]
        if rows.stop - rows.start == xs.shape[0]:
            return y
        return spatial.all_gather_cat(y, self.mesh.data_group, dim=0)

    def _forward(self, xs: torch.Tensor) -> torch.Tensor:
        mb = self.microbatch
        if mb is None or xs.shape[0] <= mb:
            return self.model_probs(xs)
        return torch.cat([self.model_probs(xs[i:i + mb])
                          for i in range(0, xs.shape[0], mb)], dim=0)

    @torch.inference_mode()
    def seg_probs(self, x) -> torch.Tensor:
        """(B, D, H, W, M) -> (B, D, H, W, C) decoder softmax probs."""
        return self._forward(self._input(x))

    # ---- fused dispatch ----

    def _stage(self, build: Callable, x: torch.Tensor) -> torch.Tensor:
        """``model_probs(build(x))``: on CUDA under ``fuse_dispatch`` one
        replay of this shape's captured graph, else staged.  A replay's
        output is the graph's static output, which the next replay
        overwrites: the caller consumes it first, in stream order."""
        if not self.fuse_dispatch:
            return self._forward(build(x))
        if self.device.type != "cuda":
            return self.model_probs(build(x))
        key = (build.__name__, tuple(x.shape), x.dtype)
        captured = self._graphs.get(key)
        if captured is None:
            captured = self._graphs[key] = self._capture(build, x)
        else:
            captured.static_in.copy_(x)
        captured.graph.replay()
        _build.add_launches(captured.launches)
        return captured.static_out

    def _capture(self, build: Callable, x: torch.Tensor) -> _Captured:
        """Warm ``model_probs(build(.))`` up on a side stream, then capture
        it there on a static input that holds a copy of ``x`` (a capture
        runs nothing: the caller replays, and the launch counters give back
        what the capture counted, which each replay adds)."""
        static_in = torch.empty_like(x, memory_format=torch.contiguous_format)
        static_in.copy_(x)
        if self._pool is None:
            self._pool = torch.cuda.graph_pool_handle()
        graph, owned = torch.cuda.CUDAGraph(), {}
        current = torch.cuda.current_stream(self.device)
        side = torch.cuda.Stream(self.device)
        side.wait_stream(current)
        with _build.owned_workspaces(owned):
            # the warm-up makes the kernels' plans, occupancy queries and
            # workspaces, none of which a capture may allocate
            with torch.cuda.stream(side):
                self.model_probs(build(static_in))
            before = _build.launch_counts()
            with torch.cuda.graph(graph, pool=self._pool, stream=side):
                static_out = self.model_probs(build(static_in))
            launches = _build.launches_since(before)
            _build.add_launches(launches, -1)
        current.wait_stream(side)
        return _Captured(graph, static_in, static_out, owned, launches)

    # ---- flip TTA ----

    @staticmethod
    def flip_batch(x: torch.Tensor) -> torch.Tensor:
        """(1, D, H, W, M) -> (8, D, H, W, M) flip variants."""
        return torch.cat([torch.flip(x, c) if c else x for c in FLIP_COMBOS],
                         dim=0)

    @staticmethod
    def unflip_mean(probs: torch.Tensor) -> torch.Tensor:
        """(8, D, H, W, C) flip-variant probs -> (1, D, H, W, C) mean of
        their softmaxes, each unflipped."""
        acc = torch.zeros_like(probs[0:1], dtype=torch.float32)
        for i, c in enumerate(FLIP_COMBOS):
            p = probs[i:i + 1]
            p = torch.flip(p, c) if c else p
            acc = acc + torch.softmax(p.float(), dim=-1)
        return acc / len(FLIP_COMBOS)

    @torch.inference_mode()
    def tta_probs(self, x) -> torch.Tensor:
        """8-way flip TTA with double-softmax averaging; x is (1, ...).
        Under ``fuse_dispatch`` the flips and the forward are one graph."""
        x = self._input(x)
        if x.shape[0] != 1:
            raise ValueError("TTA operates per volume: x must be (1, ...)")
        return self.unflip_mean(self._stage(self.flip_batch, x))

    # ---- sliding-window tiling ----

    @staticmethod
    def crops(x: torch.Tensor) -> torch.Tensor:
        """(1, 240, 240, >=155, M) -> (8, 128, 128, 128, M) crops."""
        return torch.cat([x[:, h, w, d, :] for h, w, d in CROPS], dim=0)

    @staticmethod
    def stitch_volume(t: torch.Tensor, stitch_ref: bool) -> torch.Tensor:
        """(8, 128^3, C) crop outputs -> (240, 240, 155, C) volume.  Later
        crops overwrite the 16-voxel H/W overlap with their inner region."""
        y = torch.zeros((240, 240, 155, t.shape[-1]), dtype=t.dtype,
                        device=t.device)
        y[:128, :128, :128] = t[0]
        y[:128, 128:240, :128] = t[1, :, 16:128, :]
        y[128:240, :128, :128] = t[2, 16:128, :, :]
        y[128:240, 128:240, :128] = t[3, 16:128, 16:128, :]
        lo, hi = (96, 123) if stitch_ref else (101, 128)
        y[:128, :128, 128:155] = t[4, :, :, lo:hi]
        y[:128, 128:240, 128:155] = t[5, :, 16:128, lo:hi]
        y[128:240, :128, 128:155] = t[6, 16:128, :, lo:hi]
        y[128:240, 128:240, 128:155] = t[7, 16:128, 16:128, lo:hi]
        return y

    @torch.inference_mode()
    def tiled_probs(self, x, stitch_mode: str = "reference") -> torch.Tensor:
        """(1, 240, 240, >=155, M) -> (1, 240, 240, 155, C).  Under
        ``fuse_dispatch`` the crops and the forward are one graph."""
        _check_stitch(stitch_mode)
        with span("engine.tiled_probs"):
            with span("engine.input"):
                x = self._input(x)
            if x.shape[0] != 1:
                raise ValueError(
                    "tiling operates per volume: x must be (1, ...)")
            with span("engine.forward"):
                t = self._stage(self.crops, x)
            with span("engine.stitch"):
                return self.stitch_volume(t, stitch_mode == "reference")[None]

    # ---- V volumes per forward ----

    @torch.inference_mode()
    def tta_probs_batch(self, x) -> torch.Tensor:
        """(V, D, H, W, M) -> (V, D, H, W, C): the 8 flip variants of V
        volumes through ONE forward (B=8V, volume-major), each volume's
        double-softmax mean as in :meth:`tta_probs`; V=1 is
        :meth:`tta_probs`."""
        x = self._input(x)
        if x.shape[0] == 1:
            return self.tta_probs(x)
        probs = self._forward(_cat(
            [self.flip_batch(x[v:v + 1]) for v in range(x.shape[0])]))
        return _cat([self.unflip_mean(probs[8 * v:8 * v + 8])
                     for v in range(x.shape[0])])

    @torch.inference_mode()
    def tiled_probs_batch(self, x, stitch_mode: str = "reference"
                          ) -> torch.Tensor:
        """(V, 240, 240, >=155, M) -> (V, 240, 240, 155, C): the 8 crops of
        V volumes through ONE forward (B=8V, volume-major), each stitched as
        in :meth:`tiled_probs`; V=1 is :meth:`tiled_probs`."""
        _check_stitch(stitch_mode)
        x = self._input(x)
        if x.shape[0] == 1:
            return self.tiled_probs(x, stitch_mode)
        t = self._forward(_cat([self.crops(x[v:v + 1])
                                for v in range(x.shape[0])]))
        ref = stitch_mode == "reference"
        return _cat([self.stitch_volume(t[8 * v:8 * v + 8], ref)[None]
                     for v in range(x.shape[0])])

    @torch.inference_mode()
    def tiled_tta_probs(self, x, stitch_mode: str = "reference"
                        ) -> torch.Tensor:
        """Flip TTA over full tilings: 8 flips x 8 crops = 64 forwards per
        volume, mean of the softmaxes.  Each flip variant batches all V
        volumes' crops through one B=8V forward."""
        x = self._input(x)[:, :, :, :155]
        acc = None
        for c in FLIP_COMBOS:
            xf = torch.flip(x, c) if c else x
            y = self.tiled_probs_batch(xf, stitch_mode)
            y = torch.flip(y, c) if c else y
            y = torch.softmax(y.float(), dim=-1)
            acc = y if acc is None else acc + y
        return acc / len(FLIP_COMBOS)

    def update_params(self, state_dict) -> None:
        """Swap checkpoints (for ensembling): load a state_dict into the
        model in place, strictly; under ``fold_params`` fold it again, into
        the folded tensors in place, where the captured graphs read them."""
        self.model.load_state_dict(state_dict, strict=True)
        if self.fold_params:
            with torch.no_grad():
                for key, tensors in layers.fold(self.model).items():
                    for old, new in zip(self._folded[key], tensors):
                        old.copy_(new)


def _check_stitch(stitch_mode: str) -> None:
    if stitch_mode not in ("reference", "aligned"):
        raise ValueError(f"unknown stitch_mode {stitch_mode!r}")


def _cat(parts: Sequence[torch.Tensor]) -> torch.Tensor:
    """``torch.cat`` along dim 0 that hands a single part back as is, so a
    one-volume call makes no copy."""
    return parts[0] if len(parts) == 1 else torch.cat(parts)


def ensemble_probs(predict_fn: Callable[[], torch.Tensor],
                   predictor: Predictor,
                   param_sets: Sequence,
                   divisor: Optional[float] = None) -> torch.Tensor:
    """Multi-checkpoint softmax ensembling: the mean of ``predict_fn()``
    over state_dicts.  The reference divides by a hard-coded 4 whatever the
    number of checkpoints; pass ``divisor`` to reproduce that, or None to
    divide by the actual count."""
    acc = None
    for sd in param_sets:
        predictor.update_params(sd)
        y = predict_fn()
        acc = y if acc is None else acc + y
    return acc / (divisor if divisor is not None else len(param_sets))
