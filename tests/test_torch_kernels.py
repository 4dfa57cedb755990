"""The port's two kernels, on the CPU: their plain versions against the JAX
package's Pallas kernels run in interpret mode (and against the kernels'
XLA twins), the fusednorm launch plan, and the wrappers' CPU behaviour.
The CUDA kernels themselves are checked against these plain versions on
the card by chip_smoke.py.

Tolerance 2e-5 (rtol and atol): both sides compute in f32 but reduce in
different orders.
"""

import types

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from dctseg.ops.pallas import attention as jax_attention
from dctseg.ops.pallas import fusednorm as jax_fusednorm

from dctseg_torch.ops import _build
from dctseg_torch.ops import attention as attn
from dctseg_torch.ops import fusednorm
from dctseg_torch.ops.norms import instance_norm, leaky_relu

TOL = dict(rtol=2e-5, atol=2e-5)

# the shapes of tests/test_pallas.py: plain (fine == C) and s2d-like views
NORM_CASES = [((2, 4, 4, 4, 16), 16), ((2, 4, 4, 4, 32), 4),
              ((1, 8, 8, 8, 24), 3)]


def _norm_inputs(shape, seed=0):
    rng = np.random.default_rng(seed)
    x = (rng.normal(size=shape) * 3 + 1).astype(np.float32)
    res = rng.normal(size=shape).astype(np.float32)
    return x, res


@pytest.mark.parametrize("with_res", [False, True], ids=["nores", "res"])
@pytest.mark.parametrize("act", ["none", "relu", "lrelu"])
@pytest.mark.parametrize("shape,fine", NORM_CASES,
                         ids=["c16", "c32f4", "c24f3"])
def test_fusednorm_plain_matches_pallas_interpret(shape, fine, act,
                                                  with_res):
    x, res = _norm_inputs(shape)
    r = res if with_res else None
    want = jax_fusednorm.fused_instance_norm_act(
        jnp.asarray(x), fine, act=act,
        residual=None if r is None else jnp.asarray(r), impl="interpret",
        tile_s=32)
    got = fusednorm.fused_instance_norm_act_plain(
        torch.from_numpy(x), fine, act=act,
        residual=None if r is None else torch.from_numpy(r))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("act", ["none", "relu", "lrelu"])
@pytest.mark.parametrize("shape,fine", NORM_CASES,
                         ids=["c16", "c32f4", "c24f3"])
def test_fusednorm_plain_matches_xla_twin(shape, fine, act):
    x, res = _norm_inputs(shape, seed=1)
    want = jax_fusednorm._xla_reference(jnp.asarray(x), fine, 1e-5, act,
                                        0.01, jnp.asarray(res))
    got = fusednorm.fused_instance_norm_act_plain(
        torch.from_numpy(x), fine, act=act, residual=torch.from_numpy(res))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_fusednorm_plain_matches_port_norms():
    """At fine == C the kernel's function is the model's plain composition
    (instance_norm then the activation)."""
    x, _ = _norm_inputs((2, 4, 6, 6, 16), seed=2)
    xt = torch.from_numpy(x)
    got = fusednorm.fused_instance_norm_act_plain(xt, 16, act="lrelu")
    np.testing.assert_allclose(got.numpy(),
                               leaky_relu(instance_norm(xt)).numpy(), **TOL)


# (s, c, itemsize, vec): the main path's four widths in bf16 and f32, its
# s2d views, and odd shapes (C = 12 and 24, vec 1, S not a multiple of the
# rows a block covers at a time)
PLAN_SHAPES = [(e ** 3, c, 2, 8) for e, c in
               ((128, 16), (64, 32), (32, 64), (16, 128))]
PLAN_SHAPES += [(e ** 3, c, 4, 4) for e, c in ((128, 16), (32, 64))]
PLAN_SHAPES += [(64 ** 3, 128, 2, 8), (32 ** 3, 256, 2, 8), (512, 24, 2, 8),
                (512, 12, 2, 1), (512, 12, 4, 4), (5 * 7 * 11, 16, 2, 8),
                (4099, 24, 4, 4), (1, 256, 2, 1), (1000, 2048, 2, 8)]
# samples: one, an odd count, the main path's B=8
PLAN_BATCHES = [1, 3, 8]
# (fused blocks, split blocks, stage bytes): the H100's bf16 counts (two
# fused blocks an SM with 76 KB to stage rows in), a small card, one block
PLAN_CARDS = [(264, 396, 77824), (528, 660, 36864), (132, 132, 0),
              (1, 1, 4096)]


@pytest.mark.parametrize("n", PLAN_BATCHES)
@pytest.mark.parametrize("card", PLAN_CARDS,
                         ids=["h100", "small", "no_stage", "one_block"])
@pytest.mark.parametrize("shape", PLAN_SHAPES,
                         ids=["x".join(map(str, s)) for s in PLAN_SHAPES])
def test_fusednorm_plan_covers_every_row_once(shape, card, n):
    """Every row of every sample falls in exactly one block's chunk, the
    chunks are whole iterations of the block's threads and none is empty,
    the fused route is taken exactly where the samples fit on the chip and
    each gets a block, the staged rows fit the block's shared memory, and
    the fused grid never exceeds the co-resident count it was given."""
    s, c, itemsize, vec = shape
    fused_blocks, split_blocks, stage = card
    plan = fusednorm.plan_launch(n, s, c, itemsize, vec, fused_blocks,
                                 split_blocks, stage)
    fits = n * s * c * itemsize <= (fused_blocks * stage
                                    + fusednorm.FUSED_L2_BYTES)
    assert plan.route == ("fused" if fits and n <= fused_blocks
                          else "split")
    assert plan.rows_per_iter == fusednorm.THREADS // (c // vec)
    assert plan.rows_per_block % plan.rows_per_iter == 0
    assert (plan.blocks - 1) * plan.rows_per_block < s   # no empty block
    assert plan.blocks * plan.rows_per_block >= s
    # every sample on its own row of the grid; difference array of chunks
    hits = np.zeros(s + 1, np.int64)
    for b in range(plan.blocks):
        lo = b * plan.rows_per_block
        hits[lo] += 1
        hits[min(s, lo + plan.rows_per_block)] -= 1
    assert (np.cumsum(hits)[:s] == 1).all()
    if plan.route == "fused":
        assert plan.launches == 1
        assert plan.blocks * n <= fused_blocks
        assert plan.staged <= plan.rows_per_block // plan.rows_per_iter
        assert plan.staged * fusednorm.THREADS * vec * itemsize <= stage
    else:
        assert (plan.launches, plan.staged) == (2, 0)
    assert plan.workspace_bytes == 4 * (2 * n * c * (1 + plan.blocks) + 2 * n)


def test_fusednorm_threads_cover_their_block_rows_once():
    """Thread (r0, g) of a block takes rows first + k * rows_per_iter of
    its chunk (csrc/fusednorm.cu): over r0 they cover the chunk once."""
    plan = fusednorm.plan_launch(3, 5 * 7 * 11, 24, 2, 8, 264, 396, 77824)
    for b in range(plan.blocks):
        lo = b * plan.rows_per_block
        hi = min(5 * 7 * 11, lo + plan.rows_per_block)
        rows = [r for r0 in range(plan.rows_per_iter)
                for r in range(lo + r0, hi, plan.rows_per_iter)]
        assert sorted(rows) == list(range(lo, hi))


def test_fusednorm_plan_routes_on_the_h100():
    """At the H100's bf16 counts the main path's two small widths fit the
    chip (shared memory plus L2) and run fused, one launch; the two large
    ones and the s2d views run split.  A channel axis wider than the
    block's threads take in 16-byte loads has no plan."""
    routes = {(s, c): fusednorm.plan_launch(8, s, c, 2, 8, 264, 396,
                                            77824).route
              for s, c in ((128 ** 3, 16), (64 ** 3, 32), (32 ** 3, 64),
                           (16 ** 3, 128), (64 ** 3, 128), (32 ** 3, 256))}
    assert routes == {(128 ** 3, 16): "split", (64 ** 3, 32): "split",
                      (32 ** 3, 64): "fused", (16 ** 3, 128): "fused",
                      (64 ** 3, 128): "split", (32 ** 3, 256): "split"}
    with pytest.raises(ValueError, match="no plan"):
        fusednorm.plan_launch(8, 4096, 4096, 2, 8, 264, 396, 77824)


@pytest.mark.parametrize("shape", [(1, 8, 129, 64), (2, 4, 33, 16)])
def test_attention_plain_matches_pallas_interpret(shape):
    rng = np.random.default_rng(0)
    q, k, v = (rng.normal(size=shape).astype(np.float32) for _ in range(3))
    scale = shape[-1] ** -0.5
    want = jax_attention.fused_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), scale, True)
    got = attn.fused_attention_plain(torch.from_numpy(q), torch.from_numpy(k),
                                     torch.from_numpy(v), scale)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("shape", [(1, 8, 129, 64), (2, 4, 33, 16)])
def test_attention_strided_views_match_contiguous_and_pallas(shape):
    """q, k, v as the model takes them: views of one (B, N, 3, H, D)
    projection, transposed to (B, H, N, D) with no copy.  The wrapper equals
    its call on contiguous copies exactly, and the Pallas kernel in
    interpret mode within TOL."""
    b, h, n, d = shape
    qkv = np.random.default_rng(2).normal(size=(b, n, 3, h, d)).astype(
        np.float32)
    views = [torch.from_numpy(qkv)[:, :, i].transpose(1, 2) for i in range(3)]
    assert not any(t.is_contiguous() for t in views)
    scale = d ** -0.5
    got = attn.fused_attention(*views, scale)
    contiguous = attn.fused_attention(*(t.contiguous() for t in views), scale)
    np.testing.assert_array_equal(got.numpy(), contiguous.numpy())
    want = jax_attention.fused_attention(
        *(jnp.asarray(np.ascontiguousarray(qkv[:, :, i].transpose(0, 2, 1, 3)))
          for i in range(3)), scale, True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_attention_dispatch_rule():
    """bf16 and f16 at D % 16 == 0, D <= 128, N2 <= 144 with 16-byte rows go
    to the tensor-core kernel; f32, N2 = 145, D = 24 or a row off the
    16-byte grid go to the SIMT kernel."""
    def qkv(dtype, n2=129, d=64, n=129):
        base = torch.zeros(2, max(n, n2), 3, 2, d, dtype=dtype)
        return tuple(base[:, :m, i].transpose(1, 2)
                     for i, m in ((0, n), (1, n2), (2, n2)))
    assert attn.uses_tensor_cores(*qkv(torch.bfloat16))
    assert attn.uses_tensor_cores(*qkv(torch.float16, n2=144, d=128, n=50))
    assert not attn.uses_tensor_cores(*qkv(torch.float32))
    assert not attn.uses_tensor_cores(*qkv(torch.bfloat16, n2=145))
    assert not attn.uses_tensor_cores(*qkv(torch.bfloat16, d=24))
    q, k, v = qkv(torch.bfloat16)
    odd = torch.zeros(2, 129 * 2 * 64 + 1, dtype=torch.bfloat16)[:, 1:]
    odd = odd.reshape(2, 129, 2, 64).transpose(1, 2)
    assert not attn.uses_tensor_cores(q, odd, v)


def test_attention_skips_autograd_without_a_gradient():
    q = torch.randn(1, 2, 9, 8)
    assert attn.fused_attention(q, q, q, 0.3).grad_fn is None
    leaf = q.clone().requires_grad_()
    assert attn.fused_attention(leaf, q, q, 0.3).grad_fn is not None
    with torch.no_grad():
        assert attn.fused_attention(leaf, q, q, 0.3).grad_fn is None


def test_attention_plain_matches_pallas_interpret_bf16():
    """bf16 inputs: both keep p in f32 into p.v and round only the output,
    so they agree to within a bf16 rounding of the output."""
    rng = np.random.default_rng(1)
    q, k, v = (rng.normal(size=(1, 2, 17, 8)).astype(np.float32)
               for _ in range(3))
    want = jax_attention.fused_attention(
        *(jnp.asarray(a, jnp.bfloat16) for a in (q, k, v)), 8 ** -0.5, True)
    got = attn.fused_attention_plain(
        *(torch.from_numpy(a).bfloat16() for a in (q, k, v)), 8 ** -0.5)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32),
                               rtol=2 ** -8, atol=2 ** -8)


def test_cpu_wrappers_take_plain_versions_and_launch_nothing():
    fusednorm.fused_instance_norm_act.launches = 0
    attn.fused_attention.launches = 0
    x, res = _norm_inputs((2, 4, 4, 4, 16))
    xt, rt = torch.from_numpy(x), torch.from_numpy(res)
    torch.testing.assert_close(
        fusednorm.fused_instance_norm_act(xt, 16, act="relu", residual=rt),
        fusednorm.fused_instance_norm_act_plain(xt, 16, act="relu",
                                                residual=rt),
        rtol=0, atol=0)
    q = torch.randn(1, 2, 9, 8)
    torch.testing.assert_close(attn.fused_attention(q, q, q, 0.3),
                               attn.fused_attention_plain(q, q, q, 0.3),
                               rtol=0, atol=0)
    assert fusednorm.fused_instance_norm_act.launches == 0
    assert attn.fused_attention.launches == 0
    assert _build._lib is None   # nothing was built or loaded


def test_wrappers_reject_bad_arguments():
    x = torch.randn(1, 2, 2, 2, 6)
    with pytest.raises(ValueError, match="act"):
        fusednorm.fused_instance_norm_act(x, 6, act="gelu")
    with pytest.raises(ValueError, match="fine_channels"):
        fusednorm.fused_instance_norm_act(x, 4)
    with pytest.raises(ValueError, match="residual"):
        fusednorm.fused_instance_norm_act(x, 6, residual=x[..., :3])
    q = torch.randn(1, 2, 9, 8)
    with pytest.raises(ValueError, match="B, H, N, D"):
        attn.fused_attention(q, q[:, :1], q[:, :1], 0.3)
    with pytest.raises(ValueError, match="dtype"):
        attn.fused_attention(q, q.double(), q.double(), 0.3)


def test_attention_backward_is_not_ported():
    """The backward came with the training slice: the gradient of the einsum
    formulation, recomputed from the saved inputs (no backward kernel)."""
    g = torch.Generator().manual_seed(4)
    q, k, v, go = (torch.randn(2, 3, 5, 8, generator=g) for _ in range(4))
    ctx = types.SimpleNamespace(saved_tensors=(q, k, v), scale=0.3)
    # the operator's cotangent is that of its (B, N, H, D) output
    got = attn._backward(ctx, go.transpose(1, 2))
    assert got[3] is None
    for a, b in zip(got, attn.attention_vjp(q, k, v, 0.3, go)):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_build_raises_without_nvcc(monkeypatch, tmp_path):
    """Importing the kernel modules needs no nvcc; building does, and says
    so."""
    monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.build()


def test_dtype_codes():
    assert _build.dtype_code(torch.float32) == 0
    assert _build.dtype_code(torch.bfloat16) == 1
    with pytest.raises(TypeError):
        _build.dtype_code(torch.float64)
