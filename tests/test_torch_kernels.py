"""The port's two kernels, on the CPU: their plain versions against the JAX
package's Pallas kernels run in interpret mode (and against the kernels'
XLA twins), and the wrappers' CPU behaviour.  The CUDA kernels themselves
are checked against these plain versions on the card by chip_smoke.py.

Tolerance 2e-5 (rtol and atol): both sides compute in f32 but reduce in
different orders.
"""

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
    with pytest.raises(NotImplementedError, match="training slice"):
        attn._FusedAttention.backward(None, torch.zeros(1))


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
