"""K3's launch plan and the kernel's arithmetic, on the CPU.

The CUDA kernel runs only on the card (``chip_smoke.py`` holds it to the
plain version there).  Here the pure launch plan is held to what
``csrc/relayout.cu`` takes: 16-byte output vectors at the UNet's call
sites, narrower ones where 2C or the pointers break them, and a grid of
one thread a vector up to BLOCKS_PER_SM blocks per SM.  A rehearsal of the
kernel in torch -- the grid-stride loop over output vectors, each
vector's output pixel, its (iz, iy) run and the input row it reads, the
V-element load (aligned to V elements), the cast and the store -- must
equal the plain version and the JAX relayout (the Pallas kernel in
interpret mode) bit for bit.
"""

import math
import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from dctseg.ops.pallas import relayout as jax_relayout

from dctseg_torch.ops import relayout

torch.set_num_threads(max(1, (os.cpu_count() or 1) // 6))

BF16, F32, F16 = torch.bfloat16, torch.float32, torch.float16
JNP = {F32: jnp.float32, BF16: jnp.bfloat16, F16: jnp.float16}
ITEMSIZE = {F32: 4, BF16: 2, F16: 2}
# the two UNet call sites at full width, as the training step (B=1, bf16)
# and the serving engine (B=8, f32 volumes) give them, and the fp32 model's
# input site
CALL_SITES = [((1, 128, 128, 128, 4), BF16, BF16),
              ((1, 64, 64, 64, 32), BF16, BF16),
              ((8, 128, 128, 128, 4), F32, BF16),
              ((8, 64, 64, 64, 32), BF16, BF16),
              ((1, 128, 128, 128, 4), F32, F32)]
# the shapes of tests/test_torch_s2d.py RELAYOUT_CASES (the JAX package's
# relayout test), one of 20 output rows, and two whose vectors narrow
REHEARSAL_CASES = [((2, 4, 32, 32, 4), F32, BF16, 32),
                   ((2, 4, 32, 32, 4), F32, F32, 32),
                   ((1, 4, 32, 4, 32), F32, BF16, 32),
                   ((1, 4, 32, 4, 32), BF16, BF16, 32),
                   ((1, 2, 40, 8, 16), BF16, BF16, 32),
                   ((2, 6, 8, 10, 3), F32, BF16, 32),
                   ((1, 8, 8, 8, 32), BF16, BF16, 2)]


def _grid(shape, vec):
    blocks = math.ceil(math.prod(shape) // vec / relayout.THREADS)
    return min(blocks, relayout.H100_SMS * relayout.BLOCKS_PER_SM)


@pytest.mark.parametrize("shape,in_dt,out_dt", CALL_SITES)
def test_plan_at_the_call_sites(shape, in_dt, out_dt):
    """16 bytes of output a vector, whole runs of 2C, one thread a vector
    up to BLOCKS_PER_SM blocks per SM (the B=8 calls stride)."""
    plan = relayout.plan_relayout(shape, in_dt, out_dt, 32)
    assert plan.vec * ITEMSIZE[out_dt] == 16
    assert (2 * shape[-1]) % plan.vec == 0
    assert plan.grid == _grid(shape, plan.vec)
    vectors = math.prod(shape) // plan.vec
    assert (plan.grid * relayout.THREADS >= vectors) == (shape[0] == 1)


@pytest.mark.parametrize("shape,in_dt,out_dt,aligned,vec", [
    ((2, 6, 8, 10, 3), F32, BF16, 32, 2),     # 2C = 6
    ((2, 6, 8, 10, 5), BF16, F32, 32, 2),     # 2C = 10
    ((1, 4, 4, 4, 6), F16, BF16, 32, 4),      # 2C = 12
    ((1, 128, 128, 128, 4), BF16, BF16, 2, 1),   # one element in
    ((1, 64, 64, 64, 32), BF16, BF16, 4, 2),
    ((8, 128, 128, 128, 4), F32, BF16, 8, 2),
    ((1, 64, 64, 64, 32), BF16, F32, 8, 2)])
def test_plan_gives_ragged_or_misaligned_inputs_the_vector_route(
        shape, in_dt, out_dt, aligned, vec):
    plan = relayout.plan_relayout(shape, in_dt, out_dt, aligned)
    assert plan.vec == vec
    assert (2 * shape[-1]) % vec == 0
    assert vec * max(ITEMSIZE[in_dt], ITEMSIZE[out_dt]) <= aligned
    assert plan.grid == _grid(shape, vec)


def _rehearse(x: torch.Tensor, out_dtype, plan) -> torch.Tensor:
    """csrc/relayout.cu s2d_kernel in torch: thread t of the grid takes
    output vectors v = t + p * grid * 256, p = 0, 1, ...; vector v is
    output pixel r = v // (8C/V) at channel ch = (v mod 8C/V) * V, run
    q = ch // 2C (iz, iy) = (q >> 1, q & 1) at ``within`` = ch mod 2C, which
    it reads as V elements of input row (n, 2z + iz, 2y + iy, 2x), casts
    and stores at v * V."""
    n, d, h, w, c = x.shape
    d2, h2, w2, vec = d // 2, h // 2, w // 2, plan.vec
    src = x.contiguous().reshape(-1)
    vectors = src.numel() // vec
    out = torch.zeros(vectors * vec, dtype=out_dtype)
    seen = torch.zeros(vectors, dtype=torch.int64)
    stride = plan.grid * relayout.THREADS
    lanes = torch.arange(vec)
    for p in range(math.ceil(vectors / stride)):
        v = torch.arange(p * stride, min((p + 1) * stride, vectors))
        r = v // (8 * c // vec)
        ch = (v - r * (8 * c // vec)) * vec
        q = ch // (2 * c)
        within = ch - q * 2 * c
        iz, iy = q >> 1, q & 1
        xo, r = r % w2, r // w2
        yo, r = r % h2, r // h2
        zo, nn = r % d2, r // d2
        in_row = (((nn * 2 * d2 + 2 * zo + iz) * 2 * h2 + 2 * yo + iy)
                  * 2 * w2 + 2 * xo)
        first = in_row * c + within
        assert bool((first % vec == 0).all())      # the aligned V-load
        vals = src[first[:, None] + lanes]
        out[(v * vec)[:, None] + lanes] = vals.to(out_dtype)
        seen[v] += 1
    assert bool((seen == 1).all())
    return out.reshape(n, d2, h2, w2, 8 * c)


@pytest.mark.parametrize("shape,in_dt,out_dt,aligned", REHEARSAL_CASES)
def test_kernel_rehearsal_equals_plain_and_pallas(shape, in_dt, out_dt,
                                                  aligned):
    rng = np.random.default_rng(sum(shape))
    x = torch.from_numpy(rng.normal(size=shape).astype(np.float32)).to(in_dt)
    plan = relayout.plan_relayout(shape, in_dt, out_dt, aligned)
    got = _rehearse(x, out_dt, plan)
    assert torch.equal(got, relayout.space_to_depth_plain(x, out_dt))
    xj = jnp.asarray(x.float().numpy()).astype(JNP[in_dt])
    want = jax.jit(lambda a: jax_relayout.space_to_depth(
        a, JNP[out_dt], "interpret"))(xj)
    np.testing.assert_array_equal(got.float().numpy(),
                                  np.asarray(want.astype(jnp.float32)))


@pytest.mark.parametrize("blocks", [1, 2])
def test_rehearsal_on_fewer_threads_than_vectors(blocks):
    """Threads that stride over several vectors each cover every vector
    once (the B=8 call-site grids give each thread about four)."""
    shape = (1, 8, 64, 4, 32)
    x = torch.from_numpy(np.random.default_rng(blocks).normal(size=shape)
                         .astype(np.float32)).to(BF16)
    plan = relayout.plan_relayout(shape, BF16, BF16, 32)._replace(
        grid=blocks)
    assert blocks * relayout.THREADS < math.prod(shape) // plan.vec
    assert torch.equal(_rehearse(x, BF16, plan),
                       relayout.space_to_depth_plain(x, BF16))


@pytest.mark.parametrize("ptrs,aligned", [
    ((0x7f0000000000, 0x7f0000001000), 32),
    ((0x7f0000000010, 0x7f0000001000), 16),
    ((0x7f0000000002, 0x7f0000001000), 2),    # one bf16 element in
    ((0x7f0000000004, 0x7f0000000008), 4)])
def test_alignment_is_the_largest_common_power_of_two(ptrs, aligned):
    assert relayout.alignment(*ptrs) == aligned
