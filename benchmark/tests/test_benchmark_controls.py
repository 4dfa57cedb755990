"""On the card, at each cell's own size: the program passes every limit of
its cell, and the control (a lower precision in the program's place: the
port's int8 path for serving, the reference in float8 for training) fails
at least one.  ``python -m pytest benchmark/tests -m card -q``."""

import time

import pytest

from benchmark import harness

SEEDS = (3_000_000_101, 3_000_000_102, 3_000_000_103)


@pytest.mark.card
@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("workload", ["serve_bf16_staged", "train_bf16_b1"])
def test_control_fails_where_the_program_passes(cuda, workload, seed):
    ctx = harness.Ctx(workload, seed, 0.0, False, time.perf_counter())
    got = harness.traffic(ctx.cell["traffic"]).calibrate(ctx)
    limits = ctx.cell["limits"]
    assert all(v <= limits[k] for k, v in got["program"].items()
               if k in limits), got
    assert any(v > limits[k] for k, v in got["control"].items()
               if k in limits), got
