"""The port's sharded Kimi-K2 steps against ``repro``'s own sharded
steps (``test_torch_mesh_steps_repro.py``'s code, inputs and bars):
reduced Kimi-K2's train step (Adafactor, bf16 accumulators; its experts
2-D over ``model`` and ``data``) and its decode at batch 8 (the MoE's
weights-stationary path)."""

import pytest

from test_torch_mesh_steps_repro import check, run_both

CELLS = (("kimi_k2_1t_a32b", "train"), ("kimi_k2_1t_a32b", "decode"))


@pytest.fixture(scope="module")
def results():
    return run_both(CELLS)


@pytest.mark.parametrize("arch,kind", CELLS)
def test_sharded_step_matches_repros_sharded_step(results, arch, kind):
    check(results, arch, kind)
