"""The sharded steps of ``launch.steps.build_cell`` on a world of 8 gloo
ranks against the port's one-device steps (``test_torch_mesh_steps.py``'s
worker, shapes and bars) for reduced Falcon-Mamba (SSM), LLaVA-NeXT (VLM,
bf16 accumulators) and Whisper (audio)."""

import pytest

from test_torch_mesh_steps import KINDS, check, spawn_results

ARCHS = ("falcon_mamba_7b", "llava_next_34b", "whisper_large_v3")


@pytest.fixture(scope="module")
def results():
    return spawn_results(ARCHS)


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("arch", ARCHS)
def test_sharded_step_matches_one_device(results, arch, kind):
    check(results, arch, kind)
