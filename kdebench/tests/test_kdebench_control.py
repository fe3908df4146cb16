"""The precision controls: the float32 reference with TF32 products put in
the program's place, and the program's own bf16x2 tier, must come out not
correct, the program as configured correct.  On the card at a size a test
run holds (32,768 points, 4,096 queries, three seeds; bf16x2 in the cell
of that size); on the CPU, where neither exists, the TF32 control's
plumbing only."""

import time

import pytest
import torch

from kdebench import control, harness
from kdebench.reference import mixture
from kdebench.reference import sdkde as ref

SEEDS = (2**31 + 101, 2**31 + 102, 2**31 + 103)
SIZE = {"n_train": 32768, "n_queries": 4096}
SERVE = {"warm_seconds": 0.5}


@pytest.mark.chip
@pytest.mark.parametrize("workload", ["mix16-32k.task", "mix16-1m.task",
                                      "mix16-1m.serve"])
def test_tf32_control_fails_and_the_program_passes(workload, card):
    kind = "serve" if workload.endswith("serve") else "task"
    kw = dict(config_override=SIZE,
              traffic_override=SERVE if kind == "serve" else {})
    for seed in SEEDS:
        good, _ = harness.run(workload, seed, 2.0, False,
                              t_start=time.perf_counter(), **kw)
        bad, _ = harness.run(
            workload, seed, 2.0, False, t_start=time.perf_counter(),
            check_kw={"reference": control.tf32_reference(kind)}, **kw)
        assert good["correct"], good["checks"]
        assert not bad["correct"], bad["checks"]
        err = bad["checks"]["density_rel_err"]
        assert err["value"] > err["limit"]


@pytest.mark.chip
def test_the_programs_bf16x2_tier_fails_the_32k_check(card):
    _, config, _ = harness.cell(harness.manifest(), "mix16-32k.task")
    lower = {"estimator": {**config["estimator"], "precision": "bf16x2"}}
    for seed in SEEDS:
        bad, _ = harness.run("mix16-32k.task", seed, 2.0, False,
                             t_start=time.perf_counter(),
                             config_override=lower)
        assert not bad["correct"], bad["checks"]


def test_the_control_is_the_reference_in_float32_put_in_place():
    spec = {"dim": 16, "separation": 4.0, "shifted_dims": 4,
            "stds": [1.0, 0.7], "weights": [0.6, 0.4]}
    s = mixture.from_config(spec).sampler("cpu")
    x = s.sample(600, mixture.generator("cpu", 1, "x"))
    y = s.sample(50, mixture.generator("cpu", 1, "y"))
    got = control.tf32_reference("task")(x, y)
    assert got.dtype == torch.float32
    assert torch.equal(got, ref.sdkde(x, y, dtype=torch.float32)[0])
    h = ref.sdkde_bandwidth(x)
    x_sd, _ = ref.score_shift(x, h, dtype=torch.float32)
    served = control.tf32_reference("serve")(x, y)
    assert torch.equal(served, ref.kde(x_sd, y, h, dtype=torch.float32)[0])
