"""The port's fault-tolerance substrate (``distributed/fault.py``,
``distributed/elastic.py``'s arithmetic) against ``repro``'s.

Mirrors the supervisor, restart-loop, fencing, ``plan_mesh`` and
``rebatch`` tests of ``tests/test_fault_tolerance.py``; the straggler
dispatcher, gradient compression and ``reshard_specs`` are held in
``tests/test_torch_distributed.py``.  Everything here is host Python on
injected clocks; parity with ``repro`` is exact (the same decisions, the
same integers).
"""

import pytest

from repro.distributed import elastic as jelastic
from repro.distributed.fault import Supervisor as JSupervisor
from repro_torch.distributed.elastic import MeshPlan, plan_mesh, rebatch
from repro_torch.distributed.fault import RestartLoop, Supervisor


# -- supervisor --------------------------------------------------------------


def test_supervisor_failure_detection():
    clock = [0.0]
    sup = Supervisor(4, timeout=10.0, clock=lambda: clock[0])
    for h in range(4):
        sup.beat(h, 1)
    clock[0] = 5.0
    for h in (0, 1, 2):
        sup.beat(h, 2)
    assert sup.dead_hosts() == []
    clock[0] = 12.0     # host 3 last beat at t=0 -> dead; 0-2 beat at t=5
    assert sup.dead_hosts() == [3]
    plan = sup.restart_plan(spare_hosts=0)
    assert plan["action"] == "shrink" and plan["new_size"] == 3
    plan = sup.restart_plan(spare_hosts=2)
    assert plan["action"] == "replace"


def test_supervisor_straggler_detection():
    clock = [0.0]
    sup = Supervisor(4, timeout=1e9, straggler_factor=2.0,
                     clock=lambda: clock[0])
    # hosts 0-2 step every 1s; host 3 every 10s
    for step in range(1, 6):
        for h in (0, 1, 2):
            clock[0] = step * 1.0
            sup.beat(h, step)
        clock[0] = step * 10.0
        sup.beat(3, step)
    assert sup.stragglers() == [3]
    assert sup.fleet_step() == 5


def test_restart_loop_resumes_from_checkpoint():
    executed = []
    saved = {"step": 0}
    loop = RestartLoop(
        step_fn=lambda i: executed.append(i),
        save_fn=lambda s: saved.update(step=s),
        restore_fn=lambda: saved["step"],
        ckpt_every=10,
    )
    assert loop.run(50, fail_at=25) == 2
    # steps 20..24 re-executed after the restart from the step-20 checkpoint
    assert executed == list(range(0, 25)) + list(range(20, 50))


# -- fencing epoch -------------------------------------------------------------


def test_fence_rejects_zombie_beats():
    clock = [0.0]
    sup = Supervisor(4, timeout=10.0, clock=lambda: clock[0])
    for h in range(4):
        sup.beat(h, 1)
    clock[0] = 20.0
    for h in (0, 1, 2):
        sup.beat(h, 2)
    plan = sup.restart_plan(fence=True)
    assert plan["action"] == "shrink" and plan["dead"] == [3]
    assert sup.fenced() == [3]
    # the zombie keeps beating: no epoch, then a stale one — neither may
    # flip the host back to alive
    assert sup.beat(3, 3) is False
    assert sup.beat(3, 3, epoch=0) is False
    assert sup.rejected_beats == 2
    assert sup.fenced() == [3]
    assert not sup.hosts[3].alive


def test_fence_readmission_epoch():
    clock = [0.0]
    sup = Supervisor(2, timeout=5.0, clock=lambda: clock[0])
    sup.fence([1])
    ep = sup.hosts[1].epoch
    # a beat carrying the CURRENT epoch is the re-admission handshake
    assert sup.beat(1, 7, epoch=ep) is True
    assert sup.fenced() == [] and sup.hosts[1].alive
    # coordinator-side readmit refreshes the beat clock too
    sup.fence([0])
    clock[0] = 3.0
    assert sup.readmit(0) == sup.hosts[0].epoch
    assert sup.fenced() == [] and sup.hosts[0].last_beat == 3.0


def test_restart_plan_fencing_is_idempotent():
    clock = [0.0]
    sup = Supervisor(3, timeout=1.0, clock=lambda: clock[0])
    clock[0] = 5.0
    sup.beat(0, 1)
    p1 = sup.restart_plan(fence=True)
    epochs = {h: sup.hosts[h].epoch for h in (1, 2)}
    # a second sweep sees the same dead set and must not bump epochs again
    p2 = sup.restart_plan(fence=True)
    assert p1["dead"] == p2["dead"] == [1, 2]
    assert {h: sup.hosts[h].epoch for h in (1, 2)} == epochs
    # the default restart_plan never fences
    sup2 = Supervisor(2, timeout=1.0, clock=lambda: clock[0])
    clock[0] = 10.0
    assert sup2.restart_plan()["dead"] == [0, 1]
    assert sup2.fenced() == []
    assert sup2.beat(0, 1) is True


def test_supervisor_decisions_match_repro():
    """One scripted fleet history through both supervisors: the same dead
    sets, plans, fenced hosts, epochs, rejected beats and stragglers."""
    def drive(cls):
        clock = [0.0]
        sup = cls(6, timeout=3.0, straggler_factor=2.0,
                  clock=lambda: clock[0])
        log = []
        for step in range(1, 13):
            clock[0] = float(step)
            for h in range(6):
                if h == 4 and 4 <= step < 9:
                    continue                     # host 4 stalls, recovers
                if h == 5 and step % 3:
                    continue                     # host 5 straggles
                log.append(sup.beat(h, step,
                                    epoch=sup.hosts[h].epoch
                                    if step == 10 else None))
            log.append((sup.restart_plan(spare_hosts=step % 2, fence=True),
                        sup.fenced(), sup.stragglers(), sup.fleet_step(),
                        sup.rejected_beats,
                        [sup.hosts[h].epoch for h in range(6)]))
        return log

    assert drive(Supervisor) == drive(JSupervisor)


# -- restart loop error taxonomy ------------------------------------------------


def test_restart_loop_propagates_real_bugs():
    """Only InjectedFailure is retried; a genuine step_fn bug surfaces."""
    executed = []

    def step(i):
        executed.append(i)
        if i == 3:
            raise ZeroDivisionError("real bug in step 3")

    loop = RestartLoop(step_fn=step, save_fn=lambda s: None,
                       restore_fn=lambda: 0, ckpt_every=10)
    with pytest.raises(ZeroDivisionError, match="real bug"):
        loop.run(10)
    assert executed == [0, 1, 2, 3]     # no silent retry loop


def test_restart_loop_still_retries_injected_failure():
    loop = RestartLoop(step_fn=lambda i: None, save_fn=lambda s: None,
                       restore_fn=lambda: 0, ckpt_every=100)
    assert loop.run(5, fail_at=2) == 2


# -- elastic arithmetic -----------------------------------------------------------


def test_plan_mesh_shrink():
    p = plan_mesh(512, model_parallel=16, want_pods=2)
    assert p.shape == (2, 16, 16)
    p = plan_mesh(256, model_parallel=16)
    assert p.shape == (16, 16)
    # lost 16 hosts of 32 on one pod: 240 devices
    p = plan_mesh(240, model_parallel=16)
    assert p.shape == (15, 16) and p.note == ""
    # awkward count: drops stragglers
    p = plan_mesh(250, model_parallel=16)
    assert p.n_devices <= 250


def test_plan_mesh_awkward_counts():
    # prime count: the model axis folds down to 1, everything is data
    p = plan_mesh(7, model_parallel=16)
    assert p.shape == (7, 1) and p.n_devices == 7
    assert plan_mesh(1, model_parallel=16).n_devices == 1
    # non-dividing want_pods falls back to a 2-axis mesh
    p = plan_mesh(256, model_parallel=16, want_pods=3)
    assert p.axes == ("data", "model")


@pytest.mark.parametrize("mp", [1, 2, 3, 4, 16])
@pytest.mark.parametrize("pods", [None, 2, 3])
def test_plan_mesh_matches_repro(mp, pods):
    for n in range(1, 70):
        got = plan_mesh(n, model_parallel=mp, want_pods=pods)
        want = jelastic.plan_mesh(n, model_parallel=mp, want_pods=pods)
        assert isinstance(got, MeshPlan)
        assert (got.shape, got.axes, got.note, got.n_devices) == (
            want.shape, want.axes, want.note, want.n_devices)


def test_rebatch_exact_when_divisible():
    per_dev, mb, new_gb = rebatch(256, old_dp=16, new_dp=8, microbatches=8)
    assert per_dev * 8 * mb == 256 and new_gb == 256


def test_rebatch_nearest_when_impossible():
    # 15 hosts never tile 256 exactly -> nearest achievable multiple
    per_dev, mb, new_gb = rebatch(256, old_dp=16, new_dp=15, microbatches=8)
    assert new_gb == per_dev * 15 * mb
    assert abs(new_gb - 256) <= 15 * mb // 2 + 1


def test_rebatch_non_divisible_device_count():
    per_dev, mb, new_gb = rebatch(100, old_dp=4, new_dp=7, microbatches=3)
    assert per_dev >= 1 and new_gb == per_dev * 7 * mb
    assert abs(new_gb - 100) <= 7 * mb


def test_rebatch_shrink_to_single_host():
    per_dev, mb, new_gb = rebatch(256, old_dp=16, new_dp=1, microbatches=8)
    assert new_gb == 256 and per_dev * mb == 256


def test_rebatch_matches_repro():
    for gb in (1, 7, 64, 100, 256, 1000):
        for dp in (1, 2, 3, 7, 15, 16, 33):
            for mb in (1, 3, 8):
                assert rebatch(gb, 16, dp, mb) == jelastic.rebatch(
                    gb, 16, dp, mb), (gb, dp, mb)
