"""The port's checkpoints (``repro_torch.checkpoint``), the prefetching
loader and the train launcher's kill and resume, on the CPU; and a
checkpoint that ``repro`` wrote, restored into the port and trained on.

The port reads and writes ``repro``'s layout: ``step_%09d/`` holding
``manifest.json``, ``shard_<host>.npz`` (keys ``a{i}``) and the
``_COMMITTED`` marker.  Round trips are held bit for bit.  Training on
from ``repro``'s checkpoint is held to ``repro``'s next step at the
model bar (rtol 2e-4, atol 2e-5 of the leaf's largest magnitude).  The
launcher runs as separate processes (it turns on deterministic
algorithms for its process).
"""

import ast
import dataclasses
import os
import pathlib
import subprocess
import sys
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from repro.checkpoint import CheckpointManager as JCheckpointManager
from repro.checkpoint import restore_pytree as jrestore_pytree
from repro.checkpoint import save_pytree as jsave_pytree
from repro.configs import ShapeCfg as JShapeCfg
from repro.configs import get_arch as jget_arch
from repro.launch.steps import make_train_step as jmake_train_step
from repro.launch.train import shaped_batch as jshaped_batch
from repro.models import common as jcommon
from repro.optim.adamw import adamw_init as jadamw_init
from repro_torch import configs as tconfigs
from repro_torch import convert
from repro_torch.checkpoint import (CheckpointManager, restore_pytree,
                                    save_pytree)
from repro_torch.configs import ShapeCfg
from repro_torch.data.synthetic import PrefetchLoader
from repro_torch.launch.steps import make_train_step

ROOT = pathlib.Path(__file__).resolve().parents[1]
RTOL, ATOL = 2e-4, 2e-5


def tree():
    g = torch.Generator().manual_seed(0)
    return {"params": {"embed": torch.randn(6, 4, generator=g),
                       "layers/w": torch.randn(2, 4, 3, generator=g).to(
                           torch.bfloat16)},
            "opt": {"step": torch.tensor(7, dtype=torch.int32),
                    "mu": {"embed": torch.zeros(6, 4)}}}


def flat(t, prefix=""):
    out = {}
    for k, v in t.items():
        if isinstance(v, dict):
            out.update(flat(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = v
    return out


def assert_bitwise(got, want):
    fg, fw = flat(got), flat(want)
    assert set(fg) == set(fw)
    for k, w in fw.items():
        g = fg[k]
        assert g.dtype == w.dtype and g.shape == w.shape, k
        assert torch.equal(g.view(torch.uint8) if g.dim() else g,
                           w.view(torch.uint8) if w.dim() else w), k


def test_round_trip_is_bit_exact_with_bf16_leaves(tmp_path):
    t = tree()
    t["params"]["layers/w"][0, 0, 0] = float("nan")
    save_pytree(t, str(tmp_path))
    assert_bitwise(restore_pytree(str(tmp_path), "cpu"), t)
    manifest = (tmp_path / "manifest.json").read_text()
    assert '"dtype": "bfloat16"' in manifest
    with np.load(tmp_path / "shard_0.npz") as z:
        assert {z[k].dtype.str for k in z.files} >= {"|V2"}


def test_the_checkpoint_module_needs_no_ml_dtypes():
    src = ROOT / "src" / "repro_torch" / "checkpoint" / "manager.py"
    names = set()
    for node in ast.walk(ast.parse(src.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom):
            names.add((node.module or "").split(".")[0])
    assert "ml_dtypes" not in names and "jax" not in names


def test_rotation_keeps_the_newest_and_torn_directories_are_ignored(
        tmp_path):
    m = CheckpointManager(str(tmp_path), keep=2)
    for step in (1, 2, 3):
        m.save(step, tree(), blocking=True)
    assert m.committed_steps() == [2, 3]
    torn = tmp_path / "step_000000009"
    torn.mkdir()
    (torn / "manifest.json").write_text("{}")
    assert m.latest_step() == 3
    assert int(m.restore("cpu")["opt"]["step"]) == 7
    m.close()
    with pytest.raises(FileNotFoundError):
        CheckpointManager(str(tmp_path / "empty")).restore("cpu")


def test_save_snapshots_at_call_time(tmp_path, monkeypatch):
    """The write runs on the background thread; changing the tensors
    after ``save`` returns (as the next in-place optimizer step does)
    does not change what is written."""
    from repro_torch.checkpoint import manager

    gate = threading.Event()
    real = manager._write
    monkeypatch.setattr(manager, "_write",
                        lambda *a: gate.wait(10) and real(*a))
    t = tree()
    want = {k: v.clone() for k, v in flat(t).items()}
    m = CheckpointManager(str(tmp_path))
    m.save(5, t)
    assert m.latest_step() is None            # not written yet
    t["params"]["embed"].add_(1.0)
    t["opt"]["step"].fill_(8)
    gate.set()
    m.wait()
    got = flat(m.restore("cpu"))
    for k, v in want.items():
        assert torch.equal(got[k], v), k
    assert m.last_snapshot["bytes"] == sum(
        v.numel() * v.element_size() for v in want.values())
    assert m.last_snapshot["ms"] >= 0
    m.close()


def test_repros_bf16_leaf_restores_into_the_port_only(tmp_path):
    """repro writes a bf16 leaf as a 2-byte void type, which its own
    restore cannot read back (jnp.asarray refuses it: ROADMAP C); the
    port reads its bits through an int16 view."""
    x = jnp.asarray([0.5, -1.25, 3.0e38, 1e-3], jnp.bfloat16)
    jsave_pytree({"w": x, "step": jnp.int32(3)}, str(tmp_path))
    got = restore_pytree(str(tmp_path), "cpu")
    assert got["w"].dtype == torch.bfloat16 and int(got["step"]) == 3
    assert np.array_equal(got["w"].float().numpy(),
                          np.asarray(x.astype(jnp.float32)))
    with pytest.raises(TypeError):
        jrestore_pytree(str(tmp_path))


def test_a_checkpoint_repro_wrote_restores_and_trains_on(tmp_path):
    """repro trains its reduced Gemma-2 two steps and checkpoints
    (params, opt); the port restores it equal to convert's output and its
    next step matches repro's."""
    ja = jget_arch("gemma2_2b")
    ja = dataclasses.replace(ja, model=ja.model.reduced(dtype=jnp.float32))
    ta = tconfigs.get_arch("gemma2_2b")
    ta = dataclasses.replace(ta, model=ta.model.reduced(dtype=torch.float32))
    mesh = Mesh(np.asarray(jax.devices()[:1]).reshape(1, 1),
                ("data", "model"))
    jshape = JShapeCfg("t", "train", 16, 4, microbatches=2)
    fn, _, _ = jmake_train_step(ja, mesh, jshape, peak_lr=1e-3, warmup=2)
    jstep = jax.jit(fn)
    jp = jcommon.init_params(ja.model, jax.random.PRNGKey(0))
    jo = jadamw_init(jp)
    for s in range(2):
        jp, jo, _ = jstep(jp, jo, jshaped_batch(ja.model, 0, s, jshape))
    ck = JCheckpointManager(str(tmp_path))
    ck.save(2, {"params": jp, "opt": jo}, blocking=True)

    m = CheckpointManager(str(tmp_path))
    assert m.latest_step() == 2
    state = m.restore("cpu")
    want_p = convert.lm_params_from_state(
        {k: np.asarray(v) for k, v in jp.items()}, ta.model, "cpu")
    want_o = convert.opt_state_from_state(jax.tree.map(np.asarray, jo), ta,
                                          ta.model, "cpu")
    assert_bitwise(state["params"], want_p)
    assert_bitwise(state["opt"], want_o)

    b = {k: np.asarray(v) for k, v in
         jshaped_batch(ja.model, 0, 2, jshape).items()}
    jp, jo, jm = jstep(jp, jo, b)
    tstep = make_train_step(ta, ShapeCfg("t", "train", 16, 4,
                                         microbatches=2),
                            peak_lr=1e-3, warmup=2, device="cpu")
    tp, to, tm = tstep(state["params"], state["opt"],
                       {"tokens": torch.as_tensor(b["tokens"]).long()})
    for k in ("loss", "grad_norm", "lr"):
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=RTOL)
    for k in jp:
        want = np.asarray(jp[k])
        np.testing.assert_allclose(tp[k].numpy(), want, rtol=RTOL,
                                   atol=ATOL * np.abs(want).max())
    assert int(to["step"]) == 3


def test_prefetch_loader_yields_steps_in_order_and_stops():
    with PrefetchLoader(lambda s: {"s": s * 2}, start_step=4,
                        depth=2) as it:
        got = [next(it) for _ in range(5)]
    assert got == [(s, {"s": 2 * s}) for s in range(4, 9)]
    assert not it._thread.is_alive()


def test_prefetch_loader_hands_a_failed_batch_to_the_consumer():
    def make(s):
        if s == 2:
            raise ValueError("bad batch")
        return s

    it = PrefetchLoader(make)
    assert [next(it), next(it)] == [(0, 0), (1, 1)]
    with pytest.raises(ValueError, match="bad batch"):
        next(it)
    it.close()
    assert not it._thread.is_alive()


def _launch(ckpt_dir, *extra):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    return subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--device", "cpu",
         "--steps", "10", "--ckpt-every", "5", "--log-every", "1",
         "--ckpt-dir", str(ckpt_dir), *extra],
        capture_output=True, text=True, env=env, timeout=300)


def test_launcher_resumes_bit_exact_after_an_injected_failure(tmp_path):
    killed = _launch(tmp_path / "a", "--inject-failure", "7")
    assert killed.returncode == 42, killed.stderr
    assert "injected failure at step 7" in killed.stdout
    assert sorted(os.listdir(tmp_path / "a")) == ["step_000000005"]
    resumed = _launch(tmp_path / "a", "--inject-failure", "7")
    assert resumed.returncode == 0, resumed.stderr
    assert "restored checkpoint at step 5" in resumed.stdout
    assert "step     5 loss" in resumed.stdout
    assert "step     4 loss" not in resumed.stdout
    whole = _launch(tmp_path / "b")
    assert whole.returncode == 0, whole.stderr
    assert "mesh: (1, 1) ('data', 'model')" in whole.stdout
    assert "host snapshot" in whole.stdout
    a = restore_pytree(str(tmp_path / "a" / "step_000000010"), "cpu")
    b = restore_pytree(str(tmp_path / "b" / "step_000000010"), "cpu")
    assert_bitwise(a, b)
    assert int(a["opt"]["step"]) == 10


def test_launcher_asks_for_the_card_by_default():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default runs there")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    r = subprocess.run([sys.executable, "-m", "repro_torch.launch.train",
                        "--steps", "1"], capture_output=True, text=True,
                       env=env, timeout=300)
    assert r.returncode != 0
    assert "is_available() is false" in r.stderr
