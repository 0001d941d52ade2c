"""Port of checkpointing and the fault control plane
(``distributed/checkpoint.py``, ``distributed/fault.py``): each case of
``tests/test_checkpoint.py`` on the port; checkpoints written by either
package restore bit for bit in the other (bf16 leaves included, stored as
2-byte records); the injector's schedule and seeded draws, the restart
supervisor and the straggler monitor equal the reference's. Everything
here is exact.
"""
import json
import os
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.distributed.checkpoint as JC
import repro.distributed.fault as JF
import repro_torch.distributed.checkpoint as TC
import repro_torch.distributed.fault as TF
from repro_torch.distributed.sharding import ParamSpec
from torch_parity import isolated_plan_caches

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _isolate_plan_caches():
    with isolated_plan_caches():
        yield


def _np_tree(seed=0):
    r = np.random.default_rng(seed)
    return {"layers": {"w": r.normal(0, 1, (4, 8, 8)).astype(np.float32),
                       "b": r.normal(0, 1, (4, 8)).astype(np.float32)},
            "step": np.asarray(7 + seed, np.int32)}


def _tree(seed=0):
    """The reference test's tree on the port: a bf16 stacked matrix, a
    float32 bias, an int32 scalar."""
    t = _np_tree(seed)
    return {"layers": {"w": torch.from_numpy(t["layers"]["w"]).to(
                torch.bfloat16),
                       "b": torch.from_numpy(t["layers"]["b"])},
            "step": torch.from_numpy(t["step"])}


def _jax_tree(seed=0):
    t = _np_tree(seed)
    return {"layers": {"w": jnp.asarray(t["layers"]["w"], jnp.bfloat16),
                       "b": jnp.asarray(t["layers"]["b"])},
            "step": jnp.asarray(t["step"])}


def _bits(x):
    """A leaf's raw bytes, dtype name and shape (bf16 as its 16 bits)."""
    if isinstance(x, torch.Tensor):
        name = str(x.dtype).split(".")[-1]
        if x.dtype == torch.bfloat16:
            x = x.view(torch.int16)
        return x.numpy().tobytes(), name, tuple(x.shape)
    a = np.asarray(x)
    return a.tobytes(), a.dtype.name, a.shape


def _assert_bit_equal(a, b):
    la = TC._flatten_with_paths(a) if not _is_jax(a) else _jax_flat(a)
    lb = TC._flatten_with_paths(b) if not _is_jax(b) else _jax_flat(b)
    assert [k for k, _ in la] == [k for k, _ in lb]
    for (k, x), (_, y) in zip(la, lb):
        assert _bits(x) == _bits(y), k


def _is_jax(tree):
    return any(isinstance(x, jax.Array) for x in jax.tree_util.tree_leaves(
        tree))


def _jax_flat(tree):
    return [(k, v) for k, v in JC._flatten_with_paths(tree)]


# ---------------------------------------------------------------------------
# tests/test_checkpoint.py on the port
# ---------------------------------------------------------------------------

def test_save_restore_roundtrip(tmp_path):
    t = _tree()
    TC.save_checkpoint(str(tmp_path), 12, t, extra={"note": "hi"})
    assert TC.latest_step(str(tmp_path)) == 12
    got, extra = TC.restore_checkpoint(str(tmp_path), t, device="cpu")
    _assert_bit_equal(t, got)
    assert extra["note"] == "hi"


def test_atomicity_no_partial_visible(tmp_path):
    TC.save_checkpoint(str(tmp_path), 1, _tree())
    # a stale tmp dir from a crashed writer must not be visible
    os.makedirs(str(tmp_path / "step_00000002.tmp"))
    assert TC.latest_step(str(tmp_path)) == 1
    assert TC.all_steps(str(tmp_path)) == [1]


def test_restore_shape_mismatch_raises(tmp_path):
    t = _tree()
    TC.save_checkpoint(str(tmp_path), 3, t)
    bad = dict(t, step=torch.zeros((2,), dtype=torch.int32))
    with pytest.raises(ValueError):
        TC.restore_checkpoint(str(tmp_path), bad, device="cpu")
    with pytest.raises(KeyError):
        TC.restore_checkpoint(str(tmp_path), dict(t, extra=t["step"]),
                              device="cpu")
    with pytest.raises(FileNotFoundError):
        TC.restore_checkpoint(str(tmp_path / "none"), t, device="cpu")


def test_manager_retention_and_async(tmp_path):
    m = TC.CheckpointManager(str(tmp_path), keep_n=2, async_write=True)
    for s in range(5):
        m.save(s, _tree(s))
    m.wait()
    assert m.all_steps() == [3, 4]
    got, _ = m.restore(_tree(), device="cpu")
    _assert_bit_equal(_tree(4), got)
    m.close()
    per_save = 4 * 8 * 8 * 2 + 4 * 8 * 4 + 4      # bf16 w, float32 b, step
    assert {k: m.stats[k] for k in ("saves", "bytes", "restores")} == \
        {"saves": 5, "bytes": 5 * per_save, "restores": 1}
    assert min(m.stats["save_s"], m.stats["write_s"],
               m.stats["restore_s"]) > 0


def test_manager_sync_mode(tmp_path):
    m = TC.CheckpointManager(str(tmp_path), keep_n=0, async_write=False)
    m.save(0, _tree(0))
    m.save(1, _tree(1))
    assert m.all_steps() == [0, 1]      # keep_n=0 => keep everything
    m.close()


def test_restore_onto_the_named_device_and_from_specs(tmp_path):
    # the port's counterpart of the reference's elastic-restore case: no
    # mesh yet, every leaf whole on the device the caller names; a tree
    # of ParamSpecs (shape + logical axes + dtype) serves as ``like`` too
    t = _tree()
    TC.save_checkpoint(str(tmp_path), 0, t)
    specs = {"layers": {"w": ParamSpec((4, 8, 8), ("layers", None, None)),
                        "b": ParamSpec((4, 8), ("layers", None),
                                       torch.float32)},
             "step": ParamSpec((), (), torch.int32)}
    got, _ = TC.restore_checkpoint(str(tmp_path), specs, device="cpu")
    _assert_bit_equal(t, got)
    assert all(x.device.type == "cpu" for _, x in
               TC._flatten_with_paths(got))


def test_async_save_copies_before_the_state_changes(tmp_path):
    # the optimizer updates its state in place: a save must hold the
    # values at save time, not the live storage
    m = TC.CheckpointManager(str(tmp_path), keep_n=1, async_write=True)
    t = _tree()
    want = {k: v.clone() for k, v in t["layers"].items()}
    m.save(0, t)
    t["layers"]["w"].add_(1.0)
    t["layers"]["b"].mul_(-2.0)
    got, _ = m.restore(_tree(), device="cpu")
    m.close()
    for k in want:
        assert torch.equal(got["layers"][k], want[k]), k


def _slow_writes(monkeypatch, module):
    """The module's writer takes 0.3 s a checkpoint, as a large one on a
    slow disk does."""
    real = module._write_host_copy

    def slow(*args):
        time.sleep(0.3)
        return real(*args)

    monkeypatch.setattr(module, "_write_host_copy", slow)


def test_latest_step_sees_a_pending_async_write(tmp_path, monkeypatch):
    # a restart right after an async save must resume from that save;
    # the reference's manager answers from the directory alone and, with
    # the write still in flight, finds no checkpoint (pinned: Queue 3)
    _slow_writes(monkeypatch, TC)
    _slow_writes(monkeypatch, JC)
    m = TC.CheckpointManager(str(tmp_path / "t"), keep_n=2)
    m.save(4, _tree())
    assert m.latest_step() == 4 and m.all_steps() == [4]
    m.close()
    jm = JC.CheckpointManager(str(tmp_path / "j"), keep_n=2)
    jm.save(4, _jax_tree())
    assert jm.latest_step() is None
    jm.wait()
    assert jm.latest_step() == 4
    jm.close()


def test_tuples_lists_and_training_state_keys(tmp_path):
    state = ({"embed": {"embedding": torch.ones(3, 2, dtype=torch.bfloat16)}},
             {"mu": {"embed": {"embedding": torch.zeros(3, 2)}}},
             [torch.arange(3)])
    TC.save_checkpoint(str(tmp_path), 5, state)
    with open(tmp_path / "step_00000005" / "manifest.json") as f:
        leaves = json.load(f)["leaves"]
    assert leaves == {"0/embed/embedding": {"shape": [3, 2],
                                            "dtype": "bfloat16"},
                      "1/mu/embed/embedding": {"shape": [3, 2],
                                               "dtype": "float32"},
                      "2/0": {"shape": [3], "dtype": "int64"}}
    got, _ = TC.restore_checkpoint(str(tmp_path), state, device="cpu")
    assert isinstance(got, tuple) and isinstance(got[2], list)
    _assert_bit_equal(state, got)


# ---------------------------------------------------------------------------
# across the packages
# ---------------------------------------------------------------------------

def test_port_checkpoint_restores_in_the_reference(tmp_path):
    TC.save_checkpoint(str(tmp_path), 4, _tree(1), extra={"step": 4})
    got, extra = JC.restore_checkpoint(str(tmp_path), _jax_tree())
    assert extra == {"step": 4}
    assert got["layers"]["w"].dtype == jnp.bfloat16
    _assert_bit_equal(_tree(1), got)


def test_reference_checkpoint_restores_in_the_port(tmp_path):
    JC.save_checkpoint(str(tmp_path), 9, _jax_tree(2), extra={"step": 9})
    got, extra = TC.restore_checkpoint(str(tmp_path), _tree(), device="cpu")
    assert extra == {"step": 9}
    assert got["layers"]["w"].dtype == torch.bfloat16
    _assert_bit_equal(_jax_tree(2), got)


def test_manifests_match_the_reference(tmp_path):
    TC.save_checkpoint(str(tmp_path / "t"), 3, (_tree(), _tree(1)),
                       extra={"a": 1})
    JC.save_checkpoint(str(tmp_path / "j"), 3, (_jax_tree(), _jax_tree(1)),
                       extra={"a": 1})
    docs = []
    for side in ("t", "j"):
        with open(tmp_path / side / "step_00000003" / "manifest.json") as f:
            docs.append(json.load(f))
        with open(tmp_path / side / "LATEST") as f:
            assert f.read() == "step_00000003"
    assert docs[0] == docs[1]


# ---------------------------------------------------------------------------
# failure injection, restarts, stragglers (tests/test_checkpoint.py's
# cases, each against the reference)
# ---------------------------------------------------------------------------

def _fired(inj, steps):
    out = []
    for s in steps:
        try:
            inj.maybe_fail(s)
        except (TF.SimulatedFailure, JF.SimulatedFailure) as e:
            out.append((s, str(e)))
    return out


def test_injector_schedule_fires_once():
    for mod in (TF, JF):
        inj = mod.FailureInjector(schedule=(3,))
        inj.maybe_fail(2)
        with pytest.raises(mod.SimulatedFailure):
            inj.maybe_fail(3)
        inj.maybe_fail(3)        # second pass survives (post-restart replay)


@pytest.mark.parametrize("p,seed,max_failures", [(0.3, 42, 100),
                                                 (0.05, 7, 100),
                                                 (0.5, 1, 4)])
def test_injector_draws_match_the_reference(p, seed, max_failures):
    kw = dict(schedule=(2, 11), p=p, seed=seed, max_failures=max_failures)
    steps = list(range(60)) + list(range(30))       # a replay after restarts
    got = _fired(TF.FailureInjector(**kw), steps)
    assert got == _fired(JF.FailureInjector(**kw), steps) and got
    assert got == _fired(TF.FailureInjector(**kw), steps)


def _restart_loop(mod, schedule):
    state = {"completed": [], "attempts": 0, "resumes": []}
    inj = mod.FailureInjector(schedule=schedule)

    def loop(resume):
        state["attempts"] += 1
        state["resumes"].append(resume)
        start = len(state["completed"])     # "restore from checkpoint"
        for step in range(start, 8):
            inj.maybe_fail(step)
            state["completed"].append(step)
        return state["completed"]

    return loop, state


def test_run_with_restarts_matches_the_reference():
    outs = []
    for mod in (TF, JF):
        loop, state = _restart_loop(mod, (2, 5))
        restarted = []
        result, report = mod.run_with_restarts(
            loop, mod.RestartPolicy(max_restarts=3),
            on_restart=restarted.append)
        assert result == list(range(8)) and report.restarts == 2
        assert state["attempts"] == 3 and restarted == [1, 2]
        outs.append((result, report.restarts, report.failures,
                     state["resumes"]))
    assert outs[0] == outs[1]


def test_run_with_restarts_gives_up():
    for mod in (TF, JF):
        def loop(resume, mod=mod):
            raise mod.SimulatedFailure("always")

        with pytest.raises(mod.SimulatedFailure):
            mod.run_with_restarts(loop, mod.RestartPolicy(max_restarts=2))


@pytest.mark.parametrize("times", [
    [[1.0, 1.0, 1.0, 3.0]],
    [[1.0, 3.0, 1.0, 1.0]] + [[1.0, 1.0, 1.0, 1.0]] * 8,
    [[0.5, 0.6, 0.4, 2.0], [0.5, 0.6, 0.4, 0.5], [2.0, 0.6, 0.4, 0.5]],
])
def test_straggler_monitor_matches_the_reference(times):
    t = TF.StragglerMonitor(n_hosts=4, alpha=0.5, threshold=1.4)
    j = JF.StragglerMonitor(n_hosts=4, alpha=0.5, threshold=1.4)
    assert t.stragglers() == j.stragglers() == []
    for row in times:
        t.observe(row)
        j.observe(row)
        assert t.stragglers() == j.stragglers()
        assert t.ema.tobytes() == j.ema.tobytes()
        assert t.shard_weights().tobytes() == j.shard_weights().tobytes()
    with pytest.raises(ValueError):
        t.observe([1.0])


def test_straggler_detection_and_weights():
    mon = TF.StragglerMonitor(n_hosts=4, alpha=1.0, threshold=1.5)
    mon.observe([1.0, 1.0, 1.0, 3.0])
    assert mon.stragglers() == [3]
    w = mon.shard_weights()
    assert w.sum() == pytest.approx(4.0)
    assert w[3] < w[0]          # slow host gets less data
