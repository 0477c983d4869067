"""The port's fault-tolerance runtime (``repro_torch.runtime``) and the
trainer's crash and resume on the CPU.

The reference's monitor tests run against the port; one fake-clock trace
of heartbeats from a dying worker and a straggler drives the reference's
monitor and restart policy and the port's side by side, and every
decision (dead workers, stragglers, EWMA step times, health, restart
actions) must be equal.  ``test_trainer_resumes_after_crash`` is the
reference's, with the port's ``Trainer`` on ``device="cpu"``; it also
checks that the crashed and the resumed runs' losses equal an
uninterrupted run's.
This file imports nothing of ``repro.core`` or ``repro.kernels``.
"""

import numpy as np
import pytest
import torch

from repro.runtime import HeartbeatMonitor as RefMonitor
from repro.runtime import MonitorConfig as RefMonitorConfig
from repro.runtime import RestartPolicy as RefRestartPolicy
from repro_torch.runtime import (HeartbeatMonitor, MonitorConfig,
                                 RestartPolicy, StepTimer)


@pytest.fixture(autouse=True)
def one_torch_thread():
    """CPU tensors here are small: one intra-op thread runs them faster
    than many, and keeps parallel test workers from oversubscribing the
    cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


class FakeClock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


def test_dead_worker_detection():
    clk = FakeClock()
    mon = HeartbeatMonitor(MonitorConfig(dead_after_s=10), clock=clk)
    mon.heartbeat("w0", 0)
    mon.heartbeat("w1", 0)
    clk.t = 5.0
    mon.heartbeat("w0", 1)
    assert mon.dead_workers() == []
    clk.t = 12.0   # w1 silent for 12s (> 10), w0 only 7s
    assert mon.dead_workers() == ["w1"]
    assert not mon.healthy()


def test_straggler_detection():
    clk = FakeClock()
    mon = HeartbeatMonitor(MonitorConfig(straggler_factor=2.0, ewma=0.0),
                           clock=clk)
    for step in range(3):
        for w in ("w0", "w1", "w2"):
            mon.heartbeat(w, step)
        clk.t += 1.0
    # simulate per-worker timing: w2 five times slower
    mon.step_time = {"w0": 1.0, "w1": 1.1, "w2": 5.0}
    assert mon.stragglers() == ["w2"]


def test_restart_policy():
    p = RestartPolicy(max_restarts=2)
    a = p.on_failure(["w3"])
    assert a["action"] == "restart_from_checkpoint"
    assert a["exclude_workers"] == ["w3"] and a["elastic"]
    p.on_failure([])
    assert p.on_failure([])["action"] == "abort"


def _trace():
    """(clock advance, worker, step) events: w0 steady at 1 s a step, w1
    at 1.2 s, w2 at 3.5 s, w3 silent after step 2, a repeated beat of w0
    at its own step (no timing sample), 30 beats in all."""
    r = np.random.RandomState(7)
    period = {"w0": 1.0, "w1": 1.2, "w2": 3.5, "w3": 1.0}
    due = dict.fromkeys(period, 0.0)
    step = dict.fromkeys(period, 0)
    now, out = 0.0, []
    while len(out) < 30:
        w = min(due, key=due.get)
        if w == "w3" and step[w] > 2:
            due[w] = float("inf")
            continue
        out.append((due[w] - now, w, step[w]))
        now = due[w]
        if w == "w0" and step[w] == 4:
            out.append((0.0, w, step[w]))   # the same step again
        step[w] += 1
        due[w] = now + period[w] * (1 + 0.05 * r.rand())
    return out


@pytest.mark.parametrize("cfg", [dict(), dict(dead_after_s=4.0),
                                 dict(straggler_factor=1.5, ewma=0.3)],
                         ids=["default", "dead4", "factor1.5"])
def test_monitor_decisions_equal_reference(cfg):
    """The same fake-clock trace through both monitors: every decision
    after every beat is equal, and the restart policies' actions too."""
    clocks = [FakeClock(), FakeClock()]
    ref = RefMonitor(RefMonitorConfig(**cfg), clock=clocks[0])
    port = HeartbeatMonitor(MonitorConfig(**cfg), clock=clocks[1])
    ref_pol, port_pol = RefRestartPolicy(max_restarts=3), RestartPolicy(
        max_restarts=3)
    failures = 0
    for dt, w, step in _trace():
        for c in clocks:
            c.t += dt
        ref.heartbeat(w, step)
        port.heartbeat(w, step)
        assert port.step_time == ref.step_time
        assert port.last_step == ref.last_step
        assert port.dead_workers() == ref.dead_workers()
        assert port.stragglers() == ref.stragglers()
        assert port.healthy() == ref.healthy()
        if not ref.healthy():
            failures += 1
            assert port_pol.on_failure(port.dead_workers()) == \
                ref_pol.on_failure(ref.dead_workers())
    assert ref.stragglers() == ["w2"]
    if cfg.get("dead_after_s") == 4.0:
        assert failures > 3   # the policy reached "abort"
        assert port_pol.on_failure([])["action"] == "abort"


def test_step_timer_records_each_step():
    t = StepTimer()
    for _ in range(3):
        t.start()
        assert t.stop() >= 0
    assert len(t.history) == 3


def test_trainer_resumes_after_crash(tmp_path):
    """Kill training mid-run (an injected loader failure), restart,
    converge: the port's Trainer on the CPU.  The resumed steps' losses
    equal those of an uninterrupted run (the data is a function of the
    step, the state restored exactly)."""
    from repro_torch.configs import get_config
    from repro_torch.data import DataConfig, SyntheticLM
    from repro_torch.train import OptimizerConfig, Trainer, TrainerConfig

    cfg = get_config("qwen2-7b", smoke=True)
    data = SyntheticLM(DataConfig(vocab=cfg.vocab, seq_len=32,
                                  global_batch=4, seed=1))

    class CrashyLoader:
        """Raises once at step 12 — simulates a node failure."""

        def __init__(self):
            self.crashed = False

        def __call__(self, step):
            if step == 12 and not self.crashed:
                self.crashed = True
                raise RuntimeError("injected node failure")
            return data.batch(step)

    loader = CrashyLoader()
    targs = dict(steps=16, ckpt_every=5, ckpt_dir=str(tmp_path),
                 log_every=100)
    opt = OptimizerConfig(lr=1e-3, total_steps=16)
    t = Trainer(cfg, loader, opt, TrainerConfig(**targs), global_batch=4,
                device="cpu")
    with pytest.raises(RuntimeError, match="injected"):
        t.run()
    # the async save of step 10 committed on the crash path
    assert t.ckpt.latest_step() == 10
    # supervisor restarts: a fresh Trainer picks up the latest checkpoint
    t2 = Trainer(cfg, loader, opt, TrainerConfig(**targs), global_batch=4,
                 device="cpu")
    state, losses = t2.run()
    # resumed from step 10 checkpoint -> ran only steps 10..15
    assert len(losses) == 6
    assert np.isfinite(losses).all()
    assert t2.ckpt.latest_step() == 16
    assert int(state["opt"]["step"]) == 16

    whole = Trainer(cfg, data.batch, opt, TrainerConfig(
        steps=16, log_every=100), global_batch=4, device="cpu")
    _, ref_losses = whole.run()
    assert t.losses == ref_losses[:12]   # kept through the crash
    assert losses == ref_losses[10:]
