"""The port's fault injection and fault tolerance (``repro_torch.runtime``)
make the same decisions as the reference's (``repro.runtime``) on the same
inputs: seeded random schedules, heartbeat sequences with registers and
rejoins, straggle factors and straggler picks, elastic planner
trajectories, and the bytes a corrupted or truncated checkpoint leaf ends
up with.  One parametrised test per class."""
import os

import numpy as np
import pytest

from repro.runtime import fault_tolerance as JFT
from repro.runtime import faults as JF
from repro_torch.runtime import fault_tolerance as TFT
from repro_torch.runtime import faults as TF


def _events(schedule):
    return [(e.step, e.kind, e.target, e.duration) for e in schedule]


@pytest.mark.parametrize("seed", range(20))
def test_random_schedules_match(seed):
    """``FaultSchedule.random`` from 20 seeds (pod counts, kills,
    corruptions and delays varied with the seed): the same events, and
    ``due`` delivers them at the same steps."""
    kw = dict(seed=seed, n_steps=10 + 3 * seed, n_pods=2 + seed % 4,
              n_kills=1 + seed % 3, n_corruptions=seed % 2,
              n_delays=seed % 3)
    j, t = JF.FaultSchedule.random(**kw), TF.FaultSchedule.random(**kw)
    assert _events(t) == _events(j)
    for step in range(kw["n_steps"] + 1):
        assert _events(t.due(step)) == _events(j.due(step))
    assert len(t) == len(j) == 0
    assert _events(t.fired) == _events(j.fired)
    pr = (TF.FaultSchedule.preempt_and_rejoin(seed % 3, 4, 8),
          JF.FaultSchedule.preempt_and_rejoin(seed % 3, 4, 8))
    assert _events(pr[0]) == _events(pr[1])


def _heartbeat_script(mod, seed):
    """A seeded sequence of beats, deaths, registers and rejoins; returns
    what the monitor reports after every action."""
    rng = np.random.RandomState(seed)
    mon = mod.HeartbeatMonitor(3, timeout_s=5.0)
    out, now = [], 0.0
    for i in range(60):
        now += float(rng.uniform(0.1, 2.0))
        op = rng.randint(5)
        pod = int(rng.randint(5))
        if op == 0:
            mon.mark_dead(pod)
        elif op == 1:
            mon.register(pod, now=now)
        elif op == 2:
            mon.drop(pod)
        else:
            mon.beat(pod, float(rng.uniform(0.5, 1.5)), now=now)
        dead = mon.check(now=now + float(rng.uniform(0, 6)))
        out.append((sorted(mon.alive_pods()), dead,
                    {p: list(s.step_times) for p, s in mon.pods.items()}))
    return out


def _straggler_cases(mod, seed):
    rng = np.random.RandomState(100 + seed)
    mon = mod.HeartbeatMonitor(4, timeout_s=1e9)
    for i in range(40):
        for pod in range(4):
            slow = 1.0 + (0.5 if pod == seed % 4 and seed % 2 else 0.0)
            mon.beat(pod, slow * float(1.0 + 0.02 * rng.randn()), now=i)
    if seed % 3 == 0:
        mon.mark_dead(1)
    det = mod.StragglerDetector(threshold=2.0 + seed % 3,
                                mad_floor_frac=0.01 * (1 + seed % 2))
    return det.straggle_factors(mon), det.stragglers(mon)


def _planner_trajectory(mod, seed):
    rng = np.random.RandomState(200 + seed)
    pl = mod.ElasticPlanner(mod.MeshPlan(2 + seed % 3, 1 + seed % 2, 1))
    out = []
    for _ in range(8):
        try:
            if rng.randint(2) and pl.plan.n_pods > 1:
                plan = pl.on_pod_failure([int(rng.randint(1, 4))])
            else:
                plan = pl.on_pod_join(int(rng.randint(1, 3)))
        except RuntimeError as e:
            out.append(str(e))
            continue
        out.append((plan.n_pods, plan.data, plan.model, plan.shape,
                    plan.axis_names, pl.rebalanced_batch(24),
                    pl.rebalanced_rows(12, 2 + seed % 3)))
    return out


CLASSES = {
    "HeartbeatMonitor": _heartbeat_script,
    "StragglerDetector": _straggler_cases,
    "ElasticPlanner": _planner_trajectory,
}


@pytest.mark.parametrize("seed", range(6))
@pytest.mark.parametrize("name", sorted(CLASSES))
def test_fault_tolerance_decisions_match(name, seed):
    fn = CLASSES[name]
    assert fn(TFT, seed) == fn(JFT, seed)


def _leaf_file(d, step, n):
    os.makedirs(d / f"step_{step:08d}", exist_ok=True)
    arr = np.arange(n, dtype=np.float32).reshape(-1, 4)
    for i in range(3):
        np.save(d / f"step_{step:08d}" / f"leaf_{i}.npy", arr * (i + 1))


@pytest.mark.parametrize("case", ["corrupt", "corrupt_newest",
                                  "corrupt_fallback_name", "truncate",
                                  "tiny"])
def test_checkpoint_corruptors_match(tmp_path, case):
    """The corruptors flip (or cut) the same bytes of the same file."""
    got = {}
    for name, mod in (("port", TF), ("ref", JF)):
        d = tmp_path / name
        _leaf_file(d, 3, 4096)
        _leaf_file(d, 7, 4096 if case != "tiny" else 8)
        if case == "corrupt":
            path = mod.corrupt_checkpoint_leaf(str(d), 1, step=3, seed=11)
        elif case == "corrupt_newest":
            path = mod.corrupt_checkpoint_leaf(str(d), 2, seed=5, n_bytes=9)
        elif case == "corrupt_fallback_name":
            path = mod.corrupt_checkpoint_leaf(str(d), 7, step=3, seed=2)
        elif case == "truncate":
            path = mod.truncate_checkpoint_leaf(str(d), 0)
        else:
            path = mod.corrupt_checkpoint_leaf(str(d), 0, seed=1,
                                               n_bytes=500)
        got[name] = (None if path is None else os.path.relpath(path, d),
                     {f: (d / f).read_bytes() for f in sorted(
                         os.path.relpath(os.path.join(r, x), d)
                         for r, _, xs in os.walk(d) for x in xs)})
    assert got["port"] == got["ref"]
    assert got["port"][0] is not None


def test_fault_events_reject_unknown_kinds():
    with pytest.raises(ValueError, match="unknown fault kind"):
        TF.FaultEvent(3, "meteor_strike")
    with pytest.raises(ValueError):
        TF.FaultSchedule.preempt_and_rejoin(pod=1, kill_step=9,
                                            rejoin_step=4)
    assert TF.KINDS == JF.KINDS
