"""The dry run's traced counts, on the CPU (``repro_torch/launch/
dryrun.py``; the untraced cells against the reference are in
``tests/test_torch_dryrun.py``).

* One cell per family traced in full on the 2 x 16 x 16 production
  layout, at full width — the train step of starcoder2-3b (its 24 heads
  over model = 16 split as the reference splits them), dbrx-132b,
  falcon-mamba-7b, recurrentgemma-2b (10 heads over 16) and
  seamless-m4t-medium, cut in depth to one layer or one group (a
  layer's counts repeat: the cut keeps the test inside the tier-1
  budget; ``python -m repro_torch.launch.dryrun`` traces them whole):
  each record ``ok``, and the bytes its pod tier logged equal the exec
  plan's priced bytes (``plan_wire_bytes`` of the rank's local layout).
* A step of SMOKE paper-350m on (1, 2) and on P = 2 pods x (1, 2) as
  real gloo ranks (``tests/torch_dryrun_ranks.py``) under the same
  counters: rank 0's counted FLOPs, state bytes and collective bytes and
  counts by op and tier equal the dry run's on the meta device.
"""
from torch_env import process_settings  # noqa: F401  (tests/torch_env.py)
import pytest

from repro_torch.configs import ARCHS, SHAPES
from repro_torch.configs.base import RunConfig
from repro_torch.launch.dryrun import dry_step
from repro_torch.launch.memory import cut_depth
from torch_dryrun_ranks import BATCH, SEQ, run_config, step_rank

#: one arch per family, and the depth its traced cell is cut to
FAMILIES = {"starcoder2-3b": 1, "dbrx-132b": 1, "falcon-mamba-7b": 1,
            "recurrentgemma-2b": 3, "seamless-m4t-medium": 1}
PAYLOAD_OPS = ("gather", "ring", "full")


@pytest.mark.parametrize("arch", sorted(FAMILIES))
def test_a_cell_per_family_traces_and_prices_its_pod_bytes(arch):
    cfg = cut_depth(ARCHS[arch], FAMILIES[arch])
    shape = SHAPES["train_4k"]
    rec = dry_step(cfg, shape, P=2, D=16, M=16,
                   run=RunConfig(model=cfg, shape=shape, multi_pod=True))
    w = rec["walker"]
    assert w["flops_per_device"] > 0 and w["bytes_per_device"] > 0
    assert rec["memory"]["peak_bytes"] > rec["memory"]["state_bytes"]
    assert rec["state_bytes_per_rank"]["max"] >= \
        rec["state_bytes_per_rank"]["traced"]
    assert sum(k["launches"] for k in w["kernels"].values()) > 0
    pod = {k: v for k, v in w["collective_bytes_per_device"].items()
           if k.endswith("/pod") and k.split("/")[0] in PAYLOAD_OPS}
    assert pod and sum(pod.values()) == rec["pod_priced_bytes"]
    assert "model" in {k.split("/")[1] for k in
                       w["collective_bytes_per_device"]}


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    from repro_torch.launch.mesh import spawn_pods, stop_start_server
    tmp = tmp_path_factory.mktemp("dryrun_ranks")
    out = {}
    try:
        for P in (1, 2):
            out[P] = spawn_pods(step_rank, P * 2, "cpu", args=(P, 1, 2),
                                init_method=f"file://{tmp / f'store{P}'}",
                                threads=1, timeout=600)
    finally:
        stop_start_server()
    return out


@pytest.mark.parametrize("P", (1, 2))
def test_counts_equal_the_real_ranks(ranks, P):
    run = run_config()
    assert (run.shape.seq_len, run.shape.global_batch) == (SEQ, BATCH)
    rec = dry_step(run.model, run.shape, P=P, D=1, M=2, run=run)
    real = ranks[P][0]
    w = rec["walker"]
    assert w["flops_per_device"] == real["flops"]
    assert rec["memory"]["state_bytes"] == real["state_bytes"]
    assert w["collective_bytes_per_device"] == real["collective_bytes"]
    assert w["collective_counts"] == real["collective_count"]
    assert rec["state_bytes_per_rank"]["max"] == max(
        r["state_bytes"] for r in ranks[P])
