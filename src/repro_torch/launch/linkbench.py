"""Measure the pod link: the rate and per-hop latency of the port's
transport between two pod processes, the constants behind the ring's
chunk grid (``repro_torch.core.planexec.LINK_BW`` and
``RING_HOP_LATENCY_S``) and, with ``--edge 2``, the intra-cluster rate of
the two-tier hierarchy (``INTRA_BW``).

    python -m repro_torch.launch.linkbench [--device cuda] [--iters 8]
        [--edge 2] [--out PATH]

``--edge 2`` starts a 2 x 2 fleet (four pod processes, ``spawn_pods(...,
n_edge=2)``) and plays the ping-pong over cluster 0's ``intra`` sub-group
while the other cluster waits, so that one pair is measured, as without
it.

Two pods (``spawn_pods``) play ping-pong with messages of 4 KB to 64 MB
over the transport their layout gets: on one card, gloo over loopback
TCP with each message staged device -> pinned host -> device, as the
ring's hops move it.  A leg is the sender's copy to pinned memory, the
stream synchronisation, the gloo send and receive, and the receiver's copy
back to its device and synchronisation; the one-way time of a size is half
the median round trip.  The fit ``t(s) = latency + s / rate`` minimises
the relative error over all sizes.  Prints one JSON object: the card, the
backend, per size the one-way seconds, and the fit.
"""
from __future__ import annotations

import argparse
import json
import statistics
import time
from pathlib import Path

import torch
import torch.distributed as dist

#: message sizes, bytes: 4 KB to 64 MB in steps of 4x
SIZES = tuple(4096 * 4 ** i for i in range(8))


def _leg_send(group, buf, host, peer):
    if group.staged:
        host.copy_(buf, non_blocking=True)
        torch.cuda.current_stream(group.device).synchronize()
        dist.send(host, peer, group=group.pg)
    else:
        dist.send(buf, peer, group=group.pg)


def _leg_recv(group, buf, host, peer):
    if group.staged:
        dist.recv(host, peer, group=group.pg)
        buf.copy_(host, non_blocking=True)
        torch.cuda.current_stream(group.device).synchronize()
    else:
        dist.recv(buf, peer, group=group.pg)
        if buf.is_cuda:
            torch.cuda.current_stream(group.device).synchronize()


def ping_pong(group, sizes=SIZES, iters: int = 8) -> dict:
    """Pods 0 and 1 of ``group`` (a pod group or a sub-group of one)
    bounce each size ``iters`` times (after one warm-up round trip); both
    return the same result dict."""
    if group.size != 2:
        raise ValueError(f"ping-pong needs 2 pods, got {group.size}")
    peer = group.ranks[1 - group.rank]
    one_way = []
    for s in sizes:
        buf = torch.full((s,), group.rank + 1, dtype=torch.uint8,
                         device=group.device)
        host = torch.empty((s,), dtype=torch.uint8,
                           pin_memory=group.staged)
        rtts = []
        for it in range(iters + 1):
            group.barrier()
            t0 = time.perf_counter()
            if group.rank == 0:
                _leg_send(group, buf, host, peer)
                _leg_recv(group, buf, host, peer)
            else:
                _leg_recv(group, buf, host, peer)
                _leg_send(group, buf, host, peer)
            if it:
                rtts.append(time.perf_counter() - t0)
        one_way.append(statistics.median(rtts) / 2)
    # rank 0's timings are the result on every pod
    dev = group.device if group.backend == "nccl" else "cpu"
    t = torch.tensor(one_way, dtype=torch.float64, device=dev)
    dist.broadcast(t, group.ranks[0], group=group.pg)
    t = t.cpu()
    # t = a + s * c, least squares on the relative error: rows (1, s) / t
    s = torch.tensor(sizes, dtype=torch.float64)
    a = torch.stack([1.0 / t, s / t], dim=1)
    coef = torch.linalg.lstsq(a, torch.ones_like(t)[:, None]).solution[:, 0]
    return {"backend": group.backend, "staged": group.staged,
            "tier": group.tier,
            "sizes": list(sizes), "one_way_s": t.tolist(),
            "latency_s": float(coef[0]),
            "rate_bytes_per_s": 1.0 / float(coef[1]), "iters": iters}


def _pod(group, iters):
    """Ping-pong over the pod pair, or over cluster 0's intra sub-group of
    a hierarchical fleet (the other members wait at the fleet barrier)."""
    out = None
    if group.intra is None:
        out = ping_pong(group, iters=iters)
    elif group.rank < group.n_edge:
        out = ping_pong(group.intra, iters=iters)
    group.barrier()
    if out is not None and group.device.type == "cuda":
        out["card"] = torch.cuda.get_device_name(group.device)
    return out


def main(argv=None):
    from repro_torch.launch.mesh import spawn_pods
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--iters", type=int, default=8)
    ap.add_argument("--edge", type=int, default=1, choices=(1, 2),
                    help="2: measure the intra tier of a 2 x 2 fleet")
    ap.add_argument("--out", default="")
    args = ap.parse_args(argv)
    res = spawn_pods(_pod, 2 * args.edge, args.device, args=(args.iters,),
                     n_edge=args.edge, timeout=900)[0]
    text = json.dumps(res)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(text + "\n")
    print(text)


if __name__ == "__main__":
    main()
