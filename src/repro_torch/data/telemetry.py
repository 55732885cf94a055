"""Telemetry traces for the cloud-edge simulation (paper section 4.1-4.2).

Generates per-device/per-pod bandwidth and latency traces matching the
paper's testbed: bandwidth fluctuating in 5-200 Mbps, latency 10-300 ms,
plus jitter and straggle factors.  Traces are deterministic in (seed,
device, step) so simulated runs are reproducible and restart-safe.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, List

import numpy as np

BW_MIN, BW_MAX = 5.0, 200.0         # Mbps, paper section 4.2
LAT_MIN, LAT_MAX = 10.0, 300.0      # ms

_MASK64 = (1 << 64) - 1
# splitmix64 multipliers (Steele et al.); also used to mix the counters in.
_MIX_A = 0x9E3779B97F4A7C15
_MIX_B = 0xBF58476D1CE4E5B9
_MIX_C = 0x94D049BB133111EB


def _hash01(seed: int, device_id: int, step: int, salt: int) -> float:
    """Deterministic uniform in [0, 1) from the (seed, device, step, salt)
    counter — a splitmix64 finalizer over the mixed counters.  Replaces
    the seed's per-call ``np.random.RandomState`` construction (~20us of
    Mersenne state init per sample) with a few integer ops, so replaying
    64-device traces for thousands of steps stays off the host control
    loop's critical path.  Bit-stable across platforms: pure 64-bit
    integer arithmetic, no RNG library state."""
    z = (seed * _MIX_A + device_id * _MIX_B + step * _MIX_C + salt) & _MASK64
    z = (z + _MIX_A) & _MASK64
    z ^= z >> 30
    z = (z * _MIX_B) & _MASK64
    z ^= z >> 27
    z = (z * _MIX_C) & _MASK64
    z ^= z >> 31
    return z / 2.0 ** 64


@dataclasses.dataclass
class DeviceProfile:
    device_id: int
    base_bandwidth: float     # Mbps
    base_latency: float       # ms
    jitter: float             # 0..1 relative fluctuation
    straggle: float           # >= 1.0 slowdown factor


def make_profiles(n_devices: int, seed: int = 0) -> List[DeviceProfile]:
    rng = np.random.RandomState(seed)
    profiles = []
    for i in range(n_devices):
        # log-uniform bandwidth within the paper's range; heterogeneous tiers
        bw = float(np.exp(rng.uniform(math.log(BW_MIN), math.log(BW_MAX))))
        lat = float(rng.uniform(LAT_MIN, LAT_MAX))
        jit = float(rng.uniform(0.05, 0.4))
        straggle = float(1.0 + rng.exponential(0.15))
        profiles.append(DeviceProfile(i, bw, lat, jit, straggle))
    return profiles


def bandwidth_at(profile: DeviceProfile, step: int, seed: int = 0) -> float:
    """Smooth + bursty bandwidth fluctuation at a given step (Mbps).

    Deterministic in (seed, device, step) — tests/test_hierarchy.py pins
    golden values so the trace contract survives refactors."""
    phase = (profile.device_id * 997 + seed * 31) % 1000
    slow = math.sin((step + phase) / 50.0) * 0.5 * profile.jitter
    u = _hash01(seed, profile.device_id, step, salt=1)
    burst = (2.0 * u - 1.0) * profile.jitter * 0.5
    bw = profile.base_bandwidth * (1.0 + slow + burst)
    return float(min(max(bw, BW_MIN), BW_MAX))


def latency_at(profile: DeviceProfile, step: int, seed: int = 0) -> float:
    u = _hash01(seed, profile.device_id, step, salt=2)
    lat = profile.base_latency * (1.0 + u * profile.jitter)
    return float(min(max(lat, LAT_MIN), LAT_MAX))


def snapshot(profiles: List[DeviceProfile], step: int,
             seed: int = 0) -> List[Dict]:
    """Telemetry dicts for clustering / scheduling at one step."""
    return [{
        "bandwidth_mbps": bandwidth_at(p, step, seed),
        "latency_ms": latency_at(p, step, seed),
        "jitter": p.jitter,
        "straggle": p.straggle,
    } for p in profiles]
