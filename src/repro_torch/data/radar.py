"""Synthetic range-azimuth radar data matching the paper's case study (§IV).

A numpy-only copy of the reference ``repro/data/radar.py``: the same draws
in the same order, so ``make_dataset`` and ``critical_subset`` return
byte-equal arrays (tests/test_torch_data.py holds them to it).

The real dataset [33] (IEEE DataPort 0wmc-hq36) is TD-MIMO FMCW range-azimuth
maps, 256×63, with R=10 ROI labels defined by (range d, DOA α) cells
(Table I). Offline we synthesize maps with the same geometry: a target blob
at (d, α) drawn uniformly inside the labeled ROI, plus clutter, speckle and
a robot-arm reflector. The *distribution shift* of days i=2,3 (§V-B) is
modeled as gain drift + clutter increase + small DOA miscalibration —
matching the paper's description of "different radar configurations and/or
slight changes in the HRC workspace".

Geometry (Table I):
    label 0: d >= 2m,          -60..60 deg   (safe)
    1: 0.5-0.7m   40..60  | 2: 0.3-0.5m  -10..10 | 3: 0.5-0.7m  -60..-40
    4: 1.0-1.2m   20..40  | 5: 0.9-1.1m  -10..10 | 6: 1.0-1.2m  -40..-20
    7: 1.2-1.6m   10..20  | 8: 1.1-1.5m   -5..5  | 9: 1.2-1.6m  -20..-10
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import numpy as np

# (d_min, d_max, a_min, a_max) per label — paper Table I
ROIS = np.array([
    [2.0, 3.5, -60, 60],
    [0.5, 0.7, 40, 60],
    [0.3, 0.5, -10, 10],
    [0.5, 0.7, -60, -40],
    [1.0, 1.2, 20, 40],
    [0.9, 1.1, -10, 10],
    [1.0, 1.2, -40, -20],
    [1.2, 1.6, 10, 20],
    [1.1, 1.5, -5, 5],
    [1.2, 1.6, -20, -10],
], dtype=np.float64)

MAX_RANGE_M = 3.5     # 256 bins * 4.2cm/bin + margin -> ~3.5m usable, per radar spec
FOV_DEG = 60.0
NUM_CLASSES = 10


@dataclass(frozen=True)
class ShiftSpec:
    """Parametric distribution shift for synthetic radar maps.

    Generalizes the hard-coded day-2/3 shift into independent physical
    knobs; defaults reproduce the clean day-1 configuration. The
    reference's scenario registry maps (family, severity) pairs onto
    these fields. Passing ``shift=`` to :func:`synth_map` /
    :func:`make_dataset` takes the generic path; ``shift=None`` keeps the
    legacy day-based branch bit-exact (it consumes no extra PRNG draws on
    day 1, so existing datasets are unchanged).
    """
    doa_mean_deg: float = 0.0        # systematic DOA miscalibration
    doa_std_deg: float = 0.0         # per-map DOA jitter
    gain_lo: float = 1.0             # RX gain drift (uniform draw bounds)
    gain_hi: float = 1.0
    clutter: float = 0.05            # exponential clutter floor level
    range_scale_lo: float = 1.0      # range-bin miscalibration bounds
    range_scale_hi: float = 1.0
    noise_std: float = 0.0           # extra white noise (SNR degradation)
    arm_range_m: float = 0.25        # robot-arm reflector position
    arm_azim_deg: float = 0.0
    arm_amp: float = 0.5
    extra_reflector_amp: float = 0.0  # unseen static reflector (geometry)
    extra_reflector_range_m: float = 1.0
    extra_reflector_azim_deg: float = 30.0
    ghost_prob: float = 0.3          # multipath second-bounce probability


def _blob(h: int, w: int, r_bin: float, a_bin: float, sr: float, sa: float):
    rr = np.arange(h)[:, None]
    aa = np.arange(w)[None, :]
    return np.exp(-0.5 * (((rr - r_bin) / sr) ** 2 + ((aa - a_bin) / sa) ** 2))


def synth_map(rng, label: int, hw: Tuple[int, int], day: int = 1,
              shift: Optional[ShiftSpec] = None) -> np.ndarray:
    """One range-azimuth magnitude map (H, W) in [0, ~1.5], drawn from the
    numpy ``rng`` (``np.random.default_rng``) as the reference draws it.

    ``shift=None`` keeps the legacy day-based branch (bit-exact with the
    pre-scenario code, including its PRNG draw order); an explicit
    :class:`ShiftSpec` takes the generic parametric path used by the
    scenario registry.
    """
    h, w = hw
    d0, d1, a0, a1 = ROIS[label]
    d = rng.uniform(d0, min(d1, MAX_RANGE_M))
    a = rng.uniform(a0, a1)

    if shift is None:
        # legacy day>1 shift: DOA miscalibration + gain drift + extra
        # clutter + range-bin drift (workflow/config changes, §V-B).
        # Strong enough to genuinely degrade day-1-trained models.
        spec = ShiftSpec()
        if day == 1:
            a_off, gain, clutter_lvl = 0.0, 1.0, 0.05
        else:
            a_off = rng.normal(8.0 * (day - 1), 3.0)
            gain = rng.uniform(0.35, 0.7)
            clutter_lvl = 0.22
            d = d * rng.uniform(0.85, 0.95)   # range scale miscalibration
    else:
        # generic path: every knob draws, in a fixed documented order
        # (a_off, gain, range scale) so scenario streams are stable
        spec = shift
        a_off = spec.doa_mean_deg + spec.doa_std_deg * rng.standard_normal()
        gain = rng.uniform(spec.gain_lo, spec.gain_hi)
        clutter_lvl = spec.clutter
        d = d * rng.uniform(spec.range_scale_lo, spec.range_scale_hi)

    r_bin = np.clip(d / MAX_RANGE_M, 0, 1) * (h - 1)
    a_bin = np.clip((a + a_off + FOV_DEG) / (2 * FOV_DEG), 0, 1) * (w - 1)

    m = gain * rng.uniform(0.7, 1.3) * _blob(h, w, r_bin, a_bin,
                                             sr=max(1.5, h / 42),
                                             sa=max(1.2, w / 25))
    # robot arm: static reflector (legacy position: 0.25m, 0 deg)
    arm_r = spec.arm_range_m / MAX_RANGE_M * (h - 1)
    arm_a = (spec.arm_azim_deg + FOV_DEG) / (2 * FOV_DEG) * (w - 1)
    m += spec.arm_amp * _blob(h, w, arm_r, arm_a,
                              sr=max(1.0, h / 64), sa=max(1.0, w / 32))
    # unseen room geometry: an extra static reflector the training days
    # never saw (0 amplitude on the clean/legacy configurations)
    if spec.extra_reflector_amp:
        xr = spec.extra_reflector_range_m / MAX_RANGE_M * (h - 1)
        xa = np.clip((spec.extra_reflector_azim_deg + FOV_DEG)
                     / (2 * FOV_DEG), 0, 1) * (w - 1)
        m += spec.extra_reflector_amp * _blob(h, w, xr, xa,
                                              sr=max(1.0, h / 64),
                                              sa=max(1.0, w / 32))
    # multipath ghost (second-bounce at 2x range, attenuated)
    if rng.uniform() < spec.ghost_prob:
        m += 0.15 * _blob(h, w, min(2 * r_bin, h - 1), a_bin,
                          sr=max(1.5, h / 42), sa=max(1.2, w / 25))
    # clutter + speckle
    m += clutter_lvl * rng.exponential(1.0, (h, w))
    m *= rng.uniform(0.9, 1.1, (h, w))
    # receiver noise floor (SNR degradation); magnitudes stay non-negative
    if spec.noise_std:
        m = np.maximum(m + spec.noise_std * rng.standard_normal((h, w)), 0.0)
    return m.astype(np.float32)


def normalize_maps(x: np.ndarray) -> np.ndarray:
    """Per-map log-magnitude normalization (standard radar preprocessing)."""
    x = np.log1p(x)
    return (x - x.mean(axis=(1, 2), keepdims=True)) / (
        x.std(axis=(1, 2), keepdims=True) + 1e-6)


def make_dataset(num_examples: int, hw: Tuple[int, int] = (256, 63),
                 day: int = 1, seed: int = 0,
                 labels: np.ndarray = None,
                 shift: Optional[ShiftSpec] = None) -> Dict[str, np.ndarray]:
    """Returns {'x': (N,H,W,1) float32, 'y': (N,) int32}."""
    rng = np.random.default_rng(seed + 1000 * day)
    if labels is None:
        labels = rng.integers(0, NUM_CLASSES, size=num_examples)
    x = np.stack([synth_map(rng, int(y), hw, day, shift=shift)
                  for y in labels])
    x = normalize_maps(x)
    return {"x": x[..., None].astype(np.float32),
            "y": labels.astype(np.int32)}


def critical_subset(ds: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
    """Labels 1..6: the paper's safety-critical close-range test filter (§V)."""
    m = (ds["y"] >= 1) & (ds["y"] <= 6)
    return {"x": ds["x"][m], "y": ds["y"][m]}
