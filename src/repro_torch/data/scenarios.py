"""Distribution-shift scenario registry (``repro/data/scenarios.py``).

A numpy-only copy of the reference's static part: every registered shift
family, each a pure function of ``(seed, severity)`` over the port's
:class:`~repro_torch.data.radar.ShiftSpec` and ``synth_map``, so
``make_scenario_dataset`` returns arrays byte-equal to the reference's.
``severity`` is a scalar in [0, 1]: 0 is (close to) the clean day-1
distribution, 1 the strongest configured corruption. The streaming drift
part (``:260-392``): :class:`DriftSchedule`, a severity trajectory over
training rounds pure in ``(seed, round)``, and :func:`make_drift_shards`,
each node's pool at a round's scheduled severity, byte-equal to the
reference's.

    from repro_torch.data.scenarios import make_scenario_dataset
    ds = make_scenario_dataset("gain_drift", severity=0.7, num_examples=200,
                               hw=(32, 16), seed=0)
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np

from repro_torch.data.radar import (NUM_CLASSES, ShiftSpec, normalize_maps,
                                    synth_map)

# severity-interpolation helper: lo at s=0, hi at s=1
def _lerp(lo: float, hi: float, s: float) -> float:
    return float(lo + (hi - lo) * s)


SpecFn = Callable[[np.random.Generator, float], ShiftSpec]
PriorFn = Callable[[float], np.ndarray]
# groups: [(num_examples, spec)] — heterogeneous scenarios synthesize
# different sub-populations (e.g. one shift realization per node)
GroupFn = Callable[[np.random.Generator, float, int],
                   List[Tuple[int, ShiftSpec]]]


@dataclass(frozen=True)
class Scenario:
    """One shift family: severity -> physical/sampling corruption."""
    name: str
    description: str
    spec_fn: SpecFn
    # optional label-sampling prior p(y | severity), shape (NUM_CLASSES,)
    label_prior_fn: Optional[PriorFn] = None
    # optional sub-population splitter (per-node heterogeneous shift)
    group_fn: Optional[GroupFn] = None


SCENARIOS: Dict[str, Scenario] = {}


def register_scenario(sc: Scenario) -> Scenario:
    SCENARIOS[sc.name] = sc
    return sc


def get_scenario(name: str) -> Scenario:
    if name not in SCENARIOS:
        raise KeyError(f"unknown scenario {name!r}; known: {list_scenarios()}")
    return SCENARIOS[name]


def list_scenarios() -> List[str]:
    return sorted(SCENARIOS)


def _scenario_rng(name: str, severity: float, seed: int
                  ) -> np.random.Generator:
    """Deterministic stream keyed by (scenario, severity, seed).

    The full scenario name enters through a stable digest (not a prefix —
    ``day23`` and ``day23_critical`` must not share a stream) and the
    severity through its float64 bit pattern, so every distinct cell gets
    an independent stream while equal inputs are bitwise reproducible
    (the claims gate re-synthesizes and compares).
    """
    import hashlib
    digest = hashlib.sha256(name.encode()).digest()
    name_key = int.from_bytes(digest[:8], "little")
    sev_key = int(np.float64(severity).view(np.uint64))
    return np.random.default_rng(
        np.random.SeedSequence([seed, name_key & 0xFFFFFFFF, name_key >> 32,
                                sev_key & 0xFFFFFFFF, sev_key >> 32]))


def make_scenario_dataset(name: str, severity: float, num_examples: int,
                          hw: Tuple[int, int] = (256, 63), seed: int = 0
                          ) -> Dict[str, np.ndarray]:
    """Synthesize one scenario cell: {'x': (N,H,W,1) f32, 'y': (N,) i32}.

    Pure in (name, severity, num_examples, hw, seed) — same arguments,
    bitwise-identical arrays.
    """
    sc = get_scenario(name)
    rng = _scenario_rng(name, severity, seed)
    prior = None
    if sc.label_prior_fn is not None:
        prior = np.asarray(sc.label_prior_fn(severity), np.float64)
        prior = prior / prior.sum()
    labels = rng.choice(NUM_CLASSES, size=num_examples, p=prior)
    if sc.group_fn is not None:
        groups = sc.group_fn(rng, severity, num_examples)
    else:
        groups = [(num_examples, sc.spec_fn(rng, severity))]
    assert sum(n for n, _ in groups) == num_examples, "groups must cover N"
    maps, start = [], 0
    for n_g, spec in groups:
        for y in labels[start:start + n_g]:
            maps.append(synth_map(rng, int(y), hw, shift=spec))
        start += n_g
    x = normalize_maps(np.stack(maps))
    return {"x": x[..., None].astype(np.float32),
            "y": labels.astype(np.int32)}


# --------------------------------------------------------------------------
# Shift families
# --------------------------------------------------------------------------

register_scenario(Scenario(
    name="clean",
    description="day-1 distribution through the generic path (severity "
                "is ignored); the matrix's reference column",
    spec_fn=lambda rng, s: ShiftSpec(),
))

register_scenario(Scenario(
    name="gain_drift",
    description="RX gain drifts low (radar re-configuration between days)",
    spec_fn=lambda rng, s: ShiftSpec(gain_lo=_lerp(1.0, 0.35, s),
                                     gain_hi=_lerp(1.0, 0.65, s)),
))

register_scenario(Scenario(
    name="clutter_ramp",
    description="static clutter floor rises (workspace fills up)",
    spec_fn=lambda rng, s: ShiftSpec(clutter=_lerp(0.05, 0.5, s)),
))

register_scenario(Scenario(
    name="doa_miscal",
    description="systematic DOA miscalibration + per-map angle jitter "
                "(antenna array drift)",
    spec_fn=lambda rng, s: ShiftSpec(doa_mean_deg=_lerp(0.0, 16.0, s),
                                     doa_std_deg=_lerp(0.0, 4.0, s)),
))

register_scenario(Scenario(
    name="snr_degradation",
    description="receiver noise floor rises while target gain sags",
    spec_fn=lambda rng, s: ShiftSpec(noise_std=_lerp(0.0, 0.55, s),
                                     gain_lo=_lerp(1.0, 0.6, s),
                                     gain_hi=_lerp(1.0, 0.85, s)),
))

register_scenario(Scenario(
    name="range_drift",
    description="range-bin scale miscalibration (chirp clock drift)",
    spec_fn=lambda rng, s: ShiftSpec(range_scale_lo=_lerp(1.0, 0.78, s),
                                     range_scale_hi=_lerp(1.0, 0.92, s)),
))

register_scenario(Scenario(
    name="room_geometry",
    description="unseen room geometry: robot arm moved, an extra static "
                "reflector appears, multipath becomes more likely",
    spec_fn=lambda rng, s: ShiftSpec(
        arm_range_m=_lerp(0.25, 1.1, s),
        arm_azim_deg=_lerp(0.0, -25.0, s),
        arm_amp=_lerp(0.5, 0.8, s),
        extra_reflector_amp=_lerp(0.0, 0.65, s),
        extra_reflector_range_m=float(rng.uniform(0.8, 1.4)),
        extra_reflector_azim_deg=float(rng.uniform(-40.0, 40.0)),
        ghost_prob=_lerp(0.3, 0.8, s),
    ),
))


def _critical_prior(s: float) -> np.ndarray:
    """Skew the label prior toward the safety-critical classes 1..6."""
    base = np.ones(NUM_CLASSES) / NUM_CLASSES
    crit = np.zeros(NUM_CLASSES)
    crit[1:7] = 1.0 / 6.0
    return (1.0 - s) * base + s * crit


register_scenario(Scenario(
    name="label_prior",
    description="label-prior shift toward the safety-critical close-range "
                "classes (maps stay day-1 clean)",
    spec_fn=lambda rng, s: ShiftSpec(),
    label_prior_fn=_critical_prior,
))


def _day23_spec(rng: np.random.Generator, s: float) -> ShiftSpec:
    # severity interpolates the legacy day axis: s=0 ~ day 2, s=1 ~ day 3
    return ShiftSpec(doa_mean_deg=_lerp(8.0, 16.0, s), doa_std_deg=3.0,
                     gain_lo=0.35, gain_hi=0.7, clutter=0.22,
                     range_scale_lo=0.85, range_scale_hi=0.95)


register_scenario(Scenario(
    name="day23",
    description="the paper's §V-B day-2/3 shift (gain + clutter + DOA + "
                "range drift); severity interpolates day 2 -> day 3",
    spec_fn=_day23_spec,
))

register_scenario(Scenario(
    name="day23_critical",
    description="day-2/3 shift restricted to the safety-critical classes "
                "1..6 (the paper's Fig. 4 evaluation filter)",
    spec_fn=_day23_spec,
    label_prior_fn=lambda s: _critical_prior(1.0),
))


_HETERO_FAMILIES = ("gain_drift", "clutter_ramp", "doa_miscal",
                    "snr_degradation")


def _hetero_groups(rng: np.random.Generator, s: float, n: int
                   ) -> List[Tuple[int, ShiftSpec]]:
    """Per-node heterogeneous shift: each of G sub-populations (nodes)
    draws its own family and severity in [0.25·s, s] — no two radars see
    the same corruption, the decentralized stress case."""
    g = min(5, max(1, n // 8))
    counts = [n // g + (1 if i < n % g else 0) for i in range(g)]
    groups = []
    for c in counts:
        fam = SCENARIOS[_HETERO_FAMILIES[int(rng.integers(
            len(_HETERO_FAMILIES)))]]
        sev = float(rng.uniform(0.25, 1.0)) * s
        groups.append((c, fam.spec_fn(rng, sev)))
    return groups


register_scenario(Scenario(
    name="node_hetero",
    description="per-node heterogeneous shift: sub-populations with "
                "independent families/severities",
    spec_fn=lambda rng, s: ShiftSpec(),   # unused (group_fn covers all)
    group_fn=_hetero_groups,
))


# --------------------------------------------------------------------------
# Streaming drift: time-varying severity schedules (DESIGN.md §15)
# --------------------------------------------------------------------------

# per-node offset into the drift synthesis stream: each node draws its
# phase dataset from an independent, stable seed (documented in §15 so
# the purity tests can reconstruct the exact streams)
_DRIFT_NODE_STRIDE = 7919


@dataclass(frozen=True)
class DriftSchedule:
    """Severity trajectory s(t) over training rounds — pure in (seed, round).

    ``severity_at(t)`` is a deterministic function of the static schedule
    fields and the integer round, quantized to ``refresh_every``-round
    phases (the super-round granularity at which the engines re-draw the
    training pool). It composes with every registered shift family: the
    scheduled severity feeds :func:`make_scenario_dataset`, which is
    itself pure in (scenario, severity, seed), so the whole drifting data
    stream is bitwise-reproducible from ``(seed, round)``.

    Kinds:

    * ``constant`` — ``severity`` everywhere (degenerate schedule).
    * ``step``     — ``base`` before ``onset``, ``severity`` after (the
      paper's day-boundary re-configuration, made abrupt).
    * ``ramp``     — linear ``base``→``severity`` over ``ramp_rounds``
      starting at ``onset`` (slow sensor drift).
    * ``cyclic``   — raised-cosine oscillation ``base``↔``severity`` with
      period ``period`` from ``onset`` (diurnal factory cycles).
    * ``piecewise``— explicit ``breakpoints`` ((round, severity), sorted);
      ``base`` before the first breakpoint.

    A phase whose severity equals ``base`` keeps the caller's original
    training shards untouched (bitwise — the no-drift trajectory), so a
    schedule is a strict extension of static training until onset.
    """
    scenario: str = "clean"
    kind: str = "step"            # constant | step | ramp | cyclic | piecewise
    severity: float = 0.0         # plateau / peak severity
    base: float = 0.0             # pre-onset severity
    onset: int = 0                # first drifted round (step/ramp/cyclic)
    ramp_rounds: int = 0          # ramp duration; 0 degenerates to step
    period: int = 0               # cyclic period in rounds
    breakpoints: Tuple[Tuple[int, float], ...] = ()
    refresh_every: int = 1        # phase quantization in rounds
    seed: int = 0                 # drift-synthesis stream seed

    def __post_init__(self):
        if self.kind not in ("constant", "step", "ramp", "cyclic",
                             "piecewise"):
            raise ValueError(f"unknown drift kind {self.kind!r}")
        if self.kind == "cyclic" and self.period <= 0:
            raise ValueError("cyclic drift needs period > 0")
        if self.kind == "piecewise" and not self.breakpoints:
            raise ValueError("piecewise drift needs breakpoints")
        get_scenario(self.scenario)   # fail fast on unknown families

    # -- the pure trajectory ------------------------------------------------
    def phase(self, t: int) -> int:
        """Phase index of round ``t`` (severity is constant per phase)."""
        return int(t) // max(1, int(self.refresh_every))

    def severity_at(self, t: int) -> float:
        """Scheduled severity for round ``t`` (phase-quantized, pure)."""
        tq = self.phase(t) * max(1, int(self.refresh_every))
        if self.kind == "constant":
            return float(self.severity)
        if self.kind == "piecewise":
            s = float(self.base)
            for r, sev in sorted(self.breakpoints):
                if tq >= r:
                    s = float(sev)
            return s
        if tq < self.onset:
            return float(self.base)
        if self.kind == "step":
            return float(self.severity)
        if self.kind == "ramp":
            if self.ramp_rounds <= 0:
                return float(self.severity)
            frac = min(1.0, (tq - self.onset) / float(self.ramp_rounds))
            return _lerp(self.base, self.severity, frac)
        # cyclic: raised cosine base -> severity -> base over `period`
        frac = 0.5 - 0.5 * np.cos(2.0 * np.pi * (tq - self.onset)
                                  / float(self.period))
        return _lerp(self.base, self.severity, float(frac))

    def onset_round(self) -> int:
        """First round whose scheduled severity differs from ``base``
        (the drift-onset marker the recovery gate measures from)."""
        if self.kind == "constant":
            return 0 if self.severity != self.base else 1 << 30
        if self.kind == "piecewise":
            for r, sev in sorted(self.breakpoints):
                if float(sev) != float(self.base):
                    return int(r)
            return 1 << 30
        return int(self.onset)


def make_drift_schedule(cfg) -> Optional[DriftSchedule]:
    """Build a :class:`DriftSchedule` from a
    :class:`repro_torch.config.ContinualConfig` (None when no drift is
    configured — scenario "clean" or an identically-``base`` schedule)."""
    if cfg is None or cfg.scenario in ("", "clean"):
        return None
    return DriftSchedule(
        scenario=cfg.scenario, kind=cfg.schedule, severity=cfg.severity,
        base=cfg.base_severity, onset=cfg.onset,
        ramp_rounds=cfg.ramp_rounds, period=cfg.period,
        breakpoints=tuple(tuple(bp) for bp in cfg.breakpoints),
        refresh_every=cfg.refresh_every, seed=cfg.drift_seed)


def make_drift_shards(schedule: DriftSchedule, t: int,
                      sizes: List[int], hw: Tuple[int, int]
                      ) -> List[Dict[str, np.ndarray]]:
    """Per-node training shards for round ``t``'s scheduled severity.

    Node ``k`` synthesizes its own ``sizes[k]``-example cell from the
    stable stream ``seed + _DRIFT_NODE_STRIDE * (k + 1)`` — independent
    across nodes, bitwise-reproducible in ``(schedule, t, sizes, hw)``,
    and identical whenever two rounds share a severity (cyclic schedules
    revisit the same dataset, the continual-training setting of arXiv
    2504.15328).
    """
    sev = schedule.severity_at(t)
    return [
        make_scenario_dataset(
            schedule.scenario, sev, int(n), hw=hw,
            seed=schedule.seed + _DRIFT_NODE_STRIDE * (k + 1))
        for k, n in enumerate(sizes)
    ]
