"""Streaming drift: schedules to engine pool refreshes
(``repro/train/drift.py``, DESIGN.md §15).

A :class:`~repro_torch.data.scenarios.DriftSchedule` maps each round to a
scheduled severity; this module applies it: it splits a training run into
constant-severity segments, synthesizes the per-node pools of each phase,
and installs them in the round engine with ``set_shards`` between chunks.

Purity: the pool installed for round ``t`` is a function of ``(schedule,
t, sizes, hw)`` (:func:`~repro_torch.data.scenarios.make_drift_shards`),
and a phase whose severity equals the schedule's ``base`` re-installs the
caller's own pool object, so training before onset is bit for bit the
no-drift run. The scan engine copies an installed pool into a pool of its
own that its CUDA graphs read (``train/engine.py``), so the caller's base
pool is never written and a return to base trains on the base maps.
:class:`~repro_torch.train.trainer.FedTrainer` and ``launch/train.py``
both go through this module.
"""
from __future__ import annotations

from typing import Dict, Iterator, List, Optional, Tuple

from repro_torch.data.partition import DeviceShards
from repro_torch.data.scenarios import (DriftSchedule, make_drift_schedule,
                                        make_drift_shards,
                                        make_scenario_dataset)


class DriftRefresher:
    """Applies a :class:`DriftSchedule` to a round engine's data pool.

    ``base_shards`` is the pre-drift pool, kept by reference and
    re-installed whenever the scheduled severity returns to ``base``. The
    phase pools are synthesized on the host, uploaded to the base pool's
    device and cached per severity value, so a cyclic schedule pays each
    severity's synthesis once. Only image pools (fields ``x`` and ``y``)
    drift: the scenario registry synthesizes radar maps, not tokens.
    """

    def __init__(self, schedule: DriftSchedule, base_shards: DeviceShards):
        if "x" not in base_shards.data or "y" not in base_shards.data:
            raise ValueError(
                "drift schedules need an image-style pool with 'x'/'y' "
                f"fields, got {sorted(base_shards.data)} — LM token pools "
                "have no scenario synthesis path")
        self.schedule = schedule
        self.base_shards = base_shards
        self.sizes: List[int] = [int(n) for n in base_shards.sizes]
        x = base_shards.data["x"]
        self.hw: Tuple[int, int] = (int(x.shape[2]), int(x.shape[3]))
        self._cache: Dict[float, DeviceShards] = {}
        self.current_severity: float = float(schedule.base)

    # -- segmentation ------------------------------------------------------
    def segments(self, t0: int, rounds: int) -> Iterator[Tuple[int, int]]:
        """Split ``[t0, t0 + rounds)`` at phase boundaries: ``(start, n)``
        runs of rounds of one scheduled severity. Consecutive phases of
        equal severity merge into one segment."""
        step = max(1, int(self.schedule.refresh_every))
        t, end = int(t0), int(t0) + int(rounds)
        while t < end:
            sev = self.schedule.severity_at(t)
            nxt = (t // step + 1) * step
            while nxt < end and self.schedule.severity_at(nxt) == sev:
                nxt += step
            n = min(nxt, end) - t
            yield t, n
            t += n

    # -- pool synthesis ----------------------------------------------------
    def shards_for(self, t: int) -> DeviceShards:
        """The training pool of round ``t``'s phase (cached per severity)."""
        sev = float(self.schedule.severity_at(t))
        if sev == float(self.schedule.base):
            return self.base_shards
        if sev not in self._cache:
            shard_list = make_drift_shards(self.schedule, t, self.sizes,
                                           self.hw)
            self._cache[sev] = DeviceShards.from_shards(
                shard_list, self.base_shards.device)
        return self._cache[sev]

    def refresh(self, engine, t: int) -> float:
        """Install round ``t``'s pool on ``engine`` (nothing when the
        phase's severity is the one installed). Returns the severity in
        effect."""
        sev = float(self.schedule.severity_at(t))
        if sev != self.current_severity:
            engine.set_shards(self.shards_for(t))
            self.current_severity = sev
        return sev

    def eval_dataset(self, t: int, num_examples: int, seed: int = 0):
        """A held-out cell at round ``t``'s severity: the current
        distribution of an in-training drift eval."""
        sev = float(self.schedule.severity_at(t))
        return make_scenario_dataset(self.schedule.scenario, sev,
                                     int(num_examples), hw=self.hw,
                                     seed=seed)


def make_refresher(continual, shards: DeviceShards
                   ) -> Optional[DriftRefresher]:
    """A refresher from a :class:`~repro_torch.config.ContinualConfig`
    (None when it carries no drift)."""
    schedule = make_drift_schedule(continual)
    if schedule is None:
        return None
    return DriftRefresher(schedule, shards)
