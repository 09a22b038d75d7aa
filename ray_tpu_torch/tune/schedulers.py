"""Trial schedulers: early stopping / resource-adaptive policies.

A copy of ``ray_tpu.tune.schedulers`` for the PyTorch port.

Parity: reference ``python/ray/tune/schedulers/`` — ``FIFOScheduler``
(``trial_scheduler.py``), ``AsyncHyperBandScheduler``/ASHA
(``async_hyperband.py``: brackets of halving rungs, cutoff at the top
1/reduction_factor quantile per rung), ``MedianStoppingRule``
(``median_stopping_rule.py``), ``PopulationBasedTraining`` (``pbt.py``:
exploit bottom quantile from top quantile + explore/perturb config).
"""

from __future__ import annotations

import math
import random
from typing import Any, Dict, List, Optional

from ray_tpu_torch.tune.sample import Domain
from ray_tpu_torch.tune.trial import Trial


class TrialScheduler:
    CONTINUE = "CONTINUE"
    STOP = "STOP"
    PAUSE = "PAUSE"

    def on_trial_add(self, trial: Trial):
        pass

    def on_trial_result(self, trial: Trial, result: Dict) -> str:
        return TrialScheduler.CONTINUE

    def on_trial_complete(self, trial: Trial, result: Optional[Dict]):
        pass

    def choose_trial_to_run(self, trials: List[Trial]) -> Optional[Trial]:
        """Pick the next trial the runner should (re)start (reference
        trial_scheduler.py choose_trial_to_run).  Synchronous schedulers
        override this to hold PAUSED trials until their cohort decides."""
        for t in trials:
            if t.status in (Trial.PENDING, Trial.PAUSED):
                return t
        return None


class FIFOScheduler(TrialScheduler):
    pass


class _Rung:
    def __init__(self, milestone: int):
        self.milestone = milestone
        self.recorded: Dict[str, float] = {}  # trial_id -> metric


class AsyncHyperBandScheduler(TrialScheduler):
    """ASHA (reference async_hyperband.py). One bracket by default:
    rungs at grace_period * reduction_factor^k; a trial reaching a rung
    continues only if in the top 1/reduction_factor of that rung."""

    def __init__(self, metric: str = "score", mode: str = "max",
                 time_attr: str = "training_iteration",
                 grace_period: int = 1, max_t: int = 100,
                 reduction_factor: float = 3):
        self._metric = metric
        self._mode = mode
        self._time_attr = time_attr
        self._rf = reduction_factor
        self._max_t = max_t
        self.rungs: List[_Rung] = []
        t = grace_period
        while t < max_t:
            self.rungs.append(_Rung(int(t)))
            t *= reduction_factor
        self.stopped = 0

    def _value(self, result: Dict) -> Optional[float]:
        v = result.get(self._metric)
        if v is None:
            return None
        return float(v) if self._mode == "max" else -float(v)

    def on_trial_result(self, trial: Trial, result: Dict) -> str:
        t = result.get(self._time_attr, 0)
        if t >= self._max_t:
            return TrialScheduler.STOP
        v = self._value(result)
        if v is None:
            return TrialScheduler.CONTINUE
        action = TrialScheduler.CONTINUE
        for rung in self.rungs:
            if t < rung.milestone or trial.trial_id in rung.recorded:
                continue
            rung.recorded[trial.trial_id] = v
            vals = sorted(rung.recorded.values(), reverse=True)
            k = max(1, int(len(vals) / self._rf))
            cutoff = vals[k - 1]
            if v < cutoff:
                action = TrialScheduler.STOP
        if action == TrialScheduler.STOP:
            self.stopped += 1
        return action


class _Bracket:
    """One synchronous successive-halving bracket."""

    def __init__(self, capacity: int, r0: int, eta: float, max_t: int):
        self.capacity = capacity
        self.milestone = r0
        self.eta = eta
        self.max_t = max_t
        self.added = 0                         # trials EVER assigned
        self.halved = False
        self.closed = False                    # no more trials coming
        self.live: List[Trial] = []
        self.recorded: Dict[str, float] = {}   # trial_id -> metric
        self.resumable: set = set()            # trial_ids cleared to run

    def full(self) -> bool:
        # Count trials ever added, not the live list — halving shrinks
        # live, and a bracket must not keep absorbing new trials (which
        # would join at an already-advanced milestone and skip the
        # early rungs the incumbents were filtered at).
        return self.added >= self.capacity or self.halved

    def quorum(self) -> bool:
        # The first halving waits for the bracket to actually FILL (or
        # for the source to run dry — ``closed``): with a lazy variant
        # source, halving over just the trials that happen to have
        # arrived would shrink every cohort to the concurrency level
        # (and to 1 at max_concurrent_trials=1, a silent no-op).
        if not self.live or len(self.recorded) < len(self.live):
            return False
        return self.halved or self.closed or self.added >= self.capacity

    def halve(self) -> set:
        """Keep the top 1/eta, terminate the rest.  Returns the
        surviving trial_ids; losers that are PAUSED are terminated here
        (their actors are already stopped), a loser still RUNNING gets
        STOP from on_trial_result."""
        self.halved = True
        ranked = sorted(self.live,
                        key=lambda t: self.recorded[t.trial_id],
                        reverse=True)
        k = max(1, int(math.ceil(len(ranked) / self.eta)))
        survivors, losers = ranked[:k], ranked[k:]
        for t in losers:
            if t.status == Trial.PAUSED:
                t.status = Trial.TERMINATED
        self.live = survivors
        self.milestone = min(int(self.milestone * self.eta), self.max_t)
        self.recorded = {}
        ids = {t.trial_id for t in survivors}
        self.resumable |= ids
        return ids


class HyperBandScheduler(TrialScheduler):
    """Synchronous HyperBand (reference ``hyperband.py``): trials fill
    successive-halving brackets of geometrically varying width/budget;
    each bracket waits (PAUSE) for all members to reach the current
    milestone, keeps the top 1/eta, and multiplies the milestone by eta.
    Unlike ASHA the halving decision sees the whole cohort, so stragglers
    are held at the rung instead of racing ahead.

    Pausing stops the trial's actor; survivors resume from
    ``trial.checkpoint``.  ``Trainable`` subclasses checkpoint every
    step automatically, so resumption is free.  FUNCTION trainables must
    call ``tune.save_checkpoint(...)`` (and restore via
    ``tune.load_checkpoint()``) to resume from the rung — otherwise a
    paused survivor re-runs from iteration 1 (correct result, duplicated
    compute, and regressed ``training_iteration`` values re-reported to
    the searcher)."""

    def __init__(self, metric: str = "score", mode: str = "max",
                 time_attr: str = "training_iteration",
                 max_t: int = 81, reduction_factor: float = 3):
        self._metric = metric
        self._mode = mode
        self._time_attr = time_attr
        self._eta = reduction_factor
        self._max_t = max_t
        # Bracket ladder: s = s_max..0, bracket s starts
        # n_s = ceil((s_max+1)/(s+1) * eta^s) trials at budget
        # r_s = max_t * eta^-s (the HyperBand paper's outer loop).
        s_max = int(math.log(max_t, reduction_factor))
        self._specs = []
        for s in range(s_max, -1, -1):
            n = int(math.ceil((s_max + 1) / (s + 1)
                              * reduction_factor ** s))
            r = max(1, int(max_t * reduction_factor ** (-s)))
            self._specs.append((n, r))
        self._brackets: List[_Bracket] = []
        self._spec_idx = 0
        self._by_trial: Dict[str, _Bracket] = {}
        self.stopped = 0

    def _value(self, result: Dict) -> Optional[float]:
        v = result.get(self._metric)
        if v is None:
            return None
        return float(v) if self._mode == "max" else -float(v)

    def on_trial_add(self, trial: Trial):
        if not self._brackets or self._brackets[-1].full():
            n, r = self._specs[self._spec_idx % len(self._specs)]
            self._spec_idx += 1
            self._brackets.append(
                _Bracket(n, r, self._eta, self._max_t))
        b = self._brackets[-1]
        b.added += 1
        b.live.append(trial)
        self._by_trial[trial.trial_id] = b

    def on_trial_result(self, trial: Trial, result: Dict) -> str:
        b = self._by_trial.get(trial.trial_id)
        t = result.get(self._time_attr, 0)
        if b is None or trial not in b.live:
            return TrialScheduler.STOP
        if t >= self._max_t:
            b.live.remove(trial)
            b.recorded.pop(trial.trial_id, None)
            if b.quorum():
                b.halve()
            return TrialScheduler.STOP
        v = self._value(result)
        if v is None or t < b.milestone:
            return TrialScheduler.CONTINUE
        b.recorded[trial.trial_id] = v
        if not b.quorum():
            return TrialScheduler.PAUSE     # wait for the cohort
        survivors = b.halve()
        if trial.trial_id in survivors:
            b.resumable.discard(trial.trial_id)   # it is already running
            return TrialScheduler.CONTINUE
        self.stopped += 1
        return TrialScheduler.STOP

    def on_trial_complete(self, trial: Trial, result: Optional[Dict]):
        b = self._by_trial.pop(trial.trial_id, None)
        if b is None or trial not in b.live:
            return
        b.live.remove(trial)
        b.recorded.pop(trial.trial_id, None)
        b.resumable.discard(trial.trial_id)
        if b.quorum():
            b.halve()

    def choose_trial_to_run(self, trials: List[Trial]) -> Optional[Trial]:
        for t in trials:
            if t.status == Trial.PENDING:
                return t
        for t in trials:
            if t.status == Trial.PAUSED:
                b = self._by_trial.get(t.trial_id)
                if b is not None and t.trial_id in b.resumable:
                    b.resumable.discard(t.trial_id)
                    return t
        return None

    def no_more_trials(self):
        """The variant source is exhausted (runner callback): brackets
        that were waiting to fill will never fill — close them and
        halve any whose cohort has fully recorded, so paused trials
        resume instead of waiting forever."""
        for b in self._brackets:
            b.closed = True
            if b.quorum():
                b.halve()


class MedianStoppingRule(TrialScheduler):
    """Stop a trial whose best result so far is worse than the median of
    other trials' running averages at the same step (reference
    median_stopping_rule.py)."""

    def __init__(self, metric: str = "score", mode: str = "max",
                 time_attr: str = "training_iteration",
                 grace_period: int = 1, min_samples_required: int = 3):
        self._metric = metric
        self._mode = mode
        self._time_attr = time_attr
        self._grace = grace_period
        self._min_samples = min_samples_required
        self._histories: Dict[str, List[float]] = {}

    def _value(self, result: Dict) -> Optional[float]:
        v = result.get(self._metric)
        if v is None:
            return None
        return float(v) if self._mode == "max" else -float(v)

    def on_trial_result(self, trial: Trial, result: Dict) -> str:
        v = self._value(result)
        t = result.get(self._time_attr, 0)
        if v is None:
            return TrialScheduler.CONTINUE
        self._histories.setdefault(trial.trial_id, []).append(v)
        if t < self._grace or len(self._histories) < self._min_samples:
            return TrialScheduler.CONTINUE
        means = [sum(h) / len(h) for tid, h in self._histories.items()
                 if tid != trial.trial_id and h]
        if not means:
            return TrialScheduler.CONTINUE
        means.sort()
        median = means[len(means) // 2]
        best = max(self._histories[trial.trial_id])
        return TrialScheduler.STOP if best < median \
            else TrialScheduler.CONTINUE


class PopulationBasedTraining(TrialScheduler):
    """PBT (reference pbt.py): every ``perturbation_interval`` steps, a
    bottom-quantile trial exploits (copies config+checkpoint of) a
    top-quantile trial and explores (perturbs) its hyperparameters."""

    def __init__(self, metric: str = "score", mode: str = "max",
                 time_attr: str = "training_iteration",
                 perturbation_interval: int = 5,
                 hyperparam_mutations: Optional[Dict[str, Any]] = None,
                 quantile_fraction: float = 0.25,
                 resample_probability: float = 0.25,
                 seed: Optional[int] = None):
        self._metric = metric
        self._mode = mode
        self._time_attr = time_attr
        self._interval = perturbation_interval
        self._mutations = hyperparam_mutations or {}
        self._quantile = quantile_fraction
        self._resample_prob = resample_probability
        self._rng = random.Random(seed)
        self._last_perturb: Dict[str, int] = {}
        self._trials: List[Trial] = []
        self.num_perturbations = 0

    def on_trial_add(self, trial: Trial):
        self._trials.append(trial)

    def _score(self, trial: Trial) -> Optional[float]:
        v = trial.metric(self._metric)
        if v is None:
            return None
        return float(v) if self._mode == "max" else -float(v)

    def _explore(self, config: Dict[str, Any]) -> Dict[str, Any]:
        out = dict(config)
        for k, spec in self._mutations.items():
            if self._rng.random() < self._resample_prob:
                out[k] = spec.sample(self._rng) if isinstance(spec, Domain) \
                    else self._rng.choice(spec)
            elif isinstance(out.get(k), (int, float)):
                factor = self._rng.choice([0.8, 1.2])
                out[k] = type(out[k])(out[k] * factor)
        return out

    def on_trial_result(self, trial: Trial, result: Dict) -> str:
        t = result.get(self._time_attr, 0)
        last = self._last_perturb.get(trial.trial_id, 0)
        if t - last < self._interval:
            return TrialScheduler.CONTINUE
        self._last_perturb[trial.trial_id] = t
        scored = [(self._score(x), x) for x in self._trials
                  if self._score(x) is not None]
        if len(scored) < 2:
            return TrialScheduler.CONTINUE
        scored.sort(key=lambda p: p[0])
        n = max(1, int(len(scored) * self._quantile))
        bottom = [x for _, x in scored[:n]]
        top = [x for _, x in scored[-n:]]
        if trial in bottom and trial not in top:
            model = self._rng.choice(top)
            trial.config = self._explore(model.config)
            trial.checkpoint = model.checkpoint
            self.num_perturbations += 1
            # Restart with the exploited config+checkpoint.
            return TrialScheduler.PAUSE
        return TrialScheduler.CONTINUE
