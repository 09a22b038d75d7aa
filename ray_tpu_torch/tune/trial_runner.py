"""TrialRunner: the Tune event loop.

Parity: reference ``python/ray/tune/trial_runner.py`` (``step()`` loop:
start trials up to cluster capacity, fetch one ready result via
``ray.wait``, route it through searcher + scheduler, apply
CONTINUE/STOP/PAUSE) with the executor role of ``ray_trial_executor.py``
(trial actors, checkpoint handling, restarts) folded in.

A copy of ``ray_tpu.tune.trial_runner`` for the PyTorch port.
Divergence (ROADMAP C.32, by design as C.24): ``resources_per_trial``'s
``"gpu"`` becomes the trial actor's ``num_gpus``, where the reference
reads ``"tpu"`` into ``num_tpus``.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional

import ray_tpu_torch
from ray_tpu_torch.tune.schedulers import FIFOScheduler, TrialScheduler
from ray_tpu_torch.tune.trainable import TrialRunnerActor
from ray_tpu_torch.tune.trial import Trial


def _make_stopper(stop) -> Callable[[Trial, Dict], bool]:
    if stop is None:
        return lambda trial, result: False
    if callable(stop):
        return lambda trial, result: stop(trial.trial_id, result)
    if isinstance(stop, dict):
        def check(trial, result):
            for k, v in stop.items():
                if result.get(k) is not None and result[k] >= v:
                    return True
            return False
        return check
    raise ValueError(f"invalid stop spec: {stop!r}")


class TrialRunner:
    def __init__(self, trainable, variant_source, *,
                 scheduler: Optional[TrialScheduler] = None,
                 searcher=None,
                 stop=None,
                 resources_per_trial: Optional[Dict[str, float]] = None,
                 max_concurrent_trials: Optional[int] = None,
                 raise_on_failed_trial: bool = True):
        self._trainable = trainable
        self._scheduler = scheduler or FIFOScheduler()
        self._searcher = searcher
        self._stopper = _make_stopper(stop)
        self._resources = dict(resources_per_trial or {"cpu": 1})
        self._raise_on_failed = raise_on_failed_trial
        self.trials: List[Trial] = []
        self._source = variant_source
        self._source_empty = False
        self._no_more_sent = False
        if searcher is None:
            # Grid/random variants are free to enumerate: register them
            # all up front so synchronous schedulers (HyperBand) see
            # full brackets regardless of concurrency.  Only a
            # model-based searcher is pulled lazily (in step()), so it
            # sees completed results before suggesting the next config.
            while self._next_trial() is not None:
                pass
        if max_concurrent_trials is None:
            total = ray_tpu_torch.cluster_resources().get("CPU", 1)
            per = self._resources.get("cpu", 1) or 1
            max_concurrent_trials = max(1, int(total // per))
        self._max_concurrent = max_concurrent_trials
        self._actor_cls = ray_tpu_torch.remote(
            num_cpus=self._resources.get("cpu", 1),
            num_gpus=self._resources.get("gpu", 0) or 0,
        )(TrialRunnerActor)
        self._inflight: Dict[Any, Trial] = {}  # poll ref -> trial

    # ------------------------------------------------------------------
    def _running(self) -> List[Trial]:
        return [t for t in self.trials if t.status == Trial.RUNNING]

    def _start_trial(self, trial: Trial):
        trial.runner = self._actor_cls.remote()
        ray_tpu_torch.get(trial.runner.start.remote(
            self._trainable, trial.config, trial.trial_id, trial.checkpoint))
        trial.status = Trial.RUNNING
        self._poll(trial)

    def _poll(self, trial: Trial):
        ref = trial.runner.get_next.remote()
        self._inflight[ref] = trial

    def _stop_trial(self, trial: Trial, status: str):
        trial.status = status
        if trial.runner is not None:
            try:
                trial.runner.request_stop.remote()
                ray_tpu_torch.kill(trial.runner)
            except Exception:
                pass
            trial.runner = None

    def _next_trial(self) -> Optional[Trial]:
        if self._source_empty:
            return None
        v = self._source.next_variant()
        if v is None:
            self._source_empty = True
            return None
        tag, cfg, trial_id = v if len(v) == 3 else (*v, None)
        trial = Trial(cfg, resources=self._resources,
                      experiment_tag=tag, trial_id=trial_id)
        self.trials.append(trial)
        self._scheduler.on_trial_add(trial)
        return trial

    # ------------------------------------------------------------------
    def is_finished(self) -> bool:
        return self._source_empty and \
            all(t.is_finished() for t in self.trials)

    def step(self):
        # (0) a synchronous scheduler (HyperBand halving) may terminate
        # PAUSED trials by setting their status directly — run the
        # completion lifecycle (searcher/scheduler notifications) for
        # any finished trial that never went through _complete.
        for t in self.trials:
            if t.is_finished() and not getattr(t, "_lifecycle_done",
                                               False):
                self._notify_complete(t)
        # (1) launch runnable trials up to the concurrency cap.  The
        # scheduler picks (reference choose_trial_to_run): synchronous
        # schedulers hold PAUSED trials at a rung until the cohort
        # decides; the default takes any PENDING/PAUSED trial.  When the
        # scheduler has nothing runnable, pull the next variant from the
        # (lazy) source.
        while len(self._running()) < self._max_concurrent:
            t = self._scheduler.choose_trial_to_run(self.trials)
            if t is None:
                if self._next_trial() is None:
                    break
                continue
            self._start_trial(t)
        if not self._inflight:
            if self.is_finished():
                return
            # Nothing running and nothing startable, but unfinished
            # trials remain: they are PAUSED waiting on cohorts that
            # can never fill (the source is exhausted).  Tell the
            # scheduler once so it can close its brackets; if it has no
            # such hook (or that didn't help), fail loudly over hanging.
            hook = getattr(self._scheduler, "no_more_trials", None)
            if hook is not None and not self._no_more_sent:
                self._no_more_sent = True
                hook()
                return
            raise TuneError(
                "Tune deadlock: no trial is runnable, none are running, "
                "and the variant source is exhausted; paused trials: " +
                ", ".join(t.trial_id for t in self.trials
                          if t.status == Trial.PAUSED))
        # (2) wait for one trial event.
        ready, _ = ray_tpu_torch.wait(list(self._inflight.keys()), num_returns=1,
                                timeout=60.0)
        for ref in ready:
            trial = self._inflight.pop(ref)
            event = ray_tpu_torch.get(ref)
            self._handle_event(trial, event)

    def _handle_event(self, trial: Trial, event):
        if trial.status != Trial.RUNNING:
            return
        if event.type == "checkpoint":
            trial.checkpoint = event.data
            self._poll(trial)
        elif event.type == "report":
            result = dict(event.data)
            trial.update_result(result)
            if self._searcher is not None:
                self._searcher.on_trial_result(trial.trial_id, result)
            if self._stopper(trial, result):
                decision = TrialScheduler.STOP
            else:
                decision = self._scheduler.on_trial_result(trial, result)
            if decision == TrialScheduler.STOP:
                self._complete(trial, Trial.TERMINATED)
            elif decision == TrialScheduler.PAUSE:
                # PBT exploit/explore: restart with the (possibly
                # mutated) config + exploited checkpoint.
                self._stop_trial(trial, Trial.PAUSED)
            else:
                self._poll(trial)
        elif event.type == "done":
            self._complete(trial, Trial.TERMINATED)
        elif event.type == "error":
            trial.error = event.data
            self._complete(trial, Trial.ERROR)
            if self._raise_on_failed:
                raise TuneError(
                    f"Trial {trial.trial_id} failed: {event.data!r}"
                ) from event.data
        else:  # timeout — keep polling
            self._poll(trial)

    def _complete(self, trial: Trial, status: str):
        self._stop_trial(trial, status)
        self._notify_complete(trial)

    def _notify_complete(self, trial: Trial):
        trial._lifecycle_done = True
        if self._searcher is not None:
            self._searcher.on_trial_complete(
                trial.trial_id, trial.last_result,
                error=trial.status == Trial.ERROR)
        self._scheduler.on_trial_complete(trial, trial.last_result)

    def run(self):
        while not self.is_finished():
            self.step()
        # Final sweep: trials the scheduler terminated on the last step
        # still owe their completion notifications.
        for t in self.trials:
            if t.is_finished() and not getattr(t, "_lifecycle_done",
                                               False):
                self._notify_complete(t)
        # Drop dangling poll refs.
        self._inflight.clear()


class TuneError(RuntimeError):
    pass
