"""Search algorithms.

Parity: reference ``python/ray/tune/suggest/`` —
``BasicVariantGenerator`` (``basic_variant.py``: grid_search cross
product x num_samples random draws, ``variant_generator.py``
``generate_variants``), the ``Searcher`` ABC (``suggest/suggestion.py``)
with suggest/on_trial_complete, and a built-in model-based searcher.
The reference wraps external libraries (hyperopt/optuna/ax/...); here
``TPESearcher`` is a self-contained Parzen-estimator searcher on the
standard library's ``math`` and ``random``.  A copy of
``ray_tpu.tune.suggest`` for the PyTorch port: the same draws from the
same seeded ``random.Random``.
"""

from __future__ import annotations

import itertools
import random
from typing import Any, Dict, Iterator, List, Optional, Tuple

from ray_tpu_torch.tune.sample import Categorical, Domain, Float, Integer


def _split_spec(spec: Dict[str, Any], prefix=()):
    """Yield (path, value) leaves."""
    for k, v in spec.items():
        path = prefix + (k,)
        if isinstance(v, dict) and "grid_search" not in v:
            yield from _split_spec(v, path)
        else:
            yield path, v


def _set_path(cfg: Dict, path: Tuple[str, ...], value):
    d = cfg
    for k in path[:-1]:
        d = d.setdefault(k, {})
    d[path[-1]] = value


def generate_variants(spec: Dict[str, Any], rng: random.Random
                      ) -> Iterator[Tuple[str, Dict[str, Any]]]:
    """All grid combinations; Domains/sample_from resolved per variant
    (reference variant_generator.generate_variants)."""
    leaves = list(_split_spec(spec))
    grid_leaves = [(p, v["grid_search"]) for p, v in leaves
                   if isinstance(v, dict) and "grid_search" in v]
    other_leaves = [(p, v) for p, v in leaves
                    if not (isinstance(v, dict) and "grid_search" in v)]
    grids = [vals for _, vals in grid_leaves]
    for combo in itertools.product(*grids) if grids else [()]:
        cfg: Dict[str, Any] = {}
        tag_parts = []
        for (path, _), val in zip(grid_leaves, combo):
            _set_path(cfg, path, val)
            tag_parts.append(f"{'.'.join(path)}={val}")
        for path, v in other_leaves:
            if isinstance(v, Domain):
                val = v.sample(rng)
                tag_parts.append(f"{'.'.join(path)}={val:.4g}"
                                 if isinstance(val, float)
                                 else f"{'.'.join(path)}={val}")
            else:
                val = v
            _set_path(cfg, path, val)
        yield ",".join(tag_parts), cfg


class Searcher:
    """ABC (reference suggest/suggestion.py)."""

    def __init__(self, metric: Optional[str] = None, mode: str = "max"):
        self.metric = metric
        self.mode = mode

    def suggest(self, trial_id: str) -> Optional[Dict[str, Any]]:
        raise NotImplementedError

    def on_trial_result(self, trial_id: str, result: Dict):
        pass

    def on_trial_complete(self, trial_id: str,
                          result: Optional[Dict] = None,
                          error: bool = False):
        pass


class TPESearcher(Searcher):
    """Tree-structured Parzen Estimator searcher — the model behind
    BOHB (reference wraps hyperopt/``TuneBOHB``; this is a
    self-contained numpy implementation over the repo's own Domains).

    Observed (config, score) pairs are split at the ``gamma`` quantile
    into good/bad sets; per dimension a kernel-density model is fit to
    each set (Gaussian KDE for Float/Integer, smoothed frequencies for
    Categorical) and candidates drawn from the good model are ranked by
    the density ratio l(x)/g(x).  Until ``n_initial`` results arrive it
    samples randomly."""

    def __init__(self, space: Dict[str, Any], metric: str = "score",
                 mode: str = "max", n_initial: int = 8,
                 gamma: float = 0.25, n_candidates: int = 24,
                 seed: Optional[int] = None):
        super().__init__(metric, mode)
        self._space = dict(space)
        self._rng = random.Random(seed)
        self._n_initial = n_initial
        self._gamma = gamma
        self._n_candidates = n_candidates
        self._configs: Dict[str, Dict[str, Any]] = {}
        self._scores: Dict[str, float] = {}

    # -- observation ---------------------------------------------------
    def _observe(self, trial_id: str, result: Optional[Dict]):
        if not result or trial_id not in self._configs:
            return
        v = result.get(self.metric)
        if v is None:
            return
        v = float(v) if self.mode == "max" else -float(v)
        # Keep the best score the trial ever reported.
        prev = self._scores.get(trial_id)
        self._scores[trial_id] = v if prev is None else max(prev, v)

    def on_trial_result(self, trial_id: str, result: Dict):
        self._observe(trial_id, result)

    def on_trial_complete(self, trial_id: str,
                          result: Optional[Dict] = None,
                          error: bool = False):
        if not error:
            self._observe(trial_id, result)

    # -- modelling -----------------------------------------------------
    def _split(self):
        scored = [(self._scores[tid], self._configs[tid])
                  for tid in self._scores]
        scored.sort(key=lambda p: p[0], reverse=True)
        k = max(1, int(len(scored) * self._gamma))
        return [c for _, c in scored[:k]], [c for _, c in scored[k:]]

    @staticmethod
    def _kde_logpdf(x: float, points: List[float], lo: float, hi: float
                    ) -> float:
        import math
        if not points:
            return 0.0
        span = max(hi - lo, 1e-12)
        # Silverman-ish bandwidth, floored so single points still smear.
        bw = max(span * 1.06 * len(points) ** -0.2 / 4, span * 0.05)
        dens = sum(math.exp(-0.5 * ((x - p) / bw) ** 2) for p in points)
        return math.log(dens / (len(points) * bw) + 1e-300)

    def _dim_logratio(self, name: str, dom, value, good, bad) -> float:
        import math
        gv = [c[name] for c in good if name in c]
        bv = [c[name] for c in bad if name in c]
        if isinstance(dom, Categorical):
            n = len(dom.categories)
            gcount = 1 + sum(1 for v in gv if v == value)
            bcount = 1 + sum(1 for v in bv if v == value)
            return math.log(gcount / (len(gv) + n)) - \
                math.log(bcount / (len(bv) + n))
        if hasattr(dom, "lo"):
            lo, hi = float(dom.lo), float(dom.hi)
            if getattr(dom, "log", False):
                tr = math.log
                lo, hi = tr(lo), tr(hi)
                x = tr(value)
                gv = [tr(v) for v in gv]
                bv = [tr(v) for v in bv]
            else:
                x = float(value)
                gv = [float(v) for v in gv]
                bv = [float(v) for v in bv]
            return self._kde_logpdf(x, gv, lo, hi) - \
                self._kde_logpdf(x, bv, lo, hi)
        return 0.0

    def _sample_random(self) -> Dict[str, Any]:
        cfg = {}
        for k, v in self._space.items():
            cfg[k] = v.sample(self._rng) if isinstance(v, Domain) else v
        return cfg

    def _sample_from_good(self, good: List[Dict]) -> Dict[str, Any]:
        """Candidate draw: per dimension, perturb a random good value
        (the TPE l(x) draw), falling back to the prior."""
        base = self._rng.choice(good)
        cfg = {}
        for k, dom in self._space.items():
            if not isinstance(dom, Domain) or k not in base \
                    or self._rng.random() < 0.2:
                cfg[k] = dom.sample(self._rng) \
                    if isinstance(dom, Domain) else dom
                continue
            v = base[k]
            if isinstance(dom, Categorical):
                cfg[k] = v
            elif isinstance(dom, Float):
                import math
                if dom.log:
                    span = math.log(dom.hi) - math.log(dom.lo)
                    x = math.log(v) + self._rng.gauss(0, span * 0.1)
                    cfg[k] = min(dom.hi, max(dom.lo, math.exp(x)))
                else:
                    span = dom.hi - dom.lo
                    x = v + self._rng.gauss(0, span * 0.1)
                    cfg[k] = min(dom.hi, max(dom.lo, x))
                if dom.q:
                    cfg[k] = round(cfg[k] / dom.q) * dom.q
            elif isinstance(dom, Integer):
                span = max(1, dom.hi - dom.lo)
                x = int(round(v + self._rng.gauss(0, span * 0.1)))
                x = min(dom.hi - 1, max(dom.lo, x))
                if dom.q > 1:
                    x = (x // dom.q) * dom.q
                cfg[k] = x
            else:
                cfg[k] = dom.sample(self._rng)
        return cfg

    def suggest(self, trial_id: str) -> Optional[Dict[str, Any]]:
        if len(self._scores) < self._n_initial:
            cfg = self._sample_random()
        else:
            good, bad = self._split()
            if not good:
                cfg = self._sample_random()
            else:
                best, best_score = None, -float("inf")
                for _ in range(self._n_candidates):
                    cand = self._sample_from_good(good)
                    s = sum(
                        self._dim_logratio(k, dom, cand[k], good, bad)
                        for k, dom in self._space.items()
                        if isinstance(dom, Domain))
                    if s > best_score:
                        best, best_score = cand, s
                cfg = best
        self._configs[trial_id] = cfg
        return dict(cfg)


# BOHB = HyperBand scheduling + TPE model (reference tune/suggest/bohb.py
# TuneBOHB); pair TPESearcher with schedulers.HyperBandScheduler.
TuneBOHB = TPESearcher


class BasicVariantGenerator:
    """Grid x random sampling (reference basic_variant.py)."""

    def __init__(self, spec: Dict[str, Any], num_samples: int = 1,
                 seed: Optional[int] = None):
        self._rng = random.Random(seed)
        self._variants: List[Tuple[str, Dict]] = []
        for _ in range(num_samples):
            self._variants.extend(generate_variants(spec, self._rng))
        self._idx = 0

    def __len__(self):
        return len(self._variants)

    def next_variant(self) -> Optional[Tuple[str, Dict]]:
        if self._idx >= len(self._variants):
            return None
        v = self._variants[self._idx]
        self._idx += 1
        return v


class SearcherVariantGenerator:
    """Adapts a Searcher to the variant stream (reference
    SearchGenerator)."""

    def __init__(self, searcher: Searcher, num_samples: int):
        self._searcher = searcher
        self._remaining = num_samples
        self._count = 0

    def __len__(self):
        return self._remaining + self._count

    def next_variant(self):
        """(tag, config, trial_id) — the trial_id is the one suggest()
        saw, so the Trial must carry it (TrialRunner passes it through)."""
        if self._remaining <= 0:
            return None
        trial_id = f"suggested_{self._count:05d}"
        cfg = self._searcher.suggest(trial_id)
        if cfg is None:
            return None
        self._remaining -= 1
        self._count += 1
        return f"search_{self._count}", cfg, trial_id
