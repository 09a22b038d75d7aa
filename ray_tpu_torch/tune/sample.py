"""Search-space primitives.

A copy of ``ray_tpu.tune.sample`` for the PyTorch port.

Parity: reference ``python/ray/tune/sample.py`` — ``uniform``,
``loguniform``, ``quniform``, ``randint``, ``qrandint``, ``choice``,
``sample_from``, and ``grid_search`` markers resolved by the variant
generator (``suggest/variant_generator.py``).
"""

from __future__ import annotations

import random
from typing import Any, Callable, Dict, List


class Domain:
    def sample(self, rng: random.Random) -> Any:
        raise NotImplementedError


class Float(Domain):
    def __init__(self, lo: float, hi: float, log: bool = False,
                 q: float = None):
        self.lo, self.hi, self.log, self.q = lo, hi, log, q

    def sample(self, rng):
        import math
        if self.log:
            v = math.exp(rng.uniform(math.log(self.lo), math.log(self.hi)))
        else:
            v = rng.uniform(self.lo, self.hi)
        if self.q:
            v = round(v / self.q) * self.q
        return v


class Integer(Domain):
    def __init__(self, lo: int, hi: int, q: int = 1):
        self.lo, self.hi, self.q = lo, hi, q

    def sample(self, rng):
        v = rng.randrange(self.lo, self.hi)
        if self.q > 1:
            v = (v // self.q) * self.q
        return v


class Categorical(Domain):
    def __init__(self, categories: List[Any]):
        self.categories = list(categories)

    def sample(self, rng):
        return rng.choice(self.categories)


class Function(Domain):
    def __init__(self, fn: Callable):
        self.fn = fn

    def sample(self, rng):
        try:
            return self.fn(None)
        except TypeError:
            return self.fn()


def uniform(lo: float, hi: float) -> Float:
    return Float(lo, hi)


def loguniform(lo: float, hi: float) -> Float:
    return Float(lo, hi, log=True)


def quniform(lo: float, hi: float, q: float) -> Float:
    return Float(lo, hi, q=q)


def randint(lo: int, hi: int) -> Integer:
    return Integer(lo, hi)


def qrandint(lo: int, hi: int, q: int) -> Integer:
    return Integer(lo, hi, q=q)


def choice(categories: List[Any]) -> Categorical:
    return Categorical(categories)


def sample_from(fn: Callable) -> Function:
    return Function(fn)


def grid_search(values: List[Any]) -> Dict[str, List[Any]]:
    return {"grid_search": list(values)}
