"""The spread of ``case_fused_spiller``'s counts over many runs of one
package alone (ROADMAP C.7).

    JAX_PLATFORMS=cpu python tests/fused_spiller_spread.py --package jax
    JAX_PLATFORMS=cpu python tests/fused_spiller_spread.py --package port

Runs ``tests/test_torch_object_store.py``'s ``case_fused_spiller`` (the
spill thread fuses twelve 256 KiB objects into batch files, then every
object is read back) ``--runs`` times on the named package's bare store,
each run in a fresh directory with the case's seed, and prints one JSON
line: for the store's ``spilled_objects`` and ``restored_objects``
before and after the reads, and the spill manager's ``spill_batches``,
the count of runs that gave each value.  Where the read-back's restores wake
the spill thread again is up to the threads, so the counts after the
reads spread from run to run; the case compares the packages by an
invariant there.
"""

import argparse
import collections
import json
import os
import sys
import tempfile
from pathlib import Path

import numpy as np
import pytest

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [HERE, os.path.dirname(HERE)]
import test_torch_object_store as ts  # noqa: E402


def spread(package: str, runs: int) -> dict:
    pkg = {p.name: p for p in ts._pkgs()}[package]
    seed = ts.CASES.index(ts.case_fused_spiller)
    counts = collections.defaultdict(collections.Counter)
    for _ in range(runs):
        with tempfile.TemporaryDirectory() as tmp, \
                pytest.MonkeyPatch.context() as mp:
            tmp_path = Path(tmp)
            (tmp_path / pkg.name).mkdir()
            made = []

            def make_store(*args, **kw):
                made.append(make(*args, **kw))
                return made[-1]
            make = ts._make_store
            mp.setattr(ts, "_make_store", make_store)
            seen = ts.case_fused_spiller(pkg, tmp_path, mp,
                                         np.random.default_rng(seed))
        assert all(seen[4]) and seen[5], seen
        (store, _spill_dir), = made
        for when, stats in (("before_reads", seen[2]),
                            ("after_reads", store.stats)):
            for key in ("spilled_objects", "restored_objects"):
                counts[f"{when}_{key}"][stats[key]] += 1
        counts["spill_batches"][seen[1]["spill_batches"]] += 1
    return {"package": package, "runs": runs,
            **{k: dict(sorted(v.items())) for k, v in counts.items()}}


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--package", choices=("jax", "port"), required=True)
    parser.add_argument("--runs", type=int, default=50)
    args = parser.parse_args(argv)
    print(json.dumps(spread(args.package, args.runs)), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
