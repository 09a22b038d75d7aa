"""The port's Data (``ray_tpu_torch.data``) against the JAX package's, on
the CPU.

Each case of ``tests/test_dataset.py`` runs once under each package's
``init`` (the port's with ``device="cpu"``) on the same inputs, and the
two outcomes must be equal: the values (as plain Python), or the
error's type and message.  ``test_to_jax`` is held against
``to_torch(device="cpu")``: the same values, shapes and padding of the
tail.  Then the port's divergences, each pinned by a test ending in
``_in_the_port``: ``to_torch``'s device option in place of ``to_jax``
(ROADMAP C.26) and numpy batches that need neither pandas nor pyarrow
(C.29).  The last test checks that no thread of the port outlives
``shutdown``.
"""

import importlib
import sys
import threading

import numpy as np
import pytest
import torch

import ray_tpu_torch
import ray_tpu_torch.data
from torch_cluster_util import PORT, outcome

try:  # the card's machine has no JAX
    import ray_tpu
    import ray_tpu.data
except ImportError:
    ray_tpu = None

NUM_CPUS = 8


class Pkg:
    def __init__(self, name):
        self.name = name
        self.pkg = importlib.import_module(name)
        self.data = importlib.import_module(f"{name}.data")


def plain(x):
    """A value as plain Python, so that outcomes compare with ``==``."""
    if isinstance(x, dict):
        return {k: plain(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)(plain(v) for v in x)
    if isinstance(x, torch.Tensor):
        return ("array", str(x.dtype).split(".")[-1], x.tolist())
    if hasattr(x, "__array__") and not isinstance(x, np.generic):
        a = np.asarray(x)
        return ("array", str(a.dtype), a.tolist())
    if isinstance(x, np.generic):
        return x.item()
    return x


def run(name, case, *args):
    p = Pkg(name)
    kw = {"device": "cpu"} if name == PORT else {}
    p.pkg.init(num_cpus=NUM_CPUS, **kw)
    try:
        return outcome(lambda: plain(case(p, *args)))
    finally:
        p.pkg.shutdown()


def both(case, *args):
    if ray_tpu is None:
        pytest.skip("needs the JAX package")
    return [run(name, case, *args) for name in ("ray_tpu", PORT)]


# -- the reference's cases ---------------------------------------------------

def case_range_basic(p):
    ds = p.data.range(100, parallelism=4)
    return ds.count(), ds.num_blocks(), ds.take(5), ds.sum()


def case_range_table(p):
    ds = p.data.range_table(10, parallelism=2)
    return ds.take(3)[0]["value"], ds.schema()


def case_from_items_map_filter(p):
    ds = p.data.from_items(list(range(20)), parallelism=3)
    return sorted(ds.map(lambda x: x * 2).filter(lambda x: x % 4 == 0)
                  .take(100))


def case_flat_map(p):
    return sorted(p.data.from_items([1, 2, 3])
                  .flat_map(lambda x: [x, x * 10]).take(10))


def case_map_batches_numpy(p):
    ds = p.data.range_table(32, parallelism=2)
    return ds.map_batches(lambda b: {"value": b["value"] * 2}, batch_size=8,
                          batch_format="numpy").sum("value")


def case_map_batches_pandas(p):
    def add_col(df):
        df["double"] = df["value"] * 2
        return df
    out = p.data.range_table(16, parallelism=2).map_batches(
        add_col, batch_format="pandas")
    return out.take(1)[0]["double"], out.sum("double")


def case_map_batches_actors(p):
    ds = p.data.range_table(24, parallelism=3)
    return ds.map_batches(lambda b: {"value": b["value"] + 1},
                          batch_format="numpy", compute="actors").sum("value")


def case_repartition(p):
    ds = p.data.range(100, parallelism=2).repartition(5)
    return ds.num_blocks(), ds.count(), ds.sum()


def case_random_shuffle(p):
    vals = p.data.range(100, parallelism=4).random_shuffle(seed=0).take(100)
    return vals, sorted(vals) == list(range(100)), vals != list(range(100))


def case_sort_simple(p):
    items = [int(x) for x in np.random.default_rng(0).permutation(50)]
    return p.data.from_items(items, parallelism=4).sort().take(50)


def case_sort_key_descending(p):
    ds = p.data.from_items([{"a": i % 7, "b": i} for i in range(30)],
                           parallelism=3)
    return [r["a"] for r in ds.sort(key="a", descending=True).take(30)]


def case_groupby(p):
    ds = p.data.from_items([{"k": i % 3, "v": i} for i in range(12)],
                           parallelism=3)
    counts = {r["k"]: r["count"] for r in ds.groupby("k").count().take(10)}
    sums = {r["k"]: r["sum(v)"] for r in ds.groupby("k").sum("v").take(10)}
    return counts, sums


def case_split_union_zip(p):
    parts = p.data.range(30, parallelism=6).split(3)
    u = parts[0].union(parts[1], parts[2])
    a = p.data.from_items([1, 2, 3])
    b = p.data.from_items(["x", "y", "z"])
    return [q.count() for q in parts], u.count(), a.zip(b).take(3)


def case_limit_take(p):
    ds = p.data.range(100, parallelism=4)
    return ds.limit(7).count(), ds.take(3)


def case_iter_batches_static_shapes(p):
    ds = p.data.range_table(50, parallelism=3)
    return [b["value"] for b in ds.iter_batches(
        batch_size=16, pad_to_batch=True, batch_format="numpy")]


def case_to_jax(p):
    """``to_jax`` of the reference, ``to_torch(device="cpu")`` of the
    port: 32 rows (whole batches) and 30 rows (the tail padded)."""
    out = []
    for n in (32, 30):
        ds = p.data.range_table(n, parallelism=2)
        if p.name == PORT:
            batches = list(ds.to_torch(batch_size=8, device="cpu"))
        else:
            batches = list(ds.to_jax(batch_size=8))
        out.append([(tuple(b["value"].shape), b["value"]) for b in batches])
    return out


def case_csv_roundtrip(p, tmp):
    import pandas as pd
    df = pd.DataFrame({"a": range(10), "b": [f"s{i}" for i in range(10)]})
    out_dir = f"{tmp}/{p.name}/csv"
    p.data.from_pandas(df).write_csv(out_dir)
    back = p.data.read_csv(out_dir)
    return back.count(), back.sum("a")


def case_parquet_roundtrip(p, tmp):
    out_dir = f"{tmp}/{p.name}/pq"
    p.data.range_table(20, parallelism=2).write_parquet(out_dir)
    back = p.data.read_parquet(out_dir)
    return back.count(), back.sum("value")


def case_numpy_roundtrip(p, tmp):
    out_dir = f"{tmp}/{p.name}/np"
    p.data.from_numpy(np.arange(12)).write_numpy(out_dir)
    return p.data.read_numpy(out_dir).sum("value")


def case_read_text(p, tmp):
    path = f"{tmp}/{p.name}.txt"
    with open(path, "w") as f:
        f.write("alpha\nbeta\ngamma\n")
    return p.data.read_text(path).take(5)


def case_pipeline_window(p):
    pipe = p.data.range(40, parallelism=8).window(blocks_per_window=2)
    return sum(pipe.map(lambda x: x * 2).iter_rows())


def case_pipeline_repeat(p):
    return p.data.range(10, parallelism=2).repeat(3).count()


def case_pipeline_shuffle_each_window(p):
    pipe = p.data.range(20, parallelism=4).window(blocks_per_window=2) \
        .random_shuffle_each_window(seed=1)
    return list(pipe.iter_rows())


def case_pipeline_split(p):
    shards = p.data.range(24, parallelism=4).window(
        blocks_per_window=2).split(2)
    return sum(shards[0].iter_rows()) + sum(shards[1].iter_rows())


def case_stats_aggregates(p):
    ds = p.data.from_items([float(i) for i in range(10)])
    return ds.mean(), ds.min(), ds.max(), ds.std()


def case_pipeline_split_single_execution(p):
    pipe = p.data.range(40, parallelism=4).window(blocks_per_window=2) \
        .random_shuffle_each_window()
    a, b = pipe.split(2)
    return sorted(list(a.iter_rows()) + list(b.iter_rows()))


def case_split_equal_rows(p):
    a, b = p.data.from_items(list(range(6)), parallelism=2).split(
        2, equal=True)
    return a.count(), b.count(), sorted(list(a.iter_rows()) +
                                        list(b.iter_rows()))


def case_pipeline_split_reiterate_raises(p):
    a, _ = p.data.range(8, parallelism=2).window(blocks_per_window=1).split(2)
    list(a.iter_rows())
    return list(a.iter_rows())


def case_union_mixed_schema_repartition(p):
    u = p.data.from_numpy(np.arange(4)).union(
        p.data.from_items([{"x": 1}, {"x": 2}]))
    return len(u.repartition(2).take(10))


def case_actor_pool_init_fn_with_one_arg_fn(p):
    compute = importlib.import_module(f"{p.name}.data.impl.compute")
    out = p.data.range(8).map(
        lambda row: row * 2,
        compute=compute.ActorPoolStrategy(init_fn=lambda: 5))
    return sorted(int(x) for x in out.take(8))


def case_push_shuffle_preserves_rows(p):
    out = p.data.range(200, parallelism=8).random_shuffle(seed=7,
                                                          push_based=True)
    rows = out.take(200)
    return rows, sorted(rows) == list(range(200))


def case_push_and_naive_agree(p):
    a = p.data.range(120, parallelism=6).random_shuffle(seed=3,
                                                        push_based=True)
    b = p.data.range(120, parallelism=6).random_shuffle(seed=3,
                                                        push_based=False)
    return a.take(120) == b.take(120)


def case_push_repartition(p):
    ds = p.data.range(100, parallelism=7).repartition(3, push_based=True)
    return ds.num_blocks(), sorted(ds.take(100)) == list(range(100))


def case_random_access_lookups(p):
    n = 64
    ds = p.data.from_items([
        {"id": int(i), "payload": float(i) * 2.0}
        for i in np.random.default_rng(0).permutation(n)])
    rad = ds.repartition(4).to_random_access_dataset("id", num_workers=2)
    return (rad.stats()["num_workers"], p.pkg.get(rad.get_async(10)),
            [r["id"] for r in rad.multiget([3, 63, 0, 41])],
            p.pkg.get(rad.get_async(999)),
            [r["id"] for r in rad.multiget([15, 31, 47])])


def case_map_groups_rows_and_lists(p):
    ds = p.data.from_items([{"k": i % 3, "v": float(i)} for i in range(30)])
    out = ds.groupby("k").map_groups(
        lambda rows: {"k": rows[0]["k"], "total": sum(r["v"] for r in rows)})
    out2 = ds.groupby("k").map_groups(
        lambda rows: [{"k": rows[0]["k"], "n": len(rows)}] * 2)
    return sorted(out.take(10), key=lambda r: r["k"]), out2.count()


CASES = [case_range_basic, case_range_table, case_from_items_map_filter,
         case_flat_map, case_map_batches_numpy, case_map_batches_pandas,
         case_map_batches_actors, case_repartition, case_random_shuffle,
         case_sort_simple, case_sort_key_descending, case_groupby,
         case_split_union_zip, case_limit_take,
         case_iter_batches_static_shapes, case_pipeline_window,
         case_pipeline_repeat, case_pipeline_shuffle_each_window,
         case_pipeline_split, case_stats_aggregates,
         case_pipeline_split_single_execution, case_split_equal_rows,
         case_pipeline_split_reiterate_raises,
         case_union_mixed_schema_repartition,
         case_actor_pool_init_fn_with_one_arg_fn,
         case_push_shuffle_preserves_rows, case_push_and_naive_agree,
         case_push_repartition, case_random_access_lookups,
         case_map_groups_rows_and_lists]


@pytest.mark.parametrize("case", CASES, ids=lambda c: c.__name__)
def test_dataset_case_matches_jax(case):
    want, got = both(case)
    assert got == want
    assert want[0] == "value" or case is \
        case_pipeline_split_reiterate_raises, want


@pytest.mark.parametrize("case", [case_csv_roundtrip, case_parquet_roundtrip,
                                  case_numpy_roundtrip, case_read_text],
                         ids=lambda c: c.__name__)
def test_dataset_file_case_matches_jax(case, tmp_path):
    want, got = both(case, str(tmp_path))
    assert got == want and want[0] == "value", (want, got)


def test_to_jax_against_to_torch_on_the_cpu():
    """``to_jax``'s values, shapes and padded tail, from
    ``to_torch(device="cpu")``."""
    want, got = both(case_to_jax)
    assert want[0] == "value"
    (ref_whole, ref_tail), (whole, tail) = want[1], got[1]
    assert [s for s, _ in whole] == [s for s, _ in ref_whole] == [(8,)] * 4
    assert [s for s, _ in tail] == [s for s, _ in ref_tail] == [(8,)] * 4
    for (_, a), (_, b) in zip(whole + tail, ref_whole + ref_tail):
        assert a[2] == b[2]
    assert tail[-1][1][2] == [24, 25, 26, 27, 28, 29, 24, 25]


def test_pipeline_reiterate_raises_as_the_reference():
    want, got = both(case_pipeline_split_reiterate_raises)
    assert got == want and want[:2] == ("raise", "RuntimeError")


# -- the port's divergences ----------------------------------------------------

def case_to_torch_plain(p):
    ds = p.data.range_table(30, parallelism=2)
    return [(tuple(b["value"].shape), b["value"])
            for b in ds.to_torch(batch_size=8)]


def test_to_torch_without_device_is_the_reference_to_torch_in_the_port():
    """C.26: without ``device``, the reference's ``to_torch``: CPU tensors
    and the tail as it comes (no padding)."""
    want, got = both(case_to_torch_plain)
    assert got == want
    assert [s for s, _ in got[1]] == [(8,), (8,), (8,), (6,)]


def test_to_torch_device_option_in_the_port():
    """C.26: ``to_torch(device=...)`` is ``to_jax``: ``columns`` picks the
    features, ``label_column`` rides beside them, the tail is padded, and
    ``sharding`` raises naming A.7."""
    ray_tpu_torch.init(num_cpus=4, device="cpu")
    try:
        ds = ray_tpu_torch.data.from_items(
            [{"x": float(i), "y": i % 2, "z": -i} for i in range(10)])
        batches = list(ds.to_torch(batch_size=4, columns=["x"],
                                   label_column="y", device="cpu"))
        with pytest.raises(NotImplementedError, match="A.7"):
            next(ds.to_torch(batch_size=4, device="cpu", sharding=object()))
    finally:
        ray_tpu_torch.shutdown()
    assert [sorted(b) for b in batches] == [["x", "y"]] * 3
    assert all(b["x"].shape == (4,) and b["x"].dtype == torch.float64
               for b in batches)
    assert batches[-1]["x"].tolist() == [8.0, 9.0, 8.0, 9.0]
    assert batches[-1]["y"].tolist() == [0, 1, 0, 1]


def case_numpy_batches(p):
    ds = p.data.range_table(16, parallelism=2)
    out = ds.map_batches(lambda b: {"value": b["value"] + 1}, batch_size=4,
                         batch_format="numpy")
    return out.sum("value"), [t["value"] for t in out.iter_batches(
        batch_size=8, batch_format="numpy")]


def test_numpy_batches_need_no_pandas_in_the_port(monkeypatch):
    """C.29: with pandas and pyarrow missing (as on the card's machine),
    numpy batches run in the port; the reference's ``batch_to_block``
    imports pandas first and raises."""
    if ray_tpu is None:
        pytest.skip("needs the JAX package")
    monkeypatch.setitem(sys.modules, "pandas", None)
    monkeypatch.setitem(sys.modules, "pyarrow", None)
    ref = run("ray_tpu", case_numpy_batches)
    got = run(PORT, case_numpy_batches)
    assert ref[0] == "raise", ref
    assert got[0] == "value" and got[1][0] == sum(range(16)) + 16, got


def test_no_port_thread_survives_shutdown():
    ray_tpu_torch.init(num_cpus=2, device="cpu")
    ray_tpu_torch.shutdown()
    left = [t.name for t in threading.enumerate()
            if t.name.startswith("ray_tpu_torch::")]
    assert not left, left
