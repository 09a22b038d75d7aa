"""The port's runtime environments against the JAX package's, on the CPU.

Every case of ``tests/test_runtime_env.py`` runs on both packages and
the two outcomes must be equal: validation (each package's ``validate``,
``env_hash`` equal across the packages), env vars, ``working_dir`` and
``py_modules`` on thread workers, env vars and cwd injected at spawn and
workers keyed by the env's hash on process workers, and ``pip`` from
local wheels (``--no-index``) into a cached per-hash target directory,
on both kinds of worker.  Each package runs in a cluster of its own with
a fresh ``temp_dir``, both up at once for a class's cases and stopped
after them (no thread of the port may outlive the stop).  Values, error
types and structure (a pid other than the driver's, two envs in two
processes, one env reusing its process) are compared, never pids.  A
wheel is named after its package's run, so that the first run's import
cannot satisfy the second's.  The task bodies are nested functions,
pickled by value into the worker processes.
"""

import importlib
import os
import shutil
import tempfile
import threading
import zipfile

import pytest

from torch_cluster_util import normalize, outcome

PORT = "ray_tpu_torch"
PKGS = ("ray_tpu", PORT)
TAG = {"ray_tpu": "jax", PORT: "port"}
PROCESS = {"worker_process_mode": "process",
           "maximum_startup_concurrency": 4, "num_workers_soft_limit": 4}


def _renv(name):
    return importlib.import_module(f"{name}._private.runtime_env")


def _start(name, root, system_config=None):
    pkg = importlib.import_module(name)
    config = {"temp_dir": os.path.join(root, name), **(system_config or {})}
    if name == PORT:
        pkg.init(num_cpus=4, device="cpu", _system_config=config)
    else:
        pkg.init(num_cpus=4, _system_config=config)
    return pkg


def _stop(names):
    for name in names:
        importlib.import_module(name).shutdown()
        importlib.import_module(f"{name}._private.config") \
            .initialize_config()


def _clusters(system_config=None):
    root = tempfile.mkdtemp(prefix="renv-")
    started = []
    try:
        pkgs = {}
        for name in PKGS:
            pkgs[name] = _start(name, root, system_config)
            started.append(name)
        yield pkgs
    finally:
        _stop(started)
        shutil.rmtree(root, ignore_errors=True)
        left = [t.name for t in threading.enumerate()
                if t.name.startswith(f"{PORT}::")]
        assert not left, left


# Class-scoped: each package has one global worker, so a class's
# clusters stop before the next class starts its own.
@pytest.fixture(scope="class")
def threads():
    yield from _clusters()


@pytest.fixture(scope="class")
def processes():
    yield from _clusters(PROCESS)


def _both(case, pkgs, *args):
    return [outcome(lambda name=name: case(name, pkgs[name], *args))
            for name in PKGS]


def _make_wheel(tmp_path, name, version="1.0", payload="VALUE = 42\n"):
    """A wheel built by hand (a zip with its dist-info): no network, no
    build backend."""
    whl = tmp_path / f"{name}-{version}-py3-none-any.whl"
    dist = f"{name}-{version}.dist-info"
    with zipfile.ZipFile(whl, "w") as zf:
        zf.writestr(f"{name}/__init__.py", payload)
        zf.writestr(f"{dist}/METADATA",
                    f"Metadata-Version: 2.1\nName: {name}\n"
                    f"Version: {version}\n")
        zf.writestr(f"{dist}/WHEEL",
                    "Wheel-Version: 1.0\nGenerator: test\nRoot-Is-"
                    "Purelib: true\nTag: py3-none-any\n")
        zf.writestr(f"{dist}/RECORD", "")
    return str(whl)


# -- TestValidation -----------------------------------------------------------

def _raises(fn):
    try:
        fn()
    except Exception as e:  # noqa: BLE001 — the error is the outcome
        return type(e).__name__, normalize(str(e))
    return None


@pytest.mark.parametrize("spec", [
    {"env_vars": {"A": 1}},
    {"pip": [1]},
    {"conda": {"dependencies": ["x"]}},
    {"weird": True},
], ids=["env-vars-typed", "pip-strings", "conda", "unknown"])
def test_validation_rejects_as_the_reference(spec):
    got = [_raises(lambda n=n: _renv(n).validate(spec)) for n in PKGS]
    assert got[0] == got[1] and got[0][0] == "RuntimeEnvError"


def test_validation_normalizes_as_the_reference():
    for spec in ({"pip": ["b", "a"]}, {"pip": {"packages": ["x"]}},
                 {"env_vars": {"X": "1"}, "working_dir": "/w",
                  "py_modules": ["/m"]}):
        want, got = (_renv(n).validate(spec) for n in PKGS)
        assert got == want
    assert _renv(PORT).validate({"pip": ["b", "a"]})["pip"] == ["a", "b"]


def test_hash_stable_sensitive_and_the_reference_one():
    a = {"env_vars": {"X": "1", "Y": "2"}}
    b = {"env_vars": {"Y": "2", "X": "1"}}
    c = {"env_vars": {"X": "1", "Y": "3"}}
    port, ref = _renv(PORT), _renv("ray_tpu")
    assert port.env_hash(a) == port.env_hash(b) != port.env_hash(c)
    assert [port.env_hash(s) for s in (a, b, c, None)] == \
        [ref.env_hash(s) for s in (a, b, c, None)]


# -- TestThreadModeEnv --------------------------------------------------------

def case_env_vars_visible_in_task(name, pkg):
    @pkg.remote(runtime_env={"env_vars": {"WIDGET_MODE": "blue"}})
    def read():
        return os.environ.get("WIDGET_MODE")

    @pkg.remote
    def read_plain():
        return os.environ.get("WIDGET_MODE")

    return pkg.get(read.remote(), timeout=30), \
        pkg.get(read_plain.remote(), timeout=30)


def case_env_vars_on_actor(name, pkg):
    @pkg.remote(runtime_env={"env_vars": {"ACTOR_FLAVOR": "mint"}})
    class A:
        def __init__(self):
            self.flavor = os.environ.get("ACTOR_FLAVOR")

        def get(self):
            return self.flavor

    a = A.remote()
    out = pkg.get(a.get.remote(), timeout=30)
    pkg.kill(a)
    return out


def case_working_dir_importable(name, pkg, tmp_path):
    mod_dir = tmp_path / f"proj_{TAG[name]}"
    mod_dir.mkdir()
    mod = f"secret_module_{TAG[name]}"
    (mod_dir / f"{mod}.py").write_text("MAGIC = 12345\n")

    @pkg.remote(runtime_env={"working_dir": str(mod_dir)})
    def use():
        return importlib.import_module(mod).MAGIC

    return pkg.get(use.remote(), timeout=30)


def case_py_modules(name, pkg, tmp_path):
    lib = tmp_path / f"libs_{TAG[name]}"
    lib.mkdir()
    mod = f"extra_helpers_{TAG[name]}"
    (lib / f"{mod}.py").write_text("def f():\n    return 'qq'\n")

    @pkg.remote(runtime_env={"py_modules": [str(lib)]})
    def use():
        return importlib.import_module(mod).f()

    return pkg.get(use.remote(), timeout=30)


# -- TestProcessModeEnv -------------------------------------------------------

def case_env_vars_and_cwd_injected_at_spawn(name, pkg, tmp_path):
    wd = tmp_path / f"jobdir_{TAG[name]}"
    wd.mkdir()
    (wd / "data.txt").write_text("payload-77")

    @pkg.remote(runtime_env={"env_vars": {"SPAWNED_WITH": "env-injection"},
                             "working_dir": str(wd)})
    def probe():
        with open("data.txt") as f:      # relative: a real cwd change
            data = f.read()
        return os.environ.get("SPAWNED_WITH"), data, os.getpid()

    env_val, data, pid = pkg.get(probe.remote(), timeout=120)
    return env_val, data, pid != os.getpid()


def case_workers_keyed_by_env_hash(name, pkg):
    @pkg.remote(runtime_env={"env_vars": {"TAG": "one"}})
    def tag_one():
        return os.environ["TAG"], os.getpid()

    @pkg.remote(runtime_env={"env_vars": {"TAG": "two"}})
    def tag_two():
        return os.environ["TAG"], os.getpid()

    (t1, p1), (t2, p2) = pkg.get([tag_one.remote(), tag_two.remote()],
                                 timeout=120)
    t1b, p1b = pkg.get(tag_one.remote(), timeout=120)
    return (t1, t2, t1b), p1 != p2, p1b == p1, os.getpid() not in (p1, p2)


# -- TestPipRuntimeEnv --------------------------------------------------------

def case_task_imports_wheel_absent_from_host_env(name, pkg, tmp_path):
    dep = f"tinydep_{TAG[name]}"
    whl = _make_wheel(tmp_path, dep, payload="VALUE = 42\n")

    @pkg.remote(runtime_env={"pip": [whl]})
    def use_dep():
        return importlib.import_module(dep).VALUE

    try:
        importlib.import_module(dep)
        absent = False
    except ImportError:
        absent = True
    return absent, pkg.get(use_dep.remote(), timeout=120)


def case_venv_cached_per_hash(name, pkg, tmp_path):
    renv = _renv(name)
    kv = importlib.import_module(f"{name}._private.worker") \
        .global_worker().cluster.gcs.kv
    whl = _make_wheel(tmp_path, f"cachedep_{TAG[name]}",
                      payload="VALUE = 7\n")
    spec = renv.normalize({"pip": [whl]}, kv)
    dest = str(tmp_path / f"envroot_{TAG[name]}")
    site1 = renv.materialize_pip(list(spec["pip"]), kv, dest)
    mtime = os.path.getmtime(site1)
    site2 = renv.materialize_pip(list(spec["pip"]), kv, dest)
    return (site1 == site2, os.path.getmtime(site1) == mtime,
            os.path.isdir(os.path.join(site1, f"cachedep_{TAG[name]}")),
            os.path.relpath(site1, dest).split(os.sep)[0],
            spec["pip"][0].startswith("pkg://"), len(spec["_hash"]))


def case_process_mode_worker_gets_pip_env(name, pkg, tmp_path):
    dep = f"procdep_{TAG[name]}"
    whl = _make_wheel(tmp_path, dep, payload="VALUE = 'proc'\n")

    @pkg.remote(runtime_env={"pip": [whl]})
    def use_dep():
        return importlib.import_module(dep).VALUE, os.getpid()

    value, pid = pkg.get(use_dep.remote(), timeout=120)
    return value, pid != os.getpid()


class TestThreadModeEnv:
    """Env vars, working_dir and py_modules on thread workers."""

    def test_env_vars_visible_in_task(self, threads):
        want, got = _both(case_env_vars_visible_in_task, threads)
        assert got == want == ("value", ("blue", None))

    def test_env_vars_on_actor(self, threads):
        want, got = _both(case_env_vars_on_actor, threads)
        assert got == want == ("value", "mint")

    def test_working_dir_importable(self, threads, tmp_path):
        want, got = _both(case_working_dir_importable, threads, tmp_path)
        assert got == want == ("value", 12345)

    def test_py_modules(self, threads, tmp_path):
        want, got = _both(case_py_modules, threads, tmp_path)
        assert got == want == ("value", "qq")


class TestProcessModeEnv:
    """Env vars, cwd and pip at spawn; workers keyed by the env's hash."""

    def test_env_vars_and_cwd_injected_at_spawn(self, processes, tmp_path):
        want, got = _both(case_env_vars_and_cwd_injected_at_spawn, processes,
                          tmp_path)
        assert got == want == ("value",
                               ("env-injection", "payload-77", True))

    def test_workers_keyed_by_env_hash(self, processes):
        want, got = _both(case_workers_keyed_by_env_hash, processes)
        assert got == want == ("value", (("one", "two", "one"), True, True,
                                         True))

    def test_process_mode_worker_gets_pip_env(self, processes, tmp_path):
        want, got = _both(case_process_mode_worker_gets_pip_env, processes,
                          tmp_path)
        assert got == want == ("value", ("proc", True))


class TestPipRuntimeEnv:
    """pip from local wheels on thread workers; the cached target dir."""

    def test_task_imports_wheel_absent_from_host_env(self, threads,
                                                     tmp_path):
        want, got = _both(case_task_imports_wheel_absent_from_host_env,
                          threads, tmp_path)
        assert got == want == ("value", (True, 42))

    def test_venv_cached_per_hash(self, threads, tmp_path):
        want, got = _both(case_venv_cached_per_hash, threads, tmp_path)
        assert got == want == ("value", (True, True, True, "venvs", True, 16))

    def test_missing_wheel_fails_at_submission(self, threads, tmp_path):
        """A wheel path that does not exist raises where it is submitted,
        naming the file, in both packages."""
        def case(name, pkg):
            @pkg.remote(runtime_env={"pip": [str(tmp_path / "nope-1.0-py3-"
                                                            "none-any.whl")]})
            def f():
                return 1
            return f.remote()

        want, got = _both(case, threads)
        assert got[0] == want[0] == "raise"
        assert got[1] == want[1] == "RuntimeEnvError"
        assert "pip wheel not found" in got[2]

