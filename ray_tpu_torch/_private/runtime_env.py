"""Per-task and per-actor runtime environments.

A port of ``ray_tpu._private.runtime_env`` for the PyTorch port
(reference ``python/ray/_private/runtime_env/``): validation
(``validation.py``), working-dir and py-modules packaging into the GCS
KV (``packaging.py``: a zip under a content-hash URI), and
materialization on the executing node (``working_dir.py``,
``py_modules.py``, ``pip.py``; driven by the raylet's AgentManager
``GetOrCreateRuntimeEnv``, ``src/ray/raylet/agent_manager.h:49``).  The
worker pool keys process workers by the env's stable hash
(``src/ray/raylet/worker_pool.h:428``).

Fields: ``env_vars`` (a dict), ``working_dir`` (a local directory,
packaged and materialized), ``py_modules`` (local directories, packaged
and put on the import path), ``pip`` (requirements; local wheel files
are shipped through the KV and installed into a cached per-hash target
directory on the executing node with ``--no-index``: name-only
requirements need a network).  ``conda`` is rejected.

Isolation depends on the worker mode: a process worker gets the env
vars, the cwd and the import path at spawn (full isolation); a thread
worker has the env vars and import paths applied around the task body
under a lock (an approximation: use process workers for isolation).
``framework_import_root`` names the checkout that holds
``ray_tpu_torch/``, which a worker's ``PYTHONPATH`` starts with.
"""

from __future__ import annotations

import contextlib
import hashlib
import io
import json
import os
import threading
import zipfile
from typing import Dict, List, Optional


_PKG_PREFIX = b"pkg:"
#: The environment variable through which a spawned worker learns its
#: env's working directory.
WORKER_CWD_ENV = "RAY_TPU_TORCH_WORKER_CWD"
_EXCLUDE_DIRS = {"__pycache__", ".git", ".venv", "node_modules"}


class RuntimeEnvError(ValueError):
    pass


def validate(spec: dict) -> dict:
    """Normalize field types; reject the unsupported."""
    out = {}
    for key, value in (spec or {}).items():
        if key == "env_vars":
            if not isinstance(value, dict) or not all(
                    isinstance(k, str) and isinstance(v, str)
                    for k, v in value.items()):
                raise RuntimeEnvError("env_vars must be Dict[str, str]")
            out["env_vars"] = dict(value)
        elif key in ("working_dir", "py_modules"):
            out[key] = value
        elif key == "pip":
            if isinstance(value, dict):
                value = value.get("packages", [])
            if not isinstance(value, (list, tuple)) or not all(
                    isinstance(r, str) for r in value):
                raise RuntimeEnvError(
                    "pip must be a list of requirement strings")
            out["pip"] = sorted(value)
        elif key == "conda":
            raise RuntimeEnvError(
                "runtime_env['conda'] is not supported: no network "
                "egress; use pip with local wheels, or bake "
                "dependencies into the image")
        else:
            raise RuntimeEnvError(f"Unknown runtime_env field {key!r}")
    return out


# ---------------------------------------------------------------------------
# Packaging (packaging.py parity: zip -> content-hash URI in the GCS KV)
# ---------------------------------------------------------------------------

def _zip_dir(path: str) -> bytes:
    buf = io.BytesIO()
    with zipfile.ZipFile(buf, "w", zipfile.ZIP_DEFLATED) as zf:
        for root, dirs, files in os.walk(path):
            dirs[:] = [d for d in dirs if d not in _EXCLUDE_DIRS]
            for fname in sorted(files):
                full = os.path.join(root, fname)
                zf.write(full, os.path.relpath(full, path))
    return buf.getvalue()


def _dir_signature(path: str) -> str:
    """Cheap content fingerprint (relpath, size, mtime of every file) —
    walking metadata costs microseconds where re-zipping costs the full
    compression; lets hot submission loops skip repackaging."""
    entries = []
    for root, dirs, files in os.walk(path):
        dirs[:] = [d for d in dirs if d not in _EXCLUDE_DIRS]
        for fname in sorted(files):
            full = os.path.join(root, fname)
            try:
                st = os.stat(full)
            except OSError:
                continue
            entries.append((os.path.relpath(full, path),
                            st.st_size, st.st_mtime_ns))
    return hashlib.sha256(repr(entries).encode()).hexdigest()


_package_cache: Dict[tuple, str] = {}
_package_cache_lock = threading.Lock()


def package_dir(path: str, kv) -> str:
    """Zip a local directory into the GCS KV; returns its content URI.
    Repeat submissions of an unchanged directory hit a signature cache
    instead of re-zipping (reference packaging.py caches per-URI)."""
    if not os.path.isdir(path):
        raise RuntimeEnvError(f"not a directory: {path!r}")
    key = (os.path.abspath(path), _dir_signature(path), id(kv))
    with _package_cache_lock:
        cached = _package_cache.get(key)
    if cached is not None:
        return cached
    blob = _zip_dir(path)
    digest = hashlib.sha256(blob).hexdigest()[:20]
    uri = f"pkg://{digest}"
    kv.put(_PKG_PREFIX + digest.encode(), blob, overwrite=False)
    with _package_cache_lock:
        _package_cache[key] = uri
    return uri


def framework_import_root() -> str:
    """The directory that holds the ``ray_tpu_torch`` package: prepended
    to a worker process's ``PYTHONPATH``, so that it imports the same
    checkout (and loads the same built kernels) from any cwd."""
    import ray_tpu_torch
    return os.path.dirname(os.path.dirname(
        os.path.abspath(ray_tpu_torch.__file__)))


def package_file(path: str, kv) -> str:
    """Store a single local file (e.g. a wheel) in the GCS KV; returns
    ``pkg://<digest>/<basename>`` so the materializing node can restore
    it under its original filename (pip needs the wheel name intact)."""
    with open(path, "rb") as f:
        blob = f.read()
    digest = hashlib.sha256(blob).hexdigest()[:20]
    kv.put(_PKG_PREFIX + digest.encode(), blob, overwrite=False)
    return f"pkg://{digest}/{os.path.basename(path)}"


def normalize(spec: Optional[dict], kv) -> Optional[dict]:
    """Validate + package local paths into URIs + stamp the stable hash
    the worker pool keys on.  Call once at submission time."""
    if not spec:
        return None
    out = validate(spec)
    wd = out.get("working_dir")
    if wd and not str(wd).startswith("pkg://"):
        out["working_dir"] = package_dir(wd, kv)
    mods = out.get("py_modules")
    if mods:
        out["py_modules"] = [
            m if str(m).startswith("pkg://") else package_dir(m, kv)
            for m in mods]
    if out.get("pip"):
        # Requirements that are local wheel files exist only on the
        # SUBMITTING machine — ship them through the KV so the
        # executing node can install offline (reference pip.py ships a
        # requirements file; local wheels are this image's only
        # network-free install source).
        packed = []
        for r in out["pip"]:
            if r.endswith(".whl") and not r.startswith("pkg://"):
                if not os.path.isfile(r):
                    # Fail at SUBMISSION, naming the file — deferring
                    # ships the bad path and errors in a remote worker.
                    raise RuntimeEnvError(
                        f"pip wheel not found: {r!r}")
                packed.append(package_file(r, kv))
            else:
                packed.append(r)
        out["pip"] = sorted(packed)
    out["_hash"] = env_hash(out)
    return out


def env_hash(spec: Optional[dict]) -> str:
    if not spec:
        return ""
    canon = {k: v for k, v in spec.items() if k != "_hash"}
    return hashlib.sha256(
        json.dumps(canon, sort_keys=True).encode()).hexdigest()[:16]


# ---------------------------------------------------------------------------
# Materialization (working_dir.py / py_modules.py parity)
# ---------------------------------------------------------------------------

class RuntimeEnvContext:
    """A materialized environment: what a worker needs at exec time."""

    def __init__(self, env_vars: Dict[str, str], cwd: Optional[str],
                 import_paths: List[str]):
        self.env_vars = env_vars
        self.cwd = cwd
        self.import_paths = import_paths

    def spawn_env(self, base: Optional[dict] = None) -> Dict[str, str]:
        """Env dict for a process-mode worker spawn."""
        env = dict(base if base is not None else os.environ)
        env.update(self.env_vars)
        if self.import_paths:
            extra = os.pathsep.join(self.import_paths)
            env["PYTHONPATH"] = extra + os.pathsep + env.get("PYTHONPATH", "")
        if self.cwd:
            env[WORKER_CWD_ENV] = self.cwd
        return env


def _extract_uri(uri: str, kv, dest_root: str) -> str:
    import fcntl

    digest = uri[len("pkg://"):]
    dest = os.path.join(dest_root, digest)
    marker = os.path.join(dest, ".materialized")
    if os.path.exists(marker):
        return dest
    # Cross-process/thread exclusion: concurrent materializations of the
    # same package must not extract over files a finished caller is
    # already importing from.
    os.makedirs(dest_root, exist_ok=True)
    with open(os.path.join(dest_root, f".{digest}.lock"), "w") as lock_f:
        fcntl.flock(lock_f, fcntl.LOCK_EX)
        try:
            if os.path.exists(marker):
                return dest
            blob = kv.get(_PKG_PREFIX + digest.encode())
            if blob is None:
                raise RuntimeEnvError(f"package {uri} not found in GCS KV")
            os.makedirs(dest, exist_ok=True)
            with zipfile.ZipFile(io.BytesIO(blob)) as zf:
                zf.extractall(dest)
            open(marker, "w").close()
            return dest
        finally:
            fcntl.flock(lock_f, fcntl.LOCK_UN)


def _restore_wheel(uri: str, kv, dest_root: str) -> str:
    """pkg://digest/name.whl -> local wheel path under dest_root."""
    rest = uri[len("pkg://"):]
    digest, _, name = rest.partition("/")
    # Digest as a subdirectory: pip requires the wheel FILENAME intact.
    wheel_dir = os.path.join(dest_root, "wheels", digest)
    os.makedirs(wheel_dir, exist_ok=True)
    dest = os.path.join(wheel_dir, name)
    if not os.path.exists(dest):
        import uuid
        blob = kv.get(_PKG_PREFIX + digest.encode())
        if blob is None:
            raise RuntimeEnvError(f"wheel {uri} not found in GCS KV")
        # Unique tmp name: two pip specs sharing a wheel can restore
        # it concurrently (their flocks are keyed by DIFFERENT
        # req-hashes); os.replace makes the landing atomic either way.
        tmp = f"{dest}.{os.getpid()}.{uuid.uuid4().hex[:8]}.tmp"
        with open(tmp, "wb") as f:
            f.write(blob)
        os.replace(tmp, dest)
    return dest


def materialize_pip(requirements: List[str], kv,
                    dest_root: str) -> str:
    """Cached env dir per requirements-hash (reference pip.py: one
    virtual env per runtime_env, reused across tasks): pip-install the
    requirements into a private site dir (``--no-index`` when every
    requirement is a shipped wheel — this image has no egress) and
    return it for PYTHONPATH injection.

    Idempotent + cross-process locked like package extraction."""
    import fcntl
    import subprocess
    import sys

    req_hash = hashlib.sha256(
        json.dumps(sorted(requirements)).encode()).hexdigest()[:16]
    venv_root = os.path.join(dest_root, "venvs")
    venv_dir = os.path.join(venv_root, req_hash)
    marker = os.path.join(venv_dir, ".materialized")
    site = os.path.join(
        venv_dir, "lib",
        f"python{sys.version_info.major}.{sys.version_info.minor}",
        "site-packages")
    if os.path.exists(marker):
        return site
    os.makedirs(venv_root, exist_ok=True)
    with open(os.path.join(venv_root, f".{req_hash}.lock"), "w") as lf:
        fcntl.flock(lf, fcntl.LOCK_EX)
        try:
            if os.path.exists(marker):
                return site
            local = [
                _restore_wheel(r, kv, dest_root)
                if r.startswith("pkg://") else r for r in requirements]
            all_wheels = all(r.endswith(".whl") for r in local)
            os.makedirs(site, exist_ok=True)
            # Install with THIS interpreter's pip targeted at the env's
            # own site dir (cheaper than a full `python -m venv` +
            # ensurepip bootstrap, identical import-path result).
            cmd = [sys.executable, "-m", "pip", "install", "--quiet",
                   "--target", site]
            if all_wheels:
                cmd += ["--no-index", "--no-deps"]
            cmd += local
            proc = subprocess.run(cmd, capture_output=True, text=True)
            if proc.returncode != 0:
                raise RuntimeEnvError(
                    f"pip install failed for runtime_env: "
                    f"{proc.stderr[-1500:]}")
            open(marker, "w").close()
            return site
        finally:
            fcntl.flock(lf, fcntl.LOCK_UN)


def materialize(spec: Optional[dict], kv,
                dest_root: Optional[str] = None) -> RuntimeEnvContext:
    """Download + extract the env's packages on this node; idempotent
    per content hash (uri_cache.py parity)."""
    if not spec:
        return RuntimeEnvContext({}, None, [])
    from ray_tpu_torch._private.config import get_config
    dest_root = dest_root or os.path.join(get_config().temp_dir,
                                          "runtime_env")
    cwd = None
    import_paths: List[str] = []
    wd = spec.get("working_dir")
    if wd:
        cwd = _extract_uri(wd, kv, dest_root)
        import_paths.append(cwd)
    for uri in spec.get("py_modules") or []:
        import_paths.append(_extract_uri(uri, kv, dest_root))
    if spec.get("pip"):
        import_paths.append(
            materialize_pip(list(spec["pip"]), kv, dest_root))
    return RuntimeEnvContext(dict(spec.get("env_vars") or {}), cwd,
                             import_paths)


# ---------------------------------------------------------------------------
# Thread-mode application (approximation; process mode is the real path)
# ---------------------------------------------------------------------------

_env_lock = threading.Lock()


@contextlib.contextmanager
def applied(ctx: RuntimeEnvContext):
    """Apply env vars (global, locked) and import paths around a task
    body in a thread-mode worker."""
    import sys
    if not ctx.env_vars and not ctx.import_paths:
        yield
        return
    with _env_lock:
        saved = {k: os.environ.get(k) for k in ctx.env_vars}
        os.environ.update(ctx.env_vars)
        added = [p for p in ctx.import_paths if p not in sys.path]
        sys.path[:0] = added
        try:
            yield
        finally:
            for p in added:
                try:
                    sys.path.remove(p)
                except ValueError:
                    pass
            for k, v in saved.items():
                if v is None:
                    os.environ.pop(k, None)
                else:
                    os.environ[k] = v
