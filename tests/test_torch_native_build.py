"""The port's native host library (`burst_tpu_torch/native`) builds
safely where several processes start at once, as the ranks of a
multi-host world do on a fresh tree: each compiles to a name of its own
and renames the result onto the library, so no process loads a file
that another is still writing."""
import importlib.util
import os
import shutil
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NATIVE = os.path.join(REPO, "burst_tpu_torch", "native")
SOURCES = ("__init__.py", "burst_host.cpp", "fastdiv.c")


def _copy_native(dst) -> str:
    """A copy of the native package's sources without any built
    library: every library is stale there."""
    pkg = os.path.join(str(dst), "nativecopy")
    os.makedirs(pkg)
    for name in SOURCES:
        shutil.copy(os.path.join(NATIVE, name), pkg)
    return pkg


def _built(pkg: str) -> list:
    """The files in `pkg` besides its sources and bytecode cache."""
    return sorted(set(os.listdir(pkg)) - set(SOURCES) - {"__pycache__"})


def _import_copy(pkg: str):
    spec = importlib.util.spec_from_file_location(
        "nativecopy", os.path.join(pkg, "__init__.py"),
        submodule_search_locations=[pkg])
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("loader,lib", [("load_host", "burst_host.so"),
                                        ("_load", "fastdiv.so")])
def test_compiler_writes_only_a_temporary_name(tmp_path, monkeypatch,
                                               loader, lib):
    """The compiler's output is a name of this process's own; the
    library's path is only ever written by the rename."""
    pkg = _copy_native(tmp_path)
    mod = _import_copy(pkg)
    so = os.path.join(pkg, lib)
    outputs, renames = [], []
    run, replace = subprocess.run, os.replace

    def spy_run(cmd, *a, **kw):
        outputs.append(cmd[cmd.index("-o") + 1])
        assert not os.path.exists(so)
        return run(cmd, *a, **kw)

    def spy_replace(src, dst):
        renames.append((src, dst))
        return replace(src, dst)
    monkeypatch.setattr(mod.subprocess, "run", spy_run)
    monkeypatch.setattr(mod.os, "replace", spy_replace)
    assert getattr(mod, loader)() is not None
    tmp = f"{so}.{os.getpid()}.tmp"
    assert outputs == [tmp]
    assert renames == [(tmp, so)]
    assert _built(pkg) == [lib]


def test_processes_started_at_once_all_load(tmp_path):
    """Three processes load both libraries at once from a copy whose
    libraries are stale: every one of them loads them, and no temporary
    file is left behind."""
    pkg = _copy_native(tmp_path)
    code = ("import importlib.util, os, sys\n"
            "spec = importlib.util.spec_from_file_location('nativecopy', "
            "os.path.join(sys.argv[1], '__init__.py'), "
            "submodule_search_locations=[sys.argv[1]])\n"
            "mod = importlib.util.module_from_spec(spec)\n"
            "spec.loader.exec_module(mod)\n"
            "assert mod.load_host() is not None, 'burst_host.so'\n"
            "assert mod._load() is not None, 'fastdiv.so'\n"
            "print('OK')\n")
    procs = [subprocess.Popen([sys.executable, "-c", code, pkg],
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True) for _ in range(3)]
    for p in procs:
        out, err = p.communicate(timeout=120)
        assert p.returncode == 0 and out.strip() == "OK", err[-2000:]
    assert _built(pkg) == ["burst_host.so", "fastdiv.so"]
