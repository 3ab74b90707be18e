"""The kernel library and the native library load once, whatever threads
ask at once, and no kernel launch count is lost across threads (the async
mapping worker launches beside the tracker)."""

import threading
import time
import types

from orbslam2_tpu_torch import kernels
from orbslam2_tpu_torch.utils import native
from torch_threads import one_torch_thread  # noqa: F401  (autouse)


class _FakeLib(types.SimpleNamespace):
    def __getattr__(self, name):
        fn = types.SimpleNamespace()
        setattr(self, name, fn)
        return fn


def _race(target, n=2):
    barrier = threading.Barrier(n)
    out = []

    def run():
        barrier.wait()
        out.append(target())

    threads = [threading.Thread(target=run) for _ in range(n)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    return out


def test_kernels_load_builds_once(monkeypatch, tmp_path):
    builds = []

    def build():
        builds.append(threading.current_thread().name)
        time.sleep(0.2)  # a slow compile: the other thread arrives meanwhile
        return tmp_path / "lib.so"

    monkeypatch.setattr(kernels, "_lib", None)
    monkeypatch.setattr(kernels, "build", build)
    monkeypatch.setattr(kernels.ctypes, "CDLL", lambda path: _FakeLib())
    libs = _race(kernels.load, n=4)
    assert len(builds) == 1
    assert all(lib is libs[0] for lib in libs)


def test_native_load_builds_once(monkeypatch, tmp_path):
    builds = []

    def build():
        builds.append(1)
        time.sleep(0.2)
        (tmp_path / "lib.so").write_bytes(b"")
        return True

    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "LIB_PATH", tmp_path / "lib.so")
    monkeypatch.setattr(native, "_build", build)
    monkeypatch.setattr(native.ctypes, "CDLL", lambda path: _FakeLib())
    libs = _race(native._load, n=4)
    assert len(builds) == 1
    assert libs[0] is not None and all(lib is libs[0] for lib in libs)


def test_launch_counts_lose_nothing_across_threads():
    kernels.reset_launch_counts()
    per_thread = 20000

    def count():
        for _ in range(per_thread):
            kernels._count("hamming_matrix")

    _race(count, n=4)
    assert kernels.LAUNCHES["hamming_matrix"] == 4 * per_thread
    by_thread = kernels.thread_launch_counts()
    assert len(by_thread) == 4
    assert all(c["hamming_matrix"] == per_thread for c in by_thread.values())
    kernels.reset_launch_counts()
    assert set(kernels.LAUNCHES.values()) == {0} and kernels.thread_launch_counts() == {}
