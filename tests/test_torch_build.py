"""Thread safety of the port's kernel builds and launch counters.

A serving engine's drain thread and a server's warmup request may be the
first to reach a kernel, and ``chip_smoke.py`` reads the wrappers'
launch counters while the drain thread launches. With a stub compiler
(a script that writes its ``-o`` target) and a stub loader, many threads
calling ``_build.entry`` at once must build each library once, leave no
temporary file, and all get the same bound function; many threads
counting launches must lose none.
"""
from __future__ import annotations

import sys
import threading
import types

import pytest

from repro_torch.kernels import _build

WAIT_S = 60


@pytest.fixture
def stub_toolchain(tmp_path, monkeypatch):
    """A fake ``nvcc`` that logs each compile and writes its output after
    a pause (so that racing threads overlap), and a fake ``CDLL``."""
    log = tmp_path / "compiles.log"
    nvcc = tmp_path / "nvcc"
    nvcc.write_text(
        f"#!{sys.executable}\n"
        "import sys, time\n"
        "args = sys.argv[1:]\n"
        f"open({str(log)!r}, 'a').write(args[-1] + '\\n')\n"
        "time.sleep(0.2)\n"
        "open(args[args.index('-o') + 1], 'w').write('lib')\n")
    nvcc.chmod(0o755)

    class FakeLib:
        def __init__(self, path):
            self.path = path

        def __getattr__(self, name):
            return types.SimpleNamespace(lib=self.path, name=name)

    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(_build, "nvcc", lambda: str(nvcc))
    monkeypatch.setattr(_build, "_loaded", {})
    monkeypatch.setattr(_build, "_entries", {})
    monkeypatch.setattr(_build.ctypes, "CDLL", FakeLib)
    return log


def test_entry_builds_each_library_once_across_threads(stub_toolchain):
    names = ["flash_attention_fwd", "decode_attention_fwd",
             "paged_decode_attention_fwd", "rglru_scan_fwd"] * 4
    got, errs = {}, []
    barrier = threading.Barrier(len(names))

    def call(i, name):
        try:
            barrier.wait(timeout=WAIT_S)
            got[i] = (name, _build.entry(name))
        except Exception as e:          # noqa: BLE001 — surfaced below
            errs.append(e)

    threads = [threading.Thread(target=call, args=(i, n))
               for i, n in enumerate(names)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=WAIT_S)
    assert not any(t.is_alive() for t in threads), "entry() hung"
    assert not errs
    compiles = stub_toolchain.read_text().split()
    assert sorted(compiles) == sorted(
        str(_build.CSRC / f"{s}.cu")
        for s in ("flash_attention", "decode_attention", "rglru_scan"))
    for name in set(names):
        fns = {id(fn) for n, fn in got.values() if n == name}
        assert len(fns) == 1, name
        fn = _build._entries[name]
        assert fn.argtypes == _build.SIGNATURES[name][1]
        assert fn.lib == str(_build.lib_path(_build.SIGNATURES[name][0]))
    assert not list((_build.BUILD_DIR).glob("*.tmp"))


def test_launch_counters_exact_across_threads():
    """32 threads x 500 launches with a tiny switch interval: the count
    is exact, and ``reset_launches`` sets it back to 0."""
    def wrapper():
        pass
    wrapper.launches = 0
    n_threads, per = 32, 500
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(
            target=lambda: [_build.count_launch(wrapper) for _ in range(per)])
            for _ in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=WAIT_S)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads)
    assert wrapper.launches == n_threads * per
    _build.reset_launches(wrapper)
    assert wrapper.launches == 0


def test_launch_counter_of_one_kind():
    """``count_launch(w, "lse_launches")`` adds one to both counters, a
    plain call to ``launches`` alone; ``reset_launches`` zeroes both."""
    def wrapper():
        pass
    wrapper.launches = wrapper.lse_launches = 0
    for also in ("", "lse_launches", "", "lse_launches", "lse_launches"):
        _build.count_launch(wrapper, also)
    assert (wrapper.launches, wrapper.lse_launches) == (5, 3)
    _build.reset_launches(wrapper)
    assert (wrapper.launches, wrapper.lse_launches) == (0, 0)
