"""Shared by the tests/test_torch_*.py modules: the torch thread limit, the
seeded test streams and the stubbed tkinter for the GUIs, which
chip_smoke.py also drives the card's GUI verify with."""
import contextlib
import sys
import threading
from unittest import mock

import numpy as np
import pytest
import torch

try:                                    # limits numpy's and scipy's BLAS too
    from threadpoolctl import threadpool_limits
except ImportError:                     # optional: torch alone is limited
    threadpool_limits = None

from echoseal_torch.models.embedder import WatermarkEmbedder
from echoseal_torch.models.robust import RobustEmbedder

FS = 48_000


# modules of both packages whose float64 designs go through BLAS and are
# cached per process
_DESIGN_MODULES = ("ops.demod", "ops.filters", "ops.resample", "models.robust")


def _clear_design_caches():
    for pkg in ("echoseal_torch", "echoseal_tpu"):
        for name in _DESIGN_MODULES:
            mod = sys.modules.get(f"{pkg}.{name}")
            for obj in vars(mod).values() if mod else ():
                if callable(getattr(obj, "cache_clear", None)):
                    obj.cache_clear()


@pytest.fixture(scope="module", autouse=True)
def two_torch_threads():
    """Run the importing module's torch ops and BLAS calls on two threads.

    The test workers share one machine, and idle OpenMP and OpenBLAS
    threads spin: with every worker on all cores the port's test modules
    spent about twice the CPU time for the same work.  Import it into a
    module to apply it there.

    A float64 design's last bits move with the BLAS thread count, and both
    packages cache their designs per process.  The caches are emptied on
    the way in, so that the two packages' tables, which the tests hold
    bit-equal, are designed under the same limit whatever module the worker
    ran before, and on the way out, so that later modules design theirs as
    they always did.
    """
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    _clear_design_caches()
    with (threadpool_limits(limits=2) if threadpool_limits
          else contextlib.nullcontext()):
        yield
    _clear_design_caches()
    torch.set_num_threads(n)


def compat_stream(key, seconds, seed, block=1024):
    """A silence-host stream through the port's seeded streaming TX."""
    tx = WatermarkEmbedder(key, rng=np.random.default_rng(seed))
    host = np.zeros(int(seconds * FS), np.float32)
    return np.concatenate([tx.process(host[i:i + block])
                           for i in range(0, host.size, block)])


def v2_stream(key, seconds, seed, nonce=None, level=0.1):
    """A 700 Hz host through the port's seeded v2 TX."""
    tx = RobustEmbedder(key, rng=np.random.default_rng(seed))
    host = (level * np.sin(2 * np.pi * 700 * np.arange(seconds * FS) / FS)
            ).astype(np.float32)
    return tx.embed(host, session_nonce=nonce)


def fake_tkinter() -> dict:
    """MagicMock ``tkinter``, ``tkinter.ttk`` and ``tkinter.filedialog``
    modules for the GUIs' deferred imports, by ``sys.modules`` name (no
    display needed); ``StringVar`` is a real get/set cell."""

    class _StringVar:
        def __init__(self, value: str = "") -> None:
            self._v = value

        def set(self, v: str) -> None:
            self._v = v

        def get(self) -> str:
            return self._v

    tk = mock.MagicMock(name="tkinter")
    tk.StringVar = _StringVar
    tk.ttk = mock.MagicMock(name="tkinter.ttk")
    tk.filedialog = mock.MagicMock(name="tkinter.filedialog")
    return {"tkinter": tk, "tkinter.ttk": tk.ttk,
            "tkinter.filedialog": tk.filedialog}


def run_gui_verify(gui, root, timeout: float = 300.0) -> str:
    """Start an ``RxGUI`` verify on ``root`` (a MagicMock), wait for the
    UI-thread continuation its worker thread posts through ``root.after``,
    run it and return the verdict label."""
    done = threading.Event()
    posted = []

    def after(_ms, cb=None):
        if cb is not None:
            posted.append(cb)
            done.set()

    root.after.side_effect = after
    gui._verify()
    if not done.wait(timeout=timeout):
        raise AssertionError("the GUI's worker thread posted no verdict")
    posted[-1]()
    return gui.verdict.config.call_args.kwargs["text"]
