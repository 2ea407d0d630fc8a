"""Tk transmitter GUI: key entry, device index, start/stop, VU meter.

Key entry, sound-device selection and a 10 Hz RMS meter fed through a
bounded queue from the audio callback thread: the callback never blocks
on a slow UI.  The mixer is host code (numpy); no GPU is involved.
"""
from __future__ import annotations

import queue

import numpy as np


def load_key(text: str) -> bytes:
    """The CLI's key loader, raising ``ValueError`` instead of exiting."""
    from echoseal_torch.cli.tx_app import load_key as _lk

    try:
        key = _lk(text)
    except SystemExit as e:
        # the CLI loader exits the process on a bad key: right for a
        # command line, fatal for a window; a typo in the key field must
        # reach the status label instead
        raise ValueError(str(e)) from e
    if len(key) != 32:
        raise ValueError("key must be 32 bytes (64 hex chars)")
    return key


class TxGUI:
    POLL_MS = 100

    def __init__(self, root=None) -> None:
        import tkinter as tk
        from tkinter import ttk

        self.tk = tk
        self.root = root or tk.Tk()
        self.root.title("EchoSeal transmitter")
        self._loop = None
        self._vu: queue.Queue[float] = queue.Queue(maxsize=8)

        frm = ttk.Frame(self.root, padding=12)
        frm.grid(sticky="nsew")
        ttk.Label(frm, text="Key (hex or file):").grid(row=0, column=0,
                                                       sticky="w")
        self.key_var = tk.StringVar()
        ttk.Entry(frm, textvariable=self.key_var, width=48,
                  show="*").grid(row=0, column=1)
        ttk.Label(frm, text="Device index:").grid(row=1, column=0, sticky="w")
        self.dev_var = tk.StringVar()
        ttk.Entry(frm, textvariable=self.dev_var, width=8).grid(
            row=1, column=1, sticky="w")
        self.btn = ttk.Button(frm, text="Start", command=self.toggle)
        self.btn.grid(row=2, column=0, pady=8, sticky="w")
        self.meter = ttk.Progressbar(frm, length=280, maximum=60.0)
        self.meter.grid(row=2, column=1, sticky="w")
        self.status = ttk.Label(frm, text="idle")
        self.status.grid(row=3, column=0, columnspan=2, sticky="w")
        self.root.after(self.POLL_MS, self._poll)

    # ------------------------------------------------------------------ UI
    def toggle(self) -> None:
        if self._loop is None:
            self._start()
        else:
            self._stop()

    def _start(self) -> None:
        from echoseal_torch.io.audioloop import AudioLoop
        from echoseal_torch.models.embedder import WatermarkEmbedder

        try:
            key = load_key(self.key_var.get())
        except Exception as e:
            self.status.config(text=f"key error: {e}")
            return
        embedder = WatermarkEmbedder(key)

        def process(block: np.ndarray) -> np.ndarray:
            out = embedder.process(block)
            rms = float(np.sqrt(np.mean(out * out)) + 1e-12)
            try:
                self._vu.put_nowait(20.0 * np.log10(rms + 1e-12))
            except queue.Full:
                pass
            return out

        device = int(self.dev_var.get()) if self.dev_var.get() else None
        try:
            self._loop = AudioLoop(process, device=device)
            self._loop.start()
        except Exception as e:
            self._loop = None
            self.status.config(text=f"audio error: {e}")
            return
        self.btn.config(text="Stop")
        self.status.config(text="transmitting")

    def _stop(self) -> None:
        if self._loop is not None:
            self._loop.stop()
            self._loop = None
        self.btn.config(text="Start")
        self.status.config(text="idle")

    def _poll(self) -> None:
        try:
            while True:
                db = self._vu.get_nowait()
                self.meter["value"] = max(0.0, db + 60.0)
        except queue.Empty:
            pass
        self.root.after(self.POLL_MS, self._poll)

    def run(self) -> None:
        self.root.mainloop()


def main() -> None:
    TxGUI().run()


if __name__ == "__main__":
    main()
