"""Tk verifier GUI: key entry, file picker, profile, verdict label.

The verify runs on a worker thread, which posts the verdict back to the
UI thread through ``root.after``, so Tk never blocks.  The verifier
follows the port's device rule: ``RxGUI(device=None)`` verifies on the
CUDA card, and on a host without one the label reads ``error: no CUDA
device...``; it never verifies on the CPU unless ``device="cpu"``.
"""
from __future__ import annotations

import threading

import torch


class RxGUI:
    def __init__(self, root=None, *,
                 device: str | torch.device | None = None) -> None:
        import tkinter as tk
        from tkinter import filedialog, ttk

        self.tk = tk
        self.filedialog = filedialog
        self.device = device
        self.root = root or tk.Tk()
        self.root.title("EchoSeal verifier")

        frm = ttk.Frame(self.root, padding=12)
        frm.grid(sticky="nsew")
        ttk.Label(frm, text="Key (hex or file):").grid(row=0, column=0,
                                                       sticky="w")
        self.key_var = tk.StringVar()
        ttk.Entry(frm, textvariable=self.key_var, width=48,
                  show="*").grid(row=0, column=1)
        ttk.Button(frm, text="Choose audio...",
                   command=self._pick).grid(row=1, column=0, pady=6,
                                            sticky="w")
        self.file_var = tk.StringVar()
        ttk.Label(frm, textvariable=self.file_var).grid(row=1, column=1,
                                                        sticky="w")
        self.profile_var = tk.StringVar(value="compat")
        prof = ttk.Frame(frm)
        prof.grid(row=2, column=1, sticky="w")
        ttk.Radiobutton(prof, text="compat", value="compat",
                        variable=self.profile_var).grid(row=0, column=0)
        ttk.Radiobutton(prof, text="robust v2", value="v2",
                        variable=self.profile_var).grid(row=0, column=1)
        ttk.Label(frm, text="Profile:").grid(row=2, column=0, sticky="w")
        self.btn = ttk.Button(frm, text="Verify", command=self._verify)
        self.btn.grid(row=3, column=0, pady=6, sticky="w")
        self.verdict = ttk.Label(frm, text="", font=("TkDefaultFont", 14))
        self.verdict.grid(row=3, column=1, sticky="w")

    def _pick(self) -> None:
        path = self.filedialog.askopenfilename(
            filetypes=[("audio", "*.wav *.flac"), ("all", "*.*")])
        if path:
            self.file_var.set(path)

    def _verify(self) -> None:
        from echoseal_torch.gui.tx_gui import load_key

        try:
            key = load_key(self.key_var.get())
        except Exception as e:
            self.verdict.config(text=f"key error: {e}")
            return
        path = self.file_var.get()
        if not path:
            self.verdict.config(text="choose a file first")
            return
        self.btn.config(state="disabled")
        self.verdict.config(text="verifying...")

        profile = self.profile_var.get()

        def work() -> None:
            try:
                from echoseal_torch.io import wavio

                data, fs = wavio.read(path)
                if profile == "v2":
                    from echoseal_torch.models.robust import RobustVerifier

                    verifier = RobustVerifier(key, device=self.device)
                else:
                    from echoseal_torch.models.detector import (
                        WatermarkDetector,
                    )

                    verifier = WatermarkDetector(key, device=self.device)
                ok = verifier.verify(data, fs)
                text = "AUTHENTIC" if ok else "tampered / no watermark"
            except Exception as e:      # the worker must always report
                text = f"error: {e}"
            self.root.after(0, lambda: self._done(text))

        threading.Thread(target=work, daemon=True).start()

    def _done(self, text: str) -> None:
        self.verdict.config(text=text)
        self.btn.config(state="normal")

    def run(self) -> None:
        self.root.mainloop()


def main() -> None:
    RxGUI().run()


if __name__ == "__main__":
    main()
