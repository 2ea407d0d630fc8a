"""Full-duplex real-time audio loop.

``sounddevice`` (PortAudio) is an optional dependency -- the serving image
has no audio stack -- so the import is deferred to ``start()`` and a
``NullAudioLoop`` offline stand-in is provided for tests and file-to-file
processing.
"""
from __future__ import annotations

from typing import Callable

import numpy as np

from echoseal_torch.io import wavio


class AudioLoop:
    """Mic -> process_fn -> speaker, 1 channel float32.

    Optionally captures the first 10 s of processed output to a WAV file.
    """

    def __init__(
        self,
        process_fn: Callable[[np.ndarray], np.ndarray],
        *,
        fs: int = 48_000,
        device: int | str | None = None,
        block: int = 1_024,
        save_path: str | None = None,
    ) -> None:
        self.process = process_fn
        self.fs = fs
        self.device = device
        self.block = block
        self.save_path = save_path
        self._stream = None
        self._out_buf: list[np.ndarray] = []
        self._samples_to_save = fs * 10 if save_path else 0

    def start(self) -> None:
        if self._stream is not None:
            return
        try:
            import sounddevice as sd
        except ImportError as e:  # pragma: no cover - env without PortAudio
            raise RuntimeError(
                "sounddevice (PortAudio) is not installed; live audio I/O "
                "is unavailable -- use NullAudioLoop or the batch API"
            ) from e
        self._stream = sd.Stream(
            samplerate=self.fs,
            channels=1,
            blocksize=self.block,
            dtype="float32",
            device=self.device,
            callback=self._callback,
        )
        self._stream.start()

    def stop(self) -> None:
        if self._stream is not None:
            self._stream.close()
            self._stream = None
        self._maybe_save()

    # ------------------------------------------------------------ internals
    def _callback(self, indata, outdata, frames, _time, status) -> None:
        if status:
            print("audio status:", status, flush=True)
        out = self.process(indata[:, 0])
        if self._samples_to_save > 0:
            self._out_buf.append(np.copy(out))
            self._samples_to_save -= out.size
        outdata[:] = out.reshape(-1, 1)

    def _maybe_save(self) -> None:
        if self.save_path and self._out_buf:
            audio = np.concatenate(self._out_buf)[: self.fs * 10]
            wavio.write(self.save_path, audio, self.fs)
            print(f"saved 10s sample to {self.save_path}", flush=True)


class NullAudioLoop:
    """Offline stand-in: pushes a buffer through process_fn in blocks."""

    def __init__(self, process_fn, *, fs: int = 48_000, block: int = 1_024,
                 save_path: str | None = None) -> None:
        self.process = process_fn
        self.fs = fs
        self.block = block
        self.save_path = save_path

    def run(self, host: np.ndarray) -> np.ndarray:
        out = [
            self.process(host[i : i + self.block])
            for i in range(0, host.size, self.block)
        ]
        audio = np.concatenate(out) if out else np.zeros(0, np.float32)
        if self.save_path:
            wavio.write(self.save_path, audio[: self.fs * 10], self.fs)
        return audio
