"""Host signals, one file a ``kind``: ``portbench/hosts/<kind>.py``
exports ``make(spec, n, fs, rng) -> float32 (n,)``, the host audio the
transmitter watermarks (a configuration's ``tx.host``).  ``rng`` is the
stream's generator: a host that draws from it changes every later draw."""
