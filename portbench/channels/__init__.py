"""Channels, one file a ``kind``: ``portbench/channels/<kind>.py``
exports ``apply(x, spec, fs, rng) -> (x, fs_out)``, the stream after the
channel (a traffic's ``channel``) and its sample rate, which sets the
clip length in samples.  ``rng`` is the stream's generator, drawn from
after the transmitter and before the cuts."""
