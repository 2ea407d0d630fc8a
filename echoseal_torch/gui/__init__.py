"""Tk GUIs: live transmitter (VU meter) and file verifier.

Tkinter and the audio stack are imported when a window is built, so
headless and serving machines import the package without them.  The
verifier window follows the port's device rule (``device=None`` means
CUDA).
"""
