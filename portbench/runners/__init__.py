"""Runners, one file a traffic ``entry``: ``portbench/runners/<entry>.py``
exports ``Runner``, which ``harness.runner_class(entry, root)`` finds.  A
runner drives the program for one cell and brings its own comparison; a
new deployment that needs another call of the program, or another
comparison, is a new runner file.

``Runner(cell, seed, device)`` builds the program and the inputs from
``seed`` (``calibrate.py`` passes the verifier to reuse as a fourth
argument).  ``cell`` is ``harness.load_cell``'s dict: ``config``,
``traffic`` (with the run's overrides), ``limits``, ``root`` (the
checkout whose ``portbench/`` holds the cell's files; hand it to
``gen``), and ``ranks``: None on one card, else the ``launch.Ranks``
(``rank``, ``world``, ``device``) of this process, whose device
``device`` is.  What ``harness.run``, ``trace`` and the readers use:

- ``call(i) -> (unit, verdicts, accepts)``: request ``i`` (a closed loop
  counts from 0): ``unit`` the index of the distinct batch it served,
  ``verdicts`` a bool numpy array (one a clip: ``attempted`` counts
  them), ``accepts`` {clip: what the check compares}.  On N > 1 cards the
  harness steps every rank with the same ``i``, so ``call`` is the one
  collective step; nothing else of a runner runs on any rank but 0.
- ``warm_up()``: every shape and path of the window, through ``call``.
- ``work(unit) -> float``: the audio seconds that unit verifies.
- ``check(records) -> dict``: after the window and ``free_program``,
  every comparison number against the plain reference (each key of the
  cell's limits file) and ``wrong``, the clips answered wrong.
- ``free_program()``: drop the program's state before the reference.
- ``sync_rows()``: (clips, n_valid) of each distinct unit, as the sync
  sees them (``calibrate.py``'s sync control).
- ``batches``: the distinct units; a traced run covers each once.
- ``setup_parts``: named seconds of the runner's set-up.
- ``entry``: the traffic entry (``trace.layers`` marks the stages of
  ``batch`` runners); ``verifier``: the program's object, or None.
"""
