"""Traffic entries other than the harness's own ``train`` and
``render_lidar``: one module a mix's ``entry``, ``entries/<entry>.py``,
which ``harness.entry_module`` loads by path. A new model or path of the
program comes as such a module, its plain reference under ``reference/``,
a configuration, a mix, limits and metric readers: new files alone.

An entry module has these six parts and nothing more:

``setup(run)``
    Runs after the harness has built the scene, the seed's field weights
    and the program's ``Trainer`` (``run.tr``). Does the entry's checked
    start and its warm-up, reading the entry's own keys from the
    configuration file (``run.cfg_file``) and from the mix (``run.mix``),
    and puts what the check compares under ``run.out[<entry>]``.

``unit(run) -> int``
    One unit of the window (a call, a pass or a step). Returns how many
    units it ran, and adds what failed to ``run.failed``. The window runs
    units until ``--seconds`` have passed, or, traced, the mix's
    ``trace_units`` of them.

``measures(run) -> {measure: value}``
    The end-to-end measures, from ``run.work`` (``wall_s``, ``count``),
    keyed by measure name: a metric's name up to the first dot.
    ``setup_s`` stays the harness's.

``NUMBERS``
    The names that a cell's limits may name.

``numbers(run, names, side="program") -> {name: value}``
    Compares what ``run.out`` holds with the entry's own plain float32
    reference, which lives in files of its own under ``reference/``, is
    plain torch with TF32 off and imports nothing of the program. ``side``
    is ``"program"`` or one of ``SIDES``, put in the program's place.

``SIDES``
    The names of what ``control.py`` may put in the program's place, such
    as a lower-precision control of the reference or a planted fault. It
    may be empty.
"""
