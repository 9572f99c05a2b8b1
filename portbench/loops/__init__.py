"""One module for each kind of traffic, named after the ``kind`` of a mix
(``traffic/<mix>.json``): ``loops/<kind>.py``. Each gives

- ``run(cell, seed, seconds, trace, device)``: set-up, the measured
  window and the comparison that decides ``correct``, as a dict with
  ``ctx`` (what the metric readers read; ``ctx.w0``, the window's start
  on the monotonic clock, ends set-up), ``attempted``, ``failed``,
  ``peak``, ``checks``, ``readings`` and ``correct``;
- ``control(cell, seed, device)``: the readings the limits of
  ``correct`` are set from, for ``python -m portbench.control``.
"""
