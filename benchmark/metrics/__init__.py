"""One reader per per-layer metric, found by the metric's name: each file's
``read(records)`` returns the metric's value, or None when the run has
nothing for it to read (the harness then leaves the metric out).  The
records of a ``--trace 1`` run: ``timeline`` (the profiled window's device
operations, their union and the host spans, `harness.trace.Timeline`),
``units`` (batches or steps in that window), ``spans`` (its host spans),
``untraced_spans`` / ``untraced_units`` / ``untraced_images_per_s`` (the
measured window before it, with the profiler off), ``work`` (the driver's
operations from the configuration's shapes), and ``config`` and ``mix``
(the cell's configuration and traffic mix as loaded), from which a new
reader can work out its own yardstick with a new ``work/<name>.py``."""
