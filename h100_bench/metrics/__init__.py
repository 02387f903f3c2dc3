"""One reader a metric, named as the metric in BENCHMARK.json: ``read(r)``
takes the run's ``harness.Readings`` and returns the value, or None where
the run holds nothing to read (the metric is then left out of the line).
A reader of a kernel's launches names the program's counter in
``COUNTER`` (``module:function``, whose ``by_shape`` it reads) and the
kernel's source in ``SOURCE`` (``<file>.cu`` under the program's
``csrc/``, whose kernels the trace counts: ``launches.py``)."""
