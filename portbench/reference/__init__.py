"""The benchmark's plain float64 reference: ``swe.py`` (the step, the CFL
reduction, the time controller and the uniform forcing on whole planes),
``model.py`` (a model directory read and run), and frozen copies of the
per-cell numpy oracles that the tests hold ``swe.py`` to."""
