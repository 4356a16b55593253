"""Logging, profiler spans and misc utilities."""


def time_label(t) -> str:
    """Lossless, filesystem-safe time label for %t filename substitution:
    10.0 -> '10', 1.5 -> '1.5' (reference %t semantics:
    src/Domain/Cartesian/CDomainCartesian.cpp:804-829)."""
    return f"{float(t):g}"
