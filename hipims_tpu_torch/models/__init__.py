"""Numerical scheme registry."""

from .schemes import SCHEMES, Scheme, get_scheme  # noqa: F401
