"""Shared ops helpers."""

from __future__ import annotations


def pad_to_multiple(n: int, m: int = 128) -> int:
    """Smallest multiple of ``m`` that is >= ``n``."""
    return ((n + m - 1) // m) * m
