"""Timestamped logging in the reference's ``{datetime.now()} : message``
line format."""

from __future__ import annotations

import datetime


def log(*parts: object) -> None:
    """Print a '{timestamp} : message' line, matching the reference format."""
    msg = " ".join(str(p) for p in parts)
    print(f"{datetime.datetime.now()} : {msg}", flush=True)

