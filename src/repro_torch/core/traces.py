"""Process-independent hashing of function names (own copy of
``repro.core.traces.stable_hash``, the one part of that module the port
needs: the home-invoker route of push cells starts its walk at
``stable_hash(fn) % nodes``)."""

from __future__ import annotations

import zlib


def stable_hash(name: str) -> int:
    """CRC32 of the name's UTF-8 bytes.  Python's builtin ``hash`` is salted
    per interpreter, which would route a function to another home invoker
    in every process."""
    return zlib.crc32(name.encode("utf-8"))
