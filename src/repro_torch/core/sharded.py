"""Decoded-fact checksum (the part of the reference ``core/sharded.py``
the first slice needs).

The hash-partitioned ``ShardedEngine`` is not ported yet (ROADMAP A9);
the checksum is what holds a port engine against the reference engine:
both must decode to the same fact set.
"""

from __future__ import annotations

import zlib

import numpy as np

from repro_torch.core.engine import HiperfactEngine
from repro_torch.core.facts import ValueType, decode_value
from repro_torch.core.store import VIEW_PREFIX


def iter_decoded_facts(engine: HiperfactEngine):
    """Yield every alive fact fully decoded (view copies of a sharded
    run are infrastructure and skipped, as in the reference)."""
    st = engine.store
    for ftype, tab in st.tables.items():
        if ftype.startswith(VIEW_PREFIX):
            continue
        for r in np.flatnonzero(tab.alive):
            vt = ValueType(int(tab.valtypes[r]))
            yield (ftype,
                   st.strings.lookup_id(int(tab.ids[r])),
                   st.strings.lookup_id(int(tab.attrs[r])),
                   repr(decode_value(int(tab.vals[r]), vt, st.strings)),
                   int(vt))


def decoded_fact_checksum(engine: HiperfactEngine) -> int:
    """Order-independent crc32 over the decoded fact set."""
    lines = sorted("\t".join(map(str, f)) for f in iter_decoded_facts(engine))
    return zlib.crc32("\n".join(lines).encode())
