"""State carry-over from the reference engine into a port engine.

The reference engine's state arrives as plain data — its string
dictionary as the ordered list of strings (id ``i`` is ``strings[i]``)
and, per fact type, the ``(ids, attrs, vals, valtypes)`` columns of its
alive rows — so this module needs nothing of the reference package.
Loading it through ``insert_columns`` makes both engines compute from the
same interned ids, which is what lets a test compare their encoded
tables, not only their decoded fact sets.

Carry the state *before* ``infer()``: every row lands as an asserted
fact, so a carried derived row would become a base fact.
"""

from __future__ import annotations

import numpy as np

from repro_torch.core.engine import HiperfactEngine


def load_reference_state(engine: HiperfactEngine, strings, tables) -> int:
    """Intern ``strings`` in order, then insert each fact type's columns.

    ``strings`` must extend the port engine's dictionary: strings it
    already holds (rule constants interned at ``add_rule``) must sit at
    the same ids, else the two engines' encodings differ and this raises.
    ``tables`` maps fact type -> ``(ids, attrs, vals, valtypes)``.
    Returns the number of rows inserted.
    """
    sd = engine.store.strings
    for i, s in enumerate(strings):
        sid = sd.intern(s)
        if sid != i:
            raise ValueError(
                f"string {s!r} has id {sid} in the port engine but {i} in "
                "the reference: add the same rules in the same order "
                "before loading")
    n = 0
    for ftype, (ids, attrs, vals, valtypes) in tables.items():
        n += engine.insert_columns(ftype, np.asarray(ids, np.int32),
                                   np.asarray(attrs, np.int32),
                                   np.asarray(vals, np.int64),
                                   np.asarray(valtypes, np.int8))
    return n
