"""Synthetic LUBM-style workload (the port's copy of the reference
``benchmarks/datasets.py`` ``lubm_like`` and ``LUBM_QUERIES``).

LUBM itself is not available offline, so the generator builds a
structurally similar university knowledge graph — class hierarchy,
transitive ``subOrganizationOf``, domain/range typing, star joins — with
a scale knob.  ``lubm_like(scale)`` makes about ``2136 * scale`` base
facts (``scale=500`` is ~1.07M, roughly the triple count of the standard
LUBM(10)).  Generation is seeded and deterministic, and the facts and
queries equal the reference's for the same arguments.
"""

from __future__ import annotations

import numpy as np

from repro_torch.core.conditions import cond
from repro_torch.core.facts import Fact


# ---------------------------------------------------------------------------
# LUBM-style (inference-heavy: RDFS-Plus over a university KG)


def lubm_like(scale: int = 1, seed: int = 0):
    """~scale x 4k facts: universities, departments, people, courses."""
    rng = np.random.RandomState(seed)
    facts = [
        Fact("Schema", "GraduateStudent", "subClassOf", "Student"),
        Fact("Schema", "Student", "subClassOf", "Person"),
        Fact("Schema", "FullProfessor", "subClassOf", "Professor"),
        Fact("Schema", "Professor", "subClassOf", "Faculty"),
        Fact("Schema", "Faculty", "subClassOf", "Employee"),
        Fact("Schema", "Employee", "subClassOf", "Person"),
        Fact("Schema", "subOrganizationOf", "characteristic", "transitive"),
        Fact("Schema", "memberOf", "domain", "Person"),
        Fact("Schema", "teacherOf", "domain", "Faculty"),
        Fact("Schema", "takesCourse", "domain", "Student"),
        Fact("Schema", "advisor", "range", "Professor"),
    ]
    n_uni = max(1, scale)
    for u in range(n_uni):
        uni = f"uni{u}"
        for d in range(8):
            dept = f"dept{u}_{d}"
            facts.append(Fact("Data", dept, "subOrganizationOf", uni))
            for g in range(2):
                grp = f"group{u}_{d}_{g}"
                facts.append(Fact("Data", grp, "subOrganizationOf", dept))
            for p in range(6):
                prof = f"prof{u}_{d}_{p}"
                facts.append(Fact("Data", prof, "type",
                                  "FullProfessor" if p % 3 == 0
                                  else "Professor"))
                facts.append(Fact("Data", prof, "memberOf", dept))
                for c in range(2):
                    facts.append(Fact("Data", prof, "teacherOf",
                                      f"course{u}_{d}_{p}_{c}"))
            for s in range(40):
                stu = f"stu{u}_{d}_{s}"
                facts.append(Fact("Data", stu, "type",
                                  "GraduateStudent" if s % 4 == 0
                                  else "Student"))
                facts.append(Fact("Data", stu, "memberOf", dept))
                facts.append(Fact("Data", stu, "advisor",
                                  f"prof{u}_{d}_{rng.randint(6)}"))
                for c in range(3):
                    facts.append(Fact(
                        "Data", stu, "takesCourse",
                        f"course{u}_{d}_{rng.randint(6)}_{rng.randint(2)}"))
    return facts


LUBM_QUERIES = [
    [cond("Data", "?x", "type", "Person")],
    [cond("Data", "?x", "type", "Student"),
     cond("Data", "?x", "takesCourse", "?c")],
    [cond("Data", "?x", "subOrganizationOf", "?u")],
    [cond("Data", "?s", "advisor", "?p"),
     cond("Data", "?p", "memberOf", "?d"),
     cond("Data", "?s", "memberOf", "?d")],
]
