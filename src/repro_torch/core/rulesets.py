"""RDFS-Plus-style rulesets (paper §3.1).

The paper's inference benchmarks (LUBM/WordNet) run the RDFS-Plus rule set.
Like the paper ("we have implemented those instantiated rules directly as
rules for the Hiperfact engine"), we express RDFS-Plus as concrete Hiperfact
rules over two namespaces:

* ``Schema`` facts: (Schema <class-or-prop> <meta-attr> <class-or-prop>),
  meta attrs: ``subClassOf``, ``subPropertyOf``, ``domain``, ``range``,
  ``inverseOf``, ``characteristic`` (values ``transitive``/``symmetric``).
* ``Data`` facts: (Data <subject> <predicate> <object>), with ``type``
  holding class membership in the value slot.
"""

from __future__ import annotations

from repro_torch.core.conditions import AddAction, Rule, cond, term


def rdfs_plus_rules(data: str = "Data", schema: str = "Schema") -> list[Rule]:
    R = []
    # scm-sco: subClassOf transitivity (schema-level)
    R.append(Rule(
        "scm-sco",
        (cond(schema, "?a", "subClassOf", "?b"),
         cond(schema, "?b", "subClassOf", "?c")),
        (AddAction(schema, term("?a"), "subClassOf", term("?c")),)))
    # cax-sco: class membership inheritance
    R.append(Rule(
        "cax-sco",
        (cond(data, "?x", "type", "?a"),
         cond(schema, "?a", "subClassOf", "?b")),
        (AddAction(data, term("?x"), "type", term("?b")),)))
    # scm-spo: subPropertyOf transitivity
    R.append(Rule(
        "scm-spo",
        (cond(schema, "?p", "subPropertyOf", "?q"),
         cond(schema, "?q", "subPropertyOf", "?r")),
        (AddAction(schema, term("?p"), "subPropertyOf", term("?r")),)))
    # prp-spo1: property inheritance
    R.append(Rule(
        "prp-spo1",
        (cond(data, "?x", "?p", "?y"),
         cond(schema, "?p", "subPropertyOf", "?q")),
        (AddAction(data, term("?x"), term("?q"), term("?y")),)))
    # prp-dom / prp-rng: domain + range typing
    R.append(Rule(
        "prp-dom",
        (cond(data, "?x", "?p", "?y"),
         cond(schema, "?p", "domain", "?c")),
        (AddAction(data, term("?x"), "type", term("?c")),)))
    R.append(Rule(
        "prp-rng",
        (cond(data, "?x", "?p", "?y"),
         cond(schema, "?p", "range", "?c")),
        (AddAction(data, term("?y"), "type", term("?c")),)))
    # prp-trp: transitive properties
    R.append(Rule(
        "prp-trp",
        (cond(schema, "?p", "characteristic", "transitive"),
         cond(data, "?x", "?p", "?y"),
         cond(data, "?y", "?p", "?z")),
        (AddAction(data, term("?x"), term("?p"), term("?z")),)))
    # prp-symp: symmetric properties
    R.append(Rule(
        "prp-symp",
        (cond(schema, "?p", "characteristic", "symmetric"),
         cond(data, "?x", "?p", "?y")),
        (AddAction(data, term("?y"), term("?p"), term("?x")),)))
    # prp-inv: inverse properties (both directions)
    R.append(Rule(
        "prp-inv1",
        (cond(schema, "?p", "inverseOf", "?q"),
         cond(data, "?x", "?p", "?y")),
        (AddAction(data, term("?y"), term("?q"), term("?x")),)))
    return R
