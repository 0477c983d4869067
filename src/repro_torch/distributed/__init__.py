"""Distribution layer of the port: sharding rules and layouts
(``sharding``), collectives along a mesh axis (``spmd``), the int8
gradient all-reduce and the frontier exchange's lane codecs
(``compression``), GPipe stages and the sharded engine's frontier
exchange (``pipeline``)."""

from repro_torch.distributed.sharding import (activation_hints,
                                              batch_shardings,
                                              shardings_for,
                                              sharded_abstract, spec_for)

__all__ = ["activation_hints", "batch_shardings", "shardings_for",
           "sharded_abstract", "spec_for"]
