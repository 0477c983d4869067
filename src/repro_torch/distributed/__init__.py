"""Distribution layer of the port: the sharded engine's frontier
exchange (``pipeline.FrontierExchange``), its lane codecs
(``compression``) and its device list (``sharding.fact_devices``).

The reference's GSPMD specs, GPipe stages and int8 gradient all-reduce
belong to the LM's training and are not ported yet (ROADMAP A11).
"""
