"""Serving launcher: concurrent writers + readers over a FactServer.

    PYTHONPATH=src python -m repro_torch.launch.serve --backend torch \\
        --writers 2 --readers 4 --write-ops 20 --reads 50

``--backend`` is ``torch`` (the CUDA device; raises without one),
``torch-cpu`` or ``numpy``.  ``--shards`` above 1 serves a
``ShardedEngine`` (``core.sharded``) of that many shard workers.
"""

from __future__ import annotations

import argparse
import dataclasses
import threading
import time


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--backend", default="torch")
    ap.add_argument("--eval-mode", default="delta")
    ap.add_argument("--shards", type=int, default=1)
    ap.add_argument("--chains", type=int, default=8)
    ap.add_argument("--hops", type=int, default=8)
    ap.add_argument("--writers", type=int, default=2)
    ap.add_argument("--readers", type=int, default=4)
    ap.add_argument("--write-ops", type=int, default=10)
    ap.add_argument("--reads", type=int, default=25)
    args = ap.parse_args()

    from repro_torch.core import EngineConfig, Fact, HiperfactEngine, Rule
    from repro_torch.core.conditions import AddAction, cond, term
    from repro_torch.serve import FactServer

    cfg = dataclasses.replace(EngineConfig.infer1(args.backend),
                              eval_mode=args.eval_mode, shards=args.shards)
    e = HiperfactEngine(cfg)
    e.add_rules([
        Rule("base", (cond("edge", "?x", "to", "?y"),),
             (AddAction("path", term("?x"), "to", term("?y")),)),
        Rule("rec", (cond("edge", "?x", "to", "?y"),
                     cond("path", "?y", "to", "?z")),
             (AddAction("path", term("?x"), "to", term("?z")),)),
    ])
    e.insert_facts([Fact("edge", f"c{j}_n{i}", "to", f"c{j}_n{i + 1}")
                    for j in range(args.chains) for i in range(args.hops)])
    if args.eval_mode != "demand":
        e.infer()

    with FactServer(e) as srv:
        q = [cond("path", "c0_n0", "to", "?z")]
        lat: list[float] = []
        lat_lock = threading.Lock()

        def writer(w: int) -> None:
            for i in range(args.write_ops):
                srv.append([Fact("edge", f"w{w}_m{i}", "to",
                                 f"w{w}_m{i + 1}")])

        def reader(r: int) -> None:
            for i in range(args.reads):
                t0 = time.perf_counter()
                if i % 3 == 0:
                    srv.serve([cond("edge", f"c{r % args.chains}_n0",
                                    "to", "?y")], tenant=f"t{r}")
                else:
                    srv.serve(q, tenant=f"t{r}")
                with lat_lock:
                    lat.append(time.perf_counter() - t0)

        t0 = time.perf_counter()
        threads = ([threading.Thread(target=writer, args=(w,))
                    for w in range(args.writers)] +
                   [threading.Thread(target=reader, args=(r,))
                    for r in range(args.readers)])
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        dt = time.perf_counter() - t0
        ms = sorted(x * 1e3 for x in lat)
        st = srv.stats()
        print(f"served {len(lat)} reads in {dt:.2f}s "
              f"({len(lat) / dt:.1f} qps), "
              f"p50 {ms[len(ms) // 2]:.2f}ms "
              f"p99 {ms[int(len(ms) * 0.99)]:.2f}ms")
        print(f"modes {st['served']}  requery {st['requery']}")
        if "batch" in st:
            print(f"batch {st['batch']}")


if __name__ == "__main__":
    main()
