"""Training launcher (port of the reference ``launch/train.py``).

Examples::

    # on the card (the default device; raises without one)
    PYTHONPATH=src python -m repro_torch.launch.train --arch yi-6b --smoke \\
        --steps 30 --data facts --ckpt-dir /tmp/ckpt

    # tiny smoke run on the CPU
    PYTHONPATH=src python -m repro_torch.launch.train --arch yi-6b --smoke \\
        --steps 30 --device cpu

    # a 2x4 data x model mesh (FSDP+TP) over one card's device list
    PYTHONPATH=src python -m repro_torch.launch.train --arch yi-6b --smoke \\
        --mesh 2x4 --devices cuda:0 --steps 20 --ckpt-dir /tmp/ckpt

``--device`` is ``cuda`` (the default) or ``cpu``; ``--data facts`` builds
its fact engine on the ``torch`` backend for ``cuda`` and on ``torch-cpu``
for ``cpu``.  ``--mesh AxB`` trains on a data x model mesh
(``launch/mesh.py``) over ``--devices``, a comma list of A*B devices
(one entry is repeated A*B times; ``cpu`` on the CPU); without
``--devices`` the mesh needs A*B CUDA devices and raises if torch sees
fewer.  Fault tolerance: every run resumes from the latest committed checkpoint
in ``--ckpt-dir`` automatically (see runtime/monitor.py for the
supervisor policy).
"""

from __future__ import annotations

import argparse
import logging

ENGINE_BACKENDS = {"cuda": "torch", "cpu": "torch-cpu"}


def parse_mesh(spec: str, devices: str | None):
    """``AxB`` over ``devices`` -> a ("data", "model") mesh; without
    ``devices`` it needs A*B CUDA devices."""
    from repro_torch.launch.mesh import make_host_mesh
    a, b = (int(x) for x in spec.lower().split("x"))
    if devices is None:
        try:
            return make_host_mesh((a, b))
        except ValueError as e:
            raise ValueError(f"--mesh {spec}: {e}; pass --devices (e.g. "
                             "--devices cuda:0 to share one card)") from e
    devs = devices.split(",")
    if len(devs) == 1:
        devs = devs * (a * b)
    return make_host_mesh((a, b), devices=devs)


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="yi-6b")
    ap.add_argument("--smoke", action="store_true",
                    help="use the reduced same-family config")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--accum", type=int, default=1)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--mesh", default=None,
                    help="AxB data x model mesh over --devices")
    ap.add_argument("--devices", default=None,
                    help="comma list of the mesh's devices (may repeat "
                         "one; a single entry is repeated)")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--data", default="synthetic",
                    choices=["synthetic", "facts"])
    ap.add_argument("--device", default="cuda",
                    choices=sorted(ENGINE_BACKENDS))
    args = ap.parse_args()
    mesh = parse_mesh(args.mesh, args.devices) if args.mesh else None

    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s %(name)s %(message)s")
    from repro_torch.configs import get_config
    from repro_torch.data import DataConfig, ShardedLoader, SyntheticLM
    from repro_torch.train import OptimizerConfig, Trainer, TrainerConfig

    cfg = get_config(args.arch, smoke=args.smoke)
    if args.data == "facts":
        from repro_torch.data.factsource import (FactCorpusSource,
                                                 corpus_engine)
        src = FactCorpusSource(cfg.vocab, args.seq, args.batch,
                               engine=corpus_engine(
                                   backend=ENGINE_BACKENDS[args.device]))
    else:
        src = SyntheticLM(DataConfig(vocab=cfg.vocab, seq_len=args.seq,
                                     global_batch=args.batch))
    loader = ShardedLoader(src)
    trainer = Trainer(
        cfg, loader,
        OptimizerConfig(lr=args.lr, warmup_steps=max(2, args.steps // 10),
                        total_steps=args.steps),
        TrainerConfig(steps=args.steps, ckpt_dir=args.ckpt_dir,
                      accum=args.accum),
        mesh=mesh, global_batch=args.batch, device=args.device)
    _, losses = trainer.run()
    print(f"final loss: {losses[-1]:.4f} (start {losses[0]:.4f})")


if __name__ == "__main__":
    main()
