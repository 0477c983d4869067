"""Training launcher (port of the reference ``launch/train.py``).

Examples::

    # on the card (the default device; raises without one)
    PYTHONPATH=src python -m repro_torch.launch.train --arch yi-6b --smoke \\
        --steps 30 --data facts --ckpt-dir /tmp/ckpt

    # tiny smoke run on the CPU
    PYTHONPATH=src python -m repro_torch.launch.train --arch yi-6b --smoke \\
        --steps 30 --device cpu

``--device`` is ``cuda`` (the default) or ``cpu``; ``--data facts`` builds
its fact engine on the ``torch`` backend for ``cuda`` and on ``torch-cpu``
for ``cpu``.  ``--mesh`` waits for the LM's sharding (ROADMAP A11.5).
Fault tolerance: every run resumes from the latest committed checkpoint
in ``--ckpt-dir`` automatically (see runtime/monitor.py for the
supervisor policy).
"""

from __future__ import annotations

import argparse
import logging

ENGINE_BACKENDS = {"cuda": "torch", "cpu": "torch-cpu"}


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
                    help="AxB data x model mesh (ROADMAP A11.5)")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--data", default="synthetic",
                    choices=["synthetic", "facts"])
    ap.add_argument("--device", default="cuda",
                    choices=sorted(ENGINE_BACKENDS))
    args = ap.parse_args()
    if args.mesh:
        raise NotImplementedError(
            "--mesh waits for the LM's sharding (ROADMAP A11.5); the port "
            "trains on one device")

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
        global_batch=args.batch, device=args.device)
    _, losses = trainer.run()
    print(f"final loss: {losses[-1]:.4f} (start {losses[0]:.4f})")


if __name__ == "__main__":
    main()
