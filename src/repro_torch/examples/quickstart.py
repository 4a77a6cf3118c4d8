"""Quickstart via the `repro.api.Session` facade: pick an architecture,
train a reduced config for a few steps, checkpoint, restore, and predict
the run's wall-clock with Eq (4) — the whole CM-DARE loop in ~30 lines.

PYTHONPATH=src python -m repro_torch.examples.quickstart --arch qwen3-1.7b \
    --steps 20 [--device cpu]

The port's twin of `examples/quickstart.py`: it trains on the card unless
``--device`` names another device.
"""
from __future__ import annotations

import tempfile

from repro_torch.api import Session
from repro_torch.launch import cli


def main(argv=None):
    p = cli.make_parser("quickstart", __doc__.splitlines()[0])
    cli.add_arch_arg(p)
    cli.add_batch_args(p)
    p.add_argument("--steps", type=int, default=20)
    args = p.parse_args(argv)

    session = Session.from_arch(
        args.arch, total_steps=args.steps, warmup_steps=2, lr=1e-3,
        zero1=False, checkpoint_interval=max(5, args.steps // 2),
        device=args.device)
    info = session.describe()
    print(f"arch={args.arch} (reduced): {info['n_layers']}L "
          f"d={info['d_model']} params={info['params']:,}")

    with tempfile.TemporaryDirectory() as d:
        rep = session.train(args.steps, global_batch=args.global_batch,
                            seq_len=args.seq, checkpoint_dir=d)
        print(f"loss {rep.losses[0]:.3f} -> {rep.losses[-1]:.3f} over "
              f"{rep.steps_run} steps at {rep.speed or 0:.2f} steps/s, "
              f"{rep.checkpoints} checkpoints")

        # a fresh restore sees the latest committed checkpoint
        _, restored_step = session.trainer.restore_or_init()
        print(f"restore: latest checkpoint at step {restored_step}")

        # predict a hypothetical 10x longer run on transient V100s, Eq (4)
        pred = session.predict(n_workers=1, gpu="v100",
                               steps=10 * args.steps)
        print(f"Eq(4) predicted wall-clock for {10*args.steps} steps on "
              f"1x{pred.gpu}: {pred.total_time_seconds:.1f}s "
              f"(E[revocations]={pred.expected_revocations:.2f})")


if __name__ == "__main__":
    main()
