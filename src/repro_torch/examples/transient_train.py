"""End-to-end driver on the Session facade: train a ~100M-param LM for a few
hundred steps on a transient cluster with revocations sampled from the
calibrated fleet model, checkpoint-lease handover, restore after a simulated
chief loss, and Eq(4) prediction vs. actual wall-clock.

Default runs a reduced slice of the workload (reduced width, short run) so
it finishes in minutes; pass --full-100m for the real ~100M configuration.

PYTHONPATH=src python -m repro_torch.examples.transient_train --steps 300 \
    [--device cpu]

The port's twin of `examples/transient_train.py`: it trains on the card
unless ``--device`` names another device.
"""
from __future__ import annotations

import math
import tempfile
import time

from repro_torch.api import Session
from repro_torch.configs import ModelConfig, RunConfig
from repro_torch.core.trainer import MembershipEvent
from repro_torch.core.transient.revocation import RevocationSampler
from repro_torch.launch import cli


def lm_100m(full: bool) -> ModelConfig:
    if full:
        # ~100M-param decoder LM (GPT-2-small-ish, SwiGLU, GQA)
        return ModelConfig(name="lm-100m", family="dense", n_layers=12,
                           d_model=768, n_heads=12, n_kv_heads=4, head_dim=64,
                           d_ff=2048, vocab_size=32768, tie_embeddings=True)
    return ModelConfig(name="lm-14m", family="dense", n_layers=6,
                       d_model=256, n_heads=8, n_kv_heads=4, head_dim=32,
                       d_ff=768, vocab_size=8192, tie_embeddings=True)


def main(argv=None):
    p = cli.make_parser("transient_train", __doc__.splitlines()[0])
    p.add_argument("--steps", type=int, default=300)
    cli.add_batch_args(p, batch_default=16, seq_default=128)
    p.add_argument("--members", type=int, default=4)
    p.add_argument("--full-100m", action="store_true")
    p.add_argument("--seed", type=int, default=0)
    args = p.parse_args(argv)

    cfg = lm_100m(args.full_100m)
    run = RunConfig(total_steps=args.steps, warmup_steps=20,
                    checkpoint_interval=max(20, args.steps // 6),
                    lr=3e-4, zero1=False, seed=args.seed)
    # a custom (non-registry) ModelConfig goes straight into Session
    session = Session(cfg, run, device=args.device)
    print(f"model {cfg.name}: {cfg.param_count()/1e6:.1f}M params")

    # sample a revocation schedule from the calibrated fleet model: member i
    # is a preemptible v5e slice in us-central1 (v100 stats as proxy)
    samp = RevocationSampler(args.seed)
    events = []
    for i in range(1, args.members):  # member 0 survives
        lt = samp.lifetime("us-central1", "v100")
        if math.isfinite(lt):
            at_step = int(lt / 24.0 * args.steps)
            if 0 < at_step < args.steps:
                events.append(MembershipEvent(step=at_step, kind="revoke",
                                              member_id=i))
                # replacement joins ~startup-time later (scaled)
                rejoin = min(args.steps - 1, at_step + max(2, args.steps // 20))
                events.append(MembershipEvent(step=rejoin, kind="join",
                                              member_id=100 + i))
    print(f"sampled {sum(1 for e in events if e.kind=='revoke')} revocations "
          f"from the fleet model: "
          f"{[(e.kind, e.step) for e in sorted(events, key=lambda e: e.step)]}")

    # observe the run through the Session's event bus
    session.bus.subscribe(
        "epoch", lambda kind, ev: print(f"  [bus] step {ev['step']}: "
                                        f"{ev['kind']} member "
                                        f"{ev['member_id']} -> "
                                        f"{ev['n_alive']} alive"))

    with tempfile.TemporaryDirectory() as d:
        t0 = time.monotonic()
        half = args.steps // 2
        rep1 = session.train(half, global_batch=args.global_batch,
                             seq_len=args.seq, members=args.members,
                             events=[e for e in events if e.step < half],
                             checkpoint_dir=d)
        print(f"[phase 1] loss {rep1.losses[0]:.3f} -> {rep1.losses[-1]:.3f}, "
              f"{rep1.epochs} membership epochs, "
              f"{rep1.checkpoints} checkpoints, "
              f"{rep1.speed or 0:.2f} steps/s")

        # simulate chief loss: a fresh session (new lease holder) restores
        # and continues — the lease handover means no recomputation
        # reuse the subscribed bus so the observer sees phase-2 events too
        session2 = Session(cfg, run, bus=session.bus, device=args.device)
        # free the lease as the revocation notification would
        from repro_torch.checkpoint import Checkpointer, WriterLease
        WriterLease(d, "worker-0").notify_revoked()
        resumed_step = Checkpointer(d).latest_step() or 0
        rep2 = session2.train(args.steps - resumed_step,
                              global_batch=args.global_batch,
                              seq_len=args.seq, members=args.members,
                              events=[e for e in events
                                      if e.step >= resumed_step],
                              holder="worker-replacement",
                              checkpoint_dir=d)
        lost = half - resumed_step
        print(f"[chief revoked] restored at step {resumed_step} "
              f"(recompute window {lost} steps, bounded by I_c="
              f"{run.checkpoint_interval})")
        wall = time.monotonic() - t0
        print(f"[phase 2] loss -> {rep2.losses[-1]:.3f}, "
              f"total wall {wall:.1f}s")
        full_losses = rep1.losses + rep2.losses
        assert full_losses[-1] < full_losses[0], "training must make progress"
        print(f"final loss {full_losses[-1]:.3f} "
              f"(start {full_losses[0]:.3f}) — OK")


if __name__ == "__main__":
    main()
